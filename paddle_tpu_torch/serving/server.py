"""Server front end: a dispatch thread over engines.

Counterpart of ``paddle_tpu/serving/server.py``: ``Server`` owns the
DynamicBatcher and a daemon dispatch loop that drives each engine's
``serve_step``, whatever the engine: a GenerationEngine interleaves
prefill admissions with decode ticks (continuous batching); an
InferenceEngine runs each formed batch, grouped by row shape, through its
bucket graphs. Several engines round-robin the shared queue. A request's meta carries its decode policy
(``GENERATE_META``: temperature, top_k, top_p, seed, stop beside
max_new_tokens and eos_id), which the paged engine merges over its
default field by field; a request the paged KV cache can never hold
fails its future with ``CacheExhaustedError``, a malformed one with
``BadRequestError``. The HTTP endpoint, the feedback plane, fault plans
and SLO tracking come with later slices of the port.
"""
from __future__ import annotations

import logging
import threading
from typing import Optional

import numpy as np

from .batcher import DynamicBatcher, Future

_IDLE_WAIT_S = 0.02  # dispatch-loop poll when the queue is empty
# the request fields a generate call carries (the /v1/generate schema of
# the JAX package's server, without its beam and routing fields)
GENERATE_META = ("max_new_tokens", "eos_id", "temperature", "top_k",
                 "top_p", "seed", "stop")

log = logging.getLogger(__name__)


class Server:
    """Dispatch loop + admission queue over one or more engines."""

    def __init__(self, engine, *, max_wait_ms: float = 5.0,
                 max_queue: int = 256,
                 default_timeout_ms: Optional[float] = None):
        self.engines = list(engine) if isinstance(
            engine, (list, tuple)) else [engine]
        self.metrics = self.engines[0].metrics
        # a batch never exceeds what one engine's largest bucket (a
        # generation engine's prefill bucket) can take
        self.batcher = DynamicBatcher(
            buckets=sorted({b for e in self.engines
                            for b in getattr(e, "prefill_batch_buckets",
                                             None) or e.batch_buckets}),
            max_wait_ms=max_wait_ms, max_queue=max_queue,
            default_timeout_ms=default_timeout_ms, metrics=self.metrics)
        self._thread: Optional[threading.Thread] = None
        self._running = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Server":
        if self._thread is not None:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._loop,
                                        name="paddle-tpu-torch-serving",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the dispatch loop and fail whatever is still queued."""
        self._running = False
        self.batcher.close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self) -> None:
        idx = 0
        while self._running:
            engine = self.engines[idx % len(self.engines)]
            idx += 1
            try:
                engine.serve_step(self.batcher, idle_wait_s=_IDLE_WAIT_S)
            except Exception:  # noqa: BLE001 - keep dispatching
                # a crash here would silently stop dispatch for every
                # queued request: count it, log it, keep looping
                self.metrics.inc("dispatch_errors")
                log.exception("serving dispatch step failed")

    # -- in-process API ----------------------------------------------------
    def submit(self, payload, timeout_ms: Optional[float] = None,
               **meta) -> Future:
        """Enqueue a request; returns a Future. Raises QueueFullError on
        backpressure. For a generation engine the payload is a prompt (or
        {"prompt": ids}) with max_new_tokens/eos_id in ``meta``; for an
        inference engine it is a per-row feed dict, and the future's
        result is the list of that row's fetches."""
        return self.batcher.submit(payload, timeout_ms=timeout_ms, **meta)

    def generate(self, prompt, max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 timeout_s: Optional[float] = 60.0,
                 **sampling) -> np.ndarray:
        """Blocking convenience wrapper around submit(). ``sampling``:
        the request's temperature, top_k, top_p, seed and stop."""
        unknown = set(sampling) - set(GENERATE_META)
        if unknown:
            raise TypeError(f"unknown generate fields {sorted(unknown)}; "
                            f"a request carries {GENERATE_META}")
        fut = self.submit({"prompt": prompt},
                          max_new_tokens=max_new_tokens, eos_id=eos_id,
                          **sampling)
        return fut.result(timeout=timeout_s)

    def metrics_snapshot(self) -> dict:
        self.metrics.update_device_gauges()
        snap = self.metrics.snapshot()
        snap["queue_depth"] = self.batcher.depth
        return snap
