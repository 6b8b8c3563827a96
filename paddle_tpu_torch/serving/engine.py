"""InferenceEngine: bucketed one-shot inference over a saved model.

Counterpart of ``paddle_tpu/serving/engine.py``'s ``InferenceEngine``.
A batch is padded to the smallest batch bucket that holds it (repeating
its last row) and a batch past the largest bucket is cut into chunks, so
the device only ever sees the bucket shapes. The JAX engine compiles one
executable per bucket at ``warmup()``; the port's counterpart on the
card is one CUDA graph per bucket: ``warmup()`` runs each bucket eagerly
once (building the CUDA kernels, choosing cuDNN's algorithms and filling
its workspaces), then captures ``Executor.run`` over static device feeds
into a ``torch.cuda.CUDAGraph``. ``run`` copies the padded feed into the
bucket's static inputs, replays the graph and copies the static outputs
out on the device before any later replay can overwrite them. Every
tensor the graph reads (the static feeds, the scope's weights, what the
kernel wrappers allocated at capture) stays referenced with the graph.

On the CPU ``run`` is the eager executor. On the card a failed capture or
replay raises: nothing serves eagerly there once ``warmup()`` has run,
and a bucket without a graph raises rather than running eagerly.

Later pieces of the port, each raising and naming ``ROADMAP.md``: a
device mesh or sharding plan, ``mem_budget``, ``--verify_program``, the
warmup manifests (``warm_start``, ``warm_from_manifest``,
``save_manifest``) and ``swap_params``.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.executor import CUDAPlace, Executor
from ..core.scope import Scope
from ..core.types import to_numpy
from ..ops.common import policy_key
from .errors import BadRequestError, EngineClosedError
from .metrics import MetricsRegistry

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch; see ROADMAP.md "
        f"Queue 1 item {item}")


def _graph_capture(fn, device):
    """Capture ``fn()`` (a run of the program over the static feeds) into
    a CUDA graph: (graph, the static outputs it writes on every replay).
    Two runs on a side stream first create the library handles and
    workspaces the capture stream needs (a capture may not allocate
    them)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # thread-local: a server thread may run CUDA work meanwhile
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        outs = fn()
    return graph, outs


class PendingInference:
    """Result of :meth:`InferenceEngine.run_async`: every padded chunk has
    been launched (on the card, replays enqueued on the stream and their
    outputs copied out on the device); ``result()`` waits and brings the
    fetches to the host, sliced back to the true batch."""

    def __init__(self, engine: "InferenceEngine", parts):
        self._engine = engine
        self._parts = parts  # [(device outputs, bucket, rows, t0), ...]
        self._result = None

    def done(self) -> bool:
        return self._result is not None

    def result(self) -> List[np.ndarray]:
        if self._result is None:
            outs = [self._engine._resolve(*part) for part in self._parts]
            if len(outs) == 1:
                self._result = outs[0]
            else:
                self._result = [
                    np.concatenate([o[i] for o in outs], axis=0)
                    for i in range(len(self._engine.fetch_names))]
        return self._result


class InferenceEngine:
    """Loads a saved inference model and serves padded-bucket batches.

    Construct from a ``save_inference_model`` directory (``model_dir``)
    or from an already built (program, feed_names, fetch_names, scope).
    ``place`` defaults to ``CUDAPlace(0)``, which raises without CUDA;
    pass ``CPUPlace()`` to run the plain versions of the kernels.
    """

    def __init__(self, model_dir: Optional[str] = None, *,
                 program=None, feed_names=None, fetch_names=None,
                 scope: Optional[Scope] = None,
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
                 seq_buckets: Optional[Sequence[int]] = None,
                 mesh=None, plan=None, place=None,
                 metrics: Optional[MetricsRegistry] = None,
                 transpile: Optional[bool] = None,
                 mem_budget: Optional[float] = None):
        if mesh is not None or plan is not None:
            raise _not_ported("InferenceEngine over a device mesh "
                              "(mesh/plan)", "10")
        if mem_budget is not None:
            raise _not_ported("InferenceEngine(mem_budget=...) (the "
                              "static memory analysis)", "9")
        from ..flags import FLAGS

        if FLAGS.verify_program:
            raise _not_ported("--verify_program (the analysis plane)", "9")
        self.metrics = metrics or MetricsRegistry()
        self.scope = scope or Scope()
        self.model_dir = model_dir
        self.executor = Executor(place if place is not None
                                 else CUDAPlace(0))
        self.device = self.executor.device
        if model_dir is not None:
            from ..io import load_inference_model

            program, feed_names, fetch_names = load_inference_model(
                model_dir, self.executor, scope=self.scope)
        if program is None or not feed_names or not fetch_names:
            raise ValueError("need model_dir or (program, feed_names, "
                             "fetch_names)")
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = list(fetch_names)
        # transpile before warmup, by default only a model loaded from
        # disk (a copy the engine owns): a no-op on a transpiled artefact
        if transpile is None:
            transpile = model_dir is not None
        if transpile:
            from ..transpiler import inference_pipeline

            pm = inference_pipeline()
            self.program = pm.run(self.program.clone(), self.feed_names,
                                  self.fetch_names, scope=self.scope,
                                  preserve_state_writes=True)
            for k, v in pm.metrics_dict().items():
                self.metrics.set_gauge(k, v)
        self.batch_buckets = sorted(set(int(b) for b in batch_buckets))
        self.seq_buckets = (sorted(set(int(s) for s in seq_buckets))
                            if seq_buckets else None)
        # one CUDA graph per bucket on the card, captured at warmup()
        self._use_graphs = self.device.type == "cuda"
        self._graphs: Dict[tuple, tuple] = {}
        self._lock = threading.RLock()  # one run at a time on the executor
        self._closed = False
        self._released = False
        self._inflight = 0
        self._inflight_cond = threading.Condition()

    # ------------------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def _feed_template(self, name: str):
        block = self.program.global_block
        if not block.has_var(name):
            return None, None
        v = block.var(name)
        return list(v.shape or []), v.dtype

    def _validated_arrays(self, feed: Dict[str, np.ndarray]):
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise BadRequestError(f"missing feeds: {missing}")
        arrays = {n: np.asarray(feed[n]) for n in self.feed_names}
        ns = {n: a.shape[0] for n, a in arrays.items()}
        if len(set(ns.values())) != 1:
            raise BadRequestError(f"inconsistent batch sizes: {ns}")
        n = next(iter(ns.values()))
        if n == 0:
            raise BadRequestError("empty batch")
        return arrays, n

    def _admit(self):
        if self._closed:
            raise EngineClosedError(
                "engine is closed (draining or released); no new batches")

    def _track(self, delta: int) -> None:
        with self._inflight_cond:
            self._inflight += delta
            if delta < 0:
                self._inflight_cond.notify_all()

    # ------------------------------------------------------------------
    def run(self, feed: Dict[str, np.ndarray]) -> List[np.ndarray]:
        """Execute one user batch: pad the leading dim to the nearest
        bucket (chunking batches past the largest), run, and return the
        fetches sliced back to the true batch. Every feed and fetch
        carries the batch on axis 0 (the saved-model feed contract)."""
        return self.run_async(feed).result()

    def run_async(self, feed: Dict[str, np.ndarray]) -> PendingInference:
        """:meth:`run` without the wait: every padded chunk is launched
        and its outputs copied out on the device; the handle's
        ``result()`` brings them to the host."""
        self._admit()
        arrays, n = self._validated_arrays(feed)
        parts = []
        start = 0
        while start < n:
            chunk = min(n - start, self.batch_buckets[-1])
            parts.append(self._dispatch_padded(
                {k: a[start:start + chunk] for k, a in arrays.items()},
                chunk))
            start += chunk
        return PendingInference(self, parts)

    def _pad_feed(self, arrays: Dict[str, np.ndarray], n: int):
        bucket = self.bucket_for(n)
        pad = bucket - n
        fed = {}
        for name, a in arrays.items():
            if pad:
                # repeat the last row: numerically safe for any model (an
                # all-zeros row can hit log/div landmines)
                a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
            fed[name] = a
        return fed, bucket

    def _signature(self, fed) -> tuple:
        """A CUDA graph's key: the feed shapes and the AMP and precision
        policies it was captured under (a graph replays the casts, the
        library math modes and the kernel instances it recorded), as the
        JAX executor keys its compiled programs on the policy."""
        return tuple((n, tuple(fed[n].shape)) for n in self.feed_names) \
            + policy_key()

    def _run_program(self, feed):
        return self.executor.run(self.program, feed=feed,
                                 fetch_list=self.fetch_names,
                                 scope=self.scope, return_numpy=False)

    def _dispatch_padded(self, arrays: Dict[str, np.ndarray], n: int):
        fed, bucket = self._pad_feed(arrays, n)
        t0 = time.perf_counter()
        self._track(+1)
        try:
            with self._lock, torch.no_grad():
                if self._use_graphs:
                    outs = self._replay(fed, bucket)
                else:
                    outs = self._run_program(fed)
        finally:
            self._track(-1)
        return outs, bucket, n, t0

    def _replay(self, fed: Dict[str, np.ndarray], bucket: int):
        sig = self._signature(fed)
        entry = self._graphs.get(sig)
        n_feeds = len(self.feed_names)
        if entry is None and any(s[:n_feeds] == sig[:n_feeds]
                                 for s in self._graphs):
            # a warmed shape under a policy flipped since: capture anew
            entry = self._capture({
                name: torch.zeros(fed[name].shape, device=self.device,
                                  dtype=self._feed_template(name)[1])
                for name in self.feed_names})
        if entry is None:
            raise RuntimeError(
                f"no CUDA graph for feed shapes {dict(sig)}: call warmup() "
                f"first (graphs exist for "
                f"{[dict(s) for s in self._graphs]})")
        graph, static_in, static_out = entry
        for name in self.feed_names:
            static_in[name].copy_(torch.from_numpy(
                np.ascontiguousarray(fed[name])), non_blocking=False)
        graph.replay()
        # copied out on the stream, before the next replay can overwrite
        return [o.clone() for o in static_out]

    def _resolve(self, outs, bucket: int, n: int, t0: float):
        res = [to_numpy(o)[:n] for o in outs]
        self.metrics.observe_latency(time.perf_counter() - t0,
                                     name="batch_execute")
        self.metrics.inc("batches_executed")
        self.metrics.inc("rows_executed", n)
        self.metrics.inc("bucket_rows_executed", bucket)
        self.metrics.set_gauge("batch_occupancy", n / bucket)
        return res

    # ------------------------------------------------------------------
    def _zero_feed(self, b: int, s: Optional[int]):
        """A zero feed of batch ``b`` (dynamic non-batch dims at ``s``),
        or None when a feed's shape cannot be resolved."""
        feed = {}
        for name in self.feed_names:
            shape, dtype = self._feed_template(name)
            if shape is None:
                return None
            dims = [b]
            for d in shape[1:]:
                if d in (-1, None):
                    if s is None:
                        return None
                    dims.append(s)
                else:
                    dims.append(int(d))
            feed[name] = torch.zeros(dims, dtype=dtype, device=self.device)
        return feed

    def warmup(self) -> int:
        """Run every bucket shape once before traffic arrives and, on the
        card, capture its CUDA graph. Returns the number of shapes
        warmed; shapes with an unresolved dynamic dim are skipped
        (counted in ``warmup_skipped``)."""
        combos = 0
        shapes = [(b, s) for b in self.batch_buckets
                  for s in (self.seq_buckets or [None])]
        with self._lock, torch.no_grad():
            for b, s in shapes:
                static_in = self._zero_feed(b, s)
                if static_in is None:
                    self.metrics.inc("warmup_skipped")
                    continue
                self._run_program(static_in)  # eager: kernels, workspaces
                if self._use_graphs:
                    self._capture(static_in)
                combos += 1
        self.metrics.inc("warmup_compiles", combos)
        self.metrics.set_gauge("cuda_graphs", len(self._graphs))
        return combos

    def _capture(self, static_in):
        """Capture the program over the static feeds into a CUDA graph
        under the policies now in force, keyed by its signature."""
        graph, outs = _graph_capture(
            lambda feed=static_in: self._run_program(feed), self.device)
        entry = (graph, static_in, list(outs))
        self._graphs[self._signature(static_in)] = entry
        self.metrics.inc("graph_captures")
        self.metrics.set_gauge("cuda_graphs", len(self._graphs))
        return entry

    def cache_stats(self) -> dict:
        return {"graphs": len(self._graphs)}

    # -- later pieces --------------------------------------------------
    def save_manifest(self, dirname: Optional[str] = None):
        raise _not_ported("warmup manifests (save_manifest)", "9")

    def warm_from_manifest(self, dirname: Optional[str] = None):
        raise _not_ported("warmup manifests (warm_from_manifest)", "9")

    def warm_start(self):
        raise _not_ported("warmup manifests (warm_start)", "9")

    def swap_params(self, source, *, strict: bool = True):
        raise _not_ported("swap_params (rolling weight updates)", "7")

    # ------------------------------------------------------------------
    @property
    def state(self) -> str:
        """``ready`` | ``draining`` (closed, in-flight work finishing) |
        ``closed``."""
        if not self._closed:
            return "ready"
        return "closed" if self._released else "draining"

    def close(self, drain: bool = True,
              timeout: Optional[float] = 30.0) -> None:
        """Stop admissions (``run``/``run_async``/``serve_step`` raise
        :class:`EngineClosedError` from now on); with ``drain``, wait for
        the batches in flight on other threads and for the device, then
        release the graphs. Idempotent."""
        with self._inflight_cond:
            self._closed = True
        if drain:
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            with self._inflight_cond:
                while self._inflight > 0:
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        break
                    self._inflight_cond.wait(remaining)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        with self._lock:
            self._graphs.clear()
        self._released = True

    # ------------------------------------------------------------------
    # Server-driver interface
    # ------------------------------------------------------------------
    def serve_step(self, batcher, idle_wait_s: Optional[float] = None) -> bool:
        """Pull one batch from the batcher and execute it. Request
        payloads are per-row feed dicts (no batch dim); rows with equal
        shapes go into one padded run. Every shape group is launched
        before any is brought to the host. Returns True when work was
        done."""
        self._admit()
        reqs = batcher.next_batch(wait_s=idle_wait_s)
        if not reqs:
            return False
        groups: Dict[tuple, list] = {}
        for req in reqs:
            try:
                rows = {n: np.asarray(req.payload[n])
                        for n in self.feed_names}
            except (KeyError, TypeError) as exc:
                req.future.set_exception(BadRequestError(
                    f"payload must be a dict with feeds "
                    f"{self.feed_names}: {exc}"))
                continue
            sig = tuple((n, rows[n].shape) for n in self.feed_names)
            groups.setdefault(sig, []).append((req, rows))

        def fail(members, exc):
            for req, _ in members:
                req.future.set_exception(exc)

        dispatched = []
        for members in groups.values():
            feed = {n: np.stack([rows[n] for _, rows in members])
                    for n in self.feed_names}
            try:
                pending = self.run_async(feed)
            except Exception as exc:  # engine failure fails the batch
                fail(members, exc)
                continue
            dispatched.append((members, pending))
        for members, pending in dispatched:
            try:
                fetched = pending.result()
            except Exception as exc:
                fail(members, exc)
                continue
            now = time.monotonic()
            for i, (req, _) in enumerate(members):
                req.future.set_result([f[i] for f in fetched])
                self.metrics.inc("completed")
                self.metrics.observe_latency(now - req.enqueue_t)
        return True
