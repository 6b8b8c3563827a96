"""Dynamic request batching with admission control.

Counterpart of ``paddle_tpu/serving/batcher.py``: requests queue; the
dispatch loop coalesces them into the smallest bucket that covers the
backlog, waiting at most ``max_wait_ms`` past the OLDEST queued request
before dispatching a partial batch. Admission is bounded (``max_queue``)
and rejection is a typed error (QueueFullError). Each request carries a
deadline; requests that expire while queued complete with
RequestTimeoutError. Request tracing and the fault-injection hook come
with the observability and chaos slices.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, List, Optional, Sequence

from .errors import EngineClosedError, QueueFullError, RequestTimeoutError


class Future:
    """Minimal completion handle: ``result(timeout)`` blocks for the
    value or re-raises the failure set by the serving loop."""

    def __init__(self):
        self._done = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def set_result(self, value) -> None:
        self._result = value
        self._done.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("result not ready")
        if self._exc is not None:
            raise self._exc
        return self._result


class Request:
    """One queued unit of work: an opaque payload plus scheduling state."""

    __slots__ = ("payload", "meta", "future", "enqueue_t", "deadline")

    def __init__(self, payload: Any, meta: dict,
                 timeout_ms: Optional[float]):
        self.payload = payload
        self.meta = meta
        self.future = Future()
        self.enqueue_t = time.monotonic()
        self.deadline = (self.enqueue_t + timeout_ms / 1e3
                         if timeout_ms else None)

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now or time.monotonic()) >= self.deadline)


class DynamicBatcher:
    """Bounded request queue + bucket-deadline batch former.

    buckets: ascending batch-size buckets; a batch is dispatched once the
    backlog covers the largest bucket or the oldest request has waited
    ``max_wait_ms``.
    """

    def __init__(self, buckets: Sequence[int] = (1, 2, 4, 8),
                 max_wait_ms: float = 5.0, max_queue: int = 256,
                 default_timeout_ms: Optional[float] = None,
                 metrics=None):
        if not buckets:
            raise ValueError("need at least one batch bucket")
        self.buckets = sorted(set(int(b) for b in buckets))
        self.max_wait_s = max_wait_ms / 1e3
        self.max_queue = int(max_queue)
        self.default_timeout_ms = default_timeout_ms
        self.metrics = metrics
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._closed = False

    # -- admission ---------------------------------------------------------
    def submit(self, payload: Any, timeout_ms: Optional[float] = None,
               **meta) -> Future:
        """Enqueue a request; raises QueueFullError at capacity (the
        backpressure contract) and EngineClosedError after close()."""
        req = Request(payload, meta,
                      timeout_ms if timeout_ms is not None
                      else self.default_timeout_ms)
        with self._cond:
            if self._closed:
                raise EngineClosedError("batcher is closed")
            if len(self._q) >= self.max_queue:
                if self.metrics:
                    self.metrics.inc("rejected_queue_full")
                raise QueueFullError(
                    f"queue at capacity ({self.max_queue}); retry with "
                    "backoff")
            self._q.append(req)
            if self.metrics:
                self.metrics.inc("requests")
                self.metrics.set_gauge("queue_depth", len(self._q))
            self._cond.notify_all()
        return req.future

    # -- dispatch ----------------------------------------------------------
    def _expire_locked(self, now: float) -> None:
        kept = deque()
        for req in self._q:
            if req.expired(now):
                if self.metrics:
                    self.metrics.inc("timeouts")
                req.future.set_exception(RequestTimeoutError(
                    "request deadline expired before execution"))
            else:
                kept.append(req)
        self._q = kept

    def next_batch(self, max_n: Optional[int] = None,
                   wait_s: Optional[float] = None) -> List[Request]:
        """Form the next batch, blocking up to ``wait_s`` (default: the
        bucket deadline) for work. Returns [] when nothing is ready —
        the serving loop's idle signal, never an error."""
        cap = self.buckets[-1] if max_n is None else min(
            max_n, self.buckets[-1])
        if cap <= 0:
            return []
        with self._cond:
            deadline0 = time.monotonic() + (
                wait_s if wait_s is not None else self.max_wait_s)
            while not self._q and not self._closed:
                remaining = deadline0 - time.monotonic()
                if remaining <= 0:
                    return []
                self._cond.wait(remaining)
            if not self._q:
                return []
            # bucket deadline, measured from the OLDEST request's arrival.
            # wait_s == 0 is the continuous-batching poll: grab whatever
            # is queued now (mid-flight joins must not stall decode ticks)
            if wait_s != 0:
                batch_deadline = self._q[0].enqueue_t + self.max_wait_s
                while (len(self._q) < cap and not self._closed
                       and time.monotonic() < batch_deadline):
                    self._cond.wait(batch_deadline - time.monotonic())
            self._expire_locked(time.monotonic())
            batch = []
            while self._q and len(batch) < cap:
                batch.append(self._q.popleft())
            if self.metrics:
                self.metrics.set_gauge("queue_depth", len(self._q))
        if batch and self.metrics:
            self.metrics.inc("batches")
            self.metrics.inc("batched_requests", len(batch))
        return batch

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def close(self) -> None:
        """Stop admitting and fail everything still queued."""
        with self._cond:
            self._closed = True
            pending = list(self._q)
            self._q.clear()
            self._cond.notify_all()
        for req in pending:
            req.future.set_exception(EngineClosedError("server stopped"))
