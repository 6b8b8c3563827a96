"""Typed serving errors — the admission-control contract.

The port's copy of ``paddle_tpu/serving/errors.py``, cut to the errors
the engines and the in-process server raise. Callers distinguish
overload from timeout from bad input by type.
"""
from __future__ import annotations


class ServingError(RuntimeError):
    """Base class for every serving-subsystem failure."""


class QueueFullError(ServingError):
    """Admission rejected: the request queue is at capacity. The
    backpressure signal — clients should retry with backoff."""


class RequestTimeoutError(ServingError):
    """The request's deadline expired before a result was produced."""


class BadRequestError(ServingError):
    """Malformed request payload (prompt longer than the model's context,
    non-positive max_new_tokens, an empty prompt)."""


class EngineClosedError(ServingError):
    """Submit after the server/engine was stopped."""


class CacheExhaustedError(ServingError):
    """The paged KV cache cannot hold this request: the pages its prompt
    + max_new_tokens need exceed what the pool can EVER free for it.

    Carries ``pages_needed`` and ``pages_free`` so callers can size
    retries or shrink the request. Transient pressure (pages held by
    in-flight requests) is NOT this error — the engine defers admission
    and the queue exerts backpressure instead; this fires only when the
    request can never fit.
    """

    def __init__(self, message: str, pages_needed: int = 0,
                 pages_free: int = 0, retry_after_s: float = 1.0):
        super().__init__(message)
        self.pages_needed = int(pages_needed)
        self.pages_free = int(pages_free)
        self.retry_after_s = float(retry_after_s)
