"""Typed serving errors — the admission-control contract.

The port's copy of ``paddle_tpu/serving/errors.py``, cut to the errors
the dense engine and the in-process server raise. Callers distinguish
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
