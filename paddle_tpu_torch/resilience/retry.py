"""Generic bounded-retry policy with exponential backoff.

Counterpart of ``paddle_tpu/resilience/retry.py``: the reference's
master client retries every RPC in a backoff loop; :class:`Retry` is
that loop as a reusable policy object, used by the trainer's
transient-step path.

Every failed attempt is counted in the profiler's StatSet
(``retry/attempts`` / ``retry/recovered`` / ``retry/exhausted``). The
JAX package's ``retry/attempt`` trace span lands with the port's trace
plane (ROADMAP.md Queue 1 item 9).
"""
from __future__ import annotations

import functools
import random
import time
from typing import Callable, Optional, Tuple, Type

from .faults import TransientFault

#: Errors worth retrying by default: transport failures and injected
#: transients. Deliberately NOT OSError at large — a FileNotFoundError is
#: not a flaky network.
DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    ConnectionError, TimeoutError, TransientFault)


class Retry:
    """``Retry(...).call(fn)`` runs ``fn`` until it succeeds, a
    non-retryable error escapes, attempts are exhausted, or the deadline
    passes (whichever first; the last error is re-raised).

    Also usable as a decorator: ``@Retry(max_attempts=3)``.
    """

    def __init__(self, max_attempts: int = 5, backoff: float = 0.05,
                 multiplier: float = 2.0, max_backoff: float = 2.0,
                 jitter: float = 0.0, deadline: Optional[float] = None,
                 retryable: Tuple[Type[BaseException], ...] = DEFAULT_RETRYABLE,
                 retry_on: Optional[Tuple[Type[BaseException], ...]] = None,
                 give_up_on: Tuple[Type[BaseException], ...] = (),
                 name: str = "retry", sleep: Callable[[float], None] = time.sleep):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.backoff = float(backoff)
        self.multiplier = float(multiplier)
        self.max_backoff = float(max_backoff)
        self.jitter = float(jitter)
        self.deadline = deadline
        # ``retry_on`` is the explicit filter spelling (and wins over the
        # legacy ``retryable`` default); ``give_up_on`` carves exceptions
        # OUT of the retryable set — a ConnectionRefusedError subclass a
        # caller knows is permanent must escape on the first attempt.
        self.retryable = tuple(retry_on if retry_on is not None
                               else retryable)
        self.give_up_on = tuple(give_up_on)
        self.name = name
        self._sleep = sleep

    def remaining(self, t_start: float) -> Optional[float]:
        """Seconds left of the absolute deadline measured from
        ``t_start`` (None = unbounded)."""
        if self.deadline is None:
            return None
        return self.deadline - (time.monotonic() - t_start)

    def call(self, fn: Callable, *args,
             on_retry: Optional[Callable] = None, **kwargs):
        from .. import profiler

        t_start = time.monotonic()
        delay = self.backoff
        for attempt in range(1, self.max_attempts + 1):
            try:
                out = fn(*args, **kwargs)
            except self.retryable as exc:
                if self.give_up_on and isinstance(exc, self.give_up_on):
                    raise
                profiler.global_stat.add_count("retry/attempts", 1)
                remaining = self.remaining(t_start)
                if attempt >= self.max_attempts or (
                        remaining is not None and remaining <= 0):
                    profiler.global_stat.add_count("retry/exhausted", 1)
                    raise
                if on_retry is not None:
                    on_retry(exc, attempt)
                sleep_s = min(delay, self.max_backoff)
                if self.jitter:
                    sleep_s += random.uniform(0.0, self.jitter * sleep_s)
                if remaining is not None and sleep_s >= remaining:
                    # the backoff would overshoot the caller's remaining
                    # budget — exhaust NOW instead of sleeping past the
                    # deadline and retrying into certain failure
                    profiler.global_stat.add_count("retry/exhausted", 1)
                    raise
                self._sleep(sleep_s)
                delay *= self.multiplier
                continue
            if attempt > 1:
                profiler.global_stat.add_count("retry/recovered", 1)
            return out

    def wrap(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        return wrapped

    __call__ = wrap

    def __repr__(self):
        return (f"Retry({self.name!r}, max_attempts={self.max_attempts}, "
                f"backoff={self.backoff}, deadline={self.deadline})")
