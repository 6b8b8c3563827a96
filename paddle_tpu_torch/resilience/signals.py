"""Graceful-shutdown signal plumbing for preemptible workers.

Counterpart of ``paddle_tpu/resilience/signals.py``. Preemptible
machines get SIGTERM with a short grace window before preemption. :func:`graceful_shutdown` installs
handlers that only set a :class:`ShutdownFlag`; the training loop checks
the flag at step boundaries and performs the orderly exit itself — drain
in-flight async handles, write a final checkpoint, emit
``EndPass(interrupted=True)`` — because none of that is async-signal-safe.

The same flag is the target of the fault plan's ``preempt`` kind, so a
simulated preemption exercises exactly the code path a real SIGTERM does.
"""
from __future__ import annotations

import contextlib
import signal
import threading
from typing import Iterator, Optional, Tuple


class ShutdownFlag:
    """Thread-safe latch: set by a signal handler (or a fault plan),
    polled by the training loop at step boundaries."""

    def __init__(self):
        self._evt = threading.Event()
        self.reason: Optional[str] = None

    def set(self, reason: str = "signal") -> None:
        if not self._evt.is_set():
            self.reason = reason
        self._evt.set()

    def is_set(self) -> bool:
        return self._evt.is_set()

    def clear(self) -> None:
        self._evt.clear()
        self.reason = None

    def __repr__(self):
        return f"ShutdownFlag(set={self.is_set()}, reason={self.reason!r})"


@contextlib.contextmanager
def graceful_shutdown(
        signums: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT),
        flag: Optional[ShutdownFlag] = None) -> Iterator[ShutdownFlag]:
    """Install set-flag-only handlers for ``signums`` for the duration of
    the block; previous handlers are restored on exit. Off the main
    thread (where CPython forbids ``signal.signal``) the flag is still
    yielded — fault-plan preemptions keep working, OS signals don't.
    """
    flag = flag or ShutdownFlag()
    prev = {}

    def _handler(signum, frame):  # noqa: ARG001 - signal API
        flag.set(reason=signal.Signals(signum).name)

    for s in signums:
        try:
            prev[s] = signal.signal(s, _handler)
        except (ValueError, OSError):  # non-main thread / unsupported
            pass
    try:
        yield flag
    finally:
        for s, h in prev.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):
                pass
