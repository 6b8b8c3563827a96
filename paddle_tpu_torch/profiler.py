"""Profiling and scoped-timer observability.

Counterpart of ``paddle_tpu/profiler.py``:
- ``timer()`` accumulates into the process-global ``StatSet``
  (``global_stat``, the legacy REGISTER_TIMER + printAllStatus), dumped
  by ``print_all_status()``;
- ``profiler()`` + ``record_event`` collect scoped events into a per-name
  table (calls/total/min/max/avg ms), the fluid profiler.

Timing on an asynchronous device: by default a timer measures the host's
wall time of the dispatch. Pass the step's outputs as ``block_on`` (or
``sync=True``) to include device time: ``torch.cuda.synchronize`` runs on
the outputs' CUDA device before the clock stops. A device trace
(``profiler(state="GPU")``), ``xprof_trace`` and ``framework_op_stats``
are not ported: they raise, citing ROADMAP.md Queue 1 item 9.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Optional

_local = threading.local()


class _Stat:
    __slots__ = ("calls", "total", "min", "max", "kind")

    def __init__(self):
        self.calls = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        # "time" (seconds, displayed as ms) or "count" (exact raw
        # numbers). Fixed by the first sample; later samples of the
        # other kind are converted into this entry's display plane so
        # min/max stay in one unit.
        self.kind = None

    def add(self, v):
        self.calls += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def scale(self):
        return 1.0 if self.kind == "count" else 1e3


class StatSet:
    """Named wall-time + count accumulators (the legacy globalStat).

    Two first-class kinds share the table: timers (seconds in, ms out)
    and counts (op-count deltas, sizes — exact numbers in AND out, no
    unit scaling). A name's kind is set by its first sample; the
    table/as_dict column shape is identical for both, so consumers that
    pin it (transpiler tests, serving /metrics) read counts from the
    ms-named columns as raw values."""

    def __init__(self):
        self._stats = defaultdict(_Stat)
        self._lock = threading.Lock()

    def add(self, name, dt):
        with self._lock:
            s = self._stats[name]
            if s.kind is None:
                s.kind = "time"
            # a timer sample on a count-kind name lands as ms (that
            # entry's display unit) instead of polluting min/max with
            # second-scaled values
            s.add(dt if s.kind == "time" else dt * 1e3)

    def add_count(self, name, n):
        """Record a unitless count (op-count deltas, sizes) as a
        first-class count entry: exact values, no ms scaling on
        readback. On a name already carrying timers the count is
        converted to that entry's ms plane (reads back as ``n``)."""
        with self._lock:
            s = self._stats[name]
            if s.kind is None:
                s.kind = "count"
            s.add(n if s.kind == "count" else n / 1e3)

    def reset(self):
        with self._lock:
            self._stats.clear()

    def kind_of(self, name):
        """'time' | 'count' | None (unknown name)."""
        with self._lock:
            s = self._stats.get(name)
            return s.kind if s else None

    def table(self):
        """Rows of (name, calls, total, min, max, avg) — ms for time
        entries, raw exact values for count entries."""
        with self._lock:
            rows = [
                (name, s.calls, s.total * s.scale, s.min * s.scale,
                 s.max * s.scale, s.total / s.calls * s.scale)
                for name, s in sorted(self._stats.items(),
                                      key=lambda kv: -kv[1].total
                                      * kv[1].scale)
            ]
        return rows

    def as_dict(self, prefix: str = ""):
        """JSON-safe export of the timer table (name -> calls/total/min/
        max/avg ms + kind), optionally filtered to names starting with
        ``prefix`` — how the serving /metrics endpoint surfaces its
        engine timers (serving/metrics.py merge_timer_dict). Count-kind
        entries read back exactly through the ms-named keys (the pinned
        shape)."""
        with self._lock:
            kinds = {name: s.kind for name, s in self._stats.items()}
        return {
            name: {"calls": calls, "total_ms": total, "min_ms": mn,
                   "max_ms": mx, "avg_ms": avg,
                   "kind": kinds.get(name, "time")}
            for name, calls, total, mn, mx, avg in self.table()
            if name.startswith(prefix)
        }

    def format(self):
        rows = self.table()
        if not rows:
            return "(no timers recorded)"
        head = f"{'name':<40}{'calls':>8}{'total ms':>12}{'min ms':>10}" \
               f"{'max ms':>10}{'avg ms':>10}"
        lines = [head, "-" * len(head)]
        for name, calls, total, mn, mx, avg in rows:
            lines.append(f"{name:<40}{calls:>8}{total:>12.3f}{mn:>10.3f}"
                         f"{mx:>10.3f}{avg:>10.3f}")
        return "\n".join(lines)


global_stat = StatSet()


def _tensors(value):
    """The torch tensors in a (nested) value."""
    import torch

    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def _device_sync(block_on):
    """Wait for device work: ``torch.cuda.synchronize`` on each CUDA
    device that the tensors in ``block_on`` live on; without ``block_on``
    on the current CUDA device, if CUDA is in use. ``block_on`` may be a
    zero-arg callable resolved at exit time, so a with-block can
    reference outputs it assigns inside:

        with timer("step", block_on=lambda: outs):
            outs = train_step()
    """
    import torch

    if callable(block_on):
        block_on = block_on()
    if block_on is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    for dev in {t.device for t in _tensors(block_on)
                if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def timer(name: str, stat_set: Optional[StatSet] = None, sync: bool = False,
          block_on=None):
    """Scoped timer accumulating into the global StatSet (REGISTER_TIMER).

    Async-dispatch caveat: by default this measures host wall-time of the
    dispatch. To include device time, pass the step's output arrays — or a
    zero-arg callable returning them, e.g. ``block_on=lambda: outs`` where
    the with-block assigns ``outs`` — they are block_until_ready'd before
    the clock stops. ``sync=True`` without ``block_on`` only awaits
    effectful computations.
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync or block_on is not None:
            _device_sync(block_on)
        (stat_set or global_stat).add(name, time.perf_counter() - t0)


def print_all_status(stat_set: Optional[StatSet] = None):
    print((stat_set or global_stat).format())


# ---------------------------------------------------------------------------
# Event profiler (fluid profiler parity)
# ---------------------------------------------------------------------------
class _Profile:
    def __init__(self, sync):
        self.stats = StatSet()
        self.sync = sync


def _active() -> Optional[_Profile]:
    return getattr(_local, "profile", None)


@contextlib.contextmanager
def record_event(name: str, block_on=None):
    """RAII event (platform/profiler.h:97 RecordEvent): no-op unless inside
    a ``profiler()`` context. Pass the step's outputs as ``block_on`` to
    include device time (see ``timer``)."""
    p = _active()
    if p is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if p.sync or block_on is not None:
            _device_sync(block_on)
        p.stats.add(name, time.perf_counter() - t0)


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total",
             sync: bool = False, print_report: bool = True):
    """Collect record_event timings and print the table on exit (mirrors
    fluid.profiler.profiler / EnableProfiler+DisableProfiler). Host
    timings only: ``state="GPU"`` (a device trace) raises."""
    if state == "GPU":
        _not_ported("profiler(state='GPU'), a device trace,")
    p = _Profile(sync)
    prev = _active()
    _local.profile = p
    try:
        yield p
    finally:
        _local.profile = prev  # restore outer profiler when nested
        if print_report:
            print(p.stats.format())


def _not_ported(what):
    raise NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch: the port's trace "
        "plane lands with ROADMAP.md Queue 1 item 9")


@contextlib.contextmanager
def xprof_trace(logdir: str):
    """The JAX package's XProf device trace; not ported."""
    _not_ported("xprof_trace")
    yield


def framework_op_stats(logdir: str, top: Optional[int] = None):
    """Per-op rows from an XProf capture; not ported."""
    _not_ported("framework_op_stats")
