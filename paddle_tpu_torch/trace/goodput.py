"""Goodput/badput accounting for the training plane.

Counterpart of ``paddle_tpu/trace/goodput.py``. ``GoodputMeter`` is the
one accumulator the trainer loops drive, so every second of a run is
attributable to exactly one bucket:

=================  =====================================================
bucket             what it measures
=================  =====================================================
device_compute     the steps' time on the device (the goodput)
host_dispatch      python-side dispatch/bookkeeping between steps
data_wait          blocked on the reader / feed pipeline
fresh_compile      first compilation of a program shape (the port runs
                   eagerly and compiles nothing: its trainer accounts
                   nothing here)
checkpoint_stall   step loop stalled on checkpoint save/commit
recovery_rollback  transient-fault step retries (backoff included)
=================  =====================================================

The meter is explicit: trainer code times its own regions via
:meth:`measure`/:meth:`account`, one clock read per region. The
synchronous loop books each step's run wall (the run returns host
values, so it waited for the device) as ``device_compute``. The
pipelined loop books each step's span on the CUDA stream, read from
events at dispatch and after the step's last kernel
(``RunHandle.device_seconds``): there the host blocks inside dispatch
once CUDA's launch queue is full, so no host clock can tell the
device's time from the host's.

MFU: :meth:`set_program_flops` plus per-step :meth:`note_step` device
walls give achieved FLOP/s over ``peak_flops``. The port has no analysis
plane to price a program yet, and no default peak (ROADMAP.md Queue 1
item 9), so MFU stays None unless the caller gives both.

Publishing: :meth:`publish` pushes ``goodput_seconds_total{bucket=...}``
labeled series, ``goodput_fraction``/``mfu`` gauges and the cumulative
``goodput_good_ms_total``/``goodput_total_ms_total`` counter pair into the
port's ``serving.MetricsRegistry``; :meth:`publish_stats` mirrors the
buckets into a profiler ``StatSet``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

# Ordered: the first bucket is the goodput numerator.
BUCKETS = (
    "device_compute",
    "host_dispatch",
    "data_wait",
    "fresh_compile",
    "checkpoint_stall",
    "recovery_rollback",
)

#: default EMA smoothing for the mfu gauge
MFU_EMA_ALPHA = 0.1


class GoodputMeter:
    """Cumulative per-bucket wall accounting + live MFU for one run.

    Thread-safe: a feed thread may account into it while the step loop
    accounts the compute buckets.
    """

    def __init__(self, peak_flops: Optional[float] = None,
                 ema_alpha: float = MFU_EMA_ALPHA):
        # no default peak: MFU needs the caller's (ROADMAP item 9)
        self.peak_flops = None if peak_flops is None else float(peak_flops)
        self.ema_alpha = float(ema_alpha)
        self._lock = threading.Lock()
        self._seconds: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._program_flops: Optional[float] = None
        self._steps = 0
        self._mfu: Optional[float] = None
        self._mfu_ema: Optional[float] = None
        # already-published cumulative ms (registry counters are
        # monotonic, so publish() incs only the delta)
        self._pub_good_ms = 0
        self._pub_total_ms = 0

    # -- accounting --------------------------------------------------
    def account(self, bucket: str, dt: float) -> None:
        """Add ``dt`` seconds to ``bucket`` (negative deltas clamp to 0)."""
        if bucket not in self._seconds:
            raise KeyError(f"unknown goodput bucket: {bucket!r}")
        if dt <= 0.0:
            return
        with self._lock:
            self._seconds[bucket] += dt

    @contextlib.contextmanager
    def measure(self, bucket: str):
        """Time a region into ``bucket``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.account(bucket, time.perf_counter() - t0)

    def move(self, src: str, dst: str, dt: float) -> None:
        """Re-attribute ``dt`` seconds from ``src`` to ``dst`` (e.g. a
        fresh compile discovered inside a timed dispatch region). Moves
        at most what ``src`` holds."""
        if dt <= 0.0:
            return
        with self._lock:
            dt = min(dt, self._seconds[src])
            self._seconds[src] -= dt
            self._seconds[dst] += dt

    def bucket_seconds(self, bucket: str) -> float:
        with self._lock:
            return self._seconds[bucket]

    # -- MFU ---------------------------------------------------------
    def set_program_flops(self, flops: Optional[float]) -> None:
        """Per-step program FLOPs (``analyze_memory(...).total_flops``);
        None/<=0 disables MFU."""
        with self._lock:
            self._program_flops = (float(flops)
                                   if flops and flops > 0 else None)

    def note_step(self, device_s: float) -> Optional[float]:
        """Record one step's measured device wall; returns the step's
        MFU (None when flops unknown or the wall is degenerate)."""
        with self._lock:
            self._steps += 1
            if (self._program_flops is None or device_s <= 0.0
                    or not self.peak_flops or self.peak_flops <= 0.0):
                return None
            mfu = self._program_flops / device_s / self.peak_flops
            self._mfu = mfu
            if self._mfu_ema is None:
                self._mfu_ema = mfu
            else:
                a = self.ema_alpha
                self._mfu_ema = a * mfu + (1.0 - a) * self._mfu_ema
            return mfu

    @property
    def mfu(self) -> Optional[float]:
        with self._lock:
            return self._mfu

    @property
    def mfu_ema(self) -> Optional[float]:
        with self._lock:
            return self._mfu_ema

    @property
    def steps(self) -> int:
        with self._lock:
            return self._steps

    # -- readout -----------------------------------------------------
    def total_seconds(self) -> float:
        with self._lock:
            return sum(self._seconds.values())

    def goodput_fraction(self) -> Optional[float]:
        """device_compute / total, None before any accounting."""
        with self._lock:
            total = sum(self._seconds.values())
            if total <= 0.0:
                return None
            return self._seconds["device_compute"] / total

    def snapshot(self) -> dict:
        """JSON-safe cumulative view (seconds per bucket, total,
        goodput fraction, steps, mfu + ema)."""
        with self._lock:
            total = sum(self._seconds.values())
            return {
                "buckets": {b: round(self._seconds[b], 6)
                            for b in BUCKETS},
                "total_s": round(total, 6),
                "goodput": (round(self._seconds["device_compute"]
                                  / total, 4) if total > 0 else None),
                "steps": self._steps,
                "mfu": (round(self._mfu, 4)
                        if self._mfu is not None else None),
                "mfu_ema": (round(self._mfu_ema, 4)
                            if self._mfu_ema is not None else None),
            }

    # -- publication -------------------------------------------------
    def publish(self, registry, **labels) -> None:
        """Push the current state into a ``serving.MetricsRegistry``:
        labeled ``goodput_seconds_total{bucket=...}`` series, the
        ``goodput_fraction``/``mfu``/``mfu_ema`` gauges, and the
        monotonic ``goodput_good_ms_total``/``goodput_total_ms_total``
        counter pair the SLO ratio objective differentiates. Extra
        ``labels`` ride every labeled sample (e.g. ``trainer="t0"``)."""
        with self._lock:
            seconds = dict(self._seconds)
            mfu, ema = self._mfu, self._mfu_ema
            total = sum(seconds.values())
            good_ms = int(seconds["device_compute"] * 1e3)
            total_ms = int(total * 1e3)
            d_good = good_ms - self._pub_good_ms
            d_total = total_ms - self._pub_total_ms
            self._pub_good_ms, self._pub_total_ms = good_ms, total_ms
        for b in BUCKETS:
            registry.set_labeled("goodput_seconds_total", seconds[b],
                                 bucket=b, **labels)
        if total > 0:
            registry.set_gauge("goodput_fraction",
                               seconds["device_compute"] / total)
        if mfu is not None:
            registry.set_gauge("mfu", mfu)
        if ema is not None:
            registry.set_gauge("mfu_ema", ema)
        if d_good > 0:
            registry.inc("goodput_good_ms_total", d_good)
        if d_total > 0:
            registry.inc("goodput_total_ms_total", d_total)

    def publish_stats(self, stat_set, prefix: str = "goodput/") -> None:
        """Mirror cumulative bucket seconds into a profiler ``StatSet``
        as ``goodput/<bucket>`` timer entries (cumulative: each call
        adds only the un-mirrored delta), so pass-end runlog rows carry
        the waterfall."""
        with self._lock:
            seconds = dict(self._seconds)
        mirrored = getattr(self, "_mirrored", None)
        if mirrored is None:
            mirrored = self._mirrored = {b: 0.0 for b in BUCKETS}
        for b in BUCKETS:
            delta = seconds[b] - mirrored[b]
            if delta > 0.0:
                stat_set.add(prefix + b, delta)
                mirrored[b] = seconds[b]

    def telemetry(self, last_step_wall_s: Optional[float] = None) -> dict:
        """Compact heartbeat payload for the master's straggler plane."""
        snap = self.snapshot()
        out = {"steps": snap["steps"], "goodput": snap["goodput"],
               "mfu": snap["mfu_ema"] or snap["mfu"]}
        if last_step_wall_s is not None:
            out["step_wall_s"] = round(float(last_step_wall_s), 6)
        return out
