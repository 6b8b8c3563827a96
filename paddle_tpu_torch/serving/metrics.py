"""Serving metrics registry: counters, gauges, latency quantiles and
fixed-bucket histograms.

Counterpart of ``paddle_tpu/serving/metrics.py``: one registry per
Server/engine (no global singleton), exported as a plain JSON-safe dict
snapshot. The device gauges read ``torch.cuda``'s allocator. Fleet
merging and Prometheus export come with the fleet slice.
"""
from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Sequence

import torch

# Latency reservoir size: enough for stable p99 without unbounded growth
# under sustained traffic (oldest samples fall off).
_RESERVOIR = 4096
# Sliding window for the QPS gauge.
_QPS_WINDOW_S = 10.0

#: Fixed log-spaced histogram bucket bounds (seconds): 100 µs .. 100 s,
#: four buckets per decade; shared by every registry so per-replica
#: bucket counts sum exactly.
HIST_BUCKET_BOUNDS: List[float] = [
    round(1e-4 * 10 ** (k / 4.0), 10) for k in range(25)]


def _quantile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def hist_quantile(counts: Sequence[int], q: float) -> float:
    """Quantile (seconds) from per-bucket counts, linearly interpolated
    inside the owning bucket. ``counts`` has one entry per bound plus an
    overflow bucket, read as its lower bound."""
    bounds = HIST_BUCKET_BOUNDS
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if cum + c >= target:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            frac = min(1.0, max(0.0, (target - cum) / c))
            return lo + frac * (hi - lo)
        cum += c
    return bounds[-1]


class MetricsRegistry:
    """Thread-safe counters/gauges/latency-histograms for one server."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = defaultdict(int)
        self._gauges: Dict[str, float] = {}
        self._latencies: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=_RESERVOIR))
        self._hist: Dict[str, List[int]] = {}
        self._hist_sum: Dict[str, float] = defaultdict(float)
        self._completions = deque()  # timestamps for the QPS window
        # labeled gauge series: name -> {(("k","v"),...) -> value}
        self._labeled: Dict[str, Dict[tuple, float]] = defaultdict(dict)
        self._t0 = time.monotonic()

    # -- write side --------------------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] += n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def set_labeled(self, name: str, value: float, **labels) -> None:
        """Set one sample of a labeled gauge series, e.g.
        ``set_labeled("goodput_seconds_total", 1.5, bucket="data_wait")``."""
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            self._labeled[name][key] = float(value)

    def _hist_observe_locked(self, name: str, seconds: float) -> None:
        counts = self._hist.get(name)
        if counts is None:
            counts = self._hist[name] = [0] * (len(HIST_BUCKET_BOUNDS) + 1)
        counts[bisect.bisect_left(HIST_BUCKET_BOUNDS, seconds)] += 1
        self._hist_sum[name] += seconds

    def observe_hist(self, name: str, seconds: float) -> None:
        """Observe one duration into the fixed-bucket histogram plane
        (TTFT / TPOT / queue wait)."""
        with self._lock:
            self._hist_observe_locked(name, float(seconds))

    def observe_latency(self, seconds: float, name: str = "request") -> None:
        now = time.monotonic()
        with self._lock:
            self._latencies[name].append(float(seconds))
            self._hist_observe_locked(name, float(seconds))
            if name == "request":
                self._completions.append(now)
                cutoff = now - _QPS_WINDOW_S
                while self._completions and self._completions[0] < cutoff:
                    self._completions.popleft()

    # -- read side ---------------------------------------------------------
    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def snapshot(self) -> dict:
        """Plain-dict export: counters, gauges, per-name latency quantiles
        (ms), histograms, windowed QPS, uptime."""
        now = time.monotonic()
        with self._lock:
            lat = {}
            for name, buf in self._latencies.items():
                vals = sorted(buf)
                lat[name + "_ms"] = {
                    "count": len(vals),
                    "mean": (sum(vals) / len(vals) * 1e3) if vals else 0.0,
                    "p50": _quantile(vals, 0.50) * 1e3,
                    "p95": _quantile(vals, 0.95) * 1e3,
                    "p99": _quantile(vals, 0.99) * 1e3,
                }
            hist = {}
            for name, counts in self._hist.items():
                hist[name] = {
                    "counts": list(counts),
                    "count": sum(counts),
                    "sum_ms": self._hist_sum[name] * 1e3,
                    "p50_ms": hist_quantile(counts, 0.50) * 1e3,
                    "p95_ms": hist_quantile(counts, 0.95) * 1e3,
                    "p99_ms": hist_quantile(counts, 0.99) * 1e3,
                }
            cutoff = now - _QPS_WINDOW_S
            qps_n = sum(1 for t in self._completions if t >= cutoff)
            labeled = {name: {"{" + ",".join(f'{k}="{v}"'
                                             for k, v in key) + "}": val
                              for key, val in series.items()}
                       for name, series in self._labeled.items()}
            snap = {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "latency": lat,
                "hist": hist,
                "qps": qps_n / min(max(now - self._t0, 1e-9), _QPS_WINDOW_S),
                "uptime_s": now - self._t0,
            }
            if labeled:
                snap["labeled"] = labeled
            return snap

    def update_device_gauges(self) -> None:
        """Refresh ``mem/cuda<N>_*`` gauges from the CUDA caching
        allocator (bytes in use, reserved, peak). No-op without CUDA."""
        if not torch.cuda.is_available():
            return
        for i in range(torch.cuda.device_count()):
            self.set_gauge(f"mem/cuda{i}_bytes_in_use",
                           torch.cuda.memory_allocated(i))
            self.set_gauge(f"mem/cuda{i}_bytes_reserved",
                           torch.cuda.memory_reserved(i))
            self.set_gauge(f"mem/cuda{i}_peak_bytes_in_use",
                           torch.cuda.max_memory_allocated(i))
