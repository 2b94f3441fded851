"""Latency histograms (a trimmed copy of the JAX package's `common/metrics.py`
`HistogramMetric`): tail percentiles over fixed log-spaced buckets. The
port's only writer of each histogram is the batcher's drainer thread, so one
leaf lock serves; the JAX package's per-thread lock stripes wait for a slice
with many concurrent writers."""

from __future__ import annotations

import bisect
import threading


class HistogramMetric:
    """Latency histogram over fixed log-spaced buckets (seconds).

    Default bounds double from 100µs to ~105s (21 bounds + overflow), < 2x
    relative error per bucket; percentiles interpolate linearly inside the
    winning bucket. `observe` takes one leaf lock (never blocks, never
    launches)."""

    DEFAULT_BOUNDS = tuple(1e-4 * (2.0 ** i) for i in range(21))

    __slots__ = ("_bounds", "_lock", "_counts", "_count", "_sum")

    def __init__(self, bounds=None):
        self._bounds = tuple(bounds) if bounds is not None else self.DEFAULT_BOUNDS
        self._lock = threading.Lock()
        self._counts = [0] * (len(self._bounds) + 1)  # + overflow (+Inf) bucket
        self._count = 0
        self._sum = 0.0

    def observe(self, seconds: float) -> None:
        v = max(0.0, float(seconds))
        idx = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += v

    def snapshot(self) -> tuple[list[int], int, float]:
        """(per-bucket counts incl. overflow, total count, value sum)."""
        with self._lock:
            return list(self._counts), self._count, self._sum

    def _percentile_from(self, counts, total, q: float) -> float:
        if total <= 0:
            return 0.0
        target = q * total
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self._bounds[i - 1] if i > 0 else 0.0
                hi = self._bounds[i] if i < len(self._bounds) \
                    else self._bounds[-1] * 2.0
                return lo + (hi - lo) * (target - cum) / c
            cum += c
        return self._bounds[-1] * 2.0

    def stats(self) -> dict:
        """Summary: count + mean/p50/p95/p99 in ms."""
        counts, total, vsum = self.snapshot()
        return {
            "count": total,
            "mean_ms": round(vsum / total * 1000.0, 3) if total else 0.0,
            "p50_ms": round(self._percentile_from(counts, total, 0.50) * 1000.0, 3),
            "p95_ms": round(self._percentile_from(counts, total, 0.95) * 1000.0, 3),
            "p99_ms": round(self._percentile_from(counts, total, 0.99) * 1000.0, 3),
        }
