"""Counters, means and latency histograms (a trimmed copy of the JAX
package's `common/metrics.py`): `CounterMetric` and `MeanMetric` (the search
admission controller's rollup and rejections), and `HistogramMetric`, tail
percentiles over fixed log-spaced buckets, lock-striped so concurrent pool
threads do not serialise on one lock, with the cumulative view the
Prometheus exposition renders (rest/controller.py)."""

from __future__ import annotations

import bisect
import threading


class CounterMetric:
    __slots__ = ("_lock", "_count")

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0

    def inc(self, n: int = 1):
        with self._lock:
            self._count += n

    @property
    def count(self) -> int:
        return self._count


class MeanMetric:
    """Tracks (count, sum) — e.g. query count + total time."""

    __slots__ = ("_lock", "_count", "_sum")

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0
        self._sum = 0.0

    def inc(self, value: float):
        with self._lock:
            self._count += 1
            self._sum += value

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0


class _HistogramStripe:
    """One stripe of a HistogramMetric: its own lock and counts. A thread
    maps to a stripe by identity, so concurrent observers mostly take
    distinct locks."""

    __slots__ = ("lock", "counts", "count", "sum")

    def __init__(self, n_buckets: int):
        self.lock = threading.Lock()
        self.counts = [0] * n_buckets
        self.count = 0
        self.sum = 0.0


class HistogramMetric:
    """Latency histogram over fixed log-spaced buckets (seconds).

    Default bounds double from 100µs to ~105s (21 bounds + overflow), < 2x
    relative error per bucket; percentiles interpolate linearly inside the
    winning bucket. Lock-striped: `observe` takes exactly one leaf stripe
    lock (never blocks, never launches); `snapshot` and `percentile` sum
    across the stripes."""

    DEFAULT_BOUNDS = tuple(1e-4 * (2.0 ** i) for i in range(21))
    STRIPES = 8

    __slots__ = ("_bounds", "_stripes")

    def __init__(self, bounds=None):
        self._bounds = tuple(bounds) if bounds is not None else self.DEFAULT_BOUNDS
        n = len(self._bounds) + 1  # + overflow (+Inf) bucket
        self._stripes = [_HistogramStripe(n) for _ in range(self.STRIPES)]

    def observe(self, seconds: float) -> None:
        v = max(0.0, float(seconds))
        idx = bisect.bisect_left(self._bounds, v)
        # not `ident % STRIPES`: on glibc get_ident() is the page-aligned
        # thread descriptor's address, whose low bits every thread shares
        stripe = self._stripes[(threading.get_ident() >> 12) % self.STRIPES]
        with stripe.lock:
            stripe.counts[idx] += 1
            stripe.count += 1
            stripe.sum += v

    def snapshot(self) -> tuple[list[int], int, float]:
        """(per-bucket counts incl. overflow, total count, value sum)."""
        counts = [0] * (len(self._bounds) + 1)
        total = 0
        vsum = 0.0
        for stripe in self._stripes:
            with stripe.lock:
                for i, c in enumerate(stripe.counts):
                    counts[i] += c
                total += stripe.count
                vsum += stripe.sum
        return counts, total, vsum

    @property
    def count(self) -> int:
        return self.snapshot()[1]

    @property
    def sum(self) -> float:
        return self.snapshot()[2]

    def percentile(self, q: float) -> float:
        """q in (0, 1] → seconds; 0.0 when empty."""
        counts, total, _ = self.snapshot()
        return self._percentile_from(counts, total, q)

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

    def cumulative(self) -> tuple[list[tuple[float, int]], int, float]:
        """The Prometheus view: ([(le bound in seconds, cumulative count),
        ...] ending with (inf, total), total count, value sum)."""
        counts, total, vsum = self.snapshot()
        out = []
        cum = 0
        for bound, c in zip(self._bounds, counts):
            cum += c
            out.append((bound, cum))
        out.append((float("inf"), total))
        return out, total, vsum
