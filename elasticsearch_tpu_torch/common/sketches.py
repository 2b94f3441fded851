"""Bounded-memory sketches for aggregations: HyperLogLog++ and a merging
t-digest (a copy of the JAX package's `common/sketches.py`; both are numpy,
so the port's collectors give its partials bitwise).

- HyperLogLogPlusPlus (the `cardinality` aggregation): dense registers (one
  uint8 per 2^p buckets), linear counting for the small range, merge =
  register max. Hashing is a vectorized 64-bit mix (the splitmix finalizer
  over 8-byte chunks), stable across processes, so sketches cross the wire
  between nodes and still merge.
- TDigest (the `percentiles` aggregation): the merging-digest variant with
  the k1 scale function, compressed by binning sorted samples at half-unit
  spacing in k-space; quantile() interpolates between centroid means.
  Memory is O(compression) whatever the sample count.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# stable vectorized 64-bit hashing
# ---------------------------------------------------------------------------

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — full avalanche on uint64 lanes."""
    x = x.astype(np.uint64, copy=True)
    x ^= x >> np.uint64(30)
    x *= _M1
    x ^= x >> np.uint64(27)
    x *= _M2
    x ^= x >> np.uint64(31)
    return x


def hash64_ints(values: np.ndarray) -> np.ndarray:
    """Stable 64-bit hashes for an int/float array (floats hashed by bit pattern,
    so 1.0 and 1 hash differently — distinct values, matching exact-set semantics
    for numeric doc values which are collected as floats consistently)."""
    a = np.asarray(values)
    if a.dtype.kind == "f":
        a = a.astype(np.float64)
        a = np.where(a == 0.0, 0.0, a)  # -0.0 == 0.0 must hash identically
        a = a.view(np.uint64)
    else:
        a = a.astype(np.int64).view(np.uint64)
    return _mix64(a)


def hash64_strs(values) -> np.ndarray:
    """Stable 64-bit hashes for a sequence of strings, vectorized by 8-byte chunks:
    encode to a padded byte matrix, fold each uint64 lane through the mixer, finalize
    with the length so prefixes don't collide with their zero-padded extensions."""
    if len(values) == 0:
        return np.zeros(0, dtype=np.uint64)
    bs = [v.encode("utf-8") if isinstance(v, str) else bytes(v) for v in values]
    out = np.zeros(len(bs), dtype=np.uint64)
    # bucket by chunk count so one oversized outlier can't force padding every value
    # to its width (a 64 KB value among 1M short ones would allocate a 64 GB matrix)
    nchunks = np.array([-(-len(b) // 8) for b in bs], dtype=np.int64)
    for width in np.unique(nchunks):
        sel = np.nonzero(nchunks == width)[0]
        w = max(int(width), 1)
        mat = np.zeros((len(sel), w * 8), dtype=np.uint8)
        lens = np.empty(len(sel), dtype=np.uint64)
        for row, i in enumerate(sel):
            b = bs[i]
            mat[row, : len(b)] = np.frombuffer(b, dtype=np.uint8)
            lens[row] = len(b)
        chunks = mat.view(np.uint64)  # [n, w]
        h = np.full(len(sel), _GOLDEN, dtype=np.uint64)
        for j in range(chunks.shape[1]):
            h = _mix64(h ^ chunks[:, j])
        out[sel] = _mix64(h ^ lens)
    return out


# ---------------------------------------------------------------------------
# HyperLogLog++
# ---------------------------------------------------------------------------

def precision_from_threshold(threshold: int) -> int:
    """Map the user-facing `precision_threshold` knob (counts up to the threshold
    should be near-exact; later-ES default 3000) to a register precision: linear
    counting is near-exact while the load factor stays low, so pick the smallest p
    with 2^p >= 3*threshold. Clamped to [4, 18] like the later-ES knob."""
    p = 4
    while (1 << p) < threshold * 3 and p < 18:
        p += 1
    return p


class HyperLogLogPlusPlus:
    """Dense HLL++ sketch. Memory = 2^precision bytes regardless of cardinality."""

    def __init__(self, precision: int = 14):
        if not 4 <= precision <= 18:
            raise ValueError(f"precision must be in [4,18], got {precision}")
        self.p = precision
        self.m = 1 << precision
        self.registers = np.zeros(self.m, dtype=np.uint8)

    # -- ingest ------------------------------------------------------------
    def add_hashes(self, hashes: np.ndarray):
        if len(hashes) == 0:
            return
        h = hashes.astype(np.uint64, copy=False)
        p = np.uint64(self.p)
        idx = (h >> np.uint64(64 - self.p)).astype(np.int64)
        # rank = leading zeros of the remaining 64-p bits, +1; the sentinel bit
        # caps the rank at (64-p)+1 when those bits are all zero
        w = (h << p) | np.uint64(1 << (self.p - 1))
        # floor(log2(w)) changes only at powers of two, so float64 rounding of the
        # uint64 can be off only when the top 53 bits are all ones — negligible
        rank = (np.uint64(64) - np.floor(np.log2(w.astype(np.float64))).astype(np.uint64)
                ).astype(np.uint8)
        # grouped max per register via sort + reduceat (ufunc.at is ~100x slower)
        order = np.argsort(idx, kind="stable")
        idx_s, rank_s = idx[order], rank[order]
        starts = np.concatenate([[0], np.nonzero(np.diff(idx_s))[0] + 1])
        regs = idx_s[starts]
        best = np.maximum.reduceat(rank_s, starts)
        self.registers[regs] = np.maximum(self.registers[regs], best)

    def add_values(self, values):
        if isinstance(values, np.ndarray) and values.dtype.kind in "ifu":
            self.add_hashes(hash64_ints(values))
        else:
            self.add_hashes(hash64_strs(list(values)))

    # -- estimate ----------------------------------------------------------
    def cardinality(self) -> int:
        regs = self.registers.astype(np.float64)
        m = float(self.m)
        alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(self.m, 0.7213 / (1 + 1.079 / m))
        raw = alpha * m * m / np.sum(np.exp2(-regs))
        zeros = int(np.count_nonzero(self.registers == 0))
        if raw <= 2.5 * m and zeros > 0:
            return int(round(m * np.log(m / zeros)))  # linear counting
        if raw > (1 << 32) / 30.0:
            return int(round(-(1 << 32) * np.log1p(-raw / (1 << 32))))
        return int(round(raw))

    # -- merge / wire ------------------------------------------------------
    def merge(self, other: "HyperLogLogPlusPlus"):
        if other.p != self.p:
            raise ValueError("cannot merge HLL sketches of different precision")
        np.maximum(self.registers, other.registers, out=self.registers)

    def __getstate__(self):
        return {"p": self.p, "registers": self.registers}

    def __setstate__(self, state):
        self.p = state["p"]
        self.m = 1 << self.p
        self.registers = state["registers"]


# ---------------------------------------------------------------------------
# merging t-digest
# ---------------------------------------------------------------------------

class TDigest:
    """Merging t-digest (Dunning): centroid sizes bounded by the k1 scale function
    k(q) = δ/(2π)·asin(2q−1), so tail quantiles stay sharp while the middle
    compresses. ~δ/2 centroids survive compression."""

    BUFFER = 8192

    def __init__(self, compression: float = 100.0):
        self.compression = float(compression)
        self.means = np.zeros(0, dtype=np.float64)
        self.weights = np.zeros(0, dtype=np.float64)
        self._buf: list[np.ndarray] = []
        self._buf_n = 0
        self.total = 0.0
        self._min = np.inf
        self._max = -np.inf

    # -- ingest ------------------------------------------------------------
    def add_values(self, values: np.ndarray):
        v = np.asarray(values, dtype=np.float64)
        if len(v) == 0:
            return
        self._min = min(self._min, float(v.min()))
        self._max = max(self._max, float(v.max()))
        self._buf.append(v)
        self._buf_n += len(v)
        self.total += float(len(v))
        if self._buf_n >= self.BUFFER:
            self._compress()

    def _k(self, q: np.ndarray) -> np.ndarray:
        return self.compression / (2 * np.pi) * np.arcsin(2 * np.clip(q, 0.0, 1.0) - 1)

    def _compress(self):
        if self._buf:
            bmeans = np.concatenate(self._buf)
            means = np.concatenate([self.means, bmeans])
            weights = np.concatenate([self.weights, np.ones(len(bmeans))])
            self._buf, self._buf_n = [], 0
        elif len(self.means) > self.compression:
            means, weights = self.means, self.weights
        else:
            return
        order = np.argsort(means, kind="stable")
        means, weights = means[order], weights[order]
        W = weights.sum()
        # bin sorted points at unit spacing in k-space: every bin's quantile width
        # then satisfies k(q_hi) - k(q_lo) <= 1, the merging-digest size bound
        q_mid = (np.cumsum(weights) - weights / 2) / W
        # half-unit spacing in k-space: ~δ centroids (vs ~δ/2 at unit spacing),
        # which is what keeps the pareto-tail q99 error under ~1%
        bins = np.floor(2.0 * (self._k(q_mid) - self._k(np.array([0.0]))[0])).astype(np.int64)
        starts = np.concatenate([[0], np.nonzero(np.diff(bins))[0] + 1])
        wsum = np.add.reduceat(weights, starts)
        msum = np.add.reduceat(weights * means, starts)
        self.means = msum / wsum
        self.weights = wsum

    # -- query -------------------------------------------------------------
    def quantile(self, q: float) -> float | None:
        self._compress()
        if len(self.means) == 0:
            return None
        if len(self.means) == 1:
            return float(self.means[0])
        q = min(max(float(q), 0.0), 1.0)
        target = q * self.total
        cum = np.cumsum(self.weights) - self.weights / 2
        if target <= cum[0]:
            frac = target / max(cum[0], 1e-12)
            return float(self._min + (self.means[0] - self._min) * frac)
        if target >= cum[-1]:
            span = self.total - cum[-1]
            frac = (target - cum[-1]) / max(span, 1e-12)
            return float(self.means[-1] + (self._max - self.means[-1]) * frac)
        i = int(np.searchsorted(cum, target, side="right") - 1)
        frac = (target - cum[i]) / max(cum[i + 1] - cum[i], 1e-12)
        return float(self.means[i] + (self.means[i + 1] - self.means[i]) * frac)

    # -- merge / wire ------------------------------------------------------
    def merge(self, other: "TDigest"):
        other._compress()
        if other.total == 0:
            return
        self._compress()
        self.means = np.concatenate([self.means, other.means])
        self.weights = np.concatenate([self.weights, other.weights])
        # concatenating two sorted runs yields an UNSORTED array; quantile()
        # interpolates assuming sorted means, and _compress() early-returns
        # without sorting when small — so restore the invariant here
        order = np.argsort(self.means, kind="stable")
        self.means, self.weights = self.means[order], self.weights[order]
        self.total += other.total
        self._min = min(self._min, other._min)
        self._max = max(self._max, other._max)
        if len(self.means) > 2 * self.compression:
            self._force_compress()

    def _force_compress(self):
        self._buf.append(np.zeros(0))  # non-empty buf list triggers the merge pass
        self._compress()

    def __getstate__(self):
        self._compress()
        return {"compression": self.compression, "means": self.means,
                "weights": self.weights, "total": self.total,
                "min": self._min, "max": self._max}

    def __setstate__(self, state):
        self.compression = state["compression"]
        self.means = state["means"]
        self.weights = state["weights"]
        self.total = state["total"]
        self._min = state["min"]
        self._max = state["max"]
        self._buf, self._buf_n = [], 0
