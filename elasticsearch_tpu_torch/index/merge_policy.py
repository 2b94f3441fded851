"""Tiered merge policy (a copy of the JAX package's `index/merge_policy.py`):
which contiguous window of segments to merge, and when. It makes the JAX
policy's choices for the same segment list, so both engines end with the
same segments, and so the same global doc ids and tie order.

Merges take a contiguous window of the segment list (doc order, and with it
tie order, is preserved); sizes are live-prorated, so delete-heavy segments
become candidates. Settings (`index.merge.policy.*`): max_merge_at_once
(10) and segments_per_tier (10). The JAX package's max_merged_segment_bytes,
floor_segment_bytes and expunge_deletes_allowed settings are constants here
at its defaults (5gb, 2mb, 10%); their settings wait for a route or caller
that sets them."""

from __future__ import annotations

import math
from dataclasses import dataclass

MAX_MERGED_SEGMENT_BYTES = 5 * 1024 ** 3
FLOOR_SEGMENT_BYTES = 2 * 1024 ** 2
EXPUNGE_DELETES_ALLOWED = 0.10  # share of deleted docs that makes a segment a candidate


@dataclass
class MergeSpec:
    """One planned merge: segment list indices [start, end)."""

    start: int
    end: int


class TieredMergePolicy:
    def __init__(self, settings=None):
        g = settings.get if settings is not None else (lambda k, d=None: d)

        def _f(key, default):
            v = g(key)
            return float(v) if v is not None else default

        self.max_merge_at_once = int(_f("index.merge.policy.max_merge_at_once", 10))
        self.segments_per_tier = max(
            2.0, _f("index.merge.policy.segments_per_tier", 10.0))

    def _size(self, seg) -> int:
        """Live-prorated byte size."""
        total = max(seg.estimated_bytes(), 1)
        docs = max(seg.doc_count, 1)
        live_frac = seg.live_count() / docs
        return max(int(total * live_frac), 1)

    def _floored(self, size: int) -> int:
        return max(size, FLOOR_SEGMENT_BYTES)

    def allowed_segment_count(self, sizes: list[int]) -> int:
        """Tier budget: segments_per_tier per size level, levels growing by
        max_merge_at_once."""
        if not sizes:
            return 0
        total = sum(self._floored(s) for s in sizes)
        level = self._floored(min(sizes))
        allowed = 0.0
        remaining = float(total)
        while True:
            segs_at_level = remaining / level
            if segs_at_level < self.segments_per_tier:
                allowed += math.ceil(segs_at_level)
                break
            allowed += self.segments_per_tier
            remaining -= self.segments_per_tier * level
            level *= self.max_merge_at_once
        return max(int(allowed), 1)

    def find_merge(self, segments: list) -> MergeSpec | None:
        """The best single merge, or None when the index is within budget."""
        n = len(segments)
        if n < 2:
            return None
        sizes = [self._size(s) for s in segments]
        over_budget = n > self.allowed_segment_count(sizes)
        delete_heavy = [
            i for i, s in enumerate(segments)
            if s.doc_count > 0 and
            1.0 - s.live_count() / s.doc_count > EXPUNGE_DELETES_ALLOWED]
        if not over_budget and not delete_heavy:
            return None
        best: tuple[float, MergeSpec] | None = None
        for width in range(2, min(self.max_merge_at_once, n) + 1):
            for start in range(0, n - width + 1):
                window = sizes[start:start + width]
                total = sum(window)
                if total > MAX_MERGED_SEGMENT_BYTES:
                    continue
                if not over_budget and not any(
                        start <= i < start + width for i in delete_heavy):
                    continue
                # skew (lower is better) × size^0.05 (prefer cheap merges)
                floored = [self._floored(s) for s in window]
                score = max(floored) / sum(floored) * (total ** 0.05)
                if best is None or score < best[0]:
                    best = (score, MergeSpec(start, start + width))
        return None if best is None else best[1]
