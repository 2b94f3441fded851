"""The read side of a shard: a point-in-time Searcher over frozen segments
(a copy of the JAX package's `index/engine.py Searcher`). The durable Engine
(translog, store, merge policy, versioning) belongs to a later slice of the
port; segments come from `SegmentBuilder.freeze()` or `convert.py`."""

from __future__ import annotations

from .segment import FieldStats, FrozenSegment


class Searcher:
    """Point-in-time view over frozen segments. Global doc = segment base +
    local id, bases assigned in segment order."""

    def __init__(self, segments: list[FrozenSegment], version: int = 0):
        self.segments = segments
        self.version = version
        self.bases: list[int] = []
        base = 0
        for seg in segments:
            self.bases.append(base)
            base += seg.doc_count
        self.max_doc = base

    def doc_freq(self, field: str, term: str) -> int:
        return sum(seg.doc_freq(field, term) for seg in self.segments)

    def field_stats(self, field: str) -> FieldStats:
        out = FieldStats()
        for seg in self.segments:
            s = seg.field_stats.get(field)
            if s:
                out = out.merged(s)
        return out
