"""Write-once segments (a trimmed copy of the JAX package's `index/segment.py`:
the Python-dict path of SegmentBuilder and the read side of FrozenSegment).

A segment is flat numpy arrays laid out for device packing: postings are CSR
over term ids — `post_offsets[t]:post_offsets[t+1]` slices `post_docs`
(ascending local doc ids) and `post_freqs`; norms are one byte315 byte per
doc per field; deletes are tombstones in the `live` bitmap."""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np

from ..common.smallfloat import encode_norm
from ..mapper.core import ParsedDocument

_LIVE_GEN = 0  # process-wide tombstone generation (see FrozenSegment.live_gen)


@dataclass
class FieldStats:
    """Per-field corpus statistics a similarity needs: doc_count = docs with
    the field, sum_ttf = total term occurrences (for avgdl)."""

    doc_count: int = 0
    sum_ttf: int = 0
    sum_dfs: int = 0

    def merged(self, other: "FieldStats") -> "FieldStats":
        return FieldStats(self.doc_count + other.doc_count,
                          self.sum_ttf + other.sum_ttf,
                          self.sum_dfs + other.sum_dfs)


class SegmentBuilder:
    """Accumulates parsed documents, freezes into a FrozenSegment."""

    def __init__(self, gen: int):
        self.gen = gen
        # (field, term) -> list of (local_doc, freq)
        self._postings: dict[tuple[str, str], list[tuple[int, int]]] = {}
        self._field_lengths: dict[str, list[tuple[int, int]]] = {}
        self._ids: list[str] = []
        self.doc_count = 0

    def add(self, doc: ParsedDocument) -> int:
        """Add one parsed document; returns its local doc id."""
        local = self.doc_count
        self.doc_count += 1
        for field_name, terms in doc.postings.items():
            per_term: dict[str, int] = {}
            for term, _pos in terms:
                per_term[term] = per_term.get(term, 0) + 1
            for term, freq in per_term.items():
                self._postings.setdefault((field_name, term), []).append(
                    (local, freq))
        for field_name, length in doc.field_lengths.items():
            self._field_lengths.setdefault(field_name, []).append((local, length))
        self._ids.append(doc.id)
        return local

    def freeze(self) -> "FrozenSegment":
        D = self.doc_count
        # fields sorted by name, terms sorted per field, docs ascending per term
        by_field: dict[str, list[str]] = {}
        for f, t in self._postings:
            by_field.setdefault(f, []).append(t)
        term_dict: dict[str, dict[str, int]] = {}
        offsets = [0]
        docs_parts, freqs_parts = [], []
        sum_dfs_by_field: dict[str, int] = {}
        tid = 0
        for f in sorted(by_field):
            td: dict[str, int] = {}
            for t in sorted(by_field[f]):
                plist = sorted(self._postings[(f, t)])
                sum_dfs_by_field[f] = sum_dfs_by_field.get(f, 0) + len(plist)
                td[t] = tid
                docs_parts.append(np.fromiter((e[0] for e in plist),
                                              dtype=np.int32, count=len(plist)))
                freqs_parts.append(np.fromiter((e[1] for e in plist),
                                               dtype=np.float32, count=len(plist)))
                offsets.append(offsets[-1] + len(plist))
                tid += 1
            term_dict[f] = td
        post_docs = (np.concatenate(docs_parts) if docs_parts
                     else np.zeros(0, np.int32))
        post_freqs = (np.concatenate(freqs_parts) if freqs_parts
                      else np.zeros(0, np.float32))

        norms: dict[str, np.ndarray] = {}
        field_stats: dict[str, FieldStats] = {}
        for f, entries in self._field_lengths.items():
            lengths = np.zeros(D, dtype=np.int64)
            for local, ln in entries:
                lengths[local] += ln
            norms[f] = encode_norm(lengths)
            field_stats[f] = FieldStats(
                doc_count=int((lengths > 0).sum()), sum_ttf=int(lengths.sum()),
                sum_dfs=sum_dfs_by_field.get(f, 0))

        return FrozenSegment(
            gen=self.gen,
            doc_count=D,
            term_dict=term_dict,
            post_offsets=np.asarray(offsets, dtype=np.int64),
            post_docs=post_docs,
            post_freqs=post_freqs,
            norms=norms,
            field_stats=field_stats,
            live=np.ones(D, dtype=bool),
            parent_mask=np.ones(D, dtype=bool),
            ids=list(self._ids),
        )


@dataclass
class FrozenSegment:
    gen: int
    doc_count: int
    term_dict: dict[str, dict[str, int]]
    post_offsets: np.ndarray  # int64[T+1]
    post_docs: np.ndarray  # int32[P]
    post_freqs: np.ndarray  # float32[P]
    norms: dict[str, np.ndarray]  # field -> uint8[D]
    field_stats: dict[str, FieldStats]
    live: np.ndarray  # bool[D] — tombstones
    parent_mask: np.ndarray  # bool[D] — top-level (searchable) docs
    ids: list | None = None  # external doc ids, when known
    # per-device packed planes (ops/device_index.packed_for), keyed by device
    _device_cache: dict = dc_field(default_factory=dict, repr=False, compare=False)
    # bumped on every tombstone: a pack built under an older generation is
    # re-masked before it serves again
    live_gen: int = 0

    def term_id(self, field: str, term: str) -> int | None:
        td = self.term_dict.get(field)
        if td is None:
            return None
        return td.get(term)

    def doc_freq(self, field: str, term: str) -> int:
        tid = self.term_id(field, term)
        if tid is None:
            return 0
        return int(self.post_offsets[tid + 1] - self.post_offsets[tid])

    def delete_doc(self, local: int) -> None:
        """Tombstone a doc in place."""
        global _LIVE_GEN
        self.live[local] = False
        _LIVE_GEN += 1
        self.live_gen = _LIVE_GEN
