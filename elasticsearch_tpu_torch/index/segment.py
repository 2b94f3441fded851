"""Write-once segments (a trimmed copy of the JAX package's `index/segment.py`:
the Python-dict path of SegmentBuilder, FrozenSegment, copy-on-write
tombstoning and `merge_segments`).

A segment is flat numpy arrays laid out for device packing: postings are CSR
over term ids — `post_offsets[t]:post_offsets[t+1]` slices `post_docs`
(ascending local doc ids), `post_freqs` and, per posting, its positions;
norms are one byte315 byte per doc per field; numeric doc values are CSR
float64 columns; string fields keep each doc's count of values
(`str_counts`, what `exists` reads; the values themselves are a later
slice); `_source`, ids, types, routings and versions are stored per doc for
the fetch phase and realtime gets; deletes are tombstones in the `live`
bitmap. Nested documents belong to a later slice of the port.

The read API of the host scorer (`postings`, `term_positions`,
`terms_for_field`, `num_values`) has the JAX package's
semantics. A segment built from arrays by `convert.py` has no ids, types or
positions: what needs them raises instead of answering "no match"."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field as dc_field

import numpy as np

from ..common.errors import IllegalArgumentError
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
    """Accumulates parsed documents (the indexing buffer), freezes into a
    FrozenSegment with the JAX package's exact CSR layout: fields sorted by
    name, terms sorted per field, docs ascending per term."""

    def __init__(self, gen: int):
        self.gen = gen
        # (field, term) -> list of (local_doc, freq, positions)
        self._postings: dict[tuple[str, str], list] = {}
        self._field_lengths: dict[str, list[tuple[int, int]]] = {}
        self._dv_num: dict[str, list[tuple[int, float]]] = {}
        self._str_counts: dict[str, list[tuple[int, int]]] = {}
        self._stored: list[dict | None] = []
        self._ids: list[str] = []
        self._types: list[str] = []
        self._routings: list[str | None] = []
        self._versions: list[int] = []
        self.doc_count = 0

    def add(self, doc: ParsedDocument, version: int = 1) -> int:
        """Add one parsed document; returns its local doc id."""
        local = self.doc_count
        self.doc_count += 1
        for field_name, terms in doc.postings.items():
            per_term: dict[str, list[int]] = {}
            for term, pos in terms:
                per_term.setdefault(term, []).append(pos)
            for term, positions in per_term.items():
                self._postings.setdefault((field_name, term), []).append(
                    (local, len(positions), positions))
        for field_name, length in doc.field_lengths.items():
            self._field_lengths.setdefault(field_name, []).append((local, length))
        for field_name, vals in doc.doc_values_num.items():
            self._dv_num.setdefault(field_name, []).extend((local, v) for v in vals)
        for field_name, n in doc.str_value_counts.items():
            self._str_counts.setdefault(field_name, []).append((local, n))
        self._stored.append(doc.source)
        self._ids.append(doc.id)
        self._types.append(doc.type)
        self._routings.append(doc.routing)
        self._versions.append(version)
        return local

    def freeze(self) -> "FrozenSegment":
        D = self.doc_count
        by_field: dict[str, list[str]] = {}
        for f, t in self._postings:
            by_field.setdefault(f, []).append(t)
        term_dict: dict[str, dict[str, int]] = {}
        offsets = [0]
        docs_parts, freqs_parts, pos_offsets, pos_parts = [], [], [0], []
        sum_dfs_by_field: dict[str, int] = {}
        tid = 0
        for f in sorted(by_field):
            td: dict[str, int] = {}
            for t in sorted(by_field[f]):
                plist = self._postings[(f, t)]
                plist.sort(key=lambda e: e[0])
                sum_dfs_by_field[f] = sum_dfs_by_field.get(f, 0) + len(plist)
                td[t] = tid
                docs_parts.append(np.fromiter((e[0] for e in plist),
                                              dtype=np.int32, count=len(plist)))
                freqs_parts.append(np.fromiter((e[1] for e in plist),
                                               dtype=np.float32, count=len(plist)))
                for e in plist:
                    pos_parts.extend(e[2])
                    pos_offsets.append(len(pos_parts))
                offsets.append(offsets[-1] + len(plist))
                tid += 1
            term_dict[f] = td

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

        dv_num: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        for f, entries in self._dv_num.items():
            entries.sort(key=lambda e: e[0])
            counts = np.zeros(D + 1, dtype=np.int64)
            for local, _ in entries:
                counts[local + 1] += 1
            vals = np.fromiter((v for _, v in entries), dtype=np.float64,
                               count=len(entries))
            dv_num[f] = (np.cumsum(counts), vals)

        str_counts: dict[str, np.ndarray] = {}
        for f, entries in self._str_counts.items():
            col = np.zeros(D, dtype=np.int32)
            for local, n in entries:
                col[local] += n
            str_counts[f] = col

        return FrozenSegment(
            gen=self.gen,
            doc_count=D,
            term_dict=term_dict,
            post_offsets=np.asarray(offsets, dtype=np.int64),
            post_docs=(np.concatenate(docs_parts) if docs_parts
                       else np.zeros(0, np.int32)),
            post_freqs=(np.concatenate(freqs_parts) if freqs_parts
                        else np.zeros(0, np.float32)),
            norms=norms,
            field_stats=field_stats,
            live=np.ones(D, dtype=bool),
            parent_mask=np.ones(D, dtype=bool),
            ids=list(self._ids),
            types=list(self._types),
            routings=list(self._routings),
            versions=np.asarray(self._versions, dtype=np.int64),
            stored=list(self._stored),
            pos_offsets=np.asarray(pos_offsets, dtype=np.int64),
            positions=np.asarray(pos_parts, dtype=np.int32),
            dv_num=dv_num,
            str_counts=str_counts,
        )


# the port's per-segment filter cache under `_device_cache` (search/filters.py)
FILTER_CACHE_KEY = ("filters",)


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
    # the stored side (None for a segment built from arrays by convert.py)
    types: list | None = None
    routings: list | None = None
    versions: np.ndarray | None = None  # int64[D]
    stored: list | None = None  # _source per doc
    pos_offsets: np.ndarray | None = None  # int64[P+1]
    positions: np.ndarray | None = None  # int32[sum of freqs]
    dv_num: dict = dc_field(default_factory=dict)  # field -> (offsets[D+1], values)
    str_counts: dict = dc_field(default_factory=dict)  # string field -> int32[D]
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

    def postings(self, field: str, term: str) -> tuple[np.ndarray, np.ndarray]:
        """The term's (ascending local docs, freqs); empty when absent."""
        tid = self.term_id(field, term)
        if tid is None:
            return np.zeros(0, np.int32), np.zeros(0, np.float32)
        s, e = self.post_offsets[tid], self.post_offsets[tid + 1]
        return self.post_docs[s:e], self.post_freqs[s:e]

    def term_positions(self, field: str, term: str) -> list[np.ndarray]:
        """Per matching doc, the token positions of this term (for phrase and
        span queries)."""
        tid = self.term_id(field, term)
        if tid is None:
            return []
        positions = self.require("positions", "phrase and span queries")
        s, e = int(self.post_offsets[tid]), int(self.post_offsets[tid + 1])
        return [positions[self.pos_offsets[i]: self.pos_offsets[i + 1]]
                for i in range(s, e)]

    def terms_for_field(self, field: str) -> list[str]:
        """The field's terms, sorted (memoized: the term dict never changes
        after freeze)."""
        key = ("terms", field)
        terms = self._device_cache.get(key)
        if terms is None:
            terms = self._device_cache[key] = sorted(self.term_dict.get(field, ()))
        return terms

    def num_values(self, field: str, local: int) -> np.ndarray:
        col = self.dv_num.get(field)
        if col is None:
            return np.zeros(0)
        off, vals = col
        return vals[off[local]: off[local + 1]]

    def require(self, name: str, needed_by: str):
        """The stored per-doc attribute `name` (ids, types, positions); a
        segment built from arrays without it raises."""
        value = getattr(self, name)
        if value is None:
            raise IllegalArgumentError(
                f"{needed_by} need the segment's {name}, which a segment "
                f"built from arrays (convert.py) does not carry")
        return value

    def live_count(self) -> int:
        """Live top-level docs, memoized on the tombstone generation (the
        merge policy sizes every segment on every plan)."""
        cached = self._device_cache.get("live_count")
        if cached is not None and cached[0] == self.live_gen:
            return cached[1]
        n = int((self.live & self.parent_mask).sum())
        self._device_cache["live_count"] = (self.live_gen, n)
        return n

    def delete_doc(self, local: int) -> None:
        """Tombstone a doc in place (with_deletes is the copy-on-write form
        that keeps acquired searchers' point-in-time view)."""
        global _LIVE_GEN
        self.live[local] = False
        _LIVE_GEN += 1
        self.live_gen = _LIVE_GEN

    def with_deletes(self, locals_to_delete) -> "FrozenSegment":
        """Copy-on-write tombstoning: a NEW segment object sharing every large
        array but with a fresh live bitmap, so a previously acquired Searcher
        keeps an immutable point-in-time view.

        Every pack of the segment (one per device, under `("packed",
        device)`) gets a shallow copy of its own: the postings planes stay
        shared, but `blk_docs`, `live_parent` and `live_gen` become this
        view's. `packed_for` re-masks a pack by reassigning those three, so
        re-masking the new view's copy never touches the planes an older
        view (a pinned fetch context, a batch in flight) still reads. A
        shared entry would let the delete re-mask the old view's pack under
        it. The view starts its own filter cache, so no mask cached under
        another view's liveness serves it."""
        new = dataclasses.replace(self, live=self.live.copy(),
                                  _device_cache=dict(self._device_cache))
        new._device_cache.pop("live_count", None)
        new._device_cache.pop(FILTER_CACHE_KEY, None)
        for local in locals_to_delete:
            new.delete_doc(local)
        for key, packed in list(new._device_cache.items()):
            if isinstance(key, tuple) and key[0] == "packed":
                new._device_cache[key] = dataclasses.replace(packed)
        return new

    def estimated_bytes(self) -> int:
        """The merge policy's size of the segment: postings, positions,
        norms and numeric columns — the JAX package's sum (string columns
        left out, as there), so both engines make the same merge choices
        for the same documents."""
        n = self._device_cache.get("est_bytes")
        if n is not None:
            return n
        n = self.post_docs.nbytes + self.post_freqs.nbytes
        n += self.positions.nbytes if self.positions is not None else 0
        n += sum(a.nbytes for a in self.norms.values())
        n += sum(o.nbytes + v.nbytes for o, v in self.dv_num.values())
        self._device_cache["est_bytes"] = n
        return n


def merge_segments(segments: list[FrozenSegment], gen: int) -> FrozenSegment:
    """Merge the live docs of several segments, in order, into one new
    segment: each doc's postings are rebuilt from the CSR arrays with their
    positions, so the merged segment is the one indexing those docs afresh
    would freeze."""
    builder = SegmentBuilder(gen)
    for seg in segments:
        per_doc: list[dict[str, list[tuple[str, int]]]] = [
            {} for _ in range(seg.doc_count)]
        for f, td in seg.term_dict.items():
            for term, tid in td.items():
                s, e = int(seg.post_offsets[tid]), int(seg.post_offsets[tid + 1])
                for i in range(s, e):
                    poss = seg.positions[seg.pos_offsets[i]: seg.pos_offsets[i + 1]]
                    per_doc[int(seg.post_docs[i])].setdefault(f, []).extend(
                        (term, int(p)) for p in poss)
        for local in range(seg.doc_count):
            if not seg.live[local]:
                continue
            doc = ParsedDocument(id=seg.ids[local], type=seg.types[local],
                                 uid=f"{seg.types[local]}#{seg.ids[local]}",
                                 source=seg.stored[local],
                                 routing=seg.routings[local])
            doc.postings = {f: sorted(terms, key=lambda tp: tp[1])
                            for f, terms in per_doc[local].items()}
            # norm-bearing fields only: the meta fields carry no lengths
            doc.field_lengths = {f: len(t) for f, t in doc.postings.items()
                                 if f in seg.norms}
            for f, (off, vals) in seg.dv_num.items():
                v = vals[off[local]: off[local + 1]]
                if len(v):
                    doc.doc_values_num[f] = list(v)
            for f, counts in seg.str_counts.items():
                if counts[local]:
                    doc.str_value_counts[f] = int(counts[local])
            builder.add(doc, version=int(seg.versions[local]))
    return builder.freeze()
