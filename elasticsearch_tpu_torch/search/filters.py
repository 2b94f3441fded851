"""Filter tree: non-scoring matchers evaluated per segment as boolean doc
masks (a trimmed copy of the JAX package's `search/filters.py`).

A filter evaluates to bool[doc_count] per segment from the segment's CSR
postings and numeric doc-value columns; masks combine with numpy logical ops
and gate matching (filters never contribute to scores). The per-(segment,
filter key) mask is cached under the segment's `_device_cache`
(`index.segment.FILTER_CACHE_KEY`), least recently used first out once a
segment's masks pass `FILTER_CACHE_SEGMENT_BYTES`; a masked view made by
`with_deletes` starts its own cache. A query used as a filter is not cached:
its mask can depend on shard-wide term statistics (`common`, `mlt`).

Served here: term, terms (values, not a lookup), range, prefix, exists,
missing, ids, type, match_all, bool / and / or, not, query (a scoring query
as a filter) and regexp. The geo filters, nested and has_child / has_parent,
script, indices and terms lookups are later slices of the port: their
parsers (`search/queries.py`) raise QueryParsingError saying so.
"""

from __future__ import annotations

import re
import threading
from bisect import bisect_left
from collections import OrderedDict
from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np

from ..index.segment import FILTER_CACHE_KEY, FrozenSegment
from ..mapper.core import parse_date_math


class Filter:
    def key(self) -> str:
        raise NotImplementedError

    def evaluate(self, seg: FrozenSegment, ctx) -> np.ndarray:
        raise NotImplementedError

    def cacheable(self) -> bool:
        """False for masks that depend on state outside the segment.
        Composites propagate from their children."""
        return True


# the bytes of masks one segment's filter cache holds: a bound on what
# request-chosen filter keys can pin for the segment's lifetime
FILTER_CACHE_SEGMENT_BYTES = 4 << 20
_CACHE_LOCK = threading.Lock()  # search threads share a segment's cache


def segment_mask(seg: FrozenSegment, f: Filter, ctx) -> np.ndarray:
    """Cached evaluation (the filter cache). ctx carries the mapper service."""
    if not f.cacheable():
        return f.evaluate(seg, ctx)
    k = f.key()
    with _CACHE_LOCK:
        cache = seg._device_cache.setdefault(FILTER_CACHE_KEY, OrderedDict())
        m = cache.get(k)
        if m is not None:
            cache.move_to_end(k)
            return m
    m = f.evaluate(seg, ctx)
    with _CACHE_LOCK:
        cache[k] = m
        used = sum(v.nbytes for v in cache.values())
        while used > FILTER_CACHE_SEGMENT_BYTES and len(cache) > 1:
            used -= cache.popitem(last=False)[1].nbytes
    return m


def _postings_mask(seg: FrozenSegment, field: str, term: str) -> np.ndarray:
    mask = np.zeros(seg.doc_count, dtype=bool)
    docs, _ = seg.postings(field, str(term))
    mask[docs] = True
    return mask


def _num_column_mask(seg: FrozenSegment, field: str, pred) -> np.ndarray:
    col = seg.dv_num.get(field)
    mask = np.zeros(seg.doc_count, dtype=bool)
    if col is None:
        return mask
    off, vals = col
    if len(vals) == 0:
        return mask
    hit = pred(vals)
    counts = np.diff(off)
    doc_of_val = np.repeat(np.arange(seg.doc_count), counts)
    np.logical_or.at(mask, doc_of_val, hit)
    return mask


@dataclass
class TermFilter(Filter):
    field: str
    value: Any

    def key(self):
        return f"term:{self.field}:{self.value}"

    def evaluate(self, seg, ctx):
        ft = ctx.field_type(self.field)
        if ft is not None and ft.is_numeric:
            coerced = ft.coerce(self.value)
            return _num_column_mask(seg, self.field, lambda v: v == float(coerced))
        return _postings_mask(seg, self.field, _index_term(ctx, self.field, self.value))


@dataclass
class TermsFilter(Filter):
    field: str
    values: list

    def key(self):
        return f"terms:{self.field}:{sorted(map(str, self.values))!r}"

    def evaluate(self, seg, ctx):
        ft = ctx.field_type(self.field)
        mask = np.zeros(seg.doc_count, dtype=bool)
        if ft is not None and ft.is_numeric:
            coerced = {float(ft.coerce(v)) for v in self.values}
            arr = np.asarray(sorted(coerced))
            return _num_column_mask(seg, self.field, lambda v: np.isin(v, arr))
        for v in self.values:
            mask |= _postings_mask(seg, self.field, _index_term(ctx, self.field, v))
        return mask


@dataclass
class RangeFilter(Filter):
    field: str
    gte: Any = None
    gt: Any = None
    lte: Any = None
    lt: Any = None

    def key(self):
        return f"range:{self.field}:{self.gte}:{self.gt}:{self.lte}:{self.lt}"

    def _bounds_numeric(self, ft) -> tuple[float, float, bool, bool]:
        def conv(v):
            if ft is not None and ft.type == "date" and isinstance(v, str):
                return float(parse_date_math(v, formats=ft.formats))
            return float(ft.coerce(v)) if ft is not None and ft.is_numeric else float(v)

        lo, lo_inc = -np.inf, True
        hi, hi_inc = np.inf, True
        if self.gte is not None:
            lo = conv(self.gte)
        if self.gt is not None:
            lo, lo_inc = conv(self.gt), False
        if self.lte is not None:
            hi = conv(self.lte)
        if self.lt is not None:
            hi, hi_inc = conv(self.lt), False
        return lo, hi, lo_inc, hi_inc

    def evaluate(self, seg, ctx):
        ft = ctx.field_type(self.field)
        if ft is None or ft.is_numeric:
            lo, hi, lo_inc, hi_inc = self._bounds_numeric(ft)

            def pred(v):
                lower = v >= lo if lo_inc else v > lo
                upper = v <= hi if hi_inc else v < hi
                return lower & upper

            return _num_column_mask(seg, self.field, pred)
        # lexicographic range over the sorted term dictionary (keyword fields)
        mask = np.zeros(seg.doc_count, dtype=bool)
        for term in seg.terms_for_field(self.field):
            if self.gte is not None and term < str(self.gte):
                continue
            if self.gt is not None and term <= str(self.gt):
                continue
            if self.lte is not None and term > str(self.lte):
                break
            if self.lt is not None and term >= str(self.lt):
                break
            mask |= _postings_mask(seg, self.field, term)
        return mask


@dataclass
class PrefixFilter(Filter):
    field: str
    prefix: str

    def key(self):
        return f"prefix:{self.field}:{self.prefix}"

    def evaluate(self, seg, ctx):
        mask = np.zeros(seg.doc_count, dtype=bool)
        terms = seg.terms_for_field(self.field)
        # the terms with the prefix sit together from its insertion point on
        for i in range(bisect_left(terms, self.prefix), len(terms)):
            if not terms[i].startswith(self.prefix):
                break
            mask |= _postings_mask(seg, self.field, terms[i])
        return mask


@dataclass
class ExistsFilter(Filter):
    """Docs with a value in the field: a posting, a numeric value, or a
    string value that analyzed to no token (its count in `str_counts`)."""

    field: str

    def key(self):
        return f"exists:{self.field}"

    def evaluate(self, seg, ctx):
        mask = np.zeros(seg.doc_count, dtype=bool)
        td = seg.term_dict.get(self.field)
        if td:
            for tid in td.values():
                s, e = seg.post_offsets[tid], seg.post_offsets[tid + 1]
                mask[seg.post_docs[s:e]] = True
        col = seg.dv_num.get(self.field)
        if col is not None:
            off, _ = col
            mask |= np.diff(off) > 0
        counts = seg.str_counts.get(self.field)
        if counts is not None:
            mask |= counts > 0
        return mask


@dataclass
class MissingFilter(Filter):
    field: str

    def key(self):
        return f"missing:{self.field}"

    def evaluate(self, seg, ctx):
        return ~ExistsFilter(self.field).evaluate(seg, ctx)


@dataclass
class IdsFilter(Filter):
    ids: list
    types: list = dc_field(default_factory=list)

    def key(self):
        return f"ids:{sorted(self.types)}:{sorted(map(str, self.ids))!r}"

    def evaluate(self, seg, ctx):
        ids = seg.require("ids", "ids queries and filters")
        types = seg.require("types", "ids queries and filters") if self.types else None
        mask = np.zeros(seg.doc_count, dtype=bool)
        idset = set(map(str, self.ids))
        for local in range(seg.doc_count):
            if seg.parent_mask[local] and ids[local] in idset:
                if not self.types or types[local] in self.types:
                    mask[local] = True
        return mask


@dataclass
class TypeFilter(Filter):
    type: str

    def key(self):
        return f"type:{self.type}"

    def evaluate(self, seg, ctx):
        types = seg.require("types", "type queries and filters")
        return np.asarray([t == self.type for t in types], dtype=bool)


@dataclass
class MatchAllFilter(Filter):
    def key(self):
        return "match_all"

    def evaluate(self, seg, ctx):
        return np.ones(seg.doc_count, dtype=bool)


@dataclass
class BoolFilter(Filter):
    must: list = dc_field(default_factory=list)
    should: list = dc_field(default_factory=list)
    must_not: list = dc_field(default_factory=list)

    def key(self):
        return (
            "bool:" + "&".join(f.key() for f in self.must)
            + "|" + ";".join(f.key() for f in self.should)
            + "!" + ";".join(f.key() for f in self.must_not)
        )

    def evaluate(self, seg, ctx):
        mask = np.ones(seg.doc_count, dtype=bool)
        for f in self.must:
            mask &= segment_mask(seg, f, ctx)
        if self.should:
            smask = np.zeros(seg.doc_count, dtype=bool)
            for f in self.should:
                smask |= segment_mask(seg, f, ctx)
            mask &= smask
        for f in self.must_not:
            mask &= ~segment_mask(seg, f, ctx)
        return mask

    def cacheable(self):
        return all(f.cacheable()
                   for f in (*self.must, *self.should, *self.must_not))


@dataclass
class NotFilter(Filter):
    inner: Filter

    def key(self):
        return f"not:{self.inner.key()}"

    def evaluate(self, seg, ctx):
        return ~segment_mask(seg, self.inner, ctx)

    def cacheable(self):
        return self.inner.cacheable()


@dataclass
class QueryWrapperFilter(Filter):
    """A scoring query as a filter: its match mask from the host scorer."""

    query: Any  # Query

    def key(self):
        return f"query:{self.query!r}"

    def evaluate(self, seg, ctx):
        from .execute import host_match_mask

        return host_match_mask(self.query, seg, ctx)

    def cacheable(self):
        return False


@dataclass
class RegexpFilter(Filter):
    field: str
    pattern: str

    def key(self):
        return f"regexp:{self.field}:{self.pattern}"

    def evaluate(self, seg, ctx):
        rex = re.compile(self.pattern)
        mask = np.zeros(seg.doc_count, dtype=bool)
        for term in seg.terms_for_field(self.field):
            if rex.fullmatch(term):
                mask |= _postings_mask(seg, self.field, term)
        return mask


def _index_term(ctx, field: str, value) -> str:
    """A term/terms filter value as the indexed token: the raw value, not
    analyzed (the reference's term filter semantics)."""
    return str(value)
