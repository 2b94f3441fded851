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

Served here: term, terms, range, prefix, exists,
missing, ids, type, match_all, bool / and / or, not, query (a scoring query
as a filter), regexp and script (a sandboxed expression per doc, through
`DocAccess`); nested (a block join of the inner query or filter over the
path's children, `execute.child_match_to_parents`); has_child / has_parent
(`HasChildFilter`: the shard-wide join `execute._shard_join`, once per
searcher, never in the per-segment cache); and the geo filters over a
`geo_point`'s `field.lat` / `field.lon` columns (`geo_distance`,
`geo_distance_range`, `geo_bounding_box`, `geo_polygon`, `geohash_cell`)
or a `geo_shape`'s stored shapes (`geo_shape`, its parsed shapes cached on
the segment under `("geo_shapes",)`), with the JAX package's float64
`haversine_m`; indices (`IndicesFilter`: the inner filter on the named
indices, read against `ctx.index_name`, `no_match_filter` elsewhere). A
terms lookup reaches no filter: the coordinating node resolves it into
values first (`search/queries.py resolve_terms_lookups`).
"""

from __future__ import annotations

import fnmatch
import json
import re
import threading
from bisect import bisect_left
from collections import OrderedDict
from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np

from ..common.errors import QueryParsingError
from ..common.geo import (geohash_bbox, geohash_neighbors, shape_within,
                          shapes_intersect)
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


def clear_segment_masks(seg: FrozenSegment) -> None:
    """Drop the segment's cached host masks (they rebuild on later use)."""
    with _CACHE_LOCK:
        seg._device_cache.pop(FILTER_CACHE_KEY, None)


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
    string doc value (`dv_str`, which also holds a value that analyzed to no
    token)."""

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
        scol = seg.dv_str.get(self.field)
        if scol is not None:
            _, off, _ = scol
            mask |= np.diff(off) > 0
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


@dataclass
class ScriptFilter(Filter):
    script: str
    params: dict = dc_field(default_factory=dict)

    def key(self):
        return f"script:{self.script}:{sorted(self.params.items())!r}"

    def evaluate(self, seg, ctx):
        from ..script import compile_script

        fn = compile_script(self.script, self.params)
        mask = np.zeros(seg.doc_count, dtype=bool)
        for local in range(seg.doc_count):
            if seg.parent_mask[local]:
                mask[local] = bool(fn(DocAccess(seg, local)))
        return mask


@dataclass
class NestedFilter(Filter):
    path: str
    inner: Any  # Query or Filter on the path's child docs

    def key(self):
        return f"nested:{self.path}:{getattr(self.inner, 'key', lambda: repr(self.inner))()}"

    def cacheable(self):
        # a query inside is not cached, as a query used as a filter is not
        return isinstance(self.inner, Filter) and self.inner.cacheable()

    def evaluate(self, seg, ctx):
        from .execute import child_match_to_parents

        return child_match_to_parents(seg, ctx, self.path, self.inner)[0]


@dataclass
class GeoDistanceFilter(Filter):
    field: str
    lat: float
    lon: float
    distance_m: float

    def key(self):
        return f"geodist:{self.field}:{self.lat}:{self.lon}:{self.distance_m}"

    def evaluate(self, seg, ctx):
        return _geo_points_mask(
            seg, self.field,
            lambda lats, lons: haversine_m(self.lat, self.lon, lats, lons)
            <= self.distance_m)


def _geo_points_mask(seg, field: str, hit_fn) -> np.ndarray:
    """A doc mask from the multi-valued point columns: hit_fn(lats, lons) ->
    bool[V] per value, OR-scattered to the docs (every point-based geo
    filter)."""
    lat_col = seg.dv_num.get(f"{field}.lat")
    lon_col = seg.dv_num.get(f"{field}.lon")
    mask = np.zeros(seg.doc_count, dtype=bool)
    if lat_col is None or lon_col is None:
        return mask
    off, lats = lat_col
    _, lons = lon_col
    hit = hit_fn(lats, lons)
    counts = np.diff(off)
    doc_of_val = np.repeat(np.arange(seg.doc_count), counts)
    np.logical_or.at(mask, doc_of_val, hit)
    return mask


@dataclass
class GeoShapeFilter(Filter):
    """Docs whose stored shape relates to the query shape: the shape column
    is parsed once a segment (cached) and the relation computed exactly
    (common/geo.py)."""

    field: str
    shape: tuple  # normalized (kind, data)
    relation: str = "intersects"  # intersects | within | disjoint

    def key(self):
        return f"geoshape:{self.field}:{self.relation}:" \
               f"{json.dumps(self.shape, sort_keys=True)}"

    def _doc_shapes(self, seg):
        """Parsed per-doc shape lists, cached on the segment."""
        cache = seg._device_cache.setdefault(("geo_shapes",), {})
        parsed = cache.get(self.field)
        if parsed is None:
            parsed = [None] * seg.doc_count
            for d in range(seg.doc_count):
                vals = seg.str_values(self.field, d)
                if vals:
                    parsed[d] = [tuple(json.loads(v)) for v in vals]
            cache[self.field] = parsed
        return parsed

    def evaluate(self, seg, ctx):
        mask = np.zeros(seg.doc_count, dtype=bool)
        q = self.shape
        for d, shapes in enumerate(self._doc_shapes(seg)):
            if not shapes:
                continue
            if self.relation == "within":
                mask[d] = any(shape_within(s, q) for s in shapes)
            elif self.relation == "disjoint":
                mask[d] = not any(shapes_intersect(s, q) for s in shapes)
            else:
                mask[d] = any(shapes_intersect(s, q) for s in shapes)
        return mask


@dataclass
class GeohashCellFilter(Filter):
    """Docs whose geo_point falls in the geohash cell (and, with
    `neighbors`, its 8 neighbours): a bounding-box test over the point
    columns (a point is in the cell iff the cell prefixes its geohash)."""

    field: str
    geohash: str
    neighbors: bool = False

    def key(self):
        return f"geohashcell:{self.field}:{self.geohash}:{self.neighbors}"

    def evaluate(self, seg, ctx):
        cells = [self.geohash] + (geohash_neighbors(self.geohash)
                                  if self.neighbors else [])

        def hit(lats, lons):
            h = np.zeros(len(lats), dtype=bool)
            for cell in cells:
                lat_lo, lat_hi, lon_lo, lon_hi = geohash_bbox(cell)
                h |= ((lats >= lat_lo) & (lats < lat_hi)
                      & (lons >= lon_lo) & (lons < lon_hi))
            return h

        return _geo_points_mask(seg, self.field, hit)


@dataclass
class GeoBoundingBoxFilter(Filter):
    field: str
    top: float
    left: float
    bottom: float
    right: float

    def key(self):
        return f"geobb:{self.field}:{self.top}:{self.left}:{self.bottom}:{self.right}"

    def evaluate(self, seg, ctx):
        def hit(lats, lons):
            h = (lats <= self.top) & (lats >= self.bottom)
            if self.left <= self.right:
                return h & (lons >= self.left) & (lons <= self.right)
            return h & ((lons >= self.left) | (lons <= self.right))  # dateline

        return _geo_points_mask(seg, self.field, hit)


@dataclass
class IndicesFilter(Filter):
    """The filter on the indices its patterns name, `no_match_filter`
    elsewhere (match_all by default, nothing for "none"). The index is the
    shard context's `index_name` (None: an unwired context, which counts as
    a match)."""

    indices: tuple
    filter: Any = None
    no_match_filter: Any = None  # None: match_all
    no_match_none: bool = False

    def key(self):
        inner_key = getattr(self.filter, "key", lambda: repr(self.filter))()
        nm_key = (getattr(self.no_match_filter, "key",
                          lambda: repr(self.no_match_filter))()
                  if self.no_match_filter is not None else "all")
        return f"indices:{self.indices}:{inner_key}:{nm_key}:{self.no_match_none}"

    def cacheable(self):
        return (self.filter is None or self.filter.cacheable()) and (
            self.no_match_filter is None or self.no_match_filter.cacheable())

    def evaluate(self, seg, ctx):
        name = getattr(ctx, "index_name", None)
        if name is None or any(fnmatch.fnmatch(name, pat) for pat in self.indices):
            return segment_mask(seg, self.filter, ctx)
        if self.no_match_none:
            return np.zeros(seg.doc_count, dtype=bool)
        if self.no_match_filter is None:
            return np.ones(seg.doc_count, dtype=bool)
        return segment_mask(seg, self.no_match_filter, ctx)


@dataclass
class HasChildFilter(Filter):
    """Parent docs with a matching child (or children of a matching parent),
    never scored: a slice of the query form's shard-wide join
    (execute._shard_join), since parent/child links span segments."""

    query: Any  # HasChildQuery or HasParentQuery with score_mode "none"

    def key(self):
        q = self.query
        inner_key = repr(q.query)
        return f"haschildf:{type(q).__name__}:{getattr(q, 'child_type', getattr(q, 'parent_type', None))}:{inner_key}"

    def cacheable(self):
        # the join spans the whole shard: a per-segment cached mask would go
        # stale when a child lands in (or leaves) another segment
        return False

    def evaluate(self, seg, ctx):
        from .execute import _shard_join

        # one join per (searcher, filter): a searcher's segments never change
        cache = getattr(ctx.searcher, "_join_cache", None)
        if cache is None:
            cache = ctx.searcher._join_cache = {}
        join = cache.get(self.key())
        if join is None:
            join = cache[self.key()] = _shard_join(ctx, self.query)
        for si, s in enumerate(ctx.searcher.segments):
            if s is seg:
                return join[si][1]
        return np.zeros(seg.doc_count, dtype=bool)


@dataclass
class GeoPolygonFilter(Filter):
    """Docs with a point inside the polygon (ray casting, vectorized over
    every stored point)."""

    field: str
    points: tuple  # ((lat, lon), ...), closed or open ring

    def key(self):
        return f"geopoly:{self.field}:{self.points}"

    def evaluate(self, seg, ctx):
        pts = [p for p in self.points]
        if len(pts) > 1 and pts[0] == pts[-1]:
            pts = pts[:-1]  # drop the explicit closing point
        lat_v = np.asarray([p[0] for p in pts])
        lon_v = np.asarray([p[1] for p in pts])

        def inside(lats, lons):
            hit = np.zeros(len(lats), dtype=bool)
            n = len(lat_v)
            for i in range(n):
                j = (i - 1) % n
                crosses = ((lat_v[i] > lats) != (lat_v[j] > lats)) & (
                    lons < (lon_v[j] - lon_v[i]) * (lats - lat_v[i])
                    / (lat_v[j] - lat_v[i] + 1e-300) + lon_v[i])
                hit ^= crosses
            return hit

        return _geo_points_mask(seg, self.field, inside)


@dataclass
class GeoDistanceRangeFilter(Filter):
    """Docs whose point's distance from the origin falls between the bounds
    (`include_lower` / `include_upper`)."""

    field: str
    lat: float
    lon: float
    from_m: float | None = None
    to_m: float | None = None
    include_lower: bool = True
    include_upper: bool = True

    def key(self):
        return (f"geodistrange:{self.field}:{self.lat}:{self.lon}:"
                f"{self.from_m}:{self.to_m}:{self.include_lower}:{self.include_upper}")

    def evaluate(self, seg, ctx):
        def hit(lats, lons):
            d = haversine_m(self.lat, self.lon, lats, lons)
            ok = np.ones(len(d), dtype=bool)
            if self.from_m is not None:
                ok &= (d >= self.from_m) if self.include_lower else (d > self.from_m)
            if self.to_m is not None:
                ok &= (d <= self.to_m) if self.include_upper else (d < self.to_m)
            return ok

        return _geo_points_mask(seg, self.field, hit)


EARTH_RADIUS_M = 6371008.7714


def haversine_m(lat1, lon1, lat2, lon2):
    """Great-circle metres, vectorized, float64 (the JAX package's)."""
    la1, lo1 = np.radians(lat1), np.radians(lon1)
    la2, lo2 = np.radians(lat2), np.radians(lon2)
    a = np.sin((la2 - la1) / 2) ** 2 + np.cos(la1) * np.cos(la2) * np.sin((lo2 - lo1) / 2) ** 2
    return 2 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


_DIST_RE = re.compile(r"^\s*([\d.]+)\s*([a-zA-Z]*)\s*$")
_DIST_UNITS = {
    "m": 1.0, "meters": 1.0, "km": 1000.0, "kilometers": 1000.0,
    "mi": 1609.344, "miles": 1609.344, "yd": 0.9144, "ft": 0.3048,
    "in": 0.0254, "cm": 0.01, "mm": 0.001, "nmi": 1852.0, "": 1.0,
}


def parse_point(point) -> tuple[float, float]:
    """(lat, lon) from a query's point: {lat, lon}, "lat,lon" or [lon, lat]
    (GeoJSON order)."""
    if isinstance(point, dict):
        return float(point["lat"]), float(point["lon"])
    if isinstance(point, str):
        lat, lon = (float(x) for x in point.split(","))
        return lat, lon
    return float(point[1]), float(point[0])


def parse_distance(s) -> float:
    """A distance (`"50km"`, `"2mi"`, a number of metres) in metres."""
    if isinstance(s, (int, float)):
        return float(s)
    m = _DIST_RE.match(str(s))
    if not m:
        raise QueryParsingError(f"failed to parse distance [{s}]")
    return float(m.group(1)) * _DIST_UNITS.get(m.group(2).lower(), 1.0)


class DocAccess:
    """Per-doc field access for scripts: doc['field'].value style, over the
    numeric doc values, else the string ones."""

    def __init__(self, seg: FrozenSegment, local: int):
        self.seg = seg
        self.local = local

    def __getitem__(self, field: str):
        nums = self.seg.num_values(field, self.local)
        if len(nums):
            return FieldVal(list(nums))
        return FieldVal(self.seg.str_values(field, self.local))


class FieldVal:
    def __init__(self, values: list):
        self.values = values

    @property
    def value(self):
        return self.values[0] if self.values else None

    @property
    def empty(self):
        return not self.values


def _index_term(ctx, field: str, value) -> str:
    """A term/terms filter value as the indexed token: the raw value, not
    analyzed (the reference's term filter semantics)."""
    return str(value)
