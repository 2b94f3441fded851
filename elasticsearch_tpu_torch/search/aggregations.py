"""Aggregations: the collector-tree framework and its metric and bucket
aggregations (a copy of the JAX package's `search/aggregations.py`).

Every aggregation collects a partial over one segment's matching docs and
merges partials (across segments and shards alike), then finalizes the
response — the shape of the reference's Aggregator / InternalAggregation.

  metrics : avg, sum, min, max, stats, extended_stats, value_count,
            cardinality, percentiles, top_hits, geo_bounds
  buckets : terms, significant_terms, range, date_range, ip_range,
            histogram, date_histogram, filter, filters, global, missing,
            nested, geo_distance, geohash_grid

Sub-aggregations nest arbitrarily (bucket → mask → child collect). Collect
is vectorized numpy over the doc-value columns, so its partials are the JAX
package's bitwise.

The card's half (`device_*`, `bucket_cols_for`): metric aggs on numeric
columns reduce inside the dense launch (`ops/scoring.py
agg_stat_reduction`); bucket aggs send host-built, deduplicated (doc,
bucket) pairs to its count scatter (`_bucket_scatter`), their metric
sub-aggs scatter along the same pairs; `device_partial` and
`device_bucket_partial` turn the pulled results into the host collectors'
partial shapes, so merge and finalize are shared. The legacy facets map onto
the same aggregations (`parse_facets`, `facet_response`).

`ip_range` converts its bounds with the mapper's `parse_ip` and selects on
the host's float64 column, so an IPv4 value above 2^24 keeps its exact
value; only the per-bucket counts ride the card, as for `range`.

`geo_distance` and `geohash_grid` compute each point's distance (float64
`haversine_m`) or cell on the host and ride the card's count scatter as
deduplicated (doc, bucket) pairs, as in the JAX package; `geo_bounds` and
`nested` (the path's children of the matching parents, `_parent_of_map`)
collect on the host. The `geo_distance` facet maps onto `geo_distance`.
"""

from __future__ import annotations

import math
import threading

import numpy as np

from ..common.breaker import reserve
from ..common.errors import QueryParsingError, body_value
from ..common.geo import geohash_encode
from ..mapper.core import parse_date_math, parse_ip
from .filters import haversine_m, parse_distance, parse_point, segment_mask
from .queries import parse_filter

# ---------------------------------------------------------------------------
# framework
# ---------------------------------------------------------------------------


class Agg:
    """One aggregation node: collect(seg, ctx, mask) -> partial; merge(partials) ->
    reduced; finalize(reduced) -> response dict."""

    def __init__(self, name: str, spec: dict, subs: "dict[str, Agg] | None" = None):
        self.name = name
        self.spec = spec
        self.subs = subs or {}

    def collect(self, seg, ctx, mask: np.ndarray, scores: np.ndarray | None = None):
        raise NotImplementedError

    def merge(self, partials: list):
        raise NotImplementedError

    def finalize(self, merged) -> dict:
        raise NotImplementedError

    # helpers ---------------------------------------------------------------
    def _collect_subs(self, seg, ctx, mask, scores=None) -> dict:
        return {n: a.collect(seg, ctx, mask, scores) for n, a in self.subs.items()}

    def _merge_subs(self, partial_list: list[dict]) -> dict:
        return {
            n: a.merge([p[n] for p in partial_list]) for n, a in self.subs.items()
        }

    def _finalize_subs(self, merged: dict) -> dict:
        return {n: a.finalize(merged[n]) for n, a in self.subs.items()}


def parse_aggs(spec: dict) -> dict[str, Agg]:
    out: dict[str, Agg] = {}
    for name, body in (spec or {}).items():
        subs_spec = body.get("aggs") or body.get("aggregations") or {}
        subs = parse_aggs(subs_spec)
        kinds = [k for k in body if k not in ("aggs", "aggregations", "meta")]
        if len(kinds) != 1:
            raise QueryParsingError(f"aggregation [{name}] must have exactly one type")
        kind = kinds[0]
        cls = _AGG_REGISTRY.get(kind)
        if cls is None:
            raise QueryParsingError(f"unknown aggregation type [{kind}]")
        out[name] = cls(name, body[kind], subs)
    return out


def run_aggs(aggs: dict[str, Agg], seg_masks: list, ctx) -> list[dict]:
    """Collect partials per segment: seg_masks = [(seg, mask, scores)]."""
    partials = []
    for seg, mask, scores in seg_masks:
        partials.append({n: a.collect(seg, ctx, mask, scores) for n, a in aggs.items()})
    return partials


def reduce_aggs(aggs: dict[str, Agg], partial_list: list[dict]) -> dict:
    """Merge partials (across segments AND shards — same operation) + finalize."""
    return {
        n: a.finalize(a.merge([p[n] for p in partial_list])) for n, a in aggs.items()
    }


def _field_values(seg, field: str, mask: np.ndarray):
    """(doc_idx_per_value, values) for numeric columns restricted to mask."""
    col = seg.dv_num.get(field)
    if col is None:
        return np.zeros(0, np.int64), np.zeros(0)
    off, vals = col
    counts = np.diff(off)
    doc_of_val = np.repeat(np.arange(seg.doc_count), counts)
    sel = mask[doc_of_val]
    return doc_of_val[sel], vals[sel]


def _str_values(seg, field: str, mask: np.ndarray):
    col = seg.dv_str.get(field)
    if col is None:
        return np.zeros(0, np.int64), []
    uniq, off, ords = col
    counts = np.diff(off)
    doc_of_val = np.repeat(np.arange(seg.doc_count), counts)
    sel = mask[doc_of_val]
    return doc_of_val[sel], [uniq[o] for o in ords[sel]]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


class _NumericAgg(Agg):
    def _values(self, seg, ctx, mask):
        field = self.spec.get("field")
        vals: np.ndarray
        if field:
            _, vals = _field_values(seg, field, mask)
        else:
            script = self.spec.get("script")
            if not script:
                raise QueryParsingError(f"agg [{self.name}] requires field or script")
            from ..script import compile_script
            from .filters import DocAccess

            fn = compile_script(script, self.spec.get("params", {}))
            vals = np.asarray([
                float(fn(DocAccess(seg, int(d)))) for d in np.nonzero(mask)[0]
            ])
        return vals


class SumAgg(_NumericAgg):
    def collect(self, seg, ctx, mask, scores=None):
        return float(self._values(seg, ctx, mask).sum())

    def merge(self, partials):
        return float(sum(partials))

    def finalize(self, merged):
        return {"value": merged}


class AvgAgg(_NumericAgg):
    def collect(self, seg, ctx, mask, scores=None):
        v = self._values(seg, ctx, mask)
        return (float(v.sum()), int(len(v)))

    def merge(self, partials):
        return (sum(p[0] for p in partials), sum(p[1] for p in partials))

    def finalize(self, merged):
        s, c = merged
        return {"value": (s / c) if c else None}


class MinAgg(_NumericAgg):
    def collect(self, seg, ctx, mask, scores=None):
        v = self._values(seg, ctx, mask)
        return float(v.min()) if len(v) else None

    def merge(self, partials):
        vals = [p for p in partials if p is not None]
        return min(vals) if vals else None

    def finalize(self, merged):
        return {"value": merged}


class MaxAgg(_NumericAgg):
    def collect(self, seg, ctx, mask, scores=None):
        v = self._values(seg, ctx, mask)
        return float(v.max()) if len(v) else None

    def merge(self, partials):
        vals = [p for p in partials if p is not None]
        return max(vals) if vals else None

    def finalize(self, merged):
        return {"value": merged}


class ValueCountAgg(_NumericAgg):
    def collect(self, seg, ctx, mask, scores=None):
        field = self.spec.get("field")
        if field and field in seg.dv_str:
            _, vals = _str_values(seg, field, mask)
            return len(vals)
        return int(len(self._values(seg, ctx, mask)))

    def merge(self, partials):
        return int(sum(partials))

    def finalize(self, merged):
        return {"value": merged}


class StatsAgg(_NumericAgg):
    def collect(self, seg, ctx, mask, scores=None):
        v = self._values(seg, ctx, mask)
        if not len(v):
            return (0, 0.0, None, None, 0.0)
        return (int(len(v)), float(v.sum()), float(v.min()), float(v.max()),
                float((v * v).sum()))

    def merge(self, partials):
        count = sum(p[0] for p in partials)
        total = sum(p[1] for p in partials)
        mins = [p[2] for p in partials if p[2] is not None]
        maxs = [p[3] for p in partials if p[3] is not None]
        sq = sum(p[4] for p in partials)
        return (count, total, min(mins) if mins else None, max(maxs) if maxs else None, sq)

    def finalize(self, merged):
        count, total, mn, mx, _sq = merged
        return {
            "count": count, "sum": total, "min": mn, "max": mx,
            "avg": (total / count) if count else None,
        }


class ExtendedStatsAgg(StatsAgg):
    def finalize(self, merged):
        count, total, mn, mx, sq = merged
        out = {
            "count": count, "sum": total, "min": mn, "max": mx,
            "avg": (total / count) if count else None,
            "sum_of_squares": sq,
        }
        if count:
            variance = sq / count - (total / count) ** 2
            out["variance"] = variance
            out["std_deviation"] = math.sqrt(max(variance, 0.0))
        else:
            out["variance"] = None
            out["std_deviation"] = None
        return out


# ---------------------------------------------------------------------------
# device metric-agg bridge (ops/scoring.score_agg_batch)
# ---------------------------------------------------------------------------

_DEVICE_METRIC_CLASSES = (SumAgg, AvgAgg, MinAgg, MaxAgg, ValueCountAgg, StatsAgg)


def device_agg_field(agg: Agg, ctx) -> str | None:
    """The numeric column this agg can reduce on-device, else None (host path).
    extended_stats stays host-side: its variance finalization subtracts nearly
    equal sums, which float32 kernel accumulation would amplify."""
    if type(agg) is ExtendedStatsAgg or not isinstance(agg, _DEVICE_METRIC_CLASSES):
        return None
    if agg.subs:
        return None
    field = agg.spec.get("field")
    if not field or agg.spec.get("script"):
        return None
    ft = ctx.field_type(field)
    if ft is None or not getattr(ft, "is_numeric", False):
        return None
    return field


def device_bucket_subs(agg: Agg, ctx) -> dict | None:
    """name -> numeric column for every metric sub-agg of a bucket agg, or None
    when any sub can't ride the kernel (deeper nesting, scripts, bucket subs)."""
    out = {}
    for name, sub in agg.subs.items():
        f = device_agg_field(sub, ctx)
        if f is None:
            return None
        out[name] = f
    return out


def device_partial(agg: Agg, count, st):
    """One kernel result (count int, st = (sum, min, max, sumsq) f32) → the SAME
    partial shape Agg.collect produces, so merge/finalize stay shared between
    paths. Counts arrive from an exact int32 device reduction."""
    count = int(count)
    total = float(st[0])
    mn = float(st[1]) if count and np.isfinite(st[1]) else None
    mx = float(st[2]) if count and np.isfinite(st[2]) else None
    if isinstance(agg, AvgAgg):
        return (total, count)
    if isinstance(agg, SumAgg):
        return total
    if isinstance(agg, MinAgg):
        return mn
    if isinstance(agg, MaxAgg):
        return mx
    if isinstance(agg, ValueCountAgg):
        return count
    if isinstance(agg, StatsAgg):
        return (count, total, mn, mx, float(st[3])) if count \
            else (0, 0.0, None, None, 0.0)
    raise QueryParsingError(f"not a device agg [{type(agg).__name__}]")


def device_bucket_eligible(agg: Agg) -> bool:
    """Bucket aggs the device path serves: terms / significant_terms /
    histogram / date_histogram / range family / geo buckets on a plain field,
    plus the mask-shaped buckets (filter / filters / missing — their masks are
    host-evaluated per segment like FilteredQuery). Bucket KEYS are computed
    host-side (exact — calendar bucketing and range bound conversion included);
    only the per-bucket doc counts ride the kernel (exact int32 scatter-add
    under the match mask). Specs containing relative date math ("now…") refuse:
    they re-resolve per query on the host while the device pair cache lives per
    segment generation.

    Metric SUB-aggs are separately eligible (device_bucket_subs): their per-doc
    folds scatter along the same (doc, bucket) pairs — callers must check."""
    if type(agg) in (FilterAgg, FiltersAgg, MissingAgg):
        return "now" not in repr(agg.spec)
    if not agg.spec.get("field") or agg.spec.get("script"):
        return False
    if type(agg) in (RangeAgg, DateRangeAgg, IpRangeAgg):
        return not any("now" in str(b)
                       for r in agg.spec.get("ranges", [])
                       for b in (r.get("from"), r.get("to")) if b is not None)
    return type(agg) in (TermsAgg, SignificantTermsAgg, HistogramAgg,
                         DateHistogramAgg, GeoDistanceAgg, GeohashGridAgg)


_BUCKET_CACHE_MAX = 8  # distinct bucket-agg shapes cached per segment


def bucket_cache_key(agg: Agg) -> tuple:
    """The ONE cache-key constructor for a bucket agg's per-segment columns —
    shared by the host cache here and the device-array cache on PackedSegment
    (execute._bucket_pairs_on) so the two can never drift. Every spec param
    that changes the (pairs, keys) layout MUST appear here."""
    # finalize-only params don't change the (pairs, keys) layout — excluding
    # them keeps e.g. size:10 / size:50 variants of one terms agg on one cache
    # entry instead of fragmenting the FIFO
    layout_irrelevant = ("size", "shard_size", "order", "min_doc_count",
                         "extended_bounds")
    return ("bucket_cols", type(agg).__name__,
            repr(sorted(((k, v) for k, v in agg.spec.items()
                         if k not in layout_irrelevant), key=lambda kv: kv[0])))


_BUCKET_CACHE_LOCK = threading.Lock()  # search threads share a segment's caches


def _bucket_cache_put(cache: dict, ckey: tuple, value):
    """FIFO-bound the bucket entries (user-controlled intervals must not grow
    memory unboundedly); non-bucket entries in the same dict are untouched.
    Host dict work only under the lock: a device value is built before."""
    with _BUCKET_CACHE_LOCK:
        bucket_keys = [k for k in list(cache)
                       if isinstance(k, tuple) and k and k[0] == "bucket_cols"]
        while len(bucket_keys) >= _BUCKET_CACHE_MAX:
            cache.pop(bucket_keys.pop(0), None)
        cache[ckey] = value
    return value


def bucket_cols_for(agg: Agg, seg, ctx=None) -> tuple:
    """(pair_doc int32 [NP], pair_bucket int32 [NP], keys list) for one bucket
    agg on one segment — deduplicated (doc, bucket) pairs, so the scatter counts
    DOCS exactly like the host's bucket masks (a doc with duplicate values
    counts once). Cached on the segment (host arrays; device copies cache on the
    PackedSegment).

    Bucket materialization is the reference's classic breaker customer (a
    terms agg over a high-cardinality field): on a cache miss the pair-array
    build is reserved on the request breaker through `ctx` — transient
    (estimate during build, release after), host-side only."""
    field = agg.spec.get("field")
    ckey = bucket_cache_key(agg)
    cached = seg._device_cache.get(ckey)
    if cached is not None:
        return cached
    breaker = ctx.breaker("request") if ctx is not None \
        and getattr(ctx, "breakers", None) is not None else None
    col = seg.dv_num.get(field) if field else None
    n_vals = len(col[1]) if col is not None else 0
    # per-doc pair slots + per-value intermediates (int64 pair keys, int32
    # outputs, masks) — a deliberate over-estimate, like the reference's
    # per-bucket overhead constant
    with reserve(breaker, (seg.doc_count + n_vals) * 24,
                 f"<bucket_cols>[{type(agg).__name__}]"):
        return _bucket_cols_build(agg, seg, ctx, ckey, field)


def _bucket_cols_build(agg: Agg, seg, ctx, ckey, field) -> tuple:
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32), [])
    if isinstance(agg, (FilterAgg, FiltersAgg, MissingAgg)):
        # mask-shaped buckets: host-evaluated per segment via the filter cache
        # (same masks the host collectors use), one pair per matching doc
        from .filters import MissingFilter

        if isinstance(agg, MissingAgg):
            masks = [("missing", segment_mask(seg, MissingFilter(field), ctx))]
        elif isinstance(agg, FilterAgg):
            masks = [("filter", segment_mask(seg, parse_filter(agg.spec), ctx))]
        else:
            fspecs = agg.spec.get("filters", {})
            items = fspecs.items() if isinstance(fspecs, dict) else \
                enumerate(fspecs)
            masks = [(key, segment_mask(seg, parse_filter(fs), ctx))
                     for key, fs in items]
        keys = [k for k, _m in masks]
        pair_parts = [np.nonzero(m)[0] * max(len(masks), 1) + mi
                      for mi, (_k, m) in enumerate(masks)]
        pairs = (np.concatenate(pair_parts).astype(np.int64)
                 if pair_parts else np.zeros(0, np.int64))
        out = ((pairs // max(len(masks), 1)).astype(np.int32),
               (pairs % max(len(masks), 1)).astype(np.int32), keys)
        return _bucket_cache_put(seg._device_cache, ckey, out)
    if isinstance(agg, (GeoDistanceAgg, GeohashGridAgg)):
        # geo buckets: each value's distance or cell on the host (the origin
        # and precision are in the cache key), then the same deduplicated
        # pair machinery
        field2 = agg.spec.get("field")
        lat_col = seg.dv_num.get(f"{field2}.lat")
        lon_col = seg.dv_num.get(f"{field2}.lon")
        if lat_col is None or lon_col is None or not len(lat_col[1]):
            out = (empty[0], empty[1],
                   [r.get("key") or f"{r.get('from', '*')}-{r.get('to', '*')}"
                    for r in agg.spec.get("ranges", [])]
                   if isinstance(agg, GeoDistanceAgg) else [])
            return _bucket_cache_put(seg._device_cache, ckey, out)
        off, lats = lat_col
        _, lons = lon_col
        counts = np.diff(off)
        doc_of_val = np.repeat(np.arange(seg.doc_count, dtype=np.int64), counts)
        if isinstance(agg, GeohashGridAgg):
            cells = agg._cells(lats, lons)
            uniq_c = sorted(set(cells))
            cpos = {c: i for i, c in enumerate(uniq_c)}
            inv = np.asarray([cpos[c] for c in cells], dtype=np.int64)
            pairs = np.unique(doc_of_val * len(uniq_c) + inv)
            out = ((pairs // len(uniq_c)).astype(np.int32),
                   (pairs % len(uniq_c)).astype(np.int32), uniq_c)
            return _bucket_cache_put(seg._device_cache, ckey, out)
        d = agg._distances(lats, lons)
        ranges = agg.spec.get("ranges", [])
        keys = [agg._range_key(r) for r in ranges]
        pair_parts = [
            doc_of_val[agg._range_sel(d, r)] * max(len(ranges), 1) + ri
            for ri, r in enumerate(ranges)
        ]
        pairs = (np.unique(np.concatenate(pair_parts)) if pair_parts
                 else np.zeros(0, np.int64))
        out = ((pairs // max(len(ranges), 1)).astype(np.int32),
               (pairs % max(len(ranges), 1)).astype(np.int32), keys)
        return _bucket_cache_put(seg._device_cache, ckey, out)
    if isinstance(agg, RangeAgg):
        # range buckets: a value can fall in several (overlapping) ranges —
        # one (doc, range) pair per membership, deduplicated per doc; every
        # range emits a bucket even at zero docs (host collect does too)
        ranges = agg.spec.get("ranges", [])
        keys = [r.get("key") or f"{r.get('from', '*')}-{r.get('to', '*')}"
                for r in ranges]
        col = seg.dv_num.get(field)
        if col is None or not len(col[1]) or not ranges:
            out = (empty[0], empty[1], keys)
            return _bucket_cache_put(seg._device_cache, ckey, out)
        off, vals = col
        counts = np.diff(off)
        doc_of_val = np.repeat(np.arange(seg.doc_count, dtype=np.int64), counts)
        pair_parts = [
            doc_of_val[agg._selector(vals, r)[0]] * len(ranges) + ri
            for ri, r in enumerate(ranges)
        ]
        pairs = np.unique(np.concatenate(pair_parts))
        out = ((pairs // len(ranges)).astype(np.int32),
               (pairs % len(ranges)).astype(np.int32), keys)
        return _bucket_cache_put(seg._device_cache, ckey, out)
    if isinstance(agg, TermsAgg) and field in seg.dv_str:
        uniq, off, ords = seg.dv_str[field]
        if not len(uniq):
            return _bucket_cache_put(seg._device_cache, ckey, empty)
        counts = np.diff(off)
        doc_of_val = np.repeat(np.arange(seg.doc_count, dtype=np.int64), counts)
        pairs = np.unique(doc_of_val * len(uniq) + ords)
        out = ((pairs // len(uniq)).astype(np.int32),
               (pairs % len(uniq)).astype(np.int32), list(uniq))
    else:
        col = seg.dv_num.get(field)
        if col is None or not len(col[1]):
            return _bucket_cache_put(seg._device_cache, ckey, empty)
        off, vals = col
        counts = np.diff(off)
        doc_of_val = np.repeat(np.arange(seg.doc_count, dtype=np.int64), counts)
        if isinstance(agg, HistogramAgg):  # incl. DateHistogramAgg
            kv = agg._key_for(vals)
            uniq_k, inv = np.unique(kv, return_inverse=True)
            keys = [float(k) for k in uniq_k]
        else:
            uniq_k, inv = np.unique(vals, return_inverse=True)
            keys = [int(v) if float(v).is_integer() else float(v) for v in uniq_k]
        pairs = np.unique(doc_of_val * len(uniq_k) + inv)
        out = ((pairs // len(uniq_k)).astype(np.int32),
               (pairs % len(uniq_k)).astype(np.int32), keys)
    return _bucket_cache_put(seg._device_cache, ckey, out)


def _sig_bg_counts(seg, field: str) -> dict:
    """Per-term BACKGROUND doc counts (live parent docs, deduplicated) for
    significant_terms — depends on tombstones, so cached per live generation."""
    ck = ("sig_bg", field)
    cached = seg._device_cache.get(ck)
    if cached is not None and cached[0] == seg.live_gen:
        return cached[1]
    col = seg.dv_str.get(field)
    out: dict = {}
    if col is not None and len(col[0]):
        uniq, off, ords = col
        bg = seg.live & seg.parent_mask
        counts = np.diff(off)
        doc_of_val = np.repeat(np.arange(seg.doc_count, dtype=np.int64), counts)
        sel = bg[doc_of_val]
        pairs = np.unique(doc_of_val[sel] * len(uniq) + ords[sel])
        ord_counts = np.bincount((pairs % len(uniq)).astype(np.int64),
                                 minlength=len(uniq))
        out = {uniq[i]: int(ord_counts[i]) for i in range(len(uniq))}
    seg._device_cache[ck] = (seg.live_gen, out)
    return out


def device_bucket_partial(agg: Agg, keys: list, counts: np.ndarray,
                          seg=None, sub_data=None) -> list:
    """Kernel counts → the SAME partial shape _BucketAgg.collect produces.
    Range and mask-shaped aggs keep zero-count buckets (the host emits every
    range/filter); ranges carry their converted bounds; significant_terms
    attaches per-term background counts. sub_data = (sub_aggs, field_of,
    field_order, sub_cnt [Fs, NB] int, sub_stats [Fs, NB, 4]) when metric
    sub-aggs rode the kernel — their partials assemble in the host shapes via
    device_partial, so merge/finalize nest unchanged."""
    sub_rows = None
    if sub_data is not None:
        sub_aggs, field_of, order, scnt, sstats = sub_data
        fpos = {f: i for i, f in enumerate(order)}
        sub_rows = [(n, s, fpos[field_of[n]]) for n, s in sub_aggs.items()]

    def mk(bi: int, key, c) -> dict:
        subs = {}
        if sub_rows is not None:
            subs = {n: device_partial(s, scnt[fi, bi], sstats[fi, bi])
                    for n, s, fi in sub_rows}
        return {"key": key, "doc_count": int(c), "subs": subs}

    if isinstance(agg, RangeAgg):
        out = []
        for bi, (k, c, r) in enumerate(zip(keys, counts,
                                           agg.spec.get("ranges", []))):
            b = mk(bi, k, c)
            b["from"] = agg._convert(r.get("from"))
            b["to"] = agg._convert(r.get("to"))
            out.append(b)
        return out
    if isinstance(agg, (FilterAgg, FiltersAgg, MissingAgg, GeoDistanceAgg)):
        return [mk(bi, k, c) for bi, (k, c) in enumerate(zip(keys, counts))]
    if isinstance(agg, SignificantTermsAgg):
        field = agg.spec.get("field")
        bg = _sig_bg_counts(seg, field) if seg is not None and \
            field in seg.dv_str else {}
        out = []
        for bi, (k, c) in enumerate(zip(keys, counts)):
            if c > 0:
                b = mk(bi, k, c)
                # numeric columns / unknown keys: host falls back to bg == fg
                b["bg_count"] = int(bg.get(k, c))
                out.append(b)
        return out
    return [mk(bi, k, c)
            for bi, (k, c) in enumerate(zip(keys, counts)) if c > 0]


class GeoBoundsAgg(Agg):
    def collect(self, seg, ctx, mask, scores=None):
        field = self.spec.get("field")
        _, lats = _field_values(seg, f"{field}.lat", mask)
        _, lons = _field_values(seg, f"{field}.lon", mask)
        if not len(lats):
            return None
        return (float(lats.max()), float(lons.min()), float(lats.min()), float(lons.max()))

    def merge(self, partials):
        ps = [p for p in partials if p is not None]
        if not ps:
            return None
        return (max(p[0] for p in ps), min(p[1] for p in ps),
                min(p[2] for p in ps), max(p[3] for p in ps))

    def finalize(self, merged):
        if merged is None:
            return {}
        top, left, bottom, right = merged
        return {"bounds": {"top_left": {"lat": top, "lon": left},
                           "bottom_right": {"lat": bottom, "lon": right}}}


class CardinalityAgg(Agg):
    """Distinct count via a HyperLogLog++ sketch — bounded memory (2^p bytes) on
    arbitrarily-high-cardinality fields, near-exact up to `precision_threshold`
    (default 3000; the small range is served by linear counting, which is exact
    while register load stays low). Shard partials are sketches; cross-shard merge
    is a register max, so distributed counts don't double-count overlap."""

    def collect(self, seg, ctx, mask, scores=None):
        from ..common.sketches import HyperLogLogPlusPlus, precision_from_threshold

        field = self.spec.get("field")
        threshold = int(self.spec.get("precision_threshold", 3000))
        sketch = HyperLogLogPlusPlus(precision_from_threshold(threshold))
        if field in seg.dv_str:
            _, vals = _str_values(seg, field, mask)
            sketch.add_values(vals)
        else:
            _, vals = _field_values(seg, field, mask)
            sketch.add_values(vals)
        return sketch

    def merge(self, partials):
        out = None
        for p in partials:
            if out is None:
                out = p
            else:
                out.merge(p)
        return out

    def finalize(self, merged):
        return {"value": int(merged.cardinality()) if merged is not None else 0}


class PercentilesAgg(_NumericAgg):
    """Percentiles via a merging t-digest — O(compression) memory regardless of hit
    count, tails kept sharp by the k1 scale function. Shard partials are digests;
    the reduce side merges centroids (exact concatenation + re-compression)."""

    DEFAULT_PERCENTS = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)

    def _compression(self) -> float:
        # later-ES accepts both a flat `compression` and `tdigest.compression`
        td = self.spec.get("tdigest") or {}
        return float(self.spec.get("compression", td.get("compression", 100.0)))

    def collect(self, seg, ctx, mask, scores=None):
        from ..common.sketches import TDigest

        digest = TDigest(self._compression())
        digest.add_values(self._values(seg, ctx, mask))
        return digest

    def merge(self, partials):
        out = None
        for p in partials:
            if out is None:
                out = p
            else:
                out.merge(p)
        return out

    def finalize(self, merged):
        percents = self.spec.get("percents", list(self.DEFAULT_PERCENTS))
        values = {}
        for p in percents:
            q = merged.quantile(float(p) / 100.0) if merged is not None else None
            values[f"{float(p)}"] = q
        return {"values": values}


class TopHitsAgg(Agg):
    def collect(self, seg, ctx, mask, scores=None):
        size = int(self.spec.get("size", 3))
        idx = np.nonzero(mask)[0]
        s = scores[idx] if scores is not None else np.zeros(len(idx), np.float32)
        order = np.lexsort((idx, -s))[:size]
        return [
            {"_id": seg.ids[int(idx[i])], "_type": seg.types[int(idx[i])],
             "_score": float(s[i]), "_source": seg.stored[int(idx[i])]}
            for i in order
        ]

    def merge(self, partials):
        size = int(self.spec.get("size", 3))
        all_hits = [h for p in partials for h in p]
        all_hits.sort(key=lambda h: (-h["_score"], h["_id"]))
        return all_hits[:size]

    def finalize(self, merged):
        return {"hits": {"total": len(merged), "hits": merged}}


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------


class _BucketAgg(Agg):
    """Buckets = named doc masks; sub-aggs collect within each bucket mask."""

    def _bucket_partial(self, seg, ctx, key, mask, scores):
        return {
            "key": key,
            "doc_count": int(mask.sum()),
            "subs": self._collect_subs(seg, ctx, mask, scores),
        }

    def _merge_buckets(self, partial_list: list[list[dict]], key_order=None):
        by_key: dict = {}
        for partial in partial_list:
            for b in partial:
                e = by_key.setdefault(b["key"], {"key": b["key"], "doc_count": 0, "subs": []})
                e["doc_count"] += b["doc_count"]
                e["subs"].append(b["subs"])
        for e in by_key.values():
            e["subs"] = self._merge_subs(e["subs"]) if e["subs"] else {}
        return by_key

    def _finalize_bucket(self, e: dict, key_name: str = "key") -> dict:
        out = {key_name: e["key"], "doc_count": e["doc_count"]}
        out.update(self._finalize_subs(e["subs"]))
        return out


class TermsAgg(_BucketAgg):
    def collect(self, seg, ctx, mask, scores=None):
        field = self.spec.get("field")
        buckets = []
        if field in seg.dv_str:
            docs, vals = _str_values(seg, field, mask)
            by_term: dict[str, list[int]] = {}
            for d, v in zip(docs, vals):
                by_term.setdefault(v, []).append(int(d))
        else:
            docs, nvals = _field_values(seg, field, mask)
            by_term = {}
            for d, v in zip(docs, nvals):
                key = int(v) if float(v).is_integer() else float(v)
                by_term.setdefault(key, []).append(int(d))
        for term, doc_list in by_term.items():
            bmask = np.zeros(seg.doc_count, dtype=bool)
            bmask[doc_list] = True
            bmask &= mask
            buckets.append(self._bucket_partial(seg, ctx, term, bmask, scores))
        return buckets

    def merge(self, partials):
        return self._merge_buckets(partials)

    def finalize(self, merged):
        size = int(self.spec.get("size", 10) or 0) or len(merged)
        order_spec = self.spec.get("order", {"_count": "desc"})
        (okey, odir), = order_spec.items() if isinstance(order_spec, dict) else [("_count", "desc")]
        reverse = str(odir).lower() == "desc"
        entries = list(merged.values())
        if okey == "_count":
            # secondary key: term ascending (stable tiebreak like the reference)
            entries.sort(key=lambda e: e["key"])
            entries.sort(key=lambda e: e["doc_count"], reverse=reverse)
        elif okey in ("_term", "_key"):
            entries.sort(key=lambda e: e["key"], reverse=reverse)
        else:
            # order by sub-agg value, e.g. "avg_price" or "stats.max"
            path = okey.split(".")

            def subval(e):
                sub = self.subs.get(path[0])
                if sub is None:
                    return float("-inf")
                d = sub.finalize(e["subs"][path[0]])
                v = d.get(path[1]) if len(path) > 1 else d.get("value")
                return v if v is not None else float("-inf")

            entries.sort(key=subval, reverse=reverse)
        min_count = int(self.spec.get("min_doc_count", 1))
        entries = [e for e in entries if e["doc_count"] >= min_count]
        return {"buckets": [self._finalize_bucket(e) for e in entries[:size]]}


class RangeAgg(_BucketAgg):
    key_is_date = False

    def _convert(self, v):
        if v is None:
            return None
        if self.key_is_date and isinstance(v, str):
            return float(parse_date_math(v))
        return body_value(float, v)

    def _selector(self, vals: np.ndarray, r: dict):
        """(membership bool over vals, from, to) — the ONE half-open range
        predicate, shared with the device pair builder (bucket_cols_for)."""
        frm = self._convert(r.get("from"))
        to = self._convert(r.get("to"))
        sel = np.ones(len(vals), dtype=bool)
        if frm is not None:
            sel &= vals >= frm
        if to is not None:
            sel &= vals < to
        return sel, frm, to

    def collect(self, seg, ctx, mask, scores=None):
        field = self.spec.get("field")
        docs, vals = _field_values(seg, field, mask)
        buckets = []
        for r in self.spec.get("ranges", []):
            sel, frm, to = self._selector(vals, r)
            bmask = np.zeros(seg.doc_count, dtype=bool)
            bmask[docs[sel]] = True
            bmask &= mask
            key = r.get("key") or f"{r.get('from', '*')}-{r.get('to', '*')}"
            p = self._bucket_partial(seg, ctx, key, bmask, scores)
            p["from"] = frm
            p["to"] = to
            buckets.append(p)
        return buckets

    def merge(self, partials):
        merged = self._merge_buckets(partials)
        # carry from/to through
        for partial in partials:
            for b in partial:
                if b["key"] in merged:
                    merged[b["key"]].setdefault("from", b.get("from"))
                    merged[b["key"]].setdefault("to", b.get("to"))
        return merged

    def finalize(self, merged):
        buckets = []
        for e in merged.values():
            out = self._finalize_bucket(e)
            if e.get("from") is not None:
                out["from"] = e["from"]
            if e.get("to") is not None:
                out["to"] = e["to"]
            buckets.append(out)
        return {"buckets": buckets}


class DateRangeAgg(RangeAgg):
    key_is_date = True


class IpRangeAgg(RangeAgg):
    def _convert(self, v):
        if v is None:
            return None
        return float(parse_ip(v)) if isinstance(v, str) else float(v)


class HistogramAgg(_BucketAgg):
    def _interval(self) -> float:
        return float(self.spec.get("interval", 1))

    def _key_for(self, vals: np.ndarray) -> np.ndarray:
        interval = self._interval()
        return np.floor(vals / interval) * interval

    def collect(self, seg, ctx, mask, scores=None):
        field = self.spec.get("field")
        docs, vals = _field_values(seg, field, mask)
        keys = self._key_for(vals)
        buckets = []
        for key in np.unique(keys):
            sel = keys == key
            bmask = np.zeros(seg.doc_count, dtype=bool)
            bmask[docs[sel]] = True
            bmask &= mask
            buckets.append(self._bucket_partial(seg, ctx, float(key), bmask, scores))
        return buckets

    def merge(self, partials):
        return self._merge_buckets(partials)

    def finalize(self, merged):
        entries = sorted(merged.values(), key=lambda e: e["key"])
        min_count = int(self.spec.get("min_doc_count", 0 if "extended_bounds" in self.spec else 1))
        if min_count == 0 and entries:
            # fill empty buckets between min and max keys
            interval = self._interval()
            lo, hi = entries[0]["key"], entries[-1]["key"]
            eb = self.spec.get("extended_bounds") or {}
            lo = min(lo, eb["min"]) if "min" in eb else lo
            hi = max(hi, eb["max"]) if "max" in eb else hi
            have = {e["key"] for e in entries}
            k = lo
            while k <= hi + 1e-9:
                if k not in have:
                    entries.append({"key": k, "doc_count": 0,
                                    "subs": self._merge_subs([])})
                k += interval
            entries.sort(key=lambda e: e["key"])
        entries = [e for e in entries if e["doc_count"] >= min_count]
        return {"buckets": [self._finalize_bucket(e) for e in entries]}


_CAL_INTERVALS = {
    "year": 365 * 86400_000, "quarter": 91 * 86400_000, "month": 30 * 86400_000,
    "week": 7 * 86400_000, "day": 86400_000, "hour": 3600_000,
    "minute": 60_000, "second": 1000,
}


class DateHistogramAgg(HistogramAgg):
    def _interval(self) -> float:
        spec = str(self.spec.get("interval", "day"))
        if spec in _CAL_INTERVALS:
            return float(_CAL_INTERVALS[spec])
        from ..common.units import parse_time

        return parse_time(spec) * 1000.0

    def _key_for(self, vals: np.ndarray) -> np.ndarray:
        spec = str(self.spec.get("interval", "day"))
        if spec in ("month", "year", "quarter"):
            # calendar-aware bucketing
            import datetime as dt

            out = np.empty(len(vals))
            for i, v in enumerate(vals):
                d = dt.datetime.fromtimestamp(v / 1000.0, dt.timezone.utc)
                if spec == "year":
                    d2 = dt.datetime(d.year, 1, 1, tzinfo=dt.timezone.utc)
                elif spec == "quarter":
                    d2 = dt.datetime(d.year, ((d.month - 1) // 3) * 3 + 1, 1,
                                     tzinfo=dt.timezone.utc)
                else:
                    d2 = dt.datetime(d.year, d.month, 1, tzinfo=dt.timezone.utc)
                out[i] = d2.timestamp() * 1000.0
            return out
        return super()._key_for(vals)

    def finalize(self, merged):
        out = super().finalize(merged)
        import datetime as dt

        for b in out["buckets"]:
            b["key_as_string"] = dt.datetime.fromtimestamp(
                b["key"] / 1000.0, dt.timezone.utc
            ).strftime("%Y-%m-%dT%H:%M:%S.000Z")
        return out


class FilterAgg(_BucketAgg):
    def collect(self, seg, ctx, mask, scores=None):
        f = parse_filter(self.spec)
        bmask = mask & segment_mask(seg, f, ctx)
        return [self._bucket_partial(seg, ctx, "filter", bmask, scores)]

    def merge(self, partials):
        return self._merge_buckets(partials)

    def finalize(self, merged):
        e = next(iter(merged.values())) if merged else {"key": "filter", "doc_count": 0, "subs": self._merge_subs([])}
        out = {"doc_count": e["doc_count"]}
        out.update(self._finalize_subs(e["subs"]))
        return out


class FiltersAgg(_BucketAgg):
    def collect(self, seg, ctx, mask, scores=None):
        buckets = []
        fspecs = self.spec.get("filters", {})
        items = fspecs.items() if isinstance(fspecs, dict) else enumerate(fspecs)
        for key, fs in items:
            f = parse_filter(fs)
            bmask = mask & segment_mask(seg, f, ctx)
            buckets.append(self._bucket_partial(seg, ctx, key, bmask, scores))
        return buckets

    def merge(self, partials):
        return self._merge_buckets(partials)

    def finalize(self, merged):
        return {"buckets": {
            e["key"]: {k: v for k, v in self._finalize_bucket(e).items() if k != "key"}
            for e in merged.values()
        }}


class GlobalAgg(_BucketAgg):
    def collect(self, seg, ctx, mask, scores=None):
        gmask = seg.live & seg.parent_mask
        return [self._bucket_partial(seg, ctx, "global", gmask, scores)]

    def merge(self, partials):
        return self._merge_buckets(partials)

    def finalize(self, merged):
        e = next(iter(merged.values())) if merged else {"key": "global", "doc_count": 0, "subs": {}}
        out = {"doc_count": e["doc_count"]}
        out.update(self._finalize_subs(e["subs"]) if e["subs"] else {})
        return out


class MissingAgg(_BucketAgg):
    def collect(self, seg, ctx, mask, scores=None):
        from .filters import MissingFilter

        f = MissingFilter(self.spec.get("field"))
        bmask = mask & segment_mask(seg, f, ctx)
        return [self._bucket_partial(seg, ctx, "missing", bmask, scores)]

    def merge(self, partials):
        return self._merge_buckets(partials)

    def finalize(self, merged):
        e = next(iter(merged.values())) if merged else {"key": "missing", "doc_count": 0, "subs": {}}
        out = {"doc_count": e["doc_count"]}
        out.update(self._finalize_subs(e["subs"]) if e["subs"] else {})
        return out


class NestedAgg(_BucketAgg):
    """Switches the collection scope to the nested child docs of `path`
    whose parents match."""

    def collect(self, seg, ctx, mask, scores=None):
        from .execute import _parent_of_map

        path = self.spec.get("path")
        child_sel = np.asarray([p == path for p in seg.nested_paths], dtype=bool)
        parents = _parent_of_map(seg)
        cmask = np.zeros(seg.doc_count, dtype=bool)
        idx = np.nonzero(child_sel)[0]
        if len(idx):
            pidx = parents[idx]
            ok = pidx >= 0
            cmask[idx[ok]] = mask[pidx[ok]]
        return [self._bucket_partial(seg, ctx, "nested", cmask, scores)]

    def merge(self, partials):
        return self._merge_buckets(partials)

    def finalize(self, merged):
        e = next(iter(merged.values())) if merged else {"key": "nested", "doc_count": 0, "subs": {}}
        out = {"doc_count": e["doc_count"]}
        out.update(self._finalize_subs(e["subs"]) if e["subs"] else {})
        return out


class GeoDistanceAgg(_BucketAgg):
    def _distances(self, lats: np.ndarray, lons: np.ndarray) -> np.ndarray:
        """Per-value distance from the spec origin in spec units: the one
        origin parse and haversine, shared with the device pair builder."""
        lat0, lon0 = parse_point(self.spec.get("origin") or self.spec.get("point")
                                 or self.spec.get("center"))
        unit = parse_distance("1" + self.spec.get("unit", "m"))
        return haversine_m(lat0, lon0, lats, lons) / unit

    @staticmethod
    def _range_sel(d: np.ndarray, r: dict) -> np.ndarray:
        sel = np.ones(len(d), dtype=bool)
        if r.get("from") is not None:
            sel &= d >= float(r["from"])
        if r.get("to") is not None:
            sel &= d < float(r["to"])
        return sel

    @staticmethod
    def _range_key(r: dict) -> str:
        frm, to = r.get("from"), r.get("to")
        return r.get("key") or \
            f"{frm if frm is not None else '*'}-{to if to is not None else '*'}"

    def collect(self, seg, ctx, mask, scores=None):
        field = self.spec.get("field")
        docs_lat, lats = _field_values(seg, f"{field}.lat", mask)
        _, lons = _field_values(seg, f"{field}.lon", mask)
        d = self._distances(lats, lons)
        buckets = []
        for r in self.spec.get("ranges", []):
            sel = self._range_sel(d, r)
            bmask = np.zeros(seg.doc_count, dtype=bool)
            bmask[docs_lat[sel]] = True
            bmask &= mask
            buckets.append(self._bucket_partial(seg, ctx, self._range_key(r),
                                                bmask, scores))
        return buckets

    def merge(self, partials):
        return self._merge_buckets(partials)

    def finalize(self, merged):
        return {"buckets": [self._finalize_bucket(e) for e in merged.values()]}


class GeohashGridAgg(_BucketAgg):
    """Buckets per geohash cell at `precision`, doc-deduplicated counts,
    ordered by count desc then cell asc."""

    def _cells(self, lats: np.ndarray, lons: np.ndarray) -> list:
        precision = int(self.spec.get("precision", 5))
        return [geohash_encode(float(la), float(lo), precision)
                for la, lo in zip(lats, lons)]

    def collect(self, seg, ctx, mask, scores=None):
        field = self.spec.get("field")
        docs, lats = _field_values(seg, f"{field}.lat", mask)
        _, lons = _field_values(seg, f"{field}.lon", mask)
        by_cell: dict[str, set] = {}
        for d, cell in zip(docs, self._cells(lats, lons)):
            by_cell.setdefault(cell, set()).add(int(d))
        buckets = []
        for cell, ds in by_cell.items():
            if not self.subs:
                # docs are already mask-filtered; the per-cell mask is only
                # needed to drive sub-agg collection
                buckets.append({"key": cell, "doc_count": len(ds), "subs": {}})
                continue
            bmask = np.zeros(seg.doc_count, dtype=bool)
            bmask[list(ds)] = True
            buckets.append(self._bucket_partial(seg, ctx, cell, bmask, scores))
        return buckets

    def merge(self, partials):
        return self._merge_buckets(partials)

    def finalize(self, merged):
        entries = sorted(merged.values(),
                         key=lambda e: (-e["doc_count"], e["key"]))
        size = int(self.spec.get("size", 10000) or 10000)
        return {"buckets": [self._finalize_bucket(e) for e in entries[:size]]}


class SignificantTermsAgg(TermsAgg):
    """Simplified significance: foreground/background frequency ratio scoring
    (the reference uses JLH; same monotone intent, documented deviation)."""

    def collect(self, seg, ctx, mask, scores=None):
        buckets = super().collect(seg, ctx, mask, scores)
        bg = seg.live & seg.parent_mask
        field = self.spec.get("field")
        for b in buckets:
            if field in seg.dv_str:
                uniq, off, ords = seg.dv_str[field]
                try:
                    o = uniq.index(b["key"]) if isinstance(uniq, list) else None
                except ValueError:
                    o = None
                if o is not None:
                    counts = np.diff(off)
                    doc_of_val = np.repeat(np.arange(seg.doc_count), counts)
                    sel = (ords == o) & bg[doc_of_val]
                    b["bg_count"] = int(np.unique(doc_of_val[sel]).size)
                else:
                    b["bg_count"] = b["doc_count"]
            else:
                b["bg_count"] = b["doc_count"]
        return buckets

    def merge(self, partials):
        merged = super().merge(partials)
        for partial in partials:
            for b in partial:
                if b["key"] in merged:
                    e = merged[b["key"]]
                    e["bg_count"] = e.get("bg_count", 0) + b.get("bg_count", 0)
        return merged

    def finalize(self, merged):
        entries = list(merged.values())
        for e in entries:
            bg = max(e.get("bg_count", e["doc_count"]), 1)
            e["_score"] = e["doc_count"] / bg
        entries.sort(key=lambda e: (-e["_score"], -e["doc_count"]))
        size = int(self.spec.get("size", 10))
        out = []
        for e in entries[:size]:
            b = self._finalize_bucket(e)
            b["score"] = e["_score"]
            b["bg_count"] = e.get("bg_count", e["doc_count"])
            out.append(b)
        return {"buckets": out}


_AGG_REGISTRY: dict[str, type] = {
    "sum": SumAgg,
    "avg": AvgAgg,
    "min": MinAgg,
    "max": MaxAgg,
    "value_count": ValueCountAgg,
    "stats": StatsAgg,
    "extended_stats": ExtendedStatsAgg,
    "cardinality": CardinalityAgg,
    "percentiles": PercentilesAgg,
    "top_hits": TopHitsAgg,
    "geo_bounds": GeoBoundsAgg,
    "terms": TermsAgg,
    "significant_terms": SignificantTermsAgg,
    "range": RangeAgg,
    "date_range": DateRangeAgg,
    "ip_range": IpRangeAgg,
    "histogram": HistogramAgg,
    "date_histogram": DateHistogramAgg,
    "filter": FilterAgg,
    "filters": FiltersAgg,
    "global": GlobalAgg,
    "missing": MissingAgg,
    "nested": NestedAgg,
    "geo_distance": GeoDistanceAgg,
    "geohash_grid": GeohashGridAgg,
}


# ---------------------------------------------------------------------------
# facets (legacy API) — mapped onto the agg framework (ref: search/facet/, 15k LoC,
# superseded by aggs in the reference but still first-class in this snapshot)
# ---------------------------------------------------------------------------


def parse_facets(spec: dict) -> dict[str, tuple[Agg, str]]:
    out = {}
    for name, body in (spec or {}).items():
        kinds = [k for k in body if k not in ("facet_filter", "global", "nested")]
        if not kinds:
            raise QueryParsingError(f"facet [{name}] missing type")
        kind = kinds[0]
        fspec = body[kind]
        if kind == "terms":
            agg = TermsAgg(name, fspec)
        elif kind == "statistical":
            agg = ExtendedStatsAgg(name, fspec)
        elif kind in ("histogram",):
            agg = HistogramAgg(name, fspec)
        elif kind == "date_histogram":
            agg = DateHistogramAgg(name, fspec)
        elif kind == "range":
            agg = RangeAgg(name, fspec)
        elif kind == "geo_distance":
            agg = GeoDistanceAgg(name, fspec)
        elif kind in ("query",):
            agg = FilterAgg(name, {"query": fspec})
        elif kind in ("filter",):
            agg = FilterAgg(name, fspec)
        elif kind == "terms_stats":
            agg = TermsAgg(name, {"field": fspec.get("key_field"),
                                  "size": fspec.get("size", 10)},
                           subs={"stats": StatsAgg("stats", {"field": fspec.get("value_field")})})
        else:
            raise QueryParsingError(f"unknown facet type [{kind}]")
        out[name] = (agg, kind)
    return out


def facet_response(agg: Agg, kind: str, reduced: dict) -> dict:
    """Convert an agg result into the legacy facet response shape."""
    if kind == "terms":
        return {"_type": "terms", "terms": [
            {"term": b["key"], "count": b["doc_count"]} for b in reduced["buckets"]
        ]}
    if kind == "statistical":
        return {"_type": "statistical", **{k: v for k, v in reduced.items()}}
    if kind in ("histogram", "date_histogram"):
        return {"_type": kind, "entries": [
            {"key": b["key"], "count": b["doc_count"]} for b in reduced["buckets"]
        ]}
    if kind == "range":
        return {"_type": "range", "ranges": [
            {**b, "count": b.pop("doc_count")} for b in [dict(b) for b in reduced["buckets"]]
        ]}
    if kind in ("query", "filter"):
        return {"_type": kind, "count": reduced["doc_count"]}
    if kind == "geo_distance":
        return {"_type": "geo_distance", "ranges": [
            {**b, "count": b.pop("doc_count")} for b in [dict(b) for b in reduced["buckets"]]
        ]}
    if kind == "terms_stats":
        return {"_type": "terms_stats", "entries": [
            {"term": b["key"], "count": b["doc_count"], **b.get("stats", {})}
            for b in reduced["buckets"]
        ]}
    return reduced
