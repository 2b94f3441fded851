"""Sort: field / score / geo-distance / script sort keys over doc-value
columns (a copy of the JAX package's `search/sorting.py`).

Per-segment vectorized key extraction with the multi-valued `mode`
reductions (min/max/avg/sum) and `missing` handling (_last/_first or a
constant); sort value tuples travel with the hits so the coordinator's merge
re-compares them (`compare_sort_values`). `device_sort_key_row` folds one
numeric column into the float32 key row of the card's field-sort launch
(`ops/scoring.py _dense_sort_impl`), or refuses it for the host path.

The `_geo_distance` sort keys each doc by the float64 `haversine_m` from the
origin to its points (reduced by `mode`, `min` by default) in the sort's
`unit` (km by default); it stays on the host: `device_sort_key_row`
refuses every kind but a field sort, as in the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..common.errors import QueryParsingError
from .filters import haversine_m, parse_distance, parse_point


class SortSpec:
    __slots__ = ("field", "order", "mode", "missing", "kind", "lat", "lon", "unit",
                 "script", "params")

    def __init__(self, field: str, order: str = "asc", mode: str | None = None,
                 missing: Any = "_last", kind: str = "field", lat=0.0, lon=0.0,
                 unit=1.0, script=None, params=None):
        self.field = field
        self.order = order
        self.mode = mode
        self.missing = missing
        self.kind = kind
        self.lat = lat
        self.lon = lon
        self.unit = unit
        self.script = script
        self.params = params or {}

    @property
    def reverse(self) -> bool:
        return self.order == "desc"


def parse_sort(spec) -> list[SortSpec]:
    """"sort": ["_score", {"price": "desc"}, {"_geo_distance": {...}}, "field"]"""
    if spec is None:
        return []
    if not isinstance(spec, list):
        spec = [spec]
    out: list[SortSpec] = []
    for item in spec:
        if isinstance(item, str):
            if item == "_score":
                out.append(SortSpec("_score", "desc", kind="score"))
            else:
                out.append(SortSpec(item, "asc"))
            continue
        if not isinstance(item, dict) or len(item) != 1:
            raise QueryParsingError(f"invalid sort spec {item!r}")
        (field, opts), = item.items()
        if field == "_score":
            order = opts if isinstance(opts, str) else opts.get("order", "desc")
            out.append(SortSpec("_score", order, kind="score"))
        elif field == "_geo_distance":
            opts = dict(opts)
            order = opts.pop("order", "asc")
            unit = parse_distance("1" + opts.pop("unit", "km"))
            mode = opts.pop("mode", None)
            (gfield, point), = opts.items()
            lat, lon = parse_point(point)
            out.append(SortSpec(gfield, order, mode, kind="geo", lat=lat, lon=lon, unit=unit))
        elif field == "_script":
            out.append(SortSpec("_script", opts.get("order", "asc"), kind="script",
                                script=opts.get("script"), params=opts.get("params")))
        else:
            if isinstance(opts, str):
                out.append(SortSpec(field, opts))
            else:
                out.append(SortSpec(field, opts.get("order", "asc"), opts.get("mode"),
                                    opts.get("missing", "_last")))
    return out


def _reduce_multi(off: np.ndarray, vals: np.ndarray, D: int, mode: str) -> np.ndarray:
    out = np.full(D, np.nan)
    counts = np.diff(off)
    has = counts > 0
    if not has.any():
        return out
    if mode in (None, "min"):
        red = np.minimum.reduceat(vals, off[:-1][has])
    elif mode == "max":
        red = np.maximum.reduceat(vals, off[:-1][has])
    elif mode in ("sum", "avg"):
        red = np.add.reduceat(vals, off[:-1][has])
        if mode == "avg":
            red = red / counts[has]
    else:
        raise QueryParsingError(f"unknown sort mode [{mode}]")
    out[has] = red
    return out


def sort_key_column(spec: SortSpec, seg, ctx, scores: np.ndarray | None) -> np.ndarray:
    """One float64 key per doc; NaN = missing. Ascending semantics (the
    caller negates for desc)."""
    D = seg.doc_count
    if spec.kind == "score":
        return (scores if scores is not None else np.zeros(D)).astype(np.float64)
    if spec.kind == "geo":
        lat_col = seg.dv_num.get(f"{spec.field}.lat")
        lon_col = seg.dv_num.get(f"{spec.field}.lon")
        if lat_col is None or lon_col is None:
            return np.full(D, np.nan)
        off, lats = lat_col
        _, lons = lon_col
        d = haversine_m(spec.lat, spec.lon, lats, lons) / spec.unit
        mode = spec.mode or "min"
        return _reduce_multi(off, d, D, mode if mode in ("min", "max", "avg", "sum") else "min")
    if spec.kind == "script":
        from ..script import compile_script
        from .filters import DocAccess
        from .functions import vectorized_script_eval

        fn = compile_script(spec.script or "0", spec.params)
        # _script sorts expose the document's _score (reference semantics)
        score_arr = (scores if scores is not None
                     else np.zeros(D)).astype(np.float64)
        out = np.full(D, np.nan)
        # the column-lowered form where the script has one; the docs it
        # leaves go doc by doc, a per-doc error being a missing key
        vec = vectorized_script_eval(fn, seg, score_arr)
        if vec is not None:
            vals, ok = vec
            out[ok] = vals[ok]
            rest = np.nonzero(seg.parent_mask & ~ok)[0]
        else:
            rest = np.nonzero(seg.parent_mask)[0]
        for local in rest:
            try:
                out[local] = float(fn(DocAccess(seg, int(local)),
                                      _score=float(score_arr[local])))
            except Exception:  # noqa: BLE001 — missing fields etc. → NaN key
                pass
        return out
    col = seg.dv_num.get(spec.field)
    if col is not None:
        off, vals = col
        mode = spec.mode or ("min" if spec.order == "asc" else "max")
        return _reduce_multi(off, vals, D, mode)
    scol = seg.dv_str.get(spec.field)
    if scol is not None:
        # the segment-local ordinal as the key (segment-local top-k only);
        # hits carry the raw string (sort_values_for_docs), which merges
        # across segments and shards
        uniq, off, ords = scol
        counts = np.diff(off)
        out = np.full(D, np.nan)
        has = counts > 0
        if has.any():
            red = np.minimum.reduceat(ords.astype(np.float64), off[:-1][has])
            out[has] = red
        return out
    return np.full(D, np.nan)


_F32_MAX = float(np.finfo(np.float32).max)


def device_sort_key_row(spec: SortSpec, seg, doc_pad: int) -> np.ndarray | None:
    """float32 [doc_pad] ascending-semantics key row for the card's field
    sort, or None when the spec or column needs the host path.

    Only columns whose values are exactly float32-representable ride the
    card (a fractional float64 rounded to float32 could swap a strict
    order); avg/sum modes stay on the host. Missing docs take ±FLT_MAX (not
    ±inf), so the launch ranks them after real keys but before its ±inf
    padding; a numeric missing fill must be float32-exact too. The
    exactness check and the per-doc fold are cached on the segment under
    ("sort_keys", field, mode)."""
    if spec.kind != "field" or spec.mode in ("avg", "sum"):
        return None
    if spec.field in seg.dv_str and spec.field not in seg.dv_num:
        return None
    mode = spec.mode or ("min" if spec.order == "asc" else "max")
    ckey = ("sort_keys", spec.field, mode)
    keys = seg._device_cache.get(ckey)
    if keys is None:
        col = seg.dv_num.get(spec.field)
        if col is None:
            keys = np.full(seg.doc_count, np.nan)
        else:
            off, vals = col
            if len(vals) and (
                    not np.array_equal(
                        vals.astype(np.float32).astype(np.float64), vals)
                    or np.abs(vals).max() >= _F32_MAX / 2):
                keys = "inexact"
            else:
                keys = _reduce_multi(off, vals, seg.doc_count, mode)
        seg._device_cache[ckey] = keys
    if isinstance(keys, str):
        return None
    if spec.missing == "_last":
        fill = _F32_MAX if not spec.reverse else -_F32_MAX
    elif spec.missing == "_first":
        fill = -_F32_MAX if not spec.reverse else _F32_MAX
    else:
        try:
            fill = float(spec.missing)
        except (TypeError, ValueError):
            fill = _F32_MAX
        if float(np.float32(fill)) != fill:
            return None
    keys = np.where(np.isnan(keys), fill, keys)
    row = np.full(doc_pad, _F32_MAX if not spec.reverse else -_F32_MAX,
                  dtype=np.float32)
    row[: seg.doc_count] = keys.astype(np.float32)
    return row


def apply_missing(keys: np.ndarray, spec: SortSpec) -> np.ndarray:
    missing = spec.missing
    if missing == "_last":
        fill = np.inf if not spec.reverse else -np.inf
    elif missing == "_first":
        fill = -np.inf if not spec.reverse else np.inf
    else:
        try:
            fill = float(missing)
        except (TypeError, ValueError):
            fill = np.inf
    return np.where(np.isnan(keys), fill, keys)


def sort_values_for_docs(specs: list[SortSpec], seg, ctx, locals_: np.ndarray,
                         scores: np.ndarray | None):
    """Per-hit sort VALUE tuples (they travel with the hits for the
    cross-shard merge and the response's "sort" arrays). Strings stay
    strings, so merges compare them lexicographically."""
    out: list[list] = [[] for _ in range(len(locals_))]
    for spec in specs:
        if spec.kind == "field" and spec.field in seg.dv_str and spec.field not in seg.dv_num:
            for i, local in enumerate(locals_):
                vals = seg.str_values(spec.field, int(local))
                out[i].append(min(vals) if vals else None)
        else:
            col = sort_key_column(spec, seg, ctx, scores)
            for i, local in enumerate(locals_):
                v = col[int(local)]
                out[i].append(None if np.isnan(v) else float(v))
    return out


def compare_sort_values(a: list, b: list, specs: list[SortSpec]) -> int:
    """Cross-shard comparator over sort-value tuples (None = missing)."""
    for av, bv, spec in zip(a, b, specs):
        if av == bv:
            continue
        if av is None:
            return 1 if spec.missing == "_last" else -1
        if bv is None:
            return -1 if spec.missing == "_last" else 1
        lt = av < bv
        if spec.reverse:
            return 1 if lt else -1
        return -1 if lt else 1
    return 0
