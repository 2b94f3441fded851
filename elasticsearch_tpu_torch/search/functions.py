"""function_score score functions (a copy of the JAX package's
`search/functions.py`).

Decay functions (gauss/exp/linear over numeric, date and geo_point fields;
a geo decay's distance is the float64 `haversine_m` from the origin to the
doc's first point, in metres, its scale and offset distances),
script_score, field_value_factor, random_score and boost_factor, with
filters, weights, score_mode/boost_mode combination and max_boost capping.

Decay math: for value v, origin o, scale s, offset f, decay d:
  dist = max(0, |v - o| - f)
  gauss : exp(-dist² / (2σ²)),  σ² = -s²/(2·ln d)
  exp   : exp(λ·dist),          λ = ln(d)/s
  linear: max(0, (l - dist)/l), l = s/(1 - d)

Everything is vectorized over the segment's numeric doc-value columns. The
host tail (`apply_functions`) and the device rows family
(`execute._dispatch_fs_group` with `ops/scoring._fs_rows_impl`) share
`combined_doc_rows`, float32 throughout, in the same operation order.
"""

from __future__ import annotations

import math
import zlib

import numpy as np

from ..common.errors import QueryParsingError
from ..mapper.core import parse_date_math
from .filters import haversine_m, parse_distance, parse_point, segment_mask


def vectorized_script_eval(fn, seg, scores: np.ndarray):
    """Column-lowered script evaluation over a whole segment.

    Returns (values float64[D], ok bool[D]) or None when the script is outside the
    vectorizable subset. `ok` excludes exactly the docs whose per-doc evaluation
    may diverge or raise — referenced fields missing (per-doc sees value=None) and
    non-finite vectorized results (per-doc raises ScriptError on the same domain
    error, e.g. log(0)) — so callers run the per-doc path for ~ok docs and
    semantics, including errors, are unchanged."""
    from ..script import ColumnVectorizer

    col_cache: dict[str, np.ndarray] = {}

    def col(f):
        if f not in col_cache:
            col_cache[f] = _column_first_value(seg, f)
        return col_cache[f]

    vec = ColumnVectorizer(fn, col, scores)
    result = vec.vectorize()
    if result is None:
        return None
    vals = np.broadcast_to(np.asarray(result, dtype=np.float64),
                           (seg.doc_count,))
    ok = seg.parent_mask & np.isfinite(vals)
    for f in vec.used_fields:
        ok &= ~np.isnan(col(f))
    return vals, ok


def _column_first_value(seg, field: str) -> np.ndarray:
    """First numeric value per doc (NaN = missing)."""
    col = seg.dv_num.get(field)
    out = np.full(seg.doc_count, np.nan)
    if col is None:
        return out
    off, vals = col
    has = np.diff(off) > 0
    first_idx = off[:-1][has]
    out[has] = vals[first_idx]
    return out


def _parse_scale(sf, ft) -> float:
    if ft is not None and ft.type == "date":
        from ..common.units import parse_time

        return parse_time(sf.scale) * 1000.0
    if ft is not None and ft.type == "geo_point":
        return parse_distance(sf.scale)
    return float(sf.scale)


def _parse_origin(sf, ft):
    """The origin: epoch millis for a date, (lat, lon) for a geo_point."""
    if ft is not None and ft.type == "date":
        if sf.origin is None:
            import time

            return time.time() * 1000.0
        return float(parse_date_math(str(sf.origin)))
    if ft is not None and ft.type == "geo_point":
        return parse_point(sf.origin)
    return float(sf.origin)


def _parse_offset(sf, ft) -> float:
    if not sf.offset:
        return 0.0
    if ft is not None and ft.type == "date":
        from ..common.units import parse_time

        return parse_time(sf.offset) * 1000.0
    if ft is not None and ft.type == "geo_point":
        return parse_distance(sf.offset)
    return float(sf.offset)


def evaluate_function(sf, seg, ctx, sub_scores: np.ndarray) -> np.ndarray:
    """One function's value per doc (before filter/weight)."""
    D = seg.doc_count
    if sf.kind == "boost_factor":
        return np.full(D, np.float32(sf.factor), dtype=np.float32)

    if sf.kind == "random_score":
        seed = sf.seed if sf.seed is not None else 42
        ids = np.asarray([zlib.crc32(f"{seed}:{i}".encode()) for i in seg.ids or []],
                         dtype=np.float64)
        return ((ids % 10_000) / 10_000.0).astype(np.float32)

    if sf.kind == "field_value_factor":
        vals = _column_first_value(seg, sf.field)
        missing = 1.0 if sf.missing is None else float(sf.missing)
        vals = np.where(np.isnan(vals), missing, vals) * sf.factor
        mod = sf.modifier
        with np.errstate(divide="ignore", invalid="ignore"):
            if mod in ("none", None):
                out = vals
            elif mod == "log":
                out = np.log10(vals)
            elif mod == "log1p":
                out = np.log10(vals + 1)
            elif mod == "log2p":
                out = np.log10(vals + 2)
            elif mod == "ln":
                out = np.log(vals)
            elif mod == "ln1p":
                out = np.log1p(vals)
            elif mod == "ln2p":
                out = np.log(vals + 2)
            elif mod == "square":
                out = vals * vals
            elif mod == "sqrt":
                out = np.sqrt(vals)
            elif mod == "reciprocal":
                out = 1.0 / vals
            else:
                raise QueryParsingError(f"unknown field_value_factor modifier [{mod}]")
        return np.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0).astype(np.float32)

    if sf.kind == "script_score":
        from ..script import compile_script
        from .filters import DocAccess

        fn = compile_script(sf.script, sf.params)
        vec = vectorized_script_eval(fn, seg, sub_scores.astype(np.float64))
        if vec is not None:
            vals, ok = vec
            out = np.where(ok, vals, 0.0).astype(np.float32)
            for local in np.nonzero(seg.parent_mask & ~ok)[0]:
                out[local] = float(fn(DocAccess(seg, int(local)),
                                      _score=float(sub_scores[local])))
            return out
        out = np.zeros(D, dtype=np.float32)
        for local in range(D):
            if seg.parent_mask[local]:
                out[local] = float(fn(DocAccess(seg, local), _score=float(sub_scores[local])))
        return out

    if sf.kind in ("gauss", "exp", "linear"):
        ft = ctx.field_type(sf.field)
        scale = _parse_scale(sf, ft)
        offset = _parse_offset(sf, ft)
        decay = sf.decay
        if ft is not None and ft.type == "geo_point":
            lat0, lon0 = _parse_origin(sf, ft)
            lats = _column_first_value(seg, f"{sf.field}.lat")
            lons = _column_first_value(seg, f"{sf.field}.lon")
            dist = haversine_m(lat0, lon0, lats, lons)
        else:
            origin = _parse_origin(sf, ft)
            vals = _column_first_value(seg, sf.field)
            dist = np.abs(vals - origin)
        dist = np.maximum(0.0, dist - offset)
        if sf.kind == "gauss":
            sigma2 = -(scale * scale) / (2.0 * math.log(decay))
            out = np.exp(-(dist * dist) / (2.0 * sigma2))
        elif sf.kind == "exp":
            lam = math.log(decay) / scale
            out = np.exp(lam * dist)
        else:
            l = scale / (1.0 - decay)  # noqa: E741 — the decay formula's name
            out = np.maximum(0.0, (l - dist) / l)
        return np.where(np.isnan(out), 1.0, out).astype(np.float32)  # missing → neutral

    raise QueryParsingError(f"unknown score function [{sf.kind}]")


def combined_doc_rows(q, sub_scores: np.ndarray, seg, ctx):
    """score_mode-combined function values + applies mask: (float32[D], bool[D]).

    The per-doc part of function_score — everything up to (but excluding) the
    no-function default, max_boost cap and boost_mode. Shared by the host tail
    (apply_functions) and the device rows family: all math is float32 so the
    two paths are bit-identical."""
    D = seg.doc_count
    vals: list[np.ndarray] = []
    masks: list[np.ndarray] = []
    for sf in q.functions:
        v = evaluate_function(sf, seg, ctx, sub_scores).astype(np.float32)
        if sf.weight is not None:
            v = v * np.float32(sf.weight)
        fmask = segment_mask(seg, sf.filter, ctx) if sf.filter is not None else None
        vals.append(v)
        masks.append(fmask if fmask is not None else np.ones(D, dtype=bool))
    stacked = np.stack(vals)
    mstack = np.stack(masks)
    any_applies = mstack.any(axis=0)
    one = np.float32(1.0)
    if q.score_mode == "multiply":
        combined = np.where(mstack, stacked, one).prod(axis=0, dtype=np.float32)
    elif q.score_mode == "sum":
        combined = np.where(mstack, stacked, np.float32(0.0)).sum(
            axis=0, dtype=np.float32)
    elif q.score_mode == "avg":
        cnt = mstack.sum(axis=0)
        s = np.where(mstack, stacked, np.float32(0.0)).sum(axis=0, dtype=np.float32)
        combined = np.where(cnt > 0, s / np.maximum(cnt, 1).astype(np.float32), one)
    elif q.score_mode == "max":
        combined = np.where(mstack, stacked, np.float32(-np.inf)).max(axis=0)
        combined = np.where(np.isfinite(combined), combined, one)
    elif q.score_mode == "min":
        combined = np.where(mstack, stacked, np.float32(np.inf)).min(axis=0)
        combined = np.where(np.isfinite(combined), combined, one)
    elif q.score_mode == "first":
        combined = np.ones(D, dtype=np.float32)
        chosen = np.zeros(D, dtype=bool)
        for v, m in zip(vals, masks):
            take = m & ~chosen
            combined = np.where(take, v, combined)
            chosen |= m
    else:
        raise QueryParsingError(f"unknown score_mode [{q.score_mode}]")
    return combined.astype(np.float32), any_applies


def apply_functions(q, sub_scores: np.ndarray, match: np.ndarray, seg, ctx) -> np.ndarray:
    """Combine function values with the subquery score (score_mode × boost_mode).
    Float32 throughout — in lockstep with the device family's tail
    (ops/scoring._fs_rows_impl)."""
    if not q.functions:
        return sub_scores.astype(np.float32)
    combined, any_applies = combined_doc_rows(q, sub_scores, seg, ctx)
    sub_scores = sub_scores.astype(np.float32)
    combined = np.where(any_applies, combined, np.float32(1.0))
    if math.isfinite(q.max_boost):
        combined = np.minimum(combined, np.float32(q.max_boost))
    bm = q.boost_mode
    if bm == "multiply":
        out = sub_scores * combined
    elif bm == "replace":
        out = np.where(any_applies, combined, sub_scores)
    elif bm == "sum":
        out = sub_scores + combined
    elif bm == "avg":
        out = (sub_scores + combined) / np.float32(2.0)
    elif bm == "max":
        out = np.maximum(sub_scores, combined)
    elif bm == "min":
        out = np.minimum(sub_scores, combined)
    else:
        raise QueryParsingError(f"unknown boost_mode [{bm}]")
    return out.astype(np.float32)
