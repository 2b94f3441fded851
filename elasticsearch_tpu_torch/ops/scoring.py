"""Batched query scoring on the device — the port of the JAX package's
`ops/scoring.py`: the plain-plan path and the dense request-feature family.

Two programs score a batch of plain flat bool-of-terms queries against one
packed segment:

- the SPARSE path (the hot path): queries are bucketed by how many postings
  blocks they touch (power-of-two TB buckets, chunked to a slot budget), and
  each bucket is one launch of the fused `sparse_score` kernel
  (ops/sparse_kernels.py) — work scales with postings touched, not with the
  corpus;
- the DENSE overflow path, for queries past `tb_max` blocks: gather every
  (query, block) triple, scatter-add contributions and packed match counters
  into [Q, doc_pad+1] accumulators, apply the bool semantics and the coord
  factor, take the top k. It is torch ops (the JAX package's XLA program
  `_score_batch_impl`, not a Pallas kernel). Its float32 accumulation adds
  each doc's contributions in clause order on the card as on the CPU
  (`_dense_accumulate`), so a repeated query gets the same scores; it is
  held to ≤ 2 ulp of the JAX package's scatter, which adds in its own
  order.

The dense family runs the dense program's core (`_dense_accumulate`,
`_dense_semantics`) with a tail per request feature, all torch ops (the JAX
package's XLA programs B4, B5 and B6, not Pallas kernels):

- `_dense_aggstats_impl`: `match & fmask` — a FilteredQuery's filter (or a
  post filter) gates matching, never scoring — then the metric stats
  (`agg_stat_reduction`) and the bucket counts (`_bucket_scatter`) of the
  aggregations under the match; with no aggregation it is the filtered core
  (the JAX package's `score_filtered_batch` is its F=0 call too);
- `_dense_sort_impl`: the top k by a pre-folded field-sort key row, ties to
  the lower doc;
- `_fs_rows_impl`: function_score whose functions never read `_score`: one
  host-combined float32 row a segment (`search/functions.combined_doc_rows`),
  then `max_boost`, `boost_mode`, the outer boost and `min_score`, in the
  JAX package's float32 order;
- `_fs_script_impl`: one `_score`-reading script_score, evaluated by the
  torch twin of the script vectorizer over the [Q, Dpad] sub-scores, with a
  per-query `bad` flag that sends the query to the host scorer.

The outer boost and `min_score` are per-query rows here (the JAX package
bakes them per launch): one launch serves every query of a spec whatever
its threshold. Each launcher returns device tensors without synchronising;
the caller pulls a whole batch behind one event (`cudaenv.pull_async`).

Match-count packing: one int32 carries three counters — bits 0-9 matched
SHOULD clauses, 10-19 MUST, 20-29 MUST_NOT.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from ..common import profile as _profile
from ..common.breaker import reserve
from ..common.cudaenv import pull, upload, upload_buffer
from ..common.errors import BodyValueError, body_value
from .device_index import (
    BLOCK,
    PackedSegment,
    SimTables,
    _pow2_bucket,
    ensure_blk_freqs,
)
from .sparse_kernels import (
    _MUST_SHIFT,
    _NOT_SHIFT,
    GROUP_MUST,
    GROUP_MUST_NOT,
    GROUP_SHOULD,
    sparse_score,
    sqrt_rn,
    top_k_lowest_index,
)

MODE_BM25 = 0  # contribution = w * freq/(freq + cache[normbyte])
MODE_TFIDF = 1  # contribution = w * sqrt(freq) * cache[normbyte]
MODE_CONST = 2  # contribution = w per matching term

# bytes of device temporaries per (query, doc) cell of one dense launch:
# scores/counters/match/coord index/top-k keys — the overflow chunking budget
_DENSE_CELL_BYTES = 64
DENSE_BUDGET_BYTES = 4 << 30


@dataclass
class TermBatch:
    """Flattened (query, block) triples + per-query bool-semantics arrays for
    the dense program, built on the host by the planner."""

    n_queries: int
    qidx: np.ndarray  # int32 [M]
    blk: np.ndarray  # int32 [M] — block row (padding: the all-sentinel row)
    weight: np.ndarray  # float32 [M]
    fidx: np.ndarray  # int32 [M] — row of the stacked norm/cache tables
    group: np.ndarray  # int32 [M] — GROUP_*
    tfmode: np.ndarray  # int32 [M] — MODE_*
    n_must: np.ndarray  # int32 [Q]
    msm: np.ndarray  # int32 [Q]
    coord: np.ndarray  # float32 [Q, C+1]
    norm_fields: list = dc_field(default_factory=list)  # field names, order = fidx
    caches: np.ndarray | None = None  # float32 [F, 256]
    # row offsets of the clause slots (slot j: rows slots[j]..slots[j+1]);
    # within one slot no two rows of a query share a doc
    slots: tuple = ()


@dataclass
class ScoreResult:
    scores: np.ndarray  # [Q, k] float32
    docs: np.ndarray  # [Q, k] int32 (local doc ids; doc_pad → no hit)
    total_hits: np.ndarray  # [Q]
    max_score: np.ndarray  # [Q] float32


def _dense_accumulate(blk_docs, blk_freqs, norms_stack, caches, qidx, blk,
                      weight, fidx, group, tfmode, *, Q: int, doc_pad: int,
                      slots: tuple = ()):
    """Gather the postings blocks, compute per-posting contributions (tf
    factor first, then the weight — Lucene's rounding order) and scatter-add
    them into the [Q, doc_pad] accumulator, each doc's in clause order.
    Returns (scores, flat_idx, valid)."""
    rows = blk.long()
    docs = blk_docs[rows]  # [M, B]
    freqs = blk_freqs[rows]
    valid = docs < doc_pad
    docs_safe = torch.where(valid, docs, 0).long()
    f = fidx.long()[:, None]
    nb = norms_stack[f, docs_safe]
    cache_vals = caches[f, nb.long()]
    mode = tfmode[:, None]
    w = weight[:, None]
    bm25 = w * (freqs / (freqs + cache_vals))
    tfidf = w * (sqrt_rn(freqs) * cache_vals)
    contrib = torch.where(mode == MODE_BM25, bm25,
                          torch.where(mode == MODE_TFIDF, tfidf, w))
    scoring = (group[:, None] != GROUP_MUST_NOT) & valid
    contrib = torch.where(scoring, contrib, 0.0)
    stride = doc_pad + 1
    # invalid slots land in one spare cell past the end, dropped below
    flat_idx = torch.where(valid, qidx.long()[:, None] * stride + docs_safe,
                           Q * stride).reshape(-1)
    scores = torch.zeros(Q * stride + 1, dtype=torch.float32,
                         device=blk_docs.device)
    src = contrib.reshape(-1)
    if slots:
        # the card's index_add_ adds with atomics in no fixed order: one call
        # a clause slot, inside which no cell takes two contributions (only
        # +0.0s meet in the spare cell), so each doc's sum runs in clause
        # order on the card as on the CPU
        B = docs.shape[1]
        for lo, hi in zip(slots[:-1], slots[1:]):
            scores.index_add_(0, flat_idx[lo * B: hi * B], src[lo * B: hi * B])
    else:
        scores.index_add_(0, flat_idx, src)
    scores = scores[: Q * stride].view(Q, stride)[:, :doc_pad]
    return scores, flat_idx, valid


def _dense_semantics(scores, flat_idx, valid, group, live_parent, n_must, msm,
                     coord, *, Q: int, doc_pad: int):
    """Bool-query semantics + coord over the dense accumulator: returns the
    coord-scaled scores and the match mask."""
    counters = (torch.where(group == GROUP_SHOULD, 1, 0)
                + torch.where(group == GROUP_MUST, 1 << _MUST_SHIFT, 0)
                + torch.where(group == GROUP_MUST_NOT, 1 << _NOT_SHIFT, 0)
                ).to(torch.int32)
    counter_vals = torch.where(valid, counters[:, None], 0).to(torch.int32)
    stride = doc_pad + 1
    counts = torch.zeros(Q * stride + 1, dtype=torch.int32,
                         device=scores.device)
    counts.index_add_(0, flat_idx, counter_vals.reshape(-1))
    counts = counts[: Q * stride].view(Q, stride)[:, :doc_pad]

    m_should = counts & 0x3FF
    m_must = (counts >> _MUST_SHIFT) & 0x3FF
    m_not = counts >> _NOT_SHIFT
    match = ((m_must == n_must[:, None]) & (m_should >= msm[:, None])
             & (m_not == 0))
    match = match & ((m_should + m_must) > 0) & live_parent[None, :doc_pad]
    # the coord row lookup equals the reference's select-sum: one addend is
    # coord[q, overlap], every other is +0.0
    overlap = torch.clamp(m_should + m_must, max=coord.shape[1] - 1)
    return scores * torch.gather(coord, 1, overlap.long()), match


def _score_batch_impl(blk_docs, blk_freqs, live_parent, norms_stack, caches,
                      qidx, blk, weight, fidx, group, tfmode,
                      n_must, msm, coord, *, n_queries: int, k: int,
                      doc_pad: int, simple: bool = False, slots: tuple = ()):
    """The dense program. simple=True: every clause is a SHOULD with msm<=1
    and no coord — match reduces to score>0 and the counters are skipped.
    Returns ([Q, k] scores, [Q, k] int32 docs, [Q] int32 totals)."""
    Q = n_queries
    scores, flat_idx, valid = _dense_accumulate(
        blk_docs, blk_freqs, norms_stack, caches, qidx, blk, weight, fidx,
        group, tfmode, Q=Q, doc_pad=doc_pad, slots=slots)
    if simple:
        match = (scores > 0.0) & live_parent[None, :doc_pad]
    else:
        scores, match = _dense_semantics(scores, flat_idx, valid, group,
                                         live_parent, n_must, msm, coord,
                                         Q=Q, doc_pad=doc_pad)
    masked = torch.where(match, scores, float("-inf"))
    top_scores, top_docs = top_k_lowest_index(masked, k)
    return (top_scores, top_docs.to(torch.int32),
            match.sum(dim=1, dtype=torch.int32))


def _detect_simple(batch: TermBatch) -> bool:
    """Pure-should all-BM25 batches reduce match to score>0 (BM25 is the only
    mode whose contribution is provably positive for every posting hit)."""
    return bool(np.all(batch.group == GROUP_SHOULD)
                and np.all(batch.msm <= 1) and np.all(batch.n_must == 0)
                and np.all(batch.tfmode == MODE_BM25)
                and np.all(batch.coord == 1.0))


def _stack_args(packed: PackedSegment, batch: TermBatch):
    """The stacked norm-byte and cache tables of a dense launch."""
    norms_stack = (torch.stack([packed.norm_bytes[f] for f in batch.norm_fields])
                   if batch.norm_fields
                   else torch.zeros((1, packed.doc_pad), dtype=torch.uint8,
                                    device=packed.device))
    caches = upload(batch.caches if batch.caches is not None
                    else np.ones((1, 256), np.float32), packed.device)
    return norms_stack, caches


def dense_chunk(doc_pad: int) -> int:
    """Queries per dense launch so its [Q, doc_pad+1] temporaries stay
    within DENSE_BUDGET_BYTES."""
    return max(1, DENSE_BUDGET_BYTES // ((doc_pad + 1) * _DENSE_CELL_BYTES))


def score_term_batch_async(packed: PackedSegment, batch: TermBatch, k: int):
    """Launch the dense program for one term batch; returns device tensors
    (scores, docs, totals) without synchronising."""
    dev = packed.device
    norms_stack, caches = _stack_args(packed, batch)
    return _score_batch_impl(
        packed.blk_docs, ensure_blk_freqs(packed), packed.live_parent,
        norms_stack, caches,
        *(upload(a, dev) for a in (batch.qidx, batch.blk, batch.weight,
                                   batch.fidx, batch.group, batch.tfmode,
                                   batch.n_must, batch.msm, batch.coord)),
        n_queries=batch.n_queries, k=min(k, packed.doc_pad),
        doc_pad=packed.doc_pad, simple=_detect_simple(batch), slots=batch.slots)


# ---------------------------------------------------------------------------
# the dense request-feature family: filtered and function_score tails
# ---------------------------------------------------------------------------


def _bmode_combine(sub, comb, applied, bmode: str):
    """boost_mode combine, float32, in `functions.apply_functions`' order.
    applied=None means every doc has a function applied (no filter)."""
    if bmode == "multiply":
        return sub * comb
    if bmode == "replace":
        return comb if applied is None else torch.where(applied, comb, sub)
    if bmode == "sum":
        return sub + comb
    if bmode == "avg":
        return (sub + comb) / 2.0
    if bmode == "max":
        return torch.maximum(sub, comb)
    if bmode == "min":
        return torch.minimum(sub, comb)
    raise BodyValueError(f"unknown boost_mode [{bmode}]")


def _fs_tail(scores, match, comb, applied, max_boost: float, fboost, min_score,
             gate, *, bmode: str, k: int):
    """The function_score tail shared by both fs variants: cap, boost_mode,
    outer boost (per query), the per-query min_score gate, top-k, total.
    comb=None is a spec without functions: the outer boost and the gate
    alone."""
    if comb is None:
        out = scores * fboost[:, None]
    else:
        comb = torch.clamp(comb, max=max_boost)
        out = _bmode_combine(scores, comb, applied, bmode) * fboost[:, None]
    match = match & (~gate[:, None] | (out >= min_score[:, None]))
    masked = torch.where(match, out, float("-inf"))
    top_scores, top_docs = top_k_lowest_index(masked, k)
    return (top_scores, top_docs.to(torch.int32),
            match.sum(dim=1, dtype=torch.int32))


def _fs_rows_impl(blk_docs, blk_freqs, live_parent, norms_stack, caches,
                  qidx, blk, weight, fidx, group, tfmode, n_must, msm, coord,
                  g_row, applies_row, fboost, min_score, gate,
                  *, n_queries: int, k: int, doc_pad: int, bmode: str,
                  max_boost: float, slots: tuple = ()):
    """Dense core + host-combined function rows (g_row f32 [Dpad], applies_row
    bool [Dpad]; both None when the spec has no function: then the tail is
    the outer boost and min_score alone). fboost/min_score f32 [Q], gate
    bool [Q] (has a min_score). Returns (scores [Q, k], docs i32, totals)."""
    Q = n_queries
    scores, flat_idx, valid = _dense_accumulate(
        blk_docs, blk_freqs, norms_stack, caches, qidx, blk, weight, fidx,
        group, tfmode, Q=Q, doc_pad=doc_pad, slots=slots)
    scores, match = _dense_semantics(scores, flat_idx, valid, group,
                                     live_parent, n_must, msm, coord,
                                     Q=Q, doc_pad=doc_pad)
    applied = comb = None
    if g_row is not None:
        applied = applies_row[None, :]
        comb = torch.where(applied, g_row[None, :], 1.0)
    return _fs_tail(scores, match, comb, applied, max_boost, fboost, min_score,
                    gate, bmode=bmode, k=k)


def _fs_script_impl(blk_docs, blk_freqs, live_parent, norms_stack, caches,
                    qidx, blk, weight, fidx, group, tfmode, n_must, msm, coord,
                    col_rows, fmask_row, bad_row, parent_row,
                    fboost, min_score, gate,
                    *, n_queries: int, k: int, doc_pad: int, script,
                    used_fields: tuple, bmode: str, max_boost: float,
                    weight_s: float | None, slots: tuple = ()):
    """Dense core + one `_score`-reading script evaluated over the [Q, Dpad]
    sub-scores (the torch twin of the script vectorizer), its doc columns
    as f32 [Dpad] rows (NaN = missing). fmask_row: the function's filter
    (None: none). Returns (scores, docs, totals, bad [Q]): a query is bad
    when a parent doc has a used column missing (`bad_row`) or a
    non-finite script value — the host scorer reruns it, where the per-doc
    evaluation decides (and may raise ScriptError)."""
    from ..script import torch_vectorizer_cls

    Q = n_queries
    scores, flat_idx, valid = _dense_accumulate(
        blk_docs, blk_freqs, norms_stack, caches, qidx, blk, weight, fidx,
        group, tfmode, Q=Q, doc_pad=doc_pad, slots=slots)
    scores, match = _dense_semantics(scores, flat_idx, valid, group,
                                     live_parent, n_must, msm, coord,
                                     Q=Q, doc_pad=doc_pad)
    cols = dict(zip(used_fields, col_rows))
    vec = torch_vectorizer_cls()(script, lambda f: cols[f], scores)
    val = vec.vectorize()
    if not isinstance(val, torch.Tensor):
        val = torch.full((), val, dtype=torch.float32, device=scores.device)
    val = torch.broadcast_to(val.to(torch.float32), scores.shape)
    if weight_s is not None:
        val = val * weight_s
    applied = None if fmask_row is None else fmask_row[None, :]
    comb = val if applied is None else torch.where(applied, val, 1.0)
    top_scores, top_docs, total = _fs_tail(
        scores, match, comb, applied, max_boost, fboost, min_score, gate,
        bmode=bmode, k=k)
    bad = (bad_row[None, :] | (parent_row[None, :] & ~torch.isfinite(val))).any(dim=1)
    return top_scores, top_docs, total, bad


def agg_stat_reduction(match, agg_rows):
    """Masked metric stats under a match mask. match: bool [Q, Dpad];
    agg_rows: f32 [F, 5, Dpad] per-doc folds (device_index.agg_doc_rows:
    count, sum, min, max, sumsq). Returns (counts int32 [Q, F], stats f32
    [Q, F, 4] = (sum, min, max, sumsq)). Counts are an exact int32
    reduction. The sums are masked float32 reductions, not a matmul: the
    JAX package's `[Q, Dpad] @ [Dpad, 2F]` product would follow a
    process-wide TF32 switch on the card (`torch.backends.cuda.matmul.
    allow_tf32`, `set_float32_matmul_precision`), which rounds a fractional
    value to 11 bits; a reduction never does."""
    F = agg_rows.shape[0]
    m = match[:, None, :]  # [Q, 1, Dpad]
    lin = torch.cat([agg_rows[:, 1], agg_rows[:, 4]], dim=0)  # [2F, Dpad]
    sums2 = torch.where(m, lin[None], 0.0).sum(dim=2)  # [Q, 2F]
    cnt_rows = agg_rows[:, 0].to(torch.int32)  # [F, Dpad]
    counts = torch.where(m, cnt_rows[None], 0).sum(dim=2, dtype=torch.int32)
    has = m & (agg_rows[None, :, 0, :] > 0)  # [Q, F, Dpad]
    mins = torch.where(has, agg_rows[None, :, 2, :], float("inf")).amin(dim=2)
    maxs = torch.where(has, agg_rows[None, :, 3, :], float("-inf")).amax(dim=2)
    stats = torch.stack([sums2[:, :F], mins, maxs, sums2[:, F:]], dim=2)
    return counts, stats


def _bucket_scatter(match, pdoc, pbucket, nb: int, sub_stack):
    """One bucket agg's reductions: exact int32 doc counts per bucket over
    its (doc, bucket) pairs (pdoc, pbucket int64 [NP]), plus, when the agg
    carries metric sub-aggs (sub_stack [Fs, 5, Dpad]), per-bucket masked
    stats of the per-doc folds scattered along the same pairs, so a doc
    contributes once to each bucket it belongs to (the host's per-bucket
    mask collection). The int32 scatters and the min/max ones give the same
    result in any order; the float sums on the card add in no fixed order.
    Returns (counts [Q, nb], sub counts [Q, Fs, nb] | None, sub stats
    [Q, Fs, nb, 4] | None)."""
    Q = match.shape[0]
    hit = match[:, pdoc]  # [Q, NP]
    counts = torch.zeros((Q, nb), dtype=torch.int32, device=match.device)
    counts.index_add_(1, pbucket, hit.to(torch.int32))
    if sub_stack is None:
        return counts, None, None
    Fs = sub_stack.shape[0]
    m = hit[:, None, :]  # [Q, 1, NP]
    cnt_g = sub_stack[:, 0][:, pdoc].to(torch.int32)  # [Fs, NP]
    sub_cnt = torch.zeros((Q, Fs, nb), dtype=torch.int32, device=match.device)
    sub_cnt.index_add_(2, pbucket, torch.where(m, cnt_g[None], 0))
    has_vals = m & (cnt_g[None] > 0)  # min/max must ignore value-less docs
    idx = pbucket.expand(Q, Fs, -1)
    parts = []
    for row, fill, op in ((1, 0.0, "add"), (2, float("inf"), "amin"),
                          (3, float("-inf"), "amax"), (4, 0.0, "add")):
        g = sub_stack[:, row][:, pdoc]  # [Fs, NP]
        contrib = torch.where(m if op == "add" else has_vals, g[None], fill)
        base = torch.full((Q, Fs, nb), fill, dtype=torch.float32,
                          device=match.device)
        if op == "add":
            base.index_add_(2, pbucket, contrib)
        else:
            base.scatter_reduce_(2, idx, contrib, op)
        parts.append(base)
    return counts, sub_cnt, torch.stack(parts, dim=3)


def _dense_aggstats_impl(blk_docs, blk_freqs, live_parent, norms_stack, caches,
                         qidx, blk, weight, fidx, group, tfmode, n_must, msm,
                         coord, agg_rows, bucket_pairs, fmask, *, n_queries: int,
                         k: int, doc_pad: int, slots: tuple = ()):
    """Dense core + aggregations: per-query filter masks (fmask bool
    [Q, Dpad], None: none) gate matching; the metric stats of `agg_rows`
    (f32 [F, 5, Dpad], None: F = 0) and each bucket agg of `bucket_pairs`
    ((pair docs, pair buckets, bucket count, sub-agg folds | None) each)
    reduce under the match. With F = 0 and no bucket pairs it is the
    filtered core the filtered family launches. Returns (scores [Q, k],
    docs i32, totals, counts | None, stats | None, bucket results)."""
    Q = n_queries
    scores, flat_idx, valid = _dense_accumulate(
        blk_docs, blk_freqs, norms_stack, caches, qidx, blk, weight, fidx,
        group, tfmode, Q=Q, doc_pad=doc_pad, slots=slots)
    scores, match = _dense_semantics(scores, flat_idx, valid, group,
                                     live_parent, n_must, msm, coord,
                                     Q=Q, doc_pad=doc_pad)
    if fmask is not None:
        match = match & fmask
    masked = torch.where(match, scores, float("-inf"))
    top_scores, top_docs = top_k_lowest_index(masked, k)
    counts, stats = (None, None) if agg_rows is None else \
        agg_stat_reduction(match, agg_rows)
    buckets = tuple(_bucket_scatter(match, pdoc, pbucket, nb, sub)
                    for (pdoc, pbucket, nb, sub) in bucket_pairs)
    return (top_scores, top_docs.to(torch.int32),
            match.sum(dim=1, dtype=torch.int32), counts, stats, buckets)


def _dense_sort_impl(blk_docs, blk_freqs, live_parent, norms_stack, caches,
                     qidx, blk, weight, fidx, group, tfmode, n_must, msm, coord,
                     fmask, key_row, *, n_queries: int, k: int, doc_pad: int,
                     descending: bool, slots: tuple = ()):
    """Dense core + field-sort top-k over a pre-folded f32 [Dpad] key row
    (ascending semantics; sorting.device_sort_key_row bakes in the mode and
    the missing policy). Ties go to the lower doc, as `lax.top_k` gives
    them, and both order -0.0 below +0.0. Returns (keys [Q, k], docs i32,
    the winners' scores, the top score over ALL matches (not only the
    winners), totals)."""
    Q = n_queries
    scores, flat_idx, valid = _dense_accumulate(
        blk_docs, blk_freqs, norms_stack, caches, qidx, blk, weight, fidx,
        group, tfmode, Q=Q, doc_pad=doc_pad, slots=slots)
    scores, match = _dense_semantics(scores, flat_idx, valid, group,
                                     live_parent, n_must, msm, coord,
                                     Q=Q, doc_pad=doc_pad)
    if fmask is not None:
        match = match & fmask
    pad = float("-inf") if descending else float("inf")
    sortable = torch.where(match, key_row[None, :], pad)
    if descending:
        top_keys, top_docs = top_k_lowest_index(sortable, k)
    else:
        neg, top_docs = top_k_lowest_index(-sortable, k)
        top_keys = -neg
    top_scores = torch.gather(scores, 1, top_docs)
    qmax = torch.where(match, scores, float("-inf")).amax(dim=1)
    return (top_keys, top_docs.to(torch.int32), top_scores, qmax,
            match.sum(dim=1, dtype=torch.int32))


def _f32(x: float) -> float:
    """A Python number rounded to float32 (the JAX package's device scalar)."""
    return float(np.float32(x))


def _batch_args(packed: PackedSegment, batch: TermBatch) -> tuple:
    """The dense core's leading arguments for one launch, uploaded without
    synchronising."""
    dev = packed.device
    norms_stack, caches = _stack_args(packed, batch)
    return (packed.blk_docs, ensure_blk_freqs(packed), packed.live_parent,
            norms_stack, caches,
            *(upload(a, dev) for a in (batch.qidx, batch.blk, batch.weight,
                                       batch.fidx, batch.group, batch.tfmode,
                                       batch.n_must, batch.msm, batch.coord)))


def _tail_rows(packed: PackedSegment, fboost, min_score) -> tuple:
    """Per-query outer boost, min_score and gate rows (min_score None: no
    gate) as device tensors."""
    dev = packed.device
    gate = np.asarray([m is not None for m in min_score], bool)
    return (upload(np.asarray([_f32(b) for b in fboost], np.float32), dev),
            upload(np.asarray([body_value(_f32, 0.0 if m is None else m)
                               for m in min_score],
                              np.float32), dev),
            upload(gate, dev))


def score_filtered_batch_async(packed: PackedSegment, batch: TermBatch, k: int,
                               fmask):
    """Launch the filtered core; fmask is a bool [Q, Dpad] tensor on the
    pack's device. Returns device (scores, docs, totals) unsynchronised."""
    return _dense_aggstats_impl(
        *_batch_args(packed, batch), None, (), fmask, n_queries=batch.n_queries,
        k=min(k, packed.doc_pad), doc_pad=packed.doc_pad, slots=batch.slots)[:3]


def score_agg_batch_async(packed: PackedSegment, batch: TermBatch, k: int,
                          agg_rows, bucket_pairs=(), fmask=None):
    """Launch the aggregating core: agg_rows f32 [F, 5, Dpad] (None: no
    metric agg), bucket_pairs per bucket agg (pair docs, pair buckets int64
    [NP], bucket count, sub-agg folds [Fs, 5, Dpad] | None), fmask bool
    [Q, Dpad] | None, all on the pack's device. Returns device (scores,
    docs, totals, counts, stats, bucket results) unsynchronised."""
    return _dense_aggstats_impl(
        *_batch_args(packed, batch), agg_rows, tuple(bucket_pairs), fmask,
        n_queries=batch.n_queries, k=min(k, packed.doc_pad),
        doc_pad=packed.doc_pad, slots=batch.slots)


def score_sorted_batch_async(packed: PackedSegment, batch: TermBatch, k: int,
                             key_row, descending: bool, fmask=None):
    """Launch the field-sorted core: key_row f32 [Dpad], fmask bool
    [Q, Dpad] | None, on the pack's device. Matched docs fill the first
    min(total, k) slots of a query (padding ranks after the ±FLT_MAX keys
    of missing values). Returns device (keys, docs, scores, top score,
    totals) unsynchronised."""
    return _dense_sort_impl(
        *_batch_args(packed, batch), fmask, key_row, n_queries=batch.n_queries,
        k=min(k, packed.doc_pad), doc_pad=packed.doc_pad, descending=descending,
        slots=batch.slots)


def score_fs_rows_batch_async(packed: PackedSegment, batch: TermBatch, k: int,
                              g_row, applies_row, max_boost: float, fboost,
                              min_score, bmode: str):
    """Launch the rows variant: g_row f32 / applies_row bool [Dpad] tensors
    on the pack's device (None for a spec without functions); fboost and
    min_score per query (min_score None: no gate). Returns device (scores,
    docs, totals) unsynchronised."""
    return _fs_rows_impl(
        *_batch_args(packed, batch), g_row, applies_row,
        *_tail_rows(packed, fboost, min_score),
        n_queries=batch.n_queries, k=min(k, packed.doc_pad),
        doc_pad=packed.doc_pad, bmode=bmode, max_boost=_f32(max_boost),
        slots=batch.slots)


def score_fs_script_batch_async(packed: PackedSegment, batch: TermBatch, k: int,
                                script, used_fields: tuple, col_rows, fmask_row,
                                bad_row, parent_row, weight, max_boost: float,
                                fboost, min_score, bmode: str):
    """Launch the script variant: its column (f32), filter, bad and parent
    (bool) rows are [Dpad] tensors on the pack's device (fmask_row None
    without a function filter). Returns device (scores, docs, totals, bad)
    unsynchronised."""
    return _fs_script_impl(
        *_batch_args(packed, batch), tuple(col_rows), fmask_row, bad_row,
        parent_row, *_tail_rows(packed, fboost, min_score),
        n_queries=batch.n_queries, k=min(k, packed.doc_pad),
        doc_pad=packed.doc_pad, script=script, used_fields=tuple(used_fields),
        bmode=bmode, max_boost=_f32(max_boost),
        weight_s=None if weight is None else _f32(weight), slots=batch.slots)


def finalize_score_result(scores: np.ndarray, docs: np.ndarray,
                          total: np.ndarray, doc_pad: int) -> ScoreResult:
    """Host-side [Q, k] post-processing: -inf slots → doc_pad sentinel, max_score."""
    finite = np.isfinite(scores)
    docs = np.where(finite, docs, doc_pad).astype(np.int32)
    max_score = np.where(total > 0, scores[:, 0], np.nan).astype(np.float32)
    return ScoreResult(scores=scores, docs=docs, total_hits=total,
                       max_score=max_score)


def build_term_batch(cols: tuple, n_queries: int, n_must: np.ndarray,
                     msm: np.ndarray, coord: np.ndarray, norm_fields: list[str],
                     caches: np.ndarray, nb_pad_row: int) -> TermBatch:
    """Assemble + bucket-pad the flat triple arrays. `cols` = (qidx, blk_row,
    weight, fidx, group, tfmode, slot) columns of equal length (weight
    float64: each rounds to float32 once, here; slot: the row's clause
    ordinal in its query). The rows are ordered by slot, stably, so each
    query's rows keep their clause order, and `slots` holds each slot's
    first row; padding rows point at `nb_pad_row`, a row of doc_pad
    sentinels that contributes nothing."""
    n = len(cols[0])
    order = np.argsort(cols[6], kind="stable")
    cols = tuple(np.asarray(c)[order] for c in cols)
    starts = np.flatnonzero(np.diff(cols[6], prepend=-1))
    slots = tuple(int(i) for i in starts) + (n,)
    M = _pow2_bucket(max(n, 1), 16)
    qidx = np.zeros(M, np.int32)
    blk = np.full(M, nb_pad_row, np.int32)
    weight = np.zeros(M, np.float32)
    fidx = np.zeros(M, np.int32)
    group = np.zeros(M, np.int32)
    tfmode = np.zeros(M, np.int32)
    for arr, col in zip((qidx, blk, weight, fidx, group, tfmode), cols):
        arr[:n] = col
    return TermBatch(
        n_queries=n_queries, qidx=qidx, blk=blk, weight=weight, fidx=fidx,
        group=group, tfmode=tfmode, n_must=n_must.astype(np.int32),
        msm=msm.astype(np.int32), coord=coord.astype(np.float32),
        norm_fields=norm_fields, caches=caches, slots=slots)


# ---------------------------------------------------------------------------
# sparse candidate-centric path (the serving hot path)
# ---------------------------------------------------------------------------

# the staging arrays of one sparse bucket in the order they sit in its one
# host buffer: the 4-byte arrays first, the 1-byte qconst last, each at an
# offset aligned like the caching allocator's blocks, so every typed view
# keeps its dtype's alignment on both sides of the copy
_STAGING_FIELDS = (("qblk", np.int32), ("qw", np.float32), ("qcnt", np.int32),
                   ("qfid", np.int32), ("n_must", np.int32), ("msm", np.int32),
                   ("coord", np.float32), ("qconst", np.bool_))
_STAGING_ALIGN = 256
_TORCH_DTYPES = {np.int32: torch.int32, np.float32: torch.float32,
                 np.bool_: torch.bool}


def _staging_layout(Qb: int, tb: int, c1: int) -> tuple[list, int]:
    """[(name, dtype, shape, offset, bytes)] of a [Qb, TB] bucket's staging
    set with coord [Qb, c1], and the buffer's size in bytes."""
    shapes = {"n_must": (Qb,), "msm": (Qb,), "coord": (Qb, c1)}
    layout, off = [], 0
    for name, dt in _STAGING_FIELDS:
        shape = shapes.get(name, (Qb, tb))
        nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
        layout.append((name, dt, shape, off, nbytes))
        off += -(-nbytes // _STAGING_ALIGN) * _STAGING_ALIGN
    return layout, off


class StagingSet:
    """The eight staging arrays of one sparse bucket as typed numpy views
    into ONE host buffer: `to_device` sends the whole buffer with one copy
    and returns typed device views of it. `key` is every dimension that
    sizes the buffer: (Qb, TB, C+1).

    The buffer is pageable memory: a copy from pageable memory has taken its
    source when the call returns (the driver stages it), so a set can be
    written again as soon as its launch has returned."""

    __slots__ = ("key", "buf", "layout", "arrays")

    def __init__(self, Qb: int, tb: int, c1: int):
        self.key = (Qb, tb, c1)
        self.layout, nbytes = _staging_layout(Qb, tb, c1)
        self.buf = torch.empty(nbytes, dtype=torch.uint8)
        host = self.buf.numpy()
        self.arrays = {name: host[off: off + n].view(dt).reshape(shape)
                       for (name, dt, shape, off, n) in self.layout}

    def reset(self, sentinel_row: int) -> None:
        """Padding values: every slot at the sentinel block row, weight and
        counters 0, coord 1."""
        a = self.arrays
        a["qblk"].fill(sentinel_row)
        for name in ("qw", "qcnt", "qfid", "n_must", "msm", "qconst"):
            a[name].fill(0)
        a["coord"].fill(1.0)

    def to_device(self, device: torch.device) -> dict:
        """name -> the array as a tensor on `device`, from ONE upload of the
        buffer (on the CPU: views of the host buffer itself)."""
        dbuf = upload_buffer(self.buf, device)
        return {name: dbuf[off: off + n].view(_TORCH_DTYPES[dt]).view(shape)
                for (name, dt, shape, off, n) in self.layout}


class SparseScratchPool:
    """Reusable staging sets for plan_sparse_buckets, held by each packed
    segment (`PackedSegment.sparse_scratch`, made at its first launch).

    The planner would otherwise allocate eight arrays for every bucket of
    every launch, even when the shapes repeat on every warmed batch. The
    pool hands out and takes back `StagingSet`s keyed by (Qb, TB, C+1): a
    warmed repeat batch makes 0 new allocations (`allocs` stays flat). A
    set is borrowed from take() until its bucket's launch has returned:
    by then the launch has copied it (a pageable copy takes its source
    before it returns; on the CPU the plain version has run), so
    launch_flat_sparse gives every set back before it returns, on success
    and on failure alike. Check-out and check-in keep concurrent launches
    on one segment apart; the free list is bounded, so a burst of
    concurrency does not hold staging memory forever."""

    _MAX_FREE = 4  # sets kept per shape

    def __init__(self):
        self._free: dict[tuple, list] = {}
        self._lock = threading.Lock()
        self.allocs = 0  # fresh allocations (a warmed repeat adds none)
        self.reuses = 0

    @staticmethod
    def staging_bytes(Qb: int, tb: int, c1: int) -> int:
        """Bytes of one staging set: its one buffer, alignment included."""
        return _staging_layout(Qb, tb, c1)[1]

    def take(self, Qb: int, tb: int, c1: int, sentinel_row: int) -> StagingSet:
        with self._lock:
            lst = self._free.get((Qb, tb, c1))
            st = lst.pop() if lst else None
            if st is None:
                self.allocs += 1
            else:
                self.reuses += 1
        # profile attribution, outside the pool lock (record-only)
        prof = _profile.current()
        if prof is not None:
            prof.event("scratch", cache="alloc" if st is None else "reuse",
                       shape=[int(Qb), int(tb)])
        if st is None:
            st = StagingSet(Qb, tb, c1)
        st.reset(sentinel_row)
        return st

    def give(self, st: StagingSet) -> None:
        """Take back a set whose launch has returned (one past the bound is
        dropped)."""
        with self._lock:
            lst = self._free.setdefault(st.key, [])
            if len(lst) < self._MAX_FREE:
                lst.append(st)


@dataclass
class SparseBatch:
    """One bucket of queries sharing a [Qb, TB] block layout."""

    n_queries: int  # real queries (rows beyond are padding)
    qids: np.ndarray  # int32 [Qb] — caller's query index per row (-1 padding)
    qblk: np.ndarray  # int32 [Qb, TB] — block rows (pad: sentinel all-doc_pad row)
    qw: np.ndarray  # float32 [Qb, TB] — clause weight (0 for must_not/padding)
    qconst: np.ndarray  # bool [Qb, TB] — constant-score clause (contribution = w)
    qcnt: np.ndarray  # int32 [Qb, TB] — packed group counter
    qfid: np.ndarray  # int32 [Qb, TB] — SimTables cache row of the clause's field
    n_must: np.ndarray  # int32 [Qb]
    msm: np.ndarray  # int32 [Qb]
    coord: np.ndarray  # float32 [Qb, C+1]
    passes: int  # segment-sum doubling passes = ceil(log2(max clauses per query))
    simple: bool  # pure-should all-BM25 msm<=1 no-coord (match ≡ score>0)
    staging: StagingSet  # the set whose buffer the eight arrays above view


def _sparse_impl(blk_docs, blk_tf, blk_nb, caches, modes,
                 qblk, qw, qconst, qcnt, qfid, n_must, msm, coord,
                 *, k: int, doc_pad: int, passes: int, simple: bool,
                 use_coord: bool):
    """One sparse bucket on device tensors (the JAX package's `_sparse_impl`
    signature): the clause modes are looked up per slot, then the fused
    kernel (or, on the CPU, its plain version) runs."""
    return sparse_score(qblk, qw, qconst, qcnt, qfid, modes[qfid.long()],
                        n_must, msm, coord, blk_docs, blk_tf, blk_nb, caches,
                        k=k, doc_pad=doc_pad, passes=passes, simple=simple,
                        use_coord=use_coord)


def score_sparse_batch_async(packed: PackedSegment, sb: SparseBatch, k: int,
                             sim: SimTables | None = None):
    """Launch one sparse bucket: its staging set goes to the device with ONE
    copy (without synchronising) beside the segment's planes. Returns
    device tensors (scores, docs, totals) without synchronising. `sim` is
    the SimTables the planner resolved fids against (default: the
    segment's current one). The set is free again once this returns."""
    sim = sim if sim is not None else packed.sim
    TB = sb.qblk.shape[1]
    t = sb.staging.to_device(packed.device)
    return _sparse_impl(
        packed.blk_docs, packed.blk_tf, packed.blk_nb, sim.caches, sim.modes,
        t["qblk"], t["qw"], t["qconst"], t["qcnt"], t["qfid"], t["n_must"],
        t["msm"], t["coord"],
        k=min(k, TB * BLOCK), doc_pad=packed.doc_pad, passes=sb.passes,
        simple=sb.simple,
        use_coord=not sb.simple and not bool(np.all(sb.coord == 1.0)))


def plan_sparse_buckets(clause_lists: list, n_must: np.ndarray, msm: np.ndarray,
                        coord: np.ndarray, sentinel_row: int,
                        scratch: SparseScratchPool, *,
                        tb_max: int = 512, slot_budget: int = 32768,
                        simple: bool = False):
    """Bucket queries by block count and build SparseBatches.

    clause_lists: per query, list of (b0, b1, weight, group, is_const, fid)
    block ranges — `fid` is the clause field's SimTables cache row.
    Returns (batches, overflow_qids): overflow queries (TB > tb_max) need the
    dense fallback; queries with zero blocks appear in no batch (zero hits).

    `scratch` (the packed segment's SparseScratchPool) supplies each
    bucket's staging set; the caller gives the sets back once their
    launches have returned (launch_flat_sparse does)."""
    Q = len(clause_lists)
    tb_q = [sum(b1 - b0 for (b0, b1, _w, _g, _c, _fi) in cl)
            for cl in clause_lists]
    overflow = [qi for qi in range(Q) if tb_q[qi] > tb_max]
    buckets: dict[int, list[int]] = {}
    for qi in range(Q):
        if 0 < tb_q[qi] <= tb_max:
            buckets.setdefault(_pow2_bucket(tb_q[qi], 8), []).append(qi)

    batches = []
    for tb, qis in sorted(buckets.items()):
        max_q = max(1, slot_budget // tb)
        for start in range(0, len(qis), max_q):
            chunk = qis[start: start + max_q]
            Qb = _pow2_bucket(len(chunk), 8)
            c1 = coord.shape[1]
            st = scratch.take(Qb, tb, c1, sentinel_row)
            a = st.arrays
            qblk, qw, qconst, qcnt, qfid = (a["qblk"], a["qw"], a["qconst"],
                                            a["qcnt"], a["qfid"])
            bn_must, bmsm, bcoord = a["n_must"], a["msm"], a["coord"]
            qids = np.full(Qb, -1, np.int32)
            maxc = 1
            for row, qi in enumerate(chunk):
                qids[row] = qi
                bn_must[row] = n_must[qi]
                bmsm[row] = msm[qi]
                bcoord[row] = coord[qi]
                maxc = max(maxc, len(clause_lists[qi]))
                off = 0
                for (b0, b1, w, g, is_const, fid) in clause_lists[qi]:
                    nb = b1 - b0
                    if nb <= 0:
                        continue
                    qblk[row, off: off + nb] = np.arange(b0, b1, dtype=np.int32)
                    qw[row, off: off + nb] = 0.0 if g == GROUP_MUST_NOT else w
                    qconst[row, off: off + nb] = is_const
                    qcnt[row, off: off + nb] = (
                        1 if g == GROUP_SHOULD
                        else (1 << _MUST_SHIFT) if g == GROUP_MUST
                        else (1 << _NOT_SHIFT))
                    qfid[row, off: off + nb] = fid
                    off += nb
            batches.append(SparseBatch(
                n_queries=len(chunk), qids=qids, qblk=qblk, qw=qw,
                qconst=qconst, qcnt=qcnt, qfid=qfid, n_must=bn_must, msm=bmsm,
                coord=bcoord, passes=max(0, (maxc - 1).bit_length()),
                simple=simple, staging=st))
    return batches, overflow


def launch_flat_sparse(packed: PackedSegment, clause_lists: list,
                       n_must: np.ndarray, msm: np.ndarray, coord: np.ndarray,
                       k: int, *, simple: bool = False, tb_max: int = 512,
                       breaker=None, sim: SimTables | None = None):
    """Plan + launch every sparse bucket of a flat-query batch WITHOUT
    synchronising. Returns (launches, overflow_qids), launches =
    [(SparseBatch, device result triple)]. The buckets' staging sets go back
    to the segment's SparseScratchPool before this returns, whether the
    launches succeeded or raised: a returned launch has copied its set.

    The staging of the whole batch — every bucket's set — is reserved on
    `breaker` (the request breaker) in one sum around the launches: the
    coalesced launch is the allocation, not a request's share of it."""
    scratch = packed.sparse_scratch
    if scratch is None:
        scratch = packed.sparse_scratch = SparseScratchPool()
    batches, overflow = plan_sparse_buckets(
        clause_lists, n_must, msm, coord, packed.blk_docs.shape[0] - 1,
        scratch, tb_max=tb_max, simple=simple)
    est = sum(SparseScratchPool.staging_bytes(*sb.staging.key) for sb in batches)
    try:
        with reserve(breaker, est, "<sparse_staging>"):
            launches = [(sb, score_sparse_batch_async(packed, sb, k, sim=sim))
                        for sb in batches]
    finally:
        for sb in batches:
            scratch.give(sb.staging)
    return launches, overflow


def collect_flat_sparse(launches: list, pulled: list, Q: int, k: int,
                        doc_pad: int):
    """Scatter pulled bucket results (host triples, same order as `launches`)
    into [Q, k] host arrays."""
    scores = np.full((Q, k), -np.inf, np.float32)
    docs = np.full((Q, k), doc_pad, np.int32)
    totals = np.zeros(Q, np.int64)
    for (sb, _r), (s, d, t) in zip(launches, pulled):
        rows = sb.qids >= 0
        qid = sb.qids[rows]
        kk = s.shape[1]
        scores[qid, :kk] = s[rows]
        docs[qid, :kk] = d[rows]
        totals[qid] = t[rows]
    return scores, docs, totals


def score_flat_sparse(packed: PackedSegment, clause_lists: list,
                      n_must: np.ndarray, msm: np.ndarray, coord: np.ndarray,
                      k: int, *, simple: bool = False, tb_max: int = 512,
                      sim: SimTables | None = None):
    """Score a whole flat-query batch through the sparse path: plan, launch
    every bucket, ONE pull, collect into [Q, k] host arrays. Returns (scores,
    docs, totals, overflow_qids); zero-block and overflow rows are empty."""
    launches, overflow = launch_flat_sparse(
        packed, clause_lists, n_must, msm, coord, k, simple=simple,
        tb_max=tb_max, sim=sim)
    flat = pull([t for (_sb, r) in launches for t in r])
    pulled = [tuple(flat[3 * i: 3 * i + 3]) for i in range(len(launches))]
    scores, docs, totals = collect_flat_sparse(launches, pulled,
                                               len(clause_lists), k,
                                               packed.doc_pad)
    return scores, docs, totals, overflow


# ---------------------------------------------------------------------------
# compaction concat (B7): a merged segment's planes from resident sources
# ---------------------------------------------------------------------------

_TF_TORCH = {"u8": torch.uint8, "i16": torch.int16, "f32": torch.float32}
# output rows a step of the concat: bounds its temporaries (about 40 B a
# slot of a step) whatever the merged segment's size
_CONCAT_ROWS = 1 << 15


def _concat_impl(blk_term, blk_j0, cum, starts, bases, doc_pads,
                 src_docs, src_tf, src_nb, *, doc_pad_new: int, tf_layout: str):
    """The gather/select program that assembles a merged segment's quantized
    planes from its sources' resident planes (device to device: no host
    staging of the postings), the JAX package's `_concat_impl` as torch
    ops.

    Per output slot (block row nb, lane): the merged term is `blk_term[nb]`
    (blocks never span terms), the within-term posting `blk_j0[nb] + lane`;
    the per-term cumulative source counts `cum` pick the source that holds
    it, and the gather index is that source's block start plus the offset
    within the source. A source slot masked to its sentinel (a non-parent
    doc) maps to the new sentinel, any other doc shifts by the source's doc
    base; tf widens along the u8 → i16 → f32 ladder (exact for the integral
    tf the gate admits). Pad rows carry a huge `blk_j0`, so no select takes
    them and they keep the sentinel and zeros pack_segment writes. Gathers
    and `torch.where` only: no host sync."""
    NB = blk_term.shape[0]
    B = src_docs[0].shape[1]
    dev = blk_term.device
    out_docs = torch.full((NB, B), doc_pad_new, dtype=torch.int32, device=dev)
    out_tf = torch.zeros((NB, B), dtype=_TF_TORCH[tf_layout], device=dev)
    out_nb = torch.zeros((NB, B), dtype=torch.uint8, device=dev)
    sentinel = torch.full((), doc_pad_new, dtype=torch.int32, device=dev)
    lane = torch.arange(B, dtype=torch.int64, device=dev)
    flat = [(d.reshape(-1), t.reshape(-1), n.reshape(-1))
            for d, t, n in zip(src_docs, src_tf, src_nb)]
    for r0 in range(0, NB, _CONCAT_ROWS):
        rows = slice(r0, min(NB, r0 + _CONCAT_ROWS))
        term = blk_term[rows].long()
        j = blk_j0[rows].long()[:, None] + lane
        o_docs, o_tf, o_nb = out_docs[rows], out_tf[rows], out_nb[rows]
        for s, (sd, st, sn) in enumerate(flat):
            lo = cum[s][term].long()[:, None]
            sel = (j >= lo) & (j < cum[s + 1][term].long()[:, None])
            slot = (starts[s][term].long()[:, None] * B + (j - lo)) \
                .clamp_(0, sd.numel() - 1)
            d = sd[slot]
            d = torch.where(d >= doc_pads[s], sentinel, d + bases[s])
            o_docs.copy_(torch.where(sel, d, o_docs))
            o_tf.copy_(torch.where(sel, st[slot].to(o_tf.dtype), o_tf))
            o_nb.copy_(torch.where(sel, sn[slot], o_nb))
    return out_docs, out_tf, out_nb


def concat_pack_planes(blk_term, blk_j0, cum, starts, bases, doc_pads,
                       src_docs, src_tf, src_nb, *, doc_pad_new: int,
                       tf_layout: str):
    """Launch the concat program on the sources' device: int32 `blk_term`,
    `blk_j0` [NBpad], `cum` [W+1, T], `starts` [W, T], `bases` and
    `doc_pads` [W], and the W sources' [NB_s, 128] planes. Returns the
    merged segment's (blk_docs, blk_tf, blk_nb), resident, with no pull."""
    if not src_docs or len({t.device for t in (blk_term, *src_docs)}) != 1:
        raise ValueError("the concat needs at least one source, and every "
                         "input on one device")
    return _concat_impl(blk_term, blk_j0, cum, starts, bases, doc_pads,
                        list(src_docs), list(src_tf), list(src_nb),
                        doc_pad_new=int(doc_pad_new), tf_layout=tf_layout)
