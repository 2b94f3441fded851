"""Batched query scoring on the device — the port of the JAX package's
`ops/scoring.py` for the plain-plan path.

Two programs score a batch of flat bool-of-terms queries against one packed
segment:

- the SPARSE path (the hot path): queries are bucketed by how many postings
  blocks they touch (power-of-two TB buckets, chunked to a slot budget), and
  each bucket is one launch of the fused `sparse_score` kernel
  (ops/sparse_kernels.py) — work scales with postings touched, not with the
  corpus;
- the DENSE overflow path, for queries past `tb_max` blocks: gather every
  (query, block) triple, scatter-add contributions and packed match counters
  into [Q, doc_pad+1] accumulators, apply the bool semantics and the coord
  factor, take the top k. It is torch ops (the JAX package's XLA program
  `_score_batch_impl`, not a Pallas kernel); `index_add_` on the card adds in
  no fixed order, so it is held to ≤ 2 ulp of the reference.

Match-count packing: one int32 carries three counters — bits 0-9 matched
SHOULD clauses, 10-19 MUST, 20-29 MUST_NOT.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from ..common.breaker import reserve
from ..common.cudaenv import pull, upload
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


@dataclass
class ScoreResult:
    scores: np.ndarray  # [Q, k] float32
    docs: np.ndarray  # [Q, k] int32 (local doc ids; doc_pad → no hit)
    total_hits: np.ndarray  # [Q]
    max_score: np.ndarray  # [Q] float32


def _dense_accumulate(blk_docs, blk_freqs, norms_stack, caches, qidx, blk,
                      weight, fidx, group, tfmode, *, Q: int, doc_pad: int):
    """Gather the postings blocks, compute per-posting contributions (tf
    factor first, then the weight — Lucene's rounding order) and scatter-add
    them into the [Q, doc_pad] accumulator. Returns (scores, flat_idx, valid)."""
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
    scores.index_add_(0, flat_idx, contrib.reshape(-1))
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
                      doc_pad: int, simple: bool = False):
    """The dense program. simple=True: every clause is a SHOULD with msm<=1
    and no coord — match reduces to score>0 and the counters are skipped.
    Returns ([Q, k] scores, [Q, k] int32 docs, [Q] int32 totals)."""
    Q = n_queries
    scores, flat_idx, valid = _dense_accumulate(
        blk_docs, blk_freqs, norms_stack, caches, qidx, blk, weight, fidx,
        group, tfmode, Q=Q, doc_pad=doc_pad)
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
        doc_pad=packed.doc_pad, simple=_detect_simple(batch))


def finalize_score_result(scores: np.ndarray, docs: np.ndarray,
                          total: np.ndarray, doc_pad: int) -> ScoreResult:
    """Host-side [Q, k] post-processing: -inf slots → doc_pad sentinel, max_score."""
    finite = np.isfinite(scores)
    docs = np.where(finite, docs, doc_pad).astype(np.int32)
    max_score = np.where(total > 0, scores[:, 0], np.nan).astype(np.float32)
    return ScoreResult(scores=scores, docs=docs, total_hits=total,
                       max_score=max_score)


def build_term_batch(entries: list, n_queries: int, n_must: np.ndarray,
                     msm: np.ndarray, coord: np.ndarray, norm_fields: list[str],
                     caches: np.ndarray, nb_pad_row: int) -> TermBatch:
    """Assemble + bucket-pad the flat triple arrays. `entries` = list of
    (qidx, blk_row, weight, fidx, group, tfmode); padding rows point at
    `nb_pad_row`, a row of doc_pad sentinels that contributes nothing."""
    M = _pow2_bucket(max(len(entries), 1), 16)
    qidx = np.zeros(M, np.int32)
    blk = np.full(M, nb_pad_row, np.int32)
    weight = np.zeros(M, np.float32)
    fidx = np.zeros(M, np.int32)
    group = np.zeros(M, np.int32)
    tfmode = np.zeros(M, np.int32)
    if entries:
        # float64 holds every field exactly (weights are Python floats)
        cols = np.asarray(entries, dtype=np.float64).T
        n = len(entries)
        for arr, col in zip((qidx, blk, weight, fidx, group, tfmode), cols):
            arr[:n] = col
    return TermBatch(
        n_queries=n_queries, qidx=qidx, blk=blk, weight=weight, fidx=fidx,
        group=group, tfmode=tfmode, n_must=n_must.astype(np.int32),
        msm=msm.astype(np.int32), coord=coord.astype(np.float32),
        norm_fields=norm_fields, caches=caches)


# ---------------------------------------------------------------------------
# sparse candidate-centric path (the serving hot path)
# ---------------------------------------------------------------------------


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
    """Launch one sparse bucket: its arrays are uploaded (without
    synchronising) beside the segment's planes. Returns device tensors
    (scores, docs, totals) without synchronising. `sim` is the SimTables the
    planner resolved fids against (default: the segment's current one)."""
    sim = sim if sim is not None else packed.sim
    dev = packed.device
    TB = sb.qblk.shape[1]
    return _sparse_impl(
        packed.blk_docs, packed.blk_tf, packed.blk_nb, sim.caches, sim.modes,
        upload(sb.qblk, dev), upload(sb.qw, dev), upload(sb.qconst, dev),
        upload(sb.qcnt, dev), upload(sb.qfid, dev), upload(sb.n_must, dev),
        upload(sb.msm, dev), upload(sb.coord, dev),
        k=min(k, TB * BLOCK), doc_pad=packed.doc_pad, passes=sb.passes,
        simple=sb.simple,
        use_coord=not sb.simple and not bool(np.all(sb.coord == 1.0)))


def plan_sparse_buckets(clause_lists: list, n_must: np.ndarray, msm: np.ndarray,
                        coord: np.ndarray, sentinel_row: int, *,
                        tb_max: int = 512, slot_budget: int = 32768,
                        simple: bool = False):
    """Bucket queries by block count and build SparseBatches.

    clause_lists: per query, list of (b0, b1, weight, group, is_const, fid)
    block ranges — `fid` is the clause field's SimTables cache row.
    Returns (batches, overflow_qids): overflow queries (TB > tb_max) need the
    dense fallback; queries with zero blocks appear in no batch (zero hits)."""
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
            qblk = np.full((Qb, tb), sentinel_row, np.int32)
            qw = np.zeros((Qb, tb), np.float32)
            qconst = np.zeros((Qb, tb), bool)
            qcnt = np.zeros((Qb, tb), np.int32)
            qfid = np.zeros((Qb, tb), np.int32)
            qids = np.full(Qb, -1, np.int32)
            bn_must = np.zeros(Qb, np.int32)
            bmsm = np.zeros(Qb, np.int32)
            bcoord = np.ones((Qb, coord.shape[1]), np.float32)
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
                simple=simple))
    return batches, overflow


def staging_bytes(Qb: int, tb: int) -> int:
    """Bytes of one bucket's [Qb, TB] clause arrays: qblk i32 + qw f32 +
    qconst bool + qcnt i32 + qfid i32."""
    return Qb * tb * (4 + 4 + 1 + 4 + 4)


def launch_flat_sparse(packed: PackedSegment, clause_lists: list,
                       n_must: np.ndarray, msm: np.ndarray, coord: np.ndarray,
                       k: int, *, simple: bool = False, tb_max: int = 512,
                       breaker=None, sim: SimTables | None = None):
    """Plan + launch every sparse bucket of a flat-query batch WITHOUT
    synchronising. Returns (launches, overflow_qids), launches =
    [(SparseBatch, device result triple)].

    The staging of the whole batch — every bucket's padded [Qb, TB] arrays —
    is reserved on `breaker` (the request breaker) in one sum around the
    launches: the coalesced launch is the allocation, not a request's share
    of it."""
    batches, overflow = plan_sparse_buckets(
        clause_lists, n_must, msm, coord, packed.blk_docs.shape[0] - 1,
        tb_max=tb_max, simple=simple)
    est = sum(staging_bytes(*sb.qblk.shape) for sb in batches)
    with reserve(breaker, est, "<sparse_staging>"):
        launches = [(sb, score_sparse_batch_async(packed, sb, k, sim=sim))
                    for sb in batches]
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
