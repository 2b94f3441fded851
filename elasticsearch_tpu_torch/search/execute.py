"""Per-shard query planning + execution — the port of the JAX package's
`search/execute.py`: the device path for flat plans and the host scorer for
every other query.

A query lowers to a flat weighted-term plan (`lower_flat`); a whole batch of
plans is finalized against shard-level term statistics (`finalize_flat`,
`_assemble_batch`) and, per segment, dispatched to the device: the sparse
kernel for every query within `tb_max` blocks, the dense program for the
overflow (`_dispatch_flat_plain`). The merge half (`_merge_flat_plain`) pulls
the whole batch to the host behind ONE wait and merges the segments' top-k
(score desc, global doc asc — Lucene's order).

Serving contracts carried over from the JAX package:
- one host pull per batch: the dispatch half ends by enqueueing the batch's
  device→host copies behind one event (`cudaenv.pull_async`), and the merge
  half waits on that event alone (`PendingPull.wait`), so under the
  batcher's double buffering batch N's merge never waits for batch N+1's
  launches;
- no device→host synchronisation while dispatching — chip_smoke.py runs the
  dispatch half under `torch.cuda.set_sync_debug_mode("error")`.

A query that does not lower to a flat plan (phrases, multi-term expansion,
spans, filters, a numeric term, a bool with a filter or with must_not only, a
fuzzy match) runs on the host scorer (`HostScorer`): a recursive numpy
evaluation per segment into dense (scores float32[D], match bool[D]) with the
same similarity math and the JAX package's expression order, so its scores
are bitwise the JAX host scorer's. `search_shard_batch` sends the lowerable
queries of a batch fused to the device and the rest to `_host_search`, as
the JAX package does. `filtered` and `function_score` do not lower in the
port: their device families are a later slice, so a `filtered` body is
served on the host.
"""

from __future__ import annotations

import re
import time
from collections import Counter
from dataclasses import dataclass

import numpy as np

from ..common.cudaenv import default_device, pull_async
from ..common.errors import NotPortedError, QueryParsingError
from ..index.engine import Searcher
from ..index.segment import FrozenSegment
from ..ops.device_index import (
    TFN_BM25,
    TFN_TFIDF,
    ensure_blk_freqs,
    ensure_sim_tables,
    packed_for,
)
from ..ops.scoring import (
    MODE_BM25,
    MODE_CONST,
    MODE_TFIDF,
    build_term_batch,
    collect_flat_sparse,
    dense_chunk,
    finalize_score_result,
    launch_flat_sparse,
    score_term_batch_async,
)
from ..ops.sparse_kernels import GROUP_MUST, GROUP_MUST_NOT, GROUP_SHOULD
from .filters import Filter, IdsFilter, RangeFilter, TermFilter, segment_mask
from .queries import (
    BoolQuery,
    BoostingQuery,
    CommonTermsQuery,
    ConstantScoreQuery,
    DisMaxQuery,
    FieldMaskingSpanQuery,
    FilteredQuery,
    FuzzyLikeThisQuery,
    FuzzyQuery,
    IdsQuery,
    MatchAllQuery,
    MatchQuery,
    MoreLikeThisQuery,
    MultiMatchQuery,
    PhraseQuery,
    PrefixQuery,
    Query,
    QueryStringQuery,
    RangeQuery,
    RegexpQuery,
    SimpleQueryStringQuery,
    SpanFirstQuery,
    SpanMultiTermQuery,
    SpanNearQuery,
    SpanNotQuery,
    SpanOrQuery,
    SpanTermQuery,
    TermQuery,
    WildcardQuery,
)
from .similarity import BM25Similarity, SimilarityService, TFIDFSimilarity


class ShardContext:
    """Shard-level stats + mapping access shared by planner and scorers, and
    the device the shard's queries run on (the card unless `device="cpu"`)."""

    def __init__(self, searcher: Searcher, mapper_service,
                 similarity_service: SimilarityService | None = None,
                 device=None, breakers=None, batcher=None):
        self.searcher = searcher
        self.mapper_service = mapper_service
        self.similarity_service = similarity_service or SimilarityService(
            mapper_service=mapper_service)
        self.device = default_device(device)
        # a CircuitBreakerService, or None in unwired contexts: the sparse
        # path reserves its per-batch staging on breaker("request")
        self.breakers = breakers
        # a cross-request DeviceBatcher (search/batcher.py), or None: single
        # requests coalesce with concurrent ones when present
        # (service._execute_flat_single)
        self.batcher = batcher

    def breaker(self, name: str):
        """The named circuit breaker, or None when no service is wired."""
        return None if self.breakers is None else self.breakers.breaker(name)

    @property
    def max_doc(self) -> int:
        return self.searcher.max_doc

    def doc_freq(self, field: str, term: str) -> int:
        return self.searcher.doc_freq(field, term)

    def field_stats(self, field: str):
        return self.searcher.field_stats(field)

    def field_type(self, field: str):
        return self.mapper_service.field_type(field)

    def analyze(self, field: str, text: str) -> list[str]:
        return self.mapper_service.search_analyzer_for(field).terms(text)

    def analyze_tokens(self, field: str, text: str):
        return self.mapper_service.search_analyzer_for(field).analyze(text)

    def similarity_for(self, field: str):
        return self.similarity_service.for_field(field)

    @property
    def default_similarity(self):
        return self.similarity_service.default


@dataclass
class TopDocs:
    total: int
    hits: list  # [(score, global_doc)]
    max_score: float
    # the shard's time budget ran out between segments on the host scorer:
    # hits/total cover only the segments scored before expiry
    timed_out: bool = False


@dataclass
class Clause:
    field: str
    term: str
    boost: float
    group: int  # GROUP_*


@dataclass
class FlatPlan:
    """A query lowered to one flat weighted-term batch (device-executable)."""

    clauses: list  # list[Clause]
    msm: int
    n_must: int
    coord_enabled: bool
    boost: float


# ---------------------------------------------------------------------------
# minimum_should_match (Lucene Queries.calculateMinShouldMatch)
# ---------------------------------------------------------------------------


def calculate_msm(spec, clause_count: int) -> int:
    if spec is None:
        return 0
    if isinstance(spec, int):
        result = spec
    else:
        s = str(spec).strip()
        if "<" in s:
            # "3<90%" — conditional combos separated by spaces
            result = clause_count
            for combo in s.split():
                cond, _, value = combo.partition("<")
                if clause_count > int(cond):
                    result = _msm_value(value, clause_count)
                    break
        else:
            result = _msm_value(s, clause_count)
    # no upper clamp: msm > clause_count matches nothing (Lucene semantics)
    return max(0, result)


def _msm_value(s: str, clause_count: int) -> int:
    s = s.strip()
    if s.endswith("%"):
        pct = float(s[:-1])
        if pct < 0:
            return clause_count + int(clause_count * pct / 100.0)
        return int(clause_count * pct / 100.0)
    v = int(s)
    return clause_count + v if v < 0 else v


# ---------------------------------------------------------------------------
# flat lowering
# ---------------------------------------------------------------------------


def lower_flat(query: Query, ctx: ShardContext) -> FlatPlan | None:
    """Lower a query to a flat clause list, or None when it needs the host
    scorer: a term on a numeric field (a doc-value column), a fuzzy match, a
    bool with a filter, with must_not only or with sub-clauses that are not
    single terms, every other query type, and any clause on a field whose
    similarity the kernel does not fuse (BM25 and TF-IDF only)."""
    plan = _lower_flat_inner(query, ctx)
    if plan is not None:
        for field in {c.field for c in plan.clauses}:
            if not isinstance(ctx.similarity_for(field),
                              (BM25Similarity, TFIDFSimilarity)):
                return None
    return plan


def _lower_flat_inner(query: Query, ctx: ShardContext) -> FlatPlan | None:
    if isinstance(query, TermQuery):
        ft = ctx.field_type(query.field)
        if ft is not None and ft.is_numeric:
            return None  # numeric term → doc-value column, host path
        return FlatPlan([Clause(query.field, str(query.value), query.boost,
                                GROUP_SHOULD)],
                        msm=1, n_must=0, coord_enabled=False, boost=1.0)
    if isinstance(query, MatchQuery):
        if query.fuzziness is not None:
            return None
        terms = ctx.analyze(query.field, query.text)
        if not terms:
            return FlatPlan([], msm=0, n_must=0, coord_enabled=False,
                            boost=query.boost)
        group = GROUP_MUST if query.operator == "and" else GROUP_SHOULD
        clauses = [Clause(query.field, t, 1.0, group) for t in terms]
        n_must = len(clauses) if group == GROUP_MUST else 0
        msm = (calculate_msm(query.minimum_should_match, len(clauses))
               if group == GROUP_SHOULD else 0)
        if group == GROUP_SHOULD and msm == 0:
            msm = 1
        return FlatPlan(clauses, msm=msm, n_must=n_must,
                        coord_enabled=len(clauses) > 1, boost=query.boost)
    if isinstance(query, BoolQuery):
        if query.filter:
            return None
        clauses: list[Clause] = []
        n_scoring = 0
        n_should = 0
        for sub, group in (
            [(q, GROUP_MUST) for q in query.must]
            + [(q, GROUP_SHOULD) for q in query.should]
            + [(q, GROUP_MUST_NOT) for q in query.must_not]
        ):
            term = _single_term(sub, ctx)
            if term is None:
                return None
            field, t, boost = term
            clauses.append(Clause(field, t, boost, group))
            if group != GROUP_MUST_NOT:
                n_scoring += 1
            if group == GROUP_SHOULD:
                n_should += 1
        if n_scoring == 0:
            # must_not-only bool matches all non-excluded docs: host scorer
            return None
        n_must = sum(1 for c in clauses if c.group == GROUP_MUST)
        msm = calculate_msm(query.minimum_should_match, n_should)
        if msm == 0 and n_should > 0 and n_must == 0:
            msm = 1
        return FlatPlan(clauses, msm=msm, n_must=n_must,
                        coord_enabled=not query.disable_coord and n_scoring > 1,
                        boost=query.boost)
    return None


def _single_term(query: Query, ctx: ShardContext):
    """A sub-query usable as one flat clause: a term query or single-token match."""
    if isinstance(query, TermQuery):
        ft = ctx.field_type(query.field)
        if ft is not None and ft.is_numeric:
            return None
        return (query.field, str(query.value), query.boost)
    if isinstance(query, MatchQuery) and query.fuzziness is None:
        terms = ctx.analyze(query.field, query.text)
        if len(terms) == 1:
            return (query.field, terms[0], query.boost)
    return None


def finalize_flat(plan: FlatPlan, ctx: ShardContext):
    """Resolve clause weights against shard stats; returns per-clause tuples
    (field, term, weight, fidx, group, mode, df), the plan's fields, their
    norm caches and its coord table — exactly the kernels' inputs."""
    max_doc = ctx.max_doc
    fields: list[str] = []
    caches: list[np.ndarray] = []
    field_idx: dict[str, int] = {}
    resolved = []
    ssw = 0.0
    for c in plan.clauses:
        sim = ctx.similarity_for(c.field)
        df = ctx.doc_freq(c.field, c.term)
        if c.field not in field_idx:
            field_idx[c.field] = len(fields)
            fields.append(c.field)
            caches.append(sim.norm_cache(ctx.field_stats(c.field), max_doc))
        fi = field_idx[c.field]
        if df <= 0:
            resolved.append((c.field, c.term, 0.0, fi, c.group, MODE_BM25, 0))
            continue
        if isinstance(sim, BM25Similarity):
            idf = sim.idf(df, max_doc)
            w = np.float32(idf * c.boost * plan.boost * (sim.k1 + 1.0))
            mode = MODE_BM25
        else:
            idf = TFIDFSimilarity.idf(df, max_doc)
            w = np.float32(idf * idf * c.boost * plan.boost)  # queryNorm folded below
            mode = MODE_TFIDF
        if c.group != GROUP_MUST_NOT:
            ssw += float((idf * c.boost * plan.boost) ** 2)
        resolved.append((c.field, c.term, float(w), fi, c.group, mode, df))
    qn = 1.0
    if isinstance(ctx.default_similarity, TFIDFSimilarity) and ssw > 0:
        qn = float(TFIDFSimilarity.query_norm(ssw))
    out = [(f, t, w * qn if mode == MODE_TFIDF else w, fi, g, mode, df)
           for (f, t, w, fi, g, mode, df) in resolved]
    n_scoring = sum(1 for c in plan.clauses if c.group != GROUP_MUST_NOT)
    coord = np.ones(max(n_scoring, 1) + 1, dtype=np.float32)
    if (plan.coord_enabled and isinstance(ctx.default_similarity, TFIDFSimilarity)
            and n_scoring > 0):
        coord = np.arange(n_scoring + 1, dtype=np.float32) / np.float32(n_scoring)
    return out, fields, np.stack(caches) if caches else None, coord


def _assemble_batch(plans: list[FlatPlan], finals: list):
    """Field/cache tables + per-query bool-semantics arrays for a batch of
    finalized plans (the coord padding rule is kernel ABI)."""
    Q = len(plans)
    all_fields: list[str] = []
    field_idx: dict[str, int] = {}
    cache_rows: list[np.ndarray] = []
    for (_resolved, fields, caches, _coord) in finals:
        for i, f in enumerate(fields):
            if f not in field_idx:
                field_idx[f] = len(all_fields)
                all_fields.append(f)
                cache_rows.append(caches[i])
    caches_stack = (np.stack(cache_rows) if cache_rows
                    else np.ones((1, 256), np.float32))
    max_clauses = max(1, max(
        (sum(1 for c in p.clauses if c.group != GROUP_MUST_NOT) for p in plans),
        default=1))
    coord_tbl = np.ones((Q, max_clauses + 1), dtype=np.float32)
    n_must = np.zeros(Q, np.int32)
    msm = np.zeros(Q, np.int32)
    for qi, (plan, (_r, _f, _c, coord)) in enumerate(zip(plans, finals)):
        coord_tbl[qi, : len(coord)] = coord
        if len(coord) <= max_clauses:
            coord_tbl[qi, len(coord):] = coord[-1]
        n_must[qi] = plan.n_must
        msm[qi] = plan.msm
    return all_fields, field_idx, cache_rows, caches_stack, coord_tbl, n_must, msm


# ---------------------------------------------------------------------------
# batched device execution: dispatch half, merge half
# ---------------------------------------------------------------------------


class _PendingFlat:
    """Device work in flight for one plain-plan batch: every segment's sparse
    bucket launches and dense-overflow launches, and the batch's device→host
    copies enqueued behind them (`pull`, a cudaenv.PendingPull). merge()
    waits for those copies — the batch's one wait — and merges the top-k on
    the host, stamping the wait's host clocks in pull_t0 / pull_t1."""

    __slots__ = ("Q", "k", "seg_work", "pull", "pull_t0", "pull_t1")

    def __init__(self, Q: int, k: int, seg_work: list, pull):
        self.Q = Q
        self.k = k
        # per segment: (seg, base, doc_pad, launches, dense) where dense is a
        # list of (query indices, device result triple), one per chunk
        self.seg_work = seg_work
        self.pull = pull
        self.pull_t0: float | None = None
        self.pull_t1: float | None = None

    def merge(self) -> list[TopDocs]:
        return _merge_flat_plain(self)


def _result_tensors(seg_work: list) -> list:
    """Every result tensor of a batch, in the order the merge reads them."""
    refs = []
    for (_seg, _base, _doc_pad, launches, dense) in seg_work:
        for (_sb, r) in launches:
            refs.extend(r)
        for (_sub, r) in dense or ():
            refs.extend(r)
    return refs


def _dispatch_flat_plain(plans: list[FlatPlan], ctx: ShardContext,
                         k: int) -> _PendingFlat:
    """Plan + launch a batch of plain flat plans across every segment, then
    enqueue the batch's device→host copies behind one event — all without
    any device→host synchronisation."""
    Q = len(plans)
    finals = [finalize_flat(p, ctx) for p in plans]
    (all_fields, field_idx, cache_rows, caches_stack,
     coord_tbl, n_must, msm) = _assemble_batch(plans, finals)
    sim_tables = {
        f: (TFN_BM25 if isinstance(ctx.similarity_for(f), BM25Similarity)
            else TFN_TFIDF, cache_rows[field_idx[f]])
        for f in all_fields
    }
    # zero-df clauses (w=0, no postings anywhere) can't affect results — they
    # must not demote the batch off the simple fast path
    simple = bool(
        np.all(n_must == 0) and np.all(msm <= 1) and np.all(coord_tbl == 1.0)
        and all(g == GROUP_SHOULD and mode == MODE_BM25 and w > 0
                for (resolved, _f, _c, _coord) in finals
                for (_f2, _t, w, _fi, g, mode, df) in resolved if df > 0))

    seg_work = []
    for seg, base in zip(ctx.searcher.segments, ctx.searcher.bases):
        packed = packed_for(seg, ctx.device, breaker=ctx.breaker("fielddata"))
        # a 1 KB/field LUT swap when stats moved, never a postings re-bake
        sim = ensure_sim_tables(packed, sim_tables)
        clause_lists = []
        for (resolved, _f, _c, _coord) in finals:
            cl = []
            for (f, t, w, _fi, g, mode, df) in resolved:
                tid = seg.term_id(f, t)
                if tid is None:
                    continue
                b0, b1 = packed.blocks_for_term(tid)
                cl.append((b0, b1, w, g, mode == MODE_CONST, sim.fid[f]))
            clause_lists.append(cl)
        launches, overflow = launch_flat_sparse(
            packed, clause_lists, n_must, msm, coord_tbl, k, simple=simple,
            breaker=ctx.breaker("request"), sim=sim)
        dense = None
        if overflow:
            dense = _launch_dense_fallback(
                overflow, finals, field_idx, all_fields, caches_stack,
                n_must, msm, coord_tbl, packed, seg, k,
                breaker=ctx.breaker("fielddata"))
        seg_work.append((seg, base, packed.doc_pad, launches, dense))
    return _PendingFlat(Q=Q, k=k, seg_work=seg_work,
                        pull=pull_async(_result_tensors(seg_work)))


def _merge_flat_plain(pending: _PendingFlat) -> list[TopDocs]:
    """Merge half: ONE wait — on the event recorded after this batch's own
    copies — drains every launch of the batch (sparse buckets + dense
    overflow across all segments), then the pure-host cross-segment top-k
    merge."""
    Q, k = pending.Q, pending.k
    pending.pull_t0 = time.monotonic()
    flat = iter(pending.pull.wait())
    pending.pull_t1 = time.monotonic()
    totals = np.zeros(Q, dtype=np.int64)
    seg_hits = []  # (scores [Q,k] f32, global_docs [Q,k] int64) per segment
    for (seg, base, doc_pad, launches, dense) in pending.seg_work:
        sparse_pulled = [(next(flat), next(flat), next(flat)) for _ in launches]
        scores, docs, tq = collect_flat_sparse(launches, sparse_pulled, Q, k,
                                               doc_pad)
        for (sub, _r) in dense or ():
            res = finalize_score_result(next(flat), next(flat), next(flat),
                                        doc_pad)
            kk = res.scores.shape[1]
            scores[sub, :kk] = res.scores
            docs[sub, :kk] = res.docs
            scores[sub, kk:] = -np.inf
            docs[sub, kk:] = doc_pad
            tq[sub] = res.total_hits
        totals += tq
        valid = (docs < min(doc_pad, seg.doc_count)) & np.isfinite(scores)
        gdocs = np.where(valid, docs.astype(np.int64) + base, np.int64(2**62))
        seg_hits.append((np.where(valid, scores, -np.inf), gdocs))
    return _merge_seg_hits(seg_hits, totals, Q, k)


def _merge_seg_hits(seg_hits, totals, Q: int, k: int) -> list[TopDocs]:
    """Cross-segment top-k merge: score desc, global doc asc (Lucene order)."""
    if not seg_hits:
        return [TopDocs(total=0, hits=[], max_score=float("nan"))
                for _ in range(Q)]
    all_scores = np.concatenate([s for (s, _d) in seg_hits], axis=1)
    all_docs = np.concatenate([d for (_s, d) in seg_hits], axis=1)
    out = []
    totals_h = totals.tolist()
    for qi in range(Q):
        order = np.lexsort((all_docs[qi], -all_scores[qi]))[:k]
        order = order[np.isfinite(all_scores[qi, order])]
        hits = list(zip(all_scores[qi, order].tolist(),
                        all_docs[qi, order].tolist()))
        out.append(TopDocs(total=totals_h[qi], hits=hits,
                           max_score=hits[0][0] if hits else float("nan")))
    return out


def _dense_entries(finals, seg, packed, field_idx) -> list:
    """(qidx, block_row, weight, fidx, group, mode) triples for the dense
    program, qidx = position in `finals`."""
    entries = []
    for qi, (resolved, _f, _c, _coord) in enumerate(finals):
        for (f, t, w, _fi, g, mode, df) in resolved:
            tid = seg.term_id(f, t)
            if tid is None:
                continue
            b0, b1 = packed.blocks_for_term(tid)
            for b in range(b0, b1):
                entries.append((qi, b, w, field_idx[f], g, mode))
    return entries


def _launch_dense_fallback(overflow, finals, field_idx, all_fields,
                           caches_stack, n_must, msm, coord_tbl, packed, seg,
                           k, breaker=None) -> list:
    """Launch the overflow queries (block count past tb_max) on the dense
    program without synchronising, in chunks that keep its [Q, doc_pad+1]
    temporaries within budget. Returns [(query indices, device result
    triple)] for the merge half. The lazy f32 plane's first upload is
    reserved on `breaker` (fielddata)."""
    ensure_blk_freqs(packed, breaker)
    for f in all_fields:
        if f not in packed.norm_bytes:
            # a queried field this segment never indexed: all-zero norm row
            packed.norm_bytes[f] = packed.live_parent.new_zeros(
                packed.doc_pad, dtype=packed.blk_nb.dtype)
    out = []
    step = dense_chunk(packed.doc_pad)
    for start in range(0, len(overflow), step):
        chunk = overflow[start: start + step]
        entries = _dense_entries([finals[qi] for qi in chunk], seg, packed,
                                 field_idx)
        if not entries:
            continue
        sub = np.asarray(chunk, dtype=np.int64)
        batch = build_term_batch(entries, len(chunk), n_must[sub], msm[sub],
                                 coord_tbl[sub], list(all_fields), caches_stack,
                                 nb_pad_row=packed.blk_docs.shape[0] - 1)
        out.append((sub, score_term_batch_async(packed, batch, k)))
    return out


def dispatch_flat_batch(plans: list[FlatPlan], ctx: ShardContext,
                        k: int) -> _PendingFlat:
    """Dispatch half of execute_flat_batch for the cross-request batcher:
    launches without synchronising and returns the pending handle whose
    merge() yields the per-plan TopDocs. Every plan the port lowers is a
    plain plan (the function_score and filtered families are later
    slices)."""
    return _dispatch_flat_plain(plans, ctx, k)


def execute_flat_batch(plans: list[FlatPlan], ctx: ShardContext,
                       k: int) -> list[TopDocs]:
    """Run a batch of flat plans: dispatch every segment's launches, then
    merge the per-segment top-k on the host."""
    return dispatch_flat_batch(plans, ctx, k).merge()


# ---------------------------------------------------------------------------
# host scorer (general path)
# ---------------------------------------------------------------------------


def _weight_prepass(query: Query, ctx: ShardContext) -> float:
    """Sum of squared leaf weights (Lucene getValueForNormalization pre-pass)."""

    def walk(q: Query, boost: float) -> float:
        b = boost * getattr(q, "boost", 1.0)
        if isinstance(q, TermQuery):
            ft = ctx.field_type(q.field)
            if ft is not None and ft.is_numeric:
                return 0.0
            df = ctx.doc_freq(q.field, str(q.value))
            if df <= 0:
                return 0.0
            sim = ctx.similarity_for(q.field)
            idf = sim.idf(df, ctx.max_doc)
            return float((idf * b) ** 2)
        if isinstance(q, MatchQuery):
            total = 0.0
            for t in ctx.analyze(q.field, q.text):
                df = ctx.doc_freq(q.field, t)
                if df > 0:
                    sim = ctx.similarity_for(q.field)
                    total += float((sim.idf(df, ctx.max_doc) * b) ** 2)
            return total
        if isinstance(q, PhraseQuery):
            terms = [t.term for t in ctx.analyze_tokens(q.field, q.text)]
            sim = ctx.similarity_for(q.field)
            idf_sum = sum(
                float(sim.idf(max(ctx.doc_freq(q.field, t), 0), ctx.max_doc))
                for t in terms if ctx.doc_freq(q.field, t) > 0
            )
            return float((idf_sum * b) ** 2)
        if isinstance(q, BoolQuery):
            return sum(walk(s, b) for s in q.must + q.should)
        if isinstance(q, DisMaxQuery):
            return sum(walk(s, b) for s in q.queries)
        if isinstance(q, FilteredQuery):
            return walk(q.query, b)
        return float(b * b)

    return walk(query, 1.0)


def query_norm_for(query: Query, ctx: ShardContext) -> float:
    if not isinstance(ctx.default_similarity, TFIDFSimilarity):
        return 1.0
    ssw = _weight_prepass(query, ctx)
    return float(TFIDFSimilarity.query_norm(ssw)) if ssw > 0 else 1.0


class HostScorer:
    """Recursive dense evaluation of one query against one segment: (scores
    float32[D], match bool[D]). Live and parent masking happen in the
    caller."""

    def __init__(self, ctx: ShardContext, seg: FrozenSegment,
                 query_norm: float = 1.0):
        self.ctx = ctx
        self.seg = seg
        self.qn = np.float32(query_norm)
        self.D = seg.doc_count

    # -- leaf helpers --------------------------------------------------------
    def _term_scores(self, field: str, term: str,
                     boost: float) -> tuple[np.ndarray, np.ndarray]:
        seg, ctx = self.seg, self.ctx
        scores = np.zeros(self.D, dtype=np.float32)
        match = np.zeros(self.D, dtype=bool)
        df = ctx.doc_freq(field, term)
        docs, freqs = seg.postings(field, term)
        if df <= 0 or len(docs) == 0:
            return scores, match
        sim = ctx.similarity_for(field)
        norms = seg.norms.get(field)
        nb = norms[docs] if norms is not None else np.zeros(len(docs), np.uint8)
        cache = sim.norm_cache(ctx.field_stats(field), ctx.max_doc)
        if isinstance(sim, BM25Similarity):
            w = np.float32(sim.idf(df, ctx.max_doc) * boost * (sim.k1 + 1.0))
            # tf factor first, then weight — bit-parity with the kernels'
            # in-scan tfn
            vals = w * (freqs / (freqs + cache[nb]))
        elif isinstance(sim, TFIDFSimilarity):
            idf = TFIDFSimilarity.idf(df, ctx.max_doc)
            w = np.float32(idf * idf * boost) * self.qn
            vals = w * (np.sqrt(freqs, dtype=np.float32) * cache[nb])
        else:
            raise NotPortedError(
                f"similarity [{sim.name}] of [{field}] is not ported yet: "
                "DFR, IB and LM come with a later slice of the port")
        scores[docs] = vals.astype(np.float32)
        match[docs] = True
        return scores, match

    def _const(self, mask: np.ndarray, boost: float) -> tuple[np.ndarray, np.ndarray]:
        scores = np.where(mask, np.float32(boost * self.qn),
                          np.float32(0.0)).astype(np.float32)
        return scores, mask.copy()

    def _mask(self, f: Filter) -> np.ndarray:
        return segment_mask(self.seg, f, self.ctx)

    # -- main dispatch -------------------------------------------------------
    def eval(self, q: Query, boost: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
        b = boost * getattr(q, "boost", 1.0)
        seg, ctx = self.seg, self.ctx

        if isinstance(q, MatchAllQuery):
            return self._const(np.ones(self.D, dtype=bool), b)

        if isinstance(q, TermQuery):
            ft = ctx.field_type(q.field)
            if ft is not None and ft.is_numeric:
                return self._const(self._mask(TermFilter(q.field, q.value)), b)
            return self._term_scores(q.field, str(q.value), b)

        if isinstance(q, MatchQuery):
            if q.fuzziness is not None:
                terms = ctx.analyze(q.field, q.text)
                subs = [FuzzyQuery(q.field, t, q.fuzziness, 0, q.max_expansions)
                        for t in terms]
                return self.eval(BoolQuery(should=subs, minimum_should_match=1), b)
            terms = ctx.analyze(q.field, q.text)
            if not terms:
                return np.zeros(self.D, np.float32), np.zeros(self.D, bool)
            sub = (BoolQuery(must=[TermQuery(q.field, t) for t in terms])
                   if q.operator == "and"
                   else BoolQuery(should=[TermQuery(q.field, t) for t in terms],
                                  minimum_should_match=q.minimum_should_match or 1))
            return self.eval(sub, b)

        if isinstance(q, MultiMatchQuery):
            subs = []
            for fspec in q.fields:
                if "^" in fspec:
                    fname, fboost = fspec.split("^")
                    fboost = float(fboost)
                else:
                    fname, fboost = fspec, 1.0
                subs.append(MatchQuery(fname, q.text, operator=q.operator,
                                       minimum_should_match=q.minimum_should_match,
                                       boost=fboost))
            if q.type in ("best_fields", "phrase", "phrase_prefix"):
                return self.eval(DisMaxQuery(queries=subs, tie_breaker=q.tie_breaker), b)
            return self.eval(BoolQuery(should=subs, minimum_should_match=1,
                                       disable_coord=True), b)

        if isinstance(q, BoolQuery):
            return self._eval_bool(q, b)

        if isinstance(q, FilteredQuery):
            scores, match = self.eval(q.query, b)
            fmask = self._mask(q.filter)
            return np.where(fmask, scores, 0).astype(np.float32), match & fmask

        if isinstance(q, ConstantScoreQuery):
            if q.filter is not None:
                return self._const(self._mask(q.filter), b)
            _, match = self.eval(q.query, 1.0)
            return self._const(match, b)

        if isinstance(q, DisMaxQuery):
            best = np.zeros(self.D, np.float32)
            total = np.zeros(self.D, np.float32)
            match = np.zeros(self.D, bool)
            for sub in q.queries:
                s, m = self.eval(sub, b)
                s = np.where(m, s, 0).astype(np.float32)
                best = np.maximum(best, s)
                total += s
                match |= m
            tie = np.float32(q.tie_breaker)
            scores = best + tie * (total - best)
            return np.where(match, scores, 0).astype(np.float32), match

        if isinstance(q, RangeQuery):
            return self._const(self._mask(RangeFilter(q.field, q.gte, q.gt, q.lte, q.lt)), b)

        if isinstance(q, (PrefixQuery, WildcardQuery, RegexpQuery)):
            return self._const(self._multi_term_mask(q), b)

        if isinstance(q, FuzzyQuery):
            mask = np.zeros(self.D, bool)
            for t in self._fuzzy_terms(q):
                docs, _ = seg.postings(q.field, t)
                mask[docs] = True
            return self._const(mask, b)

        if isinstance(q, IdsQuery):
            return self._const(self._mask(IdsFilter(q.ids, q.types)), b)

        if isinstance(q, PhraseQuery):
            return self._eval_phrase(q, b)

        if isinstance(q, QueryStringQuery):
            return self.eval(parse_query_string(q, self.ctx), b)

        if isinstance(q, CommonTermsQuery):
            return self.eval(self._rewrite_common(q), b)

        if isinstance(q, BoostingQuery):
            scores, match = self.eval(q.positive, b)
            _, neg = self.eval(q.negative, 1.0)
            scores = np.where(neg, scores * np.float32(q.negative_boost), scores)
            return scores.astype(np.float32), match

        if isinstance(q, MoreLikeThisQuery):
            return self.eval(self._rewrite_mlt(q), b)

        if isinstance(q, SpanTermQuery):
            return self._term_scores(q.field, q.value, b)

        if isinstance(q, (SpanNearQuery, SpanOrQuery, SpanFirstQuery, SpanNotQuery,
                          SpanMultiTermQuery, FieldMaskingSpanQuery)):
            return self._eval_spans(q, b)

        if isinstance(q, SimpleQueryStringQuery):
            return self.eval(parse_simple_query_string(q), b)

        if isinstance(q, FuzzyLikeThisQuery):
            return self.eval(self._rewrite_flt(q), b)

        raise QueryParsingError(f"unsupported query type {type(q).__name__}")

    # -- bool ---------------------------------------------------------------
    def _eval_bool(self, q: BoolQuery, boost: float):
        D = self.D
        scores = np.zeros(D, np.float32)
        matched_count = np.zeros(D, np.int32)
        must_ok = np.ones(D, bool)
        excluded = np.zeros(D, bool)
        should_count = np.zeros(D, np.int32)
        n_scoring = 0
        for sub in q.must:
            s, m = self.eval(sub, boost)
            scores += np.where(m, s, 0).astype(np.float32)
            must_ok &= m
            matched_count += m
            n_scoring += 1
        for sub in q.should:
            s, m = self.eval(sub, boost)
            scores += np.where(m, s, 0).astype(np.float32)
            should_count += m
            matched_count += m
            n_scoring += 1
        for sub in q.must_not:
            _, m = self.eval(sub, 1.0)
            excluded |= m
        fmask = np.ones(D, bool)
        for f in q.filter:
            fmask &= self._mask(f)
        msm = calculate_msm(q.minimum_should_match, len(q.should))
        if msm == 0 and q.should and not q.must:
            msm = 1
        match = must_ok & ~excluded & fmask & (should_count >= msm)
        if not q.must and not q.should:
            match = fmask & ~excluded  # filter/must_not-only bool matches the rest
            scores = np.where(match, np.float32(boost * q.boost * self.qn),
                              0).astype(np.float32)
            return scores, match
        match &= matched_count > 0
        if (not q.disable_coord and n_scoring > 1
                and isinstance(self.ctx.default_similarity, TFIDFSimilarity)):
            coord = matched_count.astype(np.float32) / np.float32(n_scoring)
            scores = scores * coord
        return np.where(match, scores, 0).astype(np.float32), match

    # -- spans ---------------------------------------------------------------
    # The span family enumerates (start, end) position windows per doc,
    # composed recursively. Scoring follows the phrase convention: freq =
    # the number of matching spans.

    def _span_tree(self, q):
        """(field, {local_doc: sorted [(start, end)]}, contributing terms)."""
        seg = self.seg
        if isinstance(q, SpanTermQuery):
            docs, _ = seg.postings(q.field, q.value)
            pos_lists = seg.term_positions(q.field, q.value)
            spans = {int(d): [(int(p), int(p) + 1) for p in np.sort(pl)]
                     for d, pl in zip(docs, pos_lists) if len(pl)}
            return q.field, spans, {(q.field, q.value)}
        if isinstance(q, SpanMultiTermQuery):
            inner = q.match
            if isinstance(inner, (PrefixQuery, WildcardQuery, RegexpQuery)):
                pred = _term_predicate(inner)
                terms = [t for t in seg.terms_for_field(inner.field) if pred(t)]
                field = inner.field
            elif isinstance(inner, FuzzyQuery):
                terms = self._fuzzy_terms(inner)
                field = inner.field
            else:
                raise QueryParsingError(
                    f"span_multi does not support [{type(inner).__name__}]")
            spans: dict = {}
            termset = set()
            for t in terms:
                _f, s2, t2 = self._span_tree(SpanTermQuery(field, t))
                termset |= t2
                for d, sp in s2.items():
                    spans.setdefault(d, []).extend(sp)
            return field, {d: sorted(set(sp)) for d, sp in spans.items()}, termset
        if isinstance(q, FieldMaskingSpanQuery):
            _f, spans, terms = self._span_tree(q.query)
            return q.field, spans, terms
        if isinstance(q, SpanOrQuery):
            field, spans, termset = None, {}, set()
            for c in q.clauses:
                f2, s2, t2 = self._span_tree(c)
                field = field or f2
                if f2 != field:
                    raise QueryParsingError("span_or clauses must share a field")
                termset |= t2
                for d, sp in s2.items():
                    spans.setdefault(d, []).extend(sp)
            return field, {d: sorted(set(sp)) for d, sp in spans.items()}, termset
        if isinstance(q, SpanFirstQuery):
            field, spans, terms = self._span_tree(q.match)
            out = {d: [s for s in sp if s[1] <= q.end] for d, sp in spans.items()}
            return field, {d: sp for d, sp in out.items() if sp}, terms
        if isinstance(q, SpanNotQuery):
            field, inc, terms = self._span_tree(q.include)
            f2, exc, _t2 = self._span_tree(q.exclude)
            if f2 != field:
                raise QueryParsingError("span_not include/exclude must share a field")
            out = {}
            for d, sp in inc.items():
                ex = exc.get(d)
                keep = sp if not ex else [
                    s for s in sp
                    if not any(e[0] < s[1] and s[0] < e[1] for e in ex)]
                if keep:
                    out[d] = keep
            # only the include's terms weigh the score (Lucene SpanNotQuery)
            return field, out, terms
        if isinstance(q, SpanNearQuery):
            field, children, termset = None, [], set()
            for c in q.clauses:
                f2, s2, t2 = self._span_tree(c)
                field = field or f2
                if f2 != field:
                    raise QueryParsingError("span_near clauses must share a field")
                children.append(s2)
                termset |= t2
            if not children:
                return field, {}, termset
            docs = set(children[0])
            for s2 in children[1:]:
                docs &= set(s2)
            spans = {}
            for d in docs:
                found = _near_spans([s2[d] for s2 in children], q.slop, q.in_order)
                if found:
                    spans[d] = found
            return field, spans, termset
        raise QueryParsingError(f"not a span query: {type(q).__name__}")

    def _eval_spans(self, q, boost: float):
        seg, ctx = self.seg, self.ctx
        scores = np.zeros(self.D, np.float32)
        match = np.zeros(self.D, bool)
        field, spans, termset = self._span_tree(q)
        if not spans or field is None:
            return scores, match
        sim = ctx.similarity_for(field)
        cache = sim.norm_cache(ctx.field_stats(field), ctx.max_doc)
        norms = seg.norms.get(field)
        idf_sum = np.float32(sum(
            float(sim.idf(ctx.doc_freq(f, t), ctx.max_doc))
            for (f, t) in sorted(termset) if ctx.doc_freq(f, t) > 0))
        for d, sp in spans.items():
            freq = len(sp)
            nb = norms[d] if norms is not None else 0
            if isinstance(sim, BM25Similarity):
                w = np.float32(idf_sum * boost * (sim.k1 + 1.0))
                scores[d] = w * (np.float32(freq) / (np.float32(freq) + cache[nb]))
            else:
                w = np.float32(idf_sum * idf_sum * boost) * self.qn
                scores[d] = w * (np.sqrt(np.float32(freq)) * cache[nb])
            match[d] = True
        return scores, match

    # -- multi-term ----------------------------------------------------------
    def _multi_term_mask(self, q) -> np.ndarray:
        seg = self.seg
        mask = np.zeros(self.D, bool)
        pred = _term_predicate(q)
        for term in seg.terms_for_field(q.field):
            if pred(term):
                docs, _ = seg.postings(q.field, term)
                mask[docs] = True
        return mask

    def _fuzzy_terms(self, q: FuzzyQuery) -> list[str]:
        max_edits = _fuzzy_max_edits(q.fuzziness, q.value)
        out = []
        for term in self.seg.terms_for_field(q.field):
            if q.prefix_length and not term.startswith(q.value[: q.prefix_length]):
                continue
            if _within_edits(q.value, term, max_edits):
                out.append(term)
                if len(out) >= q.max_expansions:
                    break
        return out

    # -- phrase --------------------------------------------------------------
    def _eval_phrase(self, q: PhraseQuery, boost: float, in_order: bool = True):
        seg, ctx = self.seg, self.ctx
        scores = np.zeros(self.D, np.float32)
        match = np.zeros(self.D, bool)
        toks = ctx.analyze_tokens(q.field, q.text)
        terms = [t.term for t in toks]
        rel_pos = [t.position for t in toks]
        if not terms:
            return scores, match
        if len(terms) == 1 and not q.prefix:
            return self._term_scores(q.field, terms[0], boost)
        last_terms = [terms[-1]]
        if q.prefix:
            last_terms = [t for t in seg.terms_for_field(q.field)
                          if t.startswith(terms[-1])][: q.max_expansions] or []
            if not last_terms:
                return scores, match
        # candidate docs: intersection of postings
        doc_sets = []
        for t in terms[:-1]:
            docs, _ = seg.postings(q.field, t)
            doc_sets.append(set(docs.tolist()))
        last_docs: set = set()
        for lt in last_terms:
            docs, _ = seg.postings(q.field, lt)
            last_docs.update(docs.tolist())
        doc_sets.append(last_docs)
        candidates = sorted(set.intersection(*doc_sets)) if doc_sets else []
        if not candidates:
            return scores, match
        if q.slop == 0:
            docs, freq = _exact_phrase_freqs(seg, q.field, terms[:-1], last_terms,
                                             rel_pos)
        else:
            # positions check
            pos_maps = [_positions_by_doc(seg, q.field, t) for t in terms[:-1]]
            last_pos: dict[int, set] = {}
            for lt in last_terms:
                for d, ps in _positions_by_doc(seg, q.field, lt).items():
                    last_pos.setdefault(d, set()).update(ps)
            freq = np.asarray([
                _phrase_freq([pm.get(d, set()) for pm in pos_maps]
                             + [last_pos.get(d, set())], rel_pos, q.slop, in_order)
                for d in candidates], dtype=np.int64)
            docs = np.asarray(candidates, dtype=np.int64)
        keep = freq > 0
        docs, freq = docs[keep], freq[keep].astype(np.float32)
        if not len(docs):
            return scores, match
        sim = ctx.similarity_for(q.field)
        norms = seg.norms.get(q.field)
        cache = sim.norm_cache(ctx.field_stats(q.field), ctx.max_doc)
        idf_sum = np.float32(sum(
            float(sim.idf(ctx.doc_freq(q.field, t), ctx.max_doc))
            for t in terms if ctx.doc_freq(q.field, t) > 0
        ))
        cnb = cache[norms[docs]] if norms is not None else np.full(len(docs), cache[0])
        # elementwise float32, the same operations as a doc-at-a-time loop
        if isinstance(sim, BM25Similarity):
            w = np.float32(idf_sum * boost * (sim.k1 + 1.0))
            scores[docs] = w * (freq / (freq + cnb))
        else:
            w = np.float32(idf_sum * idf_sum * boost) * self.qn
            scores[docs] = w * (np.sqrt(freq) * cnb)
        match[docs] = True
        return scores, match

    # -- rewrites ------------------------------------------------------------
    def _rewrite_common(self, q: CommonTermsQuery) -> Query:
        ctx = self.ctx
        terms = ctx.analyze(q.field, q.text)
        max_doc = max(ctx.max_doc, 1)
        low, high = [], []
        for t in terms:
            df = ctx.doc_freq(q.field, t)
            cutoff = q.cutoff_frequency
            threshold = cutoff * max_doc if cutoff < 1.0 else cutoff
            (high if df > threshold else low).append(TermQuery(q.field, t))
        if not low:
            op_group = q.high_freq_operator
            return BoolQuery(must=high if op_group == "and" else [],
                             should=high if op_group != "and" else [],
                             minimum_should_match=q.minimum_should_match)
        low_bool = BoolQuery(must=low if q.low_freq_operator == "and" else [],
                             should=low if q.low_freq_operator != "and" else [],
                             minimum_should_match=q.minimum_should_match)
        if not high:
            return low_bool
        return BoolQuery(must=[low_bool], should=high, disable_coord=True)

    def _rewrite_mlt(self, q: MoreLikeThisQuery) -> Query:
        ctx = self.ctx
        shoulds = []
        for field in q.fields:
            counts = Counter(ctx.analyze(field, q.like_text))
            scored = []
            for t, tf in counts.items():
                if tf < q.min_term_freq:
                    continue
                df = ctx.doc_freq(field, t)
                if df < q.min_doc_freq or df <= 0:
                    continue
                idf = TFIDFSimilarity.idf(df, ctx.max_doc)
                scored.append((float(tf * idf), t))
            scored.sort(reverse=True)
            for _, t in scored[: q.max_query_terms]:
                shoulds.append(TermQuery(field, t))
        return BoolQuery(should=shoulds, minimum_should_match=q.minimum_should_match)

    def _rewrite_flt(self, q: FuzzyLikeThisQuery) -> Query:
        """like_text analyzed per field, each term OR-expanded to its fuzzy
        neighbourhood. A legacy float fuzziness < 1 is a min-similarity:
        edits = min(2, ⌊(1-sim)·len⌋), the classic Lucene conversion."""
        ctx = self.ctx
        fields = q.fields or ["_all"]
        shoulds: list = []
        budget = max(int(q.max_query_terms), 1)
        for field in fields:
            terms = list(dict.fromkeys(ctx.analyze(field, q.like_text)))[:budget]
            for t in terms:
                fz = q.fuzziness
                try:
                    f_val = float(fz)
                    if 0 < f_val < 1:
                        fz = min(2, int((1.0 - f_val) * len(t)))
                except (TypeError, ValueError):
                    pass
                shoulds.append(FuzzyQuery(field, t, fz, q.prefix_length))
        return BoolQuery(should=shoulds, minimum_should_match=1, boost=q.boost)


def _term_predicate(q):
    """The term test of a prefix, wildcard or regexp query."""
    if isinstance(q, PrefixQuery):
        return lambda t: t.startswith(q.prefix)
    rex = re.compile(_wildcard_to_regex(q.pattern) if isinstance(q, WildcardQuery)
                     else q.pattern)
    return lambda t: rex.fullmatch(t) is not None


def _positions_by_doc(seg: FrozenSegment, field: str, term: str) -> dict[int, set]:
    tid = seg.term_id(field, term)
    if tid is None:
        return {}
    positions = seg.require("positions", "phrase queries")
    s, e = int(seg.post_offsets[tid]), int(seg.post_offsets[tid + 1])
    out = {}
    docs = seg.post_docs[s:e].tolist()
    for i, d in zip(range(s, e), docs):
        out[d] = set(positions[seg.pos_offsets[i]: seg.pos_offsets[i + 1]].tolist())
    return out


def _position_keys(seg: FrozenSegment, field: str, term: str) -> np.ndarray:
    """Every (doc, position) of the term in the segment as one int64 key,
    doc << 32 | position."""
    tid = seg.term_id(field, term)
    if tid is None:
        return np.zeros(0, np.int64)
    positions = seg.require("positions", "phrase queries")
    s, e = int(seg.post_offsets[tid]), int(seg.post_offsets[tid + 1])
    lo, hi = int(seg.pos_offsets[s]), int(seg.pos_offsets[e])
    docs = np.repeat(seg.post_docs[s:e].astype(np.int64),
                     np.diff(seg.pos_offsets[s: e + 1]))
    return (docs << 32) | positions[lo:hi].astype(np.int64)


def _exact_phrase_freqs(seg: FrozenSegment, field: str, head: list[str],
                        last_terms: list[str], rel_pos: list[int]):
    """A slop-0 phrase's occurrences per doc, `_phrase_freq`'s count at slop
    0 vectorized: each position p0 of the first term counts when every term
    i sits at p0 + rel_pos[i] - rel_pos[0] (the last term: any of
    `last_terms`). Returns (docs, freqs) of the first term's docs."""
    keys = [_position_keys(seg, field, t) for t in head]
    keys.append(np.concatenate([_position_keys(seg, field, t) for t in last_terms]))
    first = keys[0]
    hit = np.ones(len(first), dtype=bool)
    for i in range(1, len(keys)):
        hit &= np.isin(first + (rel_pos[i] - rel_pos[0]), keys[i])
    docs, freqs = np.unique(first[hit] >> 32, return_counts=True)
    return docs, freqs


def _near_spans(lists: list[list[tuple[int, int]]], slop: int,
                in_order: bool) -> list[tuple[int, int]]:
    """Compose child span lists into near-spans with total gap <= slop.

    Ordered: one span per clause, each starting at or after the previous
    clause's end (Lucene NearSpansOrdered's non-overlap rule), gap = sum of
    inter-span distances. Unordered: any one span per clause, gap = covering
    width minus total child length (overlaps clamp to 0). Enumeration stops
    at 20,000 combinations a doc."""
    out: set[tuple[int, int]] = set()
    if in_order:
        budget = [20000]  # recursion guard for pathological position lists

        def rec(i: int, start: int, prev_end: int, gap: int):
            if budget[0] <= 0:
                return
            if i == len(lists):
                out.add((start, prev_end))
                return
            for (s, e) in lists[i]:
                if i > 0 and s < prev_end:
                    continue
                g = gap + (s - prev_end if i > 0 else 0)
                if g > slop:
                    continue
                budget[0] -= 1
                rec(i + 1, start if i > 0 else s, e, g)

        rec(0, 0, 0, 0)
    else:
        import itertools

        for combo in itertools.islice(itertools.product(*lists), 20000):
            mn = min(s for s, _e in combo)
            mx = max(e for _s, e in combo)
            gap = max((mx - mn) - sum(e - s for s, e in combo), 0)
            if gap <= slop:
                out.add((mn, mx))
    return sorted(out)


def _phrase_freq(pos_sets: list[set], rel_pos: list[int], slop: int,
                 in_order: bool) -> int:
    """Count phrase occurrences. slop=0: exact relative positions. slop>0:
    alignments whose total displacement ≤ slop (greedy per anchor)."""
    if not pos_sets or any(not s for s in pos_sets):
        return 0
    first = pos_sets[0]
    count = 0
    for p0 in sorted(first):
        if slop == 0:
            if all((p0 + rel_pos[i] - rel_pos[0]) in pos_sets[i]
                   for i in range(1, len(pos_sets))):
                count += 1
        else:
            total_disp = 0
            ok = True
            prev = p0
            for i in range(1, len(pos_sets)):
                expected = p0 + rel_pos[i] - rel_pos[0]
                cands = pos_sets[i]
                if in_order:
                    cands = {c for c in cands if c > prev}
                if not cands:
                    ok = False
                    break
                nearest = min(cands, key=lambda c: abs(c - expected))
                total_disp += abs(nearest - expected)
                prev = nearest
            if ok and total_disp <= slop:
                count += 1
    return count


def _wildcard_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "*":
            out.append(".*")
        elif ch == "?":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "".join(out)


def _fuzzy_max_edits(fuzziness, value: str) -> int:
    if fuzziness in ("AUTO", "auto", None):
        n = len(value)
        return 0 if n <= 2 else (1 if n <= 5 else 2)
    try:
        return int(float(fuzziness))
    except (TypeError, ValueError):
        return 1


def _within_edits(a: str, b: str, max_edits: int) -> bool:
    if abs(len(a) - len(b)) > max_edits:
        return False
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        row_min = i
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
            row_min = min(row_min, cur[j])
        if row_min > max_edits:
            return False
        prev = cur
    return prev[-1] <= max_edits


# ---------------------------------------------------------------------------
# query_string and simple_query_string (subsets of the Lucene syntax)
# ---------------------------------------------------------------------------

_QS_TOKEN = re.compile(
    r"\s*(?:(\()|(\))|(AND\b|&&)|(OR\b|\|\|)|(NOT\b|!)|([+-])?"
    r"(?:(\w[\w.]*):)?(?:\"([^\"]*)\"|([^\s()]+)))"
)

_SQS_TOKEN = re.compile(
    r'\s*(?:(\|)|(\+)|(-)|"([^"]*)"(?:~(\d+))?|([^\s|+\-][^\s|+]*))'
)


def parse_simple_query_string(q: SimpleQueryStringQuery) -> Query:
    """Whitespace-separated terms joined by the default operator, `+` forces
    AND, `|` forces OR, a leading `-` negates, `"..."` is a phrase (optional
    ~slop), a trailing `*` a prefix. Invalid syntax never raises: stray
    operators degrade to plain text."""
    fields = q.fields or ["_all"]

    def node_for(phrase, slop, word):
        subs: list = []
        for f in fields:
            fname, _, fboost = f.partition("^")
            boost = float(fboost) if fboost else 1.0
            if phrase is not None:
                subs.append(PhraseQuery(fname, phrase, slop=int(slop or 0),
                                        boost=boost))
            elif word.endswith("*") and len(word) > 1:
                subs.append(PrefixQuery(fname, word[:-1].lower(), boost))
            else:
                subs.append(MatchQuery(fname, word, boost=boost))
        if len(subs) == 1:
            return subs[0]
        return BoolQuery(should=subs, minimum_should_match=1,
                         disable_coord=True)

    must, should, must_not = [], [], []
    pending = None  # explicit connective seen since the last term
    negate = False
    for m in _SQS_TOKEN.finditer(q.query):
        bar, plus, minus, phrase, slop, word = m.groups()
        if bar:
            # "a | b": an explicit OR releases its LEFT operand from must
            # (the default_operator=and case)
            if must:
                should.append(must.pop())
            pending = "or"
            continue
        if plus:
            pending = "and"
            continue
        if minus:
            negate = True
            continue
        node = node_for(phrase, slop, word)
        if negate:
            must_not.append(node)
        elif pending == "and" or (pending is None
                                  and q.default_operator == "and"):
            if pending == "and" and should:
                must.append(should.pop())  # "a + b": AND binds its left operand
            must.append(node)
        else:
            should.append(node)
        pending = None
        negate = False
    if not must and not should and not must_not:
        return MatchAllQuery()
    if len(should) == 1 and not must and not must_not:
        out = should[0]
        out.boost = out.boost * q.boost
        return out
    return BoolQuery(must=must, should=should, must_not=must_not, boost=q.boost)


def parse_query_string(q: QueryStringQuery, ctx: ShardContext) -> Query:
    """field:term, AND/OR/NOT, +/-, "phrases", wild*cards, (grouping — flattened)."""
    default_fields = q.fields or [q.default_field]
    must, should, must_not = [], [], []
    pending_op = None
    for m in _QS_TOKEN.finditer(q.query):
        lparen, rparen, and_, or_, not_, sign, fname, phrase, word = m.groups()
        if lparen or rparen:
            continue
        if and_:
            # "a AND b": the left operand becomes required too
            if should:
                must.append(should.pop())
            pending_op = "and"
            continue
        if or_:
            pending_op = "or"
            continue
        if not_:
            pending_op = "not"
            continue
        target_fields = [fname] if fname else default_fields
        subs: list[Query] = []
        for f in target_fields:
            if phrase is not None:
                subs.append(PhraseQuery(f, phrase))
            elif word == "*":
                subs.append(MatchAllQuery())
            elif word and ("*" in word or "?" in word):
                subs.append(WildcardQuery(f, word))
            elif word and "~" in word:
                base, _, fuzz = word.partition("~")
                subs.append(FuzzyQuery(f, base, fuzz or "AUTO"))
            elif word:
                subs.append(MatchQuery(f, word))
            else:
                continue
        node = subs[0] if len(subs) == 1 else DisMaxQuery(queries=subs)
        if sign == "+" or pending_op == "and" or (pending_op is None
                                                  and q.default_operator == "and"):
            must.append(node)
        elif sign == "-" or pending_op == "not":
            must_not.append(node)
        else:
            should.append(node)
        pending_op = None
    if not must and not should and not must_not:
        return MatchAllQuery()
    if len(should) == 1 and not must and not must_not:
        out = should[0]
        out.boost = out.boost * q.boost
        return out
    return BoolQuery(must=must, should=should, must_not=must_not, boost=q.boost)


def host_match_mask(query: Query, seg: FrozenSegment, ctx: ShardContext) -> np.ndarray:
    _, match = HostScorer(ctx, seg).eval(query)
    return match


# ---------------------------------------------------------------------------
# shard-level entry points
# ---------------------------------------------------------------------------


def dispatch_shard_batch(ctx: ShardContext, queries: list[Query],
                         k: int) -> _PendingFlat:
    """The dispatch half of `search_shard_batch` for a batch of lowerable
    queries: plans and launches it with no device→host synchronisation;
    `.merge()` on the result performs the batch's one pull and returns the
    per-query TopDocs. A query that does not lower raises: the host scorer
    has no dispatch half."""
    plans = []
    for q in queries:
        plan = lower_flat(q, ctx)
        if plan is None:
            raise QueryParsingError(
                f"[{type(q).__name__}] does not lower to a flat device plan; "
                "search_shard_batch serves it on the host scorer")
        plans.append(plan)
    return _dispatch_flat_plain(plans, ctx, k)


def search_shard(ctx: ShardContext, query: Query, k: int, use_device: bool = True,
                 deadline=None) -> TopDocs:
    return search_shard_batch(ctx, [query], k, use_device=use_device,
                              deadline=deadline)[0]


def search_shard_batch(ctx: ShardContext, queries: list[Query], k: int,
                       use_device: bool = True, deadline=None) -> list[TopDocs]:
    """Execute a batch: the flat-lowerable queries fused onto the device, the
    rest on the host scorer (all of them with `use_device=False`). Top-k hits
    per query, (score, global doc) pairs in score-desc, doc-asc order.

    `deadline` (common.deadline.Deadline) clamps host execution at segment
    granularity; a device batch, once launched, runs whole."""
    results: list[TopDocs | None] = [None] * len(queries)
    flat_idx: list[int] = []
    flat_plans: list[FlatPlan] = []
    if use_device:
        for i, q in enumerate(queries):
            plan = lower_flat(q, ctx)
            if plan is not None:
                flat_idx.append(i)
                flat_plans.append(plan)
    if flat_plans:
        for i, td in zip(flat_idx, execute_flat_batch(flat_plans, ctx, k)):
            results[i] = td
    for i, q in enumerate(queries):
        if results[i] is None:
            results[i] = _host_search(ctx, q, k, deadline=deadline)
    return results  # type: ignore[return-value]


def _host_search(ctx: ShardContext, query: Query, k: int,
                 extra_filter: Filter | None = None, deadline=None,
                 min_score: float | None = None) -> TopDocs:
    """The host scorer's top-k over the searcher's segments. A hit must
    score at least `min_score` and pass `extra_filter` (the post filter);
    the total and `max_score` count the hits that do."""
    qn = query_norm_for(query, ctx)
    all_scores: list[np.ndarray] = []
    all_docs: list[np.ndarray] = []
    total = 0
    timed_out = False
    for seg, base in zip(ctx.searcher.segments, ctx.searcher.bases):
        # host-side segment boundary: expiry keeps the segments already scored
        if deadline is not None and deadline.expired():
            timed_out = True
            break
        scores, match = HostScorer(ctx, seg, qn).eval(query)
        match = match & seg.live & seg.parent_mask
        if min_score is not None:
            match = match & (scores >= np.float32(min_score))
        if extra_filter is not None:
            match = match & segment_mask(seg, extra_filter, ctx)
        idx = np.nonzero(match)[0]
        total += len(idx)
        if len(idx):
            all_scores.append(scores[idx])
            all_docs.append(idx + base)
    if not all_scores:
        return TopDocs(0, [], float("nan"), timed_out=timed_out)
    scores = np.concatenate(all_scores)
    docs = np.concatenate(all_docs)
    order = np.lexsort((docs, -scores))[:k]
    hits = list(zip(scores[order].tolist(), docs[order].tolist()))
    return TopDocs(total, hits, float(scores.max()), timed_out=timed_out)
