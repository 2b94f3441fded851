"""Per-shard query planning + execution for plain flat plans — the port of the
JAX package's `search/execute.py` device path.

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

A query that does not lower to a flat plan raises QueryParsingError: the
host scorer that serves such queries in the JAX package is a later slice of
the port.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ..common.cudaenv import default_device, pull_async
from ..common.errors import QueryParsingError
from ..index.engine import Searcher
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
from .queries import BoolQuery, MatchQuery, Query, TermQuery
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
    scorer (fuzzy match, must_not-only bool, non-term bool sub-clauses) or
    reads a numeric, date or boolean field: those keep doc values only in
    the port so far, and a clause on one must not answer "no match"."""
    plan = _lower_flat_inner(query, ctx)
    if plan is not None:
        for field in {c.field for c in plan.clauses}:
            ft = ctx.field_type(field)
            if ft is not None and not ft.is_text:
                return None
            if not isinstance(ctx.similarity_for(field),
                              (BM25Similarity, TFIDFSimilarity)):
                return None
    return plan


def _lower_flat_inner(query: Query, ctx: ShardContext) -> FlatPlan | None:
    if isinstance(query, TermQuery):
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
# shard-level entry points
# ---------------------------------------------------------------------------


def _lower_all(ctx: ShardContext, queries: list[Query]) -> list[FlatPlan]:
    plans = []
    for q in queries:
        plan = lower_flat(q, ctx)
        if plan is None:
            raise QueryParsingError(
                f"[{type(q).__name__}] does not lower to a flat device plan; "
                "the host scorer that serves it is a later slice of the port")
        plans.append(plan)
    return plans


def dispatch_shard_batch(ctx: ShardContext, queries: list[Query],
                         k: int) -> _PendingFlat:
    """The dispatch half of `search_shard_batch`: plans and launches the batch
    with no device→host synchronisation; `.merge()` on the result performs
    the batch's one pull and returns the per-query TopDocs."""
    return _dispatch_flat_plain(_lower_all(ctx, queries), ctx, k)


def search_shard_batch(ctx: ShardContext, queries: list[Query],
                       k: int) -> list[TopDocs]:
    """Execute a batch of queries on the shard's device: top-k hits per query,
    (score, global doc) pairs in score-desc, doc-asc order."""
    if not queries:
        return []
    return execute_flat_batch(_lower_all(ctx, queries), ctx, k)


def search_shard(ctx: ShardContext, query: Query, k: int) -> TopDocs:
    return search_shard_batch(ctx, [query], k)[0]
