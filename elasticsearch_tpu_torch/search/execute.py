"""Per-shard query planning + execution — the port of the JAX package's
`search/execute.py`: the device path for flat plans and the host scorer for
every other query.

A query lowers to a flat weighted-term plan (`lower_flat`); a whole batch of
plans is finalized against shard-level term statistics (`finalize_flat`,
`_assemble_batch`) and, per segment, dispatched to the device: the sparse
kernel for every query within `tb_max` blocks, the dense program for the
overflow (`_launch_flat_plain`). The merge half (`_PendingFlat.merge`) pulls
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

A `filtered` query whose sub-query lowers, and a `function_score` whose
sub-query lowers and whose functions read no `_score` (or are one
vectorizable `_score`-reading script), lower to a plan that carries its
filter (`filt`) or its function_score spec (`fs`); the batch sends them to
the dense request-feature family — the dense program's core with the filter
mask or the function tail (`ops/scoring.py`) — beside the plain plans, and
the same one pull serves every family (`dispatch_flat_batch`). Their host
inputs (mask rows, function rows) are built and uploaded by the thread that
plans the query (`prepare_dense`), and a query the family hands back to the
host scorer is served by its caller after the merge (`host_reruns`), so the
batcher's drainer only launches and merges.

A field sort or aggregations run a single plan from the calling thread, as
in the JAX package (not through the batcher): `launch_flat_sorted` (the
dense core's top k by a pre-folded sort-key row) and `launch_flat_aggs` (the
dense core with the metric stats and bucket counts of the aggregations)
launch every segment without synchronising and return a part whose
`tensors()` the caller pulls once, with any other part of the request, and
whose `collect()` merges the segments on the host (`execute_flat_sorted`,
`execute_flat_aggs` do both for one plan, for the tests). `iter_match_masks`
is the one per-segment (scores, match) source of the host scorer's top-k
(`_host_search`) and of the general host path.

A query that does not lower to a flat plan (phrases, multi-term expansion,
spans, filters, a numeric term, a bool with a filter or with must_not only, a
fuzzy match) runs on the host scorer (`HostScorer`): a recursive numpy
evaluation per segment into dense (scores float32[D], match bool[D]) with the
same similarity math and the JAX package's expression order, so its scores
are bitwise the JAX host scorer's. `search_shard_batch` sends the lowerable
queries of a batch fused to the device and the rest to `_host_search`, as
the JAX package does.
"""

from __future__ import annotations

import fnmatch
import re
import time
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from ..common import profile as _profile
from ..common.breaker import reserve
from ..common.cudaenv import (PendingPull, default_device, pull_async, upload,
                              upload_pinned)
from ..common.devicehealth import context_lost, tag_domain
from ..common.errors import (QueryParsingError, ScriptError, SimilarityNotSupportedError,
                             body_value)
from ..common.profile import timed_launch
from ..common.smallfloat import decode_norm_doclen
from ..index.engine import Searcher
from ..index.segment import FrozenSegment
from ..ops.device_index import (
    TFN_BM25,
    TFN_TFIDF,
    expand_ranges,
    ensure_agg_rows,
    ensure_blk_freqs,
    ensure_sim_tables,
    packed_for,
)
from ..ops.scoring import (
    MODE_BM25,
    MODE_CONST,
    MODE_TFIDF,
    SparseScratchPool,
    build_term_batch,
    collect_flat_sparse,
    dense_chunk,
    finalize_score_result,
    launch_flat_sparse,
    score_agg_batch_async,
    score_filtered_batch_async,
    score_fs_rows_batch_async,
    score_fs_script_batch_async,
    score_sorted_batch_async,
    score_term_batch_async,
)
from ..ops.sparse_kernels import BLOCK, GROUP_MUST, GROUP_MUST_NOT, GROUP_SHOULD
from .aggregations import _bucket_cache_put, bucket_cache_key, bucket_cols_for
from .filters import Filter, IdsFilter, RangeFilter, TermFilter, segment_mask
from .queries import (
    BoolQuery,
    BoostingQuery,
    CommonTermsQuery,
    ConstantScoreQuery,
    DisMaxQuery,
    FieldMaskingSpanQuery,
    FilteredQuery,
    FunctionScoreQuery,
    FuzzyLikeThisQuery,
    FuzzyQuery,
    HasChildQuery,
    HasParentQuery,
    IdsQuery,
    IndicesQuery,
    MatchAllQuery,
    MatchQuery,
    MoreLikeThisQuery,
    MultiMatchQuery,
    NestedQuery,
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
from ..transport.faults import DEVICE_FAULTS, DEVICE_PULL
from .similarity import (BM25Similarity, FreqNormSimilarity, SimilarityService,
                         TFIDFSimilarity)
from .sorting import device_sort_key_row


@contextmanager
def _domain_seam(domain: str):
    """A device seam of the fault domains (common/devicehealth): the seeded
    error injection (transport/faults.DEVICE_FAULTS; one attribute read
    when disarmed) and the domain's tag on whatever the body raises."""
    try:
        if DEVICE_FAULTS.active:
            DEVICE_FAULTS.check(domain)
        yield
    except Exception as e:  # noqa: BLE001 — re-raised tagged
        raise tag_domain(e, domain)


def wait_pull(pull: PendingPull, index: str | None) -> list:
    """The batch's one wait, behind the `pull:<index>` seam. A kernel fault
    surfaces here, at the sync after the launches, not at the launch. A
    failed wait abandons the batch's staging with no further CUDA call: after
    a sticky error every call would raise again. An armed DEVICE_PULL stalls
    the wait first, as a hung card would (one attribute read disarmed)."""
    if DEVICE_PULL.active:
        stall = DEVICE_PULL.delay_for(index)
        if stall > 0.0:
            time.sleep(stall)
    try:
        if DEVICE_FAULTS.active:
            DEVICE_FAULTS.check(f"pull:{index}")
        return pull.wait()
    except Exception as e:  # noqa: BLE001 — re-raised tagged
        pull.abandon(context_lost=context_lost(e))
        raise tag_domain(e, f"pull:{index}")


class ShardContext:
    """Shard-level stats + mapping access shared by planner and scorers, and
    the device the shard's queries run on (the card unless `device="cpu"`)."""

    def __init__(self, searcher: Searcher, mapper_service,
                 similarity_service: SimilarityService | None = None,
                 device=None, breakers=None, batcher=None, filter_cache=None,
                 index_name: str | None = None, global_stats: dict | None = None):
        self.searcher = searcher
        self.mapper_service = mapper_service
        self.similarity_service = similarity_service or SimilarityService(
            mapper_service=mapper_service)
        # the DFS phase's override of the shard's own statistics:
        # {"df": {(field, term): df}, "max_doc": N, "field_stats": {field:
        # FieldStats}} (search/controller.aggregate_dfs); everything that
        # weighs a clause reads max_doc, doc_freq and field_stats below
        self.global_stats = global_stats or {}
        self.device = default_device(device)
        # a CircuitBreakerService, or None in unwired contexts: the sparse
        # path reserves its per-batch staging on breaker("request")
        self.breakers = breakers
        # a cross-request DeviceBatcher (search/batcher.py), or None: single
        # requests coalesce with concurrent ones when present
        # (service._execute_flat_single)
        self.batcher = batcher
        # the node's DeviceFilterCache (ops/device_index.py), or None: hot
        # filters' masks stay resident on the device for the filtered family
        # (_filter_mask_row)
        self.filter_cache = filter_cache
        # the index this shard belongs to (None unknown): the pack ledger's
        # owner of the packs this context's searches make
        self.index_name = index_name

    def breaker(self, name: str):
        """The named circuit breaker, or None when no service is wired."""
        return None if self.breakers is None else self.breakers.breaker(name)

    @property
    def max_doc(self) -> int:
        return self.global_stats.get("max_doc", self.searcher.max_doc)

    def doc_freq(self, field: str, term: str) -> int:
        dfs = self.global_stats.get("df")
        if dfs is not None and (field, term) in dfs:
            return dfs[(field, term)]
        return self.searcher.doc_freq(field, term)

    def field_stats(self, field: str):
        fs = self.global_stats.get("field_stats")
        if fs is not None and field in fs:
            return fs[field]
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

    def all_terms(self, field: str) -> list[str]:
        """The field's terms over every segment, sorted (the term
        suggester's candidates)."""
        terms: set[str] = set()
        for seg in self.searcher.segments:
            terms.update(seg.term_dict.get(field, ()))
        return sorted(terms)


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
    # function_score plans: the wrapping FunctionScoreQuery (the dense family
    # applies its function tail; also the host-rerun query), its kind, and
    # the outer boost — it joins the TF-IDF queryNorm pre-pass
    # (_weight_prepass walks through FunctionScoreQuery with it) but not the
    # sub-query's clause weights
    fs: object = None  # FunctionScoreQuery | None
    fs_kind: str | None = None  # "rows" | "script" (classified at lower time)
    norm_boost: float = 1.0
    # FilteredQuery (or a post filter): the filter gates MATCHING only, as
    # the host scorer's FilteredQuery branch; evaluated per segment (the
    # filter caches) and fed to the dense family as a mask row
    filt: object = None  # Filter | None


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
                if clause_count > body_value(int, cond):
                    result = _msm_value(value, clause_count)
                    break
        else:
            result = _msm_value(s, clause_count)
    # no upper clamp: msm > clause_count matches nothing (Lucene semantics)
    return max(0, result)


def _msm_value(s: str, clause_count: int) -> int:
    s = s.strip()
    if s.endswith("%"):
        pct = body_value(float, s[:-1])
        if pct < 0:
            return clause_count + int(clause_count * pct / 100.0)
        return int(clause_count * pct / 100.0)
    v = body_value(int, s)
    return clause_count + v if v < 0 else v


# ---------------------------------------------------------------------------
# flat lowering
# ---------------------------------------------------------------------------


def lower_flat(query: Query, ctx: ShardContext) -> FlatPlan | None:
    """Lower a query to a flat clause list, or None when it needs the host
    scorer: a term on a numeric field (a doc-value column), a fuzzy match, a
    bool with a filter, with must_not only or with sub-clauses that are not
    single terms, a function_score or filtered query whose sub-query does
    not lower (or whose functions `_classify_fs` sends to the host), every
    other query type, and any clause on a field whose similarity the kernel
    does not fuse (BM25 and TF-IDF only)."""
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
    if isinstance(query, FunctionScoreQuery):
        # the function tail runs in the dense family (ops/scoring
        # _fs_rows_impl / _fs_script_impl) when the sub-query lowers flat and
        # the functions classify as "rows" or "script"
        if query.query is None:
            return None
        sub = _lower_flat_inner(query.query, ctx)
        if sub is None or sub.fs is not None or sub.filt is not None:
            return None
        kind = _classify_fs(query)
        if kind is None:
            return None
        return FlatPlan(sub.clauses, msm=sub.msm, n_must=sub.n_must,
                        coord_enabled=sub.coord_enabled, boost=sub.boost,
                        fs=query, fs_kind=kind, norm_boost=query.boost)
    if isinstance(query, FilteredQuery):
        # the boost folds into the sub clauses (host: eval(q.query, b)); the
        # filter becomes a match-gating mask row in the dense family
        sub = _lower_flat_inner(query.query, ctx)
        if sub is None or sub.fs is not None or sub.filt is not None:
            return None
        return FlatPlan(sub.clauses, msm=sub.msm, n_must=sub.n_must,
                        coord_enabled=sub.coord_enabled,
                        boost=sub.boost * query.boost, filt=query.filter)
    return None


def _classify_fs(q: FunctionScoreQuery):
    """Device eligibility of a function_score spec:
      "rows"   — no function reads _score: the values fold to host-combined
                 float32 rows (functions.combined_doc_rows);
      "script" — exactly one function, a _score-reading script_score inside
                 the vectorizable subset: evaluated in the dense launch;
      None     — host scorer."""
    from ..script import compile_script, script_uses_score, script_vectorizable

    score_readers = 0
    for sf in q.functions:
        if sf.kind == "script_score":
            try:
                cs = compile_script(sf.script, sf.params)
            except ScriptError:
                return None
            if script_uses_score(cs):
                score_readers += 1
    if score_readers == 0:
        return "rows"
    if score_readers == 1 and len(q.functions) == 1 and script_vectorizable(
            compile_script(q.functions[0].script, q.functions[0].params)):
        return "script"
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


_GROUP_NAMES = {GROUP_SHOULD: "should", GROUP_MUST: "must",
                GROUP_MUST_NOT: "must_not"}


def plan_profile(plan: FlatPlan, query: Query) -> dict:
    """The resolved plan shape a profiled request reports: per clause
    (field, term, boost, group), the bool semantics and the function tail's
    kind; plain scalars, so it crosses the wire and renders as JSON."""
    return {
        "query_type": type(query).__name__,
        "clauses": [{"field": c.field, "term": c.term,
                     "boost": float(c.boost), "group": _GROUP_NAMES[c.group]}
                    for c in plan.clauses],
        "msm": int(plan.msm),
        "n_must": int(plan.n_must),
        "coord": bool(plan.coord_enabled),
        "boost": float(plan.boost),
        "function_score": plan.fs_kind,  # None | "rows" | "script"
        "filtered": plan.filt is not None,
    }


def lower_fallback_reason(query: Query, ctx: ShardContext) -> str:
    """Why lower_flat declined this query, in the profile's fallback-reason
    vocabulary (common/profile.py). Profiled requests only: it walks the
    query again. When the inner lowering succeeds, the decline was
    lower_flat's similarity gate (DFR, IB and LM fields score on the
    host)."""
    if _lower_flat_inner(query, ctx) is not None:
        return "similarity_not_fused"
    if isinstance(query, TermQuery):
        return "numeric_term"
    if isinstance(query, MatchQuery):
        return "fuzzy_match"
    if isinstance(query, BoolQuery):
        if query.filter:
            return "bool_filter_clause"
        subs = query.must + query.should + query.must_not
        if any(_single_term(sub, ctx) is None for sub in subs):
            return "non_term_subclause"
        return "must_not_only"
    if isinstance(query, FunctionScoreQuery):
        if query.query is None:
            return "function_score_no_query"
        if _lower_flat_inner(query.query, ctx) is None:
            return "non_flat_subquery"
        return "function_score_ineligible"
    if isinstance(query, FilteredQuery):
        return "non_flat_subquery"
    return f"unsupported_query:{type(query).__name__}"


def _prof_dense_segment(prof, seg, packed, path: str, launches: int,
                        t_seg: float) -> None:
    """A dense-family segment's profile record (its blocks were counted as
    its chunks' TermBatches were built, `_prof_blocks`)."""
    prof.segment(seg.gen, docs=int(seg.doc_count), path=path,
                 tf_layout=packed.tf_layout, launches=launches,
                 ms=(time.monotonic() - t_seg) * 1000.0)


def _prof_blocks(seg, cols) -> None:
    """Count a dense chunk's (query, block) triples as the segment's
    scanned blocks, when the request is profiled."""
    prof = _profile.current()
    if prof is not None:
        prof.segment(seg.gen, blocks_scanned=int(len(cols[0])))


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
            ssw += float((idf * c.boost * plan.boost * plan.norm_boost) ** 2)
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
# batched device execution: host inputs, dispatch half, merge half
# ---------------------------------------------------------------------------

# the dense-family input (`prepare_dense`) of a function_score plan whose
# spec's rows raised ScriptError while they were built: the host scorer
# serves that query, where the per-doc evaluation decides
HOST_RERUN = "host_rerun"


class _PlainPart:
    """The plain plans of a batch, at batch positions `idx`: per segment
    (seg, base, doc_pad, sparse launches, dense overflow launches)."""

    kind = "plain"
    __slots__ = ("idx", "seg_work")

    def __init__(self, idx: list, seg_work: list):
        self.idx = idx
        self.seg_work = seg_work

    def tensors(self) -> list:
        refs = []
        for (_seg, _base, _doc_pad, launches, dense) in self.seg_work:
            for (_sb, r) in launches:
                refs.extend(r)
            for (_sub, r) in dense or ():
                refs.extend(r)
        return refs

    def collect(self, flat, k: int) -> list[TopDocs]:
        """The host merge over the pulled results (`flat`, an iterator in
        `tensors()` order): per segment the sparse buckets and dense
        overflow into [Q, k], then the cross-segment top-k."""
        Q = len(self.idx)
        totals = np.zeros(Q, dtype=np.int64)
        seg_hits = []  # (scores [Q,k] f32, global_docs [Q,k] int64) per segment
        for (seg, base, doc_pad, launches, dense) in self.seg_work:
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
            seg_hits.append(_seg_hits(scores, docs, seg, base, doc_pad))
        return _merge_seg_hits(seg_hits, totals, Q, k)


class _DensePart:
    """One dense-family launch set of a batch, at batch positions `idx`:
    its filtered plans, or the function_score plans of one spec. Per segment
    (seg, base, doc_pad, [(query rows of the part, device result tensors)])
    — three tensors a launch, four for the function_score script variant
    (its `bad` flags)."""

    kind = "dense"
    __slots__ = ("idx", "seg_work")

    def __init__(self, idx: list):
        self.idx = idx
        self.seg_work: list = []

    def tensors(self) -> list:
        return [t for (_seg, _base, _doc_pad, launches) in self.seg_work
                for (_sub, r) in launches for t in r]

    def collect(self, flat, k: int) -> list[TopDocs | None]:
        """The host merge over the pulled results: per segment its chunks
        into [Q, k] (the -inf slots of a top-k dropped), then the
        cross-segment top-k; None for a query a script flagged bad, which
        the host scorer serves (`host_reruns`)."""
        Q = len(self.idx)
        totals = np.zeros(Q, dtype=np.int64)
        seg_hits = []
        host = set()
        for (seg, base, doc_pad, launches) in self.seg_work:
            scores = docs = None
            tq = np.zeros(Q, dtype=np.int64)
            for (sub, r) in launches:
                ts, td, tt = next(flat), next(flat), next(flat)
                if len(r) == 4:
                    host.update(sub[np.nonzero(next(flat))[0]].tolist())
                if scores is None:
                    scores = np.full((Q, ts.shape[1]), -np.inf, np.float32)
                    docs = np.full((Q, ts.shape[1]), doc_pad, np.int32)
                scores[sub], docs[sub], tq[sub] = ts, td, tt
            totals += tq
            seg_hits.append(_seg_hits(scores, docs, seg, base, doc_pad))
        merged = _merge_seg_hits(seg_hits, totals, Q, k)
        return [None if qi in host else td for qi, td in enumerate(merged)]


class _PendingFlat:
    """Device work in flight for one batch: every launch of its plans, in
    `parts` (a _PlainPart and a _DensePart a family), and the batch's
    device→host copies enqueued behind them (`pull`, a cudaenv.PendingPull).
    merge() waits for those copies — the batch's one wait — and merges the
    top-k on the host, stamping the wait's host clocks in pull_t0 /
    pull_t1."""

    __slots__ = ("Q", "k", "parts", "index", "pull", "pull_t0", "pull_t1")

    def __init__(self, Q: int, k: int, parts: list, index: str | None = None):
        self.Q = Q
        self.k = k
        self.parts = parts
        self.index = index  # the owning index: the pull's fault domain
        self.pull = pull_async(self.tensors())
        self.pull_t0: float | None = None
        self.pull_t1: float | None = None

    def tensors(self) -> list:
        """Every result tensor of the batch, in the order the merge reads
        them."""
        return [t for part in self.parts for t in part.tensors()]

    def sync(self) -> None:
        """Wait until the batch's launches and copies are done, without
        taking the arrays: `ESTPU_TRACE_SYNC=1` only (search/batcher.py);
        the serving path's one wait is merge()'s."""
        self.pull.synchronize()

    def merge(self) -> list[TopDocs | None]:
        """ONE wait — on the event recorded after this batch's own copies —
        drains every launch of the batch, then each part's pure-host
        cross-segment top-k merge. A query the dense family hands back to
        the host scorer (a script's `bad` flag, HOST_RERUN) merges to None:
        its caller serves it (`host_reruns`), not the merging thread."""
        self.pull_t0 = time.monotonic()
        flat = iter(wait_pull(self.pull, self.index))
        self.pull_t1 = time.monotonic()
        out: list[TopDocs | None] = [None] * self.Q
        for part in self.parts:
            for i, td in zip(part.idx, part.collect(flat, self.k)):
                out[i] = td
        return out


def _seg_hits(scores, docs, seg, base: int, doc_pad: int):
    """One segment's [Q, k] top-k with its padding and past-the-end slots
    at -inf, its docs made global (the sentinel 2**62 sorts last)."""
    valid = (docs < min(doc_pad, seg.doc_count)) & np.isfinite(scores)
    gdocs = np.where(valid, docs.astype(np.int64) + base, np.int64(2**62))
    return np.where(valid, scores, -np.inf), gdocs


def _launch_flat_plain(plans: list[FlatPlan], ctx: ShardContext,
                       k: int) -> list:
    """Plan + launch a batch of plain flat plans across every segment
    without any device→host synchronisation; returns the per-segment work
    (seg, base, doc_pad, sparse launches, dense overflow launches)."""
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

    prof = _profile.current()
    seg_work = []
    for seg, base in zip(ctx.searcher.segments, ctx.searcher.bases):
        t_seg = time.monotonic() if prof is not None else 0.0
        packed = packed_for(seg, ctx.device, breaker=ctx.breaker("fielddata"),
                            owner=ctx.index_name)
        # a 1 KB/field LUT swap when stats moved, never a postings re-bake
        sim = ensure_sim_tables(packed, sim_tables)
        clause_lists = []
        blocks_scanned = postings_scanned = 0
        for (resolved, _f, _c, _coord) in finals:
            cl = []
            for (f, t, w, _fi, g, mode, df) in resolved:
                tid = seg.term_id(f, t)
                if tid is None:
                    continue
                b0, b1 = packed.blocks_for_term(tid)
                cl.append((b0, b1, w, g, mode == MODE_CONST, sim.fid[f]))
                if prof is not None:
                    blocks_scanned += b1 - b0
                    postings_scanned += int(seg.post_offsets[tid + 1]
                                            - seg.post_offsets[tid])
            clause_lists.append(cl)
        # the compile-family seams: a launch's failure is tagged with its
        # family's fault domain (a kernel fault itself surfaces at the pull)
        with _domain_seam("compile:sparse"):
            launches, overflow = launch_flat_sparse(
                packed, clause_lists, n_must, msm, coord_tbl, k, simple=simple,
                breaker=ctx.breaker("request"), sim=sim)
        dense = None
        if overflow:
            with _domain_seam("compile:dense"):
                dense = _launch_dense_fallback(
                    overflow, finals, field_idx, all_fields, caches_stack,
                    n_must, msm, coord_tbl, packed, seg, k,
                    breaker=ctx.breaker("fielddata"))
        seg_work.append((seg, base, packed.doc_pad, launches, dense))
        if prof is not None:
            # the hand-written kernel on the card; its plain version on the
            # CPU. plane_bytes: the blocks' bytes in the device planes
            # (blk_docs i32, blk_tf u8, blk_nb u8: 6 B a slot)
            prof.segment(
                seg.gen, docs=int(seg.doc_count),
                path=("sparse_fused" if packed.device.type == "cuda"
                      else "sparse_composed"),
                tf_layout=packed.tf_layout,
                blocks_scanned=int(blocks_scanned),
                postings_scanned=int(postings_scanned),
                staged_bytes=sum(SparseScratchPool.staging_bytes(*sb.staging.key)
                                 for (sb, _r) in launches),
                plane_bytes=int(blocks_scanned) * BLOCK * 6,
                buckets=len(launches),
                dense_overflow=len(overflow),
                ms=(time.monotonic() - t_seg) * 1000.0)
    return seg_work


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


def _dense_entries(finals, seg, packed, field_idx) -> tuple:
    """The (qidx, block_row, weight, fidx, group, mode, slot) columns of the
    dense program's triples, qidx = position in `finals`: per query, per
    clause, per block of the clause's term, in that order (the host
    scorer's clause order, which the scatter-add keeps); slot = the
    clause's ordinal among its query's clauses with blocks."""
    rows = []  # (qi, b0, nblocks, w, fidx, group, mode, slot) per clause with blocks
    for qi, (resolved, _f, _c, _coord) in enumerate(finals):
        slot = 0
        for (f, t, w, _fi, g, mode, df) in resolved:
            tid = seg.term_id(f, t)
            if tid is None:
                continue
            b0, b1 = packed.blocks_for_term(tid)
            if b1 > b0:
                rows.append((qi, b0, b1 - b0, w, field_idx[f], g, mode, slot))
                slot += 1
    if not rows:
        return tuple(np.zeros(0, dt) for dt in
                     (np.int32, np.int32, np.float64, np.int32, np.int32, np.int32,
                      np.int32))
    qi, b0, nb, w, fi, g, mode, slot = (np.asarray(c) for c in zip(*rows))
    nb = nb.astype(np.int64)
    return (np.repeat(qi, nb), expand_ranges(b0, nb),
            np.repeat(w.astype(np.float64), nb), np.repeat(fi, nb),
            np.repeat(g, nb), np.repeat(mode, nb), np.repeat(slot, nb))


def _ensure_norm_rows(packed, all_fields, breaker=None):
    """Dense-launch prologue (every dense family goes through here): fault
    in the lazy f32 freqs plane, its bytes on the fielddata `breaker`, and
    give a queried field this segment never indexed an all-zero norm row."""
    ensure_blk_freqs(packed, breaker)
    for f in all_fields:
        if f not in packed.norm_bytes:
            packed.norm_bytes[f] = packed.live_parent.new_zeros(
                packed.doc_pad, dtype=packed.blk_nb.dtype)


def _launch_dense_fallback(overflow, finals, field_idx, all_fields,
                           caches_stack, n_must, msm, coord_tbl, packed, seg,
                           k, breaker=None) -> list:
    """Launch the overflow queries (block count past tb_max) on the dense
    program without synchronising, in chunks that keep its [Q, doc_pad+1]
    temporaries within budget. Returns [(query indices, device result
    triple)] for the merge half."""
    _ensure_norm_rows(packed, all_fields, breaker)
    out = []
    step = dense_chunk(packed.doc_pad)
    for start in range(0, len(overflow), step):
        chunk = overflow[start: start + step]
        cols = _dense_entries([finals[qi] for qi in chunk], seg, packed,
                              field_idx)
        if not len(cols[0]):
            continue
        sub = np.asarray(chunk, dtype=np.int64)
        batch = build_term_batch(cols, len(chunk), n_must[sub], msm[sub],
                                 coord_tbl[sub], list(all_fields), caches_stack,
                                 nb_pad_row=packed.blk_docs.shape[0] - 1)
        out.append((sub, timed_launch(score_term_batch_async, packed, batch, k)))
    return out


# ---------------------------------------------------------------------------
# the dense request-feature family: filtered and function_score plans
# ---------------------------------------------------------------------------

_FS_CHUNK = 256  # the widest dense-family launch: the JAX package's bound


def _dense_step(doc_pad: int) -> int:
    """Queries per dense-family launch: within DENSE_BUDGET_BYTES and never
    wider than _FS_CHUNK."""
    return min(dense_chunk(doc_pad), _FS_CHUNK)


def _dense_segments(plans: list[FlatPlan], ctx: ShardContext):
    """The per-batch planning of a dense part: finalized plans, the stacked
    tables, and per segment (seg, base, packed) with the dense prologue
    run, and a function that builds one chunk's TermBatch."""
    finals = [finalize_flat(p, ctx) for p in plans]
    (all_fields, field_idx, _cache_rows, caches_stack,
     coord_tbl, n_must, msm) = _assemble_batch(plans, finals)

    def chunk_batch(sub, seg, packed):
        cols = _dense_entries([finals[i] for i in sub], seg, packed, field_idx)
        _prof_blocks(seg, cols)
        return build_term_batch(cols, len(sub), n_must[sub], msm[sub],
                                coord_tbl[sub], list(all_fields), caches_stack,
                                nb_pad_row=packed.blk_docs.shape[0] - 1)

    segs = []
    for seg, base in zip(ctx.searcher.segments, ctx.searcher.bases):
        packed = packed_for(seg, ctx.device, breaker=ctx.breaker("fielddata"),
                            owner=ctx.index_name)
        _ensure_norm_rows(packed, all_fields, ctx.breaker("fielddata"))
        segs.append((seg, base, packed))
    return segs, chunk_batch


def _chunks(Q: int, doc_pad: int):
    step = _dense_step(doc_pad)
    return [np.arange(lo, min(Q, lo + step), dtype=np.int64)
            for lo in range(0, Q, step)]


def _filter_mask_row(f: Filter, seg, packed, ctx: ShardContext):
    """A filter's bool [Dpad] mask row on one segment, on the pack's device:
    the resident row from the node's DeviceFilterCache when (segment,
    filter key) is held there (no host evaluation, no copy), else the host
    mask (`segment_mask`, the per-segment host filter cache), padded, which
    the cache may promote to residency (`maybe_store`: built outside locks,
    uploaded once, published under its leaf lock) or which goes up as a
    pinned, non-blocking copy. The mask VALUES are the same either way, so
    cached plans score bitwise as uncached ones."""
    fc = ctx.filter_cache
    key = None
    if fc is not None and fc.enabled and f.cacheable():
        key = f.key()
        row = fc.lookup(seg, key, packed.device)
        if row is not None:
            return row
    m = np.zeros(packed.doc_pad, dtype=bool)
    m[: seg.doc_count] = segment_mask(seg, f, ctx)
    row = None if key is None else fc.maybe_store(seg, key, m, packed.device)
    return row if row is not None else upload_pinned(m, packed.device)


def _fs_seg_rows(fsq, kind: str, seg, packed, ctx: ShardContext) -> tuple:
    """A function_score spec's rows on one segment, on the pack's device.
    "rows": the doc-only function values combined on the host
    (functions.combined_doc_rows — float32, bitwise the host tail's) and
    where a function applies, (None, None) for a spec without functions.
    "script": its columns' f32 rows (NaN: missing), the function's filter
    row (None: none), the parent docs a missing column makes bad, the
    parent docs. Raises ScriptError when a per-doc evaluation does."""
    from ..script import compile_script, script_vector_info
    from .functions import _column_first_value, combined_doc_rows

    D, doc_pad, dev = seg.doc_count, packed.doc_pad, packed.device

    def row(values, fill, dtype):
        out = np.full(doc_pad, fill, dtype)
        out[:D] = values
        return upload_pinned(out, dev)

    if kind == "rows":
        if not fsq.functions:
            return None, None
        g, applies = combined_doc_rows(fsq, np.zeros(D, np.float32), seg, ctx)
        return row(g, 1.0, np.float32), row(applies, False, bool)
    sf = fsq.functions[0]
    colmiss = np.zeros(D, bool)
    col_rows = []
    for f in script_vector_info(compile_script(sf.script, sf.params))[1]:
        col = _column_first_value(seg, f)
        colmiss |= np.isnan(col)
        col_rows.append(row(col.astype(np.float32), np.nan, np.float32))
    fmask_row = None if sf.filter is None else \
        row(segment_mask(seg, sf.filter, ctx), False, bool)
    return (tuple(col_rows), fmask_row, row(seg.parent_mask & colmiss, False, bool),
            row(seg.parent_mask, False, bool))


def prepare_dense(plans: list[FlatPlan], ctx: ShardContext) -> list:
    """The host half of a batch's dense-family inputs, built and uploaded
    on the calling thread — a node's search thread, before its plan joins
    the batcher — so that the dispatch half only launches. Per plan: None
    for a plain plan; a filtered plan's mask row on each segment
    (`_filter_mask_row`); a function_score plan's spec rows on each segment
    (`_fs_seg_rows`, built once for the plans of one spec); HOST_RERUN when
    building them raised ScriptError, as the JAX package then reruns the
    group on the host scorer."""
    packs = None
    by_spec: dict = {}
    preps = []
    for plan in plans:
        if plan.fs is None and plan.filt is None:
            preps.append(None)
            continue
        if packs is None:
            packs = [(seg, packed_for(seg, ctx.device, breaker=ctx.breaker("fielddata"),
                                      owner=ctx.index_name))
                     for seg in ctx.searcher.segments]
        if plan.filt is not None:
            preps.append([_filter_mask_row(plan.filt, seg, packed, ctx)
                          for seg, packed in packs])
            continue
        key = _fs_group_key(plan.fs)
        if key not in by_spec:
            try:
                by_spec[key] = [_fs_seg_rows(plan.fs, plan.fs_kind, seg, packed, ctx)
                                for seg, packed in packs]
            except ScriptError:
                by_spec[key] = HOST_RERUN
        preps.append(by_spec[key])
    return preps


def _launch_filtered(idx: list, plans: list[FlatPlan], masks: list,
                     ctx: ShardContext, k: int) -> _DensePart:
    """Launch filtered plans (a FilteredQuery's filter or a post filter as
    each plan's `filt`) on the dense filtered core, chunked per segment,
    without synchronising; `masks` holds each plan's mask rows by segment
    (`prepare_dense`), stacked here on the device. Fault domain
    `compile:filtered`."""
    part = _DensePart(idx)
    prof = _profile.current()
    with _domain_seam("compile:filtered"):
        segs, chunk_batch = _dense_segments(plans, ctx)
        for j, (seg, base, packed) in enumerate(segs):
            t_seg = time.monotonic() if prof is not None else 0.0
            launches = []
            for sub in _chunks(len(plans), packed.doc_pad):
                fmask = torch.stack([masks[i][j] for i in sub])
                launches.append((sub, timed_launch(
                    score_filtered_batch_async, packed,
                    chunk_batch(sub, seg, packed), k, fmask)))
            part.seg_work.append((seg, base, packed.doc_pad, launches))
            if prof is not None:
                _prof_dense_segment(prof, seg, packed, "dense_filtered",
                                    len(launches), t_seg)
    return part


def _fs_group_key(fsq) -> tuple:
    """function_score plans whose specs are value-identical up to the outer
    boost and min_score share launches (those two are per-query rows of the
    launch). Dataclass reprs are content reprs."""
    return (repr(fsq.functions), fsq.score_mode, fsq.boost_mode, fsq.max_boost)


def _launch_fs(idx: list, plans: list[FlatPlan], seg_rows: list,
               ctx: ShardContext, k: int) -> _DensePart:
    """Launch a group of function_score plans sharing one spec (see
    _fs_group_key) on the dense family, chunked per segment, without
    synchronising; `seg_rows` holds the spec's rows by segment
    (`prepare_dense`). "rows": the host-combined function values go in as a
    row. "script": the one `_score`-reading script runs inside the launch
    over its columns' rows; the queries it flags bad (a missing column or a
    non-finite value on a parent doc) merge to None, and their callers rerun
    them on the host scorer, which decides the errors. Fault domain
    `compile:function_score`."""
    with _domain_seam("compile:function_score"):
        return _launch_fs_group(idx, plans, seg_rows, ctx, k)


def _launch_fs_group(idx: list, plans: list[FlatPlan], seg_rows: list,
                     ctx: ShardContext, k: int) -> _DensePart:
    from ..script import compile_script, script_vector_info

    fsq = plans[0].fs
    kind = plans[0].fs_kind  # classified once at lower time
    part = _DensePart(idx)
    fboost = [p.fs.boost for p in plans]
    min_score = [p.fs.min_score for p in plans]
    if kind == "script":
        sf = fsq.functions[0]
        script = compile_script(sf.script, sf.params)
        used_fields = script_vector_info(script)[1]
    prof = _profile.current()
    segs, chunk_batch = _dense_segments(plans, ctx)
    for (seg, base, packed), rows in zip(segs, seg_rows):
        t_seg = time.monotonic() if prof is not None else 0.0
        launches = []
        for sub in _chunks(len(plans), packed.doc_pad):
            batch = chunk_batch(sub, seg, packed)
            fb = [fboost[i] for i in sub]
            ms = [min_score[i] for i in sub]
            if kind == "rows":
                r = timed_launch(
                    score_fs_rows_batch_async, packed, batch, k, rows[0],
                    rows[1], fsq.max_boost, fb, ms, fsq.boost_mode)
            else:
                r = timed_launch(
                    score_fs_script_batch_async, packed, batch, k, script,
                    used_fields, *rows, sf.weight, fsq.max_boost, fb, ms,
                    fsq.boost_mode)
            launches.append((sub, r))
        part.seg_work.append((seg, base, packed.doc_pad, launches))
        if prof is not None:
            _prof_dense_segment(prof, seg, packed, "dense_function_score",
                                len(launches), t_seg)
    return part


def dispatch_flat_batch(plans: list[FlatPlan], ctx: ShardContext, k: int,
                        preps: list | None = None) -> _PendingFlat:
    """Dispatch half of execute_flat_batch for the cross-request batcher:
    launches every family of the batch without synchronising — plain plans
    on the sparse path, filtered plans on the dense filtered core,
    function_score plans grouped by spec on the dense fs family — then
    enqueues the whole batch's device→host copies behind one event, and
    returns the pending handle whose merge() yields the per-plan TopDocs
    (None for a query its caller serves on the host scorer). `preps` are
    the plans' `prepare_dense` inputs, built here when not given; a plan
    whose input is HOST_RERUN launches nothing."""
    if preps is None:
        preps = prepare_dense(plans, ctx)
    parts = []
    plain = [i for i, p in enumerate(plans) if p.fs is None and p.filt is None]
    if plain:
        parts.append(_PlainPart(plain, _launch_flat_plain(
            [plans[i] for i in plain], ctx, k)))
    filt = [i for i, p in enumerate(plans) if p.filt is not None]
    if filt:
        parts.append(_launch_filtered(filt, [plans[i] for i in filt],
                                      [preps[i] for i in filt], ctx, k))
    groups: dict = {}
    for i, p in enumerate(plans):
        if p.fs is not None and preps[i] is not HOST_RERUN:
            groups.setdefault(_fs_group_key(p.fs), []).append(i)
    for idx in groups.values():
        parts.append(_launch_fs(idx, [plans[i] for i in idx], preps[idx[0]], ctx, k))
    return _PendingFlat(Q=len(plans), k=k, parts=parts, index=ctx.index_name)


def host_reruns(plans: list[FlatPlan], tds: list, ctx: ShardContext,
                k: int) -> list[TopDocs]:
    """A merged batch's answers, with each query the dense family handed
    back (None) served by the host scorer on the calling thread — where the
    per-doc evaluation decides, and may raise ScriptError, as the JAX
    package's rerun does."""
    return [td if td is not None else _host_search(ctx, plan.fs, k)
            for plan, td in zip(plans, tds)]


def execute_flat_batch(plans: list[FlatPlan], ctx: ShardContext,
                       k: int) -> list[TopDocs]:
    """Run a batch of flat plans: dispatch every family's launches, merge
    the per-segment top-k on the host, then serve the queries handed back
    to the host scorer.

    A profiled request (common/profile.py: it bypassed the batcher, so this
    runs on its own thread) records its dispatch, pull (the one wait) and
    merge phases from host clocks; its launches' device time is its
    DeviceClock's, read once at the end of its query phase
    (search/service.py). The unprofiled path takes the first return."""
    prof = _profile.current()
    if prof is None:
        return host_reruns(plans, dispatch_flat_batch(plans, ctx, k).merge(),
                           ctx, k)
    t0 = time.monotonic()
    pending = dispatch_flat_batch(plans, ctx, k)
    t1 = time.monotonic()
    merged = pending.merge()
    t2 = time.monotonic()
    pull_s = pending.pull_t1 - pending.pull_t0
    prof.phase_s("dispatch", t1 - t0)
    prof.phase_s("pull", pull_s)
    prof.phase_s("merge", max(t2 - t1 - pull_s, 0.0))
    return host_reruns(plans, merged, ctx, k)


# ---------------------------------------------------------------------------
# single-plan field sort and aggregations (the JAX package launches these
# from the shard's search thread, not through the batcher; so does the port)
# ---------------------------------------------------------------------------


def _single_plan_segments(plan: FlatPlan, ctx: ShardContext):
    """A single plan's finalized tables, per segment (seg, base, packed),
    and a function that builds a segment's one-query TermBatch (the dense
    prologue run)."""
    finals = [finalize_flat(plan, ctx)]
    (all_fields, field_idx, _cache_rows, caches_stack,
     coord_tbl, n_must, msm) = _assemble_batch([plan], finals)
    segs = [(seg, base, packed_for(seg, ctx.device, breaker=ctx.breaker("fielddata"),
                                   owner=ctx.index_name))
            for seg, base in zip(ctx.searcher.segments, ctx.searcher.bases)]

    def seg_batch(seg, packed):
        _ensure_norm_rows(packed, all_fields, ctx.breaker("fielddata"))
        entries = _dense_entries(finals, seg, packed, field_idx)
        _prof_blocks(seg, entries)
        return build_term_batch(entries, 1, n_must, msm, coord_tbl,
                                list(all_fields), caches_stack,
                                nb_pad_row=packed.blk_docs.shape[0] - 1)

    return segs, seg_batch


def _plan_fmask(plan: FlatPlan, seg, packed, ctx: ShardContext):
    """A plan's filter as a [1, Dpad] mask on the pack's device, or None."""
    if plan.filt is None:
        return None
    return _filter_mask_row(plan.filt, seg, packed, ctx)[None, :]


class _SortedPart:
    """One field-sorted plan's launches, a result tuple (keys, docs,
    scores, top score, totals) per segment."""

    __slots__ = ("spec", "k", "seg_work")

    def __init__(self, spec, k: int):
        self.spec = spec
        self.k = k
        self.seg_work: list = []  # (segment index, base, device results)

    def tensors(self) -> list:
        return [t for (_si, _base, r) in self.seg_work for t in r]

    def collect(self, flat):
        """(total, max_score, [(key, global doc, segment index, local doc,
        score)] in the host lexsort's order: key, then global doc)."""
        total = 0
        max_score = float("nan")
        cand = []
        for si, base, _r in self.seg_work:
            keys, docs, scores, qmax, tq = (next(flat) for _ in range(5))
            (seg_total,) = tq.tolist()
            total += seg_total
            if seg_total:
                (m,) = qmax.tolist()
                max_score = m if max_score != max_score else max(max_score, m)
            n = min(seg_total, keys.shape[1])
            cand.extend(
                (ki, base + di, si, di, sc)
                for ki, di, sc in zip(keys[0, :n].tolist(), docs[0, :n].tolist(),
                                      scores[0, :n].tolist()))
        cand.sort(key=lambda e: (-e[0] if self.spec.reverse else e[0], e[1]))
        return total, max_score, cand[: max(self.k, 0)]


def sort_key_rows(ctx: ShardContext, spec) -> list | None:
    """Each segment's host sort-key row of `spec`
    (sorting.device_sort_key_row), or None when a segment's column refuses
    one. A caller checks this before it launches anything of the request,
    so a refusal launches nothing."""
    rows = []
    for seg in ctx.searcher.segments:
        packed = packed_for(seg, ctx.device, breaker=ctx.breaker("fielddata"),
                            owner=ctx.index_name)
        row = device_sort_key_row(spec, seg, packed.doc_pad)
        if row is None:
            return None
        rows.append(row)
    return rows


def launch_flat_sorted(plan: FlatPlan, ctx: ShardContext, k: int, spec,
                       key_rows: list) -> _SortedPart:
    """Launch a single plan's field-sorted dense program on every segment
    without synchronising, ordered by `key_rows` (`sort_key_rows`). Fault
    domain `compile:sorted`."""
    part = _SortedPart(spec, k)
    prof = _profile.current()
    with _domain_seam("compile:sorted"):
        segs, seg_batch = _single_plan_segments(plan, ctx)
        for si, ((seg, base, packed), row) in enumerate(zip(segs, key_rows)):
            t_seg = time.monotonic() if prof is not None else 0.0
            part.seg_work.append((si, base, timed_launch(
                score_sorted_batch_async, packed, seg_batch(seg, packed), k,
                upload_pinned(row, packed.device), spec.reverse,
                fmask=_plan_fmask(plan, seg, packed, ctx))))
            if prof is not None:
                _prof_dense_segment(prof, seg, packed, "dense_sorted", 1, t_seg)
    return part


def execute_flat_sorted(plan: FlatPlan, ctx: ShardContext, k: int, spec):
    """Single-plan field-sorted execution: (total, max_score, ordered
    entries [(key, global doc, segment index, local doc, score)]), or None
    when a segment's column refuses device keys. One pull for the plan. The
    entry the tests hold against the JAX package's of the same name; the
    service launches through `launch_flat_sorted` and pulls a request once."""
    key_rows = sort_key_rows(ctx, spec)
    if key_rows is None:
        return None
    part = launch_flat_sorted(plan, ctx, k, spec, key_rows)
    return part.collect(iter(wait_pull(pull_async(part.tensors()), ctx.index_name)))


def _bucket_pairs_on(agg, seg, packed, ctx: ShardContext):
    """A bucket agg's (doc, bucket) pairs on one segment as device int64
    tensors and its keys: the host pairs from `bucket_cols_for`, their
    device copy cached on the pack under the same key, charged to the
    fielddata breaker while it is built."""
    pdoc, pbucket, keys = bucket_cols_for(agg, seg, ctx)
    ck = bucket_cache_key(agg)
    dev = packed.bucket_cols.get(ck)
    if dev is None:
        with reserve(ctx.breaker("fielddata"), 16 * len(pdoc), "<bucket_cols>"):
            dev = (upload(pdoc.astype(np.int64), packed.device),
                   upload(pbucket.astype(np.int64), packed.device),
                   max(len(keys), 1))
        dev = _bucket_cache_put(packed.bucket_cols, ck, dev)
    return dev, keys


class _AggPart:
    """One aggregating plan's launches: per segment the top-k, the metric
    stats and each bucket agg's counts (None entries are not pulled)."""

    __slots__ = ("k", "seg_work")

    def __init__(self, k: int):
        self.k = k
        self.seg_work: list = []  # (seg, base, doc_pad, bucket keys, results)

    @staticmethod
    def _flat(r) -> list:
        scores, docs, tq, counts, stats, buckets = r
        out = [scores, docs, tq] + ([] if counts is None else [counts, stats])
        for b in buckets:
            out.extend(t for t in b if t is not None)
        return out

    def tensors(self) -> list:
        return [t for (_s, _b, _d, _k, r) in self.seg_work for t in self._flat(r)]

    def collect(self, flat):
        """(TopDocs, per segment (counts int [F], stats f32 [F, 4], [(keys,
        bucket counts, sub counts | None, sub stats | None)]))."""
        totals = np.zeros(1, dtype=np.int64)
        seg_hits, seg_stats = [], []
        for (seg, base, doc_pad, seg_keys, r) in self.seg_work:
            scores, docs, tq = next(flat), next(flat), next(flat)
            if r[3] is None:
                counts, stats = np.zeros((1, 0), np.int32), np.zeros((1, 0, 4), np.float32)
            else:
                counts, stats = next(flat), next(flat)
            buckets = []
            for keys, (_c, sc, ss) in zip(seg_keys, r[5]):
                bc = next(flat)
                sub_c = None if sc is None else next(flat)[0]
                sub_s = None if ss is None else next(flat)[0]
                buckets.append((keys, bc[0], sub_c, sub_s))
            totals += tq
            seg_hits.append(_seg_hits(scores, docs, seg, base, doc_pad))
            seg_stats.append((counts[0], stats[0], buckets))
        return _merge_seg_hits(seg_hits, totals, 1, self.k)[0], seg_stats


def launch_flat_aggs(plan: FlatPlan, ctx: ShardContext, k: int,
                     fields: list[str], bucket_aggs=()) -> _AggPart | None:
    """Launch a single plan's dense program with its aggregations on every
    segment without synchronising: the metric stats of `fields` (numeric
    columns) and, per (bucket agg, sub-agg field order | None) of
    `bucket_aggs`, the counts over its (doc, bucket) pairs with its metric
    sub-aggs' stats. None (nothing launched) when a column, on any segment,
    is not f32-exact: the host collectors serve the request. Fault domain
    `compile:aggs`."""
    with _domain_seam("compile:aggs"):
        return _launch_aggs(plan, ctx, k, fields, bucket_aggs)


def _launch_aggs(plan: FlatPlan, ctx: ShardContext, k: int, fields: list[str],
                 bucket_aggs) -> _AggPart | None:
    segs, seg_batch = _single_plan_segments(plan, ctx)
    fd = ctx.breaker("fielddata")
    rows = []
    for seg, _base, packed in segs:
        stack = ensure_agg_rows(seg, packed, fields, breaker=fd) if fields else None
        if fields and stack is None:
            return None
        subs = []
        for _agg, sub_order in bucket_aggs:
            sub = ensure_agg_rows(seg, packed, sub_order, breaker=fd) \
                if sub_order else None
            if sub_order and sub is None:
                return None
            subs.append(sub)
        rows.append((stack, subs))
    part = _AggPart(k)
    prof = _profile.current()
    for (seg, base, packed), (stack, subs) in zip(segs, rows):
        t_seg = time.monotonic() if prof is not None else 0.0
        pairs, seg_keys = [], []
        for (agg, _order), sub in zip(bucket_aggs, subs):
            (pdoc, pbucket, nb), keys = _bucket_pairs_on(agg, seg, packed, ctx)
            pairs.append((pdoc, pbucket, nb, sub))
            seg_keys.append(keys)
        r = timed_launch(score_agg_batch_async, packed, seg_batch(seg, packed),
                         k, stack, pairs,
                         fmask=_plan_fmask(plan, seg, packed, ctx))
        part.seg_work.append((seg, base, packed.doc_pad, seg_keys, r))
        if prof is not None:
            _prof_dense_segment(prof, seg, packed, "dense_aggs", 1, t_seg)
    return part


def execute_flat_aggs(plan: FlatPlan, ctx: ShardContext, k: int,
                      fields: list[str], bucket_aggs=()):
    """Single-plan dense execution with the aggregations reduced in the
    launch: (TopDocs, per-segment (counts int [F], stats float32 [F, 4] =
    (sum, min, max, sumsq) over the matched docs, [(keys, counts, sub
    counts | None, sub stats | None)] per bucket agg)), or (None, None)
    when a column is not f32-exact. One pull for the plan. The entry the
    tests hold against the JAX package's of the same name; the service
    launches through `launch_flat_aggs` and pulls a request once."""
    part = launch_flat_aggs(plan, ctx, k, fields, bucket_aggs)
    if part is None:
        return None, None
    return part.collect(iter(wait_pull(pull_async(part.tensors()), ctx.index_name)))


# ---------------------------------------------------------------------------
# host scorer (general path)
# ---------------------------------------------------------------------------


def _idf_of(sim):
    """`sim.idf`, which the phrase and span scorers read. A freq/norm
    similarity (DFR, IB, LM) has none: the JAX package's scorer raises
    AttributeError there, which its node reports as that shard's failure.
    The port fails the shard with the same reason (a SearchEngineError, so
    the coordinator records a shard failure instead of answering 500)."""
    try:
        return sim.idf
    except AttributeError as e:
        raise SimilarityNotSupportedError(str(e)) from None


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
        if isinstance(q, FunctionScoreQuery) and q.query is not None:
            return walk(q.query, b)
        if isinstance(q, NestedQuery):
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
        elif isinstance(sim, FreqNormSimilarity):
            # freq/doc-len similarities (DFR, IB, LM*): host only
            dl = decode_norm_doclen(nb)
            ttf = sum(int(s.postings(field, term)[1].sum())
                      for s in ctx.searcher.segments
                      if s.doc_freq(field, term) > 0)
            vals = sim.score_freqs(freqs, dl, df, ttf, ctx.field_stats(field),
                                   ctx.max_doc, boost)
        else:
            idf = TFIDFSimilarity.idf(df, ctx.max_doc)
            w = np.float32(idf * idf * boost) * self.qn
            vals = w * (np.sqrt(freqs, dtype=np.float32) * cache[nb])
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

        if isinstance(q, FunctionScoreQuery):
            return self._eval_function_score(q, b)

        if isinstance(q, NestedQuery):
            mask, scores = child_match_to_parents(
                seg, ctx, q.path, q.query, score_mode=q.score_mode,
                query_norm=float(self.qn))
            return (scores * np.float32(b)).astype(np.float32), mask

        if isinstance(q, (HasChildQuery, HasParentQuery)):
            # the join is shard-wide (_shard_join, when the query is the
            # whole query); inside another query it matches nothing, as in
            # the JAX package
            return np.zeros(self.D, np.float32), np.zeros(self.D, bool)

        if isinstance(q, IndicesQuery):
            # the query on the named indices, no_match_query elsewhere
            # (match_all by default, nothing for "none"); an unwired
            # context's index (None) counts as a match. lower_flat takes
            # no indices query: it always runs here, as in the JAX package,
            # whose boost applies twice (in `b` and again below), kept
            name = ctx.index_name
            if name is None or any(fnmatch.fnmatch(name, p) for p in q.indices or []):
                return self.eval(q.query, b * q.boost)
            if q.no_match_none:
                return np.zeros(self.D, np.float32), np.zeros(self.D, bool)
            return self.eval(q.no_match_query or MatchAllQuery(), b * q.boost)

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
        idf = _idf_of(sim)
        idf_sum = np.float32(sum(
            float(idf(ctx.doc_freq(f, t), ctx.max_doc))
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
        sim = ctx.similarity_for(q.field)
        idf = _idf_of(sim)
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
        norms = seg.norms.get(q.field)
        cache = sim.norm_cache(ctx.field_stats(q.field), ctx.max_doc)
        idf_sum = np.float32(sum(
            float(idf(ctx.doc_freq(q.field, t), ctx.max_doc))
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

    # -- function score ------------------------------------------------------
    def _eval_function_score(self, q: FunctionScoreQuery, boost: float):
        from .functions import apply_functions

        if q.query is not None:
            sub_scores, match = self.eval(q.query, 1.0)
        elif q.filter is not None:
            sub_scores, match = self._const(self._mask(q.filter), 1.0)
        else:
            sub_scores, match = self._const(np.ones(self.D, bool), 1.0)
        scores = apply_functions(q, sub_scores, match, self.seg, self.ctx)
        scores = (scores * np.float32(boost)).astype(np.float32)
        if q.min_score is not None:
            match = match & (scores >= np.float32(q.min_score))
        return scores, match


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


# ---------------------------------------------------------------------------
# nested and parent/child joins
# ---------------------------------------------------------------------------


def _parent_of_map(seg: FrozenSegment) -> np.ndarray:
    """Per doc, the local id of its block's parent (a parent maps to itself;
    a trailing run of children with no parent to -1), cached on the
    segment."""
    cache = seg._device_cache
    pm = cache.get("parent_of")
    if pm is None:
        pm = np.zeros(seg.doc_count, dtype=np.int64)
        parent = -1
        for local in range(seg.doc_count - 1, -1, -1):
            if seg.parent_mask[local]:
                parent = local
            pm[local] = parent
        cache["parent_of"] = pm
    return pm


def child_match_to_parents(seg: FrozenSegment, ctx: ShardContext, path: str, inner,
                           score_mode: str = "none", query_norm: float = 1.0):
    """Block join: evaluate `inner` (a Query or a Filter) over the nested
    children of `path` and gather to their parents: (parent mask, parent
    scores by `score_mode`: avg, sum / total, max, or 1.0 for none). The
    children's liveness is not read: a dead parent's block is dead with it."""
    child_sel = np.asarray([p == path for p in seg.require(
        "nested_paths", "nested queries")], dtype=bool)
    if isinstance(inner, Filter):
        cmask = segment_mask(seg, inner, ctx)
        cscores = cmask.astype(np.float32)
    else:
        cscores, cmask = HostScorer(ctx, seg, query_norm).eval(inner)
    cmask = cmask & child_sel
    parents = _parent_of_map(seg)
    pmask = np.zeros(seg.doc_count, dtype=bool)
    pscores = np.zeros(seg.doc_count, dtype=np.float32)
    pcounts = np.zeros(seg.doc_count, dtype=np.int32)
    idx = np.nonzero(cmask)[0]
    if len(idx):
        pidx = parents[idx]
        valid = pidx >= 0
        idx, pidx = idx[valid], pidx[valid]
        pmask[pidx] = True
        if score_mode in ("sum", "avg", "total"):
            np.add.at(pscores, pidx, cscores[idx])
            np.add.at(pcounts, pidx, 1)
            if score_mode == "avg":
                nz = pcounts > 0
                pscores[nz] = pscores[nz] / pcounts[nz]
        elif score_mode == "max":
            np.maximum.at(pscores, pidx, cscores[idx])
        else:
            pscores[pidx] = 1.0
    return pmask, pscores


def _shard_join(ctx: ShardContext, q: Query):
    """The cross-segment parent/child join: per-segment (scores, match) for
    a has_child / has_parent query, else None.

    has_child gathers the matching docs of `child_type` to their `_parent`
    ids over every segment (scores summed, or maxed for `max`) and matches
    the top-level docs with those ids; has_parent matches the docs whose
    `_parent` names a matching doc of `parent_type`. As in the JAX package,
    the inner query's matches are not gated on liveness (a deleted child
    still selects its parent until a merge drops it), and the scores are
    the inner query's without a query norm."""
    if not isinstance(q, (HasChildQuery, HasParentQuery)):
        return None
    out = []
    segments = ctx.searcher.segments
    if isinstance(q, HasChildQuery):
        parent_ids: dict[str, float] = {}
        for seg in segments:
            s, m = HostScorer(ctx, seg, 1.0).eval(q.query)
            types = seg.require("types", "parent/child joins")
            m = m & np.asarray([t == q.child_type for t in types], dtype=bool)
            locs = np.nonzero(m)[0]
            for local, sval in zip(locs.tolist(), s[locs].tolist()):
                pid = (seg.str_values("_parent", local) or [None])[0]
                if pid is None:
                    continue
                prev = parent_ids.get(pid, 0.0)
                parent_ids[pid] = max(prev, sval) if q.score_mode == "max" \
                    else prev + sval
        for seg in segments:
            match = np.zeros(seg.doc_count, bool)
            scores = np.zeros(seg.doc_count, np.float32)
            for local in range(seg.doc_count):
                if seg.parent_mask[local] and seg.ids[local] in parent_ids:
                    match[local] = True
                    scores[local] = parent_ids[seg.ids[local]] \
                        if q.score_mode != "none" else 1.0
            out.append((scores * np.float32(q.boost), match))
        return out
    matched_parents: dict[str, float] = {}
    for seg in segments:
        s, m = HostScorer(ctx, seg, 1.0).eval(q.query)
        types = seg.require("types", "parent/child joins")
        m = m & np.asarray([t == q.parent_type for t in types], dtype=bool)
        locs = np.nonzero(m)[0]
        for local, sval in zip(locs.tolist(), s[locs].tolist()):
            matched_parents[str(seg.ids[local])] = sval
    for seg in segments:
        match = np.zeros(seg.doc_count, bool)
        scores = np.zeros(seg.doc_count, np.float32)
        for local in range(seg.doc_count):
            pid = (seg.str_values("_parent", local) or [None])[0]
            if pid is not None and pid in matched_parents:
                match[local] = True
                scores[local] = matched_parents[pid] if q.score_mode != "none" else 1.0
        out.append((scores * np.float32(q.boost), match))
    return out


def host_match_mask(query: Query, seg: FrozenSegment, ctx: ShardContext) -> np.ndarray:
    _, match = HostScorer(ctx, seg).eval(query)
    return match


def iter_match_masks(ctx: ShardContext, query: Query):
    """Lazily yield per-segment (scores, match over live, parent docs): a
    deadline-aware caller (`_host_search`, the general host path of
    execute_query_phase) stops between segments and keeps the segments
    already scored as a partial result. A has_child / has_parent query
    reads its segments' slices of the shard-wide join (`_shard_join`)."""
    qn = query_norm_for(query, ctx)
    join = _shard_join(ctx, query)
    for si, seg in enumerate(ctx.searcher.segments):
        if join is not None:
            scores, match = join[si]
        else:
            scores, match = HostScorer(ctx, seg, qn).eval(query)
        yield scores, match & seg.live & seg.parent_mask


# ---------------------------------------------------------------------------
# shard-level entry points
# ---------------------------------------------------------------------------


def dispatch_shard_batch(ctx: ShardContext, queries: list[Query],
                         k: int) -> _PendingFlat:
    """The dispatch half of `search_shard_batch` for a batch of lowerable
    queries: plans and launches it with no device→host synchronisation;
    `.merge()` on the result performs the batch's one pull and returns the
    per-query TopDocs (None for a query handed back to the host scorer:
    `host_reruns`). A query that does not lower raises: the host scorer
    has no dispatch half."""
    plans = []
    for q in queries:
        plan = lower_flat(q, ctx)
        if plan is None:
            raise QueryParsingError(
                f"[{type(q).__name__}] does not lower to a flat device plan; "
                "search_shard_batch serves it on the host scorer")
        plans.append(plan)
    return dispatch_flat_batch(plans, ctx, k)


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
                 deadline=None) -> TopDocs:
    """The host scorer's top-k over the searcher's segments
    (`iter_match_masks`), stopping between segments at the deadline."""
    all_scores: list[np.ndarray] = []
    all_docs: list[np.ndarray] = []
    total = 0
    timed_out = False
    masks = iter_match_masks(ctx, query)
    prof = _profile.current()
    for seg, base in zip(ctx.searcher.segments, ctx.searcher.bases):
        # host-side segment boundary: expiry keeps the segments already scored
        if deadline is not None and deadline.expired():
            timed_out = True
            break
        t_seg = time.monotonic() if prof is not None else 0.0
        scores, match = next(masks)
        if prof is not None:
            prof.segment(seg.gen, docs=int(seg.doc_count), path="host",
                         ms=(time.monotonic() - t_seg) * 1000.0)
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
