"""The shard's request entry: a search body → the query phase, on the card
or on the host scorer — a port of the JAX package's `search/service.py`
(`parse_search_body`, `ShardQueryResult`, `SERVING_COUNTERS`,
`_execute_flat_single`, `execute_query_phase`, `reduce_and_respond`).

A body may carry `query` (none: match_all), `from`, `size`, `timeout`,
`post_filter` (and the top-level `filter`, its older name), `min_score`,
`sort`, `track_scores`, `aggs` (or `aggregations`), `facets`, `rescore`,
`suggest`, `explain`, `request_cache` (read by the shard's request cache,
actions.py), `profile` (the shard's query phase runs under a
ProfileCollector, common/profile.py) and the keys the fetch phase reads
(`execute_fetch_phase`, fetch.py): `_source`, `fields`, `stored_fields`,
`script_fields`, `version` and `highlight`. Any other key raises
QueryParsingError rather than being silently ignored.

`execute_query_phase` takes the JAX package's branches (its
`search/service.py` :290-603). The body's suggesters run first
(`run_suggest`, on the host), and their output rides the shard's result
on every branch, a degraded one included. Then:

- a body with no mask-needing feature lowers to a flat plan (a plain,
  `filtered` or `function_score` one) and runs on the card through the
  batcher, or, when it does not lower, on the host scorer (`_host_search`);
- aggregations alone (every one device-eligible, the query lowering without
  functions): one aggregating launch a segment (`_try_device_aggs`,
  counted `device_aggs`);
- `explain: true` keeps a body off the branches below (they read
  `req.explain` in the JAX package); a body with no mask-needing feature
  stays on the flat plan, as there;
- a `min_score` body without a post filter (nor aggs or sort) wraps its
  query in a `FunctionScoreQuery(min_score=)`: the dense function family's
  gate serves it on the card (counted `device_filtered`, as the JAX package
  counts it);
- a `post_filter` body without `min_score` or sort whose query lowers to a
  plan without functions runs on the dense filtered family, the post
  filter (and the query's own filter) gating the hits; its aggregations,
  when it has any, reduce over the query's own matches in a second launch
  (`_try_device_post_filter`; `device_filtered`);
- a sort on one numeric field (with device-eligible aggs or none): the
  field-sorted launch orders the hits (`_try_device_sort`, `device_sort`);
- every gated body (post filter, `min_score`, sort, aggregations, facets,
  rescore) that no device branch serves runs the general host path:
  per-segment score and match arrays, the gates, the sort keys, the
  rescore of the top window (`_apply_rescore`, the JAX package's
  QueryRescorer), the host collectors of the aggregations and facets,
  under a request-breaker reservation of `max_doc * (5 + 16 * (aggs +
  facets))` bytes. A body with `rescore` never takes a device branch, nor
  does a gated body with `explain`.

A plain, filtered or function_score plan goes through the shard's batcher
when one is wired, so a node's plans share its batches, except under the
DFS phase's global statistics (`ctx.global_stats`): the batcher coalesces
plans by segment view and k only, and a batch launches with its leader's
context, so such a plan launches directly from its calling thread
(`DeviceBatcher.note_direct` counts it). The sorted and
aggregating launches are single plans from the calling thread, as in the
JAX package, and every device launch of one request is pulled behind one
event (`cudaenv.pull_async`).

Device fault domains (common/devicehealth), as in the JAX package's
`search/service.py` :166-233 and :321-500: every device branch first asks
whether one of its domains is open (`_blocked_domain`: `pack:<index>`, the
`compile:<family>` domains of the families it may launch, `pull:<index>`;
one attribute read while every domain is closed). An open domain, a
failure of the card (a transient or persistent CUDA error; through the
batcher's future when the request was coalesced: the batcher replays a
failed batch member by member, so only the poisoned member fails) or a
fielddata breaker trip while packing degrades the request to the host
path: the host scorer or the general host path answers, the result is
marked `degraded` (`_shards.degraded` at the coordinator),
`SERVING_COUNTERS["degraded"]` counts it, and a CUDA error advances its
domain's circuit (`_device_failed`). The degraded path makes no CUDA call,
so it answers after a sticky error too. A request or parent breaker trip
stays a 429 and a SearchEngineError (a script or parsing error) stays the
answer. A defect of the port's own launches (a launch-configuration code,
an unexpected code from a kernel wrapper) and an exception that is not a
CUDA error (a host bug) are counted in `device_errors`, move no circuit
and reach the caller as a 500: serving them from the host would hide a
program fault behind the card (the JAX package degrades any exception).

`SearchAdmissionController` is the coordinator's admission control (the JAX
package's, copied): a search whose remaining budget cannot cover one
expected shard phase answers 429 before the fan-out.

Profiles and insights, as in the JAX package's `search/service.py`
:156-290: the serving path a request resolves to is recorded on its
ProfileCollector (`outcome`) and insights Observation once; a device
failure or an open domain records its fallback reason; a profiled request
records its lowering time and plan (or why it does not lower), launches
its plan from its own thread (`batcher: {bypassed, reason: "profile"}`,
the batcher's `profile_bypassed`), and its launches' device time is read
from its DeviceClock once, at the end of its query phase.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field as dc_field

import numpy as np

from ..common import insights as _insights
from ..common import profile as _profile
from ..common.breaker import reserve as breaker_reserve
from ..common.cudaenv import pull_async
from ..common.deadline import NO_DEADLINE, Deadline, parse_timevalue
from ..common.devicehealth import DEGRADABLE, DEVICE_HEALTH, classify_device_error
from ..common.errors import (
    BodyValueError,
    CircuitBreakingError,
    QueryParsingError,
    RejectedExecutionError,
    SearchEngineError,
    body_value,
)
from ..common.metrics import CounterMetric, HistogramMetric, MeanMetric
from ..common.logging import get_logger
from .aggregations import (
    device_agg_field,
    device_bucket_eligible,
    device_bucket_partial,
    device_bucket_subs,
    device_partial,
    facet_response,
    parse_aggs,
    parse_facets,
    reduce_aggs,
)
from .execute import (
    HostScorer,
    ShardContext,
    TopDocs,
    _host_search,
    _launch_filtered,
    execute_flat_batch,
    iter_match_masks,
    launch_flat_aggs,
    launch_flat_sorted,
    lower_fallback_reason,
    lower_flat,
    plan_profile,
    prepare_dense,
    query_norm_for,
    sort_key_rows,
    wait_pull,
)
from .fetch import build_hit
from .filters import BoolFilter, Filter, segment_mask
from .queries import (
    FunctionScoreQuery,
    MatchAllQuery,
    Query,
    parse_filter,
    parse_query,
)
from .sorting import (
    apply_missing,
    parse_sort,
    sort_key_column,
    sort_values_for_docs,
)
from .suggest import run_suggest

# the body keys the port serves; any other raises
_SERVED_KEYS = ("query", "from", "size", "timeout", "_source", "post_filter",
                "filter", "min_score", "sort", "aggs", "aggregations", "facets",
                "track_scores", "rescore", "request_cache", "suggest", "explain",
                "highlight", "fields", "stored_fields", "script_fields", "version",
                "profile")


@dataclass
class ParsedSearchRequest:
    query: Query
    post_filter: Filter | None
    from_: int
    size: int
    sort: list  # list[SortSpec]
    aggs: dict
    facets: dict
    min_score: float | None
    body: dict
    track_scores: bool = False
    # the request-body `timeout` in seconds (None: no budget)
    timeout_s: float | None = None
    # the `rescore` specs, in order (a single object reads as a list of one)
    rescore: list = dc_field(default_factory=list)
    # the body's `suggest` section (None: no suggester)
    suggest: dict | None = None
    explain: bool = False
    # `"profile": true` / `?profile=true`: the shard's query phase runs under
    # a ProfileCollector (common/profile.py)
    profile: bool = False


def parse_search_body(body: dict | None) -> ParsedSearchRequest:
    body = body or {}
    unknown = sorted(k for k in body if k not in _SERVED_KEYS)
    if unknown:
        raise QueryParsingError(f"search body key(s) {unknown} are not served")
    try:
        timeout_s = parse_timevalue(body.get("timeout"))
    except ValueError as e:
        raise QueryParsingError(str(e)) from None  # malformed timeout is a 400
    query = parse_query(body.get("query")) if body.get("query") else MatchAllQuery()
    # the top-level "filter" is the post filter (it gates hits, not
    # aggregations or facets)
    post_filter = parse_filter(body["filter"]) if body.get("filter") else \
        parse_filter(body["post_filter"]) if body.get("post_filter") else None
    rescore = body.get("rescore") or []
    if isinstance(rescore, dict):
        rescore = [rescore]
    return ParsedSearchRequest(
        query=query,
        post_filter=post_filter,
        from_=int(body.get("from", 0)),
        size=int(body.get("size", 10)),
        sort=parse_sort(body.get("sort")),
        aggs=parse_aggs(body.get("aggs") or body.get("aggregations") or {}),
        facets=parse_facets(body.get("facets") or {}),
        min_score=body.get("min_score"),
        body=body,
        track_scores=bool(body.get("track_scores", False)),
        timeout_s=timeout_s,
        rescore=rescore,
        suggest=body.get("suggest"),
        explain=bool(body.get("explain", False)),
        profile=bool(body.get("profile", False)),
    )


@dataclass
class ShardQueryResult:
    """Query-phase output for ONE shard: what travels back to the
    coordinating node before the reduce."""

    total: int
    # [(score, global_doc, sort_values|None)] — length ≤ from+size
    docs: list
    max_score: float
    agg_partials: list = dc_field(default_factory=list)  # one dict a segment
    facet_partials: list = dc_field(default_factory=list)
    shard_id: int = 0
    # the deadline expired before any segment was scored, or between two
    # segments on the host scorer (the hits cover the segments scored)
    timed_out: bool = False
    # the pinned query-time context the fetch phase reads (actions.py)
    context_id: int | None = None
    # served on the host path because a device fault domain was open or the
    # device attempt failed (`_shards.degraded` counts such shards)
    degraded: bool = False
    # the shard's suggester output, {name: entries} (None: no suggester)
    suggest: dict | None = None
    # the shard's query-phase profile (plain scalars; None: unprofiled)
    profile: dict | None = None


# process-wide serving counters of the port (its own singleton: a process
# that runs both packages counts each package's serving apart)
SERVING_COUNTERS = {
    "device_sparse": 0,  # flat top-k served on the card's sparse path
    "device_function_score": 0,  # a function_score plan on the dense family
    "device_filtered": 0,  # filtered, post_filter or min_score on the dense family
    "device_aggs": 0,  # aggregations reduced in the dense launch
    "device_sort": 0,  # field-sorted launch (with or without aggregations)
    "device_percolate": 0,  # batched percolation launches (percolator.py)
    "device_percolate_fallbacks": 0,  # a percolation's batch served by the host loop
    "device_errors": 0,  # a device attempt raised (degraded, or a host bug raised)
    "degraded": 0,  # served on the host path on a device failure or an open domain
    "host": 0,  # served by the host scorer
}
_COUNTERS_LOCK = threading.Lock()
_device_error_logged: set = set()


def _bump(name: str):
    with _COUNTERS_LOCK:
        SERVING_COUNTERS[name] += 1


def _count(path: str):
    """The serving path a query phase resolved to: its counter, and the
    request's profile outcome and insights outcome (each written once)."""
    _bump(path)
    prof = _profile.current()
    if prof is not None:
        prof.outcome(path)
    obs = _insights.current()
    if obs is not None and obs.outcome is None:
        obs.outcome = path


def _device_failed(e: BaseException, ctx: ShardContext) -> None:
    """A device attempt failed on the card or with a fielddata breaker trip:
    the search still answers on the host path. Counts it, advances the
    domain the raiser tagged (untagged errors attribute to the index's
    `pull:` domain, as in the JAX package; a trip is no CUDA error and moves
    no circuit) and logs each error type once."""
    with _COUNTERS_LOCK:
        SERVING_COUNTERS["device_errors"] += 1
        SERVING_COUNTERS["degraded"] += 1
    domain = getattr(e, "_estpu_device_domain", None) or f"pull:{ctx.index_name}"
    DEVICE_HEALTH.record_failure(domain, e)
    prof = _profile.current()
    if prof is not None:
        prof.event("device_error", error=type(e).__name__)
        prof.fallback(f"device_error:{type(e).__name__}")
    key = type(e).__name__
    if key not in _device_error_logged:
        _device_error_logged.add(key)
        get_logger("search.device").warning(
            f"device serving failed ({key}: {e}); the host scorer answers "
            "(logged once per error type)")


def _domains_for(ctx: ShardContext, families: tuple) -> tuple:
    """The fault domains one device attempt on this shard exercises: the
    index's pack and pull domains and each compile family it may launch."""
    idx = str(ctx.index_name)
    return (f"pack:{idx}",) + tuple(f"compile:{f}" for f in families) \
        + (f"pull:{idx}",)


def _blocked_domain(ctx: ShardContext, families: tuple,
                    domains: tuple | None = None) -> str | None:
    """The open fault domain that sends this request to the host path
    before any launch, or None (all closed, or this caller was admitted as
    the probe). One plain attribute read when every domain is closed.
    `domains` replaces the shard's domains of `families`."""
    if not DEVICE_HEALTH.any_open:
        return None
    return DEVICE_HEALTH.blocked(domains or _domains_for(ctx, families))


def _device_degraded(domain: str) -> None:
    """An open fault domain skipped the device path: count and profile the
    degrade."""
    _bump("degraded")
    prof = _profile.current()
    if prof is not None:
        prof.event("device_degraded", domain=domain)
        prof.fallback(f"device_degraded:{domain}")


def _note_device_ok(ctx: ShardContext, families: tuple,
                    domains: tuple | None = None) -> None:
    """A clean device outcome: closes a half-open domain this request just
    probed (one attribute read when no device failure was ever recorded)."""
    if DEVICE_HEALTH.dirty:
        DEVICE_HEALTH.note_success(domains or _domains_for(ctx, families))


def _execute_flat_single(ctx: ShardContext, plan, k: int,
                         deadline: Deadline) -> TopDocs:
    """One plan's device execution — through the shard's cross-request
    DeviceBatcher when one is wired (coalescing with concurrent searches
    into one bucketed launch; search/batcher.py), else a direct single-plan
    launch. A plan under the DFS phase's global statistics always launches
    directly: its clause weights and similarity tables are its own, and a
    shared batch launches with its leader's context.

    A profiled request launches directly too (`batcher: {bypassed, reason:
    "profile"}`): a coalesced batch's device phases belong to the batch,
    and the profile's device clock must time its own launches alone."""
    if ctx.batcher is not None:
        if ctx.global_stats:
            ctx.batcher.note_direct()
        else:
            prof = _profile.current()
            if prof is None:
                return ctx.batcher.execute(plan, ctx, k, deadline=deadline)
            prof.batcher_bypass("profile")
            ctx.batcher.note_profile_bypass()
    return execute_flat_batch([plan], ctx, k)[0]


def _prof_record_plan(prof, plan, req: ParsedSearchRequest, ctx: ShardContext,
                      use_device: bool) -> None:
    """Record the resolved plan shape, or the fallback reason when the
    query does not lower flat (profiled requests only)."""
    if plan is not None:
        prof.set_plan(plan_profile(plan, req.query))
    else:
        prof.set_plan({"query_type": type(req.query).__name__})
        prof.fallback("device_disabled" if not use_device
                      else lower_fallback_reason(req.query, ctx))


def _prof_host_features(prof, req: ParsedSearchRequest) -> None:
    """The general host path serves the body's mask-needing features:
    record which (a lowering reason recorded first wins)."""
    feats = [name for name, present in (
        ("aggs", bool(req.aggs)), ("facets", bool(req.facets)),
        ("sort", bool(req.sort)), ("post_filter", req.post_filter is not None),
        ("rescore", bool(req.rescore)),
        ("min_score", req.min_score is not None), ("explain", req.explain),
    ) if present]
    if feats:
        prof.fallback("features:" + ",".join(feats))


def execute_query_phase(ctx: ShardContext, req: ParsedSearchRequest,
                        use_device: bool = True, shard_id: int = 0,
                        deadline: Deadline | None = None) -> ShardQueryResult:
    """The shard's query phase: top from+size (score, global doc, sort
    values) hits, the total and the aggregation and facet partials. The time
    budget is the coordinator's remaining budget when given, else the
    request's own `timeout`; an expired budget answers `timed_out` with
    nothing scored, the host scorer stops between segments, and a launched
    batch always completes whole. `use_device=False` serves every body on
    the host scorer.

    Under a ProfileCollector the lowering time and plan are recorded first,
    and the device time of the request's launches (its DeviceClock) once,
    at the end."""
    prof = _profile.current()
    if prof is None:
        return _query_phase(ctx, req, use_device, shard_id, deadline, None)
    if use_device:
        prof.clock = _profile.DeviceClock(ctx.device)
    res = _query_phase(ctx, req, use_device, shard_id, deadline, prof)
    if prof.clock is not None and prof.clock.launches:
        prof.phase_s("device", prof.clock.elapsed_s())
    return res


def _query_phase(ctx: ShardContext, req: ParsedSearchRequest, use_device: bool,
                 shard_id: int, deadline: Deadline | None, prof):
    if deadline is None:
        deadline = Deadline.after(req.timeout_s) if req.timeout_s is not None \
            else NO_DEADLINE
    k = req.from_ + req.size
    # the suggesters never touch the card: their output rides every branch
    suggest_out = run_suggest(ctx, req.suggest) if req.suggest else None
    if deadline.expired():
        # budget gone before any segment was scored: legal partial = nothing
        return ShardQueryResult(total=0, docs=[], max_score=float("nan"),
                                shard_id=shard_id, timed_out=True,
                                suggest=suggest_out)
    if prof is not None:
        t_low = time.monotonic()
        plan = lower_flat(req.query, ctx) if use_device else None
        prof.phase_s("lower", time.monotonic() - t_low)
        _prof_record_plan(prof, plan, req, ctx, use_device)
    degraded = False
    if use_device:
        device, degraded = _device_branch(ctx, req, k, shard_id, deadline)
        if device is not None:
            device.suggest = suggest_out
            return device
    if req.aggs or req.facets or req.sort or req.post_filter is not None \
            or req.min_score is not None or req.rescore:
        res = _general_host_path(ctx, req, k, shard_id, deadline)
    else:
        _count("host")
        td = _host_search(ctx, req.query, max(k, 1), deadline=deadline)
        res = ShardQueryResult(total=td.total, docs=[(s, d, None) for s, d in td.hits],
                               max_score=td.max_score, shard_id=shard_id,
                               timed_out=td.timed_out)
    res.degraded = degraded
    res.suggest = suggest_out
    return res


def _device_branch(ctx: ShardContext, req: ParsedSearchRequest, k: int,
                   shard_id: int, deadline: Deadline):
    """The device branches of the module docstring, in the JAX package's
    order: (the device's result or None, degraded). None and not degraded:
    the host path serves the body as it would anyway (a rescore always, and
    a gated body with `explain`)."""
    if req.rescore:
        return None, False
    if req.explain and (req.aggs or req.facets or req.sort or req.min_score is not None
                        or req.post_filter is not None):
        return None, False  # the JAX package's gated branches read `explain`
    if req.aggs and not (req.facets or req.sort) and req.post_filter is None \
            and req.min_score is None:
        return _guarded(ctx, ("aggs",), "device_aggs",
                        lambda: _try_device_aggs(ctx, req, k, shard_id))
    if req.sort and len(req.sort) == 1 and not req.facets \
            and req.post_filter is None and req.min_score is None:
        # the families the branch launches: a probe admitted here proves
        # only those (the JAX package gates every sort on `aggs` too)
        return _guarded(ctx, ("sorted", "aggs") if req.aggs else ("sorted",),
                        "device_sort", lambda: _try_device_sort(ctx, req, k, shard_id))
    if req.aggs and req.post_filter is not None and not (req.sort or req.facets) \
            and req.min_score is None:
        return _guarded(ctx, ("filtered", "aggs"), "device_filtered",
                        lambda: _try_device_post_filter(ctx, req, k, shard_id))
    routed = device_plan(ctx, req)
    if routed is None:
        return None, False
    plan, counter = routed
    families = ("function_score",) if plan.fs is not None else \
        ("filtered",) if plan.filt is not None else ("sparse", "dense")

    def run_plan() -> ShardQueryResult:
        td = _execute_flat_single(ctx, plan, max(k, 1), deadline)
        # the kernel runs at k >= 1; the min_score and post_filter branches
        # trim to the page, as the JAX package's do
        hits = td.hits if req.post_filter is None and req.min_score is None \
            else td.hits[: max(k, 0)]
        return ShardQueryResult(total=td.total, docs=[(s, d, None) for s, d in hits],
                                max_score=td.max_score, shard_id=shard_id)

    return _guarded(ctx, families, counter, run_plan)


def _guarded(ctx: ShardContext, families: tuple, counter: str, attempt,
             domains: tuple | None = None):
    """One device branch inside the fault domains: (result, degraded).
    Skipped, degraded, when one of its domains is open; degraded on a
    failure of the card or a fielddata breaker trip (`_device_failed`); on
    success the serving counter moves and a probed domain closes. A
    malformed body value (BodyValueError) degrades with no device error
    counted, so the host path answers or fails the shard with it. A request
    or parent trip, another SearchEngineError, a defect and a host bug
    raise.
    `domains` replaces the shard's domains of `families` (`_domains_for`)
    for a branch that owns a domain of its own (the percolator's)."""
    blocked = _blocked_domain(ctx, families, domains)
    if blocked is not None:
        _device_degraded(blocked)  # an open fault domain: no launch
        return None, True
    try:
        res = attempt()
    except CircuitBreakingError as e:
        if getattr(e, "breaker", None) != "fielddata":
            raise  # request/parent trip: load shedding (429), not degradable
        _device_failed(e, ctx)  # out of device-pack budget: the host serves
        return None, True
    except BodyValueError:
        # the host path meets it again where it reads the value (no
        # circuit moves: the card did not fail)
        return None, True
    except SearchEngineError:
        raise  # parsing and script errors are the answer itself
    except Exception as e:  # noqa: BLE001 — classified right below
        if classify_device_error(e) not in DEGRADABLE:
            _bump("device_errors")
            raise  # a defect or a host bug: no circuit moves, the caller sees it
        _device_failed(e, ctx)
        return None, True
    if res is None:
        return None, False  # a refusal before any launch: the host path serves it
    _note_device_ok(ctx, families, domains)
    _count(counter)
    return res, False


def device_plan(ctx: ShardContext, req: ParsedSearchRequest):
    """The flat plan a request without sort, aggregations or facets runs on
    the card through the batcher, and the serving counter it moves, or None
    (another branch, or the host scorer, serves it)."""
    if req.aggs or req.facets or req.sort:
        return None
    if req.post_filter is None and req.min_score is None:
        plan = lower_flat(req.query, ctx)
        if plan is None:
            return None
        return plan, ("device_function_score" if plan.fs is not None
                      else "device_filtered" if plan.filt is not None
                      else "device_sparse")
    if req.post_filter is None:
        # the function_score rows family with no function IS a score gate:
        # an empty spec around the query
        plan = lower_flat(FunctionScoreQuery(query=req.query,
                                             min_score=req.min_score), ctx)
        return None if plan is None else (plan, "device_filtered")
    if req.min_score is None:
        plan = lower_flat(req.query, ctx)
        if plan is None or plan.fs is not None:
            return None
        return _hit_plan(plan, req.post_filter), "device_filtered"
    return None


def _hit_plan(plan, post_filter: Filter):
    """The plan whose hits pass the query's own filter and the post filter."""
    hit_filter = post_filter if plan.filt is None else \
        BoolFilter(must=[plan.filt, post_filter])
    return dataclasses.replace(plan, filt=hit_filter)


def _agg_launch(ctx: ShardContext, req: ParsedSearchRequest, k: int):
    """Launch the request's aggregations with its query in one aggregating
    launch a segment, without synchronising: (the launch part, a function
    from its collected per-segment stats to the agg partials), or None when
    an aggregation, a column or the query needs the host path (nothing
    launched). Metric aggs reduce to masked stats, bucket aggs
    (terms/histogram/range/filter/… with metric sub-aggs) to exact counts
    over host-built (doc, bucket) pairs."""
    metric_fields = {}
    bucket_names = []
    bucket_subs: dict[str, tuple] = {}
    for name, agg in req.aggs.items():
        f = device_agg_field(agg, ctx)
        if f is not None:
            metric_fields[name] = f
        elif device_bucket_eligible(agg):
            subs = device_bucket_subs(agg, ctx) if agg.subs else {}
            if subs is None:
                return None  # a sub-agg can't ride the launch
            bucket_names.append(name)
            # one field order for the launch's stack and the partials' rows
            bucket_subs[name] = (subs, sorted(set(subs.values())))
        else:
            return None
    plan = lower_flat(req.query, ctx)
    if plan is None or plan.fs is not None:
        return None
    fields = sorted(set(metric_fields.values()))
    fpos = {f: i for i, f in enumerate(fields)}
    bucket_aggs = [(req.aggs[n], bucket_subs[n][1] or None) for n in bucket_names]
    part = launch_flat_aggs(plan, ctx, max(k, 1), fields, bucket_aggs)
    if part is None:
        return None  # a column wasn't f32-exact — host path
    bpos = {n: i for i, n in enumerate(bucket_names)}

    def bucket_partial(name, agg, buckets, seg):
        keys, bcounts, sub_cnt, sub_stats = buckets[bpos[name]]
        field_of, order = bucket_subs[name]
        sub_data = (agg.subs, field_of, order, sub_cnt, sub_stats) if field_of else None
        return device_bucket_partial(agg, keys, bcounts, seg=seg, sub_data=sub_data)

    def partials(seg_stats) -> list[dict]:
        return [
            {name: (device_partial(agg, counts[fpos[metric_fields[name]]],
                                   stats[fpos[metric_fields[name]]])
                    if name in metric_fields
                    else bucket_partial(name, agg, buckets, seg))
             for name, agg in req.aggs.items()}
            for (counts, stats, buckets), seg in zip(seg_stats, ctx.searcher.segments)]

    return part, partials


def _pull(ctx: ShardContext, parts: list):
    """The request's one pull: every part's result tensors behind one event,
    behind the `pull:<index>` seam."""
    return iter(wait_pull(pull_async([t for p in parts for t in p.tensors()]),
                          ctx.index_name))


def _try_device_aggs(ctx: ShardContext, req: ParsedSearchRequest, k: int,
                     shard_id: int = 0) -> ShardQueryResult | None:
    """The query and its aggregations in one aggregating launch a segment;
    None when an aggregation (or the query) needs the host path."""
    launched = _agg_launch(ctx, req, k)
    if launched is None:
        return None
    part, partials = launched
    td, seg_stats = part.collect(_pull(ctx, [part]))
    # the launch's k is at least 1 so max_score stays observable; the hits
    # trim to the page (size 0: none, as on the host path)
    return ShardQueryResult(
        total=td.total, docs=[(s, d, None) for s, d in td.hits[: max(k, 0)]],
        max_score=td.max_score, agg_partials=partials(seg_stats),
        shard_id=shard_id)


def _try_device_post_filter(ctx: ShardContext, req: ParsedSearchRequest, k: int,
                            shard_id: int = 0) -> ShardQueryResult | None:
    """A post filter with aggregations: the aggregating launch sees the
    query's own matches, the hit launch (the filtered core) gates on the
    query's filter and the post filter — the host path's split — and one
    pull serves both."""
    plan = lower_flat(req.query, ctx)
    if plan is None or plan.fs is not None:
        return None
    launched = _agg_launch(ctx, req, 0)
    if launched is None:
        return None
    agg_part, partials = launched
    hit_plan = _hit_plan(plan, req.post_filter)
    hit_part = _launch_filtered([0], [hit_plan], prepare_dense([hit_plan], ctx),
                                ctx, max(k, 1))
    flat = _pull(ctx, [agg_part, hit_part])
    _td, seg_stats = agg_part.collect(flat)
    (td,) = hit_part.collect(flat, max(k, 1))
    return ShardQueryResult(
        total=td.total, docs=[(s, d, None) for s, d in td.hits[: max(k, 0)]],
        max_score=td.max_score, agg_partials=partials(seg_stats),
        shard_id=shard_id)


def _try_device_sort(ctx: ShardContext, req: ParsedSearchRequest, k: int,
                     shard_id: int = 0) -> ShardQueryResult | None:
    """A one-field sort: the field-sorted launch orders the hits; None when
    the spec, a column or the query needs the host path. The response's sort
    VALUES come from the host extractor (exact float64, None for missing);
    only the order rides the card. Device-eligible aggregations ride a
    second launch over the same match set (any other sends the request to
    the host path), pulled with the sorted one."""
    spec = req.sort[0]
    if spec.kind != "field":
        return None
    plan = lower_flat(req.query, ctx)
    if plan is None or plan.fs is not None:
        return None
    # every refusal comes before the first launch: the key rows, then the
    # aggregations' eligibility (`_agg_launch` launches only when all pass)
    key_rows = sort_key_rows(ctx, spec)
    if key_rows is None:
        return None
    parts, partials = [], None
    if req.aggs:
        launched = _agg_launch(ctx, req, 0)
        if launched is None:
            return None  # a host-only agg sends the whole request host-side
        parts.append(launched[0])
        partials = launched[1]
    sorted_part = launch_flat_sorted(plan, ctx, max(k, 1), spec, key_rows)
    flat = _pull(ctx, parts + [sorted_part])
    agg_partials = partials(parts[0].collect(flat)[1]) if parts else []
    total, max_score, entries = sorted_part.collect(flat)
    values_by_rank = _sort_values_by_rank(
        req.sort, ctx, [(si, local) for (_key, _g, si, local, _s) in entries])
    docs = [
        (s if req.track_scores else float("nan"), g, values_by_rank[rank])
        for rank, (_key, g, _si, _local, s) in enumerate(entries)
    ][: max(k, 0)]
    return ShardQueryResult(total=total, docs=docs, max_score=max_score,
                            agg_partials=agg_partials, shard_id=shard_id)


def _general_host_path(ctx: ShardContext, req: ParsedSearchRequest, k: int,
                       shard_id: int, deadline: Deadline) -> ShardQueryResult:
    """The general host path of the JAX package: per-segment (scores,
    match) from the host scorer, the `min_score` gate, the post filter on
    the hits only, the sort keys (or the score), the aggregation and facet
    partials over the un-post-filtered matches. The whole materialization
    is reserved on the request breaker up front; the deadline is checked
    between segments (a partial answer is `timed_out`). The order is the
    JAX package's Python sort over (keys, global doc), computed as one
    lexsort over the same keys."""
    est = ctx.searcher.max_doc * (5 + 16 * (len(req.aggs) + len(req.facets)))
    prof = _profile.current()
    with breaker_reserve(ctx.breaker("request"), est, "<query_phase_host>"):
        _count("host")
        if prof is not None:
            _prof_host_features(prof, req)
        timed_out = False
        seg_results = []
        masks_iter = iter_match_masks(ctx, req.query)
        seg_masks_for_aggs = []
        key_parts, score_parts, g_parts, si_parts, local_parts = [], [], [], [], []
        total = 0
        max_score = float("nan")
        for si, (seg, base) in enumerate(zip(ctx.searcher.segments,
                                             ctx.searcher.bases)):
            if si > 0 and deadline.expired():
                timed_out = True
                break
            t_seg = time.monotonic() if prof is not None else 0.0
            scores, match = next(masks_iter)
            if prof is not None:
                prof.segment(seg.gen, docs=int(seg.doc_count), path="host",
                             ms=(time.monotonic() - t_seg) * 1000.0)
            seg_results.append((scores, match))
            if req.min_score is not None:
                match = match & (scores >= body_value(np.float32, req.min_score))
            seg_masks_for_aggs.append((seg, match, scores))
            hit_mask = match
            if req.post_filter is not None:
                hit_mask = match & segment_mask(seg, req.post_filter, ctx)
            idx = np.nonzero(hit_mask)[0]
            total += len(idx)
            if not len(idx):
                continue
            seg_scores = scores[idx]
            m = float(seg_scores.max())
            max_score = m if max_score != max_score else max(max_score, m)
            if req.sort:
                key_parts.append([
                    apply_missing(sort_key_column(spec, seg, ctx, scores), spec)[idx]
                    * (-1.0 if spec.reverse else 1.0) for spec in req.sort])
            else:
                key_parts.append([-seg_scores.astype(np.float64)])
            score_parts.append(seg_scores)
            g_parts.append(base + idx.astype(np.int64))
            si_parts.append(np.full(len(idx), si, np.int64))
            local_parts.append(idx)
        top = []
        if score_parts:
            gdocs = np.concatenate(g_parts)
            keys = [np.concatenate([kp[j] for kp in key_parts])
                    for j in range(len(key_parts[0]))]
            order = np.lexsort([gdocs] + keys[::-1])[: max(k, 0)]
            scores_all = np.concatenate(score_parts)
            si_all, local_all = np.concatenate(si_parts), np.concatenate(local_parts)
            top = [(float(scores_all[i]), int(gdocs[i]), int(si_all[i]),
                    int(local_all[i])) for i in order]
        if req.rescore and top:
            top = _apply_rescore(ctx, req, top)
        if req.sort:
            sort_vals_by_rank = _sort_values_by_rank(
                req.sort, ctx, [(si, local) for (_s, _g, si, local) in top],
                scores_by_seg={si: r[0] for si, r in enumerate(seg_results)})
            score_in_sort = _score_in_sort(req.sort)
            docs = [(s if req.track_scores or score_in_sort else float("nan"), g,
                     sort_vals_by_rank[rank])
                    for rank, (s, g, _si, _l) in enumerate(top)]
        else:
            docs = [(s, g, None) for (s, g, _si, _l) in top]
        agg_partials = [
            {n: a.collect(seg, ctx, mask, scores) for n, a in req.aggs.items()}
            for seg, mask, scores in seg_masks_for_aggs] if req.aggs else []
        facet_partials = [
            {n: agg.collect(seg, ctx, mask, scores)
             for n, (agg, _kind) in req.facets.items()}
            for seg, mask, scores in seg_masks_for_aggs] if req.facets else []
        return ShardQueryResult(
            total=total, docs=docs, max_score=max_score, agg_partials=agg_partials,
            facet_partials=facet_partials, shard_id=shard_id, timed_out=timed_out)


def _apply_rescore(ctx: ShardContext, req: ParsedSearchRequest, top: list) -> list:
    """The JAX package's QueryRescorer, spec by spec: the top `window_size`
    entries (sort keys, score, global doc, segment, local doc) are scored by
    the rescore query on the host scorer and combined by `score_mode` with
    `query_weight` and `rescore_query_weight` (an entry the rescore query
    does not match keeps its score times `query_weight`), then re-sorted
    within the window by (-score, doc), whatever order the body's sort gave
    it; the entries past the window keep their place."""
    for rspec in req.rescore:
        window = body_value(int, rspec.get("window_size", 10))
        qspec = rspec.get("query", {})
        rq = parse_query(qspec.get("rescore_query"))
        qw = body_value(float, qspec.get("query_weight", 1.0))
        rw = body_value(float, qspec.get("rescore_query_weight", 1.0))
        mode = qspec.get("score_mode", "total")
        qn = query_norm_for(rq, ctx)
        window_entries = top[:window]
        rest = top[window:]
        by_seg: dict[int, list[int]] = {}
        for i, (_s, _g, si, _local) in enumerate(window_entries):
            by_seg.setdefault(si, []).append(i)
        new_entries = list(window_entries)
        for si, idxs in by_seg.items():
            rscores, rmatch = HostScorer(ctx, ctx.searcher.segments[si], qn).eval(rq)
            for i in idxs:
                s, g, si2, local = window_entries[i]
                if rmatch[local]:
                    rs = float(rscores[local])
                    if mode == "total":
                        ns = s * qw + rs * rw
                    elif mode == "multiply":
                        ns = s * qw * rs * rw
                    elif mode == "avg":
                        ns = (s * qw + rs * rw) / 2.0
                    elif mode == "max":
                        ns = max(s * qw, rs * rw)
                    elif mode == "min":
                        ns = min(s * qw, rs * rw)
                    else:
                        raise QueryParsingError(f"unknown rescore score_mode [{mode}]")
                else:
                    ns = s * qw
                new_entries[i] = (ns, g, si2, local)
        new_entries.sort(key=lambda e: (-e[0], e[1]))
        top = new_entries + rest
    return top


def _sort_values_by_rank(specs: list, ctx: ShardContext, seg_locals: list,
                         scores_by_seg: dict | None = None) -> dict:
    """rank -> sort-value list, extracted per segment so the column reads
    vectorize — the one site of the response's "sort" arrays (host path and
    device sort). seg_locals: (segment index, local doc) per rank;
    scores_by_seg supplies the score arrays of `_score` specs (host path)."""
    by_seg: dict[int, list[int]] = {}
    for rank, (si, _local) in enumerate(seg_locals):
        by_seg.setdefault(si, []).append(rank)
    out: dict[int, list] = {}
    for si, ranks in by_seg.items():
        seg = ctx.searcher.segments[si]
        locals_ = np.asarray([seg_locals[r][1] for r in ranks])
        scores = scores_by_seg.get(si) if scores_by_seg else None
        vals = sort_values_for_docs(specs, seg, ctx, locals_, scores)
        for r, v in zip(ranks, vals):
            out[r] = v
    return out


def _score_in_sort(sort: list) -> bool:
    return any(s.kind == "score" for s in sort)


def execute_fetch_phase(ctx: ShardContext, req: ParsedSearchRequest,
                        docs: list, index_name: str = "index",
                        shard_id: int | None = None) -> list[dict]:
    """docs: [(score, global_doc, sort_values|None)], the winners to
    hydrate from the context's point-in-time searcher."""
    hits = []
    for score, g, sort_values in docs:
        seg, local = ctx.searcher.resolve(g)
        hits.append(build_hit(seg, local, score, req.body, req.query, ctx,
                              index_name=index_name, sort_values=sort_values,
                              shard_id=shard_id))
    return hits


def reduce_and_respond(ctx: ShardContext, req: ParsedSearchRequest,
                       result: ShardQueryResult, took_ms: int = 0,
                       index_name: str = "index") -> dict:
    """Single-shard convenience: query result → full response body. The
    entry the tests hold against the JAX package's of the same name; a node
    reduces its shards' results in `controller.merge_responses`."""
    page = result.docs[req.from_: req.from_ + req.size]
    hits = execute_fetch_phase(ctx, req, page, index_name=index_name)
    resp: dict = {
        "took": took_ms,
        "timed_out": False,
        "_shards": {"total": 1, "successful": 1, "failed": 0},
        "hits": {
            "total": result.total,
            "max_score": None if result.max_score != result.max_score
            else result.max_score,
            "hits": hits,
        },
    }
    if req.aggs:
        resp["aggregations"] = reduce_aggs(req.aggs, result.agg_partials)
    if req.facets:
        resp["facets"] = {
            name: facet_response(agg, kind, agg.finalize(agg.merge(
                [p[name] for p in result.facet_partials])))
            for name, (agg, kind) in req.facets.items()
        }
    if result.suggest is not None:
        resp["suggest"] = result.suggest
    return resp


# ---------------------------------------------------------------------------
# deadline-aware admission control (coordinator side)
# ---------------------------------------------------------------------------


class SearchAdmissionController:
    """Reject unservable searches BEFORE the fan-out.

    A request whose remaining Deadline budget is smaller than the node's
    recent shard-phase latency cannot finish in time: running it anyway
    burns a search worker, transport slots and breaker headroom on an answer
    the client has already given up on. The coordinator observes each shard
    phase's latency (`observe`) and turns such requests into an immediate
    429 with a Retry-After hint (`admit`).

    A request without a `timeout` is always admitted, and nothing is
    rejected before `min_samples` observations: a cold node's first
    searches (which pack their segments inline) must not close admission
    for everyone. `admit` compares against an EWMA of the observations, not
    the lifetime mean, so one slow phase stops weighing within ~1/alpha
    further observations."""

    EWMA_ALPHA = 0.2  # ~5-sample memory

    def __init__(self, min_samples: int = 10):
        self.min_samples = min_samples
        self.latency = MeanMetric()  # lifetime rollup
        self.histogram = HistogramMetric()  # the same observations' tail
        self.rejected = CounterMetric()
        self._ewma = 0.0  # the decaying signal admit() compares against
        self._ewma_lock = threading.Lock()

    def observe(self, seconds: float):
        s = max(0.0, float(seconds))
        self.latency.inc(s)
        self.histogram.observe(s)
        with self._ewma_lock:
            self._ewma = s if self.latency.count <= 1 else \
                self.EWMA_ALPHA * s + (1.0 - self.EWMA_ALPHA) * self._ewma

    def admit(self, deadline: Deadline):
        """Raise RejectedExecutionError (429) when the remaining budget
        cannot cover one expected shard phase; a no-op while unbounded or
        cold."""
        remaining = deadline.remaining()
        if remaining is None or self.latency.count < self.min_samples:
            return
        expected = self._ewma
        if remaining < expected:
            self.rejected.inc()
            err = RejectedExecutionError(
                f"rejected before fan-out: remaining budget "
                f"[{remaining * 1000:.0f}ms] < expected shard phase "
                f"[{expected * 1000:.0f}ms]")
            # the hint: when the request WOULD be servable, one phase on
            err.retry_after_s = max(expected, 0.001)
            raise err

    def stats(self) -> dict:
        return {
            "observed": self.latency.count,
            "mean_shard_phase_ms": round(self.latency.mean * 1000.0, 3),
            "ewma_shard_phase_ms": round(self._ewma * 1000.0, 3),
            "rejected": self.rejected.count,
            "shard_phase": self.histogram.stats(),
        }
