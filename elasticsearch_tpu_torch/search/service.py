"""The shard's request entry: a search body → the query phase, on the card
or on the host scorer — a port of the JAX package's `search/service.py`
(`parse_search_body`, `ShardQueryResult`, `SERVING_COUNTERS`,
`_execute_flat_single`, `execute_query_phase`).

A body may carry `query` (none: match_all), `from`, `size`, `timeout`,
`_source` (read by the fetch phase, `execute_fetch_phase`), `post_filter`
(and the top-level `filter`, its older name) and `min_score`. Every other key
is a request feature (aggregations, sorting, rescoring, suggesters,
highlighting, explain, profiles, …) whose path is a later slice of the port:
it raises QueryParsingError rather than being silently ignored.

`execute_query_phase` takes the JAX package's branches: a body with neither
`post_filter` nor `min_score` lowers to a flat plan and runs on the card
through the batcher, or, when it does not lower, on the host scorer
(`_host_topk`); a body with either runs the general host path, the same top-k
with the `min_score` gate and the post filter, under a request-breaker
reservation. Where the JAX package serves `post_filter` and `min_score` on its
device families, the port serves them on the host: those families are a later
slice.

There are no device fault domains in the port yet, so a device error on a
lowerable body is not re-served by the host scorer: it is counted in
`SERVING_COUNTERS["device_errors"]` and raised to the caller (through the
batcher's future when the request was coalesced, after the batcher replayed
it on its own on the device).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from ..common.breaker import reserve as breaker_reserve
from ..common.deadline import NO_DEADLINE, Deadline, parse_timevalue
from ..common.errors import QueryParsingError, SearchEngineError
from .execute import (
    ShardContext,
    TopDocs,
    _host_search,
    execute_flat_batch,
    lower_flat,
)
from .fetch import build_hit
from .filters import Filter
from .queries import MatchAllQuery, Query, parse_filter, parse_query

# the body keys this slice serves; the rest belong to later slices
_SERVED_KEYS = ("query", "from", "size", "timeout", "_source", "post_filter",
                "filter", "min_score")


@dataclass
class ParsedSearchRequest:
    query: Query
    post_filter: Filter | None
    from_: int
    size: int
    min_score: float | None
    body: dict
    # the request-body `timeout` in seconds (None: no budget)
    timeout_s: float | None = None


def parse_search_body(body: dict | None) -> ParsedSearchRequest:
    body = body or {}
    later = sorted(k for k in body if k not in _SERVED_KEYS)
    if later:
        raise QueryParsingError(
            f"search body key(s) {later} are not ported yet: aggregations, "
            "sorting, rescoring, suggesters and the rest of the request "
            "features are later slices of the port")
    try:
        timeout_s = parse_timevalue(body.get("timeout"))
    except ValueError as e:
        raise QueryParsingError(str(e)) from None  # malformed timeout is a 400
    query = parse_query(body.get("query")) if body.get("query") else MatchAllQuery()
    # the top-level "filter" is the post filter (it gates hits only)
    post_filter = parse_filter(body["filter"]) if body.get("filter") else \
        parse_filter(body["post_filter"]) if body.get("post_filter") else None
    return ParsedSearchRequest(
        query=query,
        post_filter=post_filter,
        from_=int(body.get("from", 0)),
        size=int(body.get("size", 10)),
        min_score=body.get("min_score"),
        body=body,
        timeout_s=timeout_s,
    )


@dataclass
class ShardQueryResult:
    """Query-phase output for ONE shard: what travels back to the
    coordinating node before the reduce."""

    total: int
    # [(score, global_doc, sort_values|None)] — length ≤ from+size
    docs: list
    max_score: float
    shard_id: int = 0
    # the deadline expired before any segment was scored, or between two
    # segments on the host scorer (the hits cover the segments scored)
    timed_out: bool = False
    # the pinned query-time context the fetch phase reads (actions.py)
    context_id: int | None = None


# process-wide serving counters of the port (its own singleton: a process
# that runs both packages counts each package's serving apart)
SERVING_COUNTERS = {
    "device_sparse": 0,  # flat top-k served on the card's sparse path
    "device_errors": 0,  # the device path raised; the error reached the caller
    "host": 0,  # served by the host scorer
}
_COUNTERS_LOCK = threading.Lock()


def _count(path: str):
    with _COUNTERS_LOCK:
        SERVING_COUNTERS[path] += 1


def _execute_flat_single(ctx: ShardContext, plan, k: int,
                         deadline: Deadline) -> TopDocs:
    """One plan's device execution — through the shard's cross-request
    DeviceBatcher when one is wired (coalescing with concurrent searches
    into one bucketed launch; search/batcher.py), else a direct single-plan
    launch."""
    if ctx.batcher is not None:
        return ctx.batcher.execute(plan, ctx, k, deadline=deadline)
    return execute_flat_batch([plan], ctx, k)[0]


def execute_query_phase(ctx: ShardContext, req: ParsedSearchRequest,
                        use_device: bool = True, shard_id: int = 0,
                        deadline: Deadline | None = None) -> ShardQueryResult:
    """The shard's query phase: top from+size (score, global doc) hits and
    the total. The time budget is the coordinator's remaining budget when
    given, else the request's own `timeout`; an expired budget answers
    `timed_out` with nothing scored, the host scorer stops between segments,
    and a launched batch always completes whole. `use_device=False` serves
    every body on the host scorer."""
    if deadline is None:
        deadline = Deadline.after(req.timeout_s) if req.timeout_s is not None \
            else NO_DEADLINE
    k = req.from_ + req.size
    if deadline.expired():
        # budget gone before any segment was scored: legal partial = nothing
        return ShardQueryResult(total=0, docs=[], max_score=float("nan"),
                                shard_id=shard_id, timed_out=True)
    if req.post_filter is None and req.min_score is None:
        plan = lower_flat(req.query, ctx) if use_device else None
        if plan is not None:
            try:
                td = _execute_flat_single(ctx, plan, max(k, 1), deadline)
            except SearchEngineError:
                raise  # breaker trips and parsing errors are the answer itself
            except Exception:
                _count("device_errors")
                raise
            _count("device_sparse")
            return ShardQueryResult(total=td.total,
                                    docs=[(s, d, None) for s, d in td.hits],
                                    max_score=td.max_score, shard_id=shard_id)
        _count("host")
        td = _host_topk(ctx, req, k, deadline)
    else:
        # the general host path: its per-segment score and match arrays are
        # reserved on the request breaker up front
        with breaker_reserve(ctx.breaker("request"), ctx.searcher.max_doc * 5,
                             "<query_phase_host>"):
            _count("host")
            td = _host_topk(ctx, req, k, deadline)
    return ShardQueryResult(total=td.total,
                            docs=[(s, d, None) for s, d in td.hits],
                            max_score=td.max_score, shard_id=shard_id,
                            timed_out=td.timed_out)


def _host_topk(ctx: ShardContext, req: ParsedSearchRequest, k: int,
               deadline: Deadline = NO_DEADLINE) -> TopDocs:
    """The host scorer's top-k; a hit must reach `min_score` and pass the
    post filter, and the total and `max_score` count only such hits."""
    return _host_search(ctx, req.query, max(k, 1), extra_filter=req.post_filter,
                        deadline=deadline, min_score=req.min_score)


def execute_fetch_phase(ctx: ShardContext, req: ParsedSearchRequest,
                        docs: list, index_name: str = "index",
                        shard_id: int | None = None) -> list[dict]:
    """docs: [(score, global_doc, sort_values|None)], the winners to
    hydrate from the context's point-in-time searcher."""
    hits = []
    for score, g, _sort_values in docs:
        seg, local = ctx.searcher.resolve(g)
        hits.append(build_hit(seg, local, score, req.body,
                              index_name=index_name, shard_id=shard_id))
    return hits
