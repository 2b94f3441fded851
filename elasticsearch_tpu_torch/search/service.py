"""The shard's request entry: a search body → the query phase on the card — a
port of the JAX package's `search/service.py` trimmed to the plain device
branch (`parse_search_body`, `ShardQueryResult`, `SERVING_COUNTERS`,
`_execute_flat_single`, `execute_query_phase`).

A body may carry `query`, `from`, `size`, `timeout` and `_source` (read by
the fetch phase, `execute_fetch_phase`). Every other key is a request
feature (aggregations, sorting, post filters, rescoring, highlighting, …)
whose device or host path is a later slice of the port: it raises
QueryParsingError rather than being silently ignored.

There is no host scorer in the port yet, so a device error is not turned into
a host answer: it is counted in `SERVING_COUNTERS["device_errors"]` and
raised to the caller (through the batcher's future when the request was
coalesced, after the batcher replayed it on its own on the device).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from ..common.deadline import NO_DEADLINE, Deadline, parse_timevalue
from ..common.errors import QueryParsingError, SearchEngineError
from .execute import ShardContext, TopDocs, execute_flat_batch, lower_flat
from .fetch import build_hit
from .queries import Query, parse_query

# the body keys this slice serves; the rest belong to later slices
_SERVED_KEYS = ("query", "from", "size", "timeout", "_source")


@dataclass
class ParsedSearchRequest:
    query: Query
    from_: int
    size: int
    body: dict
    # the request-body `timeout` in seconds (None: no budget)
    timeout_s: float | None = None


def parse_search_body(body: dict | None) -> ParsedSearchRequest:
    body = body or {}
    later = sorted(k for k in body if k not in _SERVED_KEYS)
    if later:
        raise QueryParsingError(
            f"search body key(s) {later} are not ported yet: aggregations, "
            "sorting, filters, rescoring, suggesters and the rest of the "
            "request features are later slices of the port")
    try:
        timeout_s = parse_timevalue(body.get("timeout"))
    except ValueError as e:
        raise QueryParsingError(str(e)) from None  # malformed timeout is a 400
    if not body.get("query"):
        raise QueryParsingError(
            "a search body without a query (match_all) runs on the host "
            "scorer, a later slice of the port")
    return ParsedSearchRequest(
        query=parse_query(body["query"]),
        from_=int(body.get("from", 0)),
        size=int(body.get("size", 10)),
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
    # the deadline had expired before any segment was scored
    timed_out: bool = False
    # the pinned query-time context the fetch phase reads (actions.py)
    context_id: int | None = None


# process-wide serving counters of the port (its own singleton: a process
# that runs both packages counts each package's serving apart)
SERVING_COUNTERS = {
    "device_sparse": 0,  # flat top-k served on the card's sparse path
    "device_errors": 0,  # the device path raised; the error reached the caller
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
                        shard_id: int = 0,
                        deadline: Deadline | None = None) -> ShardQueryResult:
    """The shard's query phase: top from+size (score, global doc) hits and
    the total. The time budget is the coordinator's remaining budget when
    given, else the request's own `timeout`; an expired budget answers
    `timed_out` with nothing scored, and a launched batch always completes
    whole."""
    if deadline is None:
        deadline = Deadline.after(req.timeout_s) if req.timeout_s is not None \
            else NO_DEADLINE
    k = req.from_ + req.size
    if deadline.expired():
        # budget gone before any segment was scored: legal partial = nothing
        return ShardQueryResult(total=0, docs=[], max_score=float("nan"),
                                shard_id=shard_id, timed_out=True)
    plan = lower_flat(req.query, ctx)
    if plan is None:
        raise QueryParsingError(
            f"[{type(req.query).__name__}] does not lower to a flat device "
            "plan; the host scorer that serves it is a later slice of the port")
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
