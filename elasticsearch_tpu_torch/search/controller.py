"""The coordinating node's reduce across shards — a port of the JAX package's
`search/controller.py`: `sort_docs` merges the shards' top-k into the global
top-(from+size) by (score desc, shard asc, doc asc), or for a field sort by
the hits' sort values (`compare_sort_values`), then shard, then doc; and
`merge_responses` assembles `took`, `timed_out`, `_shards` (with `degraded`,
the shards served on the host path on a device fault), `hits` and the
reduced `aggregations` and `facets`. Pure functions over shard results. DFS
(`collect_dfs` / `aggregate_dfs`) is a later slice."""

from __future__ import annotations

import functools
from dataclasses import dataclass

from .aggregations import facet_response, reduce_aggs
from .service import ParsedSearchRequest, ShardQueryResult
from .sorting import compare_sort_values


@dataclass
class MergedTopDocs:
    total: int
    max_score: float
    # [(score, shard_id, global_doc, sort_values)]
    hits: list
    timed_out: bool = False


def sort_docs(req: ParsedSearchRequest,
              shard_results: list[ShardQueryResult]) -> MergedTopDocs:
    """Global top-(from+size) merge across shards. Score order: (score desc,
    shard asc, doc asc). Field order: the sort-value tuples through the
    shared comparator, then shard, then doc. One shard-level partial (its
    deadline expired) marks the whole merged result timed_out."""
    total = sum(r.total for r in shard_results)
    max_score = float("nan")
    for r in shard_results:
        if r.max_score == r.max_score:
            max_score = r.max_score if max_score != max_score \
                else max(max_score, r.max_score)
    entries = [(score, r.shard_id, doc, sort_values)
               for r in shard_results for (score, doc, sort_values) in r.docs]
    if req.sort:
        entries.sort(key=functools.cmp_to_key(
            lambda a, b: (compare_sort_values(a[3], b[3], req.sort)
                          or (a[1] - b[1]) or (a[2] - b[2]))))
    else:
        entries.sort(key=lambda e: (-e[0] if e[0] == e[0] else float("inf"),
                                    e[1], e[2]))
    k = req.from_ + req.size
    return MergedTopDocs(total=total, max_score=max_score, hits=entries[:k],
                         timed_out=any(r.timed_out for r in shard_results))


def merge_responses(req: ParsedSearchRequest, merged: MergedTopDocs,
                    shard_results: list[ShardQueryResult],
                    fetched_hits: list[dict], took_ms: int, total_shards: int,
                    successful: int, failures: list | None = None) -> dict:
    """The response: `took`, `timed_out`, `_shards`, `hits` (the hydrated
    hits of the page), and the `aggregations` and `facets` reduced from every
    shard's partials."""
    resp: dict = {
        "took": took_ms,
        "timed_out": merged.timed_out,
        "_shards": {
            "total": total_shards,
            "successful": successful,
            # shards that answered (counted successful) on the host path
            # because a device fault domain was open or the device failed
            "degraded": sum(1 for r in shard_results if r.degraded),
            "failed": total_shards - successful,
        },
        "hits": {
            "total": merged.total,
            "max_score": None if merged.max_score != merged.max_score
            else merged.max_score,
            "hits": fetched_hits,
        },
    }
    if failures:
        resp["_shards"]["failures"] = failures
    if req.aggs:
        partials = [p for r in shard_results for p in r.agg_partials]
        resp["aggregations"] = reduce_aggs(req.aggs, partials)
    if req.facets:
        facets = {}
        for name, (agg, kind) in req.facets.items():
            partials = [p[name] for r in shard_results for p in r.facet_partials]
            facets[name] = facet_response(agg, kind, agg.finalize(agg.merge(partials)))
        resp["facets"] = facets
    return resp
