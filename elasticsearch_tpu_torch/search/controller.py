"""The coordinating node's reduce across shards — a port of the JAX package's
`search/controller.py` trimmed to score order: `sort_docs` merges the
shards' top-k into the global top-(from+size) by (score desc, shard asc, doc
asc), and `merge_responses` assembles `took`, `timed_out`, `_shards` and
`hits`. Pure functions over shard results. DFS (`collect_dfs` /
`aggregate_dfs`) and field sorting are later slices."""

from __future__ import annotations

from dataclasses import dataclass

from .service import ParsedSearchRequest, ShardQueryResult


@dataclass
class MergedTopDocs:
    total: int
    max_score: float
    # [(score, shard_id, global_doc, sort_values)]
    hits: list
    timed_out: bool = False


def sort_docs(req: ParsedSearchRequest,
              shard_results: list[ShardQueryResult]) -> MergedTopDocs:
    """Global top-(from+size) merge across shards in score order (score desc,
    shard asc, doc asc). One shard-level partial (its deadline expired) marks
    the whole merged result timed_out."""
    total = sum(r.total for r in shard_results)
    max_score = float("nan")
    for r in shard_results:
        if r.max_score == r.max_score:
            max_score = r.max_score if max_score != max_score \
                else max(max_score, r.max_score)
    entries = [(score, r.shard_id, doc, sort_values)
               for r in shard_results for (score, doc, sort_values) in r.docs]
    entries.sort(key=lambda e: (-e[0] if e[0] == e[0] else float("inf"),
                                e[1], e[2]))
    k = req.from_ + req.size
    return MergedTopDocs(total=total, max_score=max_score, hits=entries[:k],
                         timed_out=any(r.timed_out for r in shard_results))


def merge_responses(req: ParsedSearchRequest, merged: MergedTopDocs,
                    shard_results: list[ShardQueryResult],
                    fetched_hits: list[dict], took_ms: int, total_shards: int,
                    successful: int, failures: list | None = None) -> dict:
    """The response's `took`, `timed_out`, `_shards` and `hits` sections
    (the JAX package's signature: `req` and `shard_results` feed the
    sections of later slices — aggregations, suggest, profile).
    `fetched_hits` are the hydrated hits of the page (the fetch phase is a
    later slice: a caller passes what it has)."""
    resp: dict = {
        "took": took_ms,
        "timed_out": merged.timed_out,
        "_shards": {
            "total": total_shards,
            "successful": successful,
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
    return resp
