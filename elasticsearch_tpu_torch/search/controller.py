"""The coordinating node's reduce across shards — a port of the JAX package's
`search/controller.py`: `sort_docs` merges the shards' top-k into the global
top-(from+size) by (score desc, shard asc, doc asc), or for a field sort by
the hits' sort values (`compare_sort_values`), then shard, then doc; and
`merge_responses` assembles `took`, `timed_out`, `_shards` (with `degraded`,
the shards served on the host path on a device fault), `hits`, the
reduced `aggregations` and `facets`, and the shards' suggestions merged
(`_merge_suggest`).

The DFS phase of `dfs_query_then_fetch`: `collect_dfs` gathers one shard's
document frequency for every term the query scores and the statistics of
every field it scores (its flat plan's clauses, or a walk of the query tree
when it does not lower), and `aggregate_dfs` sums the shards' into the
global view each shard's query phase then weighs its clauses with
(`ShardContext.global_stats`), so every shard scores with the index's
statistics rather than its own.

Pure functions over shard results."""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..index.segment import FieldStats
from .aggregations import facet_response, reduce_aggs
from .service import ParsedSearchRequest, ShardQueryResult
from .sorting import compare_sort_values


@dataclass
class DfsResult:
    """One shard's statistics from the DFS phase: its max_doc, the df of
    every term the query scores and the statistics of every field it
    scores."""

    shard_id: int
    max_doc: int
    term_df: dict  # (field, term) -> df
    field_stats: dict  # field -> FieldStats


def aggregate_dfs(results: list[DfsResult]) -> dict:
    """Sum the shards' statistics into the global view every shard's query
    phase reads (`ShardContext.global_stats`)."""
    df: dict = {}
    fstats: dict[str, FieldStats] = {}
    max_doc = 0
    for r in results:
        max_doc += r.max_doc
        for key, v in r.term_df.items():
            df[key] = df.get(key, 0) + v
        for f, s in r.field_stats.items():
            cur = fstats.get(f)
            fstats[f] = s if cur is None else cur.merged(s)
    return {"df": df, "max_doc": max_doc, "field_stats": fstats}


def collect_dfs(ctx, query, shard_id: int = 0) -> DfsResult:
    """The DFS phase on one shard: the df of every term the query scores
    (its flat plan's clauses when it lowers, else a walk of its tree) and
    the statistics of every field it scores, from the shard's own
    searcher."""
    from .execute import lower_flat

    term_df: dict = {}
    fields: set = set()
    plan = lower_flat(query, ctx)
    if plan is not None:
        for c in plan.clauses:
            term_df[(c.field, c.term)] = ctx.searcher.doc_freq(c.field, c.term)
            fields.add(c.field)
    else:
        _walk_terms(query, ctx, term_df, fields)
    return DfsResult(
        shard_id=shard_id,
        max_doc=ctx.searcher.max_doc,
        term_df=term_df,
        field_stats={f: ctx.searcher.field_stats(f) for f in fields},
    )


def _walk_terms(query, ctx, term_df: dict, fields: set):
    """The terms and fields of a query that does not lower: terms, matches
    and phrases (analyzed), multi_match, and what bool, dis_max, filtered,
    function_score and nested wrap. Other queries keep the shard's own
    statistics."""
    from .queries import (
        BoolQuery, DisMaxQuery, FilteredQuery, FunctionScoreQuery, MatchQuery,
        MultiMatchQuery, NestedQuery, PhraseQuery, TermQuery,
    )

    if isinstance(query, TermQuery):
        term_df[(query.field, str(query.value))] = ctx.searcher.doc_freq(
            query.field, str(query.value))
        fields.add(query.field)
    elif isinstance(query, (MatchQuery, PhraseQuery)):
        for t in ctx.analyze(query.field, query.text):
            term_df[(query.field, t)] = ctx.searcher.doc_freq(query.field, t)
        fields.add(query.field)
    elif isinstance(query, MultiMatchQuery):
        for fspec in query.fields:
            f = fspec.split("^")[0]
            for t in ctx.analyze(f, query.text):
                term_df[(f, t)] = ctx.searcher.doc_freq(f, t)
            fields.add(f)
    elif isinstance(query, BoolQuery):
        for sub in query.must + query.should + query.must_not:
            _walk_terms(sub, ctx, term_df, fields)
    elif isinstance(query, DisMaxQuery):
        for sub in query.queries:
            _walk_terms(sub, ctx, term_df, fields)
    elif isinstance(query, (FilteredQuery, FunctionScoreQuery, NestedQuery)):
        inner = getattr(query, "query", None)
        if inner is not None and not callable(getattr(inner, "evaluate", None)):
            _walk_terms(inner, ctx, term_df, fields)


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
    hits of the page), the `profile` section of a profiled request, the
    `aggregations` and `facets` reduced from every shard's partials, and the
    shards' `suggest` entries merged."""
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
    if req.profile:
        # one profile a shard that answered, by (index, shard): a failed
        # shard contributes none, as it contributes no hits
        shard_profiles = [r.profile for r in shard_results
                          if r.profile is not None]
        shard_profiles.sort(key=lambda p: (str(p.get("index", "")),
                                           int(p.get("shard", 0))))
        resp["profile"] = {"shards": shard_profiles}
    if req.aggs:
        partials = [p for r in shard_results for p in r.agg_partials]
        resp["aggregations"] = reduce_aggs(req.aggs, partials)
    if req.facets:
        facets = {}
        for name, (agg, kind) in req.facets.items():
            partials = [p[name] for r in shard_results for p in r.facet_partials]
            facets[name] = facet_response(agg, kind, agg.finalize(agg.merge(partials)))
        resp["facets"] = facets
    suggest = _merge_suggest(shard_results)
    if suggest is not None:
        resp["suggest"] = suggest
    return resp


def _merge_suggest(shard_results: list[ShardQueryResult]) -> dict | None:
    """The shards' suggester entries merged, as in the JAX package: each
    entry's options unioned over the shards in their order, one option a
    text (the highest score; the first seen on a tie), ranked by (score
    desc, freq desc, text) and cut to 5. None when no shard suggested."""
    any_suggest = [r.suggest for r in shard_results if r.suggest is not None]
    if not any_suggest:
        return None
    out: dict = {}
    for s in any_suggest:
        for name, entries in s.items():
            if name not in out:
                out[name] = [dict(e, options=list(e["options"])) for e in entries]
            else:
                for mine, theirs in zip(out[name], entries):
                    mine["options"].extend(theirs["options"])
    for entries in out.values():
        for e in entries:
            seen = {}
            for o in e["options"]:
                key = o["text"]
                if key not in seen or o.get("score", 0) > seen[key].get("score", 0):
                    seen[key] = o
            e["options"] = sorted(
                seen.values(),
                key=lambda o: (-o.get("score", 0), -o.get("freq", 0), o["text"]),
            )[:5]
    return out
