"""The DFS phase of the port (search/controller.py `collect_dfs`,
`aggregate_dfs`; search/execute.py `ShardContext.global_stats`;
search/service.py's batcher bypass; actions.py's DFS round) against the JAX
package.

Module against module: three shards of the same seeded documents, indexed
by each package's own Engine (two refreshes and a delete, so every shard
holds two segments and a tombstone), under BM25 and under TF-IDF. Each
shard's `collect_dfs` equals the JAX one (term dfs, field statistics,
max_doc) for lowering and non-lowering queries, their `aggregate_dfs`
equals the JAX one, and `execute_query_phase` under those global
statistics gives the JAX package's hits bitwise (every flat query rides
the sparse path; the others are served by both host scorers).

Node against node over REST: `search_type=dfs_query_then_fetch` and
`dfs_query_and_fetch` on a 3-shard index give the JAX node's hits JSON;
DFS scores of a 1-shard and a 3-shard index holding the same documents
agree, on the port as on the JAX package (the invariance
tests/test_chaos_randomized.py relies on); a DFS request never enters the
DeviceBatcher (a counting wrapper around `DeviceBatcher.execute`; the
batcher's `direct` count moves once a shard instead), while a plain one
does. On one pack, DFS and plain requests run concurrently through one
batcher each equal their answer alone, while the pack's similarity tables
flip between the index's and the shard's statistics (`SIM_SWAPS`)."""

import json
import threading

import numpy as np
import pytest

from elasticsearch_tpu_torch.common.settings import Settings as TSettings
from elasticsearch_tpu_torch.index.engine import Engine as TEngine
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.ops.device_index import SIM_SWAPS
from elasticsearch_tpu_torch.search import (
    DeviceBatcher, ShardContext, SimilarityService, execute_query_phase,
    parse_query, parse_search_body)
from elasticsearch_tpu_torch.search.controller import aggregate_dfs, collect_dfs
from tests.test_torch_node import _node_pair, call

WORDS = [f"w{i}" for i in range(40)]
SETTINGS = {"bm25": {"index.similarity.default.type": "BM25"}, "tfidf": {}}
N_SHARDS = 3

# lowering (flat) and non-lowering (host scorer) queries
QUERIES = [
    {"match": {"body": "w1 w2 w3"}},
    {"match": {"body": {"query": "w4 w5", "operator": "and"}}},
    {"term": {"body": "w6"}},
    {"bool": {"must": [{"term": {"body": "w7"}}],
              "should": [{"term": {"body": "w8"}}, {"match": {"title": "w9"}}],
              "must_not": [{"term": {"body": "w10"}}]}},
    {"bool": {"should": [{"term": {"body": "w11"}}, {"term": {"body": "w12"}},
                         {"term": {"title": "w13"}}], "minimum_should_match": 2}},
    {"match_phrase": {"body": "w1 w2"}},
    {"multi_match": {"query": "w3 w14", "fields": ["title^2", "body"]}},
    {"dis_max": {"queries": [{"term": {"body": "w15"}}, {"match": {"title": "w16"}}]}},
    {"filtered": {"query": {"match": {"body": "w2 w17"}},
                  "filter": {"term": {"title": "w2"}}}},
    {"function_score": {"query": {"match": {"body": "w18 w19"}}, "boost_factor": 2.0}},
    {"match": {"body": "no-such-term w1"}},
    {"match_all": {}},
]


def _docs(seed: int, n: int, start: int):
    rng = np.random.default_rng(seed)
    return [(str(start + i), {
        "title": " ".join(rng.choice(WORDS[: int(rng.integers(8, 40))], 3)),
        "body": " ".join(rng.choice(WORDS[: int(rng.integers(8, 40))],
                                    int(rng.integers(2, 30))))})
            for i in range(n)]


@pytest.fixture(scope="module", params=["bm25", "tfidf"])
def shards(request, tmp_path_factory):
    """([JAX contexts], [port contexts], settings name): three shards of
    different sizes, each with two segments and one deleted document."""
    from elasticsearch_tpu.common.settings import Settings as JSettings
    from elasticsearch_tpu.index.engine import Engine as JEngine
    from elasticsearch_tpu.mapper.core import MapperService as JMapperService
    from elasticsearch_tpu.search import ShardContext as JShardContext
    from elasticsearch_tpu.search.similarity import SimilarityService as JSim

    flat = SETTINGS[request.param]
    jset, tset = JSettings.from_flat(flat), TSettings.from_flat(flat)
    jsvc, tsvc = JMapperService(jset), TMapperService(tset)
    jsim, tsim = JSim(jset, mapper_service=jsvc), SimilarityService(tset, tsvc)
    engines, jctxs, tctxs = [], [], []
    for sid in range(N_SHARDS):
        root = tmp_path_factory.mktemp(f"{request.param}_{sid}")
        je, te = JEngine(str(root / "jax"), jsvc), TEngine(str(root / "port"), tsvc)
        engines += [je, te]
        batches = [_docs(10 * sid + 1, 40 + 30 * sid, 0),
                   _docs(10 * sid + 2, 25 + 10 * sid, 1000)]
        for batch in batches:
            for eng in (je, te):
                for doc_id, src in batch:
                    eng.index("doc", doc_id, src)
                eng.refresh()
        for eng in (je, te):
            eng.delete("doc", str(3 + sid))
            eng.refresh()
        jctxs.append(JShardContext(je.acquire_searcher(), jsvc, jsim))
        tctxs.append(ShardContext(te.acquire_searcher(), tsvc, tsim, device="cpu"))
    yield jctxs, tctxs, request.param
    for eng in engines:
        eng.close()


def _jax_collect(jctxs, query: dict):
    from elasticsearch_tpu.search import parse_query as jparse
    from elasticsearch_tpu.search.controller import collect_dfs as jcollect

    return [jcollect(c, jparse(query), shard_id=i) for i, c in enumerate(jctxs)]


def _as_plain(r) -> tuple:
    return (r.shard_id, r.max_doc, dict(r.term_df),
            {f: (s.doc_count, s.sum_ttf, s.sum_dfs) for f, s in r.field_stats.items()})


def _agg_plain(agg: dict) -> tuple:
    return (agg["max_doc"], dict(agg["df"]),
            {f: (s.doc_count, s.sum_ttf, s.sum_dfs) for f, s in agg["field_stats"].items()})


@pytest.mark.parametrize("query", QUERIES, ids=[f"q{i}" for i in range(len(QUERIES))])
def test_collect_and_aggregate_dfs_match_jax(shards, query):
    from elasticsearch_tpu.search.controller import aggregate_dfs as jaggregate

    jctxs, tctxs, _name = shards
    jres = _jax_collect(jctxs, query)
    tres = [collect_dfs(c, parse_query(query), shard_id=i) for i, c in enumerate(tctxs)]
    assert [_as_plain(r) for r in tres] == [_as_plain(r) for r in jres]
    assert _agg_plain(aggregate_dfs(tres)) == _agg_plain(jaggregate(jres))
    if "match_all" not in query:
        assert aggregate_dfs(tres)["field_stats"], query


def _global_stats(jctxs, tctxs, query):
    """(the JAX aggregate, the port's) of the three shards' DFS results."""
    from elasticsearch_tpu.search.controller import aggregate_dfs as jaggregate

    return (jaggregate(_jax_collect(jctxs, query)),
            aggregate_dfs([collect_dfs(c, parse_query(query), shard_id=i)
                           for i, c in enumerate(tctxs)]))


def test_query_phase_under_global_stats_is_bitwise_jax(shards):
    """Every shard's query phase under the index's statistics, on the card's
    path of each package (its sparse plain version here), against the JAX
    package's, and different from the shard-local answer where the
    statistics differ."""
    from elasticsearch_tpu.common.jaxenv import compile_tag
    from elasticsearch_tpu.search import ShardContext as JShardContext
    from elasticsearch_tpu.search.service import execute_query_phase as jphase
    from elasticsearch_tpu.search.service import parse_search_body as jparse

    jctxs, tctxs, _name = shards
    moved = 0
    for query in QUERIES:
        body = {"query": query, "size": 15}
        jagg, tagg = _global_stats(jctxs, tctxs, query)
        for jc, tc in zip(jctxs, tctxs):
            jg = JShardContext(jc.searcher, jc.mapper_service, jc.similarity_service, jagg)
            tg = ShardContext(tc.searcher, tc.mapper_service, tc.similarity_service,
                              device="cpu", global_stats=tagg)
            with compile_tag("sparse"):
                want = jphase(jg, jparse(body))
            got = execute_query_phase(tg, parse_search_body(body))
            assert (got.total, got.docs) == (want.total, want.docs), query
            local = execute_query_phase(tc, parse_search_body(body))
            moved += local.docs != got.docs
    assert moved > 0  # the index's statistics changed some shard's scores


@pytest.fixture(scope="module")
def dfs_nodes(tmp_path_factory):
    """(port base URL, JAX base URL, port node) holding `one` (1 shard) and
    `three` (3 shards), BM25 and TF-IDF twins, with the same documents."""
    docs = _docs(7, 150, 0) + _docs(8, 60, 500)
    lines = []
    for index in ("one", "three", "one_bm25", "three_bm25"):
        for doc_id, src in docs:
            lines += [{"index": {"_index": index, "_type": "doc", "_id": doc_id}}, src]
    bulk = "\n".join(json.dumps(x) for x in lines) + "\n"

    def fill(base):
        for index in ("one", "three", "one_bm25", "three_bm25"):
            settings = {"number_of_shards": 1 if index.startswith("one") else 3,
                        "refresh_interval": -1}
            if index.endswith("bm25"):
                settings["index"] = {"similarity": {"default": {"type": "BM25"}}}
            st, r = call(base, "PUT", f"/{index}", {"settings": settings})
            assert st == 200 and r["acknowledged"], r
        st, r = call(base, "POST", "/_bulk", raw=bulk)
        assert st == 200 and not r["errors"]
        st, _r = call(base, "POST", "/_refresh")
        assert st == 200

    yield from _node_pair(tmp_path_factory, fill)


@pytest.mark.parametrize("search_type", ["dfs_query_then_fetch", "dfs_query_and_fetch"])
@pytest.mark.parametrize("index", ["three", "three_bm25"])
def test_dfs_hits_json_matches_jax_node(dfs_nodes, search_type, index):
    pbase, jbase, _p = dfs_nodes
    for query in QUERIES:
        body = {"query": query, "size": 20}
        path = f"/{index}/_search?search_type={search_type}"
        (pst, pr), (jst, jr) = (call(b, "POST", path, body) for b in (pbase, jbase))
        assert pst == jst == 200, (pr, jr)
        assert (pr["hits"], pr["_shards"]) == (jr["hits"], jr["_shards"]), query


def _scores_by_id(r) -> dict:
    return {h["_id"]: h["_score"] for h in r["hits"]["hits"]}


@pytest.mark.parametrize("sim", ["", "_bm25"])
def test_dfs_scores_do_not_depend_on_shard_count(dfs_nodes, sim):
    """Under DFS a document scores the same in the 1-shard and the 3-shard
    index, on both nodes (within 2 ulp: the summation order of a shard's
    clauses is the same, its segments differ); plain query_then_fetch
    differs somewhere, which is what DFS is for."""
    from tests.test_torch_dense import _within_ulps

    pbase, jbase, _p = dfs_nodes
    differs = 0
    for query in QUERIES[:3]:
        body = {"query": query, "size": 300}
        for base in (pbase, jbase):
            one, three = (call(base, "POST", f"/{ix}{sim}/_search?search_type="
                               "dfs_query_then_fetch", body)[1] for ix in ("one", "three"))
            a, b = _scores_by_id(one), _scores_by_id(three)
            assert one["hits"]["total"] == three["hits"]["total"] == len(a) == len(b)
            assert a.keys() == b.keys()
            assert all(_within_ulps(a[i], b[i], 2) for i in a), (query, base)
            plain = _scores_by_id(call(base, "POST", f"/three{sim}/_search", body)[1])
            differs += any(not _within_ulps(a[i], plain[i], 2) for i in a)
    assert differs > 0


def test_dfs_request_never_enters_the_batcher(dfs_nodes, monkeypatch):
    pbase, _jbase, p = dfs_nodes
    entered = []
    real = DeviceBatcher.execute

    def counting(self, plan, ctx, k, deadline=None, **kw):
        entered.append(bool(ctx.global_stats))
        return real(self, plan, ctx, k, **({"deadline": deadline} if deadline else {}))

    monkeypatch.setattr(DeviceBatcher, "execute", counting)
    body = {"query": {"match": {"body": "w1 w2"}}}
    direct = p.search_batcher.stats()["direct"]
    st, r = call(pbase, "POST", "/three/_search?search_type=dfs_query_then_fetch", body)
    assert st == 200 and r["hits"]["total"] > 0
    assert entered == []
    assert p.search_batcher.stats()["direct"] - direct == 3
    st, r = call(pbase, "POST", "/three/_search", body)
    assert st == 200 and entered == [False] * 3


def test_concurrent_dfs_and_plain_on_one_pack(shards):
    """DFS and plain requests on shard 0's pack at once, through one
    batcher, from 16 threads: each equals its answer alone, and the pack's
    similarity tables flipped between the two statistics."""
    jctxs, tctxs, name = shards
    query = {"bool": {"should": [{"term": {"body": "w1"}}, {"term": {"body": "w5"}},
                                 {"term": {"title": "w2"}}]}}
    body = {"query": query, "size": 12}
    _jagg, tagg = _global_stats(jctxs, tctxs, query)
    base = tctxs[0]
    batcher = DeviceBatcher(TSettings.from_flat({"search.batch.linger_ms": "2"}))

    def ctx(dfs: bool):
        return ShardContext(base.searcher, base.mapper_service, base.similarity_service,
                            device="cpu", batcher=batcher,
                            global_stats=tagg if dfs else None)

    try:
        alone = {dfs: execute_query_phase(ctx(dfs), parse_search_body(body)).docs
                 for dfs in (False, True)}
        assert alone[False] != alone[True]
        swaps = SIM_SWAPS["changed"]
        got: list = []
        errors: list = []

        def worker(i):
            try:
                for j in range(6):
                    dfs = (i + j) % 2 == 0
                    got.append((dfs, execute_query_phase(ctx(dfs),
                                                         parse_search_body(body)).docs))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        batcher.shutdown()
    assert not errors, errors[:3]
    assert len(got) == 96
    assert all(docs == alone[dfs] for dfs, docs in got)
    # BM25's tables hold avgdl, which DFS changes; TF-IDF's do not
    flips = SIM_SWAPS["changed"] - swaps
    assert flips > 0 if name == "bm25" else flips == 0
