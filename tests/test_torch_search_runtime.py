"""The rest of the port's search runtime against the JAX package: rescore
(search/service.py `_apply_rescore`), the REST scroll and scan, `_count`,
`_msearch`, `?q=`, `?preference=` (cluster/routing.py `split_preference`)
and `?search_type=`.

Rescore, module against module on the documents of
tests/test_search_runtime.py (two segments): tests/test_search_runtime.py
TestRescore's assertions on the port, and every `score_mode`, a window
smaller than the hits, two rescore specs in a row and a rescore under a
sort give the JAX package's response bitwise (both serve a rescore on the
host path; the port's device branches never take one).

Node against node over REST (a 3-shard index, the JAX node with its mesh
and warmer off): the hits and `_shards` of every case equal the JAX
node's — scroll pages through the buffered top `max(size, 10) * 10` hits
with `hits.total` the buffer's length (the scroll id in the body, as the
raw body, in the path and as `?scroll_id=`), `search_type=scan` answers its
first page with no hits, a cleared or unknown id answers 404
SearchContextMissingException; `_count` on its three routes, with a body
and with `?q=`; `_msearch` with an item on a missing index answered in its
place; `?q=` query strings; `?preference=` `_shards:`, `_primary`,
`_local`, `_prefer_node:`, `_only_node:` and a custom string; every
`search_type` value the JAX node
serves, and an unknown one, which both serve as `query_then_fetch`.
`split_preference` equals the JAX one over a grammar table. The `_search`
parameters `profile` and `trace` and the body key `profile` answer 400 on
the port, naming their slice (A7); the parameter `fields` and the body keys
`suggest`, `highlight` and `explain`, refused until the fetch slice (A6b),
give the JAX node's answer."""

import json

import pytest

from elasticsearch_tpu_torch.cluster.routing import OperationRouting
from elasticsearch_tpu_torch.common.errors import QueryParsingError
from elasticsearch_tpu_torch.index.engine import Engine as TEngine
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.search import ShardContext, parse_search_body
from elasticsearch_tpu_torch.search.service import (
    SERVING_COUNTERS, execute_query_phase, reduce_and_respond)
from tests.test_torch_node import _bulk_and_refresh, _node_pair, call

PRODUCTS = [
    {"name": "red widget deluxe", "category": "widgets", "price": 10, "stock": 5,
     "created": "2014-01-15", "loc": {"lat": 40.7, "lon": -74.0}},
    {"name": "blue widget", "category": "widgets", "price": 20, "stock": 0,
     "created": "2014-01-20", "loc": {"lat": 40.8, "lon": -73.9}},
    {"name": "green gadget", "category": "gadgets", "price": 30, "stock": 7,
     "created": "2014-02-05", "loc": {"lat": 34.0, "lon": -118.2}},
    {"name": "red gadget pro", "category": "gadgets", "price": 40, "stock": 2,
     "created": "2014-02-10", "loc": {"lat": 37.7, "lon": -122.4}},
    {"name": "yellow gizmo", "category": "gizmos", "price": 50, "stock": 1,
     "created": "2014-03-01", "loc": {"lat": 41.8, "lon": -87.6}},
    {"name": "red gizmo mini widget", "category": "gizmos", "price": 60, "stock": 9,
     "created": "2014-03-15", "loc": {"lat": 29.7, "lon": -95.3}},
]
MAPPING = {"properties": {
    "name": {"type": "string"},
    "category": {"type": "string", "index": "not_analyzed"},
    "price": {"type": "long"},
    "stock": {"type": "long"},
    "created": {"type": "date"},
    "loc": {"type": "geo_point"},
}}


@pytest.fixture(scope="module")
def ctxs(tmp_path_factory):
    """(JAX context, port context) over PRODUCTS in two segments."""
    from elasticsearch_tpu.index import Engine as JEngine
    from elasticsearch_tpu.mapper import MapperService as JMapperService
    from elasticsearch_tpu.search import ShardContext as JShardContext

    out, engines = [], []
    for mapper, engine, make in ((JMapperService(), JEngine, JShardContext),
                                 (TMapperService(), TEngine, None)):
        mapper.put_mapping("product", MAPPING)
        e = engine(str(tmp_path_factory.mktemp("products")), mapper)
        engines.append(e)
        for i, p in enumerate(PRODUCTS):
            e.index("product", str(i), p)
            if i == 2:
                e.refresh()
        e.refresh()
        out.append(make(e.acquire_searcher(), mapper) if make else
                   ShardContext(e.acquire_searcher(), mapper, device="cpu"))
    yield tuple(out)
    for e in engines:
        e.close()


def _jax_run(jctx, body):
    from elasticsearch_tpu.common.jaxenv import compile_tag
    from elasticsearch_tpu.search.service import execute_query_phase as jphase
    from elasticsearch_tpu.search.service import parse_search_body as jparse
    from elasticsearch_tpu.search.service import reduce_and_respond as jrespond

    req = jparse(body)
    with compile_tag("sparse"):
        return jrespond(jctx, req, jphase(jctx, req))


def _run(ctx, body):
    req = parse_search_body(body)
    return reduce_and_respond(ctx, req, execute_query_phase(ctx, req))


def _rescore(mode="total", window=10, qw=1.0, rw=100.0, text="widget"):
    return {"window_size": window,
            "query": {"rescore_query": {"match": {"name": text}}, "query_weight": qw,
                      "rescore_query_weight": rw, "score_mode": mode}}


def test_rescore_total(ctxs):
    """tests/test_search_runtime.py TestRescore on the port."""
    _jctx, ctx = ctxs
    base = _run(ctx, {"query": {"match": {"name": "red"}}, "size": 10})
    r = _run(ctx, {"query": {"match": {"name": "red"}}, "size": 10, "rescore": {
        "window_size": 10,
        "query": {"rescore_query": {"match": {"name": "widget"}},
                  "query_weight": 1.0, "rescore_query_weight": 100.0}}})
    top = r["hits"]["hits"][0]
    assert "widget" in top["_source"]["name"]
    assert top["_score"] > base["hits"]["hits"][0]["_score"]


RESCORE_BODIES = [
    {"query": {"match": {"name": "red gadget"}}, "rescore": _rescore(mode)}
    for mode in ("total", "multiply", "avg", "max", "min")
] + [
    {"query": {"match": {"name": "red widget gizmo"}}, "size": 4,
     "rescore": _rescore(window=2, qw=0.5, rw=3.0, text="gizmo")},
    {"query": {"match_all": {}}, "rescore": [_rescore(text="red"),
                                             _rescore("multiply", 3, rw=2.0, text="mini")]},
    {"query": {"match": {"name": "red widget"}}, "sort": [{"price": "desc"}],
     "track_scores": True, "rescore": _rescore(window=3)},
    {"query": {"match": {"name": "widget"}}, "from": 1, "size": 2,
     "rescore": _rescore("avg", window=4, text="blue")},
]


@pytest.mark.parametrize("body", RESCORE_BODIES,
                         ids=[f"r{i}" for i in range(len(RESCORE_BODIES))])
def test_rescore_matches_jax_on_the_host_path(ctxs, body):
    jctx, ctx = ctxs
    before = dict(SERVING_COUNTERS)
    got = _run(ctx, body)
    moved = {k: v - before[k] for k, v in SERVING_COUNTERS.items() if v != before[k]}
    assert moved == {"host": 1}  # no device branch takes a rescore
    assert got["hits"] == _jax_run(jctx, body)["hits"]


def test_unknown_score_mode_raises_on_both(ctxs):
    from elasticsearch_tpu.common.errors import QueryParsingError as JQueryParsingError

    jctx, ctx = ctxs
    body = {"query": {"match": {"name": "red"}}, "rescore": _rescore("median")}
    with pytest.raises(QueryParsingError, match="score_mode"):
        _run(ctx, body)
    with pytest.raises(JQueryParsingError, match="score_mode"):
        _jax_run(jctx, body)


# split_preference over the grammar
PREFERENCES = [None, "", "_local", "_primary", "custom-key", "_only_node:n1",
               "_shards:0", "_shards:0,2", "_shards:1;_primary", "_shards:0, 2;",
               "_shards:2;_prefer_node:x", "_shards:"]


@pytest.mark.parametrize("pref", PREFERENCES, ids=[f"p{i}" for i in range(len(PREFERENCES))])
def test_split_preference_matches_jax(pref):
    from elasticsearch_tpu.cluster.routing import OperationRouting as JRouting

    assert OperationRouting.split_preference(pref) == JRouting.split_preference(pref)


# ---------------------------------------------------------------------------
# node against node over REST
# ---------------------------------------------------------------------------

WORDS = [f"w{i}" for i in range(20)]


def _docs_bulk() -> str:
    lines = []
    for i in range(260):
        words = [WORDS[(i * 7 + j * 3) % len(WORDS)] for j in range(2 + i % 9)]
        lines += [{"index": {"_index": "rt", "_type": "doc", "_id": str(i)}},
                  {"body": " ".join(words), "title": WORDS[i % 13], "n": i}]
    return "\n".join(json.dumps(x) for x in lines) + "\n"


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    def fill(base):
        st, r = call(base, "PUT", "/rt", {"settings": {"number_of_shards": 3,
                                                       "refresh_interval": -1}})
        assert st == 200, r
        _bulk_and_refresh(base, [_docs_bulk()])

    yield from _node_pair(tmp_path_factory, fill)


def _both(nodes, method, path, body=None, raw=None):
    pbase, jbase, _p = nodes
    (pst, pr), (jst, jr) = (call(b, method, path, body, raw=raw) for b in (pbase, jbase))
    assert pst == jst, (path, pr, jr)
    return pst, pr, jr


def _same_hits(nodes, method, path, body=None):
    st, pr, jr = _both(nodes, method, path, body)
    assert st == 200, (path, pr)
    assert (pr["hits"], pr["_shards"]) == (jr["hits"], jr["_shards"]), path
    return pr


def _walk(base, first, how: str) -> list:
    """The pages after `first`, asking for each by `how`, until an empty
    page; each page's `hits.total` and the id it answers."""
    sid, pages = first["_scroll_id"], []
    for _ in range(40):
        if how == "body":
            st, r = call(base, "POST", "/_search/scroll", {"scroll_id": sid, "scroll": "1m"})
        elif how == "raw":
            st, r = call(base, "POST", "/_search/scroll?scroll=1m", raw=sid)
        elif how == "path":
            st, r = call(base, "GET", f"/_search/scroll/{sid}")
        else:
            st, r = call(base, "GET", f"/_search/scroll?scroll_id={sid}")
        assert st == 200 and r["_scroll_id"] == sid, r
        pages.append((r["hits"]["total"], r["hits"]["hits"], r["_shards"]))
        if not r["hits"]["hits"]:
            return pages
    raise AssertionError("the scroll never ended")


@pytest.mark.parametrize("how", ["body", "raw", "path", "param"])
@pytest.mark.parametrize("search_type", ["query_then_fetch", "scan"])
def test_scroll_pages_match_jax(nodes, how, search_type):
    pbase, jbase, _p = nodes
    body = {"query": {"match": {"body": "w1 w2 w3"}}, "size": 7}
    path = f"/rt/_search?scroll=1m&search_type={search_type}"
    firsts = [call(b, "POST", path, body)[1] for b in (pbase, jbase)]
    pf, jf = firsts
    assert (pf["hits"], pf["_shards"]) == (jf["hits"], jf["_shards"])
    if search_type == "scan":
        assert pf["hits"]["hits"] == []
    else:
        assert len(pf["hits"]["hits"]) == 7
    pages = [_walk(b, f, how) for b, f in zip((pbase, jbase), firsts)]
    assert pages[0] == pages[1]
    full = call(pbase, "POST", "/rt/_search", {**body, "size": 100})[1]["hits"]["hits"]
    walked = ([] if search_type == "scan" else pf["hits"]["hits"]) + \
        [h for _t, hits, _s in pages[0] for h in hits]
    assert walked == full and len(full) == 100  # the buffered top max(7, 10) * 10
    assert {t for t, _h, _s in pages[0]} == {100}


def test_clear_and_missing_scroll_ids_match_jax(nodes):
    pbase, jbase, _p = nodes
    body = {"query": {"match": {"body": "w4"}}, "size": 3}
    sids = [[call(b, "POST", "/rt/_search?scroll=1m", body)[1]["_scroll_id"]
             for _ in range(3)] for b in (pbase, jbase)]
    for base, (a, b, c) in zip((pbase, jbase), sids):
        st, r = call(base, "DELETE", f"/_search/scroll/{a}")
        assert (st, r) == (200, {"succeeded": True})
        st, r = call(base, "DELETE", "/_search/scroll", {"scroll_id": [b]})
        assert (st, r) == (200, {"succeeded": True})
        st, r = call(base, "DELETE", "/_search/scroll", {"scroll_id": c})
        assert (st, r) == (200, {"succeeded": True})
    for i in range(3):
        (pst, pr), (jst, jr) = (call(base, "POST", "/_search/scroll",
                                     {"scroll_id": s[i]})
                                for base, s in zip((pbase, jbase), sids))
        assert pst == jst == 404 and pr == jr
        assert pr["error"]["type"] == "SearchContextMissingException"
    st, pr, jr = _both(nodes, "GET", "/_search/scroll/no-such-id")
    assert st == 404 and pr == jr


@pytest.mark.parametrize("path", ["/_count", "/rt/_count", "/rt/doc/_count"])
def test_count_routes_match_jax(nodes, path):
    for body, suffix in (({"query": {"match": {"body": "w5 w6"}}}, ""), (None, ""),
                         (None, "?q=body:w7"), ({"query": {"term": {"n": 3}}}, "")):
        st, pr, jr = _both(nodes, "POST" if body else "GET", path + suffix, body)
        assert st == 200 and pr == jr, (path, suffix)
        assert pr["count"] == call(nodes[0], "POST", "/rt/_search" + suffix,
                                   {**(body or {}), "size": 0})[1]["hits"]["total"]


def test_msearch_matches_jax_with_an_error_in_place(nodes):
    items = [({"index": "rt"}, {"query": {"match": {"body": "w8"}}, "size": 4}),
             ({"index": "nope"}, {"query": {"match_all": {}}}),
             ({}, {"query": {"term": {"title": "w3"}}, "size": 2}),
             ({"index": "rt"}, {"query": {"match": {"body": "w9 w10"}}, "size": 0,
                                "aggs": {"m": {"max": {"field": "n"}}}})]
    raw = "".join(json.dumps(h) + "\n" + json.dumps(b) + "\n" for h, b in items)
    for path in ("/_msearch", "/rt/_msearch"):
        st, pr, jr = _both(nodes, "POST", path, raw=raw)
        assert st == 200 and len(pr["responses"]) == len(jr["responses"]) == 4
        for i, (p, j) in enumerate(zip(pr["responses"], jr["responses"])):
            if i == 1:
                assert p == j and p["status"] == 404
                assert p["error"].startswith("IndexMissingException")
                continue
            assert (p["hits"], p["_shards"]) == (j["hits"], j["_shards"])
            if "aggregations" in j:
                assert p["aggregations"] == j["aggregations"]
    one = call(nodes[0], "POST", "/rt/_search", items[0][1])[1]
    assert pr["responses"][0]["hits"] == one["hits"]


@pytest.mark.parametrize("q", ["body:w11", "w12", "body:w1 AND body:w2", "title:w4 OR title:w5",
                               "body:\"w3 w6\"", "n:[10 TO 20]"])
def test_query_string_param_matches_jax(nodes, q):
    from urllib.parse import quote

    pr = _same_hits(nodes, "GET", f"/rt/_search?q={quote(q)}&size=30")
    assert pr["hits"]["total"] > 0, q


@pytest.mark.parametrize("pref", ["_shards:0,2", "_shards:1;_primary", "_primary", "_local",
                                  "session-7", "_shards:2;custom", "_prefer_node:nowhere"])
def test_preference_matches_jax(nodes, pref):
    body = {"query": {"match": {"body": "w1 w13"}}, "size": 50}
    pr = _same_hits(nodes, "POST", f"/rt/_search?preference={pref}", body)
    only, _copy = OperationRouting.split_preference(pref)
    if only is not None:
        assert pr["_shards"]["total"] == len(only)
        assert {h["_shard"] for h in pr["hits"]["hits"]} <= only
        # the total is those shards' count
        per = {sid: call(nodes[0], "POST", f"/rt/_search?preference=_shards:{sid}",
                         {**body, "size": 0})[1]["hits"]["total"] for sid in range(3)}
        assert pr["hits"]["total"] == sum(per[s] for s in only)


@pytest.mark.parametrize("search_type", ["query_then_fetch", "query_and_fetch",
                                         "dfs_query_then_fetch", "dfs_query_and_fetch",
                                         "count", "scan", "no_such_type"])
def test_search_types_match_jax(nodes, search_type):
    """Every value the JAX node serves; it serves an unknown one (and `count`
    and `scan` without a scroll) as `query_then_fetch`, and so does the
    port."""
    body = {"query": {"match": {"body": "w2 w14"}}, "size": 15}
    pr = _same_hits(nodes, "POST", f"/rt/_search?search_type={search_type}", body)
    if not search_type.startswith("dfs_"):
        plain = call(nodes[0], "POST", "/rt/_search", body)[1]
        assert pr["hits"] == plain["hits"]


@pytest.mark.parametrize("param", ["fields=body", "profile=true", "trace=true"])
def test_later_search_params_answer_400(nodes, param):
    """`profile` and `trace` answer 400 naming A7; `fields`, served since
    the fetch slice (A6b), gives the JAX node's hits."""
    if param.startswith("fields"):
        pr = _same_hits(nodes, "GET", f"/rt/_search?{param}&q=body:w1", None)
        assert all("fields" in h and "_source" not in h for h in pr["hits"]["hits"])
        return
    st, r = call(nodes[0], "GET", f"/rt/_search?{param}")
    assert st == 400 and "later slices" in r["error"]["reason"]
    assert "A7" in r["error"]["reason"]


@pytest.mark.parametrize("key,value", [("suggest", {"s": {"text": "w1", "term": {"field": "body"}}}),
                                       ("highlight", {"fields": {"body": {}}}),
                                       ("explain", True), ("profile", True)])
def test_later_body_keys_answer_400(nodes, key, value):
    """`profile` answers 400 naming A7; `suggest`, `highlight` and `explain`,
    served since the fetch slice (A6b), give the JAX node's answer."""
    body = {"query": {"match": {"body": "w1"}}, key: value}
    if key != "profile":
        pr = _same_hits(nodes, "POST", "/rt/_search", body)
        if key == "suggest":
            _st, pr, jr = _both(nodes, "POST", "/rt/_search", body)
            assert pr["suggest"] and pr["suggest"] == jr["suggest"]
        if key == "highlight":
            assert all("highlight" in h for h in pr["hits"]["hits"])
        return
    st, r = call(nodes[0], "POST", "/rt/_search", body)
    assert st == 400 and r["error"]["type"] == "QueryParsingException"
    assert "later slices" in r["error"]["reason"]
    assert "A7" in r["error"]["reason"]


def test_only_node_preference_matches_jax(nodes):
    """`_only_node:` naming a node that holds no copy answers the same
    error on both nodes; naming the node itself searches as usual."""
    pbase, jbase, p = nodes
    body = {"query": {"match": {"body": "w2"}}}
    st, pr, jr = _both(nodes, "POST", "/rt/_search?preference=_only_node:nowhere", body)
    assert st == pr["status"] == jr["status"] and pr["error"]["type"] == jr["error"]["type"]
    mine = call(pbase, "POST", f"/rt/_search?preference=_only_node:{p.node_id}", body)[1]
    assert mine["hits"] == call(pbase, "POST", "/rt/_search", body)[1]["hits"]
