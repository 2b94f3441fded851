"""A malformed value in a search body fails the shard that reads it, as on
the JAX node (ROADMAP C10): 200 with the reason in `_shards.failures`,
where the port answered 500 with a bare ValueError.

A port node and a JAX node (one process, each on its own in-process
transport) get the same three 2-shard indexes: `one` holds one document
(one shard is empty, so the bodies that fail only where a document is
read fail 1 of 2), `many` holds 40 (every shard reads the value) and `dfr`
holds the same 40 under a DFR default similarity (the host scorer serves
its bodies on both packages). Each of the 13 bodies of C10 —
`minimum_should_match: "abc"` in a `bool` (must, should), `match`,
`terms`, a `filtered` over that `bool`, `_count`, `common` and
`multi_match`; a sort over that `bool`; `min_score: "abc"`; a `range`
aggregation's `from: "abc"`; `rescore.window_size: "x"`; and
`function_score`'s `boost_mode: "nope"` — goes to both nodes on each
index. The status, `_shards` (counts and each failure's index, shard and
reason; the node name is each node's own) and the hits of the shards that
answered are equal, and the port's `device_errors` does not move: the
sparse path (plain `bool`, `match`, `terms`), the dense family
(`filtered`, `min_score`, `function_score`), the sort and aggregation
branches and the host path all meet the value the JAX node meets, where
it meets it. A real host bug and a defect of a launch stay a 500
(tests/test_torch_node.py pins both)."""

import json

import pytest

from elasticsearch_tpu_torch.search.service import SERVING_COUNTERS
from tests.test_torch_node import _node_pair, call

BOOL = {"bool": {"should": [{"term": {"body": "a"}}, {"term": {"body": "b"}}],
                 "minimum_should_match": "abc"}}
BODIES = {
    "bool_should": ("_search", {"query": BOOL}),
    "bool_must": ("_search", {"query": {"bool": {
        "must": [{"term": {"body": "a"}}], "should": [{"term": {"body": "b"}}],
        "minimum_should_match": "abc"}}}),
    "match": ("_search", {"query": {"match": {"body": {
        "query": "a b", "minimum_should_match": "abc"}}}}),
    "terms": ("_search", {"query": {"terms": {"body": ["a", "b"],
                                              "minimum_should_match": "abc"}}}),
    "filtered": ("_search", {"query": {"filtered": {
        "query": BOOL, "filter": {"range": {"n": {"gte": 0}}}}}}),
    "count": ("_count", {"query": BOOL}),
    "common": ("_search", {"query": {"common": {"body": {
        "query": "a b", "minimum_should_match": "abc"}}}}),
    "multi_match": ("_search", {"query": {"multi_match": {
        "query": "a b", "fields": ["body"], "minimum_should_match": "abc"}}}),
    "sorted": ("_search", {"query": BOOL, "sort": [{"n": "asc"}]}),
    "min_score": ("_search", {"query": {"match": {"body": "a"}}, "min_score": "abc"}),
    "range_agg": ("_search", {"query": {"match": {"body": "a"}}, "aggs": {
        "r": {"range": {"field": "n", "ranges": [{"from": "abc"}]}}}}),
    "rescore": ("_search", {"query": {"match": {"body": "a"}}, "rescore": {
        "window_size": "x", "query": {"rescore_query": {"match": {"body": "b"}}}}}),
    "boost_mode": ("_search", {"query": {"function_score": {
        "query": {"match": {"body": "a"}},
        "functions": [{"field_value_factor": {"field": "n"}}],
        "boost_mode": "nope"}}}),
}
TEXTS = ["a b c", "a", "b c", "a a b", "c d", "b b a", "d", "a c"]


def _fill(base):
    indexes = {"one": {}, "many": {},
               "dfr": {"index": {"similarity": {"default": {
                   "type": "DFR", "basic_model": "g", "after_effect": "l",
                   "normalization": "h2"}}}}}
    for name, extra in indexes.items():
        st, r = call(base, "PUT", f"/{name}", {"settings": {
            "number_of_shards": 2, "number_of_replicas": 0, "refresh_interval": -1,
            **extra}})
        assert st == 200, r
    lines = [json.dumps({"index": {"_index": "one", "_type": "doc", "_id": "0"}}),
             json.dumps({"body": "a b c", "n": 0})]
    for name in ("many", "dfr"):
        for i in range(40):
            lines += [json.dumps({"index": {"_index": name, "_type": "doc", "_id": str(i)}}),
                      json.dumps({"body": TEXTS[i % len(TEXTS)], "n": i})]
    st, r = call(base, "POST", "/_bulk", raw="\n".join(lines) + "\n")
    assert st == 200 and not r["errors"], r
    assert call(base, "POST", "/_refresh")[0] == 200


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    yield from _node_pair(tmp_path_factory, _fill, names=("c10", "c10"))


@pytest.mark.parametrize("index", ["one", "many", "dfr"])
@pytest.mark.parametrize("name", list(BODIES))
def test_malformed_value_fails_the_shard_as_on_the_jax_node(nodes, name, index):
    pbase, jbase, _p = nodes
    route, body = BODIES[name]
    before = SERVING_COUNTERS["device_errors"]
    (pst, pr), (jst, jr) = (call(b, "POST", f"/{index}/{route}", body)
                            for b in (pbase, jbase))
    assert SERVING_COUNTERS["device_errors"] == before
    assert pst == jst == 200, (pr, jr)
    assert pr["_shards"] == jr["_shards"]
    assert pr["_shards"]["failed"] >= 1
    if route == "_count":
        assert pr["count"] == jr["count"]
    else:
        assert pr["hits"] == jr["hits"]


def test_the_reasons_are_the_jax_nodes(nodes):
    pbase, jbase, _p = nodes
    reasons = {}
    for name, (route, body) in BODIES.items():
        (_, pr), (_, jr) = (call(b, "POST", f"/many/{route}", body) for b in (pbase, jbase))
        reasons[name] = {f["reason"] for f in pr["_shards"]["failures"]}
        assert reasons[name] == {f["reason"] for f in jr["_shards"]["failures"]}
    assert reasons["bool_should"] == {"invalid literal for int() with base 10: 'abc'"}
    assert reasons["min_score"] == {"could not convert string to float: 'abc'"}
    assert reasons["rescore"] == {"invalid literal for int() with base 10: 'x'"}
    assert reasons["boost_mode"] == {"unknown boost_mode [nope]"}
