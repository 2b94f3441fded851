"""The `indices` query and filter, the `template` query and the terms lookup
on a port node against a JAX node (no JAX test sends them).

Module against module: the template query parses, on both packages, as
the query its `params` render, and `resolve_terms_lookups` rewrites the same bodies the same
way (a path through objects and arrays, a missing document to no terms).

Node against node over REST, on two 3-shard indexes searched together and
apart: the hits and `_shards` of every body equal the JAX node's. The
`indices` query runs on the host scorer on both packages (lower_flat takes
none), against each shard's own index name: the inner query on the named
indexes (patterns too), `no_match_query` elsewhere (match_all by default,
nothing for "none"); the `indices` filter inside `filtered` keeps the
dense family on the card. A terms lookup resolves on the coordinating node
from the lookup document's field (a missing document: no terms; a missing
index: 404 on both)."""

import json

import pytest

from elasticsearch_tpu_torch.search.queries import parse_query, resolve_terms_lookups
from elasticsearch_tpu_torch.search.service import SERVING_COUNTERS
from tests.test_torch_node import _bulk_and_refresh, _node_pair, call

WORDS = [f"w{i}" for i in range(12)]


def _bulk(index, n, offset):
    lines = []
    for i in range(n):
        words = [WORDS[(i * 5 + j * 7 + offset) % len(WORDS)] for j in range(1 + i % 6)]
        lines += [{"index": {"_index": index, "_type": "doc", "_id": str(i)}},
                  {"body": " ".join(words), "tag": WORDS[(i + offset) % 5], "n": i}]
    return "\n".join(json.dumps(x) for x in lines) + "\n"


LOOKUPS = {"u1": {"tags": ["w0", "w2"]},
           "u2": {"profile": {"follows": [{"tag": "w1"}, {"tag": "w3"}], "n": 4}},
           "u3": {"tags": []}}


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    def fill(base):
        for index in ("ia", "ib"):
            st, r = call(base, "PUT", f"/{index}", {
                "settings": {"number_of_shards": 3, "refresh_interval": -1},
                "mappings": {"doc": {"properties": {
                    "tag": {"type": "string", "index": "not_analyzed"}}}}})
            assert st == 200, r
        st, r = call(base, "PUT", "/lk", {"settings": {"number_of_shards": 1}})
        assert st == 200, r
        for i, src in LOOKUPS.items():
            assert call(base, "PUT", f"/lk/user/{i}", src)[0] == 201
        _bulk_and_refresh(base, [_bulk("ia", 70, 0), _bulk("ib", 50, 3)])

    yield from _node_pair(tmp_path_factory, fill)


BODIES = {
    "indices_query": {"query": {"indices": {
        "indices": ["ia"], "query": {"match": {"body": "w1 w2"}},
        "no_match_query": {"term": {"body": "w5"}}}}},
    "indices_default_all": {"query": {"indices": {
        "indices": ["ib"], "query": {"match": {"body": "w4"}}}}, "size": 30},
    "indices_none": {"query": {"indices": {
        "index": "i*", "query": {"match": {"body": "w7"}}, "no_match_query": "none"}}},
    "indices_none_miss": {"query": {"indices": {
        "indices": ["zz*"], "query": {"match": {"body": "w7"}}, "no_match_query": "none"}}},
    "indices_boost": {"query": {"bool": {"should": [
        {"indices": {"indices": ["ib"], "query": {"term": {"body": "w3"}}, "boost": 2.0,
                     "no_match_query": {"term": {"body": "w6"}}}},
        {"match": {"body": "w8"}}]}}},
    "indices_filter": {"query": {"filtered": {
        "query": {"match": {"body": "w0 w9"}},
        "filter": {"indices": {"indices": ["ia"], "filter": {"term": {"tag": "w1"}},
                               "no_match_filter": {"range": {"n": {"lt": 20}}}}}}}},
    "indices_filter_none": {"query": {"filtered": {
        "query": {"match": {"body": "w2"}},
        "filter": {"indices": {"indices": ["ib"], "filter": {"match_all": {}},
                               "no_match_filter": "none"}}}}},
    "template": {"query": {"template": {
        "query": {"match": {"body": "{{word}}"}}, "params": {"word": "w6"}}}},
    "template_string": {"query": {"template": {
        "query": '{"bool": {"must": [{"term": {"tag": "{{t}}"}}], '
                 '"should": [{"term": {"body": "{{w}}"}}]}}',
        "params": {"t": "w2", "w": "w10"}}}},
    "lookup_filter": {"query": {"filtered": {"query": {"match": {"body": "w3 w4"}},
                                             "filter": {"terms": {"tag": {
                                                 "index": "lk", "type": "user", "id": "u1",
                                                 "path": "tags"}}}}}},
    "lookup_path": {"query": {"constant_score": {"filter": {"terms": {"tag": {
        "index": "lk", "type": "user", "id": "u2", "path": "profile.follows.tag"}}}}}},
    "lookup_query": {"query": {"terms": {"tag": {
        "index": "lk", "type": "user", "id": "u1", "path": "tags"}}}},
    "lookup_missing_doc": {"query": {"filtered": {"query": {"match_all": {}},
                                                  "filter": {"terms": {"tag": {
                                                      "index": "lk", "type": "user",
                                                      "id": "nobody", "path": "tags"}}}}}},
    "lookup_empty": {"query": {"filtered": {"query": {"match": {"body": "w1"}},
                                            "filter": {"or": [
                                                {"terms": {"tag": {
                                                    "index": "lk", "type": "user",
                                                    "id": "u3", "path": "tags"}}},
                                                {"term": {"tag": "w4"}}]}}}},
}


def _both(nodes, method, path, body):
    pbase, jbase, _p = nodes
    (pst, pr), (jst, jr) = (call(b, method, path, body) for b in (pbase, jbase))
    for r in (pr, jr):
        r.pop("took", None)
    assert (pst, json.dumps(pr, sort_keys=True)) == (jst, json.dumps(jr, sort_keys=True)), \
        (path, body, pr, jr)
    return pst, pr


@pytest.mark.parametrize("path", ["/ia,ib/_search", "/ib/_search"])
@pytest.mark.parametrize("name", list(BODIES))
def test_matches_jax_node(nodes, name, path):
    st, r = _both(nodes, "POST", path, BODIES[name])
    assert st == 200


def test_device_or_host_as_the_jax_package(nodes):
    """The `indices` query runs on the host scorer; the `indices` filter and
    a resolved terms lookup inside `filtered` on the card's dense family."""
    pbase, _jbase, _p = nodes
    for name, counter in (("indices_query", "host"), ("template", "device_sparse"),
                          ("indices_filter", "device_filtered"),
                          ("lookup_filter", "device_filtered")):
        before = dict(SERVING_COUNTERS)
        assert call(pbase, "POST", "/ia/_search", BODIES[name])[0] == 200
        moved = {k: v - before[k] for k, v in SERVING_COUNTERS.items() if v != before[k]}
        assert moved == {counter: 3}, (name, moved)


def test_lookup_on_a_missing_index_answers_404_on_both(nodes):
    body = {"query": {"filtered": {"filter": {"terms": {"tag": {
        "index": "nope", "type": "user", "id": "u1", "path": "tags"}}}}}}
    st, r = _both(nodes, "POST", "/ia/_search", body)
    assert st == 404 and r["error"]["type"] == "IndexMissingException"


def test_template_parses_as_its_rendered_query_on_both():
    from elasticsearch_tpu.search.queries import parse_query as jparse

    rendered = {"template": {"match": {"body": "w6"}},
                "template_string": {"bool": {"must": [{"term": {"tag": "w2"}}],
                                             "should": [{"term": {"body": "w10"}}]}}}
    for name, want in rendered.items():
        q = BODIES[name]["query"]
        assert parse_query(q) == parse_query(want)
        assert jparse(q) == jparse(want)


def test_resolve_terms_lookups_matches_jax():
    from elasticsearch_tpu.search.queries import resolve_terms_lookups as jresolve

    def get(index, type_name, doc_id, routing=None):
        src = LOOKUPS.get(doc_id)
        return {"found": src is not None, "_source": src}

    for name in ("lookup_filter", "lookup_path", "lookup_query", "lookup_missing_doc",
                 "lookup_empty", "template"):
        body = BODIES[name]
        got = resolve_terms_lookups(body, get)
        assert got == jresolve(body, get)
        assert (got is body) == (name == "template")  # nothing to resolve: the same object
