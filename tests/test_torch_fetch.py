"""The fetch phase of the port (search/fetch.py) against the JAX package's:
highlighting (plain and fast-vector), `fields` / `stored_fields`,
`script_fields`, `version` and `explain`.

Module against module, on the same seeded documents in two segments through
both packages' `execute_query_phase` → `reduce_and_respond`: the invariants
of tests/test_search_runtime.py `TestFetch` and tests/test_suggest_highlight.py
`TestFvhHighlight` on the port, and for every body the hits JSON equal to the
JAX package's (scores bitwise, highlights, fields and script values as
JSON). Pinned on both packages: a multi-field sub-field and a `copy_to`
target have no `_source` value of their own, so `fields` and `highlight`
leave them out; a script field that raises answers `[None]`.

Node against node over REST (a 3-shard index, the JAX node with its mesh and
warmer off): the same bodies through `_search` and `_msearch` give the JAX
node's hits, and a highlighted `bool` still runs on the card's sparse path
(`device_sparse` on every shard)."""

import json

import numpy as np
import pytest

from elasticsearch_tpu_torch.index.engine import Engine as TEngine
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.search import ShardContext, parse_search_body
from elasticsearch_tpu_torch.search.fetch import extract_field
from elasticsearch_tpu_torch.search.service import (
    SERVING_COUNTERS, execute_fetch_phase, execute_query_phase, reduce_and_respond)
from tests.test_torch_node import _bulk_and_refresh, _node_pair, call
from tests.test_torch_search_runtime import MAPPING as PRODUCT_MAPPING
from tests.test_torch_search_runtime import PRODUCTS

VOCAB = ["quick", "brown", "fox", "lazy", "dog", "sleeps", "thinking", "saves",
         "river", "stone", "green", "turtle", "night", "market", "search",
         "engine", "shard", "index", "token", "phrase"]
MAPPING = {"properties": {
    "title": {"type": "string", "fields": {"raw": {"type": "string",
                                                   "index": "not_analyzed"}},
              "copy_to": "all_text"},
    "body": {"type": "string"},
    "all_text": {"type": "string"},
    "n": {"type": "integer"},
    "meta": {"properties": {"tag": {"type": "string", "index": "not_analyzed"}}},
}}


def _sentence(rng, n) -> str:
    words = rng.choice(VOCAB, n)
    return " ".join(words).capitalize() + "."


def _documents(n_docs: int = 40, seed: int = 1601) -> list[dict]:
    """Seeded documents: a short title, a body of 1-4 sentences, an integer
    and a keyword tag; the first is TestFvhHighlight's text."""
    rng = np.random.default_rng(seed)
    docs = [{"title": "quick fox", "n": 0, "meta": {"tag": "t0"},
             "body": "The quick brown fox. A lazy dog sleeps here. "
                     "Quick thinking saves the quick brown fox again."}]
    for i in range(1, n_docs):
        body = " ".join(_sentence(rng, int(rng.integers(3, 12)))
                        for _ in range(int(rng.integers(1, 5))))
        docs.append({"title": " ".join(rng.choice(VOCAB, int(rng.integers(1, 4)))),
                     "body": body, "n": i, "meta": {"tag": f"t{i % 5}"}})
    return docs


def _contexts(tmp_path_factory, mapping, docs, type_name, split):
    """(JAX context, port context, engines) over `docs` in two segments."""
    from elasticsearch_tpu.index import Engine as JEngine
    from elasticsearch_tpu.mapper import MapperService as JMapperService
    from elasticsearch_tpu.search import ShardContext as JShardContext

    out, engines = [], []
    for mapper, engine in ((JMapperService(), JEngine), (TMapperService(), TEngine)):
        mapper.put_mapping(type_name, mapping)
        e = engine(str(tmp_path_factory.mktemp("fetch")), mapper)
        engines.append(e)
        for i, d in enumerate(docs):
            e.index(type_name, str(i), d)
            if i == split:
                e.refresh()
        e.refresh()
        out.append(mapper)
    jctx = JShardContext(engines[0].acquire_searcher(), out[0])
    tctx = ShardContext(engines[1].acquire_searcher(), out[1], device="cpu")
    return jctx, tctx, engines


@pytest.fixture(scope="module")
def ctxs(tmp_path_factory):
    jctx, tctx, engines = _contexts(tmp_path_factory, MAPPING, _documents(), "doc", 20)
    yield jctx, tctx
    for e in engines:
        e.close()


@pytest.fixture(scope="module")
def products(tmp_path_factory):
    jctx, tctx, engines = _contexts(tmp_path_factory, PRODUCT_MAPPING, PRODUCTS,
                                    "product", 2)
    yield jctx, tctx
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


# -- tests/test_search_runtime.py TestFetch, on the port ---------------------

def test_source_filtering(products):
    _j, ctx = products
    r = _run(ctx, {"query": {"ids": {"values": ["0"]}},
                   "_source": {"includes": ["name", "price"]}})
    assert set(r["hits"]["hits"][0]["_source"]) == {"name", "price"}
    r = _run(ctx, {"query": {"ids": {"values": ["0"]}}, "_source": False})
    assert "_source" not in r["hits"]["hits"][0]


def test_fields_and_version(products):
    _j, ctx = products
    r = _run(ctx, {"query": {"ids": {"values": ["2"]}},
                   "fields": ["category", "price"], "version": True})
    h = r["hits"]["hits"][0]
    assert h["fields"] == {"category": ["gadgets"], "price": [30]}
    assert h["_version"] == 1
    assert "_source" not in h  # a fields list leaves the source out


def test_script_fields(products):
    _j, ctx = products
    r = _run(ctx, {"query": {"ids": {"values": ["1"]}}, "script_fields": {
        "double_price": {"script": "doc['price'].value * 2"}}})
    assert r["hits"]["hits"][0]["fields"]["double_price"] == [40.0]


def test_highlight(products):
    _j, ctx = products
    r = _run(ctx, {"query": {"match": {"name": "red"}},
                   "highlight": {"fields": {"name": {}}}})
    assert r["hits"]["hits"]
    for h in r["hits"]["hits"]:
        assert "<em>red</em>" in h["highlight"]["name"][0]


# -- tests/test_suggest_highlight.py TestFvhHighlight, on the port ------------

def _fvh_hits(ctx, body):
    req = parse_search_body(body)
    qr = execute_query_phase(ctx, req, shard_id=0)
    return execute_fetch_phase(ctx, req, qr.docs)


def _first_doc(hits):
    (h,) = [h for h in hits if h["_id"] == "0"]
    return h


def test_phrase_highlighted_as_unit(ctxs):
    _j, ctx = ctxs
    hits = _fvh_hits(ctx, {"query": {"match_phrase": {"body": "quick brown fox"}},
                           "highlight": {"type": "fvh", "fields": {"body": {}}}})
    joined = " ".join(_first_doc(hits)["highlight"]["body"])
    assert "<em>quick brown fox</em>" in joined.lower().replace(
        "<em>quick</em> <em>brown</em> <em>fox</em>", "MULTI")
    assert "MULTI" not in joined


def test_fragment_scoring_prefers_denser(ctxs):
    _j, ctx = ctxs
    hits = _fvh_hits(ctx, {"query": {"match": {"body": "quick"}},
                           "highlight": {"type": "fvh", "fields": {"body": {
                               "fragment_size": 45, "number_of_fragments": 1}}}})
    frag = _first_doc(hits)["highlight"]["body"][0]
    assert frag.lower().count("<em>quick</em>") >= 2


def test_plain_still_works(ctxs):
    _j, ctx = ctxs
    hits = _fvh_hits(ctx, {"query": {"match": {"body": "fox"}},
                           "highlight": {"fields": {"body": {}}}})
    assert any("<em>fox</em>" in f.lower() for f in _first_doc(hits)["highlight"]["body"])


# -- module against module --------------------------------------------------

FETCH_BODIES = {
    "plain": {"query": {"match": {"body": "quick fox"}},
              "highlight": {"fields": {"body": {}}}},
    "fvh": {"query": {"match": {"body": "quick fox"}},
            "highlight": {"type": "fvh", "fields": {"body": {}}}},
    "phrase_fvh": {"query": {"match_phrase": {"body": "brown fox"}},
                   "highlight": {"fields": {"body": {"type": "fvh"}}}},
    "phrase_plain": {"query": {"match_phrase": {"body": "brown fox"}},
                     "highlight": {"fields": {"body": {}}}},
    "two_fields": {"query": {"bool": {"should": [{"match": {"body": "river stone"}},
                                                 {"match": {"title": "green"}}]}},
                   "highlight": {"pre_tags": ["<b>"], "post_tags": ["</b>"], "fields": {
                       "title": {}, "body": {"type": "fvh", "fragment_size": 40,
                                             "number_of_fragments": 2}}}},
    "multi_match": {"query": {"multi_match": {"query": "search engine",
                                              "fields": ["title^2", "body"]}},
                    "highlight": {"fields": {"title": {"type": "fvh"}, "body": {}}}},
    "query_string": {"query": {"query_string": {"query": "body:night OR title:market"}},
                     "highlight": {"fields": {"body": {}, "title": {}}}},
    "filtered": {"query": {"filtered": {"query": {"match": {"body": "token"}},
                                        "filter": {"range": {"n": {"gte": 5}}}}},
                 "highlight": {"fields": {"body": {"number_of_fragments": 0}}}},
    "whole_field_fvh": {"query": {"match": {"body": "shard index"}},
                        "highlight": {"type": "fvh", "number_of_fragments": 0,
                                      "fields": {"body": {}}}},
    "all_field": {"query": {"match": {"_all": "phrase"}},
                  "highlight": {"fields": {"body": {}, "title": {}}}},
    "postings": {"query": {"match": {"body": "lazy dog"}},
                 "highlight": {"type": "postings", "fields": {"body": {
                     "boundary_max_scan": 5, "fragment_size": 30}}}},
    "small_fragments": {"query": {"match": {"body": "the quick"}},
                        "highlight": {"fragment_size": 12, "number_of_fragments": 3,
                                      "fields": {"body": {"pre_tags": ["["],
                                                          "post_tags": ["]"]}}}},
    "fields": {"query": {"match": {"body": "fox"}}, "fields": ["title", "n"],
               "version": True},
    "fields_str": {"query": {"match": {"body": "dog"}}, "fields": "title"},
    "fields_source": {"query": {"match": {"body": "dog"}},
                      "fields": ["_source", "meta.tag"]},
    "stored_fields": {"query": {"match": {"body": "stone"}},
                      "stored_fields": ["title", "meta.tag"]},
    "fields_with_source": {"query": {"match": {"body": "river"}}, "fields": ["n"],
                           "_source": {"includes": ["title"]}},
    "script_fields": {"query": {"match": {"body": "green turtle"}}, "script_fields": {
        "twice": {"script": "doc['n'].value * 2"},
        "scored": {"script": "_score * factor", "params": {"factor": 3}}},
        "fields": ["title"]},
    "explain": {"query": {"match": {"body": "night market"}}, "explain": True,
                "version": True, "size": 20},
    "explain_min_score": {"query": {"match": {"body": "night market"}}, "explain": True,
                          "min_score": 0.1},
    "explain_post_filter": {"query": {"match": {"body": "saves"}}, "explain": True,
                            "post_filter": {"term": {"meta.tag": "t1"}}},
    "sorted_version": {"query": {"match": {"body": "engine"}}, "sort": [{"n": "desc"}],
                       "version": True, "highlight": {"fields": {"body": {}}}},
    "page": {"query": {"match": {"body": "quick brown"}}, "from": 3, "size": 4,
             "highlight": {"fields": {"body": {"type": "fvh"}}}, "fields": ["n"]},
}


@pytest.mark.parametrize("name", list(FETCH_BODIES))
def test_fetch_matches_jax(ctxs, name):
    """Hits in the same order with bitwise scores, and the same highlights,
    fields, script values and versions, as the JAX package's."""
    jctx, ctx = ctxs
    body = FETCH_BODIES[name]
    got, want = _run(ctx, body), _jax_run(jctx, body)
    assert got["hits"]["hits"], name
    assert json.dumps(got["hits"], sort_keys=True) == json.dumps(want["hits"],
                                                                 sort_keys=True)


def test_multi_field_and_copy_to_have_no_source_value_on_both(ctxs):
    """`extract_field` reads `_source`: a multi-field sub-field and a
    `copy_to` target hold no value there, so neither `fields` nor
    `highlight` names them (the JAX package's behaviour, pinned)."""
    jctx, ctx = ctxs
    assert extract_field({"title": "quick fox"}, "title.raw") == []
    assert extract_field({"title": "quick fox"}, "all_text") == []
    body = {"query": {"match": {"all_text": "quick"}}, "fields": ["title.raw", "all_text"],
            "highlight": {"fields": {"all_text": {}, "title.raw": {}}}}
    for r in (_run(ctx, body), _jax_run(jctx, body)):
        assert r["hits"]["hits"]
        for h in r["hits"]["hits"]:
            assert "fields" not in h and "highlight" not in h and "_source" not in h


def test_failing_script_field_answers_none_on_both(ctxs):
    """A script field that raises answers `[None]` (the JAX package's bare
    except, pinned): `doc['missing'].value` is None, and None * 2 raises."""
    jctx, ctx = ctxs
    body = {"query": {"match": {"body": "fox"}},
            "script_fields": {"bad": {"script": "doc['missing'].value * 2"}}}
    for r in (_run(ctx, body), _jax_run(jctx, body)):
        assert all(h["fields"] == {"bad": [None]} for h in r["hits"]["hits"])


def test_explain_keeps_gated_bodies_off_the_card(ctxs):
    """`explain` sends a `post_filter` or `min_score` body to the host path,
    as the JAX package's gates do; a plain body stays on the flat plan."""
    _j, ctx = ctxs
    for body, counter in ((FETCH_BODIES["explain_post_filter"], "host"),
                          (FETCH_BODIES["explain_min_score"], "host"),
                          ({**FETCH_BODIES["explain_post_filter"], "explain": False},
                           "device_filtered"),
                          (FETCH_BODIES["explain"], "device_sparse")):
        before = dict(SERVING_COUNTERS)
        _run(ctx, body)
        moved = {k for k, v in SERVING_COUNTERS.items() if v != before[k]}
        assert moved == {counter}, (body, moved)


# -- node against node ---------------------------------------------------------

def _bulk(docs) -> str:
    lines = []
    for i, d in enumerate(docs):
        lines += [{"index": {"_index": "fx", "_type": "doc", "_id": str(i)}}, d]
    return "\n".join(json.dumps(x) for x in lines) + "\n"


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    docs = _documents(90, seed=1602)

    def fill(base):
        st, r = call(base, "PUT", "/fx", {"settings": {"number_of_shards": 3,
                                                       "refresh_interval": -1},
                                          "mappings": {"doc": MAPPING}})
        assert st == 200, r
        _bulk_and_refresh(base, [_bulk(docs[:50]), _bulk(docs[50:])])

    yield from _node_pair(tmp_path_factory, fill)


NODE_BODIES = ["plain", "fvh", "phrase_fvh", "two_fields", "multi_match",
               "fields", "fields_source", "stored_fields", "script_fields", "explain",
               "explain_post_filter", "sorted_version", "page"]


@pytest.mark.parametrize("name", NODE_BODIES)
def test_search_matches_jax_node(nodes, name):
    pbase, jbase, _p = nodes
    body = FETCH_BODIES[name]
    (pst, pr), (jst, jr) = (call(b, "POST", "/fx/_search", body) for b in (pbase, jbase))
    assert pst == jst == 200, (pr, jr)
    assert pr["hits"]["hits"]
    assert (pr["hits"], pr["_shards"]) == (jr["hits"], jr["_shards"])


def test_msearch_and_fields_param_match_jax_node(nodes):
    pbase, jbase, _p = nodes
    ndjson = "".join(json.dumps({"index": "fx"}) + "\n" + json.dumps(FETCH_BODIES[n]) + "\n"
                     for n in ("plain", "fields", "script_fields", "explain"))
    (pst, pr), (jst, jr) = (call(b, "POST", "/_msearch", raw=ndjson) for b in (pbase, jbase))
    assert pst == jst == 200
    assert [r["hits"] for r in pr["responses"]] == [r["hits"] for r in jr["responses"]]
    path = "/fx/_search?q=body:fox&fields=title,n&size=5"
    (pst, pr), (jst, jr) = (call(b, "GET", path) for b in (pbase, jbase))
    assert pst == jst == 200 and pr["hits"] == jr["hits"]
    assert all(set(h) >= {"fields"} and "_source" not in h for h in pr["hits"]["hits"])


def test_highlighted_bool_runs_on_the_sparse_path(nodes):
    pbase, jbase, _p = nodes
    body = {"query": {"bool": {"should": [{"term": {"body": "quick"}},
                                          {"term": {"body": "river"}}]}},
            "highlight": {"fields": {"body": {"type": "fvh"}}}, "fields": ["title"],
            "version": True, "script_fields": {"twice": {"script": "doc['n'].value * 2"}}}
    before = dict(SERVING_COUNTERS)
    pst, pr = call(pbase, "POST", "/fx/_search", body)
    moved = {k: v - before[k] for k, v in SERVING_COUNTERS.items() if v != before[k]}
    assert pst == 200 and moved == {"device_sparse": 3}, moved
    jst, jr = call(jbase, "POST", "/fx/_search", body)
    assert pr["hits"] == jr["hits"] and all("highlight" in h for h in pr["hits"]["hits"])
