"""A port Node against a JAX Node over HTTP, for analysis, similarities and
the flat mapper (each package on its own in-process transport, the JAX node
with its mesh and warmer off, every index at `refresh_interval: -1`).

- The index bodies and searches of tests/test_similarities.py (every DFR,
  IB and LM family as the index default) and of
  tests/test_analysis_mapper.py (its custom analyzers, mapped onto fields)
  give the same status and hits JSON on both nodes. A phrase or span query
  over a DFR field answers what the JAX node answers (both packages' phrase
  and span paths call `sim.idf`, which DFR lacks).
- A `library`-like index at a few hundred documents (an `english` title with
  `raw` and `shingles` sub-fields, a `body_en` body with html_strip, stop,
  synonyms and porter_stem, `copy_to`, `ip`, `token_count`,
  `_routing.path`, `_timestamp`, BM25 with its own k1 and b): the search
  bodies of `chip_smoke.py` phase 18 (with `ip_range` and a sort on a
  `token_count` field), `PUT` and `GET _mapping` (a merge conflict too),
  a `_routing.required` type (a single-document write without routing
  answers 400 on both; a `_bulk` item without routing is indexed on both),
  and a percolator query on a `body_en` field give the same answers.
- `DELETE _mapping` of a type of its own (at both routes) drops the type
  and its documents as on the JAX node.
- A restart over `path.data` keeps the custom analyzer, the multi-fields,
  the copy_to target and the DFR default, with the same hits as before and
  as the restarted JAX node."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg
from tests.test_torch_node import call

# --- tests/test_similarities.py -------------------------------------------

SIM_DOCS = [
    "fox fox fox fox",
    "fox",
    "fox and dog and cat and bird and bee",
    "dog dog dog",
    "common common common fox",
    "common word soup without the animal",
]
SIM_INDEXES = {
    "dfr": {"type": "DFR"},
    "dfr_in": {"type": "DFR", "basic_model": "in", "after_effect": "b",
               "normalization": "h1"},
    "dfr_be": {"type": "DFR", "basic_model": "be", "normalization": "no"},
    "ib": {"type": "IB"},
    "ib_spl": {"type": "IB", "distribution": "spl", "lambda": "ttf"},
    "lmd": {"type": "LMDirichlet", "mu": 10},
    "lmjm": {"type": "LMJelinekMercer"},
}
SIM_BODIES = [
    {"query": {"match": {"body": "fox"}}},
    {"query": {"bool": {"must": [{"term": {"body": "fox"}}],
                        "should": [{"term": {"body": "common"}}]}}},
    {"query": {"match": {"body": "fox dog bee"}}, "size": 3},
    {"query": {"multi_match": {"query": "common fox", "fields": ["body", "_all"]}}},
]
SPAN_BODIES = [
    {"query": {"match_phrase": {"body": "fox dog"}}},
    {"query": {"match_phrase": {"body": "common fox"}}},
    {"query": {"span_near": {"clauses": [{"span_term": {"body": "fox"}},
                                         {"span_term": {"body": "dog"}}],
                             "slop": 2, "in_order": True}}},
]

# --- tests/test_analysis_mapper.py::TestAnalysis, mapped onto fields ------

AN_SETTINGS = {"analysis": {
    "analyzer": {
        "my": {"tokenizer": "whitespace", "filter": ["lowercase", "my_stop"]},
        "ng": {"tokenizer": "standard", "filter": ["lowercase", "eg"]},
        "sh": {"tokenizer": "standard", "filter": ["lowercase", "shingle"]},
        "fr": {"tokenizer": "standard", "filter": ["lowercase", "el"]},
        "cg": {"tokenizer": "standard", "filter": ["lowercase", "cg"]},
        "so": {"tokenizer": "standard", "filter": ["lowercase", "so", "porter_stem"]},
        "syn": {"tokenizer": "standard", "filter": ["lowercase", "mysyn"]},
        "h": {"tokenizer": "standard", "char_filter": ["html_strip"],
              "filter": ["lowercase"]},
    },
    "filter": {
        "my_stop": {"type": "stop", "stopwords": ["foo"]},
        "eg": {"type": "edge_ngram", "min_gram": 2, "max_gram": 4},
        "el": {"type": "elision", "articles": ["l", "d"]},
        "cg": {"type": "common_grams", "common_words": ["the", "of"]},
        "so": {"type": "stemmer_override", "rules": ["running => sprint"]},
        "mysyn": {"type": "synonym", "synonyms": ["quick,fast"]},
    }}}
AN_FIELDS = ["my", "ng", "sh", "fr", "cg", "so", "syn", "h"]
AN_TEXTS = ["Foo BAR", "hello", "Quick Brown Fox", "L'avion d'essai",
            "king of spain", "running jumping", "quick", "<b>Bold</b> move",
            "the quick fox jumped over the lazy dog", "fast hello bar"]
AN_MAPPING = {"doc": {"properties": {
    **{f: {"type": "string", "analyzer": f} for f in AN_FIELDS},
    "english": {"type": "string", "analyzer": "english"},
    "simple": {"type": "string", "analyzer": "simple"},
    "kw": {"type": "string", "analyzer": "keyword"},
    "stop": {"type": "string", "analyzer": "stop"},
    "ws": {"type": "string", "analyzer": "whitespace"}}}}
AN_ALL = AN_FIELDS + ["english", "simple", "kw", "stop", "ws"]

# --- the library index of chip_smoke.py phase 18, small ------------------

STEMS = ["run", "jump", "walk", "talk", "play", "work", "read", "cook", "paint",
         "sing", "dance", "climb", "swim", "fish", "hunt", "build", "clean",
         "learn", "teach", "help", "write", "drive", "sail", "grow"]
SUFFIXES = ["", "s", "es", "ed", "ing", "ation", "ness"]
STOP = sorted(["a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if",
               "in", "into", "is", "it", "no", "not", "of", "on", "or", "such",
               "that", "the", "their", "then", "there", "these", "they", "this",
               "to", "was", "will", "with"])
TENANTS = [f"t{i}" for i in range(6)]
LIB_SETTINGS = {
    "number_of_shards": 3,
    "index": {"similarity": {"default": {"type": "BM25", "k1": 1.4, "b": 0.6}}},
    "analysis": {
        "filter": {"syn": {"type": "synonym",
                           "synonyms": ["run,sprint", "jump,leap,hop", "talk,speak"]},
                   "sh": {"type": "shingle", "min_shingle_size": 2,
                          "max_shingle_size": 3}},
        "analyzer": {
            "body_en": {"char_filter": ["html_strip"], "tokenizer": "standard",
                        "filter": ["lowercase", "stop", "syn", "porter_stem"]},
            "shingles": {"tokenizer": "standard", "filter": ["lowercase", "sh"]}}}}
LIB_MAPPING = {
    "_routing": {"path": "tenant"},
    "_timestamp": {"enabled": True, "path": "published"},
    "properties": {
        "title": {"type": "string", "analyzer": "english",
                  "fields": {"raw": {"type": "string", "index": "not_analyzed"},
                             "shingles": {"type": "string", "analyzer": "shingles"}},
                  "copy_to": ["title_shingles", "title_raw"]},
        "title_shingles": {"type": "string", "analyzer": "shingles"},
        "title_raw": {"type": "string", "index": "not_analyzed"},
        "body": {"type": "string", "analyzer": "body_en", "copy_to": "all_text",
                 "fields": {"length": {"type": "token_count",
                                       "analyzer": "standard"}}},
        "words": {"type": "token_count", "analyzer": "standard"},
        "client_ip": {"type": "ip"},
        "views": {"type": "integer"},
        "tenant": {"type": "string", "index": "not_analyzed"},
        "published": {"type": "date"}}}


def _lib_word(rng) -> str:
    if rng.random() < 0.4:
        return str(rng.choice(STOP))
    return STEMS[min(int(rng.zipf(1.2)) - 1, len(STEMS) - 1)] + str(rng.choice(SUFFIXES))


def lib_docs(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = [_lib_word(rng) for _ in range(int(rng.poisson(30)) + 1)]
        body = " ".join(toks)
        if rng.random() < 0.3:
            body = f"<p>{body}</p> <em>{_lib_word(rng)}</em>"
        out.append({
            "title": " ".join(_lib_word(rng) for _ in range(int(rng.integers(6, 13)))),
            "body": body, "words": len(toks),
            "client_ip": "%d.%d.%d.%d" % tuple(int(x) for x in rng.integers(1, 255, 4)),
            "views": int(rng.integers(0, 100_000)), "tenant": str(rng.choice(TENANTS)),
            "published": f"2014-{1 + i % 12:02d}-{1 + i % 28:02d}T08:00:00Z"})
    return out


def lib_bodies(seed: int, n: int, titles: list[str]) -> list[dict]:
    """Phase 18's search families, `n` bodies each, seeded; the exact-match
    family looks up one of `titles`."""
    rng = np.random.default_rng(seed)

    def words(lo, hi):
        return " ".join(STEMS[int(i)] + str(rng.choice(SUFFIXES))
                        for i in rng.integers(0, 12, int(rng.integers(lo, hi + 1))))

    out = []
    for _ in range(n):
        out.append({"query": {"match": {"body": words(2, 4)}}, "size": 10})
        out.append({"query": {"match": {"title_shingles": words(2, 3)}}, "size": 10})
        out.append({"query": {"term": {"title_raw": str(rng.choice(titles))}},
                    "size": 10})
        out.append({"query": {"query_string": {"query": words(2, 3),
                                               "default_field": "all_text",
                                               "analyzer": "english"}}, "size": 10})
        out.append({"query": {"bool": {"should": [
            {"term": {"title": str(rng.choice(STEMS[:12]))}},
            {"term": {"body": str(rng.choice(STEMS[:12]))}},
            {"term": {"title": str(rng.choice(STEMS[:12]))}},
            {"term": {"body": str(rng.choice(STEMS[:12]))}}]}}, "size": 10})
        out.append({"query": {"multi_match": {"query": words(2, 3),
                                              "fields": ["title", "body"]}},
                    "size": 10})
        out.append({"query": {"match": {"body": words(1, 2)}}, "size": 0,
                    "request_cache": False,
                    "aggs": {"ips": {"ip_range": {"field": "client_ip", "ranges": [
                        {"to": "64.0.0.0"}, {"from": "64.0.0.0", "to": "128.0.0.0"},
                        {"from": "128.0.0.0", "to": "200.1.2.3"},
                        {"from": "200.1.2.3"}]}}}})
        out.append({"query": {"match": {"body": words(1, 2)}}, "size": 10,
                    "sort": [{"words": {"order": "desc"}}]})
    return out


def _ndjson(lines) -> str:
    return "\n".join(json.dumps(x) for x in lines) + "\n"


def _fill(base):
    for name, sim in SIM_INDEXES.items():
        st, r = call(base, "PUT", f"/{name}", {"settings": {
            "number_of_shards": 1, "refresh_interval": -1,
            "index": {"similarity": {"default": sim}}}})
        assert st == 200 and r["acknowledged"], r
    st, r = call(base, "PUT", "/an", {"settings": {
        "number_of_shards": 2, "refresh_interval": -1, **AN_SETTINGS},
        "mappings": AN_MAPPING})
    assert st == 200 and r["acknowledged"], r
    st, r = call(base, "PUT", "/library", {
        "settings": {**LIB_SETTINGS, "refresh_interval": -1},
        "mappings": {"book": LIB_MAPPING,
                     "private": {"_routing": {"required": True},
                                 "properties": {"body": {"type": "string",
                                                         "analyzer": "body_en"}}}}})
    assert st == 200 and r["acknowledged"], r
    lines = []
    for name in SIM_INDEXES:
        for i, text in enumerate(SIM_DOCS):
            lines += [{"index": {"_index": name, "_type": "doc", "_id": str(i)}},
                      {"body": text}]
    for i, text in enumerate(AN_TEXTS):
        lines += [{"index": {"_index": "an", "_type": "doc", "_id": str(i)}},
                  {f: text for f in AN_ALL}]
    docs = lib_docs(5, 300)
    for i, src in enumerate(docs):
        lines += [{"index": {"_index": "library", "_type": "book", "_id": str(i)}}, src]
    st, r = call(base, "POST", "/_bulk", raw=_ndjson(lines))
    assert st == 200 and not r["errors"], r
    assert call(base, "POST", "/_refresh")[0] == 200
    # a second segment a shard, with overwrites
    more = []
    for i, src in enumerate(lib_docs(6, 120)):
        doc_id = str(300 + i) if i % 10 else str(i)
        more += [{"index": {"_index": "library", "_type": "book", "_id": doc_id}}, src]
    st, r = call(base, "POST", "/_bulk", raw=_ndjson(more))
    assert st == 200 and not r["errors"], r
    assert call(base, "POST", "/_refresh")[0] == 200


def _boot(pdir, jdir):
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu.transport.local import LocalTransportRegistry as JReg

    p = PNode(name="port", settings={"node.device": "cpu"}, registry=PReg(),
              data_path=pdir)
    j = None
    try:
        p.start()
        j = JNode(name="jax", settings={"search.mesh.enabled": "false",
                                        "indices.warmer.enabled": "false"},
                  registry=JReg(), data_path=jdir)
        j.start([j.local_node.transport_address])
        j.wait_for_master()
        return (p, j, f"http://127.0.0.1:{p.start_http(0).port}",
                f"http://127.0.0.1:{j.start_http(0).port}")
    except BaseException:
        p.close()
        if j is not None:
            j.close()
        raise


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    p, j, pbase, jbase = _boot(str(tmp_path_factory.mktemp("an_port")),
                               str(tmp_path_factory.mktemp("an_jax")))
    try:
        for base in (pbase, jbase):
            _fill(base)
        yield pbase, jbase, p
    finally:
        p.close()
        j.close()
        torch.set_num_threads(threads)


def _both(nodes, method, path, body=None, raw=None):
    pbase, jbase, _p = nodes
    (pst, pr), (jst, jr) = (call(b, method, path, body, raw) for b in (pbase, jbase))
    assert pst == jst, (pr, jr)
    return pst, pr, jr


def _same_search(nodes, path, body):
    """The JAX node gets `"request_cache": false` beside a `size: 0` (it
    would answer from its request cache, which the port has not got)."""
    pbase, jbase, _p = nodes
    pst, pr = call(pbase, "POST", path, {k: v for k, v in body.items()
                                         if k != "request_cache"})
    jst, jr = call(jbase, "POST", path, body)
    assert pst == jst == 200, (pr, jr)
    assert pr["_shards"] == jr["_shards"]
    assert pr["hits"] == jr["hits"]
    assert pr.get("aggregations") == jr.get("aggregations")
    return pr


@pytest.mark.parametrize("index", list(SIM_INDEXES))
@pytest.mark.parametrize("bi", range(len(SIM_BODIES)))
def test_similarity_families_match_jax_node(nodes, index, bi):
    r = _same_search(nodes, f"/{index}/_search", SIM_BODIES[bi])
    if bi < 2:
        assert {h["_id"] for h in r["hits"]["hits"]} == {"0", "1", "2", "4"}


@pytest.mark.parametrize("bi", range(len(SPAN_BODIES)))
def test_phrase_and_span_over_dfr_answer_as_the_jax_node(nodes, bi):
    """The JAX node fails the shard with the AttributeError's message (its
    phrase and span scorers read `sim.idf`); the port fails it with the same
    reason. The bodies are equal but for the failing node's name."""
    st, pr, jr = _both(nodes, "POST", "/dfr/_search", SPAN_BODIES[bi])
    assert st == 200
    for r in (pr, jr):
        for f in r["_shards"].get("failures", []):
            f.pop("node")
    assert pr["_shards"] == jr["_shards"] and pr["hits"] == jr["hits"]
    assert jr["_shards"]["failures"][0]["reason"] == \
        "'DFRSimilarity' object has no attribute 'idf'"


@pytest.mark.parametrize("field", AN_ALL)
def test_analyzed_fields_match_jax_node(nodes, field):
    for text in AN_TEXTS:
        _same_search(nodes, "/an/_search", {"query": {"match": {field: text}},
                                            "size": 20})
    _same_search(nodes, "/an/_search", {"query": {"match_phrase": {
        field: AN_TEXTS[2]}}})


BODIES = lib_bodies(11, 4, [d["title"] for d in lib_docs(5, 300)])


@pytest.mark.parametrize("bi", range(len(BODIES)))
def test_library_searches_match_jax_node(nodes, bi):
    _same_search(nodes, "/library/_search", BODIES[bi])


def test_library_families_do_real_work(nodes):
    pbase = nodes[0]
    bodies = [{k: v for k, v in b.items() if k != "request_cache"} for b in BODIES]
    totals = [call(pbase, "POST", "/library/_search", b)[1]["hits"]["total"]
              for b in bodies]
    assert all(t > 0 for t in totals[0::8])  # match on body
    assert sum(totals[1::8]) > 0 and sum(totals[2::8]) > 0  # shingles, raw
    st, r = call(pbase, "POST", "/library/_search", bodies[6])
    assert sum(b["doc_count"] for b in r["aggregations"]["ips"]["buckets"]) > 0
    # the sub-fields are mapped but hold no terms (the JAX mapper's behaviour)
    for body in ({"query": {"term": {"title.raw": "run"}}},
                 {"query": {"match": {"title.shingles": "run jump"}}}):
        assert _same_search(nodes, "/library/_search", body)["hits"]["total"] == 0


@pytest.mark.parametrize("path", [
    "/_mapping", "/library/_mapping", "/library/book/_mapping",
    "/library/_mapping/book", "/_mapping/book", "/_mapping/private",
    "/library,an/_mapping", "/an/_mapping/nope", "/_mapping/b*"])
def test_get_mapping_matches_jax_node(nodes, path):
    st, pr, jr = _both(nodes, "GET", path)
    assert st == 200 and pr == jr


def test_get_mapping_renders_sub_fields_and_copy_to(nodes):
    _st, pr, _jr = _both(nodes, "GET", "/library/_mapping/book")
    props = pr["library"]["mappings"]["book"]["properties"]
    assert set(props["title"]["fields"]) == {"raw", "shingles"}
    assert props["title"]["copy_to"] == ["title_shingles", "title_raw"]
    assert props["body"]["fields"]["length"]["type"] == "token_count"
    assert props["client_ip"] == {"type": "ip"}
    assert pr["library"]["mappings"]["book"]["_routing"] == {"path": "tenant"}


def test_put_mapping_matches_jax_node(nodes):
    for method, path, body in [
        ("PUT", "/an/doc/_mapping", {"doc": {"properties": {
            "extra": {"type": "string", "analyzer": "syn",
                      "fields": {"raw": {"type": "string", "index": "not_analyzed"}}},
            "addr": {"type": "ip"}}}}),
        ("POST", "/an/_mapping/other", {"properties": {"n": {"type": "token_count"}}}),
        ("PUT", "/_mappings/third", {"third": {"_timestamp": {"enabled": True},
                                               "properties": {"t": {"type": "date"}}}}),
    ]:
        st, pr, jr = _both(nodes, method, path, body)
        assert st == 200 and pr == jr
    st, pr, jr = _both(nodes, "GET", "/an/_mapping")
    assert pr == jr and "extra" in pr["an"]["mappings"]["doc"]["properties"]
    st, pr, jr = _both(nodes, "GET", "/_mapping/third")
    assert st == 200 and pr == jr and len(pr) == len(SIM_INDEXES) + 2
    # the new field serves on both nodes
    doc = {"extra": "quick fox", "addr": "10.1.2.3"}
    for base in nodes[:2]:
        assert call(base, "PUT", "/an/doc/100?refresh=true", doc)[0] == 201
    _same_search(nodes, "/an/_search", {"query": {"match": {"extra": "fast"}}})


@pytest.mark.parametrize("body", [
    {"properties": {"english": {"type": "long"}}},
    {"properties": {"english": {"type": "string", "analyzer": "standard"}}},
    {"properties": {"kw": {"type": "string", "index": "not_analyzed"}}},
], ids=["type", "analyzer", "index"])
def test_put_mapping_conflict_matches_jax_node(nodes, body):
    st, pr, jr = _both(nodes, "PUT", "/an/doc/_mapping", body)
    assert st == 400 and pr == jr
    assert "conflicts" in pr["error"]["reason"]


def test_required_routing_matches_jax_node(nodes):
    st, pr, jr = _both(nodes, "PUT", "/library/private/1", {"body": "run"})
    assert st == 400 and pr == jr
    assert pr["error"]["type"] == "RoutingMissingException"
    st, pr, jr = _both(nodes, "PUT", "/library/private/1?routing=t1", {"body": "run"})
    assert st == 201 and pr == jr
    st, pr, jr = _both(nodes, "DELETE", "/library/private/1")
    assert st == 400 and pr == jr
    # a _bulk item is not checked, in either package
    bulk = _ndjson([{"index": {"_index": "library", "_type": "private", "_id": "2"}},
                    {"body": "jumping"}])
    st, pr, jr = _both(nodes, "POST", "/_bulk", raw=bulk)
    assert st == 200 and pr["items"] == jr["items"] and not pr["errors"]


def test_routing_path_routes_and_get_by_id(nodes):
    """`_routing.path` fills the stored routing, not the shard choice: the
    document is routed by its id in both packages."""
    for doc_id in ("0", "17", "299", "305"):
        st, pr, jr = _both(nodes, "GET", f"/library/book/{doc_id}")
        assert st == 200 and pr == jr


def test_percolator_on_body_en_matches_jax_node(nodes):
    for base in nodes[:2]:
        st, r = call(base, "PUT", "/library/.percolator/q1",
                     {"query": {"match": {"body": "run"}}})
        assert st == 201, r
        st, r = call(base, "PUT", "/library/.percolator/q2",
                     {"query": {"match": {"title": "the hopping"}}})
        assert st == 201, r
    for doc in ({"body": "<b>They ran</b> and RUN"}, {"title": "hops", "body": "x"},
                {"body": "leaping"}):
        st, pr, jr = _both(nodes, "POST", "/library/book/_percolate", {"doc": doc})
        assert st == 200 and pr == jr
    st, pr, jr = _both(nodes, "POST", "/library/book/_percolate",
                       {"doc": {"body": "running"}})
    assert [m["_id"] for m in pr["matches"]] == ["q1"]


def test_delete_mapping_names_its_later_slice(nodes):
    """`DELETE _mapping` (served since the document APIs' slice) drops a
    type of its own and its documents, at both routes, as on the JAX node;
    the index's other types keep theirs."""
    for i, path in enumerate(("/an/gone{}/_mapping", "/an/_mapping/gone{}")):
        _both(nodes, "PUT", f"/an/gone{i}/1?refresh=true", {"body": "gone soon"})
        _both(nodes, "POST", "/an/_refresh")
        st, pr, jr = _both(nodes, "DELETE", path.format(i))
        assert st == 200 and pr == jr == {"acknowledged": True}
        st, pr, jr = _both(nodes, "GET", "/an/_mapping")
        assert pr == jr and f"gone{i}" not in pr["an"]["mappings"]
        st, pr, jr = _both(nodes, "POST", "/an/_count", {"query": {"filtered": {
            "filter": {"type": {"value": f"gone{i}"}}}}})
        assert pr == jr and pr["count"] == 0
    st, pr, _jr = _both(nodes, "GET", "/an/_mapping")
    assert "doc" in pr["an"]["mappings"]
    st, pr, jr = _both(nodes, "DELETE", "/an/_mapping/nothere")
    assert st == 404 and pr == jr


@pytest.mark.parametrize("mapping", [
    {"_parent": {"type": "book"}}, {"_ttl": {"enabled": True}},
    {"properties": {"c": {"type": "nested"}}},
    {"properties": {"loc": {"type": "geo_point"}}}], ids=["parent", "ttl", "nested", "geo"])
def test_later_mapping_features_answer_400_on_the_port(nodes, mapping, request):
    """`_ttl` (since the document APIs' slice), `_parent`, `nested` and
    `geo_point` (the mapper's second half) are put as on the JAX node, which
    then renders the same mapping."""
    name = request.node.callspec.id
    st, r = call(nodes[0], "PUT", f"/an/kid_{name}/_mapping", mapping)
    jst, jr = call(nodes[1], "PUT", f"/an/kid_{name}/_mapping", mapping)
    assert (st, r) == (jst, jr) == (200, {"acknowledged": True})
    got = call(nodes[0], "GET", f"/an/kid_{name}/_mapping")
    assert got == call(nodes[1], "GET", f"/an/kid_{name}/_mapping")
    assert got[0] == 200


# --- restart over path.data ------------------------------------------------

RS_SEARCHES = [
    {"query": {"match": {"body": "running dogs"}}},
    {"query": {"match": {"title_shingles": "quick brown"}}},
    {"query": {"match": {"all_text": "<b>fast</b>"}}},
    {"query": {"match": {"body": {"query": "leap hound", "operator": "or"}}},
     "size": 5},
]


def _rs_fill(base):
    st, r = call(base, "PUT", "/rs", {"settings": {
        "number_of_shards": 2, "number_of_replicas": 0, "refresh_interval": -1,
        "index": {"similarity": {"default": {"type": "DFR", "basic_model": "if",
                                             "normalization": "h3"}}},
        "analysis": {"filter": {"syn": {"type": "synonym",
                                        "synonyms": ["dog,hound", "jump,leap"]},
                                "sh": {"type": "shingle"}},
                     "analyzer": {"en": {"char_filter": ["html_strip"],
                                         "tokenizer": "standard",
                                         "filter": ["lowercase", "syn", "porter_stem"]},
                                  "sh": {"tokenizer": "standard",
                                         "filter": ["lowercase", "sh"]}}}},
        "mappings": {"doc": {"properties": {
            "title": {"type": "string", "copy_to": "title_shingles",
                      "fields": {"raw": {"type": "string", "index": "not_analyzed"}}},
            "title_shingles": {"type": "string", "analyzer": "sh"},
            "body": {"type": "string", "analyzer": "en", "copy_to": "all_text"}}}}})
    assert st == 200 and r["acknowledged"], r
    rng = np.random.default_rng(3)
    vocab = ["quick", "brown", "fast", "dog", "hound", "jumps", "leaping",
             "running", "<b>bold</b>", "fox"]
    lines = []
    for i in range(60):
        lines += [{"index": {"_index": "rs", "_type": "doc", "_id": str(i)}},
                  {"title": " ".join(rng.choice(vocab, 3)),
                   "body": " ".join(rng.choice(vocab, int(rng.integers(2, 12))))}]
    assert call(base, "POST", "/_bulk", raw=_ndjson(lines))[0] == 200
    assert call(base, "POST", "/rs/_refresh")[0] == 200


def _rs_answers(base):
    out = []
    for body in RS_SEARCHES:
        st, r = call(base, "POST", "/rs/_search", body)
        assert st == 200, r
        out.append((r["hits"], r["_shards"]))
    out.append(call(base, "GET", "/rs/_mapping"))
    return out


def _wait_green(base, index):
    t0 = time.monotonic()
    while time.monotonic() - t0 < 30:
        st, h = call(base, "GET", f"/_cluster/health/{index}")
        if st == 200 and h["status"] == "green":
            return
        time.sleep(0.05)
    raise AssertionError(f"{base} {index} never green")


def test_restart_keeps_analysis_mapping_and_similarity(tmp_path):
    pdir, jdir = str(tmp_path / "p"), str(tmp_path / "j")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        p, j, pbase, jbase = _boot(pdir, jdir)
        try:
            for base in (pbase, jbase):
                _rs_fill(base)
            before = (_rs_answers(pbase), _rs_answers(jbase))
        finally:
            p.close()
            j.close()
        p, j, pbase, jbase = _boot(pdir, jdir)
        try:
            for base in (pbase, jbase):
                _wait_green(base, "rs")
            after = (_rs_answers(pbase), _rs_answers(jbase))
        finally:
            p.close()
            j.close()
    finally:
        torch.set_num_threads(threads)
    assert before[0] == before[1]
    assert after[0] == after[1] == before[0]
    assert all(hits["total"] > 0 for hits, _s in after[0][:4])
