"""Term vectors, more-like-this and `_explain` on a port node against a JAX
node over REST: tests/test_termvector_mlt.py's cases and the `_explain`
half of tests/test_rest.py::test_validate_and_explain, node against node
(JSON equality).

`_termvector` and `_termvectors` re-analyze the stored source on the
document's shard (positions, offsets, term and field statistics, field
selection by parameter and by body); `_mtermvectors` at its three routes
answers each document in place, a missing index's as an error; `_mlt`
searches a `bool` of `more_like_this` over the document's text fields
minus the document (on the host scorer, as the JAX node does), with
`mlt_fields` and a search body; `_explain` searches the query with an
`ids` filter and reports `matched` and the hit's score, with `?q=` and the
GET section of the `_source` parameters. Pinned on the port: `?fields=` on
`_explain` answers the JAX node's `fields` section, as on GET."""

import json

import pytest

from elasticsearch_tpu_torch.search.service import SERVING_COUNTERS
from tests.test_torch_node import _node_pair, call

TV_DOCS = {"1": {"title": "the quick brown fox fox", "body": "jumps over the lazy dog",
                 "n": 3},
           "2": {"title": "quick quick red fox"},
           "3": {"title": "slow green turtle"}}
BOOKS = [("the art of search", "tech"), ("cooking for two", "food"),
         ("search engines explained", "tech"), ("garden design", "home")]


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    def fill(base):
        assert call(base, "PUT", "/tv", {"settings": {"index.number_of_shards": 1}})[0] == 200
        for i, d in TV_DOCS.items():
            assert call(base, "PUT", f"/tv/doc/{i}", d)[0] == 201
        assert call(base, "PUT", "/lib", {"settings": {"number_of_shards": 2,
                                                       "number_of_replicas": 0}})[0] == 200
        for i, (title, cat) in enumerate(BOOKS):
            assert call(base, "PUT", f"/lib/book/{i}", {
                "title": title, "category": cat, "pages": (i + 1) * 100})[0] == 201
        for index in ("tv", "lib"):
            assert call(base, "POST", f"/{index}/_refresh")[0] == 200

    yield from _node_pair(tmp_path_factory, fill)


def _both(nodes, method, path, body=None):
    """Both nodes' answers to one request: the same status and JSON (but
    `took`)."""
    pbase, jbase, _p = nodes
    (pst, pr), (jst, jr) = (call(b, method, path, body) for b in (pbase, jbase))
    for r in (pr, jr):
        r.pop("took", None)
    assert (pst, json.dumps(pr, sort_keys=True)) == (jst, json.dumps(jr, sort_keys=True)), \
        (path, pr, jr)
    return pst, pr


# -- tests/test_termvector_mlt.py TestTermvector, node against node ------------

def test_basic_terms_and_freqs(nodes):
    st, r = _both(nodes, "GET", "/tv/doc/1/_termvector")
    assert st == 200 and r["found"] and r["_id"] == "1"
    terms = r["term_vectors"]["title"]["terms"]
    assert (terms["fox"]["term_freq"], terms["quick"]["term_freq"],
            terms["the"]["term_freq"]) == (2, 1, 1)
    tok = terms["quick"]["tokens"][0]
    assert tok["position"] == 1 and "start_offset" in tok and "end_offset" in tok


def test_field_selection(nodes):
    _st, r = _both(nodes, "GET", "/tv/doc/1/_termvector?fields=body")
    assert set(r["term_vectors"]) == {"body"} and "lazy" in r["term_vectors"]["body"]["terms"]
    _st, r = _both(nodes, "POST", "/tv/doc/1/_termvectors", {"fields": ["title"]})
    assert set(r["term_vectors"]) == {"title"}


def test_term_and_field_statistics(nodes):
    _st, r = _both(nodes, "GET", "/tv/doc/1/_termvector?term_statistics=true")
    assert r["term_vectors"]["title"]["terms"]["fox"]["doc_freq"] == 2
    assert r["term_vectors"]["title"]["field_statistics"]["doc_count"] == 3


@pytest.mark.parametrize("query", ["positions=false", "offsets=false",
                                   "positions=false&offsets=false",
                                   "field_statistics=false", "term_statistics=true&fields=title"])
def test_options_match_jax_node(nodes, query):
    _st, r = _both(nodes, "GET", f"/tv/doc/2/_termvectors?{query}")
    assert r["found"]


def test_missing_doc(nodes):
    _st, r = _both(nodes, "GET", "/tv/doc/999/_termvector")
    assert r["found"] is False


@pytest.mark.parametrize("path,body", [
    ("/_mtermvectors", {"docs": [{"_index": "tv", "_type": "doc", "_id": "1"},
                                 {"_index": "tv", "_type": "doc", "_id": "2"}]}),
    ("/tv/_mtermvectors", {"ids": ["1", "3", "999"]}),
    ("/tv/doc/_mtermvectors?ids=1,2&term_statistics=true&fields=title", None),
    ("/_mtermvectors", {"docs": [{"_index": "tv", "_type": "doc", "_id": "3"},
                                 {"_index": "nope", "_type": "doc", "_id": "1"}]}),
])
def test_mtermvectors(nodes, path, body):
    _st, r = _both(nodes, "POST", path, body)
    assert len(r["docs"]) >= 2


# -- TestMlt, node against node -------------------------------------------------

def test_mlt_finds_similar_excludes_self(nodes):
    before = dict(SERVING_COUNTERS)
    _st, r = _both(nodes, "GET", "/tv/doc/1/_mlt?min_term_freq=1&min_doc_freq=1")
    ids = [h["_id"] for h in r["hits"]["hits"]]
    assert "1" not in ids and "2" in ids and "3" not in ids
    # the host scorer rewrites more_like_this: the search runs on the host
    assert SERVING_COUNTERS["host"] > before["host"]
    assert SERVING_COUNTERS["device_sparse"] == before["device_sparse"]


@pytest.mark.parametrize("path,body", [
    ("/tv/doc/2/_mlt?min_term_freq=1&min_doc_freq=1&mlt_fields=title", None),
    ("/tv/doc/1/_mlt?min_term_freq=1&min_doc_freq=1", {"size": 1}),
    ("/tv/doc/2/_mlt?min_term_freq=1&min_doc_freq=1&max_query_terms=2", None),
])
def test_mlt_options_match_jax_node(nodes, path, body):
    _st, r = _both(nodes, "POST", path, body)
    assert r["_shards"]["failed"] == 0


def test_mlt_missing_doc_answers_404_on_both(nodes):
    st, r = _both(nodes, "GET", "/tv/doc/999/_mlt")
    assert st == 404 and r["error"]["type"] == "DocumentMissingException"


# -- tests/test_rest.py::test_validate_and_explain, its _explain half -----------

def test_explain_matches(nodes):
    _st, r = _both(nodes, "GET", "/lib/book/0/_explain",
                   {"query": {"match": {"title": "search"}}})
    assert r["matched"] is True and r["explanation"]["value"] > 0


@pytest.mark.parametrize("path,body", [
    ("/lib/book/1/_explain", {"query": {"match": {"title": "search"}}}),
    ("/lib/book/2/_explain?q=title:engines", None),
    ("/lib/book/2/_explain?_source=title", {"query": {"term": {"category": "tech"}}}),
    ("/lib/book/3/_explain?_source_exclude=pages", {"query": {"match_all": {}}}),
    ("/lib/book/9/_explain", {"query": {"match_all": {}}}),
])
def test_explain_cases_match_jax_node(nodes, path, body):
    _both(nodes, "POST", path, body)


def test_explain_fields_param_answers_400_on_the_port(nodes):
    """`?fields=` on `_explain`, as on GET (served since the document APIs'
    slice), answers the JAX node's `fields` section."""
    for path in ("/lib/book/0/_explain?fields=title", "/lib/book/0?fields=title",
                 "/lib/book/0/_explain?fields=title,_source",
                 "/lib/book/0?fields=title&_source=true"):
        (pst, pr), (jst, jr) = (call(b, "GET", path) for b in nodes[:2])
        assert pst == jst == 200 and pr == jr, (path, pr, jr)
        section = pr.get("get", pr)
        assert section["fields"]["title"], (path, pr)
