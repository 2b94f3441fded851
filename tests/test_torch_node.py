"""A port Node against a JAX Node, both over real HTTP (`start_http(0)`,
urllib), one process, each package on its own in-process transport.

Both nodes get the same indexes — 1, 3 and 5 shards, and 3 shards with BM25
through `index.similarity.default.type`, all with `refresh_interval: -1` —
and the same two `_bulk` bodies (explicit ids) with a refresh after each:
the second deletes and overwrites documents of the first, so every shard
holds two segments and tombstones. The JAX node runs with its SPMD mesh and
warmer off (`search.mesh.enabled`, `indices.warmer.enabled`), as its own
caching tests do, so it serves through the same per-shard path.

For every search body — term, match (or / and), bool must / should /
must_not, minimum_should_match, coord, `from`/`size` paging, `_source`
false, includes and excludes — the two responses must have equal `hits`
(total, max_score, every hit's `_index`, `_type`, `_id`, `_score`, `_shard`,
`_source`) and equal `_shards`, the `degraded` count of shards served on
the host path on a device fault included. Scores are bitwise:
every query here rides the sparse path, where both packages are
deterministic.

The query DSL over REST: the bodies of
tests/test_search_single_shard.py (TestQueryTypes, TestEdgeCases; nested
left to a later slice) on their documents, and of
tests/test_dsl_long_tail.py (simple_query_string, fuzzy_like_this,
mlt_field, wrapper) on theirs, go to both nodes. Their hits must be equal,
bitwise where both packages serve the body on the host scorer, and
tie-tolerant within 2 ulp where both serve it on the dense device family
(`filtered` whose query lowers, `post_filter`, `min_score`,
`function_score`; a `_score`-reading script at 5 decimals), where the port
node's serving counters show the family (`device_filtered`,
`device_function_score`) once a shard.

Also pinned: the port's 400 for a body key it does not serve, `GET
/_snapshot` answered as on the JAX node, a clause on a
numeric field answering the JAX node's hits, 404 for a missing index on
both nodes, 500 with a counted error when the launch raises an error that
is not a CUDA error (a host bug; a CUDA error degrades, tests/
test_torch_devicehealth.py), no
context left pinned after a failed query phase, a failed fetch dropping
only its shard's hits (as on the JAX node), the fetch reading the query
phase's pinned searcher across a refresh, and DeviceUnavailableError for a
node built without CUDA and without `node.device: cpu`.

The write path: three bulk and refresh rounds (deletes and overwrites
included), then `_optimize`, then `_flush`, on both nodes; the hits JSON is
equal after each step, and the port node packs on its warmer and merge
pools only."""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.actions import A_FETCH_PHASE, A_QUERY_PHASE
from elasticsearch_tpu_torch.common.cudaenv import DeviceUnavailableError
from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.search.service import SERVING_COUNTERS
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg
from tests.test_torch_aggs import _agg_equal
from tests.test_torch_dense import _tie_tolerant_equal, _within_ulps

WORDS = [f"w{i}" for i in range(30)]
INDEXES = {
    "one": {"number_of_shards": 1},
    "three": {"number_of_shards": 3},
    "five": {},
    "bm25": {"number_of_shards": 3,
             "index": {"similarity": {"default": {"type": "BM25"}}}},
}


def call(base, method, path, body=None, raw=None):
    if raw is not None:
        data, ctype = raw.encode(), "application/x-ndjson"
    else:
        data = None if body is None else json.dumps(body).encode()
        ctype = "application/json"
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _bulk_bodies(seed: int) -> list[str]:
    rng = np.random.default_rng(seed)

    def doc(i):
        vocab = WORDS[: int(rng.integers(6, 30))]
        return {"title": " ".join(rng.choice(vocab, 2)),
                "body": " ".join(rng.choice(vocab, int(rng.integers(2, 30)))),
                "n": i, "meta": {"tag": f"t{i % 4}", "note": "keep me"}}

    first, second = [], []
    for index in INDEXES:
        for i in range(160):
            first += [{"index": {"_index": index, "_type": "doc", "_id": str(i)}}, doc(i)]
        for i in range(160, 240):
            second += [{"index": {"_index": index, "_type": "doc", "_id": str(i)}}, doc(i)]
        for i in range(0, 160, 9):
            second.append({"delete": {"_index": index, "_type": "doc", "_id": str(i)}})
        for i in (5, 77, 200):  # overwrites, two across segments
            second += [{"index": {"_index": index, "_type": "doc", "_id": str(i)}},
                       {"title": "over written", "body": "w1 w1 w2 w3 w3 w3", "n": -i}]
    return ["\n".join(json.dumps(x) for x in part) + "\n" for part in (first, second)]


# the documents of tests/test_search_single_shard.py and
# tests/test_dsl_long_tail.py (its geo field left out)
QT_DOCS = [
    "the quick brown fox jumps over the lazy dog",
    "quick brown foxes leap over lazy dogs in summer",
    "the red fox and the brown bear",
    "lazy afternoon with a quick snack",
    "dogs and cats living together",
    "the brown dog sleeps all day",
    "fox",
    "a a a a a a a a quick",
    "brown brown brown fox fox quick",
    "nothing relevant here at all",
]
DSL_DOCS = [
    {"body": "quick brown fox", "tag": "a", "n": 1},
    {"body": "lazy brown dog", "tag": "b", "n": 2},
    {"body": "quick red wolf", "tag": "a", "n": 3},
    {"body": "slow green turtle", "tag": "c", "n": 4},
    {"body": "quick quince quest", "tag": "b", "n": 5},
]
DSL_INDEXES = {
    "qt": {"number_of_shards": 2},
    "qtbm": {"number_of_shards": 2,
             "index": {"similarity": {"default": {"type": "BM25"}}}},
    "qtdel": {"number_of_shards": 1},
    "dsl": {"number_of_shards": 1},
    "em": {"number_of_shards": 1},
}


def _dsl_bulks() -> list[str]:
    """NDJSON bodies, each followed by a refresh: QT_DOCS four at a time (so
    the shards hold several segments), then the rest."""
    def op(index, doc_id, src):
        return [{"index": {"_index": index, "_type": "doc", "_id": str(doc_id)}}, src]

    bulks = []
    for start in range(0, len(QT_DOCS), 4):
        part = []
        for index in ("qt", "qtbm", "qtdel"):
            for i in range(start, min(start + 4, len(QT_DOCS))):
                part += op(index, i, {"body": QT_DOCS[i], "num": i})
        bulks.append(part)
    last = [{"delete": {"_index": "qtdel", "_type": "doc", "_id": "6"}}]
    for i, src in enumerate(DSL_DOCS):
        last += op("dsl", i, src)
    for i, src in enumerate(({"a": "x", "b": 1}, {"a": "y"}, {"a": ""}, {"b": 2})):
        last += op("em", i, src)
    bulks.append(last)
    return ["\n".join(json.dumps(x) for x in part) + "\n" for part in bulks]


def _node_pair(tmp_path_factory, fill, names=("port", "jax")):
    """Boot a port node and a JAX node (named `names`), run `fill(base URL)`
    on each, yield (port base URL, JAX base URL, port node), then close
    both."""
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu.transport.local import LocalTransportRegistry as JReg

    # every shard's query phase runs torch CPU ops on a thread of its own:
    # one intra-op thread each keeps them from oversubscribing the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    p = PNode(name=names[0], settings={"node.device": "cpu"}, registry=PReg(),
              data_path=str(tmp_path_factory.mktemp("port_node"))).start()
    j = JNode(name=names[1], settings={"search.mesh.enabled": "false",
                                    "indices.warmer.enabled": "false"},
              registry=JReg(), data_path=str(tmp_path_factory.mktemp("jax_node")))
    try:
        j.start([j.local_node.transport_address])
        j.wait_for_master()
        bases = [f"http://127.0.0.1:{p.start_http(0).port}",
                 f"http://127.0.0.1:{j.start_http(0).port}"]
        for base in bases:
            fill(base)
        yield bases[0], bases[1], p
    finally:
        p.close()
        j.close()
        torch.set_num_threads(threads)


def _bulk_and_refresh(base, bulks):
    for bulk in bulks:
        st, r = call(base, "POST", "/_bulk", raw=bulk)
        assert st == 200 and not r["errors"], r
        st, r = call(base, "POST", "/_refresh")
        assert st == 200 and r["_shards"]["failed"] == 0


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """(port base URL, JAX base URL, port node) holding INDEXES."""
    def fill(base):
        for index, settings in INDEXES.items():
            st, r = call(base, "PUT", f"/{index}",
                         {"settings": {**settings, "refresh_interval": -1}})
            assert st == 200 and r["acknowledged"], r
        _bulk_and_refresh(base, _bulk_bodies(17))

    yield from _node_pair(tmp_path_factory, fill)


@pytest.fixture(scope="module")
def dsl_nodes(tmp_path_factory):
    """(port base URL, JAX base URL, port node) holding DSL_INDEXES."""
    def fill(base):
        for index, settings in DSL_INDEXES.items():
            body = {"settings": {**settings, "refresh_interval": -1}}
            if index == "dsl":
                body["mappings"] = {"doc": {"properties": {
                    "body": {"type": "string"},
                    "tag": {"type": "string", "index": "not_analyzed"},
                    "n": {"type": "integer"}}}}
            st, r = call(base, "PUT", f"/{index}", body)
            assert st == 200 and r["acknowledged"], r
        _bulk_and_refresh(base, _dsl_bulks())

    yield from _node_pair(tmp_path_factory, fill)


BODIES = [
    {"query": {"term": {"body": "w3"}}},
    {"query": {"term": {"title": "w1"}}, "size": 50},
    {"query": {"term": {"body": "no-such-term"}}},
    {"query": {"match": {"body": "w1 w2 w3"}}},
    {"query": {"match": {"body": {"query": "w4 w5", "operator": "and"}}}},
    {"query": {"match": {"body": {"query": "w2 w6 w7 w8", "minimum_should_match": "50%"}}}},
    {"query": {"match": {"title": {"query": "w9 w10", "boost": 2.5}}}},
    {"query": {"match": {"_all": "w1 w11"}}, "size": 15},
    {"query": {"bool": {"must": [{"term": {"body": "w1"}}],
                        "should": [{"term": {"body": "w2"}}, {"match": {"title": "w3"}}],
                        "must_not": [{"term": {"body": "w4"}}]}}},
    {"query": {"bool": {"should": [{"term": {"body": "w5"}}, {"term": {"body": "w6"}},
                                   {"term": {"body": "w7"}}],
                        "minimum_should_match": 2}}},
    {"query": {"bool": {"should": [{"term": {"body": "w8"}}, {"term": {"title": "w9"}}],
                        "disable_coord": True, "boost": 1.5}}},
    {"query": {"bool": {"should": [{"term": {"body": "w1"}}, {"term": {"body": "w2"}},
                                   {"term": {"body": "w3"}}, {"term": {"body": "w12"}}]}}},
    {"query": {"bool": {"must": [{"term": {"body": "w2"}}],
                        "must_not": [{"term": {"title": "w1"}}]}}, "size": 30},
    {"query": {"bool": {"must": [{"term": {"body": "w1"}}, {"term": {"body": "w3"}}]}}},
    {"query": {"match": {"body": "w1 w2"}}, "from": 10, "size": 10},
    {"query": {"match": {"body": "w1 w2"}}, "from": 25, "size": 5},
    {"query": {"match": {"body": "w2"}}, "from": 0, "size": 0},
    {"query": {"match": {"body": "w3 w5"}}, "_source": False},
    {"query": {"match": {"body": "w3 w5"}}, "_source": ["title", "meta.tag"]},
    {"query": {"match": {"body": "w6"}}, "_source": "meta.*"},
    {"query": {"match": {"body": "w6 w7"}},
     "_source": {"includes": ["meta"], "excludes": ["meta.note"]}},
    {"query": {"match": {"title": "over written"}}, "size": 5},
    {"query": {"match": {"body": "w1 w2 w3"}}, "timeout": "30s", "size": 3},
]


@pytest.mark.parametrize("index", list(INDEXES))
@pytest.mark.parametrize("body", BODIES, ids=[f"body{i}" for i in range(len(BODIES))])
def test_search_hits_and_shards_match_jax_node(nodes, index, body):
    pbase, jbase, _p = nodes
    pst, pr = call(pbase, "POST", f"/{index}/_search", body)
    jst, jr = call(jbase, "POST", f"/{index}/_search", body)
    assert pst == jst == 200, (pr, jr)
    assert pr["_shards"] == jr["_shards"]
    assert pr["hits"] == jr["hits"]
    assert pr["timed_out"] is jr["timed_out"] is False


def test_whole_cluster_search_and_health_match_jax_node(nodes):
    pbase, jbase, _p = nodes
    body = {"query": {"match": {"body": "w1 w2"}}, "size": 40}
    for path in ("/_search", "/one,bm25/_search", "/f*/doc/_search"):
        (pst, pr), (jst, jr) = (call(b, "GET", path, body) for b in (pbase, jbase))
        assert pst == jst == 200
        assert (pr["hits"], pr["_shards"]) == (jr["hits"], jr["_shards"]), path
    (_, ph), (_, jh) = (call(b, "GET", "/_cluster/health") for b in (pbase, jbase))
    assert ph == jh and ph["status"] == "yellow"
    assert ph["active_primary_shards"] == 12 and ph["unassigned_shards"] == 12


def test_port_refuses_what_it_does_not_serve(nodes):
    pbase, jbase, _p = nodes
    st, r = call(pbase, "POST", "/three/_search",
                 {"query": {"match": {"body": "w1"}}, "no_such_key": True})
    assert st == 400 and r["error"]["type"] == "QueryParsingException"
    assert "not served" in r["error"]["reason"]
    for base in (pbase, jbase):
        st, r = call(base, "POST", "/missing/_search", {"query": {"match": {"body": "w1"}}})
        assert st == 404 and r["error"]["type"] == "IndexMissingException", r
    # the last routes of a later slice (A9's snapshots) are served as on
    # the JAX node; a route neither node has answers "No handler found"
    (pst, pr), (jst, jr) = (call(b, "GET", "/_snapshot") for b in (pbase, jbase))
    assert pst == jst == 200 and pr == jr == {}
    st, r = call(pbase, "GET", "/_foo/bar")
    assert st == 400 and "No handler found" in r["error"]
    # a clause on a numeric field answers from its doc-value column, with
    # the JAX node's hits
    for body in ({"query": {"term": {"n": 7}}},
                 {"query": {"bool": {"must": [{"match": {"body": "w1"}}],
                                     "should": [{"range": {"n": {"gte": 100}}}]}}}):
        (pst, pr), (jst, jr) = (call(b, "POST", "/three/_search", body)
                                for b in (pbase, jbase))
        assert pst == jst == 200 and pr["hits"]["total"] > 0
        assert (pr["hits"], pr["_shards"]) == (jr["hits"], jr["_shards"])
        assert pr["_shards"]["failed"] == 0


def test_device_error_is_a_500_and_counted(nodes, monkeypatch):
    import elasticsearch_tpu_torch.ops.scoring as tscoring

    pbase, _jbase, _p = nodes

    def failing_launch(*args, **kwargs):
        raise RuntimeError("sparse_score launch failed: an illegal memory access")

    monkeypatch.setattr(tscoring, "sparse_score", failing_launch)
    before = SERVING_COUNTERS["device_errors"]
    st, r = call(pbase, "POST", "/three/_search",
                 {"query": {"match": {"body": "w13 w14"}}})
    assert st == 500 and "illegal memory access" in r["error"]["reason"]
    assert SERVING_COUNTERS["device_errors"] > before


def test_fetch_reads_the_query_phase_searcher(nodes):
    """A query phase pins its point-in-time searcher; a delete and refresh
    before the fetch neither moves the winners' doc ids nor loses them."""
    pbase, _jbase, p = nodes
    body = {"query": {"term": {"body": "w2"}}, "size": 3}
    st, ref = call(pbase, "POST", "/one/_search", body)
    assert st == 200 and len(ref["hits"]["hits"]) == 3
    qp = p.transport.submit_request(p.local_node, A_QUERY_PHASE,
                                    {"index": "one", "shard": 0, "body": body})
    for hit in ref["hits"]["hits"]:
        p.client().index("one", "doc", {"body": "gone"}, id=hit["_id"])
    p.client().refresh("one")
    fetched = p.transport.submit_request(p.local_node, A_FETCH_PHASE, {
        "index": "one", "shard": 0, "body": body, "ctx": qp["ctx_id"],
        "docs": qp["docs"][:3]})
    assert fetched["hits"] == ref["hits"]["hits"]
    st, now = call(pbase, "POST", "/one/_search", body)
    assert [h["_id"] for h in now["hits"]["hits"]] != \
        [h["_id"] for h in ref["hits"]["hits"]]
    assert p.actions.pinned_contexts() == 0


def test_node_without_cuda_and_without_cpu_setting_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        PNode(name="nodev", registry=PReg(), data_path=str(tmp_path))


def test_launcher_serves_http_and_stops_on_sigterm(tmp_path):
    """`python -m elasticsearch_tpu_torch` boots a node, answers REST on the
    port it prints, and exits 0 on SIGTERM."""
    import os
    import re
    import signal
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(repo)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "elasticsearch_tpu_torch", "-Dnode.device=cpu",
         "-Dnode.name=cli", "--data", str(tmp_path / "data"), "--http-port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env,
        cwd=str(tmp_path))
    try:
        line = proc.stdout.readline()
        m = re.search(r"http port (\d+)", line)
        assert m, line
        base = f"http://127.0.0.1:{m.group(1)}"
        st, r = call(base, "GET", "/")
        assert st == 200 and r["name"] == "cli"
        st, r = call(base, "PUT", "/idx", {"settings": {"number_of_shards": 2}})
        assert st == 200 and r["acknowledged"]
        st, r = call(base, "GET", "/_cluster/health")
        assert st == 200 and r["status"] == "yellow" and r["active_primary_shards"] == 2
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# bodies both nodes serve on the host scorer: hits bitwise
HOST_BODIES = [
    ("qt", {"query": {"match_all": {}}, "size": 20}),
    ("qt", {"size": 4}),
    ("qt", {"query": {"match_phrase": {"body": "quick brown"}}}),
    ("qt", {"query": {"match_phrase": {"body": {"query": "quick brown", "slop": 2}}}}),
    ("qtbm", {"query": {"match_phrase": {"body": {"query": "brown quick", "slop": 2}}}}),
    ("qt", {"query": {"prefix": {"body": "fo"}}}),
    ("qt", {"query": {"wildcard": {"body": "f*x"}}}),
    ("qt", {"query": {"fuzzy": {"body": "foxs"}}}),
    ("qt", {"query": {"regexp": {"body": "fox(es)?"}}}),
    ("qt", {"query": {"range": {"num": {"gte": 3, "lt": 6}}}}),
    ("qt", {"query": {"term": {"num": 3}}}),
    ("qt", {"query": {"match": {"num": "3"}}}),  # lowers on both: no match
    ("qt", {"query": {"filtered": {"query": {"match_all": {}},
                                   "filter": {"range": {"num": {"lte": 2}}}}}}),
    ("qt", {"query": {"ids": {"values": ["1", "3"]}}}),
    ("qt", {"query": {"terms": {"body": ["bear", "cats"]}}}),
    ("qtbm", {"query": {"terms": {"body": ["bear", "cats", "fox"],
                                  "minimum_should_match": 1}}}),
    ("qt", {"query": {"constant_score": {"filter": {"term": {"body": "fox"}},
                                         "boost": 3.0}}}),
    ("qt", {"query": {"bool": {"must": [{"match": {"body": "brown"}}],
                               "filter": [{"range": {"num": {"gte": 2}}}]}}}),
    ("qtbm", {"query": {"dis_max": {"queries": [{"term": {"body": "fox"}},
                                                {"term": {"body": "dog"}}],
                                    "tie_breaker": 0.5}}}),
    ("qt", {"query": {"query_string": {"query": "body:fox AND body:brown"}}}),
    ("qt", {"query": {"query_string": {"query": "fox -bear", "default_field": "body"}}}),
    ("em", {"query": {"constant_score": {"filter": {"exists": {"field": "b"}}}}}),
    ("em", {"query": {"constant_score": {"filter": {"missing": {"field": "b"}}}}}),
    ("em", {"query": {"constant_score": {"filter": {"exists": {"field": "a"}}}}}),
    ("qtdel", {"query": {"match": {"body": "fox"}}}),
    ("qt", {"query": {"match": {"body": ""}}, "size": 5}),
    ("qt", {"query": {"bool": {"should": [{"term": {"body": "fox"}}],
                               "minimum_should_match": 5}}, "size": 5}),
    ("qt", {"query": {"bool": {"must_not": [{"term": {"body": "fox"}}]}}, "size": 20}),
    ("dsl", {"query": {"simple_query_string": {"query": "fox turtle", "fields": ["body"]}}}),
    ("dsl", {"query": {"simple_query_string": {"query": "quick + brown", "fields": ["body"]}}}),
    ("dsl", {"query": {"simple_query_string": {"query": "quick -red", "fields": ["body"]}}}),
    ("dsl", {"query": {"simple_query_string": {"query": '"brown fox"', "fields": ["body"]}}}),
    ("dsl", {"query": {"simple_query_string": {"query": "quin*", "fields": ["body"]}}}),
    ("dsl", {"query": {"simple_query_string": {"query": "quick brown", "fields": ["body"],
                                               "default_operator": "and"}}}),
    ("dsl", {"query": {"simple_query_string": {"query": "+ | - fox", "fields": ["body"]}}}),
    ("dsl", {"query": {"simple_query_string": {"query": "fox | turtle", "fields": ["body"],
                                               "default_operator": "and"}}}),
    ("dsl", {"query": {"fuzzy_like_this": {"fields": ["body"], "like_text": "quik brown",
                                           "fuzziness": 1}}}),
    ("dsl", {"query": {"fuzzy_like_this_field": {"body": {"like_text": "foxx",
                                                          "fuzziness": 1}}}}),
    ("dsl", {"query": {"flt": {"fields": ["body"], "like_text": "quicky"}}}),
    ("dsl", {"query": {"more_like_this_field": {"body": {
        "like_text": "quick brown fox", "min_term_freq": 1, "min_doc_freq": 1,
        "minimum_should_match": 1}}}}),
    ("dsl", {"query": {"wrapper": {"query": "eyJ0ZXJtIjogeyJ0YWciOiAiYSJ9fQ=="}}}),
    ("dsl", {"query": {"constant_score": {"filter": {
        "wrapper": {"query": '{"term": {"tag": "b"}}'}}}}}),
]

# bodies both nodes serve on the dense device family: hits tie-tolerant
# within 2 ulp; the serving counter each body moves on the port node
DEVICE_FAMILY_BODIES = [
    ("qt", {"query": {"filtered": {"query": {"match": {"body": "fox"}},
                                   "filter": {"range": {"num": {"lte": 2}}}}}}),
    ("qtbm", {"query": {"filtered": {"query": {"match": {"body": "brown dog"}},
                                     "filter": {"exists": {"field": "num"}}}}}),
    ("qt", {"query": {"match": {"body": "quick brown"}},
            "post_filter": {"range": {"num": {"gte": 1}}}}),
    ("qtbm", {"query": {"match": {"body": "lazy dog"}}, "filter": {"term": {"body": "the"}}}),
    ("qt", {"query": {"match": {"body": "brown fox"}}, "min_score": 0.3}),
    ("qtbm", {"query": {"match": {"body": "quick fox"}}, "min_score": 0.5, "size": 3}),
    ("qt", {"query": {"function_score": {
        "query": {"match": {"body": "brown fox"}},
        "field_value_factor": {"field": "num", "modifier": "ln2p"}}}}),
    ("qtbm", {"query": {"function_score": {
        "query": {"match": {"body": "quick dog lazy"}},
        "functions": [{"gauss": {"num": {"origin": 4, "scale": 3}}},
                      {"filter": {"range": {"num": {"gte": 5}}}, "weight": 2}],
        "boost_mode": "sum", "score_mode": "max"}}}),
    ("qt", {"query": {"function_score": {
        "query": {"match": {"body": "the brown"}}, "boost_factor": 3,
        "max_boost": 2, "min_score": 0.2, "boost": 1.5}}}),
    ("qtbm", {"query": {"function_score": {
        "query": {"match": {"body": "brown"}},
        "script_score": {"script": "_score * log(2 + doc['num'].value)"}}}}),
]
_COUNTER = {"filtered": "device_filtered", "post_filter": "device_filtered",
            "filter": "device_filtered", "min_score": "device_filtered",
            "function_score": "device_function_score"}
_SHARDS = {"qt": 2, "qtbm": 2}


@pytest.mark.parametrize("index,body", HOST_BODIES,
                         ids=[f"host{i}" for i in range(len(HOST_BODIES))])
def test_dsl_host_bodies_match_jax_node(dsl_nodes, index, body):
    pbase, jbase, _p = dsl_nodes
    (pst, pr), (jst, jr) = (call(b, "POST", f"/{index}/_search", body)
                            for b in (pbase, jbase))
    assert pst == jst == 200, (pr, jr)
    assert pr["_shards"] == jr["_shards"]
    assert pr["hits"] == jr["hits"]


@pytest.mark.parametrize("index,body", DEVICE_FAMILY_BODIES,
                         ids=[f"family{i}" for i in range(len(DEVICE_FAMILY_BODIES))])
def test_dsl_device_family_bodies_match_jax_node(dsl_nodes, index, body):
    pbase, jbase, _p = dsl_nodes
    before = dict(SERVING_COUNTERS)
    pst, pr = call(pbase, "POST", f"/{index}/_search", body)
    counted = {k: v - before[k] for k, v in SERVING_COUNTERS.items() if v != before[k]}
    jst, jr = call(jbase, "POST", f"/{index}/_search", body)
    assert pst == jst == 200, (pr, jr)
    family = next((k for k in ("post_filter", "filter", "min_score") if k in body),
                  next(iter(body["query"])))
    assert counted == {_COUNTER[family]: _SHARDS[index]}, counted
    assert pr["_shards"] == jr["_shards"]
    ph, jh = pr["hits"], jr["hits"]
    assert ph["total"] == jh["total"] > 0

    def key(h):
        return (h["_index"], h["_id"])

    got = [(h["_score"], key(h)) for h in ph["hits"]]
    want = [(h["_score"], key(h)) for h in jh["hits"]]
    if "script_score" in json.dumps(body):  # float32 device vs float64 host
        assert [k for _s, k in got] == [k for _s, k in want]
        assert all(g == pytest.approx(w, rel=1e-5) for (g, _), (w, _) in zip(got, want))
        assert ph["max_score"] == pytest.approx(jh["max_score"], rel=1e-5)
    else:
        assert _within_ulps(ph["max_score"], jh["max_score"], 2)
        assert _tie_tolerant_equal(got, want)
    jby = {key(h): {k: v for k, v in h.items() if k != "_score"} for h in jh["hits"]}
    for h in ph["hits"]:
        assert {k: v for k, v in h.items() if k != "_score"} == jby[key(h)]


def test_malformed_wrapper_is_the_jax_nodes_400(dsl_nodes):
    pbase, jbase, _p = dsl_nodes
    body = {"query": {"wrapper": {"query": "not json at all {"}}}
    (pst, pr), (jst, jr) = (call(b, "POST", "/dsl/_search", body) for b in (pbase, jbase))
    assert pst == jst == 400
    assert pr["error"]["type"] == jr["error"]["type"] == "QueryParsingException"


def test_failed_fetch_drops_only_its_shard_as_on_the_jax_node(dsl_nodes, monkeypatch):
    """A shard's fetch that fails with a plain exception records a
    `_shards.failures` entry and the other shard's hits still return, as on
    the JAX node; no context stays pinned."""
    import elasticsearch_tpu.actions as jactions
    import elasticsearch_tpu_torch.actions as pactions

    pbase, jbase, p = dsl_nodes

    def failing_on_shard0(orig):
        def fetch(*args, **kwargs):
            if kwargs.get("shard_id") == 0:
                raise RuntimeError("fetch lost its segment")
            return orig(*args, **kwargs)
        return fetch

    for mod in (pactions, jactions):
        monkeypatch.setattr(mod, "execute_fetch_phase",
                            failing_on_shard0(mod.execute_fetch_phase))
    body = {"query": {"match": {"body": "the quick brown fox dog"}}, "size": 20}
    (pst, pr), (jst, jr) = (call(b, "POST", "/qt/_search", body) for b in (pbase, jbase))
    assert pst == jst == 200, pr
    pfail = pr["_shards"].pop("failures")
    jfail = jr["_shards"].pop("failures")
    assert pr["_shards"] == jr["_shards"] and pr["_shards"]["failed"] == 1
    assert [(f["index"], f["shard"]) for f in pfail] == \
        [(f["index"], f["shard"]) for f in jfail] == [("qt", 0)]
    assert pfail[0]["reason"].startswith("fetch phase failed:")
    assert "fetch lost its segment" in pfail[0]["reason"]
    assert pr["hits"] == jr["hits"] and 0 < len(pr["hits"]["hits"]) < 10
    assert p.actions.pinned_contexts() == 0


def test_failed_query_phase_leaves_no_context_pinned(dsl_nodes, monkeypatch):
    """A query-phase error that is not a shard failure (a device error) is
    a 500, and no shard that answered keeps its context pinned."""
    import elasticsearch_tpu_torch.actions as pactions

    pbase, _jbase, p = dsl_nodes
    orig = pactions.execute_query_phase

    def failing_on_shard1(ctx, req, **kwargs):
        if kwargs.get("shard_id") == 1:
            raise RuntimeError("sparse_score launch failed: device lost")
        return orig(ctx, req, **kwargs)

    monkeypatch.setattr(pactions, "execute_query_phase", failing_on_shard1)
    assert p.actions.pinned_contexts() == 0
    st, r = call(pbase, "POST", "/qt/_search", {"query": {"match": {"body": "fox"}}})
    assert st == 500 and "device lost" in r["error"]["reason"]
    assert p.actions.pinned_contexts() == 0


# -- field sort, aggregations and facets over REST ---------------------------

# (body, the port's serving counter a shard moves, the query string)
SORT_AGG_CASES = {
    "sort_desc": ({"query": {"match": {"body": "w1 w2"}}, "sort": [{"n": "desc"}],
                   "size": 20}, "device_sort", ""),
    "sort_track_scores": ({"query": {"match": {"body": "w3"}},
                           "sort": [{"n": {"order": "asc", "missing": "_first"}}],
                           "track_scores": True, "size": 15}, "device_sort", ""),
    "sort_url": ({"query": {"match": {"body": "w4 w5"}}, "size": 12}, "device_sort",
                 "?sort=n:desc"),
    "sort_string_then_score": ({"query": {"match": {"body": "w6"}},
                                "sort": [{"meta.tag": "desc"}, "_score"], "size": 25},
                               "host", ""),
    "aggs": ({"query": {"match": {"body": "w1"}}, "size": 5, "aggs": {
        "tags": {"terms": {"field": "meta.tag"},
                 "aggs": {"n_avg": {"avg": {"field": "n"}}}},
        "n_stats": {"stats": {"field": "n"}},
        "h": {"histogram": {"field": "n", "interval": 50}},
        "r": {"range": {"field": "n", "ranges": [{"to": 100}, {"from": 100}]}}}},
             "device_aggs", ""),
    "aggs_host": ({"query": {"match": {"body": "w2"}}, "size": 0, "aggs": {
        "c": {"cardinality": {"field": "meta.tag"}},
        "p": {"percentiles": {"field": "n", "percents": [25, 50, 99]}},
        "e": {"extended_stats": {"field": "n"}}}}, "host", ""),
    "post_filter_aggs": ({"query": {"match": {"body": "w2 w4"}}, "size": 10,
                          "post_filter": {"range": {"n": {"gte": 100}}},
                          "aggs": {"tags": {"terms": {"field": "meta.tag"}},
                                   "m": {"max": {"field": "n"}}}},
                         "device_filtered", ""),
    "sort_aggs": ({"query": {"match": {"body": "w7"}}, "sort": [{"n": "asc"}],
                   "size": 8, "aggs": {"s": {"sum": {"field": "n"}}}},
                  "device_sort", ""),
    "facets": ({"query": {"match": {"body": "w5"}}, "size": 3, "facets": {
        "tags": {"terms": {"field": "meta.tag"}},
        "st": {"statistical": {"field": "n"}},
        "h": {"histogram": {"field": "n", "interval": 40}}}}, "host", ""),
}


@pytest.mark.parametrize("index", ["three", "bm25"])
@pytest.mark.parametrize("case", list(SORT_AGG_CASES))
def test_sort_aggs_and_facets_match_jax_node(nodes, index, case):
    """A sorted body, a `?sort=` URL, metric and bucket aggs, a post filter
    with aggs and facets: the port node answers the JAX node's hits (ids,
    shards, sources, sort values; `_score` null without `track_scores`,
    else within 2 ulp), its aggregations within rel 1e-5 and its facets
    exactly, and its serving counters show the path once a shard."""
    body, counter, query_string = SORT_AGG_CASES[case]
    pbase, jbase, _p = nodes
    before = dict(SERVING_COUNTERS)
    pst, pr = call(pbase, "POST", f"/{index}/_search{query_string}", body)
    counted = {k: v - before[k] for k, v in SERVING_COUNTERS.items() if v != before[k]}
    jst, jr = call(jbase, "POST", f"/{index}/_search{query_string}", body)
    assert pst == jst == 200, (pr, jr)
    assert counted == {counter: 3}, counted
    assert pr["_shards"] == jr["_shards"]
    ph, jh = pr["hits"], jr["hits"]
    assert ph["total"] == jh["total"] > 0
    assert (ph["max_score"] is None) == (jh["max_score"] is None)
    if ph["max_score"] is not None:
        assert _within_ulps(ph["max_score"], jh["max_score"], 2)
    assert [{k: v for k, v in h.items() if k != "_score"} for h in ph["hits"]] == \
        [{k: v for k, v in h.items() if k != "_score"} for h in jh["hits"]]
    for h, w in zip(ph["hits"], jh["hits"]):
        assert (h["_score"] is None) == (w["_score"] is None)
        if h["_score"] is not None:
            assert _within_ulps(h["_score"], w["_score"], 2)
    if "sort" in body or query_string:
        assert all("sort" in h for h in ph["hits"])
        if not body.get("track_scores") and "_score" not in body.get("sort", []):
            assert all(h["_score"] is None for h in ph["hits"])
    _agg_equal(pr.get("aggregations"), jr.get("aggregations"))
    assert pr.get("facets") == jr.get("facets")


# ---------------------------------------------------------------------------
# the write path: refreshes, _optimize and _flush
# ---------------------------------------------------------------------------

WRITE_BODIES = [
    {"query": {"match": {"body": "w1 w2 w3"}}, "size": 20},
    {"query": {"bool": {"must": [{"term": {"body": "w2"}}],
                        "should": [{"term": {"title": "w4"}}],
                        "must_not": [{"term": {"body": "w5"}}]}}, "size": 15},
    {"query": {"match": {"title": "over written"}}, "size": 5},
]


def _write_bulks(seed: int) -> list[str]:
    """Three `_bulk` bodies into `wr`: new documents each round, the later
    rounds also deleting and overwriting earlier ones across segments."""
    rng = np.random.default_rng(seed)

    def doc(i):
        return {"title": " ".join(rng.choice(WORDS[:12], 2)),
                "body": " ".join(rng.choice(WORDS[:20], int(rng.integers(2, 25)))), "n": i}

    bulks = []
    for r in range(3):
        ops = []
        for i in range(60 * r, 60 * r + 60):
            ops += [{"index": {"_index": "wr", "_type": "doc", "_id": str(i)}}, doc(i)]
        for i in range(r, 60 * r, 11):
            ops.append({"delete": {"_index": "wr", "_type": "doc", "_id": str(i)}})
        for i in range(r + 3, 60 * r, 17):
            ops += [{"index": {"_index": "wr", "_type": "doc", "_id": str(i)}},
                    {"title": "over written", "body": "w1 w1 w2 w3", "n": -i}]
        bulks.append("\n".join(json.dumps(x) for x in ops) + "\n")
    return bulks


def test_writes_optimize_and_flush_match_jax_node(tmp_path_factory):
    """The same bulks into a 3-shard index on both nodes, three refresh
    rounds, then `_optimize`, then `_flush`: after each step every search
    answers the JAX node's hits JSON (bitwise scores: the sparse path), and
    `_optimize` and `_flush` answer as on the JAX node. On the port node
    each shard ends with one segment, and after its first search every pack
    ran on the warmer or merge pool."""
    from elasticsearch_tpu_torch.ops.device_index import PACK_LEDGER

    def fill(base):
        st, r = call(base, "PUT", "/wr", {"settings": {"number_of_shards": 3,
                                                       "refresh_interval": -1}})
        assert st == 200 and r["acknowledged"], r

    pair = _node_pair(tmp_path_factory, fill)
    pbase, jbase, pnode = next(pair)

    def same_hits(step):
        for body in WRITE_BODIES:
            (pst, pr), (jst, jr) = (call(b, "POST", "/wr/_search", body)
                                    for b in (pbase, jbase))
            assert pst == jst == 200, (step, pr, jr)
            assert pr["_shards"] == jr["_shards"], step
            assert pr["hits"] == jr["hits"], step

    def wait_drained():
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            st = pnode.warmer.stats()
            if st["packs_done"] >= st["packs_scheduled"]:
                return
            time.sleep(0.02)

    try:
        for r, bulk in enumerate(_write_bulks(23)):
            for base in (pbase, jbase):
                st, resp = call(base, "POST", "/_bulk", raw=bulk)
                assert st == 200 and not resp["errors"], resp
                assert call(base, "POST", "/wr/_refresh")[0] == 200
            wait_drained()  # the refresh's caller waits for the warmer
            same_hits(f"refresh {r}")
            if r == 0:
                PACK_LEDGER.forget("wr")  # the gate's inline packs
        for op in ("_optimize", "_flush"):
            (pst, pr), (jst, jr) = (call(b, "POST", f"/wr/{op}") for b in (pbase, jbase))
            assert pst == jst == 200 and pr == jr, (op, pr, jr)
            assert pr["_shards"]["failed"] == 0
            wait_drained()
            same_hits(op)
        svc = pnode.indices.index_service("wr")
        assert [svc.shard(s).engine.segment_count() for s in range(3)] == [1, 1, 1]
        wait_drained()
        st = PACK_LEDGER.stats("wr")
        assert st["compacts"] == 3 and st["delta_packs"] >= 6, st
        assert set(st["pools"]) <= {"warmer", "merge"}, st["pools"]
    finally:
        pair.close()
