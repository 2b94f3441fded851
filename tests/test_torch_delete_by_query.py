"""Delete-by-query and `DELETE _mapping` on the port, against the JAX
package.

- The translog's op 4 (`DELETE_BY_QUERY`, its query and the uids it
  resolved) is byte-compatible both ways: each package's `Translog` reads
  the other's file back to the same ops, the index ops' `timestamp` and
  `ttl` included.
- tests/test_search_single_shard.py::test_delete_by_query_survives_restart
  on the port's Engine: a document deleted by query does not come back
  when the engine recovers from its store and translog; nor on a port node
  restarted over its `path.data`.
- Node against node over HTTP (each index at `refresh_interval: -1`):
  `DELETE /{index}/_query` and `/{index}/{type}/_query` with a `term`, a
  `match`, a `filtered` `terms`, a `bool`, a `range` and `?q=` answer the
  same JSON, and the searches and counts after them the same hits, on an
  index of its own each; a nested parent deleted by query takes its
  children out of the nested counts; `DELETE _mapping` drops the type's
  documents and keeps the others', and a missing type answers the JAX
  node's 404.
- The port's shard request cache misses after a delete-by-query (its
  entries are keyed by view, and the delete's refresh makes a new one),
  and its answer no longer counts the deleted documents; searches running
  while a delete-by-query runs all answer, and none after its refresh
  names a deleted document."""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest

from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg
from tests.test_torch_node import _node_pair, call

TAGS = [f"tag{i}" for i in range(10)]
WORDS = ["quick", "brown", "fox", "lazy", "dog", "red", "wolf", "slow", "turtle", "bear"]
SETTINGS = {"number_of_shards": 3, "number_of_replicas": 0, "refresh_interval": -1}
POST = {"properties": {"title": {"type": "string"}, "body": {"type": "string"},
                       "tags": {"type": "string", "index": "not_analyzed"},
                       "views": {"type": "integer"}}}
NESTED = {"properties": {"title": {"type": "string"},
                         "comments": {"type": "nested", "properties": {
                             "who": {"type": "string", "index": "not_analyzed"},
                             "stars": {"type": "integer"}}}}}


def _posts(n: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [{"title": " ".join(rng.choice(WORDS, 2)),
             "body": " ".join(rng.choice(WORDS, int(rng.integers(3, 12)))),
             "tags": [str(t) for t in rng.choice(TAGS, 2, replace=False)],
             "views": int(rng.integers(0, 100))} for _ in range(n)]


def _bulk(index: str, type_name: str, docs: list[dict]) -> str:
    lines = []
    for i, d in enumerate(docs):
        lines += [json.dumps({"index": {"_index": index, "_type": type_name,
                                        "_id": str(i)}}), json.dumps(d)]
    return "\n".join(lines) + "\n"


# (path suffix after the index, body or None, query string)
DBQ_CASES = {
    "term": ("/_query", {"query": {"term": {"tags": "tag3"}}}),
    "match": ("/_query", {"query": {"match": {"body": "fox wolf"}}}),
    "filtered_terms": ("/post/_query", {"query": {"filtered": {"filter": {
        "terms": {"tags": ["tag1", "tag2", "tag5"]}}}}}),
    "bool": ("/_query", {"query": {"bool": {"must": [{"match": {"title": "quick"}}],
                                            "must_not": [{"term": {"tags": "tag0"}}]}}}),
    "range": ("/_query", {"query": {"filtered": {"filter": {
        "range": {"views": {"gte": 20, "lt": 60}}}}}}),
    "q_param": ("/_query?q=title:lazy", None),
    "no_match": ("/_query", {"query": {"term": {"tags": "nothere"}}}),
}
AFTER = [
    {"query": {"match_all": {}}, "size": 200},
    {"query": {"match": {"body": "quick brown dog"}}, "size": 20},
    {"query": {"bool": {"should": [{"term": {"tags": t}} for t in TAGS[:4]]}}, "size": 50},
    {"size": 0, "aggs": {"t": {"terms": {"field": "tags", "size": 20}}}},
]


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    posts = _posts(120, 7)

    def fill(base):
        for case in DBQ_CASES:
            index = f"dbq_{case}"
            st, r = call(base, "PUT", f"/{index}", {"settings": SETTINGS,
                                                    "mappings": {"post": POST}})
            assert st == 200, r
            assert not call(base, "POST", "/_bulk", raw=_bulk(index, "post", posts))[1]["errors"]
            # a second segment a shard, with overwrites
            more = {str(i): {**posts[i], "views": 99} for i in range(0, 120, 7)}
            lines = []
            for doc_id, d in more.items():
                lines += [json.dumps({"index": {"_index": index, "_type": "post",
                                                "_id": doc_id}}), json.dumps(d)]
            call(base, "POST", f"/{index}/_refresh")
            assert not call(base, "POST", "/_bulk", raw="\n".join(lines) + "\n")[1]["errors"]
            call(base, "POST", f"/{index}/_refresh")

    yield from _node_pair(tmp_path_factory, fill)


def _both(nodes, method, path, body=None, raw=None):
    pbase, jbase, _p = nodes
    (pst, pr), (jst, jr) = (call(b, method, path, body, raw) for b in (pbase, jbase))
    for r in (pr, jr):
        if isinstance(r, dict):
            r.pop("took", None)
    assert (pst, pr) == (jst, jr), (method, path, pr, jr)
    return pst, pr


@pytest.mark.parametrize("case", list(DBQ_CASES))
def test_delete_by_query_matches_jax_node(nodes, case):
    index = f"dbq_{case}"
    suffix, body = DBQ_CASES[case]
    st, before = _both(nodes, "GET", f"/{index}/_count")
    st, r = _both(nodes, "DELETE", f"/{index}{suffix}", body)
    assert st == 200 and list(r["_indices"]) == [index]
    deleted = r["_indices"][index]["deleted"]
    assert (deleted == 0) == (case == "no_match"), r
    st, after = _both(nodes, "GET", f"/{index}/_count")
    assert after["count"] == before["count"] - deleted
    for search in AFTER:
        st, r = _both(nodes, "POST", f"/{index}/_search", search)
        assert st == 200 and r["_shards"]["failed"] == 0
    # a GET of every document: the deleted ones are gone on both
    st, r = _both(nodes, "POST", f"/{index}/post/_mget",
                  {"ids": [str(i) for i in range(120)]})
    assert sum(d["found"] for d in r["docs"]) == after["count"]


def test_nested_parent_deleted_by_query_takes_its_children(nodes):
    docs = [{"title": f"post {w}", "comments": [{"who": w, "stars": s}
                                                for s in range(1 + i % 3)]}
            for i, w in enumerate(WORDS)]
    count = {"size": 0, "query": {"match_all": {}}, "aggs": {
        "c": {"nested": {"path": "comments"}, "aggs": {"s": {"sum": {"field":
                                                                        "comments.stars"}}}}}}
    _both(nodes, "PUT", "/dbq_nested", {"settings": SETTINGS, "mappings": {"post": NESTED}})
    _both(nodes, "POST", "/_bulk", raw=_bulk("dbq_nested", "post", docs))
    _both(nodes, "POST", "/dbq_nested/_refresh")
    st, r0 = _both(nodes, "POST", "/dbq_nested/_search", count)
    st, r = _both(nodes, "DELETE", "/dbq_nested/_query",
                  {"query": {"match": {"title": "fox wolf"}}})
    assert r["_indices"]["dbq_nested"]["deleted"] == 2
    st, r1 = _both(nodes, "POST", "/dbq_nested/_search", count)
    gone = sum(len(d["comments"]) for d in docs if d["title"] in ("post fox", "post wolf"))
    assert r1["hits"]["total"] == r0["hits"]["total"] - 2
    assert r1["aggregations"]["c"]["doc_count"] == r0["aggregations"]["c"]["doc_count"] - gone


def test_delete_mapping_deletes_its_documents_as_the_jax_node(nodes):
    _both(nodes, "PUT", "/dbq_types", {"settings": SETTINGS, "mappings": {
        "post": POST, "draft": POST}})
    posts = _posts(40, 11)
    _both(nodes, "POST", "/_bulk", raw=_bulk("dbq_types", "post", posts[:30])
          + _bulk("dbq_types", "draft", posts[30:]).replace('"_id": "', '"_id": "d'))
    _both(nodes, "POST", "/dbq_types/_refresh")
    st, r = _both(nodes, "DELETE", "/dbq_types/_mapping/draft")
    assert st == 200 and r == {"acknowledged": True}
    st, r = _both(nodes, "GET", "/dbq_types/_mapping")
    assert list(r["dbq_types"]["mappings"]) == ["post"]
    st, r = _both(nodes, "GET", "/dbq_types/_count")
    assert r["count"] == 30
    st, r = _both(nodes, "POST", "/dbq_types/_search", {"query": {"filtered": {
        "filter": {"type": {"value": "draft"}}}}})
    assert r["hits"]["total"] == 0
    st, r = _both(nodes, "DELETE", "/dbq_types/draft/_mapping")
    assert st == 404 and r["error"]["type"] == "TypeMissingException"
    st, r = _both(nodes, "DELETE", "/nothere/_mapping/post")
    assert st == 404


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_translog_op4_reads_back_in_the_other_package(tmp_path, direction):
    from elasticsearch_tpu.index import translog as jt
    from elasticsearch_tpu_torch.index import translog as tt

    write, read = (tt, jt) if direction == "port_to_jax" else (jt, tt)
    assert tt.DELETE_BY_QUERY == jt.DELETE_BY_QUERY == 4
    log = write.Translog(str(tmp_path))
    ops = [write.TranslogOp(write.INDEX, "doc", "1", {"t": "a"}, version=1,
                            timestamp="2014-01-01", ttl="1d"),
           write.TranslogOp(write.CREATE, "doc", "2", {"t": "b"}, routing="r",
                            version=1, ttl=5000),
           write.TranslogOp(write.DELETE_BY_QUERY, query={"match": {"t": "a"}},
                            source={"uids": ["doc#1", "doc#3"]}),
           write.TranslogOp(write.DELETE_BY_QUERY, query={"expired": True},
                            source={"uids": []})]
    for op in ops:
        log.add(op)
    log.sync()
    log.close()
    got = read.Translog(str(tmp_path)).read_ops()
    slots = ("op", "type", "id", "source", "routing", "version", "query", "parent",
             "timestamp", "ttl")
    assert [[getattr(o, k) for k in slots] for o in got] == \
        [[getattr(o, k) for k in slots] for o in ops]
    assert [o.encode() for o in got] == [o.encode() for o in ops]


def test_delete_by_query_survives_restart(tmp_path):
    """tests/test_search_single_shard.py::test_delete_by_query_survives_restart
    on the port's Engine."""
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.mapper import MapperService

    svc = MapperService()
    e = Engine(str(tmp_path / "dbq"), svc)
    e.index("doc", "1", {"t": "remove me"})
    e.index("doc", "2", {"t": "keep me"})
    e.refresh()
    e.delete_by_uids(["doc#1"], query={"match": {"t": "remove"}})
    e.refresh()
    live = lambda eng: sum(s.live_count() for s in eng.acquire_searcher().segments)  # noqa: E731
    assert live(e) == 1
    e.translog.sync()
    e.close()
    e2 = Engine(str(tmp_path / "dbq"), svc)
    e2.recover_from_store()
    assert live(e2) == 1  # the deleted document must not come back
    assert not e2.get("doc", "1").found and e2.get("doc", "2").found
    e2.close()


def test_node_restart_keeps_documents_deleted_by_query(tmp_path):
    data = str(tmp_path / "data")
    node = PNode(name="dbq", settings={"node.device": "cpu"}, registry=PReg(),
                 data_path=data).start()
    try:
        base = f"http://127.0.0.1:{node.start_http(0).port}"
        call(base, "PUT", "/r", {"settings": SETTINGS, "mappings": {"post": POST}})
        assert not call(base, "POST", "/_bulk", raw=_bulk("r", "post", _posts(60, 3)))[1]["errors"]
        call(base, "POST", "/r/_flush")  # a commit, then the delete in the translog
        st, r = call(base, "DELETE", "/r/_query", {"query": {"term": {"tags": "tag4"}}})
        deleted = r["_indices"]["r"]["deleted"]
        assert st == 200 and deleted > 0
        count = call(base, "GET", "/r/_count")[1]["count"]
        assert count == 60 - deleted
    finally:
        node.close()
    node = PNode(name="dbq", settings={"node.device": "cpu"}, registry=PReg(),
                 data_path=data).start()
    try:
        base = f"http://127.0.0.1:{node.start_http(0).port}"
        assert node.client().cluster_health(index="r", wait_for_status="green")["status"] \
            == "green"
        assert call(base, "GET", "/r/_count")[1]["count"] == count
        st, r = call(base, "POST", "/r/_search", {"query": {"term": {"tags": "tag4"}}})
        assert r["hits"]["total"] == 0
    finally:
        node.close()


@pytest.mark.parametrize("warmer", ["warmer_off", "warmer_on"])
def test_request_cache_misses_after_a_delete_by_query(tmp_path, warmer):
    """The cached size-0 body is a hit until the delete-by-query; then its
    entry, keyed by the old view, is never served: with the warmer off the
    next search misses on every shard, with it on the warmer's re-prime or
    the search stores a new entry a shard. Either way the answer counts
    the deletion."""
    node = PNode(name="dbqc", settings={"node.device": "cpu",
                                        "indices.warmer.enabled": warmer == "warmer_on"},
                 registry=PReg(), data_path=str(tmp_path)).start()
    try:
        base = f"http://127.0.0.1:{node.start_http(0).port}"
        call(base, "PUT", "/c", {"settings": SETTINGS, "mappings": {"post": POST}})
        posts = _posts(90, 5)
        call(base, "POST", "/_bulk", raw=_bulk("c", "post", posts))
        call(base, "POST", "/c/_refresh")
        body = {"size": 0, "query": {"match_all": {}},
                "aggs": {"t": {"terms": {"field": "tags", "size": 20}}}}
        rc = node.request_cache
        first = call(base, "POST", "/c/_search", body)[1]
        s0 = rc.stats()
        again = call(base, "POST", "/c/_search", body)[1]
        s1 = rc.stats()
        assert s1["hits"] - s0["hits"] == 3 and s1["misses"] == s0["misses"]
        assert again["aggregations"] == first["aggregations"]
        st, r = call(base, "DELETE", "/c/_query", {"query": {"term": {"tags": "tag6"}}})
        n = r["_indices"]["c"]["deleted"]
        assert n == sum("tag6" in p["tags"] for p in posts) > 0
        s2 = rc.stats()
        after = call(base, "POST", "/c/_search", body)[1]
        s3 = rc.stats()
        if warmer == "warmer_off":
            assert s3["misses"] - s2["misses"] == 3 and s3["hits"] == s2["hits"]
        # the new views' entries, stored by the re-prime or by the search
        assert s3["stores"] - s1["stores"] == 3
        assert after["hits"]["total"] == 90 - n
        buckets = {b["key"]: b["doc_count"] for b in after["aggregations"]["t"]["buckets"]}
        assert "tag6" not in buckets
    finally:
        node.close()


def test_searches_during_a_delete_by_query_all_answer(tmp_path):
    node = PNode(name="dbqs", settings={"node.device": "cpu"}, registry=PReg(),
                 data_path=str(tmp_path)).start()
    try:
        base = f"http://127.0.0.1:{node.start_http(0).port}"
        call(base, "PUT", "/s", {"settings": SETTINGS, "mappings": {"post": POST}})
        posts = _posts(150, 9)
        call(base, "POST", "/_bulk", raw=_bulk("s", "post", posts))
        call(base, "POST", "/s/_refresh")
        body = {"query": {"bool": {"should": [{"match": {"body": "quick fox"}},
                                              {"term": {"tags": "tag2"}}]}}, "size": 150}
        errors, stop = [], threading.Event()

        def searcher():
            while not stop.is_set():
                st, r = call(base, "POST", "/s/_search", body)
                if st != 200 or r["_shards"]["failed"]:
                    errors.append((st, r))

        threads = [threading.Thread(target=searcher) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            st, r = call(base, "DELETE", "/s/_query", {"query": {"term": {"tags": "tag2"}}})
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        assert st == 200 and not errors, errors[:2]
        gone = {str(i) for i, p in enumerate(posts) if "tag2" in p["tags"]}
        assert r["_indices"]["s"]["deleted"] == len(gone) > 0
        st, r = call(base, "POST", "/s/_search", body)
        assert not gone & {h["_id"] for h in r["hits"]["hits"]}
        assert r["hits"]["total"] == sum(
            1 for i, p in enumerate(posts) if str(i) not in gone
            and ({"quick", "fox"} & set(p["body"].split())))
    finally:
        node.close()
