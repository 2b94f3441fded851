"""`_ttl` and its purger on the port, against the JAX package.

- The mapper, module against module: a TTL from the document, the
  parameter or the mapping's default (a number of milliseconds or a time
  value) parses to the same `ttl` and the same `_expiry` doc value from a
  fixed timestamp; a TTL on a type without `_ttl` is ignored; a document
  already expired raises AlreadyExpiredError in both packages, and both
  nodes answer it with the same 400.
- The remaining TTL that GET reports shrinks on the wall clock: it is
  compared with bounds (positive, at most the stored TTL), never for
  equality, on both nodes, for `?ttl=`, the mapping's default and an
  update script's `ctx._ttl`.
- The purge, called directly (`node._purge_expired()`, as
  tests/test_cluster.py::test_ttl_purge calls it; no test waits out an
  interval): on the engine (that test's case), and node against node over
  HTTP, where the same documents leave both nodes' counts and GETs and the
  unexpired ones stay; the purge is logged, so a restart over `path.data`
  does not bring a purged document back.
- `indices.ttl.interval` sets the purger's period, and `close()` cancels
  it."""

from __future__ import annotations

import time

import pytest
import torch

from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg
from tests.test_torch_node import call

FUTURE_TS = 4102444800000  # 2100-01-01: a fixed stamp no TTL here has passed
DAY_MS = 86_400_000
SETTINGS = {"number_of_shards": 2, "number_of_replicas": 0, "refresh_interval": -1}
SESSIONS = {"_ttl": {"enabled": True, "default": "1d"},
            "properties": {"user": {"type": "string", "index": "not_analyzed"}}}


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """(port base URL, JAX base URL, port node, JAX node), each with a
    `sessions` index."""
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu.transport.local import LocalTransportRegistry as JReg

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    p = PNode(name="ttl_port", settings={"node.device": "cpu"}, registry=PReg(),
              data_path=str(tmp_path_factory.mktemp("ttl_port"))).start()
    j = JNode(name="ttl_jax", settings={"search.mesh.enabled": "false",
                                        "indices.warmer.enabled": "false"},
              registry=JReg(), data_path=str(tmp_path_factory.mktemp("ttl_jax")))
    try:
        j.start([j.local_node.transport_address])
        j.wait_for_master()
        bases = [f"http://127.0.0.1:{p.start_http(0).port}",
                 f"http://127.0.0.1:{j.start_http(0).port}"]
        for base in bases:
            st, r = call(base, "PUT", "/sessions", {"settings": SETTINGS,
                                                    "mappings": {"s": SESSIONS}})
            assert st == 200 and r["primaries_active"], r
        yield bases[0], bases[1], p, j
    finally:
        p.close()
        j.close()
        torch.set_num_threads(threads)


def _both(nodes, method, path, body=None):
    (pst, pr), (jst, jr) = (call(b, method, path, body) for b in nodes[:2])
    for r in (pr, jr):
        r.pop("took", None)
    assert (pst, pr) == (jst, jr), (method, path, pr, jr)
    return pst, pr


# (mapping's _ttl, parse keyword ttl): the TTL each parses to
PARSE_CASES = {
    "param_ms": ({"enabled": True}, 5000, 5000),
    "param_time_value": ({"enabled": True}, "90m", 5_400_000),
    "param_bare_string": ({"enabled": True}, "2500", 2500),
    "default": ({"enabled": True, "default": "1d"}, None, DAY_MS),
    "param_over_default": ({"enabled": True, "default": "1d"}, "1h", 3_600_000),
    "disabled": ({"enabled": False}, "1h", None),
    "no_ttl": ({"enabled": True}, None, None),
}


@pytest.mark.parametrize("case", list(PARSE_CASES))
def test_ttl_parses_as_the_jax_mapper(case):
    from elasticsearch_tpu.mapper import MapperService as JMapperService
    from elasticsearch_tpu_torch.mapper import MapperService as TMapperService

    ttl_mapping, ttl, want = PARSE_CASES[case]
    jms, tms = JMapperService(), TMapperService()
    for ms in (jms, tms):
        ms.put_mapping("s", {"_ttl": ttl_mapping, "_timestamp": {"enabled": True}})
    assert tms.mappings_dict() == jms.mappings_dict()
    jdoc, tdoc = (ms.mapper_for("s").parse({"user": "u"}, "1", timestamp=FUTURE_TS,
                                           ttl=ttl) for ms in (jms, tms))
    assert tdoc.ttl == jdoc.ttl == want
    assert tdoc.doc_values_num == jdoc.doc_values_num
    assert tdoc.doc_values_num.get("_expiry") == (
        None if want is None else [float(FUTURE_TS + want)])


def test_already_expired_raises_on_both(nodes):
    from elasticsearch_tpu.common.errors import AlreadyExpiredError as JExpired
    from elasticsearch_tpu.mapper import MapperService as JMapperService
    from elasticsearch_tpu_torch.common.errors import AlreadyExpiredError as TExpired
    from elasticsearch_tpu_torch.mapper import MapperService as TMapperService

    messages = []
    for ms, err in ((JMapperService(), JExpired), (TMapperService(), TExpired)):
        ms.put_mapping("s", SESSIONS)
        with pytest.raises(err) as e:
            ms.mapper_for("s").parse({"user": "u"}, "1", timestamp=1388534400000,
                                     ttl="1d")
        messages.append((str(e.value), e.value.status))
    assert messages[0] == messages[1] and messages[1][1] == 400
    st, r = _both(nodes, "PUT", "/sessions/s/old?timestamp=2014-01-01&ttl=1d", {"user": "u"})
    assert st == 400 and r["error"]["type"] == "AlreadyExpiredException", r
    st, r = _both(nodes, "GET", "/sessions/s/old")
    assert st == 404


@pytest.mark.parametrize("how", ["param", "default", "script"])
def test_remaining_ttl_is_bounded_on_both(nodes, how):
    doc = f"/sessions/s/bound_{how}"
    if how == "param":
        _both(nodes, "PUT", f"{doc}?ttl=1h", {"user": "a"})
        stored = 3_600_000
    elif how == "default":
        _both(nodes, "PUT", doc, {"user": "a"})
        stored = DAY_MS
    else:
        _both(nodes, "PUT", doc, {"user": "a"})
        st, r = _both(nodes, "POST", f"{doc}/_update", {"script": "ctx._ttl = '2h'"})
        assert st == 200 and r["_version"] == 2
        stored = 7_200_000
    for base in nodes[:2]:
        st, r = call(base, "GET", f"{doc}?fields=_ttl,user")
        assert st == 200 and r["fields"]["user"] == ["a"], r
        assert 0 < r["fields"]["_ttl"] < stored, r
        assert stored - r["fields"]["_ttl"] < 60_000, r
    _both(nodes, "POST", "/sessions/_refresh")  # and from the segment
    for node in nodes[2:]:
        g = node.client().get("sessions", "s", f"bound_{how}")
        assert 0 < g["_ttl"] < stored and stored - g["_ttl"] < 60_000, g


def test_purge_removes_expired_documents_on_both_nodes(nodes):
    users = [f"p{i}" for i in range(12)]
    for i, u in enumerate(users):
        # every third session lives 200 ms, the rest the default day
        suffix = "?ttl=200ms" if i % 3 == 0 else ""
        st, r = _both(nodes, "PUT", f"/sessions/s/{u}{suffix}", {"user": u})
        assert st == 201
    _both(nodes, "POST", "/sessions/_refresh")
    count = {"query": {"prefix": {"user": "p"}}}
    st, before = _both(nodes, "POST", "/sessions/_count", count)
    assert before["count"] == 12
    time.sleep(0.3)
    for node in nodes[2:]:
        node._purge_expired()
    st, after = _both(nodes, "POST", "/sessions/_count", count)
    assert after["count"] == 8
    for i, u in enumerate(users):
        st, r = _both(nodes, "GET", f"/sessions/s/{u}")
        assert st == (404 if i % 3 == 0 else 200), (u, r)
    st, r = _both(nodes, "POST", "/sessions/_search", {**count, "size": 20})
    assert sorted(h["_id"] for h in r["hits"]["hits"]) == sorted(
        u for i, u in enumerate(users) if i % 3)


def test_engine_purge_as_the_jax_test(nodes):
    """tests/test_cluster.py::test_ttl_purge on the port node's shard."""
    pnode = nodes[2]
    body = {"settings": {"number_of_shards": 1, "number_of_replicas": 0},
            "mappings": {"doc": {"_ttl": {"enabled": True},
                                 "_timestamp": {"enabled": True}}}}
    pnode.client().create_index("ttl", body)
    pnode.client().cluster_health(wait_for_status="green")
    shard = pnode.indices.index_service("ttl").shard(0)
    shard.engine.index("doc", "old", {"x": 1}, ttl=30)
    shard.engine.index("doc", "new", {"x": 2}, ttl="10d")
    shard.engine.refresh()
    time.sleep(0.05)
    live = lambda: sum(s.live_count() for s in shard.engine.acquire_searcher().segments)  # noqa: E731
    assert live() == 2
    pnode._purge_expired()
    assert live() == 1
    assert not shard.engine.get("doc", "old").found
    assert shard.engine.get("doc", "new").found


def test_purge_survives_restart_and_interval_is_read(tmp_path):
    data = str(tmp_path / "data")
    settings = {"node.device": "cpu", "indices.ttl.interval": "1h"}
    node = PNode(name="ttlr", settings=settings, registry=PReg(), data_path=data).start()
    try:
        assert node._ttl_task.interval == 3600.0
        base = f"http://127.0.0.1:{node.start_http(0).port}"
        call(base, "PUT", "/sessions", {"settings": SETTINGS, "mappings": {"s": SESSIONS}})
        for i in range(6):
            ttl = "?ttl=150ms" if i % 2 else ""
            assert call(base, "PUT", f"/sessions/s/{i}{ttl}", {"user": f"u{i}"})[0] == 201
        call(base, "POST", "/sessions/_flush")
        time.sleep(0.25)
        node._purge_expired()  # logged after the commit: replayed on restart
        assert call(base, "GET", "/sessions/_count")[1]["count"] == 3
    finally:
        node.close()
    assert node._ttl_task.cancelled.is_set()
    node = PNode(name="ttlr", settings=settings, registry=PReg(), data_path=data).start()
    try:
        base = f"http://127.0.0.1:{node.start_http(0).port}"
        node.client().cluster_health(index="sessions", wait_for_status="green")
        assert call(base, "GET", "/sessions/_count")[1]["count"] == 3
        for i in range(6):
            assert call(base, "GET", f"/sessions/s/{i}")[0] == (404 if i % 2 else 200)
    finally:
        node.close()
