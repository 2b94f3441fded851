"""Replicas on a port cluster, held against a JAX cluster given the same
requests: the replica write legs, failover of a search across copies, a
failed replica reported to the master, promotion when a primary's node
leaves.

Each cluster runs on its own in-process transport registry, each node with
its own `path.data` and HTTP port (tests/test_torch_two_nodes.py
`Cluster`: the JAX nodes with their mesh and warmer off, the port nodes on
the CPU with their warmer off). Every wait is on state, and every node is
closed in a fixture or a `finally`.

- Writes on a 1-replica index (index with internal and external versions,
  delete, `_bulk` with index, create, delete and update items, `_update`
  by doc, script and upsert, `_create`, delete-by-query): after each
  family, every copy of every shard holds the same ids, versions and
  sources as the other copy, and as the JAX cluster's copy on the same
  node (tolerance: none).
- The green cluster's `_cluster/health`, `_cat/shards` and `_cat/recovery`
  answer the JAX cluster's bodies (the store size column left out: the
  two packages' commit files differ in length).
- `_only_node` searches to each node read only that node's copies and
  answer the JAX cluster's hits JSON (ids and scores bitwise).
- The port's copy of tests/test_cluster.py::TestReplicaRecoveryAndFailover
  on both packages: a replica added to a flushed index peer-recovers the
  documents; losing a primary's node promotes the replica and every
  document is still found.
- The port's copies of tests/test_resilience.py's search failover cases
  (:313-455) on both packages: with the query phase to one node
  disconnected, every shard fails over to the other copy (failed 0); with
  every copy disconnected, one failure entry a copy; a delayed shard under
  a 150 ms budget answers a partial, `timed_out`, well inside the budget's
  order of magnitude.
- The port's copies of :457 and :501: a replica whose write transport is
  down is reported shard-failed and routed out, after a bulk and after a
  single-document index, on both packages.
- The TTL purge runs on primaries only, on both packages: a replica keeps
  an expired document until its next recovery.
- Port only (a declared difference): a closing node waits up to a second
  for the contexts its query phases pinned and records the wait in
  `close_drain`."""

import json
import random
import threading
import time
import urllib.request

import pytest

from tests.test_torch_node import call
from tests.test_torch_two_nodes import FD, Cluster, threads, wait_until  # noqa: F401

A_QUERY = "indices:data/read/search[phase/query]"


def _both(tmp, names, **kw):
    p = Cluster("port", names, tmp, **kw)
    try:
        j = Cluster("jax", names, tmp, **kw)
    except BaseException:
        p.close()
        raise
    return p, j


def _text(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as resp:
        return resp.status, resp.read().decode()


def copies(cluster, index):
    """(shard, node name) -> {id: (version, source)} of every local copy of
    `index`, each refreshed first."""
    out = {}
    for n in cluster.nodes:
        if n._closed:
            continue
        svc = n.indices.indices.get(index)
        if svc is None:
            continue
        for sid, shard in list(svc.shards.items()):
            shard.engine.refresh()
            docs = {}
            for seg in shard.engine.acquire_searcher().segments:
                for local in (seg.live & seg.parent_mask).nonzero()[0]:
                    docs[str(seg.ids[local])] = (int(seg.versions[local]),
                                                 seg.stored[local])
            out[(sid, n.name)] = docs
    return out


def assert_copies_agree(p, j, index):
    pc, jc = copies(p, index), copies(j, index)
    assert sorted(pc) == sorted(jc), (sorted(pc), sorted(jc))
    for sid in {sid for sid, _n in pc}:
        held = [docs for (s, _n), docs in pc.items() if s == sid]
        assert len(held) == 2 and held[0] == held[1], (index, sid)
    assert pc == jc
    return pc


@pytest.fixture(scope="module")
def rpair(tmp_path_factory, threads):  # noqa: F811
    p, j = _both(tmp_path_factory.mktemp("rpair"), ["a", "b"])
    try:
        yield p, j
    finally:
        p.close()
        j.close()


def _each(pair, method, path, body=None, raw=None, node="b"):
    """The same request to `node` of both clusters: [(status, body)] * 2."""
    return [call(c.base(node), method, path, body, raw=raw) for c in pair]


def _make(pair, index, shards=2):
    for st, r in _each(pair, "PUT", f"/{index}", {"settings": {
            "number_of_shards": shards, "number_of_replicas": 1,
            "refresh_interval": -1}}):
        assert st == 200 and r["acknowledged"], r
    for c in pair:
        assert c.settled(index, status="green")


def _agree(answers):
    (pst, pr), (jst, jr) = answers
    assert pst == jst, (pr, jr)
    if pst < 300:
        for key in ("_version", "found", "created"):
            assert pr.get(key) == jr.get(key), (key, pr, jr)
    return pst, pr


def _bulk_lines(items):
    return "".join(json.dumps(a) + "\n" + (json.dumps(s) + "\n" if s is not None else "")
                   for a, s in items)


WRITES = {
    "index": lambda pair, ix: [
        *[_agree(_each(pair, "PUT", f"/{ix}/doc/{i}", {"body": f"w{i % 5}", "n": i}))
          for i in range(16)],
        *[_agree(_each(pair, "PUT", f"/{ix}/doc/{i}", {"body": "again", "n": -i}))
          for i in range(0, 16, 3)],
        _agree(_each(pair, "PUT", f"/{ix}/doc/3?version=10&version_type=external",
                     {"body": "external"})),
        _agree(_each(pair, "PUT", f"/{ix}/doc/3?version=9&version_type=external",
                     {"body": "stale"})),
        _agree(_each(pair, "PUT", f"/{ix}/doc/4?version=1", {"body": "cas"}))],
    "delete": lambda pair, ix: [
        *[_agree(_each(pair, "PUT", f"/{ix}/doc/{i}", {"body": f"w{i}"}))
          for i in range(12)],
        *[_agree(_each(pair, "DELETE", f"/{ix}/doc/{i}")) for i in (1, 5, 9, 44)],
        _agree(_each(pair, "PUT", f"/{ix}/doc/5", {"body": "back"}))],
    "bulk": lambda pair, ix: [
        _agree(_each(pair, "POST", "/_bulk", raw=_bulk_lines(
            [({"index": {"_index": ix, "_type": "doc", "_id": str(i)}},
              {"body": f"w{i % 3}", "n": i}) for i in range(20)]))),
        _agree(_each(pair, "POST", "/_bulk", raw=_bulk_lines(
            [({"index": {"_index": ix, "_type": "doc", "_id": "2"}}, {"body": "re"}),
             ({"create": {"_index": ix, "_type": "doc", "_id": "40"}}, {"body": "new"}),
             ({"create": {"_index": ix, "_type": "doc", "_id": "3"}}, {"body": "dup"}),
             ({"delete": {"_index": ix, "_type": "doc", "_id": "4"}}, None),
             ({"update": {"_index": ix, "_type": "doc", "_id": "6"}},
              {"doc": {"n": 600}}),
             ({"delete": {"_index": ix, "_type": "doc", "_id": "77"}}, None)])))],
    "update": lambda pair, ix: [
        *[_agree(_each(pair, "PUT", f"/{ix}/doc/{i}", {"body": "u", "n": i}))
          for i in range(6)],
        _agree(_each(pair, "POST", f"/{ix}/doc/1/_update", {"doc": {"body": "merged"}})),
        _agree(_each(pair, "POST", f"/{ix}/doc/2/_update",
                     {"script": "ctx._source.n += 10"})),
        _agree(_each(pair, "POST", f"/{ix}/doc/9/_update",
                     {"doc": {"n": 1}, "upsert": {"body": "upserted", "n": 0}})),
        _agree(_each(pair, "POST", f"/{ix}/doc/3/_update",
                     {"script": "ctx.op = 'delete'"})),
        _agree(_each(pair, "POST", f"/{ix}/doc/42/_update", {"doc": {"n": 1}}))],
    "create": lambda pair, ix: [
        _agree(_each(pair, "PUT", f"/{ix}/doc/1/_create", {"body": "first"})),
        _agree(_each(pair, "PUT", f"/{ix}/doc/1/_create", {"body": "second"})),
        _agree(_each(pair, "PUT", f"/{ix}/doc/2?op_type=create", {"body": "op"}))],
    "delete_by_query": lambda pair, ix: [
        *[_agree(_each(pair, "PUT", f"/{ix}/doc/{i}", {"body": f"w{i % 4}", "tag": f"t{i % 3}"}))
          for i in range(24)],
        _agree(_each(pair, "DELETE", f"/{ix}/doc/_query",
                     {"query": {"term": {"tag": "t1"}}})),
        _agree(_each(pair, "DELETE", f"/{ix}/_query",
                     {"query": {"match": {"body": "w2"}}}))],
}


@pytest.mark.parametrize("family", list(WRITES))
def test_writes_reach_every_copy_as_on_jax(rpair, family):
    index = f"w-{family.replace('_', '-')}"
    _make(rpair, index)
    try:
        WRITES[family](rpair, index)
        held = assert_copies_agree(*rpair, index)
        assert sum(len(d) for d in held.values()) > 0
    finally:
        _each(rpair, "DELETE", f"/{index}")


@pytest.fixture(scope="module")
def served(rpair):
    """`srv` (3 shards, 1 replica) with 90 documents, refreshed."""
    _make(rpair, "srv", shards=3)
    lines = _bulk_lines([({"index": {"_index": "srv", "_type": "doc", "_id": str(i)}},
                          {"body": " ".join(f"w{(i * k) % 13}" for k in range(1, 6)),
                           "n": i, "tag": f"t{i % 4}"}) for i in range(90)])
    _agree(_each(rpair, "POST", "/_bulk", raw=lines))
    _agree(_each(rpair, "POST", "/srv/_refresh"))
    return rpair


ROUTES = ["/_cluster/health", "/_cluster/health/srv",
          "/_cat/shards/srv?v&h=index,shard,prirep,state,docs,ip,node",
          "/_cat/recovery", "/_cat/health?h=status,shards,pri,relo,init,unassign"]


@pytest.mark.parametrize("node", ["a", "b"])
@pytest.mark.parametrize("route", ROUTES)
def test_green_cluster_answers_as_jax(served, route, node):
    p, j = served
    if route.startswith("/_cat"):
        (pst, pt), (jst, jt) = (_text(c.base(node), route) for c in (p, j))
        assert pst == jst == 200 and pt == jt, (pt, jt)
        if route.startswith("/_cat/shards"):
            assert [line.split()[2] for line in pt.splitlines()[1:]].count("r") == 3
    else:
        (pst, pr), (jst, jr) = (call(c.base(node), "GET", route) for c in (p, j))
        assert pst == jst == 200 and pr == jr and pr["status"] == "green", (pr, jr)


SEARCHES = {
    "match": {"query": {"match": {"body": "w1 w2 w3"}}, "size": 15},
    "bool": {"query": {"bool": {"must": [{"term": {"body": "w4"}}],
                                "should": [{"term": {"body": "w5"}}]}}, "size": 20},
    "aggs": {"query": {"match": {"body": "w7"}}, "size": 3,
             "aggs": {"tags": {"terms": {"field": "tag"}}}},
    "count": {"query": {"match": {"body": "w9"}}, "size": 0},
}


@pytest.mark.parametrize("pref", ["_only_node:a", "_only_node:b", "_primary", None])
@pytest.mark.parametrize("name", list(SEARCHES))
def test_each_nodes_copies_answer_as_jax(served, name, pref):
    p, j = served
    path = "/srv/_search" + (f"?preference={pref}" if pref else "")
    (pst, pr), (jst, jr) = (call(c.base("a"), "POST", path, SEARCHES[name])
                            for c in (p, j))
    assert pst == jst == 200, (pr, jr)
    assert pr["_shards"] == jr["_shards"] and pr["_shards"]["failed"] == 0
    assert pr["hits"] == jr["hits"] and pr["hits"]["total"] > 0
    assert pr.get("aggregations") == jr.get("aggregations")


# ------------------------------------------- TestReplicaRecoveryAndFailover


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_peer_recovery_copies_data(tmp_path, threads, pkg):  # noqa: F811
    c = Cluster(pkg, ["n0", "n1"], tmp_path)
    try:
        client = c.nodes[0].client()
        client.create_index("r", {"settings": {"number_of_shards": 1,
                                               "number_of_replicas": 0}})
        client.cluster_health(wait_for_status="green")
        for i in range(10):
            client.index("r", "doc", {"i": i}, id=str(i))
        client.flush("r")
        client.update_settings("r", {"settings": {"number_of_replicas": 1}})
        h = client.cluster_health(wait_for_status="green", timeout=20)
        assert h["status"] == "green", h
        state = c.nodes[0].cluster_service.state
        replica = state.routing_table.index("r").shard(0).replicas()[0]
        rnode = next(n for n in c.nodes if n.node_id == replica.node_id)
        shard = rnode.indices.shard_or_none("r", 0)
        assert shard is not None and shard.engine.doc_stats()["count"] == 10
        assert shard.recovery_info["files"] > 0 and shard.recovery_info["bytes"] > 0
    finally:
        c.close()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_node_loss_promotes_replica_and_recovers(tmp_path, threads, pkg):  # noqa: F811
    c = Cluster(pkg, ["node_0", "node_1", "node_2"], tmp_path, settings=FD)
    try:
        client = c.nodes[0].client()
        client.create_index("ha", {"settings": {"number_of_shards": 1,
                                                "number_of_replicas": 1}})
        client.cluster_health(wait_for_status="green", timeout=20)
        for i in range(12):
            client.index("ha", "doc", {"i": i}, id=str(i), refresh=True)
        state = c.nodes[0].cluster_service.state
        group = state.routing_table.index("ha").shard(0)
        victim_id = group.primary.node_id
        if victim_id == "node_0":  # keep the master alive
            victim_id = group.replicas()[0].node_id
        victim = next(n for n in c.nodes if n.node_id == victim_id)
        c.registry.isolate(victim.local_node.transport_address)
        survivor = next(n for n in c.nodes if n is not victim)
        assert wait_until(lambda: survivor.cluster_service.state.nodes.get(victim_id)
                          is None, timeout=15)
        h = survivor.client().cluster_health(wait_for_status="green", timeout=15)
        assert h["status"] in ("green", "yellow")
        r = survivor.client().search("ha", {"query": {"match_all": {}}, "size": 20})
        assert r["hits"]["total"] == 12 and r["_shards"]["failed"] == 0
        primary = survivor.cluster_service.state.routing_table.index("ha").shard(0).primary
        assert primary.active and primary.node_id != victim_id
    finally:
        c.registry.heal()
        c.close()


# ------------------------------------------------- failover across copies


def _fault_policy(pkg, node, seed):
    if pkg == "port":
        from elasticsearch_tpu_torch.transport.faults import FaultPolicy
    else:
        from elasticsearch_tpu.transport.faults import FaultPolicy
    return FaultPolicy(seed).install(node.transport)


def _retry_policy(pkg):
    if pkg == "port":
        from elasticsearch_tpu_torch.common.retry import RetryPolicy
    else:
        from elasticsearch_tpu.common.retry import RetryPolicy
    return RetryPolicy(max_attempts=2, base_s=0.01, cap_s=0.02, rng=random.Random(0))


@pytest.fixture(scope="module")
def resil(tmp_path_factory, threads):  # noqa: F811
    """Two nodes of each package holding `resil` (2 shards, 1 replica, 40
    documents)."""
    p, j = _both(tmp_path_factory.mktemp("resil"), ["a", "b"])
    try:
        for c in (p, j):
            client = c.nodes[0].client()
            client.create_index("resil", {"settings": {
                "index.number_of_shards": 2, "index.number_of_replicas": 1}})
            assert c.settled("resil")
            for i in range(40):
                client.index("resil", "doc", {"title": f"hello world {i}", "n": i},
                             id=str(i))
            client.refresh("resil")
        yield {"port": p, "jax": j}
    finally:
        p.close()
        j.close()


def _clear(c):
    for n in c.nodes:
        if n.transport.fault_policy is not None:
            n.transport.fault_policy.clear()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_search_fails_over_around_disconnect_faults(resil, pkg):
    """One copy of every group downed: the chain's first candidate is the
    downed copy (`_prefer_node`), and failover keeps the search whole."""
    c = resil[pkg]
    node, other = c.node("a"), c.node("b")
    try:
        rule = _fault_policy(pkg, node, 3).disconnect(
            action=A_QUERY, node=other.local_node.transport_address)
        resp = node.client().search(
            "resil", {"query": {"match": {"title": "hello"}}},
            preference=f"_prefer_node:{other.local_node.id}")
        assert resp["hits"]["total"] == 40
        assert resp["_shards"]["failed"] == 0
        assert resp["_shards"]["successful"] == resp["_shards"]["total"] == 2
        assert resp["timed_out"] is False
        assert rule.hits >= 2, rule.hits
    finally:
        _clear(c)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_search_reports_failure_per_downed_copy(resil, pkg):
    c = resil[pkg]
    node = c.node("a")
    try:
        _fault_policy(pkg, node, 4).disconnect(action=A_QUERY)
        resp = node.client().search("resil", {"query": {"match": {"title": "hello"}}})
        assert resp["hits"]["total"] == 0 and resp["hits"]["hits"] == []
        assert resp["_shards"]["failed"] == resp["_shards"]["total"] == 2
        assert resp["_shards"]["successful"] == 0
        failures = resp["_shards"]["failures"]
        assert len(failures) == 4 and all(f.get("node") for f in failures)
        assert {f["shard"] for f in failures} == {0, 1}
        assert sorted((f["shard"], f["node"]) for f in failures) == \
            [(0, "a"), (0, "b"), (1, "a"), (1, "b")]
    finally:
        _clear(c)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_timeout_against_delayed_shard_returns_partial(resil, pkg):
    c = resil[pkg]
    node = c.node("a")
    body = {"query": {"match": {"title": "hello"}}, "size": 40}
    assert node.client().search("resil", body)["hits"]["total"] == 40  # warm
    try:
        _fault_policy(pkg, node, 5).delay(
            0.6, action=A_QUERY, where=lambda act, addr, req: (req or {}).get("shard") == 0)
        t0 = time.monotonic()
        resp = node.client().search("resil", {**body, "timeout": "150ms"})
        took = time.monotonic() - t0
        assert resp["timed_out"] is True
        assert 0 < resp["hits"]["total"] < 40
        assert len(resp["hits"]["hits"]) == resp["hits"]["total"]
        assert resp["_shards"]["failed"] >= 1
        assert any(f["shard"] == 0 for f in resp["_shards"]["failures"])
        assert took < 6.0
    finally:
        _clear(c)


def test_failover_answers_match_jax(resil):
    """The failed-over search's whole answer is the JAX cluster's, and a
    search with no fault after it too (the chain freed what it pinned)."""
    out = []
    for pkg in ("port", "jax"):
        c = resil[pkg]
        node, other = c.node("a"), c.node("b")
        try:
            _fault_policy(pkg, node, 6).disconnect(
                action=A_QUERY, node=other.local_node.transport_address)
            r1 = node.client().search("resil", {"query": {"match": {"title": "world 7"}},
                                                "size": 10},
                                      preference=f"_prefer_node:{other.local_node.id}")
        finally:
            _clear(c)
        r2 = node.client().search("resil", {"query": {"match": {"title": "world 7"}},
                                            "size": 10})
        out.append([(r["hits"], r["_shards"]) for r in (r1, r2)])
    assert out[0] == out[1]
    assert wait_until(lambda: resil["port"].node("a").actions.pinned_contexts() == 0
                      and resil["port"].node("b").actions.pinned_contexts() == 0)


@pytest.mark.parametrize("fetch", ["freed", "never"])
def test_close_waits_for_pinned_contexts_and_records_it(tmp_path, threads, fetch):  # noqa: F811
    """Port only (ROADMAP, declared differences): a closing node waits up
    to a second for the contexts its query phases pinned, and
    `close_drain` records the contexts pinned, those left and the wait."""
    from elasticsearch_tpu_torch.actions import A_FREE_CONTEXT

    c = Cluster("port", ["a", "b"], tmp_path)
    try:
        client = c.nodes[0].client()
        client.create_index("pin", {"settings": {"number_of_shards": 2,
                                                 "number_of_replicas": 0}})
        assert c.settled("pin")
        for i in range(8):
            client.index("pin", "doc", {"body": f"w{i}"}, id=str(i))
        client.refresh("pin")
        b = c.node("b")
        sid = next(s.shard_id for s in
                   b.cluster_service.state.routing_table.index("pin").all_shards()
                   if s.node_id == b.node_id)
        r = b.transport.send_request(b.local_node, A_QUERY, {
            "index": "pin", "shard": sid, "body": {"query": {"match_all": {}}},
            "alias_filter": None, "dfs": None, "deadline_s": None}).result(30)
        assert r["ctx_id"] is not None and b.actions.pinned_contexts() == 1
        a = c.node("a")
        if fetch == "freed":
            # the fetch comes once the master has removed b: inside b's wait
            def free():
                wait_until(lambda: a.cluster_service.state.nodes.get(b.node_id) is None)
                time.sleep(0.1)
                b.transport.send_request(b.local_node, A_FREE_CONTEXT, {
                    "index": "pin", "shard": sid, "ctx": r["ctx_id"]})

            threading.Thread(target=free, daemon=True).start()
        b.close()
        drain = b.close_drain
        assert drain["contexts"] == 1, drain
        if fetch == "freed":
            assert drain["left"] == 0 and drain["waited_s"] < 1.0, drain
        else:
            assert drain["left"] == 1 and drain["waited_s"] >= 1.0, drain
        a.close()
        assert (a.close_drain["contexts"], a.close_drain["left"]) == (0, 0)
    finally:
        c.close()


# -------------------------------------------- a failed replica is reported


def _primary_node(c, index):
    state = c.nodes[0].cluster_service.state
    primary = state.routing_table.index(index).shard(0).primary
    return primary, next(n for n in c.nodes if n.local_node.id == primary.node_id)


def _replica_routed_out(node, index, primary):
    def check():
        group = node.cluster_service.state.routing_table.index(index).shard(0)
        return all(not (s.active and s.node_id != primary.node_id) for s in group.shards)
    return check


@pytest.mark.parametrize("pkg", ["port", "jax"])
@pytest.mark.parametrize("path", ["bulk", "single"])
def test_dead_replica_is_reported_shard_failed(tmp_path, threads, pkg, path):  # noqa: F811
    c = Cluster(pkg, ["a", "b"], tmp_path)
    try:
        client = c.nodes[0].client()
        client.create_index("wr", {"settings": {"index.number_of_shards": 1,
                                                "index.number_of_replicas": 1}})
        assert c.settled("wr")
        primary, pnode = _primary_node(c, "wr")
        pnode.actions.retry_policy = _retry_policy(pkg)
        _fault_policy(pkg, pnode, 6).disconnect(action="indices:data/write/*[r]")
        if path == "bulk":
            ops = [{"action": {"index": {"_index": "wr", "_type": "doc", "_id": str(i)}},
                    "source": {"n": i}} for i in range(5)]
            assert pnode.client().bulk(ops)["errors"] is False
        else:
            assert pnode.client().index("wr", "doc", {"v": 1}, id="1")["_version"] == 1
        assert wait_until(_replica_routed_out(pnode, "wr", primary), timeout=10), \
            pnode.cluster_service.state.routing_table.index("wr").shard(0)
    finally:
        c.close()


# ---------------------------------------------------------------- TTL purge


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_ttl_purge_runs_on_primaries_only(tmp_path, threads, pkg):  # noqa: F811
    c = Cluster(pkg, ["a", "b"], tmp_path)
    try:
        base = c.base("a")
        assert call(base, "PUT", "/t", {"settings": {
            "number_of_shards": 1, "number_of_replicas": 1, "refresh_interval": -1},
            "mappings": {"doc": {"_ttl": {"enabled": True}}}})[0] == 200
        assert c.settled("t")
        assert call(base, "PUT", "/t/doc/short?ttl=50ms", {"v": 1})[0] == 201
        assert call(base, "PUT", "/t/doc/long", {"v": 2})[0] == 201
        assert call(base, "POST", "/t/_refresh")[0] == 200
        time.sleep(0.2)
        for n in c.nodes:
            n._purge_expired()
        held = {n.name: sorted(docs) for (_sid, n_name), docs in copies(c, "t").items()
                for n in c.nodes if n.name == n_name}
        primary, pnode = _primary_node(c, "t")
        rnode = next(n for n in c.nodes if n is not pnode)
        assert held[pnode.name] == ["long"]
        assert held[rnode.name] == ["long", "short"]
    finally:
        c.close()
