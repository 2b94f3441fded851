"""Two and three port nodes form one cluster, held against as many JAX
nodes given the same requests (zen discovery, the decider chain, master
forwarding, the multi-node surfaces).

Each cluster runs on its own in-process transport registry (the TCP
transport is tests/test_torch_multinode_tcp.py's), each node with its
own `path.data` and HTTP port; the JAX nodes run with their SPMD mesh and
warmer off, the port nodes with their warmer off, on the CPU. Node names
are the same in both clusters, so node ids, routing tables and `_cat`
rows compare as they are. Every wait is on state, with a generous
deadline (no fixed sleep), and every node is closed in a fixture or a
`finally`.

- Formation: both clusters elect the same master (the lowest id), every
  node of a cluster holds the master's state version, and a 4-shard
  index at 0 replicas places each primary on the JAX cluster's node.
- A create index and a mapping sent to a node that is not master are
  forwarded to the master and published to every node.
- `_search`, `_count`, DFS, aggregations and `_msearch`, sent to each
  node, answer the JAX cluster's hits JSON (ids and scores bitwise: every
  body rides the sparse path or the host collectors on both).
- The multi-node surfaces: `_cluster/stats` rolls up both nodes (versions
  included), `/_nodes` and `_cat/nodes` name both, `/_events` pulls the
  other node's journal, and `_shutdown` of a remote node closes it.
- Departures on 3 nodes: a graceful leave and a fault-detected loss (the
  node isolated on the registry) leave the JAX cluster's routing and
  health; a departed node's primaries come back empty on the nodes that
  remain (0 replicas: the JAX master's behaviour, kept on both).
- Quorum: under `minimum_master_nodes: 2`, a master left alone steps down
  and installs the no-master block, as the JAX master does.
- `gateway.recover_after_nodes: 2` recovers once the second node joins.
- A replica starts on the node without its primary by peer recovery and
  the cluster turns green, as the JAX cluster does. A `_cluster/reroute`
  `allocate_replica` of a replica held back by
  `cluster.routing.allocation.enable: primaries` is applied as given on
  both packages: the copy recovers, the cluster turns green, and the
  searches sent to either node, each node's own copies alone included,
  answer the JAX cluster's hits."""

import json
import time

import pytest
import torch

from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg
from tests.test_torch_node import call

BASE = {"port": {"node.device": "cpu", "indices.warmer.enabled": "false"},
        "jax": {"search.mesh.enabled": "false", "indices.warmer.enabled": "false"}}
# fault detection fast enough for a test, the same on both packages
FD = {"discovery.zen.fd.ping_interval": "0.1s", "discovery.zen.fd.ping_timeout": "0.5s",
      "discovery.zen.fd.ping_retries": 3}


def wait_until(fn, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return fn()


class Cluster:
    """`names` nodes of one package on one registry (or over TCP), started
    as the JAX package's tests start them, each serving HTTP."""

    def __init__(self, pkg, names, tmp, settings=None, transport="local"):
        if pkg == "port":
            node_cls, reg = PNode, PReg()
        else:
            from elasticsearch_tpu.node import Node as node_cls
            from elasticsearch_tpu.transport.local import LocalTransportRegistry

            reg = LocalTransportRegistry()
        self.pkg, self.registry, self.nodes, self.bases = pkg, reg, [], []
        conf = {**BASE[pkg], **(settings or {})}
        if transport == "tcp":
            conf["transport.type"] = "tcp"
        try:
            for name in names:
                self.nodes.append(node_cls(name=name, settings=dict(conf), registry=reg,
                                           data_path=str(tmp / f"{pkg}_{name}")))
            if transport == "tcp":
                seed = self.nodes[0].local_node.transport_address
                self.nodes[0].start(seeds=[])
                for n in self.nodes[1:]:
                    n.start(seeds=[seed])
            else:
                addresses = [n.local_node.transport_address for n in self.nodes]
                for n in self.nodes:
                    n.start(addresses)
            assert wait_until(lambda: all(
                n.cluster_service.state.nodes.size == len(names)
                and n.cluster_service.state.nodes.master_id is not None
                for n in self.nodes)), self.states()
            self.bases = [f"http://127.0.0.1:{n.start_http(0).port}" for n in self.nodes]
        except BaseException:
            self.close()
            raise

    def states(self):
        return [n.cluster_service.state for n in self.nodes]

    def node(self, name):
        return next(n for n in self.nodes if n.name == name)

    def base(self, name):
        return self.bases[[n.name for n in self.nodes].index(name)]

    def settled(self, index=None, status="green"):
        """Every node of the cluster on the master's version, the health
        at `status`."""
        def ok():
            live = [n for n in self.nodes if not n._closed]
            versions = {n.cluster_service.state.version for n in live}
            h = live[0].client().cluster_health(index, timeout=0)
            return len(versions) == 1 and h["status"] == status and \
                h["initializing_shards"] == 0
        return wait_until(ok)

    def close(self):
        for n in self.nodes:
            try:
                n.close()
            except Exception:  # noqa: BLE001 — a test may have closed it already
                pass


@pytest.fixture(scope="module")
def threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _both(tmp_path, names, **kw):
    p = Cluster("port", names, tmp_path, **kw)
    try:
        j = Cluster("jax", names, tmp_path, **kw)
    except BaseException:
        p.close()
        raise
    return p, j


def _placement(state, index):
    return [[(s.node_id, s.primary, s.state) for s in grp.shards]
            for grp in state.routing_table.index(index).shards]


WORDS = [f"w{i}" for i in range(24)]


def _bulk(n_docs=120, seed=3):
    import numpy as np

    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_docs):
        ops += [{"index": {"_index": "docs", "_type": "doc", "_id": str(i)}},
                {"body": " ".join(rng.choice(WORDS, int(rng.integers(2, 12)))),
                 "n": i, "tag": f"t{i % 5}"}]
    return "\n".join(json.dumps(o) for o in ops) + "\n"


@pytest.fixture(scope="module")
def pair(tmp_path_factory, threads):
    """A 2-node port cluster and a 2-node JAX cluster holding `docs` (4
    shards, 0 replicas, the same bulk sent to node b)."""
    p, j = _both(tmp_path_factory.mktemp("pair"), ["a", "b"])
    try:
        for c in (p, j):
            st, r = call(c.base("b"), "PUT", "/docs", {"settings": {
                "number_of_shards": 4, "number_of_replicas": 0, "refresh_interval": -1}})
            assert st == 200 and r["acknowledged"], r
            assert c.settled("docs")
            st, r = call(c.base("b"), "POST", "/_bulk", raw=_bulk())
            assert st == 200 and not r["errors"]
            assert call(c.base("a"), "POST", "/docs/_refresh")[0] == 200
        yield p, j
    finally:
        p.close()
        j.close()


def test_same_master_state_version_and_placement(pair):
    p, j = pair
    for c in (p, j):
        states = c.states()
        assert {s.nodes.master_id for s in states} == {"a"}
        assert len({s.version for s in states}) == 1
        assert all(s.nodes.size == 2 for s in states)
    assert _placement(p.states()[0], "docs") == _placement(j.states()[0], "docs")
    assert sorted(s.node_id for s in p.states()[1].routing_table.index("docs")
                  .all_shards()) == ["a", "a", "b", "b"]


def test_create_index_and_mapping_on_a_node_that_is_not_master(pair):
    p, j = pair
    mapping = {"properties": {"title": {"type": "string"}, "when": {"type": "date"}}}
    for c in (p, j):
        assert not c.node("b").is_master()
        st, r = call(c.base("b"), "PUT", "/fwd", {"settings": {
            "number_of_shards": 2, "number_of_replicas": 0}})
        assert st == 200 and r["acknowledged"], r
        st, r = call(c.base("b"), "PUT", "/fwd/_mapping/item", mapping)
        assert st == 200 and r["acknowledged"], r
        assert wait_until(lambda: all(
            s.metadata.has_index("fwd") and "item" in s.metadata.index("fwd").mappings_dict()
            for s in c.states()))
        assert c.settled("fwd")
    pm = p.states()[1].metadata.index("fwd")
    jm = j.states()[1].metadata.index("fwd")
    assert pm.settings_map == jm.settings_map
    assert pm.mappings_dict() == jm.mappings_dict()
    assert _placement(p.states()[0], "fwd") == _placement(j.states()[0], "fwd")


SEARCHES = {
    "match": ("/docs/_search", {"query": {"match": {"body": "w1 w2 w3"}}, "size": 15}),
    "bool": ("/docs/_search", {"query": {"bool": {
        "must": [{"term": {"body": "w4"}}], "should": [{"term": {"body": "w5"}},
                                                       {"term": {"body": "w6"}}]}},
        "size": 20}),
    "paged": ("/docs/_search", {"query": {"match": {"body": "w7 w8"}}, "from": 5,
                                "size": 7}),
    "count": ("/docs/_count", {"query": {"match": {"body": "w9"}}}),
    "dfs": ("/docs/_search?search_type=dfs_query_then_fetch",
            {"query": {"match": {"body": "w10 w11"}}, "size": 12}),
    "aggs": ("/docs/_search", {"query": {"match": {"body": "w12"}}, "size": 3,
                               "aggs": {"tags": {"terms": {"field": "tag"}},
                                        "n": {"stats": {"field": "n"}}}}),
    "sort": ("/docs/_search", {"query": {"match": {"body": "w13"}},
                               "sort": [{"n": "desc"}], "size": 8}),
}


@pytest.mark.parametrize("node", ["a", "b"])
@pytest.mark.parametrize("name", list(SEARCHES))
def test_searches_sent_to_each_node_answer_the_jax_cluster(pair, name, node):
    p, j = pair
    path, body = SEARCHES[name]
    (pst, pr), (jst, jr) = (call(c.base(node), "POST", path, body) for c in (p, j))
    assert pst == jst == 200, (pr, jr)
    assert pr["_shards"] == jr["_shards"] and pr["_shards"]["successful"] == 4
    if name == "count":
        assert pr["count"] == jr["count"] > 0
        return
    assert pr["hits"] == jr["hits"] and pr["hits"]["total"] > 0
    if name == "aggs":
        assert pr["aggregations"] == jr["aggregations"]


@pytest.mark.parametrize("node", ["a", "b"])
def test_msearch_sent_to_each_node_answers_the_jax_cluster(pair, node):
    p, j = pair
    lines = []
    for name in ("match", "bool", "paged"):
        lines += [json.dumps({"index": "docs"}), json.dumps(SEARCHES[name][1])]
    lines += [json.dumps({"index": "missing"}), json.dumps({"query": {"match_all": {}}})]
    raw = "\n".join(lines) + "\n"
    (pst, pr), (jst, jr) = (call(c.base(node), "POST", "/_msearch", raw=raw)
                            for c in (p, j))
    assert pst == jst == 200
    assert len(pr["responses"]) == len(jr["responses"]) == 4
    for a, b in zip(pr["responses"], jr["responses"]):
        if "error" in b:
            assert a["status"] == b["status"]
        else:
            assert (a["hits"], a["_shards"]) == (b["hits"], b["_shards"])


def test_cluster_stats_nodes_and_cat_nodes_name_both(pair):
    p, j = pair
    for node in ("a", "b"):
        (_, ps), (_, js) = (call(c.base(node), "GET", "/_cluster/stats") for c in (p, j))
        assert ps["nodes"] == js["nodes"]
        assert ps["nodes"]["count"]["total"] == 2 and ps["nodes"]["versions"] == ["10000"]
        assert ps["indices"]["docs"] == js["indices"]["docs"]
        assert ps["indices"]["docs"]["count"] >= 120
        (_, pn), (_, jn) = (call(c.base(node), "GET", "/_nodes") for c in (p, j))
        assert sorted(pn["nodes"]) == sorted(jn["nodes"]) == ["a", "b"]
        for nid in ("a", "b"):
            assert {k: v for k, v in pn["nodes"][nid].items() if k != "plugins"} == \
                {k: v for k, v in jn["nodes"][nid].items() if k != "plugins"}
        (pst, pc), (jst, jc) = (call_text(c.base(node), "/_cat/nodes") for c in (p, j))
        assert pst == jst == 200 and pc == jc
        assert {line.split()[0] for line in pc.strip().splitlines()} == {"a", "b"}


def call_text(base, path):
    import urllib.request

    with urllib.request.urlopen(base + path, timeout=30) as resp:
        return resp.status, resp.read().decode()


def test_events_pull_reads_the_other_node(pair):
    p, j = pair
    for c in (p, j):
        c.node("b").events.publish("watchdog", "from b", key=f"pull-{c.pkg}")
        (st, r), = [call(c.base("a"), "GET", "/_events")]
        assert st == 200 and sorted(r["nodes"]) == ["a", "b"]
        assert [e["message"] for e in r["events"] if e.get("node") == "b"].count("from b") == 1
        (st, local), = [call(c.base("a"), "GET", "/_events?local=true")]
        assert "from b" not in [e["message"] for e in local["events"]]


def test_replica_stays_unassigned_on_a_port_cluster(pair):
    """The name is the one the test had while a port cluster kept its
    replicas unassigned. Since replicas and recovery, a 1-replica index
    places each replica on the node without its primary, the replica
    peer-recovers and starts, and the cluster is green: the routing table
    and the health body are the JAX cluster's."""
    p, j = pair
    for c in (p, j):
        st, r = call(c.base("a"), "PUT", "/rep", {"settings": {
            "number_of_shards": 2, "number_of_replicas": 1}})
        assert st == 200 and r["acknowledged"]
        assert c.settled("rep", status="green")
    rows = p.states()[0].routing_table.index("rep").all_shards()
    assert sorted((s.primary, s.state) for s in rows) == \
        [(False, "STARTED")] * 2 + [(True, "STARTED")] * 2
    for grp in p.states()[0].routing_table.index("rep").shards:
        assert sorted(s.node_id for s in grp.shards) == ["a", "b"]
    assert _placement(p.states()[0], "rep") == _placement(j.states()[0], "rep")
    (_, ph), (_, jh) = (call(c.base("b"), "GET", "/_cluster/health/rep") for c in (p, j))
    assert ph == jh and ph["status"] == "green" and ph["unassigned_shards"] == 0, (ph, jh)
    for c in (p, j):
        assert call(c.base("a"), "DELETE", "/rep")[0] == 200


def test_reroute_of_a_replica_is_refused_and_searches_answer_as_jax(pair):
    """The name is the one the test had while a port node refused the
    command. With `cluster.routing.allocation.enable: primaries` each
    replica stays unassigned (yellow, on both packages); `allocate_replica`
    to the node without the primary, sent to either node (from b it is
    forwarded to the master), is applied as on the JAX node: the copy
    peer-recovers the bulked documents and starts, the cluster turns
    green, and every search sent to either node, with no preference and
    with each node's own copies only, answers the JAX cluster's hits."""
    p, j = pair
    raw = _bulk().replace('"_index": "docs"', '"_index": "rrep"')
    hold = {"transient": {"cluster.routing.allocation.enable": "primaries"}}
    try:
        for c in (p, j):
            assert call(c.base("a"), "PUT", "/_cluster/settings", hold)[0] == 200
            st, r = call(c.base("a"), "PUT", "/rrep", {"settings": {
                "number_of_shards": 2, "number_of_replicas": 1, "refresh_interval": -1}})
            assert st == 200 and r["acknowledged"], r
            assert c.settled("rrep", status="yellow")
            st, r = call(c.base("b"), "POST", "/_bulk", raw=raw)
            assert st == 200 and not r["errors"]
            assert call(c.base("a"), "POST", "/rrep/_refresh")[0] == 200
        primaries = {s.shard_id: s.node_id for s in
                     p.node("a").cluster_service.state.routing_table.index("rrep")
                     .all_shards() if s.primary}
        assert sorted(primaries.values()) == ["a", "b"], primaries
        assert primaries == {s.shard_id: s.node_id for s in
                             j.node("a").cluster_service.state.routing_table
                             .index("rrep").all_shards() if s.primary}
        for sid, holder in primaries.items():
            other = "b" if holder == "a" else "a"
            cmd = {"allocate_replica": {"index": "rrep", "shard": sid, "node": other}}
            for c in (p, j):
                # shard 0 from the master, shard 1 forwarded from b
                st, r = call(c.base("ab"[sid]), "POST", "/_cluster/reroute",
                             {"commands": [cmd]})
                assert st == 200 and r["acknowledged"], r
        for c in (p, j):
            assert c.settled("rrep", status="green"), c.states()
        assert _placement(p.states()[1], "rrep") == _placement(j.states()[1], "rrep")
        (_, ph), (_, jh) = (call(c.base("b"), "GET", "/_cluster/health/rrep")
                            for c in (p, j))
        assert ph == jh and ph["status"] == "green", (ph, jh)
        for node in ("a", "b"):
            for pref in ("", "?preference=_only_node:a", "?preference=_only_node:b"):
                for name in ("match", "bool", "paged", "count", "dfs"):
                    path, body = SEARCHES[name]
                    path = path.replace("/docs/", "/rrep/")
                    path += pref if "?" not in path else pref.replace("?", "&")
                    (pst, pr), (jst, jr) = (call(c.base(node), "POST", path, body)
                                            for c in (p, j))
                    assert pst == jst == 200, (pr, jr)
                    assert pr["_shards"] == jr["_shards"], (name, pr["_shards"])
                    if name == "count":
                        assert pr["count"] == jr["count"] > 0
                    else:
                        assert pr["hits"] == jr["hits"] and pr["hits"]["total"] > 0, \
                            (node, pref, name)
    finally:
        for c in (p, j):
            call(c.base("a"), "PUT", "/_cluster/settings", {
                "transient": {"cluster.routing.allocation.enable": "all"}})
            call(c.base("a"), "DELETE", "/rrep")


@pytest.fixture()
def trio(tmp_path, threads):
    p, j = _both(tmp_path, ["a", "b", "c"], settings=FD)
    try:
        for c in (p, j):
            st, r = call(c.base("a"), "PUT", "/docs", {"settings": {
                "number_of_shards": 6, "number_of_replicas": 0, "refresh_interval": -1}})
            assert st == 200, r
            assert c.settled("docs")
            assert call(c.base("a"), "POST", "/_bulk", raw=_bulk(90))[0] == 200
            assert call(c.base("a"), "POST", "/docs/_refresh")[0] == 200
        yield p, j
    finally:
        p.close()
        j.close()


def _count(c, node):
    st, r = call(c.base(node), "POST", "/docs/_count", {"query": {"match_all": {}}})
    assert st == 200, r
    return r["count"]


def test_graceful_leave_then_fault_detected_loss(trio):
    p, j = trio
    assert _placement(p.states()[0], "docs") == _placement(j.states()[0], "docs")
    before = [_count(c, "a") for c in (p, j)]
    assert before[0] == before[1] == 90
    for c in (p, j):
        c.node("c").close()
        assert wait_until(lambda: all(s.nodes.size == 2 for s in c.states()[:2]))
        assert c.settled("docs")
    assert _placement(p.states()[0], "docs") == _placement(j.states()[0], "docs")
    after_leave = [_count(c, "b") for c in (p, j)]
    # the departed node's primaries came back empty on a and b
    assert after_leave[0] == after_leave[1] < 90
    for c in (p, j):
        c.registry.isolate(c.node("b").local_node.transport_address)
        assert wait_until(lambda: c.node("a").cluster_service.state.nodes.size == 1)
        assert wait_until(lambda: c.node("a").client().cluster_health(
            "docs", timeout=0)["status"] == "green")
    (_, ph), (_, jh) = (call(c.base("a"), "GET", "/_cluster/health") for c in (p, j))
    assert ph == jh and ph["number_of_nodes"] == 1
    assert _placement(p.node("a").cluster_service.state, "docs") == \
        _placement(j.node("a").cluster_service.state, "docs")
    assert _count(p, "a") == _count(j, "a")


def test_quorum_lost_steps_the_master_down(tmp_path, threads):
    p, j = _both(tmp_path, ["a", "b"], settings={**FD, "discovery.zen.minimum_master_nodes": 2})
    try:
        for c in (p, j):
            assert c.node("a").is_master()
            c.node("b").close()
            assert wait_until(lambda: c.node("a").cluster_service.state.nodes.master_id
                              is None)
        ps, js = p.node("a").cluster_service.state, j.node("a").cluster_service.state
        assert ps.blocks.global_blocks == js.blocks.global_blocks == (("no_master", "all"),)
        (pst, pr), (jst, jr) = (call(c.base("a"), "GET", "/_cluster/health") for c in (p, j))
        assert pst == jst and pr["number_of_nodes"] == jr["number_of_nodes"]
    finally:
        p.close()
        j.close()


def test_recover_after_nodes_two(tmp_path, threads):
    p, j = _both(tmp_path, ["a", "b"], settings={"gateway.recover_after_nodes": 2})
    try:
        for c in (p, j):
            st, r = call(c.base("b"), "PUT", "/late", {"settings": {
                "number_of_shards": 2, "number_of_replicas": 0}})
            assert st == 200 and r["acknowledged"], r
            assert c.settled("late")
            assert call(c.base("a"), "PUT", "/late/doc/1?refresh=true", {"x": "y"})[0] in (200, 201)
        (_, pr), (_, jr) = (call(c.base("b"), "GET", "/late/_search") for c in (p, j))
        assert pr["hits"] == jr["hits"] and pr["hits"]["total"] == 1
        assert p.node("a").cluster_service.state.blocks.global_blocks == ()
    finally:
        p.close()
        j.close()


def test_gateway_holds_its_block_until_the_second_node_joins(tmp_path, threads):
    """The port's master holds the not-recovered block alone and lifts it
    when the second node completes `recover_after_nodes` (the JAX master
    checks only at its start: ROADMAP, declared differences)."""
    conf = {**BASE["port"], "gateway.recover_after_nodes": 2}
    reg = PReg()
    a = PNode(name="a", settings=conf, registry=reg, data_path=str(tmp_path / "a"))
    b = None
    try:
        a.start([a.local_node.transport_address])
        assert a.is_master()
        assert ("state_not_recovered", "all") in a.cluster_service.state.blocks.global_blocks
        b = PNode(name="b", settings=conf, registry=reg, data_path=str(tmp_path / "b"))
        b.start([a.local_node.transport_address])
        assert wait_until(lambda: all(n.cluster_service.state.blocks.global_blocks == ()
                                      for n in (a, b)))
    finally:
        for n in (b, a):
            if n is not None:
                n.close()


def test_shutdown_of_a_remote_node(tmp_path, threads):
    p, j = _both(tmp_path, ["a", "b"], settings=FD)
    try:
        for c in (p, j):
            st, r = call(c.base("a"), "POST", "/_cluster/nodes/b/_shutdown")
            assert st == 200 and list(r["nodes"]) == ["b"], r
            assert wait_until(lambda: c.node("b")._closed)
            assert wait_until(lambda: c.node("a").cluster_service.state.nodes.size == 1)
    finally:
        p.close()
        j.close()
