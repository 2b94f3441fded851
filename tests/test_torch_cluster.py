"""The port's cluster layer (elasticsearch_tpu_torch/cluster/, discovery,
gateway, the master-node actions) against the JAX package's.

- `djb2_hash` and `OperationRouting.shard_id` place 10,000 ids and routings
  (ASCII, digits, unicode) on the JAX package's shard for 1-7 shards: a
  document lands on the same shard of both nodes. Tolerance: none.
- `new_index_routing` and a one-node `reroute` build the same routing
  tables, step by step as the throttling decider lets two primaries
  initialize at a time (replicas stay unassigned: health yellow).
- A created index's metadata — settings, and mappings after dynamic mapping
  through the index API — equals the JAX node's, as does cluster health.
- What the one-node slice refused is served: a node on the tcp transport,
  a node started with another node's address, and a gateway that waits
  for two nodes each form the JAX cluster's two-node state (master, node
  count, health, primaries spread over both); a restart over the same
  `path.data` starts (tests/test_torch_gateway.py holds what it recovers);
  the state's blocks lift only once a master is elected and the state
  recovered."""

import numpy as np
import pytest

from elasticsearch_tpu_torch.cluster.allocation import AllocationService, new_index_routing
from elasticsearch_tpu_torch.cluster.routing import OperationRouting, djb2_hash
from elasticsearch_tpu_torch.cluster.state import (
    BLOCK_NO_MASTER, BLOCK_STATE_NOT_RECOVERED, ClusterState, DiscoveryNode,
    DiscoveryNodes, IndexMetaData)
from elasticsearch_tpu_torch.common.errors import ClusterBlockError
from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg


def _keys(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_#/") \
        + ["é", "ß", "中", "文", "😀", "ÿ"]
    out = [str(i) for i in range(n // 4)]
    for _ in range(n - len(out)):
        out.append("".join(rng.choice(alphabet, int(rng.integers(1, 24)))))
    return out


def test_djb2_matches_jax_on_10000_keys():
    from elasticsearch_tpu.cluster.routing import djb2_hash as jdjb2

    keys = _keys(10_000, 1)
    assert [djb2_hash(k) for k in keys] == [jdjb2(k) for k in keys]


def _states(num_shards: int):
    """A port and a JAX cluster state holding one index of `num_shards`."""
    from elasticsearch_tpu.cluster.state import ClusterState as JState
    from elasticsearch_tpu.cluster.state import IndexMetaData as JMeta

    settings = (("index.number_of_replicas", 1), ("index.number_of_shards", num_shards))
    t = ClusterState()
    t = t.next_version(metadata=t.metadata.with_index(IndexMetaData("i", settings)))
    j = JState()
    j = j.next_version(metadata=j.metadata.with_index(JMeta("i", settings)))
    return t, j


@pytest.mark.parametrize("num_shards", [1, 2, 3, 5, 7])
def test_shard_id_matches_jax_for_ids_and_routings(num_shards):
    from elasticsearch_tpu.cluster.routing import OperationRouting as JRouting

    t, j = _states(num_shards)
    keys = _keys(10_000, num_shards)
    routings = [None if i % 3 else k[::-1] for i, k in enumerate(keys)]
    port = [OperationRouting.shard_id(t, "i", k, r) for k, r in zip(keys, routings)]
    assert port == [JRouting.shard_id(j, "i", k, r) for k, r in zip(keys, routings)]
    assert set(port) == set(range(num_shards))


def _table(table) -> list:
    return [[(s.index, s.shard_id, s.node_id, s.primary, s.state) for s in grp.shards]
            for grp in table.shards]


@pytest.mark.parametrize("shards,replicas", [(1, 0), (3, 1), (5, 1), (2, 3)])
def test_index_routing_and_one_node_reroute_match_jax(shards, replicas):
    from elasticsearch_tpu.cluster.allocation import AllocationService as JAlloc
    from elasticsearch_tpu.cluster.allocation import new_index_routing as jroute
    from elasticsearch_tpu.cluster.state import ClusterState as JState
    from elasticsearch_tpu.cluster.state import DiscoveryNode as JNodeInfo
    from elasticsearch_tpu.cluster.state import DiscoveryNodes as JNodes

    tt, jt = new_index_routing("i", shards, replicas), jroute("i", shards, replicas)
    assert _table(tt) == _table(jt)
    t = ClusterState(nodes=DiscoveryNodes(
        (DiscoveryNode("n1", "n1", "local://n1"),), "n1", "n1"))
    t = t.next_version(routing_table=t.routing_table.with_index(tt))
    j = JState(nodes=JNodes((JNodeInfo("n1", "n1", "local://n1"),), "n1", "n1"))
    j = j.next_version(routing_table=j.routing_table.with_index(jt))
    ta, ja = AllocationService(), JAlloc()
    t, j = ta.reroute(t), ja.reroute(j)
    # the throttling decider lets two primaries initialize at a time;
    # replicas stay unassigned
    assert _table(t.routing_table.index("i")) == _table(j.routing_table.index("i"))
    assert [s.state for s in t.routing_table.all_shards() if s.primary] == \
        ["INITIALIZING"] * min(shards, 2) + ["UNASSIGNED"] * max(shards - 2, 0)
    # start what initialized until nothing moves: both end on the same table
    for _ in range(shards + 1):
        tinit = [s for s in t.routing_table.all_shards() if s.state == "INITIALIZING"]
        jinit = [s for s in j.routing_table.all_shards() if s.state == "INITIALIZING"]
        t, j = ta.apply_started_shards(t, tinit), ja.apply_started_shards(j, jinit)
    assert _table(t.routing_table.index("i")) == _table(j.routing_table.index("i"))
    states = [s.state for s in t.routing_table.all_shards()]
    assert states.count("STARTED") == shards
    assert states.count("UNASSIGNED") == shards * replicas


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu.transport.local import LocalTransportRegistry as JReg

    p = PNode(name="pc", settings={"node.device": "cpu"}, registry=PReg(),
              data_path=str(tmp_path_factory.mktemp("port_node"))).start()
    j = JNode(name="jc", settings={"search.mesh.enabled": "false",
                                   "indices.warmer.enabled": "false"},
              registry=JReg(), data_path=str(tmp_path_factory.mktemp("jax_node")))
    try:
        j.start([j.local_node.transport_address])
        j.wait_for_master()
        yield p, j
    finally:
        p.close()
        j.close()


DOCS = [("1", "doc", {"title": "a b", "body": "x y z", "n": 3, "f": 1.5,
                      "ok": True, "day": "2020-01-02", "o": {"k": "v", "z": 2}}),
        ("2", "doc", {"tags": ["p", "q"], "o": {"k2": 1}, "none": None}),
        ("3", "other", {"zz": "t", "when": "2021-03-04T05:06:07Z"})]


@pytest.mark.parametrize("body", [
    {},
    {"settings": {"number_of_shards": 2, "number_of_replicas": 0,
                  "refresh_interval": -1}},
    {"settings": {"index": {"number_of_shards": 3,
                            "similarity": {"default": {"type": "BM25", "b": 0.5}}}},
     "mappings": {"doc": {"properties": {"title": {"type": "string",
                                                   "index": "not_analyzed"}}}}},
])
def test_created_index_metadata_matches_jax(nodes, body):
    p, j = nodes
    name = f"meta{len(p.cluster_service.state.metadata.index_names())}"
    for n in (p, j):
        c = n.client()
        assert c.create_index(name, body)["acknowledged"]
        for doc_id, doc_type, src in DOCS:
            r = c.index(name, doc_type, src, id=doc_id)
            assert r["created"] and r["_version"] == 1
    pm = p.cluster_service.state.metadata.index(name)
    jm = j.cluster_service.state.metadata.index(name)
    assert pm.settings_map == jm.settings_map
    assert pm.mappings_dict() == jm.mappings_dict()
    assert set(pm.mappings_dict()["doc"]["properties"]) >= {"body", "n", "o", "day"}
    ph = p.client().cluster_health(name)
    jh = j.client().cluster_health(name)
    assert ph == jh
    assert ph["status"] == ("green" if "number_of_replicas" in str(body) else "yellow")


def test_blocks_lift_once_a_master_is_elected_and_recovered(tmp_path):
    node = PNode(name="t2", settings={"node.device": "cpu"}, registry=PReg(),
                 data_path=str(tmp_path / "b"))
    try:
        # before start: no master, state not recovered — reads answer 503
        with pytest.raises(ClusterBlockError) as err:
            node.cluster_service.state.blocks.check("read")
        assert err.value.status == 503
        assert set(node.cluster_service.state.blocks.global_blocks) == {
            BLOCK_NO_MASTER, BLOCK_STATE_NOT_RECOVERED}
        node.start([node.local_node.transport_address])
        assert node.cluster_service.state.blocks.global_blocks == ()
        assert node.cluster_service.state.nodes.master_id == "t2"
    finally:
        node.close()
    node = PNode(name="t3", settings={"node.device": "cpu"}, registry=PReg(),
                 data_path=str(tmp_path / "b"))
    try:
        node.start()
        assert node.cluster_service.state.blocks.global_blocks == ()
    finally:
        node.close()


# what the one-node slice refused: the tcp transport (a unicast seed), a
# node started with another node's address, a gateway waiting for 2 nodes
LIFTED = {"tcp": ({}, "tcp"), "seeds": ({}, "local"),
          "recover_after_nodes": ({"gateway.recover_after_nodes": 2}, "local")}


@pytest.mark.parametrize("case", list(LIFTED))
def test_lifted_path_forms_the_jax_two_node_cluster(tmp_path, case):
    from tests.test_torch_node import call
    from tests.test_torch_two_nodes import _both, _placement

    settings, transport = LIFTED[case]
    p, j = _both(tmp_path, ["a", "b"], settings=settings, transport=transport)
    try:
        for c in (p, j):
            st, r = call(c.base("b"), "PUT", "/two", {"settings": {
                "number_of_shards": 2, "number_of_replicas": 0}})
            assert st == 200 and r["acknowledged"], r
            assert c.settled("two")
        (_, ph), (_, jh) = (call(c.base("a"), "GET", "/_cluster/health/two") for c in (p, j))
        assert ph == jh and ph["number_of_nodes"] == 2 and ph["status"] == "green"
        assert [s.nodes.master_id for s in p.states()] == \
            [s.nodes.master_id for s in j.states()] == ["a", "a"]
        placed = _placement(p.states()[1], "two")
        assert placed == _placement(j.states()[1], "two")
        assert sorted(row[0][0] for row in placed) == ["a", "b"]
    finally:
        p.close()
        j.close()
