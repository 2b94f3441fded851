"""Live rebalancing, cluster stats and the node shutdown action on a cluster
of port nodes, on the CPU: the four invariants of
tests/test_rebalance_e2e.py.

- A node that joins a green two-node cluster (3 shards, 1 replica, 40
  documents) takes shards by relocation through peer recovery; the
  cluster turns green again and a search still counts 40.
- While those relocations run, the index's health never reads below green.
- `_cluster/stats` rolls both nodes up: 1 index, 4 shards, 2 primaries,
  25 documents (the primaries'), 2 master-and-data nodes.
- A shutdown the master sends to another of three nodes closes it; the
  cluster keeps 2 nodes and turns green again (the replicas re-spread).

The clusters are tests/test_torch_two_nodes.py's `Cluster` (one in-process
registry); every node is closed in a `finally`."""

from __future__ import annotations

import time

from elasticsearch_tpu_torch.node import Node as PNode
from tests.test_torch_two_nodes import BASE, Cluster, wait_until


def _add_node(cluster: Cluster, name: str, tmp_path) -> PNode:
    """Start one more port node on the cluster's registry; it joins the
    running master."""
    node = PNode(name=name, settings=dict(BASE["port"]), registry=cluster.registry,
                 data_path=str(tmp_path / f"port_{name}"))
    cluster.nodes.append(node)
    node.start([n.local_node.transport_address for n in cluster.nodes])
    assert wait_until(lambda: all(n.cluster_service.state.nodes.size == len(cluster.nodes)
                                  for n in cluster.nodes))
    return node


def _green(client, index, timeout=30.0):
    h = client.cluster_health(index, wait_for_status="green", timeout=timeout)
    assert h["status"] == "green", h
    return h


def test_node_join_triggers_relocation_to_balance(tmp_path):
    cluster = Cluster("port", ["a", "b"], tmp_path)
    try:
        client = cluster.nodes[0].client()
        client.create_index("reb", {"settings": {"number_of_shards": 3,
                                                 "number_of_replicas": 1}})
        _green(client, "reb")
        for i in range(40):
            client.index("reb", "doc", {"n": i}, id=str(i))
        client.refresh("reb")
        n3 = _add_node(cluster, "c", tmp_path)
        moved = 0
        deadline = time.time() + 30
        while time.time() < deadline:
            shards = n3.cluster_service.state.routing_table.all_shards()
            on_n3 = [s for s in shards if s.node_id == n3.local_node.id
                     and s.state == "STARTED"]
            if on_n3 and not [s for s in shards if s.state == "RELOCATING"]:
                moved = len(on_n3)
                break
            time.sleep(0.2)
        assert moved >= 1, "no shard relocated to the new node"
        _green(client, "reb")
        r = client.search("reb", {"query": {"match_all": {}}, "size": 0})
        assert r["hits"]["total"] == 40
    finally:
        cluster.close()


def test_health_stays_green_during_relocation(tmp_path):
    cluster = Cluster("port", ["a", "b"], tmp_path)
    try:
        client = cluster.nodes[0].client()
        client.create_index("grn", {"settings": {"number_of_shards": 3,
                                                 "number_of_replicas": 1}})
        _green(client, "grn")
        _add_node(cluster, "c", tmp_path)
        for _ in range(20):
            h = client.cluster_health("grn")
            assert h["status"] == "green", h
            if h["relocating_shards"] == 0:
                break
            time.sleep(0.1)
    finally:
        cluster.close()


def test_cluster_stats_aggregates_across_nodes(tmp_path):
    cluster = Cluster("port", ["a", "b"], tmp_path)
    try:
        client = cluster.nodes[0].client()
        client.create_index("cs", {"settings": {"number_of_shards": 2,
                                                "number_of_replicas": 1}})
        _green(client, "cs")
        for i in range(25):
            client.index("cs", "doc", {"n": i}, id=str(i))
        client.refresh("cs")
        stats = client.cluster_stats()
        assert stats["status"] == "green"
        assert stats["indices"]["count"] == 1
        assert stats["indices"]["shards"]["total"] == 4
        assert stats["indices"]["shards"]["primaries"] == 2
        assert stats["indices"]["docs"]["count"] == 25
        assert stats["nodes"]["count"]["total"] == 2
        assert stats["nodes"]["count"]["master_data"] == 2
    finally:
        cluster.close()


def test_node_shutdown_action(tmp_path):
    cluster = Cluster("port", ["a", "b", "c"], tmp_path)
    try:
        master = next(n for n in cluster.nodes
                      if n.node_id == n.cluster_service.state.nodes.master_id)
        client = master.client()
        client.create_index("sd", {"settings": {"number_of_shards": 2,
                                                "number_of_replicas": 1}})
        _green(client, "sd")
        victim = next(n for n in cluster.nodes if n is not master)
        r = client.nodes_shutdown(victim.local_node.id)
        assert victim.local_node.id in r["nodes"]
        h = None
        deadline = time.time() + 20
        while time.time() < deadline:
            h = client.cluster_health("sd")
            if h["number_of_nodes"] == 2 and h["status"] == "green":
                break
            time.sleep(0.2)
        assert h["number_of_nodes"] == 2, h
        assert h["status"] == "green", h
    finally:
        cluster.close()
