"""The port's `cluster/allocation.py` against the JAX package's.

- A seeded differential: synthetic cluster states (1-5 nodes, 1-7 shards,
  0-2 replicas, under no setting or one of the filter, awareness,
  throttling, disk watermark, shards-limit, enable and rebalance
  settings) go through both packages' default-chain AllocationService, a
  random walk of `reroute`, `apply_started_shards`, `apply_failed_shard`,
  `remove_node` and a joining empty node (which the rebalance step reads);
  after every step the routing tables are equal (the port's state is
  handed to the JAX package through `to_dict`, so both start equal).
  Tolerance: none.
- The invariants of tests/test_allocation_deciders.py (shards limit, node
  version, snapshot in progress, rebalancing, relocation pairs), copied
  onto the port's classes.
- A port node's chain (the JAX default): a departed node's primaries
  come back as fresh primaries on the node that remains when they have no
  replica."""

import pytest

from elasticsearch_tpu_torch.cluster.allocation import (
    AllocationService,
    new_index_routing,
)
from elasticsearch_tpu_torch.cluster.state import (
    INITIALIZING,
    RELOCATING,
    STARTED,
    UNASSIGNED,
    ClusterState,
    DiscoveryNode,
    DiscoveryNodes,
    IndexMetaData,
    MetaData,
    RoutingTable,
)
from elasticsearch_tpu_torch.common.settings import Settings


def _node(i, version_id=10000, attrs=()):
    return DiscoveryNode(id=f"n{i}", name=f"n{i}", transport_address=f"local://n{i}",
                         attrs=attrs, version_id=version_id)


def _state(n_nodes=3, shards=2, replicas=1, index="idx", index_settings=None,
           node_versions=None):
    nodes = tuple(
        _node(i, version_id=(node_versions or {}).get(i, 10000))
        for i in range(n_nodes))
    settings_map = {"index.number_of_shards": shards,
                    "index.number_of_replicas": replicas,
                    **(index_settings or {})}
    meta = IndexMetaData(name=index,
                         settings_map=tuple(settings_map.items()))
    return ClusterState(
        cluster_name="test",
        nodes=DiscoveryNodes(nodes=nodes, master_id="n0", local_id="n0"),
        metadata=MetaData(indices=((index, meta),)),
        routing_table=RoutingTable(
            ((index, new_index_routing(index, shards, replicas)),)),
    )


def _start_all(svc, state):
    for _ in range(4):
        state = svc.reroute(state)
        init = [s for s in state.routing_table.all_shards()
                if s.state == INITIALIZING and s.relocating_node is None]
        if not init:
            break
        state = svc.apply_started_shards(state, init)
    return state


class TestShardsLimit:
    def test_total_shards_per_node_caps_allocation(self):
        # 4 shards x 1 copy on 2 nodes with limit 1: only 2 can place
        svc = AllocationService()
        state = svc.reroute(_state(
            n_nodes=2, shards=4, replicas=0,
            index_settings={"index.routing.allocation.total_shards_per_node": 1}))
        assigned = [s for s in state.routing_table.all_shards() if s.assigned]
        unassigned = [s for s in state.routing_table.all_shards()
                      if s.state == UNASSIGNED]
        assert len(assigned) == 2 and len(unassigned) == 2
        per_node = {}
        for s in assigned:
            per_node[s.node_id] = per_node.get(s.node_id, 0) + 1
        assert all(v == 1 for v in per_node.values())

    def test_unlimited_by_default(self):
        svc = AllocationService()
        state = _start_all(svc, _state(n_nodes=1, shards=4, replicas=0))
        assert all(s.state == STARTED
                   for s in state.routing_table.all_shards())


class TestNodeVersion:
    def test_replica_refuses_older_node_than_primary(self):
        # n0 new (10100), n1 old (10000): if the primary lands on n0, the
        # replica cannot go to the older n1
        svc = AllocationService()
        state = _state(n_nodes=2, shards=1, replicas=1,
                       node_versions={0: 10100, 1: 10000})
        state = svc.reroute(state)
        state = svc.apply_started_shards(
            state, [s for s in state.routing_table.all_shards() if s.primary])
        state = svc.reroute(state)
        group = state.routing_table.index("idx").shard(0)
        primary = group.primary
        replica = [s for s in group.shards if not s.primary][0]
        if primary.node_id == "n0":
            assert replica.state == UNASSIGNED  # n1 is older — refused
        else:
            assert replica.assigned  # n0 is newer — fine

    def test_same_version_allocates(self):
        svc = AllocationService()
        state = _start_all(svc, _state(n_nodes=2, shards=1, replicas=1))
        assert all(s.state == STARTED
                   for s in state.routing_table.all_shards())


class TestSnapshotInProgress:
    def test_snapshotting_index_never_rebalances(self):
        svc = AllocationService()
        state = _start_all(svc, _state(n_nodes=2, shards=3, replicas=1))
        # imbalance arrives with a third empty node joining (replicas present:
        # the rebalancer moves replicas only — primaries stay put by design)
        state = ClusterState(
            cluster_name=state.cluster_name,
            nodes=DiscoveryNodes(nodes=(*state.nodes.nodes, _node(2)),
                                 master_id="n0", local_id="n0"),
            metadata=state.metadata, routing_table=state.routing_table,
            version=state.version + 1)
        svc.snapshotting_indices.add("idx")
        state2 = svc.reroute(state)
        assert not [s for s in state2.routing_table.all_shards()
                    if s.state == RELOCATING]
        svc.snapshotting_indices.clear()
        state3 = svc.reroute(state)
        assert [s for s in state3.routing_table.all_shards()
                if s.state == RELOCATING]


class TestRebalance:
    def _imbalanced(self, svc, shards=3):
        state = _start_all(svc, _state(n_nodes=2, shards=shards, replicas=1))
        # a fresh empty node joins: weights are now lopsided
        return ClusterState(
            cluster_name=state.cluster_name,
            nodes=DiscoveryNodes(nodes=(*state.nodes.nodes, _node(2)),
                                 master_id="n0", local_id="n0"),
            metadata=state.metadata, routing_table=state.routing_table,
            version=state.version + 1)

    def test_rebalance_relocates_to_new_node(self):
        svc = AllocationService()
        state = svc.reroute(self._imbalanced(svc))
        relocating = [s for s in state.routing_table.all_shards()
                      if s.state == RELOCATING]
        targets = [s for s in state.routing_table.all_shards()
                   if s.state == INITIALIZING and s.relocating_node is not None]
        assert len(relocating) == 1 and len(targets) == 1
        assert targets[0].node_id == "n2"
        assert targets[0].relocating_node == relocating[0].node_id

    def test_relocation_completes_on_target_start(self):
        svc = AllocationService()
        state = svc.reroute(self._imbalanced(svc))
        target = [s for s in state.routing_table.all_shards()
                  if s.state == INITIALIZING and s.relocating_node][0]
        state = svc.apply_started_shards(state, [target])
        group = state.routing_table.index("idx").shard(target.shard_id)
        assert len(group.shards) == 2  # primary + the relocated replica
        moved = [s for s in group.shards if not s.primary]
        assert [s.node_id for s in moved] == ["n2"]
        assert moved[0].state == STARTED and moved[0].relocating_node is None
        assert not [s for s in group.shards if s.state == RELOCATING]

    def test_relocation_target_failure_reverts_source(self):
        svc = AllocationService()
        state = svc.reroute(self._imbalanced(svc))
        target = [s for s in state.routing_table.all_shards()
                  if s.state == INITIALIZING and s.relocating_node][0]
        state = svc.apply_failed_shard(state, target)
        group = state.routing_table.index("idx").shard(target.shard_id)
        # the data-bearing source copy survived on its original node (reverted
        # to STARTED — the trailing reroute may legitimately retry, putting it
        # straight back into RELOCATING with a fresh target pair)
        src = [s for s in group.shards
               if not s.primary and s.node_id == target.relocating_node]
        assert len(src) == 1 and src[0].state in (STARTED, RELOCATING)
        retry_targets = [s for s in group.shards
                         if s.state == INITIALIZING and s.relocating_node]
        for t in retry_targets:
            assert t.relocating_node == src[0].node_id

    def test_concurrent_rebalance_limit(self):
        svc = AllocationService(Settings.from_flat(
            {"cluster.routing.allocation.cluster_concurrent_rebalance": 0}))
        state = svc.reroute(self._imbalanced(svc))
        assert not [s for s in state.routing_table.all_shards()
                    if s.state == RELOCATING]

    def test_cluster_rebalance_waits_for_all_active(self):
        svc = AllocationService()
        state = self._imbalanced(svc)
        # one shard back to UNASSIGNED: indices_all_active (default) gates
        from dataclasses import replace as dc_replace

        name, table = state.routing_table.indices[0]
        g0 = table.shards[0]
        broken = dc_replace(g0.shards[0], node_id=None, state=UNASSIGNED)
        from elasticsearch_tpu_torch.cluster.state import (IndexRoutingTable,
                                                     IndexShardRoutingTable)

        new_groups = (IndexShardRoutingTable((broken,)),) + table.shards[1:]
        state = ClusterState(
            cluster_name=state.cluster_name, nodes=state.nodes,
            metadata=state.metadata,
            routing_table=RoutingTable(
                ((name, IndexRoutingTable(name, new_groups)),)),
            version=state.version + 1)
        # remove n2's capacity problem: the unassigned shard will allocate to
        # n2 (fine) but NO relocation may start while anything is inactive
        state2 = svc.reroute(state)
        assert not [s for s in state2.routing_table.all_shards()
                    if s.state == RELOCATING]

    def test_balanced_cluster_does_not_thrash(self):
        svc = AllocationService()
        state = _start_all(svc, _state(n_nodes=2, shards=4, replicas=1))
        state2 = svc.reroute(state)
        assert not [s for s in state2.routing_table.all_shards()
                    if s.state == RELOCATING]


# ----------------------------------------------------------------------------
# the seeded differential against the JAX allocator
# ----------------------------------------------------------------------------

SCENARIOS = ["none", "filter", "awareness", "throttling", "disk", "shards_limit",
             "enable", "rebalance"]


def _scenario(rng, scenario, n_nodes):
    """(cluster settings, index settings, node attrs by index, disk usages)."""
    cluster, index, attrs, disk = {}, {}, {}, {}
    if scenario == "filter":
        victim = int(rng.integers(0, n_nodes))
        key = "exclude" if rng.random() < 0.5 else "include"
        names = f"n{victim}" if key == "exclude" else \
            ",".join(f"n{i}" for i in range(n_nodes) if i != victim) or "n0"
        if rng.random() < 0.5:
            cluster[f"cluster.routing.allocation.{key}._name"] = names
        else:
            index[f"index.routing.allocation.{key}._name"] = names
    elif scenario == "awareness":
        cluster["cluster.routing.allocation.awareness.attributes"] = "zone"
        for i in range(n_nodes):
            attrs[i] = (("zone", f"z{int(rng.integers(0, 2))}"),)
    elif scenario == "throttling":
        cluster["cluster.routing.allocation.node_concurrent_recoveries"] = \
            int(rng.integers(1, 4))
    elif scenario == "disk":
        for i in range(n_nodes):
            disk[f"n{i}"] = float(rng.choice([0.5, 0.95]))
    elif scenario == "shards_limit":
        index["index.routing.allocation.total_shards_per_node"] = int(rng.integers(1, 4))
    elif scenario == "enable":
        cluster["cluster.routing.allocation.enable"] = str(
            rng.choice(["all", "primaries", "new_primaries", "none"]))
    elif scenario == "rebalance":
        cluster["cluster.routing.allocation.allow_rebalance"] = "always"
        cluster["cluster.routing.allocation.balance.threshold"] = 1.0
    return cluster, index, attrs, disk


def _jax_state(state):
    from elasticsearch_tpu.cluster.state import ClusterState as JState

    return JState.from_dict(state.to_dict(), local_id=state.nodes.local_id)


def _rows(state):
    return state.routing_table.to_dict()


@pytest.mark.parametrize("seed", range(64))
def test_default_chain_routes_as_the_jax_allocator(seed):
    import numpy as np

    from elasticsearch_tpu.cluster.allocation import AllocationService as JAlloc

    rng = np.random.default_rng(seed)
    n_nodes = int(rng.integers(1, 6))
    shards, replicas = int(rng.integers(1, 8)), int(rng.integers(0, 3))
    scenario = SCENARIOS[seed % len(SCENARIOS)]
    cluster, index_settings, attrs, disk = _scenario(rng, scenario, n_nodes)
    state = _state(n_nodes=n_nodes, shards=shards, replicas=replicas,
                   index_settings=index_settings)
    if attrs:
        nodes = tuple(_node(i, attrs=attrs.get(i, ())) for i in range(n_nodes))
        state = ClusterState(cluster_name="test", nodes=DiscoveryNodes(
            nodes=nodes, master_id="n0", local_id="n0"), metadata=state.metadata,
            routing_table=state.routing_table)
    tsvc = AllocationService(Settings.from_flat(cluster))
    jsvc = JAlloc(_jax_settings(cluster))
    tsvc.disk_usages, jsvc.disk_usages = dict(disk), dict(disk)
    t, j = state, _jax_state(state)
    assert _rows(t) == _rows(j)
    for step in range(12):
        op = rng.choice(["reroute", "start", "start", "fail", "remove", "join"],
                        p=[0.2, 0.3, 0.2, 0.12, 0.08, 0.1])
        shards_now = list(t.routing_table.all_shards())
        if op == "reroute":
            t, j = tsvc.reroute(t), jsvc.reroute(j)
        elif op == "start":
            init = [s for s in shards_now if s.state == INITIALIZING]
            pick = [s for s in init if rng.random() < 0.7]
            t = tsvc.apply_started_shards(t, pick)
            j = jsvc.apply_started_shards(j, _jax_shards(pick))
        elif op == "fail":
            assigned = [s for s in shards_now if s.assigned]
            if not assigned:
                continue
            s = assigned[int(rng.integers(0, len(assigned)))]
            t = tsvc.apply_failed_shard(t, s)
            j = jsvc.apply_failed_shard(j, _jax_shards([s])[0])
        elif op == "remove":
            if t.nodes.size < 2:
                continue
            gone = t.nodes.nodes[int(rng.integers(1, t.nodes.size))].id
            t = tsvc.remove_node(t.next_version(nodes=t.nodes.without_node(gone)), gone)
            j = jsvc.remove_node(j.next_version(nodes=j.nodes.without_node(gone)), gone)
        else:  # an empty node joins: the rebalance step may move a replica
            from elasticsearch_tpu.cluster.state import DiscoveryNode as JNode

            new = _node(10 + step)
            t = tsvc.reroute(t.next_version(nodes=t.nodes.with_node(new)))
            j = jsvc.reroute(j.next_version(nodes=j.nodes.with_node(
                JNode.from_dict(new.to_dict()))))
        assert _rows(t) == _rows(j), (seed, step, op)


def _jax_settings(flat):
    from elasticsearch_tpu.common.settings import Settings as JSettings

    return JSettings.from_flat(flat)


def _jax_shards(shards):
    from elasticsearch_tpu.cluster.state import ShardRouting as JShard

    return [JShard.from_dict(s.to_dict()) for s in shards]


# ----------------------------------------------------------------------------
# a port node's chain
# ----------------------------------------------------------------------------

def test_departed_node_primaries_come_back_fresh_on_both_packages():
    """0 replicas: the departed node's primaries fail and are assigned again
    as primaries on the node that remains (empty: the JAX master's
    behaviour, kept)."""
    from elasticsearch_tpu.cluster.allocation import AllocationService as JAlloc

    svc = AllocationService()
    t = _start_all(svc, _state(n_nodes=2, shards=4, replicas=0))
    j = _jax_state(t)
    on_n1 = sorted(s.shard_id for s in t.routing_table.all_shards() if s.node_id == "n1")
    assert on_n1
    t = svc.remove_node(t.next_version(nodes=t.nodes.without_node("n1")), "n1")
    j = JAlloc().remove_node(j.next_version(nodes=j.nodes.without_node("n1")), "n1")
    assert _rows(t) == _rows(j)
    moved = [s for s in t.routing_table.all_shards() if s.shard_id in on_n1]
    assert all(s.primary and s.node_id == "n0" for s in moved)
    assert {s.state for s in moved} <= {INITIALIZING, UNASSIGNED}
