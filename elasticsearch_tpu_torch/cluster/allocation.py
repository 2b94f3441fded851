"""Shard allocation on a lone node (a trimmed copy of the JAX package's
`cluster/allocation.py`): `reroute` assigns every UNASSIGNED primary to the
one data node; `apply_started_shards` moves INITIALIZING → STARTED;
`new_index_routing` builds a created or restored (gateway) index's table.
`reroute` also follows the explicit commands of `_cluster/reroute`
(actions `_m_reroute`), as in the JAX package: a replica a command put
INITIALIZING beside its primary, or a copy it moved, stays as it is.

A replica never lands beside its primary, so on one node every replica
stays unassigned and health is yellow. The decider chain (filters,
awareness, disk thresholds, throttling), the balanced weight, rebalancing
and failed-shard handling belong to the slice with two nodes."""

from __future__ import annotations

from dataclasses import replace

from .state import (
    INITIALIZING,
    STARTED,
    UNASSIGNED,
    ClusterState,
    IndexRoutingTable,
    IndexShardRoutingTable,
    ShardRouting,
)


class AllocationService:
    def reroute(self, state: ClusterState) -> ClusterState:
        """Assign every UNASSIGNED primary to the lone data node."""
        data_nodes = state.nodes.data_nodes()
        if not data_nodes:
            return state
        node_id = data_nodes[0].id
        new_tables: dict[str, list[list[ShardRouting]]] = {}
        changed = False
        for name, table in state.routing_table.indices:
            groups = []
            for grp in table.shards:
                shards = []
                for s in grp.shards:
                    if s.primary and s.state == UNASSIGNED:
                        s = replace(s, node_id=node_id, state=INITIALIZING,
                                    unassigned_reason=None)
                        changed = True
                    shards.append(s)
                groups.append(shards)
            new_tables[name] = groups
        return self._rebuild(state, new_tables) if changed else state

    def apply_started_shards(self, state: ClusterState,
                             started: list[ShardRouting]) -> ClusterState:
        keys = {(s.index, s.shard_id, s.node_id) for s in started}
        new_tables = {}
        changed = False
        for name, table in state.routing_table.indices:
            groups = []
            for grp in table.shards:
                shards = []
                for s in grp.shards:
                    if s.state == INITIALIZING and (s.index, s.shard_id, s.node_id) in keys:
                        shards.append(replace(s, state=STARTED))
                        changed = True
                    else:
                        shards.append(s)
                groups.append(shards)
            new_tables[name] = groups
        return self._rebuild(state, new_tables) if changed else state

    @staticmethod
    def _rebuild(state: ClusterState, new_tables: dict) -> ClusterState:
        rt = state.routing_table
        for name, groups in new_tables.items():
            rt = rt.with_index(IndexRoutingTable(
                name, tuple(IndexShardRoutingTable(tuple(g)) for g in groups)))
        return state.next_version(routing_table=rt)


def new_index_routing(index: str, num_shards: int, num_replicas: int) -> IndexRoutingTable:
    groups = []
    for sid in range(num_shards):
        shards = [ShardRouting(index, sid, None, True, UNASSIGNED,
                               unassigned_reason="index_created")]
        for _ in range(num_replicas):
            shards.append(ShardRouting(index, sid, None, False, UNASSIGNED,
                                       unassigned_reason="index_created"))
        groups.append(IndexShardRoutingTable(tuple(shards)))
    return IndexRoutingTable(index, tuple(groups))
