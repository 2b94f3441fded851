"""Zen discovery, trimmed to a lone master-eligible node (a trimmed copy of
the JAX package's `discovery/zen.py`): the node elects itself (the lowest
id among the master-eligible nodes it knows, which is itself), installs
itself as master, lifts the no-master block and reroutes.

Pinging other nodes, joins, publishing, fault detection and re-election are
the slice with two nodes (ROADMAP A5): a node started with seed addresses
other than its own raises NotPortedError."""

from __future__ import annotations

from ..cluster.service import URGENT, ClusterService
from ..cluster.state import BLOCK_NO_MASTER, ClusterState, DiscoveryNode, DiscoveryNodes
from ..common.errors import NotPortedError
from ..common.logging import get_logger


class ZenDiscovery:
    def __init__(self, local_node: DiscoveryNode, cluster_service: ClusterService,
                 allocation_service):
        self.local_node = local_node
        self.cluster_service = cluster_service
        self.allocation = allocation_service
        self.logger = get_logger("discovery.zen")

    def start(self, seed_addresses: list[str]):
        others = [a for a in seed_addresses
                  if a != self.local_node.transport_address]
        if others:
            raise NotPortedError(
                f"joining other nodes {others} is not ported yet: the port runs "
                "one node until the slice with two nodes (zen discovery, "
                "replicas, the TCP transport)")
        self._become_master()

    def _become_master(self):
        self.logger.info("elected as master (1 known node)")
        local = self.local_node

        def update(state: ClusterState) -> ClusterState:
            nodes = DiscoveryNodes(local_id=local.id).with_node(local) \
                .with_master(local.id)
            new = state.next_version(
                nodes=nodes, blocks=state.blocks.without_global(BLOCK_NO_MASTER))
            return self.allocation.reroute(new)

        self.cluster_service.submit_state_update_task(
            "zen-elected-master", update, priority=URGENT).result(10)
