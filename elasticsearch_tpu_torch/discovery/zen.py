"""Zen discovery: ping → elect → join → publish → fault-detect (a copy of
the JAX package's `discovery/zen.py`).

- ping: ask every seed address who it is and whom it takes for master;
- election (`ElectMasterService`): the lowest id among the master-eligible
  nodes known, guarded by `discovery.zen.minimum_master_nodes` before
  electing and on every departure;
- join: a node that is not master sends a join (retried 3 times); the
  master adds it, reroutes (its shards may now spread to the new node)
  and publishes;
- publish: the master fans the full state to every node, which installs it
  unless it already holds a newer one (cluster/service `apply_new_state`);
- fault detection: every `discovery.zen.fd.ping_interval` (0.5 s) the
  master pings each node and each node pings the master; after
  `ping_retries` (3) failures in a row the master removes the node (its
  copies fail: a started replica of each of its primaries is promoted,
  and with no replica its primaries come back as fresh empty primaries on
  the nodes that remain) and a node re-joins (a lost master means a new
  election);
- quorum: a master that drops below `minimum_master_nodes` steps down and
  installs the no-master block; the nodes re-join when they can;
- leave: a closing node tells the master first (`close()`), so its
  removal does not wait for fault detection.

The handlers run on the transport's dispatching thread (`executor="same"`),
as in the JAX package."""

from __future__ import annotations

import threading
import time

from ..common.errors import MasterNotDiscoveredError, SearchEngineError
from ..common.logging import get_logger
from ..cluster.service import URGENT, ClusterService
from ..cluster.state import (
    BLOCK_NO_MASTER,
    ClusterState,
    DiscoveryNode,
    DiscoveryNodes,
)

ACTION_PING = "internal:discovery/zen/ping"
ACTION_JOIN = "internal:discovery/zen/join"
ACTION_PUBLISH = "internal:discovery/zen/publish"
ACTION_LEAVE = "internal:discovery/zen/leave"
ACTION_FD_PING = "internal:discovery/zen/fd/ping"


class ElectMasterService:
    """The master: the first master-eligible node by id."""

    def __init__(self, minimum_master_nodes: int = 1):
        self.minimum_master_nodes = minimum_master_nodes

    def has_enough_master_nodes(self, nodes: list[DiscoveryNode]) -> bool:
        eligible = [n for n in nodes if n.master_eligible]
        return len(eligible) >= self.minimum_master_nodes

    def elect(self, nodes: list[DiscoveryNode]) -> DiscoveryNode | None:
        eligible = sorted((n for n in nodes if n.master_eligible), key=lambda n: n.id)
        return eligible[0] if eligible else None


class ZenDiscovery:
    def __init__(self, local_node: DiscoveryNode, transport_service, cluster_service:
                 ClusterService, allocation_service, settings=None,
                 ping_interval: float = 0.5, ping_timeout: float = 1.5,
                 ping_retries: int = 3):
        from ..common.settings import Settings

        settings = settings or Settings.EMPTY
        self.local_node = local_node
        self.transport = transport_service
        self.cluster_service = cluster_service
        self.allocation = allocation_service
        self.elect_service = ElectMasterService(
            settings.get_int("discovery.zen.minimum_master_nodes", 1))
        self.logger = get_logger("discovery.zen", node=local_node.name)
        self.ping_interval = settings.get_time("discovery.zen.fd.ping_interval",
                                               ping_interval)
        self.ping_timeout = settings.get_time("discovery.zen.fd.ping_timeout", ping_timeout)
        self.ping_retries = settings.get_int("discovery.zen.fd.ping_retries", ping_retries)
        self._stopped = threading.Event()
        self._fd_thread: threading.Thread | None = None
        self._fail_counts: dict[str, int] = {}

        transport_service.register_handler(ACTION_PING, self._handle_ping)
        transport_service.register_handler(ACTION_JOIN, self._handle_join)
        transport_service.register_handler(ACTION_PUBLISH, self._handle_publish)
        transport_service.register_handler(ACTION_LEAVE, self._handle_leave)
        transport_service.register_handler(ACTION_FD_PING, self._handle_fd_ping)
        cluster_service.set_publisher(self.publish)

    # ------------------------------------------------------------------ joining
    def start(self, seed_addresses: list[str]):
        self._join_cluster(seed_addresses)
        self._fd_thread = threading.Thread(target=self._fault_detection_loop,
                                           daemon=True,
                                           name=f"estpu_torch[{self.local_node.name}][zen-fd]")
        self._fd_thread.start()

    def _ping_all(self, addresses: list[str]) -> list[dict]:
        """Collect (node, claimed master) from every reachable address."""
        responses = []
        for addr in addresses:
            if addr == self.local_node.transport_address:
                continue
            try:
                r = self.transport.submit_request(addr, ACTION_PING,
                                                 {"from": self.local_node.to_dict()},
                                                 timeout=self.ping_timeout)
                responses.append(r)
            except SearchEngineError:
                continue
        return responses

    def _join_cluster(self, seed_addresses: list[str]):
        responses = self._ping_all(seed_addresses)
        known = {self.local_node.id: self.local_node}
        claimed_masters = []
        for r in responses:
            node = DiscoveryNode.from_dict(r["node"])
            known[node.id] = node
            if r.get("master_id"):
                claimed_masters.append((r["master_id"], node))
        if not self.elect_service.has_enough_master_nodes(list(known.values())):
            self.logger.warning("not enough master nodes (%d known)", len(known))
            self._set_no_master()
            return
        # prefer an existing master
        if claimed_masters:
            master_id = claimed_masters[0][0]
            master_node = known.get(master_id)
            if master_node is None:
                for r in responses:
                    n = DiscoveryNode.from_dict(r["node"])
                    if n.id == master_id:
                        master_node = n
            if master_node is not None and master_id != self.local_node.id:
                self._send_join(master_node)
                return
        elected = self.elect_service.elect(list(known.values()))
        if elected is None:
            self._set_no_master()
            return
        if elected.id == self.local_node.id:
            self._become_master(known)
        else:
            self._send_join(elected)

    def _become_master(self, known: dict):
        self.logger.info("elected as master (%d known nodes)", len(known))

        def update(state: ClusterState) -> ClusterState:
            nodes = DiscoveryNodes(local_id=self.local_node.id)
            for n in known.values():
                nodes = nodes.with_node(n)
            nodes = nodes.with_master(self.local_node.id).with_local(self.local_node.id)
            new = state.next_version(
                nodes=nodes, blocks=state.blocks.without_global(BLOCK_NO_MASTER))
            return self.allocation.reroute(new)

        self.cluster_service.submit_state_update_task("zen-elected-master", update,
                                                      priority=URGENT).result(10)

    def _send_join(self, master: DiscoveryNode, retries: int = 3):
        for attempt in range(retries):
            try:
                self.transport.submit_request(
                    master.transport_address, ACTION_JOIN,
                    {"node": self.local_node.to_dict()}, timeout=5.0)
                return
            except SearchEngineError as e:
                self.logger.warning("join to %s failed (%s), attempt %d", master.id, e,
                                    attempt + 1)
                time.sleep(0.1)
        self._set_no_master()

    def _set_no_master(self):
        def update(state: ClusterState) -> ClusterState:
            nodes = DiscoveryNodes(local_id=self.local_node.id).with_node(
                self.local_node).with_local(self.local_node.id)
            return state.next_version(
                nodes=nodes.with_master(None),
                blocks=state.blocks.with_global(BLOCK_NO_MASTER))

        self.cluster_service.submit_state_update_task("zen-no-master", update,
                                                      priority=URGENT)

    # ------------------------------------------------------------------ handlers
    def _handle_ping(self, request, channel):
        state = self.cluster_service.state
        return {"node": self.local_node.to_dict(),
                "master_id": state.nodes.master_id,
                "cluster_name": state.cluster_name,
                "version": state.version}

    def _handle_join(self, request, channel):
        node = DiscoveryNode.from_dict(request["node"])
        state = self.cluster_service.state
        if state.nodes.master_id != self.local_node.id:
            raise MasterNotDiscoveredError("not the master")

        def update(current: ClusterState) -> ClusterState:
            if current.nodes.get(node.id) is not None:
                return current
            new = current.next_version(nodes=current.nodes.with_node(node))
            return self.allocation.reroute(new)

        self.cluster_service.submit_state_update_task(f"zen-join[{node.id}]", update,
                                                      priority=URGENT).result(10)
        return {"ok": True}

    def _handle_publish(self, request, channel):
        new_state = ClusterState.from_dict(request["state"], local_id=self.local_node.id)
        self.cluster_service.apply_new_state(
            f"zen-publish[v{new_state.version}]", new_state)
        return {"ack": True, "node": self.local_node.id}

    def _handle_leave(self, request, channel):
        node_id = request["node_id"]
        self._node_left(node_id, reason="left")
        return {"ok": True}

    def _handle_fd_ping(self, request, channel):
        state = self.cluster_service.state
        return {"node": self.local_node.id, "master_id": state.nodes.master_id}

    # ------------------------------------------------------------------ publish
    def publish(self, state: ClusterState):
        """Master → every other node: the full state, acknowledged; a node
        that does not answer is logged and caught by fault detection."""
        payload = state.to_dict()
        for node in state.nodes.nodes:
            if node.id == self.local_node.id:
                continue
            try:
                self.transport.submit_request(node.transport_address, ACTION_PUBLISH,
                                              {"state": payload}, timeout=5.0)
            except SearchEngineError as e:
                self.logger.warning("publish to %s failed: %s", node.id, e)

    # ------------------------------------------------------------------ fd
    def _fault_detection_loop(self):
        while not self._stopped.wait(self.ping_interval):
            try:
                state = self.cluster_service.state
                if state.nodes.master_id == self.local_node.id:
                    self._master_pings_nodes(state)
                elif state.nodes.master_id is not None:
                    self._ping_master(state)
                else:
                    # no master known: retry the join over every known address
                    registry = getattr(self.transport.backend, "registry", None)
                    addresses = registry.addresses() if registry else []
                    self._join_cluster(addresses)
            except Exception as e:  # noqa: BLE001
                self.logger.warning("fd loop error: %s", e)

    def _master_pings_nodes(self, state: ClusterState):
        for node in list(state.nodes.nodes):
            if node.id == self.local_node.id:
                continue
            try:
                self.transport.submit_request(node.transport_address, ACTION_FD_PING,
                                              {"from": self.local_node.id},
                                              timeout=self.ping_timeout)
                self._fail_counts.pop(node.id, None)
            except SearchEngineError:
                count = self._fail_counts.get(node.id, 0) + 1
                self._fail_counts[node.id] = count
                if count >= self.ping_retries:
                    self.logger.info("node [%s] failed fd %d times — removing", node.id, count)
                    self._fail_counts.pop(node.id, None)
                    self._node_left(node.id, reason="failed")

    def _ping_master(self, state: ClusterState):
        master = state.nodes.master
        if master is None:
            return
        try:
            self.transport.submit_request(master.transport_address, ACTION_FD_PING,
                                          {"from": self.local_node.id},
                                          timeout=self.ping_timeout)
            self._fail_counts.pop(master.id, None)
        except SearchEngineError:
            count = self._fail_counts.get(master.id, 0) + 1
            self._fail_counts[master.id] = count
            if count >= self.ping_retries:
                self.logger.info("master [%s] unreachable — re-joining", master.id)
                self._fail_counts.pop(master.id, None)
                self._set_no_master()

    def _node_left(self, node_id: str, reason: str):
        """Master-side: remove a node, fail its shards, check quorum."""

        def update(current: ClusterState) -> ClusterState:
            if current.nodes.get(node_id) is None:
                return current
            nodes = current.nodes.without_node(node_id)
            if not self.elect_service.has_enough_master_nodes(list(nodes.nodes)):
                # quorum lost: step down
                self.logger.warning("quorum lost after [%s] %s — stepping down", node_id, reason)
                return current.next_version(
                    nodes=nodes.with_master(None),
                    blocks=current.blocks.with_global(BLOCK_NO_MASTER))
            new = current.next_version(nodes=nodes)
            return self.allocation.remove_node(new, node_id)

        self.cluster_service.submit_state_update_task(
            f"zen-node-{reason}[{node_id}]", update, priority=URGENT)

    # ------------------------------------------------------------------ lifecycle
    def leave(self):
        """Graceful leave: tell the master before shutting down."""
        state = self.cluster_service.state
        master = state.nodes.master
        if master is not None and master.id != self.local_node.id:
            try:
                self.transport.submit_request(master.transport_address, ACTION_LEAVE,
                                              {"node_id": self.local_node.id}, timeout=2.0)
            except SearchEngineError:
                pass

    def stop(self):
        self._stopped.set()
