"""Node assembly and client (a trimmed copy of the JAX package's `node.py`).

A Node builds its services in dependency order — cluster service → gateway →
thread pools → breakers → the node-level DeviceBatcher → transport →
allocation → indices → actions → discovery — and `start()` elects itself master
of a one-node cluster and lifts the not-recovered block. `start_http(port)`
binds the REST surface (port 0 = ephemeral).

The node serves on the card unless told otherwise: its device is the
`node.device` setting ("cpu" in the tests) resolved through
`cudaenv.default_device`, so without CUDA and without that setting building
a Node raises DeviceUnavailableError. Every shard's query phase on this node
goes through ONE DeviceBatcher (`search_batcher`), as in the JAX node.

`Client` is trimmed to `create_index`, `index`, `bulk`, `refresh`, `search`
and `cluster_health`."""

from __future__ import annotations

import tempfile
import time
import uuid

from .actions import A_CREATE_INDEX, ActionModule
from .cluster.allocation import AllocationService
from .cluster.routing import OperationRouting
from .cluster.service import ClusterService
from .cluster.state import DiscoveryNode
from .common.breaker import CircuitBreakerService
from .common.cudaenv import default_device
from .common.errors import NotPortedError
from .common.logging import get_logger
from .common.settings import prepare_settings
from .discovery.zen import ZenDiscovery
from .gateway import LocalGateway
from .indices_service import IndicesService
from .search.batcher import DeviceBatcher
from .threadpool import ThreadPool
from .transport.local import DEFAULT_REGISTRY, LocalTransport
from .transport.service import TransportService


class Node:
    def __init__(self, name: str | None = None, settings=None, registry=None,
                 data_path: str | None = None):
        self.settings = prepare_settings(settings)
        self.device = default_device(self.settings.get_str("node.device"))
        self.name = name or self.settings.get_str("node.name") \
            or f"node_{uuid.uuid4().hex[:6]}"
        self.node_id = self.settings.get_str("node.id") or self.name
        self.data_path = data_path or self.settings.get_str("path.data") or \
            tempfile.mkdtemp(prefix=f"estpu_torch_{self.name}_")
        self.logger = get_logger("node")
        if self.settings.get_str("transport.type", "local") != "local":
            raise NotPortedError(
                "transport.type [tcp] is not ported yet (the slice with two "
                "nodes); the port node runs the local transport")
        # a path.data holding an earlier run's state raises here, before any
        # pool or transport thread starts
        self.cluster_service = ClusterService(self.name)
        try:
            self.gateway = LocalGateway(self.data_path, self.cluster_service)
        except Exception:
            self.cluster_service.close()
            raise
        self.registry = registry or DEFAULT_REGISTRY
        address = f"local://{self.node_id}"
        # a lone node is master-eligible and holds data
        self.local_node = DiscoveryNode(id=self.node_id, name=self.name,
                                        transport_address=address)
        self.threadpool = ThreadPool(self.settings)
        self.breakers = CircuitBreakerService(self.settings)
        # cross-request device micro-batching: concurrent query phases on
        # this node's shards coalesce into bucketed launches
        self.search_batcher = DeviceBatcher(self.settings)
        self.transport = TransportService(LocalTransport(address, self.registry),
                                          self.local_node, self.threadpool)
        self.transport.in_flight_breaker = self.breakers.breaker("in_flight_requests")
        self.allocation = AllocationService()
        self.operation_routing = OperationRouting()
        self.indices = IndicesService(self.node_id, self.data_path, self.transport,
                                      self.cluster_service, self.threadpool)
        self.actions = ActionModule(self)
        # scheduled NRT refresh and merge-policy check (each index's
        # refresh_interval is honoured inside periodic_refresh)
        self.threadpool.schedule_with_fixed_delay(
            0.5, self.indices.periodic_refresh, name="refresh")
        self.discovery = ZenDiscovery(self.local_node, self.cluster_service,
                                      self.allocation)
        self.http = None
        self._closed = False

    def start(self, seeds: list[str] | None = None) -> "Node":
        """Elect this node master of its one-node cluster and recover the
        (fresh) cluster state; seeds naming other nodes raise."""
        self.discovery.start(seeds or [])
        self.gateway.recover_fresh()
        self.logger.info("started [%s] on [%s]", self.name, self.device)
        return self

    def start_http(self, port: int = 0):
        """Bind the REST surface (port 0 = ephemeral)."""
        from .http.server import HttpServer
        from .rest.controller import build_rest_controller

        self.http = HttpServer(build_rest_controller(self), port=port).start()
        return self.http

    def close(self):
        if self._closed:
            return
        self._closed = True
        if self.http is not None:
            self.http.stop()
        self.gateway.persist_now()
        self.indices.close()
        self.cluster_service.close()
        self.transport.close()
        # stop the batcher's drainer before its callers' pools close, so
        # queued searches fail typed instead of hanging on futures
        self.search_batcher.shutdown()
        self.threadpool.shutdown()

    def client(self) -> "Client":
        return Client(self)


class Client:
    """One method per action of the slice."""

    def __init__(self, node: Node):
        self.node = node
        self.actions = node.actions

    def create_index(self, index, body=None):
        return self.node.transport.submit_request(
            self.node.local_node, A_CREATE_INDEX, {"index": index, "body": body or {}})

    def index(self, index, doc_type, body, id=None, routing=None, version=None,
              version_type="internal", op_type="index", refresh=False):
        return self.actions.index_doc(index, doc_type, id, body, routing=routing,
                                      version=version, version_type=version_type,
                                      op_type=op_type, refresh=refresh)

    def bulk(self, operations, refresh=False):
        return self.actions.bulk(operations, refresh=refresh)

    def refresh(self, index=None):
        return self.actions.broadcast(index, "refresh")

    def search(self, index=None, body=None, routing=None):
        return self.actions.search(index or "_all", body, routing=routing)

    def cluster_health(self, index=None, wait_for_status=None, timeout=10.0):
        deadline = time.monotonic() + timeout
        while True:
            h = self._health(index)
            ok = wait_for_status is None or _STATUS_ORDER.get(h["status"], 0) >= \
                _STATUS_ORDER.get(wait_for_status, 0)
            if ok or time.monotonic() > deadline:
                h["timed_out"] = not ok
                return h
            time.sleep(0.05)

    def _health(self, index=None):
        state = self.node.cluster_service.state
        shards = [s for s in state.routing_table.all_shards()
                  if index is None or s.index == index]
        active = sum(1 for s in shards if s.active)
        primaries = [s for s in shards if s.primary]
        active_primaries = sum(1 for s in primaries if s.active)
        if active_primaries < len(primaries):
            status = "red"
        elif active < len(shards):
            status = "yellow"
        else:
            status = "green"
        return {
            "cluster_name": state.cluster_name,
            "status": status,
            "number_of_nodes": state.nodes.size,
            "number_of_data_nodes": len(state.nodes.data_nodes()),
            "active_primary_shards": active_primaries,
            "active_shards": active,
            "relocating_shards": 0,
            "initializing_shards": sum(1 for s in shards if s.state == "INITIALIZING"),
            "unassigned_shards": sum(1 for s in shards if s.state == "UNASSIGNED"),
        }


_STATUS_ORDER = {"red": 0, "yellow": 1, "green": 2}
