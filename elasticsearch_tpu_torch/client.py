"""TransportClient: a cluster client that is not a cluster node (a copy of
the JAX package's `client.py`).

It speaks the framed TCP transport (transport/tcp.py) to seed addresses,
samples the cluster on a timer (sniff mode asks any reachable node for the
whole node list; listed mode probes only the seeds), round-robins calls
over the live nodes and fails over when a node stops answering: a
connection failure drops the node and tries the next; a timeout does so
only for a read (`IDEMPOTENT_METHODS`), since a write may already be
applied. Each call runs one whitelisted method of the receiving node's
Client (`CLIENT_PROXY_METHODS`, keyword arguments only), coordinated there
as a REST request would be; the list is the JAX client's, the snapshot and
repository methods included."""

from __future__ import annotations

import functools
import itertools
import threading

from .common.errors import (
    NoNodeAvailableError,
    NodeNotConnectedError,
    ReceiveTimeoutError,
    TransportError,
)
from .common.logging import get_logger

A_CLIENT_NODES = "cluster:monitor/client/nodes"
A_CLIENT_EXEC = "cluster:client/exec"

# reads are safe to replay on another node after a timeout; writes are not:
# a timed-out write may already be applied
IDEMPOTENT_METHODS = frozenset({
    "search", "msearch", "count", "suggest", "get", "mget", "termvector",
    "mtermvectors", "mlt", "percolate", "count_percolate", "mpercolate",
    "exists_index", "exists_type", "exists_alias", "explain",
    "get_mapping", "get_field_mapping", "get_settings", "get_aliases",
    "get_alias", "get_template", "get_warmer", "cluster_health",
    "cluster_state", "cluster_get_settings", "pending_tasks", "nodes_info",
    "nodes_stats", "stats", "indices_status", "get_snapshots", "get_repository",
    "snapshot_status", "cluster_stats", "node_events", "cluster_events",
})

# the proxied API surface: every name is a method of node.Client (a test
# holds it so)
CLIENT_PROXY_METHODS = IDEMPOTENT_METHODS | frozenset({
    "index", "create", "delete", "update", "bulk", "delete_by_query",
    "create_index", "delete_index", "open_index", "close_index", "refresh",
    "flush", "optimize", "clear_cache", "put_mapping", "delete_mapping",
    "put_template", "delete_template", "update_settings", "update_aliases",
    "put_warmer", "delete_warmer", "put_repository", "delete_repository",
    "verify_repository", "create_snapshot", "restore_snapshot",
    "delete_snapshot",
})


class TransportClient:
    """Round-robin, self-healing client over the TCP transport.

    seeds: ["host:port", ...] — at least one must answer for the first sample.
    sniff=True  → discover every node from the cluster state; the live set
                  follows the cluster's membership.
    sniff=False → listed-nodes mode: only ever talk to the seed addresses.
    """

    def __init__(self, seeds: list[str], sniff: bool = True,
                 sniff_interval: float = 5.0, timeout: float = 30.0):
        from .transport.service import TransportService
        from .transport.tcp import TcpTransport

        if not seeds:
            raise ValueError("TransportClient requires at least one seed address")
        self._svc = TransportService(TcpTransport())
        self._seeds = list(seeds)
        self._sniff = sniff
        self._interval = float(sniff_interval)
        self._timeout = float(timeout)
        self._logger = get_logger("client.transport")
        self._lock = threading.Lock()
        self._nodes: list[str] = []  # live addresses, round-robin order
        self._rr = itertools.count()
        self._closed = threading.Event()
        self.sample()
        self._thread = threading.Thread(target=self._sample_loop, daemon=True,
                                        name="estpu_torch-client-sampler")
        self._thread.start()

    # -- sampling ----------------------------------------------------------
    def _sample_loop(self):
        while not self._closed.wait(self._interval):
            try:
                self.sample()
            except Exception as e:  # noqa: BLE001 — sampler must never die
                self._logger.warning(f"node sample failed: {e}")

    def sample(self) -> bool:
        """One sampling round. Sniff mode: first reachable node (current, then
        seeds) supplies the authoritative node list. Listed mode: probe each seed.
        Returns True if any node answered."""
        with self._lock:
            current = list(self._nodes)
        if self._sniff:
            for address in current + [s for s in self._seeds if s not in current]:
                nodes = self._ask_nodes(address)
                if nodes is not None:
                    with self._lock:
                        self._nodes = nodes
                    return True
            with self._lock:
                self._nodes = []
            return False
        live = [s for s in self._seeds if self._ask_nodes(s) is not None]
        with self._lock:
            self._nodes = live
        return bool(live)

    def _ask_nodes(self, address: str) -> list[str] | None:
        try:
            r = self._svc.submit_request(address, A_CLIENT_NODES, {}, timeout=5.0)
            return [a for (_i, _n, a) in r["nodes"]]
        except (NodeNotConnectedError, TransportError):
            return None

    def connected_nodes(self) -> list[str]:
        with self._lock:
            return list(self._nodes)

    # -- execution ----------------------------------------------------------
    def _execute(self, method: str, *args, **kwargs):
        if args:
            raise TypeError(
                f"TransportClient.{method} takes keyword arguments only "
                "(they cross the wire by name)")
        last_err: Exception | None = None
        with self._lock:
            nodes = list(self._nodes) or list(self._seeds)
        start = next(self._rr)
        for i in range(len(nodes)):
            address = nodes[(start + i) % len(nodes)]
            try:
                r = self._svc.submit_request(
                    address, A_CLIENT_EXEC, {"method": method, "kwargs": kwargs},
                    timeout=self._timeout)
                return r["r"]
            except NodeNotConnectedError as e:
                # connection-level failure → drop the node and try the next copy;
                # application errors (index missing, conflicts…) propagate as-is
                last_err = e
                with self._lock:
                    if address in self._nodes:
                        self._nodes.remove(address)
            except ReceiveTimeoutError as e:
                # the node may still be APPLYING the request — only idempotent
                # reads are safe to replay elsewhere; a timed-out write must
                # surface to the caller, not silently double-apply
                if method not in IDEMPOTENT_METHODS:
                    raise
                last_err = e
                with self._lock:
                    if address in self._nodes:
                        self._nodes.remove(address)
        raise NoNodeAvailableError(
            f"none of {nodes} answered [{method}]: {last_err}")

    def __getattr__(self, name: str):
        if name in CLIENT_PROXY_METHODS:
            return functools.partial(self._execute, name)
        raise AttributeError(name)

    def close(self):
        self._closed.set()
        self._svc.close()
