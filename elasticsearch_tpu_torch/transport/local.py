"""In-process transport backend (a copy of the JAX package's
`transport/local.py`): nodes in one process exchange messages through a
shared registry, delivered on the target's worker thread (never inline).

`partition(a, b)` / `heal(a, b)` / `isolate(a)` drop the messages between
address pairs, both ways, requests and responses: the network partitions
the discovery tests simulate.

The port keeps a registry of its own (`DEFAULT_REGISTRY` here, never the JAX
package's), so a process that runs a node of each package never routes a
message from one to the other."""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor

from ..common.errors import NodeNotConnectedError
from .service import TransportChannel, complete_fut


class LocalTransportRegistry:
    """One registry = one simulated network."""

    def __init__(self):
        self.nodes: dict[str, "LocalTransport"] = {}
        self.partitions: set[frozenset] = set()
        self.dropped_count = 0
        self._lock = threading.Lock()

    def register(self, address: str, transport: "LocalTransport"):
        with self._lock:
            self.nodes[address] = transport

    def unregister(self, address: str):
        with self._lock:
            self.nodes.pop(address, None)

    def partition(self, a: str, b: str):
        with self._lock:
            self.partitions.add(frozenset((a, b)))

    def heal(self, a: str | None = None, b: str | None = None):
        with self._lock:
            if a is None:
                self.partitions.clear()
            else:
                self.partitions.discard(frozenset((a, b)))

    def isolate(self, address: str):
        """Partition one node from every other registered node."""
        with self._lock:
            for other in self.nodes:
                if other != address:
                    self.partitions.add(frozenset((address, other)))

    def is_blocked(self, a: str, b: str) -> bool:
        return frozenset((a, b)) in self.partitions

    def addresses(self) -> list[str]:
        return sorted(self.nodes)


DEFAULT_REGISTRY = LocalTransportRegistry()


class LocalTransport:
    def __init__(self, address: str, registry: LocalTransportRegistry | None = None):
        self.address = address
        self.registry = registry or DEFAULT_REGISTRY
        self.service = None
        self._pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix=f"estpu_torch-local-transport[{address}]")
        self._closed = False

    def bind(self, service):
        self.service = service
        self.registry.register(self.address, self)

    def send(self, node, action: str, request, fut: Future):
        address = getattr(node, "transport_address", node)
        if self.registry.is_blocked(self.address, address):
            self.registry.dropped_count += 1
            complete_fut(fut, error=NodeNotConnectedError(
                f"[{address}] dropped (partition)"))
            return
        target = self.registry.nodes.get(address)
        if target is None or target._closed:
            complete_fut(fut, error=NodeNotConnectedError(f"no node at [{address}]"))
            return

        def respond(response, error):
            # the answer crosses the simulated wire too
            if self.registry.is_blocked(self.address, address):
                self.registry.dropped_count += 1
                complete_fut(fut, error=NodeNotConnectedError(
                    f"[{address}] response dropped"))
                return
            if error is not None:
                complete_fut(fut, error=error)
            else:
                complete_fut(fut, response)

        channel = TransportChannel(respond)

        def deliver():
            if target._closed or target.service is None:
                channel.send_failure(NodeNotConnectedError(f"node [{address}] closed"))
                return
            target.service.dispatch(action, request, channel)

        try:
            target._pool.submit(deliver)
        except RuntimeError:
            complete_fut(fut, error=NodeNotConnectedError(f"node [{address}] shut down"))

    def close(self):
        self._closed = True
        self.registry.unregister(self.address)
        self._pool.shutdown(wait=False, cancel_futures=True)
