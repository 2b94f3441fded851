"""In-process transport backend (a trimmed copy of the JAX package's
`transport/local.py`): nodes in one process exchange messages through a
shared registry, delivered on the target's worker thread (never inline).

The port keeps a registry of its own (`DEFAULT_REGISTRY` here, never the JAX
package's), so a process that runs a node of each package never routes a
message from one to the other. Partitions and isolation belong to the slice
with two nodes."""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor

from ..common.errors import NodeNotConnectedError
from .service import TransportChannel, complete_fut


class LocalTransportRegistry:
    """One registry = one simulated network."""

    def __init__(self):
        self.nodes: dict[str, "LocalTransport"] = {}
        self._lock = threading.Lock()

    def register(self, address: str, transport: "LocalTransport"):
        with self._lock:
            self.nodes[address] = transport

    def unregister(self, address: str):
        with self._lock:
            self.nodes.pop(address, None)


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
        target = self.registry.nodes.get(address)
        if target is None or target._closed:
            complete_fut(fut, error=NodeNotConnectedError(f"no node at [{address}]"))
            return

        def respond(response, error):
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
