"""TransportService: action-string-keyed async RPC (a trimmed copy of the
JAX package's `transport/service.py`).

A handler registry (`register_handler(action, fn, executor)`),
`send_request(node, action, body)` returning a Future and the blocking
`submit_request`. Every message and every response round-trips through the
wire codec (`common/stream.py`) even in-process, so a payload the TCP
transport could not carry fails here too. The encoded request is reserved
on the `in_flight_requests` breaker until its response future resolves.

A request sent from a thread that carries a sampled span
(common/tracing.py) is wrapped in a `transport[<action>]` span, and its
trace context rides the payload under `_trace` (a tagged value of the
codec); the span ends when the response future resolves.

Not in this slice: the fault-injection policy, the per-request response
timer and the backstop sweep of stale reservations (every in-process
future resolves: a handler answers or fails)."""

from __future__ import annotations

from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Callable

from ..common import tracing
from ..common.errors import (
    ActionNotFoundError,
    ReceiveTimeoutError,
    SearchEngineError,
    TransportError,
)
from ..common.logging import get_logger
from ..common.stream import StreamInput, StreamOutput


def fut_result(fut: Future, timeout: float | None = 30.0):
    """Await a transport future; a timeout is a ReceiveTimeoutError."""
    try:
        return fut.result(timeout=timeout)
    except (TimeoutError, FutureTimeoutError):
        raise ReceiveTimeoutError("request timed out") from None


def complete_fut(fut: Future, result=None, error: Exception | None = None) -> bool:
    """Resolve a future exactly once; later resolutions are no-ops."""
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(result)
        return True
    except InvalidStateError:
        return False


class TransportRequestHandler:
    """Handler signature: fn(request_dict, channel) — respond through the
    channel, or return a dict to respond with it."""

    def __init__(self, fn: Callable, executor: str = "same"):
        self.fn = fn
        self.executor = executor


class TransportChannel:
    def __init__(self, respond: Callable[[dict | None, Exception | None], None]):
        self._respond = respond
        self._done = False

    def send_response(self, response: dict | None):
        if not self._done:
            self._done = True
            self._respond(response, None)

    def send_failure(self, error: Exception):
        if not self._done:
            self._done = True
            self._respond(None, error)


def _encode(payload: Any) -> bytes:
    out = StreamOutput()
    out.write_value(payload)
    return out.bytes()


def _roundtrip(payload: Any) -> Any:
    return StreamInput(_encode(payload)).read_value()


class TransportService:
    def __init__(self, backend, local_node=None, threadpool=None):
        self.backend = backend
        self.local_node = local_node
        self.threadpool = threadpool
        self.handlers: dict[str, TransportRequestHandler] = {}
        self.logger = get_logger("transport")
        # the node's in_flight_requests breaker (None: unaccounted)
        self.in_flight_breaker = None
        # messages sent and received (`/_nodes/stats` transport)
        self.stats = {"rx_count": 0, "tx_count": 0}
        backend.bind(self)

    def register_handler(self, action: str, fn: Callable, executor: str = "same"):
        self.handlers[action] = TransportRequestHandler(fn, executor)

    def _is_local(self, node) -> bool:
        address = getattr(node, "transport_address", node)
        return self.local_node is not None and \
            address == self.local_node.transport_address

    def send_request(self, node, action: str, request: dict) -> Future:
        """Dispatch `request` to `node`; the Future resolves to the response
        (or its error)."""
        fut: Future = Future()
        self.stats["tx_count"] += 1
        # a sampled caller's trace context rides the payload; unsampled
        # requests pay one thread-local read
        parent_span = tracing.current_span()
        if parent_span:
            tspan = parent_span.child(f"transport[{action}]")
            request = {**request,
                       tracing.TRACE_WIRE_KEY: tracing.wire_context(tspan)}
            fut.add_done_callback(lambda _f: tspan.end())
        try:
            raw = _encode(request)
            self._charge_in_flight(len(raw), action, fut)
            payload = StreamInput(raw).read_value()
            if self._is_local(node):
                # self-addressed: past the backend, onto the generic pool
                def respond(response, error):
                    if error is not None:
                        complete_fut(fut, error=error)
                    else:
                        complete_fut(fut, _roundtrip(response))

                self.threadpool.submit("generic", self.dispatch, action,
                                       payload, TransportChannel(respond))
            else:
                self.backend.send(node, action, payload, fut)
        except SearchEngineError as e:
            complete_fut(fut, error=e)
        except Exception as e:  # noqa: BLE001
            complete_fut(fut, error=TransportError(str(e), cause=e))
        return fut

    def _charge_in_flight(self, size: int, action: str, fut: Future):
        """Reserve the encoded message's bytes until the response future
        resolves (released exactly once, by its done-callback). A trip
        raises CircuitBreakingError, which fails the future."""
        br = self.in_flight_breaker
        if br is None:
            return
        br.add_estimate_and_maybe_break(size, f"<transport_request>[{action}]")
        fut.add_done_callback(lambda _f: br.release(size))

    def submit_request(self, node, action: str, request: dict,
                       timeout: float | None = 30.0) -> dict:
        """Blocking convenience over send_request."""
        return fut_result(self.send_request(node, action, request), timeout)

    def dispatch(self, action: str, request: Any, channel: TransportChannel):
        """Run the action's handler on its executor; a bounded-queue rejection
        travels back as the response's error (a typed 429)."""
        self.stats["rx_count"] += 1
        handler = self.handlers.get(action)
        if handler is None:
            channel.send_failure(ActionNotFoundError(f"no handler for action [{action}]"))
            return

        def run():
            try:
                result = handler.fn(request, channel)
                if result is not None:
                    channel.send_response(result)
            except Exception as e:  # noqa: BLE001
                channel.send_failure(e)

        if handler.executor == "same":
            run()
            return
        try:
            self.threadpool.submit(handler.executor, run)
        except SearchEngineError as e:
            channel.send_failure(e)

    def close(self):
        self.backend.close()
