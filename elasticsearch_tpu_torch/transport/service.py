"""TransportService: action-string-keyed async RPC (a copy of the JAX
package's `transport/service.py`).

A handler registry (`register_handler(action, fn, executor)`),
`send_request(node, action, body, timeout)` returning a Future and the
blocking `submit_request`, over a pluggable backend: the in-process
`LocalTransport` or the socket `TcpTransport` (transport/tcp.py). Every
message and every response round-trips through the wire codec
(`common/stream.py`) even in-process, so a payload the TCP transport could
not carry fails here too; the TCP backend encodes for real and skips the
round trip. The encoded request is reserved on the `in_flight_requests`
breaker until its response future resolves; a reservation whose response
never comes is failed by a lazy sweep after `INFLIGHT_BACKSTOP_S`.

A `timeout` on `send_request` arms a timer that fails the future with
ReceiveTimeoutError (a late response is dropped). A FaultPolicy
(transport/faults.py) installed on the service drops, delays, or fails a
send, or a receive in `dispatch`, by action and address.

A request sent from a thread that carries a sampled span
(common/tracing.py) is wrapped in a `transport[<action>]` span, and its
trace context rides the payload under `_trace` (a tagged value of the
codec); the span ends when the response future resolves.
"""

from __future__ import annotations

import threading
import time
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
    # a reservation older than this is failed by the next send's sweep
    INFLIGHT_BACKSTOP_S = 300.0

    def __init__(self, backend, local_node=None, threadpool=None):
        self.backend = backend
        self.local_node = local_node
        self.threadpool = threadpool
        self.handlers: dict[str, TransportRequestHandler] = {}
        self.logger = get_logger("transport")
        # messages sent and received, timed out and injected
        # (`/_nodes/stats` transport)
        self.stats = {"rx_count": 0, "tx_count": 0, "timed_out_count": 0,
                      "faults_injected": 0}
        # a FaultPolicy installed by a test (None: no faults)
        self.fault_policy = None
        # the node's in_flight_requests breaker (None: unaccounted)
        self.in_flight_breaker = None
        # outstanding reservations, future -> expiry (the backstop sweep)
        self._inflight: dict = {}
        self._inflight_lock = threading.Lock()
        backend.bind(self)

    def register_handler(self, action: str, fn: Callable, executor: str = "same"):
        self.handlers[action] = TransportRequestHandler(fn, executor)

    def _is_local(self, node) -> bool:
        address = getattr(node, "transport_address", node)
        return self.local_node is not None and \
            address == self.local_node.transport_address

    def send_request(self, node, action: str, request: dict,
                     timeout: float | None = None) -> Future:
        """Dispatch `request` to `node`; the Future resolves to the response
        (or its error). A `timeout` arms a timer that fails the future with
        ReceiveTimeoutError, for callers that park no thread on it (a
        blocking caller bounds its own wait in `fut_result`)."""
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
        if timeout is not None:
            self._arm_response_timeout(fut, action, timeout)
        try:
            rule = None if self.fault_policy is None else \
                self.fault_policy.decide(action, getattr(node, "transport_address",
                                                         node), request, "send")
            if rule is not None:
                self.stats["faults_injected"] += 1
                if self._apply_send_fault(rule, fut, node, action, request):
                    return fut
            self._send_now(node, action, request, fut)
        except SearchEngineError as e:
            complete_fut(fut, error=e)
        except Exception as e:  # noqa: BLE001
            complete_fut(fut, error=TransportError(str(e), cause=e))
        return fut

    def _charge_in_flight(self, raw: bytes, action: str, fut: Future):
        """Reserve the encoded message's bytes until the response future
        resolves (released exactly once, by its done-callback). A trip
        raises CircuitBreakingError, which fails the future. Reservations
        past their expiry are failed first (their callbacks release them),
        so a breaker full of lost responses cannot refuse every send."""
        br = self.in_flight_breaker
        if br is None:
            return
        now = time.monotonic()
        with self._inflight_lock:
            expired = [f for f, expiry in self._inflight.items() if expiry <= now]
        for f in expired:
            complete_fut(f, error=ReceiveTimeoutError(
                "in-flight reservation expired with no response "
                f"(> {self.INFLIGHT_BACKSTOP_S:.0f}s)"))
        size = len(raw)
        br.add_estimate_and_maybe_break(size, f"<transport_request>[{action}]")
        with self._inflight_lock:
            self._inflight[fut] = now + self.INFLIGHT_BACKSTOP_S

        def on_done(_f):
            br.release(size)
            with self._inflight_lock:
                self._inflight.pop(fut, None)

        fut.add_done_callback(on_done)

    def _send_now(self, node, action: str, request: dict, fut: Future):
        """Self-addressed: past the backend onto the generic pool, both ways
        through the codec. A backend that serializes (TCP) charges the
        breaker from its own frame; the in-process one from the bytes
        encoded here."""
        if self._is_local(node):
            raw = _encode(request)
            self._charge_in_flight(raw, action, fut)
            payload = StreamInput(raw).read_value()

            def respond(response, error):
                if error is not None:
                    complete_fut(fut, error=error)
                else:
                    complete_fut(fut, _roundtrip(response))

            self.threadpool.submit("generic", self.dispatch, action, payload,
                                   TransportChannel(respond))
            return
        if getattr(self.backend, "serializes", False):
            payload = request
        else:
            raw = _encode(request)
            self._charge_in_flight(raw, action, fut)
            payload = StreamInput(raw).read_value()
        self.backend.send(node, action, payload, fut)

    def _apply_send_fault(self, rule, fut: Future, node, action: str,
                          request: dict) -> bool:
        """Apply a send-side rule. True: the send was consumed (a drop, an
        error, or a delay that re-sends on a timer)."""
        if rule.kind == "drop":
            return True  # lost: only a response timeout resolves the future
        if rule.kind in ("disconnect", "error"):
            complete_fut(fut, error=rule.make_error())
            return True

        def fire():
            try:
                self._send_now(node, action, request, fut)
            except Exception as e:  # noqa: BLE001 — a timer thread must not die silent
                complete_fut(fut, error=TransportError(str(e), cause=e))

        t = threading.Timer(rule.delay_s, fire)
        t.daemon = True
        t.start()
        return True

    def _arm_response_timeout(self, fut: Future, action: str, timeout: float):
        def on_timeout():
            if complete_fut(fut, error=ReceiveTimeoutError(
                    f"[{action}] received no response within [{timeout}s]")):
                self.stats["timed_out_count"] += 1

        timer = threading.Timer(max(0.0, timeout), on_timeout)
        timer.daemon = True
        timer.start()
        fut.add_done_callback(lambda _f: timer.cancel())

    def submit_request(self, node, action: str, request: dict,
                       timeout: float | None = 30.0) -> dict:
        """Blocking convenience over send_request; the wait is bounded by
        `fut_result`, with no timer thread."""
        return fut_result(self.send_request(node, action, request), timeout)

    def dispatch(self, action: str, request: Any, channel: TransportChannel):
        """Run the action's handler on its executor; a bounded-queue rejection
        travels back as the response's error (a typed 429). A receive-side
        fault rule matches this node's own address."""
        self.stats["rx_count"] += 1
        rule = None if self.fault_policy is None else \
            self.fault_policy.decide(action, getattr(self.backend, "address", ""),
                                     request, "recv")
        if rule is not None:
            self.stats["faults_injected"] += 1
            if rule.kind == "drop":
                return  # the handler never runs: the sender's timeout shows it
            if rule.kind in ("disconnect", "error"):
                channel.send_failure(rule.make_error())
                return
            t = threading.Timer(rule.delay_s,
                                lambda: self._dispatch_now(action, request, channel))
            t.daemon = True
            t.start()
            return
        self._dispatch_now(action, request, channel)

    def _dispatch_now(self, action: str, request: Any, channel: TransportChannel):
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

        if handler.executor == "same" or self.threadpool is None:
            run()
            return
        try:
            self.threadpool.submit(handler.executor, run)
        except SearchEngineError as e:
            channel.send_failure(e)

    def close(self):
        self.backend.close()
