"""TCP transport backend (a copy of the JAX package's `transport/tcp.py`):
length-prefixed binary frames over TCP sockets between processes, with
typed connection pools per remote node (recovery, bulk, reg, state, ping)
and optional zlib compression of payloads from 1 KiB. Every payload is
encoded with the port's wire codec (common/stream.py), so a port node's
frames are byte for byte the JAX package's, and the TCP and local backends
are the same above the socket layer.

Frame layout (cf. transport/netty/SizeHeaderFrameDecoder.java):

    2B magic b"ET" | 1B flags | 4B big-endian payload length | payload

flags bit0 = response, bit1 = error-response, bit2 = zlib-compressed payload.
Request payload  = {id, action, body}; response = {id, body};
error response   = {id, error: {type, message}} — the error type is re-raised as the
matching class of the port's common.errors on the caller (a type it lacks
becomes a TransportError naming it).

A handler runs on a dispatch pool, never on a connection's reader thread,
so a blocked handler does not stall the frames behind it. A connection
that closes fails every request still in flight on it; a request's
pending entry is reaped however its future resolves.
"""

from __future__ import annotations

import socket
import struct
import threading
import zlib
from concurrent.futures import Future, ThreadPoolExecutor

from ..common import errors as _errors_mod
from ..common.errors import (
    NodeNotConnectedError,
    SearchEngineError,
    TransportError,
)
from ..common.logging import get_logger
from ..common.stream import StreamInput, StreamOutput
from .service import TransportChannel, complete_fut

MAGIC = b"ET"
FLAG_RESPONSE = 1
FLAG_ERROR = 2
FLAG_COMPRESSED = 4
HEADER = struct.Struct(">2sBI")
COMPRESS_MIN_BYTES = 1024  # below this, compression is overhead

# typed connection-pool sizes per remote node
CONNECTION_POOLS = {"ping": 1, "state": 1, "recovery": 2, "bulk": 3, "reg": 3}

# Error type name -> class, for reconstructing remote failures locally.
_ERROR_CLASSES = {
    name: cls for name, cls in vars(_errors_mod).items()
    if isinstance(cls, type) and issubclass(cls, Exception)
}


def _pool_for(action: str) -> str:
    """The connection pool an action's frames travel on."""
    if "recovery" in action:
        return "recovery"
    if "bulk" in action:
        return "bulk"
    if action.endswith("/ping") or "/fd/" in action:
        return "ping"
    if "publish" in action or "cluster/state" in action:
        return "state"
    return "reg"


def _encode(payload, flags: int, compress: bool) -> bytes:
    out = StreamOutput()
    out.write_value(payload)
    body = out.bytes()
    if compress and len(body) >= COMPRESS_MIN_BYTES:
        body = zlib.compress(body, 1)
        flags |= FLAG_COMPRESSED
    return HEADER.pack(MAGIC, flags, len(body)) + body


def _decode_body(body: bytes, flags: int):
    if flags & FLAG_COMPRESSED:
        body = zlib.decompress(body)
    return StreamInput(body).read_value()


def _error_payload(error: Exception) -> dict:
    return {"type": type(error).__name__, "message": str(error)}


def _rebuild_error(d: dict) -> Exception:
    cls = _ERROR_CLASSES.get(d.get("type"))
    msg = d.get("message", "")
    if cls is None:
        return TransportError(f"[{d.get('type')}] {msg}")
    try:
        return cls(msg)
    except TypeError:  # error classes with required extra args degrade to message-only
        return TransportError(f"[{d.get('type')}] {msg}")


def _read_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class _Connection:
    """One TCP socket with a framed writer and a reader thread."""

    def __init__(self, sock: socket.socket, on_frame, on_close, name: str):
        self.sock = sock
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()
        self._on_frame = on_frame
        self._on_close = on_close
        self.closed = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True, name=name)
        self._reader.start()

    def write_frame(self, frame: bytes):
        with self._wlock:
            self.sock.sendall(frame)

    def _read_loop(self):
        try:
            while True:
                header = _read_exact(self.sock, HEADER.size)
                if header is None:
                    break
                magic, flags, length = HEADER.unpack(header)
                if magic != MAGIC:
                    break  # protocol corruption: drop the connection
                body = _read_exact(self.sock, length)
                if body is None:
                    break
                self._on_frame(self, flags, _decode_body(body, flags))
        except (OSError, ValueError):
            pass
        finally:
            self.close()

    def close(self):
        if self.closed:
            return
        self.closed = True
        try:
            self.sock.close()
        except OSError:
            pass
        self._on_close(self)


class TcpTransport:
    """Socket transport. The listening socket binds in __init__, so the node
    knows its published address (host:port) before it builds its
    DiscoveryNode."""

    # payloads are encoded for real: the service skips its codec round trip
    serializes = True

    def __init__(self, host: str = "127.0.0.1", port: int = 0, compress: bool = False):
        self.logger = get_logger("transport.tcp")
        self.compress = compress
        self.service = None
        self._closed = False
        self._req_ids = iter(range(1, 2**62))
        self._id_lock = threading.Lock()
        # address -> pool name -> list[_Connection] (lazily dialed)
        self._outbound: dict[str, dict[str, list[_Connection]]] = {}
        self._outbound_lock = threading.Lock()
        # per-(address, pool) dial locks so one unreachable peer can't stall
        # outbound traffic to every other node
        self._dial_locks: dict[tuple[str, str], threading.Lock] = {}
        # handlers run on workers, never on connection reader threads: a
        # blocked handler must not stall the frames multiplexed behind it
        self._dispatch_pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="estpu_torch-tcp-dispatch")
        self._pending: dict[int, tuple[Future, _Connection]] = {}
        self._pending_lock = threading.Lock()
        self._inbound: set[_Connection] = set()
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen(128)
        self.address = "%s:%d" % self._server.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"estpu_torch-tcp-accept[{self.address}]")
        self._accept_thread.start()

    # ----------------------------------------------------------------- server side
    def _accept_loop(self):
        while not self._closed:
            try:
                sock, peer = self._server.accept()
            except OSError:
                return
            conn = _Connection(sock, self._on_server_frame, self._inbound.discard,
                               name=f"estpu_torch-tcp-rx[{peer[0]}:{peer[1]}]")
            self._inbound.add(conn)

    def _on_server_frame(self, conn: _Connection, flags: int, payload):
        if flags & FLAG_RESPONSE:
            return  # responses never arrive on inbound connections
        req_id, action, body = payload["id"], payload["action"], payload.get("body")

        def respond(response, error):
            resp_flags = FLAG_RESPONSE
            if error is not None:
                resp_flags |= FLAG_ERROR
                out = {"id": req_id, "error": _error_payload(error)}
            else:
                out = {"id": req_id, "body": response}
            try:
                conn.write_frame(_encode(out, resp_flags, self.compress))
            except OSError:
                conn.close()

        if self.service is None:
            respond(None, TransportError("transport not bound yet"))
            return
        channel = TransportChannel(respond)
        try:
            self._dispatch_pool.submit(self.service.dispatch, action, body, channel)
        except RuntimeError:  # pool shut down
            respond(None, NodeNotConnectedError("transport closed"))

    # ----------------------------------------------------------------- client side
    def _on_client_frame(self, conn: _Connection, flags: int, payload):
        if not flags & FLAG_RESPONSE:
            return
        with self._pending_lock:
            entry = self._pending.pop(payload.get("id"), None)
        if entry is None:
            return
        fut = entry[0]
        # a response timeout may have failed this future already: a late
        # frame is dropped
        if flags & FLAG_ERROR:
            complete_fut(fut, error=_rebuild_error(payload.get("error", {})))
        else:
            complete_fut(fut, payload.get("body"))

    def _on_conn_closed(self, conn: _Connection):
        """Fail every request still in flight on a dead connection."""
        with self._pending_lock:
            dead = [rid for rid, (_, c) in self._pending.items() if c is conn]
            entries = [self._pending.pop(rid) for rid in dead]
        for fut, _ in entries:
            complete_fut(fut, error=NodeNotConnectedError("connection closed"))

    def _connection(self, address: str, pool: str) -> _Connection:
        with self._outbound_lock:
            pools = self._outbound.setdefault(address, {})
            conns = pools.setdefault(pool, [])
            conns[:] = [c for c in conns if not c.closed]
            if len(conns) >= CONNECTION_POOLS[pool]:
                # round-robin within the pool by rotating
                conns.append(conns.pop(0))
                return conns[-1]
            dial_lock = self._dial_locks.setdefault((address, pool), threading.Lock())
        # dial outside the global lock (an unreachable peer may block for the
        # whole connect timeout); the per-target lock keeps concurrent
        # senders from over-dialing the same pool
        with dial_lock:
            with self._outbound_lock:
                conns = self._outbound.setdefault(address, {}).setdefault(pool, [])
                conns[:] = [c for c in conns if not c.closed]
                if conns and len(conns) >= CONNECTION_POOLS[pool]:
                    conns.append(conns.pop(0))
                    return conns[-1]
            host, _, port_s = address.rpartition(":")
            try:
                sock = socket.create_connection((host, int(port_s)), timeout=5.0)
                sock.settimeout(None)
            except (OSError, ValueError) as e:
                raise NodeNotConnectedError(f"connect to [{address}] failed: {e}") from e
            conn = _Connection(sock, self._on_client_frame, self._on_conn_closed,
                               name=f"estpu_torch-tcp-tx[{address}][{pool}]")
            with self._outbound_lock:
                self._outbound.setdefault(address, {}).setdefault(pool, []).append(conn)
            return conn

    # ------------------------------------------------------------- backend interface
    def bind(self, service):
        self.service = service

    def send(self, node, action: str, request, fut: Future):
        address = getattr(node, "transport_address", node)
        if self._closed:
            complete_fut(fut, error=NodeNotConnectedError("transport closed"))
            return
        with self._id_lock:
            req_id = next(self._req_ids)
        try:
            conn = self._connection(address, _pool_for(action))
        except SearchEngineError as e:
            complete_fut(fut, error=e)
            return
        with self._pending_lock:
            self._pending[req_id] = (fut, conn)
        # reap the pending entry however the future resolves (a frame, a
        # closed connection, a response timeout, an injected drop)
        fut.add_done_callback(lambda _f, rid=req_id: self._reap_pending(rid))
        frame = _encode({"id": req_id, "action": action, "body": request},
                        0, self.compress)
        # the in-flight breaker is charged the frame's real bytes, through
        # the service's one charge site
        try:
            self.service._charge_in_flight(frame, action, fut)
        except SearchEngineError as e:
            complete_fut(fut, error=e)
            return
        try:
            conn.write_frame(frame)
        except OSError as e:
            conn.close()
            complete_fut(fut, error=NodeNotConnectedError(
                f"send to [{address}] failed: {e}"))

    def _reap_pending(self, req_id: int):
        with self._pending_lock:
            self._pending.pop(req_id, None)

    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            self._server.close()
        except OSError:
            pass
        with self._outbound_lock:
            conns = [c for pools in self._outbound.values()
                     for cs in pools.values() for c in cs]
            self._outbound.clear()
        for c in conns:
            c.close()
        for c in list(self._inbound):
            c.close()
        self._dispatch_pool.shutdown(wait=False, cancel_futures=True)
