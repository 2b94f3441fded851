"""HTTP server: the REST surface over real sockets (a copy of the JAX
package's `http/server.py`): the standard library's ThreadingHTTPServer,
HTTP/1.1 keep-alive, one handler thread per connection.

Content negotiation both ways, as on the JAX node. A request body's format
comes from its Content-Type, else from sniffing its first bytes for SMILE
and CBOR; a SMILE, CBOR or YAML body decodes to objects here. A JSON body
is parsed here when it is one line (or its Content-Type says JSON);
multi-line bodies (the `_bulk` NDJSON) and lenient JSON reach their
handlers as text. A body that does not decode answers 400. The response
rides the request's format, or an explicit `?format=` (json, smile, cbor,
yaml); it is re-encoded only when the handler answered a dict or a list as
JSON, so the `_cat` text passes as it is. A response that does not encode
answers 500 with the encoding error, never a dropped connection."""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, unquote_plus, urlparse

from ..common import xcontent
from ..common.logging import get_logger
from ..rest.controller import RestController, RestRequest, RestResponse


def _request_format(raw_bytes: bytes, ctype: str) -> str | None:
    """The body's format: the Content-Type's, else SMILE or CBOR by their
    first bytes, else None (JSON or text)."""
    fmt = xcontent.from_content_type(ctype)
    if fmt is None and raw_bytes:
        sniffed = xcontent.detect(raw_bytes)
        if sniffed in (xcontent.SMILE, xcontent.CBOR):
            fmt = sniffed
    return fmt


def _parse_request_body(raw_bytes: bytes, ctype: str, fmt: str | None):
    if not raw_bytes:
        return ""
    if fmt in (xcontent.SMILE, xcontent.CBOR, xcontent.YAML):
        return xcontent.loads(raw_bytes, fmt)
    raw = raw_bytes.decode()
    if "json" in ctype or (raw.lstrip().startswith(("{", "["))
                           and "\n" not in raw.strip()):
        try:
            return json.loads(raw)
        except ValueError:
            return raw
    return raw


class _Server(ThreadingHTTPServer):
    # the standard library listens with a backlog of 5: a burst of clients
    # connecting at once (a search front end's connection pool) overflows it
    # and the kernel resets the connections it cannot queue
    request_queue_size = 1024


class HttpServer:
    def __init__(self, rest_controller: RestController, host: str = "127.0.0.1",
                 port: int = 9200):
        self.rest = rest_controller
        self.logger = get_logger("http")
        rest = self.rest

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _send(self, method: str, status: int, payload: bytes,
                      content_type: str = "application/json", headers=None):
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(payload)))
                for name, value in (headers or {}).items():
                    self.send_header(name, str(value))
                self.end_headers()
                if method != "HEAD":
                    self.wfile.write(payload)

            def _handle(self, method: str):
                parsed = urlparse(self.path)
                length = int(self.headers.get("Content-Length") or 0)
                raw_bytes = self.rfile.read(length) if length else b""
                ctype = self.headers.get("Content-Type", "")
                fmt = _request_format(raw_bytes, ctype)
                try:
                    body = _parse_request_body(raw_bytes, ctype, fmt)
                except Exception as e:  # noqa: BLE001 — a malformed body is a 400
                    self._send(method, 400, json.dumps({"error": {
                        "type": "parse_exception",
                        "reason": f"failed to parse request body: {e}"},
                        "status": 400}).encode())
                    return
                # a bare `?v` flag surfaces as "" (a truthy flag)
                params = dict(parse_qsl(parsed.query))
                for seg in parsed.query.split("&"):
                    if seg and "=" not in seg:
                        params.setdefault(unquote_plus(seg), "")
                request = RestRequest(method=method, path=parsed.path,
                                      params=params, body=body)
                response = rest.dispatch(request)
                out_fmt = xcontent.from_content_type(
                    "application/" + request.params.get("format", "")) or fmt
                try:
                    if (out_fmt and out_fmt != xcontent.JSON
                            and response.content_type == "application/json"
                            and isinstance(response.body, (dict, list))):
                        payload = xcontent.dumps(response.body, out_fmt)
                        content_type = xcontent.CONTENT_TYPES[out_fmt]
                    else:
                        payload = response.payload()
                        content_type = response.content_type
                except Exception as e:  # noqa: BLE001 — unencodable response → 500
                    response = RestResponse(500, {"error": {
                        "type": "serialization_exception", "reason": str(e)},
                        "status": 500})
                    payload = response.payload()
                    content_type = "application/json"
                self._send(method, response.status, payload, content_type,
                           response.headers)

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

            def do_PUT(self):
                self._handle("PUT")

            def do_DELETE(self):
                self._handle("DELETE")

            def do_HEAD(self):
                self._handle("HEAD")

            def log_message(self, fmt, *args):  # quiet
                pass

        self._server = _Server((host, port), Handler)
        self.port = self._server.server_port
        self.host = host
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True,
                                        name=f"estpu_torch[http:{self.port}]")
        self._thread.start()
        self.logger.info("http listening on %s:%d", self.host, self.port)
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
