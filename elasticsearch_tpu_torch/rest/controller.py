"""REST layer: path-template routing and the handlers of the one-node slice
(a trimmed copy of the JAX package's `rest/controller.py`).

Routes: `GET /`, `PUT|POST /{index}`, `PUT|POST /{index}/{type}/{id}`,
`POST /{index}/{type}`, `_bulk` NDJSON (at `/`, `/{index}` and
`/{index}/{type}`), `_refresh`, `GET /_cluster/health` and `_search` (at
`/`, `/{index}` and `/{index}/{type}`, GET or POST). A route that is not
ported answers 400 "No handler found", as the JAX controller answers an
unknown route; a missing index answers 404. Handlers call the node Client:
REST is a thin adapter, as in the JAX package."""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass, field as dc_field
from typing import Callable

from ..common.errors import IllegalArgumentError, SearchEngineError

VERSION = "0.2.0"


@dataclass
class RestRequest:
    method: str
    path: str
    params: dict = dc_field(default_factory=dict)
    body: dict | list | str | None = None
    path_params: dict = dc_field(default_factory=dict)

    def param(self, name: str, default=None):
        # a bare `?from` token reads as absent for valued params
        v = self.path_params.get(name) or self.params.get(name)
        return default if v is None or v == "" else v

    def bool_param(self, name: str, default=False) -> bool:
        if name not in self.params and not self.path_params.get(name):
            return default
        v = self.path_params.get(name) or self.params.get(name)
        return str(v).lower() in ("true", "1", "")


@dataclass
class RestResponse:
    status: int
    body: object
    content_type: str = "application/json"
    headers: dict = dc_field(default_factory=dict)  # e.g. Retry-After on 429

    def payload(self) -> bytes:
        if isinstance(self.body, bytes):
            return self.body
        if isinstance(self.body, str):
            return self.body.encode()
        return json.dumps(self.body).encode()


class RestController:
    """register(method, "/{index}/{type}/_search", handler) + dispatch."""

    def __init__(self):
        self._routes: dict[str, list[tuple[re.Pattern, list[str], Callable]]] = {}

    def register(self, method: str, template: str, handler: Callable):
        names = re.findall(r"\{(\w+)\}", template)
        pattern = re.sub(r"\{(\w+)\}", r"([^/]+)", template.rstrip("/") or "/")
        compiled = re.compile("^" + pattern + "/?$")
        for m in method.split(","):
            self._routes.setdefault(m.strip().upper(), []).append(
                (compiled, names, handler))

    def dispatch(self, request: RestRequest) -> RestResponse:
        routes = self._routes.get(request.method, []) + (
            self._routes.get("GET", []) if request.method == "HEAD" else [])
        path = request.path.rstrip("/") or "/"
        best = None
        for pattern, names, handler in routes:
            m = pattern.match(path)
            # the route with the fewest wildcards wins (a literal beats {index})
            if m and (best is None or len(names) < best[0]):
                best = (len(names), m, names, handler)
        if best is None:
            return RestResponse(400, {"error": f"No handler found for uri [{request.path}] "
                                               f"and method [{request.method}]"})
        _, m, names, handler = best
        request.path_params = dict(zip(names, m.groups()))
        try:
            result = handler(request)
            return result if isinstance(result, RestResponse) else RestResponse(200, result)
        except SearchEngineError as e:
            headers = {}
            if e.status == 429:
                headers["Retry-After"] = str(max(
                    1, int(math.ceil(getattr(e, "retry_after_s", 1.0)))))
            return RestResponse(e.status, {"error": e.to_dict(), "status": e.status},
                                headers=headers)
        except Exception as e:  # noqa: BLE001 — a device error is a 500 with the error
            return RestResponse(500, {"error": {"type": type(e).__name__,
                                                "reason": str(e)}, "status": 500})


def _parse_body(request: RestRequest) -> dict:
    if request.body is None or request.body == "":
        return {}
    if isinstance(request.body, (dict, list)):
        return request.body
    try:
        return json.loads(request.body)
    except ValueError:
        return json.loads(_lenient_to_strict_json(request.body))


def _lenient_to_strict_json(text: str) -> str:
    """The reference's JSON parser accepts unquoted field names and
    single-quoted strings; rewrite such input to strict JSON."""
    out = []
    i, n = 0, len(text)
    bare = re.compile(r"[A-Za-z_$][A-Za-z0-9_$.\-]*")
    number = re.compile(r"-?\d+(\.\d+)?([eE][+-]?\d+)?")
    while i < n:
        c = text[i]
        if c == "-" or c.isdigit():
            m = number.match(text, i)
            if m:
                out.append(m.group(0))
                i = m.end()
                continue
        if c == '"':  # standard string: copy verbatim incl. escapes
            j = i + 1
            while j < n:
                if text[j] == "\\":
                    j += 2
                    continue
                if text[j] == '"':
                    break
                j += 1
            out.append(text[i:j + 1])
            i = j + 1
        elif c == "'":  # single-quoted string → double-quoted
            j = i + 1
            buf = []
            while j < n and text[j] != "'":
                if text[j] == "\\" and j + 1 < n:
                    buf.append(text[j:j + 2])
                    j += 2
                    continue
                buf.append(text[j])
                j += 1
            out.append(json.dumps("".join(buf)))
            i = j + 1
        else:
            m = bare.match(text, i)
            if m:
                tok = m.group(0)
                out.append(tok if tok in ("true", "false", "null") else json.dumps(tok))
                i = m.end()
            else:
                out.append(c)
                i += 1
    return "".join(out)


_BULK_OPS = ("index", "create", "update", "delete")

# `_search` query parameters the JAX node serves and this slice does not
_LATER_SEARCH_PARAMS = ("q", "scroll", "sort", "fields", "profile",
                        "request_cache", "preference", "trace")


def build_rest_controller(node) -> RestController:
    client = node.client()
    rc = RestController()

    def root(req):
        return {"status": 200, "name": node.name,
                "version": {"number": VERSION, "build_snapshot": True,
                            "lucene_version": VERSION},
                "tagline": "You Know, for Search (PyTorch/CUDA port)"}

    rc.register("GET,HEAD", "/", root)

    def doc_index(req):
        r = client.index(
            req.path_params["index"], req.path_params["type"], _parse_body(req),
            id=req.path_params.get("id"), routing=req.param("routing"),
            version=int(req.param("version")) if req.param("version") else None,
            version_type=req.param("version_type", "internal"),
            op_type=req.param("op_type", "index"), refresh=req.bool_param("refresh"))
        return RestResponse(201 if r.get("created") else 200, r)

    rc.register("PUT,POST", "/{index}/{type}/{id}", doc_index)
    rc.register("POST", "/{index}/{type}", doc_index)

    def bulk(req):
        # one stream of parsed JSON objects from every accepted body shape
        # (an NDJSON string, a list of strings, a list of objects)
        stream = []
        if isinstance(req.body, list):
            for item in req.body:
                if isinstance(item, str):
                    stream.extend(json.loads(ln) for ln in item.split("\n") if ln.strip())
                else:
                    stream.append(item)
        else:
            raw = req.body if isinstance(req.body, str) else ""
            stream = [json.loads(ln) for ln in raw.split("\n") if ln.strip()]
        operations = []
        i = 0
        while i < len(stream):
            action = stream[i]
            if not isinstance(action, dict) or len(action) != 1 \
                    or next(iter(action)) not in _BULK_OPS:
                raise IllegalArgumentError(
                    f"Malformed action/metadata line [{i + 1}], expected one of {_BULK_OPS}")
            (op, meta), = action.items()
            meta = dict(meta) if isinstance(meta, dict) else {}
            meta.setdefault("_index", req.path_params.get("index"))
            meta.setdefault("_type", req.path_params.get("type", "_default_"))
            entry = {"action": {op: meta}}
            i += 1
            if op != "delete":
                entry["source"] = stream[i] if i < len(stream) else {}
                i += 1
            operations.append(entry)
        return client.bulk(operations, refresh=req.bool_param("refresh"))

    rc.register("POST,PUT", "/_bulk", bulk)
    rc.register("POST,PUT", "/{index}/_bulk", bulk)
    rc.register("POST,PUT", "/{index}/{type}/_bulk", bulk)

    def search_body(req):
        body = dict(_parse_body(req))
        for p in ("from", "size"):
            if req.param(p) is not None:
                body[p] = int(req.param(p))
        if req.param("_source") is not None:
            sp = req.param("_source")
            body["_source"] = sp == "true" if sp in ("true", "false") \
                else str(sp).split(",")
        if req.param("_source_include") or req.param("_source_exclude"):
            body["_source"] = {
                "includes": str(req.param("_source_include")).split(",")
                if req.param("_source_include") else [],
                "excludes": str(req.param("_source_exclude")).split(",")
                if req.param("_source_exclude") else []}
        if req.param("timeout") is not None:
            body["timeout"] = req.param("timeout")
        return body

    def search(req):
        later = [p for p in _LATER_SEARCH_PARAMS if req.param(p) is not None]
        if later or req.param("search_type", "query_then_fetch") != "query_then_fetch":
            raise IllegalArgumentError(
                f"search parameter(s) {later or ['search_type']} are not ported "
                "yet (a later slice of the port): query strings, scrolls, "
                "sorting, fields, profiles, the request cache and search types "
                "other than query_then_fetch")
        return client.search(req.path_params.get("index", "_all"), search_body(req),
                             routing=req.param("routing"))

    rc.register("GET,POST", "/{index}/_search", search)
    rc.register("GET,POST", "/{index}/{type}/_search", search)
    rc.register("GET,POST", "/_search", search)

    rc.register("PUT,POST", "/{index}",
                lambda r: client.create_index(r.path_params["index"], _parse_body(r)))
    rc.register("POST,GET", "/_refresh", lambda r: client.refresh(None))
    rc.register("POST,GET", "/{index}/_refresh",
                lambda r: client.refresh(r.path_params["index"]))
    rc.register("GET", "/_cluster/health",
                lambda r: client.cluster_health(
                    wait_for_status=r.param("wait_for_status"),
                    timeout=float(str(r.param("timeout", "10")).rstrip("s"))))
    rc.register("GET", "/_cluster/health/{index}",
                lambda r: client.cluster_health(index=r.path_params["index"]))
    return rc
