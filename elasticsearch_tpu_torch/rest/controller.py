"""REST layer: path-template routing and the handlers of the one-node slice
(a trimmed copy of the JAX package's `rest/controller.py`).

Routes: `GET /`, `PUT|POST /{index}`, `PUT|POST /{index}/{type}/{id}`
(with `?timestamp=` and `?ttl=`), `POST /{index}/{type}`, `PUT|POST
/{index}/{type}/{id}/_create` (409 when the id exists), `GET|HEAD
/{index}/{type}/{id}` (404 with `found: false` when missing; `?fields=`
answers the `fields` section, and the `_source` only when it names it or
`_source` is asked), `GET|HEAD /{index}/{type}/{id}/_source` (the bare
source, filtered by `_source_include` / `_source_exclude`), `POST
/{index}/{type}/{id}/_update` (`doc`, `upsert`, `doc_as_upsert`, a
`script` with `params` and `lang`, also as query parameters,
`retry_on_conflict`, `fields`), `_mget` (at `/`, `/{index}` and
`/{index}/{type}`, the `docs` or the `ids` form; the path's index and type
and the query parameters are each document's defaults), `DELETE
/{index}/_query` and `/{index}/{type}/_query` (delete-by-query, every type
of the index, as on the JAX node), `DELETE /{index}/{type}/{id}` (404 when
not found), `_bulk` NDJSON (at `/`, `/{index}` and
`/{index}/{type}`), `_refresh`, `_flush` and `_optimize` (at `/` and
`/{index}`), `GET /_cluster/health`, `_search` (at
`/`, `/{index}` and `/{index}/{type}`, GET or POST, with `?q=`,
`?search_type=` (the `dfs_` types run the DFS phase, any other is served as
`query_then_fetch`, as on the JAX node), `?preference=`,
`?request_cache=`, `?routing=`, `?scroll=`), the scroll API
(`GET|POST /_search/scroll[/{scroll_id}]`, `DELETE` to clear), `_msearch`
NDJSON (at `/` and `/{index}`), `_count` (at `/`, `/{index}` and
`/{index}/{type}`), `_percolate` and
`_percolate/count` (at `/{index}/{type}` and, for an existing document,
`/{index}/{type}/{id}`) and `_mpercolate` NDJSON (at `/`, `/{index}` and
`/{index}/{type}`), and the mapping API: `PUT|POST` `/{index}/{type}/_mapping`,
`/{index}/_mapping/{type}` and `/_mapping/{type}` (`_mappings` too), `GET`
`/_mapping`, `/{index}/_mapping`, `/{index}/{type}/_mapping`,
`/{index}/_mapping/{type}` and `/_mapping/{type}`; `_suggest` (at `/` and
`/{index}`), `/{index}/{type}/{id}/_explain` (with `?q=`, and the GET
section the `_source` parameters ask for), `_termvector` and
`_termvectors` of a document, `_mtermvectors` (at `/`, `/{index}` and
`/{index}/{type}`; the query parameters are each document's defaults) and
`/{index}/{type}/{id}/_mlt`. `?fields=` on `_search` reads as the body's
`fields`, on `_explain` as a GET's. Index administration: `DELETE` and
`HEAD /{index}`, `HEAD /{index}/{type}`, `_open`, `_close`, `_settings`
(GET and PUT, at `/` and `/{index}`, GET by a name expression),
`_aliases` (POST actions; GET), `_alias` and `_aliases/{name}` (PUT, POST,
DELETE, GET, HEAD), `_template` (PUT, POST, DELETE, GET), `_warmer` and
`_warmers` (at `/`, `/{index}` and `/{index}/{type}`), `_mapping/field`
(at four routes), `_validate/query` (the query parsed without the index:
`_shards.total` is 1, as on the JAX node), `_analyze` (an analyzer by name,
a tokenizer with filters, or a mapped field's analyzer; every token's type
reads `<ALPHANUM>`, as on the JAX node), `_cache/clear` (`?request=`,
`?filter=`) and `_gateway/snapshot` (a flush and a metadata persist; zero
`_shards`). `DELETE` of a mapping (at
`/{index}/{type}/_mapping` and `/{index}/_mapping/{type}`, `_mappings` too)
drops the types and deletes their documents. The `_search` parameters
`profile` and `trace` answer 400 naming their later slice. The
single-document index,
GET, HEAD and DELETE take `?parent=`, which routes the document when no
`routing` is given (a `_bulk` item's parent is ignored, as in the JAX
package; GET answers no `_parent` key over REST, as there). Every other
route of the JAX node answers 400 NotPortedError naming the slice that
brings it (`_LATER_ROUTES`), so that none falls through to a wider route
such as the document write; a route the JAX node lacks too answers 400 "No
handler found", as the JAX controller answers it; a missing index answers
404. Handlers call the node Client: REST is a thin adapter, as in the JAX
package.

The scroll is the JAX node's, kept as it is: a `?scroll=` search buffers the
top `max(size, 10) * 10` hits of one search (`from` 0) in a registry the
controller holds, and each `/_search/scroll` call pages `size` hits through
the buffer, reporting the buffer's length as `hits.total`; the keep-alive
is never enforced; `search_type=scan` answers its first page with no hits;
an id the registry does not hold answers 404 SearchContextMissingException.
`_msearch` runs each item on its header's `index` (`_all` when absent, the
path's index is not read, as on the JAX node) and renders a failed item's
error in its place."""

from __future__ import annotations

import json
import math
import re
import threading
import uuid
from dataclasses import dataclass, field as dc_field
from typing import Callable

from ..actions import filter_source, shape_get
from ..analysis.core import (
    _PARAMETRIC_FILTERS,
    TOKEN_FILTERS,
    TOKENIZERS,
    Analyzer,
    get_analyzer,
)
from ..common.errors import (
    IllegalArgumentError,
    NotPortedError,
    SearchContextMissingError,
    SearchEngineError,
)
from ..common.settings import Settings
from ..search.queries import parse_query

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

# `_search` query parameters the JAX node serves and the port does not yet:
# profiles and traces (A7)
_LATER_SEARCH_PARAMS = ("profile", "trace")

# Every (methods, route) of the JAX node that a port node does not serve
# yet, by the slice that brings it. Each answers 400 NotPortedError naming
# its slice, so that no such request falls through to a wider route (a
# POST to `/{index}/_close` would otherwise index a document of type
# `_close`). A slice that lands deletes its rows.
_LATER_ROUTES = {
    "A7, observability and the admin REST surface": [
        ("GET", "/_stats"), ("GET", "/{index}/_stats"),
        ("GET", "/_status"), ("GET", "/{index}/_status"),
        ("GET", "/_segments"), ("GET", "/{index}/_segments"),
        ("GET", "/_cluster/state"), ("GET", "/_cluster/state/{metric}"),
        ("GET", "/_cluster/state/{metric}/{index}"), ("GET", "/_cluster/pending_tasks"),
        ("GET", "/_cluster/stats"), ("GET", "/_cluster/stats/nodes/{node_id}"),
        ("POST", "/_shutdown"), ("POST", "/_cluster/nodes/_shutdown"),
        ("POST", "/_cluster/nodes/{node_id}/_shutdown"),
        ("PUT,GET", "/_cluster/settings"), ("POST", "/_cluster/reroute"),
        ("GET", "/_nodes"), ("GET", "/_nodes/stats"), ("GET", "/_nodes/stats/{metric}"),
        ("GET", "/_nodes/{node_id}/stats"), ("GET", "/_nodes/{node_id}/stats/{metric}"),
        ("GET", "/_cluster/nodes/hot_threads"), ("GET", "/_nodes/hot_threads"),
        ("GET", "/_insights/queries"), ("GET", "/_events"), ("GET", "/_traces"),
        ("GET", "/_tasks"), ("GET", "/_prometheus/metrics"),
        ("POST", "/_nodes/_local/profiler/start"), ("POST", "/_nodes/_local/profiler/stop"),
        ("GET", "/_cat"), ("GET", "/_cat/health"), ("GET", "/_cat/nodes"),
        ("GET", "/_cat/indices"), ("GET", "/_cat/shards"), ("GET", "/_cat/shards/{index}"),
        ("GET", "/_cat/master"), ("GET", "/_cat/allocation"),
        ("GET", "/_cat/allocation/{node_id}"), ("GET", "/_cat/count"),
        ("GET", "/_cat/count/{index}"), ("GET", "/_cat/aliases"),
        ("GET", "/_cat/aliases/{name}"), ("GET", "/_cat/pending_tasks"),
        ("GET", "/_cat/recovery"), ("GET", "/_cat/thread_pool"), ("GET", "/_cat/batcher"),
        ("GET", "/_cat/caches"), ("GET", "/_cat/segments"),
        ("GET", "/_cat/segments/{index}"), ("GET", "/_cat/events"),
    ],
    "A9, the sidecars": [
        ("PUT,POST,GET,DELETE", "/_snapshot/{repo}"), ("GET", "/_snapshot"),
        ("POST", "/_snapshot/{repo}/_verify"),
        ("PUT,GET,DELETE", "/_snapshot/{repo}/{snapshot}"),
        ("GET", "/_snapshot/{repo}/{snapshot}/_status"),
        ("POST", "/_snapshot/{repo}/{snapshot}/_restore"),
    ],
}


def _register_later_routes(rc: "RestController"):
    """A handler that answers 400 for every row of `_LATER_ROUTES`."""
    for slice_, routes in _LATER_ROUTES.items():
        for methods, template in routes:
            def refuse(req, template=template, slice_=slice_):
                raise NotPortedError(
                    f"[{req.method} {template}] is not ported yet (a later slice "
                    f"of the port: {slice_})")

            rc.register(methods, template, refuse)


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
            op_type=req.param("op_type", "index"), refresh=req.bool_param("refresh"),
            parent=req.param("parent"), timestamp=req.param("timestamp"),
            ttl=req.param("ttl"))
        return RestResponse(201 if r.get("created") else 200, r)

    rc.register("PUT,POST", "/{index}/{type}/{id}", doc_index)
    rc.register("POST", "/{index}/{type}", doc_index)

    def doc_create(req):
        r = client.create(req.path_params["index"], req.path_params["type"],
                          _parse_body(req), id=req.path_params["id"],
                          routing=req.param("routing"), parent=req.param("parent"),
                          version=int(req.param("version")) if req.param("version")
                          else None,
                          version_type=req.param("version_type", "internal"),
                          refresh=req.bool_param("refresh"),
                          timestamp=req.param("timestamp"), ttl=req.param("ttl"))
        return RestResponse(201, r)

    rc.register("PUT,POST", "/{index}/{type}/{id}/_create", doc_create)

    def render_get(req, r) -> RestResponse:
        """A GET response: 404 when not found; else the `fields` section
        `?fields=` asks for, and the `_source` unless `?_source=false` or
        `?fields=` leaves it out, filtered by `_source` patterns or
        `_source_include` / `_source_exclude`."""
        if not r["found"]:
            return RestResponse(404, {"_index": r.get("_index"),
                                      "_type": r.get("_type"),
                                      "_id": r.get("_id"), "found": False})
        src_param = req.param("_source")
        if src_param is not None and str(src_param).lower() == "false":
            src_param = False
        shaped = shape_get(r, req.param("fields"), src_param,
                           req.param("_source_include"), req.param("_source_exclude"))
        return RestResponse(200, {k: v for k, v in shaped.items() if k in (
            "_index", "_type", "_id", "_version", "found", "fields", "_source")})

    def doc_get(req):
        return render_get(req, client.get(
            req.path_params["index"], req.path_params["type"], req.path_params["id"],
            routing=req.param("routing"), parent=req.param("parent"),
            realtime=req.bool_param("realtime", True), refresh=req.bool_param("refresh")))

    rc.register("GET,HEAD", "/{index}/{type}/{id}", doc_get)

    def doc_source(req):
        r = client.get(req.path_params["index"], req.path_params["type"],
                       req.path_params["id"], routing=req.param("routing"),
                       parent=req.param("parent"),
                       realtime=req.bool_param("realtime", True),
                       refresh=req.bool_param("refresh"))
        if not r["found"]:
            return RestResponse(404, {"found": False})
        src = r["_source"]
        if req.param("_source_include") or req.param("_source_exclude"):
            src = filter_source(src, req.param("_source_include"),
                                req.param("_source_exclude"))
        return src

    rc.register("GET,HEAD", "/{index}/{type}/{id}/_source", doc_source)

    def doc_delete(req):
        r = client.delete(req.path_params["index"], req.path_params["type"],
                          req.path_params["id"], routing=req.param("routing"),
                          parent=req.param("parent"),
                          version=int(req.param("version")) if req.param("version")
                          else None,
                          version_type=req.param("version_type", "internal"),
                          refresh=req.bool_param("refresh"))
        return RestResponse(200 if r["found"] else 404, r)

    rc.register("DELETE", "/{index}/{type}/{id}", doc_delete)

    def doc_update(req):
        body = _parse_body(req)
        # `script` and `lang` may come as query parameters
        if req.param("script") is not None:
            body.setdefault("script", req.param("script"))
        if req.param("lang") is not None:
            body.setdefault("lang", req.param("lang"))
        return client.update(req.path_params["index"], req.path_params["type"],
                             req.path_params["id"], body,
                             routing=req.param("routing"), parent=req.param("parent"),
                             refresh=req.bool_param("refresh"),
                             fields=req.param("fields"), ttl=req.param("ttl"),
                             timestamp=req.param("timestamp"),
                             version=int(req.param("version"))
                             if req.param("version") else None,
                             version_type=req.param("version_type", "internal"),
                             retry_on_conflict=int(req.param("retry_on_conflict", 0)))

    rc.register("POST", "/{index}/{type}/{id}/_update", doc_update)

    def mget(req):
        body = _parse_body(req)
        default_index = body.get("index") or req.path_params.get("index")
        default_type = body.get("type") or req.path_params.get("type")
        docs = body.get("docs")
        if docs is None and "ids" in body:
            docs = [{"_index": default_index, "_type": default_type, "_id": i}
                    for i in body["ids"]]
        # the query parameters are each document's defaults
        source_param = req.param("_source")
        if source_param in ("true", "false"):
            source_param = source_param == "true"
        elif isinstance(source_param, str):
            source_param = source_param.split(",")
        if req.param("_source_include") or req.param("_source_exclude"):
            source_param = {
                "include": str(req.param("_source_include")).split(",")
                if req.param("_source_include") else [],
                "exclude": str(req.param("_source_exclude")).split(",")
                if req.param("_source_exclude") else []}
        for d in docs or []:
            if not d.get("_index") and default_index:
                d["_index"] = default_index
            if not d.get("_type") and default_type:
                d["_type"] = default_type
            if req.param("fields") is not None:
                d.setdefault("fields", str(req.param("fields")).split(","))
            if source_param is not None:
                d.setdefault("_source", source_param)
            if req.param("realtime") is not None:
                d.setdefault("realtime", req.bool_param("realtime", True))
            if req.param("refresh") is not None:
                d.setdefault("refresh", req.bool_param("refresh"))
            if req.param("routing") is not None:
                d.setdefault("routing", req.param("routing"))
        return client.mget(docs or [])

    rc.register("GET,POST", "/_mget", mget)
    rc.register("GET,POST", "/{index}/_mget", mget)
    rc.register("GET,POST", "/{index}/{type}/_mget", mget)

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
        if req.param("q"):
            body["query"] = {"query_string": {"query": req.param("q")}}
        for p in ("from", "size"):
            if req.param(p) is not None:
                body[p] = int(req.param(p))
        if req.param("sort"):
            # ?sort=field:order,... (a bare name sorts ascending)
            body["sort"] = [
                ({s.split(":")[0]: s.split(":")[1]} if ":" in s else s)
                for s in str(req.param("sort")).split(",")
            ]
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
        if req.param("fields") is not None:
            body["fields"] = str(req.param("fields")).split(",")
        if req.param("timeout") is not None:
            body["timeout"] = req.param("timeout")
        if req.param("request_cache") is not None:
            # overrides the cache's size-0 default (search/request_cache.py);
            # it rides the body to the shards
            body["request_cache"] = req.bool_param("request_cache")
        return body

    def search(req):
        later = [p for p in _LATER_SEARCH_PARAMS if req.param(p) is not None]
        if later:
            raise IllegalArgumentError(
                f"search parameter(s) {later} are not ported yet (later slices "
                "of the port: profiles and traces come with observability, A7)")
        body = search_body(req)
        index = req.path_params.get("index", "_all")
        search_type = req.param("search_type", "query_then_fetch")
        if req.param("scroll"):
            return scrolled_search(index, body, scan=search_type == "scan")
        return client.search(index, body, routing=req.param("routing"),
                             search_type=search_type,
                             preference=req.param("preference"))

    # scroll id -> (buffered hits, page size, next position)
    scrolls: dict[str, tuple] = {}
    scrolls_lock = threading.Lock()

    def scrolled_search(index, body, scan=False):
        r = client.search(index, {**body, "from": 0,
                                  "size": max(body.get("size", 10), 10) * 10})
        sid = uuid.uuid4().hex
        size = body.get("size", 10)
        hits = r["hits"]["hits"]
        with scrolls_lock:
            scrolls[sid] = (hits, size, 0 if scan else size)
        r["_scroll_id"] = sid
        r["hits"]["hits"] = [] if scan else hits[:size]
        return r

    def raw_scroll_id(req):
        """A body that is not JSON is the scroll id itself."""
        if isinstance(req.body, str) and req.body and \
                not req.body.lstrip().startswith("{"):
            return req.body.strip()
        return None

    def scroll(req):
        raw = raw_scroll_id(req)
        body = _parse_body(req) if raw is None else {}
        sid = (req.path_params.get("scroll_id") or body.get("scroll_id")
               or req.param("scroll_id") or raw)
        with scrolls_lock:
            if sid not in scrolls:
                raise SearchContextMissingError(0)
            hits, size, pos = scrolls[sid]
            scrolls[sid] = (hits, size, pos + size)
        return {"_scroll_id": sid, "hits": {"total": len(hits),
                                            "hits": hits[pos: pos + size]},
                "timed_out": False,
                "_shards": {"total": 1, "successful": 1, "failed": 0}}

    def clear_scroll(req):
        if req.path_params.get("scroll_id"):
            sids = req.path_params["scroll_id"].split(",")
        else:
            sids = _parse_body(req).get("scroll_id", [])
            if isinstance(sids, str):
                sids = sids.split(",")
        with scrolls_lock:
            for sid in sids:
                scrolls.pop(sid, None)
        return {"succeeded": True}

    rc.register("GET,POST", "/{index}/_search", search)
    rc.register("GET,POST", "/{index}/{type}/_search", search)
    rc.register("GET,POST", "/_search", search)
    rc.register("GET,POST", "/_search/scroll", scroll)
    rc.register("GET,POST", "/_search/scroll/{scroll_id}", scroll)
    rc.register("DELETE", "/_search/scroll", clear_scroll)
    rc.register("DELETE", "/_search/scroll/{scroll_id}", clear_scroll)

    def msearch(req):
        raw = req.body if isinstance(req.body, str) else ""
        lines = [ln for ln in raw.split("\n") if ln.strip()]
        return client.msearch([(json.loads(lines[i]), json.loads(lines[i + 1]))
                               for i in range(0, len(lines) - 1, 2)])

    rc.register("GET,POST", "/_msearch", msearch)
    rc.register("GET,POST", "/{index}/_msearch", msearch)

    def count(req):
        # routing and preference are not read, as on the JAX node
        return client.count(req.path_params.get("index", "_all"), search_body(req))

    def delete_by_query(req):
        return client.delete_by_query(req.path_params["index"], search_body(req))

    rc.register("DELETE", "/{index}/_query", delete_by_query)
    rc.register("DELETE", "/{index}/{type}/_query", delete_by_query)

    rc.register("GET,POST", "/_count", count)
    rc.register("GET,POST", "/{index}/_count", count)
    rc.register("GET,POST", "/{index}/{type}/_count", count)

    def suggest(req):
        return client.suggest(req.path_params.get("index", "_all"), _parse_body(req))

    rc.register("GET,POST", "/_suggest", suggest)
    rc.register("GET,POST", "/{index}/_suggest", suggest)

    def explain(req):
        body = _parse_body(req)
        if req.param("q"):
            body = {"query": {"query_string": {"query": req.param("q")}}}
        index, doc_type, doc_id = (req.path_params[k] for k in ("index", "type", "id"))
        out = client.explain(index, doc_type, doc_id, body)
        # `_source` and `fields` parameters attach the document's GET section
        if req.param("_source") is not None or req.param("_source_include") \
                or req.param("_source_exclude") or req.param("fields"):
            g = client.get(index, doc_type, doc_id, routing=req.param("routing"))
            if g.get("found"):
                rendered = render_get(req, g).body
                out["get"] = {"found": True, **{k: rendered[k] for k in
                                                ("fields", "_source") if k in rendered}}
        return out

    rc.register("GET,POST", "/{index}/{type}/{id}/_explain", explain)

    def termvector(req):
        fields = req.param("fields")
        return client.termvector(
            req.path_params["index"], req.path_params["type"], req.path_params["id"],
            routing=req.param("routing"),
            fields=fields.split(",") if fields else _parse_body(req).get("fields"),
            positions=req.bool_param("positions", True),
            offsets=req.bool_param("offsets", True),
            term_statistics=req.bool_param("term_statistics", False),
            field_statistics=req.bool_param("field_statistics", True))

    rc.register("GET,POST", "/{index}/{type}/{id}/_termvector", termvector)
    rc.register("GET,POST", "/{index}/{type}/{id}/_termvectors", termvector)

    def mtermvectors(req):
        body = _parse_body(req)
        ids = body.get("ids") or (
            str(req.param("ids")).split(",") if req.param("ids") else [])
        docs = body.get("docs", []) + [{"_id": i} for i in ids]
        for d in docs:
            d.setdefault("_index", req.path_params.get("index"))
            d.setdefault("_type", req.path_params.get("type", "_all"))
            # query parameters are each document's defaults
            for flag, default in (("term_statistics", False), ("field_statistics", True),
                                  ("positions", True), ("offsets", True)):
                if req.param(flag) is not None:
                    d.setdefault(flag, req.bool_param(flag, default))
            if req.param("routing") is not None:
                d.setdefault("routing", req.param("routing"))
            if req.param("fields") is not None:
                d.setdefault("fields", str(req.param("fields")).split(","))
        return client.mtermvectors(docs)

    rc.register("GET,POST", "/_mtermvectors", mtermvectors)
    rc.register("GET,POST", "/{index}/_mtermvectors", mtermvectors)
    rc.register("GET,POST", "/{index}/{type}/_mtermvectors", mtermvectors)

    def mlt(req):
        fields = req.param("mlt_fields")
        params = {k: int(req.param(k)) for k in
                  ("min_term_freq", "min_doc_freq", "max_query_terms")
                  if req.param(k) is not None}
        return client.mlt(
            req.path_params["index"], req.path_params["type"], req.path_params["id"],
            mlt_fields=fields.split(",") if fields else None,
            search_body=_parse_body(req) or None, routing=req.param("routing"),
            **params)

    rc.register("GET,POST", "/{index}/{type}/{id}/_mlt", mlt)

    def percolate(req):
        return node.percolator.percolate(
            req.path_params["index"], _parse_body(req),
            doc_type=req.path_params["type"],
            doc_id=req.param("id"),  # the path's, else `?id=`
            version=req.param("version"),
            percolate_index=req.param("percolate_index"),
            percolate_type=req.param("percolate_type"))

    def count_percolate(req):
        return node.percolator.count_percolate(
            req.path_params["index"], _parse_body(req), doc_type=req.path_params["type"],
            doc_id=req.path_params.get("id"))

    rc.register("GET,POST", "/{index}/{type}/_percolate", percolate)
    rc.register("GET,POST", "/{index}/{type}/{id}/_percolate", percolate)
    rc.register("GET,POST", "/{index}/{type}/_percolate/count", count_percolate)
    rc.register("GET,POST", "/{index}/{type}/{id}/_percolate/count", count_percolate)

    def mpercolate(req):
        raw = req.body if isinstance(req.body, str) else ""
        lines = [ln for ln in raw.split("\n") if ln.strip()]
        requests = [(json.loads(lines[i]), json.loads(lines[i + 1]))
                    for i in range(0, len(lines) - 1, 2)]
        return node.percolator.multi_percolate(
            requests, default_index=req.path_params.get("index"),
            default_type=req.path_params.get("type"))

    rc.register("GET,POST", "/_mpercolate", mpercolate)
    rc.register("GET,POST", "/{index}/_mpercolate", mpercolate)
    rc.register("GET,POST", "/{index}/{type}/_mpercolate", mpercolate)

    rc.register("PUT,POST", "/{index}",
                lambda r: client.create_index(r.path_params["index"], _parse_body(r)))
    rc.register("DELETE", "/{index}",
                lambda r: client.delete_index(r.path_params["index"]))
    rc.register("HEAD", "/{index}", lambda r: RestResponse(
        200 if client.exists_index(r.path_params["index"]) else 404, ""))
    rc.register("POST", "/{index}/_open", lambda r: client.open_index(r.path_params["index"]))
    rc.register("POST", "/{index}/_close",
                lambda r: client.close_index(r.path_params["index"]))
    rc.register("HEAD", "/{index}/{type}", lambda r: RestResponse(
        200 if client.exists_type(r.path_params["index"], r.path_params["type"])
        else 404, ""))

    def validate_query(req):
        body = _parse_body(req)
        try:
            parse_query(body.get("query"))
            return {"valid": True, "_shards": {"total": 1, "successful": 1, "failed": 0}}
        except SearchEngineError as e:
            return {"valid": False, "explanations": [{"error": str(e)}]}

    rc.register("GET,POST", "/{index}/_validate/query", validate_query)
    rc.register("GET,POST", "/_validate/query", validate_query)

    def get_field_mapping(req):
        return client.get_field_mapping(
            req.path_params.get("index"), req.path_params.get("type"),
            req.path_params.get("field"),
            include_defaults=req.bool_param("include_defaults"))

    rc.register("GET", "/_mapping/field/{field}", get_field_mapping)
    rc.register("GET", "/{index}/_mapping/field/{field}", get_field_mapping)
    rc.register("GET", "/_mapping/{type}/field/{field}", get_field_mapping)
    rc.register("GET", "/{index}/_mapping/{type}/field/{field}", get_field_mapping)

    rc.register("PUT", "/{index}/_settings",
                lambda r: client.update_settings(r.path_params["index"], _parse_body(r)))
    rc.register("PUT", "/_settings", lambda r: client.update_settings(None, _parse_body(r)))
    rc.register("GET", "/{index}/_settings",
                lambda r: client.get_settings(r.path_params["index"]))
    rc.register("GET", "/{index}/_settings/{name}",
                lambda r: client.get_settings(r.path_params["index"],
                                              r.path_params["name"]))
    rc.register("GET", "/_settings", lambda r: client.get_settings())
    rc.register("GET", "/_settings/{name}",
                lambda r: client.get_settings(None, r.path_params["name"]))

    rc.register("POST", "/_aliases", lambda r: client.update_aliases(_parse_body(r)))
    rc.register("GET", "/_aliases", lambda r: client.get_aliases())
    rc.register("GET", "/{index}/_aliases",
                lambda r: client.get_aliases(r.path_params["index"]))

    def put_alias(req):
        return client.update_aliases({"actions": [{"add": {
            "index": req.path_params.get("index", "_all"),
            "alias": req.path_params["name"], **_parse_body(req)}}]})

    def delete_alias(req):
        return client.update_aliases({"actions": [{"remove": {
            "index": req.path_params["index"], "alias": req.path_params["name"]}}]})

    def get_alias(req):
        return client.get_alias(req.path_params.get("index"), req.path_params.get("name"))

    def get_aliases(req):
        return client.get_aliases(req.path_params.get("index"),
                                  req.path_params.get("name"))

    def exists_alias(req):
        ok = client.exists_alias(req.path_params.get("index"), req.path_params.get("name"))
        return RestResponse(200 if ok else 404, "")

    for suffix in ("_alias", "_aliases"):
        rc.register("PUT,POST", "/{index}/" + suffix + "/{name}", put_alias)
        rc.register("PUT,POST", "/" + suffix + "/{name}", put_alias)
        rc.register("DELETE", "/{index}/" + suffix + "/{name}", delete_alias)
    rc.register("GET", "/_alias", get_alias)
    rc.register("GET", "/_alias/{name}", get_alias)
    rc.register("GET", "/{index}/_alias", get_alias)
    rc.register("GET", "/{index}/_alias/{name}", get_alias)
    rc.register("GET", "/_aliases/{name}", get_aliases)
    rc.register("GET", "/{index}/_aliases/{name}", get_aliases)
    rc.register("HEAD", "/_alias/{name}", exists_alias)
    rc.register("HEAD", "/{index}/_alias", exists_alias)
    rc.register("HEAD", "/{index}/_alias/{name}", exists_alias)

    rc.register("PUT,POST", "/_template/{name}",
                lambda r: client.put_template(r.path_params["name"], _parse_body(r)))
    rc.register("DELETE", "/_template/{name}",
                lambda r: client.delete_template(r.path_params["name"]))
    rc.register("GET", "/_template/{name}",
                lambda r: client.get_template(r.path_params["name"]))
    rc.register("GET", "/_template", lambda r: client.get_template())

    def put_warmer(req):
        return client.put_warmer(req.path_params.get("index"), req.path_params["name"],
                                 _parse_body(req), doc_type=req.path_params.get("type"))

    def get_warmer(req):
        return client.get_warmer(req.path_params.get("index"),
                                 req.path_params.get("name"))

    for suffix in ("_warmer", "_warmers"):
        rc.register("PUT,POST", "/" + suffix + "/{name}", put_warmer)
        rc.register("PUT,POST", "/{index}/" + suffix + "/{name}", put_warmer)
        rc.register("PUT,POST", "/{index}/{type}/" + suffix + "/{name}", put_warmer)
        rc.register("DELETE", "/{index}/" + suffix + "/{name}",
                    lambda r: client.delete_warmer(r.path_params["index"],
                                                   r.path_params["name"]))
    rc.register("GET", "/_warmer", get_warmer)
    rc.register("GET", "/_warmer/{name}", get_warmer)
    rc.register("GET", "/{index}/_warmer", get_warmer)
    rc.register("GET", "/{index}/_warmer/{name}", get_warmer)
    rc.register("GET", "/{index}/{type}/_warmer/{name}", get_warmer)

    def cache_clear(req):
        """`?request=` and `?filter=` select the tiers (both by default)."""
        kwargs = {}
        if req.param("request") is not None:
            kwargs["request"] = req.bool_param("request")
        if req.param("filter") is not None:
            kwargs["filter"] = req.bool_param("filter")
        return client.clear_cache(req.path_params.get("index"), **kwargs)

    rc.register("POST", "/_cache/clear", cache_clear)
    rc.register("POST", "/{index}/_cache/clear", cache_clear)

    def analyze(req):
        """An analyzer by name, a tokenizer with token filters, or a mapped
        field's analyzer when the path names an index."""
        body = _parse_body(req)
        text = body.get("text") or req.param("text") or (
            req.body if isinstance(req.body, str) and not req.body.startswith("{") else "")
        analyzer_name = body.get("analyzer") or req.param("analyzer")
        field = body.get("field") or req.param("field")
        tokenizer_name = body.get("tokenizer") or req.param("tokenizer")
        raw_filters = (body.get("filters") or body.get("token_filters")
                       or req.param("filters") or req.param("token_filters"))
        svc = None
        index = req.path_params.get("index")
        if index:
            names = node.cluster_service.state.metadata.resolve_indices(index)
            svc = node.indices.index_service(names[0])
        if tokenizer_name:
            tk = TOKENIZERS.get(tokenizer_name)
            if tk is None:
                raise IllegalArgumentError(f"unknown tokenizer [{tokenizer_name}]")
            names_list = ([f.strip() for f in str(raw_filters).split(",") if f.strip()]
                          if isinstance(raw_filters, str) else list(raw_filters or []))
            filters = []
            for fn in names_list:
                if fn in TOKEN_FILTERS:
                    filters.append(TOKEN_FILTERS[fn])
                elif fn in _PARAMETRIC_FILTERS:
                    filters.append(_PARAMETRIC_FILTERS[fn](Settings.EMPTY))
                else:
                    raise IllegalArgumentError(f"unknown token filter [{fn}]")
            a = Analyzer("_custom_", tk, filters)
        elif field and svc is not None:
            ms = svc.mapper_service
            ft = ms.field_type(field)
            if ft is not None and ft.is_text and ft.index == "not_analyzed":
                a = get_analyzer("keyword")
            elif ft is not None and ft.is_text:
                a = ms.analysis.analyzer(ft.analyzer)
            else:
                a = ms.analysis.analyzer("default")
        elif analyzer_name:
            a = (svc.mapper_service.analysis.analyzer(analyzer_name) if svc is not None
                 else get_analyzer(analyzer_name))
        else:
            a = (svc.mapper_service.analysis.analyzer("default") if svc is not None
                 else get_analyzer("standard"))
        return {"tokens": [
            {"token": t.term, "start_offset": t.start, "end_offset": t.end,
             "type": "<ALPHANUM>", "position": t.position + 1}
            for t in a.analyze(text if isinstance(text, str) else " ".join(text))]}

    rc.register("GET,POST", "/_analyze", analyze)
    rc.register("GET,POST", "/{index}/_analyze", analyze)

    rc.register("POST", "/_gateway/snapshot", lambda r: client.gateway_snapshot())
    rc.register("POST", "/{index}/_gateway/snapshot",
                lambda r: client.gateway_snapshot(r.path_params["index"]))

    def put_mapping(req):
        return client.put_mapping(req.path_params.get("index"),
                                  req.path_params["type"], _parse_body(req))

    def delete_mapping(req):
        return client.delete_mapping(req.path_params["index"], req.path_params["type"])

    for suffix in ("_mapping", "_mappings"):
        rc.register("PUT,POST", "/{index}/{type}/" + suffix, put_mapping)
        rc.register("PUT,POST", "/{index}/" + suffix + "/{type}", put_mapping)
        rc.register("PUT,POST", "/" + suffix + "/{type}", put_mapping)
        rc.register("DELETE", "/{index}/{type}/" + suffix, delete_mapping)
        rc.register("DELETE", "/{index}/" + suffix + "/{type}", delete_mapping)
    rc.register("GET", "/{index}/_mapping",
                lambda r: client.get_mapping(r.path_params["index"]))
    rc.register("GET", "/{index}/{type}/_mapping",
                lambda r: client.get_mapping(r.path_params["index"], r.path_params["type"]))
    rc.register("GET", "/{index}/_mapping/{type}",
                lambda r: client.get_mapping(r.path_params["index"], r.path_params["type"]))
    rc.register("GET", "/_mapping", lambda r: client.get_mapping())
    rc.register("GET", "/_mapping/{type}",
                lambda r: client.get_mapping(None, r.path_params["type"]))
    for op in ("refresh", "flush", "optimize"):
        rc.register("POST,GET", f"/_{op}",
                    (lambda o: lambda r: getattr(client, o)(None))(op))
        rc.register("POST,GET", "/{index}/_" + op,
                    (lambda o: lambda r: getattr(client, o)(r.path_params["index"]))(op))
    rc.register("GET", "/_cluster/health",
                lambda r: client.cluster_health(
                    wait_for_status=r.param("wait_for_status"),
                    timeout=float(str(r.param("timeout", "10")).rstrip("s"))))
    rc.register("GET", "/_cluster/health/{index}",
                lambda r: client.cluster_health(index=r.path_params["index"]))
    _register_later_routes(rc)
    return rc
