"""Action layer: the API kernel over the transport (a trimmed copy of the JAX
package's `actions.py`), in the reference's interaction patterns:

- master-node: create an index, apply a dynamic-mapping update, shard
  started — forwarded to the master, which mutates the cluster state on its
  single state thread;
- replication, primary only (a one-node cluster leaves every replica
  unassigned): `index_doc` routes a document to its primary by djb2;
  `bulk` groups the ops per shard and sends every group at once;
- scatter-gather search, `query_then_fetch`: one query phase per shard, all
  in flight at once over the transport; each runs `execute_query_phase` on
  the shard's point-in-time searcher through the node's one DeviceBatcher
  onto the card, and pins that context for the fetch. The coordinator
  reduces the shards' top-k (`sort_docs`), fetches the winners from the
  pinned contexts and frees the contexts that won nothing
  (`merge_responses` assembles the response);
- broadcast: `refresh` (and `flush`) on every active shard.

A shard whose query phase fails with a device error (anything that is not a
SearchEngineError) fails the whole search: the REST layer answers 500 with
the error, after the contexts of the shards that answered are freed. The
host scorer serves such a shard instead once the fault domains are ported (a
later slice). A shard whose fetch fails, with any error, drops its hits and
records a `_shards.failures` entry; the rest of the page returns.

Not in this slice: the SPMD mesh branch, DFS, the request cache, insights,
tracing, profiles, admission control, failover across copies and hedging,
replica writes, get/update/delete-by-query, aliases and templates."""

from __future__ import annotations

import threading
import time
import uuid

from .cluster.allocation import new_index_routing
from .cluster.service import HIGH, URGENT
from .cluster.state import ClusterState, IndexMetaData, ShardRouting
from .common.deadline import NO_DEADLINE, Deadline
from .common.errors import (
    CircuitBreakingError,
    IllegalArgumentError,
    IndexAlreadyExistsError,
    MasterNotDiscoveredError,
    RejectedExecutionError,
    SearchEngineError,
    UnavailableShardsError,
)
from .common.logging import get_logger
from .common.settings import Settings, validate_index_name
from .indices_service import ACTION_SHARD_STARTED
from .mapper import MapperService
from .search.controller import merge_responses, sort_docs
from .search.execute import ShardContext
from .search.service import (
    ShardQueryResult,
    execute_fetch_phase,
    execute_query_phase,
    parse_search_body,
)
from .transport import fut_result

A_CREATE_INDEX = "indices:admin/create"
A_MAPPING_UPDATED = "internal:cluster/mapping_updated"
A_INDEX_PRIMARY = "indices:data/write/index[p]"
A_BULK_SHARD = "indices:data/write/bulk[s]"
A_QUERY_PHASE = "indices:data/read/search[phase/query]"
A_FETCH_PHASE = "indices:data/read/search[phase/fetch]"
A_FREE_CONTEXT = "indices:data/read/search[free-context]"
A_SHARD_BROADCAST = "indices:admin/broadcast[s]"

# how long the coordinator waits for a shard phase when the request set no
# budget of its own
QUERY_PHASE_TIMEOUT = 60.0


class ActionModule:
    """Registers every handler on one node and provides the coordinator entry
    points."""

    def __init__(self, node):
        self.node = node
        self.transport = node.transport
        self.cluster_service = node.cluster_service
        self.indices = node.indices
        self.routing = node.operation_routing
        self.allocation = node.allocation
        self.logger = get_logger("action")
        # point-in-time contexts pinned between the query and fetch phases: a
        # refresh or merge between them must not move local doc ids under
        # the fetch
        self._pinned: dict[int, tuple] = {}  # cid -> (expiry, index, shard, ctx)
        self._pinned_lock = threading.Lock()
        self._pinned_next = 1
        t = self.transport
        for action, fn in [(A_CREATE_INDEX, self._m_create_index),
                           (A_MAPPING_UPDATED, self._m_mapping_updated),
                           (ACTION_SHARD_STARTED, self._m_shard_started)]:
            t.register_handler(action, self._master_wrap(fn))
        # data-path actions, each on its named pool
        t.register_handler(A_INDEX_PRIMARY, self._p_index, executor="index")
        t.register_handler(A_BULK_SHARD, self._p_bulk_shard, executor="bulk")
        t.register_handler(A_QUERY_PHASE, self._s_query_phase, executor="search")
        t.register_handler(A_FETCH_PHASE, self._s_fetch_phase, executor="search")
        t.register_handler(A_FREE_CONTEXT, self._s_free_context, executor="search")
        t.register_handler(A_SHARD_BROADCAST, self._s_broadcast,
                           executor="management")

    # ================= master-node pattern =================
    def _master_wrap(self, fn):
        def handler(request, channel):
            if self.cluster_service.state.nodes.master_id != self.node.node_id:
                raise MasterNotDiscoveredError("no master")
            return fn(request, channel)

        return handler

    def _submit(self, source, fn, priority=HIGH, timeout=30.0) -> ClusterState:
        return self.cluster_service.submit_state_update_task(source, fn, priority) \
            .result(timeout)

    def _m_create_index(self, request, channel):
        index = request["index"]
        validate_index_name(index)
        body = request.get("body") or {}

        def update(state: ClusterState) -> ClusterState:
            if state.metadata.has_index(index):
                raise IndexAlreadyExistsError(index)
            flat = {(k if k.startswith("index.") else f"index.{k}"): v
                    for k, v in Settings.from_flat(
                        body.get("settings") or {}).as_dict().items()}
            flat.setdefault("index.number_of_shards", 5)
            flat.setdefault("index.number_of_replicas", 1)
            flat["index.number_of_shards"] = int(flat["index.number_of_shards"])
            flat["index.number_of_replicas"] = int(flat["index.number_of_replicas"])
            meta = IndexMetaData(name=index, settings_map=tuple(sorted(flat.items())))
            for t, m in (body.get("mappings") or {}).items():
                meta = meta.with_mapping(t, m)
            new = state.next_version(
                metadata=state.metadata.with_index(meta),
                routing_table=state.routing_table.with_index(new_index_routing(
                    index, meta.number_of_shards, meta.number_of_replicas)))
            return self.allocation.reroute(new)

        self._submit(f"create-index[{index}]", update, priority=URGENT)
        ok = self._wait_for_active_primaries(index, timeout=10.0)
        return {"acknowledged": True, "index": index, "primaries_active": ok}

    def _m_mapping_updated(self, request, channel):
        """A data node's dynamic mapping grew: merge it into the index's
        mapping in the cluster state (a conflict raises)."""
        index, type_name = request["index"], request["type"]

        def update(state: ClusterState) -> ClusterState:
            meta = state.metadata.require_index(index)
            svc = MapperService(meta.settings)
            existing = meta.mapping(type_name)
            if existing:
                svc.put_mapping(type_name, existing)
            svc.put_mapping(type_name, request["mapping"])
            merged = svc.mappings_dict()[type_name]
            return state.next_version(metadata=state.metadata.with_index(
                meta.with_mapping(type_name, merged)))

        self._submit(f"put-mapping[{index}/{type_name}]", update)
        return {"acknowledged": True}

    def _m_shard_started(self, request, channel):
        shard = ShardRouting.from_dict(request["shard"])
        self._submit(f"shard-started[{shard.index}][{shard.shard_id}]",
                     lambda state: self.allocation.apply_started_shards(state, [shard]),
                     priority=URGENT)
        return {"ok": True}

    def _wait_for_active_primaries(self, index: str, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            table = self.cluster_service.state.routing_table.index(index)
            if table is not None and table.primaries_active():
                return True
            time.sleep(0.02)
        return False

    def _ensure_index(self, index: str):
        """Auto-create a missing index with the defaults."""
        if self.cluster_service.state.metadata.has_index(index):
            return
        try:
            self.transport.submit_request(self.node.local_node, A_CREATE_INDEX,
                                          {"index": index, "body": {}})
        except IndexAlreadyExistsError:
            pass

    def _primary_node(self, state: ClusterState, index: str, shard_id: int):
        primary = state.routing_table.index(index).shard(shard_id).primary
        if primary is None or not primary.active:
            return None
        return state.nodes.get(primary.node_id)

    # ================= writes, primary only =================
    def index_doc(self, index: str, type_name: str, doc_id: str | None,
                  source: dict, routing=None, version=None,
                  version_type="internal", op_type="index", refresh=False) -> dict:
        self._ensure_index(index)
        if doc_id is None:
            doc_id = uuid.uuid4().hex[:20]
        req = {"index": index, "type": type_name, "id": doc_id, "source": source,
               "routing": routing, "version": version, "version_type": version_type,
               "op_type": op_type, "refresh": refresh}
        state = self.cluster_service.state
        state.blocks.check("write")
        deadline = time.monotonic() + 10.0
        while True:
            sid = self.routing.shard_id(state, index, doc_id, routing)
            node = self._primary_node(state, index, sid)
            if node is not None:
                req["shard"] = sid
                return self.transport.submit_request(node, A_INDEX_PRIMARY, req)
            if time.monotonic() > deadline:
                raise UnavailableShardsError(
                    f"primary not active for [{index}] doc [{doc_id}]")
            time.sleep(0.05)  # wait for the next cluster state
            state = self.cluster_service.state

    def _p_index(self, request, channel):
        index, shard_id = request["index"], request["shard"]
        shard = self.indices.index_service(index).shard(shard_id)
        mapper = shard.engine.mapper_service.mapper_for(request["type"])
        known_before = set(mapper.fields)
        version, created = shard.engine.index(
            request["type"], request["id"], request["source"],
            routing=request.get("routing"), version=request.get("version"),
            version_type=request.get("version_type", "internal"),
            op_type=request.get("op_type", "index"))
        if set(mapper.fields) - known_before:
            # the dynamic mapping grew: propagate it to the cluster state
            try:
                self.transport.submit_request(
                    self.node.local_node, A_MAPPING_UPDATED,
                    {"index": index, "type": request["type"],
                     "mapping": mapper.to_mapping()}, timeout=10.0)
            except SearchEngineError as e:
                self.logger.warning("mapping update propagation failed: %s", e)
        if request.get("refresh"):
            shard.engine.refresh()
        shard.engine.maybe_flush()
        return {"_index": index, "_type": request["type"], "_id": request["id"],
                "_version": version, "created": created}

    def bulk(self, operations: list[dict], refresh=False) -> dict:
        """Group the ops per (index, shard) and send every group to its
        primary at once; items come back in request order."""
        t0 = time.monotonic()
        for op in operations:
            index = next(iter(op["action"].values())).get("_index")
            if index:
                self._ensure_index(index)
        state = self.cluster_service.state
        state.blocks.check("write")
        by_shard: dict = {}
        for i, op in enumerate(operations):
            (op_name, meta), = op["action"].items()
            index = meta.get("_index")
            doc_id = meta.get("_id") or uuid.uuid4().hex[:20]
            routing = meta.get("_routing") or meta.get("routing")
            shard_id = self.routing.shard_id(state, index, doc_id, routing)
            by_shard.setdefault((index, shard_id), []).append((i, {
                "op": op_name, "index": index, "type": meta.get("_type", "_default_"),
                "id": doc_id, "routing": routing, "source": op.get("source"),
                "version": meta.get("_version")}))
        results: dict[int, dict] = {}
        futs = []
        for (index, shard_id), items in by_shard.items():
            node = self._primary_node(state, index, shard_id)
            if node is None:
                for i, item in items:
                    results[i] = {"error": "primary unavailable", "status": 503, **item}
                continue
            futs.append((items, self.transport.send_request(node, A_BULK_SHARD, {
                "index": index, "shard": shard_id, "refresh": refresh,
                "items": [item for _, item in items]})))
        for items, fut in futs:
            try:
                resp = fut_result(fut, 60.0)
                for (i, _item), r in zip(items, resp["items"]):
                    results[i] = r
            except SearchEngineError as e:
                for i, _item in items:
                    results[i] = {"error": str(e), "status": 503}
        items_out = [results[i] for i in range(len(operations))]
        return {"took": int((time.monotonic() - t0) * 1000),
                "errors": any("error" in r for r in items_out),
                "items": [{r.pop("op", "index"): r} for r in items_out]}

    def _p_bulk_shard(self, request, channel):
        index, shard_id = request["index"], request["shard"]
        shard = self.indices.index_service(index).shard(shard_id)
        out = []
        for item in request["items"]:
            op = item.get("op", "index")
            base = {"_index": index, "_type": item["type"], "_id": item["id"]}
            try:
                if op in ("index", "create"):
                    version, created = shard.engine.index(
                        item["type"], item["id"], item.get("source") or {},
                        routing=item.get("routing"), version=item.get("version"),
                        op_type=op)
                    out.append({**base, "_version": version,
                                "status": 201 if created else 200, "op": op})
                elif op == "delete":
                    version, found = shard.engine.delete(item["type"], item["id"])
                    out.append({**base, "_version": version, "found": found,
                                "status": 200 if found else 404, "op": op})
                else:
                    out.append({"error": f"bulk op [{op}] is not ported yet "
                                         "(a later slice of the port)",
                                "status": 400, "op": op})
            except SearchEngineError as e:
                out.append({**base, "error": e.to_dict(), "status": e.status,
                            "op": op})
        if request.get("refresh"):
            shard.engine.refresh()
        shard.engine.maybe_flush()
        return {"items": out}

    # ================= scatter-gather search =================
    def search(self, index_expr, body: dict | None = None, routing=None) -> dict:
        t0 = time.monotonic()
        state = self.cluster_service.state
        indices = state.metadata.resolve_indices(index_expr)
        state.blocks.check("read")
        req = parse_search_body(body)
        deadline = Deadline.after(req.timeout_s) if req.timeout_s is not None \
            else NO_DEADLINE
        shards = self.routing.search_shards(state, indices, routing)
        # every shard's query phase in flight at once
        futs = [(copy, self.transport.send_request(
            state.nodes.get(copy.node_id), A_QUERY_PHASE, {
                "index": copy.index, "shard": copy.shard_id, "body": body or {},
                "deadline_s": deadline.remaining()}))
            for copy in shards]
        results: list[ShardQueryResult] = []
        failures, terminals = [], []
        # ordinal -> (index, real shard id, node, pinned context id): the
        # coordinator's merge identity is the ordinal, as (index, shard)
        # pairs of two indices can share a shard id
        shard_meta: dict[int, tuple] = {}
        wait_by = time.monotonic() + (QUERY_PHASE_TIMEOUT if deadline.remaining() is None
                                      else deadline.remaining() + 5.0)
        try:
            for ordinal, (copy, fut) in enumerate(futs):
                try:
                    r = fut_result(fut, max(0.0, wait_by - time.monotonic()))
                except SearchEngineError as e:
                    failures.append({"index": copy.index, "shard": copy.shard_id,
                                     "node": copy.node_id, "reason": str(e)})
                    terminals.append(e)
                    continue
                shard_meta[ordinal] = (copy.index, copy.shard_id,
                                       state.nodes.get(copy.node_id), r.get("ctx_id"))
                results.append(ShardQueryResult(
                    total=r["total"], docs=[tuple(d) for d in r["docs"]],
                    max_score=r["max_score"] if r["max_score"] is not None
                    else float("nan"),
                    shard_id=ordinal, timed_out=bool(r.get("timed_out")),
                    context_id=r.get("ctx_id")))
        except Exception:
            # an error that is not a shard failure (a device error) fails the
            # search: no shard that answered, or answers later, keeps its
            # context pinned
            self._free_after_failure(futs, shard_meta, wait_by)
            raise
        if not results and terminals and all(
                isinstance(e, (CircuitBreakingError, RejectedExecutionError))
                for e in terminals):
            # every shard was shed by overload protection: a 429, not a partial
            raise terminals[-1]
        return self._finish_search(req, body, results, failures, shards,
                                   shard_meta, t0, timed_out=deadline.expired())

    def _free_after_failure(self, futs, shard_meta: dict, wait_by: float):
        """Free the pinned context of every shard whose query phase answered
        or still answers before `wait_by`, and wait for the frees."""
        pinned = [(index, shard, node, cid)
                  for (index, shard, node, cid) in shard_meta.values()]
        state = self.cluster_service.state
        for ordinal, (copy, fut) in enumerate(futs):
            if ordinal in shard_meta:
                continue
            try:
                r = fut_result(fut, max(0.0, wait_by - time.monotonic()))
            except Exception:  # noqa: BLE001 — a failed shard pinned nothing
                continue
            pinned.append((copy.index, copy.shard_id,
                           state.nodes.get(copy.node_id), r.get("ctx_id")))
        frees = [self.transport.send_request(node, A_FREE_CONTEXT, {
            "index": index, "shard": shard, "ctx": cid})
            for (index, shard, node, cid) in pinned if cid is not None]
        for fut in frees:
            try:
                fut_result(fut, 30.0)
            except Exception:  # noqa: BLE001 — the original error is the answer
                self.logger.debug("freeing a pinned context failed",
                                  exc_info=True)

    def _finish_search(self, req, body, results, failures, shards, shard_meta, t0,
                       timed_out: bool = False) -> dict:
        """Reduce, fetch the page's winners (every shard's fetch in flight at
        once), free the pinned contexts that won nothing, assemble."""
        merged = sort_docs(req, results)
        merged.timed_out = merged.timed_out or timed_out
        page = merged.hits[req.from_: req.from_ + req.size]
        by_shard: dict = {}
        for rank, (score, ordinal, doc, sort_values) in enumerate(page):
            by_shard.setdefault(ordinal, []).append((rank, score, doc, sort_values))
        fetch_futs = []
        for ordinal, entries in by_shard.items():
            index_name, real_shard, node, ctx_id = shard_meta[ordinal]
            fetch_futs.append((ordinal, entries, self.transport.send_request(
                node, A_FETCH_PHASE, {
                    "index": index_name, "shard": real_shard, "body": body or {},
                    "ctx": ctx_id,
                    "docs": [[score, doc, sv] for (_r, score, doc, sv) in entries]})))
        fetched: dict[int, dict] = {}
        fetch_failed = 0
        for ordinal, entries, fut in fetch_futs:
            try:
                r = fut_result(fut, 30.0)
            except Exception as e:  # noqa: BLE001 — any fetch failure drops
                # that shard's hits (handler errors cross the local transport
                # untyped); the rest of the page still returns
                index_name, real_shard, _node, _cid = shard_meta[ordinal]
                failures.append({"index": index_name, "shard": real_shard,
                                 "reason": f"fetch phase failed: {e}"})
                fetch_failed += 1
                continue
            for (rank, *_), hit in zip(entries, r["hits"]):
                fetched[rank] = hit
        for ordinal, (index_name, real_shard, node, ctx_id) in shard_meta.items():
            if ctx_id is not None and ordinal not in by_shard:
                self.transport.send_request(node, A_FREE_CONTEXT, {
                    "index": index_name, "shard": real_shard, "ctx": ctx_id})
        return merge_responses(req, merged, results,
                               [fetched[r] for r in sorted(fetched)],
                               took_ms=int((time.monotonic() - t0) * 1000),
                               total_shards=len(shards),
                               successful=len(results) - fetch_failed,
                               failures=failures)

    _PIN_KEEP_S = 60.0

    def _pin_context(self, index: str, shard_id: int, ctx: ShardContext) -> int:
        """Pin a query-phase context for the fetch; expired pins are reaped
        lazily."""
        now = time.monotonic()
        with self._pinned_lock:
            for k in [k for k, v in self._pinned.items() if v[0] < now]:
                del self._pinned[k]
            cid = self._pinned_next
            self._pinned_next += 1
            self._pinned[cid] = (now + self._PIN_KEEP_S, index, shard_id, ctx)
        return cid

    def _take_pinned(self, cid, index: str, shard_id: int) -> ShardContext | None:
        with self._pinned_lock:
            v = self._pinned.pop(cid, None) if cid is not None else None
        if v is not None and v[1] == index and v[2] == shard_id:
            return v[3]
        return None

    def pinned_contexts(self) -> int:
        with self._pinned_lock:
            return len(self._pinned)

    def _shard_ctx(self, index: str, shard_id: int) -> ShardContext:
        """The shard's current searcher in a context wired to the node's
        device, breakers and ONE node-level DeviceBatcher."""
        svc = self.indices.index_service(index)
        shard = svc.shard(shard_id)
        return ShardContext(shard.engine.acquire_searcher(), svc.mapper_service,
                            svc.similarity_service, device=self.node.device,
                            breakers=self.node.breakers,
                            batcher=self.node.search_batcher)

    def _s_query_phase(self, request, channel):
        index, shard_id = request["index"], request["shard"]
        req = parse_search_body(request.get("body") or {})
        ctx = self._shard_ctx(index, shard_id)
        budget = request.get("deadline_s")
        if req.timeout_s is not None:
            budget = req.timeout_s if budget is None else min(budget, req.timeout_s)
        deadline = Deadline.after(budget) if budget is not None else NO_DEADLINE
        result = execute_query_phase(ctx, req, shard_id=shard_id, deadline=deadline)
        return {
            "total": result.total,
            "docs": [[s, d, sv] for (s, d, sv) in result.docs],
            "max_score": None if result.max_score != result.max_score
            else result.max_score,
            "timed_out": result.timed_out,
            # the fetch must read the SAME point-in-time searcher these doc
            # ids come from
            "ctx_id": self._pin_context(index, shard_id, ctx),
        }

    def _s_fetch_phase(self, request, channel):
        # the pinned query-time context; an expired pin falls back to the
        # current searcher (best effort, like a lost scroll)
        ctx = self._take_pinned(request.get("ctx"), request["index"],
                                request["shard"]) \
            or self._shard_ctx(request["index"], request["shard"])
        req = parse_search_body(request.get("body") or {})
        return {"hits": execute_fetch_phase(
            ctx, req, [tuple(d) for d in request["docs"]],
            index_name=request["index"], shard_id=request["shard"])}

    def _s_free_context(self, request, channel):
        self._take_pinned(request.get("ctx"), request["index"], request["shard"])
        return {}

    # ================= broadcast =================
    def broadcast(self, index_expr, op: str) -> dict:
        """refresh on every active shard copy (flush and the other broadcast
        ops come with their REST routes)."""
        state = self.cluster_service.state
        indices = state.metadata.resolve_indices(index_expr) if index_expr else \
            state.metadata.index_names()
        futs = []
        for index in indices:
            table = state.routing_table.index(index)
            if table is None:
                continue
            for group in table.shards:
                for copy in group.active_shards():
                    futs.append(self.transport.send_request(
                        state.nodes.get(copy.node_id), A_SHARD_BROADCAST,
                        {"index": index, "shard": copy.shard_id, "op": op}))
        ok = 0
        for fut in futs:
            try:
                fut_result(fut, 30.0)
                ok += 1
            except SearchEngineError:
                pass
        return {"_shards": {"total": len(futs), "successful": ok,
                            "failed": len(futs) - ok}}

    def _s_broadcast(self, request, channel):
        engine = self.indices.index_service(request["index"]) \
            .shard(request["shard"]).engine
        op = request["op"]
        if op != "refresh":
            raise IllegalArgumentError(f"broadcast op [{op}] is not ported yet")
        engine.refresh()
        return {"ok": True}
