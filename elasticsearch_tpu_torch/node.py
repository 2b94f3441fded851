"""Node assembly and client (a trimmed copy of the JAX package's `node.py`).

A Node builds its services in dependency order — cluster service → gateway →
thread pools → breakers → the node-level ShardRequestCache, DeviceFilterCache
and DeviceBatcher → the warmer → transport → allocation → indices → actions
→ discovery — and
`start()` builds every kernel of `csrc/` on a CUDA device (the port's
counterpart of the JAX node's compile-warm cycle: one nvcc per source, all
at once, and each library loaded, so no search runs nvcc) and launches each
once on a tiny input against its plain version (`KERNEL_START_CHECKS`); a
kernel that does not build, launch or agree stops the start, the node does
not degrade past it. Then it elects itself master of a one-node cluster,
and the gateway restores the indices an earlier run persisted under
`path.data` (a fresh `path.data` restores nothing) and lifts the
not-recovered block; each restored shard recovers from its store and
translog (indices_service). `start_http(port)` binds the REST surface (port
0 = ephemeral). `device_health()` reads the device fault domains
(common/devicehealth) and the warmer's pack counters in process.

`events` is the node's EventJournal (common/events): the StallWatchdog
(`watchdog`, ticking on the management pool) journals batches stalled in
their pull, pool queue-wait spikes and breakers dwelling near their limit,
and DEVICE_HEALTH publishes each fault domain's trip and recovery there.

The node serves on the card unless told otherwise: its device is the
`node.device` setting ("cpu" in the tests) resolved through
`cudaenv.default_device`, so without CUDA and without that setting building
a Node raises DeviceUnavailableError. Every shard's query phase on this node
goes through ONE DeviceBatcher (`search_batcher`), and its filtered plans
read ONE DeviceFilterCache (`filter_cache`, charged to the fielddata
breaker; its masks leave with the segments an engine view drops), its
cache-eligible bodies ONE ShardRequestCache (`request_cache`, charged to the
request breaker; a new view drops the entries of the older ones), and ONE
IndexWarmerService packs every new view's segments for the node's device
on the `warmer` and `merge` pools and re-primes the hot cached bodies, as
in the JAX node.

`tracer` (common/tracing) samples searches into span trees
(`search.trace.sample_rate`, `?trace=true`; finished traces in its ring,
live ones as tasks); `insights` (common/insights) classifies every search
into a bounded registry of query shapes; `monitor` reads the OS, the
process, `path.data`'s filesystem and the runtime with the node's card
(`torch.cuda`; nothing on a `cpu` node).

`percolator`, the node's PercolatorService, keeps a query registry per
index fed by the single-document writes of `.percolator` documents (the
indices service drops an index's registry with the index) and percolates
on the node's device. `script_service` is the node's
ScriptService (its named scripts in the port's process registry).

The indexing-memory controller (every 5 s on the management pool) refreshes
the largest un-refreshed shard buffers while they together pass
`indices.memory.index_buffer_size` ("10%" of the host's RAM by default, at
least 16 MiB, or a byte size), and any shard idle for 300 s
(indices_service `check_indexing_memory`).

The TTL purger (`_purge_expired`, every `indices.ttl.interval`, 60 s by
default, on the generic pool) reads each primary shard's `_expiry` doc
values and deletes the documents whose expiry has passed, in one logged
tombstone op a shard, then refreshes; `close()` cancels it. Replicas wait
for A5, as every replica write does.

`Client` is trimmed to `create_index`, `delete_index`, `open_index`,
`close_index`, `exists_index`, `exists_type`, `put_mapping`, `get_mapping`,
`get_field_mapping`, `delete_mapping`, `update_settings`, `get_settings`,
`update_aliases`, `get_aliases`, `get_alias`, `exists_alias`,
`put_template`, `delete_template`, `get_template`, `put_warmer`,
`delete_warmer`, `get_warmer`, `index`, `create`, `get`, `mget`,
`delete`, `update`, `bulk`, `delete_by_query`, `refresh`, `flush`,
`optimize`, `clear_cache`, `gateway_snapshot`, `search`, `msearch`,
`count`, `suggest`, `termvector`, `mtermvectors`, `mlt`, `explain`,
`percolate`, `count_percolate`, `mpercolate`, `cluster_health`, and the
stats surfaces: `stats` (with each index's device capacity stanza),
`segments` (with each segment's pack), `indices_status`, `node_events`,
`cluster_events`, `nodes_info` and `nodes_stats` (its sections by name,
an unknown one a 400; `device` is the capacity ledger over the node's
resident packs, the kernels' builds and launches, the start check's
launches, the fault domains and, on a `cuda` node, the caching
allocator's bytes)."""

from __future__ import annotations

import os
import tempfile
import time
import uuid

import numpy as np

from .actions import (
    A_ALIASES,
    A_CLOSE_INDEX,
    A_CREATE_INDEX,
    A_DELETE_INDEX,
    A_DELETE_MAPPING,
    A_DELETE_TEMPLATE,
    A_DELETE_WARMER,
    A_OPEN_INDEX,
    A_PUT_MAPPING,
    A_PUT_TEMPLATE,
    A_PUT_WARMER,
    A_UPDATE_SETTINGS,
    ActionModule,
    shape_get,
)
from .cluster.allocation import AllocationService
from .cluster.routing import OperationRouting
from .cluster.service import ClusterService
from .cluster.state import DiscoveryNode
from .common import cudaenv
from .common.breaker import CircuitBreakerService
from .common.cudaenv import default_device
from .common.devicehealth import DEVICE_HEALTH
from .common.errors import (
    AliasesMissingError,
    IllegalArgumentError,
    IndexTemplateMissingError,
    NotPortedError,
    SearchEngineError,
    TypeMissingError,
)
from .common.events import EventJournal, StallWatchdog
from .common.insights import QueryShapeInsights
from .common.tracing import Tracer
from .common.logging import get_logger
from .common.names import is_pattern, name_matches
from .common.settings import prepare_settings
from .common.units import parse_bytes
from .discovery.zen import ZenDiscovery
from .gateway import LocalGateway
from .indices_service import IndicesService
from .ops import sparse_kernels
from .monitor import MonitorService
from .ops.device_index import (
    DeviceFilterCache,
    bytes_per_posting,
    capacity_report,
    pack_cache_key,
    packed_resident_bytes,
)
from .percolator import PercolatorService
from .script import ScriptService
from .search.batcher import DeviceBatcher
from .search.request_cache import ShardRequestCache
from .threadpool import ThreadPool
from .transport.local import DEFAULT_REGISTRY, LocalTransport
from .transport.service import TransportService
from .warmer import IndexWarmerService

# each kernel source of csrc/ and the check a node's start launches it with
KERNEL_START_CHECKS = {"sparse_score": sparse_kernels.start_check}


class Node:
    def __init__(self, name: str | None = None, settings=None, registry=None,
                 data_path: str | None = None):
        self.settings = prepare_settings(settings)
        self.device = default_device(self.settings.get_str("node.device"))
        self.name = name or self.settings.get_str("node.name") \
            or f"node_{uuid.uuid4().hex[:6]}"
        self.node_id = self.settings.get_str("node.id") or self.name
        self.data_path = data_path or self.settings.get_str("path.data") or \
            tempfile.mkdtemp(prefix=f"estpu_torch_{self.name}_")
        self.logger = get_logger("node")
        if self.settings.get_str("transport.type", "local") != "local":
            raise NotPortedError(
                "transport.type [tcp] is not ported yet (the slice with two "
                "nodes); the port node runs the local transport")
        # settings a lone node cannot meet raise here, before any pool or
        # transport thread starts
        self.cluster_service = ClusterService(self.name)
        try:
            self.gateway = LocalGateway(self.data_path, self.cluster_service,
                                        self.settings)
        except Exception:
            self.cluster_service.close()
            raise
        self.registry = registry or DEFAULT_REGISTRY
        address = f"local://{self.node_id}"
        # a lone node is master-eligible and holds data
        self.local_node = DiscoveryNode(id=self.node_id, name=self.name,
                                        transport_address=address)
        self.threadpool = ThreadPool(self.settings)
        self.breakers = CircuitBreakerService(self.settings)
        # the bounded journal of stall and pressure events, fed by the
        # management-pool watchdog (started with the node) and by the device
        # fault domains' trips and recoveries
        self.events = EventJournal(self.settings, node_name=self.name,
                                   node_id=self.node_id)
        DEVICE_HEALTH.register_publisher(self.node_id, self.events.publish)
        # request-scoped tracing (sample rate, ring of finished traces,
        # in-flight registry) and the always-on query-shape insights
        self.tracer = Tracer(self.settings, node_name=self.name)
        self.insights = QueryShapeInsights(self.settings)
        # the shard request cache: a cache-eligible body's partial per shard
        # view, accounted on the request breaker
        self.request_cache = ShardRequestCache(
            self.settings, breaker=self.breakers.breaker("request"),
            total_budget=self.breakers.total_budget)
        # hot filters' per-segment masks resident on the device, accounted on
        # the fielddata breaker next to the packed postings
        self.filter_cache = DeviceFilterCache(
            self.settings, breaker=self.breakers.breaker("fielddata"))
        # cross-request device micro-batching: concurrent query phases on
        # this node's shards coalesce into bucketed launches
        self.search_batcher = DeviceBatcher(self.settings)
        # every searcher install schedules the new view's packs and remasks
        # on the warmer and merge pools, off the query path
        self.warmer = IndexWarmerService(
            self.settings, self.device, self.threadpool,
            breaker=self.breakers.breaker("fielddata"), node=self)
        self.transport = TransportService(LocalTransport(address, self.registry),
                                          self.local_node, self.threadpool)
        self.transport.in_flight_breaker = self.breakers.breaker("in_flight_requests")
        self.allocation = AllocationService()
        self.operation_routing = OperationRouting()
        self.percolator = PercolatorService(self)
        self.indices = IndicesService(self.node_id, self.data_path, self.transport,
                                      self.cluster_service, self.threadpool,
                                      filter_cache=self.filter_cache,
                                      warmer=self.warmer,
                                      request_cache=self.request_cache,
                                      percolator=self.percolator)
        self.actions = ActionModule(self)
        self.script_service = ScriptService()
        # scheduled NRT refresh and merge-policy check (each index's
        # refresh_interval is honoured inside periodic_refresh)
        self.threadpool.schedule_with_fixed_delay(
            0.5, self.indices.periodic_refresh, name="refresh")
        # the indexing-memory controller: a node-wide budget for the
        # shards' un-refreshed buffers
        self._imc_budget = self._resolve_index_buffer_size()
        self._imc_task = self.threadpool.schedule_with_fixed_delay(
            5.0, lambda: self.indices.check_indexing_memory(self._imc_budget),
            name="management")
        # the TTL purger: expired documents leave every primary shard
        self._ttl_task = self.threadpool.schedule_with_fixed_delay(
            self.settings.get_time("indices.ttl.interval", 60.0),
            self._purge_expired, name="generic")
        self.discovery = ZenDiscovery(self.local_node, self.cluster_service,
                                      self.allocation)
        self.monitor = MonitorService(self)
        self.watchdog = StallWatchdog(self, self.settings)
        self.http = None
        # the kernels the start built: {name: nvcc output} (empty when every
        # library was current), the launches each start check made, and the
        # seconds the build and the checks took
        self.kernel_builds: dict = {}
        self.kernel_checks: dict = {}
        self.kernel_build_s = 0.0
        self._closed = False

    def start(self, seeds: list[str] | None = None) -> "Node":
        """Build, load and check every kernel on a CUDA device, then elect
        this node master of its one-node cluster, recover the cluster state
        persisted under `path.data` and start the watchdog; seeds naming
        other nodes raise."""
        if self.device.type == "cuda":
            t0 = time.monotonic()
            try:
                self.kernel_builds = cudaenv.build_all()
                for name in cudaenv.kernel_sources():
                    cudaenv.load_library(name)
                    self.kernel_checks[name] = KERNEL_START_CHECKS[name](self.device)
            except BaseException:
                self.close()  # its pool threads would keep the process alive
                raise
            self.kernel_build_s = time.monotonic() - t0
            self.logger.info("kernels %s current in %.1f s (built %s)",
                             cudaenv.kernel_sources(), self.kernel_build_s,
                             sorted(self.kernel_builds))
        self.discovery.start(seeds or [])
        self.gateway.maybe_recover()
        self.watchdog.start()
        self.logger.info("started [%s] on [%s]", self.name, self.device)
        return self

    def start_http(self, port: int = 0):
        """Bind the REST surface (port 0 = ephemeral)."""
        from .http.server import HttpServer
        from .rest.controller import build_rest_controller

        self.http = HttpServer(build_rest_controller(self), port=port).start()
        return self.http

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._ttl_task.cancel()
        self._imc_task.cancel()
        DEVICE_HEALTH.unregister_publisher(self.node_id)
        self.watchdog.stop()
        if self.http is not None:
            self.http.stop()
        self.warmer.close()
        self.gateway.persist_now()
        self.indices.close()
        self.cluster_service.close()
        self.transport.close()
        # stop the batcher's drainer before its callers' pools close, so
        # queued searches fail typed instead of hanging on futures
        self.search_batcher.shutdown()
        self.threadpool.shutdown()

    def client(self) -> "Client":
        return Client(self)

    def _resolve_index_buffer_size(self) -> int:
        """`indices.memory.index_buffer_size`: a share of the host's RAM
        ("10%", the default; at least 16 MiB) or a byte size."""
        raw = self.settings.get("indices.memory.index_buffer_size", "10%")
        if isinstance(raw, str) and raw.strip().endswith("%"):
            try:
                frac = float(raw.strip()[:-1]) / 100.0
                total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
                return max(int(total * frac), 16 * 1024 ** 2)
            except (ValueError, OSError):
                return 64 * 1024 ** 2
        return parse_bytes(raw) or 64 * 1024 ** 2

    def _purge_expired(self):
        """Delete, on every primary shard, the live documents whose `_expiry`
        has passed: one `delete_by_uids` op a shard, then a refresh."""
        now = time.time() * 1000
        for index, svc in list(self.indices.indices.items()):
            for sid, shard in list(svc.shards.items()):
                if not shard.primary:
                    continue
                try:
                    uids = []
                    for seg in shard.engine.acquire_searcher().segments:
                        col = seg.dv_num.get("_expiry")
                        if col is None:
                            continue
                        off, vals = col
                        doc_of_val = np.repeat(np.arange(seg.doc_count), np.diff(off))
                        for local in doc_of_val[vals < now]:
                            if seg.live[local] and seg.parent_mask[local]:
                                uids.append(f"{seg.types[local]}#{seg.ids[local]}")
                    if uids:
                        shard.engine.delete_by_uids(uids, query={"expired": True})
                        shard.engine.refresh()
                        self.logger.info("ttl purged %d docs from [%s][%d]",
                                         len(uids), index, sid)
                except SearchEngineError:
                    continue

    def device_health(self) -> dict:
        """The device fault domains' circuits and counters (the process's
        DEVICE_HEALTH), and the warmer's pack counters. The REST route and
        the metric families of these come with the observability slice."""
        return {"health": DEVICE_HEALTH.stats(), "warmer": self.warmer.stats()}


class Client:
    """One method per action of the slice."""

    def __init__(self, node: Node):
        self.node = node
        self.actions = node.actions

    def _local(self, action: str, body: dict):
        """A master action on this (the master) node."""
        return self.node.transport.submit_request(self.node.local_node, action, body,
                                                  timeout=30.0)

    # --- indices admin ------------------------------------------------------
    def create_index(self, index, body=None):
        return self._local(A_CREATE_INDEX, {"index": index, "body": body or {}})

    def delete_index(self, index):
        return self._local(A_DELETE_INDEX, {"index": index})

    def open_index(self, index):
        return self._local(A_OPEN_INDEX, {"index": index})

    def close_index(self, index):
        return self._local(A_CLOSE_INDEX, {"index": index})

    def exists_index(self, index) -> bool:
        try:
            return bool(self.node.cluster_service.state.metadata.resolve_indices(index))
        except SearchEngineError:
            return False

    def put_mapping(self, index, doc_type, body):
        return self._local(A_PUT_MAPPING,
                           {"index": index or "_all", "type": doc_type, "body": body})

    def get_mapping(self, index=None, doc_type=None):
        return self.actions.get_mapping(index, doc_type)

    def delete_mapping(self, index, doc_type):
        return self._local(A_DELETE_MAPPING, {"index": index or "_all", "type": doc_type})

    def get_field_mapping(self, index=None, doc_type=None, field=None,
                          include_defaults=False):
        """Per index, per type, per field, the field's slice of the mapping.
        A field resolves by its full path first, then by its index name (an
        `index_name` attribute, or the leaf name under an object with `path:
        just_name`); the response key is the name it matched by. A type
        expression that matches no type answers 404 TypeMissingException."""
        state = self.node.cluster_service.state
        out = {}
        type_seen = False
        for name in state.metadata.resolve_indices(index or "_all"):
            for t, mapping in state.metadata.index(name).mappings_dict().items():
                if doc_type and not name_matches(t, doc_type):
                    continue
                type_seen = True
                props = _flatten_properties(mapping.get("properties") or {})
                index_names: dict[str, str] = {}  # alternate name -> full path
                for fname, fdef in props.items():
                    alts = set()
                    if isinstance(fdef, dict):
                        if fdef.get("index_name"):
                            alts.add(fdef["index_name"])
                        if fdef.get("_just_name"):
                            alts.add(fname.rsplit(".", 1)[-1])
                    for alt in alts:
                        if alt != fname:
                            index_names.setdefault(alt, fname)
                wanted: dict[str, str] = {}  # response key -> full path
                exprs = ([field] if not isinstance(field, list) else field) if field \
                    else ["*"]
                exprs = [e for expr in exprs for e in str(expr).split(",")]
                for expr in exprs:
                    for fname in props:
                        if name_matches(fname, expr):
                            wanted[fname] = fname
                    # an index name matches only where no full name claimed
                    # the key and its field was not matched by full name
                    for alt, fname in index_names.items():
                        if alt not in wanted and fname not in wanted.values() \
                                and name_matches(alt, expr):
                            wanted[alt] = fname
                for key, fname in sorted(wanted.items()):
                    fdef = {k: v for k, v in props[fname].items() if k != "_just_name"}
                    if include_defaults:
                        fdef.setdefault("type", "string")
                        fdef.setdefault("index", "analyzed")
                        fdef.setdefault("analyzer", "default")
                    out.setdefault(name, {"mappings": {}})["mappings"] \
                        .setdefault(t, {})[key] = {
                            "full_name": fname,
                            "mapping": {fname.rsplit(".", 1)[-1]: fdef}}
        if doc_type and not type_seen:
            raise TypeMissingError(f"type[[{doc_type}]] missing")
        return out

    def exists_type(self, index, doc_type) -> bool:
        """True only when every resolved index has a type the expression
        matches."""
        state = self.node.cluster_service.state
        try:
            names = state.metadata.resolve_indices(index or "_all")
        except SearchEngineError:
            return False
        if not names:
            return False
        return all(any(name_matches(t, doc_type)
                       for t in state.metadata.index(n).mappings_dict())
                   for n in names)

    def update_settings(self, index, body):
        return self._local(A_UPDATE_SETTINGS, {"index": index or "_all", "body": body})

    def get_settings(self, index=None, name=None):
        """Each index's settings as strings in nested form; `name` filters
        the flat keys (wildcards), and an index left with none is left
        out."""
        state = self.node.cluster_service.state
        out = {}
        for idx in state.metadata.resolve_indices(index or "_all"):
            flat = {k: _settings_str(v)
                    for k, v in state.metadata.index(idx).settings.as_dict().items()}
            if name:
                flat = {k: v for k, v in flat.items() if name_matches(k, name)}
            if flat:
                out[idx] = {"settings": _nest_keys(flat)}
        return out

    def update_aliases(self, body):
        return self._local(A_ALIASES, {"body": body})

    def get_aliases(self, index=None, name=None):
        """The plural form (`/_aliases`): an index the expression names
        explicitly appears even with no matching alias."""
        state = self.node.cluster_service.state
        explicit = set()
        if index and not is_pattern(index) and index not in ("_all", "*"):
            explicit = {p.strip() for p in str(index).split(",")}
        out = {}
        for idx in state.metadata.resolve_indices(index or "_all"):
            aliases = state.metadata.index(idx).aliases_dict()
            if name is not None:
                aliases = {a: sp for a, sp in aliases.items() if name_matches(a, name)}
                if not aliases and idx not in explicit:
                    continue
            out[idx] = {"aliases": aliases}
        return out

    def get_alias(self, index=None, name=None):
        """The singular form (`/_alias`): indices with a matching alias; a
        name that matches nothing on any index answers 404 (an index given
        explicitly makes it an empty 200)."""
        state = self.node.cluster_service.state
        out = {}
        for idx in state.metadata.resolve_indices(index or "_all"):
            aliases = state.metadata.index(idx).aliases_dict()
            if name is not None:
                aliases = {a: sp for a, sp in aliases.items() if name_matches(a, name)}
            if aliases:
                out[idx] = {"aliases": aliases}
        if not out and name is not None and index is None:
            raise AliasesMissingError([name])
        return out

    def exists_alias(self, index=None, name=None) -> bool:
        try:
            return bool(self.get_alias(index, name))
        except SearchEngineError:
            return False

    def put_template(self, name, body):
        return self._local(A_PUT_TEMPLATE, {"name": name, "body": body})

    def delete_template(self, name):
        return self._local(A_DELETE_TEMPLATE, {"name": name})

    def get_template(self, name=None):
        state = self.node.cluster_service.state
        out = {n: t.to_dict() for n, t in state.metadata.templates
               if name is None or name_matches(n, name)}
        if name is not None and not out and not is_pattern(name):
            raise IndexTemplateMissingError(name)
        return out

    def put_warmer(self, index, name, body, doc_type=None):
        if doc_type:
            body = dict(body or {})
            body["types"] = [t for t in str(doc_type).split(",") if t]
        return self._local(A_PUT_WARMER, {"index": index or "_all", "name": name,
                                          "body": body})

    def delete_warmer(self, index, name):
        return self._local(A_DELETE_WARMER, {"index": index or "_all", "name": name})

    def get_warmer(self, index=None, name=None):
        state = self.node.cluster_service.state
        out = {}
        for idx in state.metadata.resolve_indices(index or "_all"):
            warmers = state.metadata.index(idx).warmers_dict()
            if name is not None:
                warmers = {w: sp for w, sp in warmers.items() if name_matches(w, name)}
                if not warmers:
                    continue
            if not warmers and (index is None or is_pattern(index)):
                continue
            out[idx] = {"warmers": warmers}
        return out

    def clear_cache(self, index=None, request=None, filter=None):  # noqa: A002
        extra = {}
        if request is not None:
            extra["request"] = bool(request)
        if filter is not None:
            extra["filter"] = bool(filter)
        return self.actions.broadcast(index, "clear_cache", extra=extra)

    def gateway_snapshot(self, index=None):
        """The legacy `_gateway/snapshot`: flush, then persist the cluster
        metadata; it answers zero `_shards`, as the JAX node does."""
        self.flush(index)
        self.node.gateway.persist_now()
        return {"_shards": {"total": 0, "successful": 0, "failed": 0}}


    # --- stats surfaces -----------------------------------------------------
    def stats(self, index=None):
        """Index stats: each index's shards and its device capacity stanza
        (the resident bytes by tier and the pack rollup), filtered to the
        indices `index` resolves to."""
        out = self.node.indices.stats()
        if index is not None:
            names = set(self.node.cluster_service.state.metadata
                        .resolve_indices(index))
            out = {n: v for n, v in out.items() if n in names}
        device = capacity_report(self.node.indices, self.node.device,
                                 index=set(out))["indices"]
        for name, entry in out.items():
            if name in device:
                entry["device"] = device[name]
        return out

    def segments(self, index=None):
        """Per shard, per segment: doc and posting counts and the segment's
        pack on the node's device (tf layout, bytes a posting, resident
        bytes, the dense plane's state, the similarity tables' fields).
        Host reads only."""
        state = self.node.cluster_service.state
        names = state.metadata.resolve_indices(index or "_all")
        key = pack_cache_key(self.node.device)
        total = ok = failed = 0
        indices_out = {}
        for name in names:
            table = state.routing_table.index(name)
            if table is not None:
                total += sum(1 for grp in table.shards for s in grp.shards
                             if s.active)
            svc = self.node.indices.indices.get(name)
            if svc is None:
                continue
            shards_out = {}
            for sid, shard in sorted(svc.shards.items()):
                try:
                    searcher = shard.engine.acquire_searcher()
                except SearchEngineError:
                    failed += 1
                    continue
                ok += 1
                segs = {}
                for seg in searcher.segments:
                    live = int(seg.live.sum())
                    entry = {
                        "generation": int(seg.gen),
                        "num_docs": live,
                        "deleted_docs": int(seg.doc_count) - live,
                        "doc_count": int(seg.doc_count),
                        "postings": int(len(seg.post_docs)),
                        "fields": len(seg.term_dict),
                        "search": True,
                        "committed": True,
                    }
                    packed = seg._device_cache.get(key)
                    if packed is None:
                        entry["device"] = {"packed": False}
                    else:
                        dense = packed.blk_freqs is not None
                        sim = packed.sim
                        entry["device"] = {
                            "packed": True,
                            "tf_layout": packed.tf_layout,
                            "bytes_per_posting": bytes_per_posting(
                                packed.tf_layout, dense_resident=dense),
                            "resident_bytes": int(packed_resident_bytes(packed)),
                            "doc_pad": int(packed.doc_pad),
                            "dense_plane": "resident" if dense else "lazy",
                            "sim_tables": ({"fields": list(sim.fields)}
                                           if sim is not None else None),
                        }
                    segs[f"_{seg.gen}"] = entry
                shards_out[str(sid)] = [{
                    "routing": {"state": "STARTED", "primary": bool(shard.primary),
                                "node": self.node.node_id},
                    "num_search_segments": len(searcher.segments),
                    "segments": segs,
                }]
            if shards_out:
                indices_out[name] = {"shards": shards_out}
        return {"_shards": {"total": total, "successful": ok, "failed": failed},
                "indices": indices_out}

    def indices_status(self, index=None):
        """The legacy `_status` view: each index's shards."""
        state = self.node.cluster_service.state
        names = state.metadata.resolve_indices(index or "_all")
        stats = self.node.indices.stats()
        total = ok = 0
        indices = {}
        for name in names:
            table = state.routing_table.index(name)
            if table is not None:
                for grp in table.shards:
                    total += len(grp.shards)
                    ok += sum(1 for s in grp.shards if s.active)
            st = stats.get(name)
            indices[name] = {"index": {"primary_size_in_bytes": 0},
                             "shards": (st or {}).get("shards", {})}
        return {"_shards": {"total": total, "successful": ok, "failed": 0},
                "indices": indices}

    def node_events(self, size=None):
        """This node's event journal, newest first."""
        return {"node": self.node.node_id, "name": self.node.name,
                "events": self.node.events.events(size),
                "stats": self.node.events.stats()}

    def cluster_events(self, size=None, local=False):
        """`GET /_events`: the cluster's events, newest first. A lone node's
        journal is the cluster's, so `local` reads the same (the pull from
        other nodes comes with them)."""
        mine = self.node_events(size)
        return {"cluster_name": self.node.cluster_service.state.cluster_name,
                "total": len(mine["events"]), "events": mine["events"],
                "nodes": {self.node.node_id: mine["stats"]}}

    def nodes_info(self):
        state = self.node.cluster_service.state
        nodes = {}
        for n in state.nodes.nodes:
            d = n.to_dict()
            if n.id == self.node.node_id:
                d["plugins"] = []  # the plugin service comes with A9
            nodes[n.id] = d
        return {"cluster_name": state.cluster_name, "nodes": nodes}

    def nodes_stats(self, metric=None):
        """The node's stats by section; `metric` (a comma list, the
        `/_nodes/stats/{metric}` path parameter) builds only those, and an
        unknown one answers 400."""
        from .search.service import SERVING_COUNTERS

        node = self.node

        def indices_stats():
            out = node.indices.stats()
            out["request_cache"] = node.request_cache.stats()
            out["filter_cache"] = node.filter_cache.stats()
            return out

        sections = {
            "indices": indices_stats,
            "transport": lambda: dict(node.transport.stats),
            "thread_pool": lambda: node.threadpool.stats(),
            "breakers": lambda: node.breakers.stats(),
            "admission_control": lambda: node.actions.admission.stats(),
            "search": lambda: {
                "batcher": node.search_batcher.stats(),
                "latency": node.actions.search_latency.stats(),
                "shapes": node.insights.stats()},
            "device": self._device_section,
            "warmer": lambda: node.warmer.stats(),
            "events": lambda: {"journal": node.events.stats(),
                               "watchdog": node.watchdog.stats()},
            "search_serving": lambda: dict(SERVING_COUNTERS),
            "tracing": lambda: node.tracer.stats(),
            **node.monitor.sections(),
        }
        if metric and metric not in ("_all",):
            wanted = [m.strip() for m in str(metric).split(",") if m.strip()]
            unknown = [m for m in wanted if m not in sections and m != "_all"]
            if unknown:
                raise IllegalArgumentError(
                    f"unknown metric {unknown} for [/_nodes/stats]; known "
                    f"metrics are {sorted(sections)}")
            if "_all" not in wanted:
                sections = {k: sections[k] for k in sections if k in wanted}
        return {"cluster_name": node.cluster_service.state.cluster_name,
                "nodes": {node.node_id: {k: build() for k, build in sections.items()}}}

    def _device_section(self):
        """`/_nodes/stats` `device`: the capacity ledger over the node's
        resident packs; the kernels (the sources the start built, each
        kernel's launches since the process began, the build's seconds);
        the start check's launches a kernel; the fault domains; and on a
        `cuda` node the caching allocator's bytes (`torch.cuda`)."""
        node = self.node
        out = capacity_report(node.indices, node.device)
        out["kernels"] = {"sources": cudaenv.kernel_sources(),
                          "built": sorted(node.kernel_builds),
                          "build_s": round(node.kernel_build_s, 3),
                          "launches": cudaenv.LAUNCHES.snapshot()}
        out["start_check"] = {"launches": dict(node.kernel_checks)}
        out["health"] = DEVICE_HEALTH.stats()
        if node.device.type == "cuda":
            import torch

            out["memory"] = {
                "allocated_in_bytes": int(torch.cuda.memory_allocated(node.device)),
                "reserved_in_bytes": int(torch.cuda.memory_reserved(node.device)),
                "max_allocated_in_bytes": int(
                    torch.cuda.max_memory_allocated(node.device))}
        return out
    def index(self, index, doc_type, body, id=None, routing=None, version=None,
              version_type="internal", op_type="index", refresh=False,
              parent=None, timestamp=None, ttl=None):
        return self.actions.index_doc(index, doc_type, id, body, routing=routing,
                                      version=version, version_type=version_type,
                                      op_type=op_type, refresh=refresh,
                                      parent=parent, timestamp=timestamp, ttl=ttl)

    def create(self, index, doc_type, body, id=None, **kw):
        return self.index(index, doc_type, body, id=id, op_type="create", **kw)

    def get(self, index, doc_type, id, routing=None, realtime=True, refresh=False,
            parent=None, fields=None):
        """A GET; `fields` shapes it as `_mget` shapes a document (the
        `fields` section, `_source` only when named)."""
        r = self.actions.get_doc(index, doc_type, id, routing=routing,
                                 realtime=realtime, refresh=refresh, parent=parent)
        if fields and r.get("found"):
            r = shape_get(r, fields, None)
        return r

    def mget(self, docs):
        return self.actions.multi_get(docs)

    def update(self, index, doc_type, id, body, routing=None, retry_on_conflict=0,
               parent=None, refresh=False, fields=None, ttl=None, timestamp=None,
               version=None, version_type="internal"):
        return self.actions.update_doc(index, doc_type, id, body, routing=routing,
                                       retry_on_conflict=retry_on_conflict,
                                       parent=parent, refresh=refresh, fields=fields,
                                       ttl=ttl, timestamp=timestamp, version=version,
                                       version_type=version_type)

    def delete_by_query(self, index, body):
        return self.actions.delete_by_query(index, body)

    def delete(self, index, doc_type, id, routing=None, version=None,
               version_type="internal", refresh=False, parent=None):
        return self.actions.delete_doc(index, doc_type, id, routing=routing,
                                       version=version, version_type=version_type,
                                       refresh=refresh, parent=parent)

    def bulk(self, operations, refresh=False):
        return self.actions.bulk(operations, refresh=refresh)

    def refresh(self, index=None):
        return self.actions.broadcast(index, "refresh")

    def flush(self, index=None):
        return self.actions.broadcast(index, "flush")

    def optimize(self, index=None):
        return self.actions.broadcast(index, "optimize")

    def search(self, index=None, body=None, routing=None,
               search_type="query_then_fetch", preference=None):
        return self.actions.search(index or "_all", body, routing=routing,
                                   search_type=search_type, preference=preference)

    def msearch(self, requests):
        """`[(header, body)]` → `{"responses": [...]}`, each search on the
        header's `index` (`_all` when absent); an error answers in its place
        as `{"error": ..., "status": ...}`, as on the JAX node."""
        responses = []
        for header, body in requests:
            try:
                responses.append(self.search(header.get("index", "_all"), body))
            except SearchEngineError as e:
                responses.append({"error": e.es1_string(), "status": e.status})
        return {"responses": responses}

    def count(self, index=None, body=None):
        return self.actions.count(index or "_all", body)

    def suggest(self, index, body):
        """`_suggest`: a size-0 search of the suggesters alone (the request
        cache takes it, as any size-0 body), its `suggest` section."""
        r = self.search(index, {"size": 0, "suggest": body})
        return r.get("suggest", {})

    def termvector(self, index, doc_type, id, routing=None, fields=None,
                   positions=True, offsets=True, term_statistics=False,
                   field_statistics=True):
        return self.actions.term_vector(index, doc_type, id, routing=routing,
                                        fields=fields, positions=positions,
                                        offsets=offsets,
                                        term_statistics=term_statistics,
                                        field_statistics=field_statistics)

    def mtermvectors(self, docs):
        return self.actions.multi_termvector(docs)

    def mlt(self, index, doc_type, id, mlt_fields=None, search_body=None,
            routing=None, **mlt_params):
        return self.actions.more_like_this(index, doc_type, id,
                                           mlt_fields=mlt_fields,
                                           search_body=search_body,
                                           routing=routing, **mlt_params)

    def explain(self, index, doc_type, id, body):
        """`_explain`, as the JAX node answers it: a search of a `bool` that
        must match the body's query and filters on the id; `matched`, and
        the hit's score as the explanation's value."""
        r = self.search(index, {"query": {"bool": {
            "must": [body.get("query", {"match_all": {}})],
            "filter": [{"ids": {"values": [id]}}]}}, "size": 1})
        matched = r["hits"]["total"] > 0
        out = {"_index": index, "_type": doc_type, "_id": id, "matched": matched}
        if matched:
            out["explanation"] = {"value": r["hits"]["hits"][0]["_score"],
                                  "description": "score of matching document"}
        return out

    def percolate(self, index, body):
        return self.node.percolator.percolate(index, body)

    def count_percolate(self, index, body):
        return self.node.percolator.count_percolate(index, body)

    def mpercolate(self, requests):
        return self.node.percolator.multi_percolate(requests)

    def cluster_health(self, index=None, wait_for_status=None, timeout=10.0):
        deadline = time.monotonic() + timeout
        while True:
            h = self._health(index)
            ok = wait_for_status is None or _STATUS_ORDER.get(h["status"], 0) >= \
                _STATUS_ORDER.get(wait_for_status, 0)
            if ok or time.monotonic() > deadline:
                h["timed_out"] = not ok
                return h
            time.sleep(0.05)

    def _health(self, index=None):
        state = self.node.cluster_service.state
        shards = [s for s in state.routing_table.all_shards()
                  if index is None or s.index == index]
        active = sum(1 for s in shards if s.active)
        primaries = [s for s in shards if s.primary]
        active_primaries = sum(1 for s in primaries if s.active)
        if active_primaries < len(primaries):
            status = "red"
        elif active < len(shards):
            status = "yellow"
        else:
            status = "green"
        return {
            "cluster_name": state.cluster_name,
            "status": status,
            "number_of_nodes": state.nodes.size,
            "number_of_data_nodes": len(state.nodes.data_nodes()),
            "active_primary_shards": active_primaries,
            "active_shards": active,
            "relocating_shards": 0,
            "initializing_shards": sum(1 for s in shards if s.state == "INITIALIZING"),
            "unassigned_shards": sum(1 for s in shards if s.state == "UNASSIGNED"),
        }


_STATUS_ORDER = {"red": 0, "yellow": 1, "green": 2}


def _settings_str(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _nest_keys(flat: dict) -> dict:
    """{"index.number_of_shards": "5"} → {"index": {"number_of_shards": "5"}}."""
    out: dict = {}
    for k, v in flat.items():
        parts = k.split(".")
        cur = out
        for p in parts[:-1]:
            nxt = cur.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                cur[p] = nxt
            cur = nxt
        cur[parts[-1]] = v
    return out


def _flatten_properties(props: dict, prefix: str = "", just_name: bool = False) -> dict:
    """A mapping's properties tree → {"a.b": leaf definition}, multi-fields
    included; a leaf under an object with `path: just_name` is tagged, so it
    answers to its bare name too."""
    out = {}
    for name, fdef in (props or {}).items():
        full = f"{prefix}{name}"
        if isinstance(fdef, dict) and isinstance(fdef.get("properties"), dict) and \
                fdef.get("type", "object") in ("object", "nested"):
            sub_just = just_name or fdef.get("path") == "just_name"
            out.update(_flatten_properties(fdef["properties"], full + ".", sub_just))
        else:
            leaf = dict(fdef) if isinstance(fdef, dict) else {}
            if just_name:
                leaf["_just_name"] = True
            out[full] = leaf
            if isinstance(fdef, dict) and isinstance(fdef.get("fields"), dict):
                for sub, sdef in fdef["fields"].items():
                    out[f"{full}.{sub}"] = dict(sdef) if isinstance(sdef, dict) else {}
    return out
