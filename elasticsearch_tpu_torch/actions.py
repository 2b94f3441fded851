"""Action layer: the API kernel over the transport (a trimmed copy of the JAX
package's `actions.py`), in the reference's interaction patterns:

- master-node: create an index (the matching templates' settings,
  mappings and aliases applied lowest `order` first, then the body's
  aliases and warmers), delete, open and close indices, update settings
  (`index.blocks.*` install and lift index blocks; a new
  `number_of_replicas` resizes the groups), aliases, templates and search
  warmers, apply a dynamic-mapping update, the cluster's transient and
  persistent settings, a reroute with explicit commands (URGENT), shard
  started and shard failed — run on the elected master (`_master_wrap`:
  a node that is not master forwards the request to it, and with no
  master it answers 503 MasterNotDiscoveredError), which mutates the
  cluster state on its single state thread and publishes it. A
  close drops the index's routing and blocks it (reads and writes answer
  403); an open gives it fresh routing, and its shards recover from their
  stores;
- replication: `index_doc` routes a document to its primary by djb2,
  with its `timestamp` and `ttl`, through an alias that names one index;
  the primary first checks the write consistency (`quorum` by default:
  more than half of a group of more than two copies must be active, else
  503), writes, then sends the op to every assigned replica at once and
  waits for their acks (`_replicate`: an index at the primary's version as
  an external one, a delete without a version check, on each node's
  `replica` pool); a replica that fails the op past `retry_policy`'s
  retries is reported shard-failed to the master, which routes it out and
  recovers it again. `bulk` groups the ops per shard and sends every group
  at once (no consistency check, as in the JAX package), retrying once
  against a fresh state a group whose primary had no node; the shard's
  primary then sends each applied item to its replicas in order
  (`_replicate_bulk`). The update API and delete-by-query replicate
  through these legs and the broadcast;
- the update API (`update_doc`): get → modify → index on the coordinator,
  with the read version as a compare-and-set and `retry_on_conflict`
  retries; `doc` merges deep, `upsert` / `doc_as_upsert` create, a
  `script` (script/UpdateScript) edits `ctx` and may set `ctx.op` to
  `none` (a noop) or `delete`. A bulk `update` item runs it from the bulk
  pool: its get and index round trips go to the `get` and `index` pools,
  which it never holds, so nesting cannot deadlock. No lock is held
  across either round trip;
- scatter-gather search, `query_then_fetch`: one query phase per shard, all
  in flight at once over the transport, each a failover chain across the
  group's active copies, ranked by the adaptive replica selector
  (`_query_shard_async`: a timer bounds each attempt, a failed attempt or
  a copy whose node left sends the next copy, an attempt that outlives
  its copy's p99 is hedged to the next copy within the hedge budget, and
  every failed attempt is a `_shards.failures` entry when no copy
  answers); each runs `execute_query_phase` on
  the shard's point-in-time searcher through the node's one DeviceBatcher
  onto the card, and pins that context for the fetch. The coordinator
  reduces the shards' top-k (`sort_docs`), fetches the winners from the
  pinned contexts and frees the contexts that won nothing
  (`merge_responses` assembles the response). `preference` picks the shard
  groups and copies (cluster/routing.py); `count` is a `size: 0` search;
- `dfs_query_then_fetch` (and `dfs_query_and_fetch`, served the same way):
  a DFS phase on every shard first (`_s_dfs_phase`, search/controller
  `collect_dfs`), all in flight at once; the coordinator sums the shards'
  statistics (`aggregate_dfs`) and sends them with every query phase, whose
  context weighs its clauses with them (`_shard_ctx(dfs=)`) and launches
  outside the batcher (search/service.py). A DFS phase fails over across
  the group's copies; a shard no copy answers is left out of the query
  phase and reported in `_shards.failures`;
- the shard request cache (search/request_cache.py, `node.request_cache`):
  a cache-eligible body's query phase first looks up (index, shard, view
  version, fingerprint) and a hit answers the stored partial with no
  launch; a miss stores its partial, unless it timed out, with `degraded`
  false (a degraded answer is bitwise the card's). A DFS request never
  uses the cache. `warm_shard_queries` is the warmer's re-prime of a new
  view;
- filtered aliases: a search that names a filtered alias wraps each of
  that index's shard requests in a `filtered` query with the alias's filter
  before the shard's request-cache fingerprint is taken, so a filtered
  alias never reads the unfiltered body's entry;
- broadcast: `refresh` (a refresh that installs a new view runs the
  index's search warmers through the query phase, on the node's batcher;
  a failing warmer is logged), `flush`, `optimize`, `clear_cache` (the
  shard's filter masks and request-cache entries, each tier selectable)
  on every active shard, and `delete_by_query`: each shard resolves the query's matches on the host
  (`host_match_mask` over live parent documents: a nested parent takes its
  children), tombstones them in one logged op (`Engine.delete_by_uids`)
  and refreshes, so the next view leaves them out; `_m_delete_mapping`
  drops types from the cluster state, then deletes their documents so;
- single-shard reads: `get_doc` reads one active copy of the document's
  shard (realtime from the engine's version map unless `realtime` is
  false, after a refresh when asked; type `_all` walks the index's types),
  with `_timestamp` and the remaining `_ttl`; `multi_get` runs one GET a
  document and shapes each by its `fields` and `_source` (a missing index
  or a type that does not hold the id answers `found: false`);
  `term_vector` re-analyzes one document's stored `_source` on one copy of
  its shard (`_s_termvector`, on the `get` pool), `multi_termvector`
  answers each document's in place, and `more_like_this` searches the
  document's text fields minus the document itself;
- a search body's terms lookups are resolved once on the coordinating node
  against the GET path (`_lookup_get`) before any shard runs, and each
  shard's suggester output rides its query-phase partial (and the request
  cache's entry) to the coordinator, which merges them;
- the single-document delete goes to the primary (`_p_delete`). A
  `.percolator` document written or deleted through the single-document
  actions registers or unregisters its query on the node's percolator
  (`_register_percolator`); one in a `_bulk` does not, as in the JAX
  package.

A shard whose device attempt fails with a CUDA error, or whose device
fault domain is open, answers from the host path (search/service.py): its
result crosses the transport with `degraded`, and pins and frees its context
like any other. A query phase that raises anything else that is not a
SearchEngineError (a host bug) fails the whole search: the REST layer
answers 500 with the error, after the contexts of the shards that answered
are freed. A shard whose fetch fails, with any error, drops its hits and
records a `_shards.failures` entry; the rest of the page returns.

Admission control (`self.admission`, search/service.py
SearchAdmissionController): the coordinator observes every shard phase's
latency, from the fan-out to its future's resolution, failed phases too
(but not overload rejections, which resolve at once); a search whose
remaining `timeout` budget cannot cover one expected phase answers 429
with Retry-After before the fan-out.

Observability, as in the JAX package's `actions.py`: `search` roots a
trace (or nests a `coordinator` span under the REST ingress's span) and
observes its wall in `search_latency`; every transport send under it
carries the trace context (transport/service.py). A shard's query phase
continues the trace (`shard` span), runs under a ProfileCollector when the
body asks `profile`, classifies the body into the node's query-shape
insights (count, latency from the phase's own clock pair, the batcher's
queue and pull windows, the serving outcome, the request-cache hit or
miss) and writes the slowlog line (`_maybe_slowlog`: thresholds from the
index settings, then the cluster's transient and persistent settings, with
the trace id, the shape id and the queue/device/merge breakdown). Its span
list and profile ride the response; the coordinator stitches the spans
into its trace and the profiles into the response's `profile` section. A
profiled request never answers from the request cache (it peeks, and
records the hit or miss as a profile event), and one whose device clock
cannot record its CUDA events fails the whole search (500).

A node shutdown (`nodes_shutdown`) sends `_s_shutdown_node` to each named
node on its `management` pool; the node closes itself on a thread of its
own after a short delay, so the answer leaves first; a named node may be
another node of the cluster.

The TransportClient's surface (client.py): `_s_client_nodes` answers the
cluster's node list, and `_s_client_exec` runs one whitelisted Client
method on this node, coordinated as a REST request would be.

The watchdog's events another node gossips arrive at `_s_event_publish`
(the `management` pool) and land in this node's journal, deduplicated by
their origin's seq.

Not in this slice: the SPMD mesh branch, and the alias routing values (stored and rendered; no write or search reads
them, as in the JAX package)."""

from __future__ import annotations

import base64
import json
import pickle
import threading
import time
import uuid
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from dataclasses import replace

import numpy as np

from .cluster.allocation import new_index_routing
from .cluster.service import HIGH, URGENT
from .cluster.state import (
    BLOCK_INDEX_CLOSED,
    ClusterState,
    IndexMetaData,
    IndexRoutingTable,
    IndexShardRoutingTable,
    IndexTemplateMetaData,
    ShardRouting,
)
from .common import insights as _insights
from .common import profile as profiling
from .common import tracing
from .common.deadline import NO_DEADLINE, Deadline
from .common.errors import (
    ActionNotFoundError,
    ActionRequestValidationError,
    AliasesMissingError,
    CircuitBreakingError,
    DocumentMissingError,
    IllegalArgumentError,
    IndexAlreadyExistsError,
    IndexMissingError,
    IndexShardMissingError,
    IndexWarmerMissingError,
    MasterNotDiscoveredError,
    NoShardAvailableError,
    ProfileTimingError,
    ReceiveTimeoutError,
    RejectedExecutionError,
    RoutingMissingError,
    SearchEngineError,
    TypeMissingError,
    UnavailableShardsError,
    VersionConflictError,
)
from .common.logging import get_logger
from .common.metrics import HistogramMetric
from .common.names import is_pattern, name_matches
from .common.retry import RetryPolicy
from .common.settings import Settings, validate_index_name
from .common.stream import StreamInput, StreamOutput
from .common.units import parse_time
from .index.segment import FieldStats
from .indices_service import ACTION_SHARD_FAILED, ACTION_SHARD_STARTED
from .mapper import MapperService
from .search.controller import (
    DfsResult,
    aggregate_dfs,
    collect_dfs,
    merge_responses,
    sort_docs,
)
from .script import compile_update_script
from .search.execute import ShardContext, host_match_mask
from .search.filters import clear_segment_masks
from .search.queries import MatchAllQuery, parse_query, resolve_terms_lookups
from .search.request_cache import cache_policy, request_fingerprint
from .search.service import (
    SearchAdmissionController,
    ShardQueryResult,
    execute_fetch_phase,
    execute_query_phase,
    parse_search_body,
)
from .transport import complete_fut, fut_result

A_CREATE_INDEX = "indices:admin/create"
A_DELETE_INDEX = "indices:admin/delete"
A_OPEN_INDEX = "indices:admin/open"
A_CLOSE_INDEX = "indices:admin/close"
A_UPDATE_SETTINGS = "indices:admin/settings/update"
A_ALIASES = "indices:admin/aliases"
A_PUT_TEMPLATE = "indices:admin/template/put"
A_DELETE_TEMPLATE = "indices:admin/template/delete"
A_PUT_WARMER = "indices:admin/warmers/put"
A_DELETE_WARMER = "indices:admin/warmers/delete"
A_PUT_MAPPING = "indices:admin/mapping/put"
A_DELETE_MAPPING = "indices:admin/mapping/delete"
A_CLUSTER_SETTINGS = "cluster:admin/settings/update"
A_REROUTE = "cluster:admin/reroute"
A_SHUTDOWN_NODE = "cluster:admin/nodes/shutdown"
A_MAPPING_UPDATED = "internal:cluster/mapping_updated"
A_INDEX_PRIMARY = "indices:data/write/index[p]"
A_INDEX_REPLICA = "indices:data/write/index[r]"
A_BULK_SHARD = "indices:data/write/bulk[s]"
A_DELETE_PRIMARY = "indices:data/write/delete[p]"
A_DELETE_REPLICA = "indices:data/write/delete[r]"
A_GET = "indices:data/read/get[s]"
A_TERMVECTOR = "indices:data/read/termvector[s]"
A_QUERY_PHASE = "indices:data/read/search[phase/query]"
A_FETCH_PHASE = "indices:data/read/search[phase/fetch]"
A_FREE_CONTEXT = "indices:data/read/search[free-context]"
A_DFS_PHASE = "indices:data/read/search[phase/dfs]"
A_SHARD_BROADCAST = "indices:admin/broadcast[s]"
A_EVENTS_PUBLISH = "internal:cluster/events/publish"

# how long the coordinator waits for one DFS attempt when the request set
# no budget of its own (a query attempt's is QUERY_ATTEMPT_TIMEOUT)
DFS_PHASE_TIMEOUT = 30.0
DFS_SEARCH_TYPES = ("dfs_query_then_fetch", "dfs_query_and_fetch")

# `index.blocks.*` settings and the index block each installs
_BLOCK_SETTINGS = {"index.blocks.read_only": ("index_read_only", "write"),
                   "index.blocks.read": ("index_read", "read"),
                   "index.blocks.write": ("index_write", "write"),
                   "index.blocks.metadata": ("index_metadata", "metadata")}


def _normalize_alias_specs(aliases: dict) -> dict:
    """An alias keeps `filter`, `index_routing` and `search_routing`; a bare
    `routing` sets both routings."""
    out = {}
    for name, spec in aliases.items():
        spec = {k: v for k, v in dict(spec or {}).items()
                if k in ("filter", "index_routing", "search_routing", "routing")}
        if "routing" in spec:
            r = spec.pop("routing")
            spec.setdefault("index_routing", r)
            spec.setdefault("search_routing", r)
        out[name] = spec
    return out


def _normalize_warmer(body) -> dict:
    """A warmer is `{types, source}`; a bare search body is the source."""
    body = dict(body or {})
    if "source" in body:
        return {"types": body.get("types") or [], "source": body["source"]}
    types = body.pop("types", []) or []
    return {"types": types, "source": body}


class ActionModule:
    """Registers every handler on a node and provides the coordinator entry
    points."""

    def __init__(self, node):
        self.node = node
        self.transport = node.transport
        self.cluster_service = node.cluster_service
        self.indices = node.indices
        self.routing = node.operation_routing
        self.allocation = node.allocation
        self.logger = get_logger("action", node=node.name)
        # point-in-time contexts pinned between the query and fetch phases: a
        # refresh or merge between them must not move local doc ids under
        # the fetch
        self._pinned: dict[int, tuple] = {}  # cid -> (expiry, index, shard, ctx)
        self._pinned_lock = threading.Lock()
        self._pinned_next = 1
        # the write path's retry schedule (the replica fan-out, shard-failed
        # reports): transient transport failures back off with jitter, and
        # exhaustion is reported to the master, never swallowed (tests swap
        # in a faster policy)
        self.retry_policy = RetryPolicy(max_attempts=3, base_s=0.05, cap_s=1.0)
        # deadline-aware admission: a search whose budget cannot cover one
        # expected shard phase is rejected (429) before the fan-out
        self.admission = SearchAdmissionController()
        # the cluster-level slowlog thresholds, parsed once a metadata
        # version: (version, {level: seconds | None})
        self._slowlog_cluster: tuple | None = None
        # the coordinator's search latency, accept to response (the
        # /_nodes/stats search.latency percentiles and Prometheus series)
        self.search_latency = HistogramMetric()
        t = self.transport
        for action, fn in [(A_CREATE_INDEX, self._m_create_index),
                           (A_DELETE_INDEX, self._m_delete_index),
                           (A_OPEN_INDEX, self._m_open_index),
                           (A_CLOSE_INDEX, self._m_close_index),
                           (A_UPDATE_SETTINGS, self._m_update_settings),
                           (A_ALIASES, self._m_aliases),
                           (A_PUT_TEMPLATE, self._m_put_template),
                           (A_DELETE_TEMPLATE, self._m_delete_template),
                           (A_PUT_WARMER, self._m_put_warmer),
                           (A_DELETE_WARMER, self._m_delete_warmer),
                           (A_PUT_MAPPING, self._m_put_mapping),
                           (A_DELETE_MAPPING, self._m_delete_mapping),
                           (A_MAPPING_UPDATED, self._m_mapping_updated),
                           (A_CLUSTER_SETTINGS, self._m_cluster_settings),
                           (A_REROUTE, self._m_reroute),
                           (ACTION_SHARD_STARTED, self._m_shard_started),
                           (ACTION_SHARD_FAILED, self._m_shard_failed)]:
            t.register_handler(action, self._master_wrap(action, fn))
        # data-path actions, each on its named pool
        t.register_handler(A_INDEX_PRIMARY, self._p_index, executor="index")
        t.register_handler(A_INDEX_REPLICA, self._r_index, executor="replica")
        t.register_handler(A_BULK_SHARD, self._p_bulk_shard, executor="bulk")
        t.register_handler(A_DELETE_PRIMARY, self._p_delete, executor="index")
        t.register_handler(A_DELETE_REPLICA, self._r_delete, executor="replica")
        t.register_handler(A_GET, self._s_get, executor="get")
        t.register_handler(A_TERMVECTOR, self._s_termvector, executor="get")
        t.register_handler(A_QUERY_PHASE, self._s_query_phase, executor="search")
        t.register_handler(A_FETCH_PHASE, self._s_fetch_phase, executor="search")
        t.register_handler(A_FREE_CONTEXT, self._s_free_context, executor="search")
        t.register_handler(A_DFS_PHASE, self._s_dfs_phase, executor="search")
        t.register_handler(A_SHARD_BROADCAST, self._s_broadcast,
                           executor="management")
        t.register_handler(A_SHUTDOWN_NODE, self._s_shutdown_node,
                           executor="management")
        t.register_handler(A_EVENTS_PUBLISH, self._s_event_publish,
                           executor="management")
        # the TransportClient's surface: the node list its sampler asks
        # for, and every API call as a named client method
        from .client import A_CLIENT_EXEC, A_CLIENT_NODES

        t.register_handler(A_CLIENT_NODES, self._s_client_nodes, executor="management")
        t.register_handler(A_CLIENT_EXEC, self._s_client_exec, executor="generic")

    def _s_event_publish(self, request, channel):
        """A peer watchdog's event lands in this node's journal,
        deduplicated by its origin's seq (`EventJournal.ingest`)."""
        return {"stored": self.node.events.ingest(request.get("event") or {})}

    # ================= transport-client proxy =================
    def _s_client_nodes(self, request, channel):
        state = self.cluster_service.state
        return {"nodes": [[n.id, n.name, n.transport_address]
                          for n in state.nodes.nodes]}

    def _s_client_exec(self, request, channel):
        """One proxied client method, coordinated here as if it had come
        over REST."""
        from .client import CLIENT_PROXY_METHODS

        method = str(request.get("method"))
        if method not in CLIENT_PROXY_METHODS:
            raise ActionNotFoundError(f"client method [{method}] is not proxied")
        fn = getattr(self.node.client(), method)
        return {"r": fn(**(request.get("kwargs") or {}))}

    # ================= master-node pattern =================
    def _master_wrap(self, action, fn):
        """Run a master operation here when this node is master, else
        forward it to the elected master; with no master, 503."""
        def handler(request, channel):
            state = self.cluster_service.state
            if state.nodes.master_id is None:
                raise MasterNotDiscoveredError("no master")
            if state.nodes.master_id != self.node.node_id:
                master = state.nodes.master
                return self.transport.submit_request(master.transport_address, action,
                                                     request, timeout=30.0)
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
            settings = {(k if k.startswith("index.") else f"index.{k}"): v
                        for k, v in Settings.from_flat(
                            body.get("settings") or {}).as_dict().items()}
            mappings = dict(body.get("mappings") or {})
            aliases = dict(body.get("aliases") or {})
            # the matching templates, lowest order first: the body's
            # settings win, a template's mapping or alias fills a gap only
            for tpl in state.metadata.templates_for(index):
                merged = dict(tpl.settings_map)
                merged.update(Settings.from_flat(settings).as_dict())
                settings = merged
                for ttype, m in tpl.mappings:
                    mappings.setdefault(ttype, json.loads(m) if isinstance(m, str) else m)
                for a, spec in tpl.aliases:
                    aliases.setdefault(a, spec)
            flat = {(k if k.startswith("index.") else f"index.{k}"): v
                    for k, v in Settings.from_flat(settings).as_dict().items()}
            flat.setdefault("index.number_of_shards", 5)
            flat.setdefault("index.number_of_replicas", 1)
            flat["index.number_of_shards"] = int(flat["index.number_of_shards"])
            flat["index.number_of_replicas"] = int(flat["index.number_of_replicas"])
            meta = IndexMetaData(name=index, settings_map=tuple(sorted(flat.items())))
            # the mappings are parsed before the state changes (a mapping the
            # port refuses answers 400 and creates nothing) and kept as given
            svc = MapperService(meta.settings)
            for t, m in mappings.items():
                svc.put_mapping(t, m)
                meta = meta.with_mapping(t, m)
            if aliases:
                meta = meta.with_aliases(_normalize_alias_specs(aliases))
            for wname, wbody in (body.get("warmers") or {}).items():
                meta = meta.with_warmer(wname, _normalize_warmer(wbody))
            new = state.next_version(
                metadata=state.metadata.with_index(meta),
                routing_table=state.routing_table.with_index(new_index_routing(
                    index, meta.number_of_shards, meta.number_of_replicas)))
            return self.allocation.reroute(new)

        self._submit(f"create-index[{index}]", update, priority=URGENT)
        ok = self._wait_for_active_primaries(index, timeout=10.0)
        return {"acknowledged": True, "index": index, "primaries_active": ok}

    def _m_delete_index(self, request, channel):
        """Drop the resolved indices from the metadata, the routing table
        and the blocks; each node's indices service then closes their
        shards, wipes their data and releases what they held."""
        indices = self.cluster_service.state.metadata.resolve_indices(request["index"])

        def update(state: ClusterState) -> ClusterState:
            md, rt, blocks = state.metadata, state.routing_table, state.blocks
            for index in indices:
                md = md.without_index(index)
                rt = rt.without_index(index)
                blocks = blocks.without_index(index)
            return state.next_version(metadata=md, routing_table=rt, blocks=blocks)

        self._submit(f"delete-index{indices}", update, priority=URGENT)
        self._drop_pins(indices)
        return {"acknowledged": True}

    def _m_open_index(self, request, channel):
        return self._set_index_state(request["index"], "open")

    def _m_close_index(self, request, channel):
        return self._set_index_state(request["index"], "close")

    def _set_index_state(self, index_expr, target: str) -> dict:
        """`close`: the index keeps its metadata and data, loses its routing
        (its shards close) and is blocked; `open`: fresh routing, the block
        lifted, and the reroute assigns its primaries again."""
        indices = self.cluster_service.state.metadata.resolve_indices(index_expr)

        def update(state: ClusterState) -> ClusterState:
            md, rt, blocks = state.metadata, state.routing_table, state.blocks
            for index in indices:
                meta = md.require_index(index)
                md = md.with_index(replace(meta, state=target,
                                           version=meta.version + 1))
                if target == "close":
                    rt = rt.without_index(index)
                    blocks = blocks.with_index_block(index, BLOCK_INDEX_CLOSED)
                else:
                    rt = rt.with_index(new_index_routing(
                        index, meta.number_of_shards, meta.number_of_replicas))
                    blocks = blocks.without_index(index)
            return self.allocation.reroute(
                state.next_version(metadata=md, routing_table=rt, blocks=blocks))

        self._submit(f"{target}-index{indices}", update, priority=URGENT)
        if target == "close":
            self._drop_pins(indices)
        return {"acknowledged": True}

    def _drop_pins(self, indices) -> None:
        """Forget the query-phase contexts pinned on `indices` (closed or
        deleted): their searchers must not hold the index's segments, and
        with them its device memory, until the pins expire. A fetch that
        comes later reads the shard's current searcher, as an expired pin
        does."""
        names = set(indices)
        with self._pinned_lock:
            for cid in [cid for cid, v in self._pinned.items() if v[1] in names]:
                del self._pinned[cid]

    def _m_update_settings(self, request, channel):
        """Merge the body's settings into each resolved index's; an
        `index.blocks.*` key installs or lifts its index block and a new
        `number_of_replicas` resizes the index's groups."""
        indices = self.cluster_service.state.metadata.resolve_indices(request["index"])
        flat = Settings.from_flat(request["body"].get("settings", request["body"])) \
            .as_dict()
        normalized = {(k if k.startswith("index.") else f"index.{k}"): v
                      for k, v in flat.items()}

        def update(state: ClusterState) -> ClusterState:
            md, rt, blocks = state.metadata, state.routing_table, state.blocks
            for index in indices:
                meta = md.require_index(index)
                old_replicas = meta.number_of_replicas
                meta = meta.with_settings(normalized)
                md = md.with_index(meta)
                if meta.number_of_replicas != old_replicas:
                    rt = self._resize_replicas(rt, index, meta.number_of_replicas)
                for key, block in _BLOCK_SETTINGS.items():
                    if key in normalized:
                        if str(normalized[key]).lower() in ("true", "1"):
                            blocks = blocks.with_index_block(index, block)
                        else:
                            blocks = blocks.without_index_block(index, block)
            return self.allocation.reroute(
                state.next_version(metadata=md, routing_table=rt, blocks=blocks))

        self._submit(f"update-settings{indices}", update)
        return {"acknowledged": True}

    @staticmethod
    def _resize_replicas(rt, index: str, target: int):
        """Each of the index's groups with `target` replicas (new ones
        unassigned)."""
        table = rt.index(index)
        groups = []
        for grp in table.shards:
            primary = [s for s in grp.shards if s.primary]
            replicas = [s for s in grp.shards if not s.primary]
            while len(replicas) > target:
                replicas.pop()
            while len(replicas) < target:
                replicas.append(ShardRouting(index, grp.shards[0].shard_id, None, False))
            groups.append(IndexShardRoutingTable(tuple(primary + replicas)))
        return rt.with_index(IndexRoutingTable(index, tuple(groups)))

    def _m_aliases(self, request, channel):
        """Apply `add` and `remove` actions in order; the index expressions
        resolve before anything changes, and a `remove` whose alias
        expressions match no alias of its indices answers 404
        AliasesMissingException."""
        state0 = self.cluster_service.state
        resolved = []
        for entry in request["body"].get("actions", []):
            (op, spec), = entry.items()
            indices = state0.metadata.resolve_indices(
                spec.get("index") or spec.get("indices") or "_all")
            aliases = spec.get("alias") or spec.get("aliases") or []
            if not isinstance(aliases, list):
                aliases = [a.strip() for a in str(aliases).split(",")]
            resolved.append((op, spec, indices, aliases))
        for op, _spec, indices, alias_exprs in resolved:
            if op == "remove" and not any(
                    name_matches(a, expr)
                    for index in indices
                    for a, _ in state0.metadata.require_index(index).aliases
                    for expr in alias_exprs):
                raise AliasesMissingError(alias_exprs)

        def update(state: ClusterState) -> ClusterState:
            md = state.metadata
            for op, spec, indices, alias_exprs in resolved:
                for index in indices:
                    meta = md.require_index(index)
                    aliases = dict(meta.aliases)
                    if op == "add":
                        for alias in alias_exprs:
                            aliases.update(_normalize_alias_specs({alias: spec}))
                    elif op == "remove":
                        for expr in alias_exprs:
                            for a in [a for a in aliases if name_matches(a, expr)]:
                                aliases.pop(a)
                    md = md.with_index(meta.with_aliases(aliases))
            return state.next_version(metadata=md)

        self._submit("aliases", update)
        return {"acknowledged": True}

    def _m_put_template(self, request, channel):
        name, body = request["name"], request["body"]
        flat_settings = {
            (k if k.startswith("index.") else f"index.{k}"): v
            for k, v in Settings.from_flat(body.get("settings", {})).as_dict().items()}

        def update(state: ClusterState) -> ClusterState:
            tpl = IndexTemplateMetaData(
                name=name, template=body.get("template", "*"),
                order=int(body.get("order", 0)),
                settings_map=tuple(sorted(flat_settings.items())),
                mappings=tuple((t, json.dumps(m))
                               for t, m in (body.get("mappings") or {}).items()),
                aliases=tuple(sorted((body.get("aliases") or {}).items())))
            return state.next_version(metadata=state.metadata.with_template(tpl))

        self._submit(f"put-template[{name}]", update)
        return {"acknowledged": True}

    def _m_delete_template(self, request, channel):
        name = request["name"]
        self._submit(f"delete-template[{name}]", lambda state: state.next_version(
            metadata=state.metadata.without_template(name)))
        return {"acknowledged": True}

    def _m_put_warmer(self, request, channel):
        """Register a search warmer on each resolved index: its body runs
        on every explicit refresh that installs a new view (`_run_warmers`)."""
        indices = self.cluster_service.state.metadata.resolve_indices(request["index"])
        name, body = request["name"], _normalize_warmer(request.get("body"))

        def update(state: ClusterState) -> ClusterState:
            md = state.metadata
            for index in indices:
                md = md.with_index(md.require_index(index).with_warmer(name, body))
            return state.next_version(metadata=md)

        self._submit(f"put-warmer[{name}]", update)
        return {"acknowledged": True}

    def _m_delete_warmer(self, request, channel):
        state0 = self.cluster_service.state
        indices = state0.metadata.resolve_indices(request["index"])
        name_expr = request["name"] or "_all"
        matched = {index: [w for w, _ in state0.metadata.require_index(index).warmers
                           if name_matches(w, name_expr)]
                   for index in indices}
        if not any(matched.values()):
            raise IndexWarmerMissingError(name_expr)

        def update(state: ClusterState) -> ClusterState:
            md = state.metadata
            for index, names in matched.items():
                meta = md.require_index(index)
                for w in names:
                    meta = meta.with_warmer(w, None)
                md = md.with_index(meta)
            return state.next_version(metadata=md)

        self._submit(f"delete-warmer[{name_expr}]", update)
        return {"acknowledged": True}

    def _run_warmers(self, index: str, shard_id: int):
        """Run the index's registered warmers on the shard's new view,
        through the query phase and the node's batcher, as any search runs
        (filter masks and packs warm before user traffic). A failing warmer
        is logged, never raised."""
        meta = self.cluster_service.state.metadata.index(index)
        if meta is None or not meta.warmers:
            return
        for name, body in meta.warmers_dict().items():
            try:
                ctx = self._shard_ctx(index, shard_id)
                execute_query_phase(ctx, parse_search_body(body.get("source", body)),
                                    shard_id=shard_id)
            except SearchEngineError as e:
                self.logger.debug("warmer [%s] failed on [%s][%d]: %s",
                                  name, index, shard_id, e)

    def _m_put_mapping(self, request, channel):
        """Merge a type's mapping into each named index's mapping in the
        cluster state, through a throwaway mapper (a conflict raises
        MapperParsingError and changes nothing)."""
        indices = self.cluster_service.state.metadata.resolve_indices(request["index"])
        type_name = request["type"]
        mapping = request["body"].get(type_name, request["body"])

        def update(state: ClusterState) -> ClusterState:
            md = state.metadata
            for index in indices:
                meta = md.require_index(index)
                svc = MapperService(meta.settings)
                existing = meta.mapping(type_name)
                if existing:
                    svc.put_mapping(type_name, existing)
                svc.put_mapping(type_name, mapping)
                md = md.with_index(meta.with_mapping(
                    type_name, svc.mappings_dict()[type_name]))
            return state.next_version(metadata=md)

        self._submit(f"put-mapping[{indices}/{type_name}]", update)
        return {"acknowledged": True}

    def _m_mapping_updated(self, request, channel):
        """A data node's dynamic mapping grew: merge it into the index's
        mapping in the cluster state (a conflict raises)."""
        return self._m_put_mapping(
            {"index": request["index"], "type": request["type"],
             "body": request["mapping"]}, channel)

    def _m_delete_mapping(self, request, channel):
        """Drop the matching types' mappings from every resolved index, then
        delete their documents (`delete_by_query` on a `type` filter); no
        matching type answers 404 TypeMissingException."""
        state0 = self.cluster_service.state
        indices = state0.metadata.resolve_indices(request["index"])
        type_expr = request["type"]
        matched = {
            index: [t for t, _ in state0.metadata.require_index(index).mappings
                    if name_matches(t, type_expr)]
            for index in indices}
        if not any(matched.values()):
            raise TypeMissingError(f"type[[{type_expr}]] missing")

        def update(state: ClusterState) -> ClusterState:
            md = state.metadata
            for index, types in matched.items():
                meta = md.require_index(index)
                for t in types:
                    meta = meta.without_mapping(t)
                md = md.with_index(meta)
            return state.next_version(metadata=md)

        self._submit(f"delete-mapping[{indices}/{type_expr}]", update)
        for index, types in matched.items():
            for t in types:
                try:
                    self.delete_by_query(index, {"query": {
                        "filtered": {"query": {"match_all": {}},
                                     "filter": {"type": {"value": t}}}}})
                except SearchEngineError as e:
                    self.logger.warning(
                        "delete-mapping [%s/%s]: mapping removed but the purge of "
                        "its documents failed: %s", index, t, e)
        return {"acknowledged": True}

    def get_mapping(self, index=None, doc_type=None) -> dict:
        """`{index: {"mappings": {type: mapping}}}` from the cluster state; a
        type expression filters the types, an index without a matching type
        is left out, and so is an index without mappings when the index
        expression lists several."""
        state = self.cluster_service.state
        out = {}
        for name in state.metadata.resolve_indices(index or "_all"):
            mappings = state.metadata.index(name).mappings_dict()
            if doc_type:
                mappings = {t: m for t, m in mappings.items()
                            if name_matches(t, doc_type)}
                if not mappings:
                    continue
            if not mappings and (index is None or is_pattern(index)):
                continue
            out[name] = {"mappings": mappings}
        return out

    def _m_cluster_settings(self, request, channel):
        body = request["body"]

        def update(state: ClusterState) -> ClusterState:
            md = state.metadata
            transient = dict(md.transient_settings)
            transient.update(Settings.from_flat(body.get("transient", {})).as_dict())
            persistent = dict(md.persistent_settings)
            persistent.update(Settings.from_flat(body.get("persistent", {})).as_dict())
            md = replace(md, transient_settings=tuple(sorted(transient.items())),
                         persistent_settings=tuple(sorted(persistent.items())),
                         version=md.version + 1)
            return state.next_version(metadata=md)

        self._submit("cluster-settings", update)
        return {"acknowledged": True,
                "transient": body.get("transient", {}),
                "persistent": body.get("persistent", {})}

    def _m_reroute(self, request, channel):
        """The explicit commands, in order, on the routing table: `move`
        (an active copy on `from_node` goes INITIALIZING on `to_node`),
        `cancel` (the replica on `node` goes UNASSIGNED), `allocate` and
        `allocate_replica` (the group's first unassigned replica goes
        INITIALIZING on `node`, and recovers from its primary); then the
        allocation's own reroute. Each command applies as given, as on the
        JAX node."""
        commands = (request.get("body") or {}).get("commands", [])

        def update(state: ClusterState) -> ClusterState:
            for entry in commands:
                (cmd, spec), = entry.items()
                index, shard = spec["index"], int(spec["shard"])
                table = state.routing_table.index(index)
                group = table.shard(shard)
                shards = list(group.shards)
                if cmd in ("move",):
                    for i, s in enumerate(shards):
                        if s.node_id == spec["from_node"] and s.active:
                            shards[i] = replace(s, node_id=spec["to_node"],
                                                state="INITIALIZING")
                elif cmd in ("cancel",):
                    for i, s in enumerate(shards):
                        if s.node_id == spec.get("node") and not s.primary:
                            shards[i] = replace(s, node_id=None, state="UNASSIGNED")
                elif cmd in ("allocate", "allocate_replica"):
                    for i, s in enumerate(shards):
                        if not s.assigned and not s.primary:
                            shards[i] = replace(s, node_id=spec["node"],
                                                state="INITIALIZING")
                            break
                groups = list(table.shards)
                groups[shard] = IndexShardRoutingTable(tuple(shards))
                state = state.next_version(routing_table=state.routing_table.with_index(
                    IndexRoutingTable(index, tuple(groups))))
            return self.allocation.reroute(state)

        new_state = self._submit("reroute", update, priority=URGENT)
        return {"acknowledged": True, "state_version": new_state.version}

    def _m_shard_started(self, request, channel):
        shard = ShardRouting.from_dict(request["shard"])
        self._submit(f"shard-started[{shard.index}][{shard.shard_id}]",
                     lambda state: self.allocation.apply_started_shards(state, [shard]),
                     priority=URGENT)
        return {"ok": True}

    def _m_shard_failed(self, request, channel):
        shard = ShardRouting.from_dict(request["shard"])
        self._submit(f"shard-failed[{shard.index}][{shard.shard_id}]",
                     lambda state: self.allocation.apply_failed_shard(state, shard),
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
        """Auto-create a missing index with the defaults (a `_bulk` item's
        index: an alias's name too, as in the JAX package)."""
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

    # ================= node shutdown =================
    def nodes_shutdown(self, node_ids=None, delay_s: float = 0.2) -> dict:
        """Send a shutdown order to the resolved nodes (None or `_all`,
        `_local`, `_master`, ids or names; an unknown one is skipped); each
        closes itself after `delay_s`, so the answer leaves first."""
        state = self.cluster_service.state
        targets = []
        spec = node_ids
        if spec in (None, "", "_all"):
            targets = list(state.nodes.nodes)
        else:
            wanted = [s.strip() for s in str(spec).split(",") if s.strip()]
            for w in wanted:
                if w == "_local":
                    targets.append(state.nodes.get(self.node.local_node.id))
                elif w == "_master":
                    targets.append(state.nodes.master)
                else:
                    targets.extend(n for n in state.nodes.nodes
                                   if n.id == w or n.name == w)
        targets = [t2 for t2 in targets if t2 is not None]
        acked = {}
        for n in targets:
            try:
                self.transport.submit_request(
                    n, A_SHUTDOWN_NODE, {"delay_s": delay_s}, timeout=10.0)
                acked[n.id] = {"name": n.name}
            except SearchEngineError:
                pass  # already gone: a shutdown is best-effort
        return {"cluster_name": state.cluster_name, "nodes": acked}

    def _s_shutdown_node(self, request, channel):
        delay = float(request.get("delay_s", 0.2))

        def _close():
            time.sleep(delay)
            try:
                self.node.close()
            except Exception:  # noqa: BLE001 — a shutdown must not raise upward
                self.logger.warning("node close failed", exc_info=True)

        threading.Thread(target=_close, daemon=True,
                         name=f"estpu_torch-shutdown[{self.node.name}]").start()
        return {"ok": True}

    # ================= writes, primary only =================
    def _required_routing_check(self, index: str, type_name: str, doc_id: str,
                                routing) -> None:
        """A type whose mapping has `_routing.required` or `_parent` refuses
        a single-document write without a routing value (a `parent` routes
        the document; a `_routing.path` in the source does not count here,
        nor is a `_bulk` item checked: the JAX package's behaviour)."""
        if routing is not None:
            return
        meta = self.cluster_service.state.metadata.index(index)
        mapping = meta.mapping(type_name) if meta is not None and type_name \
            and type_name != "_all" else None
        if mapping and (mapping.get("_routing", {}).get("required")
                        or "_parent" in mapping):
            raise RoutingMissingError(index, type_name, doc_id)

    def index_doc(self, index: str, type_name: str, doc_id: str | None,
                  source: dict, routing=None, version=None,
                  version_type="internal", op_type="index", refresh=False,
                  parent=None, timestamp=None, ttl=None,
                  consistency="quorum") -> dict:
        """Index a document on its primary (through an alias that names one
        index); a child's `parent` routes it when no `routing` is given.
        The primary checks `consistency` before it writes."""
        index = self._resolve_index_write(index, create=True)
        if doc_id is None:
            doc_id = uuid.uuid4().hex[:20]
        effective_routing = routing if routing is not None else parent
        self._required_routing_check(index, type_name, doc_id, effective_routing)
        req = {"index": index, "type": type_name, "id": doc_id, "source": source,
               "routing": routing, "parent": parent, "timestamp": timestamp,
               "ttl": ttl, "version": version, "version_type": version_type,
               "op_type": op_type, "refresh": refresh, "consistency": consistency}
        return self._route_to_primary(index, doc_id, effective_routing,
                                      A_INDEX_PRIMARY, req)

    def _route_to_primary(self, index: str, doc_id: str, routing, action: str,
                          req: dict) -> dict:
        """Send a single-document write to its shard's primary, waiting up to
        10 s for the primary to be active."""
        state = self.cluster_service.state
        state.blocks.check("write", index)
        deadline = time.monotonic() + 10.0
        while True:
            sid = self.routing.shard_id(state, index, doc_id, routing)
            node = self._primary_node(state, index, sid)
            if node is not None:
                req["shard"] = sid
                return self.transport.submit_request(node, action, req)
            if time.monotonic() > deadline:
                raise UnavailableShardsError(
                    f"primary not active for [{index}] doc [{doc_id}]")
            time.sleep(0.05)  # wait for the next cluster state
            state = self.cluster_service.state

    def _register_percolator(self, index: str, request: dict, delete: bool = False):
        """A `.percolator` document's query joins (or leaves) the index's
        percolator registry, before the engine write, as in the JAX
        package."""
        if request.get("type") != ".percolator":
            return
        if delete:
            self.node.percolator.unregister_query(index, request["id"])
        else:
            self.node.percolator.register_query(index, request["id"],
                                                request.get("source") or {})

    def _check_consistency(self, index: str, shard_id: int, consistency: str):
        """The write-consistency precheck of the group: `one` needs one
        active copy, `all` every copy, `quorum` (the default) more than half
        of a group of more than two copies and one copy otherwise; too few
        active copies answer 503."""
        group = self.cluster_service.state.routing_table.index(index).shard(shard_id)
        size = group.size()
        active = len(group.active_shards())
        if consistency == "one":
            required = 1
        elif consistency == "all":
            required = size
        else:
            required = size // 2 + 1 if size > 2 else 1
        if active < required:
            raise UnavailableShardsError(
                f"not enough active copies for [{index}][{shard_id}]: "
                f"{active} < required {required}")

    def _p_index(self, request, channel):
        index, shard_id = request["index"], request["shard"]
        self._check_consistency(index, shard_id, request.get("consistency", "quorum"))
        self._register_percolator(index, request)
        shard = self.indices.index_service(index).shard(shard_id)
        mapper = shard.engine.mapper_service.mapper_for(request["type"])
        known_before = set(mapper.fields)
        version, created = shard.engine.index(
            request["type"], request["id"], request["source"],
            routing=request.get("routing"), version=request.get("version"),
            version_type=request.get("version_type", "internal"),
            op_type=request.get("op_type", "index"), parent=request.get("parent"),
            timestamp=request.get("timestamp"), ttl=request.get("ttl"))
        if set(mapper.fields) - known_before:
            # the dynamic mapping grew: propagate it to the cluster state
            try:
                self.transport.submit_request(
                    self.node.local_node, A_MAPPING_UPDATED,
                    {"index": index, "type": request["type"],
                     "mapping": mapper.to_mapping()}, timeout=10.0)
            except SearchEngineError as e:
                self.logger.warning("mapping update propagation failed: %s", e)
        self._replicate(index, shard_id, A_INDEX_REPLICA,
                        {**request, "version": version, "version_type": "external"})
        if request.get("refresh"):
            shard.engine.refresh()
        shard.engine.maybe_flush()
        return {"_index": index, "_type": request["type"], "_id": request["id"],
                "_version": version, "created": created}

    def _r_index(self, request, channel):
        """A replica's index: the primary's version, applied as an external
        one (a copy that already holds a newer version keeps it); the op's
        parent, timestamp and ttl are not applied, as on the JAX node."""
        self._register_percolator(request["index"], request)
        shard = self.indices.index_service(request["index"]).shard(request["shard"])
        try:
            shard.engine.index(request["type"], request["id"], request["source"],
                               routing=request.get("routing"),
                               version=request.get("version"), version_type="external")
        except VersionConflictError:
            pass  # the replica already holds a newer copy
        if request.get("refresh"):
            shard.engine.refresh()
        return {"ok": True}

    def _resolve_index_write(self, index: str, create: bool = False) -> str:
        """A write names one concrete index, or an alias (or wildcard) that
        resolves to exactly one; with `create`, a name that resolves to
        nothing is created with the defaults first."""
        md = self.cluster_service.state.metadata
        if md.has_index(index):
            return index
        try:
            resolved = md.resolve_indices(index)
        except IndexMissingError:
            if not create:
                raise
            self._ensure_index(index)
            return self._resolve_index_write(index)
        if len(resolved) != 1:
            raise IndexMissingError(index)
        return resolved[0]

    def delete_doc(self, index: str, type_name: str, doc_id: str, routing=None,
                   version=None, version_type="internal", refresh=False,
                   parent=None) -> dict:
        index = self._resolve_index_write(index)
        effective_routing = routing if routing is not None else parent
        self._required_routing_check(index, type_name, doc_id, effective_routing)
        req = {"index": index, "type": type_name, "id": doc_id, "routing": routing,
               "version": version, "version_type": version_type, "refresh": refresh}
        return self._route_to_primary(index, doc_id, effective_routing,
                                      A_DELETE_PRIMARY, req)

    def _p_delete(self, request, channel):
        index, shard_id = request["index"], request["shard"]
        self._register_percolator(index, request, delete=True)
        shard = self.indices.index_service(index).shard(shard_id)
        version, found = shard.engine.delete(
            request["type"], request["id"], version=request.get("version"),
            version_type=request.get("version_type", "internal"))
        self._replicate(index, shard_id, A_DELETE_REPLICA, dict(request))
        if request.get("refresh"):
            shard.engine.refresh()
        return {"_index": index, "_type": request["type"], "_id": request["id"],
                "_version": version, "found": found}

    def _r_delete(self, request, channel):
        """A replica's delete, with no version check (the JAX node's)."""
        shard = self.indices.index_service(request["index"]).shard(request["shard"])
        try:
            shard.engine.delete(request["type"], request["id"])
        except SearchEngineError:
            pass
        return {"ok": True}

    # how long one replica op may take, its retries included
    REPLICA_OP_TIMEOUT = 30.0

    def _replicate(self, index: str, shard_id: int, action: str, request: dict):
        """Send the op to every assigned replica at once and wait for every
        ack (synchronous replication). Transient failures retry through
        `retry_policy`; a copy that exhausts them is reported shard-failed
        to the master, which routes it out and recovers it again. A copy
        its node has not created yet (the node has not applied the state
        that assigned it) answers that it is missing, and is left alone:
        its peer recovery starts after this op reached the primary, so it
        copies the op. The JAX node reports such a copy failed and recovers
        it again."""
        state = self.cluster_service.state
        group = state.routing_table.index(index).shard(shard_id)
        futs = []
        for replica in group.replicas():
            if not replica.assigned:
                continue
            node = state.nodes.get(replica.node_id)
            if node is None:
                continue
            futs.append((replica, node, self.transport.send_request(node, action, request)))
        for replica, node, fut in futs:
            try:
                self._await_replica_op(node, action, request, fut)
            except (IndexMissingError, IndexShardMissingError):
                pass  # not created there yet: its recovery copies this op
            except SearchEngineError as e:
                self._report_replica_failed(index, shard_id, replica, e)

    def _await_replica_op(self, node, action: str, request: dict, first_fut=None):
        """One replica's ack: the first attempt may be in flight already,
        retries re-send with backoff, and the whole sequence shares one
        REPLICA_OP_TIMEOUT deadline."""
        deadline = Deadline.after(self.REPLICA_OP_TIMEOUT)
        pending = [first_fut] if first_fut is not None else []

        def one_attempt():
            fut = pending.pop() if pending else \
                self.transport.send_request(node, action, request)
            return fut_result(fut, deadline.clamp(self.REPLICA_OP_TIMEOUT))

        return self.retry_policy.call(one_attempt, deadline=deadline,
                                      describe=f"replica op [{action}]")

    def _report_replica_failed(self, index: str, shard_id: int, replica, error):
        """Mark a replica copy failed on the master; the report retries, and
        if even that gives up the failure is logged at error level."""
        self.logger.warning("replica [%s][%d] on %s failed: %s — reporting "
                            "shard-failed", index, shard_id, replica.node_id, error)
        try:
            self.retry_policy.call(
                lambda: self.transport.submit_request(
                    self.node.local_node, ACTION_SHARD_FAILED,
                    {"shard": replica.to_dict(), "reason": str(error)}, timeout=10.0),
                deadline=Deadline.after(20.0), describe="shard-failed report")
        except SearchEngineError as e:
            self.logger.error(
                "could not report shard-failed for [%s][%d] on %s (%s); the copy "
                "may serve stale reads until the next cluster-state change or "
                "recovery", index, shard_id, replica.node_id, e)

    def update_doc(self, index: str, type_name: str, doc_id: str, body: dict,
                   routing=None, retry_on_conflict: int = 0, parent=None,
                   refresh=False, fields=None, ttl=None, timestamp=None,
                   version=None, version_type="internal") -> dict:
        """The update API: get → modify → index on this coordinating node,
        the index carrying the read version (a compare-and-set), a
        VersionConflictError retried `retry_on_conflict` times; a missing
        index is created as the index action creates it."""
        index = self._resolve_index_write(index, create=True)
        effective_routing = routing if routing is not None else parent
        self._required_routing_check(index, type_name, doc_id, effective_routing)
        if isinstance(fields, str):
            fields = [f.strip() for f in fields.split(",")]
        last_error = None
        for _ in range(retry_on_conflict + 1):
            try:
                current = self.get_doc(index, type_name, doc_id,
                                       routing=effective_routing)
                noop = False
                if not current["found"]:
                    # an internal compare-and-set against a missing document
                    # is a conflict, not a 404
                    if version is not None and version_type == "internal":
                        raise VersionConflictError(
                            f"{type_name}#{doc_id}", 0, version)
                    if "upsert" in body:
                        source = body["upsert"]
                    elif body.get("doc_as_upsert") and "doc" in body:
                        source = body["doc"]
                    else:
                        raise DocumentMissingError(
                            f"[{index}][{type_name}][{doc_id}] missing")
                    r = self.index_doc(index, type_name, doc_id, source,
                                       routing=routing, parent=parent,
                                       version=version, version_type=version_type,
                                       op_type="create" if version is None else "index",
                                       refresh=refresh, ttl=ttl, timestamp=timestamp)
                else:
                    source = dict(current["_source"])
                    op = "index"
                    if "script" in body:
                        us = compile_update_script(body["script"],
                                                   body.get("params", {}),
                                                   lang=body.get("lang"))
                        ctx = {"_source": source, "op": "index",
                               "_index": index, "_type": type_name, "_id": doc_id,
                               "_version": current.get("_version"),
                               "_routing": current.get("_routing"),
                               "_parent": current.get("_parent"),
                               "_ttl": ttl, "_timestamp": timestamp}
                        us.run(ctx)
                        source = ctx.get("_source", source)
                        op = ctx.get("op", "index")
                        if ctx.get("_ttl") is not None:
                            ttl = ctx["_ttl"]
                        if ctx.get("_timestamp") is not None:
                            timestamp = ctx["_timestamp"]
                    elif "doc" in body:
                        _deep_merge(source, body["doc"])
                    if op == "delete":
                        r = self.delete_doc(index, type_name, doc_id, routing=routing,
                                            parent=parent, refresh=refresh)
                        r.pop("found", None)
                    elif op == "none":
                        noop = True
                        r = {"_index": index, "_type": type_name, "_id": doc_id,
                             "_version": current["_version"]}
                    else:
                        r = self.index_doc(index, type_name, doc_id, source,
                                           routing=routing, parent=parent,
                                           version=version if version is not None
                                           else current["_version"],
                                           version_type=version_type,
                                           refresh=refresh, ttl=ttl,
                                           timestamp=timestamp)
                out = {"_index": index, "_type": type_name, "_id": doc_id,
                       "_version": r.get("_version", current.get("_version", 1))}
                if fields:
                    # the get section from the state in hand: no further round
                    # trip, and the version reported is the one written
                    pseudo = {"found": True, "_source": source,
                              "_version": out["_version"]}
                    if effective_routing is not None:
                        pseudo["_routing"] = str(effective_routing)
                    if parent is not None:
                        pseudo["_parent"] = str(parent)
                    shaped = shape_get(pseudo, fields, None)
                    out["get"] = {k: shaped[k] for k in ("found", "_source", "fields")
                                  if k in shaped}
                if noop:
                    out["noop"] = True
                return out
            except VersionConflictError as e:
                last_error = e
        raise last_error

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

        def dispatch(node, index, shard_id, items):
            futs.append((items, self.transport.send_request(node, A_BULK_SHARD, {
                "index": index, "shard": shard_id, "refresh": refresh,
                "items": [item for _, item in items]})))

        unrouted = []
        for (index, shard_id), items in by_shard.items():
            node = self._primary_node(state, index, shard_id)
            if node is None:
                unrouted.append((index, shard_id, items))
            else:
                dispatch(node, index, shard_id, items)
        if unrouted:
            # one retry against a fresh state: a primary with no node is
            # usually mid-failover, and the next state names its new home
            time.sleep(0.1)
            state = self.cluster_service.state
            for index, shard_id, items in unrouted:
                node = self._primary_node(state, index, shard_id)
                if node is None:
                    for i, item in items:
                        results[i] = {"error": "primary unavailable", "status": 503,
                                      **item}
                else:
                    dispatch(node, index, shard_id, items)
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
                elif op == "update":
                    # the update API from this bulk-pool thread: its round
                    # trips run on the get and index pools
                    r = self.update_doc(index, item["type"], item["id"],
                                        item.get("source") or {},
                                        routing=item.get("routing"))
                    out.append({**r, "status": 200, "op": op})
                else:
                    out.append({"error": f"unknown bulk op [{op}]", "status": 400,
                                "op": op})
            except SearchEngineError as e:
                out.append({**base, "error": e.to_dict(), "status": e.status,
                            "op": op})
        self._replicate_bulk(index, shard_id, request["items"], out)
        if request.get("refresh"):
            shard.engine.refresh()
        shard.engine.maybe_flush()
        return {"items": out}

    def _replicate_bulk(self, index: str, shard_id: int, items: list, out: list):
        """The replica leg of a shard's bulk: each item the primary applied
        goes to every assigned replica as its own op, in order (an index,
        create or update as an index at the primary's version; an update's
        own index round trip replicated it already, so its copy here is a
        version no-op, as on the JAX node). A replica that exhausts its
        retries is reported shard-failed and gets no further op: its
        recovery resyncs the whole copy."""
        state = self.cluster_service.state
        group = state.routing_table.index(index).shard(shard_id)
        for replica in group.replicas():
            if not replica.assigned:
                continue
            node = state.nodes.get(replica.node_id)
            if node is None:
                continue
            for item, r in zip(items, out):
                if "error" in r:
                    continue
                base = {"index": index, "shard": shard_id, "type": item["type"],
                        "id": item["id"]}
                if item.get("op") in ("index", "create", "update"):
                    action, req = A_INDEX_REPLICA, {
                        **base, "source": item.get("source") or {},
                        "routing": item.get("routing"), "version": r.get("_version"),
                        "version_type": "external"}
                elif item.get("op") == "delete":
                    action, req = A_DELETE_REPLICA, base
                else:
                    continue
                try:
                    self._await_replica_op(node, action, req)
                except (IndexMissingError, IndexShardMissingError):
                    break  # not created there yet: its recovery copies these ops
                except SearchEngineError as e:
                    self._report_replica_failed(index, shard_id, replica, e)
                    break

    # ================= scatter-gather search =================
    def search(self, index_expr, body: dict | None = None, routing=None,
               search_type: str = "query_then_fetch", preference=None) -> dict:
        """The tracing and latency wrapper of the scatter-gather: a thread
        that carries a span (the REST ingress rooted the trace, or decided
        against it) nests a `coordinator` span under it; a direct call roots
        a trace here, at the tracer's rate."""
        t0 = time.monotonic()
        parent = tracing.current_span()
        if parent is not None:
            span = parent.child("coordinator")
        else:
            span = self.node.tracer.start_trace("coordinator").root
        try:
            with tracing.activate(span):
                return self._search_inner(index_expr, body, routing,
                                          search_type, preference)
        finally:
            span.end()
            self.search_latency.observe(time.monotonic() - t0)

    def _search_inner(self, index_expr, body: dict | None, routing,
                      search_type: str, preference) -> dict:
        t0 = time.monotonic()
        state = self.cluster_service.state
        indices = state.metadata.resolve_indices(index_expr)
        for i in indices:
            state.blocks.check("read", i)
        # a filtered alias the expression names composes into its index's
        # shard requests
        alias_filters = {i: state.metadata.alias_filter(i, index_expr) for i in indices}
        # terms lookups resolve here, once, against the GET path: every
        # shard sees the same literal values
        body = resolve_terms_lookups(body, self._lookup_get)
        req = parse_search_body(body)
        deadline = Deadline.after(req.timeout_s) if req.timeout_s is not None \
            else NO_DEADLINE
        # a budget that cannot cover one expected shard phase: 429 now
        self.admission.admit(deadline)
        # cache-affinity routing: a cache-eligible body (the shard's own
        # `cache_policy`) carries its fingerprint into copy selection, so
        # the same hot body lands on the same healthy copy and the copies'
        # request caches partition instead of duplicating
        affinity = None
        if self.node.request_cache.enabled and cache_policy(body):
            affinity = request_fingerprint(body)
        shards = self.routing.search_shards(state, indices, routing, preference,
                                            affinity=affinity)
        dfs_stats, dfs_failed = None, set()
        if search_type in DFS_SEARCH_TYPES:
            dfs_stats, dfs_failed = self._dfs_round(state, shards, body, deadline)
        # every shard's query phase in flight at once, each a failover chain
        # across the group's copies driven by future callbacks (a shard
        # whose DFS phase failed is left out: stats that omit it would skew
        # the rest)
        t_fanout = time.monotonic()
        failures, terminals = [], []
        # a hard copy pin (`_only_node:`, `_primary`, also after a
        # `_shards:N;` prefix) never hedges: an answer from a copy the
        # caller pinned away from breaks the preference even on success.
        # Soft preferences name a starting point and keep hedging
        _, pin = self.routing.split_preference(preference)
        pin = pin or ""
        allow_hedge = not pin.startswith("_only_node:") and pin != "_primary"
        futs = []
        for ordinal, copy in enumerate(shards):
            if ordinal in dfs_failed:
                failures.append({"index": copy.index, "shard": copy.shard_id,
                                 "reason": "dfs phase failed on every copy"})
                continue
            futs.append((ordinal, copy, self._query_shard_async(
                state, copy, body, alias_filters, dfs_stats, deadline,
                allow_hedge=allow_hedge)))
        results: list[ShardQueryResult] = []
        # ordinal -> (index, real shard id, node, pinned context id): the
        # coordinator's merge identity is the ordinal, as (index, shard)
        # pairs of two indices can share a shard id
        shard_meta: dict[int, tuple] = {}
        # the backstop: every attempt is timer-bounded, so this only
        # catches a wedged chain
        max_chain = max((f.max_attempts for _o, _c, f in futs), default=1)
        wait_by = time.monotonic() + deadline.clamp(
            self.QUERY_ATTEMPT_TIMEOUT * max(1, max_chain)) + 5.0
        try:
            for ordinal, copy, fut in futs:
                try:
                    r, used, node, err = fut.result(
                        timeout=max(0.0, wait_by - time.monotonic()))
                except FutureTimeoutError:
                    fut.cancel_chain()  # an abandoned chain sends no more attempts
                    r, used, node, err = None, None, None, \
                        ReceiveTimeoutError("query phase timed out")
                if err is not None and _fails_the_search(err):
                    # a host bug, or a profile whose device clock failed: the
                    # request fails, no shard answers with host timings
                    raise err
                if r is None:
                    # one failure entry per attempted copy, and the chain's
                    # terminal error when it is not the last attempt's
                    per_copy = list(fut.attempt_errors)
                    if err is not None and (not per_copy or per_copy[-1][1] is not err):
                        per_copy.append((copy.node_id, err))
                    for node_id, copy_err in per_copy:
                        failures.append({"index": copy.index, "shard": copy.shard_id,
                                         "node": node_id, "reason": str(copy_err)})
                    terminal = err if err is not None \
                        else per_copy[-1][1] if per_copy else None
                    terminals.append(terminal)
                    # a failed phase feeds admission too (a node whose phases
                    # time out must raise the signal), an overload rejection
                    # not: it resolves at once and would drag the signal down
                    if not isinstance(terminal, (CircuitBreakingError,
                                                 RejectedExecutionError)):
                        self.admission.observe(
                            getattr(fut, "completed_at", time.monotonic()) - t_fanout)
                    continue
                self.admission.observe(
                    getattr(fut, "completed_at", time.monotonic()) - t_fanout)
                prof = r.get("profile")
                shard_meta[ordinal] = (used.index, used.shard_id, node, r.get("ctx_id"))
                results.append(ShardQueryResult(
                    total=r["total"], docs=[tuple(d) for d in r["docs"]],
                    max_score=r["max_score"] if r["max_score"] is not None
                    else float("nan"),
                    agg_partials=_decode_partials(r.get("agg_partials")),
                    facet_partials=_decode_partials(r.get("facet_partials")),
                    shard_id=ordinal, timed_out=bool(r.get("timed_out")),
                    context_id=r.get("ctx_id"), degraded=bool(r.get("degraded")),
                    suggest=r.get("suggest"), profile=prof))
        except Exception:
            # an error that is not a shard failure (a host bug; a device
            # error degrades inside the shard) fails the search: no shard
            # that answered, or answers later, keeps its context pinned
            self._free_after_failure(futs, shard_meta, wait_by)
            raise
        if not results and terminals and not dfs_failed and all(
                isinstance(e, (CircuitBreakingError, RejectedExecutionError))
                for e in terminals):
            # every shard was shed by overload protection: a 429, not a partial
            raise terminals[-1]
        return self._finish_search(req, body, results, failures, shards,
                                   shard_meta, t0, timed_out=deadline.expired())

    # one query-phase attempt's budget, clamped by the request's deadline
    QUERY_ATTEMPT_TIMEOUT = 60.0

    def _query_shard_async(self, state, copy: ShardRouting, body, alias_filters,
                           dfs_stats, deadline: Deadline = NO_DEADLINE,
                           allow_hedge: bool = True) -> Future:
        """One shard's query phase with ranked failover and hedged attempts
        across its copies, driven by future callbacks (the coordinator parks
        no thread per shard).

        Failover: the candidates are `routing.ranked_copies`, the chosen
        copy first, then the group's other active copies best-first by the
        adaptive health rank (cluster/stats.py); a candidate whose node is
        not in the state is passed over. Each attempt is bounded by a timer
        from the node's wheel (`QUERY_ATTEMPT_TIMEOUT` clamped by the
        deadline); any failure of an attempt, a transport error to a node
        that just left included, sends the next candidate, until the
        candidates or the deadline run out (an attempt still in flight keeps
        the chain open). An error that fails the whole search
        (`_fails_the_search`) ends the chain at once.

        Hedging ("The Tail at Scale"): when the primary attempt outlives its
        copy's own p99 (`hedge_delay_s`: warm copies only, clamped by the
        best alternative's EWMA and by the deadline) and the `HedgeBudget`
        grants a token, the best copy not yet tried is sent the same phase;
        the first success resolves the chain, and the loser's answer frees
        its pinned context. `allow_hedge=False` (hard pins) never hedges,
        and a dead hedge never advances the chain while the attempt it
        shadowed is in flight. Every attempt feeds the selector: latency
        and the response's `load` on success (a loser's and a late one's
        too), a decayed failure on an error or a timeout. No selector call
        runs under an engine lock or across a pull: they run on transport
        callback and timer threads.

        Resolves to (response | None, the copy that answered, its node,
        error | None); a response's profile carries `winner` (`primary` or
        `hedge`). The future's `attempt_errors` lists each failed attempt as
        (node id, error), `cancel_chain()` stops it sending, and a response
        that arrives after the chain was cancelled or resolved frees its
        pinned context."""
        done: Future = Future()
        # the phase's latency ends at its resolution, not when the
        # coordinator collects it behind a slower shard
        done.add_done_callback(lambda f: setattr(f, "completed_at", time.monotonic()))
        # attempts run on timer and transport-callback threads: each send
        # re-activates the coordinator's span so it carries the trace, and
        # every response's spans stitch in here (a hedge race's loser's too)
        cur_span = tracing.current_span()
        trace_ref = cur_span.trace if cur_span else None
        group = state.routing_table.index(copy.index).shard(copy.shard_id)
        # one wiring point: the selector that ranks the chain also takes the
        # observations and holds the hedge budget
        selector = self.routing.selector
        candidates = self.routing.ranked_copies(group, copy)
        cancelled = [False]
        attempt_errors: list = []
        # the candidates claimed (sent, or passed over for a departed node)
        # and the attempts in flight; the chain fails only when every
        # candidate is claimed and none is in flight
        launched: set[int] = set()
        in_flight = [0]
        chain_lock = threading.Lock()

        def cancel_chain():
            cancelled[0] = True

        done.cancel_chain = cancel_chain  # type: ignore[attr-defined]
        done.max_attempts = len(candidates)  # type: ignore[attr-defined]
        done.attempt_errors = attempt_errors  # type: ignore[attr-defined]

        def resolve(r, used, node, err) -> bool:
            return complete_fut(done, (r, used, node, err))

        def attempt_failed(cand, err, hedge: bool):
            with chain_lock:
                in_flight[0] -= 1
                alive = in_flight[0]
                attempt_errors.append((cand.node_id, err))
                attempts = len(attempt_errors)
            if cancelled[0] or done.done():
                return
            if deadline.expired():
                # another copy could only answer after the caller stopped
                # caring; an attempt still in flight may yet answer
                if alive == 0:
                    resolve(None, None, None, ReceiveTimeoutError(
                        f"search budget exhausted after {attempts} "
                        f"attempt(s) on [{copy.index}][{copy.shard_id}]: {err}"))
                return
            if hedge and alive > 0:
                return  # the attempt it shadowed is still in flight
            try_next(err)

        def try_next(last_err, hedge: bool = False) -> bool:
            """Claim and send the best candidate not yet tried on a live
            node; False when none is left (the chain then resolves its
            error if nothing is in flight)."""
            with chain_lock:
                j = None
                for i in range(len(candidates)):
                    if i in launched:
                        continue
                    launched.add(i)
                    if state.nodes.get(candidates[i].node_id) is None:
                        continue  # a departed node: passed over
                    j = i
                    in_flight[0] += 1
                    break
                alive = in_flight[0]
            if j is None:
                if alive == 0:
                    resolve(None, None, None, last_err or NoShardAvailableError(
                        f"no active copy of [{copy.index}][{copy.shard_id}] on a live node"))
                return False
            launch(candidates[j], hedge)
            return True

        def launch(cand, hedge: bool):
            node = state.nodes.get(cand.node_id)
            payload = {"index": cand.index, "shard": cand.shard_id, "body": body or {},
                       "alias_filter": alias_filters.get(cand.index), "dfs": dfs_stats,
                       # the remaining budget as a duration: the shard
                       # restarts its own clock from it
                       "deadline_s": deadline.remaining()}
            if hedge:
                payload["hedge"] = True  # the shard tags its span
            with tracing.activate(cur_span):
                fut = self.transport.send_request(node, A_QUERY_PHASE, payload)
            t_sent = time.monotonic()
            if selector is not None:
                selector.begin_attempt(cand)
                if hedge:
                    selector.hedges.record_issued()
                else:
                    selector.hedges.note_request()
            # exactly one of the response and the attempt timer consumes the
            # attempt for the chain; `settled` drops the selector's
            # outstanding count exactly once
            consumed, settled = [False], [False]
            attempt_lock = threading.Lock()

            def consume() -> bool:
                with attempt_lock:
                    if consumed[0]:
                        return False
                    consumed[0] = True
                    return True

            def settle() -> bool:
                with attempt_lock:
                    if settled[0]:
                        return False
                    settled[0] = True
                    return True

            def on_timeout():
                if selector is not None and settle():
                    selector.end_attempt(cand)
                    selector.failure(cand)
                if consume():
                    attempt_failed(cand, ReceiveTimeoutError(
                        f"query phase attempt to [{cand.node_id}] timed out"), hedge)

            timer = self.node.threadpool.schedule(
                deadline.clamp(self.QUERY_ATTEMPT_TIMEOUT), "generic", on_timeout)

            if allow_hedge and not hedge and selector is not None:
                with chain_lock:
                    alts = [candidates[i] for i in range(len(candidates))
                            if i not in launched]
                delay = selector.hedge_delay_s(cand, deadline.remaining(), others=alts)
                if delay is not None:
                    def on_hedge():
                        if cancelled[0] or done.done():
                            return
                        with attempt_lock:
                            if consumed[0]:
                                return  # failed over already
                        with chain_lock:
                            has_next = any(
                                i not in launched and
                                state.nodes.get(candidates[i].node_id) is not None
                                for i in range(len(candidates)))
                        if not has_next or not selector.hedges.try_acquire():
                            return  # nothing to hedge to, or no budget
                        if not try_next(None, hedge=True):
                            selector.hedges.refund()  # lost the claim race

                    hedge_timer = self.node.threadpool.schedule(
                        delay, "generic", on_hedge)
                    done.add_done_callback(lambda _f: hedge_timer.cancel())

            def on_done(f):
                err = f.exception()
                lat = time.monotonic() - t_sent
                if selector is not None and settle():
                    selector.end_attempt(cand)
                if not consume():
                    # the timer failed this attempt over: a late answer
                    # still teaches the selector the copy's true latency
                    if err is None:
                        r = f.result()
                        if selector is not None:
                            selector.observe(cand, lat, load=r.get("load")
                                             if isinstance(r, dict) else None)
                        self._free_late_context(cand, node, r)
                    return
                timer.cancel()
                if err is not None:
                    if _fails_the_search(err):
                        with chain_lock:
                            in_flight[0] -= 1
                            attempt_errors.append((cand.node_id, err))
                        resolve(None, cand, node, err)
                        return
                    if selector is not None:
                        selector.failure(cand)
                    attempt_failed(cand, err, hedge)
                    return
                r = f.result()
                if selector is not None:
                    selector.observe(cand, lat, load=r.get("load")
                                     if isinstance(r, dict) else None)
                if trace_ref is not None:
                    trace_ref.add_remote(r.get("spans"))
                if isinstance(r.get("profile"), dict):
                    r = {**r, "profile": {**r["profile"],
                                          "winner": "hedge" if hedge else "primary"}}
                # resolve before dropping the in-flight count: the other
                # attempt's failure must not read 0 in flight and resolve
                # the chain with its error first
                won = not cancelled[0] and resolve(r, cand, node, None)
                with chain_lock:
                    in_flight[0] -= 1
                if not won:
                    self._free_late_context(cand, node, r)
                elif hedge and selector is not None:
                    selector.hedges.record_won()

            fut.add_done_callback(on_done)

        try_next(None)
        return done

    def _free_late_context(self, copy: ShardRouting, node, response):
        """Free the context a query phase pinned for a fetch that will not
        come (its attempt timed out, or its chain was abandoned)."""
        cid = response.get("ctx_id") if isinstance(response, dict) else None
        if cid is not None and node is not None:
            self.transport.send_request(node, A_FREE_CONTEXT, {
                "index": copy.index, "shard": copy.shard_id, "ctx": cid})

    def _dfs_round(self, state, shards, body, deadline: Deadline):
        """Every shard's DFS phase at once, then the global statistics every
        query phase weighs its clauses with: (the wire form of
        `aggregate_dfs`, the ordinals whose DFS phase failed). A failed
        phase fails over to the group's other active copies in turn
        (`_dfs_shard_result`); a shard no copy answers is left out."""
        futs = [self.transport.send_request(
            state.nodes.get(copy.node_id), A_DFS_PHASE, {
                "index": copy.index, "shard": copy.shard_id, "body": body or {}})
            for copy in shards]
        results, failed = [], set()
        for ordinal, (copy, fut) in enumerate(zip(shards, futs)):
            r = self._dfs_shard_result(state, copy, body, fut, deadline)
            if r is None:
                failed.add(ordinal)
                continue
            results.append(DfsResult(
                shard_id=copy.shard_id, max_doc=r["max_doc"],
                term_df={(f, t): v for f, t, v in r["term_df"]},
                field_stats={f: FieldStats(*v) for f, v in r["field_stats"].items()}))
        agg = aggregate_dfs(results)
        return {"max_doc": agg["max_doc"],
                "term_df": [[f, t, v] for (f, t), v in agg["df"].items()],
                "field_stats": {f: [s.doc_count, s.sum_ttf, s.sum_dfs]
                                for f, s in agg["field_stats"].items()}}, failed

    def _dfs_shard_result(self, state, copy: ShardRouting, body, first_fut,
                          deadline: Deadline = NO_DEADLINE):
        """One shard's DFS phase: the first attempt is in flight already,
        failover attempts to the group's other active copies are sent one
        after another. None when no copy on a live node answers or the
        deadline runs out."""
        group = state.routing_table.index(copy.index).shard(copy.shard_id)
        candidates = [copy] + [s for s in group.active_shards()
                               if s.node_id != copy.node_id]
        fut = first_fut
        for cand in candidates:
            if fut is None:
                if deadline.expired():
                    return None
                node = state.nodes.get(cand.node_id)
                if node is None:
                    continue
                fut = self.transport.send_request(node, A_DFS_PHASE, {
                    "index": cand.index, "shard": cand.shard_id, "body": body or {}})
            try:
                return fut_result(fut, deadline.clamp(DFS_PHASE_TIMEOUT))
            except SearchEngineError:
                fut = None  # the next copy
        return None

    def count(self, index_expr, body=None) -> dict:
        """`_count`: a `size: 0` search's total and `_shards`."""
        r = self.search(index_expr, {**(body or {}), "size": 0})
        return {"count": r["hits"]["total"], "_shards": r["_shards"]}

    def _free_after_failure(self, futs, shard_meta: dict, wait_by: float):
        """Free the pinned context of every shard whose query phase answered
        or still answers before `wait_by`, and wait for the frees; a chain
        still open at `wait_by` is cancelled (a late answer frees its own
        context)."""
        pinned = [(index, shard, node, cid)
                  for (index, shard, node, cid) in shard_meta.values()]
        for ordinal, _copy, fut in futs:
            if ordinal in shard_meta:
                continue
            try:
                r, used, node, _err = fut.result(
                    timeout=max(0.0, wait_by - time.monotonic()))
            except FutureTimeoutError:
                fut.cancel_chain()
                if not fut.done():
                    continue
                r, used, node, _err = fut.result()
            if r is not None:
                pinned.append((used.index, used.shard_id, node, r.get("ctx_id")))
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

    def _shard_ctx(self, index: str, shard_id: int, dfs: dict | None = None) -> ShardContext:
        """The shard's current searcher in a context wired to the node's
        device, breakers, ONE node-level DeviceBatcher and ONE
        DeviceFilterCache; `dfs`, the coordinator's global statistics, in
        their wire form. Opens the warmer's gate (warmer.py): from the
        shard's first search on, every new view's packs and remasks run on
        the warmer and merge pools; a shard that has never served a search
        stays off the device."""
        svc = self.indices.index_service(index)
        shard = svc.shard(shard_id)
        shard.engine.search_active = True
        global_stats = None
        if dfs:
            global_stats = {
                "max_doc": dfs["max_doc"],
                "df": {(f, t): v for f, t, v in dfs["term_df"]},
                "field_stats": {f: FieldStats(*v) for f, v in dfs["field_stats"].items()},
            }
        return ShardContext(shard.engine.acquire_searcher(), svc.mapper_service,
                            svc.similarity_service, device=self.node.device,
                            breakers=self.node.breakers,
                            batcher=self.node.search_batcher,
                            filter_cache=self.node.filter_cache, index_name=index,
                            global_stats=global_stats)

    def _s_query_phase(self, request, channel):
        index, shard_id = request["index"], request["shard"]
        body = dict(request.get("body") or {})
        alias_filter = request.get("alias_filter")
        if alias_filter:
            # the wrapped body is the one the request cache fingerprints
            body["query"] = {"filtered": {"query": body.get("query") or {"match_all": {}},
                                          "filter": alias_filter}}
        # `"profile": true`, peeked before the parse, so the unprofiled path
        # reads no clock: the collector's t0 covers the parse it times
        prof = None
        if bool(body.get("profile")):
            prof = profiling.ProfileCollector(node=self.node.name, index=index,
                                              shard=shard_id)
        req = parse_search_body(body)
        if prof is not None:
            prof.phase_s("parse", time.monotonic() - prof.t0)
        dfs = request.get("dfs")
        ctx = self._shard_ctx(index, shard_id, dfs)
        budget = request.get("deadline_s")
        if req.timeout_s is not None:
            budget = req.timeout_s if budget is None else min(budget, req.timeout_s)
        deadline = Deadline.after(budget) if budget is not None else NO_DEADLINE
        # the coordinator's trace continues from the wire context (sent only
        # for sampled traces): every batcher span of this phase hangs under
        # the shard span
        trace = self.node.tracer.continue_trace(request.get(tracing.TRACE_WIRE_KEY),
                                                "shard")
        shard_span = trace.root.tag(index=index, shard=shard_id)
        if request.get("hedge"):
            # a hedged attempt: its shard span shows as a sibling of the
            # primary attempt's in the stitched `?trace=true` tree
            shard_span.tag(hedge=True)
        # the shard request cache: a hit answers before the query phase, with
        # no launch; a DFS request's weights are its own and never cache; a
        # profiled request always runs, and records the hit or miss
        rcache = self.node.request_cache
        cache_key = None
        peek_hit = False
        if rcache.enabled and dfs is None and cache_policy(body):
            cache_key = (index, shard_id, ctx.searcher.version,
                         request_fingerprint(body))
        # every search classifies into the node's query-shape insights
        insights_reg = self.node.insights
        shape_id = shape = None
        if insights_reg.enabled:
            shape_id, shape = insights_reg.fingerprint(body)
        if cache_key is not None:
            if prof is None:
                data = rcache.get(cache_key)
                if data is not None:
                    try:
                        shard_span.tag(request_cache="hit")
                    finally:
                        shard_span.end()
                    if shape_id is not None:
                        insights_reg.record(shape_id, shape, cache="hit")
                    out = _decode_cached_partial(data)
                    out["ctx_id"] = self._pin_context(index, shard_id, ctx)
                    out["load"] = self._load_signal()
                    if trace:
                        out["spans"] = trace.span_dicts()
                    return out
            else:
                peek_hit = rcache.peek(cache_key)
                prof.event("request_cache", cache="hit" if peek_hit else "miss")
        t_q = time.monotonic()
        obs = _insights.Observation() if shape_id is not None else None
        try:
            with tracing.activate(shard_span):
                if obs is not None:
                    with _insights.activate(obs):
                        result = self._execute_qp(ctx, req, shard_id, deadline,
                                                  prof)
                else:
                    result = self._execute_qp(ctx, req, shard_id, deadline, prof)
        except Exception:
            # a failing shape still classifies (outcome "error")
            if shape_id is not None:
                obs.outcome = "error"
                insights_reg.record(shape_id, shape, time.monotonic() - t_q, obs,
                                    cache="miss" if cache_key is not None else None)
            raise
        finally:
            shard_span.end()
        took_s = time.monotonic() - t_q
        partial = _shard_partial_dict(result)
        if shape_id is not None:
            insights_reg.record(shape_id, shape, took_s, obs,
                                cache=("hit" if peek_hit else "miss")
                                if cache_key is not None else None)
        self._maybe_slowlog(index, shard_id, body, took_s, trace=trace,
                            shape_id=shape_id)
        if cache_key is not None and not result.timed_out and not peek_hit:
            # `degraded` says how this run was served, not what it found:
            # the host path's partial is bitwise the card's, and a hit is
            # served from memory; `body` enters the shard's hot bodies
            data = _encode_cached_partial({**partial, "degraded": False})
            if data is not None and rcache.put(cache_key, data, body=body) \
                    and prof is not None:
                prof.event("request_cache", cache="store")
        # the fetch must read the SAME point-in-time searcher these doc ids
        # come from; `load` is the coordinator's adaptive replica selection
        # signal (plain attribute reads: no lock, clock or device traffic)
        out = {**partial, "ctx_id": self._pin_context(index, shard_id, ctx),
               "load": self._load_signal()}
        if trace:
            # the shard's spans ride the response for the coordinator's tree;
            # this node's ring keeps its own copy too
            out["spans"] = trace.span_dicts()
        if prof is not None:
            out["profile"] = prof.to_dict()
        return out

    def _load_signal(self) -> dict:
        """A query-phase response's load sample: the search pool's queue
        depth, the request breaker's headroom fraction and the request
        cache's hit rate, read as plain attributes (an unlocked read is
        exact enough for a decayed routing signal). The hit rate is
        reported per copy in `/_nodes/stats`, never a rank input."""
        queue = self.node.threadpool.queue_depth("search")
        br = self.node.breakers.breaker("request")
        headroom = 1.0 if br.limit <= 0 else max(0.0, 1.0 - br.used / br.limit)
        rc = self.node.request_cache
        lookups = rc.hits + rc.misses
        return {"queue": queue, "headroom": round(headroom, 4),
                "rc_hit_rate": round(rc.hits / lookups, 4) if lookups else 0.0}

    @staticmethod
    def _execute_qp(ctx, req, shard_id: int, deadline, prof):
        """One shard query phase, under the profiler only when the request
        asked for it (`activate(None)` is never entered)."""
        if prof is None:
            return execute_query_phase(ctx, req, shard_id=shard_id,
                                       deadline=deadline)
        with profiling.activate(prof):
            return execute_query_phase(ctx, req, shard_id=shard_id,
                                       deadline=deadline)

    def _cluster_slowlog_levels(self, md) -> dict:
        """The cluster-level slowlog thresholds {level: seconds | None},
        parsed again only when the metadata version moves (transient
        settings win over persistent ones)."""
        cached = self._slowlog_cluster
        if cached is not None and cached[0] == md.version:
            return cached[1]
        flat = dict(md.persistent_settings)
        flat.update(dict(md.transient_settings))
        levels: dict = {}
        for level in ("warn", "info", "debug"):
            raw = flat.get(f"index.search.slowlog.threshold.query.{level}")
            value = None
            if raw is not None:
                try:
                    value = parse_time(raw)
                except IllegalArgumentError:
                    value = None
            levels[level] = value
        self._slowlog_cluster = (md.version, levels)
        return levels

    def _maybe_slowlog(self, index: str, shard_id: int, body: dict, took_s: float,
                       trace=None, shape_id: str | None = None):
        """The shard query slowlog: warn, info and debug thresholds from the
        index settings, else the cluster's transient and persistent
        settings. The line carries the trace id (`-` untraced), the shape id
        (joinable to `GET /_insights/queries`) and the trace's queue,
        device and merge milliseconds (zeros untraced)."""
        md = self.cluster_service.state.metadata
        meta = md.index(index)
        if meta is None:
            return
        cluster_levels = self._cluster_slowlog_levels(md)
        for level, log in (("warn", self.logger.warning), ("info", self.logger.info),
                           ("debug", self.logger.debug)):
            threshold = meta.settings.get_time(
                f"index.search.slowlog.threshold.query.{level}", None)
            if threshold is None:
                threshold = cluster_levels.get(level)
            if threshold is not None and threshold >= 0 and took_s >= threshold:
                phases = tracing.phase_breakdown(trace)
                log("slowlog [%s][%d] took[%.1fms] trace[%s] shape[%s] "
                    "queue[%.1fms] device[%.1fms] merge[%.1fms] source[%s]",
                    index, shard_id, took_s * 1000,
                    trace.trace_id if trace else "-", shape_id or "-",
                    phases["queue_ms"], phases["device_ms"],
                    phases["merge_ms"], str(body)[:500])
                return

    def warm_shard_queries(self, index: str, shard_id: int, bodies: list[dict],
                           budget_s: float = 5.0) -> tuple[int, int]:
        """The warmer's re-prime (warmer.py, on the `warmer` pool): run the
        shard's hottest cached bodies on its current view and store their
        partials, so a hot body's first sighting after a refresh is a hit.
        A key already present is skipped; a timed-out partial is not
        stored. Returns (warmed, failed): a body that raises counts as
        failed and never reaches the pool."""
        rcache = self.node.request_cache
        if not rcache.enabled:
            return 0, 0
        warmed = failed = 0
        for body in bodies:
            try:
                ctx = self._shard_ctx(index, shard_id)
                key = (index, shard_id, ctx.searcher.version, request_fingerprint(body))
                if rcache.peek(key):
                    continue  # a live request (or an earlier warm) stored it
                result = execute_query_phase(ctx, parse_search_body(dict(body)),
                                             shard_id=shard_id,
                                             deadline=Deadline.after(budget_s))
                if result.timed_out:
                    continue
                data = _encode_cached_partial(_shard_partial_dict(result))
                # body=None: the warm store leaves the hot bodies' ranking
                # to live traffic
                if data is not None and rcache.put(key, data):
                    warmed += 1
            except Exception:  # noqa: BLE001 — counted; the pool must not die
                self.logger.debug("re-prime of [%s][%d] failed", index, shard_id,
                                  exc_info=True)
                failed += 1
        return warmed, failed

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

    def _s_dfs_phase(self, request, channel):
        """One shard's DFS statistics for the body's query, in wire form."""
        ctx = self._shard_ctx(request["index"], request["shard"])
        body = request.get("body") or {}
        query = parse_query(body["query"]) if body.get("query") else MatchAllQuery()
        dfs = collect_dfs(ctx, query, shard_id=request["shard"])
        return {
            "max_doc": dfs.max_doc,
            "term_df": [[f, t, v] for (f, t), v in dfs.term_df.items()],
            "field_stats": {f: [s.doc_count, s.sum_ttf, s.sum_dfs]
                            for f, s in dfs.field_stats.items()},
        }

    # ================= single-shard reads =================
    def get_doc(self, index: str, type_name: str, doc_id: str, routing=None,
                realtime=True, refresh=False, parent=None) -> dict:
        state = self.cluster_service.state
        state.blocks.check("read", index)
        index = state.metadata.resolve_indices(index)[0]
        effective_routing = routing if routing is not None else parent
        copy = self.routing.get_shard_copy(state, index, doc_id, effective_routing)
        return self.transport.submit_request(state.nodes.get(copy.node_id), A_GET, {
            "index": index, "shard": copy.shard_id, "type": type_name, "id": doc_id,
            "realtime": realtime, "refresh": refresh}, timeout=10.0)

    def _s_get(self, request, channel):
        shard = self.indices.index_service(request["index"]).shard(request["shard"])
        if request.get("refresh"):
            shard.engine.refresh()
        type_name = request["type"] or "_all"
        if type_name == "_all":
            # the first type that holds the id
            r = None
            for t in shard.engine.mapper_service.types():
                r = shard.engine.get(t, request["id"],
                                     realtime=request.get("realtime", True))
                if r.found:
                    type_name = t
                    break
            if r is None or not r.found:
                return {"_index": request["index"], "_type": request["type"],
                        "_id": request["id"], "found": False}
        else:
            r = shard.engine.get(type_name, request["id"],
                                 realtime=request.get("realtime", True))
        out = {"_index": request["index"], "_type": type_name,
               "_id": request["id"], "found": r.found}
        if r.found:
            out["_version"] = r.version
            out["_source"] = r.source
            if r.routing is not None:
                out["_routing"] = str(r.routing)
            if r.parent is not None:
                out["_parent"] = str(r.parent)
            if r.timestamp is not None:
                out["_timestamp"] = int(r.timestamp)
            if r.ttl is not None:
                out["_ttl"] = int(r.ttl)
        return out

    def multi_get(self, docs: list[dict]) -> dict:
        """`_mget`: the request is validated first (no documents, or a
        document without an index or an id, answers 400), then one GET a
        document, shaped by its `fields` and `_source`; a missing index, or
        a type that does not hold the id, answers `found: false` in its
        place, any other error its error."""
        if not docs:
            raise ActionRequestValidationError("Validation Failed: no documents to get")
        for i, d in enumerate(docs):
            if not d.get("_id"):
                raise ActionRequestValidationError(
                    f"Validation Failed: {i + 1}: id is missing")
            if not d.get("_index"):
                raise ActionRequestValidationError(
                    f"Validation Failed: {i + 1}: index is missing")
        out = []
        for d in docs:
            type_name = d.get("_type") or "_all"
            try:
                r = self.get_doc(d["_index"], type_name, str(d["_id"]),
                                 routing=d.get("routing") or d.get("_routing"),
                                 parent=d.get("parent") or d.get("_parent"),
                                 realtime=d.get("realtime", True),
                                 refresh=d.get("refresh", False))
                if d.get("_type") and r.get("_type") != d["_type"]:
                    r = {"_index": d["_index"], "_type": d["_type"],
                         "_id": str(d["_id"]), "found": False}
                fields = d.get("fields") or d.get("_fields")
                src_spec = d.get("_source")
                if r.get("found") and (fields or src_spec is not None):
                    r = shape_get(r, fields, src_spec)
                out.append(r)
            except IndexMissingError:
                out.append({"_index": d["_index"], "_type": d.get("_type"),
                            "_id": str(d["_id"]), "found": False})
            except SearchEngineError as e:
                out.append({"_index": d.get("_index"), "_type": d.get("_type"),
                            "_id": str(d.get("_id")), "error": e.to_dict()})
        return {"docs": out}

    def _lookup_get(self, index, type_name, doc_id, routing=None):
        """A terms lookup's document: a missing document resolves to no
        terms, a missing index raises (`get_doc`'s IndexMissingError)."""
        return self.get_doc(index, type_name or "_all", doc_id, routing=routing)

    def term_vector(self, index: str, type_name: str, doc_id: str, routing=None,
                    fields=None, positions=True, offsets=True,
                    term_statistics=False, field_statistics=True) -> dict:
        """The term vectors of one document, read on one copy of its shard
        (`_s_termvector`)."""
        state = self.cluster_service.state
        state.blocks.check("read", index)
        index = state.metadata.resolve_indices(index)[0]
        copy = self.routing.get_shard_copy(state, index, doc_id, routing)
        return self.transport.submit_request(
            state.nodes.get(copy.node_id), A_TERMVECTOR, {
                "index": index, "shard": copy.shard_id, "type": type_name,
                "id": doc_id, "fields": list(fields) if fields else None,
                "positions": positions, "offsets": offsets,
                "term_statistics": term_statistics,
                "field_statistics": field_statistics}, timeout=10.0)

    def multi_termvector(self, docs: list[dict]) -> dict:
        """`_mtermvectors`: each document's term vectors, an error in its
        place."""
        out = []
        for d in docs:
            try:
                out.append(self.term_vector(
                    d["_index"], d.get("_type", "_all"), d["_id"],
                    routing=d.get("routing"), fields=d.get("fields"),
                    positions=d.get("positions", True),
                    offsets=d.get("offsets", True),
                    term_statistics=d.get("term_statistics", False),
                    field_statistics=d.get("field_statistics", True)))
            except SearchEngineError as e:
                out.append({"_index": d.get("_index"), "_id": d.get("_id"),
                            "error": e.to_dict()})
        return {"docs": out}

    def _s_termvector(self, request, channel):
        """One document's term vectors, re-derived by analyzing its stored
        `_source` text fields with each field's search analyzer (exact for
        write-once segments): per term its frequency and, when asked, its
        tokens' positions and offsets, its document frequency and total
        term frequency in the shard; per field its statistics."""
        index, shard_id = request["index"], request["shard"]
        shard = self.indices.index_service(index).shard(shard_id)
        r = shard.engine.get(request["type"], request["id"], realtime=True)
        out = {"_index": index, "_type": request["type"], "_id": request["id"],
               "found": r.found}
        if not r.found:
            return out
        out["_version"] = r.version
        ctx = self._shard_ctx(index, shard_id)
        wanted = request.get("fields")
        tv = {}
        for field, texts in sorted(_flatten_text_fields(r.source).items()):
            if wanted is not None and field not in wanted:
                continue
            ft = ctx.field_type(field)
            if ft is not None and getattr(ft, "index", "analyzed") == "no":
                continue
            terms: dict[str, dict] = {}
            for text in texts:
                for tok in ctx.analyze_tokens(field, str(text)):
                    e = terms.setdefault(tok.term, {"term_freq": 0, "tokens": []})
                    e["term_freq"] += 1
                    t = {}
                    if request.get("positions", True):
                        t["position"] = tok.position
                    if request.get("offsets", True):
                        t["start_offset"] = tok.start
                        t["end_offset"] = tok.end
                    if t:
                        e["tokens"].append(t)
            if not terms:
                continue
            if request.get("term_statistics"):
                for term, e in terms.items():
                    e["doc_freq"] = ctx.doc_freq(field, term)
                    e["ttf"] = sum(int(seg.postings(field, term)[1].sum())
                                   for seg in ctx.searcher.segments)
            entry = {"terms": terms}
            if request.get("field_statistics", True):
                fs = ctx.field_stats(field)
                entry["field_statistics"] = {
                    "doc_count": fs.doc_count, "sum_ttf": fs.sum_ttf,
                    "sum_doc_freq": fs.sum_dfs}
            tv[field] = entry
        out["term_vectors"] = tv
        return out

    def more_like_this(self, index: str, type_name: str, doc_id: str,
                       mlt_fields=None, search_body=None, routing=None,
                       **mlt_params) -> dict:
        """`_mlt`: GET the document, search a `bool` of a `more_like_this`
        over its text fields (or `mlt_fields`) that must not match its own
        id. The host scorer rewrites the `more_like_this` clause, so the
        search runs on the host, as in the JAX package."""
        doc = self.get_doc(index, type_name, doc_id, routing=routing)
        if not doc.get("found"):
            raise DocumentMissingError(f"[{index}][{type_name}][{doc_id}] missing")
        flat = _flatten_text_fields(doc.get("_source") or {})
        if mlt_fields:
            flat = {f: v for f, v in flat.items() if f in set(mlt_fields)}
        like_text = " ".join(str(t) for texts in flat.values() for t in texts)
        mlt = {"fields": sorted(flat) or ["_all"], "like_text": like_text}
        for k in ("min_term_freq", "min_doc_freq", "max_query_terms",
                  "minimum_should_match", "percent_terms_to_match", "boost_terms"):
            if mlt_params.get(k) is not None:
                mlt[k] = mlt_params[k]
        body = dict(search_body or {})
        body["query"] = {"bool": {
            "must": [{"more_like_this": mlt}],
            "must_not": [{"ids": {"type": type_name, "values": [doc_id]}}],
        }}
        return self.search(index, body)

    # ================= broadcast =================
    def delete_by_query(self, index_expr, body) -> dict:
        """Every active copy of every resolved index's shards deletes the
        body's matches (`_s_broadcast` op `delete_by_query`); the primaries'
        counts are summed per index."""
        body = resolve_terms_lookups(body, self._lookup_get)
        state = self.cluster_service.state
        indices = state.metadata.resolve_indices(index_expr)
        futs = []
        for index in indices:
            for group in state.routing_table.index(index).shards:
                for copy in group.active_shards():
                    futs.append((index, copy, self.transport.send_request(
                        state.nodes.get(copy.node_id), A_SHARD_BROADCAST, {
                            "index": index, "shard": copy.shard_id,
                            "op": "delete_by_query", "body": body})))
        deleted = dict.fromkeys(indices, 0)
        for index, copy, fut in futs:
            r = fut_result(fut, 30.0)
            if copy.primary:
                deleted[index] += r.get("deleted", 0)
        return {"_indices": {i: {"deleted": n} for i, n in deleted.items()}}

    def broadcast(self, index_expr, op: str, extra: dict | None = None) -> dict:
        """refresh, flush, optimize or clear_cache on every active shard
        copy; `extra` rides each shard's request (the cache clear's tier
        selectors)."""
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
                        {"index": index, "shard": copy.shard_id, "op": op,
                         **(extra or {})}))
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
        if op == "refresh":
            # the search warmers run on an explicit refresh's new view only
            if engine.refresh():
                self._run_warmers(request["index"], request["shard"])
        elif op == "flush":
            engine.flush()
        elif op == "optimize":
            engine.optimize()
        elif op == "clear_cache":
            # `request` and `filter` select the tiers (both by default)
            cleared = {"request": 0, "filter": 0}
            if request.get("filter", True) is not False:
                for seg in engine.acquire_searcher().segments:
                    clear_segment_masks(seg)  # the host masks
                    cleared["filter"] += self.node.filter_cache.clear_segment(seg)
            if request.get("request", True) is not False:
                cleared["request"] = self.node.request_cache.invalidate_shard(
                    request["index"], request["shard"], None)
            return {"ok": True, "cleared": cleared}
        elif op == "delete_by_query":
            ctx = self._shard_ctx(request["index"], request["shard"])
            query_body = (request.get("body") or {}).get("query")
            query = parse_query(query_body)
            uids = []
            for seg in ctx.searcher.segments:
                mask = host_match_mask(query, seg, ctx) & seg.live & seg.parent_mask
                uids.extend(f"{seg.types[local]}#{seg.ids[local]}"
                            for local in np.nonzero(mask)[0])
            engine.delete_by_uids(uids, query=query_body)
            engine.refresh()
            return {"ok": True, "deleted": len(uids)}
        else:
            raise IllegalArgumentError(f"broadcast op [{op}] is not ported yet")
        return {"ok": True}


def _fails_the_search(error: BaseException) -> bool:
    """An error no other copy can answer around: a host bug (not a
    SearchEngineError) or a profile whose device clock failed. Every other
    failure of an attempt fails over."""
    return not isinstance(error, SearchEngineError) or \
        isinstance(error, ProfileTimingError)


def filter_source(src: dict, includes, excludes) -> dict:
    """A GET's `_source` filtering with wildcard paths (the JAX package's
    `actions.filter_source`): an include naming an object keeps its whole
    subtree; an include naming a deeper path descends."""
    import fnmatch

    def norm(spec):
        if spec is None:
            return []
        if isinstance(spec, str):
            return [s.strip() for s in spec.split(",") if s.strip()]
        return [str(s) for s in spec]

    includes, excludes = norm(includes), norm(excludes)

    def is_ancestor(path, pattern):
        """`path` is a strict ancestor of a path the pattern could match."""
        pa, pp = path.split("."), pattern.split(".")
        if len(pa) >= len(pp):
            return False
        return all(fnmatch.fnmatch(a, b) for a, b in zip(pa, pp))

    def walk(obj, prefix, included):
        out = {}
        for k, v in obj.items():
            path = f"{prefix}{k}"
            if excludes and any(fnmatch.fnmatch(path, p) for p in excludes):
                continue
            hit = included or not includes or any(fnmatch.fnmatch(path, p)
                                                 for p in includes)
            if isinstance(v, dict):
                if hit:
                    out[k] = walk(v, path + ".", included=True)
                elif any(is_ancestor(path, p) for p in includes):
                    sub = walk(v, path + ".", included=False)
                    if sub:
                        out[k] = sub
            elif hit:
                out[k] = v
        return out

    return walk(src, "", included=False)


def shape_get(r: dict, fields, src_spec, includes=None, excludes=None) -> dict:
    """A found GET shaped by its `fields` (the `fields` section; `_source`
    kept only when `fields` names it) and its `_source` spec (true, false,
    patterns, or includes and excludes). `includes` and `excludes` are
    REST's `_source_include` and `_source_exclude`; a pattern spec takes
    the place of `includes`. The one rule of GET, `_mget`, `_explain`'s
    and `_update`'s get sections and `Client.get(fields=)`."""
    shaped = {k: v for k, v in r.items() if k != "_source"}
    src = r.get("_source")
    keep_source = True
    if fields:
        fdict, fsrc = _extract_fields(r, fields)
        if fdict:
            shaped["fields"] = fdict
        keep_source = fsrc is not None
    if src_spec is False or src_spec == "false":
        keep_source = False
    elif src_spec is True or src_spec == "true":
        keep_source = True
    elif isinstance(src_spec, (str, list)):
        includes, keep_source = src_spec, True
    elif isinstance(src_spec, dict):
        includes = src_spec.get("include") or src_spec.get("includes")
        excludes = src_spec.get("exclude") or src_spec.get("excludes")
        keep_source = True
    if keep_source and src is not None:
        if includes or excludes:
            src = filter_source(src, includes, excludes)
        shaped["_source"] = src
    return shaped


def _extract_fields(get_response: dict, fields) -> tuple[dict, dict | None]:
    """The `fields` section of a GET or update response, and the `_source`
    when `fields` names it: `_routing` and `_parent` as strings,
    `_timestamp` and `_ttl` as integers, a source leaf as a list."""
    if isinstance(fields, str):
        fields = [f.strip() for f in fields.split(",")]
    out: dict = {}
    source_out = None
    src = get_response.get("_source") or {}
    for f in fields or []:
        if f == "_source":
            source_out = src
        elif f in ("_routing", "_parent"):
            v = get_response.get(f)
            if v is not None:
                out[f] = str(v)
        elif f in ("_timestamp", "_ttl"):
            v = get_response.get(f)
            if v is not None:
                out[f] = int(v)
        else:
            vals = _source_leaf(src, f)
            if vals:
                out[f] = vals
    return out, source_out


def _source_leaf(src: dict, path: str) -> list:
    """The value at a dotted path of a `_source`, as a list (empty when
    the path is missing)."""
    cur = src
    for part in path.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            return []
    return cur if isinstance(cur, list) else [cur]


def _deep_merge(dst: dict, src: dict):
    """An update's `doc` merged into the current `_source`: objects merge
    key by key, any other value replaces."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v


def _flatten_text_fields(source: dict, prefix: str = "") -> dict[str, list]:
    """A `_source` flattened to dotted path -> its string values (term
    vectors and more-like-this read text fields only)."""
    out: dict[str, list] = {}
    for key, value in (source or {}).items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            for k, v in _flatten_text_fields(value, path + ".").items():
                out.setdefault(k, []).extend(v)
        elif isinstance(value, list):
            for item in value:
                if isinstance(item, dict):
                    for k, v in _flatten_text_fields(item, path + ".").items():
                        out.setdefault(k, []).extend(v)
                elif isinstance(item, str):
                    out.setdefault(path, []).append(item)
        elif isinstance(value, str):
            out.setdefault(path, []).append(value)
    return out


def _shard_partial_dict(result: ShardQueryResult) -> dict:
    """The wire and cache form of one shard's query-phase partial: the one
    construction site of the live query phase and the re-prime, so a warmed
    entry decodes as a live one does."""
    return {
        "total": result.total,
        "docs": [[s, d, sv] for (s, d, sv) in result.docs],
        "max_score": None if result.max_score != result.max_score
        else result.max_score,
        "agg_partials": _encode_partials(result.agg_partials),
        "facet_partials": _encode_partials(result.facet_partials),
        "suggest": result.suggest,
        "timed_out": result.timed_out,
        "degraded": result.degraded,
    }


def _encode_cached_partial(partial: dict) -> bytes | None:
    """A partial through the binary wire codec (common/stream.py): the bytes
    the cache stores and charges, and a hit's isolated copy. None (nothing
    is stored) for a value the codec refuses."""
    try:
        out = StreamOutput()
        out.write_value(partial)
        return out.bytes()
    except SearchEngineError:
        return None


def _decode_cached_partial(data: bytes) -> dict:
    return StreamInput(data).read_value()


def _encode_partials(partials):
    """Aggregation and facet partials cross the transport pickled and
    base64-encoded (they hold numpy arrays and sketches), as in the JAX
    package."""
    return base64.b64encode(pickle.dumps(partials)).decode("ascii") if partials else None


def _decode_partials(blob):
    if not blob:
        return []
    return pickle.loads(base64.b64decode(blob))
