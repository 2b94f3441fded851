"""Node-level index management and the cluster-state reconciler (a trimmed
copy of the JAX package's `indices_service.py`).

- `IndexService`: one index on this node — its MapperService,
  SimilarityService and shards.
- `IndicesService.cluster_changed` (IndicesClusterStateService's role): on
  every cluster-state change, first remove the indices the metadata no
  longer holds (each shard's caches and device packs released and its
  engine closed, its data directory wiped, its percolator registry and `PACK_LEDGER` entry
  dropped), then the shards no longer
  assigned here (a closed index: caches released, engine closed, data
  kept), then create the shards the routing table assigns here, recover
  each primary from its local store (a fresh shard recovers nothing; a
  restarted node's shard reloads its last commit, tombstones included, and
  replays its translog) on a thread of its own, and report shard-started to
  the master. A removed shard's engine leaves the warmer first, so no warm
  pack or re-prime starts on it.
- `periodic_refresh`: the scheduled NRT refresh per shard honouring
  `index.refresh_interval` (-1 disables it), then a merge-policy check on
  the `merge` pool.
- `check_indexing_memory` (the indexing-memory controller, every 5 s from
  the node): when the started shards' un-refreshed buffers together pass
  the node's budget, the largest are refreshed first until under it; a
  shard idle for 300 s is refreshed too.
- Each engine's view listeners drop the shard's request-cache entries of
  every superseded view (the node's `ShardRequestCache`) and evict the
  device filter masks of the segments a new view dropped (the node's
  `DeviceFilterCache`), then hand the view to the node's warmer, which
  packs it off the query path and re-primes the shard's hot cached bodies.
  A closing shard releases every cache byte it holds.

Peer recovery of replicas belongs to the slice with two nodes. The
removal runs on the cluster-state thread under the indices lock: it closes
engines and drops references (no device sync, no launch); the device
memory goes back to the allocator once the last search holding a view of
the index ends."""

from __future__ import annotations

import os
import shutil
import threading
import time
from dataclasses import dataclass

from .cluster.state import INITIALIZING, STARTED, ClusterState, ShardRouting
from .common.errors import IndexMissingError, IndexShardMissingError, SearchEngineError
from .common.logging import get_logger
from .common.settings import Settings
from .index.engine import Engine
from .mapper import MapperService
from .ops.device_index import PACK_LEDGER, drop_segment_packs
from .search.similarity import SimilarityService

ACTION_SHARD_STARTED = "internal:cluster/shard/started"

# shard lifecycle
CREATED, RECOVERING, SHARD_STARTED, CLOSED = "CREATED", "RECOVERING", "STARTED", "CLOSED"


@dataclass
class IndexShard:
    index: str
    shard_id: int
    engine: Engine
    primary: bool
    state: str = CREATED
    last_scheduled_refresh: float = 0.0


class IndexService:
    """One index on this node: mapping, similarity and its shards."""

    def __init__(self, name: str, index_settings: Settings, mappings: dict,
                 data_path: str):
        self.name = name
        self.settings = index_settings
        self.mapper_service = MapperService(index_settings)
        for type_name, mapping in (mappings or {}).items():
            self.mapper_service.put_mapping(type_name, mapping)
        self.similarity_service = SimilarityService(index_settings,
                                                   mapper_service=self.mapper_service)
        self.data_path = data_path
        self.shards: dict[int, IndexShard] = {}

    def shard(self, shard_id: int) -> IndexShard:
        s = self.shards.get(shard_id)
        if s is None:
            raise IndexShardMissingError(f"[{self.name}][{shard_id}] missing on this node")
        return s

    def create_shard(self, shard_id: int, primary: bool) -> IndexShard:
        engine = Engine(os.path.join(self.data_path, self.name, str(shard_id)),
                        self.mapper_service, settings=self.settings)
        shard = IndexShard(self.name, shard_id, engine, primary)
        self.shards[shard_id] = shard
        return shard

    def remove_shard(self, shard_id: int):
        shard = self.shards.pop(shard_id, None)
        if shard is not None:
            shard.state = CLOSED
            shard.engine.close()


class IndicesService:
    def __init__(self, node_id: str, data_path: str, transport, cluster_service,
                 threadpool, filter_cache=None, warmer=None, request_cache=None,
                 percolator=None):
        self.node_id = node_id
        # the node's DeviceFilterCache (None in unwired contexts): the masks
        # of segments an engine view drops leave with them
        self.filter_cache = filter_cache
        # the node's ShardRequestCache (None in unwired contexts): a view's
        # install drops the entries of the views before it
        self.request_cache = request_cache
        # the node's IndexWarmerService (None in unwired contexts)
        self.warmer = warmer
        # the node's PercolatorService (None in unwired contexts): a removed
        # index's queries go with it
        self.percolator = percolator
        self.data_path = data_path
        self.transport = transport
        self.cluster_service = cluster_service
        self.threadpool = threadpool
        self.indices: dict[str, IndexService] = {}
        self.logger = get_logger("indices")
        self._lock = threading.RLock()
        cluster_service.add_listener(self.cluster_changed)

    def index_service(self, name: str) -> IndexService:
        svc = self.indices.get(name)
        if svc is None:
            raise IndexMissingError(name)
        return svc

    # ------------------------------------------------------------ memory control
    def check_indexing_memory(self, budget_bytes: int | None = None,
                              inactive_after: float = 300.0) -> int:
        """Refresh the largest un-refreshed buffers first while the started
        shards' buffers together exceed `budget_bytes` (64 MiB by default),
        and every shard idle for `inactive_after` seconds with a buffer.
        Returns the shards refreshed."""
        budget = budget_bytes if budget_bytes is not None else 64 * 1024 ** 2
        shards = [s for svc in list(self.indices.values())
                  for s in list(svc.shards.values()) if s.state == SHARD_STARTED]
        now = time.time()
        sized = sorted(((s.engine.indexing_buffer_bytes(), s) for s in shards),
                       key=lambda t: -t[0])
        total = sum(b for b, _ in sized)
        refreshed = 0
        for nbytes, shard in sized:
            if nbytes <= 0:
                continue
            if total > budget or now - shard.engine.last_write_time > inactive_after:
                try:
                    shard.engine.refresh()
                except SearchEngineError:
                    continue
                total -= nbytes
                refreshed += 1
        return refreshed

    # ------------------------------------------------------------ nrt loop
    def periodic_refresh(self):
        """Refresh every started shard whose `index.refresh_interval` has
        passed (default 1s, -1 disables), then check its merge policy."""
        now = time.monotonic()
        for svc in list(self.indices.values()):
            interval = svc.settings.get_time("index.refresh_interval", 1.0)
            if interval is None or interval <= 0:
                continue
            for shard in list(svc.shards.values()):
                if shard.state != SHARD_STARTED or \
                        now - shard.last_scheduled_refresh < interval:
                    continue
                shard.last_scheduled_refresh = now
                try:
                    shard.engine.refresh()
                    self._schedule_merge(shard.engine)
                except SearchEngineError:
                    pass

    def _schedule_merge(self, engine: Engine):
        """The merge-policy check on the `merge` pool, off the refresh tick
        (a second submission is a no-op under the engine's merge mutex)."""
        try:
            self.threadpool.submit("merge", self._checked_merge, engine)
        except SearchEngineError:
            pass  # pool shut down: the next refresh tick re-schedules

    @staticmethod
    def _checked_merge(engine: Engine):
        try:
            engine.maybe_merge()
        except SearchEngineError:
            pass

    # ------------------------------------------------------------ reconciler
    def cluster_changed(self, event):
        with self._lock:
            self._apply_state(event.state)

    def _apply_state(self, state: ClusterState):
        """Remove the indices the metadata dropped and the shards no longer
        assigned here, then build each assigned shard's index service and
        shard, and start its recovery. An index whose service or shard
        fails to build is logged and skipped: the other indexes' shards
        still start."""
        meta_names = set(state.metadata.index_names())
        for name in [n for n in self.indices if n not in meta_names]:
            svc = self.indices.pop(name)
            for sid in list(svc.shards):
                self._remove_shard(svc, sid)
            # a recreated index of the same name must not recover this one
            shutil.rmtree(os.path.join(svc.data_path, name), ignore_errors=True)
            PACK_LEDGER.forget(name)
            if self.percolator is not None:
                self.percolator.registries.pop(name, None)
            self.logger.info("removed index [%s]", name)
        mine = {(s.index, s.shard_id) for s in state.routing_table.all_shards()
                if s.node_id == self.node_id and s.state in (INITIALIZING, STARTED)}
        for name, svc in list(self.indices.items()):
            for sid in [sid for sid in svc.shards if (name, sid) not in mine]:
                self._remove_shard(svc, sid)
                self.logger.info("removed shard [%s][%d]", name, sid)
        for s in state.routing_table.all_shards():
            if s.node_id != self.node_id or s.state not in (INITIALIZING, STARTED):
                continue
            meta = state.metadata.index(s.index)
            if meta is None:
                continue
            try:
                self._apply_shard(s, meta)
            except Exception:  # noqa: BLE001 — one index must not stop the rest
                self.logger.warning("failed to start shard [%s][%d]", s.index,
                                    s.shard_id, exc_info=True)

    def _apply_shard(self, s, meta):
        svc = self.indices.get(s.index)
        if svc is None:
            svc = IndexService(s.index, meta.settings, meta.mappings_dict(),
                               os.path.join(self.data_path, "indices"))
            self.indices[s.index] = svc
        else:
            # mapping updates reach the live mappers through the state
            for t, m in meta.mappings_dict().items():
                try:
                    svc.mapper_service.put_mapping(t, m)
                except SearchEngineError:
                    pass
        if s.shard_id not in svc.shards and s.state == INITIALIZING:
            shard = svc.create_shard(s.shard_id, s.primary)
            self._wire_cache_listeners(shard.engine, s.index, s.shard_id)
            if self.warmer is not None:
                # after the cache listeners: listeners run in order, so
                # the warmer sees a view whose superseded entries and
                # dropped masks are gone (a re-prime never races them)
                self.warmer.wire(s.index, s.shard_id, shard.engine)
            threading.Thread(target=self._recover_shard, args=(shard, s),
                             daemon=True,
                             name=f"estpu_torch-recover[{s.index}][{s.shard_id}]"
                             ).start()

    def _wire_cache_listeners(self, engine: Engine, index: str, shard_id: int):
        """Hang the node's caches off the engine's view listeners: a new
        view drops the shard's request-cache entries of older views, and
        the segments it dropped (merge sources, the copies a tombstone view
        replaced) evict their resident masks. The listener is a leaf: dict,
        counter and breaker work only (the engine calls it under its lock)."""
        rcache = self.request_cache
        fcache = self.filter_cache
        if rcache is None and fcache is None:
            return

        def on_view_change(searcher, dropped):
            if rcache is not None:
                rcache.invalidate_shard(index, shard_id, searcher.version)
            if fcache is not None and dropped:
                fcache.evict_dropped(dropped, searcher.segments)

        engine.view_listeners.append(on_view_change)

    def _remove_shard(self, svc: IndexService, shard_id: int):
        """A shard leaving this node: out of the warmer, its caches
        released, its engine closed, its segments' device packs dropped."""
        shard = svc.shards.get(shard_id)
        if shard is None:
            return
        if self.warmer is not None:
            self.warmer.unwire(shard.engine)
        segs = self._drop_shard_caches(shard)
        svc.remove_shard(shard_id)
        drop_segment_packs(segs)

    def _drop_shard_caches(self, shard: IndexShard) -> list:
        """A closing shard releases every cache byte it holds: its
        request-cache entries of every view and the filter masks of the
        segments of its last view. Returns those segments."""
        if self.request_cache is not None:
            self.request_cache.invalidate_shard(shard.index, shard.shard_id, None)
        try:
            segs = shard.engine.acquire_searcher().segments
        except SearchEngineError:
            segs = []
        if self.filter_cache is not None:
            self.filter_cache.evict_dropped(segs, ())
        return segs

    def _recover_shard(self, shard: IndexShard, routing: ShardRouting):
        shard.state = RECOVERING
        try:
            replayed = shard.engine.recover_from_store()
            self.logger.info("recovered primary [%s][%d] from store (%d ops)",
                             shard.index, shard.shard_id, replayed)
            shard.engine.refresh()
            shard.state = SHARD_STARTED
            self._report_started(routing)
        except Exception as e:  # noqa: BLE001
            self.logger.warning("recovery failed [%s][%d]: %s", shard.index,
                                shard.shard_id, e)

    def _report_started(self, routing: ShardRouting, retries: int = 10):
        for _ in range(retries):
            master = self.cluster_service.state.nodes.master
            if master is not None:
                try:
                    self.transport.submit_request(
                        master, ACTION_SHARD_STARTED, {"shard": routing.to_dict()},
                        timeout=5.0)
                    return
                except SearchEngineError:
                    pass
            time.sleep(0.1)
        self.logger.warning("could not report [%s][%d] started to the master",
                            routing.index, routing.shard_id)

    def stats(self) -> dict:
        """Per index, per shard: state, primary, docs, segments, translog
        and the engine's indexing counters (`_stats`, `_status`)."""
        out = {}
        for name, svc in list(self.indices.items()):
            shards = {}
            for sid, shard in list(svc.shards.items()):
                shards[sid] = {
                    "state": shard.state,
                    "primary": shard.primary,
                    "docs": shard.engine.doc_stats(),
                    "segments": shard.engine.segment_count(),
                    "translog": shard.engine.translog.stats(),
                    "indexing": dict(shard.engine.stats),
                }
            out[name] = {"shards": shards}
        return out

    def close(self):
        with self._lock:
            for svc in self.indices.values():
                for sid in list(svc.shards):
                    self._remove_shard(svc, sid)
            self.indices.clear()
