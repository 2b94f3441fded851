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
  replays its translog) on a thread of its own, and report shard-started
  to the master, or shard-failed with the reason when the recovery fails
  (`_send_to_master`: the master may be another node; retried while no
  master is known). A shard the routing moves off this node, or that a
  departed node's reroute re-creates here as a fresh primary, follows the
  same two paths: the removal releases its caches and device packs as an
  index removal does. A removed shard's engine leaves the warmer first, so
  no warm pack or re-prime starts on it.
- Peer recovery of a replica from its primary's node (`_peer_recover`),
  in three phases: (1) the primary flushes and answers its file manifest
  with checksums under a recovery hold; the target keeps the files it
  already has with the same checksum, deletes every other local file, and
  pulls the rest in `indices.recovery.file_chunk_size` chunks (512 KB),
  throttled on the target side to `indices.recovery.max_bytes_per_sec`
  (40 MB/s), each file checked against its checksum; then it loads that
  commit; (2) it replays the primary's translog from the commit's
  generation while the primary goes on taking writes (the hold keeps those
  generations); (3) it applies the op tail the primary reads under its
  engine lock, which releases the hold. Writes the primary replicated to
  the copy meanwhile are dropped by the load of phase 1 and come back
  through phases 2 and 3. `IndexShard.recovery_info` keeps the files,
  reused files, bytes and throttle of phase 1. The primary's four
  handlers (files, chunk, translog, finalize) each touch the hold and
  fail the recovery when it expired. A recovered copy is refreshed before
  it is reported started, so its first search packs its segments on the
  query path, as a primary's does.
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

The removal runs on the cluster-state thread under the indices lock: it closes
engines and drops references (no device sync, no launch); the device
memory goes back to the allocator once the last search holding a view of
the index ends."""

from __future__ import annotations

import base64
import os
import shutil
import threading
import time
from dataclasses import dataclass, field

from .cluster.state import INITIALIZING, RELOCATING, STARTED, ClusterState, ShardRouting
from .common.errors import IndexMissingError, IndexShardMissingError, SearchEngineError
from .common.logging import get_logger
from .common.settings import Settings
from .index.engine import Engine
from .index.store import _crc_file
from .index.translog import TranslogOp
from .mapper import MapperService
from .ops.device_index import PACK_LEDGER, drop_segment_packs
from .search.similarity import SimilarityService

ACTION_SHARD_STARTED = "internal:cluster/shard/started"
ACTION_SHARD_FAILED = "internal:cluster/shard/failed"
ACTION_RECOVERY_FILES = "internal:index/shard/recovery/files"
ACTION_RECOVERY_CHUNK = "internal:index/shard/recovery/chunk"
ACTION_RECOVERY_TRANSLOG = "internal:index/shard/recovery/translog"
ACTION_RECOVERY_FINALIZE = "internal:index/shard/recovery/finalize"

# shard lifecycle
CREATED, RECOVERING, POST_RECOVERY, SHARD_STARTED, CLOSED = (
    "CREATED", "RECOVERING", "POST_RECOVERY", "STARTED", "CLOSED")


@dataclass
class IndexShard:
    index: str
    shard_id: int
    engine: Engine
    primary: bool
    state: str = CREATED
    # a peer recovery's phase 1: files, reused, bytes, throttle_ms
    recovery_info: dict = field(default_factory=dict)
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
                 percolator=None, node_name: str | None = None):
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
        self.logger = get_logger("indices", node=node_name)
        self._lock = threading.RLock()
        transport.register_handler(ACTION_RECOVERY_FILES, self._handle_recovery_files)
        transport.register_handler(ACTION_RECOVERY_CHUNK, self._handle_recovery_chunk)
        transport.register_handler(ACTION_RECOVERY_TRANSLOG,
                                   self._handle_recovery_translog)
        transport.register_handler(ACTION_RECOVERY_FINALIZE,
                                   self._handle_recovery_finalize)
        cluster_service.add_listener(self.cluster_changed)

    def index_service(self, name: str) -> IndexService:
        svc = self.indices.get(name)
        if svc is None:
            raise IndexMissingError(name)
        return svc

    def shard_or_none(self, index: str, shard_id: int) -> IndexShard | None:
        svc = self.indices.get(index)
        return svc.shards.get(shard_id) if svc else None

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
        # a RELOCATING source keeps serving until its target takes over
        live = (INITIALIZING, STARTED, RELOCATING)
        mine = {(s.index, s.shard_id) for s in state.routing_table.all_shards()
                if s.node_id == self.node_id and s.state in live}
        for name, svc in list(self.indices.items()):
            for sid in [sid for sid in svc.shards if (name, sid) not in mine]:
                self._remove_shard(svc, sid)
                self.logger.info("removed shard [%s][%d]", name, sid)
        for s in state.routing_table.all_shards():
            if s.node_id != self.node_id or s.state not in live:
                continue
            meta = state.metadata.index(s.index)
            if meta is None:
                continue
            try:
                self._apply_shard(s, meta, state)
            except Exception:  # noqa: BLE001 — one index must not stop the rest
                self.logger.warning("failed to start shard [%s][%d]", s.index,
                                    s.shard_id, exc_info=True)

    def _apply_shard(self, s, meta, state: ClusterState):
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
        local = svc.shards.get(s.shard_id)
        if local is not None:
            local.primary = s.primary
        elif s.state == INITIALIZING:
            shard = svc.create_shard(s.shard_id, s.primary)
            self._wire_cache_listeners(shard.engine, s.index, s.shard_id)
            if self.warmer is not None:
                # after the cache listeners: listeners run in order, so
                # the warmer sees a view whose superseded entries and
                # dropped masks are gone (a re-prime never races them)
                self.warmer.wire(s.index, s.shard_id, shard.engine)
            threading.Thread(target=self._recover_shard, args=(shard, s, state),
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

    def restore_shard(self, index: str, shard_id: int, fill) -> IndexShard:
        """A snapshot restore's swap of this node's copy of a shard: the
        old shard leaves as any departing shard does (`_remove_shard`: out
        of the warmer, its request-cache entries and filter masks dropped,
        its engine closed, its segments' packs dropped), its store and
        translog are emptied, `fill(store_dir)` writes the snapshot's files,
        and a new shard, wired to the caches and the warmer, recovers from
        that store, refreshes and is started."""
        svc = self.index_service(index)
        old = svc.shard(shard_id)
        primary = old.primary
        store_dir, translog_dir = old.engine.store.dir, old.engine.translog.dir
        self._remove_shard(svc, shard_id)
        for d in (store_dir, translog_dir):
            for name in list(os.listdir(d)):
                os.unlink(os.path.join(d, name))
        fill(store_dir)
        shard = svc.create_shard(shard_id, primary)
        self._wire_cache_listeners(shard.engine, index, shard_id)
        if self.warmer is not None:
            self.warmer.wire(index, shard_id, shard.engine)
        shard.engine.recover_from_store()
        shard.engine.refresh()
        shard.state = SHARD_STARTED
        if self.request_cache is not None:
            # an entry a search stored during the swap, under the old view
            self.request_cache.invalidate_shard(index, shard_id, None)
        return shard

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

    def _recover_shard(self, shard: IndexShard, routing: ShardRouting,
                       state: ClusterState):
        """A primary recovers from its store, a replica from its primary's
        node (`_peer_recover`); the shard is refreshed, then reported
        started, or failed with the reason."""
        shard.state = RECOVERING
        try:
            if routing.primary:
                replayed = shard.engine.recover_from_store()
                self.logger.info("recovered primary [%s][%d] from store (%d ops)",
                                 shard.index, shard.shard_id, replayed)
            else:
                self._peer_recover(shard, state)
            shard.state = POST_RECOVERY
            shard.engine.refresh()
            self._report_started(routing)
            shard.state = SHARD_STARTED
        except Exception as e:  # noqa: BLE001
            self.logger.warning("recovery failed [%s][%d]: %s", shard.index,
                                shard.shard_id, e)
            self._report_failed(routing, str(e))

    def _peer_recover(self, shard: IndexShard, state: ClusterState):
        """The three phases from the primary's node (the module docstring)."""
        group = state.routing_table.index(shard.index).shard(shard.shard_id)
        primary = group.primary
        if primary is None or not primary.assigned:
            raise SearchEngineError("no primary to recover from")
        primary_node = state.nodes.get(primary.node_id)
        if primary_node is None:
            raise SearchEngineError("primary node not in cluster")
        svc = self.indices[shard.index]
        chunk_size = svc.settings.get_bytes("indices.recovery.file_chunk_size",
                                            512 * 1024)
        max_bps = svc.settings.get_bytes("indices.recovery.max_bytes_per_sec",
                                         40 * 1024 * 1024)
        addr = primary_node.transport_address
        key = {"index": shard.index, "shard": shard.shard_id}

        # phase 1: the manifest, then the missing files in chunks
        local_files = shard.engine.store.list_files()
        resp = self.transport.submit_request(
            addr, ACTION_RECOVERY_FILES,
            {**key, "have": {n: f["checksum"] for n, f in local_files.items()}},
            timeout=60.0)
        hold = resp.get("hold")
        try:
            store_dir = shard.engine.store.dir
            # the store must end up exactly the primary's file set: a stale
            # local commit (a demoted primary's) would beat the copied one
            keep = set(resp.get("names", ()))
            for name in local_files:
                if name not in keep:
                    os.unlink(os.path.join(store_dir, name))
            received, throttle_s = 0, 0.0
            t0 = time.monotonic()
            for name, length, checksum in resp["manifest"]:
                tmp = os.path.join(store_dir, name + ".tmp")
                with open(tmp, "wb") as fh:
                    off = 0
                    while off < length:
                        r = self.transport.submit_request(
                            addr, ACTION_RECOVERY_CHUNK,
                            {**key, "name": name, "offset": off,
                             "length": min(chunk_size, length - off), "hold": hold},
                            timeout=60.0)
                        data = base64.b64decode(r["data"])
                        if not data:
                            raise SearchEngineError(
                                f"short read recovering [{name}] at {off}")
                        fh.write(data)
                        off += len(data)
                        received += len(data)
                        if max_bps and max_bps > 0:
                            # the target paces its pulls against the budget
                            ahead = received / max_bps - (time.monotonic() - t0)
                            if ahead > 0:
                                time.sleep(ahead)
                                throttle_s += ahead
                if _crc_file(tmp) != checksum:
                    raise SearchEngineError(f"checksum mismatch recovering [{name}]")
                os.replace(tmp, os.path.join(store_dir, name))
            reused = resp.get("reused", 0)
            shard.recovery_info = {"files": len(resp["manifest"]), "reused": reused,
                                   "bytes": received,
                                   "throttle_ms": int(throttle_s * 1000)}
            shard.engine.recover_from_store()

            # phase 2: the translog from the copied commit's generation
            resp2 = self.transport.submit_request(
                addr, ACTION_RECOVERY_TRANSLOG,
                {**key, "from_gen": resp.get("base_gen"), "hold": hold}, timeout=60.0)
            for op_b64 in resp2["ops"]:
                shard.engine.apply_replicated_op(
                    TranslogOp.decode(base64.b64decode(op_b64)))

            # phase 3: the tail, read under the primary's engine lock
            resp3 = self.transport.submit_request(
                addr, ACTION_RECOVERY_FINALIZE,
                {**key, "gen": resp2["gen"], "count": resp2["count"], "hold": hold},
                timeout=60.0)
            hold = None  # the finalize released it
            for op_b64 in resp3["ops"]:
                shard.engine.apply_replicated_op(
                    TranslogOp.decode(base64.b64decode(op_b64)))
            self.logger.info(
                "peer-recovered [%s][%d]: %d files (%d reused, %d bytes, "
                "throttled %.0fms), %d + %d translog ops", shard.index,
                shard.shard_id, len(resp["manifest"]), reused, received,
                throttle_s * 1000, len(resp2["ops"]), len(resp3["ops"]))
        finally:
            if hold is not None:
                # a recovery that died mid-flight releases the primary's pin
                # now rather than at the hold's expiry
                try:
                    self.transport.submit_request(
                        addr, ACTION_RECOVERY_FINALIZE,
                        {**key, "release_only": True, "hold": hold}, timeout=10.0)
                except SearchEngineError:
                    pass  # the expiry cleans up

    def _shard_engine(self, request) -> Engine:
        shard = self.shard_or_none(request["index"], request["shard"])
        if shard is None:
            raise IndexShardMissingError(f"[{request['index']}][{request['shard']}]")
        return shard.engine

    @staticmethod
    def _touch_hold(eng: Engine, request):
        """Keep the recovery hold alive; an expired one fails the recovery
        (its pinned files may be gone) rather than serve a short replay."""
        hold = request.get("hold")
        if hold is not None and not eng.touch_recovery_hold(hold):
            raise SearchEngineError("recovery hold expired — restart recovery")

    def _handle_recovery_files(self, request, channel):
        """Phase 1, primary side: a flush, a hold and the commit's translog
        generation taken together under the engine lock (a flush between
        them would leave ops in neither the files nor phase 2), then the
        checksums outside it (the hold keeps the write-once files)."""
        eng = self._shard_engine(request)
        with eng._lock:
            eng.flush(force=True)
            hold = eng.acquire_recovery_hold()
            base_gen = eng.translog.gen
            names = [n for n in sorted(os.listdir(eng.store.dir))
                     if os.path.isfile(os.path.join(eng.store.dir, n))
                     and not n.endswith(".tmp")]
        have = request.get("have", {})
        manifest, reused = [], 0
        for name in names:
            p = os.path.join(eng.store.dir, name)
            checksum = _crc_file(p)
            if have.get(name) == checksum:
                reused += 1
                continue
            manifest.append((name, os.path.getsize(p), checksum))
        return {"manifest": manifest, "reused": reused, "hold": hold,
                "base_gen": base_gen, "names": names}

    def _handle_recovery_chunk(self, request, channel):
        """One bounded slice of one store file (the target paces the pulls)."""
        eng = self._shard_engine(request)
        self._touch_hold(eng, request)
        path = os.path.join(eng.store.dir, os.path.basename(str(request["name"])))
        with open(path, "rb") as fh:
            fh.seek(int(request["offset"]))
            data = fh.read(int(request["length"]))
        return {"data": base64.b64encode(data).decode("ascii")}

    def _handle_recovery_translog(self, request, channel):
        eng = self._shard_engine(request)
        self._touch_hold(eng, request)
        gen = request.get("from_gen")
        if gen is None:
            gen = eng.translog.gen
        ops = eng.translog.read_ops(from_gen=int(gen))
        return {"ops": [base64.b64encode(op.encode()).decode("ascii") for op in ops],
                "gen": int(gen), "count": len(ops)}

    def _handle_recovery_finalize(self, request, channel):
        """Phase 3, primary side: the op tail since the phase-2 read, taken
        under the engine lock, then the hold released."""
        eng = self._shard_engine(request)
        try:
            if request.get("release_only"):
                return {"ops": []}
            self._touch_hold(eng, request)
            tail = eng.translog_ops_since(int(request["gen"]), int(request["count"]))
            return {"ops": [base64.b64encode(op.encode()).decode("ascii")
                            for op in tail]}
        finally:
            eng.release_recovery_hold(request.get("hold"))

    def _report_started(self, routing: ShardRouting):
        self._send_to_master(ACTION_SHARD_STARTED, {"shard": routing.to_dict()})

    def _report_failed(self, routing: ShardRouting, reason: str):
        self._send_to_master(ACTION_SHARD_FAILED,
                             {"shard": routing.to_dict(), "reason": reason})

    def _send_to_master(self, action: str, body: dict, retries: int = 10):
        for _ in range(retries):
            master = self.cluster_service.state.nodes.master
            if master is not None:
                try:
                    self.transport.submit_request(master.transport_address, action,
                                                  body, timeout=5.0)
                    return
                except SearchEngineError:
                    pass
            time.sleep(0.1)
        self.logger.warning("could not reach the master for %s", action)

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
