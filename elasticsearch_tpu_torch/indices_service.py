"""Node-level index management and the cluster-state reconciler (a trimmed
copy of the JAX package's `indices_service.py`).

- `IndexService`: one index on this node — its MapperService,
  SimilarityService and shards.
- `IndicesService.cluster_changed` (IndicesClusterStateService's role): on
  every cluster-state change, create the shards the routing table assigns
  here, recover each primary from its local store (a fresh shard recovers
  nothing; the translog replay runs all the same) on a thread of its own,
  and report shard-started to the master.
- `periodic_refresh`: the scheduled NRT refresh per shard honouring
  `index.refresh_interval` (-1 disables it), then a merge-policy check on
  the `merge` pool.

Peer recovery of replicas, index deletion, the indexing-memory controller
and the cache and warmer listeners belong to later slices."""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

from .cluster.state import INITIALIZING, STARTED, ClusterState, ShardRouting
from .common.errors import IndexMissingError, IndexShardMissingError, SearchEngineError
from .common.logging import get_logger
from .common.settings import Settings
from .index.engine import Engine
from .mapper import MapperService
from .search.similarity import SimilarityService

ACTION_SHARD_STARTED = "internal:cluster/shard/started"

# shard lifecycle
CREATED, RECOVERING, SHARD_STARTED = "CREATED", "RECOVERING", "STARTED"


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


class IndicesService:
    def __init__(self, node_id: str, data_path: str, transport, cluster_service,
                 threadpool):
        self.node_id = node_id
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
        for s in state.routing_table.all_shards():
            if s.node_id != self.node_id or s.state not in (INITIALIZING, STARTED):
                continue
            meta = state.metadata.index(s.index)
            if meta is None:
                continue
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
                threading.Thread(target=self._recover_shard, args=(shard, s),
                                 daemon=True,
                                 name=f"estpu_torch-recover[{s.index}][{s.shard_id}]"
                                 ).start()

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

    def close(self):
        with self._lock:
            for svc in self.indices.values():
                for shard in svc.shards.values():
                    shard.engine.close()
            self.indices.clear()
