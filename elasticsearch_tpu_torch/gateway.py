"""Local gateway: cluster metadata persistence and startup recovery (a
trimmed copy of the JAX package's `gateway.py`, ROADMAP A5a).

The node persists the cluster MetaData (indices with their settings,
mappings, aliases, warmers and state; the index templates) under
`path.data/_state` on every change, and on `persist_now` (the
`_gateway/snapshot` API). The elected master's `maybe_recover` restores the
persisted indices and templates once `gateway.recover_after_nodes` nodes
(1 by default) are in the cluster and lifts the state-not-recovered block;
until then the block stays (reads and writes answer 503) and every node
that joins checks again. The restored open indices get fresh routing, and
the post-recovery reroute assigns their primaries over the data nodes,
whose shards then recover from their stores and translogs
(indices_service). A closed index comes back closed, with no routing and,
as in the JAX package, without its closed block; the templates come back
only when at least one index does (the JAX package's order). A fresh
`path.data` recovers nothing and only lifts the block. A node that is not
master recovers nothing: it installs the master's published state.

The JAX gateway checks the count once, when its master starts, and its
fresh state carries no block; the port holds the block and checks again at
every join (ROADMAP, declared differences)."""

from __future__ import annotations

import json
import os
import threading

from .cluster.allocation import new_index_routing
from .cluster.service import URGENT
from .cluster.state import BLOCK_STATE_NOT_RECOVERED, ClusterState, MetaData
from .common.logging import get_logger
from .common.settings import Settings


class LocalGateway:
    def __init__(self, data_path: str, cluster_service, settings: Settings,
                 allocation, node_name: str | None = None):
        self.dir = os.path.join(data_path, "_state")
        self.cluster_service = cluster_service
        self.settings = settings
        # the node's allocation service: its deciders place the restored
        # shards
        self.allocation = allocation
        self.recover_after_nodes = self.settings.get_int(
            "gateway.recover_after_nodes", 1)
        self.logger = get_logger("gateway", node=node_name)
        self._recovered = False
        self._lock = threading.Lock()
        os.makedirs(self.dir, exist_ok=True)
        cluster_service.add_listener(self._on_change)

    @property
    def meta_path(self) -> str:
        return os.path.join(self.dir, "metadata.json")

    # persistence ------------------------------------------------------------
    def _on_change(self, event):
        if event.metadata_changed():
            self.persist_now()
        if not self._recovered and event.nodes_added() and \
                event.previous_state.nodes.master_id is not None:
            # a join to an elected master may complete recover_after_nodes:
            # check again (only the recovery lifts the not-recovered block),
            # off the cluster-state thread (the recovery waits on it); the
            # election itself is checked by the node's start
            threading.Thread(target=self.maybe_recover, daemon=True,
                             name="estpu_torch-gateway-recover").start()

    def persist_now(self):
        try:
            tmp = self.meta_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(self.cluster_service.state.metadata.to_dict(), fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.meta_path)
        except OSError as e:
            self.logger.warning("metadata persist failed: %s", e)

    def load_metadata(self) -> MetaData | None:
        if not os.path.exists(self.meta_path):
            return None
        with open(self.meta_path) as fh:
            return MetaData.from_dict(json.load(fh))

    # recovery ---------------------------------------------------------------
    def maybe_recover(self):
        """Restore the persisted metadata and lift the not-recovered block,
        then reroute the restored shards onto this node.

        The lock covers only the recovered-check and the task submission;
        the wait on the cluster-state thread happens with no lock held, so a
        state task that re-entered the gateway (a metadata listener calling
        back in) could not deadlock against it."""
        with self._lock:
            if self._recovered:
                return
            state = self.cluster_service.state
            if state.nodes.master_id != state.nodes.local_id or \
                    state.nodes.local_id is None:
                return  # not master: the master's published state comes
            if state.nodes.size < self.recover_after_nodes:
                self.logger.info("waiting for %d nodes before recovery (have %d)",
                                 self.recover_after_nodes, state.nodes.size)
                return
            persisted = self.load_metadata()
            self._recovered = True
            names = [] if persisted is None else persisted.index_names()

            def update(current: ClusterState) -> ClusterState:
                md = current.metadata
                rt = current.routing_table
                for name in names:
                    if md.has_index(name):
                        continue
                    meta = persisted.index(name)
                    md = md.with_index(meta)
                    if meta.state == "open":
                        rt = rt.with_index(new_index_routing(
                            name, meta.number_of_shards, meta.number_of_replicas))
                # as in the JAX package, templates come back only beside at
                # least one index
                for _tname, tpl in persisted.templates if names else ():
                    md = md.with_template(tpl)
                return current.next_version(
                    metadata=md, routing_table=rt,
                    blocks=current.blocks.without_global(BLOCK_STATE_NOT_RECOVERED))

            fut = self.cluster_service.submit_state_update_task(
                "gateway-recovery", update, priority=URGENT)
        fut.result(10)
        if names:
            self.logger.info("recovered %d indices from [%s]: %s", len(names),
                             self.meta_path, names)
            # allocation of the restored shards goes through the reroute
            self.cluster_service.submit_state_update_task(
                "gateway-post-recovery-reroute",
                self.allocation.reroute).result(10)
