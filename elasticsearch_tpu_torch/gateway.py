"""Local gateway, trimmed to a fresh start (a trimmed copy of the JAX
package's `gateway.py`): the node persists the cluster metadata under
`path.data/_state` on every change, and on start it lifts the
state-not-recovered block.

Recovering that metadata (and the shards' stores) on a restart is the slice
with gateway recovery (ROADMAP A6b): a node started over a `path.data` that
already holds cluster metadata raises NotPortedError instead of silently
starting empty beside the old data."""

from __future__ import annotations

import json
import os

from .cluster.service import URGENT
from .cluster.state import BLOCK_STATE_NOT_RECOVERED, ClusterState
from .common.errors import NotPortedError
from .common.logging import get_logger


class LocalGateway:
    def __init__(self, data_path: str, cluster_service):
        self.dir = os.path.join(data_path, "_state")
        self.cluster_service = cluster_service
        self.logger = get_logger("gateway")
        if os.path.exists(self.meta_path):
            raise NotPortedError(
                f"[{data_path}] holds cluster metadata from an earlier run; "
                "recovering it is not ported yet (the gateway-recovery slice) "
                "— start the node over an empty path.data")
        os.makedirs(self.dir, exist_ok=True)
        cluster_service.add_listener(self._on_change)

    @property
    def meta_path(self) -> str:
        return os.path.join(self.dir, "metadata.json")

    def _on_change(self, event):
        if event.metadata_changed():
            self.persist_now()

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

    def recover_fresh(self):
        """A fresh cluster has no state to recover: lift the block."""

        def update(state: ClusterState) -> ClusterState:
            return state.next_version(
                blocks=state.blocks.without_global(BLOCK_STATE_NOT_RECOVERED))

        self.cluster_service.submit_state_update_task(
            "gateway-recovery", update, priority=URGENT).result(10)
