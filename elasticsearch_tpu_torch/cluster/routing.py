"""Operation routing: doc → shard, search shard selection (a trimmed copy of
the JAX package's `cluster/routing.py`).

shard_id = |djb2(routing ?: id)| % number_of_shards, with the JAX package's
exact DJB2 (32-bit overflow, Java int sign), so the port places every
document on the shard the JAX package places it. `search_shards` picks one
active copy of every shard group round-robin; `preference`, adaptive replica
selection and hedging belong to the slice with replicas."""

from __future__ import annotations

import itertools

from ..common.errors import NoShardAvailableError
from .state import ClusterState, IndexShardRoutingTable, ShardRouting


def djb2_hash(value: str) -> int:
    """DJB2 over code points, 32-bit overflow, as a signed Java int."""
    h = 5381
    for ch in value:
        h = ((h << 5) + h + ord(ch)) & 0xFFFFFFFF
    if h >= 0x80000000:
        h -= 0x100000000
    return h


class OperationRouting:
    def __init__(self):
        self._rr = itertools.count()

    @staticmethod
    def shard_id(state: ClusterState, index: str, doc_id: str,
                 routing: str | None = None) -> int:
        meta = state.metadata.require_index(index)
        h = djb2_hash(str(routing) if routing is not None else str(doc_id))
        return abs(h) % meta.number_of_shards

    def search_shards(self, state: ClusterState, indices: list[str],
                      routing: str | None = None) -> list[ShardRouting]:
        """One active copy of every relevant shard group; `routing` (a comma
        list) narrows the groups to the ones its values hash to."""
        out = []
        for index in indices:
            table = state.routing_table.index(index)
            if table is None:
                continue
            meta = state.metadata.require_index(index)
            if routing is not None:
                shard_ids = {abs(djb2_hash(r)) % meta.number_of_shards
                             for r in str(routing).split(",")}
            else:
                shard_ids = range(len(table.shards))
            for sid in shard_ids:
                out.append(self._pick(table.shard(sid)))
        return out

    def _pick(self, group: IndexShardRoutingTable) -> ShardRouting:
        active = group.active_shards()
        if not active:
            s = group.shards[0]
            raise NoShardAvailableError(f"no active copy for [{s.index}][{s.shard_id}]")
        return active[next(self._rr) % len(active)]
