"""Operation routing: doc → shard, search shard selection (a copy of the
JAX package's `cluster/routing.py`).

shard_id = |djb2(routing ?: id)| % number_of_shards, with the JAX package's
exact DJB2 (32-bit overflow, Java int sign), so the port places every
document on the shard the JAX package places it. `search_shards` picks one
active copy of every shard group, honouring `preference` as the JAX
package's does: `_shards:N,M` (with an optional `;<preference>` for the
copy) searches only those shard groups (`split_preference`), `_primary` the
primary, `_local` and `_prefer_node:x` a copy on that node when there is
one, `_only_node:x` only that node's copy, and any other string a copy
fixed by its djb2. Without a preference (and for `_local` and
`_prefer_node:x` with no such copy) the choice is ADAPTIVE when a
`cluster/stats.py AdaptiveReplicaSelector` is wired, as the node wires
it: the copies within the spread of the best C3-style health score take
turns, a copy outside it gets a probe every few selections, and a
cache-eligible request's fingerprint (`affinity`) lands it on one copy
of that set by a rendezvous hash. Until every copy of the group has the
selector's `min_samples` answers the choice is round-robin, which is what
warms it. `ranked_copies` is a search's failover order for one group: the
chosen copy first, then the group's other active copies best-first by
the selector's rank."""

from __future__ import annotations

import itertools

import hashlib

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
    def __init__(self, selector=None):
        self._rr = itertools.count()
        # an AdaptiveReplicaSelector, or None: round-robin always
        self.selector = selector

    @staticmethod
    def shard_id(state: ClusterState, index: str, doc_id: str,
                 routing: str | None = None) -> int:
        meta = state.metadata.require_index(index)
        h = djb2_hash(str(routing) if routing is not None else str(doc_id))
        return abs(h) % meta.number_of_shards

    def get_shard_copy(self, state: ClusterState, index: str, doc_id: str,
                       routing: str | None = None) -> ShardRouting:
        """One active copy of the document's shard group, for a single-shard
        read."""
        group = state.routing_table.index(index).shard(
            self.shard_id(state, index, doc_id, routing))
        return self._pick(self._active(group))

    @staticmethod
    def split_preference(preference: str | None) \
            -> tuple[set[int] | None, str | None]:
        """`_shards:0,2[;pref]` → ({0, 2}, the copy preference after the
        `;` or None); any other preference → (None, itself or None)."""
        if not preference or not preference.startswith("_shards:"):
            return None, preference or None
        spec, _, copy_pref = preference[len("_shards:"):].partition(";")
        return ({int(s) for s in spec.split(",") if s.strip()},
                copy_pref or None)

    def search_shards(self, state: ClusterState, indices: list[str],
                      routing: str | None = None, preference: str | None = None,
                      affinity: str | None = None) -> list[ShardRouting]:
        """One active copy of every relevant shard group; `routing` (a comma
        list) narrows the groups to the ones its values hash to, and a
        `_shards:` preference to the ones it names. `affinity`, the request
        cache's fingerprint of a cache-eligible body, is a soft affinity
        inside the adaptive choice: health still decides the eligible
        copies, probes and quarantine are unchanged, and every explicit
        preference wins."""
        only_shards, preference = self.split_preference(preference)
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
                if only_shards is not None and sid not in only_shards:
                    continue
                out.append(self._select(table.shard(sid), state, preference, affinity))
        return out

    def _select(self, group: IndexShardRoutingTable, state: ClusterState,
                preference: str | None, affinity: str | None = None) -> ShardRouting:
        """One active copy of the group under the copy preference."""
        active = self._active(group)
        if not preference:
            return self._pick(active, affinity)
        if preference == "_primary":
            for s in active:
                if s.primary:
                    return s
            raise NoShardAvailableError("primary not active")
        if preference == "_local" or preference.startswith("_prefer_node:"):
            node_id = state.nodes.local_id if preference == "_local" \
                else preference.split(":", 1)[1]
            for s in active:
                if node_id and s.node_id == node_id:
                    return s
            # no such copy: the plain choice (hashing the literal would pin
            # every coordinator to one copy)
            return self._pick(active, affinity)
        if preference.startswith("_only_node:"):
            node_id = preference.split(":", 1)[1]
            for s in active:
                if s.node_id == node_id:
                    return s
            raise NoShardAvailableError(f"no copy on node [{node_id}]")
        # a custom string (a session key): a copy fixed by its hash
        return active[abs(djb2_hash(preference)) % len(active)]

    @staticmethod
    def _active(group: IndexShardRoutingTable) -> list[ShardRouting]:
        active = group.active_shards()
        if not active:
            s = group.shards[0]
            raise NoShardAvailableError(f"no active copy for [{s.index}][{s.shard_id}]")
        return active

    def _pick(self, active: list[ShardRouting],
              affinity: str | None = None) -> ShardRouting:
        """The preference-free choice: the selector's when it is wired and
        the group is warm (it applies the affinity inside its spread set),
        else round-robin. A cold group round-robins even with an affinity:
        warming every copy's record comes before cache locality."""
        if self.selector is not None:
            s = self.selector.select(active, affinity=affinity)
            if s is not None:
                return s
            if self.selector.enabled and len(active) > 1:
                return active[next(self._rr) % len(active)]
        if affinity is not None and len(active) > 1:
            # no selector: the plain rendezvous affinity
            return self.rendezvous(affinity, active)
        return active[next(self._rr) % len(active)]

    @staticmethod
    def rendezvous(affinity: str, copies: list[ShardRouting]) -> ShardRouting:
        """The highest-random-weight copy for `affinity`: every coordinator
        picks the same copy for the same fingerprint (an unkeyed blake2b,
        stable across processes, where djb2's weak mixing would let the
        node id's last byte pin every fingerprint to one copy), and
        removing a copy moves only the fingerprints it held."""
        return max(copies, key=lambda s: (
            hashlib.blake2b(f"{affinity}#{s.node_id}".encode("utf-8"),
                            digest_size=8).digest(), s.node_id))

    def ranked_copies(self, group: IndexShardRoutingTable,
                      first: ShardRouting) -> list[ShardRouting]:
        """A failover chain's order for one group: `first`, the copy already
        chosen, then the group's other active copies best-first by the
        selector's rank (quarantined copies last)."""
        rest = [s for s in group.active_shards() if s.node_id != first.node_id]
        if self.selector is not None and rest:
            rest = self.selector.ranked(rest)
        return [first] + rest
