"""Shard allocation (a copy of the JAX package's `cluster/allocation.py`):
deciders, the balanced allocator and reroute, pure functions over
ClusterState.

`AllocationService.reroute` assigns UNASSIGNED copies (primaries first) to
the data node of least weight (0.45 x its shards + 0.55 x its shards of
the index, ties to the lower node id) among those every decider answers
YES, then moves at most one STARTED replica from the heaviest node to the
lightest when their shard counts differ by more than
`cluster.routing.allocation.balance.threshold` (a RELOCATING source and an
INITIALIZING target, each naming the other in `relocating_node`).
`apply_started_shards` starts copies (a relocation target retires its
source), `apply_failed_shard` fails one (an active replica is promoted
when a primary fails, else the unassigned copy becomes the primary; a
failed relocation half unwinds the pair), and `remove_node` fails every
copy of a node that left: with no replica, each of its primaries is
assigned again as a fresh, empty primary on a node that remains.

The decider chain (`DEFAULT_DECIDERS`) is the JAX package's: same shard,
replica after primary, `enable`, include/require/exclude filters,
awareness, throttling (`node_concurrent_recoveries`, 2), the disk
watermark, `total_shards_per_node`, snapshot in progress, node version,
`allow_rebalance` and `cluster_concurrent_rebalance`. A replica is
allocated as on the JAX node: it starts INITIALIZING and peer-recovers
from its primary (indices_service)."""

from __future__ import annotations

import fnmatch
from dataclasses import replace

from ..common.logging import get_logger
from ..common.settings import Settings
from .state import (
    INITIALIZING,
    RELOCATING,
    STARTED,
    UNASSIGNED,
    ClusterState,
    IndexRoutingTable,
    IndexShardRoutingTable,
    ShardRouting,
)

YES, NO, THROTTLE = "YES", "NO", "THROTTLE"


class Decider:
    name = "base"

    def can_allocate(self, shard: ShardRouting, node_id: str, ctx: "AllocationContext") -> str:
        return YES

    def can_rebalance(self, shard: ShardRouting, ctx: "AllocationContext") -> str:
        """May this STARTED shard start relocating at all? (The target's
        fitness is can_allocate's.)"""
        return YES


class SameShardDecider(Decider):
    name = "same_shard"

    def can_allocate(self, shard, node_id, ctx):
        for s in ctx.shards_on_node(node_id):
            if s.shard_key() == shard.shard_key():
                return NO
        return YES


class ReplicaAfterPrimaryDecider(Decider):
    name = "replica_after_primary_active"

    def can_allocate(self, shard, node_id, ctx):
        if shard.primary:
            return YES
        group = ctx.state.routing_table.index(shard.index).shard(shard.shard_id)
        p = group.primary
        return YES if p is not None and p.active else NO


class EnableDecider(Decider):
    name = "enable"

    def can_allocate(self, shard, node_id, ctx):
        mode = ctx.settings.get_str("cluster.routing.allocation.enable", "all")
        if mode == "none":
            return NO
        if mode == "primaries" and not shard.primary:
            return NO
        if mode == "new_primaries" and not shard.primary:
            return NO
        return YES


class FilterDecider(Decider):
    name = "filter"

    def can_allocate(self, shard, node_id, ctx):
        node = ctx.state.nodes.get(node_id)
        if node is None:
            return NO
        for scope, settings in (("cluster.routing.allocation", ctx.settings),
                                (f"index.routing.allocation", ctx.index_settings(shard.index))):
            for rule, positive in (("include", True), ("require", True), ("exclude", False)):
                prefix = f"{scope}.{rule}."
                for key in settings:
                    if not key.startswith(prefix):
                        continue
                    attr = key[len(prefix):]
                    patterns = [p.strip() for p in str(settings[key]).split(",") if p.strip()]
                    value = node.name if attr == "_name" else (
                        node.id if attr == "_id" else node.attr(attr, ""))
                    matched = any(fnmatch.fnmatch(str(value), p) for p in patterns)
                    if rule == "exclude" and matched:
                        return NO
                    if rule == "require" and not matched:
                        return NO
                    if rule == "include" and patterns and not matched:
                        return NO
        return YES


class AwarenessDecider(Decider):
    name = "awareness"

    def can_allocate(self, shard, node_id, ctx):
        attrs = ctx.settings.get_list("cluster.routing.allocation.awareness.attributes")
        if not attrs:
            return YES
        node = ctx.state.nodes.get(node_id)
        if node is None:
            return NO
        group = ctx.state.routing_table.index(shard.index).shard(shard.shard_id)
        copies = group.size()
        for attr in attrs:
            values = {n.attr(attr) for n in ctx.state.nodes.data_nodes() if n.attr(attr)}
            if not values:
                continue
            per_zone_cap = -(-copies // len(values))  # ceil
            my_zone = node.attr(attr)
            in_zone = sum(
                1 for s in group.assigned_shards()
                if s.node_id != shard.node_id
                and (n := ctx.state.nodes.get(s.node_id)) is not None
                and n.attr(attr) == my_zone
            )
            if in_zone >= per_zone_cap:
                return NO
        return YES


class ThrottlingDecider(Decider):
    name = "throttling"

    def can_allocate(self, shard, node_id, ctx):
        limit = ctx.settings.get_int(
            "cluster.routing.allocation.node_concurrent_recoveries", 2)
        initializing = sum(
            1 for s in ctx.shards_on_node(node_id) if s.state == INITIALIZING
        )
        return THROTTLE if initializing >= limit else YES


class DiskThresholdDecider(Decider):
    name = "disk_threshold"

    def can_allocate(self, shard, node_id, ctx):
        if not ctx.settings.get_bool("cluster.routing.allocation.disk.threshold_enabled", True):
            return YES
        usage = ctx.disk_usages.get(node_id)
        if usage is None:
            return YES
        high = ctx.settings.get_float("cluster.routing.allocation.disk.watermark.high", 0.90)
        return NO if usage >= high else YES


class ShardsLimitDecider(Decider):
    """A per-index cap on its shards on one node
    (index.routing.allocation.total_shards_per_node, -1 = unlimited)."""

    name = "shards_limit"

    def can_allocate(self, shard, node_id, ctx):
        limit = ctx.index_settings(shard.index).get_int(
            "index.routing.allocation.total_shards_per_node", -1)
        if limit is None or limit <= 0:
            return YES
        on_node = sum(1 for s in ctx.shards_on_node(node_id)
                      if s.index == shard.index)
        return NO if on_node >= limit else YES


class SnapshotInProgressDecider(Decider):
    """A shard whose index is being snapshotted must not move (the snapshot
    streams the primary's store)."""

    name = "snapshot_in_progress"

    def can_rebalance(self, shard, ctx):
        return NO if shard.index in ctx.snapshotting else YES

    def can_allocate(self, shard, node_id, ctx):
        # new UNASSIGNED copies are fine (they recover from the primary without
        # moving it); only the relocation of an existing copy is gated, which
        # can_rebalance already covers
        return YES


class NodeVersionDecider(Decider):
    """A replica never lands on a node older than its primary's (segments
    only stream forward)."""

    name = "node_version"

    def can_allocate(self, shard, node_id, ctx):
        target = ctx.state.nodes.get(node_id)
        if target is None:
            return NO
        if shard.primary:
            return YES
        group = ctx.state.routing_table.index(shard.index).shard(shard.shard_id)
        p = group.primary
        if p is None or not p.assigned:
            return YES
        pnode = ctx.state.nodes.get(p.node_id)
        if pnode is None:
            return YES
        return NO if target.version_id < pnode.version_id else YES


class ClusterRebalanceDecider(Decider):
    """cluster.routing.allocation.allow_rebalance:
      always | indices_primaries_active | indices_all_active (default)."""

    name = "cluster_rebalance"

    def can_rebalance(self, shard, ctx):
        mode = ctx.settings.get_str(
            "cluster.routing.allocation.allow_rebalance", "indices_all_active")
        if mode == "always":
            return YES
        shards = list(ctx.state.routing_table.all_shards())
        if mode == "indices_primaries_active":
            ok = all(s.active for s in shards if s.primary)
        else:  # indices_all_active
            ok = all(s.active for s in shards)
        return YES if ok else NO


class ConcurrentRebalanceDecider(Decider):
    """cluster.routing.allocation.cluster_concurrent_rebalance (default 2)
    bounds in-flight relocations cluster-wide."""

    name = "concurrent_rebalance"

    def can_rebalance(self, shard, ctx):
        limit = ctx.settings.get_int(
            "cluster.routing.allocation.cluster_concurrent_rebalance", 2)
        if limit is None or limit < 0:
            return YES
        relocating = sum(1 for s in ctx.state.routing_table.all_shards()
                         if s.state == RELOCATING)
        return THROTTLE if relocating >= limit else YES


DEFAULT_DECIDERS = (
    SameShardDecider(),
    ReplicaAfterPrimaryDecider(),
    EnableDecider(),
    FilterDecider(),
    AwarenessDecider(),
    ThrottlingDecider(),
    DiskThresholdDecider(),
    ShardsLimitDecider(),
    SnapshotInProgressDecider(),
    NodeVersionDecider(),
    ClusterRebalanceDecider(),
    ConcurrentRebalanceDecider(),
)


class AllocationContext:
    def __init__(self, state: ClusterState, settings: Settings,
                 disk_usages: dict | None = None,
                 snapshotting: set | None = None):
        self.state = state
        self.settings = settings
        self.disk_usages = disk_usages or {}
        self.snapshotting = snapshotting or set()  # index names being snapshotted
        self._by_node: dict[str, list[ShardRouting]] = {}
        for s in state.routing_table.all_shards():
            if s.node_id:
                self._by_node.setdefault(s.node_id, []).append(s)

    def shards_on_node(self, node_id: str) -> list[ShardRouting]:
        return self._by_node.get(node_id, [])

    def index_settings(self, index: str) -> Settings:
        meta = self.state.metadata.index(index)
        return meta.settings if meta else Settings.EMPTY

    def replace_shard(self, old: ShardRouting, new: ShardRouting):
        if old.node_id:
            lst = self._by_node.get(old.node_id, [])
            if old in lst:
                lst.remove(old)
        if new.node_id:
            self._by_node.setdefault(new.node_id, []).append(new)


class AllocationService:
    """reroute / apply_started_shards / apply_failed_shard / remove_node."""

    def __init__(self, settings: Settings | None = None, deciders=DEFAULT_DECIDERS):
        self.settings = settings or Settings.EMPTY
        self.deciders = deciders
        self.logger = get_logger("cluster.allocation")
        self.disk_usages: dict[str, float] = {}
        # index names with a snapshot in flight (read by
        # SnapshotInProgressDecider; the port has no snapshots yet, A9)
        self.snapshotting_indices: set[str] = set()

    # --- decider chain ------------------------------------------------------
    def _decide(self, shard: ShardRouting, node_id: str, ctx: AllocationContext) -> str:
        throttled = False
        for d in self.deciders:
            v = d.can_allocate(shard, node_id, ctx)
            if v == NO:
                return NO
            if v == THROTTLE:
                throttled = True
        return THROTTLE if throttled else YES

    def _decide_rebalance(self, shard: ShardRouting, ctx: AllocationContext) -> str:
        throttled = False
        for d in self.deciders:
            v = d.can_rebalance(shard, ctx)
            if v == NO:
                return NO
            if v == THROTTLE:
                throttled = True
        return THROTTLE if throttled else YES

    # --- weight --------------------------------------------------------------
    @staticmethod
    def _weight(ctx: AllocationContext, node_id: str, index: str) -> float:
        shards_on = len(ctx.shards_on_node(node_id))
        index_on = sum(1 for s in ctx.shards_on_node(node_id) if s.index == index)
        return 0.45 * shards_on + 0.55 * index_on

    # --- operations ---------------------------------------------------------
    def reroute(self, state: ClusterState) -> ClusterState:
        """Assign as many UNASSIGNED shards as the deciders allow (primaries
        first), then consider moving one started replica from the heaviest
        node to the lightest (gated by the can_rebalance chain)."""
        ctx = AllocationContext(state, self._merged_settings(state),
                                self.disk_usages, self.snapshotting_indices)
        data_nodes = [n.id for n in state.nodes.data_nodes()]
        if not data_nodes:
            return state
        new_tables: dict[str, list[list[ShardRouting]]] = {}
        changed = False
        for name, table in state.routing_table.indices:
            groups = []
            for grp in table.shards:
                shards = list(grp.shards)
                for order in (True, False):  # primaries first, then replicas
                    for i, s in enumerate(shards):
                        if s.state != UNASSIGNED or s.primary != order:
                            continue
                        candidates = [
                            nid for nid in data_nodes
                            if self._decide(s, nid, ctx) == YES
                        ]
                        if not candidates:
                            continue
                        best = min(candidates,
                                   key=lambda nid: (self._weight(ctx, nid, s.index), nid))
                        new = replace(s, node_id=best, state=INITIALIZING,
                                      unassigned_reason=None)
                        shards[i] = new
                        ctx.replace_shard(s, new)
                        changed = True
                groups.append(shards)
            new_tables[name] = groups
        changed = self._rebalance(ctx, data_nodes, new_tables) or changed
        if not changed:
            return state
        return self._rebuild(state, new_tables)

    def _rebalance(self, ctx: AllocationContext, data_nodes: list,
                   new_tables: dict) -> bool:
        """One relocation per reroute when the node weights are lopsided: the
        heaviest node's first movable STARTED replica relocates to the
        lightest node (source RELOCATING, a target INITIALIZING, each naming
        the other's node). Primaries stay put."""
        if len(data_nodes) < 2:
            return False
        threshold = ctx.settings.get_float(
            "cluster.routing.allocation.balance.threshold", 1.0)
        counts = {nid: len(ctx.shards_on_node(nid)) for nid in data_nodes}
        heavy = max(data_nodes, key=lambda n: (counts[n], n))
        light = min(data_nodes, key=lambda n: (counts[n], n))
        if counts[heavy] - counts[light] <= max(threshold, 1.0):
            return False
        for name, groups in new_tables.items():
            for shards in groups:
                for i, s in enumerate(shards):
                    if (s.state != STARTED or s.primary or s.node_id != heavy
                            or s.relocating_node is not None):
                        continue
                    if self._decide_rebalance(s, ctx) != YES:
                        continue
                    if self._decide(s, light, ctx) != YES:
                        continue
                    shards[i] = replace(s, state=RELOCATING,
                                        relocating_node=light)
                    target = replace(s, node_id=light, state=INITIALIZING,
                                     relocating_node=heavy)
                    shards.append(target)
                    ctx.replace_shard(s, shards[i])
                    ctx._by_node.setdefault(light, []).append(target)
                    return True
        return False

    def apply_started_shards(self, state: ClusterState,
                             started: list[ShardRouting]) -> ClusterState:
        keys = {(s.index, s.shard_id, s.node_id) for s in started}
        new_tables = {}
        changed = False
        for name, table in state.routing_table.indices:
            groups = []
            for grp in table.shards:
                shards = []
                drop_relocation_sources = set()  # node ids whose handoff completed
                for s in grp.shards:
                    if s.state == INITIALIZING and (s.index, s.shard_id, s.node_id) in keys:
                        if s.relocating_node is not None:
                            # a relocation target caught up: it takes over
                            # and the RELOCATING source retires
                            drop_relocation_sources.add(s.relocating_node)
                        shards.append(replace(s, state=STARTED,
                                              relocating_node=None))
                        changed = True
                    else:
                        shards.append(s)
                if drop_relocation_sources:
                    shards = [s for s in shards
                              if not (s.state == RELOCATING
                                      and s.node_id in drop_relocation_sources)]
                groups.append(shards)
            new_tables[name] = groups
        if not changed:
            return state
        return self.reroute(self._rebuild(state, new_tables))

    def apply_failed_shard(self, state: ClusterState, failed: ShardRouting) -> ClusterState:
        """Remove the failed copy; promote an active replica when a primary
        dies; schedule a fresh UNASSIGNED copy. Relocation pairs unwind: a
        failed target reverts its source to STARTED; a failed source also
        drops its half-recovered target."""
        new_tables = {}
        for name, table in state.routing_table.indices:
            groups = []
            for grp in table.shards:
                shards = list(grp.shards)
                hit = next((s for s in shards
                            if (s.index, s.shard_id, s.node_id)
                            == (failed.index, failed.shard_id, failed.node_id)), None)
                if (hit is not None and hit.state == INITIALIZING
                        and hit.relocating_node is not None):
                    # failed relocation target: revert the source, drop the target
                    shards = [
                        (replace(s, state=STARTED, relocating_node=None)
                         if s.state == RELOCATING and s.node_id == hit.relocating_node
                         else s)
                        for s in shards if s is not hit
                    ]
                    groups.append(shards)
                    continue
                if (hit is not None and hit.state == RELOCATING
                        and hit.relocating_node is not None):
                    # failed relocation source: its half-recovered target dies too
                    shards = [s for s in shards
                              if not (s.state == INITIALIZING
                                      and s.node_id == hit.relocating_node)]
                for i, s in enumerate(shards):
                    if (s.index, s.shard_id, s.node_id) == \
                            (failed.index, failed.shard_id, failed.node_id):
                        was_primary = s.primary
                        shards[i] = replace(s, node_id=None, state=UNASSIGNED,
                                            primary=False, unassigned_reason="failed")
                        if was_primary:
                            promoted = False
                            for j, r in enumerate(shards):
                                if j != i and r.active and not r.primary:
                                    shards[j] = replace(r, primary=True)
                                    promoted = True
                                    break
                            if not promoted:
                                # no live replica: the unassigned copy becomes the primary
                                shards[i] = replace(shards[i], primary=True)
                groups.append(shards)
            new_tables[name] = groups
        return self.reroute(self._rebuild(state, new_tables))

    def remove_node(self, state: ClusterState, node_id: str) -> ClusterState:
        """A node left or died: every copy on it fails."""
        for s in list(state.routing_table.all_shards()):
            if s.node_id == node_id:
                state = self.apply_failed_shard(state, s)
        return state

    # --- helpers ------------------------------------------------------------
    def _merged_settings(self, state: ClusterState) -> Settings:
        return self.settings.merged(
            Settings.from_flat(dict(state.metadata.persistent_settings))
        ).merged(Settings.from_flat(dict(state.metadata.transient_settings)))

    @staticmethod
    def _rebuild(state: ClusterState, new_tables: dict) -> ClusterState:
        rt = state.routing_table
        for name, groups in new_tables.items():
            rt = rt.with_index(IndexRoutingTable(
                name, tuple(IndexShardRoutingTable(tuple(g)) for g in groups)))
        return state.next_version(routing_table=rt)


def new_index_routing(index: str, num_shards: int, num_replicas: int) -> IndexRoutingTable:
    groups = []
    for sid in range(num_shards):
        shards = [ShardRouting(index, sid, None, True, UNASSIGNED,
                               unassigned_reason="index_created")]
        for _ in range(num_replicas):
            shards.append(ShardRouting(index, sid, None, False, UNASSIGNED,
                                       unassigned_reason="index_created"))
        groups.append(IndexShardRoutingTable(tuple(shards)))
    return IndexRoutingTable(index, tuple(groups))
