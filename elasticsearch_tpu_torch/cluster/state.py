"""Immutable cluster state (a trimmed copy of the JAX package's
`cluster/state.py`): ClusterState = {version, MetaData, RoutingTable,
DiscoveryNodes, ClusterBlocks}. Every mutation produces a NEW state with
version+1.

Trimmed to what a one-node cluster reads: index metadata keeps settings,
mappings, aliases (each with its filter and routing), search warmers,
state (open or close) and version; the metadata keeps the index templates,
and `resolve_indices` resolves names, wildcards and aliases. Blocks are
global (no master, state not recovered) or per index (a closed index,
`index.blocks.*`). `to_dict` and `from_dict` round-trip the metadata the
gateway persists under `path.data/_state`."""

from __future__ import annotations

import fnmatch
import json
from dataclasses import dataclass, field as dc_field, replace

from ..common.errors import ClusterBlockError, IndexMissingError
from ..common.settings import Settings

UNASSIGNED, INITIALIZING, STARTED = "UNASSIGNED", "INITIALIZING", "STARTED"


@dataclass(frozen=True)
class DiscoveryNode:
    id: str
    name: str
    transport_address: str
    master_eligible: bool = True
    data: bool = True

    def to_dict(self) -> dict:
        return {"id": self.id, "name": self.name,
                "transport_address": self.transport_address,
                "master_eligible": self.master_eligible, "data": self.data}


@dataclass(frozen=True)
class DiscoveryNodes:
    nodes: tuple = ()  # tuple[DiscoveryNode]
    master_id: str | None = None
    local_id: str | None = None

    def get(self, node_id: str) -> DiscoveryNode | None:
        for n in self.nodes:
            if n.id == node_id:
                return n
        return None

    @property
    def master(self) -> DiscoveryNode | None:
        return self.get(self.master_id) if self.master_id else None

    @property
    def size(self) -> int:
        return len(self.nodes)

    def data_nodes(self) -> list[DiscoveryNode]:
        return [n for n in self.nodes if n.data]

    def with_node(self, node: DiscoveryNode) -> "DiscoveryNodes":
        others = tuple(n for n in self.nodes if n.id != node.id)
        return replace(self, nodes=tuple(sorted(others + (node,), key=lambda n: n.id)))

    def with_master(self, master_id: str | None) -> "DiscoveryNodes":
        return replace(self, master_id=master_id)


@dataclass(frozen=True)
class ShardRouting:
    index: str
    shard_id: int
    node_id: str | None
    primary: bool
    state: str = UNASSIGNED
    unassigned_reason: str | None = None

    @property
    def active(self) -> bool:
        return self.state == STARTED

    @property
    def assigned(self) -> bool:
        return self.node_id is not None

    def shard_key(self) -> tuple:
        return (self.index, self.shard_id)

    def to_dict(self) -> dict:
        return {"index": self.index, "shard": self.shard_id, "node": self.node_id,
                "primary": self.primary, "state": self.state}

    @classmethod
    def from_dict(cls, d: dict) -> "ShardRouting":
        return cls(d["index"], d["shard"], d.get("node"), d["primary"],
                   d.get("state", UNASSIGNED))


@dataclass(frozen=True)
class IndexShardRoutingTable:
    """One replication group: the primary and its replicas for one shard id."""

    shards: tuple = ()  # tuple[ShardRouting]

    @property
    def primary(self) -> ShardRouting | None:
        for s in self.shards:
            if s.primary:
                return s
        return None

    def active_shards(self) -> list[ShardRouting]:
        return [s for s in self.shards if s.active]

    def size(self) -> int:
        return len(self.shards)


@dataclass(frozen=True)
class IndexRoutingTable:
    index: str
    shards: tuple = ()  # tuple[IndexShardRoutingTable], position = shard id

    def shard(self, shard_id: int) -> IndexShardRoutingTable:
        return self.shards[shard_id]

    def all_shards(self) -> list[ShardRouting]:
        return [s for grp in self.shards for s in grp.shards]

    def primaries_active(self) -> bool:
        return all(grp.primary is not None and grp.primary.active
                   for grp in self.shards)


@dataclass(frozen=True)
class RoutingTable:
    indices: tuple = ()  # tuple[(name, IndexRoutingTable)]

    def index(self, name: str) -> IndexRoutingTable | None:
        for n, t in self.indices:
            if n == name:
                return t
        return None

    def all_shards(self) -> list[ShardRouting]:
        return [s for _, t in self.indices for s in t.all_shards()]

    def with_index(self, table: IndexRoutingTable) -> "RoutingTable":
        others = tuple((n, t) for n, t in self.indices if n != table.index)
        return RoutingTable(tuple(sorted(others + ((table.index, table),))))

    def without_index(self, name: str) -> "RoutingTable":
        return RoutingTable(tuple((n, t) for n, t in self.indices if n != name))


@dataclass(frozen=True)
class IndexMetaData:
    """Settings, mappings, aliases, warmers and the open/close state of one
    index; number_of_shards is immutable after creation (documents are
    routed by it)."""

    name: str
    settings_map: tuple = ()
    mappings: tuple = ()  # ((type, mapping_dict_json), ...)
    aliases: tuple = ()  # ((alias, {filter, index_routing, search_routing}), ...)
    warmers: tuple = ()  # ((name, {types, source} as json), ...)
    state: str = "open"
    version: int = 1

    @property
    def settings(self) -> Settings:
        return Settings.from_flat(dict(self.settings_map))

    @property
    def number_of_shards(self) -> int:
        return int(dict(self.settings_map).get("index.number_of_shards", 5))

    @property
    def number_of_replicas(self) -> int:
        return int(dict(self.settings_map).get("index.number_of_replicas", 1))

    def mapping(self, type_name: str) -> dict | None:
        for t, m in self.mappings:
            if t == type_name:
                return json.loads(m)
        return None

    def mappings_dict(self) -> dict:
        out = {}
        for t, m in self.mappings:
            d = json.loads(m)
            d.setdefault("properties", {})  # always present in the REST view
            out[t] = d
        return out

    def with_mapping(self, type_name: str, mapping: dict) -> "IndexMetaData":
        others = tuple((t, m) for t, m in self.mappings if t != type_name)
        return replace(self, mappings=others + ((type_name, json.dumps(mapping)),),
                       version=self.version + 1)

    def without_mapping(self, type_name: str) -> "IndexMetaData":
        others = tuple((t, m) for t, m in self.mappings if t != type_name)
        return replace(self, mappings=others, version=self.version + 1)

    def with_settings(self, settings: dict) -> "IndexMetaData":
        merged = dict(self.settings_map)
        merged.update(settings)
        return replace(self, settings_map=tuple(sorted(merged.items())),
                       version=self.version + 1)

    def with_aliases(self, aliases: dict) -> "IndexMetaData":
        return replace(self, aliases=tuple(sorted(aliases.items(), key=lambda kv: kv[0])),
                       version=self.version + 1)

    def aliases_dict(self) -> dict:
        return dict(self.aliases)

    def with_warmer(self, name: str, body: dict | None) -> "IndexMetaData":
        """Add or replace a warmer; None removes it."""
        others = tuple((n, b) for n, b in self.warmers if n != name)
        if body is not None:
            others = others + ((name, json.dumps(body)),)
        return replace(self, warmers=others, version=self.version + 1)

    def warmers_dict(self) -> dict:
        return {n: json.loads(b) for n, b in self.warmers}

    def to_dict(self) -> dict:
        return {"name": self.name, "settings": dict(self.settings_map),
                "mappings": dict(self.mappings),
                "aliases": {k: dict(v) if isinstance(v, dict) else v
                            for k, v in self.aliases},
                "warmers": dict(self.warmers),
                "state": self.state, "version": self.version}

    @classmethod
    def from_dict(cls, d: dict) -> "IndexMetaData":
        return cls(d["name"], tuple(sorted(d.get("settings", {}).items())),
                   tuple(d.get("mappings", {}).items()),
                   tuple(sorted(d.get("aliases", {}).items())),
                   tuple(sorted(d.get("warmers", {}).items())),
                   d.get("state", "open"), d.get("version", 1))


@dataclass(frozen=True)
class IndexTemplateMetaData:
    """The settings, mappings and aliases an index whose name matches
    `template` is created with (lowest `order` applied first)."""

    name: str
    template: str  # a pattern such as "logs-*"
    order: int = 0
    settings_map: tuple = ()
    mappings: tuple = ()  # ((type, mapping_dict_json), ...)
    aliases: tuple = ()

    def to_dict(self) -> dict:
        return {"name": self.name, "template": self.template, "order": self.order,
                "settings": {k: (str(v).lower() if isinstance(v, bool) else str(v))
                             for k, v in self.settings_map},
                "mappings": dict(self.mappings),
                "aliases": dict(self.aliases)}

    @classmethod
    def from_dict(cls, d: dict) -> "IndexTemplateMetaData":
        return cls(d["name"], d["template"], d.get("order", 0),
                   tuple(sorted(d.get("settings", {}).items())),
                   tuple(d.get("mappings", {}).items()),
                   tuple(sorted(d.get("aliases", {}).items())))


@dataclass(frozen=True)
class MetaData:
    indices: tuple = ()  # ((name, IndexMetaData), ...)
    templates: tuple = ()  # ((name, IndexTemplateMetaData), ...)
    version: int = 0

    def index(self, name: str) -> IndexMetaData | None:
        for n, m in self.indices:
            if n == name:
                return m
        return None

    def require_index(self, name: str) -> IndexMetaData:
        m = self.index(name)
        if m is None:
            raise IndexMissingError(name)
        return m

    def index_names(self) -> list[str]:
        return [n for n, _ in self.indices]

    def has_index(self, name: str) -> bool:
        return any(n == name for n, _ in self.indices)

    def resolve_indices(self, expr) -> list[str]:
        """Names, wildcards and aliases → concrete index names; a missing
        name that is not a wildcard raises IndexMissingError. An alias
        expression matches by name or as a wildcard over alias names."""
        if expr in (None, "_all", "*", ""):
            return self.index_names()
        names = expr if isinstance(expr, list) else [p.strip() for p in str(expr).split(",")]
        out: list[str] = []
        for name in names:
            if self.has_index(name):
                out.append(name)
                continue
            matched = [n for n in self.index_names() if fnmatch.fnmatch(n, name)]
            for n, m in self.indices:
                if any(a == name or fnmatch.fnmatch(a, name) for a, _ in m.aliases):
                    matched.append(n)
            if not matched and "*" not in name:
                raise IndexMissingError(name)
            out.extend(matched)
        seen = set()
        return [n for n in out if not (n in seen or seen.add(n))]

    def alias_filter(self, index: str, expr) -> dict | None:
        """The filter of the first filtered alias of `index` that `expr`
        names exactly (a wildcard over aliases applies no filter)."""
        m = self.index(index)
        if m is None or expr is None:
            return None
        names = expr if isinstance(expr, list) else [p.strip() for p in str(expr).split(",")]
        for alias, spec in m.aliases:
            if alias in names and isinstance(spec, dict) and spec.get("filter"):
                return spec["filter"]
        return None

    def templates_for(self, index_name: str) -> list[IndexTemplateMetaData]:
        out = [t for _, t in self.templates if fnmatch.fnmatch(index_name, t.template)]
        out.sort(key=lambda t: t.order)
        return out

    def with_index(self, meta: IndexMetaData) -> "MetaData":
        others = tuple((n, m) for n, m in self.indices if n != meta.name)
        return replace(self, indices=tuple(sorted(others + ((meta.name, meta),))),
                       version=self.version + 1)

    def without_index(self, name: str) -> "MetaData":
        return replace(self, indices=tuple((n, m) for n, m in self.indices if n != name),
                       version=self.version + 1)

    def with_template(self, t: IndexTemplateMetaData) -> "MetaData":
        others = tuple((n, m) for n, m in self.templates if n != t.name)
        return replace(self, templates=tuple(sorted(others + ((t.name, t),))),
                       version=self.version + 1)

    def without_template(self, name: str) -> "MetaData":
        return replace(self, templates=tuple((n, t) for n, t in self.templates
                                             if n != name),
                       version=self.version + 1)

    def to_dict(self) -> dict:
        return {"indices": {n: m.to_dict() for n, m in self.indices},
                "templates": {n: t.to_dict() for n, t in self.templates},
                "version": self.version}

    @classmethod
    def from_dict(cls, d: dict) -> "MetaData":
        """The inverse of `to_dict`; a file the JAX package wrote loads too
        (its cluster settings are not read: the port has none yet)."""
        return cls(tuple(sorted((n, IndexMetaData.from_dict(m))
                                for n, m in d.get("indices", {}).items())),
                   tuple(sorted((n, IndexTemplateMetaData.from_dict(t))
                                for n, t in d.get("templates", {}).items())),
                   d.get("version", 0))


BLOCK_NO_MASTER = ("no_master", "all")
BLOCK_STATE_NOT_RECOVERED = ("state_not_recovered", "all")
BLOCK_INDEX_CLOSED = ("index_closed", "all")


@dataclass(frozen=True)
class ClusterBlocks:
    global_blocks: tuple = ()  # ((id, level), ...)
    index_blocks: tuple = ()  # ((index, (id, level)), ...)

    def blocked(self, level: str, index: str | None = None) -> list:
        out = [b for b in self.global_blocks if b[1] in ("all", level)]
        if index:
            out += [b for i, b in self.index_blocks
                    if i == index and b[1] in ("all", level)]
        return out

    def check(self, level: str, index: str | None = None):
        """Raise ClusterBlockError when a global block, or a block of
        `index`, covers `level` ("read", "write", "metadata")."""
        blocks = self.blocked(level, index)
        if blocks:
            raise ClusterBlockError(blocks)

    def without_global(self, block) -> "ClusterBlocks":
        return replace(self, global_blocks=tuple(
            b for b in self.global_blocks if b != block))

    def with_index_block(self, index: str, block) -> "ClusterBlocks":
        entry = (index, block)
        if entry in self.index_blocks:
            return self
        return replace(self, index_blocks=self.index_blocks + (entry,))

    def without_index_block(self, index: str, block) -> "ClusterBlocks":
        return replace(self, index_blocks=tuple(
            e for e in self.index_blocks if e != (index, block)))

    def without_index(self, index: str) -> "ClusterBlocks":
        return replace(self, index_blocks=tuple(
            e for e in self.index_blocks if e[0] != index))


@dataclass(frozen=True)
class ClusterState:
    cluster_name: str = "elasticsearch-tpu"
    version: int = 0
    nodes: DiscoveryNodes = dc_field(default_factory=DiscoveryNodes)
    metadata: MetaData = dc_field(default_factory=MetaData)
    routing_table: RoutingTable = dc_field(default_factory=RoutingTable)
    # a fresh node holds no master and has not recovered its state: reads
    # and writes answer 503 until discovery and the gateway lift both
    blocks: ClusterBlocks = dc_field(default_factory=lambda: ClusterBlocks(
        (BLOCK_NO_MASTER, BLOCK_STATE_NOT_RECOVERED)))

    def next_version(self, **changes) -> "ClusterState":
        return replace(self, version=self.version + 1, **changes)
