"""Per-shard engine: versioned writes, NRT searcher views and durability (a
trimmed copy of the JAX package's `index/engine.py`: `Searcher` and
`Engine`).

- writes: `index` (internal / external versions, `create` conflicts, a
  `timestamp` and a `ttl`), `delete` and `delete_by_uids` (the tombstones
  of a delete-by-query or a TTL purge, logged as one op with its uids) go
  to the translog first, then to the in-memory buffer; a realtime `get`
  is served from the version map before a refresh, with the document's
  timestamp and its remaining TTL (`_remaining_ttl`, read on the wall
  clock);
- views: `refresh` freezes the buffer into a new segment and applies
  tombstones copy-on-write (`FrozenSegment.with_deletes`), so a searcher
  acquired earlier keeps its point-in-time view;
- durability: `flush` persists the segments and a commit point and rolls the
  translog; `recover_from_store` loads the last commit and replays the
  translog after it;
- merges: `maybe_merge` runs the tiered policy (the merge itself outside the
  engine lock; a tombstone queued on a source meanwhile moves to the merged
  segment, where the JAX engine drops it and keeps the old copy live),
  `optimize` force-merges;
- device packs: a refreshed segment carries a pack hint (`delta_pack`
  beside older segments, `pack` on an empty shard), a merged one a
  `compact` hint naming its sources when every source has a resident pack
  (ops/device_index.pack_segment_concat reads them); the warmer schedules
  the packs from the view listeners once `search_active` is set;
- peer recovery, primary side: a recovery hold (`acquire_recovery_hold`,
  kept alive by `touch_recovery_hold`, a TTL bounding a dead target's
  leak) stops a flush from pruning translog generations and defers the
  deletion of merged-away segment files until the last hold drops, since
  the target pulls those files outside the engine lock;
  `translog_ops_since` reads the op tail under the engine lock (phase 3);
- replica side: `apply_replicated_op` applies an op a primary streamed
  (a replica write, recovery phases 2 and 3) with its external version, so
  the copies converge on the primary's versions; a delete is applied
  without a version check (the JAX engine's behaviour, kept)."""

from __future__ import annotations

import itertools
import os
import threading
import time
import uuid
from dataclasses import dataclass

import numpy as np

from ..common.logging import get_logger
from ..common.errors import (
    DocumentAlreadyExistsError,
    EngineClosedError,
    VersionConflictError,
)
from .merge_policy import TieredMergePolicy
from .segment import FieldStats, FrozenSegment, SegmentBuilder, merge_segments
from .store import Store
from .translog import CREATE, DELETE, DELETE_BY_QUERY, INDEX, Translog, TranslogOp

logger = get_logger("index.engine")

INTERNAL, EXTERNAL = "internal", "external"

# view versions, unique in the process: every searcher any engine installs
# takes the next, so a recreated or reopened index's views never share a
# version (and a request-cache key) with the engine it replaced
_VIEW_VERSIONS = itertools.count()


class Searcher:
    """Point-in-time view over frozen segments. Global doc = segment base +
    local id, bases assigned in segment order."""

    def __init__(self, segments: list[FrozenSegment], version: int = 0):
        self.segments = segments
        self.version = version
        self.bases: list[int] = []
        base = 0
        for seg in segments:
            self.bases.append(base)
            base += seg.doc_count
        self.max_doc = base

    def doc_freq(self, field: str, term: str) -> int:
        return sum(seg.doc_freq(field, term) for seg in self.segments)

    def field_stats(self, field: str) -> FieldStats:
        out = FieldStats()
        for seg in self.segments:
            s = seg.field_stats.get(field)
            if s:
                out = out.merged(s)
        return out

    def resolve(self, global_doc: int) -> tuple[FrozenSegment, int]:
        for i in range(len(self.segments) - 1, -1, -1):
            if global_doc >= self.bases[i]:
                return self.segments[i], global_doc - self.bases[i]
        raise IndexError(global_doc)


@dataclass
class VersionEntry:
    version: int
    deleted: bool = False
    # location of the latest copy: ("buffer", local) before refresh
    location: tuple | None = None
    # retained source for the realtime get of unrefreshed docs
    source: dict | None = None
    routing: str | None = None
    parent: str | None = None
    timestamp: int | None = None
    ttl: int | None = None


@dataclass
class GetResult:
    found: bool
    id: str = ""
    type: str = ""
    version: int = 0
    source: dict | None = None
    routing: str | None = None
    parent: str | None = None
    timestamp: int | None = None
    ttl: int | None = None  # milliseconds left at read time


def _resident(seg: FrozenSegment) -> bool:
    """Whether the segment holds a pack for some device (its
    `("packed", device)` keys)."""
    return any(isinstance(k, tuple) and k[0] == "packed" for k in seg._device_cache)


def _merged_locals(sources: list[FrozenSegment]) -> dict[tuple[int, int], int]:
    """(source gen, parent local) -> the parent's local in the segment
    `merge_segments(sources)` builds: live blocks in order, each a run of
    children and then its parent."""
    out, merged = {}, 0
    for seg in sources:
        local = 0
        while local < seg.doc_count:
            block_start = local
            while local < seg.doc_count and not seg.parent_mask[local]:
                local += 1
            if local >= seg.doc_count:
                break
            parent = local
            local += 1
            if seg.live[parent]:
                merged += parent - block_start
                out[(seg.gen, parent)] = merged
                merged += 1
    return out


class Engine:
    def __init__(self, path: str, mapper_service, settings=None):
        self.path = path
        self.mapper_service = mapper_service
        self.store = Store(os.path.join(path, "index"))
        self.translog = Translog(os.path.join(path, "translog"))
        self._lock = threading.RLock()
        self._segments: list[FrozenSegment] = []
        self._segment_files: dict[str, dict] = {}  # str(gen) -> file metadata
        self._persisted_gens: set[int] = set()
        self._next_gen = 1
        self._commit_id = 0
        self._buffer = SegmentBuilder(self._next_gen)
        self._version_map: dict[str, VersionEntry] = {}
        self._uid_index: dict[str, tuple[int, int]] = {}  # uid -> (gen, local)
        self._pending_deletes: list[tuple] = []  # locations to tombstone at refresh
        self._recovery_holds: dict[str, float] = {}  # hold id -> expiry (wall clock)
        self._deferred_segment_deletes: list[int] = []  # gens pinned by holds
        self._closed = False
        self._last_write = 0.0  # wall clock of the last index or delete
        self.merge_policy = TieredMergePolicy(settings)
        # one merge computes at a time, outside _lock (non-blocking acquire)
        self._merge_mutex = threading.Lock()
        self._searcher = Searcher([], version=next(_VIEW_VERSIONS))
        # callables (new searcher, segments the old view held that the new
        # one does not) run on every view install, under _lock: they must
        # be leaves (dict, counter and breaker work only)
        self.view_listeners: list = []
        # set by the shard query phase: the warmer packs a view's segments
        # off the query path only for a shard that has served a search (a
        # write-only shard's refreshes stay off the device)
        self.search_active = False
        # the shard's indexing counters (`_stats`' `indexing`, as the JAX
        # engine keeps them)
        self.stats = {
            "index_total": 0, "index_time_ms": 0.0, "delete_total": 0,
            "refresh_total": 0, "refresh_time_ms": 0.0,
            "flush_total": 0, "flush_time_ms": 0.0, "merge_total": 0,
        }

    # ------------------------------------------------------------------ util
    def _check_open(self):
        if self._closed:
            raise EngineClosedError("engine is closed")

    @property
    def closed(self) -> bool:
        return self._closed

    def _current_version(self, uid: str) -> tuple[int | None, bool]:
        """(version, deleted) of the latest copy, or (None, False)."""
        entry = self._version_map.get(uid)
        if entry is not None:
            return entry.version, entry.deleted
        loc = self._uid_index.get(uid)
        if loc is not None:
            seg = self._seg_by_gen(loc[0])
            if seg is not None and seg.live[loc[1]]:
                return int(seg.versions[loc[1]]), False
        return None, False

    def _seg_by_gen(self, gen: int) -> FrozenSegment | None:
        for seg in self._segments:
            if seg.gen == gen:
                return seg
        return None

    def _check_version(self, uid: str, version, version_type: str) -> int:
        """Version precheck; returns the version the new op will carry."""
        current, deleted = self._current_version(uid)
        effective = None if (current is None or deleted) else current
        if version_type == EXTERNAL:
            if version is None:
                raise VersionConflictError(uid, effective or 0, -1)
            if effective is not None and version <= effective:
                raise VersionConflictError(uid, effective, version)
            return int(version)
        if version is not None and version != 0:
            if effective is None or effective != version:
                raise VersionConflictError(uid, effective or 0, version)
        return (effective or 0) + 1

    def _tombstone_latest(self, uid: str):
        """Queue the latest searchable-or-buffered copy of `uid` for a
        tombstone at the next refresh."""
        entry = self._version_map.get(uid)
        if entry is not None and entry.location is not None and not entry.deleted:
            self._pending_deletes.append(entry.location)
        elif entry is None:
            loc = self._uid_index.get(uid)
            if loc is not None:
                self._pending_deletes.append(loc)

    # ------------------------------------------------------------------ ops
    def index(self, type_name: str, doc_id: str, source: dict,
              routing: str | None = None, version=None,
              version_type: str = INTERNAL, op_type: str = "index",
              parent: str | None = None, timestamp=None, ttl=None,
              _from_translog: bool = False) -> tuple[int, bool]:
        """Index or create a document (a child of `parent` when given).
        Returns (new_version, created)."""
        t0 = time.monotonic()
        with self._lock:
            self._check_open()
            mapper = self.mapper_service.mapper_for(type_name)
            uid = f"{type_name}#{doc_id}"
            current, deleted = self._current_version(uid)
            created = current is None or deleted
            if op_type == "create" and not created:
                raise DocumentAlreadyExistsError(f"[{type_name}][{doc_id}] already exists")
            new_version = self._check_version(uid, version, version_type)
            parsed = mapper.parse(source, doc_id, routing=routing, timestamp=timestamp,
                                  ttl=ttl, parent=parent)
            if not _from_translog:
                self.translog.add(TranslogOp(
                    CREATE if op_type == "create" else INDEX, type_name, doc_id,
                    source, routing=routing, version=new_version, parent=parent,
                    timestamp=timestamp, ttl=ttl))
            self._tombstone_latest(uid)
            local = self._buffer.add(parsed, version=new_version)
            self._last_write = time.time()
            self._version_map[uid] = VersionEntry(
                version=new_version, location=("buffer", local), source=source,
                routing=parsed.routing, parent=parsed.parent,
                timestamp=parsed.timestamp, ttl=parsed.ttl)
            self.stats["index_total"] += 1
            self.stats["index_time_ms"] += (time.monotonic() - t0) * 1000
            return new_version, created

    def delete(self, type_name: str, doc_id: str, version=None,
               version_type: str = INTERNAL,
               _from_translog: bool = False) -> tuple[int, bool]:
        """Delete by id. Returns (version, found)."""
        with self._lock:
            self._check_open()
            uid = f"{type_name}#{doc_id}"
            current, already_deleted = self._current_version(uid)
            found = current is not None and not already_deleted
            new_version = self._check_version(uid, version, version_type)
            if not _from_translog:
                self.translog.add(TranslogOp(DELETE, type_name, doc_id,
                                             version=new_version))
            self._tombstone_latest(uid)
            self._version_map[uid] = VersionEntry(version=new_version, deleted=True)
            self._last_write = time.time()
            self.stats["delete_total"] += 1
            return new_version, found

    def delete_by_uids(self, uids: list[str], query: dict | None = None,
                       _from_translog: bool = False):
        """Tombstone every live document of `uids` (`type#id`), the matches a
        delete-by-query or a TTL purge resolved; logged as one op with the
        uids, so a replay runs no query. Each tombstone bumps the version."""
        with self._lock:
            self._check_open()
            if not _from_translog:
                self.translog.add(TranslogOp(DELETE_BY_QUERY, query=query,
                                             source={"uids": list(uids)}))
            for uid in uids:
                current, deleted = self._current_version(uid)
                if current is None or deleted:
                    continue
                self._tombstone_latest(uid)
                self._version_map[uid] = VersionEntry(version=current + 1, deleted=True)

    def get(self, type_name: str, doc_id: str, realtime: bool = True) -> GetResult:
        """Realtime get: the version map first, then the segments."""
        with self._lock:
            self._check_open()
            uid = f"{type_name}#{doc_id}"
            entry = self._version_map.get(uid)
            if entry is not None:
                if entry.deleted:
                    return GetResult(found=False)
                if realtime and entry.source is not None:
                    return GetResult(True, doc_id, type_name, entry.version,
                                     entry.source, entry.routing, entry.parent,
                                     entry.timestamp,
                                     self._remaining_ttl(entry.timestamp, entry.ttl))
            loc = self._uid_index.get(uid)
            if loc is None:
                return GetResult(found=False)
            seg = self._seg_by_gen(loc[0])
            if seg is None or not seg.live[loc[1]]:
                return GetResult(found=False)
            local = loc[1]
            parent_vals = seg.str_values("_parent", local)
            ts_vals = seg.num_values("_timestamp", local)
            exp_vals = seg.num_values("_expiry", local)
            ts = int(ts_vals[0]) if len(ts_vals) else None
            ttl = None
            if len(exp_vals):
                base = ts if ts is not None else 0
                ttl = self._remaining_ttl(base, int(exp_vals[0]) - base)
            return GetResult(True, doc_id, type_name, int(seg.versions[local]),
                             seg.stored[local], seg.routings[local],
                             parent_vals[0] if parent_vals else None, ts, ttl)

    @staticmethod
    def _remaining_ttl(timestamp, ttl):
        """A stored TTL as the milliseconds left now, strictly below the
        stored value (time has passed since the write even when the clock's
        millisecond has not ticked)."""
        if ttl is None:
            return None
        base = timestamp if timestamp is not None else int(time.time() * 1000)
        return max(0, (base + ttl) - int(time.time() * 1000) - 1)

    def _install_searcher(self) -> Searcher:
        """A new point-in-time view over the current segment list (caller
        holds _lock); the view listeners get the segment objects the old
        view held that the new one does not (an identity diff: a tombstone
        view is a new object, a merge drops its sources)."""
        old = self._searcher
        self._searcher = Searcher(list(self._segments), version=next(_VIEW_VERSIONS))
        if self.view_listeners:
            current = {id(s) for s in self._searcher.segments}
            dropped = [s for s in old.segments if id(s) not in current]
            for listener in list(self.view_listeners):
                try:
                    listener(self._searcher, dropped)
                except Exception:  # noqa: BLE001 — a cache's eviction must
                    # never fail the refresh or merge that triggered it
                    logger.warning("view listener failed", exc_info=True)
        return self._searcher

    def _index_uids(self, seg: FrozenSegment):
        for local in range(seg.doc_count):
            if seg.parent_mask[local] and seg.live[local]:
                self._uid_index[f"{seg.types[local]}#{seg.ids[local]}"] = (seg.gen, local)

    # ------------------------------------------------------------------ nrt
    def refresh(self) -> bool:
        """Make buffered ops searchable: freeze the buffer into a new segment
        and apply pending tombstones, copy-on-write on older segments."""
        t0 = time.monotonic()
        with self._lock:
            self._check_open()
            if self._buffer.doc_count == 0 and not self._pending_deletes:
                return False
            new_seg: FrozenSegment | None = None
            if self._buffer.doc_count > 0:
                new_seg = self._buffer.freeze()
                # a refresh's increment beside resident segments is a delta
                # pack: bounded by the buffer, not the index
                new_seg._device_cache["pack_hint"] = {
                    "kind": "delta_pack" if self._segments else "pack"}
                self._segments.append(new_seg)
                self._next_gen += 1
                self._buffer = SegmentBuilder(self._next_gen)
            by_gen: dict[int, list[int]] = {}
            for loc in self._pending_deletes:
                if loc[0] == "buffer":
                    new_seg.delete_doc(loc[1])
                else:
                    by_gen.setdefault(loc[0], []).append(loc[1])
            for gen, locals_ in by_gen.items():
                for i, seg in enumerate(self._segments):
                    if seg.gen == gen:
                        self._segments[i] = seg.with_deletes(locals_)
                        break
            self._pending_deletes.clear()
            if new_seg is not None:
                self._index_uids(new_seg)
            for uid, entry in list(self._version_map.items()):
                if entry.deleted:
                    self._uid_index.pop(uid, None)
                del self._version_map[uid]
            self._install_searcher()
            self.stats["refresh_total"] += 1
            self.stats["refresh_time_ms"] += (time.monotonic() - t0) * 1000
            return True

    def acquire_searcher(self) -> Searcher:
        with self._lock:
            self._check_open()
            return self._searcher

    def indexing_buffer_bytes(self) -> int:
        """The un-refreshed buffer's estimated RAM (the indexing-memory
        controller's input)."""
        return self._buffer.ram_bytes

    @property
    def last_write_time(self) -> float:
        return self._last_write

    # ------------------------------------------------------------------ durability
    def _commit(self, translog_gen: int, extra: dict | None = None):
        self._commit_id += 1
        self.store.write_commit(
            self._commit_id,
            {str(seg.gen): self._segment_files[str(seg.gen)] for seg in self._segments},
            translog_gen=translog_gen, extra=extra)

    def _persist_new_segments(self) -> bool:
        wrote = False
        for seg in self._segments:
            if seg.gen not in self._persisted_gens:
                self._segment_files[str(seg.gen)] = self.store.write_segment(seg)
                self._persisted_gens.add(seg.gen)
                wrote = True
        return wrote

    def flush(self, force: bool = False) -> bool:
        """Persist segments and a commit point, roll the translog."""
        t0 = time.monotonic()
        with self._lock:
            self._check_open()
            self.refresh()
            wrote = self._persist_new_segments()
            if not wrote and not force and self._commit_id > 0:
                committed = self.store.read_last_commit()
                if committed and committed.get("translog_gen") == self.translog.gen \
                        and self.translog.ops_count == 0:
                    return False
            new_tgen = self.translog.roll()
            self._commit(new_tgen, extra={"tombstones": {
                str(seg.gen): seg.live.tolist() if not seg.live.all() else None
                for seg in self._segments}})
            if not self._recovery_held():
                # a peer recovery in flight still replays the older
                # generations (phases 2 and 3)
                self.translog.prune_before(new_tgen)
            self.stats["flush_total"] += 1
            self.stats["flush_time_ms"] += (time.monotonic() - t0) * 1000
            return True

    def maybe_flush(self):
        if self.translog.should_flush():
            self.flush()

    # ------------------------------------------------------------------ peer recovery
    def acquire_recovery_hold(self, ttl: float = 600.0) -> str:
        """Pin this engine's files for a peer recovery: flushes stop pruning
        translog generations and merged-away segment files wait. The TTL
        bounds the pin when a target dies mid-flight; a recovery touches
        its hold as it makes progress."""
        hid = uuid.uuid4().hex
        with self._lock:
            self._recovery_holds[hid] = time.time() + ttl
        return hid

    def touch_recovery_hold(self, hold_id: str | None, ttl: float = 600.0) -> bool:
        """Extend a live hold; False when it already expired or was released
        (the recovery must start again: its pinned files may be gone)."""
        with self._lock:
            self._recovery_held()
            if hold_id not in self._recovery_holds:
                return False
            self._recovery_holds[hold_id] = time.time() + ttl
            return True

    def release_recovery_hold(self, hold_id: str | None):
        with self._lock:
            self._recovery_holds.pop(hold_id, None)
            self._recovery_held()  # the last hold's release runs the deletes

    def _recovery_held(self) -> bool:
        """Drop expired holds; with none left, delete the deferred segment
        files. Caller holds _lock."""
        now = time.time()
        for hid in [h for h, exp in self._recovery_holds.items() if exp < now]:
            del self._recovery_holds[hid]
        if not self._recovery_holds and self._deferred_segment_deletes:
            for g in self._deferred_segment_deletes:
                self.store.delete_segment(g)
            self._deferred_segment_deletes = []
        return bool(self._recovery_holds)

    def _delete_segment_files(self, gen: int):
        """A merged-away segment's files go at once, unless a recovery hold
        is live: a target may still be pulling them."""
        if self._recovery_held():
            self._deferred_segment_deletes.append(gen)
        else:
            self.store.delete_segment(gen)

    def translog_ops_since(self, gen: int, count: int) -> list:
        """Recovery phase 3: every op logged after the phase-2 snapshot (the
        first `count` ops from generation `gen` on), read under the engine
        lock, so no write lands between this read and live replication."""
        with self._lock:
            return self.translog.read_ops(from_gen=gen)[count:]

    def _replace_segments(self, sources: list[FrozenSegment],
                          merged: FrozenSegment, start: int):
        """Splice `merged` over the source window; persist it and commit
        before the sources' files go when any of them was committed. Caller
        holds _lock.

        The merged segment gets the `compact` pack hint; it names the
        sources only when each has a resident pack on some device (the
        concat reads the packs of the device it packs for, and re-stages if
        one is missing there): a hint on a write-only shard, whose pack may
        never run, would otherwise hold the merged-away arrays."""
        if merged.doc_count:
            hint = {"kind": "compact"}
            if all(_resident(s) for s in sources):
                hint["sources"] = tuple(sources)
            merged._device_cache["pack_hint"] = hint
        end = start + len(sources)
        old_gens = [seg.gen for seg in sources]
        any_persisted = any(g in self._persisted_gens for g in old_gens)
        self._segments = self._segments[:start] + \
            ([merged] if merged.doc_count else []) + self._segments[end:]
        if any_persisted:
            self._persist_new_segments()
            self._commit(self.translog.gen)
        for g in old_gens:
            self._persisted_gens.discard(g)
            self._segment_files.pop(str(g), None)
            self._delete_segment_files(g)

    def optimize(self, max_num_segments: int = 1):
        """Force-merge down to one segment."""
        with self._lock:
            self._check_open()
            self.refresh()
            if len(self._segments) <= max_num_segments:
                return
            sources = list(self._segments)
            merged = merge_segments(sources, self._next_gen)
            self._next_gen += 1
            self._buffer = SegmentBuilder(self._next_gen)
            self._replace_segments(sources, merged, 0)
            self._uid_index = {}
            for seg in self._segments:
                self._index_uids(seg)
            self._install_searcher()
            self.stats["merge_total"] += 1

    def _publish_merge(self, sources: list[FrozenSegment],
                       merged: FrozenSegment) -> bool:
        """Publish a merge computed outside the lock. The sources must still
        be the live list's objects, contiguous: a refresh that tombstoned one
        replaced it copy-on-write, and publishing would resurrect those
        deletes, so the merge aborts instead. Caller holds _lock."""
        try:
            start = next(i for i, s in enumerate(self._segments) if s is sources[0])
        except StopIteration:
            return False
        window = self._segments[start:start + len(sources)]
        if len(window) != len(sources) or any(a is not b for a, b in zip(window, sources)):
            return False
        self._replace_segments(sources, merged, start)
        source_gens = {seg.gen for seg in sources}
        # a tombstone queued on a source since the merge was planned (an
        # update's old copy, a delete) moves to the merged copy: dropped, it
        # would leave the old copy live beside the new one
        moved = _merged_locals(sources)
        self._pending_deletes = [
            (merged.gen, moved[loc]) if loc[0] in source_gens else loc
            for loc in self._pending_deletes
            if loc[0] not in source_gens or loc in moved]
        for seg in sources:
            for local in range(seg.doc_count):
                if not seg.parent_mask[local]:
                    continue
                uid = f"{seg.types[local]}#{seg.ids[local]}"
                cur = self._uid_index.get(uid)
                if cur is not None and cur[0] in source_gens:
                    del self._uid_index[uid]
        self._index_uids(merged)
        self._install_searcher()
        self.stats["merge_total"] += 1
        return True

    def maybe_merge(self, max_merges: int = 4):
        """Run the tiered merge policy to convergence (at most `max_merges`
        merges). Planning and publishing hold the engine lock; the merge
        itself does not, so searches and writes go on meanwhile. A second
        concurrent caller returns at once."""
        if not self._merge_mutex.acquire(blocking=False):
            return
        try:
            for _ in range(max_merges):
                with self._lock:
                    self._check_open()
                    spec = self.merge_policy.find_merge(self._segments)
                    if spec is None:
                        return
                    sources = self._segments[spec.start:spec.end]
                    gen = self._next_gen
                    self._next_gen += 1
                    self._buffer.gen = self._next_gen
                merged = merge_segments(sources, gen)
                with self._lock:
                    self._check_open()
                    if not self._publish_merge(sources, merged):
                        return
        finally:
            self._merge_mutex.release()

    # ------------------------------------------------------------------ recovery
    def recover_from_store(self) -> int:
        """Load the last commit's segments (with their tombstones), then
        replay the translog after it. Returns the number of replayed ops."""
        with self._lock:
            self._segments = []
            self._segment_files = {}
            self._persisted_gens = set()
            self._version_map = {}
            self._uid_index = {}
            self._pending_deletes = []
            commit = self.store.read_last_commit()
            replayed = 0
            if commit:
                self._commit_id = commit["id"]
                tombstones = commit.get("extra", {}).get("tombstones", {})
                for gen_str, files in sorted(commit["segments"].items(),
                                             key=lambda kv: int(kv[0])):
                    seg = self.store.read_segment(int(gen_str), verify=files)
                    tomb = tombstones.get(gen_str)
                    if tomb:
                        seg.live = np.asarray(tomb, dtype=bool)
                    self._segments.append(seg)
                    self._segment_files[gen_str] = files
                    self._persisted_gens.add(int(gen_str))
                    self._next_gen = max(self._next_gen, int(gen_str) + 1)
                self._buffer = SegmentBuilder(self._next_gen)
                for seg in self._segments:
                    self._index_uids(seg)
                self.translog.set_gen(commit["translog_gen"])
            for op in self.translog.read_ops(self.translog.gen if commit else 1):
                self._replay_op(op)
                replayed += 1
            self._install_searcher()
            self.refresh()
            return replayed

    def _replay_op(self, op: TranslogOp):
        # the logged `parent` is not passed on, as in the JAX package: a child
        # replayed from the translog has no parent pointer (a kept behaviour)
        try:
            if op.op in (CREATE, INDEX):
                self.index(op.type, op.id, op.source or {}, routing=op.routing,
                           version=op.version, version_type=EXTERNAL,
                           _from_translog=True)
            elif op.op == DELETE:
                self.delete(op.type, op.id, _from_translog=True)
            elif op.op == DELETE_BY_QUERY:
                self.delete_by_uids((op.source or {}).get("uids", []),
                                    _from_translog=True)
        except VersionConflictError:
            pass  # replay after a delete can revisit a version; newest wins

    def apply_replicated_op(self, op: TranslogOp):
        """Apply an op a primary streamed (a replica write, recovery phases 2
        and 3): an index with the primary's version as an external one, a
        delete without a version check; an op the copy already holds a
        newer version of is dropped. The op's parent, timestamp and ttl are
        not applied, as in the JAX engine."""
        try:
            if op.op in (CREATE, INDEX):
                self.index(op.type, op.id, op.source or {}, routing=op.routing,
                           version=op.version, version_type=EXTERNAL)
            elif op.op == DELETE:
                self.delete(op.type, op.id)
        except VersionConflictError:
            pass  # the copy already holds a newer version

    # ------------------------------------------------------------------ info
    def segment_count(self) -> int:
        return len(self._segments)

    def doc_stats(self) -> dict:
        """Live parent documents and the tombstoned ones of the view."""
        s = self.acquire_searcher()
        live = sum(seg.live_count() for seg in s.segments)
        total = sum(seg.parent_mask.sum() for seg in s.segments)
        return {"count": int(live), "deleted": int(total - live)}

    def close(self):
        """Close the translog (the shard's device packs and masks leave with
        its caches, indices_service)."""
        with self._lock:
            if not self._closed:
                self.translog.close()
                self._closed = True
