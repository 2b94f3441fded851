"""Per-shard engine: versioned writes, NRT searcher views and durability (a
trimmed copy of the JAX package's `index/engine.py`: `Searcher` and
`Engine`).

- writes: `index` (internal / external versions, `create` conflicts) and
  `delete` go to the translog first, then to the in-memory buffer;
  a realtime `get` is served from the version map before a refresh;
- views: `refresh` freezes the buffer into a new segment and applies
  tombstones copy-on-write (`FrozenSegment.with_deletes`), so a searcher
  acquired earlier keeps its point-in-time view;
- durability: `flush` persists the segments and a commit point and rolls the
  translog; `recover_from_store` loads the last commit and replays the
  translog after it;
- merges: `maybe_merge` runs the tiered policy (the merge itself outside the
  engine lock), `optimize` force-merges.

Recovery holds, replica operations, delete-by-query and TTL wait for the
slice with replicas; the pack hints and view listeners wait for the warmer
and the caches."""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import numpy as np

from ..common.errors import (
    DocumentAlreadyExistsError,
    EngineClosedError,
    VersionConflictError,
)
from .merge_policy import TieredMergePolicy
from .segment import FieldStats, FrozenSegment, SegmentBuilder, merge_segments
from .store import Store
from .translog import CREATE, DELETE, INDEX, Translog, TranslogOp

INTERNAL, EXTERNAL = "internal", "external"


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


@dataclass
class GetResult:
    found: bool
    id: str = ""
    type: str = ""
    version: int = 0
    source: dict | None = None
    routing: str | None = None


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
        self._closed = False
        self.merge_policy = TieredMergePolicy(settings)
        # one merge computes at a time, outside _lock (non-blocking acquire)
        self._merge_mutex = threading.Lock()
        self._searcher_version = 0
        self._searcher = Searcher([], version=0)

    # ------------------------------------------------------------------ util
    def _check_open(self):
        if self._closed:
            raise EngineClosedError("engine is closed")

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
              _from_translog: bool = False) -> tuple[int, bool]:
        """Index or create a document. Returns (new_version, created)."""
        with self._lock:
            self._check_open()
            mapper = self.mapper_service.mapper_for(type_name)
            uid = f"{type_name}#{doc_id}"
            current, deleted = self._current_version(uid)
            created = current is None or deleted
            if op_type == "create" and not created:
                raise DocumentAlreadyExistsError(f"[{type_name}][{doc_id}] already exists")
            new_version = self._check_version(uid, version, version_type)
            parsed = mapper.parse(source, doc_id, routing=routing)
            if not _from_translog:
                self.translog.add(TranslogOp(
                    CREATE if op_type == "create" else INDEX, type_name, doc_id,
                    source, routing=routing, version=new_version))
            self._tombstone_latest(uid)
            local = self._buffer.add(parsed, version=new_version)
            self._version_map[uid] = VersionEntry(
                version=new_version, location=("buffer", local), source=source,
                routing=parsed.routing)
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
            return new_version, found

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
                                     entry.source, entry.routing)
            loc = self._uid_index.get(uid)
            if loc is None:
                return GetResult(found=False)
            seg = self._seg_by_gen(loc[0])
            if seg is None or not seg.live[loc[1]]:
                return GetResult(found=False)
            local = loc[1]
            return GetResult(True, doc_id, type_name, int(seg.versions[local]),
                             seg.stored[local], seg.routings[local])

    def _install_searcher(self) -> Searcher:
        """A new point-in-time view over the current segment list (caller
        holds _lock)."""
        self._searcher_version += 1
        self._searcher = Searcher(list(self._segments), version=self._searcher_version)
        return self._searcher

    def _index_uids(self, seg: FrozenSegment):
        for local in range(seg.doc_count):
            if seg.parent_mask[local] and seg.live[local]:
                self._uid_index[f"{seg.types[local]}#{seg.ids[local]}"] = (seg.gen, local)

    # ------------------------------------------------------------------ nrt
    def refresh(self) -> bool:
        """Make buffered ops searchable: freeze the buffer into a new segment
        and apply pending tombstones, copy-on-write on older segments."""
        with self._lock:
            self._check_open()
            if self._buffer.doc_count == 0 and not self._pending_deletes:
                return False
            new_seg: FrozenSegment | None = None
            if self._buffer.doc_count > 0:
                new_seg = self._buffer.freeze()
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
            return True

    def acquire_searcher(self) -> Searcher:
        with self._lock:
            self._check_open()
            return self._searcher

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
            self.translog.prune_before(new_tgen)
            return True

    def maybe_flush(self):
        if self.translog.should_flush():
            self.flush()

    def _replace_segments(self, sources: list[FrozenSegment],
                          merged: FrozenSegment, start: int):
        """Splice `merged` over the source window; persist it and commit
        before the sources' files go when any of them was committed. Caller
        holds _lock."""
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
            self.store.delete_segment(g)

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
        for seg in sources:
            for local in range(seg.doc_count):
                uid = f"{seg.types[local]}#{seg.ids[local]}"
                cur = self._uid_index.get(uid)
                if cur is not None and cur[0] in source_gens:
                    del self._uid_index[uid]
        self._index_uids(merged)
        self._install_searcher()
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
        try:
            if op.op in (CREATE, INDEX):
                self.index(op.type, op.id, op.source or {}, routing=op.routing,
                           version=op.version, version_type=EXTERNAL,
                           _from_translog=True)
            elif op.op == DELETE:
                self.delete(op.type, op.id, _from_translog=True)
        except VersionConflictError:
            pass  # replay after a delete can revisit a version; newest wins

    # ------------------------------------------------------------------ info
    def segment_count(self) -> int:
        return len(self._segments)

    def close(self):
        with self._lock:
            if not self._closed:
                self.translog.close()
                self._closed = True
