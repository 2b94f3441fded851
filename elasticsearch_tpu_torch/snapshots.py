"""Snapshot and restore over blob-store repositories (a copy of the JAX
package's `snapshots.py`).

- A repository is a named blob container: `FsRepository`, a directory
  (read-only when a restore shard reads it), or `UrlRepository`, read-only
  by URL (`file://` a local directory, `http(s)://` fetched with urllib).
  Repositories persist under `path.data` (`_state/repositories.json`).
- Snapshots are INCREMENTAL per shard: a shard's files are copied as blobs
  named by (checksum, name), and a blob an earlier snapshot wrote is
  reused. Deleting a snapshot prunes the blobs no other snapshot names.
- A snapshot's metadata carries each index's metadata (settings,
  mappings), so a restore recreates the index whole.
- Coordination: the coordinating node drives each primary shard through a
  shard action on its owning node (`A_SNAPSHOT_SHARD`: flush, then copy
  the store's files). While it runs, the allocator's
  `snapshot_in_progress` decider keeps the index's shards in place.
- A restore creates the index, waits for yellow, and then replaces each
  primary's files on its node (`A_RESTORE_SHARD`). The primary's old shard
  leaves through `IndicesService.restore_shard`, which unwires
  the warmer, drops its request-cache entries and filter masks, closes the
  engine and drops its segments' device packs, so nothing of the empty
  shard stays resident. The index's replicas peer-recovered from the
  primaries while these were still empty, and keep what they recovered:
  the JAX package's behaviour, kept (ROADMAP).
"""

from __future__ import annotations

import json
import os
import shutil
import time

from .common.errors import (
    RepositoryMissingError,
    SearchEngineError,
    SnapshotError,
    SnapshotMissingError,
)
from .common.logging import get_logger

A_SNAPSHOT_SHARD = "internal:snapshot/shard/create"
A_RESTORE_SHARD = "internal:snapshot/shard/restore"


class FsRepository:
    """ref: repositories/fs/FsRepository.java — a directory of blobs + metadata."""

    type = "fs"

    def __init__(self, name: str, location: str, readonly: bool = False):
        if "://" in location:
            # regression guard: a URL passed as an fs location used to be
            # makedirs()'d literally, leaking an `http:` dir at the cwd root
            raise SnapshotError(
                f"fs repository location [{location}] is a URL — use a "
                f"[url] type repository for read-only URL access")
        self.name = name
        self.location = location
        self.readonly = readonly
        os.makedirs(os.path.join(location, "blobs"), exist_ok=True)
        os.makedirs(os.path.join(location, "snapshots"), exist_ok=True)

    # blob layer -------------------------------------------------------------
    def blob_path(self, checksum: int, name: str) -> str:
        return os.path.join(self.location, "blobs", f"{checksum}_{name}")

    def put_file(self, src_path: str, name: str, checksum: int) -> str:
        if self.readonly:
            raise SnapshotError(f"repository [{self.name}] is readonly")
        dst = self.blob_path(checksum, name)
        if not os.path.exists(dst):  # incremental: identical blob reused
            shutil.copyfile(src_path, dst)
        return os.path.basename(dst)

    def get_file(self, blob_name: str, dst_path: str):
        src = os.path.join(self.location, "blobs", blob_name)
        shutil.copyfile(src, dst_path)

    # snapshot metadata -------------------------------------------------------
    def snapshot_meta_path(self, snapshot: str) -> str:
        return os.path.join(self.location, "snapshots", f"{snapshot}.json")

    def write_snapshot(self, snapshot: str, meta: dict):
        if self.readonly:
            raise SnapshotError(f"repository [{self.name}] is readonly")
        with open(self.snapshot_meta_path(snapshot), "w") as fh:
            json.dump(meta, fh)
        self._write_index()

    def _write_index(self):
        # snapshots/index.json lets read-only URL repositories (no directory
        # listing over http) enumerate snapshots
        with open(os.path.join(self.location, "snapshots", "index.json"), "w") as fh:
            json.dump(self.list_snapshots(), fh)

    def read_snapshot(self, snapshot: str) -> dict:
        p = self.snapshot_meta_path(snapshot)
        if not os.path.exists(p):
            raise SnapshotMissingError(f"[{self.name}:{snapshot}] missing")
        with open(p) as fh:
            return json.load(fh)

    def list_snapshots(self) -> list[str]:
        return sorted(
            n[:-5] for n in os.listdir(os.path.join(self.location, "snapshots"))
            if n.endswith(".json") and n != "index.json"
        )

    def delete_snapshot(self, snapshot: str):
        p = self.snapshot_meta_path(snapshot)
        if os.path.exists(p):
            os.unlink(p)
        self._write_index()
        # blobs referenced by other snapshots survive; orphan cleanup:
        referenced: set[str] = set()
        for s in self.list_snapshots():
            meta = self.read_snapshot(s)
            for idx in meta.get("indices", {}).values():
                for shard in idx.get("shards", {}).values():
                    referenced.update(shard.get("files", {}).values())
        blob_dir = os.path.join(self.location, "blobs")
        for blob in os.listdir(blob_dir):
            if blob not in referenced:
                os.unlink(os.path.join(blob_dir, blob))


class UrlRepository:
    """Read-only repository addressed by URL (ref: repositories/uri/URLRepository.java
    + common/blobstore/url/URLBlobStore.java — read-only restore source).

    `file://` URLs resolve to a local directory; `http(s)://` URLs are fetched
    with urllib (restore from a snapshot server). All mutations raise.
    """

    type = "url"
    readonly = True

    def __init__(self, name: str, url: str):
        from urllib.parse import urlparse

        self.name = name
        self.url = url.rstrip("/")
        parsed = urlparse(url)
        if parsed.scheme in ("", "file"):
            self._local = parsed.path if parsed.scheme == "file" else url
            if not os.path.isdir(self._local):
                raise SnapshotError(
                    f"url repository [{name}]: directory [{self._local}] not found")
        elif parsed.scheme in ("http", "https"):
            self._local = None
        else:
            raise SnapshotError(
                f"url repository [{name}]: unsupported scheme [{parsed.scheme}]")
        self.location = self._local or self.url  # for wire requests / display

    # read side ---------------------------------------------------------------
    def _fetch(self, relpath: str) -> bytes:
        if self._local is not None:
            p = os.path.join(self._local, relpath)
            if not os.path.exists(p):
                raise SnapshotMissingError(f"[{self.name}] blob [{relpath}] missing")
            with open(p, "rb") as fh:
                return fh.read()
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(f"{self.url}/{relpath}", timeout=30) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise SnapshotMissingError(
                    f"[{self.name}] blob [{relpath}] missing") from e
            raise SnapshotError(f"[{self.name}] fetch [{relpath}]: {e}") from e
        except urllib.error.URLError as e:
            raise SnapshotError(f"[{self.name}] unreachable: {e}") from e

    def get_file(self, blob_name: str, dst_path: str):
        with open(dst_path, "wb") as fh:
            fh.write(self._fetch(f"blobs/{blob_name}"))

    def read_snapshot(self, snapshot: str) -> dict:
        return json.loads(self._fetch(f"snapshots/{snapshot}.json"))

    def list_snapshots(self) -> list[str]:
        if self._local is not None:
            snap_dir = os.path.join(self._local, "snapshots")
            if not os.path.isdir(snap_dir):
                return []
            return sorted(n[:-5] for n in os.listdir(snap_dir)
                          if n.endswith(".json") and n != "index.json")
        # http: directory listing isn't part of the protocol — the writer
        # maintains snapshots/index.json for exactly this
        try:
            return sorted(json.loads(self._fetch("snapshots/index.json")))
        except SnapshotMissingError:
            return []

    def verify_readable(self):
        self.list_snapshots()

    # write side: always refused ---------------------------------------------
    def _ro(self):
        raise SnapshotError(f"repository [{self.name}] is readonly (url)")

    def put_file(self, *a, **k):
        self._ro()

    def write_snapshot(self, *a, **k):
        self._ro()

    def delete_snapshot(self, *a, **k):
        self._ro()


class SnapshotsService:
    """Master-side coordinator + shard-level handlers (registered on every node)."""

    def __init__(self, node):
        self.node = node
        self.repositories: dict[str, FsRepository] = {}
        self.logger = get_logger("snapshots", node=node.name)
        node.transport.register_handler(A_SNAPSHOT_SHARD, self._handle_snapshot_shard)
        node.transport.register_handler(A_RESTORE_SHARD, self._handle_restore_shard)
        self._repo_file = os.path.join(node.data_path, "_state", "repositories.json")
        self._load_repos()

    # repositories ------------------------------------------------------------
    def put_repository(self, name: str, body: dict) -> dict:
        rtype = body.get("type", "fs")
        settings = body.get("settings", {})
        if rtype == "fs":
            location = settings.get("location")
            if not location:
                raise SnapshotError("fs repository requires settings.location")
            self.repositories[name] = FsRepository(name, location)
        elif rtype == "url":
            url = settings.get("url")
            if not url:
                raise SnapshotError("url repository requires settings.url")
            self.repositories[name] = UrlRepository(name, url)
        else:
            raise SnapshotError(f"unknown repository type [{rtype}]")
        self._save_repos(body, name)
        return {"acknowledged": True}

    def get_repository(self, name: str | None = None) -> dict:
        def spec(r):
            if r.type == "url":
                return {"type": "url", "settings": {"url": r.url}}
            return {"type": "fs", "settings": {"location": r.location}}

        if name:
            return {name: spec(self._repo(name))}
        return {n: spec(r) for n, r in self.repositories.items()}

    def delete_repository(self, name: str) -> dict:
        if name not in self.repositories:
            raise RepositoryMissingError(f"[{name}] missing")
        del self.repositories[name]
        self._save_repos(None, name, delete=True)
        return {"acknowledged": True}

    def verify_repository(self, name: str) -> dict:
        repo = self._repo(name)
        if getattr(repo, "readonly", False):
            # read-only repos are verified by a read, not a probe write
            if isinstance(repo, UrlRepository):
                repo.verify_readable()
            else:
                repo.list_snapshots()
        else:
            probe = os.path.join(repo.location, ".verify")
            with open(probe, "w") as fh:
                fh.write("ok")
            os.unlink(probe)
        return {"nodes": {self.node.node_id: {"name": self.node.name}}}

    def _repo(self, name: str) -> FsRepository:
        repo = self.repositories.get(name)
        if repo is None:
            raise RepositoryMissingError(f"[{name}] missing")
        return repo

    def _load_repos(self):
        if os.path.exists(self._repo_file):
            with open(self._repo_file) as fh:
                for name, body in json.load(fh).items():
                    try:
                        self.put_repository(name, body)
                    except SnapshotError:
                        pass

    def _save_repos(self, body, name, delete=False):
        data = {}
        if os.path.exists(self._repo_file):
            with open(self._repo_file) as fh:
                data = json.load(fh)
        if delete:
            data.pop(name, None)
        elif body is not None:
            data[name] = body
        os.makedirs(os.path.dirname(self._repo_file), exist_ok=True)
        with open(self._repo_file, "w") as fh:
            json.dump(data, fh)

    # snapshot ----------------------------------------------------------------
    def create_snapshot(self, repo_name: str, snapshot: str, body: dict | None = None) -> dict:
        repo = self._repo(repo_name)
        if getattr(repo, "readonly", False):
            # guard BEFORE the shard fan-out — data nodes write blobs directly,
            # which would bypass the final write_snapshot readonly check
            raise SnapshotError(f"repository [{repo_name}] is readonly")
        state = self.node.cluster_service.state
        body = body or {}
        indices = state.metadata.resolve_indices(body.get("indices", "_all"))
        t0 = time.time()
        meta: dict = {
            "snapshot": snapshot, "state": "IN_PROGRESS",
            "start_time_ms": int(t0 * 1000), "indices": {},
        }
        failures = []
        # gate rebalancing of these indices while their primaries stream out
        # (SnapshotInProgressAllocationDecider reads this set)
        alloc = getattr(self.node, "allocation", None)
        if alloc is not None:
            alloc.snapshotting_indices.update(indices)
        try:
            failures = self._snapshot_indices(state, indices, repo, meta)
        finally:
            if alloc is not None:
                alloc.snapshotting_indices.difference_update(indices)
        meta["state"] = "SUCCESS" if not failures else "PARTIAL"
        meta["failures"] = failures
        meta["end_time_ms"] = int(time.time() * 1000)
        repo.write_snapshot(snapshot, meta)
        return {"snapshot": {"snapshot": snapshot, "state": meta["state"],
                             "indices": list(meta["indices"]),
                             "failures": failures,
                             "duration_in_millis": meta["end_time_ms"] - meta["start_time_ms"]}}

    def _snapshot_indices(self, state, indices, repo, meta) -> list:
        failures = []
        for index in indices:
            imeta = state.metadata.index(index)
            table = state.routing_table.index(index)
            entry = {"metadata": imeta.to_dict(), "shards": {}}
            for grp in table.shards:
                primary = grp.primary
                if primary is None or not primary.active:
                    failures.append(f"[{index}][{grp.shards[0].shard_id}] primary inactive")
                    continue
                node = state.nodes.get(primary.node_id)
                try:
                    r = self.node.transport.submit_request(node, A_SNAPSHOT_SHARD, {
                        "index": index, "shard": primary.shard_id,
                        "repo_location": repo.location}, timeout=120.0)
                    entry["shards"][str(primary.shard_id)] = {"files": r["files"]}
                except SearchEngineError as e:
                    failures.append(f"[{index}][{primary.shard_id}] {e}")
            meta["indices"][index] = entry
        return failures

    def _handle_snapshot_shard(self, request, channel):
        """Data-node side: flush + copy this shard's files into the repo (incremental)."""
        shard = self.node.indices.index_service(request["index"]).shard(request["shard"])
        shard.engine.flush(force=True)
        repo = FsRepository("_inline", request["repo_location"])
        files = {}
        store = shard.engine.store
        for name, info in store.list_files().items():
            blob = repo.put_file(os.path.join(store.dir, name), name, info["checksum"])
            files[name] = blob
        return {"files": files}

    def get_snapshots(self, repo_name: str, snapshot: str | None = None) -> dict:
        repo = self._repo(repo_name)
        names = [snapshot] if snapshot and snapshot != "_all" else repo.list_snapshots()
        out = []
        for n in names:
            meta = repo.read_snapshot(n)
            out.append({"snapshot": n, "state": meta["state"],
                        "indices": list(meta.get("indices", {})),
                        "start_time_in_millis": meta.get("start_time_ms"),
                        "end_time_in_millis": meta.get("end_time_ms")})
        return {"snapshots": out}

    def snapshot_status(self, repo_name: str, snapshot: str) -> dict:
        meta = self._repo(repo_name).read_snapshot(snapshot)
        return {"snapshots": [{"snapshot": snapshot, "state": meta["state"],
                               "shards_stats": {
                                   "done": sum(len(i["shards"]) for i in
                                               meta["indices"].values()),
                                   "failed": len(meta.get("failures", []))}}]}

    def delete_snapshot(self, repo_name: str, snapshot: str) -> dict:
        self._repo(repo_name).delete_snapshot(snapshot)
        return {"acknowledged": True}

    # restore -----------------------------------------------------------------
    def restore_snapshot(self, repo_name: str, snapshot: str, body: dict | None = None) -> dict:
        repo = self._repo(repo_name)
        meta = repo.read_snapshot(snapshot)
        body = body or {}
        wanted = body.get("indices")
        rename_pattern = body.get("rename_pattern")
        rename_replacement = body.get("rename_replacement", "")
        client = self.node.client()
        restored = []
        for index, entry in meta["indices"].items():
            if wanted and index not in ([wanted] if isinstance(wanted, str) else wanted):
                continue
            target = index
            if rename_pattern:
                import re as _re

                target = _re.sub(rename_pattern, rename_replacement, index)
            imeta = entry["metadata"]
            if self.node.cluster_service.state.metadata.has_index(target):
                raise SnapshotError(f"index [{target}] already exists — close/delete first")
            settings = dict(imeta.get("settings", {}))
            client.create_index(target, {
                "settings": {k: v for k, v in settings.items()},
                "mappings": {t: json.loads(m) if isinstance(m, str) else m
                             for t, m in imeta.get("mappings", {}).items()},
            })
            client.cluster_health(wait_for_status="yellow", timeout=10)
            state = self.node.cluster_service.state
            table = state.routing_table.index(target)
            for grp in table.shards:
                primary = grp.primary
                sid = str(grp.shards[0].shard_id)
                shard_files = entry["shards"].get(sid, {}).get("files", {})
                node = state.nodes.get(primary.node_id)
                self.node.transport.submit_request(node, A_RESTORE_SHARD, {
                    "index": target, "shard": int(sid),
                    "repo_type": repo.type,
                    "repo_location": repo.url if repo.type == "url" else repo.location,
                    "files": shard_files,
                }, timeout=120.0)
            restored.append(target)
        return {"snapshot": {"snapshot": snapshot, "indices": restored,
                             "shards": {"failed": 0}}}

    def _handle_restore_shard(self, request, channel):
        """Data-node side: release the primary's shard, replace its store
        with the snapshot's files (the translog wiped: a stale generation
        would replay foreign ops over the restored commit), and start it
        again from that store."""
        if request.get("repo_type") == "url":
            repo = UrlRepository("_inline", request["repo_location"])
        else:
            repo = FsRepository("_inline", request["repo_location"], readonly=True)

        def fill(store_dir: str):
            for name, blob in request["files"].items():
                repo.get_file(blob, os.path.join(store_dir, name))

        self.node.indices.restore_shard(request["index"], request["shard"], fill)
        return {"ok": True}
