"""Checksummed on-disk segment store (a trimmed copy of the JAX package's
`index/store.py`): a directory per shard holding write-once segment files
and a commit point. Every file's CRC32 is recorded in the commit, and a read
verifies it. `list_files` lists every file with its length and CRC32,
the manifest a peer recovery diffs.

Layout:
  <dir>/seg_<gen>.npz        — postings / positions / norms / doc-value arrays
  <dir>/seg_<gen>.meta.json  — term dict, stored fields, stats
  <dir>/commit_<N>.json      — commit point: live segments, translog gen,
                               tombstones
"""

from __future__ import annotations

import io
import json
import os
import zlib

import numpy as np

from ..common.errors import SearchEngineError
from .segment import FieldStats, FrozenSegment


def _crc_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(chunk, crc)


def _write_synced(path: str, data: bytes):
    with open(path, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())


class Store:
    def __init__(self, path: str):
        self.dir = path
        os.makedirs(path, exist_ok=True)

    def write_segment(self, seg: FrozenSegment) -> dict:
        """Persist a frozen segment (fsynced before any commit names it);
        returns {file: {length, checksum}}."""
        npz_path = os.path.join(self.dir, f"seg_{seg.gen}.npz")
        meta_path = os.path.join(self.dir, f"seg_{seg.gen}.meta.json")
        arrays = {
            "post_offsets": seg.post_offsets, "post_docs": seg.post_docs,
            "post_freqs": seg.post_freqs, "pos_offsets": seg.pos_offsets,
            "positions": seg.positions, "versions": seg.versions,
            "live": seg.live, "parent_mask": seg.parent_mask,
        }
        for f, a in seg.norms.items():
            arrays[f"norm::{f}"] = a
        for f, (off, vals) in seg.dv_num.items():
            arrays[f"dvn_off::{f}"] = off
            arrays[f"dvn_val::{f}"] = vals
        for f, (_uniq, off, ords) in seg.dv_str.items():
            arrays[f"dvs_off::{f}"] = off
            arrays[f"dvs_ord::{f}"] = ords
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        _write_synced(npz_path, buf.getvalue())
        meta = {
            "gen": seg.gen,
            "doc_count": seg.doc_count,
            "term_dict": {f: list(td.keys()) for f, td in seg.term_dict.items()},
            "field_stats": {f: [s.doc_count, s.sum_ttf, s.sum_dfs]
                            for f, s in seg.field_stats.items()},
            "stored": seg.stored, "ids": seg.ids, "types": seg.types,
            "routings": seg.routings, "nested_paths": seg.nested_paths,
            "dv_str_terms": {f: uniq for f, (uniq, _, _) in seg.dv_str.items()},
        }
        _write_synced(meta_path, json.dumps(meta).encode())
        return {os.path.basename(p): {"length": os.path.getsize(p),
                                      "checksum": _crc_file(p)}
                for p in (npz_path, meta_path)}

    def read_segment(self, gen: int, verify: dict | None = None) -> FrozenSegment:
        npz_path = os.path.join(self.dir, f"seg_{gen}.npz")
        meta_path = os.path.join(self.dir, f"seg_{gen}.meta.json")
        for name, info in (verify or {}).items():
            p = os.path.join(self.dir, name)
            if not os.path.exists(p) or _crc_file(p) != info["checksum"]:
                raise SearchEngineError(f"checksum mismatch for segment file [{name}]")
        with open(meta_path) as fh:
            meta = json.load(fh)
        data = np.load(npz_path)
        # term ids in the order freeze() assigned them: sorted fields, sorted terms
        term_dict: dict[str, dict[str, int]] = {}
        tid = 0
        for f in sorted(meta["term_dict"]):
            term_dict[f] = {}
            for t in meta["term_dict"][f]:
                term_dict[f][t] = tid
                tid += 1
        norms = {k[len("norm::"):]: data[k] for k in data.files if k.startswith("norm::")}
        dv_num = {k[len("dvn_off::"):]: (data[k], data["dvn_val::" + k[len("dvn_off::"):]])
                  for k in data.files if k.startswith("dvn_off::")}
        dv_str = {k[len("dvs_off::"):]: (meta["dv_str_terms"][k[len("dvs_off::"):]],
                                        data[k], data["dvs_ord::" + k[len("dvs_off::"):]])
                  for k in data.files if k.startswith("dvs_off::")}
        return FrozenSegment(
            gen=meta["gen"],
            doc_count=meta["doc_count"],
            term_dict=term_dict,
            post_offsets=data["post_offsets"],
            post_docs=data["post_docs"],
            post_freqs=data["post_freqs"],
            norms=norms,
            field_stats={f: FieldStats(*v) for f, v in meta["field_stats"].items()},
            live=data["live"].copy(),
            parent_mask=data["parent_mask"],
            ids=meta["ids"],
            types=meta["types"],
            routings=meta["routings"],
            versions=data["versions"],
            stored=meta["stored"],
            pos_offsets=data["pos_offsets"],
            positions=data["positions"],
            dv_num=dv_num,
            dv_str=dv_str,
            nested_paths=meta.get("nested_paths"),
        )

    def write_commit(self, commit_id: int, segment_files: dict, translog_gen: int,
                     extra: dict | None = None):
        """The commit point ties the segment set to a translog generation;
        written to a temp file and renamed, then older commits are pruned."""
        commit = {"id": commit_id, "segments": segment_files,
                  "translog_gen": translog_gen, "extra": extra or {}}
        tmp = os.path.join(self.dir, f"commit_{commit_id}.json.tmp")
        _write_synced(tmp, json.dumps(commit).encode())
        os.replace(tmp, os.path.join(self.dir, f"commit_{commit_id}.json"))
        for cid in self._commit_ids():
            if cid < commit_id:
                os.unlink(os.path.join(self.dir, f"commit_{cid}.json"))

    def _commit_ids(self) -> list[int]:
        return [int(n[len("commit_"):-len(".json")]) for n in os.listdir(self.dir)
                if n.startswith("commit_") and n.endswith(".json")]

    def read_last_commit(self) -> dict | None:
        ids = self._commit_ids()
        if not ids:
            return None
        with open(os.path.join(self.dir, f"commit_{max(ids)}.json")) as fh:
            return json.load(fh)

    def list_files(self) -> dict[str, dict]:
        """name -> {length, checksum} of every finished file (a peer
        recovery's manifest diff)."""
        out = {}
        for name in sorted(os.listdir(self.dir)):
            p = os.path.join(self.dir, name)
            if os.path.isfile(p) and not name.endswith(".tmp"):
                out[name] = {"length": os.path.getsize(p), "checksum": _crc_file(p)}
        return out

    def delete_segment(self, gen: int):
        for suffix in (".npz", ".meta.json"):
            p = os.path.join(self.dir, f"seg_{gen}{suffix}")
            if os.path.exists(p):
                os.unlink(p)
