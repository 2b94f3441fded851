"""Peer recovery on the port: the engine's recovery holds against the JAX
engine's, a flushed shard's files copied checksum for checksum, and no
write lost while a replica recovers under a write storm.

- Engine (port against JAX, the same calls on both): a recovery hold keeps
  a flush from pruning translog generations and defers the deletion of
  merged-away segment files until the last hold drops; an expired hold
  cannot be touched again; `translog_ops_since` returns the tail after a
  count; `apply_replicated_op` applies index and delete ops at the
  primary's versions and drops a stale one. Compared: the store's file
  names, the translog generations on disk, the ops' encodings and each
  document's version and source (tolerance: none).
- A replica of a flushed 2-shard index peer-recovers every file: the
  replica's `Store.list_files()` equals the primary's, name for name and
  checksum for checksum, and its documents equal the primary's.
- The port's copy of tests/test_recovery_under_writes.py: a one-node
  cluster indexes continuously while a second node joins and its
  replicas peer-recover; after the writer stops, every shard's two copies
  hold the same ids at the same versions, every acknowledged write among
  them, for two seeds. The index sets `indices.recovery.file_chunk_size:
  2kb` as the JAX test does; both packages store it as
  `index.indices.recovery.file_chunk_size`, which the recovery does not
  read, so the files go in 512 KB chunks on both."""

from __future__ import annotations

import os
import threading
import time

import pytest

from elasticsearch_tpu_torch.node import Node as PNode
from tests.test_torch_replication import copies
from tests.test_torch_two_nodes import Cluster, threads  # noqa: F401


def _engines(tmp_path):
    from elasticsearch_tpu.common.settings import Settings as JSettings
    from elasticsearch_tpu.index.engine import Engine as JEngine
    from elasticsearch_tpu.mapper import MapperService as JMapper
    from elasticsearch_tpu_torch.common.settings import Settings as PSettings
    from elasticsearch_tpu_torch.index.engine import Engine as PEngine
    from elasticsearch_tpu_torch.mapper import MapperService as PMapper

    flat = {"index.merge.policy.segments_per_tier": 2}
    ps, js = PSettings.from_flat(flat), JSettings.from_flat(flat)
    return {"port": PEngine(str(tmp_path / "port"), PMapper(ps), settings=ps),
            "jax": JEngine(str(tmp_path / "jax"), JMapper(js), settings=js)}


def _files(eng) -> list[str]:
    return sorted(os.listdir(eng.store.dir))


def _tlog_gens(eng) -> list[str]:
    return sorted(n for n in os.listdir(eng.translog.dir) if n.endswith(".log"))


def _docs(eng) -> dict:
    eng.refresh()
    out = {}
    for seg in eng.acquire_searcher().segments:
        for local in (seg.live & seg.parent_mask).nonzero()[0]:
            out[str(seg.ids[local])] = (int(seg.versions[local]), seg.stored[local])
    return out


@pytest.fixture()
def engines(tmp_path):
    e = _engines(tmp_path)
    try:
        yield e
    finally:
        for eng in e.values():
            eng.close()


def _write_segments(eng, n_segments=3, per=4):
    for s in range(n_segments):
        for i in range(per):
            eng.index("doc", f"{s}-{i}", {"body": f"w{i} s{s}", "n": i})
        eng.flush()


def test_hold_keeps_translog_generations_until_released(engines):
    seen = {}
    for name, eng in engines.items():
        eng.index("doc", "a", {"body": "one"})
        eng.flush()
        hold = eng.acquire_recovery_hold()
        for i in range(3):
            eng.index("doc", f"h{i}", {"body": "held"})
            eng.flush()
        held = _tlog_gens(eng)
        eng.release_recovery_hold(hold)
        eng.index("doc", "z", {"body": "after"})
        eng.flush()
        seen[name] = (held, _tlog_gens(eng))
    assert seen["port"] == seen["jax"]
    held, after = seen["port"]
    assert len(held) == 4 and len(after) == 1


def test_hold_defers_merged_segment_deletes(engines):
    seen = {}
    for name, eng in engines.items():
        _write_segments(eng)
        before = _files(eng)
        hold = eng.acquire_recovery_hold()
        eng.optimize()
        during = _files(eng)
        eng.release_recovery_hold(hold)
        seen[name] = (before, during, _files(eng))
    assert seen["port"] == seen["jax"]
    before, during, after = seen["port"]
    segs = lambda names: sorted(n for n in names if n.startswith("seg_"))  # noqa: E731
    assert set(segs(before)) <= set(segs(during))  # nothing deleted under the hold
    assert len(segs(after)) == 2  # the merged segment's two files only


def test_expired_hold_cannot_be_touched_and_frees_deletes(engines):
    for eng in engines.values():
        _write_segments(eng)
        hold = eng.acquire_recovery_hold(ttl=0.05)
        eng.optimize()
        assert len([n for n in _files(eng) if n.startswith("seg_")]) == 8
        time.sleep(0.1)
        assert eng.touch_recovery_hold(hold) is False
        assert len([n for n in _files(eng) if n.startswith("seg_")]) == 2
        live = eng.acquire_recovery_hold()
        assert eng.touch_recovery_hold(live) is True
        eng.release_recovery_hold(live)
        assert eng.touch_recovery_hold(live) is False


def test_translog_ops_since_returns_the_tail(engines):
    tails = {}
    for name, eng in engines.items():
        eng.index("doc", "base", {"body": "x"})
        eng.flush()
        gen = eng.translog.gen
        for i in range(5):
            eng.index("doc", str(i), {"body": f"op {i}"})
        count = len(eng.translog.read_ops(from_gen=gen))
        eng.delete("doc", "1")
        eng.index("doc", "late", {"body": "late"})
        tails[name] = [op.encode() for op in eng.translog_ops_since(gen, count)]
    assert tails["port"] == tails["jax"] and len(tails["port"]) == 2


def test_apply_replicated_op_converges_on_primary_versions(engines):
    from elasticsearch_tpu.index.translog import TranslogOp as JOp
    from elasticsearch_tpu_torch.index.translog import DELETE, INDEX
    from elasticsearch_tpu_torch.index.translog import TranslogOp as POp

    stream = [(INDEX, "a", {"v": 1}, 1), (INDEX, "b", {"v": 1}, 1),
              (INDEX, "a", {"v": 2}, 3), (INDEX, "a", {"v": 0}, 2),
              (DELETE, "b", None, 2), (INDEX, "c", {"v": 9}, 7), (DELETE, "zz", None, 1)]
    got = {}
    for name, eng in engines.items():
        op_cls = POp if name == "port" else JOp
        for kind, doc_id, source, version in stream:
            eng.apply_replicated_op(op_cls(kind, "doc", doc_id, source, version=version))
        got[name] = _docs(eng)
    assert got["port"] == got["jax"]
    assert got["port"] == {"a": (3, {"v": 2}), "c": (7, {"v": 9})}


def test_flushed_replica_files_equal_the_primarys(tmp_path, threads):  # noqa: F811
    c = Cluster("port", ["a", "b"], tmp_path)
    try:
        client = c.nodes[0].client()
        client.create_index("f", {"settings": {"number_of_shards": 2,
                                               "number_of_replicas": 0}})
        assert c.settled("f")
        client.bulk([{"action": {"index": {"_index": "f", "_type": "doc", "_id": str(i)}},
                      "source": {"body": f"w{i % 7} w{i % 3}", "n": i}}
                     for i in range(200)])
        client.flush("f")
        client.update_settings("f", {"settings": {"number_of_replicas": 1}})
        assert c.settled("f")
        state = c.nodes[0].cluster_service.state
        for grp in state.routing_table.index("f").shards:
            shards = {}
            for s in grp.shards:
                node = next(n for n in c.nodes if n.node_id == s.node_id)
                shards[s.primary] = node.indices.shard_or_none("f", s.shard_id)
            pfiles = shards[True].engine.store.list_files()
            rfiles = shards[False].engine.store.list_files()
            assert rfiles == pfiles and any(n.startswith("seg_") for n in pfiles)
            info = shards[False].recovery_info
            assert info["files"] == len(pfiles) and info["reused"] == 0
            assert info["bytes"] == sum(f["length"] for f in pfiles.values())
        held = copies(c, "f")
        for sid in (0, 1):
            assert held[(sid, "a")] == held[(sid, "b")]
        assert sum(len(d) for d in held.values()) == 400
    finally:
        c.close()


@pytest.mark.parametrize("seed", [0, 1])
def test_no_lost_writes_during_replica_recovery(tmp_path, threads, seed):  # noqa: F811
    c = Cluster("port", [f"rw{seed}-0"], tmp_path)
    joined = None
    try:
        client = c.nodes[0].client()
        client.create_index("journal", {"settings": {
            "number_of_shards": 2, "number_of_replicas": 1,
            # as the JAX test sets it (stored under `index.`, not read)
            "indices.recovery.file_chunk_size": "2kb"}})
        client.cluster_health(wait_for_status="yellow")
        for i in range(60):
            client.index("journal", "doc", {"n": i, "body": f"pre {i}"}, id=f"pre-{i}")
        client.flush("journal")
        stop = threading.Event()
        written: dict = {}
        errors: list = []

        def writer():
            j = 0
            while not stop.is_set():
                try:
                    r = client.index("journal", "doc", {"n": j, "body": f"live {j}"},
                                     id=f"live-{j}")
                    written[f"live-{j}"] = r["_version"]
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                j += 1
                time.sleep(0.002)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        time.sleep(0.05)
        # the second node joins mid-storm: the replicas initialize and
        # peer-recover from the primaries while ops keep flowing
        joined = PNode(name=f"rw{seed}-1", settings={"node.device": "cpu",
                                                     "indices.warmer.enabled": "false"},
                       registry=c.registry, data_path=str(tmp_path / f"rw{seed}-1"))
        joined.start([c.nodes[0].local_node.transport_address])
        c.nodes.append(joined)
        h = client.cluster_health(index="journal", wait_for_status="green", timeout=60)
        assert h["status"] == "green", h
        time.sleep(0.1)
        stop.set()
        t.join(timeout=10.0)
        assert not errors, errors[:3]
        time.sleep(0.3)
        client.refresh("journal")
        held = copies(c, "journal")
        for sid in (0, 1):
            a, b = held[(sid, f"rw{seed}-0")], held[(sid, f"rw{seed}-1")]
            assert set(a) == set(b), set(a) ^ set(b)
            assert {k: v[0] for k, v in a.items()} == {k: v[0] for k, v in b.items()}
        union = {k: v[0] for docs in held.values() for k, v in docs.items()}
        assert len(written) > 10
        assert all(union.get(k) == v for k, v in written.items())
        assert len(union) == 60 + len(written)
        rec = [s.recovery_info for s in joined.indices.indices["journal"].shards.values()]
        assert any(r.get("bytes", 0) > 0 for r in rec), rec
    finally:
        c.close()
