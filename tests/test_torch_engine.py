"""The port's durable write path (elasticsearch_tpu_torch/index/: engine,
segment, translog, store, merge_policy) against the JAX package's.

- One op sequence, made from a numpy seed (index, overwrite, external
  version, delete, refresh, flush, maybe_merge with a small tiered policy so
  merges happen, one optimize down to one segment), goes through both
  engines: every op's return, the segment list after every step (gens, doc
  counts, live bitmaps, ids, versions), realtime gets, and at the end every
  segment's CSR arrays, positions, norms and numeric columns must be equal.
  Tolerance: none.
- The JAX `Translog` reads the port's translog files back to the same ops,
  and the port's reads the JAX package's.
- `recover_from_store` on a new port Engine makes the translog-only doc
  searchable and drops the translog-only delete, as the JAX engine does.
- Point in time: a delete refreshed after a searcher was acquired must not
  change that searcher's hits nor the pack its dispatch resolved. The
  `naive` case runs a line-for-line copy of the JAX package's
  `with_deletes`, which shares the port's `("packed", device)` entry: the
  new view's re-mask then rewrites the old view's pack (the fault). The
  port's `with_deletes` gives each view its own pack copy (the repair)."""

import dataclasses

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.common.settings import Settings as TSettings
from elasticsearch_tpu_torch.index import segment as tsegment
from elasticsearch_tpu_torch.index.engine import Engine as TEngine
from elasticsearch_tpu_torch.index.translog import Translog as TTranslog
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.ops.device_index import pack_cache_key, packed_for
from elasticsearch_tpu_torch.search import (
    ShardContext, SimilarityService, parse_query, search_shard_batch)

CPU = torch.device("cpu")
WORDS = [f"w{i}" for i in range(50)]
MERGE_SETTINGS = {"index.merge.policy.segments_per_tier": 3,
                  "index.merge.policy.max_merge_at_once": 3}


def _jax_engine(path, flat=None):
    from elasticsearch_tpu.common.settings import Settings
    from elasticsearch_tpu.index.engine import Engine
    from elasticsearch_tpu.mapper.core import MapperService

    settings = Settings.from_flat(flat or {})
    return Engine(str(path), MapperService(settings), settings=settings)


def _port_engine(path, flat=None):
    settings = TSettings.from_flat(flat or {})
    return TEngine(str(path), TMapperService(settings), settings=settings)


def _src(rng, i):
    return {"title": " ".join(rng.choice(WORDS, 2)),
            "body": " ".join(rng.choice(WORDS, int(rng.integers(2, 25)))),
            "n": int(i), "score": float(rng.random()), "ok": bool(i % 2)}


def _ops(seed: int, rounds: int = 9) -> list[tuple]:
    """Rounds of indexing with overwrites, deletes and an external version,
    each closed by a refresh; a flush and a maybe_merge now and then, and
    one optimize (a force-merge down to one segment) midway."""
    rng = np.random.default_rng(seed)
    ops, next_id = [], 0
    for r in range(rounds):
        for _ in range(int(rng.integers(6, 14))):
            ops.append(("index", str(next_id), _src(rng, next_id)))
            next_id += 1
        for _ in range(3):
            ops.append(("index", str(int(rng.integers(0, next_id))), _src(rng, r)))
        for _ in range(int(rng.integers(1, 4))):
            ops.append(("delete", str(int(rng.integers(0, next_id)))))
        ops.append(("external", str(int(rng.integers(0, next_id))), 1000 + r))
        ops.append(("refresh",))
        if r % 3 == 1:
            ops.append(("flush",))
        if r % 2 == 1:
            ops.append(("merge",))
        if r == rounds // 2:
            ops.append(("optimize",))
    return ops


def _apply(engine, op):
    try:
        if op[0] == "index":
            return engine.index("doc", op[1], op[2])
        if op[0] == "external":
            return engine.index("doc", op[1], {"body": "ext"}, version=op[2],
                                version_type="external")
        if op[0] == "versioned":
            return engine.index("doc", op[1], {"body": "w4"}, version=op[2])
        if op[0] == "create":
            return engine.index("doc", op[1], {"body": "w5"}, op_type="create")
        if op[0] == "delete":
            return engine.delete("doc", op[1])
        if op[0] == "refresh":
            return engine.refresh()
        if op[0] == "flush":
            return engine.flush()
        if op[0] == "optimize":
            return engine.optimize()
        return engine.maybe_merge()
    except Exception as e:  # noqa: BLE001 — the same ops must fail alike
        return type(e).__name__


def _segments(engine):
    return [(s.gen, s.doc_count, s.live.tolist(), list(s.ids),
             np.asarray(s.versions).tolist())
            for s in engine.acquire_searcher().segments]


def _gets(engine, ids):
    return [(g.found, g.version, g.source)
            for g in (engine.get("doc", i) for i in ids)]


def _arrays_equal(ts, js):
    assert ts.term_dict == js.term_dict
    for name in ("post_offsets", "post_docs", "post_freqs", "pos_offsets",
                 "positions", "live", "versions"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name), err_msg=name)
    assert ts.norms.keys() == js.norms.keys()
    for f in ts.norms:
        np.testing.assert_array_equal(ts.norms[f], js.norms[f], err_msg=f)
    assert {f: dataclasses.astuple(s) for f, s in ts.field_stats.items()} == \
        {f: (s.doc_count, s.sum_ttf, s.sum_dfs) for f, s in js.field_stats.items()}
    assert ts.dv_num.keys() == js.dv_num.keys()
    for f, (off, vals) in ts.dv_num.items():
        np.testing.assert_array_equal(off, js.dv_num[f][0])
        np.testing.assert_array_equal(vals, js.dv_num[f][1])
    assert ts.stored == js.stored and ts.routings == js.routings
    assert ts.estimated_bytes() == js.estimated_bytes()


@pytest.mark.parametrize("seed", [3, 11])
def test_op_sequence_gives_the_jax_engines_segments(tmp_path, seed):
    ops = _ops(seed)
    je = _jax_engine(tmp_path / "jax", MERGE_SETTINGS)
    te = _port_engine(tmp_path / "port", MERGE_SETTINGS)
    try:
        ids = sorted({op[1] for op in ops if len(op) > 1}, key=int)
        for op in ops:
            assert _apply(te, op) == _apply(je, op), op
            if op[0] in ("refresh", "flush", "merge", "optimize"):
                assert _segments(te) == _segments(je), op
                assert _gets(te, ids) == _gets(je, ids), op
            if op[0] == "optimize":
                assert len(_segments(te)) == 1
        tsegs, jsegs = (e.acquire_searcher().segments for e in (te, je))
        assert len(tsegs) == len(jsegs) >= 2
        for ts, js in zip(tsegs, jsegs):
            _arrays_equal(ts, js)
        assert te.segment_count() == je.segment_count()
        # maybe_merge ran: a segment gen beyond the refreshes' own
        assert any(s.gen > sum(op[0] == "refresh" for op in ops) for s in jsegs)
    finally:
        te.close()
        je.close()


def test_realtime_get_versions_and_conflicts_match(tmp_path):
    je, te = _jax_engine(tmp_path / "jax"), _port_engine(tmp_path / "port")
    try:
        steps = [("index", "a", {"body": "w1"}), ("index", "a", {"body": "w2"}),
                 ("external", "b", 7), ("external", "b", 5), ("delete", "a"),
                 ("delete", "zz"), ("index", "a", {"body": "w3"}), ("refresh",),
                 ("external", "b", 9), ("delete", "b"), ("versioned", "a", 2),
                 ("versioned", "a", 1), ("create", "a"), ("create", "b"),
                 ("refresh",)]
        outcomes = []
        for op in steps:
            outcomes.append(_apply(te, op))
            assert outcomes[-1] == _apply(je, op), op
            assert _gets(te, ["a", "b", "zz"]) == _gets(je, ["a", "b", "zz"]), op
        assert outcomes[3] == outcomes[10] == "VersionConflictError"
        assert outcomes[12] == "DocumentAlreadyExistsError"
    finally:
        te.close()
        je.close()


def _write_ops(engine):
    engine.index("doc", "1", {"body": "w1 w2", "n": 1})
    engine.index("doc", "2", {"body": "w3"}, routing="r7")
    engine.index("doc", "1", {"body": "w4 ünïcode"})
    engine.delete("doc", "2")
    engine.index("doc", "3", {"body": "w5"}, version=42, version_type="external")
    engine.translog.sync()


def _op_tuple(op):
    return (op.op, op.type, op.id, op.source, op.routing, op.version, op.query,
            op.parent, op.timestamp, op.ttl)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_translog_files_read_back_across_packages(tmp_path, writer):
    from elasticsearch_tpu.index.translog import Translog as JTranslog

    engine = (_port_engine if writer == "port" else _jax_engine)(tmp_path)
    try:
        _write_ops(engine)
        own = [_op_tuple(op) for op in engine.translog.read_ops()]
    finally:
        engine.close()
    reader = (JTranslog if writer == "port" else TTranslog)(str(tmp_path / "translog"))
    try:
        assert [_op_tuple(op) for op in reader.read_ops()] == own
        assert len(own) == 5 and own[1][4] == "r7" and own[4][5] == 42
    finally:
        reader.close()


def _port_hits(engine, queries, k=10):
    svc = engine.mapper_service
    ctx = ShardContext(engine.acquire_searcher(), svc,
                       SimilarityService(svc.settings, svc), device="cpu")
    return [(r.total, r.hits) for r in
            search_shard_batch(ctx, [parse_query(q) for q in queries], k)]


def _jax_hits(engine, queries, k=10):
    from elasticsearch_tpu.search import ShardContext as JShardContext
    from elasticsearch_tpu.search import parse_query as jparse
    from elasticsearch_tpu.search.execute import search_shard_batch as jsearch
    from elasticsearch_tpu.search.similarity import SimilarityService as JSim

    svc = engine.mapper_service
    ctx = JShardContext(engine.acquire_searcher(), svc, JSim(svc.settings, mapper_service=svc))
    return [(r.total, r.hits) for r in
            jsearch(ctx, [jparse(q) for q in queries], k, use_device=True)]


RECOVERY_QUERIES = [{"match": {"body": "w9"}}, {"match": {"body": "w1 w2 w3"}},
                    {"term": {"body": "w7"}}]


def test_recover_from_store_replays_the_translog_only_ops(tmp_path):
    rng = np.random.default_rng(5)
    docs = [(str(i), {"body": " ".join(rng.choice(WORDS[:8], 6))}) for i in range(30)]
    engines = {}
    for name, make in (("port", _port_engine), ("jax", _jax_engine)):
        e = make(tmp_path / name)
        for doc_id, src in docs:
            e.index("doc", doc_id, src)
        e.refresh()
        e.flush()
        e.index("doc", "late", {"body": "w9 w9 w1"})  # translog only
        e.delete("doc", "4")                            # translog only
        e.translog.sync()
        e.close()
        fresh = make(tmp_path / name)
        assert fresh.recover_from_store() == 2
        engines[name] = fresh
    te, je = engines["port"], engines["jax"]
    try:
        hits = _port_hits(te, RECOVERY_QUERIES)
        assert hits == _jax_hits(je, RECOVERY_QUERIES)
        late = te.acquire_searcher()
        seg, local = late.resolve(hits[0][1][0][1])
        assert seg.ids[local] == "late" and hits[0][0] == 1
        assert te.get("doc", "late").found and not te.get("doc", "4").found
        assert _segments(te) == _segments(je)
    finally:
        te.close()
        je.close()


def _naive_with_deletes(self, locals_to_delete):
    """The JAX package's `with_deletes`, line for line: it copies only the
    `"packed"` entry, which the port never uses, so the port's
    `("packed", device)` pack stays SHARED between the two views."""
    new = dataclasses.replace(self, live=self.live.copy(),
                              _device_cache=dict(self._device_cache))
    new._device_cache.pop("pack_future", None)
    new._device_cache.pop("pack_hint", None)
    for local in locals_to_delete:
        new.delete_doc(local)
    packed = new._device_cache.get("packed")
    if packed is not None:
        new._device_cache["packed"] = dataclasses.replace(packed)
        new._device_cache.pop("live", None)
    return new


PIT_QUERIES = [{"match": {"body": "w1 w2"}}, {"term": {"body": "w3"}}]


@pytest.mark.parametrize("with_deletes", ["repaired", "naive"])
def test_older_searcher_keeps_its_point_in_time_view(tmp_path, monkeypatch,
                                                     with_deletes):
    if with_deletes == "naive":
        monkeypatch.setattr(tsegment.FrozenSegment, "with_deletes",
                            _naive_with_deletes)
    rng = np.random.default_rng(9)
    docs = [(str(i), {"body": " ".join(rng.choice(WORDS[:6], 5))}) for i in range(40)]
    te, je = _port_engine(tmp_path / "port"), _jax_engine(tmp_path / "jax")
    try:
        for e in (te, je):
            for doc_id, src in docs:
                e.index("doc", doc_id, src)
            e.refresh()
        old_t, old_j = te.acquire_searcher(), je.acquire_searcher()
        before = _port_hits(te, PIT_QUERIES)
        assert before == _jax_hits(je, PIT_QUERIES)
        # the pack the old view's dispatch resolved
        old_seg = old_t.segments[0]
        held = packed_for(old_seg, CPU)
        held_docs, held_gen = held.blk_docs.clone(), held.live_gen
        seg, local = old_t.resolve(before[0][1][0][1])
        victim = seg.ids[local]
        for e in (te, je):
            e.delete("doc", victim)
            e.refresh()
        after = _port_hits(te, PIT_QUERIES)  # re-masks the new view's pack
        assert after == _jax_hits(je, PIT_QUERIES)
        assert after[0][0] == before[0][0] - 1
        new_seg = te.acquire_searcher().segments[0]
        shared = new_seg._device_cache[pack_cache_key(CPU)] is held
        if with_deletes == "naive":
            # the fault: the delete re-masked the pack the old view resolved
            assert shared and held.live_gen != held_gen
            assert not torch.equal(held.blk_docs, held_docs)
        else:
            assert not shared and held.live_gen == held_gen
            assert torch.equal(held.blk_docs, held_docs)
        # the old searcher still answers as of its acquisition, as the JAX
        # engine's old searcher does
        from elasticsearch_tpu.search import ShardContext as JShardContext
        from elasticsearch_tpu.search import parse_query as jparse
        from elasticsearch_tpu.search.execute import search_shard_batch as jsearch
        from elasticsearch_tpu.search.similarity import SimilarityService as JSim

        svc = te.mapper_service
        old_ctx = ShardContext(old_t, svc, SimilarityService(svc.settings, svc),
                               device="cpu")
        jsvc = je.mapper_service
        jold = JShardContext(old_j, jsvc, JSim(jsvc.settings, mapper_service=jsvc))
        old_hits = [(r.total, r.hits) for r in search_shard_batch(
            old_ctx, [parse_query(q) for q in PIT_QUERIES], 10)]
        assert old_hits == before == [(r.total, r.hits) for r in jsearch(
            jold, [jparse(q) for q in PIT_QUERIES], 10, use_device=True)]
    finally:
        te.close()
        je.close()
