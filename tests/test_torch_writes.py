"""The port's write path on the device against the JAX package's: the pack
ledger, the claimable pack futures, the compaction concat, the off-lock
merge and a port node that writes while it searches (the cases of
tests/test_writes.py and the ledger cases of tests/test_device_ledger.py).

- Concat: the same documents go through both packages' SegmentBuilder and
  merge_segments; the port's `pack_segment_concat` must equal the JAX
  package's on the real block rows (sentinels normalised: the JAX doc
  bucket may come from its ladder) and the port's own
  `pack_segment(merged)` in every field, bitwise. Both return None in the
  same ineligible cases. Tolerance: none.
- Coordination: a search waits only for a pack that is running, steals one
  that has not started, never packs twice; a cache hit takes no lock, so a
  running pack on one segment does not block a hit on another, and no
  upload runs under the pack lock.
- A port node (`node.device: cpu`): once a shard has served a search, every
  refresh, tombstone view and merge packs on the warmer or merge pool
  (PACK_LEDGER's pools), a compaction concatenates, and hits stay bitwise
  those of a cold monolithic repack."""

import threading
import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.jaxenv import compile_tag
from elasticsearch_tpu_torch.common.settings import Settings as TSettings
from elasticsearch_tpu_torch.index import engine as engine_mod
from elasticsearch_tpu_torch.index.engine import Engine as TEngine
from elasticsearch_tpu_torch.index.segment import SegmentBuilder, merge_segments
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.ops import device_index as di
from elasticsearch_tpu_torch.ops.device_index import (
    BLOCK,
    PACK_LEDGER,
    PackLedger,
    begin_warm,
    cancel_warm,
    concat_estimate_bytes,
    concat_source_packs,
    ensure_blk_freqs,
    ensure_sim_tables,
    pack_cache_key,
    pack_future_keys,
    pack_segment,
    pack_segment_concat,
    pack_shape_math,
    packed_for,
    run_warm,
    tf_plane_itemsize,
)
from elasticsearch_tpu_torch.search import (
    ShardContext, SimilarityService, parse_query, search_shard)
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# segments through both packages
# ---------------------------------------------------------------------------


def _docs(gen: int, n: int, off: int = 0, seed: int = 0, big_tf: bool = False):
    """The JAX test's generator: `n` docs of 2-9 words over w0-w24 (with
    300 more `w0` under `big_tf`: the i16 rung), a tag and a number."""
    rng = np.random.default_rng(seed + gen)
    out = []
    for i in range(n):
        words = " ".join(f"w{int(rng.integers(0, 25))}"
                         for _ in range(int(rng.integers(2, 10))))
        if big_tf:
            words += " w0" * 300
        out.append((str(i + off), {"body": words, "tag": f"t{(i + off) % 3}",
                                   "n": i + off}))
    return out


def _port_seg(gen, docs, frac_tf=False):
    svc = TMapperService()
    b = SegmentBuilder(gen)
    for doc_id, src in docs:
        b.add(svc.mapper_for("doc").parse(src, doc_id), version=1)
    seg = b.freeze()
    if frac_tf:
        seg.post_freqs = seg.post_freqs + np.float32(0.5)
    return seg


def _jax_seg(gen, docs, frac_tf=False):
    from elasticsearch_tpu.common.settings import Settings
    from elasticsearch_tpu.index.segment import SegmentBuilder as JBuilder
    from elasticsearch_tpu.mapper import MapperService

    svc = MapperService(Settings.EMPTY)
    b = JBuilder(gen)
    for doc_id, src in docs:
        b.add(svc.mapper_for("doc").parse(src, doc_id), version=1)
    seg = b.freeze()
    if frac_tf:
        seg.post_freqs = seg.post_freqs + np.float32(0.5)
    return seg


def _pair(gen, docs, frac_tf=False):
    return _port_seg(gen, docs, frac_tf), _jax_seg(gen, docs, frac_tf)


def _tpack_live(seg):
    seg._device_cache[pack_cache_key(CPU)] = pack_segment(seg, CPU)
    return seg._device_cache[pack_cache_key(CPU)]


def _jpack_live(seg):
    from elasticsearch_tpu.ops.device_index import pack_segment as jpack

    with compile_tag("pack"):
        seg._device_cache["packed"] = jpack(seg)
    seg._device_cache["live"] = True
    return seg._device_cache["packed"]


def _jmerge(sources, gen):
    from elasticsearch_tpu.index.segment import merge_segments as jmerge

    return jmerge(sources, gen)


def _jconcat(merged, sources):
    from elasticsearch_tpu.ops.device_index import pack_segment_concat as jconcat

    with compile_tag("compact"):
        return jconcat(merged, sources)


def _tensor_bytes(t: torch.Tensor) -> tuple:
    return t.dtype, tuple(t.shape), t.numpy().tobytes()


def assert_packs_equal(got, want):
    """Field by field, bitwise: what pack_segment makes, the concat makes."""
    for name in ("gen", "doc_count", "doc_pad", "tf_layout", "tf_integral",
                 "live_gen"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("blk_docs", "blk_tf", "blk_nb", "live_parent"):
        assert _tensor_bytes(getattr(got, name)) == _tensor_bytes(getattr(want, name)), name
    assert got.norm_bytes.keys() == want.norm_bytes.keys()
    for f in want.norm_bytes:
        assert _tensor_bytes(got.norm_bytes[f]) == _tensor_bytes(want.norm_bytes[f]), f
    for name in ("term_blk_start", "host_docs", "host_freqs"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _sentinel(docs, doc_pad):
    return np.where(docs >= doc_pad, -1, docs)


def assert_matches_jax(got, jgot):
    """The port's concat against the JAX package's, on the real block rows."""
    NB = int(jgot.term_blk_start[-1])
    assert np.array_equal(got.term_blk_start, jgot.term_blk_start)
    assert got.tf_layout == jgot.tf_layout
    assert np.array_equal(_sentinel(got.blk_docs.numpy()[:NB], got.doc_pad),
                          _sentinel(np.asarray(jgot.blk_docs)[:NB], jgot.doc_pad))
    for plane in ("blk_tf", "blk_nb"):
        t, j = getattr(got, plane).numpy()[:NB], np.asarray(getattr(jgot, plane))[:NB]
        assert t.dtype == j.dtype and t.tobytes() == j.tobytes(), plane
    n = NB * BLOCK
    assert np.array_equal(_sentinel(got.host_docs[:n], got.doc_pad),
                          _sentinel(jgot.host_docs[:n], jgot.doc_pad))
    assert got.host_freqs[:n].tobytes() == jgot.host_freqs[:n].tobytes()
    d = got.doc_count
    assert np.array_equal(got.live_parent.numpy()[:d], np.asarray(jgot.live_parent)[:d])
    for f, col in jgot.norm_bytes.items():
        assert np.array_equal(got.norm_bytes[f].numpy()[:d], np.asarray(col)[:d]), f


# ---------------------------------------------------------------------------
# the pack ledger
# ---------------------------------------------------------------------------


class TestPackLedgerKinds:
    def test_kind_counters_and_pool_rows(self):
        led = PackLedger()
        led.record("i", 1, 1.0, 10, "u8", kind="pack", pool="search")
        led.record("i", 2, 1.0, 10, "u8", kind="delta_pack", pool="warmer")
        led.record("i", 3, 1.0, 10, "u8", kind="remask", pool="warmer")
        led.record("i", 4, 1.0, 30, "u8", kind="compact", pool="merge",
                   method="concat")
        st = led.stats("i")
        assert st["packs"] == 1 and st["delta_packs"] == 1
        assert st["remasks"] == 1 and st["compacts"] == 1
        assert st["pools"] == {"search": 1, "warmer": 2, "merge": 1}
        assert [e["kind"] for e in st["recent"]] == list(di.PACK_KINDS)
        assert st["recent"][-1]["method"] == "concat"

    def test_pool_defaults_to_thread_name(self):
        led = PackLedger()
        led.record("i", 1, 1.0, 10, "u8")  # the test's main thread
        assert led.stats("i")["pools"] == {"other": 1}
        out = {}

        def work():
            led.record("i", 2, 1.0, 10, "u8", kind="delta_pack")
            out["pools"] = led.stats("i")["pools"]

        t = threading.Thread(target=work, name="estpu_torch[warmer]_0")
        t.start()
        t.join(5)
        assert out["pools"] == {"other": 1, "warmer": 1}


class TestPackLedger:
    def test_record_and_stats(self):
        led = PackLedger()
        led.record("idx", 3, 1.5, 1024, "u8")
        led.record("idx", 4, 0.5, 2048, "u8", kind="remask")
        st = led.stats("idx")
        assert st["packs"] == 1 and st["remasks"] == 1
        assert st["pack_ms_total"] == 2.0
        assert [e["kind"] for e in st["recent"]] == ["pack", "remask"]
        assert led.stats("other") == {}

    def test_bounds(self):
        led = PackLedger()
        for i in range(PackLedger.MAX_INDICES + 10):
            led.record(f"i{i}", 1, 0.1, 10, "u8")
        assert len(led.stats()) == PackLedger.MAX_INDICES
        assert "i0" not in led.stats()  # least recently used left
        for _ in range(PackLedger.RING + 5):
            led.record("ring", 1, 0.1, 10, "u8")
        assert len(led.stats("ring")["recent"]) == PackLedger.RING

    def test_forget(self):
        led = PackLedger()
        led.record("gone", 1, 0.1, 10, "u8")
        led.forget("gone")
        assert led.stats("gone") == {}

    def test_packed_for_attributes_owner(self):
        seg = _port_seg(1, _docs(1, 40))
        PACK_LEDGER.forget("owner-test")
        packed_for(seg, CPU, owner="owner-test")
        st = PACK_LEDGER.stats("owner-test")
        assert st["packs"] == 1 and st["pools"] == {"other": 1}
        assert st["recent"][0]["bytes"] == di.packed_resident_bytes(
            seg._device_cache[pack_cache_key(CPU)])
        assert st["recent"][0]["tf_layout"] == "u8"
        seg.delete_doc(3)
        packed_for(seg, CPU, owner="owner-test")  # the remask row
        st = PACK_LEDGER.stats("owner-test")
        assert st["remasks"] == 1 and st["recent"][-1]["kind"] == "remask"
        PACK_LEDGER.forget("owner-test")


# ---------------------------------------------------------------------------
# in-flight pack coordination
# ---------------------------------------------------------------------------


def _gated_pack(monkeypatch, only=None):
    """Patch pack_segment to wait for a gate (segments in `only`, or all).
    Returns (started, gate) events."""
    started, gate = threading.Event(), threading.Event()
    real = di.pack_segment

    def gated(seg, device):
        if only is None or seg in only:
            started.set()
            gate.wait(10)
        return real(seg, device)

    monkeypatch.setattr(di, "pack_segment", gated)
    return started, gate


class TestPackCoordination:
    def test_racing_search_waits_for_actively_running_pack(self, monkeypatch):
        """A search reaching a segment whose pack is running on another
        thread waits on the in-flight future and gets the same object:
        one pack runs."""
        seg = _port_seg(1, _docs(1, 20))
        started, gate = _gated_pack(monkeypatch)
        results = []
        owner = threading.Thread(target=lambda: results.append(packed_for(seg, CPU)))
        owner.start()
        assert started.wait(5)  # the owner claimed and is packing
        waiter = threading.Thread(target=lambda: results.append(packed_for(seg, CPU)))
        waiter.start()
        time.sleep(0.05)
        assert waiter.is_alive()  # waiting on the future, not packing
        gate.set()
        owner.join(10)
        waiter.join(10)
        assert len(results) == 2 and results[0] is results[1]

    def test_search_steals_unstarted_warm_pack(self):
        """A scheduled pack that has not started is claimed by the first
        search, which packs inline and resolves the shared future; the warm
        task then returns at once."""
        seg = _port_seg(1, _docs(1, 20))
        fut = begin_warm(seg, CPU)
        assert fut is not None
        assert begin_warm(seg, CPU) is None  # one in flight
        packed = packed_for(seg, CPU)  # steals the claim
        assert fut.done() and fut.result() is packed
        assert run_warm(seg, CPU, fut) is None  # late worker: nothing to do
        assert begin_warm(seg, CPU) is None  # resident and current

    def test_cancel_warm_unblocks_query_path(self):
        seg = _port_seg(1, _docs(1, 10))
        fut = begin_warm(seg, CPU)
        cancel_warm(seg, CPU, fut)  # the pool rejected the task
        assert fut.done() and fut.result() is None
        packed = packed_for(seg, CPU)  # packs inline, no wait
        assert packed is seg._device_cache[pack_cache_key(CPU)]

    def test_with_deletes_view_drops_stale_future(self):
        seg = _port_seg(1, _docs(1, 10))
        seg._device_cache["pack_hint"] = {"kind": "delta_pack"}
        fut = begin_warm(seg, CPU)
        view = seg.with_deletes([0])
        for key in (*pack_future_keys(CPU), "pack_hint"):
            assert key not in view._device_cache, key
        assert run_warm(seg, CPU, fut) is not None  # the old view's pack runs
        assert pack_future_keys(CPU)[0] not in seg._device_cache
        assert PACK_LEDGER.stats("_unattributed")["recent"][-1]["kind"] == "delta_pack"
        packed = packed_for(view, CPU)  # the view packs its own, masked
        assert int(packed.live_parent[0]) == 0

    def test_warm_failure_propagates_then_retries_inline(self, monkeypatch):
        seg = _port_seg(1, _docs(1, 10))
        fut = begin_warm(seg, CPU)

        def boom(*a, **k):
            raise RuntimeError("boom")

        monkeypatch.setattr(di, "pack_segment", boom)
        with pytest.raises(RuntimeError):
            run_warm(seg, CPU, fut)
        with pytest.raises(RuntimeError):
            fut.result()  # a waiter would have seen it
        monkeypatch.undo()
        packed = packed_for(seg, CPU)  # the marker was cleared: inline retry
        assert packed.doc_count == seg.doc_count

    def test_running_pack_does_not_block_a_hit_on_another_segment(self, monkeypatch):
        """The cache hit takes no lock: while one segment's pack runs (held
        at a gate), a search reaching a resident segment returns at once,
        and so do its dense plane and similarity tables. Before the repair
        every `packed_for` took the process-wide pack lock, which the
        running pack held, so the hit waited for the gate."""
        hot = _port_seg(1, _docs(1, 30))
        cold = _port_seg(2, _docs(2, 30, off=100))
        resident = packed_for(hot, CPU)
        started, gate = _gated_pack(monkeypatch, only=[cold])
        packer = threading.Thread(target=packed_for, args=(cold, CPU))
        packer.start()
        try:
            assert started.wait(5)
            done = {}

            def hit():
                done["packed"] = packed_for(hot, CPU)
                done["plane"] = ensure_blk_freqs(done["packed"])
                done["sim"] = ensure_sim_tables(
                    done["packed"], {"body": (di.TFN_BM25, np.ones(256, np.float32))})

            t = threading.Thread(target=hit)
            t.start()
            t.join(3)
            assert not t.is_alive(), "a cache hit waited for another segment's pack"
            assert done["packed"] is resident and done["plane"] is resident.blk_freqs
        finally:
            gate.set()
            packer.join(10)
        assert cold._device_cache[pack_cache_key(CPU)].doc_count == 30

    def test_no_upload_runs_under_the_pack_lock(self, monkeypatch):
        """Pack, remask, concat, dense plane and LUT swap: every upload
        happens with the pack lock free."""
        real = di.upload
        calls = []

        def checked(array, device):
            assert not di._PACK_LOCK.locked(), "an upload under the pack lock"
            calls.append(1)
            return real(array, device)

        monkeypatch.setattr(di, "upload", checked)
        a, b = _port_seg(1, _docs(1, 20)), _port_seg(2, _docs(2, 15, off=50))
        pa, pb = packed_for(a, CPU), packed_for(b, CPU)
        merged = merge_segments([a, b], 9)
        assert pack_segment_concat(merged, [a, b], CPU) is not None
        a.delete_doc(2)
        packed_for(a, CPU)  # remask
        ensure_blk_freqs(pa)
        ensure_sim_tables(pb, {"body": (di.TFN_BM25, np.ones(256, np.float32))})
        assert len(calls) > 10


# ---------------------------------------------------------------------------
# compaction concat
# ---------------------------------------------------------------------------


class TestConcatPack:
    def _parity(self, docs_by_source):
        pairs = [_pair(g, docs) for g, docs in enumerate(docs_by_source, start=1)]
        tsrc, jsrc = [p[0] for p in pairs], [p[1] for p in pairs]
        for s in tsrc:
            _tpack_live(s)
        for s in jsrc:
            _jpack_live(s)
        tm, jm = merge_segments(tsrc, 99), _jmerge(jsrc, 99)
        got = pack_segment_concat(tm, tsrc, CPU)
        jgot = _jconcat(jm, jsrc)
        assert got is not None and jgot is not None, "concat ineligible"
        assert_packs_equal(got, pack_segment(tm, CPU))
        assert_matches_jax(got, jgot)
        return got

    def test_bitwise_parity_three_sources(self):
        self._parity([_docs(1, 37), _docs(2, 21, off=100), _docs(3, 5, off=200)])

    def test_tf_rung_widening_u8_to_i16(self):
        got = self._parity([_docs(1, 10), _docs(2, 6, off=50, big_tf=True)])
        assert got.tf_layout == "i16"

    def test_estimate_exact_for_concat_layout(self):
        sources = [_port_seg(1, _docs(1, 30)), _port_seg(2, _docs(2, 12, off=100))]
        for s in sources:
            _tpack_live(s)
        merged = merge_segments(sources, 9)
        NBpad, Dpad, layout = pack_shape_math(merged)
        tf_b = tf_plane_itemsize(layout)
        W, T = len(sources), len(merged.post_offsets) - 1
        expect = (NBpad * BLOCK * ((4 + 4) + (4 + tf_b + 1) + 8)
                  + NBpad * 4 * 2 + (2 * W + 1) * T * 4 * 2 + Dpad * 2
                  + Dpad * len(merged.norms) + Dpad * 8 * len(merged.dv_num))
        assert concat_estimate_bytes(merged, sources) == expect

    def test_ineligible_tombstoned_source(self):
        (a, ja), (b, jb) = _pair(1, _docs(1, 20)), _pair(2, _docs(2, 10, off=50))
        for s in (a, b):
            _tpack_live(s)
        for s in (ja, jb):
            _jpack_live(s)
        a2, ja2 = a.with_deletes([3]), ja.with_deletes([3])
        packed_for(a2, CPU)  # even remasked and current: still ineligible
        ja2._device_cache["live"] = True
        assert concat_source_packs([a2, b], CPU) is None
        assert pack_segment_concat(merge_segments([a2, b], 9), [a2, b], CPU) is None
        assert _jconcat(_jmerge([ja2, jb], 9), [ja2, jb]) is None

    def test_ineligible_fractional_f32(self):
        (a, ja), (b, jb) = _pair(1, _docs(1, 12), frac_tf=True), _pair(2, _docs(2, 8, off=50))
        pa = _tpack_live(a)
        _tpack_live(b)
        for s in (ja, jb):
            _jpack_live(s)
        assert pa.tf_layout == "f32" and not pa.tf_integral
        assert not ja._device_cache["packed"].tf_integral
        assert concat_source_packs([a, b], CPU) is None
        from elasticsearch_tpu.ops.device_index import concat_source_packs as jsrc

        assert jsrc([ja, jb]) is None

    def test_ineligible_unpacked_or_stale_source(self):
        (a, ja), (b, jb) = _pair(1, _docs(1, 10)), _pair(2, _docs(2, 10, off=50))
        _tpack_live(a)
        _jpack_live(ja)  # b never packed
        assert concat_source_packs([a, b], CPU) is None
        from elasticsearch_tpu.ops.device_index import concat_source_packs as jsrc

        assert jsrc([ja, jb]) is None
        _tpack_live(b)
        _jpack_live(jb)
        assert concat_source_packs([a, b], CPU) is not None
        b.delete_doc(1)  # a remask pending: not current
        jb.delete_doc(1)
        assert concat_source_packs([a, b], CPU) is None
        assert jsrc([ja, jb]) is None
        assert concat_source_packs([a, b], torch.device("meta")) is None  # no pack there

    @pytest.mark.parametrize("case", ["dropped_docs", "layout_drift", "term_counts"])
    def test_ineligible_merged_segment(self, case):
        """A merged segment that does not hold the sources' postings in
        order: fewer docs, a tf layout the sources do not widen to, or
        per-term counts that disagree with its CSR."""
        a_docs, b_docs = _docs(1, 12), _docs(2, 9, off=50)
        other = {"dropped_docs": None,
                 "layout_drift": _docs(3, 9, off=50, big_tf=True),
                 "term_counts": _docs(4, 9, off=50, seed=7)}[case]
        (a, ja), (b, jb) = _pair(1, a_docs), _pair(2, b_docs)
        for s in (a, b):
            _tpack_live(s)
        for s in (ja, jb):
            _jpack_live(s)
        if other is None:
            tm, jm = merge_segments([a], 9), _jmerge([ja], 9)
        else:
            c, jc = _pair(3, other)
            tm, jm = merge_segments([a, c], 9), _jmerge([ja, jc], 9)
        assert pack_segment_concat(tm, [a, b], CPU) is None
        assert _jconcat(jm, [ja, jb]) is None

    def test_warm_compact_uses_concat_and_ledger_records_it(self, tmp_path):
        """A merge publish plants the compact hint; the warm pack takes the
        concat and the ledger shows kind compact, method concat; the pack
        equals a staged one."""
        settings = TSettings.from_flat({"index.merge.policy.segments_per_tier": 2})
        e = TEngine(str(tmp_path / "s"), TMapperService(settings), settings=settings)
        try:
            for i in range(12):
                e.index("doc", str(i), {"body": f"alpha w{i % 4} common"})
                if i % 3 == 2:
                    e.refresh()
            for seg in e.acquire_searcher().segments:
                packed_for(seg, CPU)
            e.maybe_merge(max_merges=1)
            merged = next(s for s in e.acquire_searcher().segments
                          if (s._device_cache.get("pack_hint") or {}).get("kind")
                          == "compact")
            sources = merged._device_cache["pack_hint"]["sources"]
            fut = begin_warm(merged, CPU)
            PACK_LEDGER.forget("cc-test")
            got = run_warm(merged, CPU, fut, owner="cc-test")
            st = PACK_LEDGER.stats("cc-test")
            assert st["compacts"] == 1 and st["recent"][-1]["method"] == "concat"
            assert "pack_hint" not in merged._device_cache  # refs dropped
            assert len(sources) >= 2
            assert_packs_equal(got, pack_segment(merged, CPU))
            PACK_LEDGER.forget("cc-test")
        finally:
            e.close()


# ---------------------------------------------------------------------------
# the off-lock merge and the incremental uid index
# ---------------------------------------------------------------------------


def _engine(tmp_path, flat=None):
    settings = TSettings.from_flat(flat or {})
    return TEngine(str(tmp_path / "s"), TMapperService(settings), settings=settings)


def _live_docs(searcher) -> int:
    return sum(s.live_count() for s in searcher.segments)


class TestMergeOffLock:
    def test_search_not_blocked_by_merge_compute(self, tmp_path, monkeypatch):
        e = _engine(tmp_path, {"index.merge.policy.segments_per_tier": 2})
        try:
            for i in range(10):
                e.index("doc", str(i), {"n": i, "body": f"alpha w{i % 3}"})
                e.refresh()
            real = engine_mod.merge_segments
            in_merge = threading.Event()

            def slow_merge(segments, gen):
                in_merge.set()
                time.sleep(0.8)
                return real(segments, gen)

            monkeypatch.setattr(engine_mod, "merge_segments", slow_merge)
            t = threading.Thread(target=lambda: e.maybe_merge(max_merges=1))
            t.start()
            assert in_merge.wait(5)
            t0 = time.monotonic()
            got = e._lock.acquire(timeout=0.3)
            waited = time.monotonic() - t0
            assert got, "engine lock held across the merge compute"
            e._lock.release()
            assert waited < 0.3
            assert _live_docs(e.acquire_searcher()) == 10  # the old view
            t.join(10)
            assert _live_docs(e.acquire_searcher()) == 10
        finally:
            e.close()

    def test_concurrent_tombstone_aborts_publish(self, tmp_path, monkeypatch):
        """A delete in a source segment mid-merge is not resurrected by the
        publish: the identity check aborts it."""
        e = _engine(tmp_path, {"index.merge.policy.segments_per_tier": 2})
        try:
            for i in range(8):
                e.index("doc", str(i), {"n": i, "body": "alpha"})
                e.refresh()
            real = engine_mod.merge_segments
            in_merge, release = threading.Event(), threading.Event()

            def gated_merge(segments, gen):
                in_merge.set()
                release.wait(5)
                return real(segments, gen)

            monkeypatch.setattr(engine_mod, "merge_segments", gated_merge)
            n_segments = e.segment_count()
            t = threading.Thread(target=lambda: e.maybe_merge(max_merges=1))
            t.start()
            assert in_merge.wait(5)
            e.delete("doc", "0")  # a tombstone inside the merge window
            e.refresh()
            release.set()
            t.join(10)
            assert e.segment_count() == n_segments  # the publish aborted
            assert not e.get("doc", "0").found
            assert _live_docs(e.acquire_searcher()) == 7
            monkeypatch.undo()
            e.maybe_merge(max_merges=10)  # plans again afterwards
            assert not e.get("doc", "0").found
            assert _live_docs(e.acquire_searcher()) == 7
        finally:
            e.close()

    def test_uid_index_incremental_matches_full_rebuild(self, tmp_path):
        e = _engine(tmp_path, {"index.merge.policy.segments_per_tier": 2})
        try:
            for i in range(20):
                e.index("doc", str(i), {"n": i})
                e.refresh()
            e.index("doc", "5", {"n": 500})  # an update: the old copy dies
            e.delete("doc", "7")
            e.refresh()
            e.maybe_merge(max_merges=20)
            rebuilt = {}
            for seg in e._segments:
                for local in range(seg.doc_count):
                    if seg.parent_mask[local] and seg.live[local]:
                        rebuilt[f"{seg.types[local]}#{seg.ids[local]}"] = (seg.gen, local)
            assert e._uid_index == rebuilt
            assert e.get("doc", "5").source["n"] == 500
            assert not e.get("doc", "7").found
        finally:
            e.close()


# ---------------------------------------------------------------------------
# a port node writing while it searches
# ---------------------------------------------------------------------------

WR = "wr"


@pytest.fixture
def boot(tmp_path):
    """boot(settings=None, index_settings=None, docs=40) -> (node, client,
    engine): a port node on the CPU, index `wr` (1 shard, explicit
    refreshes) holding `docs` docs. Every node booted is closed."""
    booted = []

    def _boot(settings=None, index_settings=None, docs=40):
        node = PNode(name=f"wr{len(booted)}", registry=PReg(),
                     data_path=str(tmp_path / f"n{len(booted)}"),
                     settings={"node.device": "cpu", **(settings or {})}).start()
        booted.append(node)
        c = node.client()
        c.create_index(WR, {"settings": {"number_of_shards": 1,
                                         "number_of_replicas": 0,
                                         "refresh_interval": -1,
                                         **(index_settings or {})}})
        assert c.cluster_health(WR, wait_for_status="green")["status"] == "green"
        for i in range(docs):
            c.index(WR, "doc", {"body": f"alpha beta{i % 4} w{i % 7}", "n": i,
                                "tag": f"t{i % 3}"}, id=str(i))
        c.refresh(WR)
        return node, c, node.indices.index_service(WR).shard(0).engine

    yield _boot
    for node in booted:
        node.close()


def _wait(predicate, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def _drained(node) -> bool:
    st = node.warmer.stats()
    return st["packs_done"] >= st["packs_scheduled"]


def _hits(c, q):
    r = c.search(WR, q)
    return r["hits"]["total"], [(h["_id"], h["_score"]) for h in r["hits"]["hits"]]


class TestLiveWrites:
    def test_warmed_loop_zero_query_path_packs(self, boot):
        """After the gate, every pack and remask of a continuous-indexing
        loop runs on the warmer or merge pool: none on the query path, and
        no hand warm-up (the loop waits for the warmer, as a refresh's
        caller would, and searches)."""
        node, c, engine = boot()
        q = {"query": {"match": {"body": "alpha"}}, "size": 5}
        assert c.search(WR, q)["hits"]["total"] == 40  # opens the gate
        assert engine.search_active
        PACK_LEDGER.forget(WR)  # the gate's inline packs are the only ones
        for rnd in range(3):
            for i in range(6):
                c.index(WR, "doc", {"body": f"alpha beta{i % 4} w{i % 7}", "n": i},
                        id=f"live{rnd}-{i}")
            c.index(WR, "doc", {"body": "alpha overwritten", "n": rnd}, id=str(rnd))
            c.refresh(WR)
            assert _wait(lambda: _drained(node)), node.warmer.stats()
            assert c.search(WR, q)["hits"]["total"] == 40 + 6 * (rnd + 1)
        st = PACK_LEDGER.stats(WR)
        assert st["delta_packs"] >= 3 and st["remasks"] >= 1, st
        assert set(st["pools"]) <= {"warmer", "merge"}, st["pools"]
        assert all(e["pool"] in ("warmer", "merge") for e in st["recent"])
        ws = node.warmer.stats()
        assert ws["packs_scheduled"] >= 6 and ws["pack_failures"] == 0, ws

    def test_base_delta_bitwise_identical_to_cold_monolithic_repack(self, boot):
        """Hits over base and delta segments are bitwise those of the
        optimized index, packed by the concat and again cold, staged."""
        node, c, engine = boot()
        q = {"query": {"match": {"body": "alpha beta1"}}, "size": 20}
        c.search(WR, q)
        for rnd in range(2):
            for i in range(7):
                c.index(WR, "doc", {"body": f"alpha beta{i % 4} w{i % 7}",
                                    "n": 100 + i}, id=f"d{rnd}-{i}")
            c.refresh(WR)
        assert engine.segment_count() >= 3
        assert _wait(lambda: _drained(node))
        before = _hits(c, q)
        assert before[1]
        PACK_LEDGER.forget(WR)
        c.optimize(WR)
        assert _wait(lambda: _drained(node))
        seg, = engine.acquire_searcher().segments
        st = PACK_LEDGER.stats(WR)
        assert st["compacts"] == 1 and st["recent"][-1]["method"] == "concat", st
        assert _hits(c, q) == before  # over the concatenated pack
        for key in ("pack_hint", pack_cache_key(CPU), *pack_future_keys(CPU)):
            seg._device_cache.pop(key, None)  # force a cold staged repack
        assert _hits(c, q) == before  # ids, order and float32 scores

    def test_failed_warm_pack_is_counted_then_retried_inline(self, boot):
        """Out of fielddata budget during a delta pack: the warm pack fails
        and is counted; with the budget back, the next search packs the
        segment inline."""
        node, c, engine = boot()
        q = {"query": {"match": {"body": "alpha"}}, "size": 5}
        assert c.search(WR, q)["hits"]["total"] == 40
        fd = node.breakers.breaker("fielddata")
        limit = fd.limit
        fd.limit = 1  # every pack estimate trips
        try:
            c.index(WR, "doc", {"body": "alpha fresh", "n": 1}, id="t1")
            c.refresh(WR)
            assert _wait(lambda: node.warmer.stats()["pack_failures"] >= 1)
        finally:
            fd.limit = limit
        PACK_LEDGER.forget(WR)
        assert c.search(WR, q)["hits"]["total"] == 41
        pools = PACK_LEDGER.stats(WR)["pools"]  # the query path: a search
        assert sum(pools.values()) == 1 and set(pools) <= {"search", "search_batcher"}

    def test_compaction_publish_mid_search_serves_old_view(self, boot, monkeypatch):
        """A search during a long merge answers without waiting for it, the
        view acquired before keeps serving, and the compaction packs on the
        merge pool by device concat."""
        node, c, engine = boot(index_settings={
            "index.merge.policy.segments_per_tier": 2})
        q = {"query": {"match": {"body": "alpha"}}, "size": 5}
        c.search(WR, q)
        for rnd in range(3):
            for i in range(6):
                c.index(WR, "doc", {"body": f"alpha w{i % 3}", "n": i},
                        id=f"m{rnd}-{i}")
            c.refresh(WR)
            c.search(WR, q)
        assert _wait(lambda: _drained(node))
        total = 40 + 18
        real = engine_mod.merge_segments
        in_merge = threading.Event()

        def slow_merge(segments, gen):
            in_merge.set()
            time.sleep(1.0)
            return real(segments, gen)

        monkeypatch.setattr(engine_mod, "merge_segments", slow_merge)
        old = engine.acquire_searcher()
        PACK_LEDGER.forget(WR)
        t = threading.Thread(target=lambda: engine.maybe_merge(max_merges=1))
        t.start()
        try:
            assert in_merge.wait(5)
            t0 = time.monotonic()
            assert c.search(WR, q)["hits"]["total"] == total
            waited = time.monotonic() - t0
            assert waited < 0.9, f"the search waited {waited} s on the merge"
            assert _live_docs(old) == total
        finally:
            t.join(15)
        monkeypatch.undo()
        assert _wait(lambda: PACK_LEDGER.stats(WR).get("compacts", 0) >= 1)
        assert c.search(WR, q)["hits"]["total"] == total
        compact = [e for e in PACK_LEDGER.stats(WR)["recent"] if e["kind"] == "compact"]
        assert compact[-1]["pool"] == "merge" and compact[-1]["method"] == "concat"

    def test_recovery_replays_onto_delta_aware_packs(self, tmp_path):
        """Store recovery rebuilds segments and serves; then fresh writes
        carry the delta hint again."""
        e = _engine(tmp_path)
        svc = e.mapper_service
        for rnd in range(3):
            for i in range(5):
                e.index("doc", f"{rnd}-{i}", {"body": f"alpha w{i}", "n": i})
            e.refresh()
        e.flush()
        e.translog.sync()
        e.close()
        e2 = TEngine(str(tmp_path / "s"), svc, settings=TSettings.EMPTY)
        try:
            e2.recover_from_store()
            e2.refresh()
            ctx = ShardContext(e2.acquire_searcher(), svc,
                               SimilarityService(TSettings.EMPTY, svc), device="cpu")
            assert search_shard(ctx, parse_query({"match": {"body": "alpha"}}), 30).total == 15
            e2.index("doc", "new", {"body": "alpha", "n": 9})
            e2.refresh()
            segs = e2.acquire_searcher().segments
            assert segs[-1]._device_cache.get("pack_hint", {}).get("kind") == "delta_pack"
        finally:
            e2.close()

    def test_warmer_setting_keeps_pack_warming(self, boot):
        """`indices.warmer.enabled: false` switches the re-prime off in the
        JAX package and leaves pack warming on: the port reads it the same
        way (it has no re-prime yet)."""
        node, c, engine = boot(settings={"indices.warmer.enabled": "false"})
        c.search(WR, {"query": {"match": {"body": "alpha"}}})
        c.index(WR, "doc", {"body": "alpha", "n": 1}, id="x")
        c.refresh(WR)
        assert _wait(lambda: node.warmer.stats()["packs_done"] >= 1)
        assert node.warmer.stats()["enabled"] is False

    def test_write_only_shard_never_packs(self, boot):
        """The gate: a shard that has not served a search packs nothing on
        refresh."""
        node, c, engine = boot()
        c.index(WR, "doc", {"body": "alpha", "n": 1}, id="x")
        c.refresh(WR)
        assert not engine.search_active
        assert node.warmer.stats()["packs_scheduled"] == 0
        assert all(pack_cache_key(CPU) not in s._device_cache
                   for s in engine.acquire_searcher().segments)


# ---------------------------------------------------------------------------
# the merge policy's settings
# ---------------------------------------------------------------------------


class _SizedSegment:
    """What the merge policy reads of a segment: its size, docs and live
    docs."""

    def __init__(self, nbytes: int, docs: int, live: int):
        self.nbytes, self.doc_count, self.live = nbytes, docs, live

    def estimated_bytes(self) -> int:
        return self.nbytes

    def live_count(self) -> int:
        return self.live


@pytest.mark.parametrize("flat", [
    {},
    {"index.merge.policy.max_merged_segment_bytes": 3 * 1024 ** 2},
    {"index.merge.policy.floor_segment_bytes": 64 * 1024,
     "index.merge.policy.segments_per_tier": 4},
    {"index.merge.policy.expunge_deletes_allowed": 30,
     "index.merge.policy.segments_per_tier": 50},
    {"index.merge.policy.expunge_deletes_allowed": 5,
     "index.merge.policy.segments_per_tier": 50,
     "index.merge.policy.floor_segment_bytes": 1024},
], ids=["defaults", "max_merged", "floor", "expunge_30", "expunge_5"])
def test_merge_policy_settings_choose_the_jax_merge(flat):
    """The port reads max_merged_segment_bytes, floor_segment_bytes and
    expunge_deletes_allowed (a percent) as the JAX package does: the same
    merge for the same segment lists, step by step."""
    from elasticsearch_tpu.common.settings import Settings as JSettings
    from elasticsearch_tpu.index.merge_policy import TieredMergePolicy as JPolicy
    from elasticsearch_tpu_torch.index.merge_policy import TieredMergePolicy

    port = TieredMergePolicy(TSettings.from_flat(flat))
    jax = JPolicy(JSettings.from_flat(flat))
    rng = np.random.default_rng(5)
    for trial in range(20):
        n = int(rng.integers(2, 30))
        segs = []
        for _ in range(n):
            docs = int(rng.integers(1, 5000))
            segs.append(_SizedSegment(int(rng.integers(1, 4 * 1024 ** 2)), docs,
                                      docs - int(rng.integers(0, docs // 2 + 1))))
        for _ in range(n):  # plan, merge the window, plan again
            p, j = port.find_merge(segs), jax.find_merge(segs)
            assert (p and (p.start, p.end)) == (j and (j.start, j.end)), (trial, flat)
            if p is None:
                break
            window = segs[p.start:p.end]
            segs[p.start:p.end] = [_SizedSegment(
                sum(s.nbytes * s.live // max(s.doc_count, 1) for s in window),
                sum(s.live for s in window), sum(s.live for s in window))]
