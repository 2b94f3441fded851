"""The port's cross-request DeviceBatcher (elasticsearch_tpu_torch/search/
batcher.py) on the CPU: the invariants of tests/test_batcher.py — the flush
triad (full / linger / deadline-leaves-merge-budget), a lone request pays at
most the linger, fan-out matches per-request execution, shutdown serves
inline, a failing batch fails only the failing request, a pending merge is
not delayed by the next batch's linger — with the JAX test's timing margins;
plus concurrency against `search_shard_batch`, the per-batch staging
reservation on the request breaker, the enqueue/wait halves of the pull, the
merge wait recorded for overlapped merges and a device error that reaches
the caller with no host answer."""

import threading
import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.common import cudaenv
from elasticsearch_tpu_torch.common.breaker import CircuitBreakerService
from elasticsearch_tpu_torch.common.deadline import NO_DEADLINE, Deadline
from elasticsearch_tpu_torch.common.errors import CircuitBreakingError
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.index.engine import Searcher
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.mapper import MapperService
from elasticsearch_tpu_torch.search import (
    SERVING_COUNTERS, ShardContext, SimilarityService, execute_query_phase,
    parse_query, parse_search_body, search_shard_batch)
from elasticsearch_tpu_torch.search import execute as texecute
from elasticsearch_tpu_torch.search.batcher import DeviceBatcher, _Item, _k_bucket
from elasticsearch_tpu_torch.search.execute import execute_flat_batch, lower_flat

WORDS = ["quick", "brown", "fox", "lazy", "dog", "summer", "red", "bear",
         "snack", "cat"]


def _shard(n_docs=60, segments=2, settings=None):
    settings = Settings.from_flat(settings or {})
    svc = MapperService(settings)
    segs, per = [], (n_docs + segments - 1) // segments
    for g in range(segments):
        b = SegmentBuilder(g)
        for i in range(g * per, min(n_docs, (g + 1) * per)):
            text = f"{WORDS[i % 10]} {WORDS[(i + 1) % 10]} {WORDS[(i + 3) % 10]}"
            b.add(svc.mapper_for("doc").parse({"body": text}, str(i)))
        segs.append(b.freeze())
    return ShardContext(Searcher(segs), svc, SimilarityService(settings, svc),
                        device="cpu")


@pytest.fixture
def shard_ctx():
    return _shard()


def make_batcher(**flat):
    return DeviceBatcher(Settings.from_flat(
        {str(k): str(v) for k, v in flat.items()}))


def plan_for(ctx, text):
    plan = lower_flat(parse_query({"match": {"body": text}}), ctx)
    assert plan is not None
    return plan


def run_threads(fn, n):
    """fn(i) on n threads at once; returns (results, errors) per i."""
    out, errs = [None] * n, [None] * n

    def worker(i):
        try:
            out[i] = fn(i)
        except Exception as e:  # noqa: BLE001 — surfaced by the callers' asserts
            errs[i] = e

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    return out, errs


def run_concurrent(batcher, ctx, texts, k=10, deadline=None):
    """Submit one plan per text from its own thread; returns TopDocs per text."""
    plans = [plan_for(ctx, t) for t in texts]
    out, errs = run_threads(
        lambda i: batcher.execute(plans[i], ctx, k,
                                  deadline=deadline or NO_DEADLINE), len(plans))
    assert all(e is None for e in errs), errs
    return out


class TestFlushTriggers:
    def test_flush_on_full(self, shard_ctx):
        # linger far beyond the test horizon: only batch-full can flush
        b = make_batcher(**{"search.batch.linger_ms": 5000,
                            "search.batch.max_batch": 4})
        try:
            out = run_concurrent(b, shard_ctx, ["quick brown", "lazy dog",
                                                "red bear", "summer snack"])
            assert all(td is not None for td in out)
            st = b.stats()
            assert st["full_flushes"] >= 1, st
            assert st["coalesced"] == 4 and st["launches"] >= 1
        finally:
            b.shutdown()

    def test_flush_on_linger(self, shard_ctx):
        b = make_batcher(**{"search.batch.linger_ms": 40,
                            "search.batch.max_batch": 64})
        try:
            t0 = time.monotonic()
            out = run_concurrent(b, shard_ctx, ["quick brown", "lazy dog"])
            elapsed = time.monotonic() - t0
            assert all(td is not None for td in out)
            st = b.stats()
            assert st["linger_flushes"] >= 1, st
            # nothing else could flush a 2-item batch below max_batch=64
            assert st["full_flushes"] == 0 and st["deadline_flushes"] == 0
            assert elapsed < 20.0
        finally:
            b.shutdown()

    def test_flush_on_deadline_leaves_merge_budget(self, shard_ctx):
        warm_plan = plan_for(shard_ctx, "quick brown")
        execute_flat_batch([warm_plan], shard_ctx, _k_bucket(10))
        # linger 10s: only the deadline flush can release the batch
        b = make_batcher(**{"search.batch.linger_ms": 10_000,
                            "search.batch.max_batch": 64})
        try:
            budget_s = 0.4
            t0 = time.monotonic()
            td = b.execute(warm_plan, shard_ctx, 10,
                           deadline=Deadline.after(budget_s))
            elapsed = time.monotonic() - t0
            assert td.total > 0
            st = b.stats()
            assert st["deadline_flushes"] == 1, st
            # flushed at deadline - EWMA(batch service): the answer lands
            # before the budget expires, and the batch demonstrably waited
            assert elapsed < budget_s + 0.25, elapsed
            assert elapsed > 0.05, elapsed
        finally:
            b.shutdown()

    def test_lone_request_pays_at_most_linger(self, shard_ctx):
        plan = plan_for(shard_ctx, "quick brown")
        execute_flat_batch([plan], shard_ctx, _k_bucket(10))  # warm
        t0 = time.monotonic()
        direct = execute_flat_batch([plan], shard_ctx, 10)[0]
        direct_s = time.monotonic() - t0
        linger_s = 0.05
        b = make_batcher(**{"search.batch.linger_ms": linger_s * 1000})
        try:
            t0 = time.monotonic()
            td = b.execute(plan, shard_ctx, 10)
            batched_s = time.monotonic() - t0
            assert td.hits == direct.hits[:10]
            # a lone request pays at most the linger (plus scheduling slack)
            assert batched_s <= direct_s + linger_s + 0.5, (batched_s, direct_s)
        finally:
            b.shutdown()


class TestFanOut:
    def test_fanout_matches_per_request_ordering(self, shard_ctx):
        texts = ["quick brown", "lazy dog", "red bear", "summer snack",
                 "fox dog", "cat bear"]
        b = make_batcher(**{"search.batch.linger_ms": 60,
                            "search.batch.max_batch": 8})
        try:
            out = run_concurrent(b, shard_ctx, texts, k=10)
        finally:
            b.shutdown()
        for text, td in zip(texts, out):
            direct = execute_flat_batch([plan_for(shard_ctx, text)], shard_ctx, 10)[0]
            assert td.total == direct.total, text
            assert td.hits == direct.hits[:10], text
            assert (td.max_score == direct.max_score
                    or (td.max_score != td.max_score
                        and direct.max_score != direct.max_score)), text

    def test_post_shutdown_serves_inline(self, shard_ctx):
        b = make_batcher(**{"search.batch.linger_ms": 20})
        plan = plan_for(shard_ctx, "quick brown")
        assert b.execute(plan, shard_ctx, 5).total > 0
        b.shutdown()
        # a shut-down batcher must not strand searches — they serve directly
        assert b.execute(plan, shard_ctx, 5).total > 0
        assert b.stats()["bypassed"] >= 1

    def test_full_queue_serves_inline(self, shard_ctx):
        # a one-slot queue behind a long linger: the second concurrent
        # request finds it full and launches on its own thread
        b = make_batcher(**{"search.batch.linger_ms": 300,
                            "search.batch.queue_size": 1})
        try:
            out = run_concurrent(b, shard_ctx, ["quick brown", "lazy dog",
                                                "red bear"])
            assert all(td.total > 0 for td in out)
            assert b.stats()["bypassed"] >= 1, b.stats()
        finally:
            b.shutdown()


class _TrippingFamily:
    """Batch dispatch always trips the breaker; individually only the marked
    payload does — one oversized request coalesced with healthy ones."""

    name = "fake"

    def dispatch(self, items, kb):
        raise CircuitBreakingError(
            "[request] coalesced batch would exceed the limit")

    def fan_out(self, handle, items):  # pragma: no cover — dispatch raises
        raise AssertionError("unreachable")

    def execute_single(self, item):
        if item.payload == "oversized":
            err = CircuitBreakingError("[request] data would be larger than limit")
            err.breaker = "request"
            raise err
        return f"ok:{item.payload}"


class TestSplit:
    def test_trip_fails_only_the_oversized_request(self):
        b = make_batcher(**{"search.batch.linger_ms": 5000,
                            "search.batch.max_batch": 3})
        fam = _TrippingFamily()
        try:
            payloads = ["a", "oversized", "b"]
            out, errs = run_threads(
                lambda i: b._submit(_Item(fam, ("fake", "key"), payloads[i],
                                          10, 16, NO_DEADLINE)), 3)
            assert out[0] == "ok:a" and out[2] == "ok:b", (out, errs)
            assert isinstance(errs[1], CircuitBreakingError), errs
            assert errs[0] is None and errs[2] is None
            assert b.stats()["splits"] == 1
        finally:
            b.shutdown()


class TestPendingMergeFlush:
    def test_merge_not_delayed_by_next_batch_linger(self, shard_ctx):
        """With batch N dispatched and awaiting its merge, the collector
        flushes the queue at once (reason `pending`) instead of lingering
        for batch N+1. A giant linger (1.5 s, floor 1.2 s) makes the two
        behaviours unambiguous; the pending window depends on thread
        scheduling, so the attempt retries."""
        b = make_batcher(**{"search.batch.linger_ms": 1500,
                            "search.batch.min_linger_ms": 1200,
                            "search.batch.max_batch": 2})
        try:
            texts = ["quick brown", "lazy dog", "red bear"]
            ok = False
            for _attempt in range(3):
                t0 = time.monotonic()
                out = run_concurrent(b, shard_ctx, texts)
                elapsed = time.monotonic() - t0
                assert all(td is not None for td in out)
                if elapsed < 0.8 and b.stats()["pending_flushes"] >= 1:
                    ok = True
                    break
            assert ok, (elapsed, b.stats())
        finally:
            b.shutdown()


def _random_bodies(seed, n, sizes=(10, 100)):
    rng = np.random.default_rng(seed)
    bodies = []
    for i in range(n):
        terms = rng.choice(WORDS, int(rng.integers(1, 4)), replace=False)
        bodies.append({"query": {"bool": {"should": [
            {"term": {"body": str(t)}} for t in terms]}},
            "size": int(sizes[i % len(sizes)])})
    return bodies


def test_concurrent_callers_equal_search_shard_batch():
    """32 threads × 8 requests through one batcher: every response equals
    `search_shard_batch` of the same query at the same k."""
    ctx = _shard(n_docs=300, segments=3)
    ctx.batcher = make_batcher(**{"search.batch.linger_ms": 2,
                                  "search.batch.max_batch": 16})
    bodies = _random_bodies(11, 256)
    want = {}
    for size in (10, 100):
        idx = [i for i, b in enumerate(bodies) if b["size"] == size]
        for i, td in zip(idx, search_shard_batch(
                ctx, [parse_query(bodies[i]["query"]) for i in idx], size)):
            want[i] = (td.total, td.hits)

    def caller(t):
        return [execute_query_phase(ctx, parse_search_body(bodies[i]))
                for i in range(t * 8, t * 8 + 8)]

    try:
        out, errs = run_threads(caller, 32)
        assert all(e is None for e in errs), errs
        st = ctx.batcher.stats()
    finally:
        ctx.batcher.shutdown()
    got = {t * 8 + j: (r.total, [(s, d) for s, d, _ in r.docs])
           for t, rs in enumerate(out) for j, r in enumerate(rs)}
    assert got == want
    assert st["coalesced"] + st["bypassed"] == 256
    assert st["occupancy_mean"] > 1 and st["splits"] == 0, st


def test_staging_reserved_per_batch_and_drained(shard_ctx, monkeypatch):
    breakers = CircuitBreakerService(Settings.from_flat({}))
    shard_ctx.breakers = breakers
    plans = [plan_for(shard_ctx, t) for t in ("quick brown", "lazy dog")]
    seen = []
    real = texecute.launch_flat_sparse

    def spy(*args, breaker=None, **kw):
        seen.append(breaker)
        return real(*args, breaker=breaker, **kw)

    monkeypatch.setattr(texecute, "launch_flat_sparse", spy)
    execute_flat_batch(plans, shard_ctx, 10)
    monkeypatch.undo()
    assert seen and all(b is breakers.breaker("request") for b in seen)
    assert breakers.breaker("request").stats()["estimated"] == 0

    tiny = CircuitBreakerService(Settings.from_flat(
        {"indices.breaker.total_budget": "1kb"}))
    shard_ctx.breakers = tiny
    with pytest.raises(CircuitBreakingError) as err:
        execute_flat_batch(plans, shard_ctx, 10)
    assert err.value.breaker == "request"
    assert tiny.breaker("request").stats()["estimated"] == 0
    assert tiny.breaker("request").trip_count == 1


def test_pull_halves_equal_pull_on_cpu():
    rng = np.random.default_rng(3)
    tensors = [torch.from_numpy(rng.random((4, 5)).astype(np.float32)),
               torch.from_numpy(rng.integers(0, 9, 7).astype(np.int32))]
    pending = cudaenv.pull_async(tensors)
    for a, b in zip(pending.wait(), cudaenv.pull(tensors)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert cudaenv.pull_async([]).wait() == []


def test_merge_reads_the_pull_enqueued_at_dispatch(shard_ctx):
    """The dispatch half ends with the batch's copies enqueued (its handle
    holds them); the merge waits on them and stamps the wait's clocks."""
    plans = [plan_for(shard_ctx, t) for t in ("quick brown", "lazy dog")]
    pending = texecute.dispatch_flat_batch(plans, shard_ctx, 16)
    assert isinstance(pending.pull, cudaenv.PendingPull)
    assert pending.pull_t0 is None
    merged = pending.merge()
    assert pending.pull_t0 is not None and pending.pull_t1 >= pending.pull_t0
    assert [td.hits for td in merged] == [
        td.hits for td in execute_flat_batch(plans, shard_ctx, 16)]


def test_device_error_reaches_the_caller_without_a_host_answer(
        shard_ctx, monkeypatch):
    """A device error inside the dispatch half: the batcher replays each
    item on its own — on the device path again — and the error reaches
    every caller; execute_query_phase counts it and returns nothing."""
    calls = []

    def broken(plans, ctx, k):
        calls.append(len(plans))
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(texecute, "_dispatch_flat_plain", broken)
    shard_ctx.batcher = make_batcher(**{"search.batch.linger_ms": 200,
                                        "search.batch.max_batch": 2})
    before = SERVING_COUNTERS["device_errors"]
    bodies = [{"query": {"match": {"body": t}}} for t in ("quick", "lazy dog")]
    try:
        out, errs = run_threads(
            lambda i: execute_query_phase(shard_ctx, parse_search_body(bodies[i])), 2)
    finally:
        shard_ctx.batcher.shutdown()
    assert out == [None, None]
    assert all(isinstance(e, RuntimeError) and "illegal memory" in str(e)
               for e in errs), errs
    assert SERVING_COUNTERS["device_errors"] - before == 2
    # one coalesced attempt of both, then one device attempt per item
    assert sorted(calls) == [1, 1, 2], calls


def test_stats_shape(shard_ctx):
    b = make_batcher(**{"search.batch.linger_ms": 1})
    try:
        run_concurrent(b, shard_ctx, ["quick brown", "red bear"])
        st = b.stats()
    finally:
        b.shutdown()
    assert set(st) == {"launches", "coalesced", "occupancy_mean",
                       "full_flushes", "linger_flushes", "deadline_flushes",
                       "pending_flushes", "bypassed", "splits", "queue",
                       "ewma_batch_ms", "batch", "merge_wait"}
    assert st["launches"] >= 1 and st["batch"]["count"] == st["launches"]
    assert st["merge_wait"]["count"] <= st["launches"]


class _StampedFamily:
    """fan_out returns at once; the handle carries merge-wait clocks."""

    def fan_out(self, handle, items):
        return [handle] * len(items)


class _Stamped:
    def __init__(self, wait_s):
        self.pull_t0, self.pull_t1 = 10.0, 10.0 + wait_s


@pytest.mark.parametrize("overlapped", [True, False])
def test_merge_wait_recorded_only_for_overlapped_merges(overlapped):
    """The merge's wait is kept for batches merged while the next batch was
    already launched — the merges whose wait double buffering must keep
    free of the next batch's device work — and for no other."""
    b = make_batcher()
    fam = _StampedFamily()
    items = [_Item(fam, ("stamped",), i, 10, 16, NO_DEADLINE) for i in range(3)]
    b._finish(fam, items, _Stamped(0.002), time.monotonic(),
              overlapped=overlapped)
    assert all(it.future.result(0) is not None for it in items)
    mw = b.stats()["merge_wait"]
    if overlapped:
        assert mw["count"] == 1 and 1.0 < mw["p50_ms"] <= 2.56, mw
        assert mw["mean_ms"] == 2.0
    else:
        assert mw["count"] == 0
    assert b.stats()["launches"] == 1


def test_breaker_service_has_the_request_child_under_the_parent():
    svc = CircuitBreakerService(Settings.from_flat(
        {"indices.breaker.total_budget": "100kb"}))
    assert set(svc.stats()) == {"request", "fielddata", "in_flight_requests",
                                "parent"}
    assert svc.breaker("fielddata").limit == 80 * 1024
    assert svc.breaker("in_flight_requests").limit == 100 * 1024
    req = svc.breaker()
    assert req is svc.breaker("request") and req.limit == 60 * 1024
    assert svc.parent.limit == 70 * 1024
    req.add_estimate_and_maybe_break(1000, "x")
    assert svc.parent.used == 1000
    req.release(1000)
    assert svc.parent.used == 0 and req.leak_detected == 0


@pytest.mark.parametrize("k,bucket", [(1, 16), (10, 16), (16, 16), (17, 32),
                                      (100, 128), (128, 128), (129, 256)])
def test_k_bucket_is_pow2_from_16(k, bucket):
    assert _k_bucket(k) == bucket


def test_lazy_plane_and_lut_swaps_are_safe_across_launching_threads(shard_ctx):
    """The drainer and an inline caller may dispatch on one segment at once:
    the dense plane is uploaded once (every thread gets the same tensor) and
    concurrent LUT swaps never drop another thread's fields."""
    import sys

    from elasticsearch_tpu_torch.ops.device_index import (
        TFN_BM25, ensure_blk_freqs, ensure_sim_tables, packed_for)

    packed = packed_for(shard_ctx.searcher.segments[0], shard_ctx.device)
    fields = [f"f{i}" for i in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for rep in range(50):
            packed.sim, packed.blk_freqs = None, None
            cache = np.full(256, rep + 1, np.float32)
            out, errs = run_threads(
                lambda i: (ensure_blk_freqs(packed),
                           ensure_sim_tables(packed, {fields[i]: (TFN_BM25, cache)})),
                len(fields))
            assert all(e is None for e in errs), errs
            assert all(o[0] is packed.blk_freqs for o in out)
            assert set(packed.sim.key) == set(fields)
            for i, (_plane, sim) in enumerate(out):
                row = sim.caches[sim.fid[fields[i]]]
                assert bool((row == rep + 1).all())
    finally:
        sys.setswitchinterval(old)
