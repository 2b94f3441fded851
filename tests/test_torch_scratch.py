"""The sparse path's pooled staging (elasticsearch_tpu_torch/ops/scoring.py
`SparseScratchPool`, `StagingSet`) against the JAX package's
`SparseScratchPool`, on the CPU, over tests/test_torch_slice.py's two-segment
shard (BM25 and TF-IDF; seeded documents, one tombstone).

- The pin of tests/test_batcher.py::TestStagingScratch::
  test_warmed_repeat_batch_zero_new_host_allocations, on both packages: a
  warmed repeat batch makes 0 new staging allocations, and the request
  breaker's staging reservation drains to 0.
- Hits are bitwise the same with the pool (sets reused after a batch of
  other queries left them dirty) as without it (no set ever kept), and
  equal the JAX package's.
- A set goes back to its pool as soon as its launch has returned (the
  launch has copied it: pageable memory on the card, the plain version's
  eager run on the CPU): the sets are back before the batch's pull, and a
  batch whose sets were scribbled over before its pull still answers right.
- A failed pull (an injected CUDA error at `pull:<index>`, sticky or
  transient) leaves the pool whole: the next batch allocates nothing and
  answers right. The abandoned pull is told whether the context may be lost
  (a sticky code), and parks its pinned host buffers only then.
- A request-breaker trip at `<sparse_staging>` gives the sets back and parks
  nothing: the next batch allocates nothing.
- Concurrent launches on one segment never hold one set at once.
- The staging of a batch is charged to the request breaker: the sum of its
  sets' bytes, under the JAX package's label, released after the launch.
- One staging buffer a launch: every array is a dtype-aligned view into its
  set's one buffer (qconst, the 1-byte array, last), and a launch uploads
  that buffer once (on the CPU the device tensors are views of it).
- Each packed segment holds its own pool, as in the JAX package.

Tolerance: none (bitwise). Both packages' fault injectors and trackers are
reset around every test."""

import threading

import numpy as np
import pytest

from elasticsearch_tpu.common.devicehealth import DEVICE_HEALTH as J_HEALTH
from elasticsearch_tpu.transport.faults import DEVICE_FAULTS as J_FAULTS
from elasticsearch_tpu.transport.faults import DEVICE_PULL as J_PULL
from elasticsearch_tpu_torch.common import cudaenv
from elasticsearch_tpu_torch.common.breaker import CircuitBreakerService
from elasticsearch_tpu_torch.common.cudaenv import CudaError
from elasticsearch_tpu_torch.common.devicehealth import DEVICE_HEALTH, context_lost
from elasticsearch_tpu_torch.common.errors import CircuitBreakingError
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.ops import scoring as tscoring
from elasticsearch_tpu_torch.ops.device_index import packed_for
from elasticsearch_tpu_torch.ops.scoring import SparseScratchPool, StagingSet
from elasticsearch_tpu_torch.search import parse_query
from elasticsearch_tpu_torch.search.execute import (
    dispatch_flat_batch, execute_flat_batch, lower_flat)
from elasticsearch_tpu_torch.transport.faults import (
    DEVICE_FAULTS, DEVICE_PULL, make_device_error)
from tests.test_torch_slice import QUERIES, shards  # noqa: F401

OTHER = [{"match": {"body": "w30 w31 w32 w33 w34 w35"}},
         {"bool": {"should": [{"term": {"body": f"w{i}"}} for i in range(40, 52)],
                   "minimum_should_match": 3}}]


def _reset_all():
    for faults in (DEVICE_FAULTS, J_FAULTS, DEVICE_PULL, J_PULL):
        faults.disarm()
    for health in (DEVICE_HEALTH, J_HEALTH):
        health.reset()


@pytest.fixture(autouse=True)
def _device_state_hygiene():
    _reset_all()
    try:
        yield
    finally:
        _reset_all()


def _plans(ctx, queries):
    plans = [lower_flat(parse_query(q), ctx) for q in queries]
    return [p for p in plans if p is not None]


def _jax_plans(jctx, queries):
    from elasticsearch_tpu.search import parse_query as jparse
    from elasticsearch_tpu.search.execute import lower_flat as jlower

    plans = [jlower(jparse(q), jctx) for q in queries]
    return [p for p in plans if p is not None]


def _jax_batch(jctx, plans, k):
    from elasticsearch_tpu.common.jaxenv import compile_tag
    from elasticsearch_tpu.search.execute import execute_flat_batch as jexec

    with compile_tag("sparse"):
        return [(td.total, td.hits) for td in jexec(plans, jctx, k)]


def _hits(tds):
    return [(td.total, td.hits) for td in tds]


def _pools(ctx):
    return [packed_for(seg, ctx.device).sparse_scratch
            for seg in ctx.searcher.segments]


def _free(ctx) -> int:
    return sum(len(lst) for pool in _pools(ctx) if pool is not None
               for lst in pool._free.values())


def _sets(pending) -> list:
    return [sb.staging for part in pending.parts if part.kind == "plain"
            for (_seg, _b, _d, launches, _dense) in part.seg_work
            for (sb, _r) in launches]


def test_warmed_repeat_batch_zero_new_host_allocations(shards):
    """The JAX pin, on both packages side by side."""
    from elasticsearch_tpu.common.settings import Settings as JSettings
    from elasticsearch_tpu.common.breaker import CircuitBreakerService as JBreakers
    from elasticsearch_tpu.ops.device_index import packed_for as jpacked_for

    jctx, own, _conv = shards
    own.breakers = CircuitBreakerService(Settings.from_flat({}))
    jctx.breakers = JBreakers(JSettings.from_flat({}))
    try:
        plans, jplans = _plans(own, QUERIES), _jax_plans(jctx, QUERIES)
        want = _jax_batch(jctx, jplans, 10)  # warm: the pools fill here
        assert _hits(execute_flat_batch(plans, own, 10)) == want
        pools = _pools(own)
        jpools = [jpacked_for(seg).sparse_scratch for seg in jctx.searcher.segments]
        assert all(p is not None and p.allocs >= 1 for p in pools)
        before = [p.allocs for p in pools], [p.allocs for p in jpools]
        reuses = sum(p.reuses for p in pools)
        for _ in range(3):  # warmed repeats re-pad pooled sets in place
            assert _hits(execute_flat_batch(plans, own, 10)) == want
            assert _jax_batch(jctx, jplans, 10) == want
        assert [p.allocs for p in pools] == before[0], "the port's pool regressed"
        assert [p.allocs for p in jpools] == before[1]
        assert sum(p.reuses for p in pools) - reuses >= 3
        assert own.breakers.breaker("request").stats()["estimated"] == 0
    finally:
        own.breakers = None
        jctx.breakers = None


def test_hits_bitwise_with_and_without_the_pool(shards, monkeypatch):
    jctx, own, _conv = shards
    plans = _plans(own, QUERIES)
    want = _jax_batch(jctx, _jax_plans(jctx, QUERIES), 25)
    execute_flat_batch(_plans(own, OTHER), own, 25)  # leaves dirty sets behind
    pooled = _hits(execute_flat_batch(plans, own, 25))
    monkeypatch.setattr(SparseScratchPool, "_MAX_FREE", 0)  # no set is kept
    for pool in _pools(own):
        monkeypatch.setattr(pool, "_free", {})
    allocs = sum(p.allocs for p in _pools(own))
    unpooled = _hits(execute_flat_batch(plans, own, 25))
    assert sum(p.allocs for p in _pools(own)) > allocs
    assert pooled == unpooled == want


def _allocs(ctx) -> int:
    return sum(p.allocs for p in _pools(ctx))


def test_a_set_goes_back_once_its_launch_has_returned(shards):
    _jctx, own, _conv = shards
    plans = _plans(own, QUERIES)
    ref = _hits(execute_flat_batch(plans, own, 10))  # warm
    free, allocs = _free(own), _allocs(own)
    first = dispatch_flat_batch(plans, own, 10)
    sets = _sets(first)
    assert sets and _free(own) == free  # back before the pull
    for st in sets:  # the next take may write them at once
        for a in st.arrays.values():
            a.fill(3)
    second = dispatch_flat_batch(plans, own, 10)  # while the first is unmerged
    assert {id(s) for s in _sets(second)} == {id(s) for s in sets}
    assert _allocs(own) == allocs
    assert _hits(first.merge()) == ref
    assert _hits(second.merge()) == ref


@pytest.mark.parametrize("kind,lost", [("transfer", True), ("timeout", False)])
def test_a_failed_pull_leaves_the_pool_whole(shards, monkeypatch, kind, lost):
    _jctx, own, _conv = shards
    plans = _plans(own, QUERIES)
    ref = _hits(execute_flat_batch(plans, own, 10))  # warm
    free, allocs = _free(own), _allocs(own)
    seen = []
    abandon = cudaenv.PendingPull.abandon

    def spy(self, context_lost=False):
        seen.append(context_lost)
        abandon(self, context_lost)

    monkeypatch.setattr(cudaenv.PendingPull, "abandon", spy)
    pending = dispatch_flat_batch(plans, own, 10)
    DEVICE_FAULTS.arm(error=kind, domain="pull:*", times=1)
    with pytest.raises(CudaError):
        pending.merge()
    assert seen == [lost]
    assert pending.pull._hosts == [] and pending.pull._done is None  # abandoned
    assert _free(own) == free
    assert _hits(execute_flat_batch(plans, own, 10)) == ref
    assert _allocs(own) == allocs


def test_a_request_breaker_trip_gives_the_sets_back(shards):
    _jctx, own, _conv = shards
    plans = _plans(own, QUERIES)
    ref = _hits(execute_flat_batch(plans, own, 10))  # warm
    free, allocs, parked = _free(own), _allocs(own), len(cudaenv._PARKED)
    own.breakers = CircuitBreakerService(Settings.from_flat(
        {"indices.breaker.total_budget": "1kb"}))
    try:
        for _ in range(3):  # each replay would take fresh sets if none came back
            with pytest.raises(CircuitBreakingError) as err:
                dispatch_flat_batch(plans, own, 10)
            assert err.value.breaker == "request" and "<sparse_staging>" in str(err.value)
    finally:
        own.breakers = None
    assert _free(own) == free and _allocs(own) == allocs
    assert len(cudaenv._PARKED) == parked
    assert _hits(execute_flat_batch(plans, own, 10)) == ref
    assert _allocs(own) == allocs


def test_concurrent_launches_on_one_segment_never_share_a_set(shards, monkeypatch):
    jctx, own, _conv = shards
    plans = _plans(own, QUERIES)
    want = _jax_batch(jctx, _jax_plans(jctx, QUERIES), 10)
    out, clashes, lock = set(), [], threading.Lock()
    take, give = SparseScratchPool.take, SparseScratchPool.give

    def tracked_take(self, *args, **kw):
        st = take(self, *args, **kw)
        with lock:
            if id(st) in out:
                clashes.append(st.key)
            out.add(id(st))
        return st

    def tracked_give(self, st):
        with lock:
            out.discard(id(st))
        give(self, st)

    monkeypatch.setattr(SparseScratchPool, "take", tracked_take)
    monkeypatch.setattr(SparseScratchPool, "give", tracked_give)
    n = 8
    barrier = threading.Barrier(n)
    pendings, errors = [None] * n, []

    def worker(i):
        try:
            barrier.wait(10)
            pendings[i] = dispatch_flat_batch(plans, own, 10)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors, errors
    assert not clashes and not out  # none held twice; all given back
    for p in pendings:
        assert _hits(p.merge()) == want


def test_staging_bytes_charged_to_the_request_breaker(shards):
    _jctx, own, _conv = shards
    breakers = CircuitBreakerService(Settings.from_flat({}))
    req = breakers.breaker("request")
    charged = []
    add = req.add_estimate_and_maybe_break

    def spy(nbytes, label=""):
        charged.append((label, nbytes, req.stats()["estimated"]))
        return add(nbytes, label)

    req.add_estimate_and_maybe_break = spy
    own.breakers = breakers
    try:
        pending = dispatch_flat_batch(_plans(own, QUERIES), own, 10)
        sets = _sets(pending)
        pending.merge()
    finally:
        own.breakers = None
    staged = [c for c in charged if c[0] == "<sparse_staging>"]
    assert len(staged) == len(own.searcher.segments)  # one sum a segment's launch
    assert sum(n for _l, n, _e in staged) == sum(s.buf.numel() for s in sets) == sum(
        SparseScratchPool.staging_bytes(*s.key) for s in sets)
    assert req.stats()["estimated"] == 0


def test_one_buffer_a_launch_with_aligned_views(shards, monkeypatch):
    _jctx, own, _conv = shards
    uploads = []
    real = tscoring.upload_buffer

    def counted(buf, device):
        uploads.append(buf)
        return real(buf, device)

    monkeypatch.setattr(tscoring, "upload_buffer", counted)
    pending = dispatch_flat_batch(_plans(own, QUERIES), own, 10)
    sets = _sets(pending)
    launches = sum(len(launches) for part in pending.parts if part.kind == "plain"
                   for (_s, _b, _d, launches, _dense) in part.seg_work)
    pending.merge()
    assert len(uploads) == launches == len(sets)
    assert [id(b) for b in uploads] == [id(s.buf) for s in sets]
    for st in sets:
        host = st.buf.numpy()
        names = [name for (name, *_rest) in st.layout]
        assert names[-1] == "qconst"
        for name, dt, shape, off, nbytes in st.layout:
            a = st.arrays[name]
            assert off % 256 == 0 and a.dtype == np.dtype(dt) and a.shape == shape
            assert np.shares_memory(a, host) and a.ctypes.data % 4 == 0
        dev = st.to_device(own.device)
        for name, t in dev.items():  # on the CPU: views of the one buffer
            assert t.data_ptr() == st.arrays[name].ctypes.data
        Qb, tb, c1 = st.key
        assert st.arrays["coord"].shape == (Qb, c1)
        assert st.buf.numel() == SparseScratchPool.staging_bytes(Qb, tb, c1)


def test_a_pooled_set_is_reset_before_reuse():
    pool = SparseScratchPool()
    st = pool.take(8, 16, 3, sentinel_row=99)
    for a in st.arrays.values():
        a.fill(7)
    pool.give(st)
    again = pool.take(8, 16, 3, sentinel_row=41)
    assert again is st and pool.allocs == 1 and pool.reuses == 1
    a = again.arrays
    assert (a["qblk"] == 41).all() and (a["coord"] == 1.0).all()
    assert not any(a[n].any() for n in ("qw", "qcnt", "qfid", "n_must", "msm", "qconst"))
    other = pool.take(8, 16, 4, sentinel_row=41)  # another C+1: another buffer
    assert other is not st and pool.allocs == 2
    assert isinstance(other, StagingSet) and other.key == (8, 16, 4)


def test_an_abandoned_pull_parks_pinned_hosts_only_if_the_context_may_be_lost(
        monkeypatch):
    parked = []
    monkeypatch.setattr(cudaenv, "park", parked.append)
    cudaenv.PendingPull(["device tensor"], [object()], done=object()).abandon()
    cudaenv.PendingPull(["device tensor"], [object()], done=object()).abandon(
        context_lost=False)
    assert parked == []  # a healthy stream frees them
    hosts = [object()]
    cudaenv.PendingPull(["device tensor"], hosts, done=object()).abandon(
        context_lost=True)
    assert parked == [hosts]
    cudaenv.PendingPull(None, [object()], None).abandon(context_lost=True)
    assert parked == [hosts]  # the CPU: nothing pinned
    assert context_lost(make_device_error("transfer"))
    assert context_lost(make_device_error("launch"))
    assert context_lost(RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert not context_lost(make_device_error("timeout"))
    assert not context_lost(make_device_error("oom"))
    assert not context_lost(ValueError("a host bug"))


def test_each_packed_segment_holds_its_own_pool(shards):
    _jctx, own, _conv = shards
    execute_flat_batch(_plans(own, QUERIES), own, 10)
    pools = _pools(own)
    assert len(pools) == len(own.searcher.segments) >= 2
    assert all(isinstance(p, SparseScratchPool) for p in pools)
    assert len({id(p) for p in pools}) == len(pools)
