"""The port's shard request cache (search/request_cache.py), its consult and
store in the shard query phase (actions.py), its invalidation
(indices_service.py), the warmer's re-prime (warmer.py) and the filter
cache's hot keys (ops/device_index.py `DeviceFilterCache.hot_keys`/`seed`)
against the JAX package.

Units: `canonical_body`, `request_fingerprint` and `cache_policy` equal the
JAX ones over a table of bodies (key order, the volatile knobs, every
semantic change); the invariants of tests/test_caching.py
TestShardRequestCacheUnits (breaker accounting, LRU eviction releasing the
breaker, a trip skipping the store, view-selective invalidation, clear
draining to zero, the enable switch), compression and the hot bodies;
`hot_keys` and `seed` equal the JAX cache's on the same sightings.

Node against node, the cache on on both (the JAX node with its mesh off
and `indices.warmer.enabled` set as the port's): a repeated `size: 0` body
is a hit on both, and the port's hit runs no query phase and launches
nothing; `_bulk` + `_refresh` invalidates (the next answer sees the new
document on both); `?request_cache=true` caches a hit-bearing page and
`?request_cache=false` opts a `size: 0` body out; the re-prime turns the
first sighting after a refresh into a hit, and `indices.warmer.enabled:
false` turns it off. A partial answered on the host path while a device
fault domain is open is stored with `degraded: false`, as on the JAX node,
so a hit serves it undegraded."""

import json
import os
import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch import actions as tactions
from elasticsearch_tpu_torch.common.breaker import CircuitBreakerService
from elasticsearch_tpu_torch.common.devicehealth import DEVICE_HEALTH
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.ops.device_index import DeviceFilterCache
from elasticsearch_tpu_torch.search.request_cache import (
    ShardRequestCache, cache_policy, canonical_body, request_fingerprint)
from elasticsearch_tpu_torch.search.service import SERVING_COUNTERS
from elasticsearch_tpu_torch.transport.faults import DEVICE_FAULTS
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg
from tests.test_torch_aggs import _agg_equal
from tests.test_torch_node import call

BASE = {"query": {"match": {"body": "x"}}, "size": 0}
FINGERPRINT_BODIES = [
    BASE,
    {"size": 0, "query": {"match": {"body": "x"}}},  # key order
    {**BASE, "profile": True, "timeout": "50ms", "request_cache": True},  # knobs
    {**BASE, "size": 5},
    {**BASE, "from": 10},
    {**BASE, "query": {"match": {"body": "y"}}},
    {**BASE, "aggs": {"m": {"max": {"field": "n"}}}},
    {**BASE, "sort": [{"n": "asc"}]},
    {"query": {"bool": {"must": [{"term": {"t": "é"}}], "should": []}}, "size": 10},
    {"query": {"match": {"body": "x"}}, "size": 10, "request_cache": False},
    {"query": {"match": {"body": "x"}}, "size": "0"},
    {"query": {"match": {"body": "x"}}, "size": None},
    {"query": {"match": {"body": "x"}}, "size": "ten"},
    {},
    None,
]


@pytest.mark.parametrize("body", FINGERPRINT_BODIES,
                         ids=[f"b{i}" for i in range(len(FINGERPRINT_BODIES))])
def test_fingerprint_and_policy_match_jax(body):
    from elasticsearch_tpu.search import request_cache as j

    assert canonical_body(body) == j.canonical_body(body)
    assert request_fingerprint(body) == j.request_fingerprint(body)
    assert cache_policy(body) == j.cache_policy(body)


def test_fingerprint_identity_rules():
    fps = [request_fingerprint(b) for b in FINGERPRINT_BODIES[:8]]
    assert fps[0] == fps[1] == fps[2]
    assert len(set(fps[2:])) == 6  # every semantic change is a new identity


def _svc(budget="1mb"):
    return CircuitBreakerService(Settings.from_flat({"indices.breaker.total_budget": budget}))


class TestShardRequestCacheUnits:
    def test_store_hit_and_breaker_accounting(self):
        svc = _svc()
        rc = ShardRequestCache(Settings.EMPTY, breaker=svc.breaker("request"),
                               total_budget=1 << 20)
        key = ("i", 0, 1, "fp")
        assert rc.get(key) is None
        assert rc.put(key, b"x" * 100)
        assert svc.breaker("request").used == 100 + rc.ENTRY_OVERHEAD
        assert rc.get(key) == b"x" * 100
        st = rc.stats()
        assert st["hits"] == 1 and st["misses"] == 1 and st["stores"] == 1

    def test_lru_eviction_releases_breaker(self):
        svc = _svc()
        rc = ShardRequestCache(Settings.from_flat({"indices.requests.cache.size": "2kb"}),
                               breaker=svc.breaker("request"), total_budget=1 << 20)
        for i in range(10):
            assert rc.put(("i", 0, 1, f"fp{i}"), os.urandom(512))
        st = rc.stats()
        assert st["evictions"] > 0 and st["memory_size_in_bytes"] <= rc.size_bytes
        assert svc.breaker("request").used == st["memory_size_in_bytes"]
        assert rc.get(("i", 0, 1, "fp0")) is None
        assert rc.get(("i", 0, 1, "fp9")) is not None

    def test_breaker_trip_skips_store(self):
        svc = _svc(budget="4kb")  # the request child: 60% of it
        rc = ShardRequestCache(Settings.from_flat({"indices.requests.cache.size": "1mb"}),
                               breaker=svc.breaker("request"), total_budget=1 << 20)
        svc.breaker("request").add_estimate_and_maybe_break(1500, "pin")
        assert not rc.put(("i", 0, 1, "fp"), os.urandom(1200))
        assert rc.stats()["rejections"] == 1
        assert rc.get(("i", 0, 1, "fp")) is None
        svc.breaker("request").release(1500)
        assert svc.breaker("request").used == 0

    def test_view_invalidation_is_selective(self):
        rc = ShardRequestCache(Settings.EMPTY, total_budget=1 << 20)
        rc.put(("i", 0, 1, "a"), b"old")
        rc.put(("i", 0, 2, "a"), b"new")
        rc.put(("i", 1, 1, "a"), b"other-shard")
        rc.put(("j", 0, 1, "a"), b"other-index")
        assert rc.invalidate_shard("i", 0, current_view=2) == 1
        assert rc.get(("i", 0, 2, "a")) == b"new"
        assert rc.get(("i", 1, 1, "a")) == b"other-shard"
        assert rc.get(("j", 0, 1, "a")) == b"other-index"
        assert rc.invalidate_shard("i", 0, current_view=None) == 1
        assert rc.stats()["invalidations"] == 2

    def test_clear_drains_to_zero(self):
        svc = _svc()
        rc = ShardRequestCache(Settings.EMPTY, breaker=svc.breaker("request"),
                               total_budget=1 << 20)
        for i in range(5):
            rc.put(("i", 0, 1, f"fp{i}"), b"v" * 64)
        assert svc.breaker("request").used > 0
        assert rc.clear() == 5
        assert rc.stats()["memory_size_in_bytes"] == rc.stats()["entries"] == 0
        assert svc.breaker("request").used == 0

    def test_disabled_by_setting(self):
        rc = ShardRequestCache(Settings.from_flat({"indices.requests.cache.enable": "false"}))
        assert rc.enabled is False

    def test_compression_charges_the_resident_bytes(self):
        svc = _svc()
        rc = ShardRequestCache(Settings.EMPTY, breaker=svc.breaker("request"),
                               total_budget=1 << 20)
        big, small = b"ab" * 4096, b"c" * 100
        assert rc.put(("i", 0, 1, "big"), big) and rc.put(("i", 0, 1, "small"), small)
        st = rc.stats()
        assert st["compressions"] == 1 and st["compressed_raw_bytes"] == len(big)
        assert st["compressed_bytes"] < len(big) and st["compression_ratio"] < 1.0
        assert svc.breaker("request").used == st["memory_size_in_bytes"] == \
            st["compressed_bytes"] + len(small) + 2 * rc.ENTRY_OVERHEAD
        assert rc.get(("i", 0, 1, "big")) == big and rc.get(("i", 0, 1, "small")) == small

    def test_hot_bodies_rank_by_hits_and_survive_view_invalidation(self):
        rc = ShardRequestCache(Settings.EMPTY, total_budget=1 << 20)
        bodies = [{"size": 0, "query": {"term": {"t": f"v{i}"}}} for i in range(3)]
        keys = [("i", 0, 1, request_fingerprint(b)) for b in bodies]
        for key, body in zip(keys, bodies):
            rc.put(key, b"p", body=body)
        assert not rc.has_hot("i", 0) and rc.hot_bodies("i", 0) == []
        for n, key in ((1, keys[0]), (3, keys[2])):
            for _ in range(n):
                assert rc.get(key) == b"p"
        rc.invalidate_shard("i", 0, current_view=2)  # a new view: entries go
        assert rc.stats()["entries"] == 0 and rc.has_hot("i", 0)
        assert rc.hot_bodies("i", 0) == [bodies[2], bodies[0]]
        assert rc.hot_bodies("i", 0, n=1) == [bodies[2]]
        rc.invalidate_shard("i", 0, current_view=None)  # the shard closes
        assert not rc.has_hot("i", 0)


class _FakeSeg:
    def __init__(self):
        self._device_cache = {}


def test_filter_cache_hot_keys_and_seed_match_jax():
    """The same sightings on both caches: the same hot keys, the same seeds,
    and a seeded key stores at its next evaluation (port)."""
    from elasticsearch_tpu.common.settings import Settings as JSettings
    from elasticsearch_tpu.ops.device_index import DeviceFilterCache as JCache

    cpu = torch.device("cpu")
    tc = DeviceFilterCache(Settings.from_flat({"indices.filter_cache.min_sightings": 3}))
    jc = JCache(JSettings.from_flat({"indices.filter_cache.min_sightings": 3}))
    old = [_FakeSeg() for _ in range(2)]
    jold = [_FakeSeg() for _ in range(2)]
    sightings = [(0, "a", 3), (0, "b", 2), (1, "c", 4), (1, "a", 1), (1, "d", 1)]
    for si, key, n in sightings:
        for _ in range(n):
            assert tc.lookup(old[si], key, cpu) is None
            assert jc.lookup(jold[si], key) is None
    assert tc.hot_keys(old) == jc.hot_keys(jold) == {"a", "c"}
    assert tc.hot_keys(old[:1]) == jc.hot_keys(jold[:1]) == {"a"}
    new, jnew = _FakeSeg(), _FakeSeg()
    jc.lookup(jnew, "c")
    tc.lookup(new, "c", cpu)
    assert tc.seed(new, {"a", "c", "z"}, cpu) == jc.seed(jnew, {"a", "c", "z"}) == 3
    assert tc.seed(new, {"a"}, cpu) == jc.seed(jnew, {"a"}) == 0  # already seeded
    assert tc.hot_keys([new]) == jc.hot_keys([jnew]) == {"a", "c", "z"}
    assert tc.maybe_store(new, "a", np.ones(128, bool), cpu) is not None
    off = DeviceFilterCache(Settings.from_flat({"indices.filter_cache.enable": "false"}))
    assert off.seed(_FakeSeg(), {"a"}, cpu) == 0


# ---------------------------------------------------------------------------
# node against node
# ---------------------------------------------------------------------------

DOCS = 90
BODY = {"size": 0, "query": {"match": {"body": "w1 w2"}},
        "aggs": {"n": {"stats": {"field": "n"}}, "tags": {"terms": {"field": "tag"}}}}


def _bulk(start: int, n: int) -> str:
    rng = np.random.default_rng(start)
    lines = []
    for i in range(start, start + n):
        lines.append({"index": {"_index": "rc", "_type": "doc", "_id": str(i)}})
        lines.append({"body": " ".join(f"w{int(w)}" for w in rng.integers(0, 12, 8)),
                      "n": i, "tag": f"t{i % 5}"})
    return "\n".join(json.dumps(x) for x in lines) + "\n"


def _pair(tmp_path_factory, warmer: bool):
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu.transport.local import LocalTransportRegistry as JReg

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    flag = "true" if warmer else "false"
    # a re-prime's query runs under this budget; a loaded CPU (a first JAX
    # compile) can outlast the default 5 s, and a timed-out partial is not
    # stored
    warm = {"indices.warmer.enabled": flag, "indices.warmer.query_timeout": "60"}
    p = PNode(name="port", settings={"node.device": "cpu", **warm},
              registry=PReg(), data_path=str(tmp_path_factory.mktemp("port_rc"))).start()
    j = JNode(name="jax", settings={"search.mesh.enabled": "false", **warm},
              registry=JReg(), data_path=str(tmp_path_factory.mktemp("jax_rc")))
    try:
        j.start([j.local_node.transport_address])
        j.wait_for_master()
        bases = [f"http://127.0.0.1:{p.start_http(0).port}",
                 f"http://127.0.0.1:{j.start_http(0).port}"]
        for base in bases:
            st, r = call(base, "PUT", "/rc", {"settings": {
                "number_of_shards": 3, "refresh_interval": -1},
                "mappings": {"doc": {"properties": {
                    "tag": {"type": "string", "index": "not_analyzed"},
                    "n": {"type": "integer"}}}}})
            assert st == 200, r
            _write(base, 0, DOCS)
        yield bases[0], bases[1], p, j
    finally:
        p.close()
        j.close()
        torch.set_num_threads(threads)


def _write(base, start, n):
    st, r = call(base, "POST", "/_bulk", raw=_bulk(start, n))
    assert st == 200 and not r["errors"], r
    st, _r = call(base, "POST", "/rc/_refresh")
    assert st == 200


@pytest.fixture(scope="module")
def cache_nodes(tmp_path_factory):
    yield from _pair(tmp_path_factory, warmer=True)


@pytest.fixture(scope="module")
def cold_nodes(tmp_path_factory):
    yield from _pair(tmp_path_factory, warmer=False)


def _same(pr, jr):
    assert pr["hits"] == jr["hits"] and pr["_shards"] == jr["_shards"]
    if "aggregations" in jr:
        _agg_equal(pr["aggregations"], jr["aggregations"])


def _rc(node) -> dict:
    return node.request_cache.stats()


class _Phases:
    """Counts the port's shard query phases that reached execute_query_phase."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = tactions.execute_query_phase

        def counting(*a, **kw):
            self.n += 1
            return real(*a, **kw)

        monkeypatch.setattr(tactions, "execute_query_phase", counting)


def test_hit_runs_no_query_phase_and_matches_jax(cache_nodes, monkeypatch):
    pbase, jbase, p, j = cache_nodes
    body = {**BODY, "query": {"match": {"body": "w3 w4"}}}
    phases = _Phases(monkeypatch)
    p0, j0 = _rc(p), _rc(j)
    first = [call(b, "POST", "/rc/_search", body)[1] for b in (pbase, jbase)]
    assert phases.n == 3
    _same(*first)
    launches, counters = p.search_batcher.stats()["launches"], dict(SERVING_COUNTERS)
    second = [call(b, "POST", "/rc/_search", body)[1] for b in (pbase, jbase)]
    _same(*second)
    _same(first[0], second[0])
    assert phases.n == 3  # every shard answered from the cache
    assert p.search_batcher.stats()["launches"] == launches
    assert dict(SERVING_COUNTERS) == counters
    for node, before in ((p, p0), (j, j0)):
        st = _rc(node)
        assert (st["misses"] - before["misses"], st["hits"] - before["hits"],
                st["stores"] - before["stores"]) == (3, 3, 3)
    assert p.breakers.breaker("request").used >= _rc(p)["memory_size_in_bytes"] > 0


def test_request_cache_param_and_count_match_jax(cache_nodes, monkeypatch):
    pbase, jbase, p, j = cache_nodes
    phases = _Phases(monkeypatch)
    page = {"query": {"match": {"body": "w5"}}, "size": 7}
    for _ in range(2):
        rs = [call(b, "POST", "/rc/_search?request_cache=true", page)[1]
              for b in (pbase, jbase)]
        _same(*rs)
    assert phases.n == 3  # the page was stored, then hit
    for _ in range(2):
        rs = [call(b, "POST", "/rc/_search?request_cache=false", BODY)[1]
              for b in (pbase, jbase)]
        _same(*rs)
    assert phases.n == 9  # opted out: both ran
    rs = [call(b, "POST", "/rc/_search", page)[1] for b in (pbase, jbase)]
    _same(*rs)
    assert phases.n == 12  # a page without the flag is not cached
    stats = [_rc(n) for n in (p, j)]
    assert stats[0]["entries"] == stats[1]["entries"]


def test_write_and_refresh_invalidates_on_both(cache_nodes):
    pbase, jbase, p, j = cache_nodes
    body = {**BODY, "query": {"match": {"body": "w6"}}}
    before = [call(b, "POST", "/rc/_search", body)[1] for b in (pbase, jbase)]
    _same(*before)
    inval = [_rc(n)["invalidations"] for n in (p, j)]
    for base in (pbase, jbase):
        _write(base, 1000, 30)
    after = [call(b, "POST", "/rc/_search", body)[1] for b in (pbase, jbase)]
    _same(*after)
    assert after[0]["hits"]["total"] > before[0]["hits"]["total"]
    assert [_rc(n)["invalidations"] for n in (p, j)] > inval
    assert _rc(p)["invalidations"] - inval[0] == _rc(j)["invalidations"] - inval[1]


def _wait(pred, what: str, timeout: float = 20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _warmer_idle(node) -> bool:
    pool = node.threadpool.stats()["warmer"]
    return pool["queue"] == 0 and pool["active"] == 0


def _reprime_round(pbase, jbase, p, j, body, start):
    """Sight `body` twice (a store, then a hit), write to one shard and
    refresh; returns the warmer stats before the write, read once both
    warmers are idle (a re-prime an earlier write scheduled must not count
    as this write's)."""
    for _ in range(2):
        _same(*[call(b, "POST", "/rc/_search", body)[1] for b in (pbase, jbase)])
    _wait(lambda: _warmer_idle(p) and _warmer_idle(j), "idle warmers")
    warm = [n.warmer.stats() for n in (p, j)]
    for base in (pbase, jbase):
        _write(base, start, 1)
    return warm


def test_reprime_turns_the_next_sighting_into_a_hit(cache_nodes):
    pbase, jbase, p, j = cache_nodes
    body = {**BODY, "query": {"match": {"body": "w7 w8"}}}
    warm = _reprime_round(pbase, jbase, p, j, body, 2000)
    for node, w in zip((p, j), warm):
        # the re-prime counts itself once its stores are done
        _wait(lambda: node.warmer.stats()["reprimes"] > w["reprimes"], "a re-prime")
        now = node.warmer.stats()
        assert now["queries_warmed"] > w["queries_warmed"], (node.name, w, now)
        assert now["query_failures"] == w["query_failures"], (node.name, w, now)
    stats = [_rc(n) for n in (p, j)]
    _same(*[call(b, "POST", "/rc/_search", body)[1] for b in (pbase, jbase)])
    for node, st in zip((p, j), stats):
        now = _rc(node)
        assert (now["hits"] - st["hits"], now["misses"] - st["misses"]) == (3, 0), \
            (node.name, st, now)


def test_warmer_disabled_turns_the_reprime_off(cold_nodes):
    pbase, jbase, p, j = cold_nodes
    body = {**BODY, "query": {"match": {"body": "w9"}}}
    warm = _reprime_round(pbase, jbase, p, j, body, 3000)
    time.sleep(0.3)
    assert [n.warmer.stats()["reprimes"] for n in (p, j)] == \
        [w["reprimes"] for w in warm] == [0, 0]
    assert p.warmer.stats()["enabled"] is False
    stats = [_rc(n) for n in (p, j)]
    _same(*[call(b, "POST", "/rc/_search", body)[1] for b in (pbase, jbase)])
    for node, st in zip((p, j), stats):
        now = _rc(node)
        # the written shard misses, the other two hit
        assert (now["hits"] - st["hits"], now["misses"] - st["misses"]) == (2, 1)


def test_degraded_partial_is_cached_undegraded(cold_nodes):
    """A shard answered on the host path while `pull:rc` is open stores its
    partial with `degraded: false` (the JAX node's rule, kept): the degraded
    answer equals the card's, and the next sighting's hit reports no
    degraded shard, before and after the domain recovers."""
    pbase, _jbase, p, _j = cold_nodes
    body = {**BODY, "query": {"match": {"body": "w10 w11"}}}
    card = call(pbase, "POST", "/rc/_search", {**body, "request_cache": False})[1]
    assert card["_shards"]["degraded"] == 0
    DEVICE_FAULTS.arm(error="transfer", domain="pull:rc", times=10 ** 6)
    try:
        first = call(pbase, "POST", "/rc/_search", body)[1]
        assert first["_shards"]["degraded"] == 3
        assert first["hits"] == card["hits"]
        _agg_equal(first["aggregations"], card["aggregations"])
        hit = call(pbase, "POST", "/rc/_search", body)[1]
    finally:
        DEVICE_FAULTS.disarm()
        DEVICE_HEALTH.reset()
    assert hit["_shards"]["degraded"] == 0 and hit["hits"] == card["hits"]
    _agg_equal(hit["aggregations"], card["aggregations"])
    key_fp = request_fingerprint(body)
    entries = [k for k in p.request_cache._entries if k[3] == key_fp]
    assert len(entries) == 3
    assert all(tactions._decode_cached_partial(p.request_cache.get(k))["degraded"] is False
               for k in entries)
