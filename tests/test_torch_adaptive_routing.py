"""Adaptive replica selection and hedged shard requests on the port
(elasticsearch_tpu_torch/cluster/stats.py, cluster/routing.py and the hedge
branch of actions.py `_query_shard_async`): the port's copy of
tests/test_adaptive_routing.py, on the CPU.

- Units (`TestCopyHealth`, `TestSelection`, `TestHedging`,
  `TestPreferenceFallthrough`): every case runs on both packages' classes,
  parametrised by package; `test_same_observations_same_answers` feeds one
  seeded stream of observations and failures to both selectors and holds
  the port's scores, selections, ranks, hedge delays and stats to the JAX
  selector's.
- Chaos (`TestChaosAdaptiveRouting`): each case runs on a pair of port
  nodes and on a pair of JAX nodes (tests/test_torch_two_nodes.py
  `Cluster`, one index of 1 shard and 1 replica, `search.hedge.burst: 24`,
  faults from a seeded `FaultPolicy`, never a sleep in a handler): a
  copy slowed by 0.75 s loses its traffic while hedges keep p95 under the
  delay, and rejoins once the fault clears; a failing copy is quarantined
  and probed back; when every copy is slow the budget bounds the hedges;
  a hedge shows as a `shard` span tagged `hedge` and as `winner: "hedge"`
  in a profile, and a hard pin never hedges; `/_nodes/stats`
  `adaptive_routing` has the JAX shape.

Every node is closed in a `finally`."""

from __future__ import annotations

import random
import time
from types import SimpleNamespace

import pytest

from tests.test_torch_two_nodes import Cluster


def _ns(pkg: str) -> SimpleNamespace:
    """The classes a case uses, from one package."""
    if pkg == "port":
        from elasticsearch_tpu_torch.cluster import routing, state, stats
        from elasticsearch_tpu_torch.common import errors, settings
        from elasticsearch_tpu_torch.rest import controller
        from elasticsearch_tpu_torch.transport.faults import FaultPolicy
    else:
        from elasticsearch_tpu.cluster import routing, state, stats
        from elasticsearch_tpu.common import errors, settings
        from elasticsearch_tpu.rest import controller
        from elasticsearch_tpu.transport.faults import FaultPolicy
    return SimpleNamespace(
        pkg=pkg, OperationRouting=routing.OperationRouting, STARTED=state.STARTED,
        ClusterState=state.ClusterState, DiscoveryNode=state.DiscoveryNode,
        DiscoveryNodes=state.DiscoveryNodes,
        IndexShardRoutingTable=state.IndexShardRoutingTable,
        ShardRouting=state.ShardRouting,
        AdaptiveReplicaSelector=stats.AdaptiveReplicaSelector,
        CopyHealth=stats.CopyHealth, HedgeBudget=stats.HedgeBudget,
        NoShardAvailableError=errors.NoShardAvailableError,
        Settings=settings.Settings, RestRequest=controller.RestRequest,
        build_rest_controller=controller.build_rest_controller,
        FaultPolicy=FaultPolicy)


@pytest.fixture(params=["port", "jax"])
def m(request):
    return _ns(request.param)


def _copies(m, n=3, index="i", shard=0, first_node=1):
    return [m.ShardRouting(index, shard, f"n{i + first_node}", i == 0, m.STARTED)
            for i in range(n)]


def _selector(m, **over):
    flat = {"search.adaptive.min_samples": 3, **over}
    return m.AdaptiveReplicaSelector(m.Settings.from_flat(flat))


def _warm_all(sel, copies, seconds=0.01, n=None):
    for _ in range(n if n is not None else sel.min_samples):
        for c in copies:
            sel.observe(c, seconds)


# ---------------------------------------------------------------------------
# CopyHealth units
# ---------------------------------------------------------------------------


class TestCopyHealth:
    def test_ewma_tracks_recent_latency(self, m):
        sel = _selector(m)
        (c,) = _copies(m, 1)
        for _ in range(10):
            sel.observe(c, 0.01)
        e = sel._copy(sel.key(c))
        assert e.ewma_s == pytest.approx(0.01, rel=0.01)
        for _ in range(10):
            sel.observe(c, 0.5)
        assert e.ewma_s > 0.4
        assert e.samples == 20

    def test_failure_penalty_raises_score_and_quarantines(self, m):
        sel = _selector(m)
        a, b = _copies(m, 2)
        _warm_all(sel, [a, b])
        now = time.monotonic()
        hl, qt = sel.failure_halflife_s, sel.quarantine_failures
        ea, eb = sel._copy(sel.key(a)), sel._copy(sel.key(b))
        assert ea.score(now, hl) == pytest.approx(eb.score(now, hl), rel=0.01)
        for _ in range(4):
            sel.failure(a)
        assert ea.score(now, hl) > 5 * eb.score(now, hl)
        assert ea.quarantined(now, hl, qt)
        assert not eb.quarantined(now, hl, qt)

    def test_success_halves_failures_deterministically(self, m):
        sel = _selector(m)
        (c,) = _copies(m, 1)
        for _ in range(4):
            sel.failure(c)
        e = sel._copy(sel.key(c))
        now = time.monotonic()
        assert e.quarantined(now, sel.failure_halflife_s, sel.quarantine_failures)
        sel.observe(c, 0.01)  # 4 -> 2
        assert not e.quarantined(now, sel.failure_halflife_s, sel.quarantine_failures)

    def test_failure_time_decay(self, m):
        e = m.CopyHealth(("n1", "i", 0))
        for _ in range(3):
            e.failure(now=100.0, halflife_s=1.0)
        assert e.quarantined(100.0, 1.0, 3.0)
        assert not e.quarantined(103.0, 1.0, 3.0)


# ---------------------------------------------------------------------------
# selection: cold start, rotation, quarantine and probe re-entry
# ---------------------------------------------------------------------------


class TestSelection:
    def test_cold_start_returns_none_until_min_samples(self, m):
        sel = _selector(m)
        copies = _copies(m, 2)
        assert sel.select(copies) is None
        _warm_all(sel, copies[:1])
        assert sel.select(copies) is None
        _warm_all(sel, copies[1:])
        assert sel.select(copies) is not None
        assert sel.stats()["selections"]["round_robin"] >= 2

    def test_rotation_balanced_when_healthy(self, m):
        sel = _selector(m)
        copies = _copies(m, 3)
        _warm_all(sel, copies)
        picks = {c.node_id: 0 for c in copies}
        for _ in range(30):
            picks[sel.select(copies).node_id] += 1
        assert all(v >= 6 for v in picks.values()), picks

    def test_slow_copy_leaves_rotation_but_gets_probes(self, m):
        sel = _selector(m)
        copies = _copies(m, 3)
        _warm_all(sel, copies[:2], seconds=0.01)
        _warm_all(sel, copies[2:], seconds=1.0)
        picks = {c.node_id: 0 for c in copies}
        for _ in range(32):
            picks[sel.select(copies).node_id] += 1
        assert picks["n3"] <= 32 // sel.probe_every + 1, picks
        assert picks["n3"] >= 1, "no probe traffic: a permanent blacklist"
        assert sel.stats()["probes"] >= 1
        assert picks["n1"] + picks["n2"] >= 32 - 32 // sel.probe_every - 1

    def test_quarantine_probe_reentry(self, m):
        sel = _selector(m)
        copies = _copies(m, 2)
        _warm_all(sel, copies)
        for _ in range(4):
            sel.failure(copies[1])
        assert sel.stats()["copies"]["n2/i/0"]["quarantined"]
        picks = [sel.select(copies).node_id for _ in range(16)]
        assert picks.count("n2") <= 16 // sel.probe_every + 1
        sel.observe(copies[1], 0.01)
        sel.observe(copies[1], 0.01)
        assert not sel.stats()["copies"]["n2/i/0"]["quarantined"]
        picks = [sel.select(copies).node_id for _ in range(16)]
        assert picks.count("n2") >= 4, picks

    def test_failing_from_birth_copy_does_not_keep_group_cold(self, m):
        sel = _selector(m)
        copies = _copies(m, 3)
        _warm_all(sel, copies[:2])
        for _ in range(4):
            sel.failure(copies[2])
        picks = [sel.select(copies) for _ in range(16)]
        assert all(p is not None for p in picks)
        n3 = sum(1 for p in picks if p.node_id == "n3")
        assert n3 <= 16 // sel.probe_every + 1, n3
        assert sel.stats()["copies"]["n3/i/0"]["quarantined"]

    def test_registry_prunes_idle_copies(self, m):
        sel = _selector(m)
        sel.PRUNE_AT = 8
        sel.PRUNE_IDLE_S = 0.0
        for i in range(8):
            sel._copy((f"n{i}", "old", 0))
        live = sel._copy(("n0", "live", 0))
        live.last_touch = time.monotonic() + 60.0
        sel._copy(("n1", "live", 0))
        with sel._dict_lock:
            keys = set(sel._copies)
        assert ("n0", "live", 0) in keys and ("n1", "live", 0) in keys
        assert not any(k[1] == "old" for k in keys), keys

    def test_all_quarantined_group_still_serves(self, m):
        sel = _selector(m)
        copies = _copies(m, 2)
        _warm_all(sel, copies)
        for c in copies:
            for _ in range(4):
                sel.failure(c)
        assert sel.select(copies) is not None

    def test_ranked_orders_by_health(self, m):
        sel = _selector(m)
        copies = _copies(m, 3)
        _warm_all(sel, copies[:1], seconds=0.2)
        _warm_all(sel, copies[1:2], seconds=0.01)
        _warm_all(sel, copies[2:], seconds=0.05)
        assert [c.node_id for c in sel.ranked(copies)] == ["n2", "n3", "n1"]
        for _ in range(4):
            sel.failure(copies[1])
        assert [c.node_id for c in sel.ranked(copies)] == ["n3", "n1", "n2"]


# ---------------------------------------------------------------------------
# the hedge budget and delay
# ---------------------------------------------------------------------------


class TestHedging:
    def test_budget_token_bucket(self, m):
        b = m.HedgeBudget(ratio=0.05, burst=2.0)
        assert b.try_acquire() and b.try_acquire()
        assert not b.try_acquire()
        assert b.budget_exhausted == 1
        for _ in range(20):
            b.note_request()
        assert b.try_acquire()
        assert not b.try_acquire()
        for _ in range(1000):
            b.note_request()
        assert b.stats()["tokens"] == pytest.approx(2.0)
        assert b.try_acquire()
        b.refund()
        assert b.stats()["tokens"] == pytest.approx(2.0)
        b.refund()
        assert b.stats()["tokens"] == pytest.approx(2.0)

    def test_hedge_delay_cold_copy_is_none(self, m):
        sel = _selector(m)
        (c,) = _copies(m, 1)
        assert sel.hedge_delay_s(c, None) is None

    def test_hedge_delay_tracks_copy_p99(self, m):
        sel = _selector(m)
        (c,) = _copies(m, 1)
        _warm_all(sel, [c], seconds=0.05, n=20)
        d = sel.hedge_delay_s(c, None)
        assert d is not None and 0.03 <= d <= 0.15

    def test_hedge_delay_clamped_by_best_alternative(self, m):
        sel = _selector(m)
        slow, fast = _copies(m, 2)
        _warm_all(sel, [slow], seconds=0.8, n=20)
        _warm_all(sel, [fast], seconds=0.01, n=20)
        d = sel.hedge_delay_s(slow, None, others=[fast])
        assert d is not None and d <= 0.05
        slow2 = _copies(m, 3)[2]
        _warm_all(sel, [slow2], seconds=0.8, n=20)
        d2 = sel.hedge_delay_s(slow, None, others=[slow2])
        assert d2 is not None and d2 >= 0.5

    def test_hedge_delay_clamped_by_deadline(self, m):
        sel = _selector(m)
        (c,) = _copies(m, 1)
        _warm_all(sel, [c], seconds=0.2, n=20)
        d = sel.hedge_delay_s(c, 0.1)
        assert d is not None and d <= 0.05
        assert sel.hedge_delay_s(c, 0.001) is None


def test_same_observations_same_answers(monkeypatch):
    """One seeded stream of latencies, load samples and failures over three
    copies, fed to both packages' selectors on one fake clock (each
    module's `time`): after every step the scores, the ranks, the hedge
    delays and the selection agree exactly, and so do the stats."""
    from elasticsearch_tpu.cluster import stats as jstats
    from elasticsearch_tpu_torch.cluster import stats as pstats

    clock = [1000.0]
    fake = SimpleNamespace(monotonic=lambda: clock[0])
    for mod in (pstats, jstats):
        monkeypatch.setattr(mod, "time", fake)
    port, jax = _ns("port"), _ns("jax")
    sels = {p.pkg: _selector(p) for p in (port, jax)}
    copies = {p.pkg: _copies(p, 3) for p in (port, jax)}
    rng = random.Random(7)
    for step in range(200):
        clock[0] += rng.choice([0.01, 0.5, 2.0])
        i = rng.randrange(3)
        fail = rng.random() < 0.08
        lat = rng.choice([0.005, 0.01, 0.02, 0.4]) * (1.0 + rng.random())
        load = {"queue": step % 3, "headroom": 0.9, "rc_hit_rate": 0.25}
        got = {}
        for pkg, sel in sels.items():
            cs = copies[pkg]
            if fail:
                sel.failure(cs[i])
            else:
                sel.observe(cs[i], lat, load=load)
            entries = [sel._copy(sel.key(c)) for c in cs]
            got[pkg] = (
                [e.score(clock[0], sel.failure_halflife_s) for e in entries],
                [c.node_id for c in sel.ranked(cs)],
                [sel.hedge_delay_s(c, None, others=[o for o in cs if o is not c])
                 for c in cs],
                getattr(sel.select(cs), "node_id", None))
        assert got["port"] == got["jax"], (step, got)
    assert sels["port"].stats() == sels["jax"].stats()


# ---------------------------------------------------------------------------
# _select's preference fall-through
# ---------------------------------------------------------------------------


class TestPreferenceFallthrough:
    def _state(self, m, local_id="n0", n_nodes=4):
        nodes = m.DiscoveryNodes(local_id=local_id)
        for i in range(n_nodes):
            nodes = nodes.with_node(m.DiscoveryNode(f"n{i}", f"n{i}", f"local://n{i}"))
        return m.ClusterState(nodes=nodes)

    def _group(self, m):
        return m.IndexShardRoutingTable(shards=tuple(_copies(m, 3)))

    def test_local_without_local_copy_distributes(self, m):
        state, group = self._state(m), self._group(m)
        r = m.OperationRouting()
        picks = {r._select(group, state, "_local").node_id for _ in range(6)}
        assert picks == {"n1", "n2", "n3"}

    def test_local_with_local_copy_sticks(self, m):
        state, group = self._state(m, local_id="n2"), self._group(m)
        assert all(m.OperationRouting()._select(group, state, "_local").node_id
                   == "n2" for _ in range(4))

    def test_prefer_node_fallthrough_distributes(self, m):
        state, group = self._state(m), self._group(m)
        r = m.OperationRouting()
        picks = {r._select(group, state, "_prefer_node:missing").node_id
                 for _ in range(6)}
        assert picks == {"n1", "n2", "n3"}
        assert r._select(group, state, "_prefer_node:n2").node_id == "n2"

    def test_only_node_still_raises(self, m):
        state, group = self._state(m), self._group(m)
        with pytest.raises(m.NoShardAvailableError):
            m.OperationRouting()._select(group, state, "_only_node:missing")

    def test_session_key_still_stable(self, m):
        state, group = self._state(m), self._group(m)
        r = m.OperationRouting()
        first = r._select(group, state, "session-abc").node_id
        assert all(r._select(group, state, "session-abc").node_id == first
                   for _ in range(5))

    def test_adaptive_pick_avoids_slow_copy(self, m):
        sel = _selector(m)
        copies = _copies(m, 3)
        _warm_all(sel, copies[:2], seconds=0.01)
        _warm_all(sel, copies[2:], seconds=1.0)
        group = m.IndexShardRoutingTable(shards=tuple(copies))
        r = m.OperationRouting(selector=sel)
        picks = [r._select(group, self._state(m), None).node_id for _ in range(16)]
        assert picks.count("n3") <= 16 // sel.probe_every + 1


# ---------------------------------------------------------------------------
# live chaos on a pair of nodes of each package
# ---------------------------------------------------------------------------


A_QUERY_GLOB = "*[phase/query]*"
BODY = {"query": {"match": {"body": "alpha1 alpha2"}}, "size": 3}


class _Pair:
    """Two nodes of one package (names a and b: a is master and
    coordinator), one index `hx` of 1 shard and 1 replica, 30 documents."""

    def __init__(self, m, tmp_path):
        self.m = m
        self.cluster = Cluster(m.pkg, ["a", "b"], tmp_path,
                               settings={"search.hedge.burst": 24})
        try:
            self.coord, self.other = self.cluster.nodes
            client = self.coord.client()
            client.create_index("hx", {"settings": {
                "number_of_shards": 1, "number_of_replicas": 1}})
            assert self.cluster.settled("hx")
            for i in range(30):
                client.index("hx", "doc", {"body": f"alpha{i % 4} alpha{(i + 1) % 4}",
                                           "n": i}, id=str(i))
            client.refresh("hx")
        except BaseException:
            self.cluster.close()
            raise

    def policy(self, node, seed):
        return self.m.FaultPolicy(seed).install(node.transport)

    def clear_faults(self):
        for n in self.cluster.nodes:
            if n.transport.fault_policy is not None:
                n.transport.fault_policy.clear()

    def close(self):
        self.cluster.close()


@pytest.fixture
def pair(m, tmp_path):
    p = _Pair(m, tmp_path)
    try:
        yield p
    finally:
        p.close()


def _key(node, index="hx", shard=0):
    return f"{node.node_id}/{index}/{shard}"


def _warm(coord, keys, max_iters=200):
    """Warm until both copies carry min_samples observations and their
    EWMAs are within 3x of each other (a copy's first search packs its
    segments inline and lands in one copy's stats as an outlier)."""
    sel = coord.adaptive_routing
    for _ in range(max_iters):
        coord.actions.search("hx", BODY)
        copies = sel.stats()["copies"]
        if all(k in copies and copies[k]["samples"] >= sel.min_samples for k in keys):
            ew = [copies[k]["ewma_ms"] for k in keys]
            if max(ew) <= max(3.0 * min(ew), 60.0):
                return
    raise AssertionError(f"warmup never converged: {sel.stats()['copies']}")


def _drive(coord, n):
    durs = []
    for _ in range(n):
        t0 = time.monotonic()
        r = coord.actions.search("hx", BODY)
        durs.append(time.monotonic() - t0)
        assert r["hits"]["total"] > 0
    return sorted(durs)


class TestChaosAdaptiveRouting:
    def test_slow_replica_shifts_traffic_hedges_bound_tail_then_recovers(self, pair):
        coord, other = pair.coord, pair.other
        sel = coord.adaptive_routing
        slow_key, fast_key = _key(other), _key(coord)
        _warm(coord, [slow_key, fast_key])
        healthy_p99 = _drive(coord, 10)[-1]
        pair.policy(other, 11).delay(0.75, action=A_QUERY_GLOB, direction="recv")
        before = sel.stats()
        b_slow = before["copies"][slow_key]["selected"]
        b_fast = before["copies"][fast_key]["selected"]
        durs = _drive(coord, 40)
        after = sel.stats()
        slow_delta = after["copies"][slow_key]["selected"] - b_slow
        fast_delta = after["copies"][fast_key]["selected"] - b_fast
        assert slow_delta <= 15, (slow_delta, fast_delta)
        assert fast_delta >= 25, (slow_delta, fast_delta)
        assert after["hedges"]["issued"] > before["hedges"]["issued"]
        assert after["hedges"]["won"] > before["hedges"]["won"]
        p95 = durs[int(0.95 * len(durs)) - 1]
        assert p95 < 0.7, (p95, durs[-3:])
        assert p95 < max(2.0 * healthy_p99, 0.45), (p95, healthy_p99)
        pair.clear_faults()
        restored = False
        for _chunk in range(15):
            base = sel.stats()["copies"][slow_key]["selected"]
            _drive(coord, 16)
            if sel.stats()["copies"][slow_key]["selected"] - base >= 5:
                restored = True
                break
        assert restored, sel.stats()["copies"]
        assert sel.stats()["probes"] > 0

    def test_failing_copy_quarantines_and_probes_back(self, pair):
        coord, other = pair.coord, pair.other
        sel = coord.adaptive_routing
        slow_key = _key(other)
        _warm(coord, [slow_key, _key(coord)])
        pair.policy(coord, 7).error(action=A_QUERY_GLOB,
                                    node=other.local_node.transport_address)
        quarantined = False
        for _chunk in range(8):
            _drive(coord, 8)
            if sel.stats()["copies"][slow_key]["quarantined"]:
                quarantined = True
                break
        st = sel.stats()
        assert quarantined, st["copies"]
        assert st["quarantined"] == 1
        pair.clear_faults()
        readmitted = False
        for _chunk in range(12):
            _drive(coord, 8)
            if not sel.stats()["copies"][slow_key]["quarantined"]:
                readmitted = True
                break
        assert readmitted, sel.stats()["copies"]
        assert sel.stats()["probes"] > 0
        restored = False
        for _chunk in range(10):
            base = sel.stats()["copies"][slow_key]["selected"]
            _drive(coord, 16)
            if sel.stats()["copies"][slow_key]["selected"] - base >= 5:
                restored = True
                break
        assert restored, sel.stats()["copies"]

    def test_all_copies_slow_budget_bounds_hedges(self, pair):
        coord = pair.coord
        sel = coord.adaptive_routing
        _warm(coord, [_key(coord), _key(pair.other)])
        for n in (coord, pair.other):
            pair.policy(n, 13).delay(0.25, action=A_QUERY_GLOB, direction="recv")
        with sel.hedges._lock:
            sel.hedges.tokens = 0.0
        b = sel.hedges.stats()
        _drive(coord, 8)
        mid = sel.hedges.stats()
        assert mid["issued"] == b["issued"], mid
        assert mid["budget_exhausted"] > b["budget_exhausted"], mid
        with sel.hedges._lock:
            sel.hedges.tokens = 3.0
        durs = _drive(coord, 16)
        a = sel.hedges.stats()
        assert a["issued"] - mid["issued"] <= 4, a
        assert durs[-1] < 1.5, durs[-3:]

    def test_hedge_trace_and_profile_integration(self, pair):
        m, coord, other = pair.m, pair.coord, pair.other
        sel = coord.adaptive_routing
        _warm(coord, [_key(coord), _key(other)])
        pair.policy(other, 17).delay(1.5, action=A_QUERY_GLOB, direction="recv")
        with sel.hedges._lock:
            sel.hedges.tokens = sel.hedges.burst
        rc = m.build_rest_controller(coord)
        pref = f"_prefer_node:{other.node_id}"
        r = rc.dispatch(m.RestRequest(method="POST", path="/hx/_search",
                                      params={"trace": "true", "preference": pref},
                                      body=BODY))
        assert r.status == 200
        tid = r.body["trace"]["trace_id"]

        def flatten(node_, out):
            out.append(node_)
            for ch in node_.get("children", []):
                flatten(ch, out)
            return out

        inline = flatten(r.body["trace"]["tree"], [])
        assert [s for s in inline if s["name"] == "shard"
                and s.get("tags", {}).get("hedge")], [s["name"] for s in inline]
        shard_spans = []
        deadline = time.monotonic() + 8.0
        while time.monotonic() < deadline:
            snaps = [t for t in coord.tracer.traces() if t["trace_id"] == tid]
            if snaps:
                shard_spans = [s for s in snaps[0]["spans"] if s["name"] == "shard"]
                if len(shard_spans) >= 2:
                    break
            time.sleep(0.05)
        assert len(shard_spans) >= 2, shard_spans
        assert any(s["tags"].get("hedge") for s in shard_spans)
        assert any(not s["tags"].get("hedge") for s in shard_spans)
        shards = None
        for _attempt in range(3):
            r = rc.dispatch(m.RestRequest(method="POST", path="/hx/_search",
                                          params={"profile": "true", "preference": pref},
                                          body=BODY))
            assert r.status == 200
            shards = r.body["profile"]["shards"]
            assert shards and shards[0]["winner"] in ("primary", "hedge")
            if shards[0]["winner"] == "hedge":
                break
        assert shards[0]["winner"] == "hedge", shards
        # a hard pin never hedges, also after a `_shards:N;` prefix
        b = sel.hedges.stats()
        for p in (f"_only_node:{other.node_id}", f"_shards:0;_only_node:{other.node_id}"):
            r = rc.dispatch(m.RestRequest(method="POST", path="/hx/_search",
                                          params={"profile": "true", "preference": p},
                                          body=BODY))
            assert r.status == 200
            shards = r.body["profile"]["shards"]
            assert shards[0]["winner"] == "primary", shards
            assert shards[0]["node"] == other.node_id, shards
            assert sel.hedges.stats()["issued"] == b["issued"]

    def test_nodes_stats_surface(self, pair):
        m, coord = pair.m, pair.coord
        _warm(coord, [_key(coord), _key(pair.other)])
        rc = m.build_rest_controller(coord)
        r = rc.dispatch(m.RestRequest(method="GET", path="/_nodes/stats/adaptive_routing",
                                      params={}))
        assert r.status == 200
        (sections,) = r.body["nodes"].values()
        ar = sections["adaptive_routing"]
        assert set(ar) == {"enabled", "min_samples", "copies", "selections", "probes",
                           "quarantined", "hedges"}
        assert set(ar["hedges"]) == {"issued", "won", "budget_exhausted", "tokens",
                                     "ratio", "burst"}
        assert set(ar["selections"]) == {"adaptive", "round_robin", "probe", "affinity"}
        copy = ar["copies"][_key(coord)]
        assert set(copy) == {"ewma_ms", "p99_ms", "queue", "headroom", "outstanding",
                             "failures", "samples", "selected", "quarantined",
                             "rc_hit_rate"}
        assert copy["samples"] > 0
