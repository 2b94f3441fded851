"""The event journal and stall watchdog (elasticsearch_tpu_torch/common/
events.py), `DevicePullFaults` (transport/faults.py) and the device fault
domains' publishers (common/devicehealth.py), on the CPU: port copies of
tests/test_watchdog_events.py's `TestEventJournal`, `TestWatchdogChecks`,
`TestLiveWatchdog::test_device_pull_stall_detected_within_two_periods` and
`TestDevicePullFaults`, each also run on the JAX package's classes with the
same inputs where they take no node, and the gossip case
(`test_gossip_reaches_peer_journals_and_events_dedup`) on a pair of nodes
of each package.

- Journal: the ring bound, the per-(type, key) rate limit, the bounded
  vocabulary, remote ingest with its dedup and its stamping of a missing
  ts — the port's journal and the JAX one give the same events and stats.
- Checks against stub serving state: a batch stall against the batcher's
  EWMA, a queue-wait spike over the last tick's delta histogram, a breaker
  dwelling near its limit, a check that raises not ending the tick.
- Live, on a port node: DEVICE_PULL stalls one index's pull for 2 s; a
  `batch_stall` event naming the index and the batch reaches `node.events`
  within the threshold plus two watchdog periods, and healthy traffic keeps
  serving meanwhile: with a one-slot coalescing queue, a search finding the
  slot taken is launched on its caller's thread (the port has no request
  cache to answer it, as the JAX test's healthy search is answered). The
  stalled search lands with the host reference's hits.
- DEVICE_HEALTH publishes each trip and recovery to every registered node
  journal: under DEVICE_FAULTS, a port node's journal and a JAX node's
  record the same `device_degraded` and `device_recovered` events (domain,
  classification); a closed node unregisters its journal.

Both packages' injectors (DEVICE_PULL, DEVICE_FAULTS) and trackers
(DEVICE_HEALTH) are reset around every test; every node is closed in a
`finally`."""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import pytest

from elasticsearch_tpu.common.devicehealth import DEVICE_HEALTH as J_HEALTH
from elasticsearch_tpu.transport.faults import DEVICE_FAULTS as J_FAULTS
from elasticsearch_tpu.transport.faults import DEVICE_PULL as J_PULL
from elasticsearch_tpu_torch.common.devicehealth import DEVICE_HEALTH
from elasticsearch_tpu_torch.common.events import (EVENT_TYPES, EventJournal,
                                                   StallWatchdog)
from elasticsearch_tpu_torch.common.metrics import HistogramMetric
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.transport.faults import DEVICE_FAULTS, DEVICE_PULL
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg


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


def _packages():
    """(package name, EventJournal, StallWatchdog, Settings,
    HistogramMetric) of each package."""
    from elasticsearch_tpu.common import events as jevents
    from elasticsearch_tpu.common.metrics import HistogramMetric as JHist
    from elasticsearch_tpu.common.settings import Settings as JSettings

    return {"port": (EventJournal, StallWatchdog, Settings, HistogramMetric),
            "jax": (jevents.EventJournal, jevents.StallWatchdog, JSettings, JHist)}


PACKAGES = ["port", "jax"]


def _strip(events):
    """Events without their clocks."""
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


# ---------------------------------------------------------------------------
# journal units
# ---------------------------------------------------------------------------


class TestEventJournal:
    def _journal(self, pkg="port", **flat):
        journal, _dog, settings, _h = _packages()[pkg]
        return journal(settings.from_flat(flat), node_name="n1", node_id="n1")

    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_publish_shape_and_ring_bound(self, pkg):
        j = self._journal(pkg, **{"node.events.size": 8,
                                  "node.events.throttle": "0ms"})
        for i in range(20):
            ev = j.publish("queue_spike", f"m{i}", key=f"k{i}", pool="search")
            assert ev is not None
            assert ev["type"] == "queue_spike" and ev["node"] == "n1"
            assert ev["attrs"] == {"pool": "search"}
        assert len(j.events()) == 8  # ring bound
        assert j.events()[0]["message"] == "m19"  # newest first
        assert j.stats()["emitted"] == 20

    def test_port_and_jax_journals_agree(self):
        flat = {"node.events.size": 8, "node.events.throttle": "10s"}
        port, jax = self._journal("port", **flat), self._journal("jax", **flat)
        for j in (port, jax):
            for i in range(12):
                j.publish("batch_stall" if i % 3 else "new-type", f"m{i}",
                          key=f"b:{i % 5}", batch=i)
            j.ingest({"seq": 3, "node": "n2", "type": "queue_spike", "ts": 1.0})
            j.ingest({"seq": 3, "node": "n2", "type": "queue_spike", "ts": 1.0})
        assert port.stats() == jax.stats()
        assert [e["seq"] for e in port.events()] == [e["seq"] for e in jax.events()]
        assert _strip(port.events()) == _strip(jax.events())

    def test_rate_limit_per_type_key(self):
        j = self._journal(**{"node.events.throttle": "10s"})
        assert j.publish("batch_stall", "x", key="b:1") is not None
        assert j.publish("batch_stall", "x again", key="b:1") is None
        assert j.publish("batch_stall", "other batch", key="b:2") is not None
        assert j.publish("queue_spike", "other type", key="b:1") is not None
        assert j.stats()["suppressed"] == 1

    def test_unknown_type_folds_to_watchdog(self):
        from elasticsearch_tpu.common.events import EVENT_TYPES as J_TYPES

        j = self._journal()
        ev = j.publish("totally-new", "m")
        assert ev["type"] == "watchdog"
        assert set(j.stats()["by_type"]) == set(EVENT_TYPES) == set(J_TYPES)

    def test_ingest_stamps_missing_ts(self):
        j = self._journal()
        assert j.ingest({"seq": 1, "node": "n2", "type": "batch_stall"})
        assert j.ingest({"seq": 2, "node": "n2", "type": "batch_stall",
                         "ts": "bogus"})
        evs = j.events()  # must not raise
        assert all(isinstance(e["ts"], float) and e["ts"] > 0 for e in evs)

    def test_remote_ingest_dedup(self):
        j = self._journal()
        ev = {"seq": 3, "ts": time.time(), "node": "n2", "type": "batch_stall",
              "severity": "warn", "message": "remote", "attrs": {}}
        assert j.ingest(ev) is True
        assert j.ingest(dict(ev)) is False  # same origin seq
        assert j.ingest({**ev, "seq": 2}) is False  # older than watermark
        assert j.ingest({**ev, "seq": 4}) is True
        assert j.ingest({**ev, "node": "n1", "seq": 99}) is False  # our own
        st = j.stats()
        assert st["remote_ingested"] == 2 and st["remote_duplicates"] == 2


# ---------------------------------------------------------------------------
# watchdog check units (stub serving state)
# ---------------------------------------------------------------------------


def _stub_node(pkg="port", **over):
    journal, _dog, settings, _h = _packages()[pkg]
    node = SimpleNamespace(
        node_id="n1",
        settings=settings.EMPTY,
        events=journal(settings.from_flat({"node.events.throttle": "0ms"}),
                       node_id="n1"),
        search_batcher=SimpleNamespace(inflight=lambda: None, _ewma_cost=0.004),
        threadpool=SimpleNamespace(pool_histograms=lambda: {}),
        breakers=SimpleNamespace(stats=lambda: {}),
        cluster_service=SimpleNamespace(
            state=SimpleNamespace(nodes=SimpleNamespace(nodes=[]))),
    )
    for k, v in over.items():
        setattr(node, k, v)
    return node


def _dog(node, pkg="port", **flat):
    _journal, dog, settings, _h = _packages()[pkg]
    return dog(node, settings.from_flat(flat))


class TestWatchdogChecks:
    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_batch_stall_adaptive_threshold(self, pkg):
        node = _stub_node(pkg)
        snap = {"batch": 7, "age_s": 0.3, "family": "flat",
                "occupancy": 4, "shard": "idx"}
        node.search_batcher = SimpleNamespace(inflight=lambda: snap,
                                              _ewma_cost=0.01)
        dog = _dog(node, pkg, **{"watchdog.batch_stall_min": "100ms",
                                 "watchdog.batch_stall_factor": 8.0})
        dog.tick()
        (ev,) = [e for e in node.events.events() if e["type"] == "batch_stall"]
        assert ev["attrs"]["batch"] == 7 and ev["attrs"]["shard"] == "idx"
        assert "idx" in ev["message"] and "[7]" in ev["message"]
        # a batch younger than factor x EWMA stays quiet
        node2 = _stub_node(pkg)
        node2.search_batcher = SimpleNamespace(
            inflight=lambda: {**snap, "age_s": 0.05}, _ewma_cost=0.01)
        dog2 = _dog(node2, pkg, **{"watchdog.batch_stall_min": "100ms",
                                   "watchdog.batch_stall_factor": 8.0})
        dog2.tick()
        assert node2.events.events() == []

    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_queue_spike_on_delta_p99(self, pkg):
        hist = _packages()[pkg][3]()
        node = _stub_node(pkg, threadpool=SimpleNamespace(
            pool_histograms=lambda: {"search": hist}))
        dog = _dog(node, pkg, **{"watchdog.queue_p99_min": "50ms",
                                 "watchdog.queue_min_samples": 4})
        dog.tick()  # primes the delta baseline
        for _ in range(10):
            hist.observe(0.001)
        dog.tick()  # a healthy tick, learns a ~1 ms baseline
        assert node.events.events() == []
        for _ in range(10):
            hist.observe(0.8)  # the brown-out
        dog.tick()
        (ev,) = [e for e in node.events.events() if e["type"] == "queue_spike"]
        assert ev["attrs"]["pool"] == "search"
        assert ev["attrs"]["p99_ms"] > 500
        assert dog.stats()["baselines"]["queue_p99_ms"]["search"] > 0

    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_breaker_dwell_needs_consecutive_ticks(self, pkg):
        stats = {"request": {"limit": 100, "estimated": 95, "tripped": 0}}
        node = _stub_node(pkg, breakers=SimpleNamespace(stats=lambda: stats))
        dog = _dog(node, pkg, **{"watchdog.breaker_dwell_ticks": 2})
        dog.tick()
        assert node.events.events() == []  # dwell 1 of 2
        dog.tick()
        (ev,) = [e for e in node.events.events()
                 if e["type"] == "breaker_pressure"]
        assert ev["attrs"]["breaker"] == "request"
        assert ev["attrs"]["dwell_ticks"] == 2
        # dropping below the line resets the dwell
        stats["request"]["estimated"] = 10
        dog.tick()
        stats["request"]["estimated"] = 95
        dog.tick()
        assert len([e for e in node.events.events()
                    if e["type"] == "breaker_pressure"]) == 1

    def test_broken_check_does_not_kill_the_tick(self):
        node = _stub_node(breakers=SimpleNamespace(
            stats=lambda: (_ for _ in ()).throw(RuntimeError("boom"))))
        dog = _dog(node)
        dog.tick()  # must not raise
        assert dog.ticks == 1

    def test_port_and_jax_watchdogs_journal_alike(self):
        """One stub state a tick, both packages' watchdogs: the same events
        (messages and attrs) and stats."""
        snaps = [None, {"batch": 3, "age_s": 0.9, "family": "flat",
                        "occupancy": 2, "shard": "s"}, None]
        logs = {}
        for pkg in PACKAGES:
            hist = _packages()[pkg][3]()
            stats = {"request": {"limit": 100, "estimated": 90}}
            step = iter(range(10))
            node = _stub_node(pkg, threadpool=SimpleNamespace(
                pool_histograms=lambda: {"search": hist}),
                breakers=SimpleNamespace(stats=lambda: stats))
            dog = _dog(node, pkg, **{"watchdog.queue_min_samples": 2})
            for i, snap in zip(step, snaps):
                node.search_batcher = SimpleNamespace(
                    inflight=lambda s=snap: s, _ewma_cost=0.01)
                for _ in range(3):
                    hist.observe(0.002 if i < 2 else 0.9)
                dog.tick()
            dstats = dog.stats()
            dstats.pop("enabled", None)  # the port's watchdog has no off switch
            logs[pkg] = ([(e["type"], e["message"], e["attrs"])
                          for e in node.events.events()], dstats)
        assert logs["port"] == logs["jax"]
        assert {t for t, _m, _a in logs["port"][0]} == {
            "batch_stall", "queue_spike", "breaker_pressure"}


# ---------------------------------------------------------------------------
# live: a stalled pull on a port node
# ---------------------------------------------------------------------------


WATCHDOG_SETTINGS = {
    "node.device": "cpu",
    "watchdog.interval": "100ms",
    "watchdog.batch_stall_min": "200ms",
    "watchdog.batch_stall_factor": 2.0,
    "node.events.throttle": "0ms",
    # a one-slot coalescing queue: a search finding it taken is launched on
    # its caller's thread while the drainer is wedged on the stall
    "search.batch.queue_size": 1,
}


class TestLiveWatchdog:
    def test_device_pull_stall_detected_within_two_periods(self, tmp_path):
        node = PNode(name="w", settings=WATCHDOG_SETTINGS, registry=PReg(),
                     data_path=str(tmp_path))
        try:
            node.start()
            c = node.client()
            for name in ("stall", "healthy"):
                c.create_index(name, {"settings": {"number_of_shards": 1,
                                                   "number_of_replicas": 0}})
                c.cluster_health(name, wait_for_status="green")
                for i in range(15):
                    c.index(name, "doc", {"body": f"alpha{i % 3}"}, id=str(i))
                c.refresh(name)
            interval = node.watchdog.interval_s
            threshold = node.watchdog.batch_min_s
            # warm both indices (their first searches pack inline)
            c.search("stall", {"query": {"match": {"body": "alpha1"}}})
            want = c.search("healthy", {"query": {"match": {"body": "alpha1"}}})
            # a warm-up's inline pack may have journaled its own stall: only
            # an event after this one counts
            seq0 = max((e["seq"] for e in node.events.events()), default=0)
            DEVICE_PULL.arm(2.0, index="stall", times=1)
            out = {}

            def stalled():
                t0 = time.monotonic()
                out["r"] = c.search("stall", {"query": {"match": {"body": "alpha2"}}})
                out["dt"] = time.monotonic() - t0

            th = threading.Thread(target=stalled)
            t_start = time.monotonic()
            th.start()
            deadline = threshold + 2 * interval + 0.35
            ev = None
            while time.monotonic() - t_start < 2.0 and ev is None:
                evs = [e for e in node.events.events() if e["type"] == "batch_stall"
                       and e["attrs"]["shard"] == "stall" and e["seq"] > seq0]
                ev = evs[0] if evs else None
                if ev is None:
                    time.sleep(0.02)
            detected_at = time.monotonic() - t_start
            assert ev is not None, "stall never detected"
            assert detected_at <= deadline, (detected_at, deadline)
            # the event names the shard's index and the batch
            assert ev["attrs"]["shard"] == "stall"
            assert isinstance(ev["attrs"]["batch"], int)
            assert "stall" in ev["message"] and ev["severity"] == "warn"

            # healthy traffic keeps serving DURING the stall: one search takes
            # the queue's one slot (it waits for the wedged drainer), the next
            # finds it taken and launches on its own thread
            queued = threading.Thread(target=lambda: out.setdefault(
                "queued", c.search("healthy", {"query": {"match": {"body": "alpha1"}}})))
            queued.start()
            t_q = time.monotonic()
            while node.search_batcher.stats()["queue"] < 1 and \
                    time.monotonic() - t_q < 1.0:
                time.sleep(0.005)
            bypassed = node.search_batcher.stats()["bypassed"]
            t0 = time.monotonic()
            r = c.search("healthy", {"query": {"match": {"body": "alpha1"}}})
            assert r["hits"] == want["hits"]
            assert time.monotonic() - t0 < 1.0
            assert node.search_batcher.stats()["bypassed"] == bypassed + 1
            assert time.monotonic() - t_start < 2.0, \
                "healthy check ran after the stall already cleared"

            th.join(10.0)
            queued.join(10.0)
            assert out["r"]["hits"]["total"] == 5  # the stalled search lands
            assert out["dt"] >= 2.0
            assert out["queued"]["hits"] == want["hits"]
            assert DEVICE_PULL.injected >= 1 and not DEVICE_PULL.active
        finally:
            DEVICE_PULL.disarm()
            node.close()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_gossip_reaches_peer_journals_and_events_dedup(pkg, tmp_path):
    """The port's copy of tests/test_watchdog_events.py's gossip case, on a
    pair of nodes of each package: an event the origin's watchdog emits
    (`_emit`, which gossips it) lands in the peer's journal under the
    origin's node id, and `/_events` on the peer counts it once."""
    from tests.test_torch_two_nodes import Cluster

    cluster = Cluster(pkg, ["a", "b"], tmp_path)
    try:
        origin, peer = cluster.nodes
        origin.watchdog._emit("breaker_pressure", "breaker [request] dwelling",
                              key="breaker:request", breaker="request")
        _wait(lambda: peer.events.stats()["remote_ingested"] >= 1,
              what="the gossiped event ingested")
        remote = [e for e in peer.events.events() if e["type"] == "breaker_pressure"]
        assert remote and remote[0]["node"] == origin.node_id
        matching = [e for e in peer.client().cluster_events()["events"]
                    if e["type"] == "breaker_pressure"]
        assert len(matching) == 1, matching
        # a second gossip of the same event is a duplicate, stored once
        origin.watchdog._gossip(remote[0])
        _wait(lambda: peer.events.stats()["remote_duplicates"] >= 1,
              what="the duplicate counted")
        assert peer.events.stats()["remote_ingested"] == 1
    finally:
        cluster.close()


class TestDevicePullFaults:
    @pytest.mark.parametrize("pkg", PACKAGES)
    def test_arm_times_and_index_matching(self, pkg):
        pull = DEVICE_PULL if pkg == "port" else J_PULL
        pull.disarm()
        pull.arm(0.5, index="only-this", times=2)
        try:
            assert pull.delay_for("other") == 0.0
            assert pull.delay_for("only-this") == 0.5
            assert pull.delay_for("only-this") == 0.5
            # budget exhausted -> auto-disarm
            assert pull.delay_for("only-this") == 0.0
            assert pull.active is False
        finally:
            pull.disarm()

    def test_disarmed_pull_is_one_attribute_read(self, monkeypatch):
        """wait_pull reads `active` and nothing else while disarmed."""
        from elasticsearch_tpu_torch.common.cudaenv import PendingPull
        from elasticsearch_tpu_torch.search.execute import wait_pull

        calls = []
        monkeypatch.setattr(DEVICE_PULL, "delay_for",
                            lambda index: calls.append(index) or 0.0)
        assert wait_pull(PendingPull(None, [], None), "x") == []
        assert calls == []
        DEVICE_PULL.active = True
        try:
            wait_pull(PendingPull(None, [], None), "x")
        finally:
            DEVICE_PULL.active = False
        assert calls == ["x"]


# ---------------------------------------------------------------------------
# DEVICE_HEALTH's trips and recoveries in the node journals
# ---------------------------------------------------------------------------


def _transitions(journal, domain):
    return [(e["type"], e["attrs"]["domain"], e["attrs"].get("classification"))
            for e in reversed(journal.events())
            if e["type"] in ("device_degraded", "device_recovered")
            and e["attrs"].get("domain") == domain]


def _wait(cond, timeout=15.0, what=""):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def test_device_health_trips_and_recoveries_reach_the_journals(tmp_path):
    """Under the same DEVICE_FAULTS arm, a port node's journal and a JAX
    node's hold the same `device_degraded` then `device_recovered` event of
    the armed domain; a closed node's journal is unregistered."""
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu.transport.local import LocalTransportRegistry as JReg

    p = PNode(name="pub", settings={"node.device": "cpu"}, registry=PReg(),
              data_path=str(tmp_path / "p"))
    j = JNode(name="jpub", settings={"search.mesh.enabled": "false",
                                     "indices.warmer.enabled": "false"},
              registry=JReg(), data_path=str(tmp_path / "j"))
    try:
        p.start()
        j.start([j.local_node.transport_address])
        j.wait_for_master()
        body = {"query": {"match": {"body": "alpha"}}}
        # the JAX node's request cache (not in the port yet) is bypassed
        bodies = (body, {**body, "request_cache": False})
        clients = (p.client(), j.client())
        for c, body in zip(clients, bodies):
            c.create_index("pub", {"settings": {"number_of_shards": 1,
                                                "number_of_replicas": 0}})
            c.cluster_health("pub", wait_for_status="green")
            for i in range(10):
                c.index("pub", "doc", {"body": f"alpha beta{i}"}, id=str(i))
            c.refresh("pub")
            assert c.search("pub", body)["hits"]["total"] == 10  # packs inline
        domain = "pull:pub"
        for faults in (DEVICE_FAULTS, J_FAULTS):
            faults.arm(error="transfer", domain=domain, times=10**6)
        for c, body in zip(clients, bodies):
            r = c.search("pub", body)  # a persistent error: trips at once
            assert r["hits"]["total"] == 10 and r["_shards"]["degraded"] == 1
        for faults in (DEVICE_FAULTS, J_FAULTS):
            faults.disarm()
        for c, health, body in zip(clients, (DEVICE_HEALTH, J_HEALTH), bodies):
            _wait(lambda: (c.search("pub", body), not health.any_open)[1],
                  what="the domain's recovery")
        got, want = _transitions(p.events, domain), _transitions(j.events, domain)
        assert got == want == [("device_degraded", domain, "persistent"),
                               ("device_recovered", domain, None)]
        assert p.events.stats()["by_type"]["device_degraded"] == 1
        assert p.node_id in DEVICE_HEALTH._publishers
    finally:
        p.close()
        j.close()
    assert p.node_id not in DEVICE_HEALTH._publishers
