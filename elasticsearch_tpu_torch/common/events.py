"""Event journal and serving-path stall watchdog (a trimmed copy of the JAX
package's `common/events.py`).

- **EventJournal**: a bounded, rate-limited ring of typed events on each
  node. Every event carries (seq, epoch ts, node, type, severity, message,
  attrs); a per-(type, key) rate limit keeps a sustained condition from
  flooding the ring (suppressed emissions are counted, never silently
  dropped). `ingest` takes an event another node sent, deduplicated by its
  origin's seq.
- **StallWatchdog**: a management-pool periodic task that compares live
  in-flight state against adaptive thresholds:

    batch_stall       the oldest dispatched, unmerged batch's age against
                      the batcher's own service-time EWMA
                      (DeviceBatcher.inflight(): an unlocked read of state
                      only the drainer writes)
    queue_spike       each pool's queue-wait p99 over the tasks since the
                      last tick (delta histograms: a lifetime p99 would take
                      minutes to notice a brown-out) against a decayed
                      baseline
    breaker_pressure  a breaker dwelling `dwell` consecutive ticks or more
                      above BREAKER_HIGH_RATIO of its limit
    lock_stall        the lock tracer's (common/locktrace.py, when armed)
                      counters of waits on the card made under a held lock
                      grew since the last tick

The event vocabulary is bounded: batch_stall | queue_spike |
breaker_pressure | lock_stall | watchdog | device_degraded |
device_recovered (the last two are the device fault domains' trips and
recoveries, published by common/devicehealth).

Each event the watchdog emits is gossiped to the other nodes of the
cluster (`_gossip`: fire-and-forget sends from the tick), whose journals
ingest it; `GET /_events` (node.py `cluster_events`) pulls every node's
journal and deduplicates.

Hot-path contract: the watchdog runs on the management pool and reads
serving-side state as plain attributes or through leaf-locked stats()
calls; it takes no serving-path lock and touches no device. The journal's
lock is a leaf (deque and dict work only)."""

from __future__ import annotations

import threading
import time
from collections import deque

from .logging import get_logger
from .settings import Settings

EVENT_TYPES = ("batch_stall", "queue_spike", "breaker_pressure",
               "lock_stall", "watchdog",
               # device fault-domain circuit transitions (common/devicehealth)
               "device_degraded", "device_recovered")


class EventJournal:
    """Bounded per-node ring of typed events (newest kept).

    `_lock` is a leaf: deque, dict and counter work only."""

    def __init__(self, settings: Settings | None = None, node_name: str = "node",
                 node_id: str = "node"):
        settings = settings or Settings.EMPTY
        self.node_name = node_name
        self.node_id = node_id
        self.size = max(8, settings.get_int("node.events.size", 256))
        # minimum seconds between two emissions of the same (type, key): a
        # wedged drainer must not fill the ring with one stall
        self.throttle_s = settings.get_time("node.events.throttle", 10.0)
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=self.size)
        self._seq = 0
        self._last_emit: dict[tuple, float] = {}  # (type, key) -> monotonic
        self._remote_seen: dict[str, int] = {}  # origin node -> max seq
        self.emitted = 0
        self.suppressed = 0
        self.remote_ingested = 0
        self.remote_duplicates = 0
        self.by_type: dict[str, int] = {t: 0 for t in EVENT_TYPES}

    # -- write ---------------------------------------------------------------
    def publish(self, type_: str, message: str, severity: str = "warn",
                key: str | None = None, **attrs) -> dict | None:
        """Emit one local event; returns the event, or None when the
        (type, key) pair is inside its rate-limit window (counted)."""
        if type_ not in EVENT_TYPES:
            type_ = "watchdog"
        now = time.monotonic()
        with self._lock:
            rk = (type_, key)
            last = self._last_emit.get(rk)
            if last is not None and self.throttle_s \
                    and now - last < self.throttle_s:
                self.suppressed += 1
                return None
            self._last_emit[rk] = now
            # the rate-limit map must not grow one entry per transient key
            # (batch ids are unbounded): drop expired windows
            if len(self._last_emit) > 4 * self.size:
                self._last_emit = {
                    k: v for k, v in self._last_emit.items()
                    if now - v < (self.throttle_s or 0.0)}
            self._seq += 1
            event = {
                "seq": self._seq,
                "ts": time.time(),
                "node": self.node_id,
                "node_name": self.node_name,
                "type": type_,
                "severity": severity,
                "message": message,
                "attrs": attrs,
            }
            self._ring.append(event)
            self.emitted += 1
            self.by_type[type_] = self.by_type.get(type_, 0) + 1
        return event

    def ingest(self, event: dict) -> bool:
        """Store an event another node sent (deduplicated by its origin's
        increasing seq). Returns True when stored."""
        if not isinstance(event, dict) or "seq" not in event:
            return False
        origin = str(event.get("node", "?"))
        if origin == self.node_id:
            return False  # our own event, sent back
        seq = int(event["seq"])
        stored = dict(event)
        try:
            # a malformed ts would break every later events() sort: stamp
            # the arrival time
            stored["ts"] = float(stored.get("ts") or 0.0) or time.time()
        except (TypeError, ValueError):
            stored["ts"] = time.time()
        with self._lock:
            if seq <= self._remote_seen.get(origin, 0):
                self.remote_duplicates += 1
                return False
            self._remote_seen[origin] = seq
            self._ring.append(stored)
            self.remote_ingested += 1
        return True

    # -- read ----------------------------------------------------------------
    def events(self, limit: int | None = None) -> list[dict]:
        """Newest first."""
        with self._lock:
            out = list(self._ring)
        out.sort(key=lambda e: -float(e.get("ts", 0.0)))
        return out if limit is None else out[: max(limit, 0)]

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": self.size,
                "entries": len(self._ring),
                "emitted": self.emitted,
                "suppressed": self.suppressed,
                "remote_ingested": self.remote_ingested,
                "remote_duplicates": self.remote_duplicates,
                "by_type": dict(self.by_type),
            }


# queue spike: a tick's p99 queue wait above this many times the pool's
# decayed baseline (and above `watchdog.queue_p99_min`)
QUEUE_P99_FACTOR = 4.0
# breaker dwell: a breaker counts as high at this share of its limit
BREAKER_HIGH_RATIO = 0.85


class StallWatchdog:
    """Management-pool watchdog: detects serving-path stalls from live state
    and journals typed, rate-limited events in `node.events`.

    Every threshold adapts around a signal the node keeps anyway (the
    batcher's service-time EWMA, each pool's queue-wait histogram, the
    breakers' estimates), with settable floors: a cold node with no
    baseline uses the floors."""

    def __init__(self, node, settings: Settings | None = None):
        settings = settings or getattr(node, "settings", None) or Settings.EMPTY
        self.node = node
        self.interval_s = max(0.05, settings.get_time("watchdog.interval", 1.0))
        # batch stall: age > max(min, factor x the batcher's EWMA)
        self.batch_factor = settings.get_float("watchdog.batch_stall_factor", 16.0)
        self.batch_min_s = settings.get_time("watchdog.batch_stall_min", 0.5)
        # queue spike: delta p99 > max(min, factor x decayed baseline), with
        # at least min_samples tasks since the last tick
        self.queue_min_s = settings.get_time("watchdog.queue_p99_min", 0.25)
        self.queue_min_samples = settings.get_int("watchdog.queue_min_samples", 8)
        # breaker dwell: >= dwell consecutive ticks above BREAKER_HIGH_RATIO
        self.breaker_dwell = max(1, settings.get_int(
            "watchdog.breaker_dwell_ticks", 2))
        self.ticks = 0
        self._task = None
        # per-pool delta-histogram state and decayed p99 baseline
        self._pool_counts: dict[str, list[int]] = {}
        self._pool_totals: dict[str, int] = {}
        self._pool_baseline: dict[str, float] = {}
        self._breaker_dwell: dict[str, int] = {}
        # the lock tracer's counters at the last tick
        self._held_gets = 0
        self._long_held = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._task is not None:
            return self
        self._task = self.node.threadpool.schedule_with_fixed_delay(
            self.interval_s, self.tick, name="management")
        return self

    def stop(self):
        if self._task is not None:
            self._task.cancel()
            self._task = None

    # -- the tick ------------------------------------------------------------
    def tick(self):
        """One pass, on the management pool: every read is a plain
        attribute read or a leaf-locked stats() call."""
        self.ticks += 1
        try:
            self._check_batch_stall()
            self._check_queue_waits()
            self._check_breakers()
            self._check_locktrace()
        except Exception:  # noqa: BLE001 — a broken check must not end the
            # schedule; the next tick tries again
            get_logger("watchdog").warning("watchdog tick failed", exc_info=True)

    def _emit(self, type_: str, message: str, key: str | None = None, **attrs):
        journal = getattr(self.node, "events", None)
        if journal is None:
            return
        event = journal.publish(type_, message, key=key, **attrs)
        if event is not None:
            self._gossip(event)

    def _gossip(self, event: dict):
        """Push one event to every other node of the cluster (their
        journals deduplicate by origin seq): fire-and-forget sends from the
        watchdog tick, never from a serving thread."""
        try:
            from ..actions import A_EVENTS_PUBLISH

            state = self.node.cluster_service.state
            for n in state.nodes.nodes:
                if n.id == self.node.node_id:
                    continue
                try:
                    self.node.transport.send_request(n, A_EVENTS_PUBLISH,
                                                     {"event": event})
                except Exception:  # noqa: BLE001 — a departing peer is the
                    continue       # journal's business, not the watchdog's
        except Exception:  # noqa: BLE001 — no cluster service, or a shutdown race
            pass

    # -- checks --------------------------------------------------------------
    def _check_batch_stall(self):
        batcher = getattr(self.node, "search_batcher", None)
        if batcher is None:
            return
        snap = batcher.inflight()
        if snap is None:
            return
        ewma = float(getattr(batcher, "_ewma_cost", 0.0))
        threshold = max(self.batch_min_s, self.batch_factor * ewma)
        if snap["age_s"] <= threshold:
            return
        self._emit(
            "batch_stall",
            f"batch [{snap['batch']}] on [{snap['shard']}] dispatched "
            f"{snap['age_s'] * 1000:.0f}ms ago and not merged "
            f"(EWMA {ewma * 1000:.1f}ms, occupancy {snap['occupancy']})",
            key=f"batch:{snap['batch']}",
            batch=snap["batch"], shard=snap["shard"],
            family=snap["family"], occupancy=snap["occupancy"],
            age_ms=round(snap["age_s"] * 1000.0, 1),
            ewma_ms=round(ewma * 1000.0, 3))

    def _check_queue_waits(self):
        for name, hist in self.node.threadpool.pool_histograms().items():
            counts, total, _sum = hist.snapshot()
            prev_counts = self._pool_counts.get(name)
            prev_total = self._pool_totals.get(name, 0)
            self._pool_counts[name] = counts
            self._pool_totals[name] = total
            if prev_counts is None:
                continue
            delta_total = total - prev_total
            if delta_total < self.queue_min_samples:
                continue
            delta = [c - p for c, p in zip(counts, prev_counts)]
            p99 = hist._percentile_from(delta, delta_total, 0.99)
            baseline = self._pool_baseline.get(name)
            threshold = self.queue_min_s if baseline is None else \
                max(self.queue_min_s, QUEUE_P99_FACTOR * baseline)
            # the baseline learns AFTER the comparison, so a spike cannot
            # teach itself normal within one tick
            self._pool_baseline[name] = p99 if baseline is None else \
                0.2 * p99 + 0.8 * baseline
            if p99 > threshold:
                self._emit(
                    "queue_spike",
                    f"pool [{name}] queue-wait p99 {p99 * 1000:.1f}ms over "
                    f"the last tick ({delta_total} tasks; baseline "
                    f"{(baseline or 0.0) * 1000:.1f}ms)",
                    key=f"pool:{name}", pool=name,
                    p99_ms=round(p99 * 1000.0, 2),
                    baseline_ms=round((baseline or 0.0) * 1000.0, 2),
                    tasks=delta_total)

    def _check_breakers(self):
        breakers = getattr(self.node, "breakers", None)
        if breakers is None:
            return
        for name, b in breakers.stats().items():
            limit = b.get("limit", 0) or 0
            ratio = (b.get("estimated", 0) / limit) if limit > 0 else 0.0
            if ratio >= BREAKER_HIGH_RATIO:
                dwell = self._breaker_dwell.get(name, 0) + 1
                self._breaker_dwell[name] = dwell
                if dwell >= self.breaker_dwell:
                    self._emit(
                        "breaker_pressure",
                        f"breaker [{name}] at {ratio * 100:.0f}% of its "
                        f"limit for {dwell} watchdog periods (near-trip "
                        f"dwell)",
                        key=f"breaker:{name}", breaker=name,
                        ratio=round(ratio, 4), dwell_ticks=dwell,
                        estimated=b.get("estimated", 0), limit=limit)
            else:
                self._breaker_dwell[name] = 0

    def _check_locktrace(self):
        from .locktrace import TRACER

        if not TRACER.enabled:
            return
        snap = TRACER.snapshot()
        held = int(snap.get("held_device_gets", 0))
        long_held = len(snap.get("long_held", ()))
        grew_held = held - self._held_gets
        grew_long = long_held - self._long_held
        self._held_gets = held
        self._long_held = long_held
        if grew_held > 0 or grew_long > 0:
            worst = snap.get("long_held", [])[-1] if grew_long > 0 else None
            self._emit(
                "lock_stall",
                f"{grew_held} device pull(s) timed under a held lock, "
                f"{grew_long} above the long-held threshold"
                + (f" (worst: {worst[0]} {worst[1]}ms)" if worst else ""),
                key="locktrace",
                held_device_gets=held, long_held=long_held,
                max_ms=snap.get("held_device_get_max_ms", 0.0))

    def stats(self) -> dict:
        return {
            "interval_s": self.interval_s,
            "ticks": self.ticks,
            "thresholds": {
                "batch_stall_factor": self.batch_factor,
                "batch_stall_min_ms": round(self.batch_min_s * 1000.0, 1),
                "queue_p99_factor": QUEUE_P99_FACTOR,
                "queue_p99_min_ms": round(self.queue_min_s * 1000.0, 1),
                "breaker_high_ratio": BREAKER_HIGH_RATIO,
                "breaker_dwell_ticks": self.breaker_dwell,
            },
            "baselines": {
                "queue_p99_ms": {
                    name: round(v * 1000.0, 3)
                    for name, v in sorted(self._pool_baseline.items())},
            },
        }
