"""Per-copy health tracking, adaptive replica selection and the hedge budget
(a copy of the JAX package's `cluster/stats.py`).

The tail-tolerance substrate of the fan-out path ("The Tail at Scale", Dean &
Barroso, CACM 2013; C3, Suresh et al., NSDI '15, the basis of
Elasticsearch's adaptive replica selection): the coordinator keeps a decayed
health record per (node, index, shard) **copy**: the query-phase latency it
observed (an EWMA and a per-copy latency histogram), the load signals each
response carries back (the remote search pool's queue depth, the request
breaker's headroom), the attempts it has in flight there, and a decayed
failure count. Replica selection ranks the active copies by a C3-style
score instead of plain round-robin:

    score = ewma_latency * (1 + outstanding) * (1 + queue) / max(headroom, 0.05)
            * (1 + failures^2)

Selection stays **balanced when the group is healthy**: every copy whose score
is within ``spread``x of the best stays in a round-robin rotation (pure
best-pick would starve equally-healthy replicas of traffic and of the samples
that keep their stats honest). A sick copy's score pushes it out of the
rotation, so its traffic share collapses without any hard blacklist.

**No permanent blacklisting.** Copies outside the rotation — quarantined by
failures or just score-excluded after a slow spell — still receive occasional
trial traffic: every ``probe_every``-th selection for a group with excluded
copies picks one of them (rotating), so a recovered copy's fast responses decay
its EWMA/failure penalty and it rejoins the rotation. Without probing, a copy
that went slow once would never be measured again and never come back.

**Cold start.** Until every active copy of a group has ``min_samples``
observations the selector abstains (returns None) and the caller round-robins
— which is exactly what warms the stats. A cold copy's first searches pack
its segments on the query path (hundreds of ms on the card); ranking on
those would poison routing.

**Hedge budget.** ``HedgeBudget`` is a token bucket fed by primary shard
attempts (``ratio`` tokens each, capped at ``burst``): hedged attempts spend a
whole token, so hedges are bounded at ~``ratio`` of shard requests plus the
burst — under a brown-out where EVERY copy is slow, the budget exhausts
instead of doubling the load on an already-sick cluster.

Lock discipline: every lock here is a leaf — updates are plain field
mutations under the owning object's lock, never a blocking wait, never a
launch, never another of this module's locks. The per-copy latency
histograms are `HistogramMetric` (own striped leaf locks) and are always
touched OUTSIDE the copy's field lock. The shard-side load piggyback is
assembled from plain attribute reads (no locks, no clocks, no device traffic);
the coordinator pays one monotonic clock pair per attempt — the latency sample
itself — and the unhedged shard-side serving path gains zero clock reads and
zero waits on the card.
"""

from __future__ import annotations

import threading
import time

from ..common.metrics import HistogramMetric
from ..common.settings import Settings


class CopyHealth:
    """Decayed health record of ONE shard copy, as observed by this
    coordinator. All field mutation happens under `_lock` (a leaf);
    the latency histogram lives outside it (own striped locks)."""

    __slots__ = ("key", "_lock", "ewma_s", "samples", "queue", "headroom",
                 "outstanding", "failures", "_fail_stamp", "selected", "hist",
                 "last_touch", "rc_hit_rate")

    def __init__(self, key: tuple):
        self.key = key
        self.last_touch = 0.0  # stamped by the registry on every access
        self._lock = threading.Lock()
        self.ewma_s = 0.0      # decayed latency signal (seconds)
        self.samples = 0       # successful observations
        self.queue = 0         # remote search-pool queue depth (piggybacked)
        self.headroom = 1.0    # remote request-breaker headroom fraction
        self.rc_hit_rate = 0.0  # remote request-cache hit rate (piggybacked;
        # REPORTED in stats, never a rank input — health decides routing)
        self.outstanding = 0   # attempts in flight from THIS coordinator
        self.failures = 0.0    # decayed failure count
        self._fail_stamp = 0.0  # monotonic ts of the last failure decay
        self.selected = 0      # times routing picked this copy
        self.hist = HistogramMetric()  # per-copy latency (hedge delay = p99)

    # -- observations --------------------------------------------------------
    def observe(self, seconds: float, alpha: float, queue=None, headroom=None,
                rc_hit_rate=None):
        """A completed attempt's latency + piggybacked load. A success also
        halves the decayed failure count — deterministic re-entry from
        quarantine (time decay alone would make recovery wall-clock-bound,
        unreplayable in seeded chaos tests)."""
        s = max(0.0, float(seconds))
        self.hist.observe(s)  # outside _lock: HistogramMetric locks itself
        with self._lock:
            self.ewma_s = s if self.samples == 0 else \
                alpha * s + (1.0 - alpha) * self.ewma_s
            self.samples += 1
            self.failures *= 0.5
            if queue is not None:
                self.queue = max(0, int(queue))
            if headroom is not None:
                self.headroom = min(1.0, max(0.0, float(headroom)))
            if rc_hit_rate is not None:
                self.rc_hit_rate = min(1.0, max(0.0, float(rc_hit_rate)))

    def failure(self, now: float, halflife_s: float):
        with self._lock:
            self.failures = self._decayed_locked(now, halflife_s) + 1.0
            self._fail_stamp = now

    def _decayed_locked(self, now: float, halflife_s: float) -> float:
        if self.failures <= 0.0:
            return 0.0
        dt = max(0.0, now - self._fail_stamp)
        return self.failures * (0.5 ** (dt / max(halflife_s, 1e-3)))

    # -- ranking -------------------------------------------------------------
    # nominal latency for a copy with NO successful sample yet (its EWMA is
    # meaningless): pessimistic enough that a failing-from-birth copy ranks
    # behind any measured healthy copy instead of scoring near zero
    UNKNOWN_EWMA_S = 1.0

    def score(self, now: float, halflife_s: float) -> float:
        """C3-style rank input: latency scaled by concurrency (local
        outstanding + remote queue), breaker pressure, and failure penalty."""
        with self._lock:
            ew = max(self.ewma_s, 1e-6) if self.samples \
                else self.UNKNOWN_EWMA_S
            out = self.outstanding
            q = self.queue
            hr = self.headroom
            f = self._decayed_locked(now, halflife_s)
        return ew * (1.0 + out) * (1.0 + q) / max(hr, 0.05) * (1.0 + f * f)

    def quarantined(self, now: float, halflife_s: float,
                    threshold: float) -> bool:
        with self._lock:
            return self._decayed_locked(now, halflife_s) >= threshold

    def snapshot(self, now: float, halflife_s: float,
                 threshold: float) -> dict:
        with self._lock:
            f = self._decayed_locked(now, halflife_s)
            d = {
                "ewma_ms": round(self.ewma_s * 1000.0, 3),
                "samples": self.samples,
                "queue": self.queue,
                "headroom": round(self.headroom, 4),
                "outstanding": self.outstanding,
                "failures": round(f, 3),
                "selected": self.selected,
                "quarantined": f >= threshold,
                "rc_hit_rate": round(self.rc_hit_rate, 4),
            }
        d["p99_ms"] = round(self.hist.percentile(0.99) * 1000.0, 3)
        return d


class HedgeBudget:
    """Token bucket bounding hedged shard attempts to ~`ratio` of primary
    attempts (plus `burst`). Counters double as the /_nodes/stats and
    Prometheus surface."""

    __slots__ = ("_lock", "ratio", "burst", "tokens", "issued", "won",
                 "budget_exhausted")

    def __init__(self, ratio: float = 0.05, burst: float = 10.0):
        self._lock = threading.Lock()
        self.ratio = max(0.0, float(ratio))
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self.issued = 0
        self.won = 0
        self.budget_exhausted = 0

    def note_request(self):
        """A primary shard attempt accrues `ratio` tokens."""
        with self._lock:
            self.tokens = min(self.burst, self.tokens + self.ratio)

    def try_acquire(self) -> bool:
        """Spend one token (one hedge) or count the exhaustion."""
        with self._lock:
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            self.budget_exhausted += 1
            return False

    def refund(self):
        """Return an acquired-but-unused token (the hedge found no candidate
        left to launch after winning the token race) — without it, churn
        silently drains the bucket with no hedge ever issued."""
        with self._lock:
            self.tokens = min(self.burst, self.tokens + 1.0)

    def record_issued(self):
        with self._lock:
            self.issued += 1

    def record_won(self):
        with self._lock:
            self.won += 1

    def stats(self) -> dict:
        with self._lock:
            return {"issued": self.issued, "won": self.won,
                    "budget_exhausted": self.budget_exhausted,
                    "tokens": round(self.tokens, 3),
                    "ratio": self.ratio, "burst": self.burst}


class AdaptiveReplicaSelector:
    """Per-node registry of CopyHealth records + the selection policy.

    Wired into `OperationRouting` (preference-free selection + ranked failover
    chains) and `actions._query_shard_async` (per-attempt observations +
    hedging). Thread-safe; every lock is a leaf."""

    def __init__(self, settings=None):
        settings = settings or Settings.EMPTY
        self.enabled = settings.get_bool("search.adaptive.enabled", True)
        self.min_samples = settings.get_int("search.adaptive.min_samples", 5)
        self.alpha = settings.get_float("search.adaptive.ewma_alpha", 0.3)
        self.spread = settings.get_float("search.adaptive.spread", 2.0)
        self.quarantine_failures = settings.get_float(
            "search.adaptive.quarantine_failures", 3.0)
        self.probe_every = max(2, settings.get_int(
            "search.adaptive.probe_every", 8))
        self.failure_halflife_s = settings.get_float(
            "search.adaptive.failure_halflife_s", 30.0)
        self.hedge_enabled = settings.get_bool("search.hedge.enabled", True)
        self.min_hedge_s = settings.get_float(
            "search.hedge.min_delay_ms", 1.0) / 1000.0
        self.hedges = HedgeBudget(
            ratio=settings.get_float("search.hedge.budget_ratio", 0.05),
            burst=settings.get_float("search.hedge.burst", 10.0))
        self._copies: dict[tuple, CopyHealth] = {}
        self._dict_lock = threading.Lock()
        # selection counters + per-group rotation/probe state (leaf lock)
        self._sel_lock = threading.Lock()
        self._groups: dict[tuple, dict] = {}  # (index, shard) -> {n, probe_i}
        self.probes = 0
        self.selections = {"adaptive": 0, "round_robin": 0, "probe": 0,
                           "affinity": 0}

    # -- registry ------------------------------------------------------------
    @staticmethod
    def key(copy) -> tuple:
        return (copy.node_id, copy.index, copy.shard_id)

    # registry bounds: CopyHealth records for deleted indices / departed
    # nodes would otherwise accumulate forever on a long-lived coordinator —
    # and each one is four Prometheus gauge samples per scrape (unbounded
    # label cardinality). Creation past the threshold evicts entries idle
    # longer than PRUNE_IDLE_S; live copies are re-stamped on every access,
    # so only genuinely dead keys age out.
    PRUNE_AT = 512
    PRUNE_IDLE_S = 900.0

    def _copy(self, key: tuple) -> CopyHealth:
        now = time.monotonic()
        with self._dict_lock:
            e = self._copies.get(key)
            if e is None:
                if len(self._copies) >= self.PRUNE_AT:
                    cutoff = now - self.PRUNE_IDLE_S
                    for k in [k for k, v in self._copies.items()
                              if v.last_touch < cutoff]:
                        del self._copies[k]
                e = self._copies[key] = CopyHealth(key)
            e.last_touch = now
            return e

    # -- coordinator feedback ------------------------------------------------
    def begin_attempt(self, copy):
        e = self._copy(self.key(copy))
        with e._lock:
            e.outstanding += 1

    def end_attempt(self, copy):
        e = self._copy(self.key(copy))
        with e._lock:
            e.outstanding = max(0, e.outstanding - 1)

    def observe(self, copy, seconds: float, load: dict | None = None):
        """Latency of a completed query-phase attempt + the response's
        piggybacked load signals ({"queue", "headroom", "rc_hit_rate"})."""
        q = hr = rc = None
        if isinstance(load, dict):
            q, hr = load.get("queue"), load.get("headroom")
            rc = load.get("rc_hit_rate")
        self._copy(self.key(copy)).observe(seconds, self.alpha,
                                           queue=q, headroom=hr,
                                           rc_hit_rate=rc)

    def failure(self, copy):
        self._copy(self.key(copy)).failure(time.monotonic(),
                                           self.failure_halflife_s)

    # -- hedging -------------------------------------------------------------
    # the alternative clamp's tail allowance: "an attempt has outlived
    # ALT_TAIL_MULT x a healthy alternative's decayed EWMA" is the signal
    # that hedging to it would very likely already have answered
    ALT_TAIL_MULT = 4.0

    def hedge_delay_s(self, copy, remaining: float | None,
                      others=()) -> float | None:
        """When to hedge an attempt to `copy`: the copy's own latency-
        histogram p99 (what "unusually slow for THIS copy" means), with two
        clamps. (1) Against the best warm ALTERNATIVE copy's decayed EWMA
        (x ALT_TAIL_MULT): a probe to a known-slow copy hedges as soon as a
        healthy copy would very likely have answered — and when every
        alternative is as slow as the primary the delay rises to the
        primary's own tail, so an all-slow brown-out produces no useless
        speculative traffic. The alternative side deliberately uses the
        DECAYED EWMA, not the alternative's own p99: a lifetime histogram
        never forgets a one-off outlier (a copy's first search packs its
        segments on the query path and lands in exactly one copy's
        histogram), and a clamp built on
        it would quietly disable hedging through that copy forever. (2)
        Against the remaining Deadline budget, so the hedge can still answer
        in time. None = don't hedge (disabled, copy not warm, or no budget
        left)."""
        if not self.hedge_enabled:
            return None
        e = self._copy(self.key(copy))
        if e.samples < self.min_samples:
            return None
        delay = max(e.hist.percentile(0.99), self.min_hedge_s)
        alt = None
        for o in others:
            oe = self._copy(self.key(o))
            if oe.samples >= self.min_samples:
                alt = oe.ewma_s if alt is None else min(alt, oe.ewma_s)
        if alt is not None:
            delay = min(delay, max(self.ALT_TAIL_MULT * alt,
                                   self.min_hedge_s))
        if remaining is not None:
            if remaining <= 2.0 * self.min_hedge_s:
                return None  # no budget for a useful hedge
            delay = min(delay, remaining * 0.5)
        return delay

    # -- selection -----------------------------------------------------------
    def select(self, active: list, affinity: str | None = None):
        """Pick one copy of a replication group, or None to tell the caller
        to round-robin (disabled / cold group). See the module docstring for
        the rotation + probe policy.

        `affinity` (the request-cache fingerprint of a cache-eligible
        request) replaces the ROTATION pick with a rendezvous hash over the
        SAME within-spread eligible set: the hot query lands on the same
        healthy copy every time (its cache), while a sick copy's exit from
        the spread set moves the fingerprint to the next-ranked copy —
        health dominates, and probe/quarantine turns are untouched."""
        if not self.enabled or len(active) < 2:
            return None
        entries = [(s, self._copy(self.key(s))) for s in active]
        # cold = NO signal at all: neither min_samples successes nor any
        # failure. Failures count as warmth — a copy that fails from birth
        # never accumulates samples, and requiring successes alone would
        # keep its whole group round-robin forever (1/N of traffic burning
        # a full attempt timeout each). Its score ranks on the pessimistic
        # UNKNOWN_EWMA_S + failure penalty, so it drops out of the rotation
        # (or quarantines) like any other sick copy.
        if any(e.samples < self.min_samples and e.failures <= 0.0
               for _s, e in entries):
            with self._sel_lock:
                self.selections["round_robin"] += 1
            return None
        now = time.monotonic()
        hl, qt = self.failure_halflife_s, self.quarantine_failures
        scored = [(e.score(now, hl), s, e) for s, e in entries]
        healthy = [(sc, s, e) for sc, s, e in scored
                   if not e.quarantined(now, hl, qt)]
        if not healthy:
            healthy = scored  # whole group quarantined: no blacklist, serve
        best = min(sc for sc, _s, _e in healthy)
        eligible = [(s, e) for sc, s, e in healthy
                    if sc <= best * self.spread + 1e-4]
        excluded = [(s, e) for _sc, s, e in scored
                    if not any(s is s2 for s2, _e2 in eligible)]
        group_key = (active[0].index, active[0].shard_id)
        with self._sel_lock:
            g = self._groups.get(group_key)
            if g is None:
                if len(self._groups) >= self.PRUNE_AT:  # same bound as copies
                    cutoff = now - self.PRUNE_IDLE_S
                    for k in [k for k, v in self._groups.items()
                              if v["t"] < cutoff]:
                        del self._groups[k]
                g = self._groups[group_key] = {"n": 0, "probe_i": 0, "t": now}
            g["t"] = now
            g["n"] += 1
            probe = excluded and g["n"] % self.probe_every == 0
            if probe:
                g["probe_i"] += 1
                pick, entry = excluded[g["probe_i"] % len(excluded)]
                self.probes += 1
                self.selections["probe"] += 1
            elif affinity is not None:
                # rendezvous over the eligible set — which may be ONE copy
                # when health has excluded the rest (a 2-node TCP cluster's
                # remote copy often sits outside the spread): the request is
                # still affinity-routed (deterministic landing spot), so the
                # counter reflects it either way
                from .routing import OperationRouting

                pick = OperationRouting.rendezvous(
                    affinity, [s for s, _e in eligible])
                entry = next(e for s, e in eligible if s is pick)
                self.selections["affinity"] += 1
            else:
                pick, entry = eligible[g["n"] % len(eligible)]
                self.selections["adaptive"] += 1
        with entry._lock:
            entry.selected += 1
        return pick

    def ranked(self, copies: list) -> list:
        """Copies ordered best-first for failover chains: non-quarantined by
        score, quarantined (by score) last — the first fallback copy is the
        best REMAINING one, not the next array slot."""
        if not self.enabled or len(copies) < 2:
            return list(copies)
        now = time.monotonic()
        hl, qt = self.failure_halflife_s, self.quarantine_failures
        def rank(s):
            e = self._copy(self.key(s))
            return (e.quarantined(now, hl, qt), e.score(now, hl))
        return sorted(copies, key=rank)

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        now = time.monotonic()
        hl, qt = self.failure_halflife_s, self.quarantine_failures
        with self._dict_lock:
            copies = dict(self._copies)
        snaps = {f"{k[0]}/{k[1]}/{k[2]}": e.snapshot(now, hl, qt)
                 for k, e in copies.items()}
        with self._sel_lock:
            selections = dict(self.selections)
            probes = self.probes
        return {
            "enabled": self.enabled,
            "min_samples": self.min_samples,
            "copies": snaps,
            "selections": selections,
            "probes": probes,
            "quarantined": sum(1 for s in snaps.values() if s["quarantined"]),
            "hedges": self.hedges.stats(),
        }
