"""Index warmer: device packs off the query path and the request cache's
re-prime (the JAX package's `warmer.py`, without its compile warming).

Every searcher install (refresh, merge publish, optimize, recovery) calls
the warmer from the engine's view listeners, and it schedules the cold
device work of the new view on a pool instead of leaving it to the first
search that touches a segment:

- **delta and full packs**: an unpacked segment gets an in-flight pack
  Future for the node's device (ops/device_index.begin_warm), installed
  under the engine lock (dict work only); the pack runs on the `warmer`
  pool. A search racing it waits for a running pack, or steals one that
  has not started, so it never packs twice;
- **compaction packs**: a merged segment carries a `compact` pack hint; its
  pack runs on the `merge` pool and concatenates the sources' resident
  planes on the device (pack_segment_concat) when they are eligible;
- **remasks**: a tombstone view re-masks on the `warmer` pool too;
- **the re-prime** (`indices.warmer.enabled`, default true): when the
  shard's request cache holds a body hit at least once, `_re_prime` runs on
  the `warmer` pool after the packs are scheduled. It seeds the filter keys
  that were hot on the old view's segments onto the new ones
  (`DeviceFilterCache.hot_keys`/`seed`: counter work, no mask built), then
  replays the shard's `indices.warmer.top_n` (8) most hit bodies on the
  new view through the node's query phase and batcher
  (`actions.warm_shard_queries`), storing their partials, so a hot body's
  first sighting after a refresh is a hit. A body that fails is counted in
  `query_failures` and never reaches the pool (as in the JAX package).

The steady state of a node that writes and searches is then a cache hit in
every query-path `packed_for`, with zero query-path packs (PACK_LEDGER's
pools say so). Pack warming arms only once a shard has served a search
(`engine.search_active`, set by the shard query phase): the first search
packs inline by design, and a write-only shard's refreshes stay off the
device.

Lock discipline: the view listener runs under the engine lock and is a
leaf — begin_warm is dict work and a submit never blocks (both pools are
unbounded); every pack, upload and device program runs on a pool thread
with no lock held.

`indices.warmer.enabled: false` switches the re-prime off and leaves pack
warming on, as in the JAX package.

A shard that leaves the node (its index closed or deleted) is unwired
(`unwire`) before its engine closes: its view listener is removed, and a
pack already queued for it stands down when it sees the engine closed
(`packs_abandoned`), so no warm pack or re-prime runs on a closed engine.

What runs on one explicit refresh of a shard with search warmers: the
refresh installs a view; the view listener schedules its packs on the
pools and, when the shard has hot cached bodies, the re-prime; the refresh
broadcast then runs the index's search warmers (`actions._run_warmers`) on
the management pool through the query phase and the batcher. A warmer
body whose segment pack has not started steals it (one pack, counted in
`packs_stolen`); a re-prime replays only cached bodies and a search warmer
is not one unless a user sent the same body, so each body launches once a
refresh unless a user's body equals a warmer's (then the re-prime and the
warmer each run it once).

A warm pack that fails on the card (a transient or persistent CUDA error,
common/devicehealth) is retried on its pool, up to
`indices.warmer.pack_retries` (2) times after decorrelated-jitter backoffs
from `indices.warmer.pack_retry_base` (0.05 s), as in the JAX package's
`warmer.py`: the failed attempt cleared its marker and resolved its future,
so a waiter never sees a half-packed segment, and a search that claimed the
fresh marker meanwhile packs it instead. The final failure is counted and
recorded against the `pack:<index>` fault domain (no query waits on a warm
pack's future, so nothing else would classify it); a clean pack notes
success there, closing the domain when it was the recovery probe."""

from __future__ import annotations

import threading
import time

from .common.devicehealth import DEGRADABLE, DEVICE_HEALTH, classify_device_error
from .common.errors import SearchEngineError
from .common.logging import get_logger
from .common.retry import RetryPolicy
from .ops.device_index import begin_warm, cancel_warm, run_warm


class IndexWarmerService:
    """Node-level scheduler of pack work hung off the engines' view
    listeners (wired per shard by indices_service after the cache
    listeners)."""

    def __init__(self, settings, device, threadpool, breaker=None, node=None):
        self.enabled = bool(settings.get_bool("indices.warmer.enabled", True))
        self.top_n = max(0, settings.get_int("indices.warmer.top_n", 8))
        # each replayed body's time budget: a wedged replay must not hold a
        # warmer thread
        self.query_budget_s = settings.get_float("indices.warmer.query_timeout", 5.0)
        self.device = device
        self.threadpool = threadpool
        self.breaker = breaker  # the fielddata child: each pack's estimate
        # the node whose request cache, filter cache and actions the
        # re-prime reads (None: packs only)
        self.node = node
        self.pack_retry_budget = max(0, settings.get_int(
            "indices.warmer.pack_retries", 2))
        self._retry_policy = RetryPolicy(base_s=settings.get_float(
            "indices.warmer.pack_retry_base", 0.05), cap_s=1.0)
        self.logger = get_logger("indices.warmer",
                                 node=getattr(node, "name", None))
        self._lock = threading.Lock()  # leaf: counters only
        self.packs_scheduled = 0
        self.packs_done = 0
        self.packs_stolen = 0  # claimed by a racing search before we ran
        self.pack_failures = 0
        self.pack_retries = 0  # CUDA-error failures retried on the pool
        self.rejected = 0  # pool rejections (shut down)
        self.reprimes = 0
        self.queries_warmed = 0
        self.query_failures = 0
        self.filters_seeded = 0
        self.packs_abandoned = 0  # queued packs whose engine closed first
        self.closed = False
        self._wired: dict[int, object] = {}  # id(engine) -> its listener

    def wire(self, index: str, shard_id: int, engine) -> None:
        """Append this shard's warm listener to the engine's view
        listeners (run under the engine lock on every searcher install)."""

        def on_view_change(searcher, dropped):
            if searcher is not None:
                self.on_view_installed(index, shard_id, engine, searcher, dropped)

        self._wired[id(engine)] = on_view_change
        engine.view_listeners.append(on_view_change)

    def unwire(self, engine) -> None:
        """Remove this warmer's listener from a leaving shard's engine."""
        listener = self._wired.pop(id(engine), None)
        if listener is not None and listener in engine.view_listeners:
            engine.view_listeners.remove(listener)

    def on_view_installed(self, index: str, shard_id: int, engine, searcher,
                          dropped=()) -> None:
        """Schedule the new view's packs and remasks (a `compact` hint on
        the `merge` pool, everything else on `warmer`), then its re-prime.
        A leaf under the engine lock; a rejected submit withdraws its
        marker, so the query path packs inline instead of waiting on work
        nobody will do."""
        if self.closed or engine.closed:
            return
        if engine.search_active:
            self._schedule_packs(index, searcher, engine)
        rcache = getattr(self.node, "request_cache", None)
        if (not self.enabled or rcache is None or not rcache.enabled
                or not rcache.has_hot(index, shard_id)):
            return
        try:
            self.threadpool.submit("warmer", self._re_prime, index, shard_id,
                                   engine, list(dropped or ()))
        except Exception:  # noqa: BLE001 — a rejected or shut-down pool
            with self._lock:
                self.rejected += 1

    def _schedule_packs(self, index: str, searcher, engine) -> None:
        for seg in searcher.segments:
            fut = begin_warm(seg, self.device)
            if fut is None:
                continue  # resident and current, or a pack is in flight
            hint = seg._device_cache.get("pack_hint") or {}
            pool = "merge" if hint.get("kind") == "compact" else "warmer"
            try:
                self.threadpool.submit(pool, self._run_pack, seg, fut, index, engine)
            except Exception:  # noqa: BLE001 — a rejected or shut-down pool
                cancel_warm(seg, self.device, fut)
                with self._lock:
                    self.rejected += 1
                continue
            with self._lock:
                self.packs_scheduled += 1

    def _run_pack(self, seg, fut, index: str, engine) -> None:
        """The pool's body: claim and pack. A failure (a breaker trip, a
        device error) reached any waiter through the future; a failure of
        the card is retried here after a backoff while the budget lasts, and
        the final failure is counted and recorded against `pack:<index>` (a
        defect of the program is neither retried nor recorded). A pack whose
        engine closed while it was queued stands down."""
        if engine.closed:
            cancel_warm(seg, self.device, fut)
            with self._lock:
                self.packs_done += 1
                self.packs_abandoned += 1
            return
        attempts = 0
        prev_sleep = None
        while True:
            try:
                res = run_warm(seg, self.device, fut, breaker=self.breaker,
                               owner=index)
            except Exception as e:  # noqa: BLE001
                attempts += 1
                cls = classify_device_error(e)
                if cls in DEGRADABLE and attempts <= self.pack_retry_budget:
                    # back off on this pool thread (never the query path),
                    # then re-arm: a search that claimed the fresh marker
                    # meanwhile packs it, and this task stands down
                    prev_sleep = self._retry_policy.next_backoff(prev_sleep)
                    time.sleep(prev_sleep)
                    fut = begin_warm(seg, self.device)
                    if fut is None:
                        with self._lock:
                            self.packs_done += 1
                        return  # packed, or a pack is in flight elsewhere
                    with self._lock:
                        self.pack_retries += 1
                    continue
                with self._lock:
                    self.packs_done += 1
                    self.pack_failures += 1
                DEVICE_HEALTH.record_failure(
                    getattr(e, "_estpu_device_domain", None) or f"pack:{index}", e)
                log = self.logger.warning if cls == "defect" else self.logger.debug
                log("warm pack failed [%s][gen %s] after %d attempt(s): %s",
                    index, seg.gen, attempts, e)
                return
            with self._lock:
                self.packs_done += 1
                if res is None:
                    self.packs_stolen += 1  # a racing search packed it inline
            if res is not None:
                # a clean pack resets the domain's strikes (and closes it
                # when this was the recovery probe)
                DEVICE_HEALTH.note_success((f"pack:{index}",))
            return

    def _re_prime(self, index: str, shard_id: int, engine, dropped) -> None:
        """The pool's re-prime of one shard's new view: seed the filter keys
        hot on the old view's segments onto the new ones, then replay the
        shard's most hit cached bodies (`actions.warm_shard_queries`)."""
        node = self.node
        try:
            searcher = engine.acquire_searcher()
        except SearchEngineError:
            return  # the engine closed under us
        fcache = node.filter_cache
        if fcache is not None and fcache.enabled:
            keys = fcache.hot_keys(list(dropped) + list(searcher.segments))
            if keys:
                seeded = sum(fcache.seed(seg, keys, self.device)
                             for seg in searcher.segments)
                if seeded:
                    with self._lock:
                        self.filters_seeded += seeded
        if self.top_n <= 0:
            return
        bodies = node.request_cache.hot_bodies(index, shard_id, self.top_n)
        if not bodies:
            return
        warmed, failed = node.actions.warm_shard_queries(
            index, shard_id, bodies, budget_s=self.query_budget_s)
        with self._lock:
            self.reprimes += 1
            self.queries_warmed += warmed
            self.query_failures += failed

    def close(self) -> None:
        """Schedule nothing more (the node is closing; the pools' queued
        packs are cancelled with them, and their markers stay claimable)."""
        self.closed = True

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "packs_scheduled": self.packs_scheduled,
                    "packs_done": self.packs_done,
                    "packs_stolen": self.packs_stolen,
                    "pack_failures": self.pack_failures,
                    "pack_retries": self.pack_retries,
                    "reprimes": self.reprimes,
                    "queries_warmed": self.queries_warmed,
                    "query_failures": self.query_failures,
                    "filters_seeded": self.filters_seeded,
                    "packs_abandoned": self.packs_abandoned,
                    "rejected": self.rejected}
