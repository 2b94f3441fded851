"""Index warmer: device packs off the query path (the pack half of the JAX
package's `warmer.py`).

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
- **remasks**: a tombstone view re-masks on the `warmer` pool too.

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

`indices.warmer.enabled` is read and reported as in the JAX package, where
it switches the cache re-prime off and leaves pack warming on; the re-prime
(the request cache's hot bodies, the filter cache's hot keys) waits for the
request cache. A failed warm pack is counted and not retried: later
searches retry inline."""

from __future__ import annotations

import threading

from .common.logging import get_logger
from .ops.device_index import begin_warm, cancel_warm, run_warm


class IndexWarmerService:
    """Node-level scheduler of pack work hung off the engines' view
    listeners (wired per shard by indices_service after the cache
    listeners)."""

    def __init__(self, settings, device, threadpool, breaker=None):
        self.enabled = bool(settings.get_bool("indices.warmer.enabled", True))
        self.device = device
        self.threadpool = threadpool
        self.breaker = breaker  # the fielddata child: each pack's estimate
        self.logger = get_logger("indices.warmer")
        self._lock = threading.Lock()  # leaf: counters only
        self.packs_scheduled = 0
        self.packs_done = 0
        self.packs_stolen = 0  # claimed by a racing search before we ran
        self.pack_failures = 0
        self.rejected = 0  # pool rejections (shut down)
        self.closed = False

    def wire(self, index: str, engine) -> None:
        """Append this shard's warm listener to the engine's view
        listeners (run under the engine lock on every searcher install)."""

        def on_view_change(searcher, dropped):
            if searcher is not None:
                self.on_view_installed(index, engine, searcher)

        engine.view_listeners.append(on_view_change)

    def on_view_installed(self, index: str, engine, searcher) -> None:
        """Schedule the new view's packs and remasks: a `compact` hint on
        the `merge` pool, everything else on `warmer`. A leaf under the
        engine lock; a rejected submit withdraws its marker, so the query
        path packs inline instead of waiting on work nobody will do."""
        if self.closed or not engine.search_active:
            return
        for seg in searcher.segments:
            fut = begin_warm(seg, self.device)
            if fut is None:
                continue  # resident and current, or a pack is in flight
            hint = seg._device_cache.get("pack_hint") or {}
            pool = "merge" if hint.get("kind") == "compact" else "warmer"
            try:
                self.threadpool.submit(pool, self._run_pack, seg, fut, index)
            except Exception:  # noqa: BLE001 — a rejected or shut-down pool
                cancel_warm(seg, self.device, fut)
                with self._lock:
                    self.rejected += 1
                continue
            with self._lock:
                self.packs_scheduled += 1

    def _run_pack(self, seg, fut, index: str) -> None:
        """The pool's body: claim and pack. A failure (a breaker trip, a
        device error) reached any waiter through the future; it is counted
        here and not retried."""
        try:
            res = run_warm(seg, self.device, fut, breaker=self.breaker, owner=index)
        except Exception as e:  # noqa: BLE001
            with self._lock:
                self.packs_done += 1
                self.pack_failures += 1
            self.logger.debug("warm pack failed [%s][gen %s]: %s", index,
                              seg.gen, e)
            return
        with self._lock:
            self.packs_done += 1
            if res is None:
                self.packs_stolen += 1  # a racing search packed it inline

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
                    "rejected": self.rejected}
