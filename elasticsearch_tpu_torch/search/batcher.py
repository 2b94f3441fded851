"""Cross-request device micro-batching — the port of the JAX package's
`search/batcher.py` `DeviceBatcher` (its flat family).

Concurrent `execute_query_phase` calls each bring ONE plan — a plain one,
or a filtered or function_score plan of the dense family, all under the
same key, as in the JAX package; launched one at a time, every request
would pay a full set of launches and a host merge. The batcher coalesces
them into one `dispatch_flat_batch`, which launches each family of the
batch and pulls them all behind one event:

    caller threads                     drainer (a daemon thread)
    ──────────────                     ─────────────────────────
    enqueue(plan, key)──►[bounded coalescing queue]
    wait(future)                          │ collect same-key items
         ▲                                ▼
         │                        dispatch batch N+1 ──► card
         └────── fan-out ◄─────── merge batch N     ◄── card

Items coalesce only under an identical key: same segment point-in-time view +
mapper/similarity services + k bucket (k rounds up to a power of two from
16, so top-10 and top-16 pages share launches; the kernel runs at the bucket
and fan-out trims).

Flush policy — whichever fires first:
  * full     : `search.batch.max_batch` same-key plans are waiting
  * linger   : the oldest item has waited `linger_eff`, where
               linger_eff = linger_ms * (1 - queued/max_batch), floored at
               `search.batch.min_linger_ms` — a hot queue shrinks the linger
               toward zero; a lone request pays at most linger_ms
  * deadline : now >= tightest enqueued Deadline - EWMA(batch service time),
               so launch AND merge still fit in the budget
  * pending  : a dispatched batch is waiting to be merged — lingering would
               hold its answered futures hostage to the NEXT batch's linger;
               the card is busy anyway, so the queue flushes at once

The drainer only launches and merges: each caller builds its plan's host
inputs (filter mask rows, function rows) before queueing it, and serves a
query the dense family hands back to the host scorer after its batch.

Double buffering: the drainer dispatches batch N+1 BEFORE merging batch N, so
batch N's host merge overlaps batch N+1's device work. The dispatch half
never synchronises; it ends by enqueueing the batch's device→host copies
behind one event (execute.dispatch_flat_batch), and the merge half waits on
that event alone — so N's merge waits for N's device work, never N+1's.
Everything runs on the launching thread's current stream.

In-flight markers: the drainer pushes (batch id, dispatch time, family,
occupancy, index) before it dispatches a batch and pops it once the batch is
merged; `inflight()` reads the oldest without a lock, for the stall
watchdog (common/events), which ages a batch wedged in its pull.

Tracing and insights ride clocks the drainer reads anyway: an item captures
its request's active span and insights Observation at enqueue; the drainer
records `batcher.queue` (enqueue → the batch taken), `batcher.dispatch`
(the dispatch half) and `batcher.merge` with its `device_pull` child (the
batch's one wait, `_PendingFlat.pull_t0/t1`) on every sampled member, and
writes the queue wait, the pull window and the occupancy into each
Observation. No wait is added: `ESTPU_TRACE_SYNC=1` (bench and debug only)
makes the drainer wait on a traced batch's CUDA event after its dispatch,
so the dispatch span covers its device work. A profiled request never
enqueues (search/service.py); it is counted in `profile_bypassed`.

When a coalesced batch fails (a breaker trip, a device error), the drainer
replays each item on its own, on the device, so only the request that really
fails carries the error; its neighbours keep their answers. The batch-level
error is never recorded against a fault domain's circuit: the replay decides
which member was poisoned, and that member's caller records its own error
and degrades to the host scorer (search/service.py). No launch or wait
happens while the condition or the stats lock is held.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future

from ..common import insights as _insights
from ..common import tracing
from ..common.deadline import NO_DEADLINE, Deadline
from ..common.devicehealth import DEGRADABLE, classify_device_error
from ..common.errors import RejectedExecutionError
from ..common.logging import get_logger
from ..common.metrics import HistogramMetric
from ..common.settings import Settings
from ..ops.device_index import _pow2_bucket

_K_MIN = 16  # smallest k bucket (top-10 pages and top-16 share launches)
# overlapped merge waits are meant to be near zero: buckets from 10µs
_MERGE_WAIT_BOUNDS = tuple(1e-5 * 2.0 ** i for i in range(18))


def _k_bucket(k: int) -> int:
    return _pow2_bucket(k, _K_MIN)


def _index_label(item) -> str:
    """The index an in-flight batch serves (its leader's context), for the
    watchdog; never raises, whatever a payload holds."""
    payload = item.payload
    ctx = payload[1] if isinstance(payload, tuple) and len(payload) > 1 else None
    return getattr(ctx, "index_name", None) or "flat"


class _Item:
    __slots__ = ("family", "key", "payload", "k", "kb", "deadline", "future",
                 "t_enq", "span", "obs")

    def __init__(self, family, key, payload, k: int, kb: int,
                 deadline: Deadline):
        self.family = family
        self.key = key
        self.payload = payload
        self.k = k  # the request's own k (fan-out trims to it)
        self.kb = kb  # the bucketed launch k
        self.deadline = deadline
        self.future: Future = Future()
        self.t_enq = time.monotonic()
        # the enqueuing request's active span (None: untraced) and insights
        # Observation (None: insights off), read on the caller's thread
        self.span = tracing.current_span()
        self.obs = _insights.current()


class _FlatFamily:
    """Coalesces single-shard FlatPlans into dispatch_flat_batch launches.
    payload = (plan, ShardContext, the plan's `prepare_dense` input, built
    by the caller); the batch runs with the LEADER item's context — the key
    guarantees every member sees the identical segment view and stats
    sources, so per-plan weights and segment rows are identical either
    way."""

    @staticmethod
    def key(ctx, kb: int):
        s = ctx.searcher
        return ("flat", id(ctx.mapper_service), id(ctx.similarity_service),
                tuple(id(seg) for seg in s.segments), kb)

    @staticmethod
    def prepare(plan, ctx):
        from .execute import prepare_dense

        return prepare_dense([plan], ctx)[0]

    @staticmethod
    def dispatch(items, kb: int):
        from .execute import dispatch_flat_batch

        ctx = items[0].payload[1]
        return dispatch_flat_batch([it.payload[0] for it in items], ctx, kb,
                                   [it.payload[2] for it in items])

    @staticmethod
    def fan_out(handle, items):
        from .execute import TopDocs

        merged = handle.merge()
        return [None if td is None else
                TopDocs(total=td.total, hits=td.hits[: it.k], max_score=td.max_score)
                for it, td in zip(items, merged)]

    @staticmethod
    def execute_single(item):
        from .execute import dispatch_flat_batch

        plan, ctx, prep = item.payload
        return dispatch_flat_batch([plan], ctx, item.k, [prep]).merge()[0]

    @staticmethod
    def finish(item, td):
        """The caller's answer: a query the dense family handed back (None)
        is served by the host scorer here, on the caller's thread."""
        from .execute import host_reruns

        plan, ctx, _prep = item.payload
        return host_reruns([plan], [td], ctx, item.k)[0]


class DeviceBatcher:
    """Coalescing queue + drainer for cross-request device batching.

    Grouping is per coalesce key — which embeds the shard's point-in-time
    segment view — so this IS per-shard batching; one queue simply lets a
    single drainer double-buffer across shards too."""

    def __init__(self, settings: Settings | None = None):
        settings = settings or Settings.EMPTY
        self.max_batch = max(1, settings.get_int("search.batch.max_batch", 64))
        self.linger_s = max(
            0.0, settings.get_float("search.batch.linger_ms", 1.5)) / 1000.0
        self.min_linger_s = max(
            0.0, settings.get_float("search.batch.min_linger_ms", 0.1)) / 1000.0
        self.queue_cap = max(1, settings.get_int("search.batch.queue_size", 1024))
        self.logger = get_logger("search.batcher")
        self._queue: deque[_Item] = deque()
        self._cv = threading.Condition()
        self._shutdown = False
        self._drainer_started = False
        self._drainer_dead = False
        # EWMA of batch service time (dispatch start -> fan-out done): what the
        # deadline flush subtracts so launch + merge still fit in the budget
        self._ewma_cost = 0.004
        self._stats_lock = threading.Lock()
        self._launches = 0
        self._items_launched = 0  # total items served via coalesced launches
        self._full_flushes = 0
        self._linger_flushes = 0
        self._deadline_flushes = 0
        self._pending_flushes = 0  # flushed early because a merge was waiting
        self._bypassed = 0  # queue full / drainer dead / shut down -> inline
        # profiled requests launch from their own thread, never queued
        # (service._execute_flat_single)
        self._profile_bypassed = 0
        # plans their caller launched beside the drainer, never queued: the
        # DFS phase's global statistics are the plan's own (service.py)
        self._direct = 0
        self._splits = 0  # coalesced launch failed -> per-item replay
        self._device_splits = 0  # ... of them on a failure of the card
        # batch service-time tail (dispatch start -> fan-out done)
        self.service_hist = HistogramMetric()
        # the merge's one wait (pull_t1 - pull_t0) for batches merged while
        # the next batch was already launched: double buffering hides the
        # device only while this stays near zero
        self.merge_wait_hist = HistogramMetric(_MERGE_WAIT_BOUNDS)
        self._batch_ids = itertools.count(1)
        # dispatched, unmerged batches, oldest first, written only by the
        # drainer and read unlocked by the stall watchdog: (batch id,
        # dispatch time, family, occupancy, index). Pushed before the
        # dispatch, so a hang inside it ages too; under double buffering
        # the head is batch N, still merging while N+1 is dispatched
        self._inflight_q: deque[tuple] = deque()
        self._flat = _FlatFamily()

    # -- public entry point --------------------------------------------------
    def execute(self, plan, ctx, k: int, deadline: Deadline = NO_DEADLINE):
        """Coalesce one shard-local FlatPlan with concurrent callers; blocks
        until the batch lands and returns this plan's TopDocs (hits trimmed
        to k). Launches the single plan directly when the batcher is shut
        down, the queue is saturated, or the drainer has died. The plan's
        host inputs are built before it is queued, and a host rerun runs
        after its batch, both here on the caller's thread."""
        k = max(k, 1)
        kb = _k_bucket(k)
        item = _Item(self._flat, self._flat.key(ctx, kb),
                     (plan, ctx, self._flat.prepare(plan, ctx)), k, kb,
                     deadline or NO_DEADLINE)
        return self._flat.finish(item, self._submit(item))

    def _submit(self, item: _Item):
        with self._cv:
            # _drainer_dead is re-checked HERE, under the condition: the death
            # path flips it and drains the queue under the same lock, so an
            # item can never land in a queue nobody will ever service
            if (self._shutdown or self._drainer_dead
                    or len(self._queue) >= self.queue_cap):
                inline = True
            else:
                self._queue.append(item)
                self._cv.notify_all()
                inline = False
        if inline:
            # a saturated coalescing queue must not become a second rejection
            # layer — serve directly instead
            with self._stats_lock:
                self._bypassed += 1
            return item.family.execute_single(item)
        self._ensure_drainer()
        remaining = item.deadline.remaining()
        # generous slack past the deadline: the flush logic targets the
        # deadline itself, this wait only guards against a wedged drainer
        timeout = None if remaining is None else remaining + 30.0
        return item.future.result(timeout=timeout)

    # -- drainer -------------------------------------------------------------
    def _ensure_drainer(self):
        if self._drainer_started:
            return
        with self._cv:
            if self._drainer_started or self._shutdown:
                return
            self._drainer_started = True
        threading.Thread(target=self._drain_loop, daemon=True,
                         name="estpu_torch[search_batcher]").start()

    def _drain_loop(self):
        try:
            self._drain()
        except BaseException as e:  # noqa: BLE001 — a dead drainer must not
            # strand waiters: flag it (under the condition, so no _submit can
            # slip an item into the queue after the drain below) and fail
            # anything already queued; later submits launch directly
            with self._cv:
                self._drainer_dead = True
            self.logger.warning(f"batcher drainer died ({type(e).__name__}: "
                                f"{e}); serving falls back to direct launches")
            self._fail_queued(e)
            raise

    def _drain(self):
        pending = None  # (family, items, handle, t0, id): dispatched, unmerged
        while True:
            batch = None
            with self._cv:
                while not self._queue and not self._shutdown:
                    if pending is not None:
                        break  # merge the in-flight batch instead of idling
                    self._cv.wait(0.1)
                if self._queue and not self._shutdown:
                    batch = self._collect_locked(urgent=pending is not None)
            if batch is None:
                if pending is not None:
                    self._finish(*pending)
                    pending = None
                    continue
                if self._shutdown:
                    break
                continue
            items, reason = batch
            t0 = time.monotonic()
            family = items[0].family
            batch_id = next(self._batch_ids)
            traced = [it for it in items if it.span]
            # the queue wait, from the item's enqueue clock and t0 (span
            # recording takes only the trace's leaf lock)
            for it in traced:
                it.span.record("batcher.queue", it.t_enq, t0, batch=batch_id,
                               reason=reason, occupancy=len(items))
            for it in items:
                if it.obs is not None:
                    it.obs.queue_s = t0 - it.t_enq
            self._inflight_q.append(
                (batch_id, t0, "flat", len(items), _index_label(items[0])))
            try:
                # dispatch-then-merge double buffering: batch N+1's device
                # work is enqueued BEFORE batch N's host merge runs
                handle = family.dispatch(items, items[0].kb)
            except Exception as e:  # noqa: BLE001 — replay decides per item
                self._retire_inflight(batch_id)
                self._split(family, items, e)
                continue
            if traced and tracing.sync_armed():
                # ESTPU_TRACE_SYNC=1 (bench and debug only): wait on the
                # batch's CUDA event so the dispatch span covers its device
                # work; this gives up the double-buffer overlap
                handle.sync()
            if traced:
                t_disp = time.monotonic()
                for it in traced:
                    it.span.record("batcher.dispatch", t0, t_disp, batch=batch_id,
                                   occupancy=len(items), family="flat")
            self._note_flush(reason)
            if pending is not None:
                self._finish(*pending, overlapped=True)
            pending = (family, items, handle, t0, batch_id)
            with self._cv:
                queue_empty = not self._queue
            if queue_empty:
                self._finish(*pending)
                pending = None
        if pending is not None:
            self._finish(*pending)
        self._fail_queued(RejectedExecutionError(
            "search batcher is shut down"))

    def _collect_locked(self, urgent: bool = False):
        """Pick the oldest item's key and wait (under the condition) until a
        flush trigger fires; pops and returns (items, reason). Called with
        the condition held; may release it while waiting.

        `urgent` means a dispatched batch is waiting to be MERGED: take
        whatever is queued at once instead of lingering for batch N+1 while
        batch N's answers wait."""
        head = self._queue[0]
        key = head.key
        while True:
            same = [it for it in self._queue if it.key == key]
            n = len(same)
            if n >= self.max_batch:
                reason = "full"
                break
            if urgent:
                reason = "pending"
                break
            now = time.monotonic()
            # adaptive linger: shrinks linearly as the queue fills — waiting
            # longer only pays when it buys occupancy
            linger_eff = max(self.min_linger_s,
                             self.linger_s * (1.0 - n / float(self.max_batch)))
            flush_at = head.t_enq + linger_eff
            reason = "linger"
            for it in same:
                rem = it.deadline.remaining()
                if rem is None:
                    continue
                # leave one expected batch service time (launch + merge) of
                # budget so the flushed batch can still answer in time
                dl_at = now + rem - self._ewma_cost
                if dl_at < flush_at:
                    flush_at = dl_at
                    reason = "deadline"
            if now >= flush_at or self._shutdown:
                break
            self._cv.wait(min(flush_at - now, 0.05))
        taken: list[_Item] = []
        rest: deque[_Item] = deque()
        for it in self._queue:
            if it.key == key and len(taken) < self.max_batch:
                taken.append(it)
            else:
                rest.append(it)
        self._queue.clear()
        self._queue.extend(rest)
        return taken, reason

    def _finish(self, family, items, handle, t0: float, batch_id: int = 0,
                overlapped: bool = False):
        """Merge a dispatched batch and fan results out to the item futures.
        `overlapped`: the next batch is already launched, so the merge's
        wait is recorded — it should cover this batch's device work alone."""
        t_m0 = time.monotonic()
        try:
            results = family.fan_out(handle, items)
        except Exception as e:  # noqa: BLE001 — replay decides per item
            self._retire_inflight(batch_id)
            self._split(family, items, e)
            return
        t_m1 = time.monotonic()
        self._retire_inflight(batch_id)  # merged: the stall marker retires
        dt = t_m1 - t0
        # the merge span and the batch's one wait, on every member: the pull
        # window was stamped around PendingPull.wait by the merge itself
        pull_t0, pull_t1 = handle.pull_t0, handle.pull_t1
        for it in items:
            if it.obs is not None:
                it.obs.device_s = pull_t1 - pull_t0
                it.obs.occupancy = len(items)
            if it.span:
                merge_span = it.span.record("batcher.merge", t_m0, t_m1,
                                            batch=batch_id)
                merge_span.record("device_pull", pull_t0, pull_t1,
                                  batch=batch_id)
        # histogram locks are leaves — observed outside _stats_lock
        self.service_hist.observe(dt)
        if overlapped:
            self.merge_wait_hist.observe(handle.pull_t1 - handle.pull_t0)
        with self._stats_lock:
            self._ewma_cost = 0.2 * dt + 0.8 * self._ewma_cost
            self._launches += 1
            self._items_launched += len(items)
        for it, res in zip(items, results):
            it.future.set_result(res)

    def _split(self, family, items, err):
        """A coalesced launch failed (breaker trip, device error): replay every
        item on its own, on the device, so only the request that actually
        fails carries the error — its neighbours must not inherit an error
        sized for the batch. A failure of the card counts a device split
        and is NOT recorded against a circuit here: each member's own verdict
        reaches the fault domains through its future (the caller's
        service._device_failed), so neighbours' collateral never advances
        one."""
        if len(items) == 1:
            items[0].future.set_exception(err)
            return
        with self._stats_lock:
            self._splits += 1
            if classify_device_error(err) in DEGRADABLE:
                self._device_splits += 1
        for it in items:
            try:
                res = family.execute_single(it)
            except Exception as e:  # noqa: BLE001 — per-item verdict
                it.future.set_exception(e)
            else:
                it.future.set_result(res)

    def _note_flush(self, reason: str):
        with self._stats_lock:
            if reason == "full":
                self._full_flushes += 1
            elif reason == "deadline":
                self._deadline_flushes += 1
            elif reason == "pending":
                self._pending_flushes += 1
            else:
                self._linger_flushes += 1

    def _fail_queued(self, err):
        with self._cv:
            items, self._queue = list(self._queue), deque()
        for it in items:
            if not it.future.done():
                it.future.set_exception(err)

    def _retire_inflight(self, batch_id: int):
        """Drop one batch's in-flight marker (drainer thread only): almost
        always the head; a batch whose dispatch failed while an older one
        was pending sits behind it."""
        q = self._inflight_q
        if q and q[0][0] == batch_id:
            q.popleft()
            return
        for entry in list(q):
            if entry[0] == batch_id:
                q.remove(entry)
                return

    def inflight(self) -> dict | None:
        """The oldest dispatched, unmerged batch as the stall watchdog sees
        it: {batch, age_s, family, occupancy, shard}, or None. One unlocked
        read of the deque's head, on the watchdog's clock."""
        try:
            batch_id, t0, family, occupancy, label = self._inflight_q[0]
        except IndexError:
            return None
        return {"batch": batch_id, "age_s": time.monotonic() - t0,
                "family": family, "occupancy": occupancy, "shard": label}

    def note_direct(self):
        """Count a plan its caller launches directly instead of queueing
        (search/service.py `_execute_flat_single` under DFS statistics)."""
        with self._stats_lock:
            self._direct += 1

    def note_profile_bypass(self):
        """Count a profiled request that launched from its own thread
        instead of coalescing (service._execute_flat_single)."""
        with self._stats_lock:
            self._profile_bypassed += 1

    # -- lifecycle / observability -------------------------------------------
    def shutdown(self):
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()

    def stats(self) -> dict:
        with self._stats_lock:
            launches = self._launches
            items = self._items_launched
            out = {
                "launches": launches,
                "coalesced": items,
                "occupancy_mean": round(items / launches, 3) if launches else 0.0,
                "full_flushes": self._full_flushes,
                "linger_flushes": self._linger_flushes,
                "deadline_flushes": self._deadline_flushes,
                "pending_flushes": self._pending_flushes,
                "bypassed": self._bypassed,
                "profile_bypassed": self._profile_bypassed,
                "direct": self._direct,
                "splits": self._splits,
                "device_splits": self._device_splits,
                "queue": len(self._queue),
                "ewma_batch_ms": round(self._ewma_cost * 1000.0, 3),
            }
        # percentiles outside _stats_lock (the histograms' own leaf locks)
        out["batch"] = self.service_hist.stats()
        out["merge_wait"] = self.merge_wait_hist.stats()
        return out
