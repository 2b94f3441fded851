"""Named thread pools with bounded queues, a fixed-delay scheduler and a
one-shot timer wheel (a trimmed copy of the JAX package's `threadpool.py`).

A pool whose queue is full rejects the task with RejectedExecutionError
(HTTP 429) instead of queueing it forever. The pools are the ones a port
node runs work on: `generic` (transport dispatch, recoveries, timers),
`index`, `bulk`, `replica` (the replica legs of writes), `get`, `search`,
`management`, `refresh`, `merge` (merges and compaction packs) and
`warmer` (the other packs off the query path). The replica legs have a
pool of their own: a primary waits for its replicas' acks on its `index`
or `bulk` thread, so two nodes whose primaries waited on each other's
replicas in one pool could deadlock it.

`schedule(delay, pool, fn)` puts a one-shot timer on the shared wheel (one
heap, one thread; a `ScheduledTimer` handle with `cancel()`): a search's
failover chain arms one per shard attempt.

Each pool records the wait of every task in its queue in a
`HistogramMetric` (`pool_histograms()`), which the stall watchdog reads for
queue-wait spikes. A scheduled task stops at `cancel()`.

`shutdown()` stops the scheduler and shuts every executor down without
waiting: an idle worker exits at once, so after `Node.close()` no pool
thread keeps the process alive."""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

from .common.errors import RejectedExecutionError
from .common.logging import get_logger
from .common.metrics import HistogramMetric

logger = get_logger("threadpool")

_DEFAULT_SIZES = {"generic": 8, "index": 4, "bulk": 4, "replica": 4, "get": 4,
                  "search": 8, "management": 2, "refresh": 2, "merge": 2,
                  "warmer": 2}

# queue bounds (`threadpool.<name>.queue_size`; -1 = unbounded): the dispatch
# trampoline and the maintenance pools stay unbounded, as in the JAX package
# (a rejected warm pack would only move its pack onto the query path)
_DEFAULT_QUEUES = {"generic": -1, "management": -1, "merge": -1, "warmer": -1,
                   "index": 200, "bulk": 200, "replica": 200, "get": 1000,
                   "search": 1000, "refresh": 1000}


class ScheduledTimer:
    """One entry on the timer wheel: `cancel()` before it fires and it never
    does. A cancelled or fired entry holds no `fn`, so one that waits in the
    heap for the wheel to reach it keeps nothing of its caller alive."""

    __slots__ = ("deadline", "pool", "fn")

    def __init__(self, deadline: float, pool: str, fn):
        self.deadline = deadline
        self.pool = pool
        self.fn = fn

    def cancel(self):
        self.fn = None


class _ScheduledTask:
    def __init__(self, interval: float, fn, pool: str):
        self.interval = interval
        self.fn = fn
        self.pool = pool
        self.next = time.monotonic() + interval
        self.cancelled = threading.Event()

    def cancel(self):
        self.cancelled.set()


class _BoundedPool:
    """ThreadPoolExecutor wrapper tracking queued / active / rejected /
    completed and enforcing the queue bound: a submit is rejected when the
    queued backlog, less the idle workers, reaches the bound."""

    def __init__(self, name: str, size: int, queue_size: int):
        self.name = name
        self.size = size
        self.queue_size = queue_size
        self.executor = ThreadPoolExecutor(max_workers=size,
                                           thread_name_prefix=f"estpu_torch[{name}]")
        self._lock = threading.Lock()
        self.queued = 0
        self.active = 0
        self.rejected = 0
        self.completed = 0
        # time each task spent queued: "slow because queued" apart from
        # "slow because running"
        self.queue_wait = HistogramMetric()

    def submit(self, fn, *args, **kwargs) -> Future:
        with self._lock:
            if self.queue_size >= 0:
                idle = max(0, self.size - self.active)
                if self.queued - idle >= self.queue_size:
                    self.rejected += 1
                    raise RejectedExecutionError(
                        f"rejected execution on [{self.name}]: queue capacity "
                        f"[{self.queue_size}] full "
                        f"(queued [{self.queued}], active [{self.active}])")
            self.queued += 1
        try:
            return self.executor.submit(self._run, fn, args, kwargs,
                                        time.monotonic())
        except RuntimeError:
            with self._lock:
                self.queued -= 1
                self.rejected += 1
            raise RejectedExecutionError(
                f"rejected execution on [{self.name}]: pool is shut down") from None

    def _run(self, fn, args, kwargs, t_submit: float):
        self.queue_wait.observe(time.monotonic() - t_submit)
        with self._lock:
            self.queued -= 1
            self.active += 1
        try:
            return fn(*args, **kwargs)
        finally:
            with self._lock:
                self.active -= 1
                self.completed += 1

    def stats(self) -> dict:
        with self._lock:
            out = {"threads": self.size, "queue": self.queued,
                   "queue_size": self.queue_size, "active": self.active,
                   "rejected": self.rejected, "completed": self.completed}
        # the histogram's own stripe locks, outside _lock
        out["queue_wait"] = self.queue_wait.stats()
        return out


class ThreadPool:
    def __init__(self, settings=None):
        from .common.settings import Settings

        settings = settings or Settings.EMPTY
        self._pools = {
            name: _BoundedPool(
                name, settings.get_int(f"threadpool.{name}.size", size),
                settings.get_int(f"threadpool.{name}.queue_size",
                                 _DEFAULT_QUEUES[name]))
            for name, size in _DEFAULT_SIZES.items()}
        self._tasks: list[_ScheduledTask] = []
        self._tasks_lock = threading.Lock()
        self._shutdown = threading.Event()
        self._scheduler = threading.Thread(target=self._scheduler_loop,
                                           daemon=True,
                                           name="estpu_torch[scheduler]")
        self._scheduler.start()
        # the one-shot timers: a heap under a condition, fired by one thread
        self._timer_heap: list[tuple[float, int, ScheduledTimer]] = []
        self._timer_seq = itertools.count()
        self._timer_cv = threading.Condition()
        self._timer_thread = threading.Thread(target=self._timer_loop, daemon=True,
                                              name="estpu_torch[timers]")
        self._timer_thread.start()

    def submit(self, name: str, fn, *args, **kwargs) -> Future:
        """Run fn on the named pool; "same" runs it inline on the caller's
        thread. Raises RejectedExecutionError when the pool's bounded queue
        is full or the pool is shut down."""
        if name == "same":
            f: Future = Future()
            try:
                f.set_result(fn(*args, **kwargs))
            except BaseException as e:  # noqa: BLE001 - mirror executor behavior
                f.set_exception(e)
            return f
        return self._pools[name].submit(fn, *args, **kwargs)

    def schedule(self, delay_s: float, name: str, fn) -> ScheduledTimer:
        """Run `fn` on pool `name` once, `delay_s` from now, unless the
        handle is cancelled first. A cancelled timer leaves the heap when
        the wheel reaches it. The wheel is woken only for a timer that comes
        before every other (it sleeps until the earliest one anyway): a
        search's attempt timers, nearly all cancelled long before they are
        due, cost no wake-up each."""
        t = ScheduledTimer(time.monotonic() + max(0.0, float(delay_s)), name, fn)
        with self._timer_cv:
            if self._shutdown.is_set():
                t.cancel()
                return t
            heapq.heappush(self._timer_heap, (t.deadline, next(self._timer_seq), t))
            if self._timer_heap[0][2] is t:
                self._timer_cv.notify()
        return t

    def _timer_loop(self):
        """Sleep until the earliest live deadline, then submit its task
        outside the condition (the pool's lock is the submit's own)."""
        while True:
            with self._timer_cv:
                while not self._shutdown.is_set():
                    while self._timer_heap and self._timer_heap[0][2].fn is None:
                        heapq.heappop(self._timer_heap)
                    now = time.monotonic()
                    if self._timer_heap and self._timer_heap[0][0] <= now:
                        break
                    self._timer_cv.wait(min(self._timer_heap[0][0] - now, 60.0)
                                        if self._timer_heap else 60.0)
                if self._shutdown.is_set():
                    return
                _deadline, _seq, t = heapq.heappop(self._timer_heap)
            fn, t.fn = t.fn, None
            if fn is None:
                continue  # cancelled between the pop and the fire
            try:
                self.submit(t.pool, fn)
            except RejectedExecutionError:
                pass  # a saturated or closed node drops timer work
            except Exception:  # noqa: BLE001 — one bad timer must not stop
                # the wheel, or no attempt timer of the node fires again
                logger.warning("timer fire failed (pool=%s)", t.pool, exc_info=True)

    def schedule_with_fixed_delay(self, interval_s: float, fn,
                                  name: str = "generic") -> _ScheduledTask:
        task = _ScheduledTask(interval_s, fn, name)
        with self._tasks_lock:
            self._tasks.append(task)
        return task

    def _scheduler_loop(self):
        while not self._shutdown.wait(0.05):
            now = time.monotonic()
            with self._tasks_lock:
                self._tasks = [t for t in self._tasks if not t.cancelled.is_set()]
                due = [t for t in self._tasks if now >= t.next]
            for task in due:
                task.next = now + task.interval
                try:
                    self.submit(task.pool, task.fn)
                except RejectedExecutionError:
                    if self._shutdown.is_set():
                        return
                    # saturated pool: skip this tick, keep the schedule

    def shutdown(self):
        self._shutdown.set()
        # outstanding timers are cancelled before the pools close: a timer
        # that fired later would run into torn-down services
        with self._timer_cv:
            heap, self._timer_heap = self._timer_heap, []
            self._timer_cv.notify_all()
        for _deadline, _seq, t in heap:
            t.cancel()
        self._scheduler.join(timeout=1.0)
        self._timer_thread.join(timeout=1.0)
        for pool in self._pools.values():
            pool.executor.shutdown(wait=False, cancel_futures=True)

    def stats(self) -> dict:
        return {name: pool.stats() for name, pool in self._pools.items()}

    def queue_depth(self, name: str) -> int:
        """One pool's queued backlog as a plain unlocked int read: the load
        signal a query-phase response carries back for adaptive replica
        selection (a torn read is at worst one task stale, which a decayed
        routing signal absorbs)."""
        pool = self._pools.get(name)
        return 0 if pool is None else pool.queued

    def pool_histograms(self) -> dict:
        """name -> that pool's queue-wait HistogramMetric."""
        return {name: pool.queue_wait for name, pool in self._pools.items()}
