"""Named thread pools with bounded queues, and a fixed-delay scheduler (a
trimmed copy of the JAX package's `threadpool.py`).

A pool whose queue is full rejects the task with RejectedExecutionError
(HTTP 429) instead of queueing it forever. The pools are the ones the
one-node slice runs work on: `generic` (transport dispatch, recoveries),
`index`, `bulk`, `get`, `search`, `management`, `refresh`, `merge` (merges and
compaction packs) and `warmer` (the other packs off the query path). The JAX
package's one-shot timer wheel serves hedged and timed shard attempts, which
wait for the slice with replicas.

Each pool records the wait of every task in its queue in a
`HistogramMetric` (`pool_histograms()`), which the stall watchdog reads for
queue-wait spikes. A scheduled task stops at `cancel()`.

`shutdown()` stops the scheduler and shuts every executor down without
waiting: an idle worker exits at once, so after `Node.close()` no pool
thread keeps the process alive."""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

from .common.errors import RejectedExecutionError
from .common.logging import get_logger
from .common.metrics import HistogramMetric

logger = get_logger("threadpool")

_DEFAULT_SIZES = {"generic": 8, "index": 4, "bulk": 4, "get": 4, "search": 8,
                  "management": 2, "refresh": 2, "merge": 2, "warmer": 2}

# queue bounds (`threadpool.<name>.queue_size`; -1 = unbounded): the dispatch
# trampoline and the maintenance pools stay unbounded, as in the JAX package
# (a rejected warm pack would only move its pack onto the query path)
_DEFAULT_QUEUES = {"generic": -1, "management": -1, "merge": -1, "warmer": -1,
                   "index": 200, "bulk": 200, "get": 1000, "search": 1000,
                   "refresh": 1000}


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
        self._scheduler.join(timeout=1.0)
        for pool in self._pools.values():
            pool.executor.shutdown(wait=False, cancel_futures=True)

    def stats(self) -> dict:
        return {name: pool.stats() for name, pool in self._pools.items()}

    def pool_histograms(self) -> dict:
        """name -> that pool's queue-wait HistogramMetric."""
        return {name: pool.queue_wait for name, pool in self._pools.items()}
