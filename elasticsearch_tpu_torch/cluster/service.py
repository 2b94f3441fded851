"""ClusterService: the single-threaded prioritized state-update executor (a
copy of the JAX package's `cluster/service.py`).

Every cluster-state mutation runs on ONE thread in priority order: a task
takes the current state and returns a new one; when the state changed on
the master, the publisher (zen discovery's `publish`) fans it to the other
nodes first, then it is installed and listeners fire with a
ClusterChangedEvent (`nodes_added`, `nodes_removed`, `routing_changed`,
`metadata_changed`). A node that is not master installs a published state
through `apply_new_state`, which keeps its own state when the published
one is not newer. `pending_tasks` lists the queued tasks
(`_cluster/pending_tasks`)."""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field as dc_field
from typing import Callable

from ..common.logging import get_logger
from .state import ClusterState

URGENT, HIGH, NORMAL = 0, 1, 2


@dataclass(order=True)
class _Task:
    priority: int
    seq: int
    source: str = dc_field(compare=False)
    fn: Callable = dc_field(compare=False)
    future: Future = dc_field(compare=False)
    insertion_time: float = dc_field(compare=False, default=0.0)


@dataclass
class ClusterChangedEvent:
    source: str
    previous_state: ClusterState
    state: ClusterState

    def nodes_added(self):
        prev = {n.id for n in self.previous_state.nodes.nodes}
        return [n for n in self.state.nodes.nodes if n.id not in prev]

    def nodes_removed(self):
        cur = {n.id for n in self.state.nodes.nodes}
        return [n for n in self.previous_state.nodes.nodes if n.id not in cur]

    def routing_changed(self) -> bool:
        return self.previous_state.routing_table != self.state.routing_table

    def metadata_changed(self) -> bool:
        return self.previous_state.metadata != self.state.metadata


class ClusterService:
    def __init__(self, node_name: str = "node"):
        self.logger = get_logger("cluster.service", node=node_name)
        self._state = ClusterState()
        self._listeners: list[Callable[[ClusterChangedEvent], None]] = []
        self._queue: list[_Task] = []
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._publish = None  # master side: fn(new_state) fans it out
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"estpu_torch[{node_name}][clusterService]")
        self._thread.start()

    @property
    def state(self) -> ClusterState:
        return self._state

    def add_listener(self, listener: Callable[[ClusterChangedEvent], None]):
        self._listeners.append(listener)

    def set_publisher(self, publish: Callable):
        self._publish = publish

    def submit_state_update_task(self, source: str,
                                 fn: Callable[[ClusterState], ClusterState],
                                 priority: int = NORMAL) -> Future:
        """fn runs ON the cluster-state thread; the Future resolves to the
        resulting state."""
        fut: Future = Future()
        task = _Task(priority, next(self._seq), source, fn, fut, time.monotonic())
        with self._cv:
            if self._stopped:
                fut.set_exception(RuntimeError("cluster service stopped"))
                return fut
            heapq.heappush(self._queue, task)
            self._cv.notify()
        return fut

    def apply_new_state(self, source: str, new_state: ClusterState) -> Future:
        """A published state arrives on a node that is not master: install
        it unless the node already holds a newer one under a master."""

        def apply(current: ClusterState) -> ClusterState:
            if new_state.version <= current.version and current.nodes.master_id is not None \
                    and new_state.version != 0:
                return current
            return new_state

        return self.submit_state_update_task(source, apply, priority=URGENT)

    def pending_tasks(self) -> list[dict]:
        with self._cv:
            return [
                {"source": t.source, "priority": t.priority,
                 "time_in_queue_millis": int((time.monotonic() - t.insertion_time) * 1000)}
                for t in sorted(self._queue)
            ]

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._stopped:
                    self._cv.wait(0.1)
                if self._stopped and not self._queue:
                    return
                task = heapq.heappop(self._queue)
            try:
                previous = self._state
                new_state = task.fn(previous)
                if new_state is None:
                    new_state = previous
                changed = new_state is not previous and new_state != previous
                if changed and self._publish is not None and \
                        new_state.nodes.local_id is not None and \
                        new_state.nodes.master_id == new_state.nodes.local_id:
                    # the master publishes before it installs
                    self._publish(new_state)
                self._state = new_state
                if changed:
                    event = ClusterChangedEvent(task.source, previous, new_state)
                    for listener in list(self._listeners):
                        try:
                            listener(event)
                        except Exception as e:  # noqa: BLE001
                            self.logger.warning("listener failed on [%s]: %s",
                                                task.source, e)
                task.future.set_result(self._state)
            except Exception as e:  # noqa: BLE001
                task.future.set_exception(e)

    def close(self):
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=2)
