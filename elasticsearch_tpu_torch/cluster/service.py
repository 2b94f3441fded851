"""ClusterService: the single-threaded prioritized state-update executor (a
trimmed copy of the JAX package's `cluster/service.py`).

Every cluster-state mutation runs on ONE thread in priority order: a task
takes the current state and returns a new one; when the state changed,
listeners fire with a ClusterChangedEvent. Publishing to other nodes belongs
to the slice with two nodes."""

from __future__ import annotations

import heapq
import itertools
import threading
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


@dataclass
class ClusterChangedEvent:
    source: str
    previous_state: ClusterState
    state: ClusterState

    def metadata_changed(self) -> bool:
        return self.previous_state.metadata != self.state.metadata


class ClusterService:
    def __init__(self, node_name: str = "node"):
        self.logger = get_logger("cluster.service")
        self._state = ClusterState()
        self._listeners: list[Callable[[ClusterChangedEvent], None]] = []
        self._queue: list[_Task] = []
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"estpu_torch[{node_name}][clusterService]")
        self._thread.start()

    @property
    def state(self) -> ClusterState:
        return self._state

    def add_listener(self, listener: Callable[[ClusterChangedEvent], None]):
        self._listeners.append(listener)

    def submit_state_update_task(self, source: str,
                                 fn: Callable[[ClusterState], ClusterState],
                                 priority: int = NORMAL) -> Future:
        """fn runs ON the cluster-state thread; the Future resolves to the
        resulting state."""
        fut: Future = Future()
        task = _Task(priority, next(self._seq), source, fn, fut)
        with self._cv:
            if self._stopped:
                fut.set_exception(RuntimeError("cluster service stopped"))
                return fut
            heapq.heappush(self._queue, task)
            self._cv.notify()
        return fut

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
