"""Hierarchical memory circuit breakers (a trimmed copy of the JAX package's
`common/breaker.py`: `MemoryCircuitBreaker`, `reserve`,
`CircuitBreakerService`).

Estimate bytes BEFORE a large allocation and trip with CircuitBreakingError
(HTTP 429) instead of running the host or the card out of memory. A child
breaker has its own limit and shares ONE parent budget. The port has three
children: `request` (the sparse path's per-batch staging), `fielddata`
(segment packs and the lazy dense plane, `ops/device_index.py`) and
`in_flight_requests` (encoded transport messages, `transport/service.py`).

Rules:

- estimate-before-allocate, release in `finally` — accounting is transient,
  so a drained node always returns to 0 estimated bytes;
- lock order is child → parent, never the reverse.
"""

from __future__ import annotations

import contextlib
import threading

from . import profile
from .errors import CircuitBreakingError
from .units import parse_bytes, parse_ratio_or_bytes


class MemoryCircuitBreaker:
    """One named breaker. `parent` (another MemoryCircuitBreaker, no parent of
    its own) is consulted AFTER the child's own limit passes, so a trip at
    either level leaves both levels' accounting untouched."""

    def __init__(self, limit_bytes: int, name: str = "request",
                 parent: "MemoryCircuitBreaker | None" = None):
        self.name = name
        self.limit = int(limit_bytes)
        self.parent = parent
        self._used = 0
        self._trip_count = 0
        self._leak_detected = 0
        self._lock = threading.Lock()

    def _check(self, new_used: int, label: str, child: str | None = None):
        """Raise (and count the trip) when `new_used` would exceed the limit.
        Caller holds self._lock."""
        if self.limit > 0 and new_used > self.limit:
            self._trip_count += 1
            who = f"[{self.name}]" if child is None else \
                f"[{self.name}] (via [{child}])"
            err = CircuitBreakingError(
                f"{who} data for [{label}] would be larger than limit of "
                f"[{self.limit}] bytes (estimated [{new_used}])")
            err.breaker = self.name
            raise err

    def add_estimate_and_maybe_break(self, bytes_: int, label: str = "") -> int:
        """Reserve `bytes_` or raise CircuitBreakingError. The read-modify-write
        is fully under the lock: concurrent searches can never jointly blow
        past the limit between the check and the commit."""
        bytes_ = int(bytes_)
        if bytes_ < 0:
            self.release(-bytes_)
            return self._used
        with self._lock:
            new_used = self._used + bytes_
            self._check(new_used, label)
            if self.parent is not None:
                # child → parent lock order, always; a parent trip propagates
                # before the child commits, so nothing needs unwinding
                self.parent._add_from_child(bytes_, label, self.name)
            self._used = new_used
            return self._used

    def _add_from_child(self, bytes_: int, label: str, child: str) -> int:
        with self._lock:
            new_used = self._used + bytes_
            self._check(new_used, label, child=child)
            self._used = new_used
            return self._used

    def release(self, bytes_: int):
        """Return reserved bytes. Over-release clamps at zero and counts a
        leak instead of driving `used` negative (negative accounting would
        silently inflate every later request's headroom)."""
        bytes_ = int(bytes_)
        if bytes_ <= 0:
            return
        with self._lock:
            freed = min(bytes_, self._used)
            if freed < bytes_:
                self._leak_detected += 1
            self._used -= freed
        if self.parent is not None and freed:
            self.parent.release(freed)

    @property
    def used(self) -> int:
        return self._used

    @property
    def trip_count(self) -> int:
        return self._trip_count

    @property
    def leak_detected(self) -> int:
        return self._leak_detected

    def stats(self) -> dict:
        return {
            "limit": self.limit,
            "estimated": self._used,
            "tripped": self._trip_count,
            "leak_detected": self._leak_detected,
        }


@contextlib.contextmanager
def reserve(breaker: MemoryCircuitBreaker | None, bytes_: int, label: str = ""):
    """Estimate-before-allocate scope: charge on entry, ALWAYS release on
    exit. `breaker=None` (an unwired context) is a no-op, so call sites never
    special-case it."""
    if breaker is None or bytes_ <= 0:
        yield 0
        return
    breaker.add_estimate_and_maybe_break(int(bytes_), label)
    # a profiled request records each estimate it was granted (one
    # thread-local read on the unprofiled path)
    prof = profile.current()
    if prof is not None:
        prof.breaker_reserve(breaker.name, label, int(bytes_))
    try:
        yield int(bytes_)
    finally:
        breaker.release(int(bytes_))


class CircuitBreakerService:
    """The node's breaker hierarchy: one parent budget
    (`indices.breaker.total.limit`, default 70% of the byte budget) over
    three children:

    - `request` — per-request materialization, here the sparse path's
      per-batch staging (`indices.breaker.request.limit`, default 60%);
    - `fielddata` — segment packs and the lazy dense plane
      (`indices.fielddata.breaker.limit`, default 80%);
    - `in_flight_requests` — encoded transport message bytes in flight
      (`network.breaker.inflight_requests.limit`, default 100%).

    The byte budget comes from `indices.breaker.total_budget` ("64kb" /
    "2gb" / raw bytes; default the `total_budget_bytes` argument)."""

    _CHILDREN = (("request", "indices.breaker.request.limit", "60%"),
                 ("fielddata", "indices.fielddata.breaker.limit", "80%"),
                 ("in_flight_requests",
                  "network.breaker.inflight_requests.limit", "100%"))

    def __init__(self, settings=None, total_budget_bytes: int = 8 << 30):
        from .settings import Settings

        settings = settings or Settings.EMPTY
        budget = parse_bytes(settings.get("indices.breaker.total_budget"),
                             default=int(total_budget_bytes))
        # the byte budget the limits are shares of (the request cache's
        # size is one too)
        self.total_budget = budget
        self.parent = MemoryCircuitBreaker(
            parse_ratio_or_bytes(settings.get("indices.breaker.total.limit"),
                                 budget, default="70%"),
            "parent")
        self.breakers: dict[str, MemoryCircuitBreaker] = {
            name: MemoryCircuitBreaker(
                parse_ratio_or_bytes(settings.get(key), budget, default=dflt),
                name, parent=self.parent)
            for name, key, dflt in self._CHILDREN}

    def breaker(self, name: str = "request") -> MemoryCircuitBreaker:
        return self.breakers[name]

    def stats(self) -> dict:
        out = {name: b.stats() for name, b in self.breakers.items()}
        out["parent"] = self.parent.stats()
        return out
