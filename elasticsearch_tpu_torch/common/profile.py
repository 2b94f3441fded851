"""Request-scoped search profiling (a copy of the JAX package's
`common/profile.py`): the `profile` API's substrate.

Where tracing (common/tracing.py) answers *where* a request spent its time,
the profiler answers *why*: which clause, which segment, which execution
path (the hand-written sparse kernel, the dense fallback, the dense
families, the host scorer), which cache miss (segment pack, similarity
tables, the lazy dense plane, a staging set, a filter mask) made it
expensive, and how many postings, blocks and bytes the plan touched. The
response shape is the reference's `profile` section: per-shard entries
merged next to `_shards` by the coordinator.

Design rules (the port's device and lock discipline applies here too):

- **Zero overhead when off.** A hook is one thread-local read and a None
  check. `activate(None)` is never entered: call sites branch on the
  collector before wrapping.
- **Device timing only when opted in.** A profiled request's device phases
  are timed with a pair of CUDA events recorded around its own launches and
  waited on once at the end of its query phase (`time.perf_counter` on a
  `cpu` node, where the launches run inline); a request whose events cannot
  be recorded fails. The unprofiled serving path adds no wait.
- **The batcher is bypassed explicitly.** A profiled request launches from
  its own thread (`batcher: {bypassed, reason: "profile"}`), so its device
  phases are its own, not a coalesced batch's, and the collector stays
  single-writer: recording needs no locks.
- **Record under leaf code only.** Hooks append to plain lists and dicts
  owned by one thread; they never block and never launch.

Fallback-reason vocabulary: why a query left the device path —
  numeric_term, fuzzy_match, bool_filter_clause, non_term_subclause,
  must_not_only, function_score_no_query, function_score_ineligible,
  non_flat_subquery, similarity_not_fused, unsupported_query:<Type>,
  device_disabled, features:<f1,f2,...>, device_error:<Type>.
"""

from __future__ import annotations

import contextlib
import threading
import time

from .errors import ProfileTimingError

_local = threading.local()


def current() -> "ProfileCollector | None":
    """The thread's active collector, or None when the request is unprofiled
    (the common case — one thread-local read, nothing else)."""
    return getattr(_local, "prof", None)


@contextlib.contextmanager
def activate(prof: "ProfileCollector"):
    """Make `prof` the thread's collector for the scope. Call sites only
    enter this when a collector exists — the unprofiled path never pays the
    context manager."""
    prev = getattr(_local, "prof", None)
    _local.prof = prof
    try:
        yield prof
    finally:
        _local.prof = prev


class DeviceClock:
    """The device time of one profiled request's own launches (a port
    addition: the JAX profiler blocks on its dispatched arrays instead).
    On a `cuda` device each launch is bracketed by a pair of timing CUDA
    events, recorded on the launching stream; `elapsed_s()` waits once, on
    the last end event, and sums the pairs. On the CPU a launch runs inline
    and `time.perf_counter` brackets it. An event that cannot be recorded
    or read raises ProfileTimingError: the request fails."""

    __slots__ = ("cuda", "launches", "_pairs", "_host_s")

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.launches = 0
        self._pairs: list = []
        self._host_s = 0.0

    @contextlib.contextmanager
    def launch(self):
        self.launches += 1
        if not self.cuda:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._host_s += time.perf_counter() - t0
            return
        import torch

        try:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        except Exception as e:  # noqa: BLE001 — the request fails typed
            raise ProfileTimingError(f"cannot record a CUDA event: {e}",
                                     cause=e) from e
        yield
        try:
            end.record()
        except Exception as e:  # noqa: BLE001
            raise ProfileTimingError(f"cannot record a CUDA event: {e}",
                                     cause=e) from e
        self._pairs.append((start, end))

    def elapsed_s(self) -> float:
        """Seconds of device time over the bracketed launches; on the card
        one wait, on the last end event."""
        if not self.cuda:
            return self._host_s
        if not self._pairs:
            return 0.0
        try:
            self._pairs[-1][1].synchronize()
            return sum(s.elapsed_time(e) for s, e in self._pairs) / 1000.0
        except Exception as e:  # noqa: BLE001
            raise ProfileTimingError(f"cannot read a CUDA event: {e}",
                                     cause=e) from e


def timed_launch(fn, *args, **kwargs):
    """`fn(*args, **kwargs)`, one device launch (or launch sequence),
    bracketed by the profiled request's DeviceClock when one runs on this
    thread; one thread-local read otherwise."""
    prof = current()
    clock = None if prof is None else prof.clock
    if clock is None:
        return fn(*args, **kwargs)
    with clock.launch():
        return fn(*args, **kwargs)


# per-segment keys that accumulate across multiple launches of one request
# (e.g. the agg launch + the post-filter hit launch touch the same segment
# twice); everything else is identity info and overwrites
_ADDITIVE = {"blocks_scanned", "postings_scanned", "staged_bytes", "ms",
             "launches", "dense_overflow", "buckets", "plane_bytes"}


class ProfileCollector:
    """One shard-scoped profile of one request (the mesh's launch-scoped
    profile comes with the mesh).

    Single-writer by construction: profiled requests bypass the batcher, so
    every hook fires on the request thread — recording is plain appends with
    no locks. All recorded values are plain Python scalars so the result
    crosses the wire through the binary codec and renders as JSON unchanged.
    """

    MAX_EVENTS = 256  # cache-attribution events kept (drops counted)
    MAX_RESERVATIONS = 128  # breaker reservations kept (drops counted)

    __slots__ = ("node", "index", "shard", "t0", "_phases", "_plan",
                 "_outcome", "_fallback", "_segments", "_seg_order",
                 "_events", "_events_dropped", "_breakers", "_breaker_bytes",
                 "_breakers_dropped", "_batcher", "clock")

    def __init__(self, node: str = "node", index: str = "", shard: int = 0):
        self.node = node
        self.index = index
        self.shard = shard
        self.t0 = time.monotonic()
        self._phases: dict[str, float] = {}  # name -> ms
        self._plan: dict | None = None
        self._outcome: str | None = None
        self._fallback: str | None = None
        self._segments: dict[int, dict] = {}  # gen -> record
        self._seg_order: list[int] = []
        self._events: list[dict] = []
        self._events_dropped = 0
        self._breakers: list[dict] = []
        self._breaker_bytes = 0
        self._breakers_dropped = 0
        self._batcher: dict | None = None
        # the DeviceClock of the launches the query phase times (None until
        # a device branch runs)
        self.clock: DeviceClock | None = None

    # -- phases --------------------------------------------------------------
    def phase_s(self, name: str, seconds: float) -> None:
        """Accumulate wall time into a named phase (seconds in, ms out)."""
        self._phases[name] = self._phases.get(name, 0.0) + seconds * 1000.0

    # -- plan ----------------------------------------------------------------
    def set_plan(self, plan: dict) -> None:
        """First writer wins — the query-phase entry point records the plan
        once; later re-lowerings (device-agg probes etc.) must not clobber."""
        if self._plan is None:
            self._plan = plan

    def outcome(self, path: str) -> None:
        """The resolved execution path (service.SERVING_COUNTERS
        vocabulary); first writer wins."""
        if self._outcome is None:
            self._outcome = path

    def fallback(self, reason: str) -> None:
        """Why the fused device path was declined (module vocabulary)."""
        if self._fallback is None:
            self._fallback = reason

    # -- per-segment counters ------------------------------------------------
    def segment(self, gen: int, **kv) -> None:
        """Merge counters into the per-segment record: _ADDITIVE keys sum
        across launches, identity keys (path, tf_layout, docs) overwrite."""
        d = self._segments.get(gen)
        if d is None:
            d = {"generation": int(gen)}
            self._segments[gen] = d
            self._seg_order.append(gen)
        for k, v in kv.items():
            if k in _ADDITIVE and k in d:
                d[k] = d[k] + v
            else:
                d[k] = v

    # -- cache attribution / breaker accounting ------------------------------
    def event(self, kind: str, **kv) -> None:
        """A cache-attribution event (packed_segment hit/pack, sim_tables
        hit/swap, blk_freqs resident/fault, scratch reuse/alloc,
        device_error, request_cache, filter_cache)."""
        if len(self._events) < self.MAX_EVENTS:
            self._events.append({"kind": kind, **kv})
        else:
            self._events_dropped += 1

    def breaker_reserve(self, breaker: str, label: str, nbytes: int) -> None:
        self._breaker_bytes += int(nbytes)
        if len(self._breakers) < self.MAX_RESERVATIONS:
            self._breakers.append({"breaker": breaker, "label": label,
                                   "bytes": int(nbytes)})
        else:
            self._breakers_dropped += 1

    # -- batcher -------------------------------------------------------------
    def batcher_bypass(self, reason: str) -> None:
        self._batcher = {"bypassed": True, "reason": reason}

    # -- assembly ------------------------------------------------------------
    def to_dict(self) -> dict:
        phases = {k: round(v, 4) for k, v in self._phases.items()}
        phases["total"] = round((time.monotonic() - self.t0) * 1000.0, 4)
        segments = []
        for g in self._seg_order:
            d = dict(self._segments[g])
            for k, v in d.items():
                if isinstance(v, float):
                    d[k] = round(v, 4)
            segments.append(d)
        plan = {"outcome": self._outcome or "unknown",
                "fallback_reason": self._fallback}
        if self._plan:
            plan.update(self._plan)
        out = {
            "id": f"[{self.node}][{self.index}][{self.shard}]",
            "node": self.node,
            "index": self.index,
            "shard": int(self.shard),
            "plan": plan,
            "segments": segments,
            "phases_ms": phases,
            "cache": {"events": list(self._events),
                      "dropped": self._events_dropped},
            "breakers": {"reservations": list(self._breakers),
                         "reserved_bytes_total": self._breaker_bytes,
                         "dropped": self._breakers_dropped},
        }
        if self._batcher is not None:
            out["batcher"] = self._batcher
        return out
