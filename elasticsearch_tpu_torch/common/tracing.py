"""Request-scoped distributed tracing (a copy of the JAX package's
`common/tracing.py`): the node's span substrate.

Every search that is SAMPLED gets a tree of spans over the serving path —
REST ingress → coordinator fan-out → transport → shard query phase →
batcher (queue wait / dispatch / merge) → the batch's ONE device pull —
with the trace context stitched across the transport through the binary
wire codec (common/stream.py writes `TraceContext` as tag 7, so the context
rides the request payloads the transport already round-trips).

Design rules (the port's device and lock discipline applies to tracing):

- **Near-zero overhead when off.** Sampling is decided ONCE at trace start;
  an unsampled request gets the `NOOP_SPAN`/`NOOP_TRACE` singletons whose
  every method is a constant no-op — no allocation, no locking, no clock
  reads beyond one `random()` at ingress.
- **No added device syncs.** Span end-times come from host monotonic clocks
  around operations the serving path performs anyway: the device span ends
  at the batch's one wait (`execute._PendingFlat.merge` stamps `pull_t0` /
  `pull_t1` around `PendingPull.wait`). Tracing never synchronises per span;
  the opt-in `ESTPU_TRACE_SYNC=1` precise mode (bench and debug only) is
  the one exception, and it lives in the batcher's drainer, which waits on
  the batch's own CUDA event there, not in span code.
- **Leaf locks.** Trace and ring locks only guard list appends: span
  recording never blocks, never launches device work and never takes
  another lock while held.

Sampling knobs: the `ESTPU_TRACE` environment variable (=1 arms rate 1.0)
overrides `search.trace.sample_rate` (default 0.0, off). `?trace=true` on
`_search` samples that one request whatever the rate and returns its span
tree inline. Finished traces land in a bounded per-node ring
(`search.trace.ring_size`, default 128) served by `GET /_traces`; live
traces show in `GET /_tasks`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass

# the request-dict key the transport layer injects the wire context under
# (handlers read it with .get(); unknown keys are ignored everywhere else)
TRACE_WIRE_KEY = "_trace"


@dataclass(frozen=True)
class TraceContext:
    """The cross-node wire form of a trace: which trace, which parent span.

    Serialized by common/stream.py as a typed value (tag 7), so it crosses
    the transport's roundtrip through the same codec every other payload
    uses — no side-channel headers."""

    trace_id: str
    span_id: int


# ---------------------------------------------------------------------------
# thread-local activation (how spans flow down a call stack without plumbing)
# ---------------------------------------------------------------------------

_local = threading.local()


def current_span():
    """The thread's active span: a real span, the (falsy) NOOP span when an
    upstream layer already DECLINED sampling for this request, or None when
    no tracing decision has been made on this thread. Cross-thread handoff
    (the batcher drainer) is explicit: items capture this at enqueue time."""
    return getattr(_local, "span", None)


@contextlib.contextmanager
def activate(span):
    """Make `span` the thread's current span for the scope. A NOOP span is
    stored as-is: it still deactivates tracing for the scope (a child of a
    noop must not resurrect the thread-local of an outer sampled request),
    but it also marks the sampling decision as already made — a downstream
    layer that would otherwise root its own trace (the coordinator under
    REST ingress) sees the noop and must NOT roll the sampling dice a
    second time."""
    prev = getattr(_local, "span", None)
    _local.span = span
    try:
        yield span
    finally:
        _local.span = prev


def wire_context(span) -> TraceContext | None:
    """The context to ship with an outbound request parented at `span` —
    the ONE construction site for the wire shape (transport injection and
    Tracer.wire_context both route here)."""
    if not span:
        return None
    return TraceContext(span.trace.trace_id, span.span_id)


def sync_armed() -> bool:
    """ESTPU_TRACE_SYNC=1: precise device timing for bench/debug — the batcher
    drainer waits on the batch's CUDA event until the dispatched launches
    complete, so the dispatch span measures true device time. NEVER the
    default: it serializes the double-buffered dispatch/merge overlap."""
    return os.environ.get("ESTPU_TRACE_SYNC", "") == "1"


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def _new_id() -> int:
    return random.getrandbits(63)


class Span:
    """One timed operation in a trace. Mutation is single-writer (the owning
    thread); the append into the trace happens under the trace's leaf lock."""

    __slots__ = ("trace", "name", "span_id", "parent_id", "t0", "t1", "tags")

    def __init__(self, trace: "Trace", name: str, parent_id: int | None,
                 t0: float | None = None):
        self.trace = trace
        self.name = name
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.t0 = time.monotonic() if t0 is None else t0
        self.t1: float | None = None
        self.tags: dict = {}
        trace._opened(self)

    def __bool__(self) -> bool:
        return True

    def tag(self, **kv) -> "Span":
        self.tags.update(kv)
        return self

    def child(self, name: str) -> "Span":
        return Span(self.trace, name, self.span_id)

    def record(self, name: str, t0: float, t1: float, **tags) -> "Span":
        """One-shot child with explicit host-monotonic endpoints — how the
        batcher attributes a shared batch's phase timings back to every
        coalesced member request without per-member clock reads. Born
        finished: it skips the open-registry round-trip (it could never show
        in /_tasks) so the drainer pays ONE lock acquisition per member
        phase, not two."""
        sp = object.__new__(Span)
        sp.trace = self.trace
        sp.name = name
        sp.span_id = _new_id()
        sp.parent_id = self.span_id
        sp.t0 = t0
        sp.t1 = t1
        sp.tags = dict(tags)
        self.trace._record_finished(sp)
        return sp

    def end(self, t1: float | None = None) -> None:
        if self.t1 is not None:
            return  # idempotent — races between timer and response paths
        self.t1 = time.monotonic() if t1 is None else t1
        self.trace._closed(self)

    def to_dict(self) -> dict:
        t1 = self.t1 if self.t1 is not None else time.monotonic()
        return {
            "id": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "node": self.trace.node_name,
            "t0": self.t0,
            "t1": t1,
            "duration_ms": round((t1 - self.t0) * 1000.0, 4),
            "tags": dict(self.tags),
        }

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class _NoopSpan:
    """Falsy span that swallows everything — the unsampled fast path."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def tag(self, **kv) -> "_NoopSpan":
        return self

    def child(self, name: str) -> "_NoopSpan":
        return self

    def record(self, name: str, t0: float, t1: float, **tags) -> "_NoopSpan":
        return self

    def end(self, t1: float | None = None) -> None:
        pass

    def to_dict(self) -> dict:
        return {}

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP_SPAN = _NoopSpan()


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------


class Trace:
    """All spans of one sampled request on one node. The root span ending
    finishes the trace: it is snapshotted into the tracer's ring buffer and
    dropped from the in-flight registry."""

    __slots__ = ("tracer", "trace_id", "node_name", "started_at", "root",
                 "_lock", "_spans", "_open", "_finished", "_in_ring", "_seq")

    def __init__(self, tracer: "Tracer", name: str,
                 trace_id: str | None = None, parent_id: int | None = None):
        self.tracer = tracer
        # not uuid4: ~30us/call vs ~1us for getrandbits, and a trace id only
        # needs uniqueness, not RFC-4122 shape — this runs once per sampled
        # request at ingress
        self.trace_id = trace_id or f"{random.getrandbits(64):016x}"
        self.node_name = tracer.node_name
        self.started_at = time.time()
        self._lock = threading.Lock()  # leaf lock: list appends only
        self._spans: list[dict] = []  # finished spans (+ stitched remote ones)
        self._open: dict[int, Span] = {}
        self._finished = False  # root closed (guarded by _lock)
        self._in_ring = False  # snapshot committed (guarded by tracer ring lock)
        self._seq = next(tracer._trace_seq)  # ring identity (trace_id repeats
        # within one tracer when two local shards continue the same trace)
        self.root = Span(self, name, parent_id)

    def __bool__(self) -> bool:
        return True

    def span(self, name: str, parent: Span | None = None) -> Span:
        p = parent if parent is not None else self.root
        return Span(self, name, p.span_id)

    # -- span bookkeeping (called by Span; record-only, never blocks) --------
    def _opened(self, span: Span) -> None:
        with self._lock:
            self._open[span.span_id] = span

    def _closed(self, span: Span) -> None:
        with self._lock:
            self._open.pop(span.span_id, None)
            self._spans.append(span.to_dict())
            late = self._finished and span is not self.root
        if span is self.root:
            self.tracer._finish(self)
        elif late:
            # a span ending AFTER the root closed (a timed-out shard
            # attempt's transport span, ended when the late response or
            # transport error finally resolves its future) would otherwise
            # miss the ring snapshot — same refresh as a late add_remote
            self.tracer._restitch(self)

    def _record_finished(self, span: Span) -> None:
        """Append a span born finished (Span.record) — one lock acquisition,
        no open-registry traffic. Same late-refresh rule as _closed."""
        with self._lock:
            self._spans.append(span.to_dict())
            late = self._finished
        if late:
            self.tracer._restitch(self)

    def add_remote(self, span_dicts) -> None:
        """Stitch spans a remote node returned inline (the shard query
        response carries its span list back to the coordinator). A late
        stitch — the coordinator backstop abandoned the chain, the root
        already closed, and the shard's response only arrived afterwards —
        refreshes the ring snapshot so the spans still reach /_traces."""
        if not span_dicts:
            return
        clean = [dict(s) for s in span_dicts if isinstance(s, dict)]
        with self._lock:
            self._spans.extend(clean)
            late = self._finished
        if late:
            self.tracer._restitch(self)

    def span_dicts(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def current_name(self) -> str:
        """Name of the most recently opened still-open span (for /_tasks)."""
        with self._lock:
            if not self._open:
                return self.root.name
            return max(self._open.values(), key=lambda s: s.t0).name

    def to_dict(self) -> dict:
        spans = self.span_dicts()
        root = self.root.to_dict()
        return {
            "trace_id": self.trace_id,
            "node": self.node_name,
            "name": self.root.name,
            "start_ts_ms": int(self.started_at * 1000),
            "duration_ms": root["duration_ms"],
            "spans": spans,
        }


class _NoopTrace:
    __slots__ = ()

    root = NOOP_SPAN
    trace_id = None

    def __bool__(self) -> bool:
        return False

    def span(self, name: str, parent=None) -> _NoopSpan:
        return NOOP_SPAN

    def add_remote(self, span_dicts) -> None:
        pass

    def span_dicts(self) -> list:
        return []

    def to_dict(self) -> dict:
        return {}


NOOP_TRACE = _NoopTrace()


def span_tree(spans: list[dict]) -> dict | None:
    """Nest a flat span list into the root's tree (children sorted by start).
    Spans whose parent is absent (cross-node stitches of a dropped hop) attach
    to the root so nothing silently vanishes from the inline view."""
    if not spans:
        return None
    by_id = {s["id"]: {**s, "children": []} for s in spans}
    root = None
    orphans = []
    for node in by_id.values():
        parent = by_id.get(node["parent"]) if node["parent"] is not None else None
        if parent is not None:
            parent["children"].append(node)
        elif root is None and node["parent"] is None:
            root = node
        else:
            orphans.append(node)
    if root is None:  # no local root (shouldn't happen) — oldest span wins
        root = min(by_id.values(), key=lambda s: s["t0"])
        orphans = [n for n in orphans if n is not root]
    root["children"].extend(orphans)
    for node in by_id.values():
        node["children"].sort(key=lambda s: s["t0"])
    return root


def phase_breakdown(trace) -> dict:
    """queue/device/merge milliseconds extracted from a trace's batcher spans —
    the slowlog's joinable per-phase line. `device` is the batch's single
    device pull; `merge` is the host-side fan-out time around it."""
    queue = device = merge = 0.0
    for s in (trace.span_dicts() if trace else []):
        name = s.get("name")
        if name == "batcher.queue":
            queue += s["duration_ms"]
        elif name == "device_pull":
            device += s["duration_ms"]
        elif name == "batcher.merge":
            merge += s["duration_ms"]
    return {"queue_ms": round(queue, 3), "device_ms": round(device, 3),
            "merge_ms": round(max(merge - device, 0.0), 3)}


# ---------------------------------------------------------------------------
# tracer (per node)
# ---------------------------------------------------------------------------


class Tracer:
    """Per-node sampling decision + ring buffer + in-flight registry."""

    def __init__(self, settings=None, node_name: str = "node"):
        from .settings import Settings

        settings = settings or Settings.EMPTY
        env = os.environ.get("ESTPU_TRACE", "").strip()
        if env:
            if env.lower() in ("1", "true", "on"):
                rate = 1.0
            else:
                try:
                    rate = float(env)
                except ValueError:
                    rate = 0.0
        else:
            rate = settings.get_float("search.trace.sample_rate", 0.0) or 0.0
        self.sample_rate = min(max(rate, 0.0), 1.0)
        self.node_name = node_name
        ring = max(1, settings.get_int("search.trace.ring_size", 128))
        # entries are (trace seq, snapshot) pairs — the seq lets a late
        # remote stitch find and refresh ITS entry (trace_id alone is not
        # unique within a ring: two local shards continuing one trace)
        self._ring: deque[tuple[int, dict]] = deque(maxlen=ring)
        self._ring_lock = threading.Lock()
        self._trace_seq = itertools.count(1)
        self._inflight: dict[int, Trace] = {}
        self._inflight_lock = threading.Lock()
        self._sampled_total = 0
        self._finished_total = 0
        # ring-pressure counters (guarded by _ring_lock): a bounded ring that
        # silently forgets traces is an observability hole — surface how many
        # finished traces were evicted, and how many late remote stitches
        # arrived after their entry was already gone
        self._ring_evicted = 0
        self._stitch_dropped = 0

    # -- starting / continuing ----------------------------------------------
    def _sampled(self) -> bool:
        r = self.sample_rate
        return r > 0.0 and (r >= 1.0 or random.random() < r)

    def start_trace(self, name: str, force: bool = False):
        """Root a new trace here (REST ingress / coordinator). `force=True` is
        the `?trace=true` override — sampled regardless of the rate."""
        if not force and not self._sampled():
            return NOOP_TRACE
        return self._register(Trace(self, name))

    def continue_trace(self, wire, name: str):
        """Continue a trace whose context arrived over the wire (shard side).
        The sender only injects context for sampled traces, so arrival of a
        context IS the sampling decision."""
        if wire is None:
            return NOOP_TRACE
        if isinstance(wire, TraceContext):
            tid, sid = wire.trace_id, wire.span_id
        elif isinstance(wire, dict) and wire.get("tid"):
            tid, sid = str(wire["tid"]), int(wire.get("sid") or 0) or None
        else:
            return NOOP_TRACE
        return self._register(Trace(self, name, trace_id=tid, parent_id=sid))

    def wire_context(self, span) -> TraceContext | None:
        """The context to ship with an outbound request parented at `span`."""
        return wire_context(span)

    def _register(self, trace: Trace) -> Trace:
        with self._inflight_lock:
            self._inflight[id(trace)] = trace
            self._sampled_total += 1
        return trace

    def _finish(self, trace: Trace) -> None:
        """Root span ended: snapshot OUTSIDE the locks, then record."""
        with self._inflight_lock:
            self._inflight.pop(id(trace), None)
        with trace._lock:
            trace._finished = True  # set BEFORE snapshotting: a remote
            # stitch that lands after this flag re-snapshots via _restitch
        snap = trace.to_dict()
        with self._ring_lock:
            if len(self._ring) == self._ring.maxlen:
                self._ring_evicted += 1  # the append below pushes one out
            self._ring.append((trace._seq, snap))
            trace._in_ring = True
            self._finished_total += 1
        # backstop for the snapshot→commit window: a stitch in between saw
        # _finished=True but found no ring entry to refresh yet
        if len(trace.span_dicts()) != len(snap["spans"]):
            self._restitch(trace)

    def _restitch(self, trace: Trace) -> None:
        """Replace a finished trace's ring snapshot with a fuller one (spans
        stitched after the root closed). Replace-only: an entry the bounded
        ring already evicted stays evicted; span lists only grow, so the
        longer snapshot wins regardless of commit order."""
        snap = trace.to_dict()
        with self._ring_lock:
            if not trace._in_ring:
                return  # _finish has not committed yet; its backstop re-runs
            for i in range(len(self._ring) - 1, -1, -1):
                seq, old = self._ring[i]
                if seq == trace._seq:
                    if len(old["spans"]) < len(snap["spans"]):
                        self._ring[i] = (seq, snap)
                    return
            # the bounded ring already evicted this trace: the late stitch's
            # spans are dropped by design (replace-only) — count the drop so
            # /_traces pressure is visible instead of silent
            self._stitch_dropped += 1

    # -- observability surfaces ---------------------------------------------
    def traces(self, limit: int | None = None) -> list[dict]:
        """Finished traces, newest first; `limit` caps the count (0 = none)."""
        with self._ring_lock:
            out = [snap for _seq, snap in self._ring]
        out.reverse()
        return out if limit is None else out[:max(0, limit)]

    def tasks(self) -> list[dict]:
        """Live in-flight traces: current span, elapsed, cancellable=false
        (cancellation is a later PR — the field pins the API shape now)."""
        with self._inflight_lock:
            live = list(self._inflight.values())
        now = time.monotonic()
        return [{
            "trace_id": t.trace_id,
            "name": t.root.name,
            "node": t.node_name,
            "current_span": t.current_name(),
            "running_time_ms": round((now - t.root.t0) * 1000.0, 3),
            "start_ts_ms": int(t.started_at * 1000),
            "cancellable": False,
        } for t in live]

    def stats(self) -> dict:
        with self._ring_lock:
            ring_len = len(self._ring)
            finished = self._finished_total
            ring_evicted = self._ring_evicted
            stitch_dropped = self._stitch_dropped
        with self._inflight_lock:
            sampled = self._sampled_total
            in_flight = len(self._inflight)
        return {
            "sample_rate": self.sample_rate,
            "sampled": sampled,
            "finished": finished,
            "in_flight": in_flight,
            "ring": ring_len,
            "ring_size": self._ring.maxlen,
            "ring_evicted": ring_evicted,
            "late_stitch_dropped": stitch_dropped,
        }
