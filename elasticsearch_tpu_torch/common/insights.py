"""Always-on query-shape insights (a copy of the JAX package's
`common/insights.py`): every search is classified into a bounded registry
of plan shapes, with per-shape count, latency, queue and device-phase
histograms, the device-versus-fallback outcome mix and request-cache hit
rates — continuously, with no per-request opt-in.

A *shape* is the request body's normalized clause STRUCTURE, never its
literals: `{"match": {"body": "alpha7"}}` and `{"match": {"body": "zebra"}}`
are one shape; a `term` against a `match`, a 2-clause against a 4-clause
bool (power-of-two bucketed), `size: 0` against a page of hits are distinct
shapes. The canonicalisation reuses the request cache's fingerprint recipe
(sorted keys, compact JSON, execution knobs stripped —
search/request_cache.py) with literal values replaced by placeholders.

Hot-path contract:

- **Record-only hooks behind one thread-local read.** The serving path
  carries an `Observation` in a thread-local like tracing's span and the
  profiler's collector; the batcher captures it at enqueue.
- **No added clocks.** Latency reuses the query phase's own clock pair in
  `actions._s_query_phase`; queue time reuses the batcher's enqueue and
  collect clocks; device time is the batch's one pull window
  (`_PendingFlat.pull_t0/t1`).
- **No added device waits.** Everything here is host arithmetic.
- **Leaf locks only.** The registry lock guards dict and counter mutation;
  histograms have their own striped leaf locks, observed outside it.

Cardinality is bounded: the registry holds at most
`search.insights.max_shapes` (default 128) shapes, LRU-demoted past the cap
(demoted shapes fold their count and cost into one `other` bucket), which
also bounds the `estpu_query_shape_*` Prometheus label sets. Surfaces:
`GET /_insights/queries`, `/_nodes/stats` `search.shapes`, and the
Prometheus families (rest/controller.py).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import threading
from collections import OrderedDict

from .metrics import HistogramMetric

# execution knobs that select HOW a request runs, not WHAT it computes —
# superset of the request cache's volatile set (trace is REST-level)
_VOLATILE_KEYS = ("profile", "request_cache", "timeout", "trace")

# dict keys whose scalar VALUES are structural (they change the plan shape),
# not literals: everything else scalar collapses to the "?" placeholder
_STRUCTURAL_VALUE_KEYS = frozenset({
    "order", "mode", "operator", "default_operator", "type", "score_mode",
    "boost_mode", "execution", "minimum_should_match", "analyzer", "field",
    "fields", "sort_mode", "lang",
})

# outcome vocabulary: search/service.SERVING_COUNTERS paths + the two
# insights-only outcomes. Bounded by construction (unknown strings are
# folded to "unknown" so a drifting caller can't grow the dict).
OUTCOMES = (
    "device_sparse", "device_filtered", "device_function_score",
    "device_aggs", "device_sort", "host", "mesh_spmd", "cache_hit",
    "error", "unknown",
)
_OUTCOME_SET = frozenset(OUTCOMES)


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def _normalize(value, key: str | None = None):
    """Structure-preserving, literal-erasing normalization of one body node.
    Lists of identically-shaped elements collapse to [shape, "xN"] with N
    power-of-two bucketed — a 5-term and a 7-term should-list share a shape,
    a 2-term and a 40-term one do not."""
    if isinstance(value, dict):
        return {k: _normalize(v, k) for k, v in sorted(value.items())
                if k not in _VOLATILE_KEYS}
    if isinstance(value, (list, tuple)):
        # elements inherit the parent key so LIST-valued structural keys
        # survive: multi_match over {"fields": ["title", "body"]} and over
        # {"fields": ["tag"]} are different plans, not one erased shape
        norm = [_normalize(v, key) for v in value]
        if len(norm) > 1 and all(n == norm[0] for n in norm):
            return [norm[0], f"x{_pow2(len(norm))}"]
        return norm
    if key in _STRUCTURAL_VALUE_KEYS:
        return value if isinstance(value, (str, int, bool)) else "?"
    return "?"


def normalize_shape(body: dict | None) -> dict:
    """The normalized plan shape of one search body: clause structure with
    literals erased, `size`/`from` reduced to the 0-vs-paged distinction the
    request-cache policy draws (a count/dashboard query and a hit-bearing
    page are different workloads even with identical clauses)."""
    body = body or {}
    shape = _normalize({k: v for k, v in body.items()
                        if k not in ("size", "from")})
    try:
        shape["size"] = 0 if int(body.get("size", 10) or 0) == 0 else "n"
    except (TypeError, ValueError):
        shape["size"] = "n"
    if body.get("from"):
        shape["from"] = "n"
    return shape


def shape_fingerprint(body: dict | None) -> tuple[str, dict]:
    """(shape id, normalized shape). The id is a 16-hex-char blake2b over the
    canonical JSON re-serialization of the normalized shape — same recipe as
    request_cache.request_fingerprint, over the shape instead of the body."""
    shape = normalize_shape(body)
    blob = json.dumps(shape, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.blake2b(blob.encode("utf-8"),
                           digest_size=8).hexdigest(), shape


# ---------------------------------------------------------------------------
# per-request observation (thread-local, like tracing spans / profile
# collectors): the batcher and the serving-path outcome counter write into
# it; the query phase folds it into the registry when the request finishes
# ---------------------------------------------------------------------------

_local = threading.local()


class Observation:
    """One request's in-flight insight scratch. Single-writer per field by
    construction: `outcome` is written on the request thread
    (service._count), `queue_s`/`device_s`/`occupancy` on the batcher
    drainer BEFORE the item's future resolves (the Future provides the
    happens-before edge to the reader). Plain attribute writes — no locks."""

    __slots__ = ("outcome", "queue_s", "device_s", "occupancy")

    def __init__(self):
        self.outcome: str | None = None
        self.queue_s: float | None = None
        self.device_s: float | None = None
        self.occupancy: int | None = None


def current() -> Observation | None:
    """The thread's active observation, or None (one thread-local read —
    the whole cost of a hook on an insights-disabled node)."""
    return getattr(_local, "obs", None)


@contextlib.contextmanager
def activate(obs: Observation):
    """Make `obs` the thread's observation for the scope. Call sites only
    enter this when insights are enabled — the disabled path never pays the
    context manager."""
    prev = getattr(_local, "obs", None)
    _local.obs = obs
    try:
        yield obs
    finally:
        _local.obs = prev


# ---------------------------------------------------------------------------
# the bounded shape registry
# ---------------------------------------------------------------------------


class ShapeStats:
    """Accumulated telemetry of one resident shape. Counters mutate under the
    registry's leaf lock; the histograms carry their own striped leaf locks
    and are observed outside it."""

    __slots__ = ("shape", "count", "cost_ms", "cache_hits", "cache_misses",
                 "outcomes", "latency", "queue", "device", "coalesced")

    def __init__(self, shape: dict):
        self.shape = shape
        self.count = 0
        # accumulated cost, maintained UNDER the registry lock next to count
        # (histogram sums are observed outside it, so an LRU demotion racing
        # a recorder could lose their contribution — this total cannot)
        self.cost_ms = 0.0
        self.cache_hits = 0
        self.cache_misses = 0
        self.outcomes: dict[str, int] = {}
        self.latency = HistogramMetric()
        self.queue = HistogramMetric()
        self.device = HistogramMetric()
        self.coalesced = 0  # requests that rode a shared batcher launch

    def to_dict(self, shape_id: str) -> dict:
        lookups = self.cache_hits + self.cache_misses
        return {
            "shape_id": shape_id,
            "shape": self.shape,
            "count": self.count,
            "cost_ms": round(self.cost_ms, 3),
            "outcomes": dict(self.outcomes),
            "cache": {
                "hits": self.cache_hits,
                "misses": self.cache_misses,
                "hit_rate": round(self.cache_hits / lookups, 4) if lookups
                else 0.0,
            },
            "coalesced": self.coalesced,
            "latency": self.latency.stats(),
            "queue": self.queue.stats(),
            "device": self.device.stats(),
        }


class QueryShapeInsights:
    """Node-level bounded LRU registry of query shapes.

    `record()` is the one write entry point, called once per shard query
    phase from actions._s_query_phase with clocks that path already read.
    Reads (`top`, `stats`, `prom_series`) snapshot under the leaf lock and
    summarize outside it."""

    def __init__(self, settings=None):
        from .settings import Settings

        settings = settings or Settings.EMPTY
        self.enabled = bool(settings.get_bool("search.insights.enabled", True))
        self.max_shapes = max(1, settings.get_int(
            "search.insights.max_shapes", 128))
        self._lock = threading.Lock()
        self._shapes: "OrderedDict[str, ShapeStats]" = OrderedDict()
        self.demotions = 0
        # demoted shapes fold here so node totals stay honest after LRU churn
        self._other_count = 0
        self._other_cost_ms = 0.0

    def fingerprint(self, body: dict | None) -> tuple[str, dict]:
        return shape_fingerprint(body)

    # -- write ---------------------------------------------------------------
    def record(self, shape_id: str, shape: dict, took_s: float | None = None,
               obs: Observation | None = None,
               cache: str | None = None) -> None:
        """Fold one finished shard query phase into its shape's stats.

        `took_s` is the slowlog's existing clock pair (None on the
        request-cache hit path, which reads no clock at all — a hit records
        count + cache attribution only). `cache` is "hit"/"miss"/None
        (ineligible). Histogram observes happen OUTSIDE the registry lock."""
        with self._lock:
            st = self._shapes.get(shape_id)
            if st is None:
                st = ShapeStats(shape)
                self._shapes[shape_id] = st
                while len(self._shapes) > self.max_shapes:
                    _sid, old = self._shapes.popitem(last=False)
                    self.demotions += 1
                    self._other_count += old.count
                    self._other_cost_ms += old.cost_ms
            else:
                self._shapes.move_to_end(shape_id)
            st.count += 1
            if took_s is not None:
                st.cost_ms += took_s * 1000.0
            if cache == "hit":
                st.cache_hits += 1
            elif cache == "miss":
                st.cache_misses += 1
            outcome = "cache_hit" if cache == "hit" else \
                (obs.outcome if obs is not None else None) or "unknown"
            if outcome not in _OUTCOME_SET:
                outcome = "unknown"
            st.outcomes[outcome] = st.outcomes.get(outcome, 0) + 1
            if obs is not None and obs.occupancy is not None \
                    and obs.occupancy > 1:
                st.coalesced += 1
        if took_s is not None:
            st.latency.observe(took_s)
        if obs is not None:
            if obs.queue_s is not None:
                st.queue.observe(obs.queue_s)
            if obs.device_s is not None:
                st.device.observe(obs.device_s)

    # -- read ----------------------------------------------------------------
    def _snapshot(self) -> list[tuple[str, ShapeStats]]:
        with self._lock:
            return list(self._shapes.items())

    def top(self, n: int = 10) -> list[dict]:
        """Top-N shapes by accumulated cost (total latency): the operator's
        'which queries are eating the cluster' read."""
        entries = [(sid, st, st.cost_ms) for sid, st in self._snapshot()]
        entries.sort(key=lambda e: -e[2])
        return [st.to_dict(sid) for sid, st, _cost in entries[: max(n, 0)]]

    def stats(self) -> dict:
        """The `/_nodes/stats` `search.shapes` section: registry occupancy +
        a compact top-5 (full entries via GET /_insights/queries)."""
        snap = self._snapshot()
        top = sorted(((sid, st) for sid, st in snap),
                     key=lambda e: -e[1].cost_ms)[:5]
        with self._lock:
            other = {"count": self._other_count,
                     "cost_ms": round(self._other_cost_ms, 3)}
            demotions = self.demotions
        return {
            "enabled": self.enabled,
            "shapes": len(snap),
            "max_shapes": self.max_shapes,
            "demotions": demotions,
            "other": other,
            "top": [{"shape_id": sid, "count": st.count,
                     "cost_ms": round(st.cost_ms, 3)}
                    for sid, st in top],
        }

    def prom_series(self) -> list[tuple[str, ShapeStats]]:
        """Resident shapes for the Prometheus exposition — at most
        `max_shapes` label values by construction (the LRU demotion IS the
        cardinality bound)."""
        return self._snapshot()

    def clear(self) -> None:
        with self._lock:
            self._shapes.clear()
            self.demotions = 0
            self._other_count = 0
            self._other_cost_ms = 0.0
