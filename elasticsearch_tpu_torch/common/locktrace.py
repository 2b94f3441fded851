"""Runtime lock-trace sanitizer (a copy of the JAX package's
`common/locktrace.py`): the runtime check of the rule "no device wait while
holding a lock".

Under `ESTPU_LOCKTRACE=1`:

- `threading.Lock` / `threading.RLock` construction is wrapped so every lock
  created in the port (a creation site under `elasticsearch_tpu_torch/`, in
  `tests/test_torch_*.py` or in `chip_smoke.py`; torch's, the standard
  library's and everyone else's stay untraced) records per-thread
  acquisition order. Locks are aggregated by construction site, lockdep's
  "lock class": every instance created at one line is one node, so a
  child->parent acquisition inside one hierarchy is a self-edge and ignored.
  `threading.Condition()` is covered through its RLock.
- the lock-order graph accumulates over the whole run; `TRACER.check()`
  raises LockOrderViolation naming the acquisition sites of every edge of
  the first cycle found: the ABBA hazard is reported from any interleaving,
  no deadlock needed.
- the port's waits on the card, `cudaenv.PendingPull.wait`,
  `PendingPull.synchronize` and `torch.cuda.synchronize`, are timed when
  made WHILE HOLDING a traced lock. They count under the JAX package's
  counter names (`held_device_gets`, `held_device_get_max_ms`; sites longer
  than `ESTPU_LOCKTRACE_HELD_MS` land in `long_held`), which the watchdog's
  `lock_stall` check reads (common/events.py).

Nothing is patched while the knob is off: `maybe_install()` returns without
touching `threading`. Installing patches `threading.Lock` process-wide, so
`install()` refuses (RuntimeError) when another tracer has already replaced
the standard factories (the JAX package's, armed by its test suite in the
same process): only a process of its own arms this one."""

from __future__ import annotations

import _thread
import functools
import os
import sys
import threading
import time

_SELF_FILE = os.path.abspath(__file__)
_PORT_DIR = f"{os.sep}elasticsearch_tpu_torch{os.sep}"
_TESTS_DIR = f"{os.sep}tests{os.sep}"


def _standard_factories() -> bool:
    """True while `threading.Lock` and `threading.RLock` are the standard
    library's own (no tracer, of this package or another, replaced them)."""
    return (threading.Lock is _thread.allocate_lock
            and getattr(threading.RLock, "__module__", None) == "threading")


# the standard factories, saved before any patching; the tracer's own lock
# must never trace itself
_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = threading.RLock if _standard_factories() else None


class LockOrderViolation(AssertionError):
    """The runtime lock-order graph contains a cycle: an ABBA deadlock is one
    unlucky interleaving away. The message names both acquisition sites."""


_REL_CACHE: dict = {}


def _rel(fn: str) -> str:
    r = _REL_CACHE.get(fn)
    if r is None:
        r = _REL_CACHE[fn] = os.path.relpath(fn)
    return r


def _is_port_file(fn: str) -> bool:
    base = os.path.basename(fn)
    return (_PORT_DIR in fn or base == "chip_smoke.py"
            or (_TESTS_DIR in fn and base.startswith("test_torch_")))


def _creation_site() -> str | None:
    """file:line of the first frame outside this module and threading.py;
    None (do not trace) when the lock is created outside the port."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn != _SELF_FILE and f"{os.sep}threading.py" not in fn:
            if _is_port_file(fn):
                return f"{_rel(fn)}:{f.f_lineno}"
            return None
        f = f.f_back
    return None


def _acquire_site() -> tuple:
    """The raw (filename, lineno): formatting (relpath reads the working
    directory) waits for an edge's first witness, so an acquisition costs
    the frame walk alone."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn != _SELF_FILE and f"{os.sep}threading.py" not in fn:
            return (fn, f.f_lineno)
        f = f.f_back
    return ("<unknown>", 0)


def _fmt_site(raw) -> str:
    fn, line = raw
    return f"{_rel(fn)}:{line}" if line else fn


class LockTracer:
    """Process-wide recorder: per-thread held stacks and the order graph."""

    def __init__(self):
        self._glock = _REAL_LOCK()
        self._tls = threading.local()
        self.enabled = False
        self.held_ms_threshold = 0.0
        # (site_a, site_b) -> (acquire_site_a, acquire_site_b): first witness
        self.edges: dict = {}
        self.counters = {
            "locks_created": 0,
            "acquisitions": 0,
            "edges": 0,
            "held_device_gets": 0,
            "held_device_get_max_ms": 0.0,
        }
        self.long_held: list = []  # (lock_site, ms, what) above the threshold

    # -- per-thread stack -----------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # -- recording ------------------------------------------------------------
    def on_created(self) -> None:
        with self._glock:
            self.counters["locks_created"] += 1

    def on_acquired(self, lock_site: str, acq_raw: tuple) -> None:
        st = self._stack()
        with self._glock:
            self.counters["acquisitions"] += 1
            if st:
                outer_site, outer_raw = st[-1]
                if outer_site != lock_site:  # self-edge: layered instances/RLock
                    key = (outer_site, lock_site)
                    if key not in self.edges:
                        # first witness of this edge: only now pay relpath
                        self.edges[key] = (_fmt_site(outer_raw),
                                           _fmt_site(acq_raw))
                        self.counters["edges"] += 1
        st.append((lock_site, acq_raw))

    def on_released(self, lock_site: str) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):  # out-of-order release tolerated
            if st[i][0] == lock_site:
                del st[i]
                return

    def note_held_dispatch(self, duration_s: float, what: str) -> None:
        st = self._stack()
        if not st:
            return
        ms = duration_s * 1000.0
        with self._glock:
            self.counters["held_device_gets"] += 1
            self.counters["held_device_get_max_ms"] = max(
                self.counters["held_device_get_max_ms"], round(ms, 3))
            if self.held_ms_threshold and ms > self.held_ms_threshold:
                self.long_held.append((st[-1][0], round(ms, 3), what))

    # -- the gate -------------------------------------------------------------
    def find_cycle(self) -> list | None:
        """A list of (a, b, acq_a, acq_b) edges forming a cycle, or None."""
        with self._glock:
            graph: dict = {}
            for (a, b) in self.edges:
                graph.setdefault(a, set()).add(b)
            edges = dict(self.edges)
        state: dict = {}  # 0 visiting, 1 done
        path: list = []

        def dfs(v):
            state[v] = 0
            path.append(v)
            for w in sorted(graph.get(v, ())):
                if state.get(w) == 0:
                    cyc = path[path.index(w):] + [w]
                    return [(a, b, *edges[(a, b)])
                            for a, b in zip(cyc, cyc[1:])]
                if w not in state:
                    found = dfs(w)
                    if found:
                        return found
            path.pop()
            state[v] = 1
            return None

        for v in sorted(graph):
            if v not in state:
                found = dfs(v)
                if found:
                    return found
        return None

    def check(self) -> None:
        cyc = self.find_cycle()
        if cyc:
            lines = [f"  `{a}` then `{b}`  (acquired at {acq_a} -> {acq_b})"
                     for (a, b, acq_a, acq_b) in cyc]
            raise LockOrderViolation(
                "lock-order cycle observed at runtime — an ABBA deadlock is "
                "one interleaving away:\n" + "\n".join(lines) +
                "\npick one global acquisition order")

    def snapshot(self) -> dict:
        with self._glock:
            return {**self.counters, "long_held": list(self.long_held)}


TRACER = LockTracer()


class _TracedLock:
    """Delegating wrapper for the Lock/RLock objects the port creates."""

    __slots__ = ("_inner", "_site")

    def __init__(self, inner, site: str):
        self._inner = inner
        self._site = site

    def acquire(self, blocking=True, timeout=-1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            TRACER.on_acquired(self._site, _acquire_site())
        return ok

    def release(self):
        TRACER.on_released(self._site)
        self._inner.release()

    def __enter__(self):
        self._inner.acquire()
        TRACER.on_acquired(self._site, _acquire_site())
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()

    def __getattr__(self, name):
        # the RLock internals a Condition needs (_is_owned/_acquire_restore/
        # _release_save) go straight to the real lock: a wait's release and
        # reacquire inside one condition is not an ordering event
        return getattr(self._inner, name)


def _traced_lock_factory():
    site = _creation_site()
    if site is None:
        return _REAL_LOCK()
    TRACER.on_created()
    return _TracedLock(_REAL_LOCK(), site)


def _traced_rlock_factory(*args, **kwargs):
    site = _creation_site()
    if site is None:
        return _REAL_RLOCK(*args, **kwargs)
    TRACER.on_created()
    return _TracedLock(_REAL_RLOCK(*args, **kwargs), site)


def _timed(real, what: str):
    """`real` timed into `note_held_dispatch` (which counts it only while a
    traced lock is held)."""
    @functools.wraps(real)
    def wait(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            TRACER.note_held_dispatch(time.perf_counter() - t0, what)

    wait._estpu_locktrace = True
    return wait


def _wrap_waits() -> None:
    """Time the port's waits on the card: a batch's pull (`PendingPull.wait`
    and `.synchronize`) and a whole-device `torch.cuda.synchronize`."""
    import torch

    from . import cudaenv

    for name in ("wait", "synchronize"):
        real = getattr(cudaenv.PendingPull, name)
        if not getattr(real, "_estpu_locktrace", False):
            setattr(cudaenv.PendingPull, name,
                    _timed(real, f"PendingPull.{name}"))
    if not getattr(torch.cuda.synchronize, "_estpu_locktrace", False):
        torch.cuda.synchronize = _timed(torch.cuda.synchronize,
                                        "torch.cuda.synchronize")


def install(held_ms_threshold: float | None = None) -> LockTracer:
    """Arm the tracer (idempotent). Prefer maybe_install(), the env knob.
    Raises RuntimeError when another tracer already replaced the standard
    lock factories."""
    if not TRACER.enabled:
        if not _standard_factories() or _REAL_RLOCK is None:
            raise RuntimeError(
                "threading.Lock is no longer the standard factory (another "
                "lock tracer is installed in this process); arm the port's "
                "tracer in a process of its own")
        TRACER.enabled = True
        threading.Lock = _traced_lock_factory
        threading.RLock = _traced_rlock_factory
    if held_ms_threshold is not None:
        TRACER.held_ms_threshold = float(held_ms_threshold)
    _wrap_waits()
    return TRACER


def maybe_install() -> LockTracer | None:
    """Install iff ESTPU_LOCKTRACE=1. Threshold for the long-held report:
    ESTPU_LOCKTRACE_HELD_MS (float ms; unset or 0 records only)."""
    if os.environ.get("ESTPU_LOCKTRACE", "") not in ("1", "on", "true"):
        return None
    return install(float(os.environ.get("ESTPU_LOCKTRACE_HELD_MS", "0") or 0))
