"""Device fault domains: classify-and-contain failures of the card — the
port of the JAX package's `common/devicehealth.py`, with a CUDA error
taxonomy in place of its XLA status strings.

The device is a failure domain like a shard copy. Four domains cover the
serving stack's device touchpoints:

- ``pack:<index>``    — segment packing (ops/device_index pack/compact/remask)
- ``compile:<family>``— a family's launch (sparse/dense/filtered/
  function_score/sorted/aggs/percolate; a percolation's whole batch, its
  one-document pack and pull included, is ``compile:percolate``)
- ``mesh:<index>``    — the mesh executor for one index (a later slice)
- ``pull:<index>``    — the batch's one device→host wait

Each domain carries a circuit: closed → open (after classified failures) →
half-open (one probe admitted per decorrelated-jitter backoff window, schedule
from common/retry.RetryPolicy.next_backoff) → closed again on a clean probe.
An OPEN domain never 500s a search: the serving path degrades to the host
scorer and marks the shard result ``degraded`` so `_shards` stays honest.

Classification (`classify_device_error`), by type and `cudaError_t`:

=========================  ==============================  ===========
error                      codes                           class
=========================  ==============================  ===========
torch.cuda.OutOfMemoryError                                transient
memory allocation          2                               transient
devices unavailable        46                              transient
a wait timed out           909                             transient
sticky: illegal address,   700, 702 (launch timeout),      persistent
assert, illegal            710, 715, 716, 717, 718, 719
instruction, misaligned,
address space, pc, launch
failure
any other CUDA error that  (PyTorch's, an injected one, or  persistent
no launch of the port's    "CUDA error: …" text with no
returned                   known code)
launch configuration       9, 98, 209, 701                 defect
any other code a launch    (CudaError with `.kernel` set)  defect
of the port's returned
not a CUDA error           —                               None
=========================  ==============================  ===========

A CUDA error is a `cudaenv.CudaError` (what the port's kernel wrappers
raise, with its code and kernel), a `torch.cuda.OutOfMemoryError`, a
`torch.AcceleratorError`, or a RuntimeError whose text is PyTorch's "CUDA
error: …" (its code read from cudaGetErrorString's text, `cudaenv.
ERROR_STRINGS`). The classes are duck-typed by name, as the JAX module
duck-types XlaRuntimeError. A sticky error is persistent: every later CUDA
call of the process fails, so a retry cannot help; a wrapper checks its
launch synchronously, so a sticky code it returns was left by earlier work.
A persistent error trips its domain immediately; transients need
``TRANSIENT_STRIKES`` consecutive hits. Both degrade: the host scorer
answers.

A defect is a fault of the program, not of the card: a kernel built for
another architecture, a launch that asks for more than the card has, a
code no launch should return. Serving it from the host would move the work
off the card while its tensors are there and hide the bug, so a defect
degrades nothing and moves no circuit: the caller raises it (a 500), as it
does a host bug. A node's start launches every kernel once on a tiny input
(`ops/sparse_kernels.start_check`), so a kernel that cannot launch on the
card stops the start instead. Non-CUDA exceptions classify to ``None`` and
never move a circuit either — a host-side bug must not quarantine the card.

Hot-path contract: when every domain is closed a health check is ONE plain
attribute read (`any_open`), no lock, no clock. Locks and monotonic reads
happen only in degraded states; `_lock` is a leaf (the transitions are
logged outside it).
"""

from __future__ import annotations

import logging
import random
import threading
import time

from .cudaenv import (LAUNCH_CONFIG_CODES, STICKY_CODES, TRANSIENT_CODES,
                      CudaError, error_code_of)
from .retry import RetryPolicy

logger = logging.getLogger("elasticsearch_tpu_torch.devicehealth")

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"
# the classes a search degrades to the host path on
DEGRADABLE = ("transient", "persistent")

# the texts PyTorch raises a failed CUDA call with
_CUDA_PHRASES = ("CUDA ERROR", "CUDA DRIVER ERROR", "CUDA OUT OF MEMORY")


def cuda_error_code(error: BaseException) -> tuple[bool, int | None]:
    """(is a CUDA error, its cudaError_t or None): a CudaError carries its
    code; PyTorch's error classes are duck-typed by name and module, and its
    "CUDA error: …" RuntimeErrors by their text."""
    if isinstance(error, CudaError):
        return True, error.code
    torch_names = {t.__name__ for t in type(error).__mro__
                   if getattr(t, "__module__", "").split(".")[0] == "torch"}
    if "OutOfMemoryError" in torch_names:
        return True, 2
    if "AcceleratorError" in torch_names:
        code = getattr(error, "error_code", None)
        return True, code if isinstance(code, int) else error_code_of(str(error))
    if isinstance(error, RuntimeError) and \
            any(p in str(error).upper() for p in _CUDA_PHRASES):
        return True, error_code_of(str(error))
    return False, None


def classify_device_error(error: BaseException) -> str | None:
    """"transient" | "persistent" for failures of the card, "defect" for
    faults of the program's own launches, None for everything else (the
    table in the module docstring)."""
    if not isinstance(error, BaseException):
        return None
    is_cuda, code = cuda_error_code(error)
    if not is_cuda:
        return None
    if code in TRANSIENT_CODES:
        return "transient"
    if code in LAUNCH_CONFIG_CODES:
        return "defect"
    if isinstance(error, CudaError) and error.kernel is not None \
            and not error.sticky:
        return "defect"  # a launch of the port's returned an unexpected code
    return "persistent"


def context_lost(error: BaseException) -> bool:
    """Whether `error` may have lost the process's CUDA context: a CUDA
    error with a sticky code, or one whose code nothing names."""
    is_cuda, code = cuda_error_code(error)
    return is_cuda and (code is None or code in STICKY_CODES)


def tag_domain(error: BaseException, domain: str) -> BaseException:
    """Stamp `error` with the fault domain of the seam that raised/observed
    it. First (narrowest) tag wins — an exception crossing several wrappers
    keeps the most specific attribution. Returns `error` so call sites can
    `raise tag_domain(e, ...)` without losing the traceback."""
    if getattr(error, "_estpu_device_domain", None) is None:
        try:
            error._estpu_device_domain = domain
        except Exception:  # noqa: BLE001 — __slots__-ed exotic exceptions
            pass
    return error


class _DomainCircuit:
    """One fault domain's breaker state. Mutated only under DeviceHealth._lock."""

    __slots__ = ("domain", "state", "strikes", "failures", "trips", "probes",
                 "recoveries", "backoff_s", "probe_at", "last_error")

    def __init__(self, domain: str):
        self.domain = domain
        self.state = CLOSED
        self.strikes = 0        # consecutive classified failures while closed
        self.failures = 0
        self.trips = 0
        self.probes = 0
        self.recoveries = 0
        self.backoff_s = 0.0
        self.probe_at = 0.0     # monotonic time the next probe is admitted
        self.last_error = None


class DeviceHealth:
    """Per-fault-domain circuit tracker with probed recovery.

    `any_open` is THE hot-path read: a plain bool, True iff at least one
    domain is not closed. `dirty` (also a plain bool) is True once any domain
    ever recorded a failure, so the success hook costs one attr read on a
    never-failed process. Everything else — probe scheduling, trip/recover
    transitions, stats — takes the leaf `_lock`, and the transitions are
    logged OUTSIDE it."""

    TRANSIENT_STRIKES = 3   # consecutive transients to trip a closed domain

    def __init__(self, base_s: float = 0.05, cap_s: float = 5.0,
                 rng: random.Random | None = None, clock=time.monotonic):
        self.any_open = False   # the one hot-path read
        self.dirty = False      # any failure ever recorded (success fast path)
        self._lock = threading.Lock()
        self._domains: dict[str, _DomainCircuit] = {}
        self._policy = RetryPolicy(base_s=base_s, cap_s=cap_s, rng=rng)
        self._clock = clock
        # node journals the transitions are published to: key -> publish
        self._publishers: dict[object, object] = {}
        self._failures = {"transient": 0, "persistent": 0}
        self._trips = 0
        self._probes = 0
        self._recoveries = 0

    # --- gate + probe admission (degraded states only) ----------------------
    def blocked(self, domains) -> str | None:
        """First domain that is open (probe window not yet due) — the caller
        degrades to the host path naming it — or None: every listed domain is
        closed, or due for a probe THIS caller was just admitted as. Call only
        after reading `any_open` (the closed-world fast path is the caller's
        one attr read)."""
        if not self.any_open:
            return None
        now = None
        with self._lock:
            for d in domains:
                c = self._domains.get(d)
                if c is None or c.state == CLOSED:
                    continue
                if now is None:
                    now = self._clock()
                if now >= c.probe_at:
                    # admit ONE probe: concurrent callers keep degrading until
                    # it reports (note_success closes / record_failure
                    # re-opens); a probe that never reports — lost thread —
                    # re-arms at the next backoff window rather than wedging
                    # the domain half-open forever
                    c.state = HALF_OPEN
                    c.probes += 1
                    self._probes += 1
                    c.probe_at = now + max(c.backoff_s, self._policy.base_s)
                    continue
                return d
        return None

    # --- outcome recording --------------------------------------------------
    def record_failure(self, domain: str, error: BaseException) -> str | None:
        """Classify `error` and advance `domain`'s circuit. Returns the
        classification; a defect or an error that is not a CUDA error (None)
        leaves every circuit untouched."""
        cls = classify_device_error(error)
        if cls not in DEGRADABLE:
            return cls
        events = []
        with self._lock:
            self.dirty = True
            c = self._domains.get(domain)
            if c is None:
                c = self._domains[domain] = _DomainCircuit(domain)
            self._failures[cls] += 1
            c.failures += 1
            c.last_error = f"{type(error).__name__}: {error}"[:240]
            if c.state == HALF_OPEN:
                # failed probe: back to open with a grown jitter window
                c.state = OPEN
                c.backoff_s = self._policy.next_backoff(c.backoff_s)
                c.probe_at = self._clock() + c.backoff_s
            elif c.state == CLOSED:
                # a persistent error spends the whole strike budget at once
                c.strikes += 1 if cls == "transient" else self.TRANSIENT_STRIKES
                if c.strikes >= self.TRANSIENT_STRIKES:
                    c.state = OPEN
                    c.trips += 1
                    self._trips += 1
                    c.backoff_s = self._policy.next_backoff(None)
                    c.probe_at = self._clock() + c.backoff_s
                    self.any_open = True
                    events.append((
                        "device_degraded", domain, "warn",
                        f"device domain [{domain}] tripped ({cls}): "
                        f"{c.last_error} — serving degrades to the host path",
                        {"domain": domain, "classification": cls,
                         "failures": c.failures}))
            # already OPEN: count it; the probe scheduler owns transitions
        for ev in events:
            self._publish(*ev)
        return cls

    def note_success(self, domains) -> None:
        """Clean device outcome for `domains`: resets closed-domain strikes and
        closes a half-open domain (the probe reported back healthy). One attr
        read when no failure was ever recorded."""
        if not self.dirty:
            return
        events = []
        with self._lock:
            for d in domains:
                c = self._domains.get(d)
                if c is None:
                    continue
                if c.state == CLOSED:
                    c.strikes = 0
                elif c.state == HALF_OPEN:
                    c.state = CLOSED
                    c.strikes = 0
                    c.backoff_s = 0.0
                    c.recoveries += 1
                    self._recoveries += 1
                    events.append((
                        "device_recovered", d, "info",
                        f"device domain [{d}] probe succeeded — device path "
                        f"restored", {"domain": d, "probes": c.probes}))
                # OPEN + success = a straggler launched before the trip; the
                # half-open probe protocol owns closing, not stragglers
            if events:
                self.any_open = any(c.state != CLOSED
                                    for c in self._domains.values())
        for ev in events:
            self._publish(*ev)

    # --- transitions, published outside the leaf lock ----------------------
    def register_publisher(self, key, publish) -> None:
        """`publish(type_, message, severity=..., key=..., **attrs)` — the
        EventJournal.publish signature; a node registers its journal so
        trips and recoveries land beside the watchdog's events."""
        with self._lock:
            self._publishers[key] = publish

    def unregister_publisher(self, key) -> None:
        with self._lock:
            self._publishers.pop(key, None)

    def _publish(self, type_, domain, severity, message, attrs) -> None:
        """Log a trip or a recovery and hand it to every registered
        journal (`device_degraded`, `device_recovered`)."""
        log = logger.warning if severity == "warn" else logger.info
        log("%s: %s", type_, message)
        with self._lock:
            publishers = list(self._publishers.values())
        for publish in publishers:
            try:
                publish(type_, message, severity=severity, key=domain, **attrs)
            except Exception:  # noqa: BLE001 — telemetry must not fail serving
                logger.exception("device-health event publish failed")

    # --- introspection ------------------------------------------------------
    def state(self, domain: str) -> str:
        with self._lock:
            c = self._domains.get(domain)
            return CLOSED if c is None else c.state

    def stats(self) -> dict:
        with self._lock:
            return {
                "any_open": self.any_open,
                "failures": dict(self._failures),
                "trips": self._trips,
                "probes": self._probes,
                "recoveries": self._recoveries,
                "domains": {
                    d: {"state": c.state, "failures": c.failures,
                        "trips": c.trips, "probes": c.probes,
                        "recoveries": c.recoveries,
                        "backoff_ms": round(c.backoff_s * 1000.0, 1),
                        "last_error": c.last_error}
                    for d, c in sorted(self._domains.items())
                },
            }

    def reset(self) -> None:
        """Forget every domain and counter (test isolation; publishers
        stay)."""
        with self._lock:
            self._domains.clear()
            self._failures = {"transient": 0, "persistent": 0}
            self._trips = self._probes = self._recoveries = 0
            self.any_open = False
            self.dirty = False


# Process-wide singleton of the port, like SERVING_COUNTERS: the serving path
# (search/service.py module functions, execute.py) has no node handle, and the
# device being probed is per-process anyway. A process that runs both packages
# holds one tracker of each, never shared.
DEVICE_HEALTH = DeviceHealth()
