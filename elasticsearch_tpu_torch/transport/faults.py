"""Fault injection, the port of the JAX package's `transport/faults.py`:
the transport's `FaultPolicy` (seeded rules that drop, delay, or fail a
message by action and address, installed on one TransportService), the
seeded device-error injection for the fault-domain circuits
(`DeviceFaults`, `make_device_error`) and the stall injection for the
batch's one pull (`DevicePullFaults`).

A transport rule is `drop` (the message vanishes: only a response timeout
surfaces it), `delay` (delivered after `delay_s`), `error` (an error
instance or factory) or `disconnect` (NodeNotConnectedError at once). It
applies on the send side, or with `direction="recv"` inside the receiving
service's `dispatch` (a slow or lost handler). Matching is fnmatch over the
action and the target address (brackets literal), plus an optional
`where(action, address, request)`; `probability` draws from the policy's
seeded RNG only for rules that match, and `max_hits` disarms a rule.

The kinds are the JAX package's, and each keeps its JAX class under the
port's classifier (common/devicehealth), so one arm moves both packages'
circuits the same way; the errors are the ones the card raises:

===========  ===============================================  ==========
kind         raised                                           class
===========  ===============================================  ==========
oom          torch.cuda.OutOfMemoryError                      transient
timeout      CudaError(909): a wait timed out                 transient
unavailable  CudaError(46): devices busy or unavailable       transient
launch       CudaError(719): unspecified launch failure       persistent
transfer     CudaError(700): an illegal memory access         persistent
internal     CudaError(999): unknown error                    persistent
===========  ===============================================  ==========

Kinds without an exact CUDA twin: the card has no recoverable "kernel ran
too long" — a real launch timeout (702) is sticky and classifies
persistent, while an injected `timeout` is the transient 909 of a timed-out
wait; a failed device→host copy surfaces on the card as the illegal access
(700) it meets, where the JAX package's `transfer` is a non-sticky
FAILED_PRECONDITION; `internal` has no code of its own and takes 999.
"""

from __future__ import annotations

import fnmatch
import random
import threading
from dataclasses import dataclass, field

import torch

from ..common.cudaenv import CudaError
from ..common.errors import NodeNotConnectedError, TransportError

KINDS = ("drop", "delay", "error", "disconnect")


def _glob_match(value: str, pattern: str) -> bool:
    """fnmatch with `[`/`]` taken literally; a pattern without wildcards
    compares exactly."""
    if "*" not in pattern and "?" not in pattern:
        return value == pattern
    return fnmatch.fnmatchcase(value, pattern.replace("[", "[[]"))


@dataclass
class FaultRule:
    kind: str = "disconnect"
    action: str = "*"             # fnmatch pattern over the action string
    node: str = "*"               # fnmatch pattern over the target address
    direction: str = "send"       # "send" (on the sender) | "recv" (in dispatch)
    delay_s: float = 0.0          # for kind="delay"
    error: object = None          # Exception prototype or factory; for "error"
    probability: float = 1.0      # matched via the policy's seeded RNG
    max_hits: int | None = None   # disarm after N injections (None = forever)
    where: object = None          # optional (action, address, request) -> bool
    hits: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind [{self.kind}] (want one of {KINDS})")
        if self.direction not in ("send", "recv"):
            raise ValueError(f"unknown fault direction [{self.direction}]")

    def make_error(self) -> Exception:
        """A fresh exception per injection (one instance raised from many
        threads would share its traceback)."""
        if self.error is None:
            return TransportError(f"injected fault ({self.action} -> {self.node})")
        if isinstance(self.error, Exception):
            try:
                return type(self.error)(*self.error.args)
            except TypeError:  # error classes with exotic signatures: best effort
                return self.error
        err = self.error("injected fault") if callable(self.error) else None
        return err if isinstance(err, Exception) else TransportError(str(self.error))


class FaultPolicy:
    """A seeded rule set installable on one TransportService. Thread-safe:
    the transport consults it from sender and dispatcher threads; one
    seeded RNG makes a run replay from its seed."""

    def __init__(self, seed: int | None = 0):
        self.rng = random.Random(seed)
        self._rules: list[FaultRule] = []
        self._lock = threading.Lock()
        self.injected = 0  # total injections, all rules

    # --- rule management ---------------------------------------------------
    def add_rule(self, rule: FaultRule) -> FaultRule:
        with self._lock:
            self._rules.append(rule)
        return rule

    def drop(self, action: str = "*", node: str = "*", **kw) -> FaultRule:
        return self.add_rule(FaultRule(kind="drop", action=action, node=node, **kw))

    def delay(self, delay_s: float, action: str = "*", node: str = "*",
              **kw) -> FaultRule:
        return self.add_rule(FaultRule(kind="delay", delay_s=delay_s, action=action,
                                       node=node, **kw))

    def error(self, error=None, action: str = "*", node: str = "*",
              **kw) -> FaultRule:
        return self.add_rule(FaultRule(kind="error", error=error, action=action,
                                       node=node, **kw))

    def disconnect(self, action: str = "*", node: str = "*", **kw) -> FaultRule:
        return self.add_rule(
            FaultRule(kind="disconnect",
                      error=NodeNotConnectedError("injected disconnect"),
                      action=action, node=node, **kw))

    def clear(self):
        with self._lock:
            self._rules.clear()

    def remove_rule(self, rule: FaultRule):
        with self._lock:
            if rule in self._rules:
                self._rules.remove(rule)

    # --- matching ----------------------------------------------------------
    def decide(self, action: str, address: str, request=None,
               direction: str = "send") -> FaultRule | None:
        """The first armed matching rule, its hit recorded, or None."""
        with self._lock:
            for rule in self._rules:
                if rule.direction != direction:
                    continue
                if rule.max_hits is not None and rule.hits >= rule.max_hits:
                    continue
                if not _glob_match(action, rule.action):
                    continue
                if not _glob_match(str(address), rule.node):
                    continue
                if rule.where is not None and not rule.where(action, address, request):
                    continue
                if rule.probability < 1.0 and self.rng.random() >= rule.probability:
                    continue
                rule.hits += 1
                self.injected += 1
                return rule
        return None

    # --- installation ------------------------------------------------------
    def install(self, transport_service) -> "FaultPolicy":
        """Attach to a live TransportService (a node's `transport`),
        replacing any policy it had."""
        transport_service.fault_policy = self
        return self

    @staticmethod
    def uninstall(transport_service):
        transport_service.fault_policy = None


# kind -> (cudaError_t, message); None: torch's out-of-memory class
_DEVICE_ERRORS = {
    "oom": (None, "CUDA out of memory. injected: allocating scratch"),
    "timeout": (909, "injected: the timeout specified for the wait "
                     "operation has lapsed"),
    "unavailable": (46, "injected: CUDA-capable device(s) is/are busy or unavailable"),
    "launch": (719, "injected: unspecified launch failure"),
    "transfer": (700, "injected: an illegal memory access was encountered "
                      "(device-to-host copy)"),
    "internal": (999, "injected: unknown error"),
}

DEVICE_ERROR_KINDS = tuple(_DEVICE_ERRORS)


def make_device_error(kind: str) -> Exception:
    """A FRESH injected CUDA error per injection (a shared instance would
    interleave tracebacks across threads)."""
    code, msg = _DEVICE_ERRORS[kind]
    if code is None:
        return torch.cuda.OutOfMemoryError(msg)
    return CudaError(code, f"CUDA error {code}: {msg}")


class DeviceFaults:
    """Deterministic device-error injection — error kind × domain glob ×
    count. Seam call sites sit at the domain touchpoints (`pack:<index>`
    before a pack publishes, `compile:<family>` before a family's launch,
    `pull:<index>` before the batch's one wait) so every trip, probe and
    recovery replays identically under test.

    Hot-path contract: `active` is ONE plain attribute read and the shipped
    default is disarmed; `check()` takes only the leaf `_lock` for the
    countdown when armed, and raises OUTSIDE it."""

    def __init__(self):
        self.active = False  # the one hot-path read
        self._lock = threading.Lock()
        self._error = "internal"
        self._domain = "*"
        self._remaining = 0
        self.injected = 0

    def arm(self, error: str = "internal", domain: str = "*", times: int = 1):
        if error not in _DEVICE_ERRORS:
            raise ValueError(f"unknown device error kind [{error}] "
                             f"(want one of {DEVICE_ERROR_KINDS})")
        with self._lock:
            self._error = error
            self._domain = domain
            self._remaining = int(times)
            self.active = True
        return self

    def disarm(self):
        with self._lock:
            self.active = False
            self._remaining = 0

    def check(self, domain: str) -> None:
        """Raise the armed error if `domain` matches (decrements the budget,
        auto-disarms at zero). Call sites guard with the `active` attr read so
        the disarmed serving path pays exactly that."""
        with self._lock:
            if not self.active or self._remaining <= 0:
                return
            if not _glob_match(str(domain), self._domain):
                return
            self._remaining -= 1
            if self._remaining <= 0:
                self.active = False
            self.injected += 1
            kind = self._error
        raise make_device_error(kind)


# the port's own process-wide injector (a process that runs both packages
# arms each package's apart)
DEVICE_FAULTS = DeviceFaults()


class DevicePullFaults:
    """Deterministic stall injection for a batch's one device→host wait
    (search/execute.wait_pull): a pull whose owning index matches `index`
    sleeps `delay_s` before it waits, at most `times` injections in all
    (then it disarms itself). It wedges the drainer's merge the way a hung
    card would, for the stall watchdog's tests.

    The hot-path gate is one attribute read (`active`, a plain bool; the
    shipped default is disarmed). `delay_for` takes only the leaf `_lock`
    for the countdown when armed; the caller sleeps outside it."""

    def __init__(self):
        self.active = False  # the one hot-path read
        self._lock = threading.Lock()
        self._delay_s = 0.0
        self._index = "*"
        self._remaining = 0
        self.injected = 0

    def arm(self, delay_s: float, index: str = "*", times: int = 1):
        with self._lock:
            self._delay_s = float(delay_s)
            self._index = index
            self._remaining = int(times)
            self.active = True
        return self

    def disarm(self):
        with self._lock:
            self.active = False
            self._remaining = 0

    def delay_for(self, index: str | None) -> float:
        """The stall to apply to one pull (0.0: none); decrements the
        budget under the leaf lock."""
        with self._lock:
            if not self.active or self._remaining <= 0:
                return 0.0
            if not _glob_match(str(index), self._index):
                return 0.0
            self._remaining -= 1
            if self._remaining <= 0:
                self.active = False
            self.injected += 1
            return self._delay_s


# the port's own process-wide stall injector
DEVICE_PULL = DevicePullFaults()
