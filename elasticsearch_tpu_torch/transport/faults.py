"""Seeded device-error injection for the fault-domain circuits, and stall
injection for the batch's one pull — the port of the JAX package's
`transport/faults.py` `DeviceFaults`, `make_device_error` and
`DevicePullFaults` (its transport `FaultPolicy` comes with the slice with
two nodes).

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
import threading

import torch

from ..common.cudaenv import CudaError


def _glob_match(value: str, pattern: str) -> bool:
    """fnmatch with `[`/`]` taken literally; a pattern without wildcards
    compares exactly."""
    if "*" not in pattern and "?" not in pattern:
        return value == pattern
    return fnmatch.fnmatchcase(value, pattern.replace("[", "[[]"))


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
