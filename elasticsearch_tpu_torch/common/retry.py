"""Retry with exponential backoff and decorrelated jitter, bounded by a
deadline (a copy of the JAX package's `common/retry.py`).

Transient transport failures are retried with randomized, growing sleeps;
everything else (version conflicts, parse errors, validation) surfaces at
once, because retrying a deterministic failure only burns the budget. The
retry budget is a Deadline: every sleep is clamped to the remaining budget,
and exhaustion raises the last transient error for the caller to report
(never to swallow). The write path's replica fan-out and its shard-failed
reports retry through it; the device fault domains (common/devicehealth)
space their half-open probes with its schedule, and the warmer its
warm-pack retries.
"""

from __future__ import annotations

import random
import time

from .deadline import NO_DEADLINE, Deadline
from .errors import (
    ActionNotFoundError,
    ClusterBlockError,
    EngineClosedError,
    MasterNotDiscoveredError,
    NodeNotConnectedError,
    ReceiveTimeoutError,
    RejectedExecutionError,
    TransportError,
    UnavailableShardsError,
)

# Failures worth a second attempt: the remote may answer after a reconnect, a
# re-elected master or a published cluster state. ActionNotFoundError is a
# TransportError but deterministic (400): excluded below.
# RejectedExecutionError is saturation, not breakage: the queue drains, and
# the jitter keeps the retry from re-creating the spike that filled it.
_TRANSIENT = (
    NodeNotConnectedError,
    ReceiveTimeoutError,
    TransportError,
    MasterNotDiscoveredError,
    UnavailableShardsError,
    EngineClosedError,
    RejectedExecutionError,
)


def is_transient(error: BaseException) -> bool:
    """Would the same call plausibly succeed against a healthier cluster?"""
    if isinstance(error, ActionNotFoundError):
        return False
    if isinstance(error, ClusterBlockError):
        return error.status == 503  # retryable blocks only (no master / recovering)
    # a CUDA error carries its own taxonomy (common/devicehealth): an
    # out-of-memory or timeout drains with pressure and is worth a backed-off
    # retry; a launch defect or a sticky error is not. Lazy import:
    # devicehealth imports RetryPolicy.
    from .devicehealth import classify_device_error

    device_cls = classify_device_error(error)
    if device_cls is not None:
        return device_cls == "transient"
    return isinstance(error, _TRANSIENT)


class RetryExhaustedError(TransportError):
    """Every attempt failed (or the deadline ran out between them). Carries
    the last transient error as `cause`, so a shard-failed report stays
    specific."""

    def __init__(self, message: str, *, cause: Exception | None = None,
                 attempts: int = 0):
        super().__init__(message, cause=cause)
        self.attempts = attempts


class RetryPolicy:
    """Decorrelated-jitter backoff: sleep_n = min(cap, uniform(base, 3 * sleep_{n-1})).

    Jitter is load-bearing, not cosmetic — on a replica fan-out every peer
    retries at once, and synchronized retries re-create the spike that caused
    the first failure. `rng` and `sleep` are injectable so tests pin the
    schedule without wall-clock waits.
    """

    def __init__(self, max_attempts: int = 3, base_s: float = 0.05,
                 cap_s: float = 1.0, rng: random.Random | None = None,
                 classify=is_transient, sleep=time.sleep):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.base_s = base_s
        self.cap_s = cap_s
        self.rng = rng or random.Random()
        self.classify = classify
        self.sleep = sleep

    def next_backoff(self, prev_sleep_s: float | None) -> float:
        """One step of the decorrelated-jitter schedule. Always in
        [base_s, cap_s]; grows up to 3x the previous sleep."""
        prev = self.base_s if prev_sleep_s is None else prev_sleep_s
        return min(self.cap_s, self.rng.uniform(self.base_s,
                                                max(self.base_s, prev * 3.0)))

    def call(self, fn, *, deadline: Deadline = NO_DEADLINE, describe: str = "operation"):
        """Run `fn()` with retries. Raises the original error when it is not
        transient; raises RetryExhaustedError (cause = the last transient
        error) when the attempts or the deadline run out."""
        prev_sleep: float | None = None
        last_err: Exception | None = None
        made = 0  # attempts actually invoked (a pre-expired deadline makes none)
        for _ in range(self.max_attempts):
            if deadline.expired():
                break
            made += 1
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — classified right below
                if not self.classify(e):
                    raise
                last_err = e
            if made >= self.max_attempts:
                break
            prev_sleep = self.next_backoff(prev_sleep)
            pause = deadline.clamp(prev_sleep)
            if deadline.bounded and (pause is None or pause >= (deadline.remaining() or 0.0)):
                # the sleep alone would use up the budget: the retry could
                # never complete, so report exhaustion now
                break
            if pause:
                self.sleep(pause)
        detail = last_err if last_err is not None else \
            "deadline exhausted before any attempt"
        raise RetryExhaustedError(
            f"{describe} failed after {made} attempt(s): {detail}",
            cause=last_err, attempts=made)
