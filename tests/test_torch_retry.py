"""The port's `common/retry.py`, `common/deadline.py` clamp and timer wheel
against the JAX package's modules (the port's copy of
tests/test_resilience.py's deadline and RetryPolicy cases, each run on both
packages).

- The decorrelated-jitter schedule: every sleep in [base, cap] and never
  above 3x the previous one; one seed gives one schedule, and the port's
  equals the JAX module's step for step (tolerance: none, the same
  `random.Random` draws).
- `RetryPolicy.call`: a transient error retries until success, a
  deterministic one raises at once, exhaustion raises RetryExhaustedError
  carrying its attempts and cause, and a deadline stops the retries before
  a sleep would use up the budget; the attempts and sleeps equal the JAX
  module's for the same seed.
- `is_transient` classifies each error class as the JAX module classifies
  its counterpart of the same name.
- `Deadline.bounded` and `Deadline.clamp` answer as the JAX deadline's.
- `ThreadPool.schedule` (the failover chain's attempt timers) on both
  packages: due timers fire once, earliest first, a cancelled one never."""

from __future__ import annotations

import random
import time

import pytest

import elasticsearch_tpu.common.errors as jerr
import elasticsearch_tpu_torch.common.errors as perr
from elasticsearch_tpu.common import deadline as jdl
from elasticsearch_tpu.common import retry as jretry
from elasticsearch_tpu_torch.common import deadline as pdl
from elasticsearch_tpu_torch.common import retry as pretry

PKGS = {"port": (pretry, perr, pdl), "jax": (jretry, jerr, jdl)}


@pytest.fixture(params=["port", "jax"])
def pkg(request):
    return PKGS[request.param]


def test_backoff_jitter_bounds(pkg):
    retry, _errors, _dl = pkg
    policy = retry.RetryPolicy(max_attempts=10, base_s=0.05, cap_s=2.0,
                               rng=random.Random(7))
    prev = None
    for _ in range(200):
        nxt = policy.next_backoff(prev)
        assert policy.base_s <= nxt <= policy.cap_s
        assert nxt <= max(policy.base_s, (prev if prev is not None
                                          else policy.base_s) * 3.0) + 1e-9
        prev = nxt


@pytest.mark.parametrize("seed", [0, 13, 4242])
@pytest.mark.parametrize("base,cap", [(0.05, 1.0), (0.01, 0.02), (0.2, 5.0)])
def test_seeded_schedule_equals_jax(seed, base, cap):
    port = pretry.RetryPolicy(base_s=base, cap_s=cap, rng=random.Random(seed))
    jax = jretry.RetryPolicy(base_s=base, cap_s=cap, rng=random.Random(seed))
    sp = sj = None
    for _ in range(50):
        sp, sj = port.next_backoff(sp), jax.next_backoff(sj)
        assert sp == sj


def test_retry_transient_then_success_counts_attempts(pkg):
    retry, errors, _dl = pkg
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise errors.TransportError("blip")
        return "ok"

    policy = retry.RetryPolicy(max_attempts=5, rng=random.Random(0), sleep=lambda s: None)
    assert policy.call(flaky) == "ok"
    assert len(calls) == 3


def test_no_retry_on_non_transient(pkg):
    retry, errors, _dl = pkg
    calls = []

    def conflict():
        calls.append(1)
        raise errors.VersionConflictError("d#1", 2, 1)

    policy = retry.RetryPolicy(max_attempts=5, rng=random.Random(0), sleep=lambda s: None)
    with pytest.raises(errors.VersionConflictError):
        policy.call(conflict)
    assert len(calls) == 1


def test_retry_exhaustion_carries_cause(pkg):
    retry, errors, _dl = pkg
    policy = retry.RetryPolicy(max_attempts=3, rng=random.Random(0), sleep=lambda s: None)
    with pytest.raises(retry.RetryExhaustedError) as ei:
        policy.call(lambda: (_ for _ in ()).throw(errors.NodeNotConnectedError("gone")))
    assert ei.value.attempts == 3
    assert isinstance(ei.value.cause, errors.NodeNotConnectedError)
    assert isinstance(ei.value, errors.TransportError)
    assert str(ei.value) == "operation failed after 3 attempt(s): gone"


def test_retry_deadline_exhaustion_stops_early(pkg):
    """A sleep that would use up the remaining budget is not taken: the
    policy reports exhaustion instead of sleeping past the deadline."""
    retry, errors, dl = pkg
    slept = []

    def sleeping(s):
        slept.append(s)
        time.sleep(s)

    policy = retry.RetryPolicy(max_attempts=50, base_s=0.1, cap_s=0.1,
                               rng=random.Random(0), sleep=sleeping)
    calls = []

    def always_down():
        calls.append(1)
        raise errors.TransportError("down")

    with pytest.raises(retry.RetryExhaustedError):
        policy.call(always_down, deadline=dl.Deadline.after(0.25))
    assert len(calls) <= 4
    assert sum(slept) <= 0.25 + 1e-6


def test_expired_deadline_makes_no_attempt(pkg):
    retry, _errors, dl = pkg
    policy = retry.RetryPolicy(rng=random.Random(0), sleep=lambda s: None)
    calls = []
    with pytest.raises(retry.RetryExhaustedError) as ei:
        policy.call(lambda: calls.append(1), deadline=dl.Deadline.after(0.0),
                    describe="replica op")
    assert calls == [] and ei.value.attempts == 0
    assert str(ei.value) == \
        "replica op failed after 0 attempt(s): deadline exhausted before any attempt"


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_call_schedule_equals_jax(seed):
    """The same failing call under the same seed: the same attempts and
    the same sleeps on both packages."""
    out = []
    for retry, errors, _dl in (PKGS["port"], PKGS["jax"]):
        slept, calls = [], []

        def down():
            calls.append(1)
            raise errors.ReceiveTimeoutError("slow")

        policy = retry.RetryPolicy(max_attempts=6, base_s=0.01, cap_s=0.5,
                                   rng=random.Random(seed), sleep=slept.append)
        with pytest.raises(retry.RetryExhaustedError):
            policy.call(down)
        out.append((len(calls), slept))
    assert out[0] == out[1] and out[0][0] == 6 and len(out[0][1]) == 5


CLASSIFIED = [
    ("NodeNotConnectedError", ("x",)), ("ReceiveTimeoutError", ("x",)),
    ("TransportError", ("x",)), ("ActionNotFoundError", ("no handler",)),
    ("MasterNotDiscoveredError", ("x",)), ("UnavailableShardsError", ("x",)),
    ("EngineClosedError", ("x",)), ("RejectedExecutionError", ("x",)),
    ("VersionConflictError", ("d#1", 2, 1)), ("DocumentMissingError", ("x",)),
    ("IndexShardMissingError", ("x",)), ("IllegalArgumentError", ("x",)),
    ("CircuitBreakingError", ("x",)), ("SearchEngineError", ("x",)),
]


@pytest.mark.parametrize("name,args", CLASSIFIED, ids=[n for n, _a in CLASSIFIED])
def test_is_transient_matches_jax(name, args):
    port = pretry.is_transient(getattr(perr, name)(*args))
    jax = jretry.is_transient(getattr(jerr, name)(*args))
    assert port == jax


def test_is_transient_classification(pkg):
    retry, errors, _dl = pkg
    assert retry.is_transient(errors.NodeNotConnectedError("x"))
    assert retry.is_transient(errors.ReceiveTimeoutError("x"))
    assert retry.is_transient(errors.TransportError("x"))
    assert not retry.is_transient(errors.VersionConflictError("d#1", 2, 1))
    assert not retry.is_transient(errors.ActionNotFoundError("no handler"))
    assert not retry.is_transient(ValueError("a host bug"))


def test_deadline_budget_and_clamp(pkg):
    _retry, _errors, dl = pkg
    d = dl.Deadline.after(10.0)
    assert d.bounded and not d.expired()
    assert d.clamp(5.0) == pytest.approx(5.0, abs=0.1)
    assert d.clamp(60.0) == pytest.approx(d.remaining(), abs=0.1)
    assert d.clamp(None) == pytest.approx(d.remaining(), abs=0.1)
    gone = dl.Deadline.after(0.0)
    assert gone.expired() and gone.clamp(30.0) == 0.0
    free = dl.Deadline.after(None)
    assert not free.bounded and free.clamp(30.0) == 30.0 and free.clamp(None) is None
    assert dl.NO_DEADLINE.clamp(7.0) == 7.0


def test_timer_wheel_fires_due_timers_in_order_and_drops_cancelled(pkg):
    """`ThreadPool.schedule`, the failover chain's attempt timers: due
    timers fire once, earliest first, a cancelled one never, and a timer
    scheduled ahead of a waiting one still fires on time."""
    import threading

    if pkg[0] is pretry:
        from elasticsearch_tpu_torch.threadpool import ThreadPool
    else:
        from elasticsearch_tpu.threadpool import ThreadPool

    pool = ThreadPool()
    fired, lock = [], threading.Lock()

    def mark(name):
        def fn():
            with lock:
                fired.append(name)
        return fn

    try:
        late = pool.schedule(30.0, "generic", mark("late"))
        pool.schedule(0.2, "generic", mark("second"))
        pool.schedule(0.05, "generic", mark("first"))
        gone = pool.schedule(0.1, "generic", mark("cancelled"))
        gone.cancel()
        deadline = time.monotonic() + 5.0
        while len(fired) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        assert fired == ["first", "second"]
        late.cancel()
    finally:
        pool.shutdown()
