"""Monotonic per-request time budgets (a trimmed copy of the JAX package's
`common/deadline.py`: `parse_timevalue`, `Deadline`, `NO_DEADLINE`).

One `Deadline` is created where a request enters and every derived wait is
computed from its remaining budget. Deadlines are host-side only: they clamp
work between device launches (the batcher flushes early enough that launch
and merge still fit); a launched kernel always completes whole."""

from __future__ import annotations

import re
import time

_TIMEVALUE_RE = re.compile(r"^\s*(-?\d+(?:\.\d+)?)\s*(ms|s|m|h|d|micros|nanos)?\s*$",
                           re.IGNORECASE)

_UNIT_S = {"nanos": 1e-9, "micros": 1e-6, "ms": 1e-3, "s": 1.0,
           "m": 60.0, "h": 3600.0, "d": 86400.0}


def parse_timevalue(value) -> float | None:
    """Parse a reference-style time value into seconds.

    Accepts "50ms" / "5s" / "1m" / "2h" strings; a bare number (or numeric
    string) is MILLISECONDS, matching the reference's request-body `timeout`
    field. None, "" and negative values (the reference's `-1` = unlimited)
    parse to None (no budget)."""
    if value is None:
        return None
    if isinstance(value, bool):
        raise ValueError(f"cannot parse time value [{value!r}]")
    if isinstance(value, (int, float)):
        return None if value < 0 else float(value) / 1000.0
    m = _TIMEVALUE_RE.match(str(value))
    if not m:
        raise ValueError(f"cannot parse time value [{value!r}]")
    num = float(m.group(1))
    if num < 0:
        return None
    unit = (m.group(2) or "ms").lower()
    return num * _UNIT_S[unit]


class Deadline:
    """A monotonic point in time carrying a request's remaining budget.

    `Deadline.after(None)` is the unbounded deadline: it never expires."""

    __slots__ = ("_expires_at",)

    def __init__(self, expires_at: float | None):
        self._expires_at = expires_at

    @classmethod
    def after(cls, seconds: float | None) -> "Deadline":
        """Budget starting now; None = unbounded."""
        if seconds is None:
            return cls(None)
        return cls(time.monotonic() + max(0.0, float(seconds)))

    @property
    def bounded(self) -> bool:
        return self._expires_at is not None

    def remaining(self) -> float | None:
        """Seconds left (>= 0.0), or None when unbounded."""
        if self._expires_at is None:
            return None
        return max(0.0, self._expires_at - time.monotonic())

    def expired(self) -> bool:
        return self._expires_at is not None and time.monotonic() >= self._expires_at

    def clamp(self, timeout: float | None) -> float | None:
        """The tighter of `timeout` and the remaining budget; an expired
        deadline clamps to 0.0 (the caller decides how expiry surfaces)."""
        rem = self.remaining()
        if rem is None:
            return timeout
        if timeout is None:
            return rem
        return min(float(timeout), rem)


#: Shared unbounded deadline, the default argument of the serving path.
NO_DEADLINE = Deadline(None)
