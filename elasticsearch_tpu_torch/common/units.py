"""Byte-size and time-value units (a trimmed copy of the JAX package's
`common/units.py`): settings accept "512mb" and "30s" style strings."""

from __future__ import annotations

import re

from .errors import IllegalArgumentError

_BYTE_SUFFIXES = {"b": 1, "k": 1024, "kb": 1024, "m": 1024**2, "mb": 1024**2,
                  "g": 1024**3, "gb": 1024**3, "t": 1024**4, "tb": 1024**4,
                  "p": 1024**5, "pb": 1024**5}

_TIME_SUFFIXES = {"nanos": 1e-9, "micros": 1e-6, "ms": 1e-3, "s": 1.0,
                  "m": 60.0, "h": 3600.0, "d": 86400.0, "w": 604800.0}

_NUM_RE = re.compile(r"^\s*(-?[\d.]+)\s*([a-zA-Z%]*)\s*$")


def parse_bytes(value, default: int | None = None) -> int:
    """Parse "512mb" → bytes. Ints pass through."""
    if value is None:
        if default is None:
            raise IllegalArgumentError("missing byte size value")
        return default
    if isinstance(value, (int, float)):
        return int(value)
    m = _NUM_RE.match(str(value))
    if not m:
        raise IllegalArgumentError(f"failed to parse byte size [{value}]")
    num, suffix = m.groups()
    suffix = suffix.lower()
    if suffix and suffix not in _BYTE_SUFFIXES:
        raise IllegalArgumentError(f"unknown byte size unit [{suffix}] in [{value}]")
    return int(float(num) * _BYTE_SUFFIXES.get(suffix, 1))


def parse_ratio_or_bytes(value, total: int, default=None) -> int:
    """A percentage ("85%") of `total`, or an absolute byte size."""
    if value is None:
        value = default
    s = str(value)
    if s.endswith("%"):
        return int(total * float(s[:-1]) / 100.0)
    return parse_bytes(value)


def parse_time(value, default: float | None = None) -> float:
    """Parse "30s"/"5m"/"200ms" → seconds (float). Bare numbers are
    milliseconds, and "-1" stays -1 (disabled)."""
    if value is None:
        if default is None:
            raise IllegalArgumentError("missing time value")
        return default
    if isinstance(value, (int, float)):
        return float(value) / 1000.0
    s = str(value)
    if s == "-1":
        return -1.0
    m = _NUM_RE.match(s)
    if not m:
        raise IllegalArgumentError(f"failed to parse time value [{value}]")
    num, suffix = m.groups()
    suffix = suffix.lower()
    if not suffix:
        return float(num) / 1000.0
    if suffix not in _TIME_SUFFIXES:
        raise IllegalArgumentError(f"unknown time unit [{suffix}] in [{value}]")
    return float(num) * _TIME_SUFFIXES[suffix]
