"""Name-expression matching of the admin APIs (a copy of the JAX package's
`common/names.py`): `_all`, `*`, comma lists and wildcards."""

from __future__ import annotations

import fnmatch


def is_pattern(expr) -> bool:
    s = str(expr)
    return s in ("_all", "*", "") or "*" in s or "," in s


def split_names(expr) -> list[str]:
    if isinstance(expr, list):
        return [str(p) for p in expr]
    return [p.strip() for p in str(expr).split(",") if p.strip()]


def name_matches(name: str, expr) -> bool:
    """Does `name` match a name expression (_all / * / comma list / wildcards)?"""
    if expr in (None, "_all", "*", ""):
        return True
    return any(name == p or fnmatch.fnmatch(name, p) for p in split_names(expr))
