"""Flat dotted-key settings with typed getters (a trimmed copy of the JAX
package's `common/settings.py`: the accessors the node, analysis, mapping,
similarity, the breakers and the batcher read, `prepare_settings` and
`validate_index_name`)."""

from __future__ import annotations

import json
import os
import re
from typing import Any, Iterator, Mapping

from .errors import IllegalArgumentError, InvalidIndexNameError
from .units import parse_bytes, parse_time

_TRUE = {"true", "1", "on", "yes"}
_FALSE = {"false", "0", "off", "no"}


def _flatten_dict(obj, prefix: str, out: dict):
    if isinstance(obj, Mapping):
        for k, v in obj.items():
            _flatten_dict(v, f"{prefix}{k}.", out)
    elif isinstance(obj, (list, tuple)):
        out[prefix[:-1]] = list(obj)
    else:
        out[prefix[:-1]] = obj


class Settings(Mapping[str, Any]):
    """Immutable flat-keyed settings map with typed accessors."""

    EMPTY: "Settings"

    __slots__ = ("_map",)

    def __init__(self, data: Mapping[str, Any] | None = None):
        flat: dict[str, Any] = {}
        if data:
            _flatten_dict(dict(data), "", flat)
        object.__setattr__(self, "_map", flat)

    def __getitem__(self, key: str) -> Any:
        return self._map[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._map)

    def __len__(self) -> int:
        return len(self._map)

    def __repr__(self) -> str:
        return f"Settings({self._map!r})"

    def get(self, key: str, default=None):
        return self._map.get(key, default)

    def get_str(self, key: str, default: str | None = None) -> str | None:
        v = self._map.get(key)
        return default if v is None else str(v)

    def get_int(self, key: str, default: int | None = None) -> int | None:
        v = self._map.get(key)
        if v is None:
            return default
        try:
            return int(v)
        except (TypeError, ValueError):
            raise IllegalArgumentError(
                f"failed to parse int setting [{key}] = [{v}]")

    def get_float(self, key: str, default: float | None = None) -> float | None:
        v = self._map.get(key)
        if v is None:
            return default
        try:
            return float(v)
        except (TypeError, ValueError):
            raise IllegalArgumentError(
                f"failed to parse float setting [{key}] = [{v}]")

    def get_bool(self, key: str, default: bool | None = None) -> bool | None:
        v = self._map.get(key)
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        s = str(v).lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        raise IllegalArgumentError(f"failed to parse bool setting [{key}] = [{v}]")

    def get_time(self, key: str, default=None) -> float | None:
        """Seconds; a string default parses like a value."""
        v = self._map.get(key)
        if v is None:
            return parse_time(default) if isinstance(default, str) else default
        return parse_time(v)

    def get_bytes(self, key: str, default=None) -> int | None:
        """Bytes (`512kb`, `40mb`, a bare number); a string default parses
        like a value."""
        v = self._map.get(key)
        if v is None:
            return parse_bytes(default) if isinstance(default, str) else default
        return parse_bytes(v)

    def get_list(self, key: str, default: list | None = None) -> list:
        v = self._map.get(key)
        if v is None:
            # a flattened list: key.0, key.1, ...
            items = []
            while f"{key}.{len(items)}" in self._map:
                items.append(self._map[f"{key}.{len(items)}"])
            return items if items else list(default or [])
        if isinstance(v, (list, tuple)):
            return list(v)
        return [p.strip() for p in str(v).split(",") if p.strip()]

    def as_dict(self) -> dict[str, Any]:
        return dict(self._map)

    def merged(self, other: "Settings | Mapping | None") -> "Settings":
        if not other:
            return self
        s = Settings()
        s._map.update(self._map)
        if isinstance(other, Settings):
            s._map.update(other._map)
        else:
            _flatten_dict(dict(other), "", s._map)
        return s

    def by_prefix(self, prefix: str) -> "Settings":
        s = Settings()
        s._map.update({k[len(prefix):]: v for k, v in self._map.items()
                       if k.startswith(prefix)})
        return s

    def groups(self, prefix: str) -> dict[str, "Settings"]:
        """`groups("index.similarity.")` → {"default": Settings(...)}."""
        if not prefix.endswith("."):
            prefix += "."
        out: dict[str, Settings] = {}
        for k, v in self._map.items():
            if k.startswith(prefix):
                rest = k[len(prefix):]
                if "." in rest:
                    name, sub = rest.split(".", 1)
                    out.setdefault(name, Settings())._map[sub] = v
                else:
                    out.setdefault(rest, Settings())._map[""] = v
        return out

    @classmethod
    def from_flat(cls, flat: Mapping[str, Any]) -> "Settings":
        s = cls()
        for k, v in flat.items():
            if isinstance(v, Mapping):
                _flatten_dict(v, k + ".", s._map)
            else:
                s._map[k] = v
        return s


Settings.EMPTY = Settings()


def prepare_settings(settings: "Settings | Mapping | None" = None) -> Settings:
    """Node settings: the explicit ones, then the `ESTPU_SETTINGS` JSON
    environment override (the JAX package's order; config files are a later
    slice)."""
    s = Settings.EMPTY
    if settings:
        s = s.merged(settings if isinstance(settings, Settings)
                     else Settings.from_flat(settings))
    env = os.environ.get("ESTPU_SETTINGS")
    if env:
        s = s.merged(Settings.from_flat(json.loads(env)))
    return s


_INDEX_NAME_RE = re.compile(r"^[^A-Z\\/*?\"<>| ,#]+$")


def validate_index_name(name: str) -> None:
    """The JAX package's index-name rule: no upper case, no leading `_`,
    `-` or `+`, none of `\\/*?"<>| ,#` (`_river` is the one exemption)."""
    if name == "_river":
        return
    if not name or name.startswith(("_", "-", "+")) or not _INDEX_NAME_RE.match(name):
        raise InvalidIndexNameError(f"invalid index name [{name}]")
