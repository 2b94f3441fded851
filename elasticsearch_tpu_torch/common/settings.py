"""Flat dotted-key settings with typed getters (a trimmed copy of the JAX
package's `common/settings.py`: the accessors analysis, mapping,
similarity, the breakers and the batcher read)."""

from __future__ import annotations

from typing import Any, Iterator, Mapping

from .errors import IllegalArgumentError


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
