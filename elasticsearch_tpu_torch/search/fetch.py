"""Fetch phase: hydrate winning doc ids into hits (a trimmed copy of the JAX
package's `search/fetch.py`: `filter_source`, `source_spec`, `build_hit`).

A hit carries `_index`, `_type`, `_id`, `_score`, `_shard` and `_source`,
the source whole, left out (`"_source": false`) or filtered by
includes/excludes patterns. Highlighting, stored and script fields,
`version` and sort values belong to later slices: `parse_search_body`
refuses the body keys that ask for them."""

from __future__ import annotations

import fnmatch
from typing import Any


def filter_source(source: dict, includes, excludes) -> dict:
    if not includes and not excludes:
        return source

    def walk(obj, path=""):
        if not isinstance(obj, dict):
            return obj
        out = {}
        for k, v in obj.items():
            p = f"{path}{k}"
            if isinstance(v, dict):
                sub = walk(v, p + ".")
                if (sub or _included(p, includes)) and not _excluded(p, excludes):
                    out[k] = sub
            elif _included(p, includes) and not _excluded(p, excludes):
                out[k] = v
        return out

    return walk(source)


def _included(path: str, includes) -> bool:
    if not includes:
        return True
    # a pattern naming an ancestor keeps the whole subtree; one naming a
    # descendant keeps walking through this node
    return any(fnmatch.fnmatch(path, pat) or pat.startswith(path + ".")
               or path.startswith(pat + ".") for pat in includes)


def _excluded(path: str, excludes) -> bool:
    return any(fnmatch.fnmatch(path, pat) for pat in (excludes or []))


def source_spec(body: dict):
    """The `_source` directive: bool / str / list / {includes, excludes} →
    (enabled, includes, excludes)."""
    spec = body.get("_source")
    if spec is None or spec is True:
        return True, [], []
    if spec is False:
        return False, [], []
    if isinstance(spec, str):
        return True, [spec], []
    if isinstance(spec, list):
        return True, spec, []

    def as_list(v):
        if v is None:
            return []
        return [v] if isinstance(v, str) else list(v)

    return True, as_list(spec.get("includes") or spec.get("include")), \
        as_list(spec.get("excludes") or spec.get("exclude"))


def build_hit(seg, local: int, score: float, body: dict,
              index_name: str = "index", shard_id: int | None = None) -> dict:
    hit: dict[str, Any] = {
        "_index": index_name,
        "_type": seg.types[local],
        "_id": seg.ids[local],
        "_score": None if score != score else score,  # NaN → null
    }
    if shard_id is not None:
        hit["_shard"] = shard_id
    enabled, includes, excludes = source_spec(body)
    if enabled and seg.stored[local] is not None:
        hit["_source"] = filter_source(seg.stored[local], includes, excludes)
    return hit
