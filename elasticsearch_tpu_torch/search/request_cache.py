"""Shard request cache: the fingerprint of a normalized request body and the
shard's point-in-time view → the shard's serialized query-phase partial (a
port of the JAX package's `search/request_cache.py`).

A hit in `actions._s_query_phase` returns the stored partial before
`execute_query_phase` runs: no launch on the card and no pull; only the
fetch of the global winners still runs.

- **Key** = (index, shard, searcher view version, fingerprint). The view
  version advances with every searcher the engine installs (a refresh with
  changes, a merge, an optimize, a recovery), so an entry never outlives the
  view it was computed on; it is unique in the process, so a query phase
  that outlives its engine (its index deleted or closed, then recreated or
  reopened) stores under a key no later view reads. The fingerprint hashes the body's canonical JSON
  (sorted keys, compact separators) without the execution knobs `profile`,
  `request_cache` and `timeout`.
- **Policy** (`cache_policy`): a body with `request_cache: true` always, one
  with `request_cache: false` never, any other only at `size: 0` (counts
  and aggregation-only bodies); `indices.requests.cache.enable: false`
  turns the cache off on the node.
- **Value** = the partial through the binary wire codec
  (common/stream.py): a hit hands back an isolated copy. Values of at least
  `indices.requests.cache.compress_min_bytes` (1 KB; negative: never) are
  deflated with zlib when that makes them smaller.
- **Accounting**: each stored entry's bytes (its value plus
  `ENTRY_OVERHEAD`) are charged on the node's `request` breaker until the
  entry leaves; a trip at store time skips the store (counted in
  `rejections`) and never fails the search. The LRU holds at most
  `indices.requests.cache.size` (a share of the breaker budget or a byte
  size; default 1%).
- **Invalidation**: the engine's view listeners call `invalidate_shard` on
  every searcher install (the view in the key already makes the old entries
  unreachable; dropping them returns their bytes), and a closing shard
  drops all of its entries.
- **Hot bodies**: each shard remembers the canonical bodies of its last
  `HOT_PER_SHARD` stored fingerprints with their hit counts; the warmer's
  re-prime replays the most hit against a new view (warmer.py), so the
  first sighting after a refresh is a hit.

`_lock` is a leaf: only dict and counter work happens under it; the
serialization, the deflate and inflate, and the breaker's release happen
outside it."""

from __future__ import annotations

import hashlib
import json
import threading
import zlib
from collections import OrderedDict

from ..common.errors import CircuitBreakingError
from ..common.settings import Settings
from ..common.units import parse_bytes, parse_ratio_or_bytes

# body keys that choose how a request runs, not what it computes
_VOLATILE_KEYS = ("profile", "request_cache", "timeout")


def canonical_body(body: dict | None) -> bytes:
    """Sorted-keys compact JSON of the body without the volatile knobs: what
    a fingerprint hashes and what the warmer replays (it parses back to a
    body with the same fingerprint)."""
    core = {k: v for k, v in (body or {}).items() if k not in _VOLATILE_KEYS}
    return json.dumps(core, sort_keys=True, separators=(",", ":"),
                      default=str).encode("utf-8")


def request_fingerprint(body: dict | None) -> str:
    """The 16-byte blake2b of `canonical_body`, in hex: bodies that differ
    only in key order or in the volatile knobs share it, any other
    difference (query, filter, from, size, sort, aggs, …) changes it."""
    return hashlib.blake2b(canonical_body(body), digest_size=16).hexdigest()


def cache_policy(body: dict | None) -> bool:
    """Whether a body may use the cache: `request_cache` when the body sets
    it, else only `size: 0`."""
    body = body or {}
    explicit = body.get("request_cache")
    if explicit is not None:
        return bool(explicit)
    try:
        return int(body.get("size", 10) or 0) == 0
    except (TypeError, ValueError):
        return False


class ShardRequestCache:
    """The node's LRU of serialized shard partials. Thread-safe; the counter
    attributes are plain ints."""

    # bookkeeping charged beside each value (the key tuple, the dict node)
    ENTRY_OVERHEAD = 256
    # stored fingerprints remembered per shard for the re-prime (their hit
    # counts survive a view's invalidation: the re-prime replays them
    # against the next view)
    HOT_PER_SHARD = 32

    def __init__(self, settings=None, breaker=None, total_budget: int = 8 << 30):
        settings = settings or Settings.EMPTY
        self.enabled = bool(settings.get_bool("indices.requests.cache.enable", True))
        self.size_bytes = int(parse_ratio_or_bytes(
            settings.get("indices.requests.cache.size"), int(total_budget),
            default="1%"))
        self.compress_min_bytes = parse_bytes(
            settings.get("indices.requests.cache.compress_min_bytes"), 1024)
        self.breaker = breaker
        self._lock = threading.Lock()
        # key -> (blob, charged bytes, raw length: > 0 for a deflated blob);
        # the insertion order is the LRU order
        self._entries: OrderedDict[tuple, tuple[bytes, int, int]] = OrderedDict()
        # (index, shard) -> its keys, so a shard's invalidation touches only
        # its own entries
        self._by_shard: dict[tuple, set] = {}
        # (index, shard) -> OrderedDict[fingerprint -> [hits, canonical body]]
        self._hot: dict[tuple, OrderedDict[str, list]] = {}
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.evictions = 0
        self.invalidations = 0
        self.rejections = 0  # stores skipped: a breaker trip or an oversized value
        self.compressions = 0
        # the resident deflated entries: their bytes and their raw length
        self._comp_bytes = 0
        self._comp_raw_bytes = 0

    # -- lookup --------------------------------------------------------------
    def get(self, key: tuple) -> bytes | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            hot = self._hot.get(key[:2])
            if hot is not None:
                h = hot.get(key[3])
                if h is not None:
                    h[0] += 1
                    hot.move_to_end(key[3])
            blob, _charged, raw_len = entry
        return zlib.decompress(blob) if raw_len else blob

    def peek(self, key: tuple) -> bool:
        """Presence, without counting a hit or a miss or touching the LRU."""
        with self._lock:
            return key in self._entries

    # -- store ---------------------------------------------------------------
    def put(self, key: tuple, data: bytes, body: dict | None = None) -> bool:
        """Store one serialized partial, charging the request breaker first;
        a trip or a value larger than the cache skips the store and counts
        a rejection. `body` (the live query phase passes it, the re-prime
        does not) enters the fingerprint in the shard's hot bodies. Returns
        whether it stored."""
        if body is not None:
            blob = canonical_body(body)
            with self._lock:
                hot = self._hot.setdefault(key[:2], OrderedDict())
                h = hot.get(key[3])
                if h is None:
                    hot[key[3]] = [0, blob]
                    while len(hot) > self.HOT_PER_SHARD:
                        hot.popitem(last=False)
                else:
                    h[1] = blob
                    hot.move_to_end(key[3])
        blob, raw_len = data, 0
        if 0 <= self.compress_min_bytes <= len(data):
            packed = zlib.compress(data, 1)
            if len(packed) < len(data):
                blob, raw_len = packed, len(data)
        size = len(blob) + self.ENTRY_OVERHEAD
        if size > self.size_bytes:
            with self._lock:
                self.rejections += 1
            return False
        if self.breaker is not None:
            try:
                self.breaker.add_estimate_and_maybe_break(size, "<request_cache>")
            except CircuitBreakingError:
                with self._lock:
                    self.rejections += 1
                return False
        released = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
                released += old[1]
                self._drop_comp_locked(old)
            self._entries[key] = (blob, size, raw_len)
            self._by_shard.setdefault(key[:2], set()).add(key)
            self._bytes += size
            if raw_len:
                self.compressions += 1
                self._comp_bytes += len(blob)
                self._comp_raw_bytes += raw_len
            while self._bytes > self.size_bytes and len(self._entries) > 1:
                k, dropped = self._entries.popitem(last=False)
                self._drop_index_locked(k)
                self._bytes -= dropped[1]
                released += dropped[1]
                self._drop_comp_locked(dropped)
                self.evictions += 1
            self.stores += 1
        if released and self.breaker is not None:
            self.breaker.release(released)
        return True

    # -- the re-prime's hot bodies -------------------------------------------
    def has_hot(self, index: str, shard_id: int) -> bool:
        """Whether the shard has a hot body that was hit at least once."""
        with self._lock:
            hot = self._hot.get((index, shard_id))
            return hot is not None and any(h[0] > 0 for h in hot.values())

    def hot_bodies(self, index: str, shard_id: int, n: int = 8) -> list[dict]:
        """The shard's `n` most hit bodies (hit at least once), parsed back
        from their canonical JSON."""
        with self._lock:
            hot = self._hot.get((index, shard_id))
            if not hot:
                return []
            ranked = sorted((h for h in hot.values() if h[0] > 0),
                            key=lambda h: -h[0])[:max(0, n)]
            blobs = [h[1] for h in ranked]
        return [json.loads(blob.decode("utf-8")) for blob in blobs]

    def _drop_comp_locked(self, entry: tuple) -> None:
        if entry[2]:
            self._comp_bytes -= len(entry[0])
            self._comp_raw_bytes -= entry[2]

    # -- invalidation --------------------------------------------------------
    def _drop_index_locked(self, key: tuple):
        keys = self._by_shard.get(key[:2])
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_shard[key[:2]]

    def invalidate_shard(self, index: str, shard_id: int,
                         current_view: int | None) -> int:
        """Drop the shard's entries of every view but `current_view` (None:
        every entry, and the shard's hot bodies: the shard is closing).
        Called by the engine's view listeners under the engine lock; returns
        the entries dropped."""
        released = 0
        dropped = 0
        with self._lock:
            if current_view is None:
                self._hot.pop((index, shard_id), None)
            for k in [k for k in self._by_shard.get((index, shard_id), ())
                      if current_view is None or k[2] != current_view]:
                entry = self._entries.pop(k)
                self._drop_index_locked(k)
                self._bytes -= entry[1]
                released += entry[1]
                self._drop_comp_locked(entry)
                dropped += 1
            self.invalidations += dropped
        if released and self.breaker is not None:
            self.breaker.release(released)
        return dropped

    def clear(self, index: str | None = None) -> int:
        """Drop every entry (or one index's); the breaker drains by exactly
        the released bytes. Returns the entries dropped."""
        released = 0
        dropped = 0
        with self._lock:
            for k in [k for k in self._entries if index is None or k[0] == index]:
                entry = self._entries.pop(k)
                self._drop_index_locked(k)
                self._bytes -= entry[1]
                released += entry[1]
                self._drop_comp_locked(entry)
                dropped += 1
        if released and self.breaker is not None:
            self.breaker.release(released)
        return dropped

    # -- observability -------------------------------------------------------
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return (self.hits / n) if n else 0.0

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "memory_size_in_bytes": self._bytes,
                "limit_size_in_bytes": self.size_bytes,
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "stores": self.stores,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "rejections": self.rejections,
                "hit_rate": round(self.hit_rate(), 4),
                "compressions": self.compressions,
                "compressed_bytes": self._comp_bytes,
                "compressed_raw_bytes": self._comp_raw_bytes,
                "compression_ratio": (
                    round(self._comp_bytes / self._comp_raw_bytes, 4)
                    if self._comp_raw_bytes else 1.0),
            }
