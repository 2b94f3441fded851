"""Device-resident packed postings in the quantized layout (a port of the JAX
package's `ops/device_index.py`: the pack, its coordination and ledger, the
compaction concat, the similarity LUTs and the lazy dense plane).

A frozen segment's CSR postings are re-blocked into fixed-shape tensors:

    blk_docs : int32 [NB, B]       — local doc ids, padded (and dead docs
                                     masked) with `doc_pad` (out of range)
    blk_tf   : uint8/int16/float32 — term frequencies, the narrowest exact
               [NB, B]               dtype (choose_tf_layout)
    blk_nb   : uint8 [NB, B]       — the posting's norm byte for the block's
                                     owning field, decoded in the scan

Each term owns a contiguous run of blocks, `term_blk_start[t] ..
term_blk_start[t+1]`, so a query term's postings are a slice of block rows.
Shapes are padded to power-of-two buckets. The dense fallback's f32 freqs
plane is uploaded lazily (`ensure_blk_freqs`) the first time a segment feeds
the dense path.

A segment's pack for a device lives in its `_device_cache` under
`pack_cache_key(device)`; `drop_segment_packs` takes a closing shard's
packs out. `packed_for` returns a resident, current pack
with one dict read and no lock; a cold pack or remask is coordinated by a
claimable per-segment, per-device Future (`begin_warm`, `run_warm`, the
warmer's half in `warmer.py`), and runs with no lock held: `_PACK_LOCK`
covers dict work and the publishing assignments only. Every pack is
recorded in the process-wide `PACK_LEDGER` with its kind and the pool that
ran it. A merged segment whose sources are resident and fully live is
packed by `pack_segment_concat`, which concatenates the sources' planes on
the device (`ops/scoring.concat_pack_planes`) instead of re-staging them
from the host.

`DeviceFilterCache` keeps hot filters' padded per-segment doc masks resident
on the device for the dense filtered family (`search/execute.py
_filter_mask_row`).

The aggregating launches read two more resident stores on the pack: the
per-doc metric folds of numeric columns (`ensure_agg_rows`, [F, 5, Dpad]
float32 stacks of `agg_doc_rows`) and each bucket agg's (doc, bucket) pairs
(`bucket_cols`, filled by `search/execute.py`); both are charged to the
fielddata breaker while they are built, as in the JAX package.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from itertools import repeat
from concurrent.futures import Future
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from ..common.breaker import reserve
from ..common.cudaenv import upload, upload_pinned
from ..common.devicehealth import tag_domain
from ..common.errors import CircuitBreakingError
from ..common.settings import Settings
from ..index.segment import FrozenSegment
from ..transport.faults import DEVICE_FAULTS

BLOCK = 128  # postings per block row

TFN_BM25 = 0  # tfn = f / (f + cache[norm_byte])  — weight multiplies outside
TFN_TFIDF = 1  # tfn = sqrt(f) * cache[norm_byte]

# tf-plane layout ladder: uint8 covers real-text term frequencies; int16 is
# the overflow rung; float32 the escape for non-integral or > 2^15-1 values
TF_U8, TF_I16, TF_F32 = "u8", "i16", "f32"
_TF_DTYPE = {TF_U8: np.uint8, TF_I16: np.int16, TF_F32: np.float32}


def _pow2_bucket(n: int, minimum: int = 128) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def expand_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Flatten half-open ranges [starts[i], starts[i]+counts[i]) into one int64
    array (the CSR expansion idiom: repeat + within-range offset)."""
    total = int(counts.sum())
    excl = np.zeros(len(counts), dtype=np.int64)
    if len(counts) > 1:
        np.cumsum(counts[:-1], out=excl[1:])
    within = np.arange(total, dtype=np.int64) - np.repeat(excl, counts)
    return np.repeat(np.asarray(starts, dtype=np.int64), counts) + within


def tf_plane_itemsize(layout: str) -> int:
    return np.dtype(_TF_DTYPE[layout]).itemsize


def _all_integral(post_freqs: np.ndarray) -> bool:
    """Whether every value is an integer, scanned in bounded chunks."""
    chunk = 1 << 20
    for i in range(0, len(post_freqs), chunk):
        c = post_freqs[i: i + chunk]
        if not np.all(c == np.floor(c)):
            return False
    return True


def tf_plane_integral(post_freqs: np.ndarray, layout: str) -> bool:
    """Whether a segment's raw tf values are all integers. The u8 and i16
    rungs are integral by construction; the f32 escape holds both huge
    integral tf and fractional tf, and only the former survives a merge
    exactly (merge_segments rebuilds tf as the position count), which is
    what gates the compaction concat."""
    return layout != TF_F32 or _all_integral(post_freqs)


def choose_tf_layout(post_freqs: np.ndarray) -> str:
    """The narrowest exact tf-plane dtype for a segment's raw frequencies."""
    if len(post_freqs) == 0:
        return TF_U8
    mx = float(post_freqs.max())
    if mx > 32767:
        return TF_F32
    if post_freqs.dtype.kind not in "iu" and not _all_integral(post_freqs):
        return TF_F32
    return TF_U8 if mx <= 255 else TF_I16


@dataclass
class SimTables:
    """Stacked per-field similarity decode state for the quantized scan: one
    256-entry f32 cache row and one TFN_* mode per field."""

    fields: list  # field order = fid
    fid: dict  # field -> row index
    modes: torch.Tensor  # int32 [F]
    caches: torch.Tensor  # float32 [F, 256]
    key: dict  # field -> (mode, cache bytes) — staleness fingerprint


@dataclass
class PackedSegment:
    """Device tensors + host lookup tables for one frozen segment on one device."""

    gen: int
    doc_count: int  # real docs
    doc_pad: int  # padded D (pow-2 bucket)
    device: torch.device
    blk_docs: torch.Tensor  # int32 [NBpad, B] — dead/non-parent docs masked to doc_pad
    blk_tf: torch.Tensor  # uint8/int16/float32 [NBpad, B]
    blk_nb: torch.Tensor  # uint8 [NBpad, B]
    tf_layout: str
    term_blk_start: np.ndarray  # host int64 [T+1]
    live_parent: torch.Tensor  # bool [Dpad] — live & parent (searchable docs)
    norm_bytes: dict  # field -> uint8 [Dpad] tensor
    host_docs: np.ndarray  # int32 [NBpad*B] raw (unmasked) doc ids, for re-masks
    host_freqs: np.ndarray  # float32 [NBpad*B], source of the lazy dense plane
    live_gen: int = 0  # the segment's tombstone generation the masks reflect
    # every raw tf is an integer (u8/i16 by construction; f32 checked): the
    # compaction concat needs it (merge_segments rebuilds tf from positions)
    tf_integral: bool = True
    sim: SimTables | None = None  # ensure_sim_tables state
    blk_freqs: torch.Tensor | None = None  # float32 [NBpad, B], dense path only
    # field -> host f32 [5, Dpad] folds (None: not f32-exact); agg_doc_rows
    agg_rows: dict = dc_field(default_factory=dict)
    # tuple of fields -> device f32 [F, 5, Dpad] stack (FIFO, _AGG_STACKS_MAX)
    agg_stacks: dict = dc_field(default_factory=dict)
    # bucket-agg cache key -> device (pair docs, pair buckets int64, count)
    bucket_cols: dict = dc_field(default_factory=dict)
    # ops/scoring.SparseScratchPool of the sparse launches' staging sets
    # (made at the first launch)
    sparse_scratch: object | None = None

    def blocks_for_term(self, tid: int) -> tuple[int, int]:
        return int(self.term_blk_start[tid]), int(self.term_blk_start[tid + 1])


def pack_shape_math(seg: FrozenSegment) -> tuple[int, int, str]:
    """(NBpad, Dpad, tf_layout): NBpad keeps at least one all-sentinel row past
    the real blocks — padding slots of a launch point at row NBpad-1."""
    counts = np.diff(seg.post_offsets)
    nblks = (counts + BLOCK - 1) // BLOCK
    NBpad = _pow2_bucket(int(nblks.sum()) + 1, 64)
    Dpad = _pow2_bucket(max(seg.doc_count, 1), 128)
    return NBpad, Dpad, choose_tf_layout(seg.post_freqs)


def _live_parent(seg: FrozenSegment, Dpad: int) -> np.ndarray:
    live_parent = np.zeros(Dpad, dtype=bool)
    live_parent[: seg.doc_count] = seg.live & seg.parent_mask
    return live_parent


def _norm_bytes(seg: FrozenSegment, Dpad: int, device) -> dict:
    """Each field's norm bytes as a padded uint8 [Dpad] tensor on `device`."""
    out = {}
    for f, arr in seg.norms.items():
        padded = np.zeros(Dpad, dtype=np.uint8)
        padded[: seg.doc_count] = arr
        out[f] = upload(padded, device)
    return out


def _mask_docs(host_docs: np.ndarray, live_parent: np.ndarray,
               Dpad: int) -> np.ndarray:
    """Dead/non-parent docs masked to the sentinel IN the postings, so the
    sparse scan needs no per-posting live gather."""
    return np.where(live_parent[np.minimum(host_docs, Dpad - 1)]
                    & (host_docs < Dpad), host_docs,
                    Dpad).astype(np.int32, copy=False)


def pack_segment(seg: FrozenSegment, device: torch.device) -> PackedSegment:
    """Pack a frozen segment's postings + norms for scoring on `device`."""
    T = len(seg.post_offsets) - 1
    counts = np.diff(seg.post_offsets)
    nblks = (counts + BLOCK - 1) // BLOCK
    blk_start = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(nblks, out=blk_start[1:])
    NB = int(blk_start[-1])
    NBpad, Dpad, tf_layout = pack_shape_math(seg)

    flat_docs = np.full(NBpad * BLOCK, Dpad, dtype=np.int32)
    flat_freqs = np.zeros(NBpad * BLOCK, dtype=np.float32)
    if len(seg.post_docs):
        # slot of entry j of term t = blk_start[t]*B + (j - post_offsets[t])
        slots = expand_ranges(blk_start[:-1] * BLOCK, counts)
        flat_docs[slots] = seg.post_docs
        flat_freqs[slots] = seg.post_freqs

    # block -> owning field ordinal (blocks never span terms, terms never span fields)
    field_names = list(seg.term_dict.keys())
    fid_of_tid = np.full(T, -1, dtype=np.int32)
    for fo, f in enumerate(field_names):
        tids = np.fromiter(seg.term_dict[f].values(), dtype=np.int64,
                           count=len(seg.term_dict[f]))
        fid_of_tid[tids] = fo
    blk_field = np.full(NBpad, -1, dtype=np.int32)
    if NB:
        blk_field[:NB] = np.repeat(fid_of_tid, nblks)

    live_gen = seg.live_gen
    live_parent = _live_parent(seg, Dpad)

    # per-posting norm byte of the block's owning field (norm-less meta
    # fields keep byte 0)
    flat_tf = flat_freqs.astype(_TF_DTYPE[tf_layout])
    flat_nb = np.zeros(NBpad * BLOCK, dtype=np.uint8)
    fid_per_slot = np.repeat(blk_field, BLOCK)
    real = flat_docs < seg.doc_count
    for fo, fname in enumerate(field_names):
        norms = seg.norms.get(fname)
        if norms is None:
            continue
        sel = (fid_per_slot == fo) & real
        if sel.any():
            flat_nb[sel] = norms[flat_docs[sel]]

    return PackedSegment(
        gen=seg.gen,
        doc_count=seg.doc_count,
        doc_pad=Dpad,
        device=device,
        blk_docs=upload(_mask_docs(flat_docs, live_parent, Dpad)
                        .reshape(NBpad, BLOCK), device),
        blk_tf=upload(flat_tf.reshape(NBpad, BLOCK), device),
        blk_nb=upload(flat_nb.reshape(NBpad, BLOCK), device),
        tf_layout=tf_layout,
        term_blk_start=blk_start,
        live_parent=upload(live_parent, device),
        norm_bytes=_norm_bytes(seg, Dpad, device),
        host_docs=flat_docs,
        host_freqs=flat_freqs,
        live_gen=live_gen,
        tf_integral=tf_plane_integral(seg.post_freqs, tf_layout),
    )


def packed_resident_bytes(packed: PackedSegment) -> int:
    """Device-resident postings-plane bytes: docs + tf + nb, plus the dense
    f32 plane once it has been faulted in."""
    return sum(t.numel() * t.element_size()
               for t in (packed.blk_docs, packed.blk_tf, packed.blk_nb,
                         packed.blk_freqs) if t is not None)


def pack_estimate_bytes(seg: FrozenSegment) -> int:
    """Host staging + device bytes pack_segment allocates, the estimate the
    fielddata breaker checks before packing: per slot the host docs i32,
    freqs f32, tf and nb staging plus the device docs, tf and nb planes and
    a 12 B allowance for the masking temporaries; per padded doc the live
    mask (host and device) and each field's norm byte."""
    NBpad, Dpad, layout = pack_shape_math(seg)
    tf_b = tf_plane_itemsize(layout)
    per_slot = (4 + 4 + tf_b + 1) + (4 + tf_b + 1) + 12
    return NBpad * BLOCK * per_slot + Dpad * 2 + Dpad * len(seg.norms)


def _pool_label() -> str:
    """Which named thread pool runs the current thread, the ledger's pack
    attribution: pool workers are named "estpu_torch[<pool>]_N"
    (threadpool._BoundedPool), the batcher's drainer
    "estpu_torch[search_batcher]"; any other thread (a test's main thread, a
    raw Thread) reads as "other"."""
    name = threading.current_thread().name
    prefix = "estpu_torch["
    if name.startswith(prefix) and "]" in name:
        return name[len(prefix): name.index("]")]
    return "other"


# the ledger's kinds: "pack" (a segment's first full pack), "delta_pack" (a
# refresh's new segment beside resident ones: bounded by the buffer, not the
# index), "remask" (a tombstone view's live-mask refresh), "compact" (a
# merged segment's pack: concatenated on the device from the sources'
# resident planes when eligible, re-staged from the host otherwise; the
# event's `method` says which)
PACK_KINDS = ("pack", "delta_pack", "remask", "compact")
_KIND_COUNTER = {"pack": "packs", "delta_pack": "delta_packs",
                 "remask": "remasks", "compact": "compacts"}


class PackLedger:
    """Process-wide record of every pack, keyed by index (the JAX package's
    `PackLedger`): each pack's wall time, resident bytes, tf layout, kind
    (PACK_KINDS), the pool whose thread did the work (`pool`: "warmer",
    "merge", "search", "other"; what says whether a pack ran on the query
    path) and, for a compaction, its `method` ("concat" or "staged").
    Bounded: at most MAX_INDICES indices (least recently used leave), each
    with cumulative counters and a ring of its RING latest events. `_lock`
    is a leaf (dict work only); recording happens on the cold pack path."""

    MAX_INDICES = 256
    RING = 16

    def __init__(self):
        self._lock = threading.Lock()
        self._by_index: OrderedDict[str, dict] = OrderedDict()

    def record(self, index: str | None, gen: int, ms: float, nbytes: int,
               layout: str, kind: str = "pack", pool: str | None = None,
               method: str | None = None) -> None:
        index = index or "_unattributed"
        pool = pool or _pool_label()
        with self._lock:
            entry = self._by_index.get(index)
            if entry is None:
                entry = {"packs": 0, "delta_packs": 0, "remasks": 0,
                         "compacts": 0, "pack_ms_total": 0.0,
                         "pools": {}, "recent": []}
                self._by_index[index] = entry
                while len(self._by_index) > self.MAX_INDICES:
                    self._by_index.popitem(last=False)
            else:
                self._by_index.move_to_end(index)
            entry[_KIND_COUNTER.get(kind, "packs")] += 1
            entry["pack_ms_total"] += ms
            pools = entry["pools"]
            pools[pool] = pools.get(pool, 0) + 1
            event = {"kind": kind, "generation": int(gen), "ms": round(ms, 3),
                     "bytes": int(nbytes), "tf_layout": layout, "pool": pool}
            if method is not None:
                event["method"] = method
            recent = entry["recent"]
            recent.append(event)
            if len(recent) > self.RING:
                del recent[: len(recent) - self.RING]

    def forget(self, index: str) -> None:
        """Drop an index's entry (a deleted index; a caller opening a fresh
        window of observation)."""
        with self._lock:
            self._by_index.pop(index, None)

    @staticmethod
    def _row(e: dict) -> dict:
        return {"packs": e["packs"], "delta_packs": e["delta_packs"],
                "remasks": e["remasks"], "compacts": e["compacts"],
                "pack_ms_total": round(e["pack_ms_total"], 3),
                "pools": dict(e["pools"]), "recent": list(e["recent"])}

    def stats(self, index: str | None = None) -> dict:
        with self._lock:
            if index is not None:
                e = self._by_index.get(index)
                return {} if e is None else self._row(e)
            return {idx: self._row(e) for idx, e in self._by_index.items()}


PACK_LEDGER = PackLedger()


# ---------------------------------------------------------------------------
# pack coordination: claimable per-segment, per-device futures
# ---------------------------------------------------------------------------

# a LEAF lock over `_device_cache` dict work and the publishing assignments
# only: no pack, remask, upload or Future wait runs under it, and the warmed
# fast path (a resident, current pack) never takes it
_PACK_LOCK = threading.Lock()
# swaps of a pack's similarity tables that replaced a field's LUT (BM25
# avgdl drift after a write, or a DFS request's index-wide statistics
# against the shard's own), counted under _PACK_LOCK
SIM_SWAPS = {"changed": 0}


_PACK = "packed"


def pack_cache_key(device: torch.device) -> tuple:
    """The key of a segment's pack for `device` in its `_device_cache`."""
    return (_PACK, str(device))


def drop_segment_packs(segs) -> None:
    """Take every device's pack out of `segs`' caches (a closing shard's
    segments), so its engine reaches no pack; a search still holding a
    view keeps its own references until it ends."""
    with _PACK_LOCK:
        for seg in segs:
            for key in [k for k in list(seg._device_cache)
                        if isinstance(k, tuple) and k[:1] == (_PACK,)]:
                seg._device_cache.pop(key, None)


def pack_future_keys(device: torch.device) -> tuple[tuple, tuple]:
    """The keys of the in-flight pack's Future and of its claim flag for
    `device` (per device, as the pack is; per view: `with_deletes` drops
    them)."""
    return ("pack_future", str(device)), ("pack_claimed", str(device))


def _current(seg: FrozenSegment, packed: PackedSegment | None) -> bool:
    return packed is not None and packed.live_gen == seg.live_gen


def begin_warm(seg: FrozenSegment, device: torch.device) -> Future | None:
    """Install the in-flight marker for a pack (or remask) about to be
    scheduled off the query path. Returns the Future a racing search waits
    on, or None when the pack is resident and current or another is in
    flight. Dict work only: safe from an engine view listener, which runs
    under the engine lock.

    The marker is claimable: whoever claims it first packs — normally the
    scheduled warmer or merge task, but a search arriving before the task
    starts steals the work and packs inline, resolving the same future. So
    a wait is only ever on a pack that is running on some thread, which
    ends without needing a pool slot: no waiter deadlocks behind pack work
    queued on its own pool."""
    cache = seg._device_cache
    fkey, ckey = pack_future_keys(device)
    with _PACK_LOCK:
        if _current(seg, cache.get(pack_cache_key(device))) \
                or cache.get(fkey) is not None:
            return None
        fut: Future = Future()
        cache[fkey] = fut
        cache[ckey] = False
        return fut


def cancel_warm(seg: FrozenSegment, device: torch.device, fut: Future) -> None:
    """Withdraw a begin_warm future whose submission the pool rejected:
    clear the marker and resolve the future with None, so a racer already
    waiting loops and packs inline. A no-op once a racer claimed the work
    (the claimant owns the future then)."""
    cache = seg._device_cache
    fkey, ckey = pack_future_keys(device)
    with _PACK_LOCK:
        if cache.get(fkey) is not fut or cache.get(ckey):
            return
        cache.pop(fkey, None)
        cache.pop(ckey, None)
    if not fut.done():
        fut.set_result(None)


def run_warm(seg: FrozenSegment, device: torch.device, fut: Future,
             breaker=None, owner: str | None = None) -> PackedSegment | None:
    """The warmer or merge pool's body for a begin_warm future: claim it and
    pack. Returns None at once when a racing search claimed it first (that
    search resolves the future on its own thread). A failure resolves the
    future with the exception, so waiters fail as an inline pack would,
    clears the marker, so a later search retries inline, and raises."""
    cache = seg._device_cache
    fkey, ckey = pack_future_keys(device)
    with _PACK_LOCK:
        if cache.get(fkey) is not fut or cache.get(ckey):
            return None
        cache[ckey] = True
    return _perform_pack(seg, device, fut, breaker, owner)


def _perform_pack(seg: FrozenSegment, device: torch.device, fut: Future,
                  breaker, owner: str | None) -> PackedSegment:
    """Pack (full, delta or compaction) or remask one segment for `device`
    with no lock held, publish under the leaf lock and resolve `fut`, which
    the caller claimed."""
    cache = seg._device_cache
    key = pack_cache_key(device)
    fkey, ckey = pack_future_keys(device)
    try:
        # the seeded device-error seam (transport/faults.DEVICE_FAULTS): one
        # attribute read disarmed; armed, the pack fails here, before any
        # publish, so no half-packed segment lands in the cache
        if DEVICE_FAULTS.active:
            DEVICE_FAULTS.check(f"pack:{owner}")
        t0 = time.monotonic()
        packed: PackedSegment | None = cache.get(key)
        if packed is None:
            hint = cache.get("pack_hint") or {}
            kind = hint.get("kind", "pack")
            sources = hint.get("sources")
            new = None
            method = "staged" if kind == "compact" else None
            if kind == "compact" and sources:
                with reserve(breaker, concat_estimate_bytes(seg, sources),
                             f"<segment_compact>[{seg.gen}]"):
                    new = pack_segment_concat(seg, sources, device)
                if new is not None:
                    method = "concat"
            if new is None:
                with reserve(breaker, pack_estimate_bytes(seg),
                             f"<segment_pack>[{seg.gen}]"):
                    new = pack_segment(seg, device)
            with _PACK_LOCK:
                cache[key] = new
                cache.pop(fkey, None)
                cache.pop(ckey, None)
                cache.pop("pack_hint", None)  # drops the sources' refs
            PACK_LEDGER.record(owner, seg.gen, (time.monotonic() - t0) * 1e3,
                               packed_resident_bytes(new), new.tf_layout,
                               kind=kind, method=method)
            fut.set_result(new)
            return new
        # remask: the pack is resident but this view's tombstones moved.
        # The postings carry the live mask inline (the sparse scan has no
        # per-posting live gather): re-mask from the raw host copy
        live_gen = seg.live_gen
        live_parent = _live_parent(seg, packed.doc_pad)
        docs = upload(_mask_docs(packed.host_docs, live_parent, packed.doc_pad)
                      .reshape(-1, BLOCK), device)
        lp = upload(live_parent, device)
        with _PACK_LOCK:
            packed.blk_docs = docs
            packed.live_parent = lp
            packed.live_gen = live_gen  # last: a lock-free reader that sees
            cache.pop(fkey, None)       # the gen sees the planes
            cache.pop(ckey, None)
        PACK_LEDGER.record(owner, seg.gen, (time.monotonic() - t0) * 1e3,
                           packed_resident_bytes(packed), packed.tf_layout,
                           kind="remask")
        fut.set_result(packed)
        return packed
    except BaseException as e:  # noqa: BLE001 — waiters must never hang
        if isinstance(e, Exception):
            tag_domain(e, f"pack:{owner}")  # the fault domain's attribution
        with _PACK_LOCK:
            if cache.get(fkey) is fut:
                cache.pop(fkey, None)
                cache.pop(ckey, None)
        fut.set_exception(e)
        raise


def packed_for(seg: FrozenSegment, device: torch.device, breaker=None,
               owner: str | None = None) -> PackedSegment:
    """The segment's pack on `device`, re-masked when its tombstones moved.

    A resident, current pack is one dict read, with no lock. Otherwise the
    call coordinates through the segment's in-flight Future for `device`: it
    claims and packs inline when no pack is in flight or when a scheduled
    warm pack has not started yet (a steal), and waits, with no lock held,
    only for a pack another thread is running. In the warmed loop every
    query-path call is a hit and the warmer and merge pools do all the
    packing (PACK_LEDGER's pools say so).

    `breaker` (the node's fielddata child; None unwired) is charged only by
    the call that packs, with the pack's estimate, while it runs; a trip
    raises CircuitBreakingError, and a failed pack another thread ran
    raises here too (later calls retry). `owner` (the index name) goes to
    the ledger. Uploads never synchronise, so this is safe inside a
    dispatch."""
    cache = seg._device_cache
    key = pack_cache_key(device)
    packed = cache.get(key)
    if _current(seg, packed):
        return packed
    fkey, ckey = pack_future_keys(device)
    while True:
        with _PACK_LOCK:
            packed = cache.get(key)
            if _current(seg, packed):
                return packed
            fut = cache.get(fkey)
            own = True
            if fut is None:
                fut = Future()
                cache[fkey] = fut
                cache[ckey] = True
            elif not cache.get(ckey):
                cache[ckey] = True  # steal a scheduled pack not started yet
            else:
                own = False
        if own:
            return _perform_pack(seg, device, fut, breaker, owner)
        fut.result()  # a pack running on another thread: wait, no lock held
        with _PACK_LOCK:
            # a resolved future is never waited on twice
            if cache.get(fkey) is fut:
                cache.pop(fkey, None)
                cache.pop(ckey, None)


def ensure_blk_freqs(packed: PackedSegment, breaker=None) -> torch.Tensor:
    """Fault in the dense-fallback f32 freqs plane (sparse-only segments
    never pay its 4 B/posting), its bytes reserved on `breaker` (fielddata)
    around the upload. The upload runs with no lock held; the first plane
    published under the pack lock wins, so every caller gets the same
    tensor (two racing callers may both upload: the loser's copy is
    dropped)."""
    plane = packed.blk_freqs
    if plane is not None:
        return plane
    with reserve(breaker, packed.host_freqs.nbytes, "<dense_freqs>"):
        plane = upload(packed.host_freqs.reshape(-1, BLOCK), packed.device)
    with _PACK_LOCK:
        if packed.blk_freqs is None:
            packed.blk_freqs = plane
        return packed.blk_freqs


# ---------------------------------------------------------------------------
# compaction: a merged segment's pack from its sources' resident planes
# ---------------------------------------------------------------------------

# per-slot allowance for the concat program's device temporaries (the
# gather index, selects and gathered values alive at its peak)
CONCAT_TRANSIENT_SLOT_BYTES = 8

_TF_RANK = {TF_U8: 0, TF_I16: 1, TF_F32: 2}


def concat_source_packs(sources, device: torch.device) -> list | None:
    """The sources' packs on `device` when the compaction concat is legal,
    else None (the caller re-stages with pack_segment):

    - every source fully live (merge_segments drops a tombstoned source's
      postings, which breaks the posting-for-posting alignment) with its
      pack resident and current (no remask pending);
    - every source's tf integral (a merge rebuilds tf as the position
      count: a fractional f32 tf would not come back bitwise)."""
    key = pack_cache_key(device)
    packs = []
    for src in sources:
        packed = src._device_cache.get(key)
        if not _current(src, packed) or not bool(src.live.all()) \
                or not packed.tf_integral:
            return None
        packs.append(packed)
    return packs


def concat_estimate_bytes(merged: FrozenSegment, sources) -> int:
    """Host staging plus device bytes pack_segment_concat allocates, the
    fielddata breaker's estimate for a compaction, exact for the concat
    layout as pack_estimate_bytes is for the staged one: per slot the
    retained host docs and freqs, the device docs, tf and nb planes and the
    program's temporaries; the blk_term and blk_j0 rows and the [W+1, T]
    and [W, T] tables (host and device); per padded doc the live mask, each
    norm byte and 8 B a numeric column."""
    NBpad, Dpad, layout = pack_shape_math(merged)
    tf_b = tf_plane_itemsize(layout)
    W = len(sources)
    T = len(merged.post_offsets) - 1
    per_slot = (4 + 4) + (4 + tf_b + 1) + CONCAT_TRANSIENT_SLOT_BYTES
    return (NBpad * BLOCK * per_slot + NBpad * 4 * 2
            + (2 * W + 1) * T * 4 * 2 + Dpad * 2
            + Dpad * len(merged.norms) + Dpad * 8 * len(merged.dv_num))


def concat_tables(merged: FrozenSegment, sources, packs) -> tuple | None:
    """The concat program's host inputs: per merged term and source the
    posting count and the source's first block (`cnt`, `starts`, [W, T]),
    their cumulative counts over sources (`cum`, [W+1, T]), each merged
    block's term and first within-term posting (`blk_term`, `blk_j0`,
    [NBpad]; pad rows get an offset no source holds) and the merged
    `term_blk_start`. Terms resolve by name, a field at a time. None when
    the per-term counts disagree with the merged CSR."""
    NBpad, _Dpad, _layout = pack_shape_math(merged)
    T = len(merged.post_offsets) - 1
    counts_m = np.diff(merged.post_offsets)
    W = len(sources)
    cnt = np.zeros((W, T), dtype=np.int32)
    starts = np.zeros((W, T), dtype=np.int32)
    src_counts = [np.diff(src.post_offsets) for src in sources]
    for f, td_m in merged.term_dict.items():
        tids_m = np.fromiter(td_m.values(), dtype=np.int64, count=len(td_m))
        for s, (src, packed) in enumerate(zip(sources, packs)):
            td_s = src.term_dict.get(f)
            if not td_s:
                continue
            tids_s = np.fromiter(map(td_s.get, td_m, repeat(-1)), dtype=np.int64,
                                 count=len(td_m))
            hit = tids_s >= 0
            cnt[s, tids_m[hit]] = src_counts[s][tids_s[hit]]
            starts[s, tids_m[hit]] = packed.term_blk_start[tids_s[hit]]
    cum = np.zeros((W + 1, T), dtype=np.int32)
    np.cumsum(cnt, axis=0, out=cum[1:])
    if not np.array_equal(cum[-1], counts_m):
        return None
    nblks = (counts_m + BLOCK - 1) // BLOCK
    blk_start = np.zeros(T + 1, dtype=np.int64)
    np.cumsum(nblks, out=blk_start[1:])
    NB = int(blk_start[-1])
    blk_term = np.zeros(NBpad, dtype=np.int32)
    # pad rows: an offset past every source's count, so no select takes
    # them and they keep the sentinel and zero the staged pack writes
    blk_j0 = np.full(NBpad, 1 << 30, dtype=np.int32)
    if NB:
        blk_term[:NB] = np.repeat(np.arange(T, dtype=np.int32), nblks)
        blk_j0[:NB] = ((np.arange(NB, dtype=np.int64)
                        - np.repeat(blk_start[:-1], nblks)) * BLOCK).astype(np.int32)
    return blk_term, blk_j0, cum, starts, blk_start


def pack_segment_concat(merged: FrozenSegment, sources,
                        device: torch.device) -> PackedSegment | None:
    """A merged segment's pack on `device`, assembled by concatenating its
    sources' resident planes (one gather/select program,
    ops/scoring.concat_pack_planes, tf widened along the choose_tf_layout
    ladder) instead of re-staging its postings from the host: the upload is
    the O(NB + W·T + D) tables and columns, not the O(postings) planes.
    Legal only when the merge kept every posting in source order; the
    result equals pack_segment(merged, device) field by field. None when
    ineligible: a source tombstoned, not resident or not current, a
    fractional f32 tf, dropped docs, tf-layout drift, or per-term counts
    that disagree with the merged CSR (the caller re-stages)."""
    from .scoring import concat_pack_planes

    packs = concat_source_packs(sources, device)
    if packs is None or not len(merged.post_docs):
        return None
    if merged.doc_count != sum(s.doc_count for s in sources):
        return None  # docs were dropped: source order is not merged order
    NBpad, Dpad, layout = pack_shape_math(merged)
    widest = max((p.tf_layout for p in packs), key=_TF_RANK.__getitem__)
    if layout != widest:
        return None  # the tf drifted between the sources and the merged CSR
    live_gen = merged.live_gen
    tables = concat_tables(merged, sources, packs)
    if tables is None:
        return None
    blk_term, blk_j0, cum, starts, blk_start = tables
    bases = np.cumsum([0] + [s.doc_count for s in sources[:-1]]).astype(np.int32)
    doc_pads = np.asarray([p.doc_pad for p in packs], dtype=np.int32)
    out_docs, out_tf, out_nb = concat_pack_planes(
        upload(blk_term, device), upload(blk_j0, device), upload(cum, device),
        upload(starts, device), upload(bases, device), upload(doc_pads, device),
        [p.blk_docs for p in packs], [p.blk_tf for p in packs],
        [p.blk_nb for p in packs], doc_pad_new=Dpad, tf_layout=layout)

    # the retained host copies (remasks, the lazy dense plane): host only
    flat_docs = np.full(NBpad * BLOCK, Dpad, dtype=np.int32)
    flat_freqs = np.zeros(NBpad * BLOCK, dtype=np.float32)
    slots = expand_ranges(blk_start[:-1] * BLOCK, np.diff(merged.post_offsets))
    flat_docs[slots] = merged.post_docs
    flat_freqs[slots] = merged.post_freqs
    return PackedSegment(
        gen=merged.gen,
        doc_count=merged.doc_count,
        doc_pad=Dpad,
        device=device,
        blk_docs=out_docs,
        blk_tf=out_tf,
        blk_nb=out_nb,
        tf_layout=layout,
        term_blk_start=blk_start,
        live_parent=upload(_live_parent(merged, Dpad), device),
        norm_bytes=_norm_bytes(merged, Dpad, device),
        host_docs=flat_docs,
        host_freqs=flat_freqs,
        live_gen=live_gen,
        tf_integral=True,  # every source's tf is integral
    )


def tfn_values(freqs: np.ndarray, nb: np.ndarray, cache: np.ndarray,
               mode: int) -> np.ndarray:
    """The per-posting tfn formula on the host — what the quantized scan
    computes on the device, f32 op order included."""
    cv = cache[nb]
    if mode == TFN_BM25:
        return (freqs / (freqs + cv)).astype(np.float32)
    return np.sqrt(freqs, dtype=np.float32) * cv


def ensure_sim_tables(packed: PackedSegment,
                      tables: dict[str, tuple[int, np.ndarray]]) -> SimTables:
    """Ensure the stacked per-field similarity LUTs for `tables` ({field:
    (TFN_* mode, float32[256] cache)}) and return the SimTables whose `fid`
    maps fields to cache rows for this launch. A changed cache (BM25 avgdl
    drift) swaps a 1 KB/field table, never the postings. Fields accumulate
    across calls; a re-ensure swaps packed.sim and never mutates an existing
    SimTables, so a dispatch in flight keeps the one it resolved its fids
    against. The swap is a compare-and-swap of packed.sim: the merged
    tables are built and uploaded with no lock held, then published under
    the pack lock only if packed.sim is still the one they were merged
    from (else the merge reruns), so two dispatching threads never drop
    each other's fields."""
    while True:
        cur = packed.sim
        if _sim_current(cur, tables):
            return cur
        merged = _merged_sim(packed, cur, tables)
        with _PACK_LOCK:
            if packed.sim is cur:
                packed.sim = merged
                if cur is not None and any(
                        f in cur.key and cur.key[f] != merged.key[f] for f in tables):
                    SIM_SWAPS["changed"] += 1
                return merged


def _sim_current(cur: SimTables | None, tables: dict) -> bool:
    return cur is not None and all(
        f in cur.key and cur.key[f] == (mode, cache.tobytes())
        for f, (mode, cache) in tables.items())


def _merged_sim(packed: PackedSegment, cur: SimTables | None,
                tables: dict) -> SimTables:
    merged = dict(cur.key) if cur is not None else {}
    for f, (mode, cache) in tables.items():
        merged[f] = (mode, cache.tobytes())
    fields = list(merged.keys())
    if fields:
        modes = np.array([merged[f][0] for f in fields], dtype=np.int32)
        caches = np.stack([np.frombuffer(merged[f][1], dtype=np.float32)
                           for f in fields])
    else:
        # fieldless batch (e.g. an empty analyzed query): one neutral row so
        # the kernel keeps its [F, 256] shape — only padding slots read it
        modes = np.zeros(1, dtype=np.int32)
        caches = np.ones((1, 256), dtype=np.float32)
    return SimTables(fields=fields, fid={f: i for i, f in enumerate(fields)},
                     modes=upload(modes, packed.device),
                     caches=upload(caches, packed.device), key=merged)


# ---------------------------------------------------------------------------
# per-doc metric folds for the aggregating launches
# ---------------------------------------------------------------------------

_AGG_STACKS_MAX = 8  # device stacks kept per pack (distinct field tuples)
_AGG_LOCK = threading.Lock()  # the pack's agg dicts (no device work under it)


def agg_doc_rows(seg: FrozenSegment, field: str) -> np.ndarray | None:
    """Per-doc metric folds of one numeric column: float32 [5, doc_count]
    rows (count, sum, min, max, sumsq), or None when the column is
    INTEGER-valued but not exactly float32-representable (longs and dates
    past 2^24 stay on the exact host collectors); a fractional column is an
    approximate real and takes the float32 launch. Multi-valued docs fold
    exactly (cumsum difference and reduceat over the CSR); a doc without a
    value has count 0 and ±inf min/max, which the masked reductions skip."""
    D = seg.doc_count
    rows = np.zeros((5, D), dtype=np.float32)
    rows[2] = np.inf
    rows[3] = -np.inf
    col = seg.dv_num.get(field)
    if col is None:
        return rows
    off, vals = col
    if len(vals) and not np.array_equal(
            vals.astype(np.float32).astype(np.float64), vals) \
            and np.all(vals == np.floor(vals)):
        return None
    counts = np.diff(off)
    c = np.zeros(len(vals) + 1)
    np.cumsum(vals, out=c[1:])
    sums = c[off[1:]] - c[off[:-1]]
    c2 = np.zeros(len(vals) + 1)
    np.cumsum(np.asarray(vals, dtype=np.float64) ** 2, out=c2[1:])
    sumsq = c2[off[1:]] - c2[off[:-1]]
    has = counts > 0
    if len(vals):
        # reduceat over the value-holding docs' own start offsets, so a run
        # never absorbs the next docs' (empty) runs
        starts = off[:-1][has]
        rows[2][has] = np.minimum.reduceat(vals, starts)
        rows[3][has] = np.maximum.reduceat(vals, starts)
    rows[0] = counts
    rows[1] = sums
    rows[4] = sumsq
    return rows


def _pad_agg_rows(rows: np.ndarray, doc_pad: int) -> np.ndarray:
    """[5, D] rows in a [5, doc_pad] canvas (padding: count 0, ±inf)."""
    out = np.zeros((5, doc_pad), dtype=np.float32)
    out[2] = np.inf
    out[3] = -np.inf
    out[:, : rows.shape[1]] = rows
    return out


def ensure_agg_rows(seg: FrozenSegment, packed: PackedSegment, fields,
                    breaker=None) -> torch.Tensor | None:
    """The resident [F, 5, Dpad] float32 stack of `fields` on the pack's
    device, or None when a column is not f32-exact (the host collectors
    serve the request). Per-field rows cache on the host; the device stacks,
    one per field tuple, are FIFO-bounded. `breaker` (fielddata) holds the
    stack's bytes (host rows and device copy) while it is built. The upload
    is a pinned, non-blocking copy; the dicts are published under a lock
    that covers no device work."""
    key = tuple(fields)
    stack = packed.agg_stacks.get(key)
    if stack is not None:
        return stack
    est = len(key) * 5 * packed.doc_pad * 4 * 2
    with reserve(breaker, est, f"<agg_rows>{list(key)}"):
        rows = {}
        for f in key:
            r = packed.agg_rows.get(f, False)
            if r is False:
                folds = agg_doc_rows(seg, f)
                r = None if folds is None else _pad_agg_rows(folds, packed.doc_pad)
                with _AGG_LOCK:
                    packed.agg_rows[f] = r
            if r is None:
                return None
            rows[f] = r
        stack = upload_pinned(np.stack([rows[f] for f in key]) if key else
                              np.zeros((0, 5, packed.doc_pad), np.float32),
                              packed.device)
    with _AGG_LOCK:
        while len(packed.agg_stacks) >= _AGG_STACKS_MAX:
            packed.agg_stacks.pop(next(iter(packed.agg_stacks)), None)
        packed.agg_stacks[key] = stack
    return stack


# ---------------------------------------------------------------------------
# device-resident filter masks
# ---------------------------------------------------------------------------


def filter_masks_key(device: torch.device) -> tuple:
    """The key of a segment's filter-mask holder for `device` in its
    `_device_cache` (the port's own key, beside its pack's)."""
    return ("filter_masks", str(device))


class _SegmentFilterMasks:
    """Per-segment holder of device-resident filter masks, in
    `seg._device_cache[filter_masks_key(device)]`. A tombstone view
    (`FrozenSegment.with_deletes`) copies the device cache shallowly, so the
    views of one segment SHARE this holder — eviction therefore asks whether
    the holder is still referenced by a live segment, not whether the
    segment object is. Filter masks do not depend on liveness (filters gate
    matching; liveness is the dense core's separate live_parent gate), so
    sharing them across tombstone views is exact."""

    __slots__ = ("masks", "seen", "bytes", "dead")

    def __init__(self):
        self.masks: dict = {}  # filter key -> (device bool [Dpad], nbytes)
        self.seen: dict = {}  # filter key -> sighting count
        self.bytes = 0
        self.dead = False  # evicted with its segment: never stores again


class DeviceFilterCache:
    """Node-level accounting and policy for per-segment device filter masks
    (the JAX package's `DeviceFilterCache`).

    Hot filters keep their padded per-segment doc masks resident on the
    device, keyed by (segment, `Filter.key()`), so a filtered plan that hits
    skips the host mask evaluation and its host→device copy; the dense core
    reads the resident row and scores bitwise as it would with the host's
    mask (the mask VALUES are identical). Population is by sightings: a
    filter's first evaluation on a segment only counts it; the
    `indices.filter_cache.min_sightings`-th (default 2nd) builds the padded
    row on the host outside any lock, uploads it once from pinned memory
    (no synchronisation), charges the fielddata breaker and publishes it
    under the leaf lock. Masks leave with their segment when an engine view
    drops it (`evict_dropped`, hung off the engine's view listeners) or by
    `clear_segment`, and release their breaker bytes.
    `indices.filter_cache.enable: false` turns the cache off.

    `_lock` is a leaf guarding dicts and counters only: no mask is built,
    uploaded or released to the breaker under it."""

    def __init__(self, settings=None, breaker=None):
        settings = settings or Settings.EMPTY
        self.enabled = bool(
            settings.get_bool("indices.filter_cache.enable", True))
        self.min_sightings = max(1, int(
            settings.get_int("indices.filter_cache.min_sightings", 2)))
        self.breaker = breaker
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self.evictions = 0
        self.rejections = 0  # breaker-tripped stores
        self._bytes = 0
        self._masks = 0
        self._devices: set = set()  # every device a holder was made for

    def _holder(self, seg, device) -> _SegmentFilterMasks:
        key = filter_masks_key(device)
        holder = seg._device_cache.get(key)
        if holder is None:
            with self._lock:
                self._devices.add(str(device))
            # benign setdefault race: both racers publish an empty holder,
            # one wins, neither has accounted bytes yet
            holder = seg._device_cache.setdefault(key, _SegmentFilterMasks())
        return holder

    def lookup(self, seg, key: str, device):
        """The resident row on `device` for (segment, filter key), or None.
        A miss counts a sighting, which is what promotes the filter."""
        holder = self._holder(seg, device)
        with self._lock:
            entry = holder.masks.get(key)
            if entry is not None:
                self.hits += 1
            else:
                self.misses += 1
                holder.seen[key] = holder.seen.get(key, 0) + 1
        return entry[0] if entry is not None else None

    def maybe_store(self, seg, key: str, padded_mask: np.ndarray, device):
        """Promote a freshly evaluated mask (the host bool [Dpad] row, built
        outside any lock) once it has reached `min_sightings`: charge the
        breaker, upload it (outside the leaf lock), publish under it.
        Returns the device row (this one or a concurrent winner's), or None
        while the filter is cold, the cache is off or the breaker trips."""
        if not self.enabled:
            return None
        holder = self._holder(seg, device)
        with self._lock:
            if holder.dead:
                return None  # segment evicted: a stale searcher must not
                # repopulate bytes nobody will ever release
            entry = holder.masks.get(key)
            if entry is not None:
                return entry[0]
            if holder.seen.get(key, 0) < self.min_sightings:
                return None
        nbytes = int(padded_mask.nbytes)
        if self.breaker is not None:
            try:
                self.breaker.add_estimate_and_maybe_break(nbytes, "<filter_mask>")
            except CircuitBreakingError:
                with self._lock:
                    self.rejections += 1  # out of fielddata budget: the
                return None               # host mask still serves
        row = upload_pinned(padded_mask, device)  # the one copy, outside _lock
        release = 0
        with self._lock:
            if holder.dead:
                release = nbytes
                row = None
            else:
                entry = holder.masks.get(key)
                if entry is not None:
                    release = nbytes  # concurrent winner: keep theirs
                    row = entry[0]
                else:
                    holder.masks[key] = (row, nbytes)
                    holder.bytes += nbytes
                    self._bytes += nbytes
                    self._masks += 1
                    self.builds += 1
        if release and self.breaker is not None:
            self.breaker.release(release)
        return row

    def _drop(self, holder: _SegmentFilterMasks, dead: bool) -> int:
        """Empty a holder under the lock; returns its bytes (the caller
        releases them to the breaker outside the lock)."""
        with self._lock:
            if holder.dead:
                return 0
            holder.dead = dead
            n = len(holder.masks)
            released = holder.bytes
            self._bytes -= holder.bytes
            self._masks -= n
            self.evictions += n
            holder.masks.clear()
            holder.seen.clear()
            holder.bytes = 0
        return released

    def evict_dropped(self, dropped, live) -> int:
        """Evict the masks of segments a new engine view dropped. `live` is
        the new view's segments: a holder a live segment still shares (a
        tombstone view of the same segment) stays. Returns the bytes
        released."""
        live_holders = {id(h) for s in live for h in list(s._device_cache.values())
                        if isinstance(h, _SegmentFilterMasks)}
        with self._lock:
            devices = sorted(self._devices)
        released = 0
        for seg in dropped:
            for device in devices:
                key = filter_masks_key(device)
                holder = seg._device_cache.get(key)
                if holder is None:
                    # plant a dead holder, so a straggler request still on
                    # the old searcher cannot store bytes after this ran
                    dead = _SegmentFilterMasks()
                    dead.dead = True
                    holder = seg._device_cache.setdefault(key, dead)
                    if holder is dead:
                        continue
                if id(holder) not in live_holders:
                    released += self._drop(holder, dead=True)
        if released and self.breaker is not None:
            self.breaker.release(released)
        return released

    def clear_segment(self, seg) -> int:
        """Drop a live segment's resident masks and sighting counts (they
        rebuild on later sightings); returns the bytes released."""
        released = sum(self._drop(h, dead=False)
                       for h in list(seg._device_cache.values())
                       if isinstance(h, _SegmentFilterMasks))
        if released and self.breaker is not None:
            self.breaker.release(released)
        return released

    # -- the warmer's re-prime ------------------------------------------------
    def hot_keys(self, segs) -> set:
        """The filter keys resident, or seen at least `min_sightings` times,
        on any of `segs` (any device): what the re-prime carries from an old
        view's segments onto the new view's."""
        keys: set = set()
        with self._lock:
            for seg in segs:
                for holder in list(seg._device_cache.values()):
                    if isinstance(holder, _SegmentFilterMasks):
                        keys.update(holder.masks.keys())
                        keys.update(k for k, c in holder.seen.items()
                                    if c >= self.min_sightings)
        return keys

    def seed(self, seg, keys, device) -> int:
        """Mark `keys` seen `min_sightings` times on the segment's holder for
        `device`, so their next evaluation there stores the mask at once.
        Counter work only: no mask is built or uploaded. Returns the keys
        seeded."""
        if not self.enabled or not keys:
            return 0
        holder = self._holder(seg, device)
        seeded = 0
        with self._lock:
            if holder.dead:
                return 0
            for k in keys:
                if k not in holder.masks and holder.seen.get(k, 0) < self.min_sightings:
                    holder.seen[k] = self.min_sightings
                    seeded += 1
        return seeded

    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return (self.hits / n) if n else 0.0

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "memory_size_in_bytes": self._bytes,
                "masks": self._masks,
                "hits": self.hits,
                "misses": self.misses,
                "builds": self.builds,
                "evictions": self.evictions,
                "rejections": self.rejections,
                "hit_rate": round(self.hit_rate(), 4),
            }
