"""Device-resident packed postings in the quantized layout (a port of the JAX
package's `ops/device_index.py`: the pack, the similarity LUTs and the lazy
dense plane).

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
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..common.breaker import reserve
from ..common.cudaenv import upload
from ..index.segment import FrozenSegment

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


def choose_tf_layout(post_freqs: np.ndarray) -> str:
    """The narrowest exact tf-plane dtype for a segment's raw frequencies."""
    if len(post_freqs) == 0:
        return TF_U8
    mx = float(post_freqs.max())
    if mx > 32767:
        return TF_F32
    if post_freqs.dtype.kind not in "iu":
        chunk = 1 << 20
        for i in range(0, len(post_freqs), chunk):
            c = post_freqs[i: i + chunk]
            if not np.all(c == np.floor(c)):
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
    sim: SimTables | None = None  # ensure_sim_tables state
    blk_freqs: torch.Tensor | None = None  # float32 [NBpad, B], dense path only

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

    live_parent = _live_parent(seg, Dpad)
    norm_bytes = {}
    for f, arr in seg.norms.items():
        padded = np.zeros(Dpad, dtype=np.uint8)
        padded[: seg.doc_count] = arr
        norm_bytes[f] = upload(padded, device)

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
        norm_bytes=norm_bytes,
        host_docs=flat_docs,
        host_freqs=flat_freqs,
        live_gen=seg.live_gen,
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
    tf_b = np.dtype(_TF_DTYPE[layout]).itemsize
    per_slot = (4 + 4 + tf_b + 1) + (4 + tf_b + 1) + 12
    return NBpad * BLOCK * per_slot + Dpad * 2 + Dpad * len(seg.norms)


_PACK_LOCK = threading.Lock()


def pack_cache_key(device: torch.device) -> tuple:
    """The key of a segment's pack for `device` in its `_device_cache`."""
    return ("packed", str(device))


def packed_for(seg: FrozenSegment, device: torch.device,
               breaker=None) -> PackedSegment:
    """The segment's pack on `device`, cached on the segment; re-masks the
    live planes when tombstones changed since the pack. A first pack
    reserves `pack_estimate_bytes` on `breaker` (the node's fielddata child;
    None in unwired contexts) while it runs. Uploads never synchronise, so
    this is safe inside a dispatch."""
    key = pack_cache_key(device)
    with _PACK_LOCK:
        packed = seg._device_cache.get(key)
        if packed is None:
            with reserve(breaker, pack_estimate_bytes(seg), "<packed_segment>"):
                packed = pack_segment(seg, device)
            seg._device_cache[key] = packed
        elif packed.live_gen != seg.live_gen:
            live_parent = _live_parent(seg, packed.doc_pad)
            packed.blk_docs = upload(
                _mask_docs(packed.host_docs, live_parent, packed.doc_pad)
                .reshape(-1, BLOCK), device)
            packed.live_parent = upload(live_parent, device)
            packed.live_gen = seg.live_gen
    return packed


def ensure_blk_freqs(packed: PackedSegment, breaker=None) -> torch.Tensor:
    """Fault in the dense-fallback f32 freqs plane (sparse-only segments
    never pay its 4 B/posting), its bytes reserved on `breaker` (fielddata)
    around the upload. Under the pack lock, so two dispatching threads
    upload it once."""
    if packed.blk_freqs is None:
        with _PACK_LOCK:
            if packed.blk_freqs is None:
                with reserve(breaker, packed.host_freqs.nbytes, "<dense_freqs>"):
                    packed.blk_freqs = upload(
                        packed.host_freqs.reshape(-1, BLOCK), packed.device)
    return packed.blk_freqs


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
    against. The swap is a read-modify-write of packed.sim: under the pack
    lock, so two dispatching threads never drop each other's fields."""
    cur = packed.sim
    if _sim_current(cur, tables):
        return cur
    with _PACK_LOCK:
        cur = packed.sim
        if _sim_current(cur, tables):
            return cur
        packed.sim = _merged_sim(packed, cur, tables)
        return packed.sim


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
