"""Carry the JAX package's state across into the port's.

The JAX package's state is given as numpy arrays and plain dicts (a caller
passes `np.asarray(...)` of its objects' fields); nothing here imports the
JAX package.

- `segment_from_arrays` builds a port FrozenSegment from a segment's CSR
  postings, norms, field statistics, masks, numeric and string doc-value
  columns, routing values and, for a nested segment, its ids, types and
  nested paths (the children's `__nested__` type and path, their parent's
  id); a child's `_parent` pointers travel in the `_parent` string
  column.
- `packed_from_arrays` builds a port PackedSegment on a device from already
  packed planes, and can install it as a segment's pack for that device.
"""

from __future__ import annotations

import numpy as np

from .common.cudaenv import default_device, upload
from .index.segment import FieldStats, FrozenSegment
from .ops.device_index import (
    BLOCK,
    TF_F32,
    TF_I16,
    TF_U8,
    PackedSegment,
    pack_cache_key,
    tf_plane_integral,
)

_LAYOUT_OF_DTYPE = {np.dtype(np.uint8): TF_U8, np.dtype(np.int16): TF_I16,
                    np.dtype(np.float32): TF_F32}


def segment_from_arrays(term_dict: dict, post_offsets: np.ndarray,
                        post_docs: np.ndarray, post_freqs: np.ndarray,
                        norms: dict, field_stats: dict, live: np.ndarray,
                        parent_mask: np.ndarray, *, gen: int = 0,
                        ids: list | None = None,
                        dv_num: dict | None = None,
                        dv_str: dict | None = None,
                        routings: list | None = None,
                        types: list | None = None,
                        nested_paths: list | None = None) -> FrozenSegment:
    """A port segment from CSR arrays. `term_dict` is {field: {term: tid}},
    `norms` {field: uint8[D]}, `field_stats` {field: {"doc_count",
    "sum_ttf", "sum_dfs"}}; `live` and `parent_mask` are bool[D];
    `dv_num` {field: (offsets int64[D+1], values float64[offsets[-1]])},
    each doc's numeric values (the JAX segment's `dv_num` layout); `dv_str`
    {field: (sorted distinct values, offsets int64[D+1], ords int32)}, each
    doc's string values as ordinals into the distinct values (`dv_str`;
    `_parent` holds a child document's parent id); `routings` each doc's
    routing value (None where it has none); `types` each doc's type and
    `nested_paths` each doc's nested path (None for a top-level doc): a
    segment with nested children (False in `parent_mask`) needs both, with
    `ids`, for its blocks."""
    live = np.array(live, dtype=bool)  # tombstones mutate it: own copy
    post_offsets = np.asarray(post_offsets, dtype=np.int64)
    if post_offsets[-1] != len(post_docs) or len(post_docs) != len(post_freqs):
        raise ValueError("post_offsets must end at len(post_docs) == len(post_freqs)")
    for name, per_doc in (("routings", routings), ("ids", ids), ("types", types),
                          ("nested_paths", nested_paths)):
        if per_doc is not None and len(per_doc) != len(live):
            raise ValueError(f"{name} cover {len(per_doc)} docs, not {len(live)}")
    parent_mask = np.asarray(parent_mask, dtype=bool)
    if not parent_mask.all() and (nested_paths is None or ids is None
                                  or types is None):
        raise ValueError("a segment with nested children needs its ids, types "
                         "and nested_paths")
    for f, arr in norms.items():
        if len(arr) != len(live):
            raise ValueError(f"norms of [{f}] cover {len(arr)} docs, not {len(live)}")
    columns = {}
    for f, (off, vals) in (dv_num or {}).items():
        off = np.asarray(off, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        if len(off) != len(live) + 1 or off[0] != 0 or off[-1] != len(vals) \
                or np.any(np.diff(off) < 0):
            raise ValueError(f"dv_num of [{f}]: offsets must rise from 0 to "
                             f"len(values) over {len(live)} docs")
        columns[f] = (off, vals)
    strings = {}
    for f, (uniq, off, ords) in (dv_str or {}).items():
        off = np.asarray(off, dtype=np.int64)
        ords = np.asarray(ords, dtype=np.int32)
        if list(uniq) != sorted(set(uniq)) or len(off) != len(live) + 1 \
                or off[0] != 0 or off[-1] != len(ords) or np.any(np.diff(off) < 0) \
                or (len(ords) and (ords.min() < 0 or ords.max() >= len(uniq))):
            raise ValueError(f"dv_str of [{f}]: sorted distinct values and "
                             f"ordinals into them over {len(live)} docs")
        strings[f] = (list(uniq), off, ords)
    return FrozenSegment(
        gen=gen,
        doc_count=len(live),
        term_dict={f: dict(td) for f, td in term_dict.items()},
        post_offsets=post_offsets,
        post_docs=np.asarray(post_docs, dtype=np.int32),
        post_freqs=np.asarray(post_freqs, dtype=np.float32),
        norms={f: np.asarray(a, dtype=np.uint8) for f, a in norms.items()},
        field_stats={f: FieldStats(int(s["doc_count"]), int(s["sum_ttf"]),
                                   int(s.get("sum_dfs", 0)))
                     for f, s in field_stats.items()},
        live=live,
        parent_mask=parent_mask,
        ids=None if ids is None else list(ids),
        types=None if types is None else list(types),
        routings=None if routings is None else list(routings),
        nested_paths=None if nested_paths is None else list(nested_paths),
        dv_num=columns,
        dv_str=strings,
    )


def packed_from_arrays(blk_docs: np.ndarray, blk_tf: np.ndarray,
                       blk_nb: np.ndarray, term_blk_start: np.ndarray,
                       doc_pad: int, norm_bytes: dict, live_parent: np.ndarray,
                       *, device, doc_count: int, gen: int = 0,
                       segment: FrozenSegment | None = None) -> PackedSegment:
    """A port PackedSegment on `device` from packed planes: `blk_docs` int32
    [NB, 128] (dead docs already masked to `doc_pad`), `blk_tf`
    uint8/int16/float32 [NB, 128], `blk_nb` uint8 [NB, 128], `norm_bytes`
    {field: uint8[doc_pad]}, `live_parent` bool[doc_pad]. With `segment`,
    the pack is installed as that segment's pack for `device`."""
    device = default_device(device)
    blk_docs = np.asarray(blk_docs, dtype=np.int32)
    blk_tf = np.asarray(blk_tf)
    layout = _LAYOUT_OF_DTYPE.get(blk_tf.dtype)
    if layout is None:
        raise ValueError(f"unsupported tf plane dtype {blk_tf.dtype}")
    if blk_docs.ndim != 2 or blk_docs.shape[1] != BLOCK \
            or blk_tf.shape != blk_docs.shape or np.shape(blk_nb) != blk_docs.shape:
        raise ValueError(f"planes must share one [NB, {BLOCK}] shape")
    host_docs = blk_docs.reshape(-1).copy()
    packed = PackedSegment(
        gen=gen,
        doc_count=doc_count,
        doc_pad=int(doc_pad),
        device=device,
        blk_docs=upload(blk_docs, device),
        blk_tf=upload(blk_tf, device),
        blk_nb=upload(np.asarray(blk_nb, dtype=np.uint8), device),
        tf_layout=layout,
        term_blk_start=np.asarray(term_blk_start, dtype=np.int64),
        live_parent=upload(np.asarray(live_parent, dtype=bool), device),
        norm_bytes={f: upload(np.asarray(a, dtype=np.uint8), device)
                    for f, a in norm_bytes.items()},
        # the masked ids stand in for the raw ones: tombstones only grow, so
        # a later re-mask never needs a dead doc's id back
        host_docs=host_docs,
        host_freqs=blk_tf.astype(np.float32).reshape(-1),
        tf_integral=tf_plane_integral(blk_tf.reshape(-1), layout),
    )
    if segment is not None:
        packed.live_gen = segment.live_gen
        segment._device_cache[pack_cache_key(device)] = packed
    return packed
