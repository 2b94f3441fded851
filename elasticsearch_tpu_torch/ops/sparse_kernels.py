"""The fused sparse scoring kernel `sparse_score` and its plain torch version.

`sparse_score` is the port of the JAX package's Pallas kernel
(`elasticsearch_tpu/ops/pallas_kernels.py sparse_score`, body
`_sparse_score_kernel`): per query row, stream the TB postings blocks named by
`qblk`, widen tf, decode each posting's norm byte through its clause field's
256-entry LUT, compute the BM25 / TF-IDF contribution, fold the packed
should/must/must_not counter, then sort the candidates by doc, merge duplicate
docs with `passes` doubling segment-sums, apply the bool semantics and the
optional coord factor, and keep the top k. In: [Qb, TB] clause arrays and the
[NB, 128] planes; out: scores f32 [Qb, k], docs i32 [Qb, k], totals i32 [Qb].

On a CUDA tensor the wrapper launches the hand-written kernel in
`csrc/sparse_score.cu` (or raises), in the variant `_launch_plan` picks: all
in shared memory up to 8192 slots a query, global scratch with tiled sorts
above. On a CPU tensor it runs the plain version
below, `sparse_candidates` + `sparse_reduce`, which repeats the kernel's
arithmetic op for op. The two are bitwise equal: chip_smoke.py holds them
against each other on the card at every bucket shape the main path launches,
and tests/test_torch_sparse.py holds the plain version against the JAX
package bit for bit.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..common import cudaenv
from .device_index import BLOCK, TFN_BM25

GROUP_SHOULD, GROUP_MUST, GROUP_MUST_NOT = 0, 1, 2
_MUST_SHIFT, _NOT_SHIFT = 10, 20

_TF_KIND = {torch.uint8: 0, torch.int16: 1, torch.float32: 2}

SMEM_MAX_SLOTS = 8192  # largest P the shared-memory variant holds
GLOBAL_TILE = 8192  # keys per shared tile of the global variant's sorts
_VARIANT_CODE = {"smem": 0, "global": 1}


@dataclass(frozen=True)
class LaunchPlan:
    """How one launch of the kernel runs: the variant, its threads per
    block, its dynamic shared bytes, and the global scratch the wrapper
    allocates ({name: (shape, dtype)}, empty for the smem variant)."""
    variant: str
    threads: int
    shared_bytes: int
    scratch: dict


def _launch_plan(Qb: int, TB: int, simple: bool) -> LaunchPlan:
    """The launch plan of a [Qb, TB] bucket (P = TB·128 slots per query).

    TB is a bucket size of `plan_sparse_buckets`: a power of two ≥ 8.
    P ≤ 8192: the smem variant — the whole reduction in shared memory (doc
    keys 8 B, contributions ping/pong 8 B, counters ping/pong 8 B unless
    simple, per slot), min(1024, P/2) threads, no global scratch. Above: the
    global variant — 1024 threads, a 64 KB shared tile for the tiled sorts,
    [Qb, P] doc keys and score keys and ping/pong [2, Qb, P] contributions
    (and counters unless simple) in device memory."""
    if TB < 8 or TB & (TB - 1):
        raise ValueError(f"sparse_score: TB={TB} must be a power of two >= 8")
    P = TB * BLOCK
    if P <= SMEM_MAX_SLOTS:
        return LaunchPlan("smem", min(1024, P // 2), P * (16 if simple else 24), {})
    scratch = {"keys": ((Qb, P), torch.int64), "skeys": ((Qb, P), torch.int64),
               "cbuf": ((2, Qb, P), torch.float32)}
    if not simple:
        scratch["nbuf"] = ((2, Qb, P), torch.int32)
    return LaunchPlan("global", 1024, GLOBAL_TILE * 8, scratch)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of a float32 tensor (what
    `__fsqrt_rn` and numpy compute): taken in float64 and rounded once, which
    is exact for float32 inputs. Not `torch.sqrt` on float32 directly: the
    CPU build's vectorised float32 square root is not correctly rounded (one
    ulp off on about 0.5% of integer tf values)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def top_k_lowest_index(values: torch.Tensor, k: int):
    """Top-k along dim 1 with `jax.lax.top_k`'s tie rule: equal values come
    out lower index first. Each (value, index) pair becomes one int64 key —
    the float's order-preserving int32 image in the high half, the inverted
    index in the low half — so the keys are unique and `torch.topk` on them
    is deterministic. Returns (values [.., k], indices int64 [.., k])."""
    bits = values.contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    n = values.shape[1]
    idx = torch.arange(n, device=values.device, dtype=torch.int64)
    keys = ordered * (1 << 32) + (0xFFFFFFFF - idx)
    top = torch.topk(keys, k, dim=1).values
    top_idx = 0xFFFFFFFF - (top & 0xFFFFFFFF)
    return torch.gather(values, 1, top_idx), top_idx


def sparse_candidates(blk_docs, blk_tf, blk_nb, caches, qmode, qblk, qw,
                      qconst, qfid, *, doc_pad: int):
    """The decode half of the plain version: gather each query's postings
    blocks and compute per-posting contributions — tf widened to f32, norm
    byte through the field LUT, tf factor first, then the weight (Lucene's
    weight·tfNorm rounding order). Returns (docs [Qb, TB, B] i32, contrib
    [Qb, TB, B] f32 zeroed on invalid slots, valid [Qb, TB, B] bool)."""
    rows = qblk.long()
    docs = blk_docs[rows]
    tf = blk_tf[rows].to(torch.float32)
    nb = blk_nb[rows].long()
    cv = caches.reshape(-1)[qfid.long()[:, :, None] * 256 + nb]
    mode = qmode[:, :, None]
    tfn = torch.where(mode == TFN_BM25, tf / (tf + cv), sqrt_rn(tf) * cv)
    contrib = qw[:, :, None] * torch.where(qconst[:, :, None], 1.0, tfn)
    valid = docs < doc_pad
    return docs, torch.where(valid, contrib, 0.0), valid


def sparse_reduce(docs, contrib, cnt, n_must, msm, coord, *, k: int,
                  doc_pad: int, passes: int, simple: bool, use_coord: bool):
    """The reduction half: stable sort by doc id, `passes` doubling
    segment-sums (a run's full sum lands on its LAST element), bool semantics
    on the folded counters, top-k with lower-index-first ties.
    [Qb, P] in → ([Qb, k] scores, [Qb, k] docs, [Qb] totals). `cnt` may be
    None when simple."""
    Qb = docs.shape[0]
    docs_s, order = torch.sort(docs, dim=1, stable=True)
    vals = [torch.gather(contrib, 1, order)]
    if not simple:
        vals.append(torch.gather(cnt, 1, order))
    for i in range(passes):
        shift = 1 << i
        same = torch.cat([torch.zeros((Qb, shift), dtype=torch.bool,
                                      device=docs.device),
                          docs_s[:, shift:] == docs_s[:, :-shift]], dim=1)
        vals = [v + torch.where(same, torch.cat(
                    [torch.zeros((Qb, shift), dtype=v.dtype, device=v.device),
                     v[:, :-shift]], dim=1), torch.zeros((), dtype=v.dtype,
                                                         device=v.device))
                for v in vals]
    c_s = vals[0]
    is_last = torch.cat([docs_s[:, :-1] != docs_s[:, 1:],
                         torch.ones((Qb, 1), dtype=torch.bool,
                                    device=docs.device)], dim=1)
    if simple:
        match = is_last & (docs_s < doc_pad) & (c_s > 0.0)
    else:
        n_s = vals[1]
        m_should = n_s & 0x3FF
        m_must = (n_s >> _MUST_SHIFT) & 0x3FF
        m_not = n_s >> _NOT_SHIFT
        match = (is_last & (docs_s < doc_pad)
                 & (m_must == n_must[:, None]) & (m_should >= msm[:, None])
                 & (m_not == 0) & ((m_should + m_must) > 0))
        if use_coord:
            overlap = torch.clamp(m_should + m_must, max=coord.shape[1] - 1)
            c_s = c_s * torch.gather(coord, 1, overlap.long())
    masked = torch.where(match, c_s, float("-inf"))
    top_scores, idx = top_k_lowest_index(masked, k)
    top_docs = torch.gather(docs_s, 1, idx)
    return top_scores, top_docs, match.sum(dim=1, dtype=torch.int32)


def sparse_score_plain(qblk, qw, qconst, qcnt, qfid, qmode, n_must, msm, coord,
                       blk_docs, blk_tf, blk_nb, caches, *, k: int,
                       doc_pad: int, passes: int, simple: bool,
                       use_coord: bool):
    """The plain torch version of the kernel (same signature)."""
    Qb, TB = qblk.shape
    P = TB * BLOCK
    docs, contrib, valid = sparse_candidates(
        blk_docs, blk_tf, blk_nb, caches, qmode, qblk, qw, qconst, qfid,
        doc_pad=doc_pad)
    cnt = (None if simple
           else torch.where(valid, qcnt[:, :, None], 0).reshape(Qb, P))
    return sparse_reduce(docs.reshape(Qb, P), contrib.reshape(Qb, P), cnt,
                         n_must, msm, coord, k=k, doc_pad=doc_pad,
                         passes=passes, simple=simple, use_coord=use_coord)


def sparse_score(qblk, qw, qconst, qcnt, qfid, qmode, n_must, msm, coord,
                 blk_docs, blk_tf, blk_nb, caches, *, k: int, doc_pad: int,
                 passes: int, simple: bool, use_coord: bool):
    """Fused quantized sparse scoring → ([Qb, k] scores, [Qb, k] docs, [Qb]
    totals). Launches the CUDA kernel on card tensors; runs the plain version
    on CPU tensors."""
    kwargs = dict(k=k, doc_pad=doc_pad, passes=passes, simple=simple,
                  use_coord=use_coord)
    args = (qblk, qw, qconst, qcnt, qfid, qmode, n_must, msm, coord,
            blk_docs, blk_tf, blk_nb, caches)
    if qblk.device.type == "cpu":
        return sparse_score_plain(*args, **kwargs)
    if qblk.device.type != "cuda":
        raise ValueError(f"sparse_score: unsupported device [{qblk.device}]")
    return _sparse_score_cuda(*args, **kwargs)


def start_check(device) -> int:
    """Launch the kernel once in each variant and mode on a tiny seeded
    input and hold it against its plain version, bitwise: a node's start
    runs it, so a kernel built for another architecture, one that asks for
    more than the card has or one that faults or disagrees on its first
    launch stops the start instead of failing every search. Raises the
    launch's CudaError, or KernelBuildError on a disagreement; returns the
    launches it checked."""
    g = torch.Generator().manual_seed(0)
    caches = (torch.rand((2, 256), generator=g) * 2 + 0.1).to(device)
    Qb, doc_pad, checked = 2, 1 << 20, 0
    for TB in (8, 2 * SMEM_MAX_SLOTS // BLOCK):  # the smem and the global variant
        NB = 2 * TB
        planes = (torch.randint(0, TB * 32, (NB, BLOCK), generator=g, dtype=torch.int32),
                  torch.randint(1, 256, (NB, BLOCK), generator=g).to(torch.uint8),
                  torch.randint(0, 256, (NB, BLOCK), generator=g).to(torch.uint8))
        qblk = torch.randint(0, NB, (Qb, TB), generator=g, dtype=torch.int32)
        qw = torch.rand((Qb, TB), generator=g) + 0.1
        must = torch.arange(TB) >= TB // 2  # the second half of a row: one must clause
        for simple in (True, False):
            qcnt = torch.where(must & (not simple), 1 << _MUST_SHIFT, 1)
            zeros = torch.zeros((Qb, TB), dtype=torch.int32)
            args = [t.to(device) for t in (
                qblk, qw, zeros.bool(), qcnt.expand(Qb, TB).to(torch.int32).contiguous(),
                zeros, zeros, torch.full((Qb,), 0 if simple else 1, dtype=torch.int32),
                torch.ones(Qb, dtype=torch.int32), torch.ones((Qb, 3)), *planes)]
            kw = dict(k=10, doc_pad=doc_pad, passes=3, simple=simple, use_coord=False)
            got = sparse_score(*args, caches, **kw)
            want = sparse_score_plain(*args, caches, **kw)
            for a, b, what in zip(got, want, ("scores", "docs", "totals")):
                if not torch.equal(a, b):
                    raise cudaenv.KernelBuildError(
                        f"sparse_score: the start check's {what} at TB={TB} "
                        f"simple={simple} disagree with the plain version")
            checked += 1
    return checked


def _lib():
    lib = cudaenv.load_library("sparse_score")
    if not getattr(lib, "_sparse_score_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sparse_score_launch.argtypes = (
            [p] * 9 + [i]            # qblk qw qconst qcnt qfid qmode n_must msm coord, C1
            + [p, p, i, p, p]        # blk_docs blk_tf tf_kind blk_nb caches
            + [i] * 7                # Qb TB k doc_pad passes simple use_coord
            + [i] * 3                # the plan: variant, threads, shared bytes
            + [p, p, p, p]           # scratch: keys, score keys, contrib, counters
            + [p, p, p, p])          # out scores, docs, totals; stream
        lib.sparse_score_launch.restype = ctypes.c_int
        lib.sparse_score_error_string.argtypes = [ctypes.c_int]
        lib.sparse_score_error_string.restype = ctypes.c_char_p
        lib._sparse_score_bound = True
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"sparse_score: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"sparse_score: {name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"sparse_score: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"sparse_score: {name} is not contiguous")


def _sparse_score_cuda(qblk, qw, qconst, qcnt, qfid, qmode, n_must, msm, coord,
                       blk_docs, blk_tf, blk_nb, caches, *, k: int,
                       doc_pad: int, passes: int, simple: bool,
                       use_coord: bool):
    device = qblk.device
    Qb, TB = qblk.shape
    P = TB * BLOCK
    NB = blk_docs.shape[0]
    F = caches.shape[0]
    C1 = coord.shape[1]
    plan = _launch_plan(Qb, TB, simple)
    if not 1 <= k <= P:
        raise ValueError(f"sparse_score: k={k} outside [1, {P}]")
    if not 0 <= passes < 31 or (1 << passes) > P:
        raise ValueError(f"sparse_score: passes={passes} out of range")
    for name, t, dt in (("qblk", qblk, torch.int32), ("qw", qw, torch.float32),
                        ("qconst", qconst, torch.bool),
                        ("qcnt", qcnt, torch.int32), ("qfid", qfid, torch.int32),
                        ("qmode", qmode, torch.int32)):
        _check(t, name, dt, (Qb, TB), device)
    _check(n_must, "n_must", torch.int32, (Qb,), device)
    _check(msm, "msm", torch.int32, (Qb,), device)
    _check(coord, "coord", torch.float32, (Qb, C1), device)
    _check(blk_docs, "blk_docs", torch.int32, (NB, BLOCK), device)
    if blk_tf.dtype not in _TF_KIND:
        raise ValueError(f"sparse_score: blk_tf dtype {blk_tf.dtype} unsupported")
    _check(blk_tf, "blk_tf", blk_tf.dtype, (NB, BLOCK), device)
    _check(blk_nb, "blk_nb", torch.uint8, (NB, BLOCK), device)
    _check(caches, "caches", torch.float32, (F, 256), device)

    scratch = {name: torch.empty(shape, dtype=dtype, device=device)
               for name, (shape, dtype) in plan.scratch.items()}
    keys, skeys, cbuf, nbuf = (scratch[n].data_ptr() if n in scratch else None
                               for n in ("keys", "skeys", "cbuf", "nbuf"))
    scores = torch.empty((Qb, k), dtype=torch.float32, device=device)
    docs = torch.empty((Qb, k), dtype=torch.int32, device=device)
    totals = torch.empty((Qb,), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _lib()
    err = lib.sparse_score_launch(
        qblk.data_ptr(), qw.data_ptr(), qconst.data_ptr(), qcnt.data_ptr(),
        qfid.data_ptr(), qmode.data_ptr(), n_must.data_ptr(), msm.data_ptr(),
        coord.data_ptr(), C1,
        blk_docs.data_ptr(), blk_tf.data_ptr(), _TF_KIND[blk_tf.dtype],
        blk_nb.data_ptr(), caches.data_ptr(),
        Qb, TB, k, doc_pad, passes, int(simple), int(use_coord),
        _VARIANT_CODE[plan.variant], plan.threads, plan.shared_bytes,
        keys, skeys, cbuf, nbuf,
        scores.data_ptr(), docs.data_ptr(), totals.data_ptr(), stream)
    if err != 0:
        msg = lib.sparse_score_error_string(err).decode()
        raise cudaenv.CudaError(err, f"sparse_score launch failed: CUDA error "
                                     f"{err}: {msg}", kernel="sparse_score")
    cudaenv.LAUNCHES.bump("sparse_score")
    cudaenv.LAUNCHES.bump(f"sparse_score.{plan.variant}")
    return scores, docs, totals
