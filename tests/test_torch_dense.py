"""The port's dense overflow program against the JAX package's
`ops/scoring._score_batch_impl`.

Tolerance: per-doc scores within 2 ulp, hit order identical except inside
groups of near-equal scores, totals exact (the rule of
tests/test_randomized_differential.py `_tie_tolerant_equal`). The reason: a
scatter-add adds a doc's contributions in no specified order — XLA's and
torch's `index_add_` may differ, and on the card `index_add_` uses atomics."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.jaxenv import compile_tag
from elasticsearch_tpu.ops import scoring as jscoring
from elasticsearch_tpu_torch.ops import scoring as tscoring
from elasticsearch_tpu_torch.ops.device_index import BLOCK

_ORDER = ("blk_docs", "blk_freqs", "live_parent", "norms_stack", "caches",
          "qidx", "blk", "weight", "fidx", "group", "tfmode", "n_must", "msm",
          "coord")


def _data(kind: str, seed=11, NB=48, Q=4, M=64, F=2, doc_pad=2048):
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, 1500, (NB, BLOCK)).astype(np.int32)
    docs[rng.random((NB, BLOCK)) < 0.1] = doc_pad
    docs[-1] = doc_pad  # the all-sentinel padding row
    d = {
        "doc_pad": doc_pad, "Q": Q,
        "blk_docs": docs,
        "blk_freqs": rng.integers(1, 40, (NB, BLOCK)).astype(np.float32),
        "live_parent": rng.random(doc_pad) < 0.95,
        "norms_stack": rng.integers(0, 256, (F, doc_pad)).astype(np.uint8),
        "caches": (rng.random((F, 256)) * 2 + 0.1).astype(np.float32),
        "qidx": rng.integers(0, Q, M).astype(np.int32),
        "blk": rng.integers(0, NB, M).astype(np.int32),
        "weight": (rng.random(M) * 3 + 0.1).astype(np.float32),
        "fidx": rng.integers(0, F, M).astype(np.int32),
        "group": np.zeros(M, np.int32),
        "tfmode": np.zeros(M, np.int32),
        "n_must": np.zeros(Q, np.int32),
        "msm": np.ones(Q, np.int32),
        "coord": np.ones((Q, 4), np.float32),
    }
    if kind != "simple":
        d["group"] = rng.choice([0, 0, 1, 2], M).astype(np.int32)
        d["tfmode"] = rng.choice([0, 1, 2], M).astype(np.int32)
        d["n_must"] = np.asarray([np.unique(d["blk"][(d["qidx"] == q)
                                                     & (d["group"] == 1)]).size
                                  > 0 for q in range(Q)], np.int32)
        d["msm"] = rng.integers(0, 2, Q).astype(np.int32)
    if kind == "coord":
        d["coord"] = (rng.random((Q, 4)) + 0.5).astype(np.float32)
    return d


def _hits(scores, docs, total):
    out = []
    for s, dd, t in zip(scores, docs, total):
        fin = np.isfinite(s)
        out.append((int(t), list(zip(s[fin].tolist(), dd[fin].tolist()))))
    return out


def _within_ulps(a: float, b: float, ulps: int) -> bool:
    ia = np.array(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.array(b, np.float32).view(np.int32).astype(np.int64)
    return abs(int(ia) - int(ib)) <= ulps


def _tie_tolerant_equal(dev, ref, ulps=2) -> bool:
    """Same doc set, per-doc scores within `ulps`, identical order except
    inside groups of scores within `ulps` of each other."""
    if sorted(d for _, d in dev) != sorted(d for _, d in ref):
        return False
    ref_by = {d: s for s, d in ref}
    if not all(_within_ulps(s, ref_by[d], ulps) for s, d in dev):
        return False
    pos = {d: i for i, (_, d) in enumerate(dev)}
    for i, (sa, a) in enumerate(ref):
        for sb, b in ref[i + 1:]:
            if not _within_ulps(sa, sb, 2 * ulps) and pos[a] > pos[b]:
                return False
    return True


@pytest.mark.parametrize("kind", ["simple", "bool", "coord"])
def test_dense_program_matches_jax(kind):
    import jax
    import jax.numpy as jnp

    d = _data(kind)
    k, simple = 50, kind == "simple"
    statics = dict(n_queries=d["Q"], k=k, doc_pad=d["doc_pad"], simple=simple)

    @jax.jit
    def fn(*a):
        return jscoring._score_batch_impl(*a, **statics)

    with compile_tag("dense"):
        ref = jax.device_get(fn(*(jnp.asarray(d[n]) for n in _ORDER)))
    out = tscoring._score_batch_impl(
        *(torch.from_numpy(np.ascontiguousarray(d[n])) for n in _ORDER),
        **statics)
    ref_h = _hits(*(np.asarray(x) for x in ref))
    out_h = _hits(*(x.numpy() for x in out))
    assert any(hits for _t, hits in ref_h)
    for (rt, rh), (ot, oh) in zip(ref_h, out_h):
        assert rt == ot
        assert _tie_tolerant_equal(oh, rh), (oh[:5], rh[:5])

