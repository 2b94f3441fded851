"""The port's sparse scoring path against the JAX package's, bit for bit.

The same inputs, made from a seed with numpy, go through JAX
`ops/scoring._sparse_impl` (jitted, as serving launches it) and the port's
`ops/scoring._sparse_impl` on CPU tensors — where the port's `sparse_score`
runs its plain torch version. Tolerance: none; scores, docs and totals must
be bitwise equal, as the Pallas kernel is to the composed path. The plain
version is also held against the Pallas `sparse_score` itself in interpret
mode (tiny shapes: interpret mode is slow)."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.jaxenv import compile_tag
from elasticsearch_tpu.ops import scoring as jscoring
from elasticsearch_tpu.ops.device_index import BLOCK, TFN_BM25, TFN_TFIDF
from elasticsearch_tpu_torch.ops import scoring as tscoring
from elasticsearch_tpu_torch.ops.sparse_kernels import (
    _launch_plan, sparse_score, top_k_lowest_index)

SMEM_LIMIT = 232_448  # dynamic shared bytes a Hopper block may use


def _data(seed=3, NB=64, Qb=8, TB=16, F=3, doc_pad=10_240, tf_dtype=np.uint8):
    rng = np.random.default_rng(seed)
    # a narrow doc range makes duplicate docs (segment-sum runs) and ties common
    docs = rng.integers(0, 600, (NB, BLOCK)).astype(np.int32)
    docs[rng.random((NB, BLOCK)) < 0.1] = doc_pad  # padding/dead slots
    return {
        "doc_pad": doc_pad,
        "blk_docs": docs,
        "blk_tf": rng.integers(1, 200, (NB, BLOCK)).astype(tf_dtype),
        "blk_nb": rng.integers(0, 256, (NB, BLOCK)).astype(np.uint8),
        "caches": (rng.random((F, 256)) * 2 + 0.1).astype(np.float32),
        "modes": np.array([TFN_BM25, TFN_TFIDF, TFN_BM25][:F], np.int32),
        "qblk": rng.integers(0, NB, (Qb, TB)).astype(np.int32),
        "qw": (rng.random((Qb, TB)) * 3).astype(np.float32),
        "qconst": rng.random((Qb, TB)) < 0.2,
        "qcnt": np.where(rng.random((Qb, TB)) < 0.7, 1, 1 << 10).astype(np.int32),
        "qfid": rng.integers(0, F, (Qb, TB)).astype(np.int32),
        "n_must": rng.integers(0, 2, Qb).astype(np.int32),
        "msm": np.ones(Qb, np.int32),
        "coord": (rng.random((Qb, 5)) + 0.5).astype(np.float32),
    }


_ORDER = ("blk_docs", "blk_tf", "blk_nb", "caches", "modes", "qblk", "qw",
          "qconst", "qcnt", "qfid", "n_must", "msm", "coord")


def _jax_sparse(d, *, k, passes, simple, use_coord, use_pallas=False):
    import jax
    import jax.numpy as jnp

    args = tuple(jnp.asarray(d[n]) for n in _ORDER)

    @jax.jit
    def fn(*a):
        return jscoring._sparse_impl(*a, k=k, doc_pad=d["doc_pad"],
                                     passes=passes, simple=simple,
                                     use_coord=use_coord,
                                     use_pallas=use_pallas)

    with compile_tag("sparse"):
        return [np.asarray(x) for x in jax.device_get(fn(*args))]


def _torch_sparse(d, *, k, passes, simple, use_coord):
    args = tuple(torch.from_numpy(np.ascontiguousarray(d[n])) for n in _ORDER)
    out = tscoring._sparse_impl(*args, k=k, doc_pad=d["doc_pad"], passes=passes,
                                simple=simple, use_coord=use_coord)
    return [x.numpy() for x in out]


def _assert_bitwise(ref, out):
    for r, o, name in zip(ref, out, ("scores", "docs", "totals")):
        assert r.dtype == o.dtype, name
        assert np.array_equal(r, o, equal_nan=True), name


@pytest.mark.parametrize("tf_dtype", [np.uint8, np.int16, np.float32],
                         ids=["u8", "i16", "f32"])
@pytest.mark.parametrize("simple,use_coord", [(True, False), (False, False),
                                              (False, True)],
                         ids=["simple", "bool", "coord"])
def test_sparse_impl_bitwise(simple, use_coord, tf_dtype):
    d = _data(tf_dtype=tf_dtype)
    if not use_coord:
        d["coord"] = np.ones_like(d["coord"])
    kw = dict(k=10, passes=3, simple=simple, use_coord=use_coord)
    _assert_bitwise(_jax_sparse(d, **kw), _torch_sparse(d, **kw))


def test_sparse_k_exceeds_slots():
    """k larger than a bucket's P = TB·128 slots: both packages clamp to P
    at the launch site and agree bitwise, -inf fill slots included."""
    from elasticsearch_tpu.ops.device_index import (
        PackedSegment as JPacked, SimTables as JSim)
    from elasticsearch_tpu_torch.ops.device_index import (
        PackedSegment as TPacked, SimTables as TSim)
    import jax.numpy as jnp

    d = _data(seed=5, Qb=8, TB=8)
    k = 5000  # > P = 1024
    jp = JPacked(gen=0, doc_count=600, doc_pad=d["doc_pad"],
                 blk_docs=jnp.asarray(d["blk_docs"]), term_blk_start=None,
                 live_parent=None, norm_bytes={},
                 blk_tf=jnp.asarray(d["blk_tf"]), blk_nb=jnp.asarray(d["blk_nb"]))
    jsim = JSim(fields=[], fid={}, modes=jnp.asarray(d["modes"]),
                caches=jnp.asarray(d["caches"]), key={})
    tp = TPacked(gen=0, doc_count=600, doc_pad=d["doc_pad"],
                 device=torch.device("cpu"),
                 blk_docs=torch.from_numpy(d["blk_docs"]),
                 blk_tf=torch.from_numpy(d["blk_tf"]),
                 blk_nb=torch.from_numpy(d["blk_nb"]), tf_layout="u8",
                 term_blk_start=None, live_parent=None, norm_bytes={},
                 host_docs=None, host_freqs=None)
    tsim = TSim(fields=[], fid={}, modes=torch.from_numpy(d["modes"]),
                caches=torch.from_numpy(d["caches"]), key={})
    fields = dict(n_queries=8, qids=np.arange(8, dtype=np.int32),
                  qblk=d["qblk"], qw=d["qw"], qconst=d["qconst"],
                  qcnt=d["qcnt"], qfid=d["qfid"], n_must=d["n_must"],
                  msm=d["msm"], coord=d["coord"], passes=3, simple=False)
    with compile_tag("sparse"):
        ref = [np.asarray(x) for x in jscoring.score_sparse_batch_async(
            jp, jscoring.SparseBatch(**fields), k, sim=jsim)]
    out = [x.numpy() for x in tscoring.score_sparse_batch_async(
        tp, tscoring.SparseBatch(**fields), k, sim=tsim)]
    assert out[0].shape == (8, 8 * BLOCK)
    assert np.isneginf(out[0]).any()
    _assert_bitwise(ref, out)


@pytest.mark.parametrize("simple,use_coord", [(True, False), (False, True)],
                         ids=["simple", "coord"])
def test_plain_matches_pallas_interpret(simple, use_coord):
    """The port's plain sparse_score against the JAX Pallas kernel, run in
    interpret mode on the CPU: bitwise."""
    d = _data(seed=7, NB=16, Qb=2, TB=8)
    kw = dict(k=8, passes=2, simple=simple, use_coord=use_coord)
    _assert_bitwise(_jax_sparse(d, use_pallas=True, **kw), _torch_sparse(d, **kw))


def test_top_k_lowest_index_breaks_ties_by_index():
    """lax.top_k's rule: equal values come out lower index first, -inf and
    negative values ordered like floats."""
    v = torch.tensor([[1.0, 3.0, 3.0, -2.0, float("-inf"), 3.0, -0.5, float("-inf")]])
    vals, idx = top_k_lowest_index(v, 8)
    assert idx.tolist() == [[1, 2, 5, 0, 6, 3, 4, 7]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 1.0, -0.5, -2.0, float("-inf"),
                              float("-inf")]]


def test_wrapper_rejects_unsupported_device():
    d = _data(Qb=8, TB=8)
    args = [torch.from_numpy(np.ascontiguousarray(d[n])).to("meta")
            for n in ("qblk", "qw", "qconst", "qcnt", "qfid", "qfid", "n_must",
                      "msm", "coord", "blk_docs", "blk_tf", "blk_nb", "caches")]
    with pytest.raises(ValueError, match="unsupported device"):
        sparse_score(*args, k=4, doc_pad=d["doc_pad"], passes=1, simple=True,
                     use_coord=False)


@pytest.mark.parametrize("mode", [TFN_BM25, TFN_TFIDF], ids=["bm25", "tfidf"])
def test_tfn_values_match_jax_and_the_scan(mode):
    """The host tfn formula equals the JAX package's bit for bit, and equals
    what the plain scan decodes per slot (weight 1, not constant)."""
    from elasticsearch_tpu.ops.device_index import tfn_values as jtfn
    from elasticsearch_tpu_torch.ops.device_index import tfn_values as ttfn
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_candidates

    d = _data(seed=9, NB=4, Qb=1, TB=4, F=1)
    freqs = d["blk_tf"].astype(np.float32).reshape(-1)
    nb = d["blk_nb"].reshape(-1)
    cache = d["caches"][0]
    host = ttfn(freqs, nb, cache, mode)
    assert host.tobytes() == np.asarray(jtfn(freqs, nb, cache, mode)).tobytes()
    T = {n: torch.from_numpy(np.ascontiguousarray(d[n])) for n in _ORDER}
    qblk = torch.arange(4, dtype=torch.int32)[None, :]
    ones = torch.ones((1, 4), dtype=torch.float32)
    _docs, contrib, _valid = sparse_candidates(
        T["blk_docs"], T["blk_tf"], T["blk_nb"], T["caches"],
        torch.full((1, 4), mode, dtype=torch.int32), qblk, ones,
        torch.zeros((1, 4), dtype=torch.bool), torch.zeros((1, 4), dtype=torch.int32),
        doc_pad=d["doc_pad"])
    valid = d["blk_docs"].reshape(-1) < d["doc_pad"]
    assert contrib.numpy().reshape(-1)[valid].tobytes() == host[valid].tobytes()


def test_score_flat_sparse_matches_jax():
    """The launch plumbing — bucketing by block count, padding, launches, one
    pull, the scatter back into [Q, k] — on a real segment: the port's
    `score_flat_sparse` against the JAX package's, bitwise, overflow list
    included (tb_max lowered so one query overflows)."""
    from elasticsearch_tpu.ops import device_index as jdi
    from elasticsearch_tpu_torch.ops import device_index as tdi
    from tests.test_torch_pack import _docs, _jax_pack, _jax_segment, convert_segment

    jseg = _jax_segment(_docs(6, 400), deletes=(5, 77))
    jp = _jax_pack(jseg)
    tp = tdi.pack_segment(convert_segment(jseg), torch.device("cpu"))
    rng = np.random.default_rng(2)
    cache = (rng.random(256) * 2 + 0.1).astype(np.float32)
    tables = {"body": (TFN_BM25, cache), "title": (TFN_TFIDF, cache * 0.5)}
    with compile_tag("sparse"):
        jsim = jdi.ensure_sim_tables(jp, tables)
    tsim = tdi.ensure_sim_tables(tp, tables)
    assert jsim.fid == tsim.fid
    words = [f"w{i}" for i in range(60)]
    clause_lists = []
    for q in range(12):
        cl = []
        for j, w in enumerate(rng.choice(words, 3 if q else 8, replace=False)):
            field = "title" if j == 2 else "body"
            tid = jseg.term_id(field, str(w))
            if tid is None:
                continue
            b0, b1 = int(jp.term_blk_start[tid]), int(jp.term_blk_start[tid + 1])
            cl.append((b0, b1, float(rng.random() + 0.5), j % 3 if q % 2 else 0,
                       j == 1 and q % 3 == 0, tsim.fid[field]))
        clause_lists.append(cl)
    n_must = np.array([sum(1 for c in cl if c[3] == 1) for cl in clause_lists], np.int32)
    msm = np.where(n_must > 0, 0, 1).astype(np.int32)
    coord = np.tile(np.array([0.0, 0.4, 0.7, 1.0], np.float32), (12, 1))
    kw = dict(simple=False, tb_max=4)
    with compile_tag("sparse"):
        ref = jscoring.score_flat_sparse(jp, clause_lists, n_must, msm, coord, 10,
                                         sim=jsim, **kw)
    out = tscoring.score_flat_sparse(tp, clause_lists, n_must, msm, coord, 10,
                                     sim=tsim, **kw)
    assert list(out[3]) == list(ref[3]) and len(out[3]) >= 1
    assert out[2].sum() > 0
    _assert_bitwise([np.asarray(x) for x in ref[:3]], list(out[:3]))


@pytest.mark.parametrize("TB", [8, 16, 32, 64])
@pytest.mark.parametrize("simple", [True, False], ids=["simple", "bool"])
def test_launch_plan_smem_variant_has_no_scratch(TB, simple):
    """TB ≤ 64: the whole reduction in shared memory, no global scratch,
    min(1024, P/2) threads, within a block's shared-memory limit."""
    plan = _launch_plan(16, TB, simple)
    P = TB * BLOCK
    assert plan.variant == "smem"
    assert plan.scratch == {}
    assert plan.threads == min(1024, P // 2)
    assert plan.shared_bytes == P * (16 if simple else 24) <= SMEM_LIMIT


def test_launch_plan_smem_budget_at_8192_slots():
    """At P = 8192: keys 64 KB + contributions 64 KB + counters 64 KB when
    the query is not simple, 128 KB when it is, both under 232,448 bytes."""
    assert _launch_plan(4, 64, False).shared_bytes == 192 * 1024 <= SMEM_LIMIT
    assert _launch_plan(4, 64, True).shared_bytes == 128 * 1024 <= SMEM_LIMIT


@pytest.mark.parametrize("TB", [128, 256, 512])
@pytest.mark.parametrize("simple", [True, False], ids=["simple", "bool"])
def test_launch_plan_global_variant_scratch(TB, simple):
    """TB ≥ 128: the global variant with [Qb, P] scratch (doc keys, score
    keys; contributions and, unless simple, counters double-buffered)."""
    Qb, P = 32, TB * BLOCK
    plan = _launch_plan(Qb, TB, simple)
    assert plan.variant == "global"
    assert plan.threads == 1024
    assert plan.shared_bytes == 8192 * 8 <= SMEM_LIMIT
    want = {"keys": ((Qb, P), torch.int64), "skeys": ((Qb, P), torch.int64),
            "cbuf": ((2, Qb, P), torch.float32)}
    if not simple:
        want["nbuf"] = ((2, Qb, P), torch.int32)
    assert plan.scratch == want


@pytest.mark.parametrize("TB", [0, 3, 4, 12, 96, -8])
def test_launch_plan_rejects_tb_not_a_power_of_two(TB):
    """Bucket sizes are powers of two from 8 up; anything else is refused
    before a launch."""
    with pytest.raises(ValueError, match="power of two"):
        _launch_plan(8, TB, True)


def _top_k_by_descending_sort(values: np.ndarray, k: int):
    """The kernel's top-k, step for step: the unsigned 64-bit key of each
    (score, index) — ordered float image with its sign bit flipped in the high
    half, 0xFFFFFFFF - index in the low half — sorted descending, first k;
    score and index decoded back from the key."""
    n = values.shape[1]
    bits = values.view(np.int32)
    ordered = np.where(bits < 0, bits ^ 0x7FFFFFFF, bits).astype(np.int32)
    high = (ordered.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
    low = np.uint64(0xFFFFFFFF) - np.arange(n, dtype=np.uint64)
    keys = (high << np.uint64(32)) | low
    top = np.sort(keys, axis=1)[:, ::-1][:, :k]
    back = ((top >> np.uint64(32)).astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
    scores = np.where(back < 0, back ^ 0x7FFFFFFF, back).astype(np.int32).view(np.float32)
    index = (np.uint64(0xFFFFFFFF) - (top & np.uint64(0xFFFFFFFF))).astype(np.int64)
    return scores, index


def _score_rows(case: str, rng) -> tuple[np.ndarray, int]:
    n = 256
    if case == "ties":
        v = rng.choice(np.array([0.5, 1.0, 2.0, -np.inf], np.float32), (4, n))
        return v, 40
    if case == "fewer_than_k":
        v = np.full((4, n), -np.inf, np.float32)
        v[np.arange(4), rng.integers(0, n, 4)] = rng.random(4).astype(np.float32)
        v[0, :] = -np.inf  # a row with no match at all
        return v, 10
    if case == "k_equals_p":
        v = rng.choice(np.array([0.25, 3.0, -np.inf], np.float32), (4, n))
        return v, n
    v = rng.choice(np.array([1.0, 0.0, -0.0, -1.5, -np.inf, np.nan], np.float32), (4, n))
    return v, 64


@pytest.mark.parametrize("case", ["ties", "fewer_than_k", "k_equals_p", "nan"])
def test_top_k_by_descending_sort_equals_top_k_lowest_index(case):
    """The kernel's top-k definition (a descending sort of the plain version's
    keys, first k) against `top_k_lowest_index`: same indices, same score
    bits — heavy ties, -inf fill with fewer matches than k, k = P, NaN."""
    values, k = _score_rows(case, np.random.default_rng(11))
    scores, index = _top_k_by_descending_sort(values, k)
    want_scores, want_index = top_k_lowest_index(torch.from_numpy(values), k)
    assert np.array_equal(index, want_index.numpy())
    assert scores.view(np.int32).tobytes() == want_scores.numpy().view(np.int32).tobytes()
