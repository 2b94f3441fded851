"""The port's packing and norm codec against the JAX package's.

A segment built by the JAX package is converted with `convert.py` and packed
by the port; its planes must be byte-equal to the JAX package's
`pack_segment` on the real block rows. Tolerance: none. The `doc_pad`
sentinels are normalised first: the JAX package's doc bucket may come from
an autotuned ladder rather than the power of two the port uses."""

import dataclasses

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.jaxenv import compile_tag
from elasticsearch_tpu_torch.common import smallfloat as tsf
from elasticsearch_tpu_torch.convert import packed_from_arrays, segment_from_arrays
from elasticsearch_tpu_torch.index.engine import Searcher
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.ops.device_index import pack_segment
from elasticsearch_tpu_torch.search import (
    ShardContext, SimilarityService, parse_query, search_shard_batch)

CPU = torch.device("cpu")
WORDS = [f"w{i}" for i in range(60)]


def _docs(seed: int, n: int, heavy: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    docs = [{"title": " ".join(rng.choice(WORDS, 3)),
             "body": " ".join(rng.choice(WORDS, int(rng.integers(4, 30))))}
            for _ in range(n)]
    if heavy:
        # one doc whose tf passes the u8 (255) or i16 (32767) rung
        docs[n // 2] = {"body": " ".join(["w7"] * heavy)}
    return docs


def _jax_segment(docs, deletes=()):
    from elasticsearch_tpu.index.segment import SegmentBuilder
    from elasticsearch_tpu.mapper.core import MapperService

    svc = MapperService()
    b = SegmentBuilder(0)
    for i, src in enumerate(docs):
        b.add(svc.mapper_for("doc").parse(src, str(i)))
    seg = b.freeze()
    for local in deletes:
        seg.delete_doc(local)
    return seg


def convert_segment(jseg):
    """A JAX-package segment as a port segment, through numpy and dicts."""
    return segment_from_arrays(
        jseg.term_dict, np.asarray(jseg.post_offsets), np.asarray(jseg.post_docs),
        np.asarray(jseg.post_freqs),
        {f: np.asarray(a) for f, a in jseg.norms.items()},
        {f: dataclasses.asdict(s) for f, s in jseg.field_stats.items()},
        np.asarray(jseg.live), np.asarray(jseg.parent_mask), gen=jseg.gen,
        ids=list(jseg.ids))


def _jax_pack(jseg):
    from elasticsearch_tpu.ops.device_index import pack_segment as jpack

    with compile_tag("pack"):
        return jpack(jseg)


def _norm_sentinel(docs: np.ndarray, doc_pad: int) -> np.ndarray:
    return np.where(docs >= doc_pad, -1, docs)


@pytest.mark.parametrize("case", ["u8", "i16", "f32", "tombstones"])
def test_pack_planes_byte_equal(case):
    heavy = {"i16": 300, "f32": 33_000}.get(case, 0)
    deletes = (3, 17, 40) if case == "tombstones" else ()
    jseg = _jax_segment(_docs(1, 64, heavy), deletes)
    jp = _jax_pack(jseg)
    tp = pack_segment(convert_segment(jseg), CPU)
    assert tp.tf_layout == jp.tf_layout == case.replace("tombstones", "u8")
    NB = int(jp.term_blk_start[-1])
    assert np.array_equal(tp.term_blk_start, jp.term_blk_start)
    assert np.array_equal(
        _norm_sentinel(tp.blk_docs.numpy()[:NB], tp.doc_pad),
        _norm_sentinel(np.asarray(jp.blk_docs)[:NB], jp.doc_pad))
    assert (tp.blk_docs.numpy()[NB:] == tp.doc_pad).all()
    for plane in ("blk_tf", "blk_nb"):
        t = getattr(tp, plane).numpy()[:NB]
        j = np.asarray(getattr(jp, plane))[:NB]
        assert t.dtype == j.dtype and t.tobytes() == j.tobytes(), plane
    n = jseg.doc_count
    assert np.array_equal(tp.live_parent.numpy()[:n], np.asarray(jp.live_parent)[:n])
    for f, col in jp.norm_bytes.items():
        assert np.array_equal(tp.norm_bytes[f].numpy()[:n], np.asarray(col)[:n])
    if deletes:
        masked = tp.blk_docs.numpy()[:NB]
        assert not np.isin(masked, list(deletes)).any()


def test_norm_codec_and_device_tables_match():
    from elasticsearch_tpu.common import smallfloat as jsf

    lengths = np.arange(0, 5000)
    assert np.array_equal(tsf.encode_norm(lengths), jsf.encode_norm(lengths))
    assert np.array_equal(tsf.NORM_TABLE, jsf.NORM_TABLE)
    all_bytes = np.arange(256, dtype=np.uint8)
    assert np.array_equal(tsf.decode_norm_doclen(all_bytes),
                          jsf.decode_norm_doclen(all_bytes))
    tb = tsf.byte315_to_float_t(torch.from_numpy(all_bytes)).numpy()
    assert tb.tobytes() == np.asarray(jsf.jnp_byte315_to_float(all_bytes)).tobytes()
    assert tsf.norm_table(CPU).numpy().tobytes() == \
        np.asarray(jsf.jnp_norm_table()).tobytes()
    assert tsf.doclen_table(CPU).numpy().tobytes() == \
        np.asarray(jsf.jnp_doclen_table()).tobytes()


def test_mapper_and_builder_match_jax_segment():
    """The port's own indexing path (mapper → analyzer → SegmentBuilder)
    freezes the same CSR postings, norms and field stats as the JAX package."""
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder

    docs = _docs(2, 50, heavy=300)
    docs[5] = {"title": "Hello, WORLD's end", "tags": ["x y", None, "z"],
               "meta": {"note": "nested object text"}, "empty": ""}
    jseg = _jax_segment(docs)
    svc = TMapperService()
    b = SegmentBuilder(0)
    for i, src in enumerate(docs):
        b.add(svc.mapper_for("doc").parse(src, str(i)))
    tseg = b.freeze()
    assert tseg.term_dict == jseg.term_dict
    for name in ("post_offsets", "post_docs", "post_freqs"):
        a, j = getattr(tseg, name), np.asarray(getattr(jseg, name))
        assert a.dtype == j.dtype and np.array_equal(a, j), name
    assert tseg.norms.keys() == jseg.norms.keys()
    for f in jseg.norms:
        assert np.array_equal(tseg.norms[f], jseg.norms[f]), f
    assert {f: dataclasses.asdict(s) for f, s in tseg.field_stats.items()} == \
        {f: dataclasses.asdict(s) for f, s in jseg.field_stats.items()}


def test_tombstones_after_pack_remask_like_a_fresh_pack():
    """A doc deleted after its segment was packed is masked out of the
    resident planes before the next search (`packed_for` re-masks on the
    segment's live generation): hits equal those of a segment whose
    tombstone predates its pack."""
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder

    docs = _docs(4, 90)
    queries = [parse_query(q) for q in (
        {"match": {"body": "w1 w2 w3"}},
        {"bool": {"must": [{"term": {"body": "w5"}}],
                  "should": [{"term": {"title": "w6"}}]}})]
    svc = TMapperService()

    def build(deletes):
        b = SegmentBuilder(0)
        for i, src in enumerate(docs):
            b.add(svc.mapper_for("doc").parse(src, str(i)))
        seg = b.freeze()
        for local in deletes:
            seg.delete_doc(local)
        return seg

    def search(seg):
        ctx = ShardContext(Searcher([seg]), svc, SimilarityService(), device="cpu")
        return [(r.total, r.hits) for r in search_shard_batch(ctx, queries, 20)]

    late = build(())
    before = search(late)
    victim = before[0][1][0][1]  # the top hit of the first query
    late.delete_doc(victim)
    after = search(late)
    assert after == search(build((victim,)))
    assert after != before
    assert victim not in {d for _t, hits in after for _s, d in hits}


def test_packed_from_arrays_serves_like_own_pack():
    """JAX-packed planes carried across with packed_from_arrays score
    exactly like the port's own pack of the same segment."""
    jseg = _jax_segment(_docs(3, 80), deletes=(4,))
    jp = _jax_pack(jseg)
    queries = [{"match": {"body": "w1 w2 w3"}},
               {"bool": {"must": [{"term": {"body": "w4"}}],
                         "should": [{"term": {"title": "w5"}}],
                         "must_not": [{"term": {"body": "w6"}}]}}]

    def run(seg):
        svc = TMapperService()
        svc.mapper_for("doc").parse(_docs(3, 1)[0], "probe")  # map the fields
        ctx = ShardContext(Searcher([seg]), svc, SimilarityService(), device="cpu")
        return search_shard_batch(ctx, [parse_query(q) for q in queries], 10)

    own = run(convert_segment(jseg))
    seg = convert_segment(jseg)
    packed_from_arrays(
        np.asarray(jp.blk_docs), np.asarray(jp.blk_tf), np.asarray(jp.blk_nb),
        jp.term_blk_start, jp.doc_pad,
        {f: np.asarray(a) for f, a in jp.norm_bytes.items()},
        np.asarray(jp.live_parent), device="cpu", doc_count=jseg.doc_count,
        segment=seg)
    carried = run(seg)
    assert [(r.total, r.hits) for r in own] == [(r.total, r.hits) for r in carried]
    assert own[0].total > 0
