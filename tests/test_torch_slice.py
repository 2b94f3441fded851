"""The ported slice as a whole against the JAX package: shard query phase of
batched bool-of-terms search, top-k per query.

A JAX shard is built with `Engine` (two refreshes, one delete). The port
indexes the same docs through its own mapper and SegmentBuilder, and also
converts the JAX segments with `convert.py`; both port searchers must return
the JAX `search_shard_batch(..., use_device=True)` hits: same totals, same
order (ties by doc id ascending), scores bitwise — every query here rides
the sparse path. A segment built from CSR arrays with one term of more than
65,536 postings sends queries past `tb_max` onto the dense overflow path,
held to ≤ 2 ulp (tests/test_torch_dense.py says why)."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.common.cudaenv import DeviceUnavailableError, default_device
from elasticsearch_tpu_torch.common.errors import QueryParsingError
from elasticsearch_tpu_torch.common.settings import Settings as TSettings
from elasticsearch_tpu_torch.index.engine import Searcher
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.ops import scoring as tscoring
from elasticsearch_tpu_torch.search import (
    ShardContext, SimilarityService, parse_query, search_shard_batch)
from tests.test_torch_dense import _tie_tolerant_equal
from tests.test_torch_pack import convert_segment

WORDS = [f"w{i}" for i in range(80)]
QUERIES = [
    {"match": {"body": "w1 w2 w3"}},
    {"match": {"body": {"query": "w4 w5", "operator": "and"}}},
    {"match": {"body": {"query": "w6 w7 w8 w9", "minimum_should_match": "50%"}}},
    {"match": {"title": {"query": "w10 w11", "boost": 2.5}}},
    {"term": {"body": "w12"}},
    {"term": {"body": "no-such-term"}},
    {"bool": {"must": [{"term": {"body": "w13"}}],
              "should": [{"term": {"body": "w14"}}, {"match": {"title": "w15"}}],
              "must_not": [{"term": {"body": "w16"}}]}},
    {"bool": {"should": [{"term": {"body": "w17"}}, {"term": {"body": "w18"}},
                         {"term": {"body": "w19"}}],
              "minimum_should_match": 2}},
    {"bool": {"should": [{"term": {"body": "w20"}}, {"term": {"title": "w21"}}],
              "disable_coord": True, "boost": 1.5}},
    {"match": {"_all": "w1 w22"}},
]
DELETED = "7"


def _docs(seed, n, start):
    rng = np.random.default_rng(seed)
    return [(str(start + i), {"title": " ".join(rng.choice(WORDS, 3)),
                              "body": " ".join(rng.choice(WORDS, int(rng.integers(3, 40))))})
            for i in range(n)]


SETTINGS = {"bm25": {"index.similarity.default.type": "BM25"}, "tfidf": {}}


@pytest.fixture(scope="module", params=["bm25", "tfidf"])
def shards(request, tmp_path_factory):
    """(JAX context, port own-index context, port converted context)."""
    from elasticsearch_tpu.common.settings import Settings
    from elasticsearch_tpu.index.engine import Engine
    from elasticsearch_tpu.mapper.core import MapperService
    from elasticsearch_tpu.search import ShardContext as JShardContext
    from elasticsearch_tpu.search.similarity import SimilarityService as JSim

    flat = SETTINGS[request.param]
    batches = [_docs(1, 120, 0), _docs(2, 80, 120)]
    settings = Settings.from_flat(flat)
    svc = MapperService(settings)
    eng = Engine(str(tmp_path_factory.mktemp(request.param)), svc)
    for batch in batches:
        for doc_id, src in batch:
            eng.index("doc", doc_id, src)
        eng.refresh()
    eng.delete("doc", DELETED)
    eng.refresh()
    jsearcher = eng.acquire_searcher()
    assert len(jsearcher.segments) == 2
    jctx = JShardContext(jsearcher, svc, JSim(settings, mapper_service=svc))

    tsettings = TSettings.from_flat(flat)
    tsvc = TMapperService(tsettings)
    segs = []
    for g, batch in enumerate(batches):
        b = SegmentBuilder(g)
        for doc_id, src in batch:
            b.add(tsvc.mapper_for("doc").parse(src, doc_id))
        segs.append(b.freeze())
    segs[0].delete_doc(int(DELETED))
    own = ShardContext(Searcher(segs), tsvc, SimilarityService(tsettings, tsvc),
                       device="cpu")
    conv = ShardContext(Searcher([convert_segment(s) for s in jsearcher.segments]),
                        tsvc, SimilarityService(tsettings, tsvc), device="cpu")
    yield jctx, own, conv
    eng.close()


def _jax_hits(jctx, queries, k):
    from elasticsearch_tpu.search import parse_query as jparse
    from elasticsearch_tpu.search.execute import search_shard_batch as jsearch

    return [(r.total, r.hits) for r in
            jsearch(jctx, [jparse(q) for q in queries], k, use_device=True)]


def _port_hits(ctx, queries, k):
    return [(r.total, r.hits) for r in
            search_shard_batch(ctx, [parse_query(q) for q in queries], k)]


@pytest.mark.parametrize("k", [10, 150])
def test_slice_hits_match_jax(shards, k):
    jctx, own, conv = shards
    ref = _jax_hits(jctx, QUERIES, k)
    assert sum(t for t, _h in ref) > 0
    assert _port_hits(own, QUERIES, k) == ref
    assert _port_hits(conv, QUERIES, k) == ref


def test_tombstoned_doc_never_hits(shards):
    _jctx, own, _conv = shards
    for total, hits in _port_hits(own, QUERIES, 200):
        assert int(DELETED) not in {d for _s, d in hits}


def _csr_segment_pair(n_docs=80_000, big=70_000, seed=5):
    """One field `body`: term `big` with `big` postings (past tb_max = 512
    blocks of 128), plus small terms; the same arrays as a JAX FrozenSegment
    and as a port segment."""
    from elasticsearch_tpu.common.smallfloat import encode_norm
    from elasticsearch_tpu.index.segment import FieldStats, FrozenSegment

    rng = np.random.default_rng(seed)
    lengths = rng.integers(5, 60, n_docs)
    post = {"big": np.sort(rng.choice(n_docs, big, replace=False))}
    for i in range(6):
        post[f"s{i}"] = np.sort(rng.choice(n_docs, int(rng.integers(50, 3000)),
                                           replace=False))
    terms = sorted(post)
    docs = np.concatenate([post[t] for t in terms]).astype(np.int32)
    freqs = rng.integers(1, 6, len(docs)).astype(np.float32)
    offsets = np.zeros(len(terms) + 1, np.int64)
    offsets[1:] = np.cumsum([len(post[t]) for t in terms])
    term_dict = {"body": {t: i for i, t in enumerate(terms)}}
    norms = {"body": encode_norm(lengths)}
    stats = FieldStats(doc_count=n_docs, sum_ttf=int(lengths.sum()),
                       sum_dfs=len(docs))
    live = np.ones(n_docs, bool)
    live[rng.choice(n_docs, 500, replace=False)] = False
    jseg = FrozenSegment(
        gen=0, doc_count=n_docs, term_dict=term_dict, post_offsets=offsets,
        post_docs=docs, post_freqs=freqs,
        pos_offsets=np.zeros(len(docs) + 1, np.int64),
        positions=np.zeros(0, np.int32), norms=norms,
        field_stats={"body": stats}, dv_num={}, dv_str={}, stored=[None] * n_docs,
        ids=[str(i) for i in range(n_docs)], types=["doc"] * n_docs,
        routings=[None] * n_docs, versions=np.ones(n_docs, np.int64),
        live=live, parent_mask=np.ones(n_docs, bool),
        nested_paths=[None] * n_docs)
    return jseg, convert_segment(jseg)


OVERFLOW_QUERIES = [
    {"term": {"body": "big"}},
    {"bool": {"should": [{"term": {"body": "big"}}, {"term": {"body": "s1"}}]}},
    {"bool": {"must": [{"term": {"body": "s2"}}],
              "should": [{"term": {"body": "big"}}, {"term": {"body": "s3"}}],
              "must_not": [{"term": {"body": "s4"}}]}},
    {"term": {"body": "s0"}},  # sparse path in the same batch
]


@pytest.fixture(scope="module")
def overflow_shards():
    from elasticsearch_tpu.common.settings import Settings
    from elasticsearch_tpu.index.engine import Searcher as JSearcher
    from elasticsearch_tpu.mapper.core import MapperService
    from elasticsearch_tpu.search import ShardContext as JShardContext
    from elasticsearch_tpu.search.similarity import SimilarityService as JSim

    jseg, tseg = _csr_segment_pair()
    out = {}
    for name, flat in SETTINGS.items():
        svc = MapperService(Settings.from_flat(flat))
        svc.put_mapping("doc", {"properties": {"body": {"type": "string"}}})
        tsvc = TMapperService(TSettings.from_flat(flat))
        tsvc.put_mapping("doc", {"properties": {"body": {"type": "string"}}})
        out[name] = (
            JShardContext(JSearcher([jseg]), svc,
                          JSim(Settings.from_flat(flat), mapper_service=svc)),
            ShardContext(Searcher([tseg]), tsvc,
                         SimilarityService(TSettings.from_flat(flat), tsvc),
                         device="cpu"))
    return out


@pytest.mark.parametrize("sim", ["bm25", "tfidf"])
def test_overflow_path_matches_jax(overflow_shards, sim):
    jctx, tctx = overflow_shards[sim]
    ref = _jax_hits(jctx, OVERFLOW_QUERIES, 20)
    out = _port_hits(tctx, OVERFLOW_QUERIES, 20)
    assert ref[0][0] > 60_000  # the big term really matched
    for (rt, rh), (ot, oh) in zip(ref, out):
        assert rt == ot
        assert _tie_tolerant_equal(oh, rh), (oh[:5], rh[:5])
    assert out[-1] == ref[-1]  # the sparse-path query stays bitwise


def test_overflow_chunks_match_one_launch(overflow_shards, monkeypatch):
    """Overflow queries split over several dense launches (a tiny memory
    budget: one query per launch) return exactly what one launch returns."""
    _jctx, tctx = overflow_shards["bm25"]
    whole = _port_hits(tctx, OVERFLOW_QUERIES, 20)
    doc_pad = tctx.searcher.segments[0]._device_cache[("packed", "cpu")].doc_pad
    monkeypatch.setattr(tscoring, "DENSE_BUDGET_BYTES",
                        (doc_pad + 1) * tscoring._DENSE_CELL_BYTES)
    assert tscoring.dense_chunk(doc_pad) == 1
    assert _port_hits(tctx, OVERFLOW_QUERIES, 20) == whole


def test_unported_queries_raise(shards):
    """The query types of later slices raise at parse time; a range query
    and a must_not-only bool, once refused, now run on the host scorer with
    the JAX package's hits, in a batch beside a query the card serves."""
    jctx, own, _conv = shards
    for q in ({"function_score": {"query": {"match_all": {}}}},
              {"nested": {"path": "c", "query": {"match_all": {}}}},
              {"geo_shape": {"loc": {"shape": {}}}},
              {"constant_score": {"filter": {"geo_distance": {
                  "distance": "1km", "loc": [0, 0]}}}}):
        with pytest.raises(QueryParsingError, match="later slice"):
            parse_query(q)
    served = [{"range": {"n": {"gte": 1}}},
              {"bool": {"must_not": [{"term": {"body": "w1"}}]}},
              {"match": {"body": "w2 w3"}}]
    got = _port_hits(own, served, 10)
    assert got == _jax_hits(jctx, served, 10)
    assert got[1][0] > 0


def test_entry_points_need_the_card_unless_asked_for_cpu():
    assert default_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert default_device().type == "cuda"
    else:
        with pytest.raises(DeviceUnavailableError):
            default_device()
        with pytest.raises(DeviceUnavailableError):
            default_device("cuda")
        with pytest.raises(DeviceUnavailableError):
            ShardContext(Searcher([]), TMapperService())
