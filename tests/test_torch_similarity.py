"""The port's similarities (`search/similarity.py`) and its host scorer's
freq/norm branch against the JAX package's.

- `score_freqs` of every DFR basic model × after-effect × normalization, of
  IB (each distribution and lambda) and of both LM models: bitwise against
  the JAX class on seeded freqs, norm-decoded lengths and corpus stats.
- `SimilarityService._build` reads the JAX setting names
  (`normalization.h2.c`, `normalization.h3.mu`, `normalization.z.z`, `mu`,
  `lambda`); an unknown type raises with the JAX message.
- `for_field` keeps the JAX package's lookup: its field types carry no
  `similarity` attribute, so a mapping's `similarity` key has no effect and
  every field scores with the index default.
- The host scorer over a small three-segment index under each freq/norm
  default: the same hits and scores as the JAX host scorer, bitwise, and
  `lower_flat` returns None (both packages score such fields on the host).
- A phrase or span query over a DFR field fails in both packages with the
  same message (their phrase and span paths read `sim.idf`, which a
  freq/norm similarity lacks); the node test pins the REST answer.
- BM25 with its own `k1` 1.4 and `b` 0.6: the port's sparse path (its
  plain torch version on the CPU) against the JAX device path, bitwise."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import IllegalArgumentError as JIllegal
from elasticsearch_tpu.common.jaxenv import compile_tag
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.engine import Engine as JEngine
from elasticsearch_tpu.mapper.core import MapperService as JMapperService
from elasticsearch_tpu.search import ShardContext as JShardContext
from elasticsearch_tpu.search import parse_query as jparse_query
from elasticsearch_tpu.search import similarity as jsim
from elasticsearch_tpu.search.execute import lower_flat as jlower_flat
from elasticsearch_tpu.search.execute import search_shard as jsearch_shard
from elasticsearch_tpu.search.execute import search_shard_batch as jsearch_batch
from elasticsearch_tpu_torch.common.errors import (IllegalArgumentError,
                                                   SimilarityNotSupportedError)
from elasticsearch_tpu_torch.common.settings import Settings as TSettings
from elasticsearch_tpu_torch.common.smallfloat import decode_norm_doclen, encode_norm
from elasticsearch_tpu_torch.index.engine import Engine as TEngine
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.search import (
    ShardContext, SimilarityService, parse_query, search_shard, search_shard_batch)
from elasticsearch_tpu_torch.search import similarity as tsim
from elasticsearch_tpu_torch.search.execute import lower_flat


class _Stats:
    def __init__(self, sum_ttf: int, doc_count: int):
        self.sum_ttf = sum_ttf
        self.doc_count = doc_count


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    n = 400
    freqs = rng.integers(1, 40, n).astype(np.float32)
    lengths = rng.integers(1, 3000, n)
    dl = decode_norm_doclen(encode_norm(lengths))
    return freqs, dl


CORPORA = [  # (df, ttf, sum_ttf, doc_count, max_docs)
    (1, 1, 50, 10, 10),
    (37, 400, 90_000, 1_500, 1_600),
    (900, 12_000, 2_000_000, 20_000, 20_000),
    (5, 0, 0, 0, 7),  # empty stats: the fallbacks
]


def _bitwise(a: np.ndarray, b: np.ndarray):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_scores(jobj, tobj, seed=11):
    freqs, dl = _inputs(seed)
    for df, ttf, sum_ttf, doc_count, max_docs in CORPORA:
        fs = _Stats(sum_ttf, doc_count)
        for boost in (1.0, 2.5):
            j = jobj.score_freqs(freqs, dl, df, ttf, fs, max_docs, boost)
            t = tobj.score_freqs(freqs, dl, df, ttf, fs, max_docs, boost)
            _bitwise(t, j)
        _bitwise(tobj.norm_cache(fs, max_docs), jobj.norm_cache(fs, max_docs))
        assert tobj.term_weight(2.0, df, max_docs) == jobj.term_weight(2.0, df, max_docs)


DFR_CASES = list(itertools.product(["be", "d", "g", "p", "in", "ine", "if"],
                                   ["no", "b", "l"],
                                   ["no", "h1", "h2", "h3", "z"]))


@pytest.mark.parametrize("model,effect,norm", DFR_CASES)
def test_dfr_score_freqs_bitwise(model, effect, norm):
    kw = dict(basic_model=model, after_effect=effect, normalization=norm,
              c=1.7, mu=500.0, z=0.45)
    _same_scores(jsim.DFRSimilarity(**kw), tsim.DFRSimilarity(**kw))


@pytest.mark.parametrize("dist,lam,norm", list(itertools.product(
    ["ll", "spl"], ["df", "ttf"], ["no", "h1", "h2", "h3", "z"])))
def test_ib_score_freqs_bitwise(dist, lam, norm):
    kw = dict(distribution=dist, lambda_=lam, normalization=norm, c=0.8)
    _same_scores(jsim.IBSimilarity(**kw), tsim.IBSimilarity(**kw))


@pytest.mark.parametrize("mu", [10.0, 2000.0])
def test_lm_dirichlet_score_freqs_bitwise(mu):
    _same_scores(jsim.LMDirichletSimilarity(mu), tsim.LMDirichletSimilarity(mu))


@pytest.mark.parametrize("lam", [0.1, 0.7])
def test_lm_jelinek_mercer_score_freqs_bitwise(lam):
    _same_scores(jsim.LMJelinekMercerSimilarity(lam),
                 tsim.LMJelinekMercerSimilarity(lam))


BUILD_CASES = [
    {"type": "DFR", "basic_model": "in", "after_effect": "b",
     "normalization": "h2", "normalization.h2.c": 3.5},
    {"type": "dfr", "normalization": "h3", "normalization.h3.mu": 120},
    {"type": "DFR", "normalization": "z", "normalization.z.z": 0.2},
    {"type": "DFR", "c": 2.0},
    {"type": "IB", "distribution": "spl", "lambda": "ttf",
     "normalization.h2.c": 4.0},
    {"type": "ib"},
    {"type": "LMDirichlet", "mu": 350},
    {"type": "LMJelinekMercer", "lambda": 0.35},
    {"type": "BM25", "k1": 1.4, "b": 0.6},
    {"type": "default"},
]


@pytest.mark.parametrize("conf", BUILD_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_build_reads_the_jax_setting_names(conf):
    flat = {f"index.similarity.default.{k}": v for k, v in conf.items()}
    j = jsim.SimilarityService(JSettings.from_flat(flat)).default
    t = tsim.SimilarityService(TSettings.from_flat(flat)).default
    assert type(t).__name__ == type(j).__name__
    assert vars(t).keys() == vars(j).keys()
    for k, v in vars(j).items():
        if k == "_norm":
            assert vars(t._norm) == vars(v)
        else:
            assert getattr(t, k) == v, k
    if hasattr(j, "score_freqs"):
        _same_scores(j, t)


def test_unknown_similarity_type_raises_with_the_jax_message():
    flat = {"index.similarity.default.type": "nope"}
    with pytest.raises(JIllegal) as jerr:
        jsim.SimilarityService(JSettings.from_flat(flat))
    with pytest.raises(IllegalArgumentError) as terr:
        tsim.SimilarityService(TSettings.from_flat(flat))
    assert str(terr.value) == str(jerr.value)


def test_for_field_ignores_the_mapping_similarity_key():
    """The JAX package's lookup, kept: a named similarity and a field that
    names it in its mapping still score with the index default."""
    flat = {"index.similarity.default.type": "BM25",
            "index.similarity.my_dfr.type": "DFR"}
    mapping = {"properties": {"body": {"type": "string", "similarity": "my_dfr"}}}
    jms, tms = JMapperService(JSettings.from_flat(flat)), TMapperService(
        TSettings.from_flat(flat))
    jms.put_mapping("doc", mapping)
    tms.put_mapping("doc", mapping)
    j = jsim.SimilarityService(JSettings.from_flat(flat), mapper_service=jms)
    t = tsim.SimilarityService(TSettings.from_flat(flat), mapper_service=tms)
    assert type(j.for_field("body")).__name__ == "BM25Similarity"
    assert type(t.for_field("body")).__name__ == "BM25Similarity"
    assert not hasattr(tms.field_type("body"), "similarity")
    assert type(t._named["my_dfr"]).__name__ == "DFRSimilarity"


# --- the host scorer over an index -----------------------------------------

VOCAB = ["fox", "dog", "cat", "bird", "bee", "common", "word", "soup", "the",
         "animal"] + [f"w{i}" for i in range(20)]
_P = 1.0 / np.arange(1, len(VOCAB) + 1) ** 1.1
_P /= _P.sum()

DEFAULTS = {
    "dfr_g_l_h2": {"index.similarity.default.type": "DFR"},
    "dfr_in_b_h1": {"index.similarity.default.type": "DFR",
                    "index.similarity.default.basic_model": "in",
                    "index.similarity.default.after_effect": "b",
                    "index.similarity.default.normalization": "h1"},
    "dfr_be_no_no": {"index.similarity.default.type": "DFR",
                     "index.similarity.default.basic_model": "be",
                     "index.similarity.default.after_effect": "no",
                     "index.similarity.default.normalization": "no"},
    "ib_ll_df": {"index.similarity.default.type": "IB"},
    "ib_spl_ttf": {"index.similarity.default.type": "IB",
                   "index.similarity.default.distribution": "spl",
                   "index.similarity.default.lambda": "ttf"},
    "lm_dirichlet": {"index.similarity.default.type": "LMDirichlet",
                     "index.similarity.default.mu": 10},
    "lm_jm": {"index.similarity.default.type": "LMJelinekMercer"},
}

QUERIES = [
    {"match": {"body": "fox"}},
    {"match": {"body": "fox dog bird"}},
    {"match": {"body": {"query": "fox dog", "operator": "and"}}},
    {"term": {"title": "w3"}},
    {"bool": {"must": [{"match": {"body": "common"}}],
              "should": [{"term": {"title": "w1"}}, {"match": {"body": "cat"}}],
              "must_not": [{"term": {"body": "bee"}}]}},
    {"multi_match": {"query": "fox w2", "fields": ["title", "body^2"]}},
    {"match": {"_all": "fox w4"}},
    {"dis_max": {"queries": [{"match": {"title": "w5"}}, {"match": {"body": "soup"}}],
                 "tie_breaker": 0.3}},
    {"constant_score": {"filter": {"term": {"body": "dog"}}, "boost": 2.0}},
    {"prefix": {"body": "an"}},
]


def _docs(seed: int):
    rng = np.random.default_rng(seed)

    def words(lo, hi):
        return " ".join(rng.choice(VOCAB, int(rng.integers(lo, hi)), p=_P))

    batches = []
    for b in range(3):
        batches.append([(str(b * 40 + i), {"title": words(1, 5), "body": words(2, 60)})
                        for i in range(40)])
    return batches


@pytest.fixture(scope="module", params=list(DEFAULTS))
def ctxs(request, tmp_path_factory):
    flat = DEFAULTS[request.param]
    jset, tset = JSettings.from_flat(flat), TSettings.from_flat(flat)
    jms, tms = JMapperService(jset), TMapperService(tset)
    jeng = JEngine(str(tmp_path_factory.mktemp("j")), jms)
    teng = TEngine(str(tmp_path_factory.mktemp("t")), tms)
    try:
        for batch in _docs(3):
            for doc_id, src in batch:
                jeng.index("doc", doc_id, src)
                teng.index("doc", doc_id, src)
            jeng.delete("doc", batch[5][0])
            teng.delete("doc", batch[5][0])
            jeng.refresh()
            teng.refresh()
        jctx = JShardContext(jeng.acquire_searcher(), jms,
                             jsim.SimilarityService(jset, mapper_service=jms))
        tctx = ShardContext(teng.acquire_searcher(), tms, SimilarityService(tset, tms),
                            device="cpu")
        assert len(tctx.searcher.segments) == 3
        yield jctx, tctx
    finally:
        jeng.close()
        teng.close()


@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_host_scorer_matches_jax(ctxs, qi):
    jctx, tctx = ctxs
    q = QUERIES[qi]
    ref = jsearch_shard(jctx, jparse_query(q), 50, use_device=False)
    out = search_shard(tctx, parse_query(q), 50, use_device=False)
    assert out.total == ref.total
    assert out.hits == ref.hits
    # the batch entry point sends these fields to the host as well
    assert search_shard_batch(tctx, [parse_query(q)], 50)[0].hits == ref.hits


def test_freq_norm_fields_do_not_lower(ctxs):
    jctx, tctx = ctxs
    for q in QUERIES[:7]:
        assert jlower_flat(jparse_query(q), jctx) is None
        assert lower_flat(parse_query(q), tctx) is None


def _outcome(fn):
    try:
        r = fn()
    except (AttributeError, SimilarityNotSupportedError) as e:
        return ("fails", str(e))
    return (r.total, r.hits)


@pytest.mark.parametrize("q", [
    {"match_phrase": {"body": "fox dog"}},
    {"match_phrase": {"body": {"query": "fox bird", "slop": 4}}},
    {"span_near": {"clauses": [{"span_term": {"body": "fox"}},
                               {"span_term": {"body": "dog"}}],
                   "slop": 3, "in_order": False}},
    {"span_term": {"body": "fox"}},
], ids=["phrase", "sloppy_phrase", "span_near", "span_term"])
def test_phrase_and_span_over_freq_norm_as_in_jax(ctxs, q):
    """A phrase or span_near over a freq/norm field fails in both packages
    with the same message (the JAX package raises AttributeError from
    `sim.idf`, the port SimilarityNotSupportedError, which its node reports
    as a shard failure as the JAX node does); a lone span_term scores as a
    term."""
    jctx, tctx = ctxs
    ref = _outcome(lambda: jsearch_shard(jctx, jparse_query(q), 10, use_device=False))
    out = _outcome(lambda: search_shard(tctx, parse_query(q), 10, use_device=False))
    assert out == ref
    if "span_term" not in q:
        assert ref[0] == "fails" and "has no attribute 'idf'" in ref[1]


# --- BM25 with its own k1 and b on the sparse path -----------------------

SPARSE_QUERIES = [
    {"match": {"body": "fox dog bird"}},
    {"match": {"body": {"query": "common word", "operator": "and"}}},
    {"match": {"title": {"query": "w1 w2 w3 w4", "minimum_should_match": "50%"}}},
    {"bool": {"must": [{"term": {"body": "cat"}}],
              "should": [{"term": {"title": "w6"}}, {"term": {"body": "bee"}}],
              "must_not": [{"term": {"body": "soup"}}]}},
    {"term": {"body": "animal"}},
]


def test_bm25_own_k1_b_sparse_path_matches_jax(tmp_path):
    flat = {"index.similarity.default.type": "BM25",
            "index.similarity.default.k1": 1.4, "index.similarity.default.b": 0.6}
    jset, tset = JSettings.from_flat(flat), TSettings.from_flat(flat)
    jms, tms = JMapperService(jset), TMapperService(tset)
    jeng, teng = JEngine(str(tmp_path / "j"), jms), TEngine(str(tmp_path / "t"), tms)
    try:
        for batch in _docs(9):
            for doc_id, src in batch:
                jeng.index("doc", doc_id, src)
                teng.index("doc", doc_id, src)
            jeng.refresh()
            teng.refresh()
        jctx = JShardContext(jeng.acquire_searcher(), jms,
                             jsim.SimilarityService(jset, mapper_service=jms))
        tctx = ShardContext(teng.acquire_searcher(), tms, SimilarityService(tset, tms),
                            device="cpu")
        assert tctx.similarity_for("body").k1 == 1.4
        assert all(lower_flat(parse_query(q), tctx) is not None for q in SPARSE_QUERIES)
        with compile_tag("sparse"):
            ref = [(r.total, r.hits) for r in jsearch_batch(
                jctx, [jparse_query(q) for q in SPARSE_QUERIES], 30, use_device=True)]
        out = [(r.total, r.hits) for r in search_shard_batch(
            tctx, [parse_query(q) for q in SPARSE_QUERIES], 30)]
        assert sum(t for t, _h in ref) > 0
        assert out == ref
    finally:
        jeng.close()
        teng.close()
