"""The port's host scorer, query DSL and filters against the JAX package's.

Both packages' `Engine`s index the same seeded sources (two text fields with
positions, a `not_analyzed` string, `long`, `double`, `date` and `boolean`
fields, a multi-valued `long`, a text field that is sometimes empty or all
punctuation) in three refreshes with deletes and overwrites, so each shard
holds three segments and tombstones; under BM25 and under TF-IDF.

- For every query type the port serves, one parametrised test per family:
  the JAX `search_shard(ctx, q, k, use_device=False)` and the port's return
  the same total and the same hits in the same order, scores bitwise (both
  host scorers are numpy with the same expression order).
- For every filter type, one parametrised test per family: every segment's
  `segment_mask` is equal array for array, and the filter gating a
  `constant_score` and a `filtered` query gives the JAX hits, bitwise.
- `execute_query_phase(..., use_device=False)` with `post_filter`,
  `filter` and `min_score`: the JAX package's results, bitwise.
- A seeded differential (a fixed seed, after
  tests/test_randomized_differential.py): random lowerable bodies through
  the port's device path on the CPU (its plain torch versions) agree with
  the port's host scorer: same order, tie-tolerant, scores within 2 ulp.
- The segment read API on a segment built from arrays, the filter cache of a
  `with_deletes` view and `parse_date_math`."""

import base64
import json

import numpy as np
import pytest

from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.engine import Engine as JEngine
from elasticsearch_tpu.mapper.core import MapperService as JMapperService
from elasticsearch_tpu.search import ShardContext as JShardContext
from elasticsearch_tpu.search import parse_query as jparse_query
from elasticsearch_tpu.search.execute import search_shard as jsearch_shard
from elasticsearch_tpu.search.filters import segment_mask as jsegment_mask
from elasticsearch_tpu.search.queries import parse_filter as jparse_filter
from elasticsearch_tpu.search.service import execute_query_phase as jphase
from elasticsearch_tpu.search.service import parse_search_body as jparse_body
from elasticsearch_tpu.search.similarity import SimilarityService as JSim
from elasticsearch_tpu_torch.common.errors import IllegalArgumentError
from elasticsearch_tpu_torch.common.settings import Settings as TSettings
from elasticsearch_tpu_torch.convert import segment_from_arrays
from elasticsearch_tpu_torch.index.engine import Engine as TEngine
from elasticsearch_tpu_torch.index.engine import Searcher
from elasticsearch_tpu_torch.index.segment import FILTER_CACHE_KEY
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.mapper.core import parse_date_math
from elasticsearch_tpu_torch.search import (
    ShardContext, SimilarityService, execute_query_phase, parse_filter,
    parse_query, parse_search_body, search_shard, search_shard_batch)
from elasticsearch_tpu_torch.search.filters import segment_mask
from tests.test_torch_dense import _tie_tolerant_equal

VOCAB = ["alpha", "alpine", "alps", "beta", "bet", "better", "gamma", "game",
         "games", "delta", "dell", "epsilon", "zeta", "zen", "theta", "iota",
         "kappa", "lambda", "lamb", "omega"] + [f"w{i}" for i in range(12)]
# a zipf-like draw, so some terms are common and some rare
_P = 1.0 / np.arange(1, len(VOCAB) + 1) ** 0.9
_P /= _P.sum()
TAGS = ["red", "green", "blue-ish", "Red", "teal"]
MAPPING = {"properties": {
    "title": {"type": "string"}, "body": {"type": "string"},
    "note": {"type": "string"},
    "tag": {"type": "string", "index": "not_analyzed"},
    "n": {"type": "long"}, "price": {"type": "double"}, "ts": {"type": "date"},
    "flag": {"type": "boolean"}, "nums": {"type": "long"}}}
SIMS = {"bm25": {"index.similarity.default.type": "BM25"}, "tfidf": {}}


def _source(rng, i: int) -> dict:
    def words(lo, hi):
        return " ".join(rng.choice(VOCAB, int(rng.integers(lo, hi)), p=_P))

    src = {"title": words(1, 5), "body": words(3, 30), "n": i,
           "price": float(np.round(rng.uniform(0.5, 20), 1)),
           "ts": f"2014-{1 + i % 12:02d}-{1 + i % 28:02d}",
           "flag": bool(rng.random() < 0.4),
           "tag": str(rng.choice(TAGS))}
    r = rng.random()
    if r < 0.5:
        src["note"] = words(1, 4)
    elif r < 0.65:
        src["note"] = ""  # a value, with no token
    elif r < 0.75:
        src["note"] = "!!! ..."
    if rng.random() < 0.6:
        src["nums"] = [int(x) for x in rng.integers(0, 8, int(rng.integers(1, 4)))]
    if rng.random() < 0.1:
        del src["tag"]
    return src


def _ops(seed: int) -> list[list]:
    """Three refresh batches: index, index, then deletes and overwrites."""
    rng = np.random.default_rng(seed)
    first = [("index", str(i), _source(rng, i)) for i in range(110)]
    second = [("index", str(i), _source(rng, i)) for i in range(110, 180)]
    third = [("delete", str(i), None) for i in range(0, 180, 13)]
    third += [("index", str(i), _source(rng, 1000 + i)) for i in (4, 50, 120, 121)]
    return [first, second, third]


def _run_ops(engine, batches):
    for batch in batches:
        for op, doc_id, src in batch:
            if op == "index":
                engine.index("doc", doc_id, src)
            else:
                engine.delete("doc", doc_id)
        engine.refresh()


@pytest.fixture(scope="module", params=list(SIMS))
def ctxs(request, tmp_path_factory):
    """(JAX context, port context) over the same ops."""
    flat = SIMS[request.param]
    batches = _ops(7)
    jset = JSettings.from_flat(flat)
    jsvc = JMapperService(jset)
    jsvc.put_mapping("doc", MAPPING)
    jeng = JEngine(str(tmp_path_factory.mktemp("jax")), jsvc)
    tset = TSettings.from_flat(flat)
    tsvc = TMapperService(tset)
    tsvc.put_mapping("doc", MAPPING)
    teng = TEngine(str(tmp_path_factory.mktemp("port")), tsvc)
    try:
        _run_ops(jeng, batches)
        _run_ops(teng, batches)
        jctx = JShardContext(jeng.acquire_searcher(), jsvc, JSim(jset, mapper_service=jsvc))
        tctx = ShardContext(teng.acquire_searcher(), tsvc, SimilarityService(tset, tsvc),
                            device="cpu")
        assert [s.doc_count for s in tctx.searcher.segments] == \
            [s.doc_count for s in jctx.searcher.segments]
        assert len(tctx.searcher.segments) == 3
        yield jctx, tctx
    finally:
        jeng.close()
        teng.close()


def _b64(obj) -> str:
    return base64.b64encode(json.dumps(obj).encode()).decode()


QUERY_FAMILIES = {
    "match_all": [{"match_all": {}}, {"match_all": {"boost": 2.5}}],
    "term": [
        {"term": {"body": "alpha"}}, {"term": {"title": {"value": "beta", "boost": 2}}},
        {"term": {"n": 7}}, {"term": {"price": 3.5}}, {"term": {"flag": True}},
        {"term": {"tag": "blue-ish"}}, {"term": {"ts": "2014-03-03"}},
        {"term": {"nums": 3}}, {"term": {"body": "no-such-term"}},
        {"terms": {"body": ["alpha", "beta", "w3"], "minimum_should_match": 2}},
        {"in": {"nums": [1, 2]}}, {"terms": {"tag": ["green", "Red"], "boost": 1.5}},
    ],
    "match": [
        {"match": {"body": "alpha beta gamma"}},
        {"match": {"body": {"query": "alpha beta", "operator": "and"}}},
        {"match": {"title": {"query": "alpha w1 w2 delta", "minimum_should_match": "50%"}}},
        {"match": {"body": {"query": "alhpa bta", "fuzziness": 1}}},
        {"match": {"body": {"query": "gamme lamda", "fuzziness": "AUTO"}}},
        {"match": {"n": "7"}}, {"match": {"_all": "alpha zen"}},
        {"match": {"body": ""}},
    ],
    "phrase": [
        {"match_phrase": {"body": "alpha beta"}},
        {"match_phrase": {"body": {"query": "alpha gamma", "slop": 2}}},
        {"match_phrase": {"body": {"query": "beta alpha delta", "slop": 3, "boost": 2}}},
        {"match_phrase_prefix": {"body": "alpha be"}},
        {"match_phrase_prefix": {"title": {"query": "alpha ga", "max_expansions": 1}}},
        {"match": {"body": {"query": "beta gamma", "type": "phrase"}}},
        {"match": {"title": {"query": "alpha al", "type": "phrase_prefix"}}},
        {"match_phrase": {"body": "alpha"}},
        {"match_phrase": {"body": "alpha alpha"}},
        {"match_phrase": {"body": "alpha alpine alpha"}},
        {"match_phrase_prefix": {"body": "alpha alpha a"}},
    ],
    "multi_match": [
        {"multi_match": {"query": "alpha beta", "fields": ["title^2", "body"]}},
        {"multi_match": {"query": "alpha beta", "fields": ["title", "body"],
                         "type": "most_fields"}},
        {"multi_match": {"query": "gamma", "fields": ["title", "body"],
                         "tie_breaker": 0.3, "operator": "and"}},
    ],
    "bool": [
        {"bool": {"must": [{"match": {"body": "alpha"}}],
                  "filter": [{"terms": {"tag": ["red", "green"]}}]}},
        {"bool": {"must_not": [{"term": {"body": "alpha"}}]}},
        {"bool": {"filter": {"range": {"n": {"gte": 20, "lt": 90}}}, "boost": 3}},
        {"bool": {"should": [{"term": {"body": "alpha"}}, {"term": {"body": "beta"}},
                             {"match_phrase": {"body": "gamma delta"}}],
                  "minimum_should_match": 2, "filter": [{"term": {"flag": True}}]}},
        {"bool": {"must": [{"term": {"body": "beta"}}, {"term": {"n": 33}}],
                  "should": [{"term": {"title": "alpha"}}], "disable_coord": True}},
        {"bool": {"should": [{"bool": {"must": [{"term": {"body": "alpha"}},
                                                 {"term": {"body": "zen"}}]}},
                             {"prefix": {"title": "ga"}}],
                  "must_not": [{"range": {"price": {"lt": 2}}}]}},
        {"bool": {"should": [{"term": {"body": "alpha"}}], "minimum_should_match": 5}},
    ],
    "compound": [
        {"filtered": {"query": {"match": {"body": "alpha beta"}},
                      "filter": {"range": {"n": {"lte": 100}}}}},
        {"filtered": {"query": {"match_all": {}}, "filter": {"term": {"tag": "teal"}},
                      "boost": 2}},
        {"filtered": {"query": {"match_phrase": {"body": "alpha beta"}},
                      "filter": {"exists": {"field": "nums"}}}},
        {"constant_score": {"filter": {"term": {"body": "gamma"}}, "boost": 3.0}},
        {"constant_score": {"query": {"match": {"body": "delta"}}}},
        {"dis_max": {"queries": [{"term": {"body": "alpha"}}, {"term": {"title": "alpha"}}],
                     "tie_breaker": 0.5}},
        {"boosting": {"positive": {"match": {"body": "alpha"}},
                      "negative": {"term": {"body": "beta"}}, "negative_boost": 0.3}},
    ],
    "range": [
        {"range": {"n": {"gte": 10, "lt": 40}}},
        {"range": {"price": {"gt": 5.5, "lte": 12}}},
        {"range": {"ts": {"gte": "2014-03-01", "lt": "2014-06-15", "boost": 2}}},
        {"range": {"ts": {"lte": "now", "gte": "now-20000d/d"}}},
        {"range": {"n": {"from": 5, "to": 25, "include_lower": False,
                         "include_upper": False}}},
        {"range": {"tag": {"gte": "blue", "lt": "red"}}},
        {"range": {"nums": {"gte": 6}}},
    ],
    "multi_term": [
        {"prefix": {"body": "al"}}, {"prefix": {"tag": {"value": "re", "boost": 2}}},
        {"wildcard": {"body": "al*a"}}, {"wildcard": {"title": "g?me"}},
        {"regexp": {"body": "al(pha|ps)"}}, {"fuzzy": {"body": "gamme"}},
        {"fuzzy": {"body": {"value": "bett", "fuzziness": 2, "prefix_length": 1,
                            "max_expansions": 2}}},
    ],
    "ids_type": [
        {"ids": {"values": ["1", "3", "13", "120", "nope"]}},
        {"ids": {"type": "doc", "values": ["5", "6"]}},
        {"ids": {"type": "other", "values": ["5"]}},
        {"type": {"value": "doc"}},
    ],
    "query_string": [
        {"query_string": {"query": "body:alpha AND body:beta"}},
        {"query_string": {"query": "alpha -beta", "default_field": "body"}},
        {"query_string": {"query": "\"alpha beta\" OR gam*", "default_field": "body"}},
        {"query_string": {"query": "gamme~ NOT zen", "fields": ["body", "title"]}},
        {"query_string": {"query": "*", "default_field": "body"}},
        {"query_string": {"query": "alpha beta", "default_field": "body",
                          "default_operator": "AND", "boost": 2}},
        {"field": {"body": "alpha lamb"}},
    ],
    "simple_query_string": [
        {"simple_query_string": {"query": "alpha zen", "fields": ["body"]}},
        {"simple_query_string": {"query": "alpha + beta", "fields": ["body"]}},
        {"simple_query_string": {"query": "alpha -beta", "fields": ["body^2", "title"]}},
        {"simple_query_string": {"query": "\"alpha beta\"~1 gam*", "fields": ["body"]}},
        {"simple_query_string": {"query": "alpha | zen", "default_operator": "and"}},
        {"simple_query_string": "+ | - alpha"},
    ],
    "common": [
        {"common": {"body": {"query": "alpha beta zen kappa", "cutoff_frequency": 0.2}}},
        {"common": {"body": {"query": "alpha beta zen", "cutoff_frequency": 0.2,
                             "low_freq_operator": "and"}}},
        {"common": {"body": {"query": "alpha beta", "cutoff_frequency": 3,
                             "high_freq_operator": "and"}}},
    ],
    "span": [
        {"span_term": {"body": "alpha"}},
        {"span_near": {"clauses": [{"span_term": {"body": "alpha"}},
                                   {"span_term": {"body": "beta"}}], "slop": 1}},
        {"span_near": {"clauses": [{"span_term": {"body": "beta"}},
                                   {"span_term": {"body": "alpha"}}],
                       "slop": 2, "in_order": False}},
        {"span_or": {"clauses": [{"span_term": {"body": "zen"}},
                                 {"span_term": {"body": "lamb"}}], "boost": 2}},
        {"span_first": {"match": {"span_term": {"body": "alpha"}}, "end": 2}},
        {"span_not": {"include": {"span_term": {"body": "alpha"}},
                      "exclude": {"span_near": {"clauses": [
                          {"span_term": {"body": "alpha"}},
                          {"span_term": {"body": "beta"}}], "slop": 0}}}},
        {"span_multi": {"match": {"prefix": {"body": "ga"}}}},
        {"span_multi": {"match": {"wildcard": {"body": "d*l"}}}},
        {"span_multi": {"match": {"fuzzy": {"body": "lamda"}}}},
        {"span_multi": {"match": {"regexp": {"body": "ze.*"}}}},
        {"span_near": {"clauses": [
            {"span_term": {"body": "alpha"}},
            {"field_masking_span": {"query": {"span_term": {"title": "beta"}},
                                    "field": "body"}}], "slop": 5,
            "in_order": False}},
    ],
    "mlt_flt": [
        {"more_like_this": {"fields": ["body"], "like_text": "alpha beta beta gamma",
                            "min_term_freq": 1, "min_doc_freq": 1}},
        {"mlt": {"fields": ["body", "title"], "like_text": "alpha alpha zen",
                 "min_term_freq": 2, "min_doc_freq": 2, "minimum_should_match": 1}},
        {"more_like_this_field": {"body": {"like_text": "gamma delta", "min_term_freq": 1,
                                           "min_doc_freq": 1, "minimum_should_match": 1}}},
        {"mlt_field": {"title": "alpha alpha"}},
        {"fuzzy_like_this": {"fields": ["body"], "like_text": "alpah betta", "fuzziness": 1}},
        {"flt": {"like_text": "gamme", "fields": ["title"]}},
        {"flt_field": {"body": {"like_text": "zenn", "fuzziness": 1}}},
        {"fuzzy_like_this_field": {"body": "lamda"}},
    ],
    "wrapper": [
        {"wrapper": {"query": _b64({"term": {"tag": "red"}})}},
        {"wrapper": {"query": json.dumps({"match": {"body": "alpha"}})}},
    ],
}


def _hits(ctx, search, parse, q, k=30):
    td = search(ctx, parse(q), k, use_device=False)
    return td.total, td.hits


@pytest.mark.parametrize("family", list(QUERY_FAMILIES))
def test_host_queries_match_jax(ctxs, family):
    jctx, tctx = ctxs
    matched = 0
    for q in QUERY_FAMILIES[family]:
        ref = _hits(jctx, jsearch_shard, jparse_query, q)
        got = _hits(tctx, search_shard, parse_query, q)
        assert got == ref, q
        matched += ref[0]
    assert matched > 0, family


FILTER_FAMILIES = {
    "term": [{"term": {"body": "alpha"}}, {"term": {"n": 12}}, {"term": {"flag": False}},
             {"term": {"ts": "2014-05-05"}}, {"term": {"tag": "Red", "_cache": True}},
             {"terms": {"nums": [0, 5]}}, {"in": {"body": ["zen", "lamb", "nope"]}},
             {"terms": {"tag": ["teal", "green"], "execution": "bool"}}],
    "range": [{"range": {"n": {"gte": 5, "lte": 60}}}, {"numeric_range": {"price": {"lt": 4}}},
              {"range": {"ts": {"gt": "2014-02-01", "lt": "now+1d/d"}}},
              {"range": {"tag": {"gt": "Red"}}},
              {"range": {"nums": {"from": 2, "to": 4, "include_upper": False}}}],
    "prefix_regexp": [{"prefix": {"body": "ga"}}, {"prefix": {"tag": "r"}},
                      {"regexp": {"title": "(alpha|beta)"}}, {"regexp": {"tag": "[a-z]+-.*"}}],
    "exists_missing": [{"exists": {"field": "note"}}, {"missing": {"field": "note"}},
                       {"exists": {"field": "nums"}}, {"missing": {"field": "tag"}},
                       {"exists": {"field": "n"}}, {"missing": "no_such_field"}],
    "ids_type": [{"ids": {"values": ["2", "7", "120", "121"]}},
                 {"ids": {"values": ["2"], "types": ["doc"]}}, {"type": {"value": "doc"}},
                 {"match_all": {}}, {"limit": {"value": 3}}],
    "bool": [{"bool": {"must": [{"term": {"body": "alpha"}}],
                       "should": [{"term": {"tag": "red"}}, {"range": {"n": {"lt": 50}}}],
                       "must_not": [{"term": {"flag": True}}]}},
             {"and": [{"exists": {"field": "nums"}}, {"prefix": {"body": "be"}}]},
             {"and": {"filters": [{"term": {"body": "beta"}}, {"term": {"flag": True}}]}},
             {"or": [{"term": {"body": "zen"}}, {"term": {"tag": "teal"}}]},
             {"not": {"term": {"body": "alpha"}}},
             {"not": {"filter": {"missing": {"field": "note"}}}}],
    "query": [{"query": {"match_phrase": {"body": "alpha beta"}}},
              {"fquery": {"query": {"match": {"body": {"query": "gamma delta",
                                                        "operator": "and"}}}}},
              {"wrapper": {"query": '{"term": {"tag": "green"}}'}}],
}


@pytest.mark.parametrize("family", list(FILTER_FAMILIES))
def test_filters_match_jax(ctxs, family):
    jctx, tctx = ctxs
    for f in FILTER_FAMILIES[family]:
        jf, tf = jparse_filter(f), parse_filter(f)
        masks = [(jsegment_mask(js, jf, jctx), segment_mask(ts, tf, tctx))
                 for js, ts in zip(jctx.searcher.segments, tctx.searcher.segments)]
        for jm, tm in masks:
            assert tm.dtype == np.bool_ and np.array_equal(jm, tm), f
        assert any(tm.any() for _jm, tm in masks), f
        for q in ({"constant_score": {"filter": f, "boost": 2}},
                  {"filtered": {"query": {"match": {"body": "alpha beta gamma"}},
                                "filter": f}}):
            assert _hits(tctx, search_shard, parse_query, q) == \
                _hits(jctx, jsearch_shard, jparse_query, q), q


SERVICE_BODIES = [
    {"post_filter": {"term": {"tag": "red"}}, "size": 15},
    {"query": {"match": {"body": "alpha beta"}}, "filter": {"range": {"n": {"gte": 50}}}},
    {"query": {"match": {"body": "alpha beta gamma"}}, "min_score": 0.9, "size": 20},
    {"query": {"match": {"body": "gamma"}}, "min_score": 0.5,
     "post_filter": {"exists": {"field": "note"}}, "from": 3, "size": 5},
    {"query": {"match_phrase": {"body": "alpha beta"}}},
    {"query": {"term": {"n": 42}}},
    {"size": 7, "from": 2},
    {"query": {"match": {"body": "alpha"}}, "post_filter": {"term": {"tag": "none"}}},
]


def test_query_phase_host_branches_match_jax(ctxs):
    """min_score, post_filter (and `filter`), a body without a query and a
    host query, through `execute_query_phase(..., use_device=False)`."""
    jctx, tctx = ctxs
    for body in SERVICE_BODIES:
        r = jphase(jctx, jparse_body(body), use_device=False)
        g = execute_query_phase(tctx, parse_search_body(body), use_device=False)
        assert (g.total, g.docs, g.timed_out) == (r.total, r.docs, r.timed_out), body
        assert g.max_score == r.max_score or (g.max_score != g.max_score
                                              and r.max_score != r.max_score), body


def _rand_lowerable(rng):
    def term():
        return {"term": {str(rng.choice(["body", "title"])): str(rng.choice(VOCAB, p=_P))}}

    r = rng.random()
    if r < 0.35:
        q = {"match": {"body": " ".join(rng.choice(VOCAB, int(rng.integers(1, 5)), p=_P))}}
        if rng.random() < 0.3:
            q["match"]["body"] = {"query": q["match"]["body"], "operator": "and"}
        elif rng.random() < 0.3:
            q["match"]["body"] = {"query": q["match"]["body"],
                                  "minimum_should_match": int(rng.integers(1, 4))}
        return q
    if r < 0.45:
        return term()
    nb = {"should": [term() for _ in range(int(rng.integers(0, 4)))],
          "must": [term() for _ in range(int(rng.integers(0, 3)))],
          "must_not": [term() for _ in range(int(rng.integers(0, 2)))]}
    nb = {k: v for k, v in nb.items() if v}
    if not nb.get("should") and not nb.get("must"):
        nb["should"] = [term()]
    if nb.get("should") and rng.random() < 0.4:
        nb["minimum_should_match"] = int(rng.integers(1, len(nb["should"]) + 2))
    if rng.random() < 0.3:
        nb["boost"] = float(np.float32(rng.uniform(0.2, 3)))
    return {"bool": nb}


def test_device_path_agrees_with_host_scorer(ctxs):
    """Random lowerable bodies: the port's device path (plain torch on the
    CPU) against its host scorer, tie-tolerant within 2 ulp."""
    _jctx, tctx = ctxs
    rng = np.random.default_rng(20240611)
    queries = [parse_query(_rand_lowerable(rng)) for _ in range(60)]
    dev = search_shard_batch(tctx, queries, 25)
    host = search_shard_batch(tctx, queries, 25, use_device=False)
    assert sum(d.total for d in dev) > 0
    for q, d, h in zip(queries, dev, host):
        assert d.total == h.total, q
        assert _tie_tolerant_equal(d.hits, h.hits), (q, d.hits[:5], h.hits[:5])


def test_segment_from_arrays_refuses_what_it_lacks(ctxs):
    """A segment built from arrays has no ids, types or positions: phrase,
    span, ids and type evaluation raise on it instead of matching nothing;
    term-level reads work."""
    _jctx, tctx = ctxs
    own = tctx.searcher.segments[0]
    seg = segment_from_arrays(
        own.term_dict, own.post_offsets, own.post_docs, own.post_freqs, own.norms,
        {f: vars(s) for f, s in own.field_stats.items()}, own.live, own.parent_mask)
    ctx = ShardContext(Searcher([seg]), tctx.mapper_service, tctx.similarity_service,
                       device="cpu")
    assert np.array_equal(seg.postings("body", "alpha")[0], own.postings("body", "alpha")[0])
    assert seg.terms_for_field("tag") == own.terms_for_field("tag")
    assert search_shard(ctx, parse_query({"prefix": {"body": "al"}}), 5,
                        use_device=False).total > 0
    for q in ({"match_phrase": {"body": "alpha beta"}},
              {"span_first": {"match": {"span_term": {"body": "alpha"}}, "end": 2}},
              {"ids": {"values": ["1"]}}, {"type": {"value": "doc"}}):
        with pytest.raises(IllegalArgumentError, match="built from arrays"):
            search_shard(ctx, parse_query(q), 5, use_device=False)


def test_with_deletes_view_keeps_its_own_filter_cache(ctxs):
    _jctx, tctx = ctxs
    seg = tctx.searcher.segments[1]
    f = parse_filter({"term": {"body": "alpha"}})
    segment_mask(seg, f, tctx)
    assert f.key() in seg._device_cache[FILTER_CACHE_KEY]
    view = seg.with_deletes([0])
    assert FILTER_CACHE_KEY not in view._device_cache
    assert np.array_equal(segment_mask(view, f, tctx), segment_mask(seg, f, tctx))
    assert view._device_cache[FILTER_CACHE_KEY] is not seg._device_cache[FILTER_CACHE_KEY]


def test_filter_cache_stays_bounded(ctxs, monkeypatch):
    """Distinct filter keys past the byte budget evict the least recently
    used masks; a query used as a filter is never cached (its mask can read
    shard-wide statistics)."""
    from elasticsearch_tpu_torch.search import filters as tfilters

    _jctx, tctx = ctxs
    seg = tctx.searcher.segments[0].with_deletes([])  # a cache of its own
    monkeypatch.setattr(tfilters, "FILTER_CACHE_SEGMENT_BYTES", 8 * seg.doc_count)
    fs = [parse_filter({"terms": {"body": ["alpha", f"w{i}"]}}) for i in range(50)]
    for i, f in enumerate(fs):
        segment_mask(seg, f, tctx)
        if i == 20:
            segment_mask(seg, fs[0], tctx)  # a hit makes fs[0] the newest
    cache = seg._device_cache[FILTER_CACHE_KEY]
    assert sum(m.nbytes for m in cache.values()) <= 8 * seg.doc_count
    assert list(cache) == [f.key() for f in fs[-8:]]
    assert np.array_equal(segment_mask(seg, fs[3], tctx),
                          segment_mask(tctx.searcher.segments[0], fs[3], tctx))
    qf = parse_filter({"query": {"common": {"body": {"query": "alpha zen"}}}})
    segment_mask(seg, qf, tctx)
    assert qf.key() not in cache


def test_read_api_matches_jax(ctxs):
    """postings, term_positions, terms_for_field and num_values, segment by
    segment."""
    jctx, tctx = ctxs
    for js, ts in zip(jctx.searcher.segments, tctx.searcher.segments):
        for field in ("body", "tag", "_all"):
            assert ts.terms_for_field(field) == js.terms_for_field(field)
        for term in ("alpha", "zen", "nope"):
            for a, b in zip(ts.postings("body", term), js.postings("body", term)):
                assert np.array_equal(a, b)
            assert [p.tolist() for p in ts.term_positions("body", term)] == \
                [p.tolist() for p in js.term_positions("body", term)]
        for local in range(0, ts.doc_count, 7):
            for field in ("nums", "price", "ts", "flag"):
                assert np.array_equal(ts.num_values(field, local),
                                      js.num_values(field, local))


def test_parse_date_math_matches_jax():
    from elasticsearch_tpu.mapper.core import parse_date_math as jmath

    now = 1_400_000_123_456
    for v in ("now", "now-1d", "now+2h", "now/d", "now-1d/d", "now-3M/M", "now+1w/w",
              "2014-01-02", "2014-01-02T03:04:05Z", "1400000000000"):
        assert parse_date_math(v, now_ms=now) == jmath(v, now_ms=now), v
    assert parse_date_math("02.01.2014", formats=["%d.%m.%Y"]) == \
        parse_date_math("2014-01-02")
