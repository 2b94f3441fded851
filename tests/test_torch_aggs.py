"""The port's aggregations and facets against the JAX package's.

Both packages' `Engine`s index the same seeded documents (the corpus of
tests/test_device_aggs.py: a text field, a fractional `price`, a keyword
`label`, a multi-valued `tags_n` on 1 doc in 3, an integer `pop` missing on 1
doc in 7; two segments, three tombstones). For every body:

- the host collectors give the JAX package's reduced aggregations exactly
  (both numpy, sketches included);
- the card's path (the port's torch ops on CPU tensors; the JAX package's
  device path on the CPU) gives the JAX package's within the JAX package's
  own bar (`_agg_equal`: counts, keys, min and max exact; sums and averages
  rel 1e-5), and so does it against the host collectors;
- totals are exact, hits agree (host bitwise; the card within 2 ulp,
  tie-tolerant), and the port's serving counters move exactly when the
  JAX package's do (`_try_device_aggs` refuses what the JAX package's
  refuses).

Also here: the aggregating launch itself against the JAX package's
(`execute_flat_aggs`), the runtime cases of tests/test_search_runtime.py
`TestAggregations` and the facets, the multi-shard reduce
(`merge_responses`), the geo and nested aggregations and the
`geo_distance` facet (once later-slice answers, served since the mapper's
second half), the
string doc values (`dv_str`) through `merge_segments`, `with_deletes` and a
store round trip, and a device error on an aggregating or sorted body
(counted and raised: the port has no fault domains yet)."""

import numpy as np
import pytest

from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.engine import Engine as JEngine
from elasticsearch_tpu.index.segment import merge_segments as jmerge_segments
from elasticsearch_tpu.mapper.core import MapperService as JMapperService
from elasticsearch_tpu.search import ShardContext as JShardContext
from elasticsearch_tpu.search import parse_query as jparse_query
from elasticsearch_tpu.search.aggregations import bucket_cols_for as jbucket_cols_for
from elasticsearch_tpu.search.aggregations import parse_aggs as jparse_aggs
from elasticsearch_tpu.search.aggregations import reduce_aggs as jreduce_aggs
from elasticsearch_tpu.search.controller import merge_responses as jmerge_responses
from elasticsearch_tpu.search.controller import sort_docs as jsort_docs
from elasticsearch_tpu.search.execute import execute_flat_aggs as jexecute_flat_aggs
from elasticsearch_tpu.search.execute import lower_flat as jlower_flat
from elasticsearch_tpu.search.service import SERVING_COUNTERS as JCOUNTERS
from elasticsearch_tpu.search.service import _try_device_aggs as jtry_device_aggs
from elasticsearch_tpu.search.service import execute_query_phase as jphase
from elasticsearch_tpu.search.service import parse_search_body as jparse_body
from elasticsearch_tpu.search.service import reduce_and_respond as jrespond
from elasticsearch_tpu.search.similarity import SimilarityService as JSim
from elasticsearch_tpu_torch.common.settings import Settings as TSettings
from elasticsearch_tpu_torch.index.engine import Engine as TEngine
from elasticsearch_tpu_torch.index.segment import merge_segments
from elasticsearch_tpu_torch.index.store import Store
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.ops.device_index import agg_doc_rows
from elasticsearch_tpu_torch.search import (
    SERVING_COUNTERS, ShardContext, SimilarityService, execute_query_phase,
    merge_responses, parse_query, parse_search_body, search_shard, sort_docs)
from elasticsearch_tpu_torch.search import service as tservice
from elasticsearch_tpu_torch.search.aggregations import (
    bucket_cols_for, device_bucket_eligible, parse_aggs, reduce_aggs)
from elasticsearch_tpu_torch.search.execute import execute_flat_aggs, lower_flat
from elasticsearch_tpu_torch.search.filters import segment_mask
from elasticsearch_tpu_torch.search.queries import parse_filter
from elasticsearch_tpu_torch.search.service import _try_device_aggs, reduce_and_respond
from tests.test_torch_dense import _tie_tolerant_equal

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon"]
COUNTED = ("device_sparse", "device_filtered", "device_function_score",
           "device_aggs", "device_sort", "host")
BM25 = {"index.similarity.default.type": "BM25"}


def _docs() -> list[dict]:
    rng = np.random.default_rng(17)
    out = []
    for i in range(400):
        d = {"body": " ".join(rng.choice(WORDS, size=5)),
             "price": float(np.round(rng.uniform(1, 99), 2)),
             "label": WORDS[i % 5]}
        if i % 3 == 0:
            d["tags_n"] = [int(x) for x in rng.integers(1, 10, size=3)]
        if i % 7 != 0:
            d["pop"] = int(rng.integers(1, 100))
        out.append(d)
    return out


def _fill(engine, docs, refresh_at=199, deletes=(4, 44, 250)):
    for i, d in enumerate(docs):
        engine.index("doc", str(i), d)
        if i == refresh_at:
            engine.refresh()  # a second segment
    for i in deletes:
        engine.delete("doc", str(i))
    engine.refresh()


def _pair(tmp_path_factory, docs, settings=None, mapping=None, **fill):
    """(JAX context, port context, engines) over the same documents."""
    flat = settings or {}
    jset, tset = JSettings.from_flat(flat), TSettings.from_flat(flat)
    jsvc, tsvc = JMapperService(jset), TMapperService(tset)
    if mapping:
        jsvc.put_mapping("doc", mapping)
        tsvc.put_mapping("doc", mapping)
    jeng = JEngine(str(tmp_path_factory.mktemp("jax")), jsvc)
    teng = TEngine(str(tmp_path_factory.mktemp("port")), tsvc)
    _fill(jeng, docs, **fill)
    _fill(teng, docs, **fill)
    jctx = JShardContext(jeng.acquire_searcher(), jsvc, JSim(jset, mapper_service=jsvc))
    tctx = ShardContext(teng.acquire_searcher(), tsvc, SimilarityService(tset, tsvc),
                        device="cpu")
    return jctx, tctx, (jeng, teng)


@pytest.fixture(scope="module")
def ctxs(tmp_path_factory):
    jctx, tctx, engines = _pair(tmp_path_factory, _docs(), settings=BM25)
    try:
        yield jctx, tctx
    finally:
        for e in engines:
            e.close()


def _agg_equal(a, b, path=""):
    """tests/test_device_aggs.py's bar: floats rel 1e-5, the rest exact."""
    if isinstance(a, dict) and isinstance(b, dict):
        assert set(a) == set(b), (path, a, b)
        for k2 in a:
            _agg_equal(a[k2], b[k2], f"{path}.{k2}")
    elif isinstance(a, list) and isinstance(b, list):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _agg_equal(x, y, f"{path}[{i}]")
    elif a is None or b is None:
        assert a is None and b is None, (path, a, b)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-5), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _counts(counters) -> dict:
    return {k: counters[k] for k in COUNTED}


def _delta(before, counters) -> dict:
    return {k: counters[k] - before[k] for k in COUNTED if counters[k] != before[k]}


def _hits(docs):
    return [(s, d) for s, d, _v in docs]


def _both(ctxs, body, expect="device_aggs"):
    """Port and JAX on the card's path and on the host; asserts the rules of
    the module docstring and that the serving counter `expect` moved in
    both. Returns (request, port device result, port host result)."""
    jctx, tctx = ctxs
    req, jreq = parse_search_body(body), jparse_body(body)
    tb, jb = _counts(SERVING_COUNTERS), _counts(JCOUNTERS)
    dev = execute_query_phase(tctx, req, use_device=True)
    jdev = jphase(jctx, jreq, use_device=True)
    assert _delta(tb, SERVING_COUNTERS) == _delta(jb, JCOUNTERS) == {expect: 1}
    host = execute_query_phase(tctx, req, use_device=False)
    jhost = jphase(jctx, jreq, use_device=False)
    assert dev.total == jdev.total == host.total == jhost.total
    assert _hits(host.docs) == _hits(jhost.docs)
    assert _tie_tolerant_equal(_hits(dev.docs), _hits(jdev.docs))
    assert _tie_tolerant_equal(_hits(dev.docs), _hits(host.docs))
    if req.aggs:
        want_host = jreduce_aggs(jreq.aggs, jhost.agg_partials)
        assert reduce_aggs(req.aggs, host.agg_partials) == want_host
        got = reduce_aggs(req.aggs, dev.agg_partials)
        want = jreduce_aggs(jreq.aggs, jdev.agg_partials)
        for name in want:
            _agg_equal(got[name], want[name], name)
            _agg_equal(got[name], want_host[name], name)
    return req, dev, host


def test_all_metric_types_parity(ctxs):
    jctx, tctx = ctxs
    req, _dev, _host = _both(ctxs, {
        "query": {"match": {"body": "alpha beta"}}, "size": 5,
        "aggs": {"p_avg": {"avg": {"field": "price"}},
                 "p_sum": {"sum": {"field": "price"}},
                 "p_stats": {"stats": {"field": "price"}},
                 "pop_min": {"min": {"field": "pop"}},
                 "pop_max": {"max": {"field": "pop"}},
                 "p_count": {"value_count": {"field": "price"}}}})
    assert _try_device_aggs(tctx, req, 5) is not None


def test_multivalued_column_exact(ctxs):
    """Per-doc folds happen on the host, so multi-valued sums and counts are
    exact on the card too."""
    _req, dev, host = _both(ctxs, {
        "query": {"match": {"body": "gamma"}}, "size": 3,
        "aggs": {"t_sum": {"sum": {"field": "tags_n"}},
                 "t_cnt": {"value_count": {"field": "tags_n"}},
                 "t_min": {"min": {"field": "tags_n"}},
                 "t_max": {"max": {"field": "tags_n"}}}})
    aggs = parse_aggs({"t_sum": {"sum": {"field": "tags_n"}}})
    assert reduce_aggs(aggs, [{"t_sum": p["t_sum"]} for p in dev.agg_partials]) == \
        reduce_aggs(aggs, [{"t_sum": p["t_sum"]} for p in host.agg_partials])


def test_missing_column_docs(ctxs):
    _both(ctxs, {"query": {"match": {"body": "delta epsilon"}}, "size": 3,
                 "aggs": {"s": {"stats": {"field": "pop"}}}})


def test_no_matches_yields_empty_stats(ctxs):
    req, dev, _host = _both(ctxs, {
        "query": {"match": {"body": "zzzznope"}}, "size": 3,
        "aggs": {"s": {"stats": {"field": "price"}},
                 "m": {"min": {"field": "price"}}}})
    r = reduce_aggs(req.aggs, dev.agg_partials)
    assert r["s"]["count"] == 0 and r["s"]["min"] is None
    assert r["m"]["value"] is None


@pytest.mark.parametrize("aggs", [
    {"x": {"extended_stats": {"field": "price"}}},  # variance: host-only
    {"x": {"avg": {"script": "doc['price'].value * 2"}}},  # script agg
    {"x": {"terms": {"field": "label"},
           "aggs": {"s": {"cardinality": {"field": "pop"}}}}},  # sketch sub-agg
    {"x": {"terms": {"field": "label"},
           "aggs": {"s": {"terms": {"field": "pop"}}}}},  # bucket sub-agg
    {"x": {"value_count": {"field": "label"}}},  # string column
    {"x": {"cardinality": {"field": "pop"}}},  # sketch agg
    {"x": {"percentiles": {"field": "pop"}}},  # sketch agg
    {"x": {"top_hits": {"size": 2}}},
    {"x": {"global": {}, "aggs": {"n": {"value_count": {"field": "pop"}}}}},
], ids=["extended_stats", "script", "sketch_sub", "bucket_sub", "string_count",
        "cardinality", "percentiles", "top_hits", "global"])
def test_ineligible_aggs_fall_back(ctxs, aggs):
    jctx, tctx = ctxs
    body = {"query": {"match": {"body": "alpha"}}, "size": 3, "aggs": aggs}
    assert _try_device_aggs(tctx, parse_search_body(body), 3) is None
    assert jtry_device_aggs(jctx, jparse_body(body), 3, None, 0) is None
    _both(ctxs, body, expect="host")


def test_terms_agg_parity(ctxs):
    """terms on a string column and on a numeric one, with multi-valued docs
    (a doc with a value twice counts once)."""
    jctx, tctx = ctxs
    body = {"query": {"match": {"body": "alpha"}}, "size": 0,
            "aggs": {"by_label": {"terms": {"field": "label", "size": 20}},
                     "by_pop": {"terms": {"field": "pop", "size": 50}},
                     "by_tag": {"terms": {"field": "tags_n", "size": 20}}}}
    req, _dev, _host = _both(ctxs, body)
    assert _try_device_aggs(tctx, req, 1) is not None


def test_histogram_parity(ctxs):
    _both(ctxs, {"query": {"match": {"body": "beta gamma"}}, "size": 0,
                 "aggs": {"h": {"histogram": {"field": "price", "interval": 10}},
                          "hm": {"histogram": {"field": "tags_n", "interval": 2}}}})


def test_range_agg_parity(ctxs):
    """Overlapping, unbounded, keyed and empty ranges; zero-count buckets
    stay."""
    _both(ctxs, {"query": {"match": {"body": "alpha"}}, "size": 0,
                 "aggs": {"r": {"range": {"field": "price", "ranges": [
                     {"to": 30}, {"from": 20, "to": 60}, {"from": 50},
                     {"key": "none", "from": 4000, "to": 5000}]}},
                     "rm": {"range": {"field": "tags_n", "ranges": [
                         {"from": 1, "to": 5}, {"from": 5}]}}}})


def test_mixed_metric_and_bucket_aggs(ctxs):
    _both(ctxs, {"query": {"match": {"body": "delta"}}, "size": 3,
                 "aggs": {"by_label": {"terms": {"field": "label"}},
                          "p_avg": {"avg": {"field": "price"}},
                          "h": {"histogram": {"field": "price", "interval": 25}}}})


def test_filtered_query_with_aggs(ctxs):
    _both(ctxs, {"query": {"filtered": {"query": {"match": {"body": "alpha"}},
                                        "filter": {"range": {"pop": {"gte": 50}}}}},
                 "size": 3,
                 "aggs": {"p_avg": {"avg": {"field": "price"}},
                          "by_label": {"terms": {"field": "label"}}}})


def test_filtered_query_device_topk(ctxs):
    jctx, tctx = ctxs
    qd = {"filtered": {"query": {"match": {"body": "beta gamma"}},
                       "filter": {"term": {"label": "gamma"}}, "boost": 1.5}}
    plan = lower_flat(parse_query(qd), tctx)
    assert plan is not None and plan.filt is not None
    dev = search_shard(tctx, parse_query(qd), 10, use_device=True)
    host = search_shard(tctx, parse_query(qd), 10, use_device=False)
    assert dev.total == host.total > 0
    assert _tie_tolerant_equal(dev.hits, host.hits)


def test_date_histogram_parity(tmp_path_factory):
    docs = [{"body": "alpha", "ts": f"2014-{(i % 3) + 1:02d}-{(i % 27) + 1:02d}"}
            for i in range(90)]
    jctx, tctx, engines = _pair(tmp_path_factory, docs, refresh_at=44, deletes=(5,))
    try:
        req, _d, _h = _both((jctx, tctx), {
            "query": {"match": {"body": "alpha"}}, "size": 0,
            "aggs": {"d": {"date_histogram": {"field": "ts", "interval": "month"}},
                     "w": {"date_histogram": {"field": "ts", "interval": "week"}},
                     "r": {"date_range": {"field": "ts", "ranges": [
                         {"to": "2014-02-01"}, {"from": "2014-02-01"}]}}}})
        assert _try_device_aggs(tctx, req, 1) is not None
    finally:
        for e in engines:
            e.close()


def test_trailing_valueless_docs_dont_truncate_minmax(tmp_path_factory):
    """A value-less doc after a multi-valued one must not cut the previous
    doc's run: max([1, 9]) is 9 in the folds and on the card."""
    docs = [{"body": "alpha", "v": [1, 9]}, {"body": "alpha"}]
    jctx, tctx, engines = _pair(tmp_path_factory, docs, refresh_at=-1, deletes=())
    try:
        rows = agg_doc_rows(tctx.searcher.segments[0], "v")
        assert rows[3][0] == 9.0 and rows[2][0] == 1.0
        req, dev, _h = _both((jctx, tctx), {"query": {"match": {"body": "alpha"}},
                                            "aggs": {"m": {"max": {"field": "v"}}}})
        assert reduce_aggs(req.aggs, dev.agg_partials)["m"]["value"] == 9.0
    finally:
        for e in engines:
            e.close()


def test_f32_inexact_column_falls_back_to_host(tmp_path_factory):
    """Integers past 2^24 are not float32-exact: the card refuses them and
    the host collectors serve the exact value."""
    big = 1_700_000_000_123
    docs = [{"body": "alpha", "ts_l": big + i} for i in range(5)]
    jctx, tctx, engines = _pair(tmp_path_factory, docs, refresh_at=-1, deletes=())
    try:
        body = {"query": {"match": {"body": "alpha"}},
                "aggs": {"m": {"max": {"field": "ts_l"}}}}
        assert _try_device_aggs(tctx, parse_search_body(body), 3) is None
        req, dev, _h = _both((jctx, tctx), body, expect="host")
        assert reduce_aggs(req.aggs, dev.agg_partials)["m"]["value"] == big + 4
    finally:
        for e in engines:
            e.close()


def test_unlowerable_query_falls_back(ctxs):
    jctx, tctx = ctxs
    body = {"query": {"match_all": {}}, "aggs": {"a": {"avg": {"field": "price"}}}}
    assert _try_device_aggs(tctx, parse_search_body(body), 3) is None
    req, dev, _h = _both(ctxs, body, expect="host")
    assert reduce_aggs(req.aggs, dev.agg_partials)["a"]["value"] is not None


@pytest.mark.parametrize("spec,eligible", [
    ({"date_range": {"field": "pop", "ranges": [{"from": "now-1h"}]}}, False),
    ({"range": {"field": "pop", "ranges": [{"from": 10, "to": 20}]}}, True),
    ({"filter": {"range": {"pop": {"gte": "now-1h"}}}}, False),
    ({"filter": {"range": {"pop": {"gte": 5}}}}, True),
], ids=["date_math_range", "range", "date_math_filter", "filter"])
def test_date_math_bounds_stay_host(spec, eligible):
    """`now`-relative bounds re-resolve per query on the host, while the
    device pair cache lives per segment: such specs refuse the card."""
    assert device_bucket_eligible(parse_aggs({"r": spec})["r"]) is eligible


def test_mask_shaped_bucket_aggs_parity(ctxs):
    """filter, filters and missing ride the count scatter with host masks."""
    _both(ctxs, {"query": {"match": {"body": "alpha"}}, "size": 0,
                 "aggs": {"f": {"filter": {"range": {"pop": {"gte": 50}}}},
                          "fs": {"filters": {"filters": {
                              "cheap": {"range": {"price": {"lte": 30}}},
                              "tagged": {"exists": {"field": "tags_n"}}}}},
                          "no_pop": {"missing": {"field": "pop"}}}})


def test_significant_terms_parity(ctxs):
    req, dev, _h = _both(ctxs, {
        "query": {"match": {"body": "alpha beta"}}, "size": 0,
        "aggs": {"sig": {"significant_terms": {"field": "label", "size": 10}}}})
    r = reduce_aggs(req.aggs, dev.agg_partials)
    assert all("bg_count" in b and b["bg_count"] >= b["doc_count"] >= 1
               for b in r["sig"]["buckets"])


def test_metric_sub_aggs_under_buckets_parity(ctxs):
    """Buckets with metric sub-aggs, all in the launch."""
    jctx, tctx = ctxs
    body = {"query": {"match": {"body": "alpha beta"}}, "size": 0, "aggs": {
        "by_label": {"terms": {"field": "label", "size": 20},
                     "aggs": {"p_avg": {"avg": {"field": "price"}},
                              "p_stats": {"stats": {"field": "price"}},
                              "pop_max": {"max": {"field": "pop"}}}},
        "by_range": {"range": {"field": "price", "ranges": [{"to": 40}, {"from": 40}]},
                     "aggs": {"t_sum": {"sum": {"field": "tags_n"}}}},
        "no_pop": {"missing": {"field": "pop"},
                   "aggs": {"p_min": {"min": {"field": "price"}}}}}}
    _both(ctxs, body)
    assert _try_device_aggs(tctx, parse_search_body(body), 1) is not None


def test_sub_agg_empty_buckets_parity(ctxs):
    _both(ctxs, {"query": {"match": {"body": "gamma"}}, "size": 0,
                 "aggs": {"r": {"range": {"field": "price",
                                          "ranges": [{"from": 5000, "to": 6000}]},
                                "aggs": {"a": {"avg": {"field": "pop"}},
                                         "m": {"min": {"field": "pop"}}}}}})


def test_sub_agg_multivalued_exact(ctxs):
    _both(ctxs, {"query": {"match": {"body": "delta"}}, "size": 0,
                 "aggs": {"by_label": {"terms": {"field": "label"},
                                       "aggs": {"t": {"sum": {"field": "tags_n"}},
                                                "tc": {"value_count": {"field": "tags_n"}}}}}})


def test_post_filter_device_parity(ctxs):
    """Hits post-filtered, aggs over the whole match set (the faceting
    idiom): one aggregating and one filtered launch, one pull."""
    req, dev, _h = _both(ctxs, {
        "query": {"match": {"body": "alpha"}}, "size": 10,
        "post_filter": {"range": {"pop": {"gte": 50}}},
        "aggs": {"by_label": {"terms": {"field": "label"}},
                 "p_avg": {"avg": {"field": "price"}}}}, expect="device_filtered")
    _jctx, tctx = ctxs
    full = execute_query_phase(tctx, parse_search_body(
        {"query": {"match": {"body": "alpha"}}, "size": 0}))
    assert dev.total < full.total
    r = reduce_aggs(req.aggs, dev.agg_partials)
    assert sum(b["doc_count"] for b in r["by_label"]["buckets"]) == full.total


def test_post_filter_with_filtered_query(ctxs):
    _both(ctxs, {"query": {"filtered": {"query": {"match": {"body": "beta"}},
                                        "filter": {"range": {"price": {"lte": 70}}}}},
                 "size": 8, "post_filter": {"term": {"label": "gamma"}},
                 "aggs": {"s": {"stats": {"field": "pop"}}}}, expect="device_filtered")


@pytest.mark.parametrize("body,expect", [
    ({"query": {"match": {"body": "alpha beta"}}, "size": 10, "min_score": 0.8},
     "device_filtered"),
    ({"query": {"match": {"body": "alpha beta"}}, "size": 10, "min_score": 0.8,
      "aggs": {"s": {"stats": {"field": "pop"}}}}, "host"),
    ({"query": {"match": {"body": "alpha"}}, "size": 5,
      "post_filter": {"term": {"label": "beta"}},
      "aggs": {"c": {"cardinality": {"field": "pop"}}}}, "host"),
    ({"query": {"function_score": {"query": {"match": {"body": "alpha"}},
                                   "boost_factor": 2}}, "size": 5,
      "aggs": {"s": {"sum": {"field": "pop"}}}}, "host"),
], ids=["min_score", "min_score_aggs", "post_filter_host_agg", "function_score_aggs"])
def test_min_score_and_refusals_parity(ctxs, body, expect):
    _both(ctxs, body, expect=expect)


@pytest.mark.parametrize("fields,buckets", [
    (["price", "pop"], []),
    ([], [({"terms": {"field": "label"}}, None),
          ({"histogram": {"field": "price", "interval": 20}}, ["pop"])]),
    (["tags_n"], [({"range": {"field": "pop", "ranges": [{"to": 50}, {"from": 50}]}},
                   ["price", "tags_n"])]),
], ids=["metrics", "buckets", "both"])
def test_execute_flat_aggs_matches_jax(ctxs, fields, buckets):
    """The aggregating launch itself, per segment: counts, bucket keys and
    counts, min and max exact; sums within rel 1e-5; the top-k within 2
    ulp."""
    jctx, tctx = ctxs
    q = {"match": {"body": "alpha epsilon"}}
    spec = {f"b{i}": s for i, (s, _o) in enumerate(buckets)}
    jaggs, taggs = jparse_aggs(spec), parse_aggs(spec)
    jtd, jstats = jexecute_flat_aggs(
        jlower_flat(jparse_query(q), jctx), jctx, 20, fields,
        [(jaggs[f"b{i}"], o) for i, (_s, o) in enumerate(buckets)])
    td, stats = execute_flat_aggs(
        lower_flat(parse_query(q), tctx), tctx, 20, fields,
        [(taggs[f"b{i}"], o) for i, (_s, o) in enumerate(buckets)])
    assert td.total == jtd.total
    assert _tie_tolerant_equal(td.hits, jtd.hits)
    for (c, st, bk), (jc, jst, jbk) in zip(stats, jstats):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(st[:, 1:3], jst[:, 1:3])
        np.testing.assert_allclose(st[:, [0, 3]], jst[:, [0, 3]], rtol=1e-5)
        for (keys, bc, sc, ss), (jkeys, jbc, jsc, jss) in zip(bk, jbk):
            assert keys == jkeys
            np.testing.assert_array_equal(bc[: len(keys)], jbc[: len(keys)])
            assert (sc is None) == (jsc is None)
            if sc is not None:
                np.testing.assert_array_equal(sc[:, : len(keys)], jsc[:, : len(keys)])
                np.testing.assert_array_equal(ss[:, : len(keys), 1:3],
                                              jss[:, : len(keys), 1:3])
                np.testing.assert_allclose(ss[:, : len(keys), [0, 3]],
                                           jss[:, : len(keys), [0, 3]], rtol=1e-5)


def test_bucket_pairs_match_jax(ctxs):
    """The host-built (doc, bucket) pairs of every bucket agg kind."""
    jctx, tctx = ctxs
    spec = {"t": {"terms": {"field": "label"}}, "tn": {"terms": {"field": "tags_n"}},
            "h": {"histogram": {"field": "price", "interval": 7}},
            "r": {"range": {"field": "pop", "ranges": [{"to": 30}, {"from": 20}]}},
            "f": {"filters": {"filters": {"a": {"term": {"label": "beta"}},
                                          "b": {"range": {"pop": {"lt": 9}}}}}},
            "m": {"missing": {"field": "tags_n"}},
            "s": {"significant_terms": {"field": "label"}}}
    jaggs, taggs = jparse_aggs(spec), parse_aggs(spec)
    for jseg, tseg in zip(jctx.searcher.segments, tctx.searcher.segments):
        for name in spec:
            jd, jb, jk = jbucket_cols_for(jaggs[name], jseg, jctx)
            td, tb, tk = bucket_cols_for(taggs[name], tseg, tctx)
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tb, jb)
            assert tk == jk


GEO_MAPPING = {"properties": {
    "loc": {"type": "geo_point"},
    "comments": {"type": "nested", "properties": {
        "who": {"type": "string", "index": "not_analyzed"},
        "stars": {"type": "integer"}}}}}
CITIES = [(40.71, -74.0), (51.5, -0.12), (48.86, 2.35), (35.68, 139.69)]


def _geo_docs() -> list[dict]:
    rng = np.random.default_rng(23)
    out = []
    for i in range(300):
        lat, lon = CITIES[i % len(CITIES)]
        d = {"body": " ".join(rng.choice(WORDS, size=4)),
             "loc": {"lat": float(lat + rng.normal(0, 0.3)),
                     "lon": float(lon + rng.normal(0, 0.3))},
             "comments": [{"who": WORDS[int(rng.integers(5))],
                           "stars": int(rng.integers(1, 6))}
                          for _ in range(int(rng.integers(0, 4)))]}
        if i % 11 == 0:
            d.pop("loc")
        out.append(d)
    return out


@pytest.fixture(scope="module")
def geo_ctxs(tmp_path_factory):
    """Two segments with tombstoned nested blocks, points around 4 cities."""
    jctx, tctx, engines = _pair(tmp_path_factory, _geo_docs(), settings=BM25,
                                mapping=GEO_MAPPING, refresh_at=149)
    try:
        yield jctx, tctx
    finally:
        for e in engines:
            e.close()


GEO_AGGS = {
    "geo_bounds": ({"geo_bounds": {"field": "loc"}}, "host"),
    "geo_distance": ({"geo_distance": {
        "field": "loc", "origin": {"lat": 51.5, "lon": -0.12}, "unit": "km",
        "ranges": [{"to": 20}, {"from": 20, "to": 400}, {"from": 400}]},
        "aggs": {"s": {"sum": {"field": "comments.stars"}}}}, "device_aggs"),
    "geohash_grid": ({"geohash_grid": {"field": "loc", "precision": 3}},
                     "device_aggs"),
    "nested": ({"nested": {"path": "comments"},
                "aggs": {"avg_stars": {"avg": {"field": "comments.stars"}},
                         "who": {"terms": {"field": "comments.who"}}}}, "host"),
}


@pytest.mark.parametrize("kind", ["geo_bounds", "geo_distance", "geohash_grid",
                                  "nested"])
def test_later_slice_aggs_answer_400(geo_ctxs, kind):
    """Served since the mapper's second half: each aggregation gives the JAX
    package's answer on the card's path and the host's, and takes the same
    branch (the geo buckets ride the aggregating launch, `geo_bounds` and
    `nested` go to the host collectors, as in the JAX package)."""
    spec, expect = GEO_AGGS[kind]
    req, _dev, host = _both(geo_ctxs, {
        "query": {"match": {"body": "alpha gamma"}}, "size": 5,
        "aggs": {"x": spec}}, expect=expect)
    got = reduce_aggs(req.aggs, host.agg_partials)["x"]
    if kind == "geo_bounds":
        assert got["bounds"]["top_left"]["lat"] > got["bounds"]["bottom_right"]["lat"]
    elif kind == "nested":
        assert got["doc_count"] > 0 and got["who"]["buckets"]
    else:
        assert sum(b["doc_count"] for b in got["buckets"]) > 0


def test_geo_distance_facet_answers_400(geo_ctxs):
    """Served: the `geo_distance` facet answers the JAX node's ranges."""
    jctx, tctx = geo_ctxs
    body = {"query": {"match_all": {}}, "size": 0, "facets": {"x": {"geo_distance": {
        "field": "loc", "origin": "40.71,-74.0", "unit": "km",
        "ranges": [{"to": 30}, {"from": 30, "to": 6000}, {"from": 6000}]}}}}
    req, jreq = parse_search_body(body), jparse_body(body)
    for use_device in (True, False):
        got = reduce_and_respond(tctx, req, execute_query_phase(
            tctx, req, use_device=use_device))
        want = jrespond(jctx, jreq, jphase(jctx, jreq, use_device=use_device))
        assert got["facets"] == want["facets"]
        assert sum(r["count"] for r in got["facets"]["x"]["ranges"]) > 0


def test_device_error_is_counted_and_raised(ctxs, monkeypatch):
    """No fault domains in the port yet: a device error on an aggregating or
    sorted body is counted and reaches the caller (the JAX package serves
    such a body on the host scorer instead)."""
    _jctx, tctx = ctxs

    def boom(*a, **k):
        raise RuntimeError("device backend unavailable")

    monkeypatch.setattr(tservice, "launch_flat_aggs", boom)
    monkeypatch.setattr(tservice, "launch_flat_sorted", boom)
    for body in ({"query": {"match": {"body": "alpha"}}, "size": 0,
                  "aggs": {"m": {"max": {"field": "pop"}}}},
                 {"query": {"match": {"body": "alpha"}}, "sort": [{"pop": "asc"}],
                  "size": 5}):
        before = SERVING_COUNTERS["device_errors"]
        with pytest.raises(RuntimeError, match="unavailable"):
            execute_query_phase(tctx, parse_search_body(body), use_device=True)
        assert SERVING_COUNTERS["device_errors"] == before + 1
        host = execute_query_phase(tctx, parse_search_body(body), use_device=False)
        assert host.total > 0


# -- tests/test_search_runtime.py TestAggregations, and the facets -----------

PRODUCTS = [
    {"name": "red widget deluxe", "category": "widgets", "price": 10, "stock": 5,
     "created": "2014-01-15"},
    {"name": "blue widget", "category": "widgets", "price": 20, "stock": 0,
     "created": "2014-01-20"},
    {"name": "green gadget", "category": "gadgets", "price": 30, "stock": 7,
     "created": "2014-02-05"},
    {"name": "red gadget pro", "category": "gadgets", "price": 40, "stock": 2,
     "created": "2014-02-10"},
    {"name": "yellow gizmo", "category": "gizmos", "price": 50, "stock": 1,
     "created": "2014-03-01"},
    {"name": "red gizmo mini widget", "category": "gizmos", "price": 60, "stock": 9,
     "created": "2014-03-15"},
]
PRODUCT_MAPPING = {"properties": {
    "name": {"type": "string"},
    "category": {"type": "string", "index": "not_analyzed"},
    "price": {"type": "long"}, "stock": {"type": "long"},
    "created": {"type": "date"}}}


@pytest.fixture(scope="module")
def products(tmp_path_factory):
    jctx, tctx, engines = _pair(tmp_path_factory, PRODUCTS, mapping=PRODUCT_MAPPING,
                                refresh_at=2, deletes=())
    try:
        yield jctx, tctx
    finally:
        for e in engines:
            e.close()


RUNTIME_BODIES = {
    "metrics": {"size": 0, "aggs": {
        "avg_price": {"avg": {"field": "price"}},
        "sum_price": {"sum": {"field": "price"}},
        "minmax": {"stats": {"field": "price"}},
        "ext": {"extended_stats": {"field": "price"}},
        "n": {"value_count": {"field": "price"}},
        "card": {"cardinality": {"field": "category"}},
        "pct": {"percentiles": {"field": "price", "percents": [50]}}}},
    "terms_sub_order": {"size": 0, "aggs": {
        "cats": {"terms": {"field": "category", "order": {"avg_price": "desc"}},
                 "aggs": {"avg_price": {"avg": {"field": "price"}}}}}},
    "terms_query": {"query": {"match": {"name": "red"}}, "size": 0, "aggs": {
        "cats": {"terms": {"field": "category"}}}},
    "terms_query_device": {"query": {"match": {"name": "red widget"}}, "size": 2,
                           "aggs": {"cats": {"terms": {"field": "category"},
                                             "aggs": {"s": {"stats": {"field": "stock"}}}},
                                    "h": {"histogram": {"field": "price",
                                                        "interval": 20}}}},
    "range_histograms": {"size": 0, "aggs": {
        "ranges": {"range": {"field": "price", "ranges": [
            {"to": 25}, {"from": 25, "to": 45}, {"from": 45}]}},
        "hist": {"histogram": {"field": "price", "interval": 20}},
        "ext_hist": {"histogram": {"field": "price", "interval": 20,
                                   "extended_bounds": {"min": -40, "max": 100}}},
        "by_month": {"date_histogram": {"field": "created", "interval": "month"}}}},
    "filter_global_missing": {"query": {"term": {"category": "widgets"}}, "size": 0,
                              "aggs": {"expensive": {"filter": {"range": {"price": {"gte": 15}}}},
                                       "all_docs": {"global": {}, "aggs": {
                                           "n": {"value_count": {"field": "price"}}}},
                                       "no_stock": {"missing": {"field": "nope"}}}},
    "filters": {"size": 0, "aggs": {"groups": {"filters": {"filters": {
        "cheap": {"range": {"price": {"lt": 30}}},
        "red": {"query": {"match": {"name": "red"}}}}}}}},
    "top_hits": {"size": 0, "aggs": {
        "cats": {"terms": {"field": "category", "order": {"_term": "asc"}},
                 "aggs": {"top": {"top_hits": {"size": 1}}}}}},
    "facets": {"size": 0, "facets": {
        "cats": {"terms": {"field": "category"}},
        "price_stats": {"statistical": {"field": "price"}},
        "hist": {"histogram": {"field": "price", "interval": 25}},
        "months": {"date_histogram": {"field": "created", "interval": "month"}},
        "ranges": {"range": {"field": "price", "ranges": [{"to": 35}, {"from": 35}]}},
        "red": {"query": {"match": {"name": "red"}}},
        "cheap": {"filter": {"range": {"price": {"lt": 30}}}},
        "ts": {"terms_stats": {"key_field": "category", "value_field": "stock"}}}},
    "facets_with_query_and_post_filter": {
        "query": {"match": {"name": "red widget"}}, "size": 3,
        "post_filter": {"term": {"category": "widgets"}},
        "facets": {"cats": {"terms": {"field": "category"}}},
        "aggs": {"cats": {"terms": {"field": "category"}}}},
}


@pytest.mark.parametrize("name", list(RUNTIME_BODIES))
def test_search_runtime_aggregations(products, name):
    """The same response — hits, aggregations and facets — from both
    packages (the host collectors bitwise, the card within rel 1e-5)."""
    jctx, tctx = products
    body = RUNTIME_BODIES[name]
    req, jreq = parse_search_body(body), jparse_body(body)
    got = reduce_and_respond(tctx, req, execute_query_phase(tctx, req))
    want = jrespond(jctx, jreq, jphase(jctx, jreq))
    assert [(h["_id"], h["sort"] if "sort" in h else None)
            for h in got["hits"]["hits"]] == \
        [(h["_id"], h["sort"] if "sort" in h else None) for h in want["hits"]["hits"]]
    assert got["hits"]["total"] == want["hits"]["total"]
    _agg_equal(got.get("aggregations"), want.get("aggregations"))
    assert got.get("facets") == want.get("facets")
    host = reduce_and_respond(tctx, req, execute_query_phase(tctx, req, use_device=False))
    assert host.get("aggregations") == jrespond(
        jctx, jreq, jphase(jctx, jreq, use_device=False)).get("aggregations")


def test_runtime_values(products):
    """A few of tests/test_search_runtime.py's absolute expectations."""
    _jctx, tctx = products
    req = parse_search_body(RUNTIME_BODIES["metrics"])
    a = reduce_and_respond(tctx, req, execute_query_phase(tctx, req))["aggregations"]
    assert a["minmax"] == {"count": 6, "sum": 210.0, "min": 10.0, "max": 60.0,
                           "avg": 35.0}
    assert a["card"]["value"] == 3 and a["pct"]["values"]["50.0"] == pytest.approx(35.0)
    req = parse_search_body(RUNTIME_BODIES["terms_sub_order"])
    b = reduce_and_respond(tctx, req, execute_query_phase(tctx, req))
    assert [x["key"] for x in b["aggregations"]["cats"]["buckets"]] == \
        ["gizmos", "gadgets", "widgets"]


def test_agg_reduce_across_shards(tmp_path_factory):
    """tests/test_multishard.py::test_agg_reduce_across_shards on both
    packages: per-shard partials reduce in `merge_responses`."""
    rng = np.random.default_rng(123)
    shards = []
    try:
        for si in range(4):
            docs = [{"body": " ".join(rng.choice(WORDS, size=int(rng.integers(3, 9)))),
                     "shard": si} for _ in range(32)]
            shards.append(_pair(tmp_path_factory, docs, settings=BM25, refresh_at=15,
                                deletes=()))
        body = {"size": 0, "aggs": {"by_shard": {"terms": {"field": "shard"}},
                                    "n": {"value_count": {"field": "shard"}},
                                    "c": {"cardinality": {"field": "shard"}}},
                "facets": {"f": {"terms": {"field": "shard"}}}}
        for q in (None, {"match": {"body": "alpha"}}):
            b = dict(body, **({"query": q} if q else {}))
            req, jreq = parse_search_body(b), jparse_body(b)
            res = [execute_query_phase(t, req, shard_id=si)
                   for si, (_j, t, _e) in enumerate(shards)]
            jres = [jphase(j, jreq, shard_id=si) for si, (j, _t, _e) in enumerate(shards)]
            got = merge_responses(req, sort_docs(req, res), res, [], took_ms=1,
                                  total_shards=4, successful=4)
            want = jmerge_responses(jreq, jsort_docs(jreq, jres), jres, [], took_ms=1,
                                    total_shards=4, successful=4)
            assert got["aggregations"] == want["aggregations"]
            assert got["facets"] == want["facets"]
            assert got["hits"]["total"] == want["hits"]["total"]
        assert got["aggregations"]["n"]["value"] == got["hits"]["total"]
    finally:
        for _j, _t, engines in shards:
            for e in engines:
                e.close()


# -- string doc values ------------------------------------------------------

def test_dv_str_through_merge_deletes_and_store(tmp_path_factory, tmp_path):
    """`dv_str` is the JAX package's layout (sorted values, offsets,
    ordinals), carried through `merge_segments` (deleted docs dropped),
    `with_deletes` and a store round trip; `exists` reads it, so a value
    that analyzes to no token exists, as in the JAX package."""
    docs = [{"body": "alpha", "tag": ["b", "a"] if i % 3 else "", "kw": f"k{i % 4}"}
            for i in range(30)]
    docs[5] = {"body": "alpha", "tag": "!!!"}
    mapping = {"properties": {"kw": {"type": "string", "index": "not_analyzed"}}}
    jctx, tctx, engines = _pair(tmp_path_factory, docs, mapping=mapping,
                                refresh_at=14, deletes=(3, 20))
    try:
        for jseg, tseg in zip(jctx.searcher.segments, tctx.searcher.segments):
            assert set(tseg.dv_str) == set(jseg.dv_str)
            for f, (uniq, off, ords) in tseg.dv_str.items():
                juniq, joff, jords = jseg.dv_str[f]
                assert uniq == juniq
                np.testing.assert_array_equal(off, joff)
                np.testing.assert_array_equal(ords, jords)
            for f in ("tag", "kw", "missing_field"):
                assert [tseg.str_values(f, i) for i in range(tseg.doc_count)] == \
                    [jseg.str_values(f, i) for i in range(jseg.doc_count)]
            for flt in ({"exists": {"field": "tag"}}, {"missing": {"field": "tag"}}):
                from elasticsearch_tpu.search.filters import segment_mask as jmask
                from elasticsearch_tpu.search.queries import parse_filter as jpf
                np.testing.assert_array_equal(segment_mask(tseg, parse_filter(flt), tctx),
                                              jmask(jseg, jpf(flt), jctx))
        tsegs, jsegs = tctx.searcher.segments, jctx.searcher.segments
        merged, jmerged = merge_segments(tsegs, 9), jmerge_segments(jsegs, 9)
        assert merged.doc_count == jmerged.doc_count == 28
        for f in ("tag", "kw"):
            assert merged.dv_str[f][0] == jmerged.dv_str[f][0]
            np.testing.assert_array_equal(merged.dv_str[f][1], jmerged.dv_str[f][1])
            np.testing.assert_array_equal(merged.dv_str[f][2], jmerged.dv_str[f][2])
        view = tsegs[0].with_deletes([0])
        assert view.dv_str is tsegs[0].dv_str and view.str_values("kw", 1) == ["k1"]
        store = Store(str(tmp_path / "store"))
        store.write_segment(merged)
        back = store.read_segment(merged.gen)
        for f in merged.dv_str:
            assert back.dv_str[f][0] == merged.dv_str[f][0]
            np.testing.assert_array_equal(back.dv_str[f][1], merged.dv_str[f][1])
            np.testing.assert_array_equal(back.dv_str[f][2], merged.dv_str[f][2])
        assert [back.str_values("tag", i) for i in range(back.doc_count)] == \
            [merged.str_values("tag", i) for i in range(merged.doc_count)]
        assert not hasattr(back, "str_counts")
    finally:
        for e in engines:
            e.close()


def test_string_terms_and_script_agg_parity(tmp_path_factory):
    """A terms agg and a script over string doc values, and a value count
    of a string column, on both packages."""
    docs = [{"body": "alpha beta" if i % 2 else "alpha", "kw": f"k{i % 5}",
             "n": i % 7} for i in range(50)]
    mapping = {"properties": {"kw": {"type": "string", "index": "not_analyzed"}}}
    jctx, tctx, engines = _pair(tmp_path_factory, docs, mapping=mapping,
                                refresh_at=20, deletes=(7,))
    try:
        _both((jctx, tctx), {"query": {"match": {"body": "alpha"}}, "size": 4,
                             "aggs": {"kw": {"terms": {"field": "kw"},
                                             "aggs": {"s": {"sum": {"field": "n"}}}}}})
        _both((jctx, tctx), {"query": {"match": {"body": "beta"}}, "size": 0,
                             "aggs": {"vc": {"value_count": {"field": "kw"}},
                                      "c": {"cardinality": {"field": "kw"}},
                                      "sc": {"sum": {"script": "1 if doc['kw'].value == 'k1' else 0"}}}},
              expect="host")
    finally:
        for e in engines:
            e.close()
