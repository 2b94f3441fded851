"""The port's field sort against the JAX package's.

Both packages' `Engine`s index the same seeded documents (the corpus of
tests/test_device_sort.py: a text field, an integer `rank` missing on 1 doc
in 6, a fractional `price_frac`, a multi-valued `multi` on 1 doc in 5; two
segments and three tombstones). For every body:

- `execute_query_phase` on the card's path (the port's torch ops on CPU
  tensors; the JAX package's device path on the CPU) and on the host scorer
  give the same total, the same hits in the same order (ties by doc
  ascending) and identical sort values; `track_scores` scores within 2 ulp;
- the port's `device_sort`, `device_aggs` and `host` counters move exactly
  when the JAX package's do (`_try_device_sort` refuses what the JAX
  package's refuses).

Also here: -0.0 and +0.0 keys tie as the JAX package's `lax.top_k` breaks
them (-0.0 below +0.0 inside a segment's launch), the multi-shard merge of
sort values (`sort_docs`), the runtime cases of tests/test_search_runtime.py
`TestSort` and the later-slice answer to `_geo_distance`."""

import math

import numpy as np
import pytest

from elasticsearch_tpu.search.aggregations import reduce_aggs as jreduce_aggs
from elasticsearch_tpu.search.controller import sort_docs as jsort_docs
from elasticsearch_tpu.search.execute import execute_flat_sorted as jexecute_flat_sorted
from elasticsearch_tpu.search.execute import lower_flat as jlower_flat
from elasticsearch_tpu.search.service import SERVING_COUNTERS as JCOUNTERS
from elasticsearch_tpu.search.service import ShardQueryResult as JShardQueryResult
from elasticsearch_tpu.search.service import _try_device_sort as jtry_device_sort
from elasticsearch_tpu.search.service import execute_query_phase as jphase
from elasticsearch_tpu.search.service import parse_search_body as jparse_body
from elasticsearch_tpu.search.service import reduce_and_respond as jrespond
from elasticsearch_tpu.search.sorting import parse_sort as jparse_sort
from elasticsearch_tpu_torch.search import (
    SERVING_COUNTERS, ShardQueryResult, execute_query_phase, parse_search_body,
    sort_docs)
from elasticsearch_tpu_torch.search import execute as texecute
from elasticsearch_tpu_torch.search.aggregations import reduce_aggs
from elasticsearch_tpu_torch.search.execute import execute_flat_sorted, lower_flat
from elasticsearch_tpu_torch.search.service import _try_device_sort, reduce_and_respond
from elasticsearch_tpu_torch.search.sorting import parse_sort
from tests.test_torch_aggs import _counts, _delta, _pair
from tests.test_torch_dense import _within_ulps

WORDS = ["alpha", "beta", "gamma", "delta"]


def _docs() -> list[dict]:
    rng = np.random.default_rng(31)
    out = []
    for i in range(300):
        d = {"body": " ".join(rng.choice(WORDS, size=5)),
             "rank": int(rng.integers(0, 5000)),
             "price_frac": float(np.round(rng.uniform(1, 99), 2))}
        if i % 6 == 0:
            del d["rank"]  # missing values
        if i % 5 == 0:
            d["multi"] = [int(x) for x in rng.integers(0, 100, size=3)]
        out.append(d)
    return out


@pytest.fixture(scope="module")
def ctxs(tmp_path_factory):
    jctx, tctx, engines = _pair(tmp_path_factory, _docs(), refresh_at=149,
                                deletes=(7, 70, 200))
    try:
        yield jctx, tctx
    finally:
        for e in engines:
            e.close()


def _same_docs(got, want, ulps=None):
    """Identical (global doc, sort values) in order; scores NaN together,
    else equal (within `ulps` when given)."""
    assert [(d, v) for _s, d, v in got] == [(d, v) for _s, d, v in want]
    for (gs, _g, _v), (ws, _w, _x) in zip(got, want):
        assert math.isnan(gs) == math.isnan(ws)
        if not math.isnan(gs):
            assert (gs == ws) if ulps is None else _within_ulps(gs, ws, ulps)


def _both(ctxs, body, expect_device=True):
    """Port and JAX on the card's path and on the host; returns the port's
    (device, host) results and the request."""
    jctx, tctx = ctxs
    req, jreq = parse_search_body(body), jparse_body(body)
    k = req.from_ + req.size
    if expect_device:
        assert _try_device_sort(tctx, req, k) is not None
        assert jtry_device_sort(jctx, jreq, k, None, 0) is not None
    tb, jb = _counts(SERVING_COUNTERS), _counts(JCOUNTERS)
    dev = execute_query_phase(tctx, req, use_device=True)
    jdev = jphase(jctx, jreq, use_device=True)
    moved = _delta(tb, SERVING_COUNTERS)
    assert moved == _delta(jb, JCOUNTERS), body
    assert moved == ({"device_sort": 1} if expect_device else {"host": 1}), moved
    host = execute_query_phase(tctx, req, use_device=False)
    jhost = jphase(jctx, jreq, use_device=False)
    assert dev.total == jdev.total == host.total == jhost.total
    _same_docs(host.docs, jhost.docs)  # both numpy: bitwise
    _same_docs(dev.docs, jdev.docs, ulps=2)
    assert [(d, v) for _s, d, v in dev.docs] == [(d, v) for _s, d, v in host.docs]
    for m in (dev.max_score, jdev.max_score, host.max_score):
        assert math.isnan(m) == math.isnan(jhost.max_score)
    if not math.isnan(host.max_score):
        assert host.max_score == jhost.max_score
        assert _within_ulps(dev.max_score, jdev.max_score, 2)
    return req, dev, host


@pytest.mark.parametrize("order", ["asc", "desc"])
def test_basic_field_sort(ctxs, order):
    _both(ctxs, {"query": {"match": {"body": "alpha beta"}},
                 "sort": [{"rank": order}], "size": 25})


@pytest.mark.parametrize("missing", ["_last", "_first", 42])
def test_missing_policies(ctxs, missing):
    _both(ctxs, {"query": {"match": {"body": "gamma"}},
                 "sort": [{"rank": {"order": "asc", "missing": missing}}],
                 "size": 30})


@pytest.mark.parametrize("mode,order", [("min", "desc"), ("max", "asc")])
def test_multivalued_modes(ctxs, mode, order):
    _both(ctxs, {"query": {"match": {"body": "delta"}},
                 "sort": [{"multi": {"order": order, "mode": mode}}], "size": 20})


def test_filtered_query_with_sort(ctxs):
    _both(ctxs, {"query": {"filtered": {"query": {"match": {"body": "alpha"}},
                                        "filter": {"range": {"rank": {"lte": 2500}}}}},
                 "sort": [{"rank": "desc"}], "size": 15})


def test_sort_with_aggs_combined(ctxs):
    """Sort and device-eligible aggs: the order from the sorted launch, the
    partials from the aggregating one (the same match set), one pull."""
    jctx, tctx = ctxs
    body = {"query": {"match": {"body": "alpha"}},
            "sort": [{"rank": "asc"}], "size": 10,
            "aggs": {"m": {"max": {"field": "rank"}},
                     "by_label": {"terms": {"field": "multi"}}}}
    req, dev, host = _both(ctxs, body)
    jreq = jparse_body(body)
    want = jreduce_aggs(jreq.aggs, jphase(jctx, jreq, use_device=True).agg_partials)
    assert reduce_aggs(req.aggs, dev.agg_partials) == want
    assert reduce_aggs(req.aggs, host.agg_partials) == want


def test_sort_with_host_only_agg_falls_back(ctxs):
    """An aggregation the card does not serve sends the whole request to
    the host path, in both packages."""
    _both(ctxs, {"query": {"match": {"body": "alpha"}},
                 "sort": [{"rank": "asc"}], "size": 5,
                 "aggs": {"c": {"cardinality": {"field": "rank"}}}},
          expect_device=False)


@pytest.mark.parametrize("fixture,body", [
    ("products", {"query": {"match": {"name": "red"}}, "size": 3,
                  "sort": [{"category": "asc"}],
                  "aggs": {"p": {"stats": {"field": "price"}}}}),
    ("ctxs", {"query": {"match": {"body": "alpha"}}, "size": 5,
              "sort": [{"price_frac": "asc"}],
              "aggs": {"r": {"stats": {"field": "rank"}}}}),
], ids=["string", "fractional"])
def test_sort_refusal_launches_nothing(request, monkeypatch, fixture, body):
    """A sort whose key rows the card refuses, beside device-eligible
    aggregations: the refusal comes before any launch (the aggregating one
    included), and the host path serves the request, as in the JAX
    package."""
    jctx, tctx = request.getfixturevalue(fixture)
    launched = []
    for name in ("score_agg_batch_async", "score_sorted_batch_async"):
        orig = getattr(texecute, name)
        monkeypatch.setattr(texecute, name, lambda *a, _o=orig, _n=name, **kw:
                            launched.append(_n) or _o(*a, **kw))
    req, jreq = parse_search_body(body), jparse_body(body)
    tb, jb = _counts(SERVING_COUNTERS), _counts(JCOUNTERS)
    got = execute_query_phase(tctx, req)
    want = jphase(jctx, jreq)
    assert launched == []
    assert _delta(tb, SERVING_COUNTERS) == _delta(jb, JCOUNTERS) == {"host": 1}
    assert got.total == want.total
    _same_docs(got.docs, want.docs)
    assert reduce_aggs(req.aggs, got.agg_partials) == \
        jreduce_aggs(jreq.aggs, want.agg_partials)


def test_track_scores(ctxs):
    _req, dev, _host = _both(ctxs, {"query": {"match": {"body": "beta"}},
                                    "sort": [{"rank": "asc"}], "size": 10,
                                    "track_scores": True})
    assert not any(math.isnan(s) for s, _d, _v in dev.docs)


@pytest.mark.parametrize("body", [
    # fractional column: not f32-exact → host (the order must still agree)
    {"query": {"match": {"body": "alpha"}}, "sort": [{"price_frac": "asc"}],
     "size": 10},
    # multi-key → host
    {"query": {"match": {"body": "alpha"}},
     "sort": [{"rank": "asc"}, {"price_frac": "desc"}], "size": 10},
    # avg mode → host
    {"query": {"match": {"body": "alpha"}},
     "sort": [{"multi": {"order": "asc", "mode": "avg"}}], "size": 10},
    # _score sort → host
    {"query": {"match": {"body": "alpha"}}, "sort": ["_score"], "size": 10},
    # a script sort → host
    {"query": {"match": {"body": "gamma"}},
     "sort": [{"_script": {"script": "doc['price_frac'].value * 2",
                           "order": "desc"}}], "size": 10},
    # match_all (does not lower) → host
    {"sort": [{"rank": "desc"}], "size": 12},
], ids=["fractional", "multi_key", "avg_mode", "score", "script", "match_all"])
def test_host_fallbacks_agree(ctxs, body):
    jctx, tctx = ctxs
    req = parse_search_body(body)
    if len(req.sort) == 1:
        assert _try_device_sort(tctx, req, 10) is None
        assert jtry_device_sort(jctx, jparse_body(body), 10, None, 0) is None
    _both(ctxs, body, expect_device=False)


@pytest.mark.parametrize("body,path", [
    ({"query": {"match": {"body": "alpha"}}, "size": 3}, "device_sparse"),
    ({"query": {"filtered": {"query": {"match": {"body": "alpha"}},
                             "filter": {"range": {"rank": {"gte": 1}}}}},
      "size": 3}, "device_filtered"),
    ({"query": {"function_score": {"query": {"match": {"body": "alpha"}},
                                   "boost_factor": 2}}, "size": 3},
     "device_function_score"),
    ({"query": {"match": {"body": "alpha"}}, "size": 0,
      "aggs": {"m": {"max": {"field": "rank"}}}}, "device_aggs"),
    ({"query": {"match": {"body": "alpha"}}, "sort": [{"rank": "asc"}],
      "size": 3}, "device_sort"),
    ({"query": {"match": {"body": "alpha"}}, "sort": ["_score", {"rank": "asc"}],
      "size": 3}, "host"),
    ({"query": {"match": {"body": "alpha"}}, "size": 3,
      "post_filter": {"range": {"rank": {"gte": 100}}},
      "aggs": {"m": {"max": {"field": "rank"}}}}, "device_filtered"),
    ({"query": {"match": {"body": "alpha"}}, "size": 3, "min_score": 0.1,
      "aggs": {"m": {"max": {"field": "rank"}}}}, "host"),
], ids=["sparse", "filtered", "function_score", "aggs", "sort", "multi_sort",
        "post_filter_aggs", "min_score_aggs"])
def test_serving_counters_track_paths(ctxs, body, path):
    """One serving counter moves a request, in both packages the same."""
    jctx, tctx = ctxs
    tb, jb = _counts(SERVING_COUNTERS), _counts(JCOUNTERS)
    execute_query_phase(tctx, parse_search_body(body), use_device=True)
    jphase(jctx, jparse_body(body), use_device=True)
    assert _delta(tb, SERVING_COUNTERS) == _delta(jb, JCOUNTERS) == {path: 1}


@pytest.mark.parametrize("spec", [{"rank": "asc"}, {"rank": "desc"},
                                  {"multi": {"order": "asc", "mode": "max"}},
                                  {"rank": {"order": "desc", "missing": "_first"}}])
def test_execute_flat_sorted_matches_jax(ctxs, spec):
    """The sorted launch itself: the same ordered (key, global doc, segment,
    local doc) entries, total and top score as the JAX package's."""
    jctx, tctx = ctxs
    q = {"match": {"body": "alpha gamma"}}
    from elasticsearch_tpu.search import parse_query as jparse_query
    from elasticsearch_tpu_torch.search import parse_query

    want = jexecute_flat_sorted(jlower_flat(jparse_query(q), jctx), jctx, 40,
                                jparse_sort([spec])[0])
    got = execute_flat_sorted(lower_flat(parse_query(q), tctx), tctx, 40,
                              parse_sort([spec])[0])
    assert got[0] == want[0] and _within_ulps(got[1], want[1], 2)
    assert [e[:4] for e in got[2]] == [e[:4] for e in want[2]]
    assert all(_within_ulps(a[4], b[4], 2) for a, b in zip(got[2], want[2]))


def test_signed_zero_keys_tie_as_in_the_jax_package(tmp_path_factory):
    """A column holding both -0.0 and +0.0: inside one segment's launch the
    JAX package's top-k ranks -0.0 below +0.0 (an ascending sort's first
    three of six tied docs are the -0.0 ones), and the merge then orders the
    winners by doc; the port picks the same winners. The host path ties
    them all and takes the lowest docs."""
    docs = [{"body": "alpha", "z": -0.0 if i % 2 else 0.0} for i in range(6)]
    jctx, tctx, engines = _pair(tmp_path_factory, docs, refresh_at=-1, deletes=())
    try:
        for order in ("asc", "desc"):
            body = {"query": {"match": {"body": "alpha"}},
                    "sort": [{"z": order}], "size": 3}
            req, jreq = parse_search_body(body), jparse_body(body)
            dev = execute_query_phase(tctx, req, use_device=True)
            jdev = jphase(jctx, jreq, use_device=True)
            _same_docs(dev.docs, jdev.docs)
            host = execute_query_phase(tctx, req, use_device=False)
            _same_docs(host.docs, jphase(jctx, jreq, use_device=False).docs)
            assert [d for _s, d, _v in host.docs] == [0, 1, 2]
            want = [1, 3, 5] if order == "asc" else [0, 2, 4]
            assert [d for _s, d, _v in dev.docs] == want
            assert all(str(v[0]) == ("-0.0" if d % 2 else "0.0")
                       for _s, d, v in dev.docs)
    finally:
        for e in engines:
            e.close()


def test_field_sort_merge():
    """tests/test_multishard.py::test_field_sort_merge on both packages'
    `sort_docs`: sort values merge across shards, then shard, then doc."""
    body = {"size": 4, "sort": [{"price": "asc"}]}
    shards = [[(float("nan"), 1, [10.0]), (float("nan"), 2, [30.0])],
              [(float("nan"), 1, [5.0]), (float("nan"), 2, [20.0]),
               (float("nan"), 3, [None])],
              [(float("nan"), 0, [20.0])]]
    got = sort_docs(parse_search_body(body), [
        ShardQueryResult(total=len(d), docs=d, max_score=float("nan"), shard_id=si)
        for si, d in enumerate(shards)])
    want = jsort_docs(jparse_body(body), [
        JShardQueryResult(total=len(d), docs=d, max_score=float("nan"), shard_id=si)
        for si, d in enumerate(shards)])
    assert [h[1:] for h in got.hits] == [h[1:] for h in want.hits]
    assert [h[3][0] for h in got.hits] == [5.0, 10.0, 20.0, 20.0]
    assert got.total == want.total == 6


PRODUCTS = [
    {"name": "red widget deluxe", "category": "widgets", "price": 10},
    {"name": "blue widget", "category": "widgets", "price": 20},
    {"name": "green gadget", "category": "gadgets", "price": 30},
    {"name": "red gadget pro", "category": "gadgets", "price": 40},
    {"name": "yellow gizmo", "category": "gizmos", "price": 50},
    {"name": "red gizmo mini widget", "category": "gizmos", "price": 60},
]
PRODUCT_MAPPING = {"properties": {
    "name": {"type": "string"},
    "category": {"type": "string", "index": "not_analyzed"},
    "price": {"type": "long"}}}


@pytest.fixture(scope="module")
def products(tmp_path_factory):
    jctx, tctx, engines = _pair(tmp_path_factory, PRODUCTS, mapping=PRODUCT_MAPPING,
                                refresh_at=2, deletes=())
    try:
        yield jctx, tctx
    finally:
        for e in engines:
            e.close()


@pytest.mark.parametrize("body,ids", [
    ({"sort": [{"price": "desc"}], "size": 3}, ["5", "4", "3"]),
    ({"sort": [{"price": "asc"}], "size": 2}, ["0", "1"]),
    ({"query": {"match": {"name": "red"}},
      "sort": [{"category": "asc"}, "_score"], "size": 10}, ["3", "0", "5"]),
    ({"sort": [{"price": "asc"}], "from": 2, "size": 2}, ["2", "3"]),
    ({"query": {"match": {"name": "red widget"}}, "sort": [{"price": "desc"}],
      "size": 4}, ["5", "3", "1", "0"]),
    # a string field orders a shard by each segment's own ordinals (both
    # packages); only the sort values, which are the strings, merge shards
    ({"sort": ["category"], "size": 6}, ["2", "3", "0", "1", "4", "5"]),
], ids=["desc", "asc", "string_then_score", "from", "device", "string"])
def test_search_runtime_sort_cases(products, body, ids):
    """tests/test_search_runtime.py TestSort (its geo case answers 400, see
    below): the same response in both packages, from the same hits."""
    jctx, tctx = products
    req, jreq = parse_search_body(body), jparse_body(body)
    got = reduce_and_respond(tctx, req, execute_query_phase(tctx, req))
    want = jrespond(jctx, jreq, jphase(jctx, jreq))
    assert [h["_id"] for h in got["hits"]["hits"]][: len(ids)] == ids
    assert [h["sort"] for h in got["hits"]["hits"]] == \
        [h["sort"] for h in want["hits"]["hits"]]
    assert [(h["_id"], h["_score"] is None) for h in got["hits"]["hits"]] == \
        [(h["_id"], h["_score"] is None) for h in want["hits"]["hits"]]
    assert got["hits"]["total"] == want["hits"]["total"]


def test_geo_distance_sort_is_a_later_slice(tmp_path_factory):
    """Served since geo fields were ported: the `_geo_distance` sort goes
    to the host path (the JAX package's device sort refuses it too) and
    gives the JAX package's order and sort values."""
    mapping = {"properties": {"loc": {"type": "geo_point"}}}
    rng = np.random.default_rng(5)
    docs = [{"body": str(rng.choice(["alpha", "beta"])),
             "loc": {"lat": float(rng.uniform(40, 41)),
                     "lon": float(rng.uniform(-75, -73))}} for _ in range(60)]
    docs[7].pop("loc")
    jctx, tctx, engines = _pair(tmp_path_factory, docs, mapping=mapping)
    try:
        body = {"query": {"match": {"body": "alpha"}}, "size": 20, "sort": [
            {"_geo_distance": {"loc": {"lat": 40.7, "lon": -74.0},
                               "order": "asc", "unit": "km"}}]}
        req, jreq = parse_search_body(body), jparse_body(body)
        before = SERVING_COUNTERS["host"]
        got = reduce_and_respond(tctx, req, execute_query_phase(tctx, req))
        assert SERVING_COUNTERS["host"] == before + 1
        want = jrespond(jctx, jreq, jphase(jctx, jreq))
        assert [(h["_id"], h["sort"]) for h in got["hits"]["hits"]] == \
            [(h["_id"], h["sort"]) for h in want["hits"]["hits"]]
        assert got["hits"]["total"] == want["hits"]["total"]
    finally:
        for e in engines:
            e.close()
