"""The port's dense request-feature family against the JAX package's.

Both packages' `Engine`s index the same seeded documents (a text field, an
integer `pop` missing on 1 doc in 7, a `price`, a `date` and a field that is
sometimes 0), shaped like tests/test_function_score_device.py `_build`: two
segments and four tombstones, under BM25 and under TF-IDF. For every case:

- `lower_flat` lowers where the JAX package's does, to the same kind of
  plan (function_score rows or script, filtered);
- the port's `search_shard(use_device=True)` on the CPU (its torch ops) is
  held against the JAX package's device path (on the CPU) and against its
  host scorer: totals exact, the same hits in the same order except inside
  groups of scores within 2 ulp, each score within 2 ulp (the rule of
  tests/test_torch_dense.py); a `_score`-reading script at 5 decimals, as
  the JAX package holds its own device script family;
- `execute_query_phase` takes the device `min_score` and `post_filter`
  branches under the JAX package's conditions, with its hits, and counts
  them in `SERVING_COUNTERS`.

Also here: a batch mixing plain, filtered and function_score plans equals
each family run alone; a script's `bad` flag reruns a query on the host
scorer; the `DeviceFilterCache` promotes on the second sighting, hits,
charges and releases the fielddata breaker, evicts with a dropped segment
(an engine view listener) and scores cached plans bitwise as uncached ones;
`segment_from_arrays` carries numeric doc values (`dv_num`)."""

import contextlib
import dataclasses
import threading

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.errors import ScriptError as JScriptError
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.engine import Engine as JEngine
from elasticsearch_tpu.mapper.core import MapperService as JMapperService
from elasticsearch_tpu.search import ShardContext as JShardContext
from elasticsearch_tpu.search import parse_query as jparse_query
from elasticsearch_tpu.search.execute import lower_flat as jlower_flat
from elasticsearch_tpu.search.execute import search_shard as jsearch_shard
from elasticsearch_tpu.search.functions import _column_first_value as jfirst_value
from elasticsearch_tpu.search.service import execute_query_phase as jphase
from elasticsearch_tpu.search.service import parse_search_body as jparse_body
from elasticsearch_tpu.search.similarity import SimilarityService as JSim
from elasticsearch_tpu_torch.common.breaker import CircuitBreakerService
from elasticsearch_tpu_torch.common.errors import CircuitBreakingError, ScriptError
from elasticsearch_tpu_torch.common.settings import Settings as TSettings
from elasticsearch_tpu_torch.convert import segment_from_arrays
from elasticsearch_tpu_torch.index.engine import Engine as TEngine
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.ops.device_index import DeviceFilterCache, filter_masks_key
from elasticsearch_tpu_torch.search import (
    SERVING_COUNTERS, ShardContext, SimilarityService, execute_query_phase,
    parse_query, parse_search_body, search_shard, search_shard_batch)
from elasticsearch_tpu_torch.search import execute as texecute
from elasticsearch_tpu_torch.search.execute import lower_flat
from elasticsearch_tpu_torch.search.functions import _column_first_value
from tests.test_torch_dense import _tie_tolerant_equal, _within_ulps

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta"]
SIMS = {"bm25": {"index.similarity.default.type": "BM25"}, "tfidf": {}}


def _docs() -> list[dict]:
    rng = np.random.default_rng(42)
    out = []
    for i in range(400):
        doc = {
            "body": " ".join(rng.choice(WORDS, size=6)),
            "pop": int(rng.integers(1, 200)),
            "price": float(np.round(rng.uniform(1, 60), 2)),
            "ts": f"2014-01-{int(rng.integers(1, 28)):02d}",
        }
        if i % 7 == 0:
            del doc["pop"]  # a missing column
        if i % 11 == 0:
            doc["zero"] = 0
        out.append(doc)
    return out


def _fill(engine, docs):
    for i, doc in enumerate(docs):
        engine.index("doc", str(i), doc)
        if i == 199:
            engine.refresh()  # a second segment
    for i in (3, 77, 140, 301):
        engine.delete("doc", str(i))
    engine.refresh()


@pytest.fixture(scope="module", params=list(SIMS))
def ctxs(request, tmp_path_factory):
    """(JAX context, port context) over the same documents."""
    flat = SIMS[request.param]
    docs = _docs()
    jset = JSettings.from_flat(flat)
    jsvc = JMapperService(jset)
    jeng = JEngine(str(tmp_path_factory.mktemp("jax")), jsvc)
    tset = TSettings.from_flat(flat)
    tsvc = TMapperService(tset)
    teng = TEngine(str(tmp_path_factory.mktemp("port")), tsvc)
    try:
        _fill(jeng, docs)
        _fill(teng, docs)
        jctx = JShardContext(jeng.acquire_searcher(), jsvc,
                             JSim(jset, mapper_service=jsvc))
        tctx = ShardContext(teng.acquire_searcher(), tsvc,
                            SimilarityService(tset, tsvc), device="cpu")
        assert [s.doc_count for s in tctx.searcher.segments] == \
            [s.doc_count for s in jctx.searcher.segments] == [200, 200]
        yield jctx, tctx
    finally:
        jeng.close()
        teng.close()


def _fs(query, **spec):
    return {"function_score": {"query": query, **spec}}


M_AB = {"match": {"body": "alpha beta"}}
M_G = {"match": {"body": "gamma"}}
B3 = {"bool": {"should": [{"term": {"body": "alpha"}}, {"term": {"body": "beta"}},
                          {"term": {"body": "gamma"}}]}}

# function_score bodies the dense rows family serves
ROWS_CASES = {
    **{f"decay_{k}": _fs(M_AB, functions=[{k: {"price": {
        "origin": 25, "scale": 10, "offset": 2, "decay": 0.4}}}])
       for k in ("gauss", "exp", "linear")},
    "decay_date": _fs(M_G, functions=[{"gauss": {"ts": {
        "origin": "2014-01-15", "scale": "7d"}}}]),
    **{f"fvf_{m}": _fs({"match": {"body": "delta"}}, field_value_factor={
        "field": "pop", "factor": 1.3, "modifier": m, "missing": 2})
       for m in ("none", "log1p", "ln2p", "sqrt", "reciprocal")},
    "boost_factor_filters": _fs({"match": {"body": "alpha beta gamma"}}, functions=[
        {"filter": {"range": {"pop": {"gte": 100}}}, "boost_factor": 3},
        {"filter": {"term": {"body": "zeta"}}, "boost_factor": 0.5}]),
    "random_score": _fs({"match": {"body": "epsilon"}},
                        functions=[{"random_score": {"seed": 1234}}]),
    **{f"score_mode_{sm}": _fs({"match": {"body": "alpha"}}, functions=[
        {"filter": {"range": {"price": {"lte": 30}}},
         "gauss": {"price": {"origin": 10, "scale": 15}}},
        {"filter": {"range": {"pop": {"gte": 50}}}, "boost_factor": 2, "weight": 1.5}],
        score_mode=sm) for sm in ("multiply", "sum", "avg", "max", "min", "first")},
    **{f"boost_mode_{bm}": _fs({"match": {"body": "beta gamma"}}, functions=[
        {"filter": {"range": {"pop": {"gte": 80}}},
         "field_value_factor": {"field": "pop", "modifier": "ln2p"}}],
        boost_mode=bm) for bm in ("multiply", "replace", "sum", "avg", "max", "min")},
    "max_and_outer_boost": _fs({"match": {"body": "alpha delta"}}, functions=[
        {"field_value_factor": {"field": "pop", "missing": 1}}],
        max_boost=5.0, boost=2.5),
    "min_score": _fs({"match": {"body": "alpha"}}, functions=[
        {"gauss": {"price": {"origin": 25, "scale": 8}}}], min_score=0.8),
    "no_functions_min_score": _fs(M_AB, min_score=0.3, boost_mode="sum"),
    "weight_only": _fs({"match": {"body": "zeta"}}, functions=[
        {"weight": 4.0, "filter": {"range": {"pop": {"gte": 20}}}}]),
    "doc_only_script": _fs({"match": {"body": "eta"}}, script_score={
        "script": "log(2 + doc['price'].value)"}),
    "bool_coord_outer_boost": _fs(B3, functions=[
        {"gauss": {"price": {"origin": 20, "scale": 12}}}], boost=1.7),
}

# function_score bodies the dense script family serves (5 decimals)
SCRIPT_CASES = {
    "basic": _fs({"match": {"body": "gamma delta"}}, script_score={
        "script": "_score * log(2 + doc['price'].value)"}),
    "params_weight_replace": _fs({"match": {"body": "alpha"}}, functions=[
        {"script_score": {"script": "_score * factor + doc['price'].value / divisor",
                          "params": {"factor": 2.5, "divisor": 10}}, "weight": 1.25}],
        boost_mode="replace"),
    "filter_sum_max_min": _fs({"match": {"body": "beta epsilon"}}, functions=[
        {"filter": {"range": {"price": {"lte": 40}}},
         "script_score": {"script": "_score + sqrt(doc['price'].value)"}}],
        boost_mode="sum", max_boost=20.0, min_score=0.2),
    "empty_guard_reruns_on_host": _fs({"match": {"body": "alpha"}}, script_score={
        "script": "_score if doc['pop'].empty else _score * log(1 + doc['pop'].value)"}),
}

FILTERED_CASES = {
    "range": {"filtered": {"query": {"match": {"body": "alpha beta"}},
                           "filter": {"range": {"pop": {"gte": 60}}}}},
    "terms_boost": {"filtered": {"query": B3, "boost": 2.0,
                                 "filter": {"terms": {"body": ["zeta", "eta"]}}}},
    "bool_filter": {"filtered": {"query": {"match": {"body": {"query": "gamma delta",
                                                              "operator": "and"}}},
                                 "filter": {"bool": {"must_not": [
                                     {"range": {"price": {"gte": 30}}}]}}}},
    "exists_msm": {"filtered": {"query": {"match": {"body": {
        "query": "alpha beta gamma delta", "minimum_should_match": 2}}},
        "filter": {"exists": {"field": "zero"}}}},
    "script_filter": {"filtered": {"query": M_G, "filter": {"script": {
        "script": "doc['price'].value > 20"}}}},
}

# bodies neither package lowers: both serve them on the host scorer
HOST_CASES = {
    "fs_match_all": _fs({"match_all": {}}, functions=[
        {"gauss": {"price": {"origin": 25, "scale": 10}}}]),
    "fs_two_score_readers": _fs(M_G, functions=[
        {"script_score": {"script": "_score * 2"}}, {"boost_factor": 3}]),
    "fs_no_query": {"function_score": {"filter": {"range": {"pop": {"gte": 50}}},
                                       "boost_factor": 2}},
    "filtered_phrase": {"filtered": {"query": {"match_phrase": {"body": "alpha beta"}},
                                     "filter": {"range": {"pop": {"gte": 10}}}}},
    "fs_of_filtered": _fs({"filtered": {"query": M_G, "filter": {
        "range": {"pop": {"gte": 10}}}}}, boost_factor=2),
}


def _hits_equal(got, want, places=None):
    """Same total and hits: tie-tolerant within 2 ulp, or at `places`
    decimals in the same order."""
    assert got.total == want.total
    if places is None:
        assert _tie_tolerant_equal(got.hits, want.hits), (got.hits[:4], want.hits[:4])
        return
    assert [d for _s, d in got.hits] == [d for _s, d in want.hits]
    for (gs, _), (ws, _) in zip(got.hits, want.hits):
        assert gs == pytest.approx(ws, rel=10 ** -places)


def _plan_kind(plan):
    if plan is None:
        return None
    return (plan.fs_kind, plan.filt is not None, plan.norm_boost)


def _parity(ctxs, body, k=10, places=None):
    jctx, tctx = ctxs
    jq, tq = jparse_query(body), parse_query(body)
    assert _plan_kind(lower_flat(tq, tctx)) == _plan_kind(jlower_flat(jq, jctx))
    port = search_shard(tctx, tq, k, use_device=True)
    jdev = jsearch_shard(jctx, jq, k, use_device=True)
    jhost = jsearch_shard(jctx, jq, k, use_device=False)
    _hits_equal(port, jdev, places)
    _hits_equal(port, jhost, places)
    assert search_shard(tctx, tq, k, use_device=False).hits == jhost.hits
    return port


@pytest.mark.parametrize("name", list(ROWS_CASES))
def test_function_score_rows_match_jax(ctxs, name):
    body = ROWS_CASES[name]
    assert lower_flat(parse_query(body), ctxs[1]).fs_kind == "rows"
    assert _parity(ctxs, body, k=20).total > 0


@pytest.mark.parametrize("name", list(SCRIPT_CASES))
def test_function_score_script_matches_jax(ctxs, name):
    body = SCRIPT_CASES[name]
    assert lower_flat(parse_query(body), ctxs[1]).fs_kind == "script"
    assert _parity(ctxs, body, k=20, places=5).total > 0


@pytest.mark.parametrize("name", list(FILTERED_CASES))
def test_filtered_matches_jax(ctxs, name):
    body = FILTERED_CASES[name]
    assert lower_flat(parse_query(body), ctxs[1]).filt is not None
    assert _parity(ctxs, body, k=20).total > 0


@pytest.mark.parametrize("name", list(HOST_CASES))
def test_bodies_neither_package_lowers(ctxs, name):
    jctx, tctx = ctxs
    body = HOST_CASES[name]
    assert jlower_flat(jparse_query(body), jctx) is None
    assert lower_flat(parse_query(body), tctx) is None
    port = search_shard(tctx, parse_query(body), 20, use_device=True)
    want = jsearch_shard(jctx, jparse_query(body), 20, use_device=False)
    assert (port.total, port.hits) == (want.total, want.hits) and port.total > 0


def test_script_missing_column_raises_on_both_paths(ctxs):
    """`pop` is missing on some docs: the host raises ScriptError on them;
    the device family flags the query bad and its host rerun raises too."""
    jctx, tctx = ctxs
    body = _fs({"match": {"body": "alpha"}}, script_score={
        "script": "_score * doc['pop'].value"})
    assert lower_flat(parse_query(body), tctx).fs_kind == "script"
    for use_device in (False, True):
        with pytest.raises(ScriptError):
            search_shard(tctx, parse_query(body), 10, use_device=use_device)
        with pytest.raises(JScriptError):
            jsearch_shard(jctx, jparse_query(body), 10, use_device=use_device)


def test_script_errors_and_bad_flags_rerun_on_host(ctxs, monkeypatch):
    """A doc-only script that raises while a segment's rows are built sends
    its whole group to the host scorer, which raises; a `_score` script
    whose query meets a missing column on a parent doc (guarded by
    `.empty`) is flagged bad and rerun on the host scorer, once."""
    _jctx, tctx = ctxs
    rows = _fs({"match": {"body": "alpha beta gamma delta"}},
               script_score={"script": "log(doc['zero'].value)"})
    assert lower_flat(parse_query(rows), tctx).fs_kind == "rows"
    with pytest.raises(ScriptError):
        search_shard(tctx, parse_query(rows), 10, use_device=True)
    reruns = []
    orig = texecute._host_search
    monkeypatch.setattr(texecute, "_host_search",
                        lambda ctx, q, k, **kw: reruns.append(q) or orig(ctx, q, k, **kw))
    guarded = parse_query(SCRIPT_CASES["empty_guard_reruns_on_host"])
    clean = parse_query(SCRIPT_CASES["basic"])
    tds = search_shard_batch(tctx, [guarded, clean], 10)
    assert reruns == [guarded]  # the clean script stayed on the device
    assert tds[0].hits == orig(tctx, guarded, 10).hits


def test_mixed_batch_equals_each_family_alone(ctxs):
    """Plain, filtered and function_score plans (two specs, one with
    per-query min_score and boost) in one batch: each answer equals its
    plan run alone."""
    _jctx, tctx = ctxs
    bodies = [M_AB, FILTERED_CASES["range"], ROWS_CASES["boost_factor_filters"],
              B3, SCRIPT_CASES["basic"], FILTERED_CASES["terms_boost"],
              _fs(M_AB, min_score=0.2), _fs(M_AB, min_score=1.2),
              _fs(M_AB, min_score=1.2, boost=2.0), ROWS_CASES["random_score"]]
    queries = [parse_query(b) for b in bodies]
    batch = search_shard_batch(tctx, queries, 15)
    for q, td in zip(queries, batch):
        alone = search_shard(tctx, q, 15)
        assert (td.total, td.hits) == (alone.total, alone.hits)
    # one launch serves the spec: each query keeps its own gate
    assert batch[6].total > batch[7].total > 0


def test_batcher_drainer_builds_no_host_inputs_and_serves_no_rerun(ctxs, monkeypatch):
    """Through a DeviceBatcher, the host inputs of the dense family (a
    filter's mask rows, a spec's function rows) are built on the callers'
    threads, and a query handed back to the host scorer (a script's `bad`
    flag, a spec whose rows raise ScriptError) is served on its caller's
    thread after the batch: the five requests share one coalesced batch,
    which does not split, and each answers as it does without a batcher."""
    from elasticsearch_tpu_torch.search import functions as tfunctions
    from elasticsearch_tpu_torch.search.batcher import DeviceBatcher

    _jctx, tctx = ctxs
    bodies = [{"query": M_AB}, {"query": FILTERED_CASES["range"]},
              {"query": ROWS_CASES["boost_factor_filters"]},
              {"query": SCRIPT_CASES["empty_guard_reruns_on_host"]},
              {"query": _fs({"match": {"body": "alpha beta gamma delta"}},
                            script_score={"script": "log(doc['zero'].value)"})}]
    alone = []
    for b in bodies:
        try:
            alone.append(execute_query_phase(tctx, parse_search_body(b)).docs)
        except ScriptError as e:
            alone.append(type(e))
    assert alone[-1] is ScriptError and all(isinstance(a, list) for a in alone[:-1])

    threads = []

    def on_thread(fn):
        def wrapped(*a, **kw):
            threads.append(threading.current_thread().name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(texecute, "segment_mask", on_thread(texecute.segment_mask))
    monkeypatch.setattr(tfunctions, "combined_doc_rows",
                        on_thread(tfunctions.combined_doc_rows))
    monkeypatch.setattr(texecute, "_host_search", on_thread(texecute._host_search))
    batcher = DeviceBatcher(TSettings.from_flat({"search.batch.linger_ms": "500",
                                                 "search.batch.max_batch": "5"}))
    monkeypatch.setattr(tctx, "batcher", batcher)
    got = [None] * len(bodies)

    def call(i):
        try:
            got[i] = execute_query_phase(tctx, parse_search_body(bodies[i])).docs
        except ScriptError as e:
            got[i] = type(e)

    workers = [threading.Thread(target=call, args=(i,)) for i in range(len(bodies))]
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join()
    finally:
        batcher.shutdown()
    assert got == alone
    stats = batcher.stats()
    assert (stats["launches"], stats["coalesced"], stats["splits"]) == (1, 5, 0)
    assert len(threads) >= 3  # a mask, a function row, the reruns
    assert "estpu_torch[search_batcher]" not in threads, threads


@pytest.mark.parametrize("when", ["plain", "min_score", "post_filter",
                                  "post_filter_filtered", "both", "fs_post_filter"])
def test_query_phase_branches_match_jax(ctxs, when):
    """`execute_query_phase` takes the device min_score and post_filter
    branches exactly where the JAX package does, with its hits, and counts
    them; where the JAX package serves the host, so does the port."""
    jctx, tctx = ctxs
    body = {"query": M_AB, "size": 15}
    if when in ("min_score", "both"):
        body["min_score"] = 0.4
    if when in ("post_filter", "both"):
        body["post_filter"] = {"range": {"pop": {"lte": 120}}}
    if when == "post_filter_filtered":
        body["query"] = FILTERED_CASES["range"]
        body["filter"] = {"term": {"body": "delta"}}
    if when == "fs_post_filter":
        body["query"] = ROWS_CASES["weight_only"]
        body["post_filter"] = {"range": {"pop": {"gte": 10}}}
    want_counter = {"plain": "device_sparse", "min_score": "device_filtered",
                    "post_filter": "device_filtered",
                    "post_filter_filtered": "device_filtered",
                    "both": "host", "fs_post_filter": "host"}[when]
    before = dict(SERVING_COUNTERS)
    port = execute_query_phase(tctx, parse_search_body(body))
    counted = {k: v - before[k] for k, v in SERVING_COUNTERS.items() if v != before[k]}
    assert counted == {want_counter: 1}
    jdev = jphase(jctx, jparse_body(body), use_device=True)
    jhost = jphase(jctx, jparse_body(body), use_device=False)
    got = [(s, d) for s, d, _ in port.docs]
    for ref in (jdev, jhost):
        assert port.total == ref.total > 0
        assert _tie_tolerant_equal(got, [(s, d) for s, d, _ in ref.docs])
        assert _within_ulps(port.max_score, ref.max_score, 2)


def test_query_phase_size_zero_trims_device_branch_hits(ctxs):
    _jctx, tctx = ctxs
    body = {"query": M_AB, "size": 0, "min_score": 0.1}
    r = execute_query_phase(tctx, parse_search_body(body))
    assert r.docs == [] and r.total > 0


# ---------------------------------------------------------------------------
# DeviceFilterCache (after tests/test_caching.py TestDeviceFilterCacheUnits)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _cache_ctx(tctx, **settings):
    """A context over `tctx`'s searcher with a DeviceFilterCache of its own
    and a 64 MB breaker budget. The masks live in the segments' device
    caches, so they are cleared on the way out."""
    breakers = CircuitBreakerService(TSettings.from_flat(
        {"indices.breaker.total_budget": "64mb", **settings.pop("breaker", {})}))
    fc = DeviceFilterCache(TSettings.from_flat(settings),
                           breaker=breakers.breaker("fielddata"))
    ctx = ShardContext(tctx.searcher, tctx.mapper_service, tctx.similarity_service,
                       device="cpu", breakers=breakers, filter_cache=fc)
    try:
        yield ctx, fc, breakers.breaker("fielddata")
    finally:
        for seg in ctx.searcher.segments:
            fc.clear_segment(seg)


def test_filter_cache_promotes_on_second_sighting_and_hits(ctxs):
    _jctx, tctx = ctxs
    q = parse_query(FILTERED_CASES["range"])
    uncached = search_shard(tctx, q, 20)
    with _cache_ctx(tctx) as (ctx, fc, fielddata):
        nseg = len(ctx.searcher.segments)
        results = [search_shard(ctx, q, 20) for _ in range(3)]
        st = fc.stats()
        # sighting 1 counts, sighting 2 builds and stores, sighting 3 hits
        assert (st["misses"], st["builds"], st["hits"]) == (2 * nseg, nseg, nseg)
        pads = [s._device_cache[("packed", "cpu")].doc_pad
                for s in ctx.searcher.segments]
        # a padded bool row a segment, charged to fielddata while resident
        assert st["memory_size_in_bytes"] == fielddata.used == sum(pads)
        assert st["masks"] == nseg and st["hit_rate"] == round(1 / 3, 4)
        for r in results:  # bitwise: the mask values are the same either way
            assert (r.total, r.hits) == (uncached.total, uncached.hits)
    assert fielddata.used == 0 and fc.stats()["masks"] == 0


def test_filter_cache_min_sightings_disable_and_breaker(ctxs):
    _jctx, tctx = ctxs
    q = parse_query(FILTERED_CASES["bool_filter"])
    want = search_shard(tctx, q, 10)
    with _cache_ctx(tctx, **{"indices.filter_cache.min_sightings": 1}) as (ctx, fc, _f):
        assert search_shard(ctx, q, 10).hits == want.hits
        assert fc.stats()["builds"] == len(ctx.searcher.segments)
    with _cache_ctx(tctx, **{"indices.filter_cache.enable": "false"}) as (ctx, fc, _f):
        for _ in range(3):
            assert search_shard(ctx, q, 10).hits == want.hits
        assert fc.stats()["builds"] == 0 and fc.stats()["hits"] == 0
    # a fielddata budget too small for a mask: the store is rejected, the
    # host mask serves, and the breaker keeps nothing
    with _cache_ctx(tctx, **{"indices.filter_cache.min_sightings": 1,
                             "breaker": {"indices.fielddata.breaker.limit": "1b"}}
                    ) as (ctx, fc, fielddata):
        with pytest.raises(CircuitBreakingError):
            fielddata.add_estimate_and_maybe_break(2, "probe")
        assert search_shard(ctx, q, 10).hits == want.hits
        assert fc.stats()["rejections"] == len(ctx.searcher.segments)
        assert fc.stats()["builds"] == 0 and fielddata.used == 0


def test_filter_cache_evicts_dropped_segments_and_releases_breaker(tmp_path):
    """Masks leave with the segments an engine view drops (a merge) and
    give their bytes back; a tombstone view shares its segment's masks."""
    from elasticsearch_tpu_torch.indices_service import IndicesService

    tset = TSettings.from_flat({})
    tsvc = TMapperService(tset)
    eng = TEngine(str(tmp_path / "e"), tsvc)
    breakers = CircuitBreakerService(tset)
    fielddata = breakers.breaker("fielddata")
    fc = DeviceFilterCache(TSettings.from_flat(
        {"indices.filter_cache.min_sightings": 1}), breaker=fielddata)
    IndicesService._wire_cache_listeners(
        type("Indices", (), {"filter_cache": fc, "request_cache": None})(), eng,
        "idx", 0)
    try:
        _fill(eng, _docs())
        sim = SimilarityService(tset, tsvc)

        def run():
            ctx = ShardContext(eng.acquire_searcher(), tsvc, sim, device="cpu",
                               filter_cache=fc)
            return ctx, search_shard(ctx, parse_query(FILTERED_CASES["range"]), 10)

        ctx, _first = run()
        held = fc.stats()["memory_size_in_bytes"]
        assert held > 0 and fc.stats()["masks"] == 2
        used = fielddata.used
        # a delete makes a tombstone view of one segment: it shares the masks
        eng.delete("doc", "5")
        eng.refresh()
        assert fc.stats()["masks"] == 2 and fc.stats()["evictions"] == 0
        old = ctx.searcher.segments
        eng.optimize()  # the merge drops both sources: their masks go
        st = fc.stats()
        assert st["masks"] == 0 and st["evictions"] == 2
        assert st["memory_size_in_bytes"] == 0 and fielddata.used == used - held
        # a straggler on the old view cannot store again into a dead holder
        assert fc.maybe_store(old[0], "k", np.zeros(4, bool), torch.device("cpu")) is None
        _ctx, after = run()
        assert after.total > 0 and fc.stats()["masks"] == 1
        assert fc.clear_segment(eng.acquire_searcher().segments[0]) > 0
        assert fc.stats()["masks"] == 0
        holder = eng.acquire_searcher().segments[0]._device_cache[filter_masks_key("cpu")]
        assert not holder.dead  # cleared, not evicted: it rebuilds
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# numeric doc values carried across
# ---------------------------------------------------------------------------


def test_segment_from_arrays_carries_dv_num(ctxs):
    """A JAX segment's `dv_num` arrays, carried across, give the port's
    segment the same first values per doc (what every function reads)."""
    jctx, _tctx = ctxs
    jseg = jctx.searcher.segments[0]
    post_offsets = np.asarray(jseg.post_offsets)
    tseg = segment_from_arrays(
        {f: dict(td) for f, td in jseg.term_dict.items()}, post_offsets,
        np.asarray(jseg.post_docs), np.asarray(jseg.post_freqs),
        {f: np.asarray(a) for f, a in jseg.norms.items()},
        {f: {"doc_count": s.doc_count, "sum_ttf": s.sum_ttf,
             "sum_dfs": getattr(s, "sum_dfs", 0)}
         for f, s in jseg.field_stats.items()},
        np.asarray(jseg.live), np.asarray(jseg.parent_mask),
        dv_num={f: (np.asarray(o), np.asarray(v)) for f, (o, v) in jseg.dv_num.items()})
    assert set(tseg.dv_num) == set(jseg.dv_num) >= {"pop", "price", "zero"}
    for f in ("pop", "price", "zero", "ts", "absent"):
        np.testing.assert_array_equal(_column_first_value(tseg, f),
                                      jfirst_value(jseg, f))
    with pytest.raises(ValueError, match="dv_num"):
        segment_from_arrays({}, np.zeros(1, np.int64), np.zeros(0), np.zeros(0), {}, {},
                            np.ones(3, bool), np.ones(3, bool),
                            dv_num={"x": (np.array([0, 1, 1]), np.ones(1))})


def test_port_plan_carries_no_jax_types(ctxs):
    """A port plan's fs and filt are the port's own query and filter types."""
    _jctx, tctx = ctxs
    plan = lower_flat(parse_query(ROWS_CASES["weight_only"]), tctx)
    assert type(plan.fs).__module__.startswith("elasticsearch_tpu_torch.")
    plan = lower_flat(parse_query(FILTERED_CASES["range"]), tctx)
    assert type(plan.filt).__module__.startswith("elasticsearch_tpu_torch.")
    assert dataclasses.replace(plan, filt=None).filt is None
