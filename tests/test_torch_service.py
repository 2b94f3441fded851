"""The port's serving entry (elasticsearch_tpu_torch/search/service.py and
controller.py) against the JAX package: the same search bodies, made from a
numpy seed, go through `parse_search_body` → `execute_query_phase` with a
DeviceBatcher wired on both sides (JAX on the CPU as its own tests run it, the
port on `device="cpu"`) and must give identical totals and hits — bitwise,
every query here rides the sparse path; `sort_docs` over two shards gives
identical merged hits and `merge_responses` the same sections; an expired
`timeout` answers `timed_out` with nothing scored on both sides. Request
features the port has not reached raise QueryParsingError; `post_filter`,
`filter` and `min_score` parse, and a body without a query is match_all."""

import numpy as np
import pytest

from elasticsearch_tpu_torch.common.deadline import Deadline
from elasticsearch_tpu_torch.common.errors import QueryParsingError
from elasticsearch_tpu_torch.common.settings import Settings as TSettings
from elasticsearch_tpu_torch.index.engine import Searcher
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.search import (
    DeviceBatcher, ShardContext, SimilarityService, execute_query_phase,
    merge_responses, parse_search_body, sort_docs)
from elasticsearch_tpu_torch.search.filters import TermFilter
from elasticsearch_tpu_torch.search.queries import MatchAllQuery
from tests.test_torch_slice import SETTINGS, WORDS, _docs, shards  # noqa: F401

BATCH_SETTINGS = {"search.batch.linger_ms": "1"}


def _bodies(seed, n):
    """Search bodies of every query shape the slice serves, with from/size
    and a generous timeout on some."""
    rng = np.random.default_rng(seed)

    def w():
        return str(rng.choice(WORDS))

    out = []
    for i in range(n):
        kind = i % 5
        if kind == 0:
            q = {"match": {"body": f"{w()} {w()} {w()}"}}
        elif kind == 1:
            q = {"match": {"body": {"query": f"{w()} {w()}", "operator": "and"}}}
        elif kind == 2:
            q = {"bool": {"should": [{"term": {"body": w()}} for _ in range(4)],
                          "minimum_should_match": 2}}
        elif kind == 3:
            q = {"bool": {"must": [{"term": {"body": w()}}],
                          "should": [{"term": {"body": w()}},
                                     {"match": {"title": w()}}],
                          "must_not": [{"term": {"body": w()}}]}}
        else:
            q = {"match": {"title": {"query": f"{w()} {w()}", "boost": 1.5}}}
        body = {"query": q, "size": int(rng.choice([3, 10, 25]))}
        if i % 3 == 1:
            body["from"] = 2
        if i % 4 == 2:
            body["timeout"] = "30s"
        out.append(body)
    return out


def _jax_phase(jctx, bodies, **kw):
    from elasticsearch_tpu.common.jaxenv import compile_tag
    from elasticsearch_tpu.search.service import execute_query_phase as jphase
    from elasticsearch_tpu.search.service import parse_search_body as jparse

    with compile_tag("sparse"):
        return [jphase(jctx, jparse(b), **kw) for b in bodies]


def _with_batchers(shards):
    """(JAX context, port context), each with its own package's batcher."""
    from elasticsearch_tpu.common.settings import Settings
    from elasticsearch_tpu.search import ShardContext as JShardContext
    from elasticsearch_tpu.search.batcher import DeviceBatcher as JBatcher

    jctx, own, _conv = shards
    jb = JBatcher(Settings.from_flat(BATCH_SETTINGS))
    tb = DeviceBatcher(TSettings.from_flat(BATCH_SETTINGS))
    return (JShardContext(jctx.searcher, jctx.mapper_service,
                          jctx.similarity_service, batcher=jb),
            ShardContext(own.searcher, own.mapper_service, own.similarity_service,
                         device="cpu", batcher=tb))


def test_query_phase_through_batchers_matches_jax(shards):
    jctx, tctx = _with_batchers(shards)
    bodies = _bodies(21, 20)
    try:
        ref = _jax_phase(jctx, bodies)
        got = [execute_query_phase(tctx, parse_search_body(b)) for b in bodies]
        jst, tst = jctx.batcher.stats(), tctx.batcher.stats()
    finally:
        jctx.batcher.shutdown()
        tctx.batcher.shutdown()
    assert sum(r.total for r in ref) > 0
    for body, r, g in zip(bodies, ref, got):
        assert (g.total, g.docs, g.timed_out) == (r.total, r.docs, r.timed_out), body
        assert len(g.docs) <= body.get("from", 0) + body["size"]
    assert jst["coalesced"] == tst["coalesced"] == len(bodies)


def test_expired_timeout_matches_jax(shards):
    jctx, tctx = _with_batchers(shards)
    body = {"query": {"match": {"body": "w1 w2"}}, "timeout": "0ms"}
    try:
        (ref,) = _jax_phase(jctx, [body])
        got = execute_query_phase(tctx, parse_search_body(body))
        # a coordinator's budget that ran out before the shard started
        (ref2,) = _jax_phase(jctx, [{"query": body["query"]}],
                             deadline=_jax_deadline_expired())
        got2 = execute_query_phase(tctx, parse_search_body({"query": body["query"]}),
                                   deadline=Deadline.after(0.0))
        launched = tctx.batcher.stats()["launches"]
    finally:
        jctx.batcher.shutdown()
        tctx.batcher.shutdown()
    for r, g in ((ref, got), (ref2, got2)):
        assert r.timed_out and g.timed_out
        assert (g.total, g.docs) == (r.total, r.docs) == (0, [])
    assert launched == 0  # nothing reached the card


def _jax_deadline_expired():
    from elasticsearch_tpu.common.deadline import Deadline as JDeadline

    return JDeadline.after(0.0)


@pytest.fixture(scope="module")
def two_shards(tmp_path_factory):
    """Two shards of different docs, as JAX contexts and as port contexts."""
    from elasticsearch_tpu.common.settings import Settings
    from elasticsearch_tpu.index.engine import Engine
    from elasticsearch_tpu.mapper.core import MapperService
    from elasticsearch_tpu.search import ShardContext as JShardContext
    from elasticsearch_tpu.search.similarity import SimilarityService as JSim

    flat = SETTINGS["bm25"]
    jctxs, tctxs, engines = [], [], []
    for shard, (seed, n) in enumerate(((31, 90), (32, 70))):
        docs = _docs(seed, n, 0)
        settings = Settings.from_flat(flat)
        svc = MapperService(settings)
        eng = Engine(str(tmp_path_factory.mktemp(f"shard{shard}")), svc)
        for doc_id, src in docs:
            eng.index("doc", doc_id, src)
        eng.refresh()
        engines.append(eng)
        jctxs.append(JShardContext(eng.acquire_searcher(), svc,
                                   JSim(settings, mapper_service=svc)))
        tsettings = TSettings.from_flat(flat)
        tsvc = TMapperService(tsettings)
        b = SegmentBuilder(0)
        for doc_id, src in docs:
            b.add(tsvc.mapper_for("doc").parse(src, doc_id))
        tctxs.append(ShardContext(Searcher([b.freeze()]), tsvc,
                                  SimilarityService(tsettings, tsvc), device="cpu"))
    yield jctxs, tctxs
    for eng in engines:
        eng.close()


def test_two_shard_reduce_matches_jax(two_shards):
    from elasticsearch_tpu.search.controller import merge_responses as jmerge_resp
    from elasticsearch_tpu.search.controller import sort_docs as jsort
    from elasticsearch_tpu.search.service import parse_search_body as jparse

    jctxs, tctxs = two_shards
    for body in _bodies(41, 10):
        jresults = [_jax_phase(c, [body], shard_id=i)[0] for i, c in enumerate(jctxs)]
        tresults = [execute_query_phase(c, parse_search_body(body), shard_id=i)
                    for i, c in enumerate(tctxs)]
        jreq, treq = jparse(body), parse_search_body(body)
        jm, tm = jsort(jreq, jresults), sort_docs(treq, tresults)
        assert (tm.total, tm.hits, tm.timed_out) == (jm.total, jm.hits, jm.timed_out), body
        assert tm.max_score == jm.max_score or (tm.max_score != tm.max_score
                                                and jm.max_score != jm.max_score)
        page = [{"_shard": s, "_doc": d, "_score": sc}
                for (sc, s, d, _sv) in tm.hits[treq.from_:]]
        jresp = jmerge_resp(jreq, jm, jresults, page, 3, 2, 2)
        jresp["_shards"].pop("degraded")  # the port has no degraded serving yet
        assert merge_responses(treq, tm, tresults, page, 3, 2, 2) == jresp


# served since the host scorer: each key with the value the parse keeps
_SERVED_FEATURES = {"post_filter": {"term": {"body": "w1"}},
                    "filter": {"term": {"body": "w1"}}, "min_score": 0.5}


@pytest.mark.parametrize("key", ["aggs", "aggregations", "sort", "post_filter",
                                 "filter", "rescore", "min_score", "suggest",
                                 "highlight", "explain", "profile"])
def test_unported_request_features_raise(key):
    """The request features of later slices raise; `post_filter`, its older
    name `filter`, and `min_score` parse into the request."""
    body = {"query": {"match": {"body": "w1"}}, key: _SERVED_FEATURES.get(key, {})}
    if key not in _SERVED_FEATURES:
        with pytest.raises(QueryParsingError, match="later slice"):
            parse_search_body(body)
        return
    req = parse_search_body(body)
    if key == "min_score":
        assert (req.min_score, req.post_filter) == (0.5, None)
    else:
        assert (req.min_score, req.post_filter) == (None, TermFilter("body", "w1"))


def test_body_without_query_and_bad_timeout_raise():
    """A body without a query is match_all (a bad timeout still raises)."""
    req = parse_search_body({"size": 3})
    assert req.query == MatchAllQuery() and req.size == 3
    with pytest.raises(QueryParsingError, match="time value"):
        parse_search_body({"query": {"match": {"body": "w1"}}, "timeout": "soon"})
