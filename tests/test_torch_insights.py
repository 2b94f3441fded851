"""Always-on query-shape insights on the port (common/insights.py and its
hooks in actions.py, search/service.py and the batcher) against the JAX
package.

Units, each on both packages' module with the same inputs: literals are
erased and structure kept, field names and structural values survive,
key order and the execution knobs do not matter, `size: 0` is a shape of
its own, clause lists bucket by powers of two, list-valued structural keys
survive; the bounded registry accumulates, demotes least recently used
shapes into `other` with honest totals, keeps a re-sighted shape, folds an
unknown outcome to `unknown`; the Observation is thread-local. Both
packages give every body of a seeded table the same shape id.

Node against node (the same bulk and the same traffic, from fresh
registries): `/_insights/queries` lists the JAX node's shapes with the
same ids, counts, outcome mix, request-cache hits and misses and the same
number of latency and queue observations (their values are clocks), and a
device observation for every batched member (the JAX batcher observes
the plain family's only); the `?size=` bounds and the `search.shapes` stats section; the
slowlog line's shape id is the registry's; a burst of more distinct shapes
than `max_shapes` keeps every `estpu_query_shape_*` Prometheus family at
most `max_shapes` label sets. The hot-path pin: the same warmed loop waits
as many times (`PendingPull.wait`) with insights on as off, once a batch,
and never calls `torch.cuda.synchronize`."""

import json
import logging
import threading

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common import insights as jinsights
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu_torch.common import cudaenv
from elasticsearch_tpu_torch.common import insights as tinsights
from elasticsearch_tpu_torch.common.settings import Settings as TSettings
from tests.test_torch_node import _node_pair, call
from tests.test_torch_tracing import _text, parse_prometheus

INDEX = "ins"


@pytest.fixture(params=["jax", "port"])
def mod(request):
    return {"jax": (jinsights, JSettings), "port": (tinsights, TSettings)}[request.param]


# ---------------------------------------------------------------------------
# shape normalization
# ---------------------------------------------------------------------------


def test_literals_erased_structure_kept(mod):
    fp = mod[0].shape_fingerprint
    a, _ = fp({"query": {"match": {"body": "alpha"}}})
    b, _ = fp({"query": {"match": {"body": "zebra zw"}}})
    c, _ = fp({"query": {"term": {"body": "alpha"}}})
    assert a == b and a != c


def test_field_names_are_structural(mod):
    fp = mod[0].shape_fingerprint
    assert fp({"query": {"match": {"body": "x"}}})[0] != \
        fp({"query": {"match": {"title": "x"}}})[0]


def test_key_order_and_volatile_knobs_do_not_matter(mod):
    fp = mod[0].shape_fingerprint
    a, _ = fp({"size": 5, "query": {"match": {"b": "x"}}})
    b, _ = fp({"query": {"match": {"b": "y"}}, "size": 5, "timeout": "100ms",
               "profile": True, "request_cache": False, "trace": True})
    assert a == b


def test_size_zero_is_a_distinct_shape(mod):
    fp = mod[0].shape_fingerprint
    q = {"query": {"match": {"b": "x"}}}
    a, b, c = (fp({**q, "size": n})[0] for n in (0, 10, 3))
    assert a != b and b == c


def test_clause_lists_bucket_by_pow2(mod):
    fp = mod[0].shape_fingerprint

    def body(n):
        return {"query": {"bool": {"should": [{"term": {"b": f"t{i}"}} for i in range(n)]}}}

    assert fp(body(5))[0] == fp(body(7))[0] and fp(body(2))[0] != fp(body(40))[0]


def test_list_valued_structural_keys_survive(mod):
    fp = mod[0].shape_fingerprint
    a, _ = fp({"query": {"multi_match": {"query": "x", "fields": ["title", "body"]}}})
    b, _ = fp({"query": {"multi_match": {"query": "y", "fields": ["tag", "other"]}}})
    c, _ = fp({"query": {"multi_match": {"query": "z", "fields": ["title", "body"]}}})
    assert a != b and a == c


def test_structural_values_survive(mod):
    ins = mod[0]
    shape = ins.normalize_shape({"sort": [{"n": {"order": "desc"}}],
                                 "query": {"match": {"b": "x"}}})
    assert "desc" in str(shape)
    assert ins.shape_fingerprint({"sort": [{"n": {"order": "desc"}}]})[0] != \
        ins.shape_fingerprint({"sort": [{"n": {"order": "asc"}}]})[0]


def _seeded_bodies(seed=41, n=60):
    rng = np.random.default_rng(seed)
    fields = ["body", "title", "tag", "n"]
    out = []
    for _ in range(n):
        f = str(rng.choice(fields))
        kind = int(rng.integers(0, 4))
        if kind == 0:
            q = {"match": {f: " ".join(f"w{i}" for i in rng.integers(0, 9, 3))}}
        elif kind == 1:
            q = {"bool": {"should": [{"term": {f: f"w{i}"}}
                                     for i in range(int(rng.integers(1, 9)))]}}
        elif kind == 2:
            q = {"range": {"n": {"gte": int(rng.integers(0, 50))}}}
        else:
            q = {"filtered": {"query": {"match": {f: "w1"}},
                              "filter": {"term": {"tag": "t1"}}}}
        body = {"query": q, "size": int(rng.integers(0, 3)) * 5}
        if rng.random() < 0.3:
            body["sort"] = [{"n": {"order": str(rng.choice(["asc", "desc"]))}}]
        out.append(body)
    return out


def test_both_packages_give_seeded_bodies_the_same_shape():
    for body in _seeded_bodies():
        assert tinsights.shape_fingerprint(body) == jinsights.shape_fingerprint(body)


# ---------------------------------------------------------------------------
# bounded registry
# ---------------------------------------------------------------------------


def _reg(mod, max_shapes=4):
    return mod[0].QueryShapeInsights(mod[1].from_flat({"search.insights.max_shapes": max_shapes}))


def test_record_accumulates(mod):
    reg = _reg(mod)
    sid, shape = reg.fingerprint({"query": {"match": {"b": "x"}}})
    obs = mod[0].Observation()
    obs.outcome, obs.queue_s, obs.device_s, obs.occupancy = "device_sparse", 0.001, 0.002, 3
    reg.record(sid, shape, 0.01, obs, cache="miss")
    reg.record(sid, shape, cache="hit")
    (entry,) = reg.top(5)
    assert entry["count"] == 2
    assert entry["cache"] == {"hits": 1, "misses": 1, "hit_rate": 0.5}
    assert entry["outcomes"] == {"device_sparse": 1, "cache_hit": 1}
    assert entry["coalesced"] == 1
    assert (entry["latency"]["count"], entry["queue"]["count"],
            entry["device"]["count"]) == (1, 1, 1)


def test_lru_demotion_is_bounded_and_honest(mod):
    reg = _reg(mod, 4)
    for i in range(10):
        sid, shape = reg.fingerprint({"query": {"match": {f"f{i}": "x"}}})
        reg.record(sid, shape, 0.01)
    st = reg.stats()
    assert (st["shapes"], st["demotions"], st["other"]["count"]) == (4, 6, 6)
    assert st["other"]["cost_ms"] > 0 and len(reg.prom_series()) == 4


def test_resighting_moves_to_end(mod):
    reg = _reg(mod, 2)
    ids = []
    for i in range(2):
        sid, shape = reg.fingerprint({"query": {"match": {f"f{i}": "x"}}})
        ids.append(sid)
        reg.record(sid, shape, 0.01)
    reg.record(*reg.fingerprint({"query": {"match": {"f0": "x"}}}), 0.01)
    sid2, shape2 = reg.fingerprint({"query": {"match": {"f2": "x"}}})
    reg.record(sid2, shape2, 0.01)
    resident = {sid for sid, _ in reg.prom_series()}
    assert ids[0] in resident and sid2 in resident and ids[1] not in resident


def test_unknown_outcome_folds_to_unknown(mod):
    reg = _reg(mod)
    sid, shape = reg.fingerprint({})
    obs = mod[0].Observation()
    obs.outcome = "weird_new_path"
    reg.record(sid, shape, 0.01, obs)
    assert reg.top(1)[0]["outcomes"] == {"unknown": 1}


def test_observation_is_thread_local(mod):
    ins = mod[0]
    assert ins.current() is None
    obs = ins.Observation()
    with ins.activate(obs):
        assert ins.current() is obs
        seen = []
        t = threading.Thread(target=lambda: seen.append(ins.current()))
        t.start()
        t.join()
        assert seen == [None]
    assert ins.current() is None


# ---------------------------------------------------------------------------
# node against node
# ---------------------------------------------------------------------------


def _bulk(seed: int = 37, n: int = 120) -> str:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        lines.append(json.dumps({"index": {"_index": INDEX, "_type": "doc",
                                           "_id": str(i)}}))
        lines.append(json.dumps({"body": " ".join(f"w{j}" for j in rng.integers(0, 9, 5)),
                                 "n": i, "tag": f"t{i % 3}"}))
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    def fill(base):
        st, r = call(base, "PUT", f"/{INDEX}", {
            "settings": {"number_of_shards": 2, "refresh_interval": -1},
            "mappings": {"doc": {"properties": {
                "tag": {"type": "string", "index": "not_analyzed"},
                "n": {"type": "integer"}}}}})
        assert st == 200, r
        st, r = call(base, "POST", "/_bulk", raw=_bulk())
        assert st == 200 and not r["errors"]
        assert call(base, "POST", f"/{INDEX}/_refresh")[0] == 200

    yield from _node_pair(tmp_path_factory, fill)


MATCH = {"query": {"match": {"body": "w1"}}, "size": 3}
COUNT = {"query": {"match": {"body": "w2"}}, "size": 0}
TRAFFIC = ([{"query": {"match": {"body": f"w{i}"}}, "size": 3} for i in range(4)]
           + [COUNT, COUNT,  # a miss that stores, then a request-cache hit
              {"query": {"match": {"body": {"query": "w1x", "fuzziness": "AUTO"}}}},
              {"query": {"filtered": {"query": {"match": {"body": "w3"}},
                                      "filter": {"term": {"tag": "t1"}}}}},
              {"query": {"match": {"body": "w4"}}, "aggs": {"m": {"max": {"field": "n"}}}},
              {"query": {"match": {"body": "w5"}}, "sort": [{"n": "desc"}]}])


def _entries(base):
    st, r = call(base, "GET", "/_insights/queries?size=100")
    assert st == 200
    return {e["shape_id"]: e for e in r["shapes"]}


def test_every_search_classified_as_on_the_jax_node(nodes):
    """Runs first in the module: both registries start empty."""
    pbase, jbase, _p = nodes
    for body in TRAFFIC:
        for base in (pbase, jbase):
            assert call(base, "POST", f"/{INDEX}/_search", body)[0] == 200
    pe, je = _entries(pbase), _entries(jbase)
    assert set(pe) == set(je) and len(pe) == 6
    for sid, p in pe.items():
        j = je[sid]
        assert (p["shape"], p["count"], p["outcomes"], p["cache"]) == \
            (j["shape"], j["count"], j["outcomes"], j["cache"]), sid
        for hist in ("latency", "queue"):
            assert p[hist]["count"] == j[hist]["count"], (sid, hist)
        # the port stamps the one pull window of every batch, whatever its
        # families; the JAX batcher stamps it for the plain family only (a
        # declared difference: a dense-family member has a device phase)
        assert p["device"]["count"] in (j["device"]["count"], p["queue"]["count"])
    match = max(pe.values(), key=lambda e: e["count"])
    assert match["count"] == 8 and match["outcomes"] == {"device_sparse": 8}
    assert match["queue"]["count"] == 8 and match["device"]["count"] == 8
    cached = next(e for e in pe.values() if e["cache"]["hits"])
    assert cached["outcomes"].get("cache_hit") == 2
    assert any(e["outcomes"].get("host") for e in pe.values())


def test_rest_surfaces_and_size_bounds(nodes):
    for base in nodes[:2]:
        call(base, "POST", f"/{INDEX}/_search", MATCH)
        st, r = call(base, "GET", "/_insights/queries")
        assert st == 200 and r["insights"]["shapes"] >= 1
        assert r["shapes"][0]["cost_ms"] >= r["shapes"][-1]["cost_ms"]
        assert len(call(base, "GET", "/_insights/queries?size=1")[1]["shapes"]) == 1
        assert call(base, "GET", "/_insights/queries?size=-2")[0] == 400
        st, r = call(base, "GET", "/_nodes/stats/search")
        shapes = next(iter(r["nodes"].values()))["search"]["shapes"]
        assert shapes["shapes"] >= 1 and shapes["top"] and shapes["max_shapes"] == 128
    (_, pr), (_, jr) = (call(b, "GET", "/_insights/queries") for b in nodes[:2])
    assert set(pr) == set(jr) and set(pr["insights"]) == set(jr["insights"])
    assert set(pr["shapes"][0]) == set(jr["shapes"][0])


def test_slowlog_shape_id_joins_the_registry(nodes):
    pbase, _jbase, p = nodes
    records = []

    class _Capture(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = _Capture()
    assert call(pbase, "PUT", f"/{INDEX}/_settings",
                {"index.search.slowlog.threshold.query.debug": "0ms"})[0] == 200
    logger = logging.getLogger("estpu_torch.action")
    level = logger.level
    logger.setLevel(logging.DEBUG)
    logger.addHandler(handler)
    try:
        call(pbase, "POST", f"/{INDEX}/_search", MATCH)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
        assert call(pbase, "PUT", f"/{INDEX}/_settings",
                    {"index.search.slowlog.threshold.query.debug": "-1"})[0] == 200
    slow = [m for m in records if "slowlog" in m]
    sid, _ = p.insights.fingerprint(MATCH)
    assert len(slow) == 2 and all(f"shape[{sid}]" in m and "trace[-]" in m for m in slow)
    assert sid in _entries(pbase)


def test_prometheus_shape_families_stay_within_max_shapes(nodes):
    pbase, _jbase, p = nodes
    rng = np.random.default_rng(7)
    old = p.insights.max_shapes
    p.insights.max_shapes = 12
    try:
        for i in range(40):
            field = f"f{int(rng.integers(0, 1000))}_{i}"
            if i % 3 == 0:
                body = {"query": {"bool": {"should": [
                    {"term": {field: "x"}} for _ in range(int(rng.integers(1, 6)))]}},
                    "size": int(rng.integers(0, 2))}
            else:
                body = {"query": {"match": {field: "x"}}, "size": int(rng.integers(0, 3))}
            assert call(pbase, "POST", f"/{INDEX}/_search", body)[0] == 200
        assert p.insights.stats()["demotions"] > 0
        st, _c, text = _text(pbase, "/_prometheus/metrics")
        assert st == 200
        parse_prometheus(text)
        for fam in ("estpu_query_shape_count_total", "estpu_query_shape_cost_seconds_total",
                    "estpu_query_shape_device_seconds_total",
                    "estpu_query_shape_cache_hits_total"):
            labels = {ln.split("{", 1)[1] for ln in text.splitlines()
                      if ln.startswith(fam + "{")}
            assert 0 < len(labels) <= 12, (fam, len(labels))
        assert "estpu_query_shape_demotions_total" in text
    finally:
        p.insights.max_shapes = old


def test_insights_add_no_wait_and_no_sync(nodes, monkeypatch):
    pbase, _jbase, p = nodes
    for _ in range(2):
        call(pbase, "POST", f"/{INDEX}/_search", MATCH)
        call(pbase, "POST", f"/{INDEX}/_search", COUNT)
    waits, syncs = [], []
    orig_wait = cudaenv.PendingPull.wait
    monkeypatch.setattr(cudaenv.PendingPull, "wait",
                        lambda self: (waits.append(1), orig_wait(self))[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: syncs.append(1))

    def loop(n=6):
        waits.clear()
        before = p.search_batcher.stats()["launches"]
        for _ in range(n):
            assert call(pbase, "POST", f"/{INDEX}/_search", MATCH)[0] == 200
            assert call(pbase, "POST", f"/{INDEX}/_search", COUNT)[0] == 200
        return len(waits), p.search_batcher.stats()["launches"] - before

    assert p.insights.enabled
    armed, armed_batches = loop()
    p.insights.enabled = False
    try:
        baseline, _ = loop()
    finally:
        p.insights.enabled = True
    assert armed == baseline == armed_batches
    assert armed == 6 * 2  # one batch a shard a search; the cached count pulls nothing
    assert syncs == []
