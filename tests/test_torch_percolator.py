"""The port's percolator (elasticsearch_tpu_torch/percolator.py) and its
single-document GET and DELETE against the JAX package's, on the CPU.

- The batch: tests/test_device_aggs.py's 200-query registry (seed 13) on
  both packages — the port's batch equals its host loop, the JAX batch and
  the JAX host loop, and `device_percolate` moves once.
- Seeded random registries of 64-300 queries (term, match, bool, prefix,
  range, phrase over text, keyword and numeric fields) and documents, some
  percolations narrowed by `filter_ids`: the port's matches equal the JAX
  package's, the port's batch equals its host loop, and the batch ran
  whenever 64 or more queries lowered flat.
- Node against node (each package on its own in-process transport, both
  over HTTP): tests/test_cluster.py's percolator sequence over the client
  and over REST, `_percolate/count`, `_mpercolate` with a missing document,
  an existing document percolated against another index's registry and
  with a version conflict, DELETE unregistering a query, a `.percolator`
  document in a `_bulk` left unregistered on both; and GET and DELETE
  themselves — a realtime GET before a refresh, `found: false` with a 404,
  the `_all` type, `_source` filtering, a versioned DELETE's conflict. The
  JSON and statuses are equal.
- Fault domains: with `compile:percolate` armed a percolation answers 200
  with the host loop's matches and counts a fallback, the open domain skips
  the launch, and after the disarm the domain closes and the batch serves
  again; a defect answers 500 with `device_errors` +1 and no circuit; a
  query whose lowering raises is served by the host loop.

Both packages' serving counters, fault trackers and injectors are process
singletons: every test resets them in a `finally` (the autouse fixture)."""

import json
import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.devicehealth import DEVICE_HEALTH as J_HEALTH
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.mapper.core import MapperService as JMapperService
from elasticsearch_tpu.percolator import PercolatorRegistry as JRegistry
from elasticsearch_tpu.search.service import SERVING_COUNTERS as J_COUNTERS
from elasticsearch_tpu.transport.faults import DEVICE_FAULTS as J_FAULTS
from elasticsearch_tpu_torch import percolator as tperc
from elasticsearch_tpu_torch.common.cudaenv import CudaError, DeviceUnavailableError
from elasticsearch_tpu_torch.common.devicehealth import CLOSED, DEVICE_HEALTH, OPEN
from elasticsearch_tpu_torch.common.settings import Settings
from elasticsearch_tpu_torch.mapper import MapperService
from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.percolator import PercolatorRegistry
from elasticsearch_tpu_torch.search.service import SERVING_COUNTERS
from elasticsearch_tpu_torch.transport.faults import DEVICE_FAULTS
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg
from tests.test_torch_node import call

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta"]
TAGS = ["red", "green", "blue", "ochre"]
MAPPING = {"properties": {"body": {"type": "string"},
                          "tag": {"type": "string", "index": "not_analyzed"},
                          "n": {"type": "long"}, "price": {"type": "double"}}}


def _reset_all():
    for faults in (DEVICE_FAULTS, J_FAULTS):
        faults.disarm()
    for health in (DEVICE_HEALTH, J_HEALTH):
        health.reset()


@pytest.fixture(autouse=True)
def _device_state_hygiene():
    """Both packages' counters, trackers and injectors: every test starts
    and ends with the trackers closed and the injectors disarmed; the
    counters come back as they were."""
    saved = dict(SERVING_COUNTERS), dict(J_COUNTERS)
    _reset_all()
    try:
        yield
    finally:
        _reset_all()
        SERVING_COUNTERS.update(saved[0])
        J_COUNTERS.update(saved[1])


def _mappers(mapping=None):
    p = MapperService(Settings.from_flat({}))
    j = JMapperService(JSettings.from_flat({}))
    if mapping is not None:
        p.put_mapping("doc", mapping)
        j.put_mapping("doc", mapping)
    return p, j


def _host_loop(reg, *args, **kwargs):
    """The registry's pure host loop: its class's batch gate raised."""
    cls = type(reg)
    orig = cls.DEVICE_BATCH_MIN
    cls.DEVICE_BATCH_MIN = 10**9
    try:
        return reg.percolate(*args, **kwargs)
    finally:
        cls.DEVICE_BATCH_MIN = orig


# ---------------------------------------------------------------------------
# the registry: batch against host loop, port against JAX
# ---------------------------------------------------------------------------

def _aggs_test_queries() -> list[dict]:
    """tests/test_device_aggs.py::test_batched_device_percolation_parity's
    registry."""
    rng = np.random.default_rng(13)
    words = WORDS[:5]
    out = []
    for i in range(200):
        kind = i % 4
        if kind == 0:
            q = {"match": {"body": str(rng.choice(words))}}
        elif kind == 1:
            q = {"bool": {"must": [{"term": {"body": str(rng.choice(words))}}],
                          "must_not": [{"term": {"body": str(rng.choice(words))}}]}}
        elif kind == 2:
            q = {"term": {"body": str(rng.choice(words))}}
        else:  # not flat-lowerable → host within the same percolation
            q = {"match_phrase": {"body": f"{rng.choice(words)} {rng.choice(words)}"}}
        out.append(q)
    return out


def test_batched_percolation_equals_host_loop_and_jax():
    preg, jreg = PercolatorRegistry(), JRegistry()
    for i, q in enumerate(_aggs_test_queries()):
        preg.register(f"q{i}", {"query": q})
        jreg.register(f"q{i}", {"query": q})
    assert preg.count() == jreg.count() >= preg.DEVICE_BATCH_MIN
    psvc, jsvc = _mappers()
    doc = {"body": "alpha beta gamma"}
    before = SERVING_COUNTERS["device_percolate"], J_COUNTERS["device_percolate"]
    batched = preg.percolate(doc, psvc, device="cpu")
    jbatched = jreg.percolate(doc, jsvc)
    # both batches really ran (a fallback would compare host with host)
    assert SERVING_COUNTERS["device_percolate"] == before[0] + 1
    assert J_COUNTERS["device_percolate"] == before[1] + 1
    assert SERVING_COUNTERS["device_percolate_fallbacks"] == 0
    host = _host_loop(preg, doc, psvc, device="cpu")
    jhost = _host_loop(jreg, doc, jsvc)
    assert batched == host == jbatched == jhost and len(batched) > 0
    assert SERVING_COUNTERS["device_percolate"] == before[0] + 1


def _random_query(rng) -> dict:
    kind = rng.choice(["term", "term", "match", "match", "bool", "bool_should",
                       "prefix", "range", "phrase", "tag"])
    w = lambda: str(rng.choice(WORDS))  # noqa: E731
    if kind == "term":
        return {"term": {"body": w()}}
    if kind == "tag":
        return {"term": {"tag": str(rng.choice(TAGS))}}
    if kind == "match":
        return {"match": {"body": " ".join(w() for _ in range(rng.integers(1, 4)))}}
    if kind == "bool":
        return {"bool": {"must": [{"term": {"body": w()}}],
                         "must_not": [{"term": {"body": w()}}]}}
    if kind == "bool_should":
        return {"bool": {"should": [{"term": {"body": w()}} for _ in range(3)],
                         "minimum_should_match": int(rng.integers(1, 3))}}
    if kind == "prefix":
        return {"prefix": {"body": w()[:2]}}
    if kind == "range":
        field = str(rng.choice(["n", "price"]))
        lo = int(rng.integers(0, 50))
        return {"range": {field: {"gte": lo, "lt": lo + int(rng.integers(5, 40))}}}
    return {"match_phrase": {"body": f"{w()} {w()}"}}


def _random_doc(rng) -> dict:
    return {"body": " ".join(str(rng.choice(WORDS))
                             for _ in range(rng.integers(1, 7))),
            "tag": str(rng.choice(TAGS)), "n": int(rng.integers(0, 60)),
            "price": float(rng.integers(0, 6000)) / 100.0}


@pytest.mark.parametrize("seed", range(8))
def test_random_registry_matches_jax(seed):
    rng = np.random.default_rng(seed)
    preg, jreg = PercolatorRegistry(), JRegistry()
    n = int(rng.integers(64, 301))
    for i in range(n):
        q = _random_query(rng)
        preg.register(f"q{i:03d}", {"query": q})
        jreg.register(f"q{i:03d}", {"query": q})
    psvc, jsvc = _mappers(MAPPING)
    launched = 0
    before = SERVING_COUNTERS["device_percolate"]
    for d in range(4):
        doc = _random_doc(rng)
        filter_ids = None if d % 2 == 0 else {
            f"q{i:03d}" for i in rng.choice(n, size=n * 3 // 4, replace=False)}
        got = preg.percolate(doc, psvc, filter_ids=filter_ids, device="cpu")
        assert got == jreg.percolate(doc, jsvc, filter_ids=filter_ids), (seed, d)
        assert got == _host_loop(preg, doc, psvc, filter_ids=filter_ids, device="cpu")
        ctx = tperc.one_doc_context(doc, psvc, "doc", "cpu")
        items = [(qid, v) for qid, v in preg._queries.items()
                 if filter_ids is None or qid in filter_ids]
        launched += len(tperc.split_flat(items, ctx)[0]) >= preg.DEVICE_BATCH_MIN
    assert SERVING_COUNTERS["device_percolate"] - before == launched > 0
    assert SERVING_COUNTERS["device_percolate_fallbacks"] == 0


def test_registry_runs_on_the_card_unless_told_otherwise(monkeypatch):
    """An entry point without a device runs on the card: without CUDA it
    raises instead of serving from the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    reg = PercolatorRegistry()
    reg.register("q", {"query": {"term": {"body": "alpha"}}})
    psvc, _ = _mappers()
    with pytest.raises(DeviceUnavailableError):
        reg.percolate({"body": "alpha"}, psvc)


def test_register_requires_a_query():
    from elasticsearch_tpu_torch.common.errors import PercolateError

    with pytest.raises(PercolateError):
        PercolatorRegistry().register("q", {"match": {"body": "x"}})


# ---------------------------------------------------------------------------
# node against node
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    """(port base URL, JAX base URL, port node, JAX node)."""
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu.transport.local import LocalTransportRegistry as JReg

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    p = PNode(name="port", settings={"node.device": "cpu"}, registry=PReg(),
              data_path=str(tmp_path_factory.mktemp("port_perc"))).start()
    j = JNode(name="jax", settings={"search.mesh.enabled": "false",
                                    "indices.warmer.enabled": "false"},
              registry=JReg(), data_path=str(tmp_path_factory.mktemp("jax_perc")))
    try:
        j.start([j.local_node.transport_address])
        j.wait_for_master()
        bases = [f"http://127.0.0.1:{p.start_http(0).port}",
                 f"http://127.0.0.1:{j.start_http(0).port}"]
        for base in bases:
            for index in ("pq", "docs", "gd", "alerts"):
                st, r = call(base, "PUT", f"/{index}", {"settings": {
                    "number_of_shards": 3 if index == "gd" else 1,
                    "number_of_replicas": 0, "refresh_interval": -1}})
                assert st == 200 and r["acknowledged"], r
        yield bases[0], bases[1], p, j
    finally:
        p.close()
        j.close()
        torch.set_num_threads(threads)


def _both(nodes, method, path, body=None, raw=None):
    """The same request to both nodes: equal statuses and JSON (a bulk's or
    search's `took` aside)."""
    pbase, jbase = nodes[0], nodes[1]
    got = call(pbase, method, path, body, raw)
    want = call(jbase, method, path, body, raw)
    for _st, r in (got, want):
        r.pop("took", None)
    assert got == want, (method, path, got, want)
    return got


def _ndjson(lines) -> str:
    return "\n".join(json.dumps(x) for x in lines) + "\n"


def test_percolator_sequence_over_the_client_matches_jax(nodes):
    """tests/test_cluster.py::TestSidecars::test_percolator, port node
    against JAX node through each one's Client."""
    p, j = nodes[2].client(), nodes[3].client()

    def both(fn):
        got, want = fn(p), fn(j)
        assert got == want
        return got

    both(lambda c: c.create_index("cq", {"settings": {"number_of_shards": 1,
                                                     "number_of_replicas": 0}}))
    both(lambda c: c.index("cq", ".percolator",
                           {"query": {"match": {"body": "alert"}}}, id="q1"))
    both(lambda c: c.index("cq", ".percolator",
                           {"query": {"range": {"level": {"gte": 3}}}}, id="q2"))
    r = both(lambda c: c.percolate("cq", {"doc": {"body": "an alert fired", "level": 1}}))
    assert [m["_id"] for m in r["matches"]] == ["q1"]
    r = both(lambda c: c.percolate("cq", {"doc": {"body": "quiet", "level": 5}}))
    assert [m["_id"] for m in r["matches"]] == ["q2"]
    r = both(lambda c: c.percolate("cq", {"doc": {"body": "alert", "level": 9}}))
    assert [m["_id"] for m in r["matches"]] == ["q1", "q2"]
    r = both(lambda c: c.count_percolate("cq", {"doc": {"body": "alert", "level": 9}}))
    assert r["total"] == 2 and "matches" not in r
    both(lambda c: c.delete("cq", ".percolator", "q1"))
    r = both(lambda c: c.percolate("cq", {"doc": {"body": "alert", "level": 9}}))
    assert [m["_id"] for m in r["matches"]] == ["q2"]
    r = both(lambda c: c.mpercolate([({"percolate": {"index": "cq"}},
                                      {"doc": {"body": "alert", "level": 4}}),
                                     ({"count": {"index": "cq"}},
                                      {"doc": {"level": 1}})]))
    assert [x["total"] for x in r["responses"]] == [1, 0]


def test_percolator_sequence_over_rest_matches_jax(nodes):
    for qid, q in (("q1", {"match": {"body": "alert"}}),
                   ("q2", {"range": {"level": {"gte": 3}}}),
                   ("q3", {"bool": {"must": [{"term": {"body": "fired"}}],
                                    "must_not": [{"term": {"body": "quiet"}}]}})):
        st, r = _both(nodes, "PUT", f"/pq/.percolator/{qid}", {"query": q})
        assert st == 201 and r["created"]
    for doc, want in (({"body": "an alert fired", "level": 1}, ["q1", "q3"]),
                      ({"body": "quiet", "level": 5}, ["q2"]),
                      ({"body": "alert", "level": 9}, ["q1", "q2"])):
        st, r = _both(nodes, "POST", "/pq/doc/_percolate", {"doc": doc})
        assert st == 200 and [m["_id"] for m in r["matches"]] == want
        assert r["_shards"] == {"total": 1, "successful": 1, "failed": 0}
        st, r = _both(nodes, "GET", "/pq/doc/_percolate/count", {"doc": doc})
        assert st == 200 and r["total"] == len(want)
    # no [doc]: the request is refused alike
    st, r = _both(nodes, "POST", "/pq/doc/_percolate", {"docs": {}})
    assert st >= 400
    # an existing document, percolated against another index's registry
    st, r = _both(nodes, "PUT", "/docs/doc/1?refresh=true",
                  {"body": "an alert fired", "level": 7})
    assert st == 201
    st, r = _both(nodes, "GET", "/docs/doc/1/_percolate?percolate_index=pq")
    assert st == 200 and [m["_id"] for m in r["matches"]] == ["q1", "q2", "q3"]
    assert all(m["_index"] == "pq" for m in r["matches"])
    st, r = _both(nodes, "GET", "/docs/doc/_percolate?id=1&percolate_index=pq")
    assert st == 200 and r["total"] == 3
    st, r = _both(nodes, "GET", "/docs/doc/1/_percolate?percolate_index=pq&version=1")
    assert st == 200 and r["total"] == 3
    st, r = _both(nodes, "GET", "/docs/doc/1/_percolate?percolate_index=pq&version=4")
    assert st == 409 and r["error"]["type"] == "VersionConflictException"
    st, r = _both(nodes, "GET", "/docs/doc/nope/_percolate?percolate_index=pq")
    assert st == 404 and r["error"]["type"] == "DocumentMissingException"
    st, r = _both(nodes, "GET", "/docs/doc/1/_percolate/count")
    assert st == 200 and r["total"] == 0  # `docs` has no registered query
    # _mpercolate at each prefix, a missing document among its items
    body = _ndjson([{"percolate": {"index": "pq", "type": "doc"}},
                    {"doc": {"body": "alert", "level": 1}},
                    {"count": {"index": "pq"}}, {"doc": {"level": 8}},
                    {"percolate": {"index": "docs", "id": "1",
                                   "percolate_index": "pq"}}, {},
                    {"percolate": {"index": "docs", "id": "missing"}}, {}])
    for path in ("/_mpercolate", "/pq/_mpercolate", "/pq/doc/_mpercolate"):
        st, r = _both(nodes, "POST", path, raw=body)
        assert st == 200 and len(r["responses"]) == 4
        assert r["responses"][3]["status"] == 404
        assert r["responses"][3]["error"].startswith("DocumentMissingException[")
    # DELETE unregisters; a .percolator doc in a _bulk is not registered
    st, r = _both(nodes, "DELETE", "/pq/.percolator/q1")
    assert st == 200 and r["found"]
    bulk = _ndjson([{"index": {"_index": "pq", "_type": ".percolator", "_id": "qb"}},
                    {"query": {"term": {"body": "alert"}}}])
    st, r = _both(nodes, "POST", "/_bulk", raw=bulk)
    assert st == 200 and not r["errors"]
    st, r = _both(nodes, "POST", "/pq/doc/_percolate",
                  {"doc": {"body": "an alert fired", "level": 9}})
    assert [m["_id"] for m in r["matches"]] == ["q2", "q3"]


def test_get_and_delete_match_jax(nodes):
    for i in range(6):
        st, r = _both(nodes, "PUT", f"/gd/doc/{i}",
                      {"body": f"w{i}", "n": i, "obj": {"a": i, "b": {"c": "x"}}})
        assert st == 201
    st, r = _both(nodes, "PUT", "/gd/other/9", {"body": "elsewhere"})
    assert st == 201
    # realtime: before any refresh, from the version map
    for path in ("/gd/doc/3", "/gd/_all/3", "/gd/_all/9", "/gd/other/9",
                 "/gd/doc/3?_source=false", "/gd/doc/3?_source=obj.b",
                 "/gd/doc/3?_source_include=obj&_source_exclude=obj.b",
                 "/gd/doc/3?_source_exclude=body,n"):
        st, r = _both(nodes, "GET", path)
        assert st == 200 and r["found"], path
    # not realtime: unseen until a refresh, which the GET may ask for
    st, r = _both(nodes, "GET", "/gd/doc/4?realtime=false")
    assert st == 404 and r["found"] is False
    st, r = _both(nodes, "GET", "/gd/doc/4?realtime=false&refresh=true")
    assert st == 200 and r["found"]
    st, r = _both(nodes, "GET", "/gd/doc/3?_source=false")
    assert "_source" not in r
    for path in ("/gd/doc/404", "/gd/_all/404", "/gd/other/3"):
        st, r = _both(nodes, "GET", path)
        assert st == 404 and r["found"] is False, path
    st, r = _both(nodes, "GET", "/missing/doc/1")
    assert st == 404
    # deletes: plain, a version conflict, a versioned hit, one not found
    st, r = _both(nodes, "DELETE", "/gd/doc/0")
    assert st == 200 and r["found"] and r["_version"] == 2
    st, r = _both(nodes, "DELETE", "/gd/doc/1?version=7")
    assert st == 409 and r["error"]["type"] == "VersionConflictException"
    st, r = _both(nodes, "DELETE", "/gd/doc/1?version=1&refresh=true")
    assert st == 200 and r["found"]
    st, r = _both(nodes, "DELETE", "/gd/doc/404")
    assert st == 404 and r["found"] is False
    for path in ("/gd/doc/0", "/gd/doc/1", "/gd/_all/1", "/gd/doc/2"):
        _both(nodes, "GET", path)
    _both(nodes, "POST", "/gd/_refresh")
    st, r = _both(nodes, "POST", "/gd/_search", {"query": {"match_all": {}}})
    assert st == 200 and r["hits"]["total"] == 5


def test_client_get_and_delete_match_jax(nodes):
    p, j = nodes[2].client(), nodes[3].client()
    for c in (p, j):
        c.index("gd", "doc", {"body": "client"}, id="c1")
    assert p.get("gd", "doc", "c1") == j.get("gd", "doc", "c1")
    assert p.get("gd", "_all", "c1", realtime=False, refresh=True) == \
        j.get("gd", "_all", "c1", realtime=False, refresh=True)
    assert p.delete("gd", "doc", "c1") == j.delete("gd", "doc", "c1")
    assert p.get("gd", "doc", "c1") == j.get("gd", "doc", "c1")


# ---------------------------------------------------------------------------
# fault domains (the port's; the JAX package falls back on any exception)
# ---------------------------------------------------------------------------

ALERT_QUERIES = 96


@pytest.fixture(scope="module")
def alerts(nodes):
    """`alerts` on both nodes with ALERT_QUERIES registered queries, most of
    them flat; returns the documents to percolate."""
    rng = np.random.default_rng(5)
    for i in range(ALERT_QUERIES):
        q = _random_query(rng)
        for c in (nodes[2].client(), nodes[3].client()):
            c.index("alerts", ".percolator", {"query": q}, id=f"a{i:02d}")
    return [_random_doc(rng) for _ in range(3)]


def _percolate_both(nodes, doc):
    return _both(nodes, "POST", "/alerts/doc/_percolate", {"doc": doc})


def test_armed_domain_serves_the_host_loop_then_recovers(nodes, alerts):
    card = [_percolate_both(nodes, d) for d in alerts]  # the batch, unarmed
    before = dict(SERVING_COUNTERS)
    DEVICE_FAULTS.arm(error="transfer", domain="compile:percolate", times=10**6)
    # the circuits' clock stands still while armed: a percolation slower
    # than the first jittered backoff (~70-110 ms) would otherwise admit a
    # probe, and its failure, between two of them
    clock = DEVICE_HEALTH._clock
    frozen = clock()
    DEVICE_HEALTH._clock = lambda: frozen
    try:
        for d, want in zip(alerts, card):
            assert _percolate_both(nodes, d) == want  # 200, the JAX node's matches
    finally:
        DEVICE_HEALTH._clock = clock
    assert DEVICE_HEALTH.state("compile:percolate") == OPEN
    # the first trips the domain; the open domain skips the next launches
    assert DEVICE_FAULTS.injected >= 1
    assert SERVING_COUNTERS["device_percolate"] == before["device_percolate"]
    assert SERVING_COUNTERS["device_percolate_fallbacks"] - \
        before["device_percolate_fallbacks"] == len(alerts)
    assert SERVING_COUNTERS["degraded"] - before["degraded"] == len(alerts)
    assert SERVING_COUNTERS["device_errors"] - before["device_errors"] == 1
    injected = DEVICE_FAULTS.injected
    DEVICE_FAULTS.disarm()
    deadline = time.monotonic() + 15.0
    while DEVICE_HEALTH.state("compile:percolate") != CLOSED:
        assert time.monotonic() < deadline, DEVICE_HEALTH.stats()
        assert _percolate_both(nodes, alerts[0]) == card[0]
        time.sleep(0.02)
    assert DEVICE_FAULTS.injected == injected
    served = SERVING_COUNTERS["device_percolate"]
    assert _percolate_both(nodes, alerts[1]) == card[1]
    assert SERVING_COUNTERS["device_percolate"] == served + 1


def test_search_families_do_not_gate_on_the_percolate_domain(nodes, alerts):
    """An open `compile:percolate` sends no search to the host path."""
    DEVICE_FAULTS.arm(error="launch", domain="compile:percolate", times=1)
    _percolate_both(nodes, alerts[0])
    assert DEVICE_HEALTH.state("compile:percolate") == OPEN
    before = SERVING_COUNTERS["degraded"]
    st, r = call(nodes[0], "POST", "/gd/_search", {"query": {"match": {"body": "w3"}}})
    assert st == 200 and r["_shards"]["degraded"] == 0
    assert SERVING_COUNTERS["degraded"] == before


@pytest.mark.parametrize("code", [9, 701, 1])
def test_defect_answers_500_and_moves_no_circuit(nodes, alerts, monkeypatch, code):
    def refuse(*a, **k):
        raise CudaError(code, f"sparse_score launch failed: CUDA error {code}",
                        kernel="sparse_score")

    monkeypatch.setattr(tperc, "execute_flat_batch", refuse)
    before = dict(SERVING_COUNTERS)
    st, r = call(nodes[0], "POST", "/alerts/doc/_percolate", {"doc": alerts[0]})
    assert st == 500 and f"CUDA error {code}" in r["error"]["reason"]
    assert SERVING_COUNTERS["device_errors"] - before["device_errors"] == 1
    for key in ("degraded", "device_percolate", "device_percolate_fallbacks"):
        assert SERVING_COUNTERS[key] == before[key], key
    assert not DEVICE_HEALTH.dirty and not DEVICE_HEALTH.any_open


def test_host_bug_in_the_batch_answers_500(nodes, alerts, monkeypatch):
    def bug(*a, **k):
        raise KeyError("a host bug")

    monkeypatch.setattr(tperc, "execute_flat_batch", bug)
    before = SERVING_COUNTERS["device_errors"]
    st, r = call(nodes[0], "POST", "/alerts/doc/_percolate", {"doc": alerts[0]})
    assert st == 500 and r["error"]["type"] == "KeyError"
    assert SERVING_COUNTERS["device_errors"] == before + 1
    assert not DEVICE_HEALTH.dirty


def test_lowering_trouble_sends_one_query_to_the_host_loop(nodes, alerts, monkeypatch):
    orig = tperc.lower_flat
    seen = []

    def lower(query, ctx):
        if not seen:
            seen.append(query)
            raise ValueError("cannot lower")
        return orig(query, ctx)

    monkeypatch.setattr(tperc, "lower_flat", lower)
    before = dict(SERVING_COUNTERS)
    for d in alerts:
        seen.clear()
        _percolate_both(nodes, d)
    assert SERVING_COUNTERS["device_percolate"] - before["device_percolate"] == len(alerts)
    for key in ("device_errors", "degraded", "device_percolate_fallbacks"):
        assert SERVING_COUNTERS[key] == before[key], key
