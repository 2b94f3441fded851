"""The `profile` API on the port (common/profile.py, its hooks on the device
path, search/service.py, actions.py, the coordinator's `profile` section)
against the JAX package, and the surfaces that read a node's threads and
device: hot threads and the `torch.profiler` routes.

Units, on both packages' ProfileCollector: the thread-local activation,
phases accumulating, additive per-segment counters beside overwritten
identity keys, the event and reservation caps, first writer wins. The
fallback-reason vocabulary (`execute.lower_fallback_reason`) on the same
seeded shard in both packages. The port's DeviceClock: on the CPU it times
its launches with `time.perf_counter`; a CUDA clock whose events cannot be
recorded raises ProfileTimingError, and a profiled request that meets one
fails (500), never answered with host timings.

Node against node (the same bulk on both): for each body of a table that
reaches every branch (the sparse kernel, the dense filtered and function
families, device aggregations, sort and post filter, the host scorer for
the fallback reasons), every shard's profile has the JAX node's outcome,
fallback reason, plan, batcher bypass and per-segment path, layout and
block, posting, bucket and launch counts; timings are non-negative; the
hits equal the unprofiled answer on both nodes. `?profile=true` equals the
body flag; an unprofiled response has no `profile`; each profiled shard
counts one `profile_bypassed` on the batcher; a profiled size-0 body peeks
the request cache and still runs. Declared differences, masked by name:
`staged_bytes` (the port's staging buffer has its own layout) and
`plane_bytes` (the port's count of the device planes' bytes a plan read, 6
B a slot), the segment's `ms`, the phases of a non-sparse branch (the
port times its dense families' dispatch, pull and merge too), and the
post filter's batcher bypass (the port serves that branch through the
batcher, a declared path difference).

Hot threads (`test_profile.py` :444-486 on both nodes): a busy thread
ranks with its CPU share, `?threads=` bounds the report, a bad
`?interval=` answers 400. The device profiler: a start, searches and a
stop write a Chrome trace; a second start and a stop with none running
answer 400."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from elasticsearch_tpu.common import profile as jprofile
from elasticsearch_tpu_torch.common import profile as tprofile
from elasticsearch_tpu_torch.common.errors import ProfileTimingError
from tests.test_torch_node import _node_pair, call

INDEX = "pf"
WORDS = [f"w{j}" for j in range(12)]


@pytest.fixture(params=["jax", "port"])
def prof_mod(request):
    return {"jax": jprofile, "port": tprofile}[request.param]


# ---------------------------------------------------------------------------
# collector units
# ---------------------------------------------------------------------------


def test_current_is_none_off_thread(prof_mod):
    assert prof_mod.current() is None
    prof = prof_mod.ProfileCollector(node="n", index="i", shard=3)
    with prof_mod.activate(prof):
        assert prof_mod.current() is prof
        seen = []
        t = threading.Thread(target=lambda: seen.append(prof_mod.current()))
        t.start()
        t.join()
        assert seen == [None]
    assert prof_mod.current() is None


def test_phases_accumulate_and_round(prof_mod):
    prof = prof_mod.ProfileCollector()
    prof.phase_s("lower", 0.001)
    prof.phase_s("lower", 0.002)
    d = prof.to_dict()
    assert d["phases_ms"]["lower"] == pytest.approx(3.0, abs=0.01)
    assert d["phases_ms"]["total"] >= 0


def test_segment_counters_additive_identity_overwrites(prof_mod):
    prof = prof_mod.ProfileCollector()
    prof.segment(7, docs=100, path="sparse_composed", blocks_scanned=3, ms=1.0)
    prof.segment(7, docs=100, path="dense_filtered", blocks_scanned=2, ms=0.5)
    (seg,) = prof.to_dict()["segments"]
    assert (seg["generation"], seg["blocks_scanned"], seg["docs"], seg["path"]) == \
        (7, 5, 100, "dense_filtered")
    assert seg["ms"] == pytest.approx(1.5, abs=0.01)


def test_event_and_reservation_caps(prof_mod):
    C = prof_mod.ProfileCollector
    prof = C()
    for _ in range(C.MAX_EVENTS + 5):
        prof.event("scratch", cache="reuse")
    for _ in range(C.MAX_RESERVATIONS + 3):
        prof.breaker_reserve("request", "<x>", 10)
    d = prof.to_dict()
    assert (len(d["cache"]["events"]), d["cache"]["dropped"]) == (C.MAX_EVENTS, 5)
    assert (len(d["breakers"]["reservations"]), d["breakers"]["dropped"]) == \
        (C.MAX_RESERVATIONS, 3)
    assert d["breakers"]["reserved_bytes_total"] == (C.MAX_RESERVATIONS + 3) * 10


def test_first_writer_wins_for_plan_outcome_fallback(prof_mod):
    prof = prof_mod.ProfileCollector()
    prof.outcome("device_sparse")
    prof.outcome("host")
    prof.set_plan({"query_type": "A"})
    prof.set_plan({"query_type": "B"})
    prof.fallback("numeric_term")
    prof.fallback("fuzzy_match")
    prof.batcher_bypass("profile")
    d = prof.to_dict()
    assert (d["plan"]["outcome"], d["plan"]["query_type"],
            d["plan"]["fallback_reason"]) == ("device_sparse", "A", "numeric_term")
    assert d["batcher"] == {"bypassed": True, "reason": "profile"}


def test_collectors_render_the_same_dict():
    """The same calls on both packages' collectors give the same dict but
    the wall-clock total."""
    def fill(mod):
        prof = mod.ProfileCollector(node="n", index="i", shard=1)
        prof.phase_s("parse", 0.0005)
        prof.set_plan({"query_type": "MatchQuery", "msm": 1})
        prof.outcome("device_sparse")
        prof.segment(3, docs=10, path="sparse_composed", blocks_scanned=2, ms=0.25)
        prof.event("packed_segment", gen=3, cache="hit")
        prof.breaker_reserve("request", "<sparse_staging>", 2048)
        prof.batcher_bypass("profile")
        d = prof.to_dict()
        d["phases_ms"].pop("total")
        return d

    assert fill(jprofile) == fill(tprofile)


def test_device_clock_times_cpu_launches_with_perf_counter():
    import torch

    clock = tprofile.DeviceClock(torch.device("cpu"))
    assert clock.elapsed_s() == 0.0
    with clock.launch():
        time.sleep(0.01)
    with clock.launch():
        pass
    assert clock.launches == 2 and 0.009 < clock.elapsed_s() < 1.0
    # timed_launch brackets only under an active collector with a clock
    assert tprofile.timed_launch(lambda x: x + 1, 1) == 2
    prof = tprofile.ProfileCollector()
    prof.clock = clock
    with tprofile.activate(prof):
        assert tprofile.timed_launch(lambda x: x * 3, 2) == 6
    assert clock.launches == 3


def test_cuda_clock_without_events_raises_profile_timing_error():
    import torch

    clock = tprofile.DeviceClock(torch.device("cpu"))
    clock.cuda = True  # a card whose events cannot be made or recorded
    with pytest.raises(ProfileTimingError, match="CUDA event"):
        with clock.launch():
            pass


# ---------------------------------------------------------------------------
# the fallback-reason vocabulary, shard against shard
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shard_ctxs(tmp_path_factory):
    from elasticsearch_tpu.common.settings import Settings as JS
    from elasticsearch_tpu.index import Engine as JE
    from elasticsearch_tpu.mapper import MapperService as JM
    from elasticsearch_tpu.search import ShardContext as JC
    from elasticsearch_tpu.search.similarity import SimilarityService as JSim
    from elasticsearch_tpu_torch.common.settings import Settings as TS
    from elasticsearch_tpu_torch.index.engine import Engine as TE
    from elasticsearch_tpu_torch.mapper import MapperService as TM
    from elasticsearch_tpu_torch.search import ShardContext as TC
    from elasticsearch_tpu_torch.search.similarity import SimilarityService as TSim

    out = {}
    for name, (S, E, M, C, Sim, extra) in {
            "jax": (JS, JE, JM, JC, JSim, {}),
            "port": (TS, TE, TM, TC, TSim, {"device": "cpu"})}.items():
        settings = S.from_flat({})
        svc = M(settings)
        svc.put_mapping("doc", {"doc": {"properties": {"n": {"type": "long"}}}})
        e = E(str(tmp_path_factory.mktemp(f"fb_{name}") / "shard0"), svc)
        rng = np.random.default_rng(31)
        for i in range(30):
            e.index("doc", str(i), {"body": " ".join(rng.choice(WORDS, 3)), "n": i})
        e.refresh()
        out[name] = C(e.acquire_searcher(), svc, Sim(settings, mapper_service=svc),
                      **extra)
    return out


FALLBACKS = {
    "phrase": ({"match_phrase": {"body": "w1 w2"}}, "unsupported_query:PhraseQuery"),
    "numeric_term": ({"term": {"n": 3}}, "numeric_term"),
    "fuzzy": ({"match": {"body": {"query": "w11x", "fuzziness": "AUTO"}}}, "fuzzy_match"),
    "bool_filter": ({"bool": {"must": [{"term": {"body": "w1"}}],
                              "filter": {"term": {"body": "w2"}}}}, "bool_filter_clause"),
    "non_term_sub": ({"bool": {"must": [{"match_phrase": {"body": "w1 w2"}}]}},
                     "non_term_subclause"),
    "must_not_only": ({"bool": {"must_not": [{"term": {"body": "w1"}}]}}, "must_not_only"),
    "fs_non_flat": ({"function_score": {"query": {"match_phrase": {"body": "w1 w2"}},
                                        "functions": [{"weight": 2.0}]}}, "non_flat_subquery"),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallback_reason_vocabulary_matches_jax(shard_ctxs, case):
    from elasticsearch_tpu.search import parse_query as jparse
    from elasticsearch_tpu.search.execute import lower_fallback_reason as jreason
    from elasticsearch_tpu.search.execute import lower_flat as jlower
    from elasticsearch_tpu_torch.search import parse_query as tparse
    from elasticsearch_tpu_torch.search.execute import lower_fallback_reason as treason
    from elasticsearch_tpu_torch.search.execute import lower_flat as tlower

    qdict, want = FALLBACKS[case]
    jq, tq = jparse(qdict), tparse(qdict)
    assert jlower(jq, shard_ctxs["jax"]) is None and tlower(tq, shard_ctxs["port"]) is None
    assert treason(tq, shard_ctxs["port"]) == jreason(jq, shard_ctxs["jax"]) == want


# ---------------------------------------------------------------------------
# node against node
# ---------------------------------------------------------------------------


def _bulk(seed: int = 29, n: int = 160) -> str:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        lines.append(json.dumps({"index": {"_index": INDEX, "_type": "doc",
                                           "_id": str(i)}}))
        lines.append(json.dumps({"body": " ".join(rng.choice(WORDS, int(rng.integers(3, 10)))),
                                 "n": i, "tag": f"t{i % 4}"}))
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


MATCH = {"match": {"body": "w1 w2"}}
BODIES = {
    "sparse": {"query": MATCH, "size": 5},
    "bool": {"query": {"bool": {"must": [{"term": {"body": "w1"}}],
                                "should": [{"term": {"body": "w2"}}],
                                "must_not": [{"term": {"body": "w3"}}]}}},
    "phrase": {"query": {"match_phrase": {"body": "w1 w2"}}},
    "fuzzy": {"query": {"match": {"body": {"query": "w11x", "fuzziness": "AUTO"}}}},
    "rescore": {"query": MATCH, "rescore": {"query": {
        "rescore_query": {"match": {"body": "w4"}}}}},
    "filtered": {"query": {"filtered": {"query": MATCH,
                                        "filter": {"term": {"tag": "t1"}}}}},
    "function_score": {"query": {"function_score": {"query": MATCH,
                                                    "functions": [{"weight": 2.0}]}}},
    "aggs": {"query": MATCH, "aggs": {"m": {"max": {"field": "n"}}}},
    "sort": {"query": MATCH, "sort": [{"n": "desc"}]},
    "post_filter": {"query": MATCH, "post_filter": {"term": {"tag": "t2"}}},
    "min_score": {"query": MATCH, "min_score": 0.5},
}
# compared per segment; `ms` is a wall time and `staged_bytes` /
# `plane_bytes` are the port's own byte counts (a declared difference)
_SEG_MASK = {"ms", "staged_bytes", "plane_bytes"}


def _profiled(nodes, body):
    pbase, jbase, _p = nodes
    out = []
    for base in (pbase, jbase):
        st, r = call(base, "POST", f"/{INDEX}/_search?profile=true", body)
        assert st == 200, r
        out.append(r)
    return out


@pytest.mark.parametrize("case", sorted(BODIES))
def test_profile_section_matches_the_jax_node(nodes, case):
    body = BODIES[case]
    pr, jr = _profiled(nodes, body)
    pshards, jshards = pr["profile"]["shards"], jr["profile"]["shards"]
    assert [(s["index"], s["shard"]) for s in pshards] == \
        [(s["index"], s["shard"]) for s in jshards] == [(INDEX, 0), (INDEX, 1)]
    for ps, js in zip(pshards, jshards):
        assert ps["plan"] == js["plan"], case
        if case == "post_filter":
            # a declared path difference: the port's post filter without
            # aggregations is a batcher plan (bypassed when profiled); the
            # JAX node launches it on its own
            assert (ps["batcher"], js.get("batcher")) == (
                {"bypassed": True, "reason": "profile"}, None)
        else:
            assert ps.get("batcher") == js.get("batcher")
        assert ps["winner"] == js["winner"] == "primary"
        assert set(ps) - {"batcher"} == set(js) - {"batcher"}
        assert [{k: v for k, v in seg.items() if k not in _SEG_MASK}
                for seg in ps["segments"]] == \
            [{k: v for k, v in seg.items() if k not in _SEG_MASK}
             for seg in js["segments"]], case
        assert all(v >= 0 for v in ps["phases_ms"].values())
        if ps["plan"]["outcome"] == "device_sparse":
            assert set(ps["phases_ms"]) == set(js["phases_ms"])
            assert all(seg["plane_bytes"] == seg["blocks_scanned"] * 128 * 6
                       for seg in ps["segments"])
            assert "<sparse_staging>" in {r["label"] for r in
                                          ps["breakers"]["reservations"]}
        kinds = {e["kind"] for e in ps["cache"]["events"]}
        assert kinds <= {"packed_segment", "sim_tables", "scratch", "blk_freqs",
                         "filter_cache", "request_cache", "device_error",
                         "device_degraded"}


@pytest.mark.parametrize("case", sorted(BODIES))
def test_hits_identical_with_and_without_profile(nodes, case):
    body = BODIES[case]
    prof = _profiled(nodes, body)
    for base, pr in zip(nodes[:2], prof):
        plain = call(base, "POST", f"/{INDEX}/_search", body)[1]
        assert pr["hits"] == plain["hits"] and "profile" not in plain
        assert pr.get("aggregations") == plain.get("aggregations")
    assert prof[0]["hits"] == prof[1]["hits"]


def test_profile_body_flag_equals_the_parameter(nodes):
    pbase = nodes[0]
    a = call(pbase, "POST", f"/{INDEX}/_search?profile=true", BODIES["sparse"])[1]
    b = call(pbase, "POST", f"/{INDEX}/_search", {**BODIES["sparse"], "profile": True})[1]
    assert a["hits"] == b["hits"]
    assert [s["plan"] for s in a["profile"]["shards"]] == \
        [s["plan"] for s in b["profile"]["shards"]]


def test_batcher_counts_a_profile_bypass_a_shard(nodes):
    pbase, jbase, p = nodes
    before = p.search_batcher.stats()["profile_bypassed"]
    call(pbase, "POST", f"/{INDEX}/_search?profile=true", BODIES["sparse"])
    assert p.search_batcher.stats()["profile_bypassed"] == before + 2
    st, r = call(pbase, "GET", "/_nodes/stats/search")
    assert next(iter(r["nodes"].values()))["search"]["batcher"]["profile_bypassed"] \
        == before + 2


def test_profiled_size_zero_body_peeks_the_request_cache(nodes):
    body = {"query": {"match": {"body": "w5"}}, "size": 0,
            "aggs": {"m": {"max": {"field": "n"}}}}
    pbase, jbase, _p = nodes
    for base in (pbase, jbase):
        call(base, "POST", f"/{INDEX}/_search", body)  # stores
    for base in (pbase, jbase):
        st, r = call(base, "POST", f"/{INDEX}/_search?profile=true", body)
        assert st == 200
        for shard in r["profile"]["shards"]:
            rc = [e["cache"] for e in shard["cache"]["events"]
                  if e["kind"] == "request_cache"]
            assert rc == ["hit"], shard["cache"]
            assert shard["plan"]["outcome"] == "device_aggs"


def test_a_profiled_request_whose_clock_fails_fails(nodes, monkeypatch):
    """No host timing stands in for the card's: a profiled request whose
    DeviceClock cannot record its events answers 500, and the same request
    unprofiled still serves."""
    pbase, _jbase, _p = nodes
    orig = tprofile.DeviceClock.__init__

    def cuda_clock(self, device):
        orig(self, device)
        self.cuda = True

    monkeypatch.setattr(tprofile.DeviceClock, "__init__", cuda_clock)
    st, r = call(pbase, "POST", f"/{INDEX}/_search?profile=true", BODIES["sparse"])
    assert st == 500 and r["error"]["type"] == "ProfileTimingException", r
    assert call(pbase, "POST", f"/{INDEX}/_search", BODIES["sparse"])[0] == 200


# ---------------------------------------------------------------------------
# hot threads and the device profiler
# ---------------------------------------------------------------------------


def _text(base, path, method="GET"):
    req = urllib.request.Request(base + path, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


@pytest.mark.parametrize("which", ["port", "jax"])
def test_hot_threads_ranks_a_busy_thread(nodes, which):
    base = nodes[0] if which == "port" else nodes[1]
    stop = threading.Event()

    def burn():
        x = 0
        while not stop.is_set():
            x = (x * 31 + 7) % 1000003

    t = threading.Thread(target=burn, name="estpu[hot-burner]", daemon=True)
    t.start()
    try:
        st, ctype, text = _text(base, "/_nodes/hot_threads?interval=250ms&threads=4")
    finally:
        stop.set()
        t.join(5)
    assert st == 200 and ctype.startswith("text/plain")
    assert text.startswith(":::") and "idle/parked skipped" in text
    line = next(ln for ln in text.splitlines() if "hot-burner" in ln)
    assert float(line.strip().split("%")[0]) > 0.0


@pytest.mark.parametrize("path", ["/_nodes/hot_threads", "/_cluster/nodes/hot_threads"])
def test_hot_threads_bounds_match_jax(nodes, path):
    for base in nodes[:2]:
        st, _c, text = _text(base, f"{path}?interval=50ms&threads=1")
        assert st == 200
        assert len([ln for ln in text.splitlines() if "% cpu usage" in ln]) <= 1
        st, _c, text = _text(base, f"{path}?interval=bogus")
        assert st == 400, text


def test_device_profiler_start_search_stop(nodes):
    pbase, _jbase, p = nodes
    st, r = call(pbase, "POST", "/_nodes/_local/profiler/stop")
    assert st == 400 and r["error"] == "profiler not running"
    st, r = call(pbase, "POST", "/_nodes/_local/profiler/start")
    assert st == 200 and r["started"] and r["dir"].startswith(p.data_path)
    try:
        st2, r2 = call(pbase, "POST", "/_nodes/_local/profiler/start")
        assert st2 == 400 and r2["error"] == "profiler already running"
        assert call(pbase, "POST", f"/{INDEX}/_search", BODIES["sparse"])[0] == 200
    finally:
        st, r = call(pbase, "POST", "/_nodes/_local/profiler/stop")
    assert st == 200 and r["stopped"] and len(r["files"]) == 1
    with open(r["files"][0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert isinstance(events, list)
