"""Request tracing on the port (common/tracing.py, the wire context of
common/stream.py, the transport's spans, the batcher's and the
coordinator's hooks, the slowlog, `/_nodes/stats`, Prometheus) against the
JAX package.

Units, each run on both packages' modules with the same inputs: the
striped HistogramMetric (buckets, percentiles, overflow, concurrent
observers, the cumulative view), the tracer (an unsampled request is a
no-op and marks the decision made, the ring's bound and its eviction
counter, a late span close and a late remote stitch refresh the ring, the
in-flight tasks, `continue_trace` under a wire context, explicit-time
records and `phase_breakdown`). `TraceContext` crosses both codecs both
ways.

Node against node (a port node on the CPU and a JAX node, the same bulk):
`?trace=true` answers the JAX node's span tree (the same span names and
the same parent → child edges: rest → coordinator → transport → shard →
batcher.queue / batcher.dispatch / batcher.merge → device_pull) with the
same hits; a `?scroll=` search is traced too; an untraced response has no
`trace`; `/_traces` and `/_tasks` have the JAX node's keys; the slowlog
line carries the trace id, the shape id and the phase breakdown, from an
index threshold and from a cluster-level one; `/_nodes/stats` has the JAX
node's sections, `adaptive_routing` included, each addressable alone, an
unknown one a 400 on both; the Prometheus text parses under the text
grammar with every family one contiguous group, and holds the JAX node's
families but the declared ones (XLA compiles, the compile-warming
registry). The zero-added-waits pin: a warmed loop
through the batcher with tracing at 1.0 and insights on waits once a
batch (`PendingPull.wait`) and never calls `torch.cuda.synchronize`;
`ESTPU_TRACE_SYNC=1` is opt-in and returns the same hits."""

import json
import logging
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common import metrics as jmetrics
from elasticsearch_tpu.common import stream as jstream
from elasticsearch_tpu.common import tracing as jtracing
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu_torch.common import cudaenv
from elasticsearch_tpu_torch.common import metrics as tmetrics
from elasticsearch_tpu_torch.common import stream as tstream
from elasticsearch_tpu_torch.common import tracing as ttracing
from elasticsearch_tpu_torch.common.settings import Settings as TSettings
from tests.test_torch_node import _node_pair, call

PKGS = {"jax": (jmetrics, jtracing, JSettings), "port": (tmetrics, ttracing, TSettings)}


@pytest.fixture(params=["jax", "port"])
def pkg(request):
    return PKGS[request.param]


# ---------------------------------------------------------------------------
# HistogramMetric
# ---------------------------------------------------------------------------


def test_histogram_bucketing_and_percentiles(pkg):
    h = pkg[0].HistogramMetric()
    for _ in range(90):
        h.observe(0.001)
    for _ in range(10):
        h.observe(0.1)
    assert h.count == 100
    assert abs(h.sum - (90 * 0.001 + 10 * 0.1)) < 1e-9
    p50, p99 = h.percentile(0.50), h.percentile(0.99)
    assert 0.0004 < p50 < 0.004 and 0.04 < p99 < 0.3
    assert p50 <= h.percentile(0.95) <= p99


def test_histogram_empty_and_overflow(pkg):
    h = pkg[0].HistogramMetric()
    assert h.percentile(0.99) == 0.0 and h.stats()["count"] == 0
    h.observe(10_000.0)
    buckets, total, _ = h.cumulative()
    assert total == 1 and buckets[-1] == (float("inf"), 1) and buckets[-2][1] == 0


def test_histogram_concurrent_observes_lose_nothing(pkg):
    h = pkg[0].HistogramMetric()

    def worker(seed):
        for i in range(500):
            h.observe(0.0001 * ((seed + i) % 7 + 1))

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert h.count == 8 * 500


def test_histogram_cumulative_monotone_and_stats_shape(pkg):
    h = pkg[0].HistogramMetric()
    for v in (0.0002, 0.003, 0.04, 0.5, 6.0):
        h.observe(v)
    buckets, total, _ = h.cumulative()
    cums = [c for (_b, c) in buckets]
    assert cums == sorted(cums) and cums[-1] == total == 5
    assert set(h.stats()) == {"count", "mean_ms", "p50_ms", "p95_ms", "p99_ms"}


def test_histograms_agree_on_seeded_samples():
    """The same seeded samples give both packages' histograms the same
    counts, sums and percentiles."""
    samples = np.random.default_rng(19).lognormal(-6, 2, 2000)
    hj, ht = jmetrics.HistogramMetric(), tmetrics.HistogramMetric()
    for v in samples:
        hj.observe(float(v))
        ht.observe(float(v))
    assert hj.cumulative()[0] == ht.cumulative()[0]
    assert hj.stats() == ht.stats()


# ---------------------------------------------------------------------------
# tracer units
# ---------------------------------------------------------------------------


def _tracer(pkg, rate="0", ring=None):
    flat = {"search.trace.sample_rate": rate}
    if ring is not None:
        flat["search.trace.ring_size"] = str(ring)
    t = pkg[1].Tracer(pkg[2].from_flat(flat), node_name="test")
    t.sample_rate = float(rate)
    return t


def test_unsampled_is_noop_and_marks_the_decision(pkg):
    tracing = pkg[1]
    tr = _tracer(pkg, "0")
    trace = tr.start_trace("rest")
    assert not trace and trace.root is tracing.NOOP_SPAN
    assert trace.span("x") is tracing.NOOP_SPAN
    trace.root.end()
    assert tr.traces() == []
    with tracing.activate(trace.root):
        cur = tracing.current_span()
        assert cur is tracing.NOOP_SPAN and not cur
        assert cur.child("coordinator") is tracing.NOOP_SPAN
    assert tracing.current_span() is None


def test_rest_decline_suppresses_coordinator_roll(pkg, monkeypatch):
    tracing = pkg[1]
    rolls = iter([0.99, 0.0, 0.0])
    monkeypatch.setattr(tracing.random, "random", lambda: next(rolls))
    tr = _tracer(pkg, "0")
    tr.sample_rate = 0.5
    trace = tr.start_trace("rest")
    assert not trace
    with tracing.activate(trace.root):
        parent = tracing.current_span()
        assert parent is not None and parent.child("coordinator") is tracing.NOOP_SPAN
    assert tr.stats()["sampled"] == 0
    assert next(rolls) == 0.0


def test_late_span_close_refreshes_ring(pkg):
    tr = _tracer(pkg, "0")
    trace = tr.start_trace("rest", force=True)
    child = trace.root.child("transport[q]")
    trace.root.end()
    assert {s["name"] for s in tr.traces()[0]["spans"]} == {"rest"}
    child.end()
    assert {s["name"] for s in tr.traces()[0]["spans"]} == {"rest", "transport[q]"}


def test_late_remote_stitch_refreshes_ring(pkg):
    tr = _tracer(pkg, "0", ring=4)
    trace = tr.start_trace("rest", force=True)
    root_id = trace.root.span_id
    trace.root.end()
    trace.add_remote([{"id": 99, "parent": root_id, "name": "shard", "t0": 0.0,
                       "t1": 0.5, "duration_ms": 500.0, "tags": {}}])
    (snap,) = tr.traces()
    assert {s["name"] for s in snap["spans"]} == {"rest", "shard"}
    assert tr.stats()["finished"] == 1
    for _ in range(4):
        tr.start_trace("rest", force=True).root.end()
    trace.add_remote([{"id": 100, "parent": root_id, "name": "late", "t0": 0.0,
                       "t1": 0.1, "duration_ms": 100.0, "tags": {}}])
    assert all(s["trace_id"] != trace.trace_id for s in tr.traces())
    assert tr.stats()["late_stitch_dropped"] == 1


def test_forced_traces_ring_and_eviction_counter(pkg):
    tr = _tracer(pkg, "0", ring=4)
    ids = []
    for _ in range(7):
        trace = tr.start_trace("rest", force=True)
        with trace.root.child("coordinator"):
            pass
        trace.root.end()
        ids.append(trace.trace_id)
    got = tr.traces()
    assert [t["trace_id"] for t in got] == ids[-1:-5:-1]
    assert {s["name"] for s in got[0]["spans"]} == {"rest", "coordinator"}
    st = tr.stats()
    assert (st["ring"], st["finished"], st["ring_evicted"]) == (4, 7, 3)
    assert len(tr.traces(2)) == 2 and tr.traces(0) == []


def test_tasks_show_in_flight(pkg):
    tr = _tracer(pkg, "0")
    trace = tr.start_trace("rest", force=True)
    child = trace.root.child("coordinator")
    (task,) = tr.tasks()
    assert task["trace_id"] == trace.trace_id and task["current_span"] == "coordinator"
    assert task["cancellable"] is False and task["running_time_ms"] >= 0
    child.end()
    trace.root.end()
    assert tr.tasks() == [] and tr.stats()["in_flight"] == 0


def test_continue_trace_stitches_parent(pkg):
    tr = _tracer(pkg, "0")
    root_trace = tr.start_trace("rest", force=True)
    wire = tr.wire_context(root_trace.root)
    shard_trace = tr.continue_trace(wire, "shard")
    assert shard_trace.trace_id == root_trace.trace_id
    assert shard_trace.root.parent_id == root_trace.root.span_id
    shard_trace.root.end()
    root_trace.add_remote(shard_trace.span_dicts())
    root_trace.root.end()
    tree = pkg[1].span_tree(root_trace.span_dicts())
    assert tree["name"] == "rest" and [c["name"] for c in tree["children"]] == ["shard"]
    assert not tr.continue_trace(None, "shard")
    # the dict form of a wire context continues too
    assert tr.continue_trace({"tid": "ab", "sid": 5}, "shard").trace_id == "ab"


def test_record_explicit_times_and_phase_breakdown(pkg):
    tr = _tracer(pkg, "0")
    trace = tr.start_trace("shard", force=True)
    t0 = time.monotonic()
    q = trace.root.record("batcher.queue", t0, t0 + 0.010)
    m = trace.root.record("batcher.merge", t0 + 0.012, t0 + 0.030)
    m.record("device_pull", t0 + 0.012, t0 + 0.020)
    assert q.t1 - q.t0 == pytest.approx(0.010)
    trace.root.end()
    phases = pkg[1].phase_breakdown(trace)
    assert phases["queue_ms"] == pytest.approx(10.0, abs=0.1)
    assert phases["device_ms"] == pytest.approx(8.0, abs=0.1)
    assert phases["merge_ms"] == pytest.approx(10.0, abs=0.1)
    assert pkg[1].phase_breakdown(None) == {"queue_ms": 0.0, "device_ms": 0.0,
                                            "merge_ms": 0.0}


def test_sync_mode_is_opt_in(pkg, monkeypatch):
    monkeypatch.delenv("ESTPU_TRACE_SYNC", raising=False)
    assert not pkg[1].sync_armed()
    monkeypatch.setenv("ESTPU_TRACE_SYNC", "1")
    assert pkg[1].sync_armed()


# ---------------------------------------------------------------------------
# the wire context through both codecs
# ---------------------------------------------------------------------------

CODECS = {"jax": (jstream, jtracing), "port": (tstream, ttracing)}


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_trace_context_crosses_both_codecs(writer, reader):
    (wstream, wtracing), (rstream, rtracing) = CODECS[writer], CODECS[reader]
    out = wstream.StreamOutput()
    out.write_value({"body": {"q": 1}, "_trace": wtracing.TraceContext(
        "abcd1234abcd1234", 1234567890123)})
    data = out.bytes()
    back = rstream.StreamInput(data).read_value()
    assert back["_trace"] == rtracing.TraceContext("abcd1234abcd1234", 1234567890123)
    assert back["body"] == {"q": 1}
    # byte for byte the same encoding
    other = rstream.StreamOutput()
    other.write_value(back)
    assert other.bytes() == data


# ---------------------------------------------------------------------------
# node against node
# ---------------------------------------------------------------------------

INDEX = "tr"


def _bulk(seed: int = 23, n: int = 120) -> str:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        words = rng.choice([f"w{j}" for j in range(12)], int(rng.integers(3, 12)))
        lines.append(json.dumps({"index": {"_index": INDEX, "_type": "doc",
                                           "_id": str(i)}}))
        lines.append(json.dumps({"body": " ".join(words) + " common", "n": i,
                                 "tag": f"t{i % 5}"}))
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


# every shard wins hits (size 60 of a term every document holds), so no
# shard's context is freed after the response and the trees are stable
COMMON = {"query": {"match": {"body": "common w1"}}, "size": 60}


def _flatten(node, out=None):
    out = [] if out is None else out
    out.append(node)
    for c in node["children"]:
        _flatten(c, out)
    return out


def _edges(tree) -> list:
    by_id = {n["id"]: n for n in _flatten(tree)}
    return sorted((by_id[n["parent"]]["name"] if n["parent"] in by_id else "",
                   n["name"]) for n in _flatten(tree))


def _both(nodes, method, path, body=None):
    pbase, jbase, _p = nodes
    return [call(b, method, path, body) for b in (pbase, jbase)]


def test_trace_true_answers_the_jax_span_tree(nodes):
    (pst, pr), (jst, jr) = _both(nodes, "POST", f"/{INDEX}/_search?trace=true", COMMON)
    assert pst == jst == 200
    assert pr["hits"] == jr["hits"]
    ptree, jtree = pr["trace"]["tree"], jr["trace"]["tree"]
    assert _edges(ptree) == _edges(jtree)
    names = {n["name"] for n in _flatten(ptree)}
    assert {"rest", "coordinator", "shard", "batcher.queue", "batcher.dispatch",
            "batcher.merge", "device_pull"} <= names
    for shard in (n for n in _flatten(ptree) if n["name"] == "shard"):
        (merge,) = [c for c in shard["children"] if c["name"] == "batcher.merge"]
        (pull,) = merge["children"]
        assert pull["name"] == "device_pull" and pull["duration_ms"] >= 0
        # the device span lies inside its merge, on the batch's clocks
        assert merge["t0"] <= pull["t0"] <= pull["t1"] <= merge["t1"]
        assert pull["tags"]["batch"] == merge["tags"]["batch"]
    # the response's trace id is in the node's ring
    _p = nodes[2]
    assert pr["trace"]["trace_id"] in {t["trace_id"] for t in _p.tracer.traces()}


def test_hits_identical_with_and_without_trace(nodes):
    for base in nodes[:2]:
        plain = call(base, "POST", f"/{INDEX}/_search", COMMON)[1]
        traced = call(base, "POST", f"/{INDEX}/_search?trace=true", COMMON)[1]
        assert traced["hits"] == plain["hits"]
        assert "trace" not in plain


def test_scrolled_search_honours_trace(nodes):
    for st, r in _both(nodes, "POST", f"/{INDEX}/_search?scroll=1m&trace=true",
                       {"query": {"match": {"body": "w2"}}}):
        assert st == 200 and "_scroll_id" in r
        names = {n["name"] for n in _flatten(r["trace"]["tree"])}
        assert {"rest", "coordinator", "shard"} <= names


def test_traces_and_tasks_have_the_jax_keys(nodes):
    _both(nodes, "POST", f"/{INDEX}/_search?trace=true", COMMON)
    (_, pt), (_, jt) = _both(nodes, "GET", "/_traces?size=2")
    assert set(pt) == set(jt) and set(pt["tracing"]) == set(jt["tracing"])
    assert pt["total"] == len(pt["traces"]) == 2
    for entry in pt["traces"]:
        assert set(entry) == set(jt["traces"][0])
    (_, pk), (_, jk) = _both(nodes, "GET", "/_tasks")
    ((pn,), (jn,)) = (pk["nodes"].values(), jk["nodes"].values())
    assert set(pn) == set(jn) and isinstance(pn["tasks"], list)
    for base in nodes[:2]:
        assert call(base, "GET", "/_traces?size=-1")[0] == 400
        assert call(base, "GET", "/_traces?size=x")[0] == 400


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


def _slow_lines(base, logger_name, body):
    handler = _Capture()
    logging.getLogger(logger_name).addHandler(handler)
    try:
        st, r = call(base, "POST", f"/{INDEX}/_search?trace=true", body)
    finally:
        logging.getLogger(logger_name).removeHandler(handler)
    assert st == 200
    return r, [m for m in handler.records if "slowlog" in m]


def test_slowlog_line_joins_the_trace_and_the_shape(nodes):
    pbase, _jbase, p = nodes
    body = {"query": {"match": {"body": "w3"}}}
    assert call(pbase, "PUT", f"/{INDEX}/_settings",
                {"index.search.slowlog.threshold.query.warn": "0ms"})[0] == 200
    try:
        r, slow = _slow_lines(pbase, "estpu_torch.action", body)
    finally:
        assert call(pbase, "PUT", f"/{INDEX}/_settings",
                    {"index.search.slowlog.threshold.query.warn": "-1"})[0] == 200
    sid, _shape = p.insights.fingerprint(body)
    joined = [m for m in slow if f"trace[{r['trace']['trace_id']}]" in m]
    assert len(joined) == 2, slow  # one line a shard
    assert all(f"shape[{sid}]" in m and "queue[" in m and "device[" in m
               and "merge[" in m for m in joined)
    assert not _slow_lines(pbase, "estpu_torch.action", body)[1]


def test_cluster_level_slowlog_threshold(nodes):
    """A transient cluster setting arms the slowlog where the index sets no
    threshold of that level; a persistent one yields to it (the setter
    comes with `_cluster/settings`, so the test installs the settings in
    the cluster state)."""
    pbase, _jbase, p = nodes
    body = {"query": {"match": {"body": "w4"}}}

    def set_cluster(transient, persistent=()):
        from dataclasses import replace

        def update(state):
            md = replace(state.metadata, transient_settings=tuple(transient),
                         persistent_settings=tuple(persistent),
                         version=state.metadata.version + 1)
            return state.next_version(metadata=md)

        p.cluster_service.submit_state_update_task("test", update).result(10)

    key = "index.search.slowlog.threshold.query.info"
    try:
        set_cluster([(key, "0ms")], [(key, "1h")])
        assert len(_slow_lines(pbase, "estpu_torch.action", body)[1]) == 2
        set_cluster([], [(key, "1h")])
        assert not _slow_lines(pbase, "estpu_torch.action", body)[1]
    finally:
        set_cluster([])


def test_nodes_stats_sections_match_jax_but_declared(nodes):
    (pst, pr), (jst, jr) = _both(nodes, "GET", "/_nodes/stats")
    assert pst == jst == 200
    ((psec,), (jsec,)) = (pr["nodes"].values(), jr["nodes"].values())
    assert set(psec) == set(jsec)
    for metric in psec:
        st, one = call(nodes[0], "GET", f"/_nodes/stats/{metric}")
        assert st == 200 and list(next(iter(one["nodes"].values()))) == [metric]
    st, two = call(nodes[0], "GET", "/_nodes/_local/stats/thread_pool,breakers")
    assert sorted(next(iter(two["nodes"].values()))) == ["breakers", "thread_pool"]
    for st, r in _both(nodes, "GET", "/_nodes/stats/bogus"):
        assert st == 400 and "bogus" in json.dumps(r)
    lat = psec["search"]["latency"]
    assert lat["count"] >= 1 and lat["p99_ms"] >= lat["p50_ms"] >= 0
    assert "queue_wait" in psec["thread_pool"]["search"]
    assert "shard_phase" in psec["admission_control"]
    assert set(psec["search"]["batcher"]) >= set(jsec["search"]["batcher"]) - {
        "mesh_launches", "mesh_items"}
    assert psec["tracing"]["ring_size"] >= 1


def _text(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=60) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
                     r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*)?\})? (\S+)$')


def parse_prometheus(text: str) -> tuple[dict, dict]:
    """The text format, line by line: `# TYPE name type`, or a sample
    `name{label="v",...} value`; every family's samples one contiguous
    group (a histogram's _bucket, _sum and _count under its name). Returns
    ({family: type}, {series: value}); raises AssertionError otherwise."""
    types, series = {}, {}
    seen, current = set(), None
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            assert parts[1] in ("TYPE", "HELP"), line
            if parts[1] == "TYPE":
                assert len(parts) == 4 and parts[3] in (
                    "counter", "gauge", "histogram", "summary", "untyped"), line
                assert parts[2] not in types, f"family {parts[2]} typed twice"
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE.match(line)
        assert m, f"malformed sample line {line!r}"
        name, value = m.group(1), m.group(5)
        float(value.replace("+Inf", "inf"))
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[: -len(suffix)]
            if name.endswith(suffix) and types.get(base) == "histogram":
                family = base
        assert family in types, f"sample of untyped family {family}"
        if family != current:
            assert family not in seen, f"family {family} interleaved"
            seen.add(family)
            current = family
        key = line.rsplit(" ", 1)[0]
        assert key not in series, f"duplicate series {key}"
        series[key] = float(value.replace("+Inf", "inf"))
    return types, series


# the families the port declares different: XLA compile events and the
# compile-warming registry (the port's are estpu_cuda_kernel_*)
_DECLARED = re.compile(r"^estpu_(jax_|compile_warm)")


def test_prometheus_text_parses_and_holds_the_jax_families(nodes):
    pbase, jbase, _p = nodes
    call(pbase, "POST", f"/{INDEX}/_search", COMMON)
    (pst, pctype, ptext), (jst, _jc, jtext) = (_text(b, "/_prometheus/metrics")
                                                for b in (pbase, jbase))
    assert pst == jst == 200 and pctype.startswith("text/plain")
    ptypes, pseries = parse_prometheus(ptext)
    jtypes, _ = parse_prometheus(jtext)
    assert {f: t for f, t in jtypes.items() if not _DECLARED.match(f)} == \
        {f: t for f, t in ptypes.items() if not f.startswith("estpu_cuda_kernel_")}
    assert not any(f.startswith("estpu_jax_") for f in ptypes)
    assert ptypes["estpu_cuda_kernel_launches_total"] == "counter"
    assert 'estpu_cuda_kernel_launches_total{kernel="sparse_score"}' in pseries
    count = pseries["estpu_search_latency_seconds_count"]
    assert count >= 1 and pseries['estpu_search_latency_seconds_bucket{le="+Inf"}'] == count
    assert pseries["estpu_hbm_resident_bytes"] > 0
    assert pseries["estpu_batcher_launches_total"] >= 1


# ---------------------------------------------------------------------------
# the zero-added-waits pin
# ---------------------------------------------------------------------------


def _counting(monkeypatch):
    """Count PendingPull.wait and torch.cuda.synchronize calls."""
    waits, syncs = [], []
    orig_wait = cudaenv.PendingPull.wait
    monkeypatch.setattr(cudaenv.PendingPull, "wait",
                        lambda self: (waits.append(1), orig_wait(self))[1])
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: syncs.append(1))
    return waits, syncs


def test_traced_loop_waits_once_a_batch_and_never_synchronizes(nodes, monkeypatch):
    pbase, _jbase, p = nodes
    bodies = [{"query": {"match": {"body": f"w{i} w{i + 1}"}}, "size": 5}
              for i in range(8)]

    def loop():
        out = [None] * len(bodies)

        def worker(i):
            out[i] = call(pbase, "POST", f"/{INDEX}/_search", bodies[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert all(st == 200 for st, _r in out)
        return [r["hits"] for _st, r in out]

    warm = loop()
    old_rate = p.tracer.sample_rate
    p.tracer.sample_rate = 1.0
    assert p.insights.enabled
    try:
        waits, syncs = _counting(monkeypatch)
        before = p.search_batcher.stats()["launches"]
        sampled = p.tracer.stats()["sampled"]
        again = loop()
        launched = p.search_batcher.stats()["launches"] - before
    finally:
        p.tracer.sample_rate = old_rate
    assert again == warm
    assert p.tracer.stats()["sampled"] > sampled
    assert syncs == []
    assert launched >= 1 and len(waits) == launched


def test_trace_sync_mode_calls_the_batch_sync_and_keeps_hits(nodes, monkeypatch):
    pbase, _jbase, p = nodes
    from elasticsearch_tpu_torch.search import execute as texecute

    plain = call(pbase, "POST", f"/{INDEX}/_search", COMMON)[1]["hits"]
    calls = []
    orig = texecute._PendingFlat.sync
    monkeypatch.setattr(texecute._PendingFlat, "sync",
                        lambda self: (calls.append(1), orig(self))[1])
    call(pbase, "POST", f"/{INDEX}/_search?trace=true", COMMON)
    assert calls == []  # not armed: no sync
    monkeypatch.setenv("ESTPU_TRACE_SYNC", "1")
    st, r = call(pbase, "POST", f"/{INDEX}/_search?trace=true", COMMON)
    assert st == 200 and r["hits"] == plain
    assert len(calls) >= 1
