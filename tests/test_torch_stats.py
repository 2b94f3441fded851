"""The stats surfaces of a port node (monitor.py, the capacity ledger of
ops/device_index.py, node.py's `stats`, `segments`, `indices_status`,
`cluster_events`, `nodes_info` and `nodes_stats`) against the JAX package.

Units, on both packages' monitor with the same canned procfs: meminfo in
bytes, a missing meminfo, the process's threads, RSS and descriptors, a
missing status, statvfs and a bad path, the section set. The port's
runtime section on a `cpu` device lists no device and makes no CUDA call.

Node against node after the same bulk and the same searches: `/_stats`
(every shard's state, documents, segments, translog and indexing counters;
the index's device stanza has the JAX node's keys), `/{index}/_stats`
scoped to its index, `/_status`, `/_segments` (each segment's documents,
postings and pack: layout, bytes a posting, resident bytes, the padded
doc count, the dense plane and the similarity tables) answer the JAX
node's JSON, the wall times of the indexing counters masked by name;
`/_events` (local, cluster-wide, `?size=`) has the JAX node's shape.
`/_nodes` has the JAX node's keys but `attrs` and `version_id` (the
port's discovery node has neither).
The `/_nodes/stats` `device` section: the JAX node's capacity ledger,
whose resident bytes are each pack's own tensors' bytes and whose postings
tier equals the JAX node's for the same segments; the port's `kernels`
and `start_check` stanzas in place of `compile` and `compile_warming`
(declared), and no `memory` stanza and no CUDA call on a `cpu` node."""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from elasticsearch_tpu import monitor as jmonitor
from elasticsearch_tpu_torch import monitor as tmonitor
from elasticsearch_tpu_torch.ops.device_index import (
    PackedSegment,
    capacity_report,
    pack_cache_key,
    segment_capacity,
)
from tests.test_torch_node import _node_pair, call

INDEX = "st"

MEMINFO = """MemTotal:       16265540 kB
MemFree:         1543732 kB
MemAvailable:    9853212 kB
Buffers:          734372 kB
Cached:          6754120 kB
SwapTotal:       2097148 kB
SwapFree:        2097000 kB
"""

SELF_STATUS = """Name:\tpython
Umask:\t0022
State:\tR (running)
Threads:\t17
VmPeak:\t  902340 kB
VmRSS:\t  345678 kB
voluntary_ctxt_switches:\t100
"""


def _fake_proc(tmp_path):
    proc = tmp_path / "proc"
    (proc / "self" / "fd").mkdir(parents=True)
    (proc / "meminfo").write_text(MEMINFO)
    (proc / "self" / "status").write_text(SELF_STATUS)
    for i in range(5):
        (proc / "self" / "fd" / str(i)).write_text("")
    return str(proc)


@pytest.fixture(params=["jax", "port"])
def mon(request):
    return {"jax": jmonitor, "port": tmonitor}[request.param]


def test_meminfo_parsed_to_bytes(mon, tmp_path):
    out = mon.os_stats(proc=_fake_proc(tmp_path))
    assert out["mem"] == {"total_in_bytes": 16265540 * 1024,
                          "free_in_bytes": 1543732 * 1024,
                          "available_in_bytes": 9853212 * 1024}
    assert out["swap"] == {"total_in_bytes": 2097148 * 1024,
                           "free_in_bytes": 2097000 * 1024}
    assert out["cpu"]["count"] == os.cpu_count() and isinstance(out["timestamp"], int)


def test_missing_meminfo_degrades_gracefully(mon, tmp_path):
    out = mon.os_stats(proc=str(tmp_path))
    assert "mem" not in out and "cpu" in out


def test_status_threads_rss_and_fds(mon, tmp_path):
    out = mon.process_stats(proc=_fake_proc(tmp_path))
    assert out["threads"] == 17
    assert out["mem"]["resident_in_bytes"] == 345678 * 1024
    assert out["open_file_descriptors"] == 5 and out["max_file_descriptors"] >= 5
    assert out["id"] == os.getpid()
    cpu = out["cpu"]
    assert abs(cpu["total_in_millis"] - (cpu["user_in_millis"] + cpu["sys_in_millis"])) <= 2


def test_missing_status_keeps_rusage_fallback(mon, tmp_path):
    out = mon.process_stats(proc=str(tmp_path))
    assert out["mem"]["resident_in_bytes"] > 0 and "threads" not in out


def test_statvfs_shape_and_bad_path(mon, tmp_path):
    (entry,) = mon.fs_stats([str(tmp_path)])["data"]
    assert entry["path"] == str(tmp_path)
    assert entry["total_in_bytes"] >= entry["free_in_bytes"] >= entry["available_in_bytes"] >= 0
    assert mon.fs_stats([str(tmp_path / "definitely-not-there")])["data"] == []


def test_the_monitors_agree_on_the_same_procfs(tmp_path):
    proc = _fake_proc(tmp_path)
    for fn in ("os_stats", "process_stats"):
        a, b = getattr(jmonitor, fn)(proc=proc), getattr(tmonitor, fn)(proc=proc)
        for d in (a, b):
            d.pop("timestamp")
            d.pop("cpu", None) if fn == "process_stats" else None
        assert a == b, fn


def test_full_stats_sections(mon, tmp_path):
    node = types.SimpleNamespace(data_path=str(tmp_path), device=torch.device("cpu"))
    out = mon.MonitorService(node).full_stats()
    assert set(out) == {"os", "process", "fs", "runtime"}
    assert out["runtime"]["runtime"] == "python"
    assert isinstance(out["runtime"]["devices"], list)


def test_runtime_on_a_cpu_node_makes_no_cuda_call(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CUDA call on a cpu node")

    for name in ("memory_allocated", "memory_reserved", "max_memory_allocated",
                 "mem_get_info", "get_device_name", "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    assert tmonitor.runtime_stats(torch.device("cpu"))["devices"] == []
    assert tmonitor.runtime_stats()["devices"] == []


# ---------------------------------------------------------------------------
# node against node
# ---------------------------------------------------------------------------


def _bulk(seed: int = 43, n: int = 150) -> str:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        lines.append(json.dumps({"index": {"_index": INDEX, "_type": "doc",
                                           "_id": str(i)}}))
        lines.append(json.dumps({"body": " ".join(f"w{j}" for j in rng.integers(0, 15, 6)),
                                 "n": i, "tag": f"t{i % 4}"}))
    return "\n".join(lines) + "\n"


SEARCHES = [{"query": {"match": {"body": "w1 w2"}}},
            {"query": {"filtered": {"query": {"match": {"body": "w3"}},
                                    "filter": {"term": {"tag": "t1"}}}}},
            {"query": {"match": {"body": "w4"}}, "aggs": {"m": {"max": {"field": "n"}}},
             "request_cache": False}]


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    def fill(base):
        for name in (INDEX, "other"):
            st, r = call(base, "PUT", f"/{name}", {
                "settings": {"number_of_shards": 2, "refresh_interval": -1},
                "mappings": {"doc": {"properties": {
                    "tag": {"type": "string", "index": "not_analyzed"},
                    "n": {"type": "integer"}}}}})
            assert st == 200, r
        st, r = call(base, "POST", "/_bulk", raw=_bulk())
        assert st == 200 and not r["errors"]
        # a second segment a shard, and a deleted document
        assert call(base, "POST", f"/{INDEX}/_refresh")[0] == 200
        assert call(base, "DELETE", f"/{INDEX}/doc/3")[0] == 200
        assert call(base, "PUT", f"/{INDEX}/doc/500", {"body": "w1 late", "n": 5})[0] == 201
        assert call(base, "POST", "/_refresh")[0] == 200
        for body in SEARCHES:
            assert call(base, "POST", f"/{INDEX}/_search", body)[0] == 200

    yield from _node_pair(tmp_path_factory, fill)


_TIMES = {"index_time_ms", "refresh_time_ms", "flush_time_ms"}


def _masked_shards(shards: dict) -> dict:
    return {sid: {**sh, "indexing": {k: v for k, v in sh["indexing"].items()
                                     if k not in _TIMES}}
            for sid, sh in shards.items()}


def test_stats_answer_the_jax_json(nodes):
    pbase, jbase, _p = nodes
    (pst, pr), (jst, jr) = (call(b, "GET", "/_stats") for b in (pbase, jbase))
    assert pst == jst == 200 and set(pr["indices"]) == set(jr["indices"]) == {INDEX, "other"}
    for name in pr["indices"]:
        p, j = pr["indices"][name], jr["indices"][name]
        assert _masked_shards(p["shards"]) == _masked_shards(j["shards"]), name
        assert set(p) == set(j)
        if "device" in p:
            pd, jd = p["device"], j["device"]
            assert set(pd) == set(jd) and set(pd["totals"]) == set(jd["totals"])
            assert pd["totals"].get("postings") == jd["totals"].get("postings")
    st, scoped = call(pbase, "GET", f"/{INDEX}/_stats")
    assert st == 200 and list(scoped["indices"]) == [INDEX]
    assert _masked_shards(scoped["indices"][INDEX]["shards"]) == \
        _masked_shards(pr["indices"][INDEX]["shards"])


def test_status_answers_the_jax_json(nodes):
    for path in ("/_status", f"/{INDEX}/_status"):
        (pst, pr), (jst, jr) = (call(b, "GET", path) for b in nodes[:2])
        assert pst == jst == 200 and pr["_shards"] == jr["_shards"]
        assert set(pr["indices"]) == set(jr["indices"])
        for name in pr["indices"]:
            assert pr["indices"][name]["index"] == jr["indices"][name]["index"]
            assert _masked_shards(pr["indices"][name]["shards"]) == \
                _masked_shards(jr["indices"][name]["shards"])


@pytest.mark.parametrize("path", ["/_segments", f"/{INDEX}/_segments"])
def test_segments_answer_the_jax_json(nodes, path):
    (pst, pr), (jst, jr) = (call(b, "GET", path) for b in nodes[:2])
    assert pst == jst == 200
    # node ids differ between the two nodes
    for r in (pr, jr):
        for idx in r["indices"].values():
            for copies in idx["shards"].values():
                for copy in copies:
                    copy["routing"].pop("node")
    assert pr == jr
    packed = [seg["device"] for idx in pr["indices"].values()
              for copies in idx["shards"].values() for copy in copies
              for seg in copy["segments"].values() if seg["device"]["packed"]]
    # 6 B a posting, 10 with the dense plane the aggregation faulted in
    assert packed and {d["bytes_per_posting"] for d in packed} <= {6, 10}


def test_events_answer_the_jax_shape(nodes):
    """The journals hold what each node's watchdog saw (a JAX node's first
    batch may stall behind its compile), so the reads are held by shape:
    the same keys, a published event rendered with the JAX event's keys,
    newest first, `?size=` and `?local=` as on the JAX node."""
    from elasticsearch_tpu.common.events import EventJournal as JJournal

    pbase, jbase, p = nodes
    p.events.publish("watchdog", "probe one", severity="info", key="a", probe=1)
    p.events.publish("watchdog", "probe two", severity="info", key="b", probe=2)
    jevent = JJournal(node_name="j", node_id="j").publish("watchdog", "probe",
                                                         severity="info", probe=1)
    for path in ("/_events", "/_events?local=true", "/_events?size=1"):
        (pst, pr), (jst, jr) = (call(b, "GET", path) for b in (pbase, jbase))
        assert pst == jst == 200 and set(pr) == set(jr)
        assert pr["total"] == len(pr["events"]) >= 1
        assert pr["events"][0]["message"] == "probe two"
        assert all(set(e) == set(jevent) for e in pr["events"])
        ((ps,), (js,)) = (pr["nodes"].values(), jr["nodes"].values())
        assert set(ps) == set(js)
    assert len(call(pbase, "GET", "/_events?size=1")[1]["events"]) == 1
    for base in (pbase, jbase):
        assert call(base, "GET", "/_events?size=-1")[0] == 400


def test_nodes_info_has_the_jax_keys(nodes):
    (pst, pr), (jst, jr) = (call(b, "GET", "/_nodes") for b in nodes[:2])
    assert pst == jst == 200 and pr["cluster_name"] == jr["cluster_name"]
    ((pn,), (jn,)) = (pr["nodes"].values(), jr["nodes"].values())
    assert set(pn) == set(jn) - {"attrs", "version_id"}
    assert pn["plugins"] == jn["plugins"] == []


def test_device_section_and_capacity_ledger(nodes, monkeypatch):
    pbase, jbase, p = nodes

    def refuse(*a, **k):
        raise AssertionError("a CUDA call on a cpu node")

    for name in ("memory_allocated", "memory_reserved", "max_memory_allocated",
                 "mem_get_info", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    (pst, pr), (jst, jr) = (call(b, "GET", "/_nodes/stats/device") for b in (pbase, jbase))
    assert pst == jst == 200
    (pd,), (jd,) = (r["nodes"].values() for r in (pr, jr))
    pd, jd = pd["device"], jd["device"]
    # the port's kernels and start check in place of the XLA compile events
    # and the compile-warming registry (declared); no memory stanza on CPU
    assert set(pd) == set(jd) - {"compile", "compile_warming"} | {"kernels", "start_check"}
    assert pd["kernels"]["sources"] == ["sparse_score"]
    assert set(pd["kernels"]) == {"sources", "built", "build_s", "launches"}
    assert pd["start_check"] == {"launches": {}}  # a cpu node builds nothing
    assert set(pd["indices"]) == set(jd["indices"])
    for name, entry in pd["indices"].items():
        assert set(entry) == set(jd["indices"][name])
        assert entry["totals"].get("postings", 0) == \
            jd["indices"][name]["totals"].get("postings", 0)
        assert entry["total_bytes"] == sum(entry["totals"].values())
    assert pd["total_bytes"] > 0


def _tensor_bytes(packed: PackedSegment) -> int:
    """Every device tensor a pack holds, walked field by field."""
    total = 0
    for f in dataclasses.fields(packed):
        v = getattr(packed, f.name)
        items = v.values() if isinstance(v, dict) else [v]
        for item in items:
            for t in (item if isinstance(item, tuple) else (item,)):
                if isinstance(t, torch.Tensor):
                    total += t.numel() * t.element_size()
    if packed.sim is not None:
        total += sum(t.numel() * t.element_size()
                     for t in (packed.sim.caches, packed.sim.modes))
    return total


def test_ledger_counts_each_packs_own_tensors(nodes):
    """The resident bytes the ledger reports are the bytes the packs' own
    tensors hold (on a `cuda` node the smoke holds them against
    `torch.cuda.memory_allocated()`), plus the filter-mask holders."""
    _pbase, _jbase, p = nodes
    report = capacity_report(p.indices, p.device)
    walked = masks = 0
    for name, svc in p.indices.indices.items():
        for shard in svc.shards.values():
            for seg in shard.engine.acquire_searcher().segments:
                packed = seg._device_cache.get(pack_cache_key(p.device))
                row = segment_capacity(seg, p.device)
                if packed is not None:
                    walked += _tensor_bytes(packed)
                if row is not None:
                    masks += row["tiers"]["filter_masks"]
    assert walked > 0 and report["total_bytes"] == walked + masks
    assert report["totals"]["filter_masks"] == masks
