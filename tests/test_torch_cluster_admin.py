"""The cluster admin routes of a port node against the JAX node's
(node.py `cluster_state`, `cluster_stats`, `cluster_get_settings`,
`cluster_update_settings`, `cluster_reroute`, `pending_tasks`,
`nodes_shutdown`; actions.py `_m_cluster_settings`, `_m_reroute`,
`_s_shutdown_node`; cluster/service.py `pending_tasks`).

Both nodes carry one name and hold the same indexes, template and alias:

- `_cluster/state`, whole and under every metric and comma list, with an
  index filter and `index_templates`, answers the JAX node's JSON but two
  declared fields: the state's `version` (each node counts its own state
  transitions);
- `_cluster/stats` at the root, `nodes/_all`, by name, `_local`,
  `_master` and a comma list answers the JAX node's rollup, `nodes.versions`
  included, but its `timestamp`; an
  unknown id answers 404 NodeMissingException on both;
- `_cluster/pending_tasks` is empty at rest, and the cluster service lists
  queued tasks in priority order as the JAX one does;
- `_cluster/settings` PUT and GET, nested and with `flat_settings`, answer
  alike; a transient slowlog threshold of `0ms` makes the next search log
  one line a shard on both nodes, `1h` none; after a gateway restart both
  nodes answer the same settings (neither restores them);
- each `_cluster/reroute` command leaves the same routing table, health and
  `_count` answer on both nodes, and a malformed command answers 500 on
  both;
- `_shutdown` at its three routes, under `_local`, `_master`, the node's
  name and an unknown id, answers the JAX node's body; a named node stops
  listening within 5 s (the port's batcher drainer has exited too), and an
  unknown id shuts nothing."""

import json
import logging
import socket
import time
import urllib.error
import urllib.request

import pytest
import torch

from tests.test_torch_node import _node_pair, call

NAME = "admnode"


def _fill(base):
    st, r = call(base, "PUT", "/_template/tpl", {
        "template": "ad*", "order": 1, "settings": {"number_of_replicas": 1},
        "mappings": {"doc": {"properties": {"n": {"type": "integer"}}}}})
    assert st == 200, r
    assert call(base, "PUT", "/_template/other", {"template": "zz*"})[0] == 200
    st, r = call(base, "PUT", "/ad", {"settings": {"number_of_shards": 2,
                                                   "refresh_interval": -1}})
    assert st == 200, r
    st, r = call(base, "PUT", "/ae", {
        "settings": {"number_of_shards": 1, "number_of_replicas": 0,
                     "refresh_interval": -1},
        "aliases": {"al": {"filter": {"term": {"n": 3}}}}})
    assert st == 200, r
    lines = []
    for index in ("ad", "ae"):
        for i in range(60):
            lines.append(json.dumps({"index": {"_index": index, "_type": "doc",
                                               "_id": str(i)}}))
            lines.append(json.dumps({"body": f"w{i % 7} w{i % 3}", "n": i % 5}))
    st, r = call(base, "POST", "/_bulk", raw="\n".join(lines) + "\n")
    assert st == 200 and not r["errors"]
    assert call(base, "POST", "/_refresh")[0] == 200
    assert call(base, "POST", "/ad/_close")[0] == 200
    assert call(base, "POST", "/ad/_open")[0] == 200
    assert call(base, "GET", "/_cluster/health?wait_for_status=yellow")[1]["status"] \
        == "yellow"


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    yield from _node_pair(tmp_path_factory, _fill, names=(NAME, NAME))


def _both(nodes, method, path, body=None):
    return [call(base, method, path, body) for base in nodes[:2]]


STATE_PATHS = [
    "/_cluster/state", "/_cluster/state/_all", "/_cluster/state/version",
    "/_cluster/state/master_node", "/_cluster/state/nodes", "/_cluster/state/metadata",
    "/_cluster/state/routing_table", "/_cluster/state/blocks",
    "/_cluster/state/metadata,routing_table", "/_cluster/state/nodes,blocks,master_node",
    "/_cluster/state/metadata,routing_table/ad", "/_cluster/state/metadata/a*",
    "/_cluster/state/routing_table/al", "/_cluster/state/_all/ae",
    "/_cluster/state/metadata?index_templates=tpl",
    "/_cluster/state?index_templates=tpl,other",
    "/_cluster/state/metadata/ad?index_templates=nope",
]


@pytest.mark.parametrize("path", STATE_PATHS)
def test_cluster_state_matches_jax(nodes, path):
    (pst, pr), (jst, jr) = _both(nodes, "GET", path)
    assert pst == jst == 200, (pr, jr)
    assert ("version" in pr) == ("version" in jr)
    if "version" in pr:
        assert pr.pop("version") > 0 and jr.pop("version") > 0
    assert pr == jr
    if "routing_table" in pr and "/ad" in path:
        assert list(pr["routing_table"]["indices"]) == ["ad"]
        assert list(pr["metadata"]["indices"]) == ["ad"]
    if path.endswith("index_templates=tpl"):
        assert list(pr["metadata"]["templates"]) == ["tpl"]


def test_cluster_state_blocks_show_a_closed_index(nodes):
    try:
        for st, _r in _both(nodes, "POST", "/ae/_close"):
            assert st == 200
        (pst, pr), (jst, jr) = _both(nodes, "GET", "/_cluster/state/blocks")
        assert pst == jst == 200 and pr == jr
        assert list(pr["blocks"]["indices"]) == ["ae"]
    finally:
        for st, _r in _both(nodes, "POST", "/ae/_open"):
            assert st == 200
        for base in nodes[:2]:
            call(base, "GET", "/_cluster/health?wait_for_status=yellow")


STATS_PATHS = ["/_cluster/stats", "/_cluster/stats/nodes/_all",
               f"/_cluster/stats/nodes/{NAME}", "/_cluster/stats/nodes/_local",
               "/_cluster/stats/nodes/_master", f"/_cluster/stats/nodes/{NAME},_local"]


@pytest.mark.parametrize("path", STATS_PATHS)
def test_cluster_stats_matches_jax(nodes, path):
    (pst, pr), (jst, jr) = _both(nodes, "GET", path)
    assert pst == jst == 200
    assert abs(pr.pop("timestamp") - jr.pop("timestamp")) < 60_000
    assert pr["nodes"]["versions"] == jr["nodes"]["versions"] == ["10000"]
    assert pr == jr
    counts = [call(nodes[0], "GET", f"/{i}/_count")[1]["count"] for i in ("ad", "ae")]
    assert pr["indices"]["docs"]["count"] == sum(counts) == 120
    assert pr["nodes"]["count"]["total"] == 1


def test_cluster_stats_unknown_node_is_404(nodes):
    for path in ("/_cluster/stats/nodes/nope", f"/_cluster/stats/nodes/{NAME},nope"):
        (pst, pr), (jst, jr) = _both(nodes, "GET", path)
        assert pst == jst == 404 and pr == jr
        assert pr["error"]["type"] == "NodeMissingException"


def test_pending_tasks_empty_at_rest(nodes):
    (pst, pr), (jst, jr) = _both(nodes, "GET", "/_cluster/pending_tasks")
    assert pst == jst == 200 and pr == jr == {"tasks": []}


def test_cluster_service_lists_queued_tasks_as_jax():
    import threading

    from elasticsearch_tpu.cluster.service import ClusterService as JService
    from elasticsearch_tpu_torch.cluster.service import ClusterService as PService

    out = []
    for cls in (PService, JService):
        svc = cls()
        gate = threading.Event()
        try:
            svc.submit_state_update_task("blocker", lambda s: (gate.wait(10), s)[1])
            time.sleep(0.1)
            futs = [svc.submit_state_update_task(src, lambda s: s, priority=pr)
                    for src, pr in (("low", 2), ("urgent", 0), ("high", 1), ("low2", 2))]
            tasks = svc.pending_tasks()
            assert all(t["time_in_queue_millis"] >= 0 for t in tasks)
            out.append([(t["source"], t["priority"]) for t in tasks])
        finally:
            gate.set()
            for f in futs:
                f.result(10)
            assert svc.pending_tasks() == []
            svc.close()
    assert out[0] == out[1] == [("urgent", 0), ("high", 1), ("low", 2), ("low2", 2)]


SETTINGS_BODIES = [
    {"transient": {"index.search.slowlog.threshold.query.debug": "500ms"},
     "persistent": {"a.b": 3, "a": {"c": True}}},
    {"transient": {"x": 1.5, "y": ["a", "b"], "z": None}},
    {},
    None,
]


@pytest.mark.parametrize("bi", range(len(SETTINGS_BODIES)))
def test_cluster_settings_put_and_get_match_jax(nodes, bi):
    body = SETTINGS_BODIES[bi]
    for path in ("/_cluster/settings", "/_cluster/settings?flat_settings=true"):
        (pst, pr), (jst, jr) = _both(nodes, "PUT", path, body)
        assert pst == jst == 200 and pr == jr and pr["acknowledged"]
        for get in ("/_cluster/settings", "/_cluster/settings?flat_settings=true"):
            (pst, pr), (jst, jr) = _both(nodes, "GET", get)
            assert pst == jst == 200 and pr == jr
    flat = call(nodes[0], "GET", "/_cluster/settings?flat_settings=true")[1]
    assert flat["persistent"]["a.b"] == "3" and flat["persistent"]["a.c"] == "true"
    assert call(nodes[0], "GET", "/_cluster/settings")[1]["persistent"]["a"] == {
        "b": "3", "c": "true"}


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record.getMessage())


def _slowlog_lines(base, logger_name, body):
    handler = _Capture()
    logging.getLogger(logger_name).addHandler(handler)
    try:
        st, _r = call(base, "POST", "/ad/_search", body)
    finally:
        logging.getLogger(logger_name).removeHandler(handler)
    assert st == 200
    return [m for m in handler.records if "slowlog" in m]


def test_transient_slowlog_threshold_reaches_the_next_search(nodes):
    pbase, jbase, _p = nodes
    key = "index.search.slowlog.threshold.query.warn"
    body = {"query": {"match": {"body": "w2"}}, "request_cache": False}
    try:
        for value, lines in (("0ms", 2), ("1h", 0)):
            for st, r in _both(nodes, "PUT", "/_cluster/settings",
                               {"transient": {key: value}}):
                assert st == 200 and r["transient"]["index"]["search"]["slowlog"][
                    "threshold"]["query"]["warn"] == value
            for st, r in _both(nodes, "GET", "/_cluster/settings?flat_settings=true"):
                assert r["transient"][key] == value
            assert len(_slowlog_lines(pbase, "estpu_torch.action", body)) == lines
            assert len(_slowlog_lines(jbase, "estpu.action", body)) == lines
    finally:
        _both(nodes, "PUT", "/_cluster/settings", {"transient": {key: "-1"}})


def test_cluster_settings_after_a_gateway_restart(tmp_path):
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu.transport.local import LocalTransportRegistry as JReg
    from elasticsearch_tpu_torch.node import Node as PNode
    from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg

    def boot_port():
        return PNode(name=NAME, settings={"node.device": "cpu"}, registry=PReg(),
                     data_path=str(tmp_path / "port")).start()

    def boot_jax():
        j = JNode(name=NAME, settings={"search.mesh.enabled": "false",
                                       "indices.warmer.enabled": "false"},
                  registry=JReg(), data_path=str(tmp_path / "jax"))
        j.start([j.local_node.transport_address])
        j.wait_for_master()
        return j

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    answers = []
    try:
        for boot in (boot_port, boot_jax):
            node = boot()
            try:
                base = f"http://127.0.0.1:{node.start_http(0).port}"
                assert call(base, "PUT", "/g", {"settings": {"number_of_shards": 1}})[0] == 200
                assert call(base, "PUT", "/_cluster/settings", {
                    "transient": {"t.k": "1"}, "persistent": {"p.k": "2"}})[0] == 200
                before = call(base, "GET", "/_cluster/settings")[1]
            finally:
                node.close()
            node = boot()
            try:
                base = f"http://127.0.0.1:{node.start_http(0).port}"
                call(base, "GET", "/_cluster/health?wait_for_status=green")
                after = call(base, "GET", "/_cluster/settings?flat_settings=true")[1]
                answers.append((before, after, call(base, "GET", "/g/_count")[0]))
            finally:
                node.close()
    finally:
        torch.set_num_threads(threads)
    assert answers[0] == answers[1], answers
    assert answers[0][0] == {"persistent": {"p": {"k": "2"}}, "transient": {"t": {"k": "1"}}}


def _routing(base, index):
    st, r = call(base, "GET", f"/_cluster/state/routing_table/{index}")
    assert st == 200
    return r["routing_table"]


REROUTES = [
    {"allocate_replica": {"index": "rr", "shard": 0, "node": NAME}},
    {"cancel": {"index": "rr", "shard": 0, "node": NAME}},
    {"allocate": {"index": "rr", "shard": 1, "node": NAME}},
    {"cancel": {"index": "rr", "shard": 1, "node": "elsewhere"}},
    {"move": {"index": "rr", "shard": 1, "from_node": NAME, "to_node": NAME}},
    {"move": {"index": "rr", "shard": 0, "from_node": NAME, "to_node": "ghost"}},
]


def _fill_rr(base):
    st, r = call(base, "PUT", "/rr", {"settings": {"number_of_shards": 2,
                                                   "number_of_replicas": 1,
                                                   "refresh_interval": -1}})
    assert st == 200, r
    lines = "".join(json.dumps({"index": {"_index": "rr", "_type": "doc", "_id": str(i)}})
                    + "\n" + json.dumps({"body": f"w{i % 4}"}) + "\n" for i in range(40))
    assert call(base, "POST", "/_bulk", raw=lines)[0] == 200
    assert call(base, "POST", "/rr/_refresh")[0] == 200


@pytest.fixture(scope="module")
def rr_nodes(tmp_path_factory):
    yield from _node_pair(tmp_path_factory, _fill_rr, names=(NAME, NAME))


def test_reroute_with_no_commands_changes_nothing(rr_nodes):
    before = [_routing(b, "rr") for b in rr_nodes[:2]]
    for body in (None, {}, {"commands": []}):
        for st, r in _both(rr_nodes, "POST", "/_cluster/reroute", body):
            assert st == 200 and r["acknowledged"] and r["state_version"] > 0
    assert [_routing(b, "rr") for b in rr_nodes[:2]] == before
    assert before[0] == before[1]


def test_each_reroute_command_routes_as_on_jax(rr_nodes):
    """Each command routes as on the JAX node, an `allocate` of a replica
    included: both nodes place the copy as given (on the node that holds
    its primary, where no recovery starts), and both cancel it again, so
    the two routing tables go on comparing equal."""
    for cmd in REROUTES:
        (name, spec), = cmd.items()
        (pst, pr), (jst, jr) = _both(rr_nodes, "POST", "/_cluster/reroute",
                                     {"commands": [cmd]})
        assert jst == 200 and jr["acknowledged"], jr
        assert pst == 200 and pr["acknowledged"], pr
        if name.startswith("allocate"):
            undo = {"cancel": {"index": "rr", "shard": spec["shard"], "node": NAME}}
            for st, r in _both(rr_nodes, "POST", "/_cluster/reroute", {"commands": [undo]}):
                assert st == 200 and r["acknowledged"], r
        time.sleep(0.3)  # a shard the command started or dropped settles
        (ph, jh) = (call(b, "GET", "/_cluster/health/rr")[1] for b in rr_nodes[:2])
        assert ph == jh, (cmd, ph, jh)
        assert _routing(rr_nodes[0], "rr") == _routing(rr_nodes[1], "rr"), cmd
        (pst, pr), (jst, jr) = _both(rr_nodes, "GET", "/rr/_count")
        assert pst == jst, (cmd, pr, jr)
        if pst == 200:
            assert pr["count"] == jr["count"]
        else:
            assert pr["error"]["type"] == jr["error"]["type"]
    rows = _routing(rr_nodes[0], "rr")["indices"]["rr"]["shards"]
    assert [(s["node"], s["state"]) for s in rows["0"]] == [
        ("ghost", "INITIALIZING"), (None, "UNASSIGNED")]
    assert [(s["node"], s["state"]) for s in rows["1"]] == [
        (NAME, "INITIALIZING"), (None, "UNASSIGNED")]


@pytest.mark.parametrize("cmd", [
    {"bogus": {"index": "rr", "shard": 0}},
    {"move": {"index": "nope", "shard": 0, "from_node": "a", "to_node": "b"}},
    {"cancel": {"index": "rr", "shard": 9, "node": NAME}},
    {"allocate": {"index": "rr", "shard": 0}},
], ids=["unknown", "missing_index", "shard_out_of_range", "no_node"])
def test_malformed_reroute_answers_as_jax(rr_nodes, cmd):
    (pst, pr), (jst, jr) = _both(rr_nodes, "POST", "/_cluster/reroute", {"commands": [cmd]})
    assert pst == jst, (pr, jr)
    assert pr.get("acknowledged") == jr.get("acknowledged")


def _refuses(base) -> bool:
    host, port = base.rsplit("//", 1)[1].split(":")
    try:
        socket.create_connection((host, int(port)), timeout=1).close()
    except OSError:
        return True
    return False


SHUTDOWNS = [("/_shutdown", True), ("/_cluster/nodes/_shutdown", True),
             ("/_cluster/nodes/_local/_shutdown", True),
             ("/_cluster/nodes/_master/_shutdown", True),
             (f"/_cluster/nodes/{NAME}/_shutdown", True),
             ("/_cluster/nodes/nope/_shutdown", False)]


@pytest.mark.parametrize("path,stops", SHUTDOWNS, ids=[p for p, _s in SHUTDOWNS])
def test_shutdown_answers_and_closes_as_jax(tmp_path_factory, path, stops):
    def fill(base):  # one search, so the port's batcher drainer runs
        assert call(base, "PUT", "/s/doc/1?refresh=true", {"body": "w"})[0] == 201
        assert call(base, "POST", "/s/_search", {"query": {"match": {"body": "w"}}})[0] == 200

    pair = _node_pair(tmp_path_factory, fill, names=(NAME, NAME))
    pbase, jbase, p = next(pair)
    drainer = p.search_batcher.drainer_thread
    try:
        assert drainer is not None and drainer.is_alive()
        (pst, pr), (jst, jr) = ((call(b, "POST", path)) for b in (pbase, jbase))
        assert pst == jst == 200 and pr == jr
        assert pr["nodes"] == ({NAME: {"name": NAME}} if stops else {})
        deadline = time.monotonic() + 5.0
        if stops:
            while not (_refuses(pbase) and _refuses(jbase)):
                assert time.monotonic() < deadline, "a node still listens"
                time.sleep(0.05)
            while drainer.is_alive():
                assert time.monotonic() < deadline, "the drainer still runs"
                time.sleep(0.05)
            assert p._closed
        else:
            time.sleep(0.5)
            for base in (pbase, jbase):
                assert call(base, "GET", "/_cluster/health")[0] == 200
            assert drainer.is_alive() and not p._closed
    finally:
        try:
            next(pair)
        except StopIteration:
            pass
