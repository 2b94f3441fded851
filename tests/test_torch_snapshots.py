"""Snapshot and restore on the port (elasticsearch_tpu_torch/snapshots.py),
on the CPU: the port's copy of tests/test_snapshots.py on a port node (the
round trip, an incremental second snapshot restored under a new name,
orphan blobs pruned with the last snapshot, a restore over an existing
index refused, `file://` and local `http://` URL repositories, an fs
location that is a URL and an unsupported scheme refused), and three
more:

- the kept behaviour: on two nodes with an index of 2 shards and 1
  replica, after snapshot, delete, restore and green, each node's own
  copies (`_only_node`) count what the JAX cluster's count for the same
  steps (the replicas peer-recovered from the still-empty primaries, and
  the restore replaced only the primaries' files). Whether a replica
  finishes recovering before its primary's swap is a race on both
  packages; the test holds each swap until every copy has started, the
  order of a quiet cluster;
- the release: a restore leaves no pack of the shard it replaced on the
  device, and a 0-hit answer the request cache stored for the empty index
  before the swap is not served after it;
- every snapshot route, sent to a port node and to a JAX node in the same
  order, answers the same status and body (times and repository paths
  masked).

Every node is closed in a fixture or a `finally`."""

from __future__ import annotations

import http.server
import os
import threading

import pytest

from elasticsearch_tpu_torch.common.errors import SnapshotError, SnapshotMissingError
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry
from tests.test_torch_node import _node_pair, call
from tests.test_torch_two_nodes import Cluster, wait_until


@pytest.fixture()
def cluster(tmp_path):
    node = Node(name="snap_node", settings={"node.device": "cpu"},
                registry=LocalTransportRegistry(), data_path=str(tmp_path / "node"))
    node.start()
    try:
        yield node, node.client(), str(tmp_path / "repo")
    finally:
        node.close()


class TestSnapshots:
    def test_snapshot_restore_roundtrip(self, cluster):
        node, client, repo_path = cluster
        client.create_index("src", {"settings": {"number_of_shards": 2,
                                                 "number_of_replicas": 0}})
        client.cluster_health(wait_for_status="green")
        for i in range(15):
            client.index("src", "doc", {"n": i, "text": f"document {i}"}, id=str(i))
        client.put_repository("backup", {"type": "fs", "settings": {"location": repo_path}})
        assert client.verify_repository("backup")["nodes"]
        r = client.create_snapshot("backup", "snap1")
        assert r["snapshot"]["state"] == "SUCCESS"
        client.delete_index("src")
        assert not client.exists_index("src")
        r = client.restore_snapshot("backup", "snap1")
        assert "src" in r["snapshot"]["indices"]
        client.cluster_health(wait_for_status="green")
        client.refresh("src")
        assert client.count("src")["count"] == 15
        g = client.get("src", "doc", "7")
        assert g["found"] and g["_source"]["n"] == 7

    def test_incremental_second_snapshot(self, cluster):
        node, client, repo_path = cluster
        client.create_index("inc", {"settings": {"number_of_shards": 1,
                                                 "number_of_replicas": 0}})
        client.cluster_health(wait_for_status="green")
        client.index("inc", "doc", {"v": 1}, id="1")
        client.put_repository("b2", {"type": "fs", "settings": {"location": repo_path}})
        client.create_snapshot("b2", "s1")
        blobs = set(os.listdir(os.path.join(repo_path, "blobs")))
        client.index("inc", "doc", {"v": 2}, id="2")
        r = client.create_snapshot("b2", "s2")
        assert r["snapshot"]["state"] == "SUCCESS"
        # the second snapshot reuses the first's segment blobs
        assert blobs < set(os.listdir(os.path.join(repo_path, "blobs")))
        snaps = client.get_snapshots("b2")
        assert [s["snapshot"] for s in snaps["snapshots"]] == ["s1", "s2"]
        r = client.restore_snapshot("b2", "s1", {"rename_pattern": "inc",
                                                 "rename_replacement": "inc_restored"})
        assert r["snapshot"]["indices"] == ["inc_restored"]
        client.refresh("inc_restored")
        assert client.count("inc_restored")["count"] == 1
        assert client.count("inc")["count"] == 2

    def test_delete_snapshot_prunes_orphans(self, cluster):
        node, client, repo_path = cluster
        client.create_index("p", {"settings": {"number_of_shards": 1,
                                               "number_of_replicas": 0}})
        client.cluster_health(wait_for_status="green")
        client.index("p", "doc", {"x": 1}, id="1")
        client.put_repository("b3", {"type": "fs", "settings": {"location": repo_path}})
        client.create_snapshot("b3", "only")
        client.delete_snapshot("b3", "only")
        with pytest.raises(SnapshotMissingError):
            client.get_snapshots("b3", "only")
        assert os.listdir(os.path.join(repo_path, "blobs")) == []

    def test_restore_refuses_existing_index(self, cluster):
        node, client, repo_path = cluster
        client.create_index("e", {"settings": {"number_of_shards": 1,
                                               "number_of_replicas": 0}})
        client.cluster_health(wait_for_status="green")
        client.index("e", "doc", {"x": 1}, id="1")
        client.put_repository("b4", {"type": "fs", "settings": {"location": repo_path}})
        client.create_snapshot("b4", "s")
        with pytest.raises(SnapshotError):
            client.restore_snapshot("b4", "s")


class TestUrlRepository:
    def test_fs_location_rejects_url(self, cluster):
        node, client, repo_path = cluster
        with pytest.raises(SnapshotError):
            client.put_repository("bad", {"type": "fs", "settings": {
                "location": "http://snapshot.test1/repo"}})
        assert not os.path.exists("http:")

    def test_file_url_restore_and_readonly(self, cluster):
        node, client, repo_path = cluster
        client.create_index("u", {"settings": {"number_of_shards": 1,
                                               "number_of_replicas": 0}})
        client.cluster_health(wait_for_status="green")
        client.index("u", "doc", {"x": 41}, id="1")
        client.put_repository("w", {"type": "fs", "settings": {"location": repo_path}})
        client.create_snapshot("w", "s1")
        client.delete_index("u")
        client.put_repository("ro", {"type": "url",
                                     "settings": {"url": f"file://{repo_path}"}})
        assert client.verify_repository("ro")["nodes"]
        snaps = client.get_snapshots("ro")
        assert [s["snapshot"] for s in snaps["snapshots"]] == ["s1"]
        with pytest.raises(SnapshotError):
            client.create_snapshot("ro", "s2")
        r = client.restore_snapshot("ro", "s1")
        assert r["snapshot"]["indices"] == ["u"]
        client.refresh("u")
        assert client.get("u", "doc", "1")["_source"]["x"] == 41

    def test_http_url_restore(self, cluster):
        """The repository tree served by a local HTTP server; the restore
        reads it through that server."""
        node, client, repo_path = cluster
        client.create_index("h", {"settings": {"number_of_shards": 1,
                                               "number_of_replicas": 0}})
        client.cluster_health(wait_for_status="green")
        client.index("h", "doc", {"x": 7}, id="1")
        client.put_repository("w2", {"type": "fs", "settings": {"location": repo_path}})
        client.create_snapshot("w2", "s1")
        client.delete_index("h")
        served = []

        class Handler(http.server.SimpleHTTPRequestHandler):
            def __init__(self, *a, **kw):
                super().__init__(*a, directory=str(repo_path), **kw)

            def log_message(self, *a):
                served.append(self.path)

        httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            client.put_repository("httpro", {"type": "url", "settings": {
                "url": f"http://127.0.0.1:{httpd.server_address[1]}"}})
            snaps = client.get_snapshots("httpro")
            assert [s["snapshot"] for s in snaps["snapshots"]] == ["s1"]
            r = client.restore_snapshot("httpro", "s1")
            assert r["snapshot"]["indices"] == ["h"]
            client.refresh("h")
            assert client.get("h", "doc", "1")["_source"]["x"] == 7
            assert any(p.endswith("index.json") for p in served), served
            assert len(served) > 1, served
        finally:
            httpd.shutdown()
            httpd.server_close()

    def test_unsupported_scheme_rejected(self, cluster):
        node, client, repo_path = cluster
        with pytest.raises(SnapshotError):
            client.put_repository("bad2", {"type": "url", "settings": {
                "url": "ftp://example.com/repo"}})


# --------------------------------------------------------------------------
# the port's own cases
# --------------------------------------------------------------------------


def _swap_after_green(cluster):
    """Hold each node's restore-shard handler until every copy of its
    index is started: the order a quiet cluster shows, where the restore's
    replicas finish their peer recovery from the empty primaries before
    the primaries' files are replaced. (Which comes first is a race on
    both packages: a replica that recovers after the swap copies the
    restored files.)"""
    for n in cluster.nodes:
        handler = n.transport.handlers["internal:snapshot/shard/restore"]
        inner = handler.fn

        def held(request, channel, n=n, inner=inner):
            def started():
                table = n.cluster_service.state.routing_table.index(request["index"])
                return table is not None and all(
                    s.state == "STARTED" for s in table.all_shards())
            assert wait_until(started)
            return inner(request, channel)

        handler.fn = held


def _per_copy_counts(cluster, tmp_path) -> dict:
    """Snapshot, delete, restore and green on a two-node cluster holding
    `rs` (2 shards, 1 replica, 40 documents): each node's `_only_node`
    count after the restore, and the count through the primaries."""
    _swap_after_green(cluster)
    client = cluster.nodes[0].client()
    client.create_index("rs", {"settings": {"number_of_shards": 2,
                                            "number_of_replicas": 1}})
    assert cluster.settled("rs")
    for i in range(40):
        client.index("rs", "doc", {"n": i, "text": f"document {i}"}, id=str(i))
    client.refresh("rs")
    client.put_repository("r", {"type": "fs", "settings": {
        "location": str(tmp_path / f"repo_{cluster.pkg}")}})
    assert client.create_snapshot("r", "s")["snapshot"]["state"] == "SUCCESS"
    client.delete_index("rs")
    assert client.restore_snapshot("r", "s")["snapshot"]["indices"] == ["rs"]
    assert cluster.settled("rs")
    client.refresh("rs")
    out = {n.name: client.search("rs", {"size": 0},
                                 preference=f"_only_node:{n.node_id}")["hits"]["total"]
           for n in cluster.nodes}
    out["_primary"] = client.search("rs", {"size": 0},
                                    preference="_primary")["hits"]["total"]
    return out


def test_restored_replicas_keep_what_they_recovered_as_on_jax(tmp_path):
    got = {}
    for pkg in ("port", "jax"):
        c = Cluster(pkg, ["a", "b"], tmp_path)
        try:
            got[pkg] = _per_copy_counts(c, tmp_path)
        finally:
            c.close()
    assert got["port"] == got["jax"], got
    # the primaries hold every document; each node's copies one primary's
    # share (the replicas stayed empty)
    assert got["port"]["_primary"] == 40
    assert got["port"]["a"] + got["port"]["b"] == 40, got


def test_restore_releases_the_replaced_shard(cluster):
    """The swap releases the shard it replaces: a segment the pre-swap
    shard packed (a stray document indexed and searched between the
    index's creation and the swap) holds no pack after the restore, and the
    0-hit answer cached for the pre-swap view is not served after it."""
    from elasticsearch_tpu_torch.ops.device_index import pack_cache_key

    node, client, repo_path = cluster
    client.create_index("rel", {"settings": {"number_of_shards": 1,
                                             "number_of_replicas": 0}})
    client.cluster_health(wait_for_status="green")
    for i in range(12):
        client.index("rel", "doc", {"text": f"document {i}"}, id=str(i))
    client.put_repository("b", {"type": "fs", "settings": {"location": repo_path}})
    client.create_snapshot("b", "s")
    client.delete_index("rel")
    body = {"size": 0, "query": {"match": {"text": "document"}}}
    held = {}
    real = node.indices.restore_shard

    def before_swap(index, shard_id, fill):
        shard = node.indices.index_service(index).shard(shard_id)
        shard.engine.index("doc", "stray", {"text": "stray words"})
        shard.engine.refresh()
        # packs the stray segment, then caches a 0-hit answer for this view
        assert client.search(index, {"query": {"match": {"text": "stray"}}})[
            "hits"]["total"] == 1
        assert client.search(index, body)["hits"]["total"] == 0
        held["hits"] = node.request_cache.stats()["hits"]
        assert client.search(index, body)["hits"]["total"] == 0
        assert node.request_cache.stats()["hits"] == held["hits"] + 1  # served cached
        held["segs"] = list(shard.engine.acquire_searcher().segments)
        key = pack_cache_key(node.device)
        assert all(s._device_cache.get(key) is not None for s in held["segs"])
        return real(index, shard_id, fill)

    node.indices.restore_shard = before_swap
    try:
        client.restore_snapshot("b", "s")
    finally:
        node.indices.restore_shard = real
    client.cluster_health(wait_for_status="green")
    key = pack_cache_key(node.device)
    assert held["segs"] and all(s._device_cache.get(key) is None for s in held["segs"])
    assert client.search("rel", body)["hits"]["total"] == 12
    assert client.count("rel")["count"] == 12
    assert not client.get("rel", "doc", "stray")["found"]
    shard = node.indices.index_service("rel").shard(0)
    assert not set(map(id, held["segs"])) & set(
        map(id, shard.engine.acquire_searcher().segments))


def _masked(r):
    """A snapshot route's body with its times and repository paths masked."""
    if isinstance(r, dict):
        return {k: ("<t>" if k.endswith(("time_in_millis", "_millis", "time_ms"))
                    else "<path>" if k in ("location", "url") else _masked(v))
                for k, v in r.items()}
    if isinstance(r, list):
        return [_masked(v) for v in r]
    return r


def test_snapshot_routes_answer_as_jax(tmp_path_factory):
    roots = {}

    def fill(base):
        st, r = call(base, "PUT", "/sr", {"settings": {"number_of_shards": 2,
                                                       "number_of_replicas": 0}})
        assert st == 200, r
        for i in range(9):
            assert call(base, "PUT", f"/sr/doc/{i}", {"text": f"w{i % 3}"})[0] == 201
        assert call(base, "POST", "/sr/_refresh")[0] == 200
        roots[base] = str(tmp_path_factory.mktemp("route_repo"))

    steps = [
        ("GET", "/_snapshot", None), ("GET", "/_snapshot/nope", None),
        ("PUT", "/_snapshot/bk", "repo"), ("POST", "/_snapshot/bk2", "repo2"),
        ("GET", "/_snapshot", None), ("GET", "/_snapshot/bk", None),
        ("POST", "/_snapshot/bk/_verify", None), ("POST", "/_snapshot/nope/_verify", None),
        ("PUT", "/_snapshot/bk/s1", {"indices": "sr"}), ("PUT", "/_snapshot/bk/s2", None),
        ("GET", "/_snapshot/bk/s1", None), ("GET", "/_snapshot/bk/_all", None),
        ("GET", "/_snapshot/bk/missing", None), ("GET", "/_snapshot/bk/s1/_status", None),
        ("POST", "/_snapshot/bk/s1/_restore", None),
        ("POST", "/_snapshot/bk/s1/_restore",
         {"rename_pattern": "sr", "rename_replacement": "sr_copy"}),
        ("GET", "/sr_copy/_count", None),
        ("DELETE", "/sr", None), ("POST", "/_snapshot/bk/s2/_restore", None),
        ("GET", "/sr/_count", None),
        ("DELETE", "/_snapshot/bk/s1", None), ("DELETE", "/_snapshot/bk/s1", None),
        ("GET", "/_snapshot/bk/_all", None),
        ("DELETE", "/_snapshot/bk2", None), ("DELETE", "/_snapshot/bk2", None),
        ("GET", "/_snapshot", None)]
    pair = _node_pair(tmp_path_factory, fill, names=("snap", "snap"))
    pbase, jbase, _p = next(pair)
    try:
        for method, path, body in steps:
            answers = []
            for base in (pbase, jbase):
                b = body
                if body in ("repo", "repo2"):
                    b = {"type": "fs", "settings": {
                        "location": os.path.join(roots[base], body)}}
                st, r = call(base, method, path, b)
                if method == "POST" and path.endswith("_restore") and st == 200:
                    index = (b or {}).get("rename_replacement", "sr")
                    assert call(base, "GET", f"/_cluster/health/{index}"
                                "?wait_for_status=green&timeout=30s")[0] == 200
                    assert call(base, "POST", f"/{index}/_refresh")[0] == 200
                answers.append((st, _masked(r)))
            assert answers[0] == answers[1], (method, path, answers)
    finally:
        pair.close()
