"""Port nodes over real sockets: the counterparts of the JAX package's
tests/test_tcp_transport.py::test_two_node_cluster_over_tcp,
tests/test_transport_client.py and tests/test_multiprocess_cluster.py.

- Two port nodes on `transport.type: tcp` (the second seeded with the
  first's address) elect one master, spread a 2-shard index at 0 replicas
  over both and answer a search sent to the node that is not master.
- The TransportClient (client.py): every whitelisted name is a Client
  method, sniffing finds both nodes from one seed, a call round-trips
  through the proxy, a method off the list is refused, and when the seed
  node dies the client fails over to the other (the document lives on the
  survivor: its index has no replica to promote).
- Three `python -m elasticsearch_tpu_torch --transport tcp --seeds …
  -Dnode.device=cpu` processes form one cluster, serve writes sent to one
  and searches sent to another, and after one is killed the survivors
  answer green with the documents the survivors hold (the killed node's
  primaries come back empty, the JAX master's behaviour at 0 replicas);
  each process runs under a timeout and is terminated in a `finally`."""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from elasticsearch_tpu_torch.client import TransportClient
from elasticsearch_tpu_torch.common.errors import ClusterBlockError, NoNodeAvailableError
from elasticsearch_tpu_torch.node import Node

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"node.device": "cpu", "transport.type": "tcp"}


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_two_node_cluster_over_tcp(tmp_path):
    n1 = Node(name="tcp1", settings=dict(CPU), data_path=str(tmp_path / "n1"))
    seed = n1.local_node.transport_address
    n2 = Node(name="tcp2", settings={**CPU, "discovery.zen.ping.unicast.hosts": [seed]},
              data_path=str(tmp_path / "n2"))
    try:
        n1.start(seeds=[])
        n2.start()
        assert n1.cluster_service.state.nodes.master_id == "tcp1"
        assert n2.cluster_service.state.nodes.master_id == "tcp1"
        assert len(n2.cluster_service.state.nodes.nodes) == 2
        client = n1.client()
        client.create_index("tcpidx", {"settings": {"index.number_of_shards": 2,
                                                    "index.number_of_replicas": 0}})
        assert client.cluster_health(wait_for_status="green", timeout=30)["status"] == "green"
        owners = {s.node_id for s in n1.cluster_service.state.routing_table.all_shards()}
        assert owners == {"tcp1", "tcp2"}
        for i in range(20):
            client.index("tcpidx", "doc", {"title": f"hello world {i}"}, id=str(i))
        client.refresh("tcpidx")
        resp = n2.client().search("tcpidx", {"query": {"match": {"title": "hello"}}})
        assert resp["hits"]["total"] == 20
        assert resp["_shards"] == {"total": 2, "successful": 2, "degraded": 0, "failed": 0}
    finally:
        n2.close()
        n1.close()


@pytest.fixture()
def cluster(tmp_path):
    n1 = Node(name="tc1", settings=dict(CPU), data_path=str(tmp_path / "n1"))
    n2 = None
    try:
        n1.start([])
        assert n1.wait_for_master()
        seed = n1.local_node.transport_address
        n2 = Node(name="tc2", settings={**CPU, "discovery.zen.ping.unicast.hosts": [seed]},
                  data_path=str(tmp_path / "n2"))
        n2.start()
        n1.client().cluster_health(wait_for_nodes=2)
        yield n1, n2, seed
    finally:
        for n in (n1, n2):
            if n is not None:
                try:
                    n.close()
                except Exception:  # noqa: BLE001 — a test may have closed one already
                    pass


def test_whitelist_names_are_real_client_methods():
    from elasticsearch_tpu_torch.client import CLIENT_PROXY_METHODS, IDEMPOTENT_METHODS
    from elasticsearch_tpu_torch.node import Client

    missing = [m for m in CLIENT_PROXY_METHODS | IDEMPOTENT_METHODS
               if not callable(getattr(Client, m, None))]
    assert not missing, missing


class TestTransportClient:
    def test_sniff_discovers_all_nodes(self, cluster):
        n1, n2, seed = cluster
        client = TransportClient([seed], sniff_interval=0.2)
        try:
            assert len(client.connected_nodes()) == 2
        finally:
            client.close()

    def test_api_roundtrip_through_proxy(self, cluster):
        n1, n2, seed = cluster
        client = TransportClient([seed], sniff_interval=0.2)
        try:
            client.create_index(index="books", body={"settings": {
                "number_of_shards": 2, "number_of_replicas": 0}})
            client.cluster_health(wait_for_status="green")
            client.index(index="books", doc_type="doc",
                         body={"title": "snow crash"}, id="1")
            client.refresh(index="books")
            r = client.search(index="books",
                              body={"query": {"match": {"title": "snow"}}})
            assert r["hits"]["total"] == 1
            assert r["hits"]["hits"][0]["_id"] == "1"
            g = client.get(index="books", doc_type="doc", id="1")
            assert g["_source"]["title"] == "snow crash"
        finally:
            client.close()

    def test_unproxied_method_rejected(self, cluster):
        n1, n2, seed = cluster
        client = TransportClient([seed], sniff=False, sniff_interval=5)
        try:
            with pytest.raises(AttributeError):
                client.start_http()
        finally:
            client.close()

    def test_failover_when_node_dies(self, cluster):
        n1, n2, seed = cluster
        client = TransportClient([seed], sniff_interval=0.2)
        try:
            # the one shard lives on the survivor: no replica to promote
            client.create_index(index="ha", body={"settings": {
                "number_of_shards": 1, "number_of_replicas": 0,
                "index.routing.allocation.include._name": "tc2"}})
            client.cluster_health(wait_for_status="green")
            client.index(index="ha", doc_type="doc", body={"x": 1}, id="1")
            client.refresh(index="ha")
            n1.close()  # the seed node dies: calls re-route to tc2
            deadline = time.time() + 20
            got = None
            while time.time() < deadline:
                try:
                    got = client.count(index="ha")
                    break
                except (NoNodeAvailableError, ClusterBlockError):
                    time.sleep(0.3)  # a re-election's no-master window too
            assert got is not None and got["count"] == 1
            deadline = time.time() + 10
            while time.time() < deadline and len(client.connected_nodes()) != 1:
                time.sleep(0.2)
            assert len(client.connected_nodes()) == 1
        finally:
            client.close()


# --------------------------------------------------------------------------
# three processes
# --------------------------------------------------------------------------

class PortProc:
    """One `python -m elasticsearch_tpu_torch` process on the CPU with
    ephemeral ports."""

    def __init__(self, name: str, data: str, seeds: str | None):
        env = {**os.environ, "PYTHONPATH": REPO, "PYTHONUNBUFFERED": "1",
               "OMP_NUM_THREADS": "1"}
        cmd = [sys.executable, "-m", "elasticsearch_tpu_torch", f"-Dnode.name={name}",
               "-Dnode.device=cpu", "-Ddiscovery.zen.fd.ping_interval=0.2s",
               "--data", data, "--http-port", "0", "--transport", "tcp"]
        if seeds:
            cmd += ["--seeds", seeds]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL, text=True,
                                     env=env, cwd=REPO)
        self.name = name
        self.transport_addr = None
        self.http_port = None

    def wait_started(self, timeout: float = 90.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            line = self.proc.stdout.readline()
            if not line:
                if self.proc.poll() is not None:
                    raise RuntimeError(f"{self.name} died rc={self.proc.returncode}")
                time.sleep(0.1)
                continue
            m = re.search(r"transport (\S+), http port (\d+)", line)
            if m:
                self.transport_addr = m.group(1).rstrip(",")
                self.http_port = int(m.group(2))
                return self
        raise TimeoutError(f"{self.name} did not start in {timeout}s")

    def kill(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)
            self.proc.wait(timeout=10)

    def terminate(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.kill()


def _req(port: int, method: str, path: str, body=None, timeout=15.0):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return json.loads(e.read() or b"{}")


def _wait(fn, timeout=60.0):
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        try:
            last = fn()
            if last:
                return last
        except Exception:  # noqa: BLE001 — a node may still be booting
            pass
        time.sleep(0.3)
    raise TimeoutError(f"never reached: {last}")


def test_three_process_cluster_lifecycle(tmp_path):
    procs: list[PortProc] = []
    try:
        n1 = PortProc("mp1", str(tmp_path / "mp1"), None)
        procs.append(n1)
        n1.wait_started()
        n2 = PortProc("mp2", str(tmp_path / "mp2"), n1.transport_addr)
        n3 = PortProc("mp3", str(tmp_path / "mp3"), n1.transport_addr)
        procs += [n2, n3]
        n2.wait_started()
        n3.wait_started()
        _wait(lambda: _req(n1.http_port, "GET", "/_cluster/health",
                           timeout=5.0).get("number_of_nodes") == 3)
        r = _req(n1.http_port, "PUT", "/mpidx", {"settings": {
            "number_of_shards": 3, "number_of_replicas": 0}})
        assert r.get("acknowledged") is True, r
        _wait(lambda: _req(n1.http_port, "GET", "/_cluster/health/mpidx",
                           timeout=5.0).get("status") == "green")
        state = _req(n1.http_port, "GET", "/_cluster/state/routing_table")
        owners = {row[0]["node"] for row in
                  state["routing_table"]["indices"]["mpidx"]["shards"].values()}
        assert owners == {"mp1", "mp2", "mp3"}
        for i in range(30):
            r = _req(n2.http_port, "PUT", f"/mpidx/doc/{i}", {"n": i, "body": f"payload {i}"})
            assert r.get("_id") == str(i), r
        _req(n1.http_port, "POST", "/mpidx/_refresh")
        r = _req(n3.http_port, "GET", "/mpidx/_search",
                 {"query": {"match_all": {}}, "size": 30})
        assert r["hits"]["total"] == 30, r
        shard_owner = {int(sid): rows[0]["node"] for sid, rows in
                       state["routing_table"]["indices"]["mpidx"]["shards"].items()}
        held_by_survivors = sum(1 for h in r["hits"]["hits"]
                                if shard_owner[h["_shard"]] != "mp3")
        assert 0 < held_by_survivors < 30
        n3.kill()
        _wait(lambda: _req(n1.http_port, "GET", "/_cluster/health/mpidx",
                           timeout=5.0).get("number_of_nodes") == 2, timeout=90.0)
        _wait(lambda: _req(n1.http_port, "GET", "/_cluster/health/mpidx",
                           timeout=5.0).get("status") == "green", timeout=90.0)
        _req(n1.http_port, "POST", "/mpidx/_refresh")
        r = _req(n1.http_port, "GET", "/mpidx/_search", {"query": {"match_all": {}},
                                                        "size": 0})
        assert r["hits"]["total"] == held_by_survivors, r
        r = _req(n1.http_port, "PUT", "/mpidx/doc/after", {"n": 99, "body": "after"})
        assert r.get("_version") == 1, r
        _req(n1.http_port, "POST", "/mpidx/_refresh")
        r = _req(n2.http_port, "GET", "/mpidx/_count", {"query": {"match_all": {}}})
        assert r["count"] == held_by_survivors + 1, r
    finally:
        for p in procs:
            p.terminate()
