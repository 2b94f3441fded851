"""Every REST route of the JAX node on a port node (the repair of the fault
where such a request fell through to the document write).

Both packages' `build_rest_controller` run against a recording stub: every
(method, route) pair the JAX controller registers, all 255, is served by
the port's too, and the port registers no pair the JAX controller lacks.
The 11 snapshot pairs (the last rows of the port's table of later slices,
which is gone), each sent to a port node and to a JAX node with its path
filled in (an existing index `p3`, type `doc`, id `1`, names `x`) and the
same body, answer the same status and error type, and the index's
document count and mappings stay as they were (before the repair,
`POST /p3/_close` answered 201 and indexed a document of type `_close`;
index administration, which served that route since, is held against
the JAX node in `tests/test_torch_index_admin.py`). The 20 pairs of the observability
slice (A7a), which left that table, are each served on the port node:
200, and the index untouched (a profiler's stop after its start). So is
each GET pair of the admin slice (A7b: `_cat`, `_cluster/state`, `stats`,
`pending_tasks`, `settings`); its PUT and POST pairs (settings, reroute,
shutdown) are held against the JAX node in
`tests/test_torch_cluster_admin.py`."""

import json
import re
import urllib.error
import urllib.request

import pytest

from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.rest import controller as tcontroller
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg
from tests.test_torch_node import call


class _Stub:
    """Stands for the node and everything reached from it while a
    controller registers its routes."""

    def __getattr__(self, name):
        return _Stub()

    def __call__(self, *args, **kwargs):
        return _Stub()

    def __iter__(self):
        return iter(())


def _route_pairs(module) -> set[tuple[str, str]]:
    """The (method, route template) pairs `module.build_rest_controller`
    registers; wildcards read `{}`."""
    pairs = []
    original = module.RestController.register

    def register(self, method, template, handler):
        pairs.extend((m.strip().upper(), template) for m in method.split(","))
        return original(self, method, template, handler)

    module.RestController.register = register
    try:
        module.build_rest_controller(_Stub())
    finally:
        module.RestController.register = original
    return {(m, re.sub(r"\{\w+\}", "{}", t.rstrip("/") or "/")) for m, t in pairs}


# the snapshot pairs (A9), the last rows of the table of later slices
SNAPSHOT_ROUTES = [
    ("PUT,POST,GET,DELETE", "/_snapshot/{repo}"), ("GET", "/_snapshot"),
    ("POST", "/_snapshot/{repo}/_verify"),
    ("PUT,GET,DELETE", "/_snapshot/{repo}/{snapshot}"),
    ("GET", "/_snapshot/{repo}/{snapshot}/_status"),
    ("POST", "/_snapshot/{repo}/{snapshot}/_restore")]
LATER = [(m, template) for methods, template in SNAPSHOT_ROUTES
         for m in methods.split(",")]


def test_port_registers_every_jax_route_and_no_other():
    from elasticsearch_tpu.rest import controller as jcontroller

    jax, port = _route_pairs(jcontroller), _route_pairs(tcontroller)
    assert port == jax, (sorted(jax - port), sorted(port - jax))
    snapshot = {(m, re.sub(r"\{\w+\}", "{}", t)) for m, t in LATER}
    assert len(snapshot) == len(LATER)  # no pair twice
    assert len(jax) == 255 and len(snapshot) == 11 and snapshot <= port
    assert not hasattr(tcontroller, "_LATER_ROUTES")


def _fill_p3(base):
    st, r = call(base, "PUT", "/p3", {"settings": {"number_of_shards": 2,
                                                   "refresh_interval": -1}})
    assert st == 200, r
    for i in range(3):
        assert call(base, "PUT", f"/p3/doc/{i}", {"body": f"w{i}"})[0] == 201
    assert call(base, "POST", "/p3/_refresh")[0] == 200


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    node = PNode(name="routes", settings={"node.device": "cpu"}, registry=PReg(),
                 data_path=str(tmp_path_factory.mktemp("routes"))).start()
    try:
        base = f"http://127.0.0.1:{node.start_http(0).port}"
        _fill_p3(base)
        yield base
    finally:
        node.close()


@pytest.fixture(scope="module")
def jax(tmp_path_factory):
    """A JAX node named as the port node, holding the same `p3`."""
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu.transport.local import LocalTransportRegistry as JReg

    node = JNode(name="routes", settings={"search.mesh.enabled": "false",
                                          "indices.warmer.enabled": "false"},
                 registry=JReg(), data_path=str(tmp_path_factory.mktemp("routes_jax")))
    try:
        node.start([node.local_node.transport_address])
        node.wait_for_master()
        base = f"http://127.0.0.1:{node.start_http(0).port}"
        _fill_p3(base)
        yield base
    finally:
        node.close()


def _state(base):
    assert call(base, "POST", "/p3/_refresh")[0] == 200
    return call(base, "GET", "/p3/_count")[1]["count"], call(base, "GET", "/p3/_mapping")[1]


def _send(base, method, path):
    data = json.dumps({"probe": 1}).encode() if method in ("PUT", "POST") else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("method,template", LATER, ids=[f"{m} {t}" for m, t in LATER])
def test_snapshot_route_answers_as_the_jax_node(port, jax, method, template):
    path = template.replace("{index}", "p3").replace("{type}", "doc") \
        .replace("{id}", "1")
    path = re.sub(r"\{\w+\}", "x", path)
    answers = []
    for base in (port, jax):
        before = _state(base)
        st, payload = _send(base, method, path)
        err = json.loads(payload).get("error") if st >= 400 else None
        answers.append((st, err["type"] if isinstance(err, dict) else err))
        assert _state(base) == before == (3, before[1])
    assert answers[0] == answers[1], (method, path, answers)
    assert "NotPorted" not in json.dumps(answers[0])


# the pairs the observability slice (A7a) serves
A7A = [("GET", "/_stats"), ("GET", "/{index}/_stats"), ("GET", "/_status"),
       ("GET", "/{index}/_status"), ("GET", "/_segments"), ("GET", "/{index}/_segments"),
       ("GET", "/_nodes"), ("GET", "/_nodes/stats"), ("GET", "/_nodes/stats/{metric}"),
       ("GET", "/_nodes/{node_id}/stats"), ("GET", "/_nodes/{node_id}/stats/{metric}"),
       ("GET", "/_cluster/nodes/hot_threads"), ("GET", "/_nodes/hot_threads"),
       ("GET", "/_insights/queries"), ("GET", "/_events"), ("GET", "/_traces"),
       ("GET", "/_tasks"), ("GET", "/_prometheus/metrics"),
       ("POST", "/_nodes/_local/profiler/start"), ("POST", "/_nodes/_local/profiler/stop")]


@pytest.mark.parametrize("method,template", A7A, ids=[f"{m} {t}" for m, t in A7A])
def test_observability_route_is_served_and_writes_nothing(port, method, template):
    assert (method, template) not in set(LATER)
    path = template.replace("{index}", "p3").replace("{metric}", "search,tracing") \
        .replace("{node_id}", "_local")
    if "hot_threads" in path:
        path += "?interval=1ms"
    before = _state(port)
    if path.endswith("/profiler/stop"):
        assert _send(port, "POST", "/_nodes/_local/profiler/start")[0] == 200
    st, payload = _send(port, method, path)
    assert st == 200, (method, path, payload)
    if path.endswith("/profiler/start"):
        assert _send(port, "POST", "/_nodes/_local/profiler/stop")[0] == 200
    if not path.startswith(("/_nodes/hot", "/_cluster/nodes/hot", "/_prometheus")):
        assert "NotPorted" not in json.dumps(json.loads(payload))
    assert _state(port) == before == (3, before[1])


# the GET pairs the admin slice (A7b) serves
A7B = [("GET", "/_cluster/state"), ("GET", "/_cluster/state/{metric}"),
       ("GET", "/_cluster/state/{metric}/{index}"), ("GET", "/_cluster/pending_tasks"),
       ("GET", "/_cluster/stats"), ("GET", "/_cluster/stats/nodes/{node_id}"),
       ("GET", "/_cluster/settings"), ("GET", "/_cat"), ("GET", "/_cat/health"),
       ("GET", "/_cat/nodes"), ("GET", "/_cat/indices"), ("GET", "/_cat/shards"),
       ("GET", "/_cat/shards/{index}"), ("GET", "/_cat/master"),
       ("GET", "/_cat/allocation"), ("GET", "/_cat/allocation/{node_id}"),
       ("GET", "/_cat/count"), ("GET", "/_cat/count/{index}"), ("GET", "/_cat/aliases"),
       ("GET", "/_cat/aliases/{name}"), ("GET", "/_cat/pending_tasks"),
       ("GET", "/_cat/recovery"), ("GET", "/_cat/thread_pool"), ("GET", "/_cat/batcher"),
       ("GET", "/_cat/caches"), ("GET", "/_cat/segments"),
       ("GET", "/_cat/segments/{index}"), ("GET", "/_cat/events")]


@pytest.mark.parametrize("method,template", A7B, ids=[f"{m} {t}" for m, t in A7B])
def test_admin_route_is_served(port, method, template):
    assert (method, template) not in set(LATER)
    path = template.replace("{index}", "p3").replace("{metric}", "metadata,routing_table") \
        .replace("{node_id}", "routes").replace("{name}", "*")
    before = _state(port)
    st, payload = _send(port, method, path)
    assert st == 200, (method, path, payload)
    assert b"NotPorted" not in payload
    if path.startswith("/_cat"):
        assert path == "/_cat" or b"error" not in payload, payload
    else:
        json.loads(payload)
    if path == "/_cat/count/p3":
        assert payload.split()[-1] == b"3"
    assert _state(port) == before == (3, before[1])
