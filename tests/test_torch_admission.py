"""Search admission control (elasticsearch_tpu_torch/search/service.py
`SearchAdmissionController`, wired in actions.py) against the JAX
package's, on the CPU.

- Controller against controller: both take the same seeded sequence of
  shard-phase observations (latencies drawn from a lognormal around a few
  ms, with outliers) and, after each, the same admission questions (budgets
  above and below the expected phase, an unbounded one); they give the same
  decisions, the same `retry_after_s` and the same `stats()` at every step,
  cold (fewer than `min_samples` observations) and warm.
- Node against node (each package on its own in-process transport, both over
  HTTP): a cold node admits `?timeout=1ms`; once at least 10 shard phases
  have been observed, `?timeout=1ms` answers 429 on both with a
  `Retry-After` header and the port's `rejected` counts it, while a body
  without a timeout answers 200 with the JAX node's hits.
- The same searches through the port node's batcher (every shard phase
  coalesced, none bypassed) answer the JAX node's hits and `_shards`.

Tolerance: none. Every node is closed in a `finally`."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.common.errors import RejectedExecutionError
from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.search.service import SearchAdmissionController
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg
from tests.test_torch_node import call

WORDS = [f"w{i}" for i in range(20)]


class _Budget:
    """A deadline with a fixed remaining budget (None: unbounded), the one
    method both packages' controllers read."""

    def __init__(self, remaining):
        self._remaining = remaining

    def remaining(self):
        return self._remaining


def _decide(ctl, budget):
    try:
        ctl.admit(_Budget(budget))
    except Exception as e:  # noqa: BLE001 — the decision under test
        return type(e).__name__, getattr(e, "retry_after_s", None), str(e)
    return "admitted", None, None


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_controllers_decide_alike_on_the_same_observations(seed):
    from elasticsearch_tpu.search.service import SearchAdmissionController as JCtl

    rng = np.random.default_rng(seed)
    port, jax = SearchAdmissionController(), JCtl()
    n_rejected = 0
    for step in range(40):
        s = float(rng.lognormal(np.log(0.004), 0.5))
        if step % 13 == 7:
            s *= 50.0  # an outlier phase
        port.observe(s)
        jax.observe(s)
        expected = port.stats()["ewma_shard_phase_ms"] / 1000.0
        for budget in (None, 0.0, 0.001, expected * 0.5, expected * 2.0, 5.0):
            got, want = _decide(port, budget), _decide(jax, budget)
            assert got == want, (step, budget, got, want)
            n_rejected += got[0] != "admitted"
            if step + 1 < port.min_samples:
                assert got[0] == "admitted"  # cold: nothing is rejected
        assert port.stats() == jax.stats()
    assert n_rejected > 0 and port.stats()["rejected"] == n_rejected
    with pytest.raises(RejectedExecutionError) as err:
        port.admit(_Budget(0.0))
    assert err.value.status == 429 and err.value.retry_after_s >= 0.001


def _request(base, method, path, body=None):
    """(status, JSON, headers)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _fill(base):
    st, r = call(base, "PUT", "/adm", {"settings": {
        "number_of_shards": 2, "number_of_replicas": 0, "refresh_interval": -1}})
    assert st == 200, r
    rng = np.random.default_rng(9)
    lines = []
    for i in range(80):
        lines += [{"index": {"_index": "adm", "_type": "doc", "_id": str(i)}},
                  {"body": " ".join(rng.choice(WORDS, int(rng.integers(2, 12))))}]
    st, r = call(base, "POST", "/_bulk",
                 raw="\n".join(json.dumps(x) for x in lines) + "\n")
    assert st == 200 and not r["errors"], r
    assert call(base, "POST", "/adm/_refresh")[0] == 200


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(port base URL, JAX base URL, port node)."""
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu.transport.local import LocalTransportRegistry as JReg

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    p = PNode(name="port", settings={"node.device": "cpu"}, registry=PReg(),
              data_path=str(tmp_path_factory.mktemp("adm_port"))).start()
    j = JNode(name="jax", settings={"search.mesh.enabled": "false",
                                    "indices.warmer.enabled": "false"},
              registry=JReg(), data_path=str(tmp_path_factory.mktemp("adm_jax")))
    try:
        j.start([j.local_node.transport_address])
        j.wait_for_master()
        bases = [f"http://127.0.0.1:{p.start_http(0).port}",
                 f"http://127.0.0.1:{j.start_http(0).port}"]
        for base in bases:
            _fill(base)
        yield bases[0], bases[1], p
    finally:
        p.close()
        j.close()
        torch.set_num_threads(threads)


BODIES = [{"query": {"match": {"body": f"w{i} w{i + 3} w{i + 7}"}}, "size": 10}
          for i in range(8)]


def test_timeout_1ms_answers_429_once_warm_on_both(pair):
    pbase, jbase, p = pair
    # cold: nothing observed yet, so even a 1 ms budget is admitted
    assert p.actions.admission.stats()["observed"] == 0
    for base in (pbase, jbase):
        st, _r, _h = _request(base, "POST", "/adm/_search?timeout=1ms", BODIES[0])
        assert st == 200
    for body in BODIES:  # 2 shard phases a search: past min_samples
        got, want = (call(base, "POST", "/adm/_search", body) for base in (pbase, jbase))
        assert got[0] == want[0] == 200
        assert (got[1]["hits"], got[1]["_shards"]) == (want[1]["hits"], want[1]["_shards"])
    stats = p.actions.admission.stats()
    assert stats["observed"] >= 10 and stats["ewma_shard_phase_ms"] > 1.0, stats
    rejected = stats["rejected"]
    for base in (pbase, jbase):
        st, r, headers = _request(base, "POST", "/adm/_search?timeout=1ms", BODIES[1])
        assert st == 429, r
        assert "rejected before fan-out" in json.dumps(r)
        assert int(headers["Retry-After"]) >= 1
    assert p.actions.admission.stats()["rejected"] == rejected + 1
    # a body with no timeout is admitted, with the JAX node's hits
    got, want = (call(base, "POST", "/adm/_search", BODIES[2]) for base in (pbase, jbase))
    assert got[0] == want[0] == 200 and got[1]["hits"] == want[1]["hits"]


def test_batched_searches_serve_the_jax_node_hits(pair):
    pbase, jbase, p = pair
    before = p.search_batcher.stats()
    for body in BODIES:
        got, want = (call(base, "POST", "/adm/_search", body) for base in (pbase, jbase))
        assert got[0] == want[0] == 200
        assert (got[1]["hits"], got[1]["_shards"]) == (want[1]["hits"], want[1]["_shards"])
    after = p.search_batcher.stats()
    assert after["coalesced"] - before["coalesced"] == 2 * len(BODIES)
    assert after["bypassed"] == before["bypassed"]
