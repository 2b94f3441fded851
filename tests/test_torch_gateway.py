"""Gateway recovery on a one-node restart (elasticsearch_tpu_torch/gateway.py,
cluster/state.py `from_dict`) against the JAX package's, on the CPU.

Node against node: a port node and a JAX node (each package on its own
in-process transport, both over HTTP) go through the same sequence on a
2-shard index — two `_bulk` requests each followed by a refresh, a flush, a
single-document DELETE, a third `_bulk` and a single-document index left
in the translog (the latter brings a new field into the index's mapping
through dynamic mapping; a `_bulk` does not update the cluster's mapping in
either package) — then a refresh, so the
answers before the close can be recorded. Both nodes close and start again
over the same `path.data`. After the restart each `_search` body's `hits`
and `_shards` equal the JAX node's and the node's own answers before the
close, bitwise; so does a GET of a document that lived only in the
translog, of the deleted one and of a flushed one, and the restored
mappings carry the dynamic field. The model is
tests/test_cluster.py::TestAliasesTemplatesGateway::
test_gateway_restores_metadata_after_full_restart.

Also: `MetaData.from_dict(to_dict())` round-trips the port's metadata (and
reads the JAX package's file); under `gateway.recover_after_nodes: 2` a
restarted node and a second one restore the persisted index as the JAX
pair does; a fresh `path.data` starts as before; neither package
re-registers the `.percolator` documents of a restarted index (its
registry is filled by the single-document index only), so the two answer a
percolation after the restart alike; and the warmer's gate holds after a
restart as after a fresh start — the first search packs inline, later
views pack on the warmer pool.

Every node is closed in a `finally`; both packages' fault injectors and
trackers are reset around every test."""

import json
import os
import time

import pytest
import torch

from elasticsearch_tpu.common.devicehealth import DEVICE_HEALTH as J_HEALTH
from elasticsearch_tpu.transport.faults import DEVICE_FAULTS as J_FAULTS
from elasticsearch_tpu.transport.faults import DEVICE_PULL as J_PULL
from elasticsearch_tpu_torch.cluster.state import MetaData
from elasticsearch_tpu_torch.common.devicehealth import DEVICE_HEALTH
from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.ops.device_index import PACK_LEDGER
from elasticsearch_tpu_torch.transport.faults import DEVICE_FAULTS, DEVICE_PULL
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg
from tests.test_torch_node import call

WORDS = [f"w{i}" for i in range(24)]
GW = "gw"


def _reset_all():
    for faults in (DEVICE_FAULTS, J_FAULTS, DEVICE_PULL, J_PULL):
        faults.disarm()
    for health in (DEVICE_HEALTH, J_HEALTH):
        health.reset()


@pytest.fixture(autouse=True)
def _device_state_hygiene():
    _reset_all()
    try:
        yield
    finally:
        _reset_all()


def _ndjson(lines) -> str:
    return "\n".join(json.dumps(x) for x in lines) + "\n"


def _bulks(seed: int) -> list[str]:
    """Three bulk bodies on GW: 0-119; 120-199 with deletes and overwrites;
    200-239 with one document bringing the new field `tag2`."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def doc(i):
        vocab = WORDS[: int(rng.integers(6, 24))]
        return {"body": " ".join(rng.choice(vocab, int(rng.integers(2, 20)))),
                "n": i}

    def op(i, src):
        return [{"index": {"_index": GW, "_type": "doc", "_id": str(i)}}, src]

    first = [x for i in range(120) for x in op(i, doc(i))]
    second = [x for i in range(120, 200) for x in op(i, doc(i))]
    second += [{"delete": {"_index": GW, "_type": "doc", "_id": str(i)}}
               for i in range(0, 120, 11)]
    second += op(7, {"body": "over written w1 w1 w2", "n": -7})
    third = [x for i in range(200, 240) for x in op(i, doc(i))]
    third += op(240, {"body": "w3 fresh", "n": 240, "tag2": "late"})
    third += op(17, {"body": "w2 w2 rewritten in the translog", "n": -17})
    return [_ndjson(b) for b in (first, second, third)]


SEARCHES = [
    {"query": {"match": {"body": "w1 w2 w3"}}, "size": 20},
    {"query": {"term": {"body": "w5"}}, "size": 10},
    {"query": {"bool": {"must": [{"term": {"body": "w2"}}],
                        "should": [{"term": {"body": "w4"}}, {"term": {"body": "w9"}}],
                        "must_not": [{"term": {"body": "w7"}}]}}, "size": 15},
    {"query": {"match": {"body": {"query": "w0 w6", "operator": "and"}}}},
    {"query": {"match": {"body": "w8 w12 w15"}}, "from": 5, "size": 10},
    {"query": {"term": {"tag2": "late"}}},
    {"query": {"match": {"body": "rewritten fresh written"}}, "size": 5},
    {"query": {"match_all": {}}, "size": 3},
    {"query": {"term": {"tag3": "solo"}}},
]
GETS = ["17", "240", "300", "7", "0", "11", "150", "missing"]


def _boot(pdir, jdir):
    """A port node and a JAX node over the given data paths: (port, JAX,
    port base URL, JAX base URL)."""
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu.transport.local import LocalTransportRegistry as JReg

    p = PNode(name="port", settings={"node.device": "cpu"}, registry=PReg(),
              data_path=pdir)
    j = None
    try:
        p.start()
        j = JNode(name="jax", settings={"search.mesh.enabled": "false",
                                        "indices.warmer.enabled": "false"},
                  registry=JReg(), data_path=jdir)
        j.start([j.local_node.transport_address])
        j.wait_for_master()
        return (p, j, f"http://127.0.0.1:{p.start_http(0).port}",
                f"http://127.0.0.1:{j.start_http(0).port}")
    except BaseException:
        p.close()
        if j is not None:
            j.close()
        raise


def _wait_green(base, index):
    t0 = time.monotonic()
    while time.monotonic() - t0 < 30:
        st, h = call(base, "GET", f"/_cluster/health/{index}")
        if st == 200 and h["status"] == "green":
            return h
        time.sleep(0.05)
    raise AssertionError(f"{base} {index} never green: {h}")


def _answers(base) -> dict:
    out = {}
    for i, body in enumerate(SEARCHES):
        st, r = call(base, "POST", f"/{GW}/_search", body)
        assert st == 200, r
        out[("search", i)] = (r["hits"], r["_shards"])
    for doc_id in GETS:
        out[("get", doc_id)] = call(base, "GET", f"/{GW}/doc/{doc_id}")
    return out


def _fill(base):
    for index, shards in ((GW, 2), ("pq", 1), ("gate", 1)):
        st, r = call(base, "PUT", f"/{index}", {"settings": {
            "number_of_shards": shards, "number_of_replicas": 0,
            "refresh_interval": -1}})
        assert st == 200 and r["acknowledged"], r
    first, second, third = _bulks(41)
    for bulk in (first, second):
        st, r = call(base, "POST", "/_bulk", raw=bulk)
        assert st == 200 and not r["errors"], r
        assert call(base, "POST", f"/{GW}/_refresh")[0] == 200
    assert call(base, "POST", f"/{GW}/_flush")[0] == 200
    st, r = call(base, "DELETE", f"/{GW}/doc/150")
    assert st == 200 and r["found"], r
    st, r = call(base, "POST", "/_bulk", raw=third)
    assert st == 200 and not r["errors"], r
    st, r = call(base, "PUT", f"/{GW}/doc/300",
                 {"body": "w4 single", "n": 300, "tag3": "solo"})
    assert st == 201, r
    # the percolator's registry: filled by the single-document index
    st, r = call(base, "PUT", "/pq/.percolator/q1",
                 {"query": {"match": {"body": "alert"}}})
    assert st == 201, r
    gate = _ndjson([x for i in range(20) for x in (
        {"index": {"_index": "gate", "_type": "doc", "_id": str(i)}},
        {"body": f"alpha beta{i % 3}"})])
    assert call(base, "POST", "/_bulk", raw=gate)[0] == 200
    assert call(base, "POST", "/gate/_refresh")[0] == 200
    assert call(base, "POST", "/gate/_flush")[0] == 200


@pytest.fixture(scope="module")
def restarted(tmp_path_factory):
    """Both nodes through the sequence, closed and started again over the
    same data: {"before": {port, jax answers}, "after": ..., nodes, bases}."""
    pdir = str(tmp_path_factory.mktemp("gw_port"))
    jdir = str(tmp_path_factory.mktemp("gw_jax"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        p, j, pbase, jbase = _boot(pdir, jdir)
        try:
            for base in (pbase, jbase):
                _fill(base)
            out["perc_before"] = [call(b, "POST", "/pq/doc/_percolate",
                                       {"doc": {"body": "an alert"}})
                                  for b in (pbase, jbase)]
            # the translog's ops are made visible, NOT flushed: the answers
            # before the close read the same documents as the restart
            for base in (pbase, jbase):
                assert call(base, "POST", f"/{GW}/_refresh")[0] == 200
            out["before"] = (_answers(pbase), _answers(jbase))
            out["mappings_before"] = (
                p.cluster_service.state.metadata.index(GW).mappings_dict(),
                j.cluster_service.state.metadata.index(GW).mappings_dict())
        finally:
            p.close()
            j.close()
        p, j, pbase, jbase = _boot(pdir, jdir)
        try:
            for base in (pbase, jbase):
                for index in (GW, "pq", "gate"):
                    _wait_green(base, index)
            out.update(p=p, j=j, pbase=pbase, jbase=jbase)
            out["after"] = (_answers(pbase), _answers(jbase))
            yield out
        finally:
            p.close()
            j.close()
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("i", range(len(SEARCHES)))
def test_search_after_restart_matches_jax_node_and_before(restarted, i):
    """`hits` and `_shards` whole, bitwise: the restarted port node against
    the restarted JAX node, and against its own answer before the close."""
    (pa, ja), (pb, jb) = restarted["after"], restarted["before"]
    got, want = pa[("search", i)], ja[("search", i)]
    assert got == want
    assert got == pb[("search", i)]
    assert want == jb[("search", i)]
    assert got[1]["failed"] == 0 and got[0]["total"] > 0


@pytest.mark.parametrize("doc_id", GETS)
def test_get_after_restart_matches_jax_node(restarted, doc_id):
    """GET of a translog-only document (240, 300, 17 rewritten), a flushed one,
    a document deleted after the flush (150), one deleted by the bulk (0,
    11) and a missing id: status and JSON equal the JAX node's and the
    port's own before the close."""
    (pa, ja), (pb, _jb) = restarted["after"], restarted["before"]
    assert pa[("get", doc_id)] == ja[("get", doc_id)]
    assert pa[("get", doc_id)] == pb[("get", doc_id)]
    st, r = pa[("get", doc_id)]
    found = doc_id not in ("150", "0", "11", "missing")
    assert st == (200 if found else 404) and r["found"] == found
    if doc_id == "240":
        assert r["_source"]["tag2"] == "late"


def test_dynamic_mapping_returns_through_the_metadata(restarted):
    p, j = restarted["p"], restarted["j"]
    got = p.cluster_service.state.metadata.index(GW).mappings_dict()
    assert got == j.cluster_service.state.metadata.index(GW).mappings_dict()
    assert got == restarted["mappings_before"][0]
    assert {"body", "n", "tag3"} <= set(got["doc"]["properties"])


def test_percolator_registry_is_not_refilled_on_either_node(restarted):
    """Before the restart both match q1; after it neither package has
    re-registered the `.percolator` document, and they answer alike."""
    before = restarted["perc_before"]
    assert before[0] == before[1] or _drop_took(before[0]) == _drop_took(before[1])
    assert [m["_id"] for m in before[0][1]["matches"]] == ["q1"]
    after = [call(b, "POST", "/pq/doc/_percolate", {"doc": {"body": "an alert"}})
             for b in (restarted["pbase"], restarted["jbase"])]
    assert _drop_took(after[0]) == _drop_took(after[1])
    assert after[0][0] == 200 and after[0][1]["total"] == 0


def _drop_took(resp):
    st, r = resp
    return st, {k: v for k, v in r.items() if k != "took"}


def test_warmer_gate_holds_after_restart(restarted):
    """The restarted shard has served no search: the first one packs its
    segment on the query path, and after it a refresh's view packs on the
    warmer pool."""
    p, base = restarted["p"], restarted["pbase"]
    engine = p.indices.index_service("gate").shard(0).engine
    assert not engine.search_active
    PACK_LEDGER.forget("gate")
    st, r = call(base, "POST", "/gate/_search", {"query": {"match": {"body": "alpha"}}})
    assert st == 200 and r["hits"]["total"] == 20
    assert engine.search_active
    pools = PACK_LEDGER.stats("gate")["pools"]
    assert sum(pools.values()) >= 1 and set(pools) <= {"search", "search_batcher"}, pools
    PACK_LEDGER.forget("gate")
    st, _r = call(base, "PUT", "/gate/doc/new", {"body": "alpha late"})
    assert st == 201
    assert call(base, "POST", "/gate/_refresh")[0] == 200
    t0 = time.monotonic()
    while time.monotonic() - t0 < 20:
        ws = p.warmer.stats()
        if ws["packs_done"] >= ws["packs_scheduled"] and PACK_LEDGER.stats("gate"):
            break
        time.sleep(0.02)
    st, r = call(base, "POST", "/gate/_search", {"query": {"match": {"body": "alpha"}}})
    assert st == 200 and r["hits"]["total"] == 21
    pools = PACK_LEDGER.stats("gate")["pools"]
    assert pools and set(pools) <= {"warmer", "merge"}, pools
    PACK_LEDGER.forget("gate")


def test_metadata_round_trips_and_reads_the_jax_file(restarted):
    p, j = restarted["p"], restarted["j"]
    md = p.cluster_service.state.metadata
    assert MetaData.from_dict(md.to_dict()) == md
    assert MetaData.from_dict(json.loads(json.dumps(md.to_dict()))) == md
    # the JAX node's persisted file: the same indices, settings and mappings
    with open(os.path.join(j.data_path, "_state", "metadata.json")) as fh:
        jmd = MetaData.from_dict(json.load(fh))
    assert jmd.index_names() == md.index_names()
    # ("gate" takes a document on the port node alone, in the gate's test)
    for name in (GW, "pq"):
        assert jmd.index(name).settings_map == md.index(name).settings_map
        assert jmd.index(name).mappings_dict() == md.index(name).mappings_dict()


def test_recover_after_nodes_two_restores_the_persisted_index_as_jax(tmp_path):
    """Node a persists an index alone; restarted beside b under
    `gateway.recover_after_nodes: 2`, each package's master restores it
    once both nodes are in and spreads its primaries over both."""
    from tests.test_torch_node import call
    from tests.test_torch_two_nodes import Cluster, _placement

    for pkg in ("port", "jax"):
        first = Cluster(pkg, ["a"], tmp_path)
        try:
            st, r = call(first.base("a"), "PUT", "/kept", {"settings": {
                "number_of_shards": 2, "number_of_replicas": 0}})
            assert st == 200 and first.settled("kept")
        finally:
            first.close()
    both = []
    try:
        for pkg in ("port", "jax"):
            both.append(Cluster(pkg, ["a", "b"], tmp_path,
                                settings={"gateway.recover_after_nodes": 2}))
        for c in both:
            assert c.settled("kept")
        p, j = both
        assert p.states()[0].metadata.index_names() == \
            j.states()[0].metadata.index_names() == ["kept"]
        assert _placement(p.states()[0], "kept") == _placement(j.states()[0], "kept")
        assert p.states()[0].blocks.global_blocks == j.states()[0].blocks.global_blocks
    finally:
        for c in both:
            c.close()


def test_fresh_path_data_starts_as_before(tmp_path):
    """No metadata file: nothing is restored, the blocks lift, the node
    creates and serves an index, and its metadata is persisted."""
    node = PNode(name="f", settings={"node.device": "cpu"}, registry=PReg(),
                 data_path=str(tmp_path))
    try:
        node.start()
        state = node.cluster_service.state
        assert state.blocks.global_blocks == ()
        assert state.metadata.index_names() == []
        c = node.client()
        c.create_index("fresh", {"settings": {"number_of_shards": 1,
                                              "number_of_replicas": 0}})
        assert c.cluster_health("fresh", wait_for_status="green")["status"] == "green"
        c.index("fresh", "doc", {"body": "x"}, id="1", refresh=True)
        assert c.search("fresh", {"query": {"match": {"body": "x"}}})["hits"]["total"] == 1
        with open(node.gateway.meta_path) as fh:
            assert "fresh" in json.load(fh)["indices"]
    finally:
        node.close()
