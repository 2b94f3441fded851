"""Index creation with the mappings the port used to refuse (the repair of the
fault where such an index was acknowledged, never started, and kept the
indexes after it from starting).

The mapper, module against module: a `binary` field is kept in `_source`
only, a `completion`, `murmur3` or other unlisted type keeps its values as
string doc values, as the JAX mapper does (the same rendered mapping and the
same parsed document). `_ttl` maps as in the JAX mapper (served since the
document APIs' slice).

Node against node over REST: `binary`, `completion` and `murmur3` indexes
start, index a document and serve the same search, GET and mapping as the
JAX node's, and so does an index created with a `_ttl` mapping. An index
whose service fails to build
(metadata written without the create action's check, as a node that ran
before the repair persisted it) stays red on its own: an index created
after it starts green, also after a restart over the same `path.data`."""

import json

import pytest

from elasticsearch_tpu_torch.cluster.allocation import new_index_routing
from elasticsearch_tpu_torch.cluster.state import IndexMetaData
from elasticsearch_tpu_torch.common.errors import MapperParsingError
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg
from tests.test_torch_node import _node_pair, call

TYPES = {
    "binary": ({"type": "binary"}, "aGVsbG8gd29ybGQ="),
    "completion": ({"type": "completion"}, "Nirvana"),
    "murmur3": ({"type": "murmur3"}, "some value"),
}


def _mapping(kind):
    spec, _value = TYPES[kind]
    return {"properties": {"title": {"type": "string"}, "f": spec}}


@pytest.mark.parametrize("kind", list(TYPES))
def test_mapper_keeps_unlisted_types_as_the_jax_mapper(kind):
    from elasticsearch_tpu.mapper import MapperService as JMapperService

    jms, tms = JMapperService(), TMapperService()
    for ms in (jms, tms):
        ms.put_mapping("doc", _mapping(kind))
    assert tms.mappings_dict() == jms.mappings_dict()
    src = {"title": "a quick fox", "f": TYPES[kind][1]}
    jdoc, tdoc = (ms.mapper_for("doc").parse(src, "1") for ms in (jms, tms))
    assert tdoc.doc_values_str == jdoc.doc_values_str
    assert tdoc.postings == jdoc.postings and tdoc.field_lengths == jdoc.field_lengths
    assert ("f" in tdoc.doc_values_str) == (kind != "binary")


def test_ttl_still_raises_naming_its_slice():
    """`_ttl` maps, renders and parses as in the JAX mapper (its refusal went
    with the document APIs' slice): a document's TTL from the default."""
    from elasticsearch_tpu.mapper import MapperService as JMapperService

    mapping = {"_ttl": {"enabled": True, "default": "1d"},
               "properties": {"title": {"type": "string"}}}
    jms, tms = JMapperService(), TMapperService()
    for ms in (jms, tms):
        ms.put_mapping("doc", mapping)
    assert tms.mappings_dict() == jms.mappings_dict()
    assert tms.mappings_dict()["doc"]["_ttl"] == {"enabled": True}
    jdoc, tdoc = (ms.mapper_for("doc").parse({"title": "x"}, "1",
                                             timestamp=4102444800000)
                  for ms in (jms, tms))
    assert tdoc.ttl == jdoc.ttl == 86_400_000
    assert tdoc.doc_values_num == jdoc.doc_values_num
    assert tdoc.doc_values_num["_expiry"] == [4102444800000.0 + 86_400_000]


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    def fill(base):
        for kind in TYPES:
            st, r = call(base, "PUT", f"/c7_{kind}", {
                "settings": {"number_of_shards": 2, "number_of_replicas": 0,
                             "refresh_interval": -1},
                "mappings": {"doc": _mapping(kind)}})
            assert st == 200 and r["primaries_active"], r
            for i in range(4):
                st, r = call(base, "PUT", f"/c7_{kind}/doc/{i}",
                             {"title": f"quick fox {i}", "f": TYPES[kind][1]})
                assert st == 201, r
            assert call(base, "POST", f"/c7_{kind}/_refresh")[0] == 200

    yield from _node_pair(tmp_path_factory, fill)


@pytest.mark.parametrize("kind", list(TYPES))
def test_index_starts_and_serves_as_the_jax_node(nodes, kind):
    pbase, jbase, _p = nodes
    answers = []
    for path, body in ((f"/_cluster/health/c7_{kind}", None),
                       (f"/c7_{kind}/_mapping", None),
                       (f"/c7_{kind}/doc/2", None),
                       (f"/c7_{kind}/_search", {"query": {"match": {"title": "fox"}}}),
                       (f"/c7_{kind}/_search", {"query": {"filtered": {
                           "filter": {"exists": {"field": "f"}}}}})):
        (pst, pr), (jst, jr) = (call(b, "POST" if body else "GET", path, body)
                                for b in (pbase, jbase))
        for r in (pr, jr):
            r.pop("took", None)
        assert (pst, json.dumps(pr, sort_keys=True)) == (jst, json.dumps(jr, sort_keys=True))
        answers.append((pst, pr))
    health, _mapping_, got, found, exists = answers
    assert health[1]["status"] == "green" and got[1]["_source"]["f"] == TYPES[kind][1]
    assert found[1]["hits"]["total"] == 4
    # a binary value is kept in _source only: no doc value says it exists
    assert exists[1]["hits"]["total"] == (0 if kind == "binary" else 4)


def test_ttl_at_create_answers_400_and_creates_nothing(nodes):
    """An index created with a `_ttl` mapping (refused before the document
    APIs' slice) starts, maps and serves a document as on the JAX node."""
    pbase, jbase, pnode = nodes
    answers = []
    for path, method, body in (
            ("/c7_ttl", "PUT", {"settings": {"number_of_shards": 1,
                                             "number_of_replicas": 0},
                                "mappings": {"doc": {"_ttl": {"enabled": True,
                                                              "default": "1d"}}}}),
            ("/_cluster/health/c7_ttl", "GET", None),
            ("/c7_ttl/_mapping", "GET", None),
            ("/c7_ttl/doc/1", "PUT", {"title": "quick fox"}),
            ("/c7_ttl/_refresh", "POST", None),
            ("/c7_ttl/_search", "POST", {"query": {"match": {"title": "fox"}}})):
        (pst, pr), (jst, jr) = (call(b, method, path, body) for b in (pbase, jbase))
        pr.pop("took", None), jr.pop("took", None)
        assert (pst, pr) == (jst, jr), path
        answers.append((pst, pr))
    assert answers[0][1]["acknowledged"] and answers[1][1]["status"] == "green"
    assert answers[5][1]["hits"]["total"] == 1
    assert pnode.cluster_service.state.metadata.has_index("c7_ttl")
    # the document's remaining TTL: positive, under the default
    st, r = call(pbase, "GET", "/c7_ttl/doc/1?fields=_ttl")
    assert st == 200 and 0 < r["fields"]["_ttl"] < 86_400_000, r


def _put_unchecked_index(node, name: str, mappings: dict):
    """An index straight into the cluster state, past the create action's
    mapping check."""
    def update(state):
        meta = IndexMetaData(name=name, settings_map=(
            ("index.number_of_replicas", 0), ("index.number_of_shards", 1)))
        for t, m in mappings.items():
            meta = meta.with_mapping(t, m)
        return node.allocation.reroute(state.next_version(
            metadata=state.metadata.with_index(meta),
            routing_table=state.routing_table.with_index(new_index_routing(name, 1, 0))))

    node.cluster_service.submit_state_update_task(f"unchecked[{name}]", update).result(10)


def test_an_index_after_a_failing_one_starts(tmp_path):
    data = str(tmp_path / "data")
    node = PNode(name="c7", settings={"node.device": "cpu"}, registry=PReg(),
                 data_path=data).start()
    try:
        base = f"http://127.0.0.1:{node.start_http(0).port}"
        # a mapping the port's mapper refuses: a field spec that is no object
        _put_unchecked_index(node, "aaa_broken", {"doc": {"properties": {"f": "string"}}})
        st, r = call(base, "PUT", "/zzz_after", {"settings": {"number_of_replicas": 0}})
        assert st == 200 and r["primaries_active"], r
        assert call(base, "PUT", "/zzz_after/doc/1", {"body": "x"})[0] == 201
        assert call(base, "GET", "/_cluster/health/zzz_after")[1]["status"] == "green"
        assert call(base, "GET", "/_cluster/health/aaa_broken")[1]["status"] == "red"
    finally:
        node.close()
    # restarted over the same path.data: the gateway restores both indexes
    node = PNode(name="c7", settings={"node.device": "cpu"}, registry=PReg(),
                 data_path=data).start()
    try:
        base = f"http://127.0.0.1:{node.start_http(0).port}"
        h = node.client().cluster_health(index="zzz_after", wait_for_status="green")
        assert h["status"] == "green", h
        assert call(base, "GET", "/zzz_after/doc/1")[1]["_source"] == {"body": "x"}
    finally:
        node.close()
