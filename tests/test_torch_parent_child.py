"""Parent/child on the port against the JAX package: the `?parent=` routing
of single-document writes and reads, the `_parent` mapping, and the
has_child / has_parent / top_children joins.

- Node against node (each package on its own LocalTransportRegistry): a
  document written with `?parent=` lands on the shard its parent hashes to
  on both nodes, with or without a `_parent` mapping, and GET, DELETE and
  `_search` answer the same JSON; a `_parent` type refuses a write without
  routing as the JAX node does; the join bodies over the Elasticsearch 1.x
  guide's company/branch/employee model and the has_child / has_parent
  filter cases of tests/test_dsl_long_tail.py `TestParentChildFilters`
  answer the JAX node's hits JSON (bitwise on the host scorer, within 2
  ulp tie-tolerant where a join filter rides the dense family).
- Module against module: `_shard_join` over three segments with
  tombstones gives the JAX package's per-segment scores and masks bitwise,
  for every score mode, and the has_child filter never serves a stale
  mask after a child lands in a later segment.
- Two behaviours of the JAX package are pinned, not repaired: a `_bulk`
  item's parent is ignored (no pointer, routed by id), and a child
  replayed from the translog loses its parent pointer.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg
from tests.test_torch_dense import _tie_tolerant_equal, _within_ulps
from tests.test_torch_node import call

SHARDS = 5
BRANCHES = [("london", "London Westminster", "UK"),
            ("liverpool", "Liverpool Central", "UK"),
            ("paris", "Champs Élysées", "France")]
HOBBIES = ["hiking", "golf", "chess", "climbing", "painting", "sailing"]
FIRST = ["Alice", "Mark", "Barry", "Adrien", "Zoe", "Ivan", "Nora", "Omar"]
COMPANY_MAPPINGS = {
    "branch": {"properties": {"name": {"type": "string"},
                              "city": {"type": "string", "index": "not_analyzed"},
                              "country": {"type": "string", "index": "not_analyzed"}}},
    "employee": {"_parent": {"type": "branch"},
                 "properties": {"name": {"type": "string"},
                                "dob": {"type": "date"},
                                "hobby": {"type": "string"}}},
}
BLOG_MAPPINGS = {
    "blog": {"properties": {"title": {"type": "string"}}},
    "comment": {"_parent": {"type": "blog"}, "properties": {"text": {"type": "string"}}},
}


def _branches() -> list[tuple[str, dict]]:
    out = [(bid, {"name": name, "city": bid, "country": country})
           for bid, name, country in BRANCHES]
    rng = np.random.default_rng(41)
    for i in range(9):
        out.append((f"b{i}", {"name": f"branch {rng.choice(HOBBIES)} {i}",
                              "city": f"city{i}", "country": str(rng.choice(["UK", "FR"]))}))
    return out


def _employees(branch_ids) -> list[tuple[str, str, dict]]:
    rng = np.random.default_rng(42)
    out = [("1", "london", {"name": "Alice Smith", "dob": "1970-10-24",
                            "hobby": "hiking"}),
           ("2", "london", {"name": "Mark Thomas", "dob": "1982-05-16",
                            "hobby": "diving"}),
           ("3", "liverpool", {"name": "Barry Smith", "dob": "1979-04-01",
                               "hobby": "hiking"}),
           ("4", "paris", {"name": "Adrien Grand", "dob": "1987-05-11",
                           "hobby": "horses"})]
    for i in range(5, 61):
        parent = str(rng.choice(branch_ids[3:])) if i % 4 else "paris"
        out.append((str(i), parent, {
            "name": f"{rng.choice(FIRST)} {rng.choice(FIRST)}son",
            "dob": f"19{int(rng.integers(60, 99))}-0{int(rng.integers(1, 9))}-1{i % 9}",
            "hobby": " ".join(rng.choice(HOBBIES, size=2))}))
    return out


def _put(base, path, body):
    st, r = call(base, "PUT", path, body)
    assert st in (200, 201), (path, r)
    return r


def _fill(base):
    for index, mappings in (("company", COMPANY_MAPPINGS), ("blogpc", BLOG_MAPPINGS)):
        _put(base, f"/{index}", {"mappings": mappings, "settings": {
            "number_of_shards": SHARDS if index != "blogpc" else 2,
            "number_of_replicas": 0, "refresh_interval": -1}})
    branches = _branches()
    for bid, src in branches:
        _put(base, f"/company/branch/{bid}", src)
    call(base, "POST", "/company/_refresh")  # the branches in their own segments
    for eid, parent, src in _employees([b for b, _ in branches]):
        _put(base, f"/company/employee/{eid}?parent={parent}", src)
    for bid, title in (("b1", "jax on tpu"), ("b2", "numpy tricks"), ("b3", "silent post")):
        _put(base, f"/blogpc/blog/{bid}", {"title": title})
    for cid, parent, text in (("c1", "b1", "great article"), ("c2", "b2", "nice read great"),
                              ("c3", "b2", "meh")):
        _put(base, f"/blogpc/comment/{cid}?parent={parent}", {"text": text})
    # a child deleted after a refresh: its tombstone is in the view
    _put(base, "/company/employee/gone?parent=london",
         {"name": "Gone Smith", "hobby": "hiking"})
    call(base, "POST", "/_refresh")
    st, _r = call(base, "DELETE", "/company/employee/gone?parent=london")
    assert st == 200
    call(base, "POST", "/_refresh")


def _node_pair(tmp_path_factory, fill):
    """(port URL, JAX URL, port node, JAX node), both closed afterwards."""
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu.transport.local import LocalTransportRegistry as JReg

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    p = PNode(name="port", settings={"node.device": "cpu"}, registry=PReg(),
              data_path=str(tmp_path_factory.mktemp("pc_port"))).start()
    j = None
    try:
        j = JNode(name="jax", settings={"search.mesh.enabled": "false",
                                        "indices.warmer.enabled": "false"},
                  registry=JReg(), data_path=str(tmp_path_factory.mktemp("pc_jax")))
        j.start([j.local_node.transport_address])
        j.wait_for_master()
        bases = [f"http://127.0.0.1:{p.start_http(0).port}",
                 f"http://127.0.0.1:{j.start_http(0).port}"]
        for base in bases:
            fill(base)
        yield bases[0], bases[1], p, j
    finally:
        p.close()
        if j is not None:
            j.close()
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    yield from _node_pair(tmp_path_factory, _fill)


def _fill_plain(base):
    _put(base, "/plain", {"settings": {"number_of_shards": SHARDS,
                                       "number_of_replicas": 0,
                                       "refresh_interval": -1}})


@pytest.fixture(scope="module")
def plain_nodes(tmp_path_factory):
    """A node pair holding one index with no mapping at all."""
    yield from _node_pair(tmp_path_factory, _fill_plain)


def _shard_of(node, index, type_, doc_id) -> list[int]:
    """The shards whose engine holds the document (realtime get)."""
    svc = node.indices.index_service(index)
    return [s for s in range(SHARDS)
            if svc.shard(s).engine.get(type_, doc_id).found]


def _djb2_shard(key: str) -> int:
    from elasticsearch_tpu_torch.cluster.routing import djb2_hash

    return abs(djb2_hash(key)) % SHARDS


# ids whose own shard differs from their parent's: routing by id would put
# them elsewhere
PARENTED = [(i, p) for i, p in (("k1", "7"), ("k2", "x9"), ("k3", "p-3"), ("k4", "42"))
            if _djb2_shard(i) != _djb2_shard(p)]


def test_parent_param_routes_index_get_and_delete_as_the_jax_node(plain_nodes):
    """`PUT /plain/t/{id}?parent=P` (no `_parent` mapping) lands on P's shard
    on both nodes; GET and DELETE find it by `?parent=`; the client's GET
    answers `_parent`, REST's does not (on both), and a search over the
    index answers the same hits JSON."""
    pbase, jbase, p, j = plain_nodes
    assert len(PARENTED) >= 3
    for doc_id, parent in PARENTED:
        for base in (pbase, jbase):
            st, r = call(base, "PUT", f"/plain/t/{doc_id}?parent={parent}",
                         {"text": f"child of {parent} with some words"})
            assert st == 201, r
        want = [_djb2_shard(parent)]
        assert _shard_of(p, "plain", "t", doc_id) == _shard_of(j, "plain", "t", doc_id) \
            == want
        pg, jg = (call(b, "GET", f"/plain/t/{doc_id}?parent={parent}")
                  for b in (pbase, jbase))
        assert pg == jg and pg[0] == 200 and pg[1]["found"]
        assert "_parent" not in pg[1]
        pc = p.client().get("plain", "t", doc_id, parent=parent)
        jc = j.client().get("plain", "t", doc_id, parent=parent)
        assert pc == jc and pc["_parent"] == parent
    for base in (pbase, jbase):
        call(base, "POST", "/plain/_refresh")
    body = {"query": {"match": {"text": "child words"}}, "size": 10}
    pr, jr = (call(b, "POST", "/plain/_search", body) for b in (pbase, jbase))
    assert pr[0] == jr[0] == 200
    assert pr[1]["hits"] == jr[1]["hits"] and pr[1]["hits"]["total"] == len(PARENTED)
    assert pr[1]["_shards"] == jr[1]["_shards"]
    doc_id, parent = PARENTED[0]
    pd, jd = (call(b, "DELETE", f"/plain/t/{doc_id}?parent={parent}")
              for b in (pbase, jbase))
    assert pd == jd and pd[0] == 200 and pd[1]["found"]
    assert _shard_of(p, "plain", "t", doc_id) == _shard_of(j, "plain", "t", doc_id) == []


def test_parent_mapping_requires_routing_as_the_jax_node(nodes):
    """A type with `_parent` refuses a single-document write without a
    parent or routing (the `_parent` half of the routing check)."""
    pbase, jbase, _p, _j = nodes
    for method in ("PUT", "DELETE"):
        body = {"name": "orphan"} if method == "PUT" else None
        (pst, pr), (jst, jr) = (call(b, method, "/company/employee/orphan", body)
                                for b in (pbase, jbase))
        assert pst == jst == 400, (pr, jr)
        assert pr["error"]["type"] == jr["error"]["type"] == "routing_missing_exception" \
            or pr["error"]["reason"] == jr["error"]["reason"]
    # with routing it goes through, routed by it, on both
    for base in (pbase, jbase):
        st, r = call(base, "PUT", "/company/employee/routed?routing=paris",
                     {"name": "Routed Person"})
        assert st == 201, r


def test_get_of_a_child_answers_its_parent_on_both(nodes):
    _pbase, _jbase, p, j = nodes
    for eid, parent, _src in _employees([b for b, _ in _branches()])[:12]:
        pc = p.client().get("company", "employee", eid, parent=parent)
        jc = j.client().get("company", "employee", eid, parent=parent)
        assert pc == jc and pc["found"] and pc["_parent"] == parent


JOIN_BODIES = {
    "has_child_none": ("company", {"query": {"has_child": {
        "type": "employee", "query": {"match": {"hobby": "hiking"}}}}}),
    "has_child_sum": ("company", {"query": {"has_child": {
        "type": "employee", "score_mode": "sum",
        "query": {"match": {"hobby": "hiking golf"}}}}, "size": 20}),
    "has_child_max": ("company", {"query": {"has_child": {
        "type": "employee", "score_mode": "max",
        "query": {"match": {"name": "alice smith"}}}}, "size": 20}),
    "has_child_range": ("company", {"query": {"has_child": {
        "type": "employee", "query": {"range": {"dob": {"gte": "1980-01-01"}}}}}}),
    "has_parent_none": ("company", {"query": {"has_parent": {
        "parent_type": "branch", "query": {"term": {"country": "UK"}}}}, "size": 50}),
    "has_parent_score": ("company", {"query": {"has_parent": {
        "parent_type": "branch", "score_mode": "score",
        "query": {"match": {"name": "london branch"}}}}, "size": 50}),
    "top_children": ("company", {"query": {"top_children": {
        "type": "employee", "query": {"match": {"hobby": "chess"}}}}}),
    "has_child_in_bool": ("company", {"query": {"bool": {
        "must": [{"match": {"name": "branch"}}],
        "should": [{"has_child": {"type": "employee",
                                  "query": {"match": {"hobby": "golf"}}}}]}}}),
    "has_child_filter_post": ("company", {"query": {"match": {"name": "branch"}},
                                          "post_filter": {"has_child": {
        "type": "employee", "query": {"match": {"hobby": "sailing"}}}}}),
    "has_parent_filter_constant": ("company", {"query": {"constant_score": {
        "filter": {"has_parent": {"type": "branch",
                                  "filter": {"term": {"city": "paris"}}}}}}, "size": 30}),
    "dsl_has_child_filter": ("blogpc", {"query": {"constant_score": {"filter": {
        "has_child": {"type": "comment", "query": {"term": {"text": "great"}}}}}}}),
    "dsl_has_child_filter_body": ("blogpc", {"query": {"constant_score": {"filter": {
        "has_child": {"type": "comment", "filter": {"term": {"text": "meh"}}}}}}}),
    "dsl_has_parent_filter": ("blogpc", {"query": {"constant_score": {"filter": {
        "has_parent": {"parent_type": "blog", "query": {"term": {"title": "jax"}}}}}}}),
    "dsl_has_child_in_bool_filter": ("blogpc", {"query": {"constant_score": {"filter": {
        "bool": {"must": [{"has_child": {"type": "comment",
                                         "query": {"term": {"text": "great"}}}}],
                 "must_not": [{"term": {"title": "numpy"}}]}}}}}),
}
# bodies the dense family serves on both nodes (a join filter as a mask row);
# their query fields are in every segment (the JAX node's dense launch for a
# field a segment lacks compiles outside its compile tags)
DENSE = {
    "filtered_has_child": ("company", {"query": {"filtered": {
        "query": {"match": {"name": "branch london"}},
        "filter": {"has_child": {"type": "employee",
                                 "query": {"match": {"hobby": "hiking"}}}}}}}),
    "filtered_has_parent": ("company", {"query": {"filtered": {
        "query": {"match": {"name": "smith alice zoeson"}},
        "filter": {"has_parent": {"type": "branch",
                                  "query": {"term": {"country": "UK"}}}}}},
        "size": 30}),
}


@pytest.mark.parametrize("name", list(JOIN_BODIES))
def test_join_bodies_match_jax_node(nodes, name):
    pbase, jbase, _p, _j = nodes
    index, body = JOIN_BODIES[name]
    (pst, pr), (jst, jr) = (call(b, "POST", f"/{index}/_search", body)
                            for b in (pbase, jbase))
    assert pst == jst == 200, (pr, jr)
    assert pr["_shards"] == jr["_shards"]
    assert pr["hits"] == jr["hits"]
    assert pr["hits"]["total"] > 0 or name == "has_child_in_bool"


@pytest.mark.parametrize("name", list(DENSE))
def test_join_filters_on_the_dense_family_match_jax_node(nodes, name):
    from elasticsearch_tpu_torch.search.service import SERVING_COUNTERS

    pbase, jbase, _p, _j = nodes
    index, body = DENSE[name]
    before = SERVING_COUNTERS["device_filtered"]
    (pst, pr), (jst, jr) = (call(b, "POST", f"/{index}/_search", body)
                            for b in (pbase, jbase))
    assert pst == jst == 200, (pr, jr)
    assert SERVING_COUNTERS["device_filtered"] > before
    ph, jh = pr["hits"], jr["hits"]
    assert ph["total"] == jh["total"] > 0
    got = [(h["_score"], h["_id"]) for h in ph["hits"]]
    want = [(h["_score"], h["_id"]) for h in jh["hits"]]
    assert _tie_tolerant_equal(got, want)
    assert _within_ulps(ph["max_score"], jh["max_score"], 2)


def test_bulk_ignores_the_parent_on_both_nodes(nodes):
    """Kept behaviour of the JAX package: `_bulk` reads only `_routing` /
    `routing` from an action line, so a child indexed through it has no
    parent pointer (has_child never sees it) and is routed by its id."""
    pbase, jbase, p, j = nodes
    lines = []
    for i in range(6):
        lines.append({"index": {"_index": "company", "_type": "employee",
                                "_id": f"bulk{i}", "_parent": "paris"}})
        lines.append({"name": f"Bulk Person {i}", "hobby": "unicycling"})
    raw = "\n".join(json.dumps(x) for x in lines) + "\n"
    for base in (pbase, jbase):
        st, r = call(base, "POST", "/_bulk", raw=raw)
        assert st == 200 and not r["errors"], r
        call(base, "POST", "/company/_refresh")
    body = {"query": {"has_child": {"type": "employee",
                                    "query": {"match": {"hobby": "unicycling"}}}}}
    pr, jr = (call(b, "POST", "/company/_search", body) for b in (pbase, jbase))
    assert pr[0] == jr[0] == 200
    assert pr[1]["hits"] == jr[1]["hits"] and pr[1]["hits"]["total"] == 0
    flat = {"query": {"match": {"hobby": "unicycling"}}, "size": 10}
    pr, jr = (call(b, "POST", "/company/_search", flat) for b in (pbase, jbase))
    assert pr[1]["hits"] == jr[1]["hits"] and pr[1]["hits"]["total"] == 6
    for i in range(6):
        assert _shard_of(p, "company", "employee", f"bulk{i}") == \
            _shard_of(j, "company", "employee", f"bulk{i}") == [_djb2_shard(f"bulk{i}")]
        assert "_parent" not in p.client().get("company", "employee", f"bulk{i}")
        assert "_parent" not in j.client().get("company", "employee", f"bulk{i}")


# --- module against module ---------------------------------------------------


def _engines(tmp_path_factory, seed: int = 3):
    """Both packages' engines over the same parents and children in three
    segments, with a deleted parent and a deleted child."""
    from elasticsearch_tpu.mapper.core import MapperService as JMapperService
    from elasticsearch_tpu.index.engine import Engine as JEngine
    from elasticsearch_tpu_torch.index.engine import Engine as TEngine
    from elasticsearch_tpu_torch.mapper import MapperService as TMapperService

    rng = np.random.default_rng(seed)
    out = []
    for make_svc, make_eng, tag in ((JMapperService, JEngine, "j"),
                                    (TMapperService, TEngine, "t")):
        svc = make_svc()
        for t, m in BLOG_MAPPINGS.items():
            svc.put_mapping(t, m)
        out.append((svc, make_eng(str(tmp_path_factory.mktemp(f"pc_{tag}")), svc)))
    words = ["great", "meh", "nice", "read", "article", "bad", "jax", "tpu"]
    ops = []
    for i in range(30):
        ops.append(("blog", f"b{i}", {"title": " ".join(rng.choice(words, 3))}, None))
    for i in range(90):
        parent = f"b{int(rng.integers(0, 34))}"  # some parents do not exist
        ops.append(("comment", f"c{i}", {"text": " ".join(rng.choice(words, 4))}, parent))
    for _svc, eng in out:
        for n, (t, i, src, parent) in enumerate(ops):
            eng.index(t, i, src, parent=parent)
            if n in (40, 80):
                eng.refresh()
        eng.delete("blog", "b3")
        eng.delete("comment", "c7")
        eng.refresh()
    return out


@pytest.fixture(scope="module")
def engine_pair(tmp_path_factory):
    from elasticsearch_tpu.search import ShardContext as JShardContext
    from elasticsearch_tpu_torch.search import ShardContext

    (jsvc, jeng), (tsvc, teng) = _engines(tmp_path_factory)
    try:
        yield (JShardContext(jeng.acquire_searcher(), jsvc),
               ShardContext(teng.acquire_searcher(), tsvc, device="cpu"))
    finally:
        jeng.close()
        teng.close()


@pytest.mark.parametrize("spec", [
    {"has_child": {"type": "comment", "query": {"match": {"text": "great nice"}}}},
    {"has_child": {"type": "comment", "score_mode": "sum",
                   "query": {"match": {"text": "great nice"}}}},
    {"has_child": {"type": "comment", "score_mode": "max", "boost": 2.0,
                   "query": {"match": {"text": "read bad"}}}},
    {"has_parent": {"parent_type": "blog", "query": {"match": {"title": "jax tpu"}}}},
    {"has_parent": {"parent_type": "blog", "score_mode": "score",
                    "query": {"match": {"title": "jax article"}}}},
    {"top_children": {"type": "comment", "query": {"term": {"text": "meh"}}}},
], ids=["child_none", "child_sum", "child_max_boost", "parent_none", "parent_score",
        "top_children"])
def test_shard_join_matches_jax(engine_pair, spec):
    from elasticsearch_tpu.search import parse_query as jparse_query
    from elasticsearch_tpu.search.execute import _shard_join as jshard_join
    from elasticsearch_tpu_torch.search import parse_query
    from elasticsearch_tpu_torch.search.execute import _shard_join

    jctx, tctx = engine_pair
    want = jshard_join(jctx, jparse_query(spec))
    got = _shard_join(tctx, parse_query(spec))
    assert len(got) == len(want) == 3
    for (ts, tm), (js, jm) in zip(got, want):
        assert np.array_equal(tm, jm)
        assert ts.dtype == js.dtype and ts.tobytes() == js.tobytes()
    assert any(m.any() for _s, m in got)


@pytest.mark.parametrize("spec", [
    {"has_child": {"type": "comment", "query": {"term": {"text": "great"}}}},
    {"has_child": {"type": "comment", "filter": {"term": {"text": "meh"}}}},
    {"has_parent": {"parent_type": "blog", "query": {"term": {"title": "jax"}}}},
    {"bool": {"must": [{"has_child": {"type": "comment",
                                      "query": {"term": {"text": "great"}}}}],
              "must_not": [{"term": {"title": "nice"}}]}},
], ids=["has_child", "has_child_filter_body", "has_parent", "in_bool"])
def test_join_filter_masks_match_jax(engine_pair, spec):
    from elasticsearch_tpu.search.filters import segment_mask as jsegment_mask
    from elasticsearch_tpu.search.queries import parse_filter as jparse_filter
    from elasticsearch_tpu_torch.search.filters import segment_mask
    from elasticsearch_tpu_torch.search.queries import parse_filter

    jctx, tctx = engine_pair
    jf, tf = jparse_filter(spec), parse_filter(spec)
    assert not tf.cacheable()
    for jseg, tseg in zip(jctx.searcher.segments, tctx.searcher.segments):
        assert np.array_equal(segment_mask(tseg, tf, tctx), jsegment_mask(jseg, jf, jctx))


def test_has_child_filter_sees_new_children(tmp_path):
    """No stale per-segment cache: a child indexed into a later segment
    changes an earlier segment's mask, on both packages."""
    from elasticsearch_tpu.index.engine import Engine as JEngine
    from elasticsearch_tpu.mapper.core import MapperService as JMapperService
    from elasticsearch_tpu.search import ShardContext as JShardContext
    from elasticsearch_tpu.search.filters import segment_mask as jsegment_mask
    from elasticsearch_tpu.search.queries import parse_filter as jparse_filter
    from elasticsearch_tpu_torch.index.engine import Engine as TEngine
    from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
    from elasticsearch_tpu_torch.search import ShardContext
    from elasticsearch_tpu_torch.search.filters import segment_mask
    from elasticsearch_tpu_torch.search.queries import parse_filter

    spec = {"has_child": {"type": "comment", "query": {"term": {"text": "late"}}}}
    sides = ((JMapperService, JEngine, JShardContext, jparse_filter, jsegment_mask, {}),
             (TMapperService, TEngine, ShardContext, parse_filter, segment_mask,
              {"device": "cpu"}))
    masks = []
    for make_svc, make_eng, make_ctx, parse, mask_of, kw in sides:
        svc = make_svc()
        for t, m in BLOG_MAPPINGS.items():
            svc.put_mapping(t, m)
        eng = make_eng(str(tmp_path / make_eng.__module__), svc)
        try:
            eng.index("blog", "p1", {"title": "lonely"})
            eng.refresh()
            f = parse(spec)
            c1 = make_ctx(eng.acquire_searcher(), svc, **kw)
            first = [mask_of(s, f, c1).tolist() for s in c1.searcher.segments]
            eng.index("comment", "c9", {"text": "late arrival"}, parent="p1")
            eng.refresh()
            c2 = make_ctx(eng.acquire_searcher(), svc, **kw)
            masks.append((first, [mask_of(s, f, c2).tolist() for s in c2.searcher.segments]))
        finally:
            eng.close()
    assert masks[0] == masks[1] == ([[False]], [[True], [False]])


def test_translog_replay_drops_the_parent_pointer_on_both(tmp_path):
    """Kept behaviour of the JAX package: the translog logs a child's parent
    but the replay does not pass it on, so a child recovered from the
    translog (not from a flushed segment) has no `_parent` and has_child no
    longer finds its parent."""
    from elasticsearch_tpu.index.engine import Engine as JEngine
    from elasticsearch_tpu.mapper.core import MapperService as JMapperService
    from elasticsearch_tpu.search import ShardContext as JShardContext
    from elasticsearch_tpu.search import parse_query as jparse_query
    from elasticsearch_tpu.search import search_shard as jsearch_shard
    from elasticsearch_tpu_torch.index.engine import Engine as TEngine
    from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
    from elasticsearch_tpu_torch.search import ShardContext, parse_query, search_shard

    spec = {"has_child": {"type": "comment", "query": {"match_all": {}}}}
    sides = ((JMapperService, JEngine, JShardContext, jparse_query, jsearch_shard, {}),
             (TMapperService, TEngine, ShardContext, parse_query, search_shard,
              {"device": "cpu"}))
    seen = []
    for make_svc, make_eng, make_ctx, parse, search, kw in sides:
        path = str(tmp_path / make_eng.__module__)
        svc = make_svc()
        for t, m in BLOG_MAPPINGS.items():
            svc.put_mapping(t, m)
        eng = make_eng(path, svc)
        eng.index("blog", "p1", {"title": "post"})
        eng.flush()
        eng.index("comment", "c1", {"text": "reply"}, parent="p1")
        eng.refresh()
        before = search(make_ctx(eng.acquire_searcher(), svc, **kw), parse(spec), 10,
                        use_device=False).total
        parent_before = eng.get("comment", "c1").parent
        eng.translog.sync()
        eng.close()
        eng = make_eng(path, svc)
        try:
            eng.recover_from_store()
            after = search(make_ctx(eng.acquire_searcher(), svc, **kw), parse(spec), 10,
                           use_device=False).total
            seen.append((before, parent_before, after, eng.get("comment", "c1").found,
                         eng.get("comment", "c1").parent))
        finally:
            eng.close()
    assert seen[0] == seen[1] == (1, "p1", 0, True, None)
