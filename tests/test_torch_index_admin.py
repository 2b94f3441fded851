"""Index administration on a port node against a JAX node, both over real
HTTP (`start_http(0)`, urllib), one process, each package on its own
in-process transport (booted as `tests/test_torch_node.py` boots them).

- The write-consistency check (fault C9): after `number_of_replicas` is
  raised over `_settings`, the single-document PUT, `_create` and
  `_update`'s index round trip answer the JAX node's status and JSON (503
  UnavailableShardsException once a quorum of copies cannot be active on
  one node), and a `_bulk` item is not checked, on either node.
- Every (method, route) pair of index administration: the same request,
  on an index of its own (a mapping, two documents, an alias, a warmer, a
  template), answers the same status and JSON on both nodes, and the
  cluster's aliases, templates, warmers and settings read the same after
  it.
- The JAX package's own cases of the slice, step by step, port node
  against JAX node: `tests/test_rest.py` `test_mapping_settings_aliases`,
  `test_analyze_api` and the `_validate` half of
  `test_validate_and_explain`; `tests/test_cluster.py`
  `test_filtered_alias_and_template` and `test_warmers_registered_and_run`;
  the REST half of `tests/test_caching.py`
  `test_writes_invalidate_and_clear_drains_breaker`.
- The port's own: `_close` refuses reads and writes and `_open` restores
  the count and hits; `_mapping/field`; `_gateway/snapshot`, then a
  restart over `path.data` that keeps the templates and a closed index
  closed; a deleted and recreated index serves none of the old documents
  from disk, the request cache or the filter cache, even to a query phase
  held across the delete and the recreation; a filtered alias is
  never served the unfiltered body's cached partial; a delete leaves no
  engine, percolator registry, `PACK_LEDGER` entry, cache bytes or data
  directory, and a close no engine or cache bytes; a refresh runs a
  registered warmer through the batcher and logs a failing one.
- Behaviours kept from the JAX node (ROADMAP, "Kept behaviours"), on both
  nodes: an alias's routing values are stored but not read; the search
  warmers run on an explicit refresh only; `_validate/query` parses without
  the index; `_gateway/snapshot` answers zero `_shards`; `_analyze` types
  every token `<ALPHANUM>`; a `_bulk` item naming an alias creates an index
  of that name; a `refresh_interval` set over `_settings` does not reach
  the live shards; a template carries no warmers; a closed index restored
  from `path.data` has no routing and no block.
"""

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from elasticsearch_tpu_torch.node import Node as PNode
from elasticsearch_tpu_torch.ops.device_index import PACK_LEDGER, pack_cache_key
from elasticsearch_tpu_torch.rest import controller as tcontroller
from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry as PReg


def call(base, method, path, body=None, raw=None):
    """(status, parsed JSON or None for an empty body)."""
    if raw is not None:
        data, ctype = raw.encode(), "application/x-ndjson"
    else:
        data = None if body is None else json.dumps(body).encode()
        ctype = "application/json"
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            payload = resp.read()
            status = resp.status
    except urllib.error.HTTPError as e:
        payload, status = e.read(), e.code
    return status, (json.loads(payload) if payload else None)


def _strip(r):
    """A response without its wall-clock `took` (a search's, a bulk's, each
    of an `_msearch`'s)."""
    if isinstance(r, dict):
        return {k: ([_strip(x) for x in v] if k == "responses" else v)
                for k, v in r.items() if k != "took"}
    return r


def both(pair, method, path, body=None, raw=None):
    """The same request to both nodes; their statuses and JSON must agree.
    Returns the port node's (status, JSON)."""
    pbase, jbase = pair["port"], pair["jax"]
    p = call(pbase, method, path, body, raw)
    j = call(jbase, method, path, body, raw)
    assert (p[0], _strip(p[1])) == (j[0], _strip(j[1])), (method, path, p, j)
    return p


def both_concurrently(pair, requests):
    """Each (method, path, body) of `requests` at once, to each node at
    once; statuses and JSON must agree request by request. A JAX node
    answers a write it refuses for too few active copies after its 10 s
    retry window, so the refused writes of a case overlap."""
    out = {}

    def run(tag, base, i, method, path, body):
        out[(tag, i)] = call(base, method, path, body)

    threads = [threading.Thread(target=run, args=(tag, pair[tag], i, *r))
               for tag in ("port", "jax") for i, r in enumerate(requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    got = []
    for i, r in enumerate(requests):
        p, j = out[("port", i)], out[("jax", i)]
        assert (p[0], _strip(p[1])) == (j[0], _strip(j[1])), (r, p, j)
        got.append(p)
    return got


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A port node and a JAX node: {"port", "jax"} base URLs, the nodes
    ("pnode", "jnode") and their data paths."""
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu.transport.local import LocalTransportRegistry as JReg

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ppath = str(tmp_path_factory.mktemp("port_admin"))
    jpath = str(tmp_path_factory.mktemp("jax_admin"))
    p = PNode(name="port", settings={"node.device": "cpu"}, registry=PReg(),
              data_path=ppath).start()
    j = JNode(name="jax", settings={"search.mesh.enabled": "false",
                                    "indices.warmer.enabled": "false"},
              registry=JReg(), data_path=jpath)
    try:
        j.start([j.local_node.transport_address])
        j.wait_for_master()
        yield {"port": f"http://127.0.0.1:{p.start_http(0).port}",
               "jax": f"http://127.0.0.1:{j.start_http(0).port}",
               "pnode": p, "jnode": j, "ppath": ppath, "jpath": jpath}
    finally:
        p.close()
        j.close()
        torch.set_num_threads(threads)


MAPPING = {"doc": {"properties": {
    "body": {"type": "string"},
    "tag": {"type": "string", "index": "not_analyzed"},
    "n": {"type": "integer"},
    "meta": {"type": "object", "path": "just_name", "properties": {
        "label": {"type": "string", "index_name": "lbl"}}}}}}


def _make_index(pair, name, shards=1, replicas=0, docs=2, mappings=MAPPING,
                extra=None):
    body = {"settings": {"number_of_shards": shards, "number_of_replicas": replicas,
                         "refresh_interval": -1}, "mappings": mappings}
    body.update(extra or {})
    assert both(pair, "PUT", f"/{name}", body)[0] == 200
    for i in range(docs):
        assert both(pair, "PUT", f"/{name}/doc/{i}",
                    {"body": f"alpha beta{i % 3}", "tag": f"t{i % 2}", "n": i})[0] == 201
    assert both(pair, "POST", f"/{name}/_refresh")[0] == 200


HOT = {"query": {"match": {"body": "alpha"}}, "size": 0,
       "aggs": {"m": {"max": {"field": "n"}}}}
FILTERED = {"query": {"filtered": {"query": {"match": {"body": "alpha"}},
                                   "filter": {"term": {"tag": "t1"}}}},
            "size": 8}


def test_writes_invalidate_and_clear_drains_breaker(pair):
    """The REST half of tests/test_caching.py::
    test_writes_invalidate_and_clear_drains_breaker, on both nodes. It runs
    first on the pair: the JAX node keeps a deleted index's request-cache
    entries and filter masks (the port releases them), so the node-wide
    zeros it asserts hold only before any delete."""
    both(pair, "PUT", "/hot", {"settings": {"number_of_shards": 1,
                                            "number_of_replicas": 0}})
    lines = []
    for i in range(60):
        lines += [json.dumps({"index": {"_index": "hot", "_type": "doc", "_id": str(i)}}),
                  json.dumps({"body": f"alpha beta{i % 4}", "n": i, "tag": f"t{i % 3}"})]
    both(pair, "POST", "/_bulk", raw="\n".join(lines) + "\n")
    both(pair, "POST", "/hot/_refresh")
    nodes = (pair["pnode"], pair["jnode"])
    before = [n.request_cache.stats() for n in nodes]
    assert both(pair, "POST", "/hot/_search", HOT)[1]["hits"]["total"] == 60
    assert both(pair, "POST", "/hot/_search", HOT)[1]["hits"]["total"] == 60
    for n, b in zip(nodes, before):
        st = n.request_cache.stats()
        assert st["hits"] > b["hits"] and st["stores"] > b["stores"]
    both(pair, "POST", "/_bulk", raw=json.dumps(
        {"index": {"_index": "hot", "_type": "doc", "_id": "new1"}}) + "\n" + json.dumps(
        {"body": "alpha fresh", "n": 100, "tag": "t9"}) + "\n")
    both(pair, "POST", "/hot/_refresh")
    r3 = both(pair, "POST", "/hot/_search", HOT)[1]
    assert r3["hits"]["total"] == 61, "stale cached partial served"
    assert r3["aggregations"]["m"]["value"] == 100.0
    both(pair, "POST", "/hot/_search", HOT)
    for _ in range(3):
        both(pair, "POST", "/hot/_search", FILTERED)
    for n in nodes:
        assert n.breakers.breaker("request").used > 0
    st, r = both(pair, "POST", "/hot/_cache/clear?request=true&filter=true")
    assert st == 200 and r["_shards"]["successful"] >= 1
    for n in nodes:
        assert n.request_cache.stats()["memory_size_in_bytes"] == 0
        assert n.filter_cache.stats()["memory_size_in_bytes"] == 0
        assert n.breakers.breaker("request").used == 0
        assert n.breakers.breaker("fielddata").used == 0
    assert both(pair, "POST", "/hot/_search", HOT)[1]["hits"]["total"] == 61
    both(pair, "DELETE", "/hot")


# ------------------------------------------------------------------ C9


@pytest.mark.parametrize("replicas", [0, 1, 2])
def test_write_consistency_matches_jax_node(pair, replicas):
    """A single-document PUT, `_create` and `_update`'s index round trip on
    an index with `replicas` replicas: 503 on both nodes when a quorum (2
    of 3 copies) cannot be active on one node, 201/200 otherwise; a `_bulk`
    item is never checked (the document `_update` reads is bulked). Before
    the repair the port answered 201 where the JAX node answers 503."""
    name = f"wc{replicas}"
    both(pair, "PUT", f"/{name}", {"settings": {"number_of_shards": 1,
                                                "number_of_replicas": replicas}})
    bulk = json.dumps({"index": {"_index": name, "_type": "doc", "_id": "0"}}) \
        + "\n" + json.dumps({"body": "bulked"}) + "\n"
    st, r = both(pair, "POST", "/_bulk", raw=bulk)
    assert st == 200 and r["items"][0]["index"]["status"] == 201, r
    got = both_concurrently(pair, [
        ("PUT", f"/{name}/doc/5", {"body": "put"}),
        ("PUT", f"/{name}/doc/6/_create", {"body": "create"}),
        ("POST", f"/{name}/doc/0/_update", {"doc": {"body": "updated"}})])
    expected = [503, 503, 503] if replicas == 2 else [201, 201, 200]
    assert [s for s, _ in got] == expected, got
    if replicas == 2:
        assert got[0][1]["error"]["type"] == "UnavailableShardsException"
    both(pair, "DELETE", f"/{name}")


# ------------------------------------------------------------------ routes

# the (methods, route) pairs of index administration: the rows the port's
# table of later slices held before this slice served them
A6D_ROUTES = [
    ("DELETE,HEAD", "/{index}"), ("HEAD", "/{index}/{type}"),
    ("POST", "/{index}/_open"), ("POST", "/{index}/_close"),
    ("GET", "/_mapping/field/{field}"), ("GET", "/{index}/_mapping/field/{field}"),
    ("GET", "/_mapping/{type}/field/{field}"),
    ("GET", "/{index}/_mapping/{type}/field/{field}"),
    ("PUT,GET", "/{index}/_settings"), ("PUT,GET", "/_settings"),
    ("GET", "/{index}/_settings/{name}"), ("GET", "/_settings/{name}"),
    ("POST,GET", "/_aliases"), ("GET", "/{index}/_aliases"),
    ("PUT,POST,DELETE,GET,HEAD", "/{index}/_alias/{name}"),
    ("PUT,POST,GET,HEAD", "/_alias/{name}"),
    ("PUT,POST,DELETE,GET", "/{index}/_aliases/{name}"),
    ("PUT,POST,GET", "/_aliases/{name}"), ("GET", "/_alias"),
    ("GET,HEAD", "/{index}/_alias"),
    ("PUT,POST,DELETE,GET", "/_template/{name}"), ("GET", "/_template"),
    ("PUT,POST,GET", "/_warmer/{name}"),
    ("PUT,POST,DELETE,GET", "/{index}/_warmer/{name}"),
    ("PUT,POST,GET", "/{index}/{type}/_warmer/{name}"),
    ("PUT,POST", "/_warmers/{name}"), ("PUT,POST,DELETE", "/{index}/_warmers/{name}"),
    ("PUT,POST", "/{index}/{type}/_warmers/{name}"),
    ("GET", "/_warmer"), ("GET", "/{index}/_warmer"),
    ("GET,POST", "/_validate/query"), ("GET,POST", "/{index}/_validate/query"),
    ("GET,POST", "/_analyze"), ("GET,POST", "/{index}/_analyze"),
    ("POST", "/_cache/clear"), ("POST", "/{index}/_cache/clear"),
    ("POST", "/_gateway/snapshot"), ("POST", "/{index}/_gateway/snapshot"),
]
ROUTES = [(m, t) for methods, t in A6D_ROUTES for m in methods.split(",")]


def test_a6d_routes_are_served_and_no_longer_refused():
    assert len(ROUTES) == len(set(ROUTES)) == 73
    # the table of later slices is gone: a port node serves every JAX route
    assert not hasattr(tcontroller, "_LATER_ROUTES")


def _route_request(method, template, i):
    """The path and body a route case sends, on its index `c<i>` (alias
    `a<i>`, warmer `w<i>`, template `t<i>`, field `body`)."""
    if "_template" in template:
        name = f"t{i}"
    elif "_warmer" in template:
        name = f"w{i}"
    elif "_settings" in template:
        name = "index.number_of_*"
    else:
        name = f"a{i}"
    path = (template.replace("{index}", f"c{i}").replace("{type}", "doc")
            .replace("{field}", "body").replace("{name}", name))
    body = None
    if method in ("PUT", "POST"):
        if "_settings" in template:
            body = {"settings": {"index.refresh_interval": "-1"}}
        elif template == "/_aliases":
            body = {"actions": [
                {"add": {"index": f"c{i}", "alias": f"b{i}",
                         "filter": {"term": {"tag": "t1"}}}},
                {"remove": {"index": f"c{i}", "alias": f"a{i}"}}]}
        elif "_alias" in template:
            body = {"filter": {"term": {"tag": "t0"}}, "routing": "1"}
        elif "_template" in template:
            body = {"template": f"tpl{i}-*", "order": 1,
                    "settings": {"number_of_shards": 1},
                    "mappings": {"doc": {"properties": {"level": {
                        "type": "string", "index": "not_analyzed"}}}},
                    "aliases": {f"tal{i}": {}}}
        elif "_warmer" in template:
            body = {"query": {"match": {"body": "alpha"}}}
    if "_validate" in template:
        body = {"query": {"match": {"body": "alpha"}}}
    if "_analyze" in template:
        body = {"text": "Quick Brown-Foxes 42"}
        body.update({"field": "body"} if "{index}" in template
                    else {"analyzer": "standard"})
    return path, body


@pytest.mark.parametrize("method,template", ROUTES,
                         ids=[f"{m} {t}" for m, t in ROUTES])
def test_route_answers_as_the_jax_node(pair, method, template):
    """One index of its own a case; after the request the aliases,
    templates, warmers and settings of the cluster read the same."""
    i = ROUTES.index((method, template))
    _make_index(pair, f"c{i}", extra={
        "aliases": {f"a{i}": {"filter": {"term": {"tag": "t1"}}}},
        "warmers": {f"w{i}": {"query": {"match_all": {}}}}})
    both(pair, "PUT", f"/_template/t{i}", {"template": f"zz{i}-*",
                                           "settings": {"number_of_shards": 2}})
    if template == "/{index}/_open":
        both(pair, "POST", f"/c{i}/_close")
    path, body = _route_request(method, template, i)
    both(pair, method, path, body)
    for probe in ("/_aliases", "/_template", "/_warmer", "/_settings"):
        both(pair, "GET", probe)
    if template in ("/{index}/_close", "/{index}/_open"):
        both(pair, "GET", f"/c{i}/_count")
        both(pair, "PUT", f"/c{i}/doc/7", {"body": "late"})
    both(pair, "DELETE", f"/c{i}")
    both(pair, "DELETE", f"/_template/t{i}")


# ------------------------------------------------------------------ JAX cases


def test_mapping_settings_aliases(pair):
    """tests/test_rest.py::test_mapping_settings_aliases, step by step."""
    both(pair, "PUT", "/meta1", {"settings": {"number_of_shards": 1,
                                              "number_of_replicas": 0}})
    st, _ = both(pair, "PUT", "/meta1/typ/_mapping", {
        "typ": {"properties": {"tag": {"type": "string", "index": "not_analyzed"}}}})
    assert st == 200
    st, body = both(pair, "GET", "/meta1/_mapping")
    assert body["meta1"]["mappings"]["typ"]["properties"]["tag"]["type"] == "string"
    assert both(pair, "PUT", "/meta1/_alias/m1")[0] == 200
    assert "m1" in both(pair, "GET", "/_aliases")[1]["meta1"]["aliases"]
    assert both(pair, "PUT", "/meta1/typ/1", {"tag": "x"})[0] == 201
    both(pair, "POST", "/meta1/_refresh")
    assert both(pair, "GET", "/m1/_search")[1]["hits"]["total"] == 1
    st, _ = both(pair, "PUT", "/meta1/_settings",
                 {"settings": {"number_of_replicas": 2}})
    assert st == 200
    st, body = both(pair, "GET", "/meta1/_settings")
    assert str(body["meta1"]["settings"]["index"]["number_of_replicas"]) == "2"
    st, body = both(pair, "PUT", "/meta1/typ/2", {"tag": "y"})
    assert st == 503, body  # a quorum (2 of 3) cannot be active on one node
    both(pair, "DELETE", "/meta1")


def test_analyze_api(pair):
    """tests/test_rest.py::test_analyze_api, and the other forms."""
    st, body = both(pair, "GET", "/_analyze?text=Quick+Brown+Foxes&analyzer=standard")
    assert [t["token"] for t in body["tokens"]] == ["quick", "brown", "foxes"]
    both(pair, "GET", "/_analyze?text=Quick+Brown+Foxes&analyzer=english")
    both(pair, "POST", "/_analyze", {"text": "The Quick foxes", "tokenizer": "whitespace",
                                     "filters": ["lowercase", "stop"]})
    both(pair, "POST", "/_analyze", {"text": "x", "analyzer": "nope"})
    both(pair, "POST", "/_analyze", {"text": "x", "tokenizer": "nope"})
    _make_index(pair, "an1", extra={"settings": {
        "number_of_shards": 1, "number_of_replicas": 0,
        "analysis": {"analyzer": {"folded": {"type": "custom",
                                             "tokenizer": "standard",
                                             "filter": ["lowercase", "asciifolding"]}}}}})
    for q in ("?text=Caf%C3%A9+Bar&analyzer=folded", "?text=Big+Tag&field=tag",
              "?text=Big+Body&field=body", "?text=Big+Body"):
        both(pair, "GET", "/an1/_analyze" + q)
    both(pair, "DELETE", "/an1")


def test_validate_half_of_validate_and_explain(pair):
    """The `_validate` half of tests/test_rest.py::test_validate_and_explain
    (its index `lib` exists on neither node: the query is parsed without
    it, a kept behaviour)."""
    st, body = both(pair, "POST", "/lib/_validate/query",
                    {"query": {"match": {"title": "x"}}})
    assert st == 200 and body["valid"] is True
    assert body["_shards"]["total"] == 1
    st, body = both(pair, "POST", "/lib/_validate/query", {"query": {"nope": {}}})
    assert body["valid"] is False


def test_filtered_alias_and_template(pair):
    """tests/test_cluster.py::test_filtered_alias_and_template over REST."""
    both(pair, "PUT", "/_template/logs_tpl", {
        "template": "logs-*",
        "settings": {"number_of_shards": 1, "number_of_replicas": 0},
        "mappings": {"event": {"properties": {"level": {
            "type": "string", "index": "not_analyzed"}}}}})
    both(pair, "PUT", "/logs-2014")
    both(pair, "GET", "/_cluster/health?wait_for_status=green")
    st, body = both(pair, "GET", "/logs-2014/_settings")
    assert body["logs-2014"]["settings"]["index"]["number_of_shards"] == "1"
    st, body = both(pair, "GET", "/logs-2014/_mapping")
    assert "level" in body["logs-2014"]["mappings"]["event"]["properties"]
    both(pair, "PUT", "/logs-2014/event/1", {"level": "error", "msg": "boom"})
    both(pair, "PUT", "/logs-2014/event/2", {"level": "info", "msg": "fine"})
    both(pair, "POST", "/_aliases", {"actions": [
        {"add": {"index": "logs-2014", "alias": "errors",
                 "filter": {"term": {"level": "error"}}}}]})
    both(pair, "POST", "/_refresh")
    st, r = both(pair, "POST", "/errors/_search", {"query": {"match_all": {}}})
    assert r["hits"]["total"] == 1
    assert r["hits"]["hits"][0]["_source"]["level"] == "error"
    both(pair, "DELETE", "/logs-2014")
    both(pair, "DELETE", "/_template/logs_tpl")


def test_warmers_registered_and_run(pair):
    """tests/test_cluster.py::test_warmers_registered_and_run over REST."""
    both(pair, "PUT", "/w", {"settings": {"number_of_shards": 1,
                                          "number_of_replicas": 0}})
    both(pair, "GET", "/_cluster/health?wait_for_status=green")
    both(pair, "PUT", "/w/_warmer/warm1", {"query": {"match_all": {}}})
    assert "warm1" in both(pair, "GET", "/w/_warmer")[1]["w"]["warmers"]
    both(pair, "PUT", "/w/d/1", {"a": "x"})
    assert both(pair, "POST", "/w/_refresh")[0] == 200  # runs the warmer
    both(pair, "DELETE", "/w/_warmer/warm1")
    assert both(pair, "GET", "/w/_warmer")[1]["w"]["warmers"] == {}
    both(pair, "DELETE", "/w/_warmer/warm1")  # nothing left: 404 on both
    both(pair, "DELETE", "/w")


# ------------------------------------------------------------------ port's own


def test_close_refuses_reads_and_writes_and_open_restores(pair):
    _make_index(pair, "cl", shards=2, docs=12)
    body = {"query": {"match": {"body": "alpha"}}, "size": 20}
    count0 = both(pair, "GET", "/cl/_count")[1]["count"]
    hits0 = both(pair, "POST", "/cl/_search", body)[1]["hits"]
    assert count0 == 12
    both(pair, "POST", "/cl/_close")
    assert pair["pnode"].indices.indices["cl"].shards == {}
    for method, path, b in (("POST", "/cl/_search", body), ("GET", "/cl/_count", None),
                            ("GET", "/cl/doc/1", None), ("PUT", "/cl/doc/99", {"x": 1}),
                            ("POST", "/cl/doc/1/_update", {"doc": {"x": 2}}),
                            ("DELETE", "/cl/doc/1", None)):
        st, r = both(pair, method, path, b)
        assert st == 403 and r["error"]["type"] == "ClusterBlockException", (path, r)
    assert both(pair, "GET", "/cl/_settings")[0] == 200  # metadata stays readable
    both(pair, "POST", "/cl/_open")
    both(pair, "GET", "/_cluster/health?wait_for_status=yellow")
    assert both(pair, "GET", "/cl/_count")[1]["count"] == count0
    assert both(pair, "POST", "/cl/_search", body)[1]["hits"] == hits0
    both(pair, "DELETE", "/cl")


def test_field_mapping_forms(pair):
    _make_index(pair, "fm", docs=1)
    for path in ("/fm/_mapping/field/body", "/fm/_mapping/doc/field/body,tag",
                 "/_mapping/doc/field/n", "/fm/_mapping/field/lbl",
                 "/fm/_mapping/field/label", "/fm/_mapping/field/meta.label",
                 "/fm/_mapping/field/*", "/fm/_mapping/field/nope",
                 "/fm/_mapping/nope/field/body",
                 "/fm/_mapping/field/body?include_defaults=true"):
        both(pair, "GET", path)
    st, r = both(pair, "GET", "/fm/_mapping/field/lbl")
    assert r["fm"]["mappings"]["doc"]["lbl"]["full_name"] == "meta.label"
    assert both(pair, "GET", "/fm/_mapping/nope/field/body")[0] == 404
    both(pair, "DELETE", "/fm")


def test_gateway_snapshot_then_restart_keeps_templates_and_closed_index(pair, tmp_path):
    """`_gateway/snapshot` persists the metadata; each node restarted over
    its `path.data` keeps the template, the open index's documents, and
    the closed index closed (no routing, and no block: a kept behaviour,
    its search answers no shard)."""
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu.transport.local import LocalTransportRegistry as JReg

    nodes = {}
    bases = {}
    try:
        nodes["port"] = PNode(name="gw", settings={"node.device": "cpu"}, registry=PReg(),
                              data_path=str(tmp_path / "p")).start()
        nodes["jax"] = JNode(name="gw", settings={"search.mesh.enabled": "false",
                                                  "indices.warmer.enabled": "false"},
                             registry=JReg(), data_path=str(tmp_path / "j"))
        nodes["jax"].start([nodes["jax"].local_node.transport_address])
        nodes["jax"].wait_for_master()
        sub = {"port": None, "jax": None}
        for tag, n in nodes.items():
            sub[tag] = f"http://127.0.0.1:{n.start_http(0).port}"
        _make_index(sub, "open1", docs=3)
        _make_index(sub, "shut1", docs=2)
        both(sub, "PUT", "/_template/keep", {"template": "k-*", "order": 2,
                                             "settings": {"number_of_shards": 1}})
        both(sub, "POST", "/shut1/_close")
        assert both(sub, "POST", "/_gateway/snapshot")[1]["_shards"]["total"] == 0
        for n in nodes.values():
            n.close()
        nodes.clear()
        nodes["port"] = PNode(name="gw", settings={"node.device": "cpu"}, registry=PReg(),
                              data_path=str(tmp_path / "p")).start()
        nodes["jax"] = JNode(name="gw", settings={"search.mesh.enabled": "false",
                                                  "indices.warmer.enabled": "false"},
                             registry=JReg(), data_path=str(tmp_path / "j"))
        nodes["jax"].start([nodes["jax"].local_node.transport_address])
        nodes["jax"].wait_for_master()
        for tag, n in nodes.items():
            bases[tag] = f"http://127.0.0.1:{n.start_http(0).port}"
        both(bases, "GET", "/_cluster/health?wait_for_status=yellow")
        assert "keep" in both(bases, "GET", "/_template")[1]
        assert both(bases, "GET", "/open1/_count")[1]["count"] == 3
        st, r = both(bases, "POST", "/shut1/_search")
        assert st == 200 and r["_shards"]["total"] == 0
        assert nodes["port"].cluster_service.state.metadata.index("shut1").state == "close"
        assert "shut1" not in nodes["port"].indices.indices
    finally:
        for n in nodes.values():
            n.close()


def test_kept_templates_alone_do_not_survive_a_restart(tmp_path):
    """The gateway restores the templates only beside at least one index:
    a node whose `path.data` held templates and no index comes back
    without them, on both packages."""
    from elasticsearch_tpu.node import Node as JNode
    from elasticsearch_tpu.transport.local import LocalTransportRegistry as JReg

    def boot(tag):
        if tag == "port":
            return PNode(name="tpl", settings={"node.device": "cpu"}, registry=PReg(),
                         data_path=str(tmp_path / tag)).start()
        n = JNode(name="tpl", settings={"search.mesh.enabled": "false",
                                        "indices.warmer.enabled": "false"},
                  registry=JReg(), data_path=str(tmp_path / tag))
        n.start([n.local_node.transport_address])
        n.wait_for_master()
        return n

    nodes = {}
    try:
        for round_ in range(2):
            for tag in ("port", "jax"):
                nodes[tag] = boot(tag)
            bases = {tag: f"http://127.0.0.1:{n.start_http(0).port}"
                     for tag, n in nodes.items()}
            if round_ == 0:
                both(bases, "PUT", "/_template/lonely", {"template": "l-*"})
                assert both(bases, "POST", "/_gateway/snapshot")[0] == 200
            else:
                assert both(bases, "GET", "/_template")[1] == {}
            for n in nodes.values():
                n.close()
            nodes.clear()
    finally:
        for n in nodes.values():
            n.close()


def _port_index_holdings(p, name):
    """What a port node holds for an index: its engines' open shards, its
    percolator registry, its PACK_LEDGER entry, its request-cache entries
    and its data directory."""
    svc = p.indices.indices.get(name)
    rkeys = [k for k in p.request_cache._entries if k[0] == name]
    return {"shards": sorted(svc.shards) if svc else [],
            "percolator": name in p.percolator.registries,
            "ledger": bool(PACK_LEDGER.stats(name)),
            "request_cache": len(rkeys),
            "data": os.path.isdir(os.path.join(p.data_path, "indices", name))}


def _fill_caches(pair, name):
    # the query document carries the fields the bodies below read: a
    # segment without them would send the JAX node's dense launch through
    # a compile outside its tags
    both(pair, "PUT", f"/{name}/.percolator/q1", {"query": {"match": {"body": "alpha"}},
                                                  "body": "q", "tag": "t1", "n": 0})
    both(pair, "POST", f"/{name}/_refresh")
    for body in (FILTERED, FILTERED, FILTERED, HOT,
                 {"query": {"match": {"body": "alpha"}}, "size": 5}):
        both(pair, "POST", f"/{name}/_search", body)


def test_delete_and_close_release_what_the_index_held(pair):
    p = pair["pnode"]
    fbytes0 = p.filter_cache.stats()["memory_size_in_bytes"]
    for name, op in (("rel_del", "DELETE"), ("rel_close", "POST")):
        _make_index(pair, name, shards=2, docs=40)
        _fill_caches(pair, name)
        engines = [s.engine for s in p.indices.index_service(name).shards.values()]
        segs = [seg for e in engines for seg in e.acquire_searcher().segments]
        held = _port_index_holdings(p, name)
        assert held["shards"] == [0, 1] and held["percolator"] and held["ledger"]
        assert held["request_cache"] > 0 and held["data"], held
        assert p.filter_cache.stats()["memory_size_in_bytes"] > fbytes0
        assert any(pack_cache_key(p.device) in s._device_cache for s in segs)
        path = f"/{name}" if op == "DELETE" else f"/{name}/_close"
        assert both(pair, op, path)[0] == 200
        after = _port_index_holdings(p, name)
        assert after["shards"] == [] and after["request_cache"] == 0, after
        assert all(e.closed for e in engines)
        assert not any(pack_cache_key(p.device) in s._device_cache for s in segs)
        assert p.filter_cache.stats()["memory_size_in_bytes"] == fbytes0
        if op == "DELETE":
            assert not after["percolator"] and not after["ledger"] and not after["data"]
        else:
            assert after["data"]  # a closed index keeps its data
            both(pair, "DELETE", f"/{name}")
    assert p.breakers.breaker("fielddata").used == 0


def test_deleted_and_recreated_index_serves_nothing_old(pair):
    p = pair["pnode"]
    _make_index(pair, "again", shards=2, docs=30)
    _fill_caches(pair, "again")
    hits_before = p.request_cache.stats()["hits"]
    both(pair, "DELETE", "/again")
    both(pair, "PUT", "/again", {"settings": {"number_of_shards": 2,
                                              "number_of_replicas": 0,
                                              "refresh_interval": -1},
                                 "mappings": MAPPING})
    both(pair, "GET", "/_cluster/health?wait_for_status=green")
    for body in (HOT, FILTERED, FILTERED, FILTERED):
        st, r = both(pair, "POST", "/again/_search", body)
        assert r["hits"]["total"] == 0, r
    assert both(pair, "GET", "/again/_count")[1]["count"] == 0
    assert both(pair, "GET", "/again/doc/1")[0] == 404
    assert p.request_cache.stats()["hits"] == hits_before
    both(pair, "DELETE", "/again")


def test_query_phase_outliving_its_index_caches_nothing_the_new_one_reads(pair,
                                                                        monkeypatch):
    """A size-0 query phase held until its index was deleted, recreated
    with other documents and refreshed as often as the old one stores its
    partial under its own engine's view: the new index's same body misses
    and answers the new documents."""
    from elasticsearch_tpu_torch import actions as tactions

    p, base = pair["pnode"], pair["port"]
    _make_index(pair, "held", docs=30)
    entered, release = threading.Event(), threading.Event()
    real = tactions.execute_query_phase

    def held_once(ctx, req, **kw):
        result = real(ctx, req, **kw)
        if ctx.index_name == "held" and not entered.is_set():
            entered.set()
            release.wait(60)
        return result

    monkeypatch.setattr(tactions, "execute_query_phase", held_once)
    out = {}
    t = threading.Thread(target=lambda: out.update(r=call(base, "POST", "/held/_search",
                                                          HOT)))
    t.start()
    try:
        assert entered.wait(60)
        assert both(pair, "DELETE", "/held")[0] == 200
        _make_index(pair, "held", docs=3)
    finally:
        release.set()
        t.join(60)
    assert not t.is_alive() and "r" in out
    hits0 = p.request_cache.stats()["hits"]
    st, r = both(pair, "POST", "/held/_search", HOT)
    assert st == 200 and r["hits"]["total"] == 3, r
    assert r["aggregations"]["m"]["value"] == 2.0, r
    assert p.request_cache.stats()["hits"] == hits0
    both(pair, "DELETE", "/held")


def test_filtered_alias_is_not_served_the_unfiltered_cached_partial(pair):
    """A size-0 body is cached per shard view; the same body through a
    filtered alias is wrapped before its fingerprint, so it misses and
    answers the filtered counts."""
    _make_index(pair, "fa", shards=2, docs=30)
    both(pair, "POST", "/_aliases", {"actions": [{"add": {
        "index": "fa", "alias": "fa_t1", "filter": {"term": {"tag": "t1"}}}}]})
    body = {"query": {"match": {"body": "alpha"}}, "size": 0,
            "aggs": {"n": {"sum": {"field": "n"}}}}
    full = [both(pair, "POST", "/fa/_search", body)[1] for _ in range(2)]
    aliased = [both(pair, "POST", "/fa_t1/_search", body)[1] for _ in range(2)]
    assert full[0]["hits"]["total"] == 30 and aliased[0]["hits"]["total"] == 15
    assert aliased[1]["hits"] == aliased[0]["hits"]
    assert aliased[1]["aggregations"] == aliased[0]["aggregations"] \
        != full[0]["aggregations"]
    both(pair, "DELETE", "/fa")


def test_refresh_runs_a_warmer_through_the_batcher_and_logs_a_failing_one(pair):
    p = pair["pnode"]
    _make_index(pair, "wb", docs=4)
    both(pair, "POST", "/wb/_search", {"query": {"match": {"body": "alpha"}}})
    both(pair, "PUT", "/wb/_warmer/good", {"query": {"match": {"body": "alpha beta1"}}})
    both(pair, "PUT", "/wb/_warmer/bad", {"query": {"nope": {}}})
    launches0 = p.search_batcher.stats()["launches"]
    logger = logging.getLogger("estpu_torch.action")
    seen = []

    class _Catch(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    handler, level = _Catch(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG)
    try:
        both(pair, "PUT", "/wb/doc/9", {"body": "alpha fresh"})
        assert both(pair, "POST", "/wb/_refresh")[0] == 200
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    assert p.search_batcher.stats()["launches"] > launches0
    assert any("warmer [bad] failed" in m for m in seen), seen
    assert not any("warmer [good] failed" in m for m in seen), seen
    both(pair, "DELETE", "/wb")


# ------------------------------------------------------------------ kept


def test_kept_alias_routing_is_stored_but_not_read(pair):
    _make_index(pair, "ar", shards=2, docs=0)
    both(pair, "POST", "/_aliases", {"actions": [{"add": {
        "index": "ar", "alias": "ar_r", "routing": "1"}}]})
    assert both(pair, "GET", "/ar/_alias/ar_r")[1]["ar"]["aliases"]["ar_r"] == {
        "index_routing": "1", "search_routing": "1"}
    for i in range(6):
        both(pair, "PUT", f"/ar_r/doc/{i}", {"body": "alpha"})
    both(pair, "POST", "/ar/_refresh")
    # the documents land by their ids, and a search through the alias
    # reads both shards
    shard_counts = [both(pair, "GET", f"/ar/_count?preference=_shards:{s}")[1]["count"]
                    for s in (0, 1)]
    st, r = both(pair, "POST", "/ar_r/_search", {"size": 0})
    assert r["_shards"]["total"] == 2 and r["hits"]["total"] == 6
    by_shard = [both(pair, "POST", "/ar/_search?preference=_shards:{}".format(s),
                     {"size": 0})[1]["hits"]["total"] for s in (0, 1)]
    assert sum(by_shard) == 6 and min(by_shard) > 0, (by_shard, shard_counts)
    both(pair, "DELETE", "/ar")


def test_kept_warmers_and_settings_on_a_periodic_refresh(pair):
    """The search warmers run on an explicit refresh only, never on the
    periodic one; a `refresh_interval` set over `_settings` does not reach
    the live shards (each keeps the settings it was built with)."""
    calls = {"port": 0, "jax": 0}
    originals = {}
    for tag in ("port", "jax"):
        actions = pair["pnode" if tag == "port" else "jnode"].actions
        originals[tag] = actions._run_warmers

        def counting(index, shard_id, tag=tag):
            calls[tag] += 1
            return originals[tag](index, shard_id)

        actions._run_warmers = counting
    try:
        both(pair, "PUT", "/pr", {"settings": {"number_of_shards": 1,
                                               "number_of_replicas": 0,
                                               "refresh_interval": "200ms"},
                                  "warmers": {"w": {"query": {"match_all": {}}}}})
        both(pair, "PUT", "/frozen", {"settings": {"number_of_shards": 1,
                                                   "number_of_replicas": 0,
                                                   "refresh_interval": -1}})
        both(pair, "GET", "/_cluster/health?wait_for_status=green")
        both(pair, "PUT", "/frozen/_settings", {"settings": {"refresh_interval": "200ms"}})
        both(pair, "PUT", "/pr/doc/1", {"body": "alpha"})
        both(pair, "PUT", "/frozen/doc/1", {"body": "alpha"})
        deadline = time.monotonic() + 10
        for base in (pair["port"], pair["jax"]):
            while call(base, "GET", "/pr/_count")[1]["count"] < 1:
                assert time.monotonic() < deadline
                time.sleep(0.1)
        time.sleep(1.0)  # a few more ticks of the periodic refresh
        assert calls == {"port": 0, "jax": 0}
        assert both(pair, "GET", "/frozen/_count")[1]["count"] == 0
        both(pair, "PUT", "/pr/doc/2", {"body": "alpha"})
        both(pair, "POST", "/pr/_refresh")
        assert calls["port"] == calls["jax"] <= 1
    finally:
        for tag in ("port", "jax"):
            actions = pair["pnode" if tag == "port" else "jnode"].actions
            del actions._run_warmers
        both(pair, "DELETE", "/pr,frozen")


def test_kept_small_forms(pair):
    """`_gateway/snapshot` answers zero `_shards`; `_analyze` types every
    token `<ALPHANUM>`; a template carries no warmers; a `_bulk` item whose
    `_index` names an alias creates an index of that name."""
    assert both(pair, "POST", "/_gateway/snapshot")[1] == {
        "_shards": {"total": 0, "successful": 0, "failed": 0}}
    toks = both(pair, "POST", "/_analyze", {"text": "foo 42 bar@x.com 3.5",
                                            "analyzer": "standard"})[1]["tokens"]
    assert {t["type"] for t in toks} == {"<ALPHANUM>"}
    both(pair, "PUT", "/_template/nw", {"template": "nw-*", "order": 0,
                                        "settings": {"number_of_shards": 1},
                                        "warmers": {"w": {"query": {"match_all": {}}}}})
    both(pair, "PUT", "/nw-1")
    assert both(pair, "GET", "/nw-1/_warmer")[1] == {"nw-1": {"warmers": {}}}
    _make_index(pair, "real", docs=1)
    both(pair, "POST", "/_aliases", {"actions": [{"add": {"index": "real",
                                                          "alias": "via"}}]})
    bulk = json.dumps({"index": {"_index": "via", "_type": "doc", "_id": "b1"}}) \
        + "\n" + json.dumps({"body": "bulk"}) + "\n"
    st, r = both(pair, "POST", "/_bulk?refresh=true", raw=bulk)
    assert r["items"][0]["index"]["_index"] == "via"
    assert both(pair, "HEAD", "/via")[0] == 200
    assert both(pair, "GET", "/real/_count")[1]["count"] == 1
    both(pair, "DELETE", "/nw-1,real,via")
    both(pair, "DELETE", "/_template/nw")



def test_other_entry_points_resolve_aliases_as_the_jax_node(pair):
    """`_count` and `_msearch` through a filtered alias apply its filter;
    `_mget` and GET read through an alias; a delete-by-query through a
    filtered alias deletes the query's matches in the whole index (the
    filter is not applied, as on the JAX node); `_percolate` does not
    resolve aliases (404 on both)."""
    _make_index(pair, "ep", shards=2, docs=12)
    both(pair, "PUT", "/ep/.percolator/q1", {"query": {"match": {"body": "alpha"}},
                                             "body": "q", "tag": "t1", "n": 0})
    both(pair, "POST", "/_aliases", {"actions": [{"add": {
        "index": "ep", "alias": "ep_t1", "filter": {"term": {"tag": "t1"}}}}]})
    both(pair, "POST", "/ep/_refresh")
    assert both(pair, "GET", "/ep_t1/_count")[1]["count"] == 7
    both(pair, "POST", "/ep_t1/_count", {"query": {"match": {"body": "beta1"}}})
    msearch = "\n".join(json.dumps(x) for x in (
        {"index": "ep_t1"}, {"query": {"match": {"body": "alpha"}}},
        {"index": "ep"}, {"query": {"match": {"body": "alpha"}}})) + "\n"
    st, r = both(pair, "POST", "/_msearch", raw=msearch)
    assert [x["hits"]["total"] for x in r["responses"]] == [6, 12]
    both(pair, "POST", "/_mget", {"docs": [{"_index": "ep_t1", "_type": "doc", "_id": "1"},
                                           {"_index": "ep_t1", "_type": "doc", "_id": "2"}]})
    both(pair, "GET", "/ep_t1/doc/3")
    both(pair, "POST", "/ep_t1/doc/_percolate", {"doc": {"body": "alpha"}})
    st, r = both(pair, "DELETE", "/ep_t1/_query", {"query": {"match": {"body": "beta0"}}})
    both(pair, "POST", "/ep/_refresh")
    assert both(pair, "GET", "/ep/_count")[1]["count"] == 12 - 4 + 1
    both(pair, "DELETE", "/ep")


def test_close_and_delete_under_in_flight_searches(pair):
    """Searches racing a close, an open and a delete of their index answer
    (200, the shards that failed reported) or fail with the error the
    index's state gives, as the JAX node's routing and blocks give it (403
    closed, 503 no active copy while the reopened shards recover, 404
    missing); none answers 500, none hangs, and the node serves another
    index afterwards."""
    p = pair["port"]
    _make_index(pair, "race", shards=3, docs=60)
    _make_index(pair, "bystander", docs=10)
    body = {"query": {"match": {"body": "alpha beta1"}}, "size": 5}
    statuses, errors = [], []
    stop = threading.Event()

    def searcher():
        while not stop.is_set():
            st, r = call(p, "POST", "/race/_search", body)
            statuses.append(st)
            if st != 200:
                errors.append((st, r["error"]["type"], r["error"]["reason"][:120]))

    threads = [threading.Thread(target=searcher) for _ in range(6)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.3)
        assert call(p, "POST", "/race/_close")[0] == 200
        time.sleep(0.2)
        assert call(p, "POST", "/race/_open")[0] == 200
        time.sleep(0.3)
        assert call(p, "DELETE", "/race")[0] == 200
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert set(statuses) <= {200, 403, 404, 503} and 200 in statuses, sorted(set(errors))
    assert {e[1] for e in errors} <= {"ClusterBlockException", "IndexMissingException",
                                      "NoShardAvailableException"}, sorted(set(errors))
    assert 403 in statuses or 404 in statuses  # some search met the change
    st, r = call(p, "POST", "/bystander/_search", body)
    assert st == 200 and r["hits"]["total"] > 0
    assert pair["pnode"].search_batcher.stats()["queue"] == 0
    both(pair, "DELETE", "/bystander")


def test_indexing_memory_controller_refreshes_as_the_jax_node(pair):
    """`check_indexing_memory`: under a budget the buffers pass, the
    largest un-refreshed buffers are refreshed (their documents become
    searchable); under a large budget none is. Both nodes refresh the same
    shards."""
    _make_index(pair, "imc", shards=2, docs=0)
    for i in range(20):
        both(pair, "PUT", f"/imc/doc/{i}", {"body": f"alpha beta{i}", "n": i})
    nodes = (pair["pnode"], pair["jnode"])
    assert [n.indices.check_indexing_memory(1 << 30) for n in nodes] == [0, 0]
    assert both(pair, "GET", "/imc/_count")[1]["count"] == 0
    sizes = [sorted(s.engine.indexing_buffer_bytes()
                    for s in n.indices.index_service("imc").shards.values()) for n in nodes]
    assert sizes[0] == sizes[1] and min(sizes[0]) > 0, sizes
    assert [n.indices.check_indexing_memory(1) for n in nodes] == [2, 2]
    assert both(pair, "GET", "/imc/_count")[1]["count"] == 20
    both(pair, "DELETE", "/imc")
