"""The document APIs on a port Node against a JAX Node, both over real HTTP
(one process, each package on its own in-process transport; the JAX node
with its mesh and warmer off, every index at `refresh_interval: -1`).

- C8, repaired: `?timestamp=` on the single-document index is stored on
  the port as on the JAX node (before the repair the port stamped the wall
  clock): a `range` on `_timestamp` finds the same document, and GET
  `?fields=_timestamp` answers the same value.
- The document cases of tests/test_rest.py::test_document_crud_lifecycle
  and tests/test_cluster.py::test_update_and_bulk, step by step.
- Every route of the document APIs (`_create`, `_source` for GET and HEAD,
  `_update` with `doc`, `upsert`, `doc_as_upsert`, a script with `params`,
  `lang` and the query-parameter form, `ctx.op` `none` and `delete`,
  `ctx._timestamp`, `fields`, `_mget` at three levels in its `docs` and
  `ids` forms with `fields` and `_source` specs and its request-level
  defaults, GET `?fields=`, the bulk `update` op), their errors included
  (404 DocumentMissingException, 409, the `_mget` validation 400s, an
  unknown `lang`): the same status and JSON on both nodes at every step.
- Concurrent `_update`s of one document on both nodes: `views` equals the
  count of acknowledged increments; a `_bulk` of updates beside
  concurrent single `_update`s finishes (its round trips nest into the
  `get` and `index` pools from the `bulk` pool) and loses no increment.
- `UpdateScript` module against module: the same `ctx` after the same
  script, and the same refusals of the sandbox's escape attempts (a dunder
  chain, an attribute chain not rooted at `ctx`, a rebinding of `ctx` or
  of a builtin, a call outside the whitelist), which both nodes answer
  with the same 400.
- Named scripts (`ScriptService.put` / `remove`) resolve through
  `compile_script` on both packages alike."""

from __future__ import annotations

import copy
import threading
import urllib.error
import urllib.parse
import urllib.request

import pytest

from tests.test_torch_node import _node_pair, call

BLOG = {"properties": {"title": {"type": "string"}, "body": {"type": "string"},
                       "tags": {"type": "string", "index": "not_analyzed"},
                       "views": {"type": "integer"}}}
# a type whose documents are stamped: only explicit stamps are rendered
STAMPED = {"_timestamp": {"enabled": True}}
SETTINGS = {"number_of_shards": 2, "number_of_replicas": 0, "refresh_interval": -1}


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    def fill(base):
        st, r = call(base, "PUT", "/website", {"settings": SETTINGS,
                                               "mappings": {"blog": BLOG,
                                                            "stamped": STAMPED}})
        assert st == 200 and r["primaries_active"], r

    yield from _node_pair(tmp_path_factory, fill)


def _both(nodes, method, path, body=None, raw=None):
    """The same request to both nodes: equal status and JSON (`took`
    aside); returns (status, port JSON)."""
    pbase, jbase, _p = nodes
    (pst, pr), (jst, jr) = (call(b, method, path, body, raw) for b in (pbase, jbase))
    for r in (pr, jr):
        if isinstance(r, dict):
            r.pop("took", None)
    assert (pst, pr) == (jst, jr), (method, path, pr, jr)
    return pst, pr


def _head(base, path):
    req = urllib.request.Request(base + path, method="HEAD")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def test_timestamp_param_is_stored_as_on_the_jax_node(nodes):
    """C8: the probe (a `_timestamp` index, one document PUT with
    `?timestamp=2014-01-01T00:00:00`, one without, a `range` on
    `_timestamp` below 2015-01-01) finds document 1 alone on both nodes,
    and GET `?fields=_timestamp` answers its stamp."""
    _both(nodes, "PUT", "/ts", {"settings": SETTINGS,
                                "mappings": {"doc": {"_timestamp": {"enabled": True}}}})
    st, r = _both(nodes, "PUT", "/ts/doc/1?timestamp=2014-01-01T00:00:00", {"a": 1})
    assert st == 201
    _both(nodes, "PUT", "/ts/doc/2", {"a": 2})
    _both(nodes, "POST", "/ts/_refresh")
    st, r = _both(nodes, "POST", "/ts/_search", {"query": {"filtered": {
        "filter": {"range": {"_timestamp": {"lt": 1420070400000}}}}}})
    assert r["hits"]["total"] == 1 and [h["_id"] for h in r["hits"]["hits"]] == ["1"]
    st, r = _both(nodes, "GET", "/ts/doc/1?fields=_timestamp")
    assert r["fields"] == {"_timestamp": 1388534400000}
    # a `_create` carries it too
    _both(nodes, "PUT", "/ts/doc/3/_create?timestamp=2013-06-01", {"a": 3})
    st, r = _both(nodes, "GET", "/ts/doc/3?fields=_timestamp,_source")
    assert r["fields"] == {"_timestamp": 1370044800000} and r["_source"] == {"a": 3}


def test_document_crud_lifecycle_matches_jax_node(nodes):
    """tests/test_rest.py::test_document_crud_lifecycle on both nodes."""
    st, r = _both(nodes, "PUT", "/crud", {"settings": {"number_of_shards": 1,
                                                       "number_of_replicas": 0}})
    assert st == 200 and r["acknowledged"]
    st, r = _both(nodes, "PUT", "/crud/doc/1", {"title": "hello world", "views": 3})
    assert st == 201 and r["created"] and r["_version"] == 1
    st, r = _both(nodes, "GET", "/crud/doc/1")
    assert st == 200 and r["_source"]["title"] == "hello world"
    st, r = _both(nodes, "GET", "/crud/doc/1/_source")
    assert r == {"title": "hello world", "views": 3}
    st, r = _both(nodes, "PUT", "/crud/doc/1", {"title": "updated"})
    assert st == 200 and r["_version"] == 2
    st, r = _both(nodes, "POST", "/crud/doc/1/_update", {"doc": {"extra": True}})
    assert st == 200
    st, r = _both(nodes, "GET", "/crud/doc/1")
    assert r["_source"] == {"title": "updated", "extra": True}
    st, r = _both(nodes, "DELETE", "/crud/doc/1")
    assert st == 200 and r["found"]
    st, r = _both(nodes, "GET", "/crud/doc/1")
    assert st == 404 and not r["found"]
    st, r = _both(nodes, "PUT", "/crud/doc/2/_create", {"a": 1})
    assert st == 201
    st, r = _both(nodes, "PUT", "/crud/doc/2/_create", {"a": 2})
    assert st == 409


def test_update_and_bulk_matches_jax_node(nodes):
    """tests/test_cluster.py::test_update_and_bulk over REST on both nodes,
    and through the port's Client."""
    _both(nodes, "PUT", "/b", {"settings": {"number_of_shards": 1,
                                            "number_of_replicas": 0}})
    ndjson = "\n".join([
        '{"index": {"_index": "b", "_type": "d", "_id": "1"}}', '{"v": 1}',
        '{"index": {"_index": "b", "_type": "d", "_id": "2"}}', '{"v": 2}',
        '{"delete": {"_index": "b", "_type": "d", "_id": "2"}}']) + "\n"
    st, r = _both(nodes, "POST", "/_bulk?refresh=true", raw=ndjson)
    assert not r["errors"]
    st, r = _both(nodes, "GET", "/b/_count")
    assert r["count"] == 1
    _both(nodes, "POST", "/b/d/1/_update", {"doc": {"extra": "x"}})
    st, r = _both(nodes, "GET", "/b/d/1")
    assert r["_source"] == {"v": 1, "extra": "x"}
    client = nodes[2].client()
    r = client.update("b", "d", "1", {"doc": {"more": 2}}, fields="_source,more")
    assert r["get"] == {"found": True, "_source": {"v": 1, "extra": "x", "more": 2},
                        "fields": {"more": [2]}}
    assert client.get("b", "d", "1", fields="more") == {
        "_index": "b", "_type": "d", "_id": "1", "found": True, "_version": 3,
        "fields": {"more": [2]}}
    assert client.create("b", "d", {"v": 9}, id="9")["created"]
    assert client.mget([{"_index": "b", "_id": "9"}])["docs"][0]["_source"] == {"v": 9}


_Q = urllib.parse.quote
# each case: its steps, (method, path, body) or (method, path, None, NDJSON);
# each case writes documents of its own
A6C_CASES = {
    "create_new": [("PUT", "/website/blog/c1/_create", {"title": "fresh"}),
                   ("POST", "/website/blog/c1b/_create", {"title": "posted"}),
                   ("GET", "/website/blog/c1", None)],
    "create_taken": [("PUT", "/website/blog/c2", {"title": "first"}),
                     ("PUT", "/website/blog/c2/_create", {"title": "second"}),
                     ("PUT", "/website/blog/c2/_create?version=1", {"title": "third"}),
                     ("GET", "/website/blog/c2/_source", None)],
    "source": [("PUT", "/website/blog/s1", {"title": "a", "tags": ["x", "y"],
                                            "meta": {"a": 1, "b": 2}}),
               ("GET", "/website/blog/s1/_source", None),
               ("GET", "/website/blog/s1/_source?_source_include=title,meta.a", None),
               ("GET", "/website/blog/s1/_source?_source_exclude=meta", None),
               ("GET", "/website/blog/nothere/_source", None),
               ("GET", "/nothere/blog/s1/_source", None)],
    "update_doc_merge": [("PUT", "/website/blog/u1", {"title": "t", "meta": {"a": 1, "b": 2}}),
                         ("POST", "/website/blog/u1/_update",
                          {"doc": {"meta": {"b": 3, "c": [1]}, "x": 1}}),
                         ("GET", "/website/blog/u1", None)],
    "update_script_params": [("PUT", "/website/blog/u2", {"views": 1}),
                             ("POST", "/website/blog/u2/_update",
                              {"script": "ctx._source.views += n", "params": {"n": 5}}),
                             ("POST", "/website/blog/u2/_update",
                              {"script": "ctx._source.tags = ['hot'] if "
                                         "ctx._source.views > 3 else []",
                               "lang": "mvel"}),
                             ("GET", "/website/blog/u2", None)],
    "update_script_param_form": [
        ("PUT", "/website/blog/u3", {"views": 7}),
        ("POST", "/website/blog/u3/_update?script=" + _Q("ctx._source.views += 1")
         + "&lang=mvel", {}),
        ("GET", "/website/blog/u3?fields=views", None)],
    "update_upsert": [("POST", "/website/blog/u4/_update",
                       {"script": "ctx._source.views += 1", "upsert": {"views": 1}}),
                      ("POST", "/website/blog/u4/_update",
                       {"script": "ctx._source.views += 1", "upsert": {"views": 1}}),
                      ("GET", "/website/blog/u4", None)],
    "update_doc_as_upsert": [("POST", "/website/blog/u5/_update",
                              {"doc": {"title": "new"}, "doc_as_upsert": True}),
                             ("POST", "/website/blog/u5/_update",
                              {"doc": {"body": "more"}, "doc_as_upsert": True}),
                             ("GET", "/website/blog/u5", None)],
    "update_missing": [("POST", "/website/blog/u6/_update", {"doc": {"title": "x"}}),
                       ("POST", "/website/blog/u6/_update?version=2",
                        {"doc": {"title": "x"}, "upsert": {"title": "y"}})],
    "update_noop_and_delete": [("PUT", "/website/blog/u7", {"views": 1}),
                               ("POST", "/website/blog/u7/_update",
                                {"script": "ctx.op = 'none'"}),
                               ("GET", "/website/blog/u7", None),
                               ("POST", "/website/blog/u7/_update",
                                {"script": "ctx.op = 'delete'"}),
                               ("GET", "/website/blog/u7", None)],
    "update_version_conflict": [("PUT", "/website/blog/u8", {"views": 1}),
                                ("POST", "/website/blog/u8/_update?version=5",
                                 {"doc": {"views": 2}}),
                                ("POST", "/website/blog/u8/_update?version=1",
                                 {"doc": {"views": 2}}),
                                ("GET", "/website/blog/u8", None)],
    "update_fields": [("PUT", "/website/blog/u9?routing=r1", {"title": "t", "views": 2}),
                      ("POST", "/website/blog/u9/_update?fields=title,_source,_routing"
                               "&routing=r1", {"doc": {"views": 3}}),
                      ("POST", "/website/blog/u9/_update?fields=views&routing=r1",
                       {"script": "ctx._source.views *= 2"})],
    "update_bad_script": [("PUT", "/website/blog/u10", {"views": 1}),
                          ("POST", "/website/blog/u10/_update",
                           {"script": "ctx._source.views += 1", "lang": "groovy"}),
                          ("POST", "/website/blog/u10/_update",
                           {"script": "ctx._source.nothere += 1"}),
                          ("POST", "/website/blog/u10/_update", {"script": "ctx._source.("}),
                          ("GET", "/website/blog/u10", None)],
    "update_timestamp": [("PUT", "/website/stamped/u11", {"title": "stamped"}),
                         ("POST", "/website/stamped/u11/_update",
                          {"script": "ctx._timestamp = 1388534400000"}),
                         ("GET", "/website/stamped/u11?fields=_timestamp,title", None),
                         ("POST", "/website/stamped/u11/_update?timestamp=2012-01-01",
                          {"doc": {"title": "restamped"}}),
                         ("GET", "/website/stamped/u11?fields=_timestamp", None)],
    "mget_docs": [("PUT", "/website/blog/m1", {"title": "one", "views": 1}),
                  ("PUT", "/website/blog/m2", {"title": "two", "views": 2}),
                  ("POST", "/_mget", {"docs": [
                      {"_index": "website", "_type": "blog", "_id": "m1"},
                      {"_index": "website", "_id": "m2"},
                      {"_index": "website", "_type": "blog", "_id": "nothere"},
                      {"_index": "nothere", "_type": "blog", "_id": "m1"},
                      {"_index": "website", "_type": "other", "_id": "m1"}]})],
    "mget_ids_and_levels": [("PUT", "/website/blog/m3", {"title": "three"}),
                            ("PUT", "/website/blog/m4", {"title": "four"}),
                            ("POST", "/website/blog/_mget", {"ids": ["m3", "m4", "m9"]}),
                            ("GET", "/website/_mget", {"docs": [
                                {"_type": "blog", "_id": "m3"}, {"_id": "m4"}]}),
                            ("POST", "/_mget", {"index": "website", "type": "blog",
                                                "ids": ["m4"]})],
    "mget_fields_and_source": [
        ("PUT", "/website/blog/m5", {"title": "five", "views": 5, "meta": {"a": 1, "b": 2}}),
        ("POST", "/website/_mget", {"docs": [
            {"_type": "blog", "_id": "m5", "fields": ["title", "meta.a"]},
            {"_type": "blog", "_id": "m5", "fields": ["_source", "views"]},
            {"_type": "blog", "_id": "m5", "_source": False},
            {"_type": "blog", "_id": "m5", "_source": ["meta.*"]},
            {"_type": "blog", "_id": "m5", "_source": {"include": ["meta"],
                                                       "exclude": ["meta.b"]}}]}),
        ("POST", "/website/blog/_mget?fields=title", {"ids": ["m5"]}),
        ("POST", "/website/blog/_mget?_source=false", {"ids": ["m5"]}),
        ("POST", "/website/blog/_mget?_source=title,views", {"ids": ["m5"]}),
        ("POST", "/website/blog/_mget?_source_include=meta&_source_exclude=meta.a",
         {"ids": ["m5"]}),
        ("POST", "/website/blog/_mget?realtime=false&refresh=true", {"ids": ["m5"]})],
    "mget_validation": [("POST", "/_mget", {}), ("POST", "/_mget", {"docs": []}),
                        ("POST", "/website/_mget", {"docs": [{"_type": "blog"}]}),
                        ("POST", "/_mget", {"docs": [{"_id": "m1"}]})],
    "get_fields": [("PUT", "/website/blog/g1?routing=rr",
                    {"title": "quick", "views": 4, "meta": {"x": [1, 2]}}),
                   ("GET", "/website/blog/g1?fields=title,views&routing=rr", None),
                   ("GET", "/website/blog/g1?fields=_source,meta.x&routing=rr", None),
                   ("GET", "/website/blog/g1?fields=title&_source=true&routing=rr", None),
                   ("GET", "/website/blog/g1?fields=title&_source_include=views&_source=x"
                           "&routing=rr", None),
                   ("GET", "/website/blog/g1?fields=_routing,nothere&routing=rr", None),
                   ("GET", "/website/blog/g1?fields=title&_source=false&routing=rr", None)],
    "get_source_params": [
        ("PUT", "/website/blog/g2", {"title": "slow", "views": 6, "meta": {"a": 1, "b": 2}}),
        ("GET", "/website/blog/g2?_source=title,meta.a", None),
        ("GET", "/website/blog/g2?_source_include=meta&_source_exclude=meta.b", None),
        ("GET", "/website/blog/g2?_source=true&_source_exclude=meta", None),
        ("GET", "/website/blog/g2?_source=meta&_source_exclude=meta.a", None),
        ("GET", "/website/blog/g2?_source=FALSE", None),
        ("GET", "/website/blog/g2?fields=title&_source_exclude=title", None),
        ("GET", "/website/blog/g2?fields=_source,views&_source_include=title", None),
        ("POST", "/website/_refresh", None),
        ("GET", "/website/blog/g2/_explain?q=title:slow&fields=views&_source=meta", None)],
    "bulk_update": [
        ("PUT", "/website/blog/k1", {"views": 1}),
        ("POST", "/_bulk", None, "\n".join([
            '{"update": {"_index": "website", "_type": "blog", "_id": "k1"}}',
            '{"script": "ctx._source.views += 10"}',
            '{"update": {"_index": "website", "_type": "blog", "_id": "k1"}}',
            '{"doc": {"title": "bulked"}}',
            '{"update": {"_index": "website", "_type": "blog", "_id": "k2"}}',
            '{"doc": {"title": "nope"}}',
            '{"update": {"_index": "website", "_type": "blog", "_id": "k3"}}',
            '{"doc": {"title": "upserted"}, "doc_as_upsert": true}',
            '{"index": {"_index": "website", "_type": "blog", "_id": "k4"}}',
            '{"views": 4}']) + "\n"),
        ("POST", "/website/blog/_mget", {"ids": ["k1", "k2", "k3", "k4"]})],
}


@pytest.mark.parametrize("case", list(A6C_CASES))
def test_document_api_route_matches_jax_node(nodes, case):
    statuses = []
    for method, path, body, *raw in A6C_CASES[case]:
        st, r = _both(nodes, method, path, body, raw[0] if raw else None)
        statuses.append(st)
    # every case answers something other than a refusal of the slice
    assert 400 not in statuses or case in ("mget_validation", "update_bad_script"), statuses
    if case == "create_taken":
        assert statuses[1:3] == [409, 409]
    if case == "update_missing":
        assert statuses == [404, 409]
    if case == "update_version_conflict":
        assert statuses[1:3] == [409, 200]
    if case in ("mget_validation", "update_bad_script"):
        assert statuses.count(400) >= 3, statuses


def test_head_of_source_matches_jax_node(nodes):
    pbase, jbase, _p = nodes
    _both(nodes, "PUT", "/website/blog/h1", {"title": "head"})
    for path in ("/website/blog/h1/_source", "/website/blog/h9/_source",
                 "/website/blog/h1"):
        assert _head(pbase, path) == _head(jbase, path) == \
            (404 if "h9" in path else 200), path


def _update_storm(base, doc_path, n_threads, n_updates, retry):
    """`n_threads` threads each send `n_updates` increments of `views`;
    returns (acknowledged, conflicts)."""
    acked, conflicts, errors = [0] * n_threads, [0] * n_threads, []

    def worker(t):
        for _ in range(n_updates):
            st, r = call(base, "POST", f"{doc_path}/_update?retry_on_conflict={retry}",
                         {"script": "ctx._source.views += n", "params": {"n": 1}})
            if st == 200:
                acked[t] += 1
            elif st == 409:
                conflicts[t] += 1
            else:
                errors.append((st, r))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors[:3]
    return sum(acked), sum(conflicts)


@pytest.mark.parametrize("retry", [0, 8])
def test_concurrent_updates_count_every_acknowledged_increment(nodes, retry):
    """8 threads × 6 increments of one document's `views` on each node:
    the stored count equals the acknowledged increments (a 409 is counted
    apart and adds nothing)."""
    path = f"/website/blog/hot{retry}"
    for base in nodes[:2]:
        assert call(base, "PUT", path, {"views": 0})[0] == 201
        acked, conflicts = _update_storm(base, path, 8, 6, retry)
        assert acked + conflicts == 48 and acked > 0
        st, r = call(base, "GET", path)
        assert r["_source"]["views"] == acked and r["_version"] == acked + 1, (base, r)


def test_bulk_updates_beside_single_updates_do_not_deadlock(nodes):
    """A `_bulk` of 60 `update` items over 6 documents from one thread,
    while 6 threads send single `_update`s to the same documents: every
    request answers, and each document's `views` equals its acknowledged
    increments."""
    pbase = nodes[0]
    ids = [f"mix{i}" for i in range(6)]
    for i in ids:
        assert call(pbase, "PUT", f"/website/blog/{i}", {"views": 0})[0] == 201
    lines = []
    for n in range(60):
        lines += ['{"update": {"_index": "website", "_type": "blog", "_id": "%s", '
                  '"_retry_on_conflict": 3}}' % ids[n % 6],
                  '{"script": "ctx._source.views += 1"}']
    bulk_out = {}

    def bulk():
        bulk_out["r"] = call(pbase, "POST", "/_bulk", raw="\n".join(lines) + "\n")

    singles = {}

    def single(i):
        singles[i] = _update_storm(pbase, f"/website/blog/{i}", 1, 5, 10)

    threads = [threading.Thread(target=bulk)] + \
        [threading.Thread(target=single, args=(i,)) for i in ids]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a request never answered"
    st, r = bulk_out["r"]
    assert st == 200
    bulk_acked = {i: 0 for i in ids}
    for item in r["items"]:
        u = item["update"]
        if u["status"] == 200:
            bulk_acked[u["_id"]] += 1
        else:
            assert u["status"] == 409, u
    for i in ids:
        st, g = call(pbase, "GET", f"/website/blog/{i}")
        assert g["_source"]["views"] == bulk_acked[i] + singles[i][0], (i, g)


SCRIPTS = {
    "increment": ("ctx._source.views += n", {"n": 3}),
    "conditional": ("if ctx._source.views > 2:\n    ctx._source.tags = ['hot']\n"
                    "else:\n    ctx.op = 'none'", {}),
    "nested_set": ("ctx._source.meta.a = max(ctx._source.meta.a, 10) * 2", {}),
    "subscript": ("ctx._source['title'] = ctx._source['title'] + ' edited'", {}),
    "new_dict": ("ctx._source.stats = {'views': ctx._source.views, 'x': [1, 2]}", {}),
    "ttl_and_op": ("ctx._ttl = '1h'\nctx.op = 'delete' if ctx._source.views > 100 "
                   "else 'index'", {}),
    "math": ("ctx._source.score = round(sqrt(ctx._source.views) + log(2), 4)", {}),
}
ESCAPES = {
    "dunder_chain": "ctx.__class__",
    "dunder_on_literal": "x = ().__class__",
    "attr_not_ctx": "x = {}\nx.keys",
    "rebind_ctx": "ctx = 1",
    "rebind_builtin": "abs = 1",
    "call_outside": "open('/etc/passwd')",
    "import": "import os",
    "lambda": "f = lambda: 1",
    "comprehension": "x = [v for v in ctx._source]",
    "syntax": "ctx._source.views +=",
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_update_script_same_ctx_on_both_packages(name):
    from elasticsearch_tpu.script import compile_update_script as jcompile
    from elasticsearch_tpu_torch.script import compile_update_script as tcompile

    source, params = SCRIPTS[name]
    ctx = {"_source": {"views": 5, "title": "a post", "meta": {"a": 4}},
           "op": "index", "_index": "website", "_type": "blog", "_id": "1",
           "_version": 2, "_routing": None, "_parent": None, "_ttl": None,
           "_timestamp": None}
    jctx, tctx = copy.deepcopy(ctx), copy.deepcopy(ctx)
    jcompile(source, params).run(jctx)
    tcompile(source, params).run(tctx)
    assert tctx == jctx and tctx != ctx


@pytest.mark.parametrize("name", list(ESCAPES))
def test_update_script_refusals_match_jax(nodes, name):
    """Each escape attempt: the same ScriptError on both packages, the same
    400 on both nodes, and the document unchanged."""
    from elasticsearch_tpu.common.errors import ScriptError as JScriptError
    from elasticsearch_tpu.script import compile_update_script as jcompile
    from elasticsearch_tpu_torch.common.errors import ScriptError as TScriptError
    from elasticsearch_tpu_torch.script import compile_update_script as tcompile

    source = ESCAPES[name]
    errors = []
    for compile_, err in ((jcompile, JScriptError), (tcompile, TScriptError)):
        with pytest.raises(err) as e:
            compile_(source, {}).run({"_source": {"views": 1}})
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    path = f"/website/blog/esc_{name}"
    _both(nodes, "PUT", path, {"views": 1})
    st, r = _both(nodes, "POST", f"{path}/_update", {"script": source})
    assert st == 400 and r["error"]["type"] == "ScriptException", r
    st, r = _both(nodes, "GET", path)
    assert r["_source"] == {"views": 1} and r["_version"] == 1


def test_named_scripts_resolve_as_in_jax():
    """`ScriptService.put` on both packages: `compile_script` resolves a
    name to the newest owner's source, a removal falls back to the older
    owner's, and a name no owner holds compiles as a source of its own.
    Each package keeps its own registry."""
    from elasticsearch_tpu import script as jscript
    from elasticsearch_tpu_torch import script as tscript

    name = "named_script_parity"
    results = []
    for mod in (jscript, tscript):
        first, second = mod.ScriptService(), mod.ScriptService()
        try:
            first.put(name, "_score * factor")
            second.put(name, "_score + factor")
            steps = [mod.compile_script(name, {"factor": 3.0})(None, _score=2.0)]
            second.remove(name)
            steps.append(mod.compile_script(name, {"factor": 3.0})(None, _score=2.0))
            steps.append(first.compile(name, {"factor": 4.0})(None, _score=2.0))
            first.remove(name)
            steps.append(mod.compile_script(name).source)
            results.append(steps)
        finally:
            first.remove(name)
            second.remove(name)
    assert results[0] == results[1] == [5.0, 6.0, 8.0, name]
    assert name not in jscript._named and name not in tscript._named


def test_tombstone_queued_during_a_merge_survives_its_publish(tmp_path, monkeypatch):
    """An update and a delete that land on a segment while a background
    merge of it computes (outside the engine lock) tombstone the merged
    copy when the merge publishes: the old copy of the updated document
    and the deleted document leave the next view. (The JAX engine drops
    such a tombstone: its old copy stays live beside the new one.)"""
    import types

    from elasticsearch_tpu_torch.index import engine as tengine
    from elasticsearch_tpu_torch.mapper import MapperService

    e = tengine.Engine(str(tmp_path), MapperService())
    for i, doc_id in enumerate("abcdef"):
        e.index("doc", doc_id, {"t": f"v{i} common"})
        e.refresh()
    merge = tengine.merge_segments
    plans = [types.SimpleNamespace(start=0, end=3)]
    monkeypatch.setattr(e.merge_policy, "find_merge",
                        lambda segs: plans.pop() if plans else None)

    def racing_merge(sources, gen):
        merged = merge(sources, gen)
        e.index("doc", "a", {"t": "new"})  # the old copy sits in a source
        e.delete("doc", "b")
        return merged

    monkeypatch.setattr(tengine, "merge_segments", racing_merge)
    e.maybe_merge()
    assert len(e.acquire_searcher().segments) == 4  # the merge published
    e.refresh()
    live = [(seg.ids[i], seg.stored[i]) for seg in e.acquire_searcher().segments
            for i in range(seg.doc_count) if seg.live[i]]
    assert sorted(doc_id for doc_id, _src in live) == ["a", "c", "d", "e", "f"]
    assert dict(live)["a"] == {"t": "new"}
    e.close()
