"""The `_cat` tables of a port node against the JAX node's
(rest/controller.py `_register_cat_routes`, `_cat_table`).

Both nodes carry one name, hold the same two indexes (one with a filtered
and a routing alias) after the same bulk, and answer the same searches.
Every `_cat` route then answers 200 `text/plain` on both, and the text is
equal: the `/_cat` listing, the `?help` columns, the `?v` header and the
rows, under `?h=` by name and by alias too. Declared differences, each
column by name (ROADMAP "Declared path differences"):

- host and clock columns: `count`'s `epoch` and `timestamp`,
  `allocation`'s `disk.*` (the filesystem moves between two reads), the
  pool activity of `thread_pool` beyond its default view (a watchdog tick
  may hold a management thread);
- device columns: `batcher`'s launch and flush counters (each node's own
  coalescing under its own timing), and `events`' rows (each node's own
  journal: a JAX node's first batch can journal a `batch_stall` behind its
  XLA compile).

The renderer's contract holds on its own too: `?h=` keeps the order asked
and drops unknown names, the header shows the key as asked, numbers
right-align and text left-aligns, and an empty table is empty text."""

import json
import re
import urllib.error
import urllib.request

import pytest

from elasticsearch_tpu_torch.rest.controller import RestRequest, _cat_table
from tests.test_torch_node import _node_pair, call

NAME = "catnode"


def _fill(base):
    st, r = call(base, "PUT", "/ca", {"settings": {
        "number_of_shards": 2, "number_of_replicas": 1, "refresh_interval": -1}})
    assert st == 200, r
    st, r = call(base, "PUT", "/cb", {
        "settings": {"number_of_shards": 1, "number_of_replicas": 0,
                     "refresh_interval": -1},
        "aliases": {"al": {"filter": {"term": {"n": 3}}},
                    "ar": {"index_routing": "1", "search_routing": "1,2"}}})
    assert st == 200, r
    lines = []
    for index in ("ca", "cb"):
        for i in range(150):
            lines.append(json.dumps({"index": {"_index": index, "_type": "doc",
                                               "_id": str(i)}}))
            lines.append(json.dumps({"body": f"w{i % 7} w{i % 3} x", "n": i % 5}))
    st, r = call(base, "POST", "/_bulk", raw="\n".join(lines) + "\n")
    assert st == 200 and not r["errors"]
    assert call(base, "POST", "/_refresh")[0] == 200
    for q in ("w1", "w2 x", "w3"):
        assert call(base, "POST", "/_search", {"query": {"match": {"body": q}}})[0] == 200
    for _ in range(2):
        assert call(base, "POST", "/ca/_search",
                    {"query": {"match": {"body": "w1"}}, "size": 0})[0] == 200


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    yield from _node_pair(tmp_path_factory, _fill, names=(NAME, NAME))


def _text(base, path):
    req = urllib.request.Request(base + path, method="GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def _both(nodes, path):
    pbase, jbase, _p = nodes
    (pst, pct, ptext), (jst, jct, jtext) = _text(pbase, path), _text(jbase, path)
    assert (pst, pct) == (jst, jct) == (200, "text/plain"), (path, ptext, jtext)
    return ptext, jtext


# (route, query strings compared whole on both nodes)
PLAIN = ["health", "nodes", "indices", "master", "pending_tasks", "recovery"]
TABLES = {
    "shards": ["", "?v", "?help", "?v&h=i,s,p,d", "?h=index,state,node&v"],
    "shards/ca": ["?v", "?h=st,sto"],
    "allocation": ["?help", "?v&h=shards,node", "?h=h,ip,n&v"],
    f"allocation/{NAME}": ["?h=shards,host&v", "?help"],
    "allocation/_master": ["?h=shards,n"],
    "count": ["?help", "?h=count&v", "?h=dc"],
    "count/ca": ["?h=dc,count&v"],
    "aliases": ["", "?v", "?help", "?h=a,ri,rs&v"],
    "aliases/al": ["?v", "?h=i,f"],
    "thread_pool": ["", "?v", "?help", "?h=pid,id,host,ip,port&v", "?h=sa,sq,sr,ba"],
    "batcher": ["?help", "?h=host,ip,queue&v", "?h=h,i,q"],
    "caches": ["", "?v", "?help", "?h=t,e,lb,ht,ms,hr,ev&v"],
    "segments": ["", "?v", "?help", "?h=i,s,p,seg,g,dc,dd,po&v",
                 "?h=pk,tf,bp,sz,dp,se&v"],
    "segments/cb": ["?v", "?h=index,size,packed"],
    "events": ["?help", "?h=ts,n,t&help"],
}
CASES = [(r, "") for r in PLAIN] + [(r, q) for r, qs in TABLES.items() for q in qs]


def test_listing_names_every_route(nodes):
    ptext, jtext = _both(nodes, "/_cat")
    assert ptext == jtext
    routes = [ln.split("/_cat/")[1] for ln in ptext.splitlines()]
    assert sorted(routes) == sorted(PLAIN + [r for r in TABLES if "/" not in r])
    for route in routes:  # on both nodes: a count warms the request cache
        _both(nodes, f"/_cat/{route}")


@pytest.mark.parametrize("route,query", CASES, ids=[f"{r}{q}" for r, q in CASES])
def test_cat_route_matches_jax(nodes, route, query):
    ptext, jtext = _both(nodes, f"/_cat/{route}{query}")
    assert ptext == jtext, (ptext, jtext)
    assert "NotPorted" not in ptext


def test_count_and_allocation_rows_match_but_their_clock_and_disk(nodes):
    ptext, jtext = _both(nodes, "/_cat/count/ca?v")
    (ph, prow), (jh, jrow) = (t.splitlines() for t in (ptext, jtext))
    assert ph == jh and ph.split() == ["epoch", "timestamp", "count"]
    # epoch and timestamp are each node's clock; the count is the index's
    assert prow.split()[2] == jrow.split()[2] == "150"
    assert abs(int(prow.split()[0]) - int(jrow.split()[0])) <= 5
    ptext, jtext = _both(nodes, "/_cat/allocation?v")
    prows, jrows = ptext.splitlines(), jtext.splitlines()
    assert prows[0] == jrows[0] and len(prows) == len(jrows) == 3
    for pr, jr in zip(prows[1:], jrows[1:]):
        # shards first, then the disk columns, then host, ip and node
        assert pr.split()[0] == jr.split()[0] and pr.split()[-1] == jr.split()[-1]


def test_batcher_and_events_rows_have_the_jax_shape(nodes):
    ptext, jtext = _both(nodes, "/_cat/batcher?v")
    (ph, prow), (jh, jrow) = (t.splitlines() for t in (ptext, jtext))
    assert ph == jh
    pcells, jcells = prow.split(), jrow.split()
    assert len(pcells) == len(jcells) == 10 and pcells[:2] == jcells[:2]
    launches, coalesced = int(pcells[2]), int(pcells[3])
    assert launches > 0 and coalesced >= launches
    assert float(pcells[4]) == pytest.approx(coalesced / launches, abs=0.06)
    ptext, jtext = _both(nodes, "/_cat/events?v")
    assert ptext.splitlines()[0].split() == jtext.splitlines()[0].split() == [
        "timestamp", "node", "type", "severity", "shard", "message"]
    ptext, jtext = _both(nodes, "/_cat/events")
    assert all(re.match(r"\d\d:\d\d:\d\d ", ln) for ln in ptext.splitlines())


def test_segments_show_the_port_layout(nodes):
    """The device columns read the port's packs: each searched segment is
    packed, its u8 tf plane at 6 bytes a posting, and `size` formats the
    resident bytes `/_segments` reports."""
    from elasticsearch_tpu_torch.common.units import format_bytes

    pbase, _j, _p = nodes
    segs = call(pbase, "GET", "/_segments")[1]["indices"]
    _st, _ct, text = _text(pbase, "/_cat/segments?h=i,s,seg,pk,tf,bp,sz,dp")
    rows = [ln.split() for ln in text.splitlines()]
    assert len(rows) == 3
    for index, sid, seg, packed, tf, bp, size, dense in rows:
        dev = segs[index]["shards"][sid][0]["segments"][seg]["device"]
        assert (packed, tf, bp, dense) == ("true", "u8", "6", "lazy")
        assert size == format_bytes(dev["resident_bytes"])


def _req(**params):
    return RestRequest(method="GET", path="/_cat/x", params=params)


COLUMNS = [("name", "n", "a name"), ("num", "nu", "a number"),
           ("ratio", None, "a decimal")]
ROWS = [{"name": "alpha", "num": 7, "ratio": 0.5},
        {"name": "b", "num": 12345, "ratio": 10.25},
        {"name": "gamma-long", "num": 0}]


def test_renderer_help_header_alignment():
    r = _cat_table(_req(help=""), COLUMNS, ROWS)
    assert r.body == "name | n | a name\nnum | nu | a number\nratio | ratio | a decimal\n"
    assert r.content_type == "text/plain"
    lines = _cat_table(_req(v=""), COLUMNS, ROWS).body.splitlines()
    assert lines[0] == "name       num   ratio "
    # text left-aligns, numbers right-align, an empty cell is blank
    assert lines[1:] == ["alpha          7   0.5 ",
                         "b          12345 10.25 ",
                         "gamma-long     0       "]


def test_renderer_h_by_name_and_alias():
    body = _cat_table(_req(v="", h="nu,ratio,nope,name"), COLUMNS, ROWS).body
    assert body.splitlines()[0] == "nu    ratio name       "
    assert body.splitlines()[2] == "12345 10.25 b          "
    assert _cat_table(_req(h="n"), COLUMNS, ROWS).body == "alpha      \nb          \ngamma-long \n"
    assert _cat_table(_req(), COLUMNS, []).body == ""
