"""The port's host modules of the node slice against the JAX package's, on
the same inputs: the wire codec (the same bytes both ways), units and
settings getters, the `_source` filter of the fetch phase, the lenient
JSON rewrite of REST bodies, content-type detection; and the thread pools'
bounded queues and shutdown."""

import threading

import pytest

from elasticsearch_tpu_torch.common import stream as pstream
from elasticsearch_tpu_torch.common import units as punits
from elasticsearch_tpu_torch.common import xcontent as pxc
from elasticsearch_tpu_torch.common.errors import RejectedExecutionError
from elasticsearch_tpu_torch.common.settings import Settings as PSettings
from elasticsearch_tpu_torch.rest.controller import _lenient_to_strict_json as p_lenient
from elasticsearch_tpu_torch.search.fetch import filter_source, source_spec
from elasticsearch_tpu_torch.threadpool import ThreadPool

VALUES = [
    None, True, False, 0, 1, -1, 127, 128, -129, 2**31 - 1, -(2**31), 2**62, -(2**62),
    0.0, -0.0, 1.5, 3.4028234663852886e38, 1e-300, "", "doc", "ünïcødé ✓",
    b"\x00\xff raw", [], [1, "two", 3.0, None], (4, 5),
    {"a": 1, "b": {"c": [True, {"d": "e"}]}, "f": None},
    {"index": "corpus", "shard": 3, "docs": [[1.25, 17, None], [0.5, 2, None]]},
]


@pytest.mark.parametrize("value", VALUES, ids=[f"v{i}" for i in range(len(VALUES))])
def test_wire_codec_writes_the_jax_bytes_and_reads_them_back(value):
    from elasticsearch_tpu.common import stream as jstream

    pout, jout = pstream.StreamOutput(), jstream.StreamOutput()
    pout.write_value(value)
    jout.write_value(value)
    assert pout.bytes() == jout.bytes()
    want = list(value) if isinstance(value, tuple) else value
    assert pstream.StreamInput(jout.bytes()).read_value() == want
    assert jstream.StreamInput(pout.bytes()).read_value() == want


TIMES = [None, 0, 250, 1.5, "-1", "200ms", "30s", "5m", "2h", "1d", "0.5s", "750"]
BYTES = [0, 1024, "512b", "1kb", "64mb", "2gb", "1.5kb", "100"]


@pytest.mark.parametrize("value", TIMES)
def test_parse_time_matches_jax(value):
    from elasticsearch_tpu.common import units as junits

    assert punits.parse_time(value, 9.0) == junits.parse_time(value, 9.0)


@pytest.mark.parametrize("value", BYTES)
def test_parse_bytes_matches_jax(value):
    from elasticsearch_tpu.common import units as junits

    assert punits.parse_bytes(value) == junits.parse_bytes(value)
    assert punits.parse_ratio_or_bytes("40%", 1000) == junits.parse_ratio_or_bytes("40%", 1000)


def test_settings_getters_match_jax():
    from elasticsearch_tpu.common.settings import Settings as JSettings

    flat = {"index.refresh_interval": "-1", "a.flag": "true", "b.flag": "false",
            "c.flag": True, "t1": "30s", "t2": 1500, "l1": "x, y,z", "l2": ["p", "q"],
            "n": "7", "index": {"similarity": {"default": {"type": "BM25"}}}}
    p, j = PSettings.from_flat(flat), JSettings.from_flat(flat)
    assert p.as_dict() == j.as_dict()
    for key in ("a.flag", "b.flag", "c.flag", "missing"):
        assert p.get_bool(key, False) == j.get_bool(key, False), key
    for key in ("index.refresh_interval", "t1", "t2", "missing"):
        assert p.get_time(key, 1.0) == j.get_time(key, 1.0), key
    for key in ("l1", "l2", "missing"):
        assert p.get_list(key, []) == j.get_list(key, []), key
    assert p.get_int("n") == j.get_int("n") == 7


SOURCE = {"title": "t", "body": "b", "n": 3,
          "meta": {"tag": "x", "note": "keep", "deep": {"a": 1, "b": [1, 2]}},
          "other": {"tag": "y"}}
SPECS = [None, True, False, "title", "meta.*", ["title", "meta.tag"], ["*.tag"],
         {"includes": ["meta"], "excludes": ["meta.note"]},
         {"include": "meta.deep", "exclude": "meta.deep.b"},
         {"excludes": ["body", "meta.deep"]}, ["nothing"], ["meta.deep.a", "n"]]


@pytest.mark.parametrize("spec", SPECS, ids=[f"spec{i}" for i in range(len(SPECS))])
def test_source_filtering_matches_jax_fetch(spec):
    from elasticsearch_tpu.search import fetch as jfetch

    body = {} if spec is None else {"_source": spec}
    assert source_spec(body) == jfetch.source_spec(body)
    enabled, inc, exc = source_spec(body)
    if enabled:
        assert filter_source(SOURCE, inc, exc) == jfetch.filter_source(SOURCE, inc, exc)


LENIENT = [
    '{query: {match: {body: "w1 w2"}}}',
    "{'query': {'term': {'body': 'it\\'s'}}, size: 5}",
    '{"from": -3, size: 1e2, "_source": false, x: null, y: true}',
    '{a: "quoted \\"inner\\"", b: [1, 2.5, -7]}',
]


@pytest.mark.parametrize("text", LENIENT, ids=[f"lenient{i}" for i in range(len(LENIENT))])
def test_lenient_json_rewrite_matches_jax_controller(text):
    from elasticsearch_tpu.rest.controller import _lenient_to_strict_json as j_lenient

    assert p_lenient(text) == j_lenient(text)


@pytest.mark.parametrize("ctype,raw", [
    ("application/json", b'{"a": 1}'), ("application/x-ndjson", b'{"a": 1}\n'),
    ("", b'{"a": 1}'), ("application/smile", b":)\n\x03"), ("", b":)\n\x03"),
    ("application/cbor", b"\xa1"), ("application/yaml", b"a: 1"), ("text/plain", b"[1]"),
])
def test_content_type_and_sniffing_match_jax(ctype, raw):
    from elasticsearch_tpu.common import xcontent as jxc

    assert pxc.from_content_type(ctype) == jxc.from_content_type(ctype)
    assert pxc.detect(raw) == jxc.detect(raw)


def test_bounded_pool_rejects_when_full_and_shutdown_frees_its_threads():
    tp = ThreadPool(PSettings.from_flat({"threadpool.search.size": 1,
                                         "threadpool.search.queue_size": 2}))
    release = threading.Event()
    try:
        futs = [tp.submit("search", release.wait, 10) for _ in range(3)]
        with pytest.raises(RejectedExecutionError):
            tp.submit("search", release.wait, 10)
        assert tp.stats()["search"]["rejected"] == 1
        release.set()
        assert [f.result(timeout=10) for f in futs] == [True] * 3
    finally:
        release.set()
        tp.shutdown()
    with pytest.raises(RejectedExecutionError):
        tp.submit("search", print)
    for t in threading.enumerate():
        if t.name.startswith("estpu_torch[search]"):
            t.join(timeout=5)
            assert not t.is_alive(), t.name


def test_unencodable_response_is_a_500_body():
    """A handler whose response does not encode as JSON answers a 500 JSON
    body naming the error, as the JAX server does, and the connection keeps
    serving."""
    import http.client
    import json

    import numpy as np

    from elasticsearch_tpu_torch.http.server import HttpServer
    from elasticsearch_tpu_torch.rest.controller import RestController

    rc = RestController()
    rc.register("GET", "/bad", lambda r: {"x": np.float32(1)})
    rc.register("GET", "/good", lambda r: {"x": 1})
    server = HttpServer(rc, port=0).start()
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=10)
    try:
        conn.request("GET", "/bad")
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 500 and body["status"] == 500
        assert body["error"]["type"] == "serialization_exception"
        assert "float32" in body["error"]["reason"]
        conn.request("GET", "/good")
        resp = conn.getresponse()
        assert (resp.status, json.loads(resp.read())) == (200, {"x": 1})
    finally:
        conn.close()
        server.stop()
