"""The port's content formats (common/xcontent.py, http/server.py) against
the JAX package's.

Codecs: on seeded numpy documents (nested dicts and lists, integers past
64 bits, floats, unicode, bools, None) the port's `dumps` is byte for byte
the JAX package's for CBOR, SMILE, YAML and JSON, and each package `loads`
the other's bytes back to the document; `detect` and `from_content_type`
agree on every sample; the RFC 7049 vectors and foreign decode-only forms
of `tests/test_xcontent.py` hold on the port's codec.

Over HTTP, node against node after the same bulk: a CBOR, a SMILE and a
YAML `_search` body answer in their own format with the JSON search's hits;
`?format=` re-encodes a JSON request's answer; a SMILE document write is
read back; a `_cat` table stays text under `?format=`; a malformed binary
body answers 400 `parse_exception` on both, and the connection serves on."""

import http.client
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from elasticsearch_tpu.common import xcontent as jxc
from elasticsearch_tpu_torch.common import xcontent as pxc
from tests import test_xcontent as jtests
from tests.test_torch_node import _node_pair, call

FORMATS = [pxc.CBOR, pxc.SMILE, pxc.YAML, pxc.JSON]
UNICODE = ["é", "ü", "日本", "テキスト", "ß", "Ω", "😀", "a", "z", " "]


def _seeded_doc(seed: int, depth: int = 0):
    """A seeded document: a dict of every kind of value, nested."""
    rng = np.random.default_rng(seed)

    def text():
        n = int(rng.integers(0, 80))
        return "".join(rng.choice(UNICODE if rng.random() < 0.4 else list("abcxyz"), n))

    def scalar():
        kind = int(rng.integers(0, 8))
        if kind == 0:
            return int(rng.integers(-20, 20))
        if kind == 1:
            return int(rng.integers(-(2 ** 62), 2 ** 62)) * int(rng.integers(1, 2 ** 40))
        if kind == 2:
            return -(2 ** 64) - int(rng.integers(0, 2 ** 30))
        if kind == 3:
            return float(rng.normal() * 10.0 ** int(rng.integers(-30, 30)))
        if kind == 4:
            return text()
        if kind == 5:
            return bool(rng.integers(0, 2))
        if kind == 6:
            return None
        return int(rng.integers(2 ** 31, 2 ** 63))

    def value(d):
        r = rng.random()
        if d < 3 and r < 0.25:
            return {f"k{j}{text()[:int(rng.integers(0, 70))]}": value(d + 1)
                    for j in range(int(rng.integers(0, 5)))}
        if d < 3 and r < 0.45:
            return [value(d + 1) for _ in range(int(rng.integers(0, 6)))]
        return scalar()

    return {f"f{j}": value(depth) for j in range(int(rng.integers(3, 9)))}


SEEDS = list(range(12))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("seed", SEEDS)
def test_dumps_is_byte_for_byte_the_jax_encoding(seed, fmt):
    doc = _seeded_doc(seed)
    raw = pxc.dumps(doc, fmt)
    assert raw == jxc.dumps(doc, fmt)
    assert pxc.loads(raw, fmt) == doc
    assert jxc.loads(raw, fmt) == doc
    assert pxc.loads(jxc.dumps(doc, fmt), fmt) == doc


@pytest.mark.parametrize("fmt", FORMATS)
def test_jax_documents_round_trip_both_ways(fmt):
    for doc in jtests.DOCS:
        raw = pxc.dumps(doc, fmt)
        assert raw == jxc.dumps(doc, fmt), doc
        assert pxc.loads(raw, fmt) == jxc.loads(raw, fmt) == doc


def test_huge_integers_and_bytes_match():
    for n in (2 ** 64, -(2 ** 64), 2 ** 63, -(2 ** 63) - 1, 10 ** 30, -(10 ** 30)):
        for fmt in (pxc.CBOR, pxc.SMILE):
            assert pxc.dumps(n, fmt) == jxc.dumps(n, fmt)
            assert pxc.loads(pxc.dumps(n, fmt), fmt) == n
    assert pxc.cbor_dumps(b"\x00\x01\xff") == jxc.cbor_dumps(b"\x00\x01\xff")
    assert pxc.cbor_loads(pxc.cbor_dumps(b"\x00\x01\xff")) == b"\x00\x01\xff"
    with pytest.raises(TypeError):
        pxc.smile_dumps(b"\x00")


@pytest.mark.parametrize("obj,hexa", jtests.TestCborVectors.VECTORS,
                         ids=[h for _o, h in jtests.TestCborVectors.VECTORS])
def test_rfc7049_vector(obj, hexa):
    assert pxc.cbor_dumps(obj).hex() == hexa
    assert pxc.cbor_loads(bytes.fromhex(hexa)) == obj


@pytest.mark.parametrize("hexa", ["9f018202039f0405ffff", "7f657374726561646d696e67ff",
                                  "f90000", "f93c00", "f97c00", "fa47c35000",
                                  "d9d9f783010203", "c249010000000000000000"])
def test_foreign_cbor_forms_decode_as_on_jax(hexa):
    raw = bytes.fromhex(hexa)
    assert pxc.cbor_loads(raw) == jxc.cbor_loads(raw)


SNIFF = [b'{"a": 1}', b"  [1]", b"---\na: 1\n", b"a: 1", b"", b"\x8b" + b"\x01" * 11,
         b"\xa1aa\x01", b"\xd9\xd9\xf7\x80", b":)\n\x00\xfa\xfb", b"\x00\x01", b"plain"]


@pytest.mark.parametrize("raw", SNIFF, ids=[r[:6].hex() or "empty" for r in SNIFF])
def test_detect_agrees(raw):
    assert pxc.detect(raw) == jxc.detect(raw)


CTYPES = ["application/json", "application/json; charset=UTF-8", "application/smile",
          "application/x-jackson-smile", "application/cbor", "text/yaml",
          "application/yaml", "application/x-ndjson", "text/plain", "", None]


@pytest.mark.parametrize("ctype", CTYPES, ids=[str(c) for c in CTYPES])
def test_from_content_type_agrees(ctype):
    assert pxc.from_content_type(ctype) == jxc.from_content_type(ctype)


def test_smile_header_and_small_ints():
    raw = pxc.smile_dumps({"a": 1})
    assert raw[:3] == b":)\n" and raw[3] == 0x00
    for n in (-16, -1, 0, 1, 15):
        assert len(pxc.smile_dumps(n)) == 5
    with pytest.raises(ValueError):
        pxc.smile_loads(b"{}")


# --- over HTTP, node against node --------------------------------------------

WORDS = ["quick", "brown", "fox", "lazy", "dog", "summer", "red", "bear", "ünï"]


def _fill(base):
    st, r = call(base, "PUT", "/xc", {"settings": {"number_of_shards": 2,
                                                   "refresh_interval": -1}})
    assert st == 200, r
    rng = np.random.default_rng(7)
    lines = []
    for i in range(120):
        lines.append(json.dumps({"index": {"_index": "xc", "_type": "doc", "_id": str(i)}}))
        lines.append(json.dumps({"body": " ".join(rng.choice(WORDS, int(rng.integers(2, 9)))),
                                 "n": i}))
    st, r = call(base, "POST", "/_bulk", raw="\n".join(lines) + "\n")
    assert st == 200 and not r["errors"]
    assert call(base, "POST", "/xc/_refresh")[0] == 200


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    yield from _node_pair(tmp_path_factory, _fill)


def _raw(base, method, path, data=None, ctype=None):
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": ctype} if ctype else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


BODIES = [{"query": {"match": {"body": "quick fox"}}, "size": 7},
          {"query": {"bool": {"must": [{"match": {"body": "lazy"}}],
                              "should": [{"match": {"body": "ünï dog"}}]}}},
          {"query": {"match_all": {}}, "size": 3, "sort": [{"n": "desc"}]}]


@pytest.mark.parametrize("fmt", [pxc.CBOR, pxc.SMILE, pxc.YAML])
@pytest.mark.parametrize("bi", range(len(BODIES)))
def test_search_body_in_each_format_answers_in_kind(nodes, fmt, bi):
    pbase, jbase, _p = nodes
    body = BODIES[bi]
    want = call(pbase, "POST", "/xc/_search", body)[1]["hits"]
    assert want == call(jbase, "POST", "/xc/_search", body)[1]["hits"]
    for base in (pbase, jbase):
        st, ctype, raw = _raw(base, "POST", "/xc/_search", pxc.dumps(body, fmt),
                              pxc.CONTENT_TYPES[fmt])
        assert (st, ctype) == (200, pxc.CONTENT_TYPES[fmt]), raw[:200]
        assert pxc.loads(raw, fmt)["hits"] == want


@pytest.mark.parametrize("fmt", [pxc.CBOR, pxc.SMILE, pxc.YAML, pxc.JSON])
def test_format_param_reencodes_a_json_request(nodes, fmt):
    pbase, jbase, _p = nodes
    body = json.dumps(BODIES[1]).encode()
    answers = []
    for base in (pbase, jbase):
        st, ctype, raw = _raw(base, "POST", f"/xc/_search?format={fmt}", body,
                              "application/json")
        assert (st, ctype) == (200, pxc.CONTENT_TYPES[fmt])
        answers.append(pxc.loads(raw, fmt)["hits"])
    assert answers[0] == answers[1]


def test_sniffed_binary_bodies_without_content_type(nodes):
    pbase, jbase, _p = nodes
    for fmt in (pxc.CBOR, pxc.SMILE):
        out = []
        for base in (pbase, jbase):
            st, ctype, raw = _raw(base, "POST", "/xc/_search", pxc.dumps(BODIES[0], fmt))
            assert (st, ctype) == (200, pxc.CONTENT_TYPES[fmt])
            out.append(pxc.loads(raw, fmt)["hits"])
        assert out[0] == out[1]


def test_smile_document_write_reads_back(nodes):
    pbase, jbase, _p = nodes
    doc = {"body": "smile wörld", "n": 2 ** 40, "tags": ["a", None, True, 1.25]}
    answers = []
    for base in (pbase, jbase):
        st, ctype, raw = _raw(base, "PUT", "/xc/doc/s1", pxc.smile_dumps(doc),
                              "application/smile")
        assert (st, ctype) == (201, "application/smile"), raw
        put = pxc.smile_loads(raw)
        st, ctype, raw = _raw(base, "GET", "/xc/doc/s1?format=cbor")
        assert (st, ctype) == (200, "application/cbor")
        got = pxc.cbor_loads(raw)
        assert got["_source"] == doc and got["found"]
        answers.append((put, got))
    assert answers[0] == answers[1]


def test_cat_text_passes_format_untouched(nodes):
    pbase, jbase, _p = nodes
    for base in (pbase, jbase):
        st, ctype, raw = _raw(base, "GET", "/_cat?format=smile")
        assert (st, ctype) == (200, "text/plain")
        assert raw.decode().splitlines()[0] == "/_cat/health"


@pytest.mark.parametrize("ctype,raw", [
    ("application/cbor", b"\xbf\x61"), ("application/smile", b":)\n\x00\xfa\x85"),
    ("application/yaml", b"a: [1, 2"), ("", b"\xa1\x61"), ("application/smile", b"nope")])
def test_malformed_body_is_400_and_connection_serves_on(nodes, ctype, raw):
    pbase, jbase, _p = nodes
    for base in (pbase, jbase):
        host, port = base.rsplit("//", 1)[1].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        try:
            conn.request("POST", "/xc/_search", body=raw,
                         headers={"Content-Type": ctype} if ctype else {})
            resp = conn.getresponse()
            err = json.loads(resp.read())
            assert resp.status == 400 and err["error"]["type"] == "parse_exception"
            assert err["error"]["reason"].startswith("failed to parse request body")
            conn.request("GET", "/xc/_count")
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read())["count"] >= 120
        finally:
            conn.close()
