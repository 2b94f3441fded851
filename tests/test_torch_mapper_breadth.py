"""The port's flat mapper (`mapper/core.py`) against the JAX package's:
multi-fields, `copy_to`, `ip`, `token_count`, per-field index and search
analyzers, `_routing` and `_timestamp`, under custom analyzers with stacked
synonyms.

- For seeded documents, `ParsedDocument` postings, field lengths, numeric and
  string doc values, `routing` and `timestamp` are equal to the JAX mapper's.
  Two behaviours of the JAX package are pinned: a field's length is its
  number of indexed terms (stacked synonyms count), and values of a field
  are 100 positions apart; as in the JAX package, parsing indexes no value
  into a multi-field's sub-fields, and a `token_count` value is the number
  the document gives.
- `to_mapping()` and `merge()` (conflicts included) are equal; the mapper
  service's dynamic fields and a `copy_to` target made dynamically too.
- `_ttl` (served since the document APIs' slice), `_parent`, `nested`,
  `geo_point` and `geo_shape` (since the mapper's second half) map, render
  and parse a document as the JAX mapper does.
- A JAX segment built with these mappings, carried across by
  `convert.segment_from_arrays` (doc values and routings included), scores
  the same as the JAX device path, and so does the port's own index of the
  same documents; an `ip_range` aggregation over both gives the JAX
  buckets."""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest

from elasticsearch_tpu.common.errors import MapperParsingError as JMapperParsingError
from elasticsearch_tpu.common.jaxenv import compile_tag
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.engine import Engine as JEngine
from elasticsearch_tpu.mapper.core import MapperService as JMapperService
from elasticsearch_tpu.mapper.core import format_ip as jformat_ip
from elasticsearch_tpu.mapper.core import parse_ip as jparse_ip
from elasticsearch_tpu.search import ShardContext as JShardContext
from elasticsearch_tpu.search import parse_query as jparse_query
from elasticsearch_tpu.search.aggregations import reduce_aggs as jreduce_aggs
from elasticsearch_tpu.search.execute import search_shard_batch as jsearch_batch
from elasticsearch_tpu.search.service import execute_query_phase as jphase
from elasticsearch_tpu.search.service import parse_search_body as jparse_body
from elasticsearch_tpu.search.similarity import SimilarityService as JSim
from elasticsearch_tpu_torch.common.errors import MapperParsingError
from elasticsearch_tpu_torch.common.settings import Settings as TSettings
from elasticsearch_tpu_torch.convert import segment_from_arrays
from elasticsearch_tpu_torch.index.engine import Engine as TEngine
from elasticsearch_tpu_torch.index.engine import Searcher
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.mapper.core import format_ip, parse_ip
from elasticsearch_tpu_torch.search import (
    ShardContext, SimilarityService, execute_query_phase, parse_query,
    parse_search_body, search_shard_batch)
from elasticsearch_tpu_torch.search.aggregations import reduce_aggs

STEMS = ["run", "jump", "walk", "talk", "play", "work", "read", "cook", "paint",
         "sing", "dance", "climb", "swim", "fish", "hunt", "build", "clean",
         "learn", "teach", "help"]
SUFFIXES = ["", "s", "es", "ed", "ing", "ation", "ness"]
STOP = ["the", "a", "of", "and", "to", "in", "is", "it", "that", "with"]
TENANTS = [f"tenant{i}" for i in range(4)]

SETTINGS = {
    "index.similarity.default.type": "BM25",
    "index.similarity.default.k1": 1.4,
    "index.similarity.default.b": 0.6,
    "index.analysis.filter.syn.type": "synonym",
    "index.analysis.filter.syn.synonyms": ["run,sprint,dash", "jump,leap",
                                           "talk,speak,chat"],
    "index.analysis.analyzer.body_en.char_filter": ["html_strip"],
    "index.analysis.analyzer.body_en.tokenizer": "standard",
    "index.analysis.analyzer.body_en.filter": ["lowercase", "stop", "syn",
                                               "porter_stem"],
    "index.analysis.filter.sh.type": "shingle",
    "index.analysis.filter.sh.max_shingle_size": 3,
    "index.analysis.analyzer.shingles.tokenizer": "standard",
    "index.analysis.analyzer.shingles.filter": ["lowercase", "sh"],
}

MAPPING = {
    "_routing": {"path": "tenant"},
    "_timestamp": {"enabled": True, "path": "published"},
    "properties": {
        "title": {"type": "string", "analyzer": "english",
                  "fields": {"raw": {"type": "string", "index": "not_analyzed"},
                             "shingles": {"type": "string", "analyzer": "shingles"}},
                  "copy_to": ["title_shingles"]},
        "title_shingles": {"type": "string", "analyzer": "shingles"},
        "body": {"type": "string", "analyzer": "body_en", "search_analyzer": "english",
                 "copy_to": "all_text",
                 "fields": {"length": {"type": "token_count", "analyzer": "standard"}}},
        "client_ip": {"type": "ip"},
        "views": {"type": "integer"},
        "words": {"type": "token_count", "analyzer": "standard"},
        "tenant": {"type": "string", "index": "not_analyzed"},
        "published": {"type": "date"},
        "legacy": {"type": "multi_field", "fields": {
            "legacy": {"type": "string"},
            "untouched": {"type": "string", "index": "not_analyzed"}}},
    },
}


def _word(rng) -> str:
    if rng.random() < 0.35:
        return str(rng.choice(STOP))
    return STEMS[min(int(rng.zipf(1.3)) - 1, len(STEMS) - 1)] + str(rng.choice(SUFFIXES))


def _doc(rng, i: int) -> dict:
    body = " ".join(_word(rng) for _ in range(int(rng.poisson(20)) + 1))
    if rng.random() < 0.3:
        body = f"<p>{body}</p> <b>{_word(rng)}</b>"
    src = {"title": " ".join(_word(rng) for _ in range(int(rng.integers(3, 8)))),
           "body": body if rng.random() < 0.9 else [body, _word(rng) + " " + _word(rng)],
           "client_ip": "%d.%d.%d.%d" % tuple(int(x) for x in rng.integers(0, 256, 4)),
           "views": int(rng.integers(0, 10_000)),
           "tenant": str(rng.choice(TENANTS)),
           "published": f"2014-{1 + i % 12:02d}-{1 + i % 28:02d}T10:00:00Z",
           "legacy": _word(rng)}
    src["words"] = len(body.split())
    if rng.random() < 0.1:
        del src["client_ip"]
    return src


def _docs(seed: int, n: int, start: int = 0) -> list[tuple[str, dict]]:
    rng = np.random.default_rng(seed)
    return [(str(start + i), _doc(rng, start + i)) for i in range(n)]


def _services(settings=SETTINGS, mapping=MAPPING):
    jms = JMapperService(JSettings.from_flat(settings))
    tms = TMapperService(TSettings.from_flat(settings))
    jms.put_mapping("doc", copy.deepcopy(mapping))
    tms.put_mapping("doc", copy.deepcopy(mapping))
    return jms, tms


def _parsed(doc) -> dict:
    return {"id": doc.id, "uid": doc.uid, "type": doc.type, "routing": doc.routing,
            "timestamp": doc.timestamp, "postings": doc.postings,
            "field_lengths": doc.field_lengths, "num": doc.doc_values_num,
            "str": doc.doc_values_str}


def test_parsed_documents_match_jax():
    jms, tms = _services()
    for doc_id, src in _docs(1, 150):
        j = jms.mapper_for("doc").parse(src, doc_id)
        t = tms.mapper_for("doc").parse(src, doc_id)
        assert _parsed(t) == _parsed(j), doc_id
        assert j.nested_docs == [] and j.parent is None and j.ttl is None
    assert tms.mappings_dict() == jms.mappings_dict()


def test_pinned_jax_behaviours():
    _jms, tms = _services()
    m = tms.mapper_for("doc")
    doc = m.parse({"body": ["run fast", "<i>jump</i>"], "title": "The Runner",
                   "client_ip": "192.168.1.10", "words": "7", "tenant": "t1",
                   "published": "2014-01-01"}, "x")
    # stacked synonyms count in the length: run → run/sprint/dash at one position
    assert doc.postings["body"][:3] == [("run", 0), ("sprint", 0), ("dash", 0)]
    assert doc.field_lengths["body"] == len(doc.postings["body"]) == 6
    # the +100 position gap between values, counted from the value's number
    # of tokens (4 here: stacked synonyms too), not from its last position
    assert doc.postings["body"][4:] == [("jump", 104), ("leap", 104)]
    # sub-fields are mapped, not indexed; the copy_to targets are indexed,
    # with their own analyzer, and add nothing to _all
    assert "title.raw" not in doc.postings and "body.length" not in doc.doc_values_num
    assert [t for t, _ in doc.postings["title_shingles"]] == \
        ["the", "the runner", "runner"]
    assert [t for t, _ in doc.postings["all_text"]] == ["run", "fast", "i", "jump", "i"]
    assert "sprint" in [t for t, _ in doc.postings["_all"]]
    assert "the runner" not in [t for t, _ in doc.postings["_all"]]
    assert doc.doc_values_num["client_ip"] == [float(parse_ip("192.168.1.10"))]
    assert doc.doc_values_num["words"] == [7.0]
    assert doc.routing == "t1" and doc.timestamp == 1388534400000
    assert doc.doc_values_num["_timestamp"] == [1388534400000.0]
    assert m.field_type("all_text").type == "string" and m._mapping_dirty
    with pytest.raises(MapperParsingError, match="as token_count"):
        m.parse({"words": "seven words"}, "y")
    assert format_ip(parse_ip("10.0.0.255")) == jformat_ip(jparse_ip("10.0.0.255"))
    for bad in ("1.2.3", "1.2.3.256"):
        with pytest.raises(MapperParsingError):
            parse_ip(bad)
        with pytest.raises(JMapperParsingError):
            jparse_ip(bad)


def test_explicit_timestamp_routing_and_search_analyzer():
    jms, tms = _services()
    src = {"body": "Running dogs", "tenant": "t2", "published": "2014-03-04"}
    for kw in ({"routing": "r9"}, {"timestamp": "2015-06-01"},
               {"timestamp": 1400000000000}, {}):
        j = jms.mapper_for("doc").parse(src, "1", **kw)
        t = tms.mapper_for("doc").parse(src, "1", **kw)
        assert _parsed(t) == _parsed(j), kw
    # enabled, without a value at the path: the clock's now
    j = jms.mapper_for("doc").parse({"body": "x"}, "2")
    t = tms.mapper_for("doc").parse({"body": "x"}, "2")
    assert abs(t.timestamp - j.timestamp) < 60_000
    assert t.doc_values_num["_timestamp"] == [float(t.timestamp)]
    for field in ("body", "title", "title.shingles", "all_text", "views", "nope"):
        assert tms.search_analyzer_for(field).name == jms.search_analyzer_for(field).name
        for text in ("The Running dogs", "jumping <b>jacks</b>"):
            assert tms.search_analyzer_for(field).terms(text) == \
                jms.search_analyzer_for(field).terms(text)


def test_dynamic_copy_to_target_and_dynamic_fields_match_jax():
    mapping = {"properties": {"a": {"type": "string", "copy_to": ["t1", "t2"]},
                              "n": {"type": "long", "copy_to": "m"},
                              "ip": {"type": "ip", "copy_to": "ips"}}}
    jms, tms = _services({}, mapping)
    rng = np.random.default_rng(4)
    for i in range(40):
        src = {"a": _word(rng), "n": int(rng.integers(0, 9)),
               "ip": "10.0.%d.%d" % (i, i), "extra": {"x": i, "y": "w"}}
        if i % 3 == 0:
            src["m"] = None
        j = jms.mapper_for("doc").parse(src, str(i))
        t = tms.mapper_for("doc").parse(src, str(i))
        assert _parsed(t) == _parsed(j)
    assert tms.mappings_dict() == jms.mappings_dict()
    assert tms.mapper_for("doc")._mapping_dirty == jms.mapper_for("doc")._mapping_dirty


MERGES = [
    {"properties": {"title": {"type": "long"}}},
    {"properties": {"title": {"type": "string", "index": "not_analyzed"}}},
    {"properties": {"title": {"type": "string", "analyzer": "standard"}}},
    {"properties": {"title": {"type": "string", "analyzer": "english",
                              "fields": {"raw": {"type": "long"},
                                         "new": {"type": "string"}}}}},
    {"properties": {"extra": {"type": "ip"}, "cnt": {"type": "token_count"},
                    "body": {"type": "string", "analyzer": "body_en",
                             "copy_to": "other"}}},
    {"properties": {"legacy": {"type": "multi_field", "fields": {
        "legacy": {"type": "string", "analyzer": "whitespace"},
        "more": {"type": "string"}}}}},
    {"_routing": {"required": True}, "_timestamp": {"enabled": False},
     "properties": {"views": {"type": "integer"}}},
]


@pytest.mark.parametrize("i", range(len(MERGES)))
def test_merge_and_to_mapping_match_jax(i):
    jms, tms = _services()
    jm, tm = jms.mapper_for("doc"), tms.mapper_for("doc")
    assert tm.to_mapping() == jm.to_mapping()
    assert tm.merge(copy.deepcopy(MERGES[i])) == jm.merge(copy.deepcopy(MERGES[i]))
    assert tm.to_mapping() == jm.to_mapping()
    # through the service: a conflict raises with the same message
    jms2, tms2 = _services()
    jerr = terr = None
    try:
        jms2.put_mapping("doc", copy.deepcopy(MERGES[i]))
    except JMapperParsingError as e:
        jerr = str(e)
    try:
        tms2.put_mapping("doc", copy.deepcopy(MERGES[i]))
    except MapperParsingError as e:
        terr = str(e)
    assert terr == jerr
    assert tms2.mappings_dict() == jms2.mappings_dict()


# a document for each served mapping: (mapping, parse arguments)
_SECOND_HALF_DOCS = {
    "_parent": ({"title": "a reply"}, {"parent": "7"}),
    "_ttl": ({"title": "a session"}, {"timestamp": 4102444800000, "ttl": "90m"}),
    "nested": ({"title": "post", "c": [{"who": "ann", "n": 3}, {"who": "bo", "n": 5}]},
               {}),
    "geo_point": ({"loc": [{"lat": 40.7, "lon": -74.0}, "51.5,-0.12", "u4pruydqqvj",
                           [2.35, 48.86]]}, {}),
    "geo_shape": ({"shape": {"type": "envelope",
                             "coordinates": [[-10.0, 50.0], [5.0, 40.0]]}}, {}),
}


@pytest.mark.parametrize("mapping,slice_", [
    ({"_parent": {"type": "blog"}}, None),
    ({"_ttl": {"enabled": True}}, None),
    ({"properties": {"c": {"type": "nested", "properties": {
        "who": {"type": "string", "index": "not_analyzed"},
        "n": {"type": "integer"}}}}}, None),
    ({"properties": {"loc": {"type": "geo_point"}}}, None),
    ({"properties": {"shape": {"type": "geo_shape"}}}, None),
], ids=["_parent", "_ttl", "nested", "geo_point", "geo_shape"])
def test_later_slices_still_raise(request, mapping, slice_):
    """`_ttl` (since the document APIs' slice) and the mapper's second half
    (`_parent`, `nested`, `geo_point`, `geo_shape`) map, render and parse as
    the JAX mapper does, nested children included; a TTL lands as the same
    `_expiry` doc value."""
    tms = TMapperService()
    if slice_ is not None:
        with pytest.raises(MapperParsingError, match="later slice") as err:
            tms.put_mapping("doc", mapping)
        assert slice_ in str(err.value)
        return
    jms, tms = _services(settings={}, mapping=mapping)
    assert tms.mappings_dict() == jms.mappings_dict()
    src, kwargs = _SECOND_HALF_DOCS[request.node.callspec.id]
    jdoc = jms.mapper_for("doc").parse(copy.deepcopy(src), "1", **kwargs)
    tdoc = tms.mapper_for("doc").parse(copy.deepcopy(src), "1", **kwargs)
    assert _parsed(tdoc) == _parsed(jdoc)
    assert tdoc.parent == jdoc.parent
    assert [(p, _parsed(d)) for p, d in tdoc.nested_docs] == \
        [(p, _parsed(d)) for p, d in jdoc.nested_docs]


# --- a JAX segment carried across, and the port's own index ---------------

QUERIES = [
    {"match": {"body": "running jumps"}},
    {"match": {"body": {"query": "sprinted talking", "operator": "and"}}},
    {"match": {"title": "the walking reader"}},
    {"match": {"title_shingles": "run jump"}},
    {"match": {"all_text": "cooking paints"}},
    {"bool": {"should": [{"term": {"title": "run"}}, {"term": {"body": "leap"}},
                         {"term": {"body": "chat"}}, {"term": {"title": "swim"}}]}},
    {"multi_match": {"query": "climbing swims", "fields": ["title", "body"]}},
    {"term": {"title.raw": "run"}},
]


def _convert(jseg):
    return segment_from_arrays(
        jseg.term_dict, np.asarray(jseg.post_offsets), np.asarray(jseg.post_docs),
        np.asarray(jseg.post_freqs), {f: np.asarray(a) for f, a in jseg.norms.items()},
        {f: dataclasses.asdict(s) for f, s in jseg.field_stats.items()},
        np.asarray(jseg.live), np.asarray(jseg.parent_mask), gen=jseg.gen,
        ids=list(jseg.ids), dv_num=jseg.dv_num, dv_str=jseg.dv_str,
        routings=list(jseg.routings))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    jms, tms = _services()
    jeng = JEngine(str(tmp_path_factory.mktemp("j")), jms)
    teng = TEngine(str(tmp_path_factory.mktemp("t")), tms)
    tset = TSettings.from_flat(SETTINGS)
    try:
        for start in (0, 120):
            for doc_id, src in _docs(7 + start, 120, start):
                jeng.index("doc", doc_id, src)
                teng.index("doc", doc_id, src)
            jeng.refresh()
            teng.refresh()
        jctx = JShardContext(jeng.acquire_searcher(), jms,
                             JSim(JSettings.from_flat(SETTINGS), mapper_service=jms))
        own = ShardContext(teng.acquire_searcher(), tms, SimilarityService(tset, tms),
                           device="cpu")
        conv = ShardContext(Searcher([_convert(s) for s in jctx.searcher.segments]),
                            tms, SimilarityService(tset, tms), device="cpu")
        yield jctx, own, conv
    finally:
        jeng.close()
        teng.close()


def test_converted_segments_keep_their_columns(shards):
    jctx, own, conv = shards
    for jseg, cseg, oseg in zip(jctx.searcher.segments, conv.searcher.segments,
                                own.searcher.segments):
        assert cseg.routings == list(jseg.routings) == oseg.routings
        assert set(cseg.dv_num) == set(jseg.dv_num) == set(oseg.dv_num)
        for f in ("client_ip", "_timestamp", "words", "views"):
            for a, b in zip(cseg.dv_num[f], jseg.dv_num[f]):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(oseg.dv_num[f], jseg.dv_num[f]):
                np.testing.assert_array_equal(a, b)
        assert cseg.dv_num["client_ip"][1].max() > 2 ** 24
        assert oseg.norms.keys() == jseg.norms.keys()
        for f in jseg.norms:
            np.testing.assert_array_equal(oseg.norms[f], jseg.norms[f])


def test_scores_match_jax_device_path(shards):
    jctx, own, conv = shards
    with compile_tag("sparse"):
        ref = [(r.total, r.hits) for r in jsearch_batch(
            jctx, [jparse_query(q) for q in QUERIES], 25, use_device=True)]
    assert sum(t for t, _h in ref[:-1]) > 0 and ref[-1][0] == 0
    for ctx in (own, conv):
        out = [(r.total, r.hits) for r in search_shard_batch(
            ctx, [parse_query(q) for q in QUERIES], 25)]
        assert out == ref


IP_BODIES = [
    {"size": 0, "aggs": {"ips": {"ip_range": {"field": "client_ip", "ranges": [
        {"to": "10.0.0.0"}, {"from": "10.0.0.0", "to": "128.0.0.0"},
        {"from": "128.0.0.0", "to": "192.168.255.255"}, {"from": "192.168.255.255"}]}}}},
    {"query": {"match": {"body": "run"}}, "size": 0, "aggs": {"ips": {"ip_range": {
        "field": "client_ip", "ranges": [{"from": 16777217, "to": 3000000000},
                                         {"key": "top", "from": "200.0.0.1"}]}}}},
]


@pytest.mark.parametrize("bi", range(len(IP_BODIES)))
def test_ip_range_buckets_match_jax(shards, bi):
    jctx, own, conv = shards
    body = IP_BODIES[bi]
    jreq = jparse_body(body)
    with compile_tag("aggs"):
        ref = jphase(jctx, jreq)
    want = jreduce_aggs(jreq.aggs, ref.agg_partials)
    assert sum(b["doc_count"] for b in want["ips"]["buckets"]) > 0
    for ctx in (own, conv):
        for use_device in (True, False):
            req = parse_search_body(body)
            out = execute_query_phase(ctx, req, use_device=use_device)
            assert out.total == ref.total
            assert reduce_aggs(req.aggs, out.agg_partials) == want


@pytest.mark.parametrize("spec", [
    {"field": "client_ip", "ranges": [{"to": "10.0.0.0"}, {"from": "10.0.0.0"}]},
    {"field": "client_ip", "ranges": [{"from": 1, "to": 2 ** 31}]},
    {"script": "doc['client_ip'].value", "ranges": [{"to": 5}]},
], ids=["strings", "numbers", "script"])
def test_ip_range_takes_the_jax_branch(shards, spec):
    """`ip_range` is device-eligible exactly where the JAX package's is, and
    its bucket columns (docs, bucket ids, keys) are the JAX package's."""
    from elasticsearch_tpu.search.aggregations import bucket_cols_for as jcols
    from elasticsearch_tpu.search.aggregations import device_bucket_eligible as jelig
    from elasticsearch_tpu.search.aggregations import parse_aggs as jparse_aggs
    from elasticsearch_tpu_torch.search.aggregations import (
        bucket_cols_for, device_bucket_eligible, parse_aggs)

    jctx, own, conv = shards
    jagg = jparse_aggs({"ips": {"ip_range": spec}})["ips"]
    tagg = parse_aggs({"ips": {"ip_range": spec}})["ips"]
    assert type(tagg).__name__ == type(jagg).__name__ == "IpRangeAgg"
    assert device_bucket_eligible(tagg) == jelig(jagg)
    if not jelig(jagg):
        return
    for ctx in (own, conv):
        for jseg, tseg in zip(jctx.searcher.segments, ctx.searcher.segments):
            jd, jb, jk = jcols(jagg, jseg, jctx)
            td, tb, tk = bucket_cols_for(tagg, tseg, ctx)
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tb, jb)
            assert tk == jk
