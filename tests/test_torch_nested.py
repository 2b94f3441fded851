"""Nested documents on the port against the JAX package.

- Mapper and segment: a `nested` object parses into the JAX mapper's nested
  documents (tests/test_analysis_mapper.py's nested case and deeper ones),
  and SegmentBuilder freezes the JAX block layout: children first, type
  `__nested__`, the parent's id, `parent_mask` False, `nested_paths`
  (tests/test_engine.py `test_nested_docs_block_layout`). Tombstoning a
  parent tombstones its block, in place and copy-on-write; `merge_segments`
  walks the blocks as the JAX one does, array for array, and a store round
  trip keeps `nested_paths`.
- Kept behaviour of the JAX package, pinned: a merge rebuilds each child
  from its postings only, so a nested `range` on a child's number matches
  before an `_optimize` and nothing after it, on both packages.
- Packs: `pack_segment` of a nested segment equals the JAX pack plane by
  plane (children masked out of `blk_docs`, `live_parent`), and the
  compaction concat of nested sources equals `pack_segment(merged)` and
  the JAX concat, or both refuse.
- Queries: `_parent_of_map` and `child_match_to_parents` (every score mode,
  a query or a filter inside) bitwise; the nested query and filter on the
  host scorer, and a flat `match` on a nested index through `sparse_score`'s
  plain version, bitwise against the JAX host scorer and device path;
  `convert.segment_from_arrays` carries a JAX nested segment across and
  scores it the same.
- The percolator: a document with nested comments and a geo_point matches a
  registry of nested, geo_distance and flat queries as the JAX registry does.
- Node against node: the Elasticsearch 1.x guide's blog with nested comments
  (tests/test_search_single_shard.py `TestNested` and its filter-only
  syntax among the bodies) answers the JAX node's hits JSON and nested
  aggregations, before and after a DELETE of a post with comments and an
  `_optimize`.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.jaxenv import compile_tag
from elasticsearch_tpu.index.segment import SegmentBuilder as JBuilder
from elasticsearch_tpu.index.segment import merge_segments as jmerge_segments
from elasticsearch_tpu.mapper.core import MapperService as JMapperService
from elasticsearch_tpu_torch.convert import segment_from_arrays
from elasticsearch_tpu_torch.index.engine import Searcher
from elasticsearch_tpu_torch.index.segment import SegmentBuilder, merge_segments
from elasticsearch_tpu_torch.index.store import Store
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.ops.device_index import (pack_cache_key, pack_segment,
                                                      pack_segment_concat)
from tests.test_torch_node import call
from tests.test_torch_writes import (_jconcat, _jpack_live, _tpack_live,
                                     assert_matches_jax, assert_packs_equal)

CPU = torch.device("cpu")
WORDS = ["great", "terrible", "stuff", "mediocre", "post", "reply", "nice",
         "read", "long", "short"]
NAMES = ["alice", "bob", "carol", "dave", "erin"]
MAPPING = {"properties": {
    "title": {"type": "string"},
    "body": {"type": "string"},
    "comments": {"type": "nested", "properties": {
        "name": {"type": "string", "index": "not_analyzed"},
        "comment": {"type": "string"},
        "age": {"type": "integer"},
        "stars": {"type": "integer"},
        "date": {"type": "date"}}}}}


def _post(rng, i: int, max_comments: int = 4) -> dict:
    d = {"title": f"post {rng.choice(WORDS)} {i}",
         "body": " ".join(rng.choice(WORDS, size=int(rng.integers(3, 9))))}
    n = int(rng.integers(0, max_comments + 1))
    if n:
        d["comments"] = [{"name": str(rng.choice(NAMES)),
                          "comment": " ".join(rng.choice(WORDS, size=3)),
                          "age": int(rng.integers(18, 70)),
                          "stars": int(rng.integers(1, 6)),
                          "date": f"2014-0{int(rng.integers(1, 9))}-1{int(rng.integers(0, 9))}"}
                         for _ in range(n)]
        if n == 1 and i % 2:
            d["comments"] = d["comments"][0]  # a single object, not a list
    return d


def _posts(seed: int, n: int, start: int = 0) -> list[tuple[str, dict]]:
    rng = np.random.default_rng(seed)
    return [(str(start + i), _post(rng, start + i)) for i in range(n)]


def _services():
    jsvc, tsvc = JMapperService(), TMapperService()
    jsvc.put_mapping("doc", copy.deepcopy(MAPPING))
    tsvc.put_mapping("doc", copy.deepcopy(MAPPING))
    return jsvc, tsvc


def _segments(docs, gen: int = 1, deletes=()):
    """(JAX segment, port segment) of the same posts, `deletes` tombstoned
    by doc id (the parent's local id)."""
    jsvc, tsvc = _services()
    jb, tb = JBuilder(gen), SegmentBuilder(gen)
    jloc, tloc = {}, {}
    for doc_id, src in docs:
        jloc[doc_id] = jb.add(jsvc.mapper_for("doc").parse(copy.deepcopy(src), doc_id))
        tloc[doc_id] = tb.add(tsvc.mapper_for("doc").parse(copy.deepcopy(src), doc_id))
    jseg, tseg = jb.freeze(), tb.freeze()
    for doc_id in deletes:
        jseg.delete_doc(jloc[doc_id])
        tseg.delete_doc(tloc[doc_id])
    return jseg, tseg


SEG_ARRAYS = ("post_offsets", "post_docs", "post_freqs", "pos_offsets", "positions",
              "versions", "live", "parent_mask")


def assert_segments_equal(tseg, jseg):
    assert tseg.doc_count == jseg.doc_count
    assert tseg.term_dict == jseg.term_dict
    for name in SEG_ARRAYS:
        a, b = getattr(tseg, name), np.asarray(getattr(jseg, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("ids", "types", "routings", "nested_paths", "stored"):
        assert list(getattr(tseg, name)) == list(getattr(jseg, name)), name
    assert tseg.norms.keys() == jseg.norms.keys()
    for f in jseg.norms:
        assert np.array_equal(tseg.norms[f], jseg.norms[f]), f
    assert {f: dataclasses.asdict(s) for f, s in tseg.field_stats.items()} == \
        {f: dataclasses.asdict(s) for f, s in jseg.field_stats.items()}
    assert tseg.dv_num.keys() == jseg.dv_num.keys()
    for f, (off, vals) in jseg.dv_num.items():
        assert np.array_equal(tseg.dv_num[f][0], off) and \
            np.array_equal(tseg.dv_num[f][1], vals), f
    assert tseg.dv_str.keys() == jseg.dv_str.keys()
    for f, (uniq, off, ords) in jseg.dv_str.items():
        tu, to, tords = tseg.dv_str[f]
        assert list(tu) == list(uniq) and np.array_equal(to, off) \
            and np.array_equal(tords, ords), f


# --- mapper and segment -----------------------------------------------------


@pytest.mark.parametrize("src", [
    {"user": {"name": "alice smith"},
     "comments": [{"comment": "first post"}, {"comment": "second"}]},
    {"comments": {"name": "bob", "stars": 4, "age": 30}},
    {"title": "no comments", "comments": []},
    {"comments": [{"name": "x", "extra": {"deep": "object inside"}},
                  {"comment": "two", "stars": 2, "date": "2014-09-01"}]},
], ids=["analysis_mapper_case", "single_object", "empty", "object_inside"])
def test_nested_parse_matches_jax(src):
    from tests.test_torch_mapper_breadth import _parsed

    jsvc, tsvc = _services()
    jdoc = jsvc.mapper_for("doc").parse(copy.deepcopy(src), "1")
    tdoc = tsvc.mapper_for("doc").parse(copy.deepcopy(src), "1")
    assert _parsed(tdoc) == _parsed(jdoc)
    assert [(p, _parsed(d)) for p, d in tdoc.nested_docs] == \
        [(p, _parsed(d)) for p, d in jdoc.nested_docs]
    assert tsvc.mappings_dict() == jsvc.mappings_dict()


def test_block_layout_matches_jax():
    jseg, tseg = _segments(_posts(1, 40))
    assert_segments_equal(tseg, jseg)
    assert (~tseg.parent_mask).sum() > 20
    assert {t for t, pm in zip(tseg.types, tseg.parent_mask) if not pm} == {"__nested__"}
    # tests/test_engine.py test_nested_docs_block_layout's post
    jseg, tseg = _segments([("1", {"title": "post", "comments": [
        {"comment": "aa"}, {"comment": "bb"}]})])
    assert tseg.parent_mask.tolist() == [False, False, True]
    assert tseg.nested_paths == ["comments", "comments", None]
    assert tseg.live_count() == 1
    assert_segments_equal(tseg, jseg)


def test_tombstoning_a_parent_tombstones_its_block():
    docs = _posts(2, 30)
    with_children = [d for d, s in docs if isinstance(s.get("comments"), list)][:3]
    jseg, tseg = _segments(docs, deletes=with_children)
    assert_segments_equal(tseg, jseg)
    assert (~tseg.live).sum() > len(with_children)
    # copy-on-write: the old view keeps its bitmap, the new one loses the block
    jseg2, tseg2 = _segments(docs)
    local = next(i for i, (d, pm) in enumerate(zip(tseg2.ids, tseg2.parent_mask))
                 if d == with_children[0] and pm)
    tview, jview = tseg2.with_deletes([local]), jseg2.with_deletes([local])
    assert tseg2.live.all()
    assert np.array_equal(tview.live, jview.live)
    assert tview.live_count() == jview.live_count() == tseg2.live_count() - 1


@pytest.mark.parametrize("deletes", [(), ("103", "210", "211", "314")],
                         ids=["live", "tombstoned"])
def test_merge_segments_matches_jax(deletes):
    sources = [_segments(_posts(s, 15, start=100 * s), gen=s,
                         deletes=[d for d in deletes if d[0] == str(s)])
               for s in (1, 2, 3)]
    jm = jmerge_segments([j for j, _t in sources], 9)
    tm = merge_segments([t for _j, t in sources], 9)
    assert_segments_equal(tm, jm)
    # the children's doc values are gone after the merge (kept behaviour)
    assert not any(f.startswith("comments.") for f in tm.dv_num)
    assert any(f.startswith("comments.") for _j, t in sources for f in t.dv_num)


def test_store_round_trip_keeps_the_blocks(tmp_path):
    _jseg, tseg = _segments(_posts(4, 20), gen=7)
    store = Store(str(tmp_path))
    files = store.write_segment(tseg)
    back = store.read_segment(7, verify=files)
    assert back.nested_paths == tseg.nested_paths
    assert np.array_equal(back.parent_mask, tseg.parent_mask)
    assert back.types == tseg.types and back.ids == tseg.ids


def test_merge_drops_childrens_doc_values_on_both_engines(tmp_path):
    """Kept behaviour of the JAX package: a nested `range` on
    `comments.stars` matches 2 parents over two segments and none after an
    `_optimize` to one segment, on both packages."""
    from elasticsearch_tpu.index.engine import Engine as JEngine
    from elasticsearch_tpu.search import ShardContext as JShardContext
    from elasticsearch_tpu.search import parse_query as jparse_query
    from elasticsearch_tpu.search import search_shard as jsearch_shard
    from elasticsearch_tpu_torch.index.engine import Engine as TEngine
    from elasticsearch_tpu_torch.search import ShardContext, parse_query, search_shard

    q = {"nested": {"path": "comments", "query": {"range": {"comments.stars": {"gte": 4}}}}}
    jsvc, tsvc = _services()
    counts = []
    for svc, make_eng, make_ctx, parse, search, kw in (
            (jsvc, JEngine, JShardContext, jparse_query, jsearch_shard, {}),
            (tsvc, TEngine, ShardContext, parse_query, search_shard, {"device": "cpu"})):
        eng = make_eng(str(tmp_path / make_eng.__module__), svc)
        try:
            eng.index("doc", "1", {"title": "a", "comments": [{"stars": 5}, {"stars": 1}]})
            eng.refresh()
            eng.index("doc", "2", {"title": "b", "comments": [{"stars": 4}]})
            eng.index("doc", "3", {"title": "c", "comments": [{"stars": 2}]})
            eng.refresh()
            seen = []
            for step in ("two segments", "optimized"):
                if step == "optimized":
                    eng.optimize()
                ctx = make_ctx(eng.acquire_searcher(), svc, **kw)
                seen.append((len(ctx.searcher.segments),
                             search(ctx, parse(q), 10, use_device=False).total))
            counts.append(seen)
        finally:
            eng.close()
    assert counts[0] == counts[1] == [(2, 2), (1, 0)]


# --- packs -------------------------------------------------------------------


def _jax_pack(jseg):
    from elasticsearch_tpu.ops.device_index import pack_segment as jpack

    with compile_tag("pack"):
        return jpack(jseg)


@pytest.mark.parametrize("deletes", [(), ("2", "9")], ids=["live", "tombstoned"])
def test_pack_of_a_nested_segment_matches_jax_plane_by_plane(deletes):
    jseg, tseg = _segments(_posts(5, 50), deletes=deletes)
    jp, tp = _jax_pack(jseg), pack_segment(tseg, CPU)
    NB = int(jp.term_blk_start[-1])
    assert np.array_equal(tp.term_blk_start, jp.term_blk_start)
    assert tp.tf_layout == jp.tf_layout and tp.doc_pad == jp.doc_pad
    tdocs, jdocs = tp.blk_docs.numpy(), np.asarray(jp.blk_docs)
    assert np.array_equal(tdocs[:NB], jdocs[:NB])
    assert (tdocs[NB:] == tp.doc_pad).all()
    for plane in ("blk_tf", "blk_nb"):
        t, j = getattr(tp, plane).numpy()[:NB], np.asarray(getattr(jp, plane))[:NB]
        assert t.dtype == j.dtype and t.tobytes() == j.tobytes(), plane
    n = jseg.doc_count
    assert np.array_equal(tp.live_parent.numpy()[:n], np.asarray(jp.live_parent)[:n])
    children = np.nonzero(~tseg.parent_mask)[0]
    assert len(children) and not np.isin(tdocs[:NB], children).any()
    assert not tp.live_parent.numpy()[children].any()
    for f, col in jp.norm_bytes.items():
        assert np.array_equal(tp.norm_bytes[f].numpy()[:n], np.asarray(col)[:n]), f


def test_concat_of_nested_sources_is_the_merged_pack_or_refused_as_jax():
    live = [_segments(_posts(s, 12, start=100 * s), gen=s) for s in (1, 2)]
    for jseg, tseg in live:
        _jpack_live(jseg)
        _tpack_live(tseg)
    jm = jmerge_segments([j for j, _t in live], 9)
    tm = merge_segments([t for _j, t in live], 9)
    jgot = _jconcat(jm, [j for j, _t in live])
    got = pack_segment_concat(tm, [t for _j, t in live], CPU)
    assert got is not None and jgot is not None  # fully live sources concat
    assert_packs_equal(got, pack_segment(tm, CPU))
    assert_matches_jax(got, jgot)
    # a tombstoned block: both refuse (the merge drops its postings)
    dead = [_segments(_posts(3, 12, start=300), gen=3, deletes=("301",)),
            _segments(_posts(4, 12, start=400), gen=4)]
    for jseg, tseg in dead:
        _jpack_live(jseg)
        _tpack_live(tseg)
    jm = jmerge_segments([j for j, _t in dead], 10)
    tm = merge_segments([t for _j, t in dead], 10)
    assert pack_segment_concat(tm, [t for _j, t in dead], CPU) is None
    assert _jconcat(jm, [j for j, _t in dead]) is None


# --- queries -------------------------------------------------------------------


@pytest.fixture(scope="module")
def shard_pair(tmp_path_factory):
    """Both packages' engines over the same posts in three segments, a post
    with comments deleted; (JAX context, port context)."""
    from elasticsearch_tpu.index.engine import Engine as JEngine
    from elasticsearch_tpu.search import ShardContext as JShardContext
    from elasticsearch_tpu_torch.index.engine import Engine as TEngine
    from elasticsearch_tpu_torch.search import ShardContext

    jsvc, tsvc = _services()
    jeng = JEngine(str(tmp_path_factory.mktemp("nested_j")), jsvc)
    teng = TEngine(str(tmp_path_factory.mktemp("nested_t")), tsvc)
    docs = _posts(6, 120)
    for eng in (jeng, teng):
        for n, (doc_id, src) in enumerate(docs):
            eng.index("doc", doc_id, copy.deepcopy(src))
            if n in (50, 90):
                eng.refresh()
        eng.delete("doc", next(d for d, s in docs if isinstance(s.get("comments"), list)))
        eng.refresh()
    try:
        yield (JShardContext(jeng.acquire_searcher(), jsvc),
               ShardContext(teng.acquire_searcher(), tsvc, device="cpu"))
    finally:
        jeng.close()
        teng.close()


@pytest.mark.parametrize("score_mode", ["avg", "sum", "total", "max", "none"])
@pytest.mark.parametrize("inner", [
    {"match": {"comments.comment": "great stuff"}},
    {"filter": {"range": {"comments.stars": {"gte": 3}}}},
], ids=["query", "filter"])
def test_child_match_to_parents_matches_jax(shard_pair, score_mode, inner):
    from elasticsearch_tpu.search.execute import _parent_of_map as jparent_of
    from elasticsearch_tpu.search.execute import child_match_to_parents as jcmp
    from elasticsearch_tpu.search.queries import parse_filter as jparse_filter
    from elasticsearch_tpu.search.queries import parse_query as jparse_query
    from elasticsearch_tpu_torch.search.execute import _parent_of_map, child_match_to_parents
    from elasticsearch_tpu_torch.search.queries import parse_filter, parse_query

    jctx, tctx = shard_pair
    if "filter" in inner:
        jq, tq = jparse_filter(inner["filter"]), parse_filter(inner["filter"])
    else:
        jq, tq = jparse_query(inner), parse_query(inner)
    hit = False
    for jseg, tseg in zip(jctx.searcher.segments, tctx.searcher.segments):
        assert np.array_equal(_parent_of_map(tseg), jparent_of(jseg))
        tm, ts = child_match_to_parents(tseg, tctx, "comments", tq, score_mode, 0.5)
        jm, js = jcmp(jseg, jctx, "comments", jq, score_mode, 0.5)
        assert np.array_equal(tm, jm) and ts.tobytes() == js.tobytes()
        hit |= bool(tm.any())
    assert hit


NESTED_QUERIES = {
    "nested_avg": {"nested": {"path": "comments", "score_mode": "avg",
                              "query": {"match": {"comments.comment": "great stuff"}}}},
    "nested_max_boost": {"nested": {"path": "comments", "score_mode": "max", "boost": 2,
                                    "query": {"match": {"comments.comment": "nice read"}}}},
    "nested_in_bool": {"bool": {"must": [{"match": {"body": "post long"}}],
                                "should": [{"nested": {"path": "comments", "query": {
                                    "term": {"comments.name": "alice"}}}}]}},
    "bool_nested_range_filter": {"bool": {"must": [{"match_all": {}}], "filter": [
        {"nested": {"path": "comments",
                    "query": {"range": {"comments.stars": {"gte": 4}}}}}]}},
    "nested_filter_only_syntax": {"nested": {"path": "comments", "filter": {
        "exists": {"field": "comments.date"}}}},
    "constant_nested_filter": {"constant_score": {"filter": {"nested": {
        "path": "comments", "filter": {"term": {"comments.name": "bob"}}}}}},
}


@pytest.mark.parametrize("name", list(NESTED_QUERIES))
def test_nested_queries_on_the_host_scorer_match_jax(shard_pair, name):
    from elasticsearch_tpu.search import parse_query as jparse_query
    from elasticsearch_tpu.search.execute import search_shard_batch as jbatch
    from elasticsearch_tpu_torch.search import parse_query, search_shard_batch

    jctx, tctx = shard_pair
    q = NESTED_QUERIES[name]
    (td,) = search_shard_batch(tctx, [parse_query(q)], 20, use_device=False)
    (jtd,) = jbatch(jctx, [jparse_query(q)], 20, use_device=False)
    assert (td.total, td.hits) == (jtd.total, jtd.hits) and td.total > 0


def test_flat_match_on_a_nested_index_is_the_sparse_path_bitwise(shard_pair):
    """A flat `match` / `bool` on a nested index lowers to `sparse_score`
    (its plain version here) over packs whose children are masked out."""
    from elasticsearch_tpu.search import parse_query as jparse_query
    from elasticsearch_tpu.search.execute import search_shard_batch as jbatch
    from elasticsearch_tpu_torch.search import parse_query, search_shard_batch
    from elasticsearch_tpu_torch.search.execute import lower_flat

    jctx, tctx = shard_pair
    qs = [{"match": {"body": "great stuff post"}},
          {"match": {"title": "post reply"}},
          {"bool": {"should": [{"term": {"body": "nice"}}, {"term": {"body": "long"}}],
                    "must_not": [{"term": {"body": "short"}}]}},
          {"match": {"comments.comment": "great"}}]  # children only: no hit
    assert all(lower_flat(parse_query(q), tctx) is not None for q in qs)
    got = search_shard_batch(tctx, [parse_query(q) for q in qs], 20)
    with compile_tag("sparse"):
        want = jbatch(jctx, [jparse_query(q) for q in qs], 20, use_device=True)
    assert [(t.total, t.hits) for t in got] == [(t.total, t.hits) for t in want]
    assert got[0].total > 0 and got[3].total == 0
    for seg in tctx.searcher.segments:
        assert seg._device_cache.get(pack_cache_key(CPU)) is not None


def test_convert_carries_a_jax_nested_segment_across():
    """A JAX nested segment through `segment_from_arrays` (ids, types,
    nested_paths, the `_parent`-free dv columns): the sparse path and the
    nested query answer as the JAX package does, bitwise."""
    from elasticsearch_tpu.search import ShardContext as JShardContext
    from elasticsearch_tpu.search import parse_query as jparse_query
    from elasticsearch_tpu.search.execute import search_shard_batch as jbatch
    from elasticsearch_tpu.index.engine import Searcher as JSearcher
    from elasticsearch_tpu_torch.search import ShardContext, parse_query, search_shard_batch

    jseg, _t = _segments(_posts(8, 60), deletes=("4",))
    conv = segment_from_arrays(
        jseg.term_dict, np.asarray(jseg.post_offsets), np.asarray(jseg.post_docs),
        np.asarray(jseg.post_freqs), {f: np.asarray(a) for f, a in jseg.norms.items()},
        {f: dataclasses.asdict(s) for f, s in jseg.field_stats.items()},
        np.asarray(jseg.live), np.asarray(jseg.parent_mask), gen=jseg.gen,
        ids=list(jseg.ids), types=list(jseg.types), nested_paths=list(jseg.nested_paths),
        dv_num=dict(jseg.dv_num), dv_str=dict(jseg.dv_str), routings=list(jseg.routings))
    with pytest.raises(ValueError, match="nested"):
        segment_from_arrays(jseg.term_dict, np.asarray(jseg.post_offsets),
                            np.asarray(jseg.post_docs), np.asarray(jseg.post_freqs),
                            {f: np.asarray(a) for f, a in jseg.norms.items()},
                            {f: dataclasses.asdict(s) for f, s in jseg.field_stats.items()},
                            np.asarray(jseg.live), np.asarray(jseg.parent_mask))
    jsvc, tsvc = _services()
    jctx = JShardContext(JSearcher([jseg]), jsvc)
    tctx = ShardContext(Searcher([conv]), tsvc, device="cpu")
    flat = [{"match": {"body": "great stuff post"}}, {"match": {"title": "post"}}]
    got = search_shard_batch(tctx, [parse_query(q) for q in flat], 30)
    with compile_tag("sparse"):
        want = jbatch(jctx, [jparse_query(q) for q in flat], 30, use_device=True)
    assert [(t.total, t.hits) for t in got] == [(t.total, t.hits) for t in want]
    nq = NESTED_QUERIES["nested_avg"]
    (td,) = search_shard_batch(tctx, [parse_query(nq)], 30, use_device=False)
    (jtd,) = jbatch(jctx, [jparse_query(nq)], 30, use_device=False)
    assert (td.total, td.hits) == (jtd.total, jtd.hits) and td.total > 0


def test_percolating_a_nested_geo_document_matches_the_jax_registry():
    from elasticsearch_tpu.percolator import PercolatorRegistry as JRegistry
    from elasticsearch_tpu_torch.percolator import PercolatorRegistry
    from elasticsearch_tpu_torch.search.service import SERVING_COUNTERS

    mapping = copy.deepcopy(MAPPING)
    mapping["properties"]["location"] = {"type": "geo_point"}
    jsvc, tsvc = JMapperService(), TMapperService()
    jsvc.put_mapping("doc", copy.deepcopy(mapping))
    tsvc.put_mapping("doc", copy.deepcopy(mapping))
    rng = np.random.default_rng(12)
    queries = []
    for i in range(150):
        kind = i % 6
        if kind == 0:
            queries.append({"nested": {"path": "comments", "query": {
                "match": {"comments.comment": str(rng.choice(WORDS))}}}})
        elif kind == 1:
            queries.append({"nested": {"path": "comments", "query": {
                "range": {"comments.stars": {"gte": int(rng.integers(1, 6))}}}}})
        elif kind == 2:
            queries.append({"filtered": {"query": {"match_all": {}}, "filter": {
                "geo_distance": {"distance": f"{int(rng.integers(1, 800))}km",
                                 "location": {"lat": 51.5, "lon": -0.12}}}}})
        else:
            queries.append({"match": {"body": " ".join(rng.choice(WORDS, size=2))}})
    preg, jreg = PercolatorRegistry(), JRegistry()
    for i, q in enumerate(queries):
        preg.register(f"q{i}", {"query": q})
        jreg.register(f"q{i}", {"query": q})
    doc = {"title": "a post", "body": "great stuff nice read",
           "location": {"lat": 48.86, "lon": 2.35},
           "comments": [{"name": "alice", "comment": "great post", "stars": 4},
                        {"name": "bob", "comment": "terrible stuff", "stars": 1}]}
    before = SERVING_COUNTERS["device_percolate"]
    got = preg.percolate(copy.deepcopy(doc), tsvc, device="cpu")
    want = jreg.percolate(copy.deepcopy(doc), jsvc)
    assert got == want
    assert SERVING_COUNTERS["device_percolate"] == before + 1
    kinds = {int(m[1:]) % 6 for m in got}
    assert {0, 1, 2} <= kinds and (kinds & {3, 4, 5})


# --- node against node -----------------------------------------------------------

NODE_POSTS = 160


def _fill_blog(base):
    st, r = call(base, "PUT", "/blog", {"settings": {
        "number_of_shards": 3, "number_of_replicas": 0, "refresh_interval": -1},
        "mappings": {"blogpost": MAPPING}})
    assert st == 200, r
    docs = _posts(9, NODE_POSTS)
    # tests/test_search_single_shard.py TestNested's three posts
    docs[:3] = [("1", {"title": "post one", "comments": [
                    {"comment": "great stuff", "stars": 5}, {"comment": "terrible", "stars": 1}]}),
                ("2", {"title": "post two", "comments": [
                    {"comment": "mediocre stuff", "stars": 3}]}),
                ("3", {"title": "no comments"})]
    for n, (doc_id, src) in enumerate(docs):
        st, r = call(base, "PUT", f"/blog/blogpost/{doc_id}", src)
        assert st in (200, 201), r
        if n in (60, 120):
            call(base, "POST", "/blog/_refresh")
    call(base, "POST", "/blog/_refresh")


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    from tests.test_torch_parent_child import _node_pair

    yield from _node_pair(tmp_path_factory, _fill_blog)


NODE_BODIES = {
    "test_nested_query": {"query": {"nested": {
        "path": "comments", "query": {"match": {"comments.comment": "stuff"}}}}},
    "test_nested_filter_in_bool": {"query": {"bool": {
        "must": [{"match_all": {}}],
        "filter": [{"nested": {"path": "comments",
                               "query": {"range": {"comments.stars": {"gte": 4}}}}}]}}},
    "filter_only_syntax": {"query": {"nested": {
        "path": "comments", "filter": {"exists": {"field": "comments.name"}}}}},
    "score_mode_sum": {"query": {"nested": {"path": "comments", "score_mode": "sum",
                                            "query": {"match": {"comments.comment": "great nice"}}}},
                       "size": 15},
    "flat_match": {"query": {"match": {"body": "great stuff read"}}, "size": 15},
    "nested_agg": {"size": 0, "query": {"match": {"body": "post"}}, "aggs": {
        "c": {"nested": {"path": "comments"}, "aggs": {
            "avg_stars": {"avg": {"field": "comments.stars"}},
            "by_name": {"terms": {"field": "comments.name"}}}}}},
}


def _same(nodes, body):
    pbase, jbase, _p, _j = nodes
    jbody = dict(body, request_cache=False) if body.get("size") == 0 else body
    (pst, pr), (jst, jr) = (call(pbase, "POST", "/blog/_search", body),
                            call(jbase, "POST", "/blog/_search", jbody))
    assert pst == jst == 200, (pr, jr)
    assert pr["_shards"] == jr["_shards"]
    assert pr["hits"] == jr["hits"]
    assert pr.get("aggregations") == jr.get("aggregations")
    return pr


@pytest.mark.parametrize("name", list(NODE_BODIES))
def test_blog_bodies_match_jax_node(nodes, name):
    r = _same(nodes, NODE_BODIES[name])
    assert r["hits"]["total"] > 0


def test_delete_and_optimize_match_jax_node(nodes):
    """A DELETE of a post with comments takes its children out of every
    count; after `_optimize` the children's doc values are gone on both
    (the nested range matches nothing), the rest unchanged."""
    pbase, jbase, _p, _j = nodes
    agg = {"size": 0, "aggs": NODE_BODIES["nested_agg"]["aggs"]}
    before = _same(nodes, agg)["aggregations"]["c"]["doc_count"]
    for base in (pbase, jbase):
        st, r = call(base, "DELETE", "/blog/blogpost/1")
        assert st == 200 and r["found"], r
        call(base, "POST", "/blog/_refresh")
    after = _same(nodes, agg)["aggregations"]["c"]["doc_count"]
    assert after < before
    assert _same(nodes, NODE_BODIES["test_nested_query"])["hits"]["total"] > 0
    for base in (pbase, jbase):
        st, r = call(base, "POST", "/blog/_optimize")
        assert st == 200, r
    ranged = _same(nodes, NODE_BODIES["test_nested_filter_in_bool"])
    assert ranged["hits"]["total"] == 0
    for name in ("test_nested_query", "flat_match", "filter_only_syntax"):
        assert _same(nodes, NODE_BODIES[name])["hits"]["total"] > 0
