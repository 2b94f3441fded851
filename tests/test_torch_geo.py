"""Geo fields on the port against the JAX package.

- `common/geo.py` function for function (tests/test_spans_geo.py
  `TestGeohash`, `TestShapeGeometry` and the geometry of
  `TestReviewRegressions`): geohash encode, decode, cell bounds and
  neighbours, shape normalization and the intersect / within relations over
  seeded points and shapes, the scalar and the vectorized `haversine_m` and
  `parse_distance`, all equal (floats bitwise).
- The mapper: `geo_point` in its four spellings, multi-valued, into the
  `field.lat` / `field.lon` columns; `geo_shape` into the string doc values;
  the same errors.
- Every geo filter's per-segment mask over a seeded two-segment shard with
  tombstones equals the JAX package's (bitwise: the same float64
  `haversine_m`); `filtered` with a geo filter rides the dense family, a geo
  decay the function_score rows family, the `_geo_distance` sort the host
  path, and the geo buckets the aggregating launch, each against the JAX
  package's device path and host path (tests/test_torch_aggs.py `_both`:
  hits within 2 ulp tie-tolerant on the card, bitwise on the host; counts,
  keys, min and max exact).
- Node against node: tests/test_spans_geo.py `TestGeoFilters`,
  tests/test_dsl_long_tail.py `TestGeoFilters`, tests/test_search_runtime.py's
  `geo_distance` aggregation and `_geo_distance` sort and
  tests/test_device_aggs.py `test_geo_bucket_aggs_parity` over REST, with
  the JAX node's hits JSON and aggregations.
"""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest

import elasticsearch_tpu.common.geo as jgeo
import elasticsearch_tpu_torch.common.geo as tgeo
from elasticsearch_tpu.common.errors import MapperParsingError as JMapperParsingError
from elasticsearch_tpu.common.errors import QueryParsingError as JQueryParsingError
from elasticsearch_tpu.mapper.core import MapperService as JMapperService
from elasticsearch_tpu.search.filters import haversine_m as jhaversine_m
from elasticsearch_tpu.search.filters import parse_distance as jparse_distance
from elasticsearch_tpu.search.filters import segment_mask as jsegment_mask
from elasticsearch_tpu.search.queries import parse_filter as jparse_filter
from elasticsearch_tpu_torch.common.errors import MapperParsingError, QueryParsingError
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.search.filters import haversine_m, parse_distance, segment_mask
from elasticsearch_tpu_torch.search.queries import parse_filter
from tests.test_torch_aggs import BM25, _both, _pair
from tests.test_torch_dense import _tie_tolerant_equal, _within_ulps
from tests.test_torch_node import call

# --- common/geo.py ------------------------------------------------------------


def _points(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-90, 90, n), rng.uniform(-180, 180, n)], axis=1)


@pytest.mark.parametrize("precision", [1, 2, 3, 5, 7, 9, 12])
def test_geohash_functions_match_jax(precision):
    for lat, lon in _points(precision, 200):
        h = tgeo.geohash_encode(float(lat), float(lon), precision)
        assert h == jgeo.geohash_encode(float(lat), float(lon), precision)
        assert tgeo.geohash_bbox(h) == jgeo.geohash_bbox(h)
        assert tgeo.geohash_decode(h) == jgeo.geohash_decode(h)
        assert tgeo.geohash_neighbors(h) == jgeo.geohash_neighbors(h)
    assert tgeo.geohash_encode(57.64911, 10.40744, 11) == "u4pruydqqvj"
    for bad in ("", "a!"):
        with pytest.raises((ValueError, KeyError)) as terr:
            tgeo.geohash_bbox(bad)
        with pytest.raises((ValueError, KeyError)) as jerr:
            jgeo.geohash_bbox(bad)
        assert type(terr.value) is type(jerr.value)


def _shape_specs(seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = [
        {"type": "polygon", "coordinates": [
            [[0, 0], [10, 0], [10, 10], [0, 10], [0, 0]],
            [[4, 4], [6, 4], [6, 6], [4, 6], [4, 4]]]},  # the donut
        {"type": "polygon", "coordinates": [[[2, -1], [3, -1], [3, 5], [2, 5], [2, -1]]]},
        {"type": "envelope", "coordinates": [[3, 7], [7, 3]]},
        {"type": "envelope", "coordinates": [[1, 3], [3, 1]]},
        {"type": "point", "coordinates": [5, 5]},
        {"type": "point", "coordinates": [2, 2]},
    ]
    for _ in range(10):
        x, y = rng.uniform(-5, 12, 2)
        w, h = rng.uniform(0.5, 6, 2)
        kind = int(rng.integers(3))
        if kind == 0:
            out.append({"type": "point", "coordinates": [float(x), float(y)]})
        elif kind == 1:
            out.append({"type": "envelope", "coordinates": [[float(x), float(y + h)],
                                                            [float(x + w), float(y)]]})
        else:
            out.append({"type": "polygon", "coordinates": [[
                [float(x), float(y)], [float(x + w), float(y)],
                [float(x + w / 2), float(y + h)], [float(x), float(y)]]]})
    return out


def test_shape_relations_match_jax():
    specs = _shape_specs(4)
    tshapes = [tgeo.normalize_shape(copy.deepcopy(s)) for s in specs]
    jshapes = [jgeo.normalize_shape(copy.deepcopy(s)) for s in specs]
    assert tshapes == jshapes
    hits = 0
    for a, ja in zip(tshapes, jshapes):
        assert tgeo.shape_bbox(a) == jgeo.shape_bbox(ja)
        for b, jb in zip(tshapes, jshapes):
            assert tgeo.shapes_intersect(a, b) == jgeo.shapes_intersect(ja, jb)
            assert tgeo.shape_within(a, b) == jgeo.shape_within(ja, jb)
            hits += tgeo.shape_within(a, b)
    assert hits > len(specs)
    # TestShapeGeometry / TestReviewRegressions: holes and edge crossings
    donut, crossing, covers_hole, clear, in_hole, in_ring = tshapes[:6]
    assert not tgeo.shapes_intersect(donut, in_hole) and tgeo.shapes_intersect(donut, in_ring)
    assert tgeo.shapes_intersect(donut, crossing) and not tgeo.shape_within(crossing, donut)
    assert not tgeo.shape_within(covers_hole, donut) and tgeo.shape_within(clear, donut)
    for bad in ({"type": "circle", "coordinates": [0, 0]}, {"type": "point"},
                {"type": "polygon", "coordinates": [[[0, 0], [1, 1]]]}):
        with pytest.raises(ValueError) as terr:
            tgeo.normalize_shape(bad)
        with pytest.raises(ValueError) as jerr:
            jgeo.normalize_shape(bad)
        assert str(terr.value) == str(jerr.value)


def test_haversine_and_distances_match_jax():
    pts = _points(7, 500)
    for (a, b), (c, d) in zip(pts[:250], pts[250:]):
        assert tgeo.haversine_m(a, b, c, d) == jgeo.haversine_m(a, b, c, d)
    got = haversine_m(52.37, 4.89, pts[:, 0], pts[:, 1])
    want = jhaversine_m(52.37, 4.89, pts[:, 0], pts[:, 1])
    assert got.dtype == want.dtype == np.float64 and got.tobytes() == want.tobytes()
    for s in ("50km", "2mi", 1500, "3.5 nmi", "12ft", "7", "10yd", "1.25kilometers"):
        assert parse_distance(s) == jparse_distance(s)
    with pytest.raises(QueryParsingError):
        parse_distance("far")
    with pytest.raises(JQueryParsingError):
        jparse_distance("far")


# --- the mapper -----------------------------------------------------------------

GEO_MAPPING = {"properties": {"body": {"type": "string"},
                              "loc": {"type": "geo_point"},
                              "area": {"type": "geo_shape"}}}


@pytest.mark.parametrize("src", [
    {"loc": {"lat": 52.37, "lon": 4.89}},
    {"loc": "52.52,13.40"},
    {"loc": [-122.42, 37.77]},
    {"loc": "u33dc0cppj"},
    {"loc": [{"lat": 1.0, "lon": 2.0}, {"lat": 3.0, "lon": 4.0}]},
    {"loc": ["1.5,2.5", [4.0, 3.0], {"lat": -5, "lon": 6}]},
    {"area": {"type": "polygon", "coordinates": [[[13.0, 52.0], [14.0, 52.0],
                                                  [14.0, 53.0], [13.0, 52.0]]]}},
    {"area": [{"type": "point", "coordinates": [1, 2]},
              {"type": "envelope", "coordinates": [[0, 5], [5, 0]]}]},
])
def test_geo_parse_matches_jax(src):
    from tests.test_torch_mapper_breadth import _parsed

    jsvc, tsvc = JMapperService(), TMapperService()
    jsvc.put_mapping("doc", copy.deepcopy(GEO_MAPPING))
    tsvc.put_mapping("doc", copy.deepcopy(GEO_MAPPING))
    jdoc = jsvc.mapper_for("doc").parse(copy.deepcopy(src), "1")
    tdoc = tsvc.mapper_for("doc").parse(copy.deepcopy(src), "1")
    assert _parsed(tdoc) == _parsed(jdoc)


@pytest.mark.parametrize("src", [{"loc": ""}, {"loc": 5}, {"loc": "not!hash"},
                                 {"area": "a string"},
                                 {"area": {"type": "blob", "coordinates": []}}],
                         ids=["empty_geohash", "number", "bad_geohash", "shape_string",
                              "shape_type"])
def test_geo_parse_errors_match_jax(src):
    jsvc, tsvc = JMapperService(), TMapperService()
    jsvc.put_mapping("doc", copy.deepcopy(GEO_MAPPING))
    tsvc.put_mapping("doc", copy.deepcopy(GEO_MAPPING))
    with pytest.raises(JMapperParsingError) as jerr:
        jsvc.mapper_for("doc").parse(copy.deepcopy(src), "1")
    with pytest.raises(MapperParsingError) as terr:
        tsvc.mapper_for("doc").parse(copy.deepcopy(src), "1")
    assert str(terr.value) == str(jerr.value)


# --- filters, decay, sort and buckets on a shard --------------------------------

CITIES = [(52.37, 4.89), (52.52, 13.40), (48.86, 2.35), (37.77, -122.42),
          (51.5, -0.12), (40.71, -74.0)]
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon"]


def _geo_docs() -> list[dict]:
    rng = np.random.default_rng(31)
    out = []
    for i in range(360):
        lat, lon = CITIES[i % len(CITIES)]
        d = {"body": " ".join(rng.choice(WORDS, size=4)),
             "likes": int(rng.integers(1, 50)),
             "loc": {"lat": float(lat + rng.normal(0, 0.4)),
                     "lon": float(lon + rng.normal(0, 0.4))}}
        if i % 9 == 0:  # a second point
            d["loc"] = [d["loc"], {"lat": float(rng.uniform(-60, 60)),
                                   "lon": float(rng.uniform(-170, 170))}]
        if i % 13 == 0:
            d.pop("loc")
        if i % 4 == 0:
            x, y = float(lon + rng.normal(0, 1)), float(lat + rng.normal(0, 1))
            d["area"] = ({"type": "envelope", "coordinates": [[x, y + 0.5], [x + 0.5, y]]}
                         if i % 8 else {"type": "point", "coordinates": [x, y]})
        out.append(d)
    return out


@pytest.fixture(scope="module")
def geo_ctxs(tmp_path_factory):
    mapping = {"properties": {"loc": {"type": "geo_point"}, "area": {"type": "geo_shape"},
                              "likes": {"type": "integer"}}}
    jctx, tctx, engines = _pair(tmp_path_factory, _geo_docs(), settings=BM25,
                                mapping=mapping, refresh_at=179, deletes=(6, 60, 250))
    try:
        yield jctx, tctx
    finally:
        for e in engines:
            e.close()


AMSTERDAM = {"lat": 52.37, "lon": 4.89}
GEO_FILTERS = {
    "distance": {"geo_distance": {"distance": "50km", "loc": AMSTERDAM}},
    "distance_latlon_string": {"geo_distance": {"distance": "700km", "loc": "48.86,2.35"}},
    "distance_array": {"geo_distance": {"distance": 120000, "loc": [13.40, 52.52]}},
    "range": {"geo_distance_range": {"from": "500km", "to": "1000km", "loc": AMSTERDAM}},
    "range_gt_lt": {"geo_distance_range": {"gt": "0km", "lt": "500km", "loc": AMSTERDAM}},
    "range_gte_lte": {"geo_distance_range": {"gte": "100km", "lte": "6000km",
                                             "loc": "40.71,-74.0"}},
    "bbox": {"geo_bounding_box": {"loc": {"top_left": {"lat": 55, "lon": 0},
                                          "bottom_right": {"lat": 45, "lon": 15}}}},
    "bbox_arrays": {"geo_bounding_box": {"loc": {"top_left": [-125, 45],
                                                 "bottom_right": [-70, 30]}}},
    "bbox_dateline": {"geo_bounding_box": {"loc": {"top": 60, "left": 170,
                                                   "bottom": -60, "right": -100}}},
    "polygon": {"geo_polygon": {"loc": {"points": [
        {"lat": 60.0, "lon": 0.0}, {"lat": 60.0, "lon": 20.0},
        {"lat": 40.0, "lon": 10.0}, {"lat": 40.0, "lon": -5.0}]}}},
    "polygon_closed": {"geo_polygon": {"loc": {"points": [
        "41,-76", "41,-72", "39,-72", "39,-76", "41,-76"]}}},
    "geohash_cell": {"geohash_cell": {"loc": AMSTERDAM, "precision": 3}},
    "geohash_cell_neighbors": {"geohash_cell": {"loc": "u33", "neighbors": True}},
    "geohash_cell_latlon": {"geohash_cell": {"loc": "37.77,-122.42", "precision": 2}},
    "shape_intersects": {"geo_shape": {"area": {"shape": {
        "type": "envelope", "coordinates": [[3.0, 54.0], [8.0, 50.0]]}}}},
    "shape_within": {"geo_shape": {"area": {"relation": "within", "shape": {
        "type": "polygon", "coordinates": [[[-2, 45], [20, 45], [20, 56], [-2, 56],
                                            [-2, 45]]]}}}},
    "shape_disjoint": {"geo_shape": {"area": {"relation": "disjoint", "shape": {
        "type": "envelope", "coordinates": [[-130, 60], [-60, 20]]}}}},
    "shape_polygon": {"geo_shape": {"area": {"shape": {
        "type": "polygon", "coordinates": [[[-1, 46], [6, 46], [2.5, 51.5],
                                            [-1, 46]]]}}}},
}


@pytest.mark.parametrize("name", list(GEO_FILTERS))
def test_geo_filter_masks_match_jax(geo_ctxs, name):
    jctx, tctx = geo_ctxs
    spec = GEO_FILTERS[name]
    jf, tf = jparse_filter(copy.deepcopy(spec)), parse_filter(copy.deepcopy(spec))
    assert tf.key() == jf.key() and tf.cacheable()
    total = 0
    for jseg, tseg in zip(jctx.searcher.segments, tctx.searcher.segments):
        got, want = segment_mask(tseg, tf, tctx), jsegment_mask(jseg, jf, jctx)
        assert np.array_equal(got, want)
        total += int((got & tseg.live & tseg.parent_mask).sum())
    assert total > 0


@pytest.mark.parametrize("name", ["distance", "bbox", "polygon", "shape_within",
                                  "geohash_cell_neighbors"])
def test_filtered_geo_rides_the_dense_family(geo_ctxs, name):
    _both(geo_ctxs, {"query": {"filtered": {
        "query": {"match": {"body": "alpha gamma"}}, "filter": GEO_FILTERS[name]}},
        "size": 12}, expect="device_filtered")


@pytest.mark.parametrize("decay,params", [
    ("gauss", {"origin": AMSTERDAM, "scale": "200km"}),
    ("exp", {"origin": "48.86,2.35", "scale": "500km", "offset": "50km", "decay": 0.3}),
    ("linear", {"origin": [-74.0, 40.71], "scale": "2000km", "decay": 0.4}),
])
def test_geo_decay_rides_the_function_score_family(geo_ctxs, decay, params):
    _both(geo_ctxs, {"query": {"function_score": {
        "query": {"match": {"body": "beta delta"}},
        "functions": [{decay: {"loc": params}}]}}, "size": 15},
        expect="device_function_score")


@pytest.mark.parametrize("sort", [
    {"_geo_distance": {"loc": AMSTERDAM, "order": "asc", "unit": "km"}},
    {"_geo_distance": {"loc": "40.71,-74.0", "order": "desc", "mode": "max"}},
    {"_geo_distance": {"loc": [2.35, 48.86], "unit": "mi", "mode": "avg"}},
], ids=["asc_km", "desc_max", "avg_mi"])
def test_geo_distance_sort_matches_jax(geo_ctxs, sort):
    from elasticsearch_tpu.search.service import execute_query_phase as jphase
    from elasticsearch_tpu.search.service import parse_search_body as jparse_body
    from elasticsearch_tpu.search.service import reduce_and_respond as jrespond
    from elasticsearch_tpu_torch.search import execute_query_phase, parse_search_body
    from elasticsearch_tpu_torch.search.service import reduce_and_respond

    from elasticsearch_tpu_torch.search.service import SERVING_COUNTERS

    jctx, tctx = geo_ctxs
    body = {"query": {"match": {"body": "epsilon"}}, "size": 25, "sort": [sort]}
    req, jreq = parse_search_body(body), jparse_body(body)
    before = SERVING_COUNTERS["host"]
    got = reduce_and_respond(tctx, req, execute_query_phase(tctx, req))
    assert SERVING_COUNTERS["host"] == before + 1  # the host path, as in JAX
    want = jrespond(jctx, jreq, jphase(jctx, jreq))
    assert [(h["_id"], h["sort"]) for h in got["hits"]["hits"]] == \
        [(h["_id"], h["sort"]) for h in want["hits"]["hits"]]


@pytest.mark.parametrize("aggs,expect", [
    ({"d": {"geo_distance": {"field": "loc", "origin": {"lat": 50, "lon": 10},
                             "unit": "km", "ranges": [{"to": 300},
                                                      {"from": 300, "to": 900},
                                                      {"from": 900}]}},
      "g": {"geohash_grid": {"field": "loc", "precision": 2}}}, "device_aggs"),
    ({"g": {"geohash_grid": {"field": "loc", "precision": 4, "size": 5},
            "aggs": {"l": {"avg": {"field": "likes"}}}}}, "device_aggs"),
    ({"b": {"geo_bounds": {"field": "loc"}},
      "d": {"geo_distance": {"field": "loc", "origin": "51.5,-0.12",
                             "ranges": [{"key": "near", "to": 100000}, {"from": 100000}]}}},
     "host"),
], ids=["device_aggs_parity", "grid_with_metric", "bounds"])
def test_geo_aggregations_match_jax(geo_ctxs, aggs, expect):
    """tests/test_device_aggs.py test_geo_bucket_aggs_parity and more:
    the geo buckets ride the aggregating launch, `geo_bounds` the host."""
    _both(geo_ctxs, {"query": {"match": {"body": "alpha"}}, "size": 3, "aggs": aggs},
          expect=expect)


# --- node against node ------------------------------------------------------------

SPANS_GEO_DOCS = [
    {"body": "quick brown fox jumps over the lazy dog"},
    {"body": "fox stole the extremely well hidden quick cheese"},
    {"body": "quick quack quartz"},
    {"body": "brown bear brown bread"},
    {"body": "lazy days of summer", "spot": {"lat": 52.37, "lon": 4.89},
     "area": {"type": "envelope", "coordinates": [[4.0, 53.0], [5.0, 52.0]]}},
    {"body": "dog house", "spot": "52.52,13.40",
     "area": {"type": "polygon", "coordinates":
              [[[13.0, 52.0], [14.0, 52.0], [14.0, 53.0], [13.0, 53.0], [13.0, 52.0]]]}},
    {"body": "far away", "spot": [-122.42, 37.77],
     "area": {"type": "point", "coordinates": [-122.42, 37.77]}},
]
DSL_CITIES = [("0", 52.37, 4.89), ("1", 52.52, 13.40), ("2", 48.86, 2.35),
              ("3", 37.77, -122.42)]
PRODUCTS = [
    {"name": "red widget deluxe", "category": "widgets", "price": 10,
     "loc": {"lat": 40.7, "lon": -74.0}},
    {"name": "blue widget", "category": "widgets", "price": 20,
     "loc": {"lat": 40.8, "lon": -73.9}},
    {"name": "green gadget", "category": "gadgets", "price": 30,
     "loc": {"lat": 34.0, "lon": -118.2}},
    {"name": "red gadget pro", "category": "gadgets", "price": 40,
     "loc": {"lat": 37.7, "lon": -122.4}},
    {"name": "yellow gizmo", "category": "gizmos", "price": 50,
     "loc": {"lat": 41.8, "lon": -87.6}},
    {"name": "red gizmo mini widget", "category": "gizmos", "price": 60,
     "loc": {"lat": 29.7, "lon": -95.3}},
]


def _fill_geo(base):
    indexes = {
        "spans": ({"doc": {"properties": {"body": {"type": "string"},
                                          "spot": {"type": "geo_point"},
                                          "area": {"type": "geo_shape"}}}}, 1),
        "dsl": ({"doc": {"properties": {"loc": {"type": "geo_point"}}}}, 1),
        "products": ({"product": {"properties": {
            "name": {"type": "string"},
            "category": {"type": "string", "index": "not_analyzed"},
            "price": {"type": "long"}, "loc": {"type": "geo_point"}}}}, 2),
        "points": ({"doc": {"properties": {"loc": {"type": "geo_point"}}}}, 3),
    }
    for index, (mappings, shards) in indexes.items():
        st, r = call(base, "PUT", f"/{index}", {"mappings": mappings, "settings": {
            "number_of_shards": shards, "number_of_replicas": 0, "refresh_interval": -1}})
        assert st == 200, r
    lines = []
    for i, d in enumerate(SPANS_GEO_DOCS):
        lines += [{"index": {"_index": "spans", "_type": "doc", "_id": str(i)}}, d]
    for doc_id, lat, lon in DSL_CITIES:
        lines += [{"index": {"_index": "dsl", "_type": "doc", "_id": doc_id}},
                  {"loc": {"lat": lat, "lon": lon}, "tag": "city"}]
    for i, p in enumerate(PRODUCTS):
        lines += [{"index": {"_index": "products", "_type": "product", "_id": str(i)}}, p]
    rng = np.random.default_rng(9)
    for i in range(150):  # tests/test_device_aggs.py test_geo_bucket_aggs_parity
        lines += [{"index": {"_index": "points", "_type": "doc", "_id": str(i)}},
                  {"body": "alpha" if i % 2 else "alpha beta",
                   "loc": {"lat": float(rng.uniform(40, 60)),
                           "lon": float(rng.uniform(-5, 25))}}]
    raw = "\n".join(json.dumps(x) for x in lines) + "\n"
    st, r = call(base, "POST", "/_bulk", raw=raw)
    assert st == 200 and not r["errors"], r
    call(base, "POST", "/_refresh")


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    from tests.test_torch_parent_child import _node_pair

    yield from _node_pair(tmp_path_factory, _fill_geo)


def _cs(flt):
    return {"query": {"filtered": {"query": {"match_all": {}}, "filter": flt}}}


NODE_BODIES = {
    "spans_geohash_cell": ("spans", _cs({"geohash_cell": {
        "spot": {"lat": 52.37, "lon": 4.89}, "precision": 5}})),
    "spans_geohash_cell_neighbors": ("spans", _cs({"geohash_cell": {
        "spot": "u33", "neighbors": True}})),
    "spans_geo_shape_envelope_query": ("spans", {"query": {"geo_shape": {"area": {
        "shape": {"type": "envelope", "coordinates": [[4.5, 52.5], [4.9, 52.1]]}}}}}),
    "spans_geo_shape_polygon_vs_point": ("spans", {"query": {"geo_shape": {"area": {
        "shape": {"type": "polygon", "coordinates": [[[-123.0, 37.0], [-122.0, 37.0],
                                                      [-122.0, 38.0], [-123.0, 38.0],
                                                      [-123.0, 37.0]]]}}}}}),
    "spans_geo_shape_within": ("spans", _cs({"geo_shape": {"area": {
        "shape": {"type": "envelope", "coordinates": [[3.0, 54.0], [6.0, 51.0]]},
        "relation": "within"}}})),
    "spans_geo_shape_disjoint": ("spans", _cs({"geo_shape": {"area": {
        "shape": {"type": "envelope", "coordinates": [[3.0, 54.0], [6.0, 51.0]]},
        "relation": "disjoint"}}})),
    "spans_geohash_string_cell": ("spans", _cs({"geohash_cell": {
        "spot": tgeo.geohash_encode(37.77, -122.42, 4)}})),
    "dsl_geo_polygon": ("dsl", _cs({"geo_polygon": {"loc": {"points": [
        {"lat": 60.0, "lon": 0.0}, {"lat": 60.0, "lon": 20.0},
        {"lat": 40.0, "lon": 10.0}, {"lat": 40.0, "lon": -5.0}]}}})),
    "dsl_geo_distance_range": ("dsl", _cs({"geo_distance_range": {
        "from": "500km", "to": "1000km", "loc": {"lat": 52.37, "lon": 4.89}}})),
    "dsl_geo_distance_range_gt": ("dsl", _cs({"geo_distance_range": {
        "gt": "0km", "lt": "500km", "loc": {"lat": 52.37, "lon": 4.89}}})),
    "dsl_geo_distance_range_gte": ("dsl", _cs({"geo_distance_range": {
        "gte": "0km", "lt": "500km", "loc": {"lat": 52.37, "lon": 4.89}}})),
    "runtime_geo_distance_sort": ("products", {"sort": [{"_geo_distance": {
        "loc": {"lat": 40.7, "lon": -74.0}, "order": "asc", "unit": "km"}}], "size": 3}),
    "runtime_geo_distance_agg": ("products", {"size": 0, "aggs": {"near_nyc": {
        "geo_distance": {"field": "loc", "origin": {"lat": 40.7, "lon": -74.0},
                         "unit": "km", "ranges": [{"to": 100}, {"from": 100}]}}}}),
    "runtime_geo_bounds_and_facet": ("products", {"size": 0, "aggs": {
        "b": {"geo_bounds": {"field": "loc"}}}, "facets": {"f": {"geo_distance": {
            "field": "loc", "origin": "40.7,-74.0", "unit": "km",
            "ranges": [{"to": 1000}, {"from": 1000}]}}}}),
    "device_aggs_geo_buckets": ("points", {
        "query": {"match": {"body": "alpha"}}, "size": 0,
        "aggs": {"d": {"geo_distance": {"field": "loc", "origin": {"lat": 50, "lon": 10},
                                        "unit": "km", "ranges": [
                                            {"to": 300}, {"from": 300, "to": 900},
                                            {"from": 900}]}},
                 "g": {"geohash_grid": {"field": "loc", "precision": 2}}}}),
    "points_gauss_decay": ("points", {"query": {"function_score": {
        "query": {"match": {"body": "alpha beta"}},
        "functions": [{"gauss": {"loc": {"origin": {"lat": 50, "lon": 10},
                                         "scale": "300km"}}}]}}, "size": 10}),
    "points_filtered_distance": ("points", {"query": {"filtered": {
        "query": {"match": {"body": "alpha beta"}},
        "filter": {"geo_distance": {"distance": "400km",
                                    "loc": {"lat": 50, "lon": 10}}}}}, "size": 10}),
}
# bodies both nodes serve on the dense family (scores within 2 ulp)
DENSE = {"points_gauss_decay", "points_filtered_distance"}


@pytest.mark.parametrize("name", list(NODE_BODIES))
def test_geo_bodies_match_jax_node(nodes, name):
    pbase, jbase, _p, _j = nodes
    index, body = NODE_BODIES[name]
    jbody = dict(body, request_cache=False) if body.get("size") == 0 else body
    (pst, pr), (jst, jr) = (call(pbase, "POST", f"/{index}/_search", body),
                            call(jbase, "POST", f"/{index}/_search", jbody))
    assert pst == jst == 200, (pr, jr)
    assert pr["_shards"] == jr["_shards"]
    assert pr.get("aggregations") == jr.get("aggregations")
    assert pr.get("facets") == jr.get("facets")
    ph, jh = pr["hits"], jr["hits"]
    assert ph["total"] == jh["total"] > 0
    if name in DENSE:
        got = [(h["_score"], h["_id"]) for h in ph["hits"]]
        want = [(h["_score"], h["_id"]) for h in jh["hits"]]
        assert _tie_tolerant_equal(got, want)
        assert _within_ulps(ph["max_score"], jh["max_score"], 2)
    else:
        assert ph == jh
