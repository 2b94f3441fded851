"""Query DSL: JSON → query tree (a trimmed copy of the JAX package's
`search/queries.py`, with its filter parsers).

Queries are data: `search/execute.py` lowers the flat ones (term, match,
bool of those) onto the card's sparse path and evaluates every other one on
the host scorer, and filters take a query through `QueryWrapperFilter`.

Served: match_all, match (boolean, phrase, phrase_prefix; fuzziness),
match_phrase, match_phrase_prefix, multi_match, term, terms / in, bool (with
filter), filtered, constant_score, dis_max, range, prefix, wildcard, regexp,
fuzzy, ids, query_string, field, simple_query_string, common, boosting, the
span family (span_term, span_near, span_or, span_first, span_not,
span_multi, field_masking_span), type, more_like_this / mlt (and their
`_field` forms), fuzzy_like_this / flt (and `_field`) and wrapper; the
filters of `search/filters.py` (the script filter among them), and
function_score (`ScoreFunction`: script_score, boost_factor, weight,
random_score, field_value_factor and the numeric, date and geo decays);
nested (`NestedQuery`, a block join over the path's children),
has_child / has_parent / top_children (`HasChildQuery`, `HasParentQuery`:
the shard-wide join of `execute._shard_join` when the query is the whole
query, no match inside another query, as in the JAX package) and geo_shape
(a constant score over `GeoShapeFilter`), with the nested, has_child,
has_parent and geo filters; indices (`IndicesQuery`, `IndicesFilter`: the
inner query or filter on the named indices, `no_match_query` elsewhere,
read against the shard's `ShardContext.index_name`) and template (the
`params` substituted into the query, then parsed). A terms lookup (the
values of another document's field) is resolved by the coordinating node
before the shards run (`resolve_terms_lookups`, against the node's GET
path); one that reaches a shard unresolved raises QueryParsingError, as in
the JAX package. A type the JAX package does not know is "unknown", as
there.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field
from typing import Any

from ..common.errors import QueryParsingError
from ..common.geo import geohash_encode, normalize_shape
from .filters import (
    BoolFilter,
    ExistsFilter,
    Filter,
    GeoBoundingBoxFilter,
    GeoDistanceFilter,
    GeoDistanceRangeFilter,
    GeohashCellFilter,
    GeoPolygonFilter,
    GeoShapeFilter,
    HasChildFilter,
    IdsFilter,
    IndicesFilter,
    MatchAllFilter,
    MissingFilter,
    NestedFilter,
    NotFilter,
    PrefixFilter,
    QueryWrapperFilter,
    RangeFilter,
    RegexpFilter,
    ScriptFilter,
    TermFilter,
    TermsFilter,
    TypeFilter,
    parse_distance,
    parse_point,
)


class Query:
    boost: float = 1.0


@dataclass
class MatchAllQuery(Query):
    boost: float = 1.0


@dataclass
class TermQuery(Query):
    field: str
    value: Any
    boost: float = 1.0


@dataclass
class MatchQuery(Query):
    field: str
    text: str
    operator: str = "or"  # or | and
    minimum_should_match: Any = None
    analyzer: str | None = None
    boost: float = 1.0
    fuzziness: Any = None
    max_expansions: int = 50


@dataclass
class MultiMatchQuery(Query):
    fields: list  # ["title^2", "body"]
    text: str
    operator: str = "or"
    minimum_should_match: Any = None
    type: str = "best_fields"
    tie_breaker: float = 0.0
    analyzer: str | None = None
    boost: float = 1.0


@dataclass
class BoolQuery(Query):
    must: list = dc_field(default_factory=list)
    should: list = dc_field(default_factory=list)
    must_not: list = dc_field(default_factory=list)
    filter: list = dc_field(default_factory=list)
    minimum_should_match: Any = None
    disable_coord: bool = False
    boost: float = 1.0


@dataclass
class FilteredQuery(Query):
    query: Query
    filter: Filter
    boost: float = 1.0


@dataclass
class ConstantScoreQuery(Query):
    filter: Filter | None = None
    query: Query | None = None
    boost: float = 1.0


@dataclass
class DisMaxQuery(Query):
    queries: list = dc_field(default_factory=list)
    tie_breaker: float = 0.0
    boost: float = 1.0


@dataclass
class RangeQuery(Query):
    field: str
    gte: Any = None
    gt: Any = None
    lte: Any = None
    lt: Any = None
    boost: float = 1.0


@dataclass
class PrefixQuery(Query):
    field: str
    prefix: str
    boost: float = 1.0
    rewrite: str | None = None


@dataclass
class WildcardQuery(Query):
    field: str
    pattern: str
    boost: float = 1.0


@dataclass
class RegexpQuery(Query):
    field: str
    pattern: str
    boost: float = 1.0


@dataclass
class FuzzyQuery(Query):
    field: str
    value: str
    fuzziness: Any = "AUTO"
    prefix_length: int = 0
    max_expansions: int = 50
    boost: float = 1.0


@dataclass
class IdsQuery(Query):
    ids: list = dc_field(default_factory=list)
    types: list = dc_field(default_factory=list)
    boost: float = 1.0


@dataclass
class PhraseQuery(Query):
    field: str
    text: str
    slop: int = 0
    analyzer: str | None = None
    boost: float = 1.0
    prefix: bool = False  # phrase_prefix
    max_expansions: int = 50


@dataclass
class QueryStringQuery(Query):
    query: str
    default_field: str = "_all"
    default_operator: str = "or"
    fields: list = dc_field(default_factory=list)
    analyzer: str | None = None
    boost: float = 1.0


@dataclass
class CommonTermsQuery(Query):
    field: str
    text: str
    cutoff_frequency: float = 0.01
    low_freq_operator: str = "or"
    high_freq_operator: str = "or"
    minimum_should_match: Any = None
    analyzer: str | None = None
    boost: float = 1.0


@dataclass
class BoostingQuery(Query):
    positive: Query
    negative: Query
    negative_boost: float = 0.2
    boost: float = 1.0


@dataclass
class IndicesQuery(Query):
    indices: list
    query: Query = None
    no_match_query: Query | None = None  # None: match_all (the default)
    boost: float = 1.0
    no_match_none: bool = False  # "no_match_query": "none"


@dataclass
class MoreLikeThisQuery(Query):
    fields: list
    like_text: str
    min_term_freq: int = 2
    min_doc_freq: int = 5
    max_query_terms: int = 25
    minimum_should_match: Any = "30%"
    boost: float = 1.0


@dataclass
class SpanTermQuery(Query):
    field: str
    value: str
    boost: float = 1.0


@dataclass
class SpanNearQuery(Query):
    clauses: list
    slop: int = 0
    in_order: bool = True
    boost: float = 1.0


@dataclass
class SpanOrQuery(Query):
    """The union of the clauses' spans."""

    clauses: list
    boost: float = 1.0


@dataclass
class SpanFirstQuery(Query):
    """The match's spans that end within [0, end)."""

    match: Query = None
    end: int = 0
    boost: float = 1.0


@dataclass
class SpanNotQuery(Query):
    """The include's spans that overlap no exclude span."""

    include: Query = None
    exclude: Query = None
    boost: float = 1.0


@dataclass
class SpanMultiTermQuery(Query):
    """A multi-term query (prefix, wildcard, fuzzy, regexp) as a span: the
    union of the expanded terms' position spans."""

    match: Query = None
    boost: float = 1.0


@dataclass
class FieldMaskingSpanQuery(Query):
    """Inner spans reported under another field name, so span_near can
    compose across fields indexed in lockstep."""

    query: Query = None
    field: str = ""
    boost: float = 1.0


@dataclass
class SimpleQueryStringQuery(Query):
    """The degraded-gracefully
    query syntax (+ | - "phrase" prefix*); resolved against the analyzer at
    execution time like QueryStringQuery (execute.parse_simple_query_string)."""

    query: str = ""
    fields: list = dc_field(default_factory=list)  # empty = _all
    default_operator: str = "or"
    analyzer: str | None = None
    boost: float = 1.0


@dataclass
class FuzzyLikeThisQuery(Query):
    """like_text analyzed, each term expanded to its fuzzy index-term neighborhood,
    OR-combined. Rewritten in HostScorer._rewrite_flt."""

    fields: list = dc_field(default_factory=list)  # empty = _all
    like_text: str = ""
    fuzziness: Any = 0.5  # min_similarity legacy float or edit distance
    prefix_length: int = 0
    max_query_terms: int = 25
    ignore_tf: bool = False
    analyzer: str | None = None
    boost: float = 1.0


@dataclass
class ScoreFunction:
    kind: str  # script_score | boost_factor | random_score | gauss | exp | linear | field_value_factor
    filter: Filter | None = None
    # decay params
    field: str | None = None
    origin: Any = None
    scale: Any = None
    offset: Any = 0
    decay: float = 0.5
    # others
    script: str | None = None
    params: dict = dc_field(default_factory=dict)
    factor: float = 1.0
    modifier: str = "none"
    missing: float | None = None
    seed: int | None = None
    weight: float | None = None


@dataclass
class FunctionScoreQuery(Query):
    query: Query | None = None
    filter: Filter | None = None
    functions: list = dc_field(default_factory=list)  # list[ScoreFunction]
    score_mode: str = "multiply"  # multiply sum avg first max min
    boost_mode: str = "multiply"  # multiply replace sum avg max min
    max_boost: float = float("inf")
    min_score: float | None = None
    boost: float = 1.0


@dataclass
class NestedQuery(Query):
    path: str
    query: Query  # or a Filter (the `filter` form)
    score_mode: str = "avg"  # avg | sum | max | total | none
    boost: float = 1.0


@dataclass
class HasChildQuery(Query):
    child_type: str
    query: Query
    score_mode: str = "none"
    boost: float = 1.0


@dataclass
class HasParentQuery(Query):
    parent_type: str
    query: Query
    score_mode: str = "none"
    boost: float = 1.0


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------


def parse_query(body: Any) -> Query:
    """Parse a query DSL dict (the object under "query")."""
    if body is None:
        return MatchAllQuery()
    if not isinstance(body, dict) or len(body) != 1:
        if isinstance(body, dict) and len(body) == 0:
            return MatchAllQuery()
        raise QueryParsingError(f"expected single-key query object, got {body!r}")
    kind, spec = next(iter(body.items()))
    parser = _QUERY_PARSERS.get(kind)
    if parser is None:
        raise QueryParsingError(f"unknown query type [{kind}]")
    return parser(spec)


def parse_filter(body: Any) -> Filter:
    if body is None:
        return MatchAllFilter()
    if not isinstance(body, dict) or len(body) != 1:
        if isinstance(body, dict) and len(body) == 0:
            return MatchAllFilter()
        raise QueryParsingError(f"expected single-key filter object, got {body!r}")
    kind, spec = next(iter(body.items()))
    parser = _FILTER_PARSERS.get(kind)
    if parser is None:
        raise QueryParsingError(f"unknown filter type [{kind}]")
    return parser(spec)


def _field_spec(spec: dict, value_key: str) -> tuple[str, dict]:
    """`{"field": "value"}` or `{"field": {value_key: ..., "boost": ...}}`."""
    if len(spec) != 1:
        # allow extra top-level options like boost alongside the field
        fields = [k for k in spec if k not in ("boost", "_name")]
        if len(fields) != 1:
            raise QueryParsingError(f"expected one field, got {list(spec)}")
        fname = fields[0]
        opts = {"boost": spec.get("boost", 1.0)}
        v = spec[fname]
        if isinstance(v, dict):
            opts.update(v)
        else:
            opts[value_key] = v
        return fname, opts
    fname, v = next(iter(spec.items()))
    if isinstance(v, dict):
        return fname, dict(v)
    return fname, {value_key: v}


def _parse_match(spec) -> Query:
    fname, opts = _field_spec(spec, "query")
    mtype = opts.get("type", "boolean")
    if mtype in ("phrase", "phrase_prefix"):
        return PhraseQuery(
            field=fname, text=str(opts.get("query", "")), slop=int(opts.get("slop", 0)),
            analyzer=opts.get("analyzer"), boost=float(opts.get("boost", 1.0)),
            prefix=(mtype == "phrase_prefix"),
            max_expansions=int(opts.get("max_expansions", 50)),
        )
    return MatchQuery(
        field=fname, text=str(opts.get("query", "")),
        operator=str(opts.get("operator", "or")).lower(),
        minimum_should_match=opts.get("minimum_should_match"),
        analyzer=opts.get("analyzer"), boost=float(opts.get("boost", 1.0)),
        fuzziness=opts.get("fuzziness"),
        max_expansions=int(opts.get("max_expansions", 50)),
    )


def _parse_match_phrase(spec) -> Query:
    fname, opts = _field_spec(spec, "query")
    return PhraseQuery(field=fname, text=str(opts.get("query", "")),
                       slop=int(opts.get("slop", 0)), analyzer=opts.get("analyzer"),
                       boost=float(opts.get("boost", 1.0)))


def _parse_match_phrase_prefix(spec) -> Query:
    fname, opts = _field_spec(spec, "query")
    return PhraseQuery(field=fname, text=str(opts.get("query", "")),
                       slop=int(opts.get("slop", 0)), analyzer=opts.get("analyzer"),
                       boost=float(opts.get("boost", 1.0)), prefix=True,
                       max_expansions=int(opts.get("max_expansions", 50)))


def _parse_multi_match(spec) -> Query:
    return MultiMatchQuery(
        fields=list(spec.get("fields", [])), text=str(spec.get("query", "")),
        operator=str(spec.get("operator", "or")).lower(),
        minimum_should_match=spec.get("minimum_should_match"),
        type=spec.get("type", "best_fields"),
        tie_breaker=float(spec.get("tie_breaker", 0.0)),
        analyzer=spec.get("analyzer"), boost=float(spec.get("boost", 1.0)),
    )


def _parse_term(spec) -> Query:
    fname, opts = _field_spec(spec, "value")
    value = opts.get("value", opts.get("term"))
    return TermQuery(field=fname, value=value, boost=float(opts.get("boost", 1.0)))


def _parse_terms(spec) -> Query:
    spec = dict(spec)
    msm = spec.pop("minimum_should_match", spec.pop("minimum_match", None))
    boost = float(spec.pop("boost", 1.0))
    spec.pop("disable_coord", None)
    if len(spec) != 1:
        raise QueryParsingError("terms query requires exactly one field")
    fname, values = next(iter(spec.items()))
    q = BoolQuery(should=[TermQuery(fname, v) for v in values],
                  minimum_should_match=msm, boost=boost)
    return q


def _parse_bool(spec) -> Query:
    def as_list(v):
        if v is None:
            return []
        return v if isinstance(v, list) else [v]

    return BoolQuery(
        must=[parse_query(q) for q in as_list(spec.get("must"))],
        should=[parse_query(q) for q in as_list(spec.get("should"))],
        must_not=[parse_query(q) for q in as_list(spec.get("must_not"))],
        filter=[parse_filter(f) for f in as_list(spec.get("filter"))],
        minimum_should_match=spec.get("minimum_should_match", spec.get("minimum_number_should_match")),
        disable_coord=bool(spec.get("disable_coord", False)),
        boost=float(spec.get("boost", 1.0)),
    )


def _parse_filtered(spec) -> Query:
    return FilteredQuery(
        query=parse_query(spec.get("query")),
        filter=parse_filter(spec.get("filter")),
        boost=float(spec.get("boost", 1.0)),
    )


def _parse_constant_score(spec) -> Query:
    return ConstantScoreQuery(
        filter=parse_filter(spec["filter"]) if "filter" in spec else None,
        query=parse_query(spec["query"]) if "query" in spec else None,
        boost=float(spec.get("boost", 1.0)),
    )


def _parse_dis_max(spec) -> Query:
    return DisMaxQuery(
        queries=[parse_query(q) for q in spec.get("queries", [])],
        tie_breaker=float(spec.get("tie_breaker", 0.0)),
        boost=float(spec.get("boost", 1.0)),
    )


def _parse_range_q(spec) -> Query:
    fname, opts = _field_spec(spec, "value")
    conv = {"from": "gte", "to": "lte"}
    kw = {}
    for k in ("gte", "gt", "lte", "lt", "from", "to"):
        if k in opts:
            kw[conv.get(k, k)] = opts[k]
    if "include_lower" in opts and not opts["include_lower"] and "gte" in kw:
        kw["gt"] = kw.pop("gte")
    if "include_upper" in opts and not opts["include_upper"] and "lte" in kw:
        kw["lt"] = kw.pop("lte")
    return RangeQuery(field=fname, boost=float(opts.get("boost", 1.0)), **kw)


def _parse_query_string(spec) -> Query:
    if isinstance(spec, str):
        spec = {"query": spec}
    return QueryStringQuery(
        query=spec.get("query", "*"),
        default_field=spec.get("default_field", "_all"),
        default_operator=str(spec.get("default_operator", "or")).lower(),
        fields=list(spec.get("fields", [])),
        analyzer=spec.get("analyzer"),
        boost=float(spec.get("boost", 1.0)),
    )


def _parse_simple_query_string(spec) -> Query:
    if isinstance(spec, str):
        spec = {"query": spec}
    return SimpleQueryStringQuery(
        query=str(spec.get("query", "")),
        fields=list(spec.get("fields", [])),
        default_operator=str(spec.get("default_operator", "or")).lower(),
        analyzer=spec.get("analyzer"),
        boost=float(spec.get("boost", 1.0)),
    )


def _parse_flt(spec) -> Query:
    return FuzzyLikeThisQuery(
        fields=list(spec.get("fields", [])),
        like_text=str(spec.get("like_text", "")),
        fuzziness=spec.get("fuzziness", spec.get("min_similarity", 0.5)),
        prefix_length=int(spec.get("prefix_length", 0)),
        max_query_terms=int(spec.get("max_query_terms", 25)),
        ignore_tf=bool(spec.get("ignore_tf", False)),
        analyzer=spec.get("analyzer"),
        boost=float(spec.get("boost", 1.0)),
    )


def _parse_flt_field(spec) -> Query:
    """{field: {like_text: ...}} (the _field form)."""
    (fname, opts), = spec.items()
    return _parse_flt({**(opts if isinstance(opts, dict) else {"like_text": opts}),
                       "fields": [fname]})


def _parse_mlt_field(spec) -> Query:
    """{field: {like_text: ...}} (the _field form)."""
    (fname, opts), = spec.items()
    if not isinstance(opts, dict):
        opts = {"like_text": opts}
    return _QUERY_PARSERS["more_like_this"]({**opts, "fields": [fname]})


def _unwrap_wrapper(spec) -> Any:
    """{"query": <base64 JSON or raw JSON str>}."""
    import base64

    raw = spec.get("query") if isinstance(spec, dict) else spec
    if isinstance(raw, (dict, list)):
        return raw
    s = str(raw)
    try:
        s = base64.b64decode(s, validate=True).decode("utf-8")
    except Exception:  # noqa: BLE001 — not base64: treat as raw JSON
        pass
    try:
        return json.loads(s)
    except ValueError as e:
        raise QueryParsingError(f"wrapper: malformed embedded query: {e}")


def _parse_indices_common(spec, parse_inner):
    """The indices query's and filter's shape: (inner, no_match, "none"
    given, indices); `no_match_query` (`no_match_filter`) is "all" (the
    default), "none" or a spec."""
    inner = parse_inner(spec.get("query") if "query" in spec else spec.get("filter"))
    nm = spec.get("no_match_query", spec.get("no_match_filter"))
    no_match_none = isinstance(nm, str) and nm.lower() == "none"
    no_match = parse_inner(nm) if isinstance(nm, dict) else None
    return inner, no_match, no_match_none, _as_list(spec.get("indices", spec.get("index")))


def _parse_indices_q(spec) -> Query:
    inner, no_match, none, indices = _parse_indices_common(spec, parse_query)
    return IndicesQuery(indices, inner, no_match, float(spec.get("boost", 1.0)),
                        no_match_none=none)


def _parse_indices_f(spec) -> Filter:
    inner, no_match, none, indices = _parse_indices_common(spec, parse_filter)
    return IndicesFilter(tuple(indices), inner, no_match, no_match_none=none)


def _parse_template(spec) -> Query:
    """`params` substituted for `{{name}}` in `query` (an object or a JSON
    string), then the result parsed."""
    tpl = spec.get("query")
    params = spec.get("params") or {}

    def subst(s: str) -> str:
        for k, v in params.items():
            s = s.replace("{{%s}}" % k, str(v))
        return s

    return parse_query(json.loads(subst(tpl if isinstance(tpl, str) else json.dumps(tpl))))


def _parse_nested_q(spec) -> Query:
    # a nested "filter" spec goes through the FILTER parser (missing and
    # exists are no queries; term means another thing as a filter):
    # child_match_to_parents takes a Query or a Filter
    inner = (parse_query(spec["query"]) if "query" in spec
             else parse_filter(spec.get("filter")))
    return NestedQuery(
        path=spec["path"], query=inner,
        score_mode=spec.get("score_mode", "avg"), boost=float(spec.get("boost", 1.0)),
    )


def _parse_function_score(spec) -> Query:
    functions = []
    for fspec in spec.get("functions", [spec] if any(
        k in spec for k in ("script_score", "boost_factor", "random_score", "gauss",
                            "exp", "linear", "field_value_factor")
    ) else []):
        functions.append(_parse_score_function(fspec))
    return FunctionScoreQuery(
        query=parse_query(spec["query"]) if "query" in spec else None,
        filter=parse_filter(spec["filter"]) if "filter" in spec else None,
        functions=functions,
        score_mode=spec.get("score_mode", "multiply"),
        boost_mode=spec.get("boost_mode", "multiply"),
        max_boost=float(spec.get("max_boost", float("inf"))),
        min_score=spec.get("min_score"),
        boost=float(spec.get("boost", 1.0)),
    )


def _parse_score_function(fspec: dict) -> ScoreFunction:
    filt = parse_filter(fspec["filter"]) if "filter" in fspec else None
    weight = fspec.get("weight")
    if "script_score" in fspec:
        ss = fspec["script_score"]
        return ScoreFunction("script_score", filt, script=ss.get("script"),
                             params=ss.get("params", {}), weight=weight)
    if "boost_factor" in fspec:
        return ScoreFunction("boost_factor", filt, factor=float(fspec["boost_factor"]),
                             weight=weight)
    if "random_score" in fspec:
        return ScoreFunction("random_score", filt,
                             seed=fspec["random_score"].get("seed"), weight=weight)
    if "field_value_factor" in fspec:
        fv = fspec["field_value_factor"]
        return ScoreFunction("field_value_factor", filt, field=fv.get("field"),
                             factor=float(fv.get("factor", 1.0)),
                             modifier=fv.get("modifier", "none"),
                             missing=fv.get("missing"), weight=weight)
    for decay in ("gauss", "exp", "linear"):
        if decay in fspec:
            dspec = fspec[decay]
            (fname, params), = dspec.items()
            return ScoreFunction(
                decay, filt, field=fname, origin=params.get("origin"),
                scale=params.get("scale"), offset=params.get("offset", 0),
                decay=float(params.get("decay", 0.5)), weight=weight,
            )
    if weight is not None:
        return ScoreFunction("boost_factor", filt, factor=float(weight))
    raise QueryParsingError(f"unknown score function {list(fspec)}")


_QUERY_PARSERS = {
    "match_all": lambda s: MatchAllQuery(boost=float((s or {}).get("boost", 1.0))),
    "match": _parse_match,
    "match_phrase": _parse_match_phrase,
    "match_phrase_prefix": _parse_match_phrase_prefix,
    "multi_match": _parse_multi_match,
    "term": _parse_term,
    "terms": _parse_terms,
    "in": _parse_terms,
    "bool": _parse_bool,
    "filtered": _parse_filtered,
    "constant_score": _parse_constant_score,
    "dis_max": _parse_dis_max,
    "range": _parse_range_q,
    "prefix": lambda s: (lambda f, o: PrefixQuery(f, str(o.get("value", o.get("prefix", ""))),
                                                  float(o.get("boost", 1.0))))(*_field_spec(s, "value")),
    "wildcard": lambda s: (lambda f, o: WildcardQuery(f, str(o.get("value", o.get("wildcard", ""))),
                                                      float(o.get("boost", 1.0))))(*_field_spec(s, "value")),
    "regexp": lambda s: (lambda f, o: RegexpQuery(f, str(o.get("value", "")),
                                                  float(o.get("boost", 1.0))))(*_field_spec(s, "value")),
    "fuzzy": lambda s: (lambda f, o: FuzzyQuery(f, str(o.get("value", "")),
                                                o.get("fuzziness", "AUTO"),
                                                int(o.get("prefix_length", 0)),
                                                int(o.get("max_expansions", 50)),
                                                float(o.get("boost", 1.0))))(*_field_spec(s, "value")),
    "ids": lambda s: IdsQuery(ids=[str(i) for i in s.get("values", [])],
                              types=_as_list(s.get("type", s.get("types"))),
                              boost=float(s.get("boost", 1.0))),
    "query_string": _parse_query_string,
    "field": lambda s: (lambda f, o: QueryStringQuery(str(o.get("query", "")), default_field=f,
                                                      boost=float(o.get("boost", 1.0))))(*_field_spec(s, "query")),
    "common": lambda s: (lambda f, o: CommonTermsQuery(
        f, str(o.get("query", "")), float(o.get("cutoff_frequency", 0.01)),
        str(o.get("low_freq_operator", "or")).lower(),
        str(o.get("high_freq_operator", "or")).lower(),
        o.get("minimum_should_match"), o.get("analyzer"),
        float(o.get("boost", 1.0))))(*_field_spec(s, "query")),
    "boosting": lambda s: BoostingQuery(parse_query(s["positive"]), parse_query(s["negative"]),
                                        float(s.get("negative_boost", 0.2)),
                                        float(s.get("boost", 1.0))),
    "more_like_this": lambda s: MoreLikeThisQuery(
        fields=list(s.get("fields", ["_all"])), like_text=s.get("like_text", ""),
        min_term_freq=int(s.get("min_term_freq", 2)),
        min_doc_freq=int(s.get("min_doc_freq", 5)),
        max_query_terms=int(s.get("max_query_terms", 25)),
        minimum_should_match=s.get("minimum_should_match", s.get("percent_terms_to_match", "30%")),
        boost=float(s.get("boost", 1.0))),
    "mlt": lambda s: _QUERY_PARSERS["more_like_this"](s),
    "span_term": lambda s: (lambda f, o: SpanTermQuery(f, str(o.get("value", "")),
                                                       float(o.get("boost", 1.0))))(*_field_spec(s, "value")),
    "span_near": lambda s: SpanNearQuery([parse_query(c) for c in s.get("clauses", [])],
                                         int(s.get("slop", 0)), bool(s.get("in_order", True))),
    "span_or": lambda s: SpanOrQuery([parse_query(c) for c in s.get("clauses", [])],
                                     float(s.get("boost", 1.0))),
    "span_first": lambda s: SpanFirstQuery(parse_query(s.get("match")),
                                           int(s.get("end", 0)),
                                           float(s.get("boost", 1.0))),
    "span_not": lambda s: SpanNotQuery(parse_query(s.get("include")),
                                       parse_query(s.get("exclude")),
                                       float(s.get("boost", 1.0))),
    "span_multi": lambda s: SpanMultiTermQuery(parse_query(s.get("match")),
                                               float(s.get("boost", 1.0))),
    "field_masking_span": lambda s: FieldMaskingSpanQuery(
        parse_query(s.get("query")), str(s.get("field", "")),
        float(s.get("boost", 1.0))),
    "type": lambda s: ConstantScoreQuery(filter=TypeFilter(s.get("value"))),
    "simple_query_string": _parse_simple_query_string,
    "fuzzy_like_this": _parse_flt,
    "flt": _parse_flt,
    "fuzzy_like_this_field": _parse_flt_field,
    "flt_field": _parse_flt_field,
    "more_like_this_field": _parse_mlt_field,
    "mlt_field": _parse_mlt_field,
    "wrapper": lambda s: parse_query(_unwrap_wrapper(s)),
    "indices": _parse_indices_q,
    "template": _parse_template,
    "function_score": _parse_function_score,
    "nested": _parse_nested_q,
    "has_child": lambda s: HasChildQuery(s.get("type", s.get("child_type")),
                                         parse_query(s.get("query") or s.get("filter")),
                                         s.get("score_mode", s.get("score_type", "none")),
                                         float(s.get("boost", 1.0))),
    "has_parent": lambda s: HasParentQuery(s.get("parent_type", s.get("type")),
                                           parse_query(s.get("query") or s.get("filter")),
                                           s.get("score_mode", s.get("score_type", "none")),
                                           float(s.get("boost", 1.0))),
    "top_children": lambda s: HasChildQuery(s.get("type"), parse_query(s.get("query")),
                                            s.get("score", "max"), float(s.get("boost", 1.0))),
    "geo_shape": lambda s: ConstantScoreQuery(
        filter=_parse_geo_shape_f({k: v for k, v in s.items() if k != "boost"}),
        boost=float(s.get("boost", 1.0))),
}



def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def resolve_terms_lookups(body, get_fn):
    """Rewrite the terms LOOKUP specs of a raw request body into plain value
    lists by fetching each referenced document, once a request on the
    coordinating node, so every shard sees the same values.

    get_fn(index, type, id, routing) -> a GET response dict (or None). A
    missing document resolves to no terms; a missing index raises (the
    get's IndexMissingError). Returns the original object when nothing
    needed rewriting."""
    def walk(obj):
        if isinstance(obj, list):
            new = [walk(v) for v in obj]
            return new if any(a is not b for a, b in zip(new, obj)) else obj
        if not isinstance(obj, dict):
            return obj
        out = {}
        changed = False
        for k, v in obj.items():
            if k in ("terms", "in") and isinstance(v, dict):
                fields = {fk: fv for fk, fv in v.items()
                          if not fk.startswith("_") and fk not in
                          ("execution", "minimum_should_match",
                           "minimum_match", "boost", "disable_coord")}
                if len(fields) == 1:
                    (fk, fv), = fields.items()
                    if isinstance(fv, dict) and "id" in fv and "path" in fv:
                        values = _fetch_lookup_terms(fv, get_fn)
                        out[k] = {**{ok: ov for ok, ov in v.items() if ok != fk},
                                  fk: values}
                        changed = True
                        continue
            nv = walk(v)
            changed = changed or (nv is not v)
            out[k] = nv
        return out if changed else obj

    return walk(body)


def _fetch_lookup_terms(spec: dict, get_fn) -> list:
    index = spec.get("index")
    if not index:
        raise QueryParsingError("terms lookup requires [index]")
    doc = get_fn(index, spec.get("type"), str(spec["id"]), spec.get("routing"))
    src = (doc or {}).get("_source")
    if not doc or not doc.get("found") or src is None:
        return []
    values: list = []

    def extract(node, parts):
        if not parts:
            if isinstance(node, list):
                values.extend(node)
            elif node is not None:
                values.append(node)
            return
        head, rest = parts[0], parts[1:]
        if isinstance(node, list):
            for item in node:
                extract(item, parts)
        elif isinstance(node, dict) and head in node:
            extract(node[head], rest)

    extract(src, str(spec.get("path", "")).split("."))
    return values


def _parse_terms_f(spec) -> Filter:
    spec = {k: v for k, v in spec.items() if k not in ("execution", "_cache", "_cache_key", "_name")}
    if len(spec) != 1:
        raise QueryParsingError("terms filter requires exactly one field")
    fname, values = next(iter(spec.items()))
    if isinstance(values, dict):
        # a terms lookup: the coordinating node resolves it against the GET
        # path before the shards run (resolve_terms_lookups); one that gets
        # here had no coordinator
        raise QueryParsingError(
            f"terms lookup on [{fname}] must be resolved by the coordinating "
            f"node (index/type/id/path get) before shard execution")
    return TermsFilter(fname, list(values))


def _parse_range_f(spec) -> Filter:
    spec = {k: v for k, v in spec.items() if k not in ("_cache", "_cache_key", "_name", "execution")}
    fname, opts = _field_spec(spec, "value")
    conv = {"from": "gte", "to": "lte"}
    kw = {}
    for k in ("gte", "gt", "lte", "lt", "from", "to"):
        if k in opts:
            kw[conv.get(k, k)] = opts[k]
    if "include_lower" in opts and not opts["include_lower"] and "gte" in kw:
        kw["gt"] = kw.pop("gte")
    if "include_upper" in opts and not opts["include_upper"] and "lte" in kw:
        kw["lt"] = kw.pop("lte")
    return RangeFilter(field=fname, **kw)


def _parse_geo_polygon_f(spec) -> Filter:
    """{field: {points: [...]}}."""
    spec = {k: v for k, v in spec.items() if k not in ("_cache", "_cache_key", "_name")}
    (fname, body), = spec.items()
    pts = tuple(parse_point(p) for p in body.get("points", []))
    if len({p for p in pts}) < 3:
        raise QueryParsingError("geo_polygon requires at least 3 distinct points")
    return GeoPolygonFilter(fname, pts)


def _parse_geo_distance_range_f(spec) -> Filter:
    """geo_distance with from/to/gt/gte/lt/lte distance bounds around the
    origin point."""
    spec = {k: v for k, v in spec.items()
            if k not in ("_cache", "_cache_key", "_name", "distance_type",
                         "optimize_bbox", "unit")}
    from_m = to_m = None
    include_lower = include_upper = True
    for k in ("from", "gte", "gt"):
        if k in spec:
            from_m = parse_distance(spec.pop(k))
            include_lower = k != "gt"
    for k in ("to", "lte", "lt"):
        if k in spec:
            to_m = parse_distance(spec.pop(k))
            include_upper = k != "lt"
    if "include_lower" in spec:
        include_lower = bool(spec.pop("include_lower"))
    if "include_upper" in spec:
        include_upper = bool(spec.pop("include_upper"))
    (fname, point), = spec.items()
    lat, lon = parse_point(point)
    return GeoDistanceRangeFilter(fname, lat, lon, from_m, to_m,
                                  include_lower, include_upper)


def _parse_has_child_f(spec) -> Filter:
    """Parent docs with a matching child; never scores (score_mode none).
    The cross-segment join lives in filters.HasChildFilter (a
    QueryWrapperFilter would evaluate segment-local and match nothing)."""
    inner = (parse_query(spec["query"]) if "query" in spec
             else ConstantScoreQuery(filter=parse_filter(spec.get("filter"))))
    return HasChildFilter(
        HasChildQuery(spec.get("type", spec.get("child_type")), inner, "none"))


def _parse_has_parent_f(spec) -> Filter:
    """Child docs of a matching parent; never scores."""
    inner = (parse_query(spec["query"]) if "query" in spec
             else ConstantScoreQuery(filter=parse_filter(spec.get("filter"))))
    return HasChildFilter(
        HasParentQuery(spec.get("parent_type", spec.get("type")), inner, "none"))


def _parse_geo_distance_f(spec) -> Filter:
    spec = {k: v for k, v in spec.items() if k not in ("_cache", "_name", "distance_type", "optimize_bbox")}
    dist = parse_distance(spec.pop("distance"))
    spec.pop("unit", None)  # a unit-less distance is metres, as in the JAX package
    (fname, point), = spec.items()
    lat, lon = parse_point(point)
    return GeoDistanceFilter(fname, lat, lon, dist)


def _parse_geo_bbox_f(spec) -> Filter:
    spec = {k: v for k, v in spec.items() if k not in ("_cache", "_name", "type")}
    (fname, box), = spec.items()
    if "top_left" in box:
        tl, br = box["top_left"], box["bottom_right"]
        if isinstance(tl, dict):
            top, left = tl["lat"], tl["lon"]
            bottom, right = br["lat"], br["lon"]
        else:
            left, top = tl[0], tl[1]
            right, bottom = br[0], br[1]
    else:
        top, left, bottom, right = box["top"], box["left"], box["bottom"], box["right"]
    return GeoBoundingBoxFilter(fname, float(top), float(left), float(bottom), float(right))


def _parse_geo_shape_f(spec) -> Filter:
    """{field: {shape: {...}, relation}}."""
    spec = {k: v for k, v in spec.items() if k not in ("_cache", "_name")}
    (fname, body), = spec.items()
    shape_spec = body.get("shape")
    if shape_spec is None:
        raise QueryParsingError("geo_shape requires [shape]")
    try:
        shape = normalize_shape(shape_spec)
    except ValueError as e:
        raise QueryParsingError(str(e))
    relation = str(body.get("relation", "intersects")).lower()
    if relation not in ("intersects", "within", "disjoint"):
        raise QueryParsingError(f"unknown geo_shape relation [{relation}]")
    return GeoShapeFilter(fname, shape, relation)


def _parse_geohash_cell_f(spec) -> Filter:
    """{field: pin, precision, neighbors}."""
    spec = {k: v for k, v in spec.items() if k not in ("_cache", "_name")}
    neighbors = bool(spec.pop("neighbors", False))
    precision = spec.pop("precision", None)
    (fname, pin), = spec.items()
    if isinstance(pin, dict):
        h = geohash_encode(float(pin["lat"]), float(pin["lon"]),
                           int(precision or 12))
    elif isinstance(pin, str) and "," in pin:
        lat, lon = (float(x) for x in pin.split(","))
        h = geohash_encode(lat, lon, int(precision or 12))
    elif isinstance(pin, str):
        h = pin.strip().lower()
        if precision is not None:
            h = h[: int(precision)]
    else:  # [lon, lat]
        h = geohash_encode(float(pin[1]), float(pin[0]), int(precision or 12))
    if not h:
        raise QueryParsingError("geohash_cell requires a non-empty cell")
    return GeohashCellFilter(fname, h, neighbors)


_FILTER_PARSERS = {
    "term": lambda s: (lambda f, o: TermFilter(f, o.get("value")))(
        *_field_spec({k: v for k, v in s.items() if not k.startswith("_")}, "value")),
    "terms": _parse_terms_f,
    "in": _parse_terms_f,
    "range": _parse_range_f,
    "numeric_range": _parse_range_f,
    "exists": lambda s: ExistsFilter(s["field"] if isinstance(s, dict) else s),
    "missing": lambda s: MissingFilter(s["field"] if isinstance(s, dict) else s),
    "ids": lambda s: IdsFilter(ids=[str(i) for i in s.get("values", [])],
                               types=_as_list(s.get("type", s.get("types")))),
    "type": lambda s: TypeFilter(s.get("value")),
    "match_all": lambda s: MatchAllFilter(),
    "bool": lambda s: BoolFilter(
        must=[parse_filter(f) for f in _as_list(s.get("must"))],
        should=[parse_filter(f) for f in _as_list(s.get("should"))],
        must_not=[parse_filter(f) for f in _as_list(s.get("must_not"))]),
    "and": lambda s: BoolFilter(must=[parse_filter(f) for f in
                                      (s.get("filters", s) if isinstance(s, dict) else s)]),
    "or": lambda s: BoolFilter(should=[parse_filter(f) for f in
                                       (s.get("filters", s) if isinstance(s, dict) else s)]),
    "not": lambda s: NotFilter(parse_filter(s.get("filter", s) if isinstance(s, dict) else s)),
    "prefix": lambda s: (lambda f, o: PrefixFilter(f, str(o.get("value", o.get("prefix", "")))))(
        *_field_spec({k: v for k, v in s.items() if not k.startswith("_")}, "value")),
    "regexp": lambda s: (lambda f, o: RegexpFilter(f, str(o.get("value", ""))))(
        *_field_spec({k: v for k, v in s.items() if not k.startswith("_")}, "value")),
    "query": lambda s: QueryWrapperFilter(parse_query(s)),
    "fquery": lambda s: QueryWrapperFilter(parse_query(s.get("query"))),
    "nested": lambda s: NestedFilter(s["path"], parse_query(s.get("query")) if "query" in s
                                     else parse_filter(s.get("filter"))),
    "geo_distance": _parse_geo_distance_f,
    "geo_bounding_box": _parse_geo_bbox_f,
    "geo_shape": _parse_geo_shape_f,
    "geohash_cell": _parse_geohash_cell_f,
    "script": lambda s: ScriptFilter(s.get("script", ""), s.get("params", {})),
    "limit": lambda s: MatchAllFilter(),  # limit filter is best-effort in the reference too
    "geo_polygon": _parse_geo_polygon_f,
    "geo_distance_range": _parse_geo_distance_range_f,
    "has_child": _parse_has_child_f,
    "has_parent": _parse_has_parent_f,
    "indices": _parse_indices_f,
    "wrapper": lambda s: parse_filter(_unwrap_wrapper(s)),
}
