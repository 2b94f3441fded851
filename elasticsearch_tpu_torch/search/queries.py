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
filters of `search/filters.py`. The query types and filters of later slices
raise QueryParsingError naming the slice: function_score and the script
filter with the dense feature family; nested, has_child, has_parent,
top_children, geo_shape and the geo filters with the mapper's nested, join
and geo fields; indices, template and terms lookups with the runtime that
resolves them. A type the JAX package does not know is "unknown", as there.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any

from ..common.errors import QueryParsingError
from .filters import (
    BoolFilter,
    ExistsFilter,
    Filter,
    IdsFilter,
    MatchAllFilter,
    MissingFilter,
    NotFilter,
    PrefixFilter,
    QueryWrapperFilter,
    RangeFilter,
    RegexpFilter,
    TermFilter,
    TermsFilter,
    TypeFilter,
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
        if kind in _LATER_QUERIES:
            raise _later_slice(f"query type [{kind}]", _LATER_QUERIES[kind])
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
        if kind in _LATER_FILTERS:
            raise _later_slice(f"filter type [{kind}]", _LATER_FILTERS[kind])
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
    import json as _json

    raw = spec.get("query") if isinstance(spec, dict) else spec
    if isinstance(raw, (dict, list)):
        return raw
    s = str(raw)
    try:
        s = base64.b64decode(s, validate=True).decode("utf-8")
    except Exception:  # noqa: BLE001 — not base64: treat as raw JSON
        pass
    try:
        return _json.loads(s)
    except ValueError as e:
        raise QueryParsingError(f"wrapper: malformed embedded query: {e}")


# where each refused query type and filter is ported
_LATER_QUERIES = {
    "function_score": "the dense feature family",
    "nested": "the mapper's nested documents",
    "has_child": "the mapper's parent/child joins",
    "has_parent": "the mapper's parent/child joins",
    "top_children": "the mapper's parent/child joins",
    "geo_shape": "the mapper's geo fields",
    "indices": "the multi-index search runtime",
    "template": "the multi-index search runtime",
}
_LATER_FILTERS = {
    "script": "the dense feature family (scripts)",
    "nested": "the mapper's nested documents",
    "has_child": "the mapper's parent/child joins",
    "has_parent": "the mapper's parent/child joins",
    "geo_distance": "the mapper's geo fields",
    "geo_bounding_box": "the mapper's geo fields",
    "geo_shape": "the mapper's geo fields",
    "geohash_cell": "the mapper's geo fields",
    "geo_polygon": "the mapper's geo fields",
    "geo_distance_range": "the mapper's geo fields",
    "indices": "the multi-index search runtime",
}


def _later_slice(what: str, where: str) -> QueryParsingError:
    return QueryParsingError(
        f"{what} is not ported yet: it comes with {where}, a later slice of "
        "the port")


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
}



def _as_list(v):
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _parse_terms_f(spec) -> Filter:
    spec = {k: v for k, v in spec.items() if k not in ("execution", "_cache", "_cache_key", "_name")}
    if len(spec) != 1:
        raise QueryParsingError("terms filter requires exactly one field")
    fname, values = next(iter(spec.items()))
    if isinstance(values, dict):
        # a terms lookup: its values live in another document, fetched by
        # the coordinating node before the shards run
        raise _later_slice(f"terms lookup on [{fname}]",
                           "the multi-index search runtime")
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
    "limit": lambda s: MatchAllFilter(),  # limit filter is best-effort in the reference too
    "wrapper": lambda s: parse_filter(_unwrap_wrapper(s)),
}
