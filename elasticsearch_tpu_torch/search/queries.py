"""Query DSL: JSON → query tree, for the query types this slice of the port
runs on the device — `term`, `match` (operator, minimum_should_match, boost)
and `bool` (must / should / must_not, minimum_should_match, disable_coord).
A trimmed copy of the JAX package's `search/queries.py`; every other query
type raises QueryParsingError naming the later slice that ports it."""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Any

from ..common.errors import QueryParsingError


class Query:
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


@dataclass
class BoolQuery(Query):
    must: list = dc_field(default_factory=list)
    should: list = dc_field(default_factory=list)
    must_not: list = dc_field(default_factory=list)
    minimum_should_match: Any = None
    disable_coord: bool = False
    boost: float = 1.0


def _later_slice(what: str) -> QueryParsingError:
    return QueryParsingError(
        f"{what} is not ported yet: it runs on the host scorer or the dense "
        "feature family, later slices of the port")


def parse_query(body: Any) -> Query:
    """Parse a query DSL dict (the object under "query")."""
    if not isinstance(body, dict) or len(body) != 1:
        raise QueryParsingError(f"expected single-key query object, got {body!r}")
    kind, spec = next(iter(body.items()))
    parser = _QUERY_PARSERS.get(kind)
    if parser is None:
        raise _later_slice(f"query type [{kind}]")
    return parser(spec)


def _field_spec(spec: dict, value_key: str) -> tuple[str, dict]:
    """`{"field": "value"}` or `{"field": {value_key: ..., "boost": ...}}`."""
    if len(spec) != 1:
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
    if mtype != "boolean":
        raise _later_slice(f"match type [{mtype}]")
    return MatchQuery(
        field=fname, text=str(opts.get("query", "")),
        operator=str(opts.get("operator", "or")).lower(),
        minimum_should_match=opts.get("minimum_should_match"),
        analyzer=opts.get("analyzer"), boost=float(opts.get("boost", 1.0)),
        fuzziness=opts.get("fuzziness"),
    )


def _parse_term(spec) -> Query:
    fname, opts = _field_spec(spec, "value")
    value = opts.get("value", opts.get("term"))
    return TermQuery(field=fname, value=value, boost=float(opts.get("boost", 1.0)))


def _parse_bool(spec) -> Query:
    def as_list(v):
        if v is None:
            return []
        return v if isinstance(v, list) else [v]

    if spec.get("filter"):
        raise _later_slice("bool filter clause")
    return BoolQuery(
        must=[parse_query(q) for q in as_list(spec.get("must"))],
        should=[parse_query(q) for q in as_list(spec.get("should"))],
        must_not=[parse_query(q) for q in as_list(spec.get("must_not"))],
        minimum_should_match=spec.get("minimum_should_match",
                                      spec.get("minimum_number_should_match")),
        disable_coord=bool(spec.get("disable_coord", False)),
        boost=float(spec.get("boost", 1.0)),
    )


_QUERY_PARSERS = {
    "match": _parse_match,
    "term": _parse_term,
    "bool": _parse_bool,
}
