"""Document mapping: JSON docs → per-field term streams, field lengths and
numeric columns (a copy of the JAX package's `mapper/core.py`, its flat
half).

Field lengths decide the norm bytes and so the scores: they are computed
exactly as the JAX package computes them, `_all` included. A field's length
is its number of indexed terms (`len(terms)`): stacked synonyms count, and
no overlap discount is applied. Values of one field are 100 positions apart.
Dynamic mapping resolves an unseen field as the JAX package does: strings
map to analyzed `string`, ISO-8601 strings to `date`, ints to `long`, floats
to `double`, booleans to `boolean`, objects to `object`; `to_mapping`
renders the resulting mapping the same way. A numeric, date, boolean, `ip`
or `token_count` value is coerced and stored in a doc-value column, which
term, terms and range queries and filters read (`search/filters.py`); a
`token_count` value is the number given in the document, as in the JAX
package. A string field keeps its values per document (the segment's string
doc values).

Multi-fields (`fields`, and the legacy `multi_field` type) register their
sub-fields `full.sub`, which `to_mapping` renders under the parent's
`fields`; as in the JAX package, parsing indexes no value into a sub-field.
`copy_to` indexes a field's values into its targets (a missing target is
mapped dynamically with the source's type) and adds nothing to `_all`.
`_routing` (`required`, `path`), `_timestamp` (`enabled`, `path`) and
`_ttl` (`enabled`, `default`) are served: a document's TTL (its own, else
the default; a string is a time value, a number milliseconds) lands as its
absolute expiry in the `_expiry` doc-value column, from its timestamp (else
the wall clock), and one already past raises AlreadyExpiredError. A `binary` field is kept in `_source` only, and a field
of any other type the mapper does not list (`completion`, `murmur3`, ...)
stores its values as string doc values, as the JAX mapper keeps them.

A `nested` object's values become nested documents of their own
(`ParsedDocument.nested_docs`, one per object, parsed under the object's
path), which the segment stores before their parent. A `geo_point` (a
`{lat, lon}` object, a `"lat,lon"` string, a geohash or a `[lon, lat]`
pair) lands in two numeric columns, `field.lat` and `field.lon`; a
`geo_shape` is stored as the canonical JSON of its normalized form in the
string doc values. A child document of a `_parent` mapping stores its
parent's id in the `_parent` string doc values and as a `_parent` term
(`parent_type#id`), and is routed by it when no routing is given."""

from __future__ import annotations

import datetime as _dt
import json
import re
import time
from dataclasses import dataclass, field as dc_field
from typing import Any

from ..analysis import AnalysisService, Analyzer
from ..common.errors import AlreadyExpiredError, MapperParsingError
from ..common.geo import geohash_decode, normalize_shape
from ..common.settings import Settings
from ..common.units import parse_time

TEXT_TYPES = {"string", "text"}
NUMERIC_TYPES = {"long", "integer", "short", "byte", "double", "float", "date",
                 "boolean", "ip", "token_count"}

_INT_BOUNDS = {"byte": (-(2**7), 2**7 - 1), "short": (-(2**15), 2**15 - 1),
               "integer": (-(2**31), 2**31 - 1), "long": (-(2**63), 2**63 - 1)}

_ISO_RE = re.compile(
    r"^(\d{4})-(\d{2})-(\d{2})(?:[T ](\d{2}):(\d{2})(?::(\d{2})(?:\.(\d{1,9}))?)?"
    r"(Z|[+-]\d{2}:?\d{2})?)?$"
)

META_FIELDS = ("_uid", "_id", "_type", "_source", "_all", "_routing", "_parent",
               "_timestamp", "_ttl", "_version", "_size", "_index", "_boost")

GEO_TYPES = {"geo_point", "geo_shape"}


def parse_ip(value: str) -> int:
    parts = str(value).split(".")
    if len(parts) != 4:
        raise MapperParsingError(f"failed to parse ip [{value}]")
    n = 0
    for p in parts:
        b = int(p)
        if not 0 <= b <= 255:
            raise MapperParsingError(f"failed to parse ip [{value}]")
        n = (n << 8) | b
    return n


def format_ip(n: int) -> str:
    return ".".join(str((n >> s) & 0xFF) for s in (24, 16, 8, 0))


def parse_date(value: Any, formats: list[str] | None = None) -> int:
    """A date value → epoch millis (UTC): epoch-millis numbers, ISO-8601
    (strict_date_optional_time), or the JAX package's fallback formats."""
    if isinstance(value, bool):
        raise MapperParsingError(f"cannot parse boolean [{value}] as date")
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value).strip()
    if s.isdigit() or (s.startswith("-") and s[1:].isdigit()):
        return int(s)
    m = _ISO_RE.match(s)
    if m:
        y, mo, d = int(m.group(1)), int(m.group(2)), int(m.group(3))
        hh, mm, ss = int(m.group(4) or 0), int(m.group(5) or 0), int(m.group(6) or 0)
        micros = int(float("0." + (m.group(7) or "0")) * 1e6)
        tz = m.group(8)
        tzinfo = _dt.timezone.utc
        if tz and tz != "Z":
            sign = 1 if tz[0] == "+" else -1
            tz = tz[1:].replace(":", "")
            tzinfo = _dt.timezone(sign * _dt.timedelta(hours=int(tz[:2]),
                                                       minutes=int(tz[2:] or 0)))
        dt = _dt.datetime(y, mo, d, hh, mm, ss, micros, tzinfo=tzinfo)
        return int(dt.timestamp() * 1000)
    for fmt in formats or ("%Y/%m/%d %H:%M:%S", "%Y/%m/%d", "%d-%m-%Y", "%m/%d/%Y"):
        try:
            dt = _dt.datetime.strptime(s, fmt).replace(tzinfo=_dt.timezone.utc)
            return int(dt.timestamp() * 1000)
        except ValueError:
            continue
    raise MapperParsingError(f"failed to parse date field [{value}]")


# "now-1d/d" style date math used by range queries
_DATE_MATH_RE = re.compile(r"^now(?:([+-]\d+)([yMwdhHms]))?(?:/([yMwdhHms]))?$")
_UNIT_MILLIS = {
    "y": 365 * 86400_000, "M": 30 * 86400_000, "w": 7 * 86400_000,
    "d": 86400_000, "h": 3600_000, "H": 3600_000, "m": 60_000, "s": 1000,
}


def parse_date_math(value: str, now_ms: int | None = None,
                    formats: list[str] | None = None) -> int:
    """`now`, `now-1d`, `now/d`, `now+2h/h` → epoch millis; any other value
    parses as a date, in the mapping's `formats` when it names any."""
    m = _DATE_MATH_RE.match(value)
    if not m:
        return parse_date(value, formats)
    t = now_ms if now_ms is not None else int(time.time() * 1000)
    if m.group(1):
        t += int(m.group(1)) * _UNIT_MILLIS[m.group(2)]
    if m.group(3):
        unit = _UNIT_MILLIS[m.group(3)]
        t = (t // unit) * unit
    return t


@dataclass
class FieldType:
    """Resolved view of one field's mapping."""

    name: str
    type: str = "string"
    index: str = "analyzed"  # analyzed | not_analyzed | no
    store: bool = False
    boost: float = 1.0
    analyzer: str | None = None
    search_analyzer: str | None = None
    formats: list[str] | None = None  # date formats
    null_value: Any = None
    include_in_all: bool = True
    doc_values: bool = True
    copy_to: list[str] = dc_field(default_factory=list)
    nested: bool = False  # an object of type nested

    @property
    def is_text(self) -> bool:
        return self.type in TEXT_TYPES

    @property
    def is_numeric(self) -> bool:
        return self.type in NUMERIC_TYPES

    @property
    def searchable(self) -> bool:
        return self.index != "no"

    @property
    def analyzed(self) -> bool:
        return self.is_text and self.index == "analyzed"

    def coerce(self, value: Any):
        """A raw JSON value as the column stores it: ints, floats, epoch
        millis for dates, 0/1 for booleans, an int for an ip."""
        t = self.type
        if value is None:
            value = self.null_value
            if value is None:
                return None
        if t in _INT_BOUNDS or t == "token_count":
            try:
                v = int(float(value)) if not isinstance(value, bool) else int(value)
            except (TypeError, ValueError):
                raise MapperParsingError(
                    f"failed to parse [{self.name}] value [{value}] as {t}")
            lo, hi = _INT_BOUNDS.get(t, _INT_BOUNDS["long"])
            if not lo <= v <= hi:
                raise MapperParsingError(
                    f"value [{value}] out of range for {t} field [{self.name}]")
            return v
        if t in ("double", "float"):
            try:
                return float(value)
            except (TypeError, ValueError):
                raise MapperParsingError(
                    f"failed to parse [{self.name}] value [{value}] as {t}")
        if t == "date":
            return parse_date(value, self.formats)
        if t == "boolean":
            if isinstance(value, bool):
                return 1 if value else 0
            return 1 if str(value).lower() in ("true", "1", "on", "yes") else 0
        if t == "ip":
            return parse_ip(value) if isinstance(value, str) else int(value)
        return value

    def to_mapping(self) -> dict:
        d: dict[str, Any] = {"type": "string" if self.type == "text" else self.type}
        if self.is_text and self.index != "analyzed":
            d["index"] = self.index
        elif not self.is_text and self.index == "no":
            d["index"] = "no"
        if self.store:
            d["store"] = True
        if self.boost != 1.0:
            d["boost"] = self.boost
        if self.analyzer:
            d["analyzer"] = self.analyzer
        if self.null_value is not None:
            d["null_value"] = self.null_value
        if self.copy_to:
            d["copy_to"] = self.copy_to
        return d


@dataclass
class ParsedDocument:
    """Output of DocumentMapper.parse — what the segment builder consumes."""

    id: str
    type: str
    uid: str
    source: dict
    routing: str | None = None
    timestamp: int | None = None
    ttl: int | None = None  # milliseconds
    parent: str | None = None
    # field → list[(term, position)]
    postings: dict[str, list[tuple[str, int]]] = dc_field(default_factory=dict)
    # field → token count (for norms)
    field_lengths: dict[str, int] = dc_field(default_factory=dict)
    # field → numeric value(s) of the doc-value column
    doc_values_num: dict[str, list[float]] = dc_field(default_factory=dict)
    # string field → the doc's values as given (null_value included): the
    # segment's string doc values
    doc_values_str: dict[str, list[str]] = dc_field(default_factory=dict)
    # nested documents in block order: (nested path, their ParsedDocument)
    nested_docs: list[tuple[str, "ParsedDocument"]] = dc_field(default_factory=list)


def _infer_dynamic_type(value: Any, dynamic_date: bool = True) -> str | None:
    if isinstance(value, bool):
        return "boolean"
    if isinstance(value, int):
        return "long"
    if isinstance(value, float):
        return "double"
    if isinstance(value, str):
        if dynamic_date and _ISO_RE.match(value.strip()):
            return "date"
        return "string"
    if isinstance(value, dict):
        return "object"
    return None


class DocumentMapper:
    """Parses docs of one mapping type; holds that type's field registry."""

    def __init__(self, type_name: str, mapping: dict | None,
                 analysis: AnalysisService):
        self.type = type_name
        self.analysis = analysis
        mapping = mapping or {}
        self.dynamic = mapping.get("dynamic", True)
        self.date_detection = mapping.get("date_detection", True)
        self.source_enabled = mapping.get("_source", {}).get("enabled", True)
        self.all_enabled = mapping.get("_all", {}).get("enabled", True)
        self.routing_required = mapping.get("_routing", {}).get("required", False)
        self.routing_path = mapping.get("_routing", {}).get("path")
        self.parent_type = mapping.get("_parent", {}).get("type")
        self.timestamp_enabled = mapping.get("_timestamp", {}).get("enabled", False)
        self.timestamp_path = mapping.get("_timestamp", {}).get("path")
        self.ttl_enabled = mapping.get("_ttl", {}).get("enabled", False)
        self.default_ttl = mapping.get("_ttl", {}).get("default")
        self.fields: dict[str, FieldType] = {}
        # set when parsing mapped a field dynamically (a copy_to target too)
        self._mapping_dirty = False
        self._parse_properties(mapping.get("properties", {}), prefix="")

    def _parse_properties(self, props: dict, prefix: str):
        for name, spec in props.items():
            full = f"{prefix}{name}"
            if not isinstance(spec, dict):
                raise MapperParsingError(f"invalid mapping for field [{full}]")
            ftype = spec.get("type")
            if ftype in (None, "object", "nested") and (
                    "properties" in spec or ftype in ("object", "nested")):
                self.fields[full] = FieldType(name=full, type="object",
                                              nested=ftype == "nested")
                self._parse_properties(spec.get("properties", {}), prefix=f"{full}.")
                continue
            if ftype == "multi_field":
                # legacy multi_field: sub-fields full.sub, the one named like
                # the field is the field itself
                for sub, subspec in spec.get("fields", {}).items():
                    sub_full = full if sub == name else f"{full}.{sub}"
                    self.fields[sub_full] = self._field_type_from_spec(sub_full, subspec)
                continue
            self.fields[full] = self._field_type_from_spec(full, spec)
            for sub, subspec in spec.get("fields", {}).items():
                self.fields[f"{full}.{sub}"] = self._field_type_from_spec(
                    f"{full}.{sub}", subspec)

    def _field_type_from_spec(self, full: str, spec: dict) -> FieldType:
        ftype = spec.get("type", "string")
        if ftype == "text":
            ftype = "string"
        if ftype == "keyword":  # alias: not_analyzed string
            ftype = "string"
            spec = {**spec, "index": "not_analyzed"}
        index = spec.get("index", "analyzed" if ftype in TEXT_TYPES else "yes")
        if index == "yes":
            index = "analyzed" if ftype in TEXT_TYPES else "not_analyzed"
        copy_to = spec.get("copy_to", [])
        if isinstance(copy_to, str):
            copy_to = [copy_to]
        return FieldType(
            name=full,
            type=ftype,
            index=index,
            store=bool(spec.get("store", False) in (True, "yes", "true")),
            boost=float(spec.get("boost", 1.0)),
            analyzer=spec.get("analyzer") or spec.get("index_analyzer"),
            search_analyzer=spec.get("search_analyzer"),
            formats=[spec["format"]] if "format" in spec else None,
            null_value=spec.get("null_value"),
            include_in_all=spec.get("include_in_all", True),
            doc_values=spec.get("doc_values", True),
            copy_to=copy_to,
        )

    def field_type(self, name: str) -> FieldType | None:
        return self.fields.get(name)

    def parse(self, source: dict, doc_id: str, routing: str | None = None,
              timestamp=None, ttl=None, parent: str | None = None) -> ParsedDocument:
        if not isinstance(source, dict):
            raise MapperParsingError("document source must be an object")
        doc = ParsedDocument(id=doc_id, type=self.type,
                             uid=f"{self.type}#{doc_id}", source=source,
                             routing=routing, parent=parent)
        # an explicit timestamp always takes effect; the `_timestamp` doc
        # value is stored only when the meta-field is enabled
        if timestamp is not None:
            doc.timestamp = parse_date(timestamp)
        elif self.timestamp_enabled:
            if self.timestamp_path and self.timestamp_path in source:
                doc.timestamp = parse_date(source[self.timestamp_path])
            else:
                doc.timestamp = int(time.time() * 1000)
        if self.ttl_enabled:
            raw_ttl = ttl if ttl is not None else self.default_ttl
            if raw_ttl is not None:
                doc.ttl = int(parse_time(raw_ttl) * 1000) if isinstance(raw_ttl, str) \
                    else int(raw_ttl)
        if self.routing_path and routing is None and self.routing_path in source:
            doc.routing = str(source[self.routing_path])
        if parent is not None:
            # a child document: the parent pointer for the joins, and its
            # routing when none is given
            doc.parent = str(parent)
            doc.doc_values_str["_parent"] = [doc.parent]
            doc.postings["_parent"] = [(f"{self.parent_type or 'doc'}#{doc.parent}", 0)]
            if doc.routing is None:
                doc.routing = doc.parent
        if doc.ttl is not None:
            now = int(time.time() * 1000)
            expiry = (doc.timestamp if doc.timestamp is not None else now) + doc.ttl
            if expiry < now:
                raise AlreadyExpiredError(
                    f"already expired [{doc_id}]: expiry [{expiry}] < now")
            doc.doc_values_num["_expiry"] = [float(expiry)]
        if doc.timestamp is not None and self.timestamp_enabled:
            doc.doc_values_num["_timestamp"] = [float(doc.timestamp)]
        all_terms: list[tuple[str, int]] = []
        self._parse_object(source, "", doc, all_terms)
        if self.all_enabled and all_terms:
            doc.postings["_all"] = all_terms
            doc.field_lengths["_all"] = len(all_terms)
        # meta-field postings (norm-less: the mapper records no length for them)
        doc.postings["_uid"] = [(doc.uid, 0)]
        doc.postings["_id"] = [(doc.id, 0)]
        doc.postings["_type"] = [(self.type, 0)]
        return doc

    def _parse_object(self, obj: dict, prefix: str, doc: ParsedDocument,
                      all_terms: list):
        for key, value in obj.items():
            if key in META_FIELDS:
                continue
            full = f"{prefix}{key}"
            ft = self.fields.get(full)
            if isinstance(value, dict) and (ft is None or ft.type == "object"):
                if ft is None:
                    if self.dynamic == "strict":
                        raise MapperParsingError(
                            f"strict dynamic mapping: unknown field [{full}]")
                    if not self.dynamic:
                        continue
                    self.fields[full] = ft = FieldType(name=full, type="object")
                    self._mapping_dirty = True
                if ft.nested:
                    self._add_nested(doc, full, value)
                else:
                    self._parse_object(value, f"{full}.", doc, all_terms)
                continue
            values = value if isinstance(value, list) else [value]
            if values and all(isinstance(v, dict) for v in values) \
                    and ft is not None and ft.nested:
                for v in values:
                    self._add_nested(doc, full, v)
                continue
            if values and all(isinstance(v, dict) for v in values) and (
                    ft is None or ft.type not in GEO_TYPES):
                # array of objects, non-nested: flatten each (a geo type
                # takes its object form as a leaf value)
                for v in values:
                    self._parse_object(v, f"{full}.", doc, all_terms)
                continue
            if ft is None:
                if self.dynamic == "strict":
                    raise MapperParsingError(
                        f"strict dynamic mapping: unknown field [{full}]")
                if not self.dynamic:
                    continue
                sample = next((v for v in values if v is not None), None)
                inferred = _infer_dynamic_type(sample, self.date_detection)
                if inferred is None:
                    continue
                ft = self._field_type_from_spec(full, {"type": inferred})
                self.fields[full] = ft
                self._mapping_dirty = True
            self._index_values(ft, values, doc, all_terms)
            for target in ft.copy_to:
                tft = self.fields.get(target)
                if tft is None:
                    tft = self._field_type_from_spec(target, {"type": ft.type})
                    self.fields[target] = tft
                    self._mapping_dirty = True
                self._index_values(tft, values, doc, all_terms=[])

    def _add_nested(self, doc: ParsedDocument, path: str, obj: dict):
        """One nested object as a document of its own, parsed under `path`
        (it adds nothing to the parent's `_all`)."""
        sub = ParsedDocument(id=doc.id, type=self.type, uid=doc.uid, source=obj)
        self._parse_object(obj, f"{path}.", sub, [])
        doc.nested_docs.append((path, sub))

    def _index_values(self, ft: FieldType, values: list, doc: ParsedDocument,
                      all_terms: list):
        if not ft.searchable and not ft.doc_values:
            return
        if ft.is_numeric:
            col = doc.doc_values_num.setdefault(ft.name, [])
            col.extend(float(cv) for cv in (ft.coerce(v) for v in values)
                       if cv is not None)
            if not col:
                doc.doc_values_num.pop(ft.name, None)
            return
        if ft.type == "geo_point":
            for lat, lon in _parse_geo_points(values):
                doc.doc_values_num.setdefault(f"{ft.name}.lat", []).append(lat)
                doc.doc_values_num.setdefault(f"{ft.name}.lon", []).append(lon)
            return
        if ft.type == "geo_shape":
            # relations evaluate on the host from the parsed form
            # (search/filters.py GeoShapeFilter)
            for v in values:
                if not isinstance(v, dict):
                    raise MapperParsingError(f"failed to parse geo_shape [{v}]")
                try:
                    kind, data = normalize_shape(v)
                except ValueError as e:
                    raise MapperParsingError(str(e))
                doc.doc_values_str.setdefault(ft.name, []).append(
                    json.dumps([kind, data], separators=(",", ":")))
            return
        if ft.type == "binary":
            return  # kept in _source only
        if not ft.is_text:
            # a type the mapper does not list: its values as string doc values
            for v in values:
                if v is not None:
                    doc.doc_values_str.setdefault(ft.name, []).append(str(v))
            return
        analyzer = self.analysis.analyzer(ft.analyzer)
        terms = doc.postings.setdefault(ft.name, [])
        pos_base = doc.field_lengths.get(ft.name, 0)
        for v in values:
            if v is None:
                if ft.null_value is None:
                    continue
                v = ft.null_value
            text = str(v)
            doc.doc_values_str.setdefault(ft.name, []).append(text)
            if ft.analyzed:
                toks = analyzer.index_tokens(text)
                for term, pos in toks:
                    terms.append((term, pos_base + pos))
                    if ft.include_in_all and self.all_enabled:
                        all_terms.append((term, len(all_terms)))
                pos_base += len(toks) + 100  # position gap between values
            else:
                terms.append((text, pos_base))
                pos_base += 1
                if ft.include_in_all and self.all_enabled:
                    all_terms.append((text, len(all_terms)))
        doc.field_lengths[ft.name] = len(terms)

    def to_mapping(self) -> dict:
        """The mapping as the cluster state stores it (the JAX package's
        rendering: leaf fields under nested `properties`, objects implied,
        a sub-field under its parent's `fields`)."""
        props: dict[str, Any] = {}
        multi = []  # (parent_parts, leaf, ft)
        for name, ft in sorted(self.fields.items()):
            if ft.type == "object":
                continue
            parts = name.split(".")
            parent = self.fields.get(".".join(parts[:-1])) if len(parts) > 1 else None
            if parent is not None and parent.type != "object":
                multi.append((parts[:-1], parts[-1], ft))
                continue
            node = props
            for p in parts[:-1]:
                obj_ft = self.fields.get(".".join(parts[: parts.index(p) + 1]))
                node = node.setdefault(
                    p, {"type": "nested"} if obj_ft and obj_ft.nested else {})
                node = node.setdefault("properties", {})
            node[parts[-1]] = ft.to_mapping()
        for parent_parts, leaf, ft in multi:
            node = props
            for i, p in enumerate(parent_parts):
                if i:
                    node = node.setdefault("properties", {})
                node = node.setdefault(p, {})
            node.setdefault("fields", {})[leaf] = ft.to_mapping()
        out: dict[str, Any] = {"properties": props}
        if not self.source_enabled:
            out["_source"] = {"enabled": False}
        if not self.all_enabled:
            out["_all"] = {"enabled": False}
        if self.routing_required or self.routing_path:
            out["_routing"] = {k: v for k, v in (("required", self.routing_required),
                                                 ("path", self.routing_path)) if v}
        if self.parent_type:
            out["_parent"] = {"type": self.parent_type}
        if self.timestamp_enabled:
            out["_timestamp"] = {"enabled": True}
        if self.ttl_enabled:
            out["_ttl"] = {"enabled": True}
        return out

    def merge(self, new_mapping: dict) -> list[str]:
        """Merge another mapping of this type in; returns the conflicts."""
        other = DocumentMapper(self.type, new_mapping, self.analysis)
        conflicts = []
        for name, ft in other.fields.items():
            mine = self.fields.get(name)
            if mine is None:
                self.fields[name] = ft
            elif mine.type != ft.type and not {mine.type, ft.type} <= {"object"}:
                conflicts.append(f"mapper [{name}] of different type, current "
                                 f"[{mine.type}], merged [{ft.type}]")
            elif mine.index != ft.index:
                conflicts.append(f"mapper [{name}] has different index values")
            elif mine.analyzer != ft.analyzer:
                conflicts.append(f"mapper [{name}] has different analyzer")
        return conflicts


def _parse_geo_points(values: list) -> list[tuple[float, float]]:
    """One or many points: {lat, lon}, "lat,lon", a geohash or [lon, lat];
    a bare numeric pair is ONE point (GeoJSON order), anything else is read
    element by element."""
    if len(values) == 2 and all(isinstance(x, (int, float)) for x in values):
        return [(float(values[1]), float(values[0]))]
    return [_parse_geo_point(v) for v in values]


def _parse_geo_point(v) -> tuple[float, float]:
    if isinstance(v, dict):
        return float(v["lat"]), float(v["lon"])
    if isinstance(v, str):
        if "," in v:
            lat, lon = v.split(",")
            return float(lat), float(lon)
        try:  # a bare string is a geohash
            return geohash_decode(v.strip().lower())
        except (KeyError, ValueError):
            raise MapperParsingError(f"failed to parse geohash [{v}]")
    if isinstance(v, list):
        if len(v) == 2 and all(isinstance(x, (int, float)) for x in v):
            return float(v[1]), float(v[0])  # GeoJSON order [lon, lat]
    raise MapperParsingError(f"failed to parse geo_point [{v}]")


class MapperService:
    """type → DocumentMapper registry for one index."""

    DEFAULT_TYPE = "_default_"

    def __init__(self, index_settings: Settings | None = None,
                 analysis: AnalysisService | None = None):
        self.settings = index_settings or Settings.EMPTY
        self.analysis = analysis or AnalysisService(self.settings)
        self.mappers: dict[str, DocumentMapper] = {}
        self._default_mapping: dict = {}

    def put_mapping(self, type_name: str, mapping: dict) -> None:
        """Register a type's mapping, or merge it into the registered one
        (conflicts raise MapperParsingError)."""
        body = mapping.get(type_name, mapping)
        if type_name == self.DEFAULT_TYPE:
            self._default_mapping = body
            return
        existing = self.mappers.get(type_name)
        if existing is not None:
            conflicts = existing.merge(body)
            if conflicts:
                raise MapperParsingError(f"mapping merge conflicts: {conflicts}")
            return
        merged = dict(self._default_mapping)
        merged.update(body)
        self.mappers[type_name] = DocumentMapper(type_name, merged, self.analysis)

    def mapper_for(self, type_name: str) -> DocumentMapper:
        m = self.mappers.get(type_name)
        if m is None:
            m = DocumentMapper(type_name, dict(self._default_mapping), self.analysis)
            self.mappers[type_name] = m
        return m

    def types(self) -> list[str]:
        return list(self.mappers)

    def field_type(self, field: str) -> FieldType | None:
        for mapper in self.mappers.values():
            ft = mapper.field_type(field)
            if ft is not None:
                return ft
        return None

    def search_analyzer_for(self, field: str) -> Analyzer:
        ft = self.field_type(field)
        if ft is None or not ft.is_text:
            return self.analysis.analyzer("default")
        return self.analysis.analyzer(ft.search_analyzer or ft.analyzer)

    def mappings_dict(self) -> dict:
        return {t: m.to_mapping() for t, m in self.mappers.items()}
