"""Document mapping: JSON docs → per-field term streams, field lengths and
numeric columns (a trimmed copy of the JAX package's `mapper/core.py`).

Field lengths decide the norm bytes and so the scores: they are computed
exactly as the JAX package computes them, `_all` included. Dynamic mapping
resolves an unseen field as the JAX package does: strings map to analyzed
`string`, ISO-8601 strings to `date`, ints to `long`, floats to `double`,
booleans to `boolean`, objects to `object`; `to_mapping` renders the
resulting mapping the same way. A numeric, date or boolean value is coerced
and stored in a doc-value column, which term, terms and range queries and
filters read (`search/filters.py`). A string field counts its values per
document (the JAX package's string doc-value column holds them; the port
keeps only the count, which `exists` and `missing` read). Nested fields,
multi-fields, copy_to, geo and the `_routing`/`_parent`/`_timestamp`/`_ttl`
meta-fields belong to later slices and raise MapperParsingError."""

from __future__ import annotations

import datetime as _dt
import re
import time
from dataclasses import dataclass, field as dc_field
from typing import Any

from ..analysis import AnalysisService, Analyzer
from ..common.errors import MapperParsingError
from ..common.settings import Settings

TEXT_TYPES = {"string", "text"}
NUMERIC_TYPES = {"long", "integer", "short", "byte", "double", "float", "date",
                 "boolean"}

_INT_BOUNDS = {"byte": (-(2**7), 2**7 - 1), "short": (-(2**15), 2**15 - 1),
               "integer": (-(2**31), 2**31 - 1), "long": (-(2**63), 2**63 - 1)}

_ISO_RE = re.compile(
    r"^(\d{4})-(\d{2})-(\d{2})(?:[T ](\d{2}):(\d{2})(?::(\d{2})(?:\.(\d{1,9}))?)?"
    r"(Z|[+-]\d{2}:?\d{2})?)?$"
)

META_FIELDS = ("_uid", "_id", "_type", "_source", "_all", "_routing", "_parent",
               "_timestamp", "_ttl", "_version", "_size", "_index", "_boost")

_LATER_META = ("_routing", "_parent", "_timestamp", "_ttl")


def _not_ported(what: str) -> MapperParsingError:
    return MapperParsingError(
        f"{what} is not ported yet (a later slice of the port); this slice "
        "maps string, numeric, date, boolean and object fields")


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
        millis for dates, 0/1 for booleans."""
        t = self.type
        if value is None:
            value = self.null_value
            if value is None:
                return None
        if t in _INT_BOUNDS:
            try:
                v = int(float(value)) if not isinstance(value, bool) else int(value)
            except (TypeError, ValueError):
                raise MapperParsingError(
                    f"failed to parse [{self.name}] value [{value}] as {t}")
            lo, hi = _INT_BOUNDS[t]
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
        if isinstance(value, bool):
            return 1 if value else 0
        return 1 if str(value).lower() in ("true", "1", "on", "yes") else 0

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
        return d


@dataclass
class ParsedDocument:
    """Output of DocumentMapper.parse — what the segment builder consumes."""

    id: str
    type: str
    uid: str
    source: dict
    routing: str | None = None
    # field → list[(term, position)]
    postings: dict[str, list[tuple[str, int]]] = dc_field(default_factory=dict)
    # field → token count (for norms)
    field_lengths: dict[str, int] = dc_field(default_factory=dict)
    # field → numeric value(s) of the doc-value column
    doc_values_num: dict[str, list[float]] = dc_field(default_factory=dict)
    # string field → how many values the doc gave it (null_value included)
    str_value_counts: dict[str, int] = dc_field(default_factory=dict)


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
        later = [m for m in _LATER_META if m in mapping]
        if later:
            raise _not_ported(f"meta-field mapping {later}")
        self.dynamic = mapping.get("dynamic", True)
        self.date_detection = mapping.get("date_detection", True)
        self.source_enabled = mapping.get("_source", {}).get("enabled", True)
        self.all_enabled = mapping.get("_all", {}).get("enabled", True)
        self.fields: dict[str, FieldType] = {}
        self._parse_properties(mapping.get("properties", {}), prefix="")

    def _parse_properties(self, props: dict, prefix: str):
        for name, spec in props.items():
            full = f"{prefix}{name}"
            if not isinstance(spec, dict):
                raise MapperParsingError(f"invalid mapping for field [{full}]")
            ftype = spec.get("type")
            if ftype == "nested":
                raise _not_ported(f"nested field [{full}]")
            if ftype in (None, "object") and ("properties" in spec or ftype == "object"):
                self.fields[full] = FieldType(name=full, type="object")
                self._parse_properties(spec.get("properties", {}), prefix=f"{full}.")
                continue
            if spec.get("fields") or ftype == "multi_field" or spec.get("copy_to"):
                raise _not_ported(f"multi-field / copy_to of [{full}]")
            self.fields[full] = self._field_type_from_spec(full, spec)

    def _field_type_from_spec(self, full: str, spec: dict) -> FieldType:
        ftype = spec.get("type", "string")
        if ftype == "text":
            ftype = "string"
        if ftype == "keyword":  # alias: not_analyzed string
            ftype = "string"
            spec = {**spec, "index": "not_analyzed"}
        if ftype not in TEXT_TYPES and ftype not in NUMERIC_TYPES:
            raise _not_ported(f"field type [{ftype}] of [{full}]")
        index = spec.get("index", "analyzed" if ftype in TEXT_TYPES else "yes")
        if index == "yes":
            index = "analyzed" if ftype in TEXT_TYPES else "not_analyzed"
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
        )

    def field_type(self, name: str) -> FieldType | None:
        return self.fields.get(name)

    def parse(self, source: dict, doc_id: str,
              routing: str | None = None) -> ParsedDocument:
        if not isinstance(source, dict):
            raise MapperParsingError("document source must be an object")
        doc = ParsedDocument(id=doc_id, type=self.type,
                             uid=f"{self.type}#{doc_id}", source=source,
                             routing=routing)
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
                    self.fields[full] = FieldType(name=full, type="object")
                self._parse_object(value, f"{full}.", doc, all_terms)
                continue
            values = value if isinstance(value, list) else [value]
            if values and all(isinstance(v, dict) for v in values):
                # array of objects, non-nested: flatten each
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
            self._index_values(ft, values, doc, all_terms)

    def _index_values(self, ft: FieldType, values: list, doc: ParsedDocument,
                      all_terms: list):
        if not ft.searchable and not ft.doc_values:
            return
        if ft.is_numeric:
            col = [float(cv) for cv in (ft.coerce(v) for v in values)
                   if cv is not None]
            if col:
                doc.doc_values_num.setdefault(ft.name, []).extend(col)
            return
        if not ft.is_text:
            raise _not_ported(f"field type [{ft.type}] of [{ft.name}]")
        analyzer = self.analysis.analyzer(ft.analyzer)
        terms = doc.postings.setdefault(ft.name, [])
        pos_base = doc.field_lengths.get(ft.name, 0)
        for v in values:
            if v is None:
                if ft.null_value is None:
                    continue
                v = ft.null_value
            text = str(v)
            doc.str_value_counts[ft.name] = doc.str_value_counts.get(ft.name, 0) + 1
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
        rendering: leaf fields under nested `properties`, objects implied)."""
        props: dict[str, Any] = {}
        for name, ft in sorted(self.fields.items()):
            if ft.type == "object":
                continue
            parts = name.split(".")
            node = props
            for p in parts[:-1]:
                node = node.setdefault(p, {}).setdefault("properties", {})
            node[parts[-1]] = ft.to_mapping()
        out: dict[str, Any] = {"properties": props}
        if not self.source_enabled:
            out["_source"] = {"enabled": False}
        if not self.all_enabled:
            out["_all"] = {"enabled": False}
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
