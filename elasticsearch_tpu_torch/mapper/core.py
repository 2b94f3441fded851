"""Document mapping for `string` fields: JSON docs → per-field term streams
and field lengths (a trimmed copy of the JAX package's `mapper/core.py`).

Field lengths decide the norm bytes and so the scores: they are computed
exactly as the JAX package computes them, `_all` included. Field types other
than `string` (numbers, dates, geo, nested, multi-fields, copy_to) belong to
later slices of the port and raise MapperParsingError here."""

from __future__ import annotations

import re
from dataclasses import dataclass, field as dc_field
from typing import Any

from ..analysis import AnalysisService, Analyzer
from ..common.errors import MapperParsingError
from ..common.settings import Settings

TEXT_TYPES = {"string", "text"}

# ISO-8601 dates: dynamic mapping would map such strings to `date` fields
_ISO_RE = re.compile(
    r"^(\d{4})-(\d{2})-(\d{2})(?:[T ](\d{2}):(\d{2})(?::(\d{2})(?:\.(\d{1,9}))?)?"
    r"(Z|[+-]\d{2}:?\d{2})?)?$"
)

META_FIELDS = ("_uid", "_id", "_type", "_source", "_all", "_routing", "_parent",
               "_timestamp", "_ttl", "_version", "_size", "_index", "_boost")


def _not_ported(what: str) -> MapperParsingError:
    return MapperParsingError(
        f"{what} is not ported yet (a later slice of the port); this slice "
        "maps string fields")


@dataclass
class FieldType:
    """Resolved view of one field's mapping."""

    name: str
    type: str = "string"
    index: str = "analyzed"  # analyzed | not_analyzed | no
    analyzer: str | None = None
    search_analyzer: str | None = None
    null_value: Any = None
    include_in_all: bool = True
    doc_values: bool = True

    @property
    def is_text(self) -> bool:
        return self.type in TEXT_TYPES

    @property
    def is_numeric(self) -> bool:
        return False  # numeric types are not mapped by this slice

    @property
    def searchable(self) -> bool:
        return self.index != "no"

    @property
    def analyzed(self) -> bool:
        return self.is_text and self.index == "analyzed"


@dataclass
class ParsedDocument:
    """Output of DocumentMapper.parse — what the segment builder consumes."""

    id: str
    type: str
    uid: str
    source: dict
    # field → list[(term, position)]
    postings: dict[str, list[tuple[str, int]]] = dc_field(default_factory=dict)
    # field → token count (for norms)
    field_lengths: dict[str, int] = dc_field(default_factory=dict)


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
        if ftype not in TEXT_TYPES:
            raise _not_ported(f"field type [{ftype}] of [{full}]")
        index = spec.get("index", "analyzed")
        if index == "yes":
            index = "analyzed"
        return FieldType(
            name=full,
            type=ftype,
            index=index,
            analyzer=spec.get("analyzer") or spec.get("index_analyzer"),
            search_analyzer=spec.get("search_analyzer"),
            null_value=spec.get("null_value"),
            include_in_all=spec.get("include_in_all", True),
            doc_values=spec.get("doc_values", True),
        )

    def field_type(self, name: str) -> FieldType | None:
        return self.fields.get(name)

    def parse(self, source: dict, doc_id: str) -> ParsedDocument:
        if not isinstance(source, dict):
            raise MapperParsingError("document source must be an object")
        doc = ParsedDocument(id=doc_id, type=self.type,
                             uid=f"{self.type}#{doc_id}", source=source)
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
        if not ft.is_text:
            raise _not_ported(f"field type [{ft.type}] of [{ft.name}]")
        if not ft.searchable and not ft.doc_values:
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


class MapperService:
    """type → DocumentMapper registry for one index."""

    def __init__(self, index_settings: Settings | None = None,
                 analysis: AnalysisService | None = None):
        self.settings = index_settings or Settings.EMPTY
        self.analysis = analysis or AnalysisService(self.settings)
        self.mappers: dict[str, DocumentMapper] = {}

    def put_mapping(self, type_name: str, mapping: dict) -> None:
        body = mapping.get(type_name, mapping)
        if type_name in self.mappers:
            raise _not_ported(f"mapping merge for type [{type_name}]")
        self.mappers[type_name] = DocumentMapper(type_name, body, self.analysis)

    def mapper_for(self, type_name: str) -> DocumentMapper:
        m = self.mappers.get(type_name)
        if m is None:
            m = DocumentMapper(type_name, {}, self.analysis)
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
