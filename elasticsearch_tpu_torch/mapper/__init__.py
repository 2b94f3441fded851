from .core import DocumentMapper, FieldType, MapperService, ParsedDocument

__all__ = ["DocumentMapper", "FieldType", "MapperService", "ParsedDocument"]
