"""The error classes the ported query phase raises (a trimmed copy of the
JAX package's `common/errors.py` tree: same names, same REST statuses)."""

from __future__ import annotations


class SearchEngineError(Exception):
    """Root of the exception tree."""

    status = 500

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message


class IllegalArgumentError(SearchEngineError):
    status = 400


class ParsingError(IllegalArgumentError):
    """Bad query / mapping / settings body."""


class MapperParsingError(ParsingError):
    pass


class QueryParsingError(ParsingError):
    pass
