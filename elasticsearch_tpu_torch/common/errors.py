"""The error classes the ported query phase and its serving path raise (a
trimmed copy of the JAX package's `common/errors.py` tree: same names, same
REST statuses)."""

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


class CircuitBreakingError(SearchEngineError):
    """A memory circuit breaker tripped. 429: the node is out of memory
    headroom, not broken — clients back off and retry after `retry_after_s`.
    `breaker` names the tripped breaker ("request" / "parent")."""

    status = 429
    retry_after_s = 1.0
    breaker: str | None = None


class RejectedExecutionError(SearchEngineError):
    """A bounded queue rejected the work, or the executor behind it is shut
    down. Transient by definition: 429 with a Retry-After hint."""

    status = 429
    retry_after_s = 1.0
