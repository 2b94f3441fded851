"""The error classes the port raises (a trimmed copy of the JAX package's
`common/errors.py` tree: same names, same REST statuses, same `to_dict`
rendering of a REST error)."""

from __future__ import annotations


class SearchEngineError(Exception):
    """Root of the exception tree."""

    status = 500

    def __init__(self, message: str = "", *, cause: Exception | None = None):
        super().__init__(message)
        self.message = message
        self.cause = cause

    def wire_name(self) -> str:
        """The error type as the API shows it: `*Error` → `*Exception`."""
        name = type(self).__name__
        return name[:-len("Error")] + "Exception" if name.endswith("Error") else name

    def to_dict(self) -> dict:
        d = {"type": self.wire_name(), "reason": self.message}
        if self.cause is not None:
            d["caused_by"] = {"type": type(self.cause).__name__,
                              "reason": str(self.cause)}
        return d


class IllegalArgumentError(SearchEngineError):
    status = 400


class ParsingError(IllegalArgumentError):
    """Bad query / mapping / settings body."""


class MapperParsingError(ParsingError):
    pass


class QueryParsingError(ParsingError):
    pass


class InvalidIndexNameError(IllegalArgumentError):
    pass


class IndexMissingError(SearchEngineError):
    status = 404

    def __init__(self, index: str):
        super().__init__(f"[{index}] missing")
        self.index = index


class IndexAlreadyExistsError(SearchEngineError):
    status = 400

    def __init__(self, index: str):
        super().__init__(f"index [{index}] already exists")
        self.index = index


class IndexShardMissingError(SearchEngineError):
    status = 404


class VersionConflictError(SearchEngineError):
    """Optimistic-concurrency failure."""

    status = 409

    def __init__(self, uid: str, current: int, provided: int):
        super().__init__(
            f"version conflict for [{uid}]: current [{current}], provided [{provided}]")
        self.current = current
        self.provided = provided


class DocumentAlreadyExistsError(SearchEngineError):
    status = 409


class EngineClosedError(SearchEngineError):
    status = 503


class NodeNotConnectedError(SearchEngineError):
    status = 503


class TransportError(SearchEngineError):
    status = 503


class ActionNotFoundError(TransportError):
    status = 400


class ReceiveTimeoutError(TransportError):
    status = 503


class MasterNotDiscoveredError(SearchEngineError):
    status = 503


class ClusterBlockError(SearchEngineError):
    """Rejected by a cluster-level block: 503 when every block is retryable
    (no master, state not recovered), else 403."""

    RETRYABLE = {"no_master", "state_not_recovered"}

    def __init__(self, blocks):
        super().__init__(f"blocked by: {[str(b) for b in blocks]}")
        self.blocks = blocks
        self.status = 503 if all(b[0] in self.RETRYABLE for b in blocks) else 403


class NoShardAvailableError(SearchEngineError):
    status = 503


class UnavailableShardsError(SearchEngineError):
    status = 503


class NotPortedError(IllegalArgumentError):
    """A feature of the JAX package that a later slice of the port serves."""


class CircuitBreakingError(SearchEngineError):
    """A memory circuit breaker tripped. 429: the node is out of memory
    headroom, not broken — clients back off and retry after `retry_after_s`.
    `breaker` names the tripped breaker ("request" / "fielddata" /
    "in_flight_requests" / "parent")."""

    status = 429
    retry_after_s = 1.0
    breaker: str | None = None


class RejectedExecutionError(SearchEngineError):
    """A bounded queue rejected the work, or the executor behind it is shut
    down. Transient by definition: 429 with a Retry-After hint."""

    status = 429
    retry_after_s = 1.0
