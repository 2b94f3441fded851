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

    def es1_string(self) -> str:
        """The ES 1.x one-string rendering, `Type[message]` with nested
        causes: the shape of a per-item error (`_mpercolate`)."""
        out = f"{self.wire_name()}[{self.message}]"
        if self.cause is not None:
            inner = (self.cause.es1_string() if isinstance(self.cause, SearchEngineError)
                     else f"{type(self.cause).__name__}[{self.cause}]")
            out += f"; nested: {inner}"
        return out

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


class BodyValueError(QueryParsingError):
    """A value of a search body that does not parse (`minimum_should_match:
    "abc"`, `min_score: "abc"`, `window_size: "x"`, an unknown
    `boost_mode`). Its message is the JAX node's shard failure's reason
    (Python's own for a conversion), and the shard that reads the value
    fails with it. A device attempt that meets one hands its shard to the
    host path, as the JAX node's device attempts do with any error, and
    the host path meets it again where it reads the value."""


def body_value(convert, value):
    """`convert(value)`, a conversion's ValueError or TypeError raised as a
    BodyValueError with the same message."""
    try:
        return convert(value)
    except (TypeError, ValueError) as e:
        raise BodyValueError(str(e)) from None


class InvalidIndexNameError(IllegalArgumentError):
    pass


class DocumentMissingError(SearchEngineError):
    status = 404


class IndexMissingError(SearchEngineError):
    status = 404

    def __init__(self, index: str):
        super().__init__(f"[{index}] missing")
        self.index = index


class NodeMissingError(SearchEngineError):
    """A node-addressed API named an id or name no node of the cluster
    answers to (`/_cluster/stats/nodes/{node_id}`)."""

    status = 404

    def __init__(self, node_id: str):
        super().__init__(f"node [{node_id}] missing")
        self.node_id = node_id


class IndexAlreadyExistsError(SearchEngineError):
    status = 400

    def __init__(self, index: str):
        super().__init__(f"index [{index}] already exists")
        self.index = index


class TypeMissingError(SearchEngineError):
    status = 404


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


class NoNodeAvailableError(SearchEngineError):
    """Every node a TransportClient knows refused or timed out."""

    status = 503


class ClusterBlockError(SearchEngineError):
    """Rejected by a cluster-level or index-level block: 503 when every
    block is retryable (no master, state not recovered), else 403 (a closed
    index, `index.blocks.*`)."""

    RETRYABLE = {"no_master", "state_not_recovered"}

    def __init__(self, blocks):
        super().__init__(f"blocked by: {[str(b) for b in blocks]}")
        self.blocks = blocks
        self.status = 503 if all(b[0] in self.RETRYABLE for b in blocks) else 403


class NoShardAvailableError(SearchEngineError):
    status = 503


class UnavailableShardsError(SearchEngineError):
    status = 503


class ScriptError(SearchEngineError):
    """A script failed to compile or to run (a REST 400)."""

    status = 400


class PercolateError(SearchEngineError):
    pass


class AliasesMissingError(SearchEngineError):
    """An alias `remove` or a `GET /_alias/{name}` that matched nothing."""

    status = 404

    def __init__(self, aliases):
        super().__init__(f"aliases {list(aliases)} missing")
        self.aliases = list(aliases)


class IndexTemplateMissingError(SearchEngineError):
    status = 404

    def __init__(self, name):
        super().__init__(f"index_template [{name}] missing")


class IndexWarmerMissingError(SearchEngineError):
    status = 404

    def __init__(self, name):
        super().__init__(f"index_warmer [{name}] missing")


class SnapshotError(SearchEngineError):
    pass


class SnapshotMissingError(SnapshotError):
    status = 404


class RepositoryError(SearchEngineError):
    pass


class RepositoryMissingError(RepositoryError):
    status = 404


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


class ActionRequestValidationError(IllegalArgumentError):
    """A request that failed validation before it ran (`_mget` without
    documents, or a document without an index or id)."""


class AlreadyExpiredError(SearchEngineError):
    """A document whose `_ttl` expired before it was indexed."""

    status = 400


class RoutingMissingError(IllegalArgumentError):
    def __init__(self, index: str, type_: str, id_: str):
        super().__init__(f"routing is required for [{index}]/[{type_}]/[{id_}]")


class SimilarityNotSupportedError(SearchEngineError):
    """A phrase or span query over a field whose similarity has no `idf`
    (DFR, IB, LM): the shard fails with the JAX package's AttributeError
    message as its reason."""


class SearchContextMissingError(SearchEngineError):
    """A scroll id the node does not hold (never issued, or cleared)."""

    status = 404

    def __init__(self, context_id):
        super().__init__(f"no search context found for id [{context_id}]")


class ProfileTimingError(SearchEngineError):
    """A profiled request's CUDA events could not be recorded or read: the
    request fails (no host timing stands in for the card's)."""
