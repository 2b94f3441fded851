"""Percolator: reverse search — match a DOCUMENT against registered queries
(the port of the JAX package's `percolator.py`).

Queries are registered as documents of the special `.percolator` type of an
index (the single-document index and delete actions feed the registry, as
in the JAX package; a `.percolator` document in a `_bulk` is indexed but not
registered there either). `percolate(doc)` parses the document into a
one-document segment and evaluates every registered query against it,
returning the ids of the queries that match.

Percolation runs many queries against one document. When at least
`DEVICE_BATCH_MIN` registered queries lower to flat plans, they run as ONE
batch on the card: `execute_flat_batch(plans, ctx, 1)` over the segment's
pack, so `sparse_score` launches at k = 1 with one row a query that shares
a term with the document (a query with no such term has no block and is in
no launch). The rest, and smaller registries, run on the host loop
(`HostScorer`). The batch is a device branch of its own fault domain,
`compile:percolate` (`search/service.py _guarded`): an open domain skips the
launch, a failure of the card serves the whole registry from the host loop
(`device_percolate_fallbacks`), and a defect of the port's launches or a
host bug raises (a 500), where the JAX package falls back on any exception.
The one-document context has no index name, as in the JAX package: its
packs land under `_unattributed` in `PACK_LEDGER`, apart from every
index's query-path packs."""

from __future__ import annotations

import threading
from contextlib import contextmanager

from .common.errors import (
    DocumentMissingError,
    PercolateError,
    SearchEngineError,
    VersionConflictError,
)
from .index.engine import Searcher
from .index.segment import SegmentBuilder
from .mapper import MapperService
from .search.execute import HostScorer, ShardContext, execute_flat_batch, lower_flat
from .search.queries import Query, parse_query
from .search.service import _count, _guarded
from .transport.faults import DEVICE_FAULTS

PERCOLATOR_TYPE = ".percolator"
PERCOLATE_DOMAIN = "compile:percolate"


@contextmanager
def _percolate_seam():
    """The percolation's fault-domain seam: the injector's check at the
    device branch's entry, and `compile:percolate` on whatever the batch
    raises. The outermost tag wins here, as the JAX package's compile tag
    does: a percolation's failure moves its own domain, never a search
    family's (`compile:sparse`) or a `pull:` domain its one-document context
    has no index for."""
    try:
        if DEVICE_FAULTS.active:
            DEVICE_FAULTS.check(PERCOLATE_DOMAIN)
        yield
    except Exception as e:  # noqa: BLE001 — re-raised tagged
        try:
            e._estpu_device_domain = PERCOLATE_DOMAIN
        except Exception:  # noqa: BLE001 — __slots__-ed exotic exceptions
            pass
        raise


def one_doc_context(doc: dict, mapper_service: MapperService, type_name: str,
                    device=None) -> ShardContext:
    """`doc` parsed by the type's mapper into a frozen one-document segment,
    in a context of its own on `device` (no index name: its packs are
    unattributed)."""
    parsed = mapper_service.mapper_for(type_name).parse(doc, doc_id="_percolate")
    builder = SegmentBuilder(gen=0)
    builder.add(parsed)
    return ShardContext(Searcher([builder.freeze()]), mapper_service, device=device)


def split_flat(items: list, ctx: ShardContext) -> tuple[list, list, list]:
    """(flat plans, their query ids, the other items): lowering trouble is
    host logic and sends its one query to the host loop."""
    plans, qids, rest = [], [], []
    for qid, (body, query) in items:
        try:
            plan = lower_flat(query, ctx)
        except Exception:  # noqa: BLE001 — lowering trouble → host loop
            plan = None
        if plan is not None:
            plans.append(plan)
            qids.append(qid)
        else:
            rest.append((qid, (body, query)))
    return plans, qids, rest


def host_matches(items: list, ctx: ShardContext) -> list[str]:
    """The ids of `items` whose query matches the one document, on the host
    scorer; a query that fails to evaluate matches nothing."""
    seg = ctx.searcher.segments[0]
    out = []
    for qid, (_body, query) in items:
        try:
            _, match = HostScorer(ctx, seg).eval(query)
        except Exception:  # noqa: BLE001 — a bad query must not break the rest
            continue
        if bool((match & seg.parent_mask).any()):
            out.append(qid)
    return out


def device_matches(plans: list, qids: list, ctx: ShardContext) -> list[str]:
    """The ids of the flat plans that match, from ONE batch at k = 1 behind
    the percolation's seam."""
    with _percolate_seam():
        tds = execute_flat_batch(plans, ctx, 1)
    return [qid for qid, td in zip(qids, tds) if td.total > 0]


class PercolatorRegistry:
    """Per-index registry of parsed percolator queries, kept in step with
    the index's `.percolator` documents."""

    DEVICE_BATCH_MIN = 64  # below this the host loop beats device dispatch

    def __init__(self):
        self._queries: dict[str, tuple[dict, Query]] = {}
        self._lock = threading.Lock()

    def register(self, query_id: str, body: dict):
        if "query" not in body:
            raise PercolateError("percolator document requires a [query]")
        q = parse_query(body["query"])
        with self._lock:
            self._queries[query_id] = (body, q)

    def unregister(self, query_id: str):
        with self._lock:
            self._queries.pop(query_id, None)

    def count(self) -> int:
        return len(self._queries)

    def percolate(self, doc: dict, mapper_service: MapperService,
                  type_name: str = "doc", filter_ids=None, device=None) -> list[str]:
        """The sorted ids of the registered queries (those in `filter_ids`
        when given) that match `doc`; the batch runs on `device` (the card
        unless the caller passes the CPU)."""
        ctx = one_doc_context(doc, mapper_service, type_name, device)
        with self._lock:
            items = list(self._queries.items())
        if filter_ids is not None:
            items = [(qid, v) for qid, v in items if qid in filter_ids]
        matches, host_items = [], items
        if len(items) >= self.DEVICE_BATCH_MIN:
            plans, qids, rest = split_flat(items, ctx)
            # the gate is batch size: only launch when the FLAT count
            # amortizes dispatch (a mostly-non-flat registry stays host)
            if len(plans) >= self.DEVICE_BATCH_MIN:
                found, degraded = _guarded(
                    ctx, ("percolate",), "device_percolate",
                    lambda: device_matches(plans, qids, ctx),
                    domains=(PERCOLATE_DOMAIN,))
                if degraded:
                    _count("device_percolate_fallbacks")
                else:
                    matches, host_items = found, rest
        return sorted(matches + host_matches(host_items, ctx))


class PercolatorService:
    """Node-level: a registry per index, fed by the single-document write
    path and served by the REST `_percolate` APIs on the node's device."""

    def __init__(self, node):
        self.node = node
        self.registries: dict[str, PercolatorRegistry] = {}

    def registry(self, index: str) -> PercolatorRegistry:
        r = self.registries.get(index)
        if r is None:
            r = PercolatorRegistry()
            self.registries[index] = r
        return r

    def register_query(self, index: str, query_id: str, body: dict):
        self.registry(index).register(query_id, body)

    def unregister_query(self, index: str, query_id: str):
        self.registry(index).unregister(query_id)

    def percolate(self, index: str, body: dict | None, doc_type: str = "doc",
                  doc_id=None, version=None, percolate_index=None,
                  percolate_type=None) -> dict:
        """Percolate an inline doc, or an EXISTING doc by id (optionally
        against another index's percolator)."""
        body = body or {}
        if doc_id is not None:
            g = self.node.actions.get_doc(index, doc_type or "_all", str(doc_id))
            if not g.get("found"):
                raise DocumentMissingError(f"[{index}][{doc_type}][{doc_id}] missing")
            if version is not None and int(version) != int(g.get("_version", -1)):
                raise VersionConflictError(f"{doc_type}#{doc_id}",
                                           g.get("_version", -1), int(version))
            doc = g.get("_source") or {}
            target = percolate_index or index
            target_type = percolate_type or doc_type
        else:
            doc = body.get("doc")
            if doc is None:
                raise PercolateError("percolate request requires [doc]")
            target = index
            target_type = doc_type
        svc = self.node.indices.index_service(target)
        matches = self.registry(target).percolate(
            doc, svc.mapper_service, type_name=target_type or "doc",
            device=self.node.device)
        return {
            "total": len(matches),
            "_shards": {"total": 1, "successful": 1, "failed": 0},
            "matches": [{"_index": target, "_id": qid} for qid in matches],
        }

    def count_percolate(self, index: str, body: dict | None, doc_type: str = "doc",
                        doc_id=None) -> dict:
        r = self.percolate(index, body, doc_type=doc_type, doc_id=doc_id)
        return {"total": r["total"], "_shards": r["_shards"]}

    def multi_percolate(self, requests: list[tuple[dict, dict]],
                        default_index=None, default_type=None) -> dict:
        """ndjson multi-percolate: header lines {"percolate": {...}} /
        {"count": {...}} paired with doc bodies; a failed item answers its
        error in place."""
        responses = []
        for header, body in requests:
            (op, params), = header.items() if header else (("percolate", {}),)
            try:
                kwargs = dict(
                    index=params.get("index", default_index),
                    body=body,
                    doc_type=params.get("type", default_type) or "doc",
                    doc_id=params.get("id"),
                    percolate_index=params.get("percolate_index"),
                    percolate_type=params.get("percolate_type"),
                )
                if op == "count":
                    responses.append(self.count_percolate(
                        kwargs["index"], body, doc_type=kwargs["doc_type"],
                        doc_id=kwargs["doc_id"]))
                else:
                    responses.append(self.percolate(**kwargs))
            except Exception as e:  # noqa: BLE001
                if isinstance(e, SearchEngineError):
                    responses.append({"error": e.es1_string(), "status": e.status})
                else:
                    responses.append({"error": str(e)})
        return {"responses": responses}
