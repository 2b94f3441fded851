from .batcher import DeviceBatcher
from .controller import MergedTopDocs, merge_responses, sort_docs
from .execute import (
    ShardContext,
    TopDocs,
    dispatch_shard_batch,
    search_shard,
    search_shard_batch,
)
from .queries import parse_filter, parse_query
from .service import (
    SERVING_COUNTERS,
    ParsedSearchRequest,
    ShardQueryResult,
    execute_query_phase,
    parse_search_body,
)
from .similarity import SimilarityService

__all__ = ["DeviceBatcher", "MergedTopDocs", "ParsedSearchRequest",
           "SERVING_COUNTERS", "ShardContext", "ShardQueryResult",
           "SimilarityService", "TopDocs", "dispatch_shard_batch",
           "execute_query_phase", "merge_responses", "parse_filter", "parse_query",
           "parse_search_body", "search_shard", "search_shard_batch",
           "sort_docs"]
