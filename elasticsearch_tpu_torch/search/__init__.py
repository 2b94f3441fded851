from .execute import (
    ShardContext,
    TopDocs,
    dispatch_shard_batch,
    search_shard,
    search_shard_batch,
)
from .queries import parse_query
from .similarity import SimilarityService

__all__ = ["ShardContext", "SimilarityService", "TopDocs",
           "dispatch_shard_batch", "parse_query", "search_shard",
           "search_shard_batch"]
