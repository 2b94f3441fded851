"""PyTorch/CUDA port of the search engine's device path.

The JAX package (`elasticsearch_tpu`) stays the reference; this package carries
the same query phase onto an NVIDIA Hopper card. It imports `torch` and
`numpy`, never `jax`, and nothing of the JAX package: the host code it needs
(analysis, mapping, segments, similarity, query parsing, planning) lives here
as its own copies, trimmed to what the ported slice reads.

The device path is the shard query phase of a batched bool-of-terms search:
`search.execute.search_shard_batch` plans the batch, packs each segment's
postings into quantized device planes (`ops.device_index`), scores each
bucket of queries with the hand-written CUDA kernel `sparse_score`
(`csrc/sparse_score.cu`, wrapped in `ops.sparse_kernels`), falls back to a
dense torch program for queries over too many postings blocks, pulls the whole
batch to the host once and merges the segments' top-k. Every query that does
not lower to that path runs on the numpy host scorer
(`search.execute.HostScorer`, with `search.filters`). A `node.Node` serves
both over REST, alone or in a cluster of port nodes (zen discovery over the
in-process or the TCP transport).

Entry points run on the card unless the caller passes `device="cpu"`
(`common.cudaenv.default_device`); on the CPU every kernel wrapper runs its
plain torch version.
"""
