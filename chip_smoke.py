#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--docs N] [--vocab V] [--batches B] [--batch Q]
                          [--node-docs N] [--node-requests R] [--report PATH]

Drives the port's main path — the shard query phase of batched BM25
bool-of-terms search, top-100 per query — through its public entry points
(`ShardContext` → `search_shard_batch`) at the data size of a real shard,
then the serving path — concurrent single requests through
`parse_search_body` → `execute_query_phase` → the `DeviceBatcher` — then a
port `Node` serving REST `_bulk` and `_search` over HTTP (with highlighted
traffic and the fetch slice's requests since phase 21), then the dense
request-feature family (filtered, post_filter, min_score, function_score)
at full width, then the percolator, then an index with custom analysis and
the flat mapper's field types, and holds every hand-written kernel of
those paths against its plain torch version on the card. Phases:

  1. card facts (nvidia-smi, torch / CUDA / nvcc versions), build the kernels
     from `elasticsearch_tpu_torch/csrc` (one nvcc per source, all at once);
  2. a zipf(1.35) CSR corpus of 1,000,000 docs over a 200k-term vocabulary
     (about 60 terms a doc, one text field), split into 3 segments of
     600k / 300k / 100k docs, 1% of one segment tombstoned, packed on the card;
     two seeded numeric doc values in each segment's `dv_num`: `pop`
     (integers 1-1000, missing on 1 doc in 7) and `likes` (integers 0-1000,
     on every doc), and a seeded keyword `cat` in `dv_str` (one of 200
     values a doc, zipf(1.3) over them);
  3. the main path: batches of 1024 `bool` queries of 4 `should` BM25 term
     clauses (terms from df ranks 50-5000), top-100; each batch's dispatch
     runs under `torch.cuda.set_sync_debug_mode("error")`;
  4. a non-simple batch: 256 `bool` queries with must + should + must_not
     and minimum_should_match 2, under BM25 and under TF-IDF (coord);
  5. every kernel against its plain version on the same card tensors, at
     every bucket shape phases 3-4 launched: bitwise;
 5b. `sparse_score` against its plain version on synthetic inputs, bitwise:
     every TB rung 8-512 × {simple, bool, bool + coord} × tf plane {u8, i16,
     f32}, with a row of fewer matches than k, a row all sentinel, and k = P
     at TB = 8 — both kernel variants and every tf plane;
  6. end to end against an independent numpy term-at-a-time scorer;
  7. the normal indexing path, small: mapper → analyzer → SegmentBuilder →
     two segments → Searcher → parse_query → search_shard_batch, on the card
     and on the CPU: identical hits;
  8. times: QPS and batch latency of phase 3, each kernel's time (CUDA
     events) beside its plain version's and its bound; the same calls
     replayed from a CUDA graph give their device time without the host's
     launch cost;
  9. serving: 8192 single-request bodies (phase 3's traffic, half size 10 and
     half size 100: k buckets 16 and 128) from 128 concurrent callers through
     a DeviceBatcher at its default settings, the whole run under
     `set_sync_debug_mode("error")`; every response held against
     `search_shard_batch` at the same k (bitwise; the rare dense-path query
     within 2 ulp, tie-tolerant), the batcher's occupancy, flushes and
     double buffering asserted, every kernel shape it launched held bitwise
     against the plain version; requests/s, per-request p50/p99 latency, the
     merge's wait for batches merged while the next batch was already
     launched, and the device's idle share over a profiled window; a spin
     kernel standing in for batch N+1's launches shows that batch N's merge
     does not wait for them while a pull enqueued at merge time does; then a
     2-shard reduce
     (`execute_query_phase` on each shard, `sort_docs`) at phase 7's size,
     on the card and on the CPU: identical merged hits;
 10. the node over HTTP: a port `Node` on the card, every thread pool at
     its default size, serves REST on an ephemeral port; `PUT /corpus` with
     the defaults (5 shards, 1 replica: health yellow on one node) and
     `refresh_interval: -1`; 50,000 docs (200,000 before phase 19 joined
     the run, 150,000 before phase 21 did, 100,000 before phase 25 did)
     (phase 2's generator rendered as tokens `t<rank>`) in `_bulk`
     requests of 1,000 through the host analyzer into each shard's durable
     Engine, then `_refresh`; 512 `_search` requests (2,048 before phase
     19, 1,024 before phase 25) (phase 3's 4-term `bool` of
     `should` terms, size 10, `_source` returned) from 64 client threads in
     a process of their own, each on its own keep-alive connection, the
     whole timed run under `set_sync_debug_mode("error")`. Every response's
     total equals an exact
     numpy count over the corpus, its ids and scores equal each shard's
     `search_shard_batch` reduced by score desc, shard, doc; the kernel
     launched from the node's DeviceBatcher and is bitwise equal to its
     plain version at every shape phase 10 launched. Bulk docs/s,
     requests/s, p50/p99, batcher occupancy and flushes, launches by
     variant, the node process's CPU seconds by thread kind and the
     device's idle share over a profiled window.
 11. mixed traffic on phase 10's node and index: 256 `_search` requests
     (2,048 before phase 12 joined the run, 1,024 before phase 13 did, 512
     before phase 19 did: cuts for the time limit)
     from the same 64 connections in a seeded random order, half phase 3's
     4-term `bool` (the card's sparse path through the node's batcher), half
     the other families a seventh each: on the host scorer `match_phrase` of
     two adjacent tokens of a corpus doc, `bool` of a `must` term with a
     `filter` of 20 `terms` (df ranks 20-400), `constant_score` over a
     4-character `prefix` (`t` and 3 digits, ~111 terms), no query
     (match_all) with a `post_filter` term (df ranks 20-400); on the card's dense
     family (through the same batcher) `filtered`: phase 3's `bool` with such
     a `terms` filter, phase 3's `bool` with a `post_filter` term (df ranks
     20-400), and phase 3's `bool` with `min_score` at half its own top score
     (the port's host search, before the clock). The whole timed run under
     `set_sync_debug_mode("error")`. Every response's total, ids, scores and
     shards equal each shard's host query phase (`execute_query_phase(...,
     use_device=False)`) reduced by score desc, shard, doc: bitwise for the
     host families; for the card's the same order within 2 ulp,
     tie-tolerant (the share that is bitwise is printed by family), and the
     sparse half bitwise against each shard's `search_shard_batch`. The
     totals of the filter families equal exact numpy counts; the serving
     counters show 5 host shard phases a host request, 5 `device_filtered`
     ones a dense-family request and 5 sparse ones a sparse request, and no
     device error; the kernel is bitwise equal to its plain version at every
     shape phase 11 launched. Requests/s of the mix, p50/p99 by family
     beside the run before these three families moved to the card (whose
     `post_filter` family sent the match_all body), the node's CPU seconds
     by thread kind and the
     device's idle share over a profiled window.
 12. the dense request-feature family at full width on phase 2's shard:
     one batch of 256 requests a family — `filtered` (phase 3's `bool` under
     a 20-term `terms` filter), `post_filter` (a term), `min_score` (half the
     query's own top score), function_score rows (`field_value_factor` on
     `pop`, log1p, times a weight filtered on `pop` >= 500, `boost_mode:
     sum`) and function_score script (`_score * log(2 + doc['likes'].value)`)
     — routed by the service (`device_plan`) and dispatched together,
     twice: cold, then with every filter mask resident in a
     DeviceFilterCache. Everything after the set-up under
     `set_sync_debug_mode("error")`. 16 queries a family (32 before phase
     20 joined the run) equal the host
     scorer (2 ulp, tie-tolerant, totals exact; the script at 5 decimals)
     and the same ops on CPU tensors (every query of the batch until phase
     26 joined the run); no query reruns on the
     host; the script on `pop` (missing on 1 doc in 7) flags its query,
     which reruns on the host scorer and raises ScriptError there, as in the
     JAX package. Ms a batch by family (CUDA events and host wall), dense
     launches, device→host copies and the filter cache's hits, builds and
     resident bytes.
 13. field sort and aggregations. The library leg, on phase 2's shard: 8
     requests a family (64 before phase 16 joined the run, 32 before phase
     19 did, 16 before phase 20 did) through
     `parse_search_body` → `execute_query_phase`, each over phase 3's 4-term
     `bool` — `sort_asc` (`pop` asc, missing
     last, top-100), `sort_desc_scores` (`likes` desc, `track_scores`),
     `aggs_metric` (stats of `likes`, avg and value_count of `pop`),
     `aggs_terms` (terms on `cat` with an avg of `pop`), `aggs_hist`
     (histogram of `likes`, range of `pop`), `sort_aggs` and
     `post_filter_aggs` — the timed run under `set_sync_debug_mode("error")`;
     every response equal to the same request on the host path and on CPU
     tensors (hits, sort values and totals exact, scores within 2 ulp,
     aggregations' counts, keys, min and max exact and sums within rel
     1e-5), the serving counters (`device_sort`, `device_aggs`,
     `device_filtered`) a request, one device→host pull a request; ms a
     request by family (CUDA events and host wall), launches and copies a
     request, the resident bytes of the agg rows and bucket columns, and
     the top device ops of one `aggs_terms` request. The node leg, on phase
     10's node before it closes: a `catalog` index (5 shards) of 12,500 of
     phase 10's texts (50,000 before phase 18 joined the run, 25,000
     before phase 25 did) with `pop`,
     `likes` and `cat`, bulked over HTTP, then 128 `_search` requests (256
     before phase 18) from the same 64 connections drawn in a seeded
     order from the library leg's families, a `facets` body and a
     `?sort=pop:desc` URL, under `set_sync_debug_mode("error")`; every
     response equal to the shards' host query phases reduced by `sort_docs`
     and `merge_responses`, totals equal to exact numpy counts, the serving
     counters 5 a request; requests/s and p50/p99 by family; the search
     pool's CPU split by span (`SpanClock`).
 14. the write path. The library leg, on phase 2's corpus without
     tombstones: its three segments packed on the card, their merged
     segment built from the same CSR in one piece (`merged_csr`: not
     `merge_segments`, which walks every posting in Python), packed by
     `pack_segment_concat` (B7 on the card) and by the staged
     `pack_segment`, every field bitwise equal; the concat's host half (of
     it the per-term tables) and device program (CUDA events, and in a CUDA
     graph) against B7's bound, the staged pack's host wall, each one's
     upload bytes; 64 of phase 3's queries, top-100, over the merged pack
     and over the three sources: equal hits (bitwise but where a query
     reaches the dense fallback: 2 ulp, tie-tolerant), `sparse_score`
     launches and ms a batch. The node leg, on phase 10's node before it
     closes: a `writes` index (5 shards, `refresh_interval: -1`) of 10,000
     of phase 10's texts (20,000 before a run on a slow host passed 950
     s); one `_search` opens the warmer's gate; then 4 rounds of a `_bulk`
     of 1,000 new docs, `_refresh`, a wait for the
     warmer, and 64 `_search` requests from 64 connections under
     `set_sync_debug_mode("error")`, every response equal to exact totals
     and the shards' `search_shard_batch`; `PACK_LEDGER` shows >= 20 delta
     packs after the gate, all on the `warmer` or `merge` pool (none on the
     query path); then `POST /writes/_optimize`: one segment a shard, each
     packed by the concat on the `merge` pool, the same hits; requests/s,
     p50 and the drainer's `sparse_score` launches a request before and
     after the optimize.
 15. device faults on the card. (a) On phase 10's node before it closes,
     from 16 connections of this process: the card's answers to 16 of
     phase 3's `bool` bodies (`corpus`) and 8 each of `filtered`,
     function_score rows, a field sort and a terms agg (`catalog`) pinned
     with `_shards.degraded` 0; then each fault domain armed in turn with a
     persistent kind — `pull:*`, `compile:sparse`, `compile:filtered`,
     `compile:function_score`, `compile:sorted`, `compile:aggs`, and
     `pack:writes` before a 1,000-doc `_bulk` and `_refresh` into phase
     14's index: the first request of the family that meets the seam trips
     it; then all the bodies again under `set_sync_debug_mode("error")`:
     every answer 200 at its family's bar (scores within 2 ulp of the
     card's, tie-tolerant; sort order and values exact; aggregations as in
     phase 13; `pack:writes` against the shards' host query phases), every
     shard of a blocked family degraded, the others on the card, the blocked
     family's serving counter unmoved and `sparse_score` launched by the
     admitted half-open probes only; disarmed, the domain closes by probe
     within 15 s and `sparse_score` launches again. Then `oom` twice at
     `pull:splits` (a 1-shard index, so the searches coalesce): the batch
     splits, one search degrades, the circuit stays closed. Time to trip,
     requests/s degraded against the card on the same bodies, time to
     recover. (b) In a child process (this script, `--sticky-child`, 60 s
     limit): a node whose start builds `sparse_score` into a fresh build
     directory (no nvcc after it), 2 shards of 5,000 of phase 10's texts,
     32 `bool` searches pinned on the card, an out-of-range CUDA index and
     a synchronize (a device-side assert, code 710), then the 32 searches
     again: each 200, `_shards.degraded` 2, bitwise equal to the shards'
     host query phases and within 2 ulp of the pinned answers, every
     failure persistent; the child prints one JSON line and leaves with
     `os._exit` (its node flushed its shards before the fault). Then a
     second child (`--restart-child`, 60 s limit) starts a node on the card
     over the same `path.data` and build directory: its start finds every
     kernel built (no nvcc) and passes the start check, the gateway restores
     the index and its shards recover from their stores, and the 32
     searches answer 200, `degraded` 0, with `sparse_score` launched,
     bitwise equal to the answers pinned before the fault. Phases 1-14
     degrade nothing and count no device error.
 16. the percolator on the card. (a) The library leg: a registry of 10,000
     queries made from the seed over phase 10's vocabulary, a quarter each
     `match` of 1-3 terms, `term`, `bool` of a `must` and a `must_not` term
     (phase 3's df ranks) and `match_phrase` of two adjacent tokens of a
     corpus text (host-only), percolates 16 of phase 10's texts (32 before
     phase 19 joined the run): each
     document's matches equal the host loop's (the same registry with its
     batch gate raised), every percolation is one batch on the card
     (`device_percolate`, no fallback, one pull, `sparse_score.smem`
     launched, one one-document pack under `_unattributed`), and the kernel
     is bitwise equal to its plain version at every (Qb, TB, k = 1) shape
     launched; percolations/s on the card and on the host loop, and one
     percolation's wall split into parse, one-document pack (ms, bytes),
     lowering, dispatch (CUDA events on the device), pull and the host-only
     queries. (b) On phase 10's node: an `alerts` index (1 shard, 0
     replicas) with 1,000 of those queries registered by `PUT
     /alerts/.percolator/{id}` from 16 connections, then 128 `_percolate`
     requests from 16 connections (requests/s, p50/p99), 8 `_mpercolate`
     bodies of 8 items (one a missing document: a 404 in place), 16
     existing documents of an `alert_docs` index read by GET and percolated
     against `alerts`, and 16 `_percolate/count` requests, every answer
     equal to the node's host loop; DELETE of 100 queries (the matched ones
     first), after which no answer names them; `compile:percolate` armed:
     every answer 200 from the host loop, no launch, a fallback each; then
     disarmed, the domain closes by probe within 15 s and the card serves
     again. No pack is booked against `alerts`.
 17. restart and serving hygiene. (a) A node (`restart`, 2 shards, 0
     replicas) over 10,000 of phase 10's texts: two `_bulk` rounds each with
     a `_refresh` (the second overwrites 10 documents), a `_flush`, a
     DELETE, a third `_bulk` and a single-document index bringing a new
     field through dynamic mapping, both left in the translog, a
     `_refresh`, then 64 of phase 10's `bool` searches whose hits are
     recorded. The node closes and a new node starts in this process over
     the same data: it reaches green, its mapping holds the dynamic field,
     a GET of a translog-only document and the 64 searches answer bitwise
     as before the close; the recovery's wall clock by step (the start with
     its kernel check, the gateway's metadata, the shards' stores and
     translogs, the first search with its inline packs, `PACK_LEDGER`'s
     packs by kind). (b) Staging, printed by earlier phases: phase 3 the
     scratch pools' allocations and reuses over its batches (a warmed
     repeat batch allocates none), phase 10 the host→device copies per
     `sparse_score` launch in its profiled window (one buffer a launch) and
     the drainer's CPU seconds there. (c) Admission, on the restarted node:
     after at least 10 observed shard phases `?timeout=1ms` answers 429
     with `Retry-After` and the controller counts it; a body with no
     timeout answers 200. (d) The watchdog: `DEVICE_PULL` stalls one pull
     of the index for 2 s; a `batch_stall` event naming it reaches the
     node's journal within the stall threshold plus two watchdog periods,
     and the stalled search answers 200 with its recorded hits; phase 15's
     windows left `device_degraded` and `device_recovered` events in phase
     10's journal. The kernel is bitwise equal to its plain version at
     every shape phase 17 launched.
 18. analysis, similarities and the flat mapper, on a port node of its own
     on the card (5 shards, `refresh_interval: -1`, as phase 10's): a
     site-search index `library` in the shape Elasticsearch's 1.x guide
     documents, 4,000 seeded English-like documents (20,000 before phase
     19 joined the run, 10,000 before phase 27 did, 6,000 until its
     review; 2,000 generated stems
     under the suffixes "", s, es, ed, ing, ation, ness, drawn zipf(1.2);
     Lucene's 33 English stop words at about 40% of the tokens; bodies of
     poisson(60) tokens with a little HTML, titles of 6-12), an `english`
     title with `raw` and `shingles` sub-fields and copies into
     `title_shingles` and `title_raw` (parsing fills no sub-field, as in the
     JAX package), a `body_en` body (html_strip, standard, lowercase, stop,
     50 seeded synonym groups, porter_stem) with a `copy_to` catch-all and a
     token_count sub-field, `ip`, `integer`, a `token_count` `words`,
     `_routing.path` and `_timestamp`, BM25 with k1 1.4 and b 0.6; and
     `library_dfr`, 2,500 of the documents (5,000 before phase 19) in 1
     shard under DFR (g, l, h2).
     `GET /library/_mapping` renders the sub-fields and copy_to; a
     single-document write without routing into a `_routing.required` type
     answers 400, a `_bulk` item without one is indexed (both as the JAX
     node does). 256 `_search` requests (512 until phase 27's review)
     from 32 connections in a seeded
     order, an eighth each of `match` on `body`, `match` on the title's
     shingles, an exact title, `query_string` on the catch-all with the
     english analyzer, a 4-term `bool` across title and body, `multi_match`,
     `ip_range` and a sort on `words` (a sixteenth each, the card's dense
     family), and `match` on `library_dfr`; the run under
     `set_sync_debug_mode("error")`. Every response equals the node's own
     host query phases reduced (the card's families within 2 ulp,
     tie-tolerant, `library_dfr` bitwise, `ip_range` counts exact); the
     DFR requests alone launch nothing and count only `host`. Bulk docs/s
     beside phase 10's, the mapper's parse CPU ms a document, requests/s,
     p50/p99 by family, `sparse_score` launches and ms a launch at each
     shape, the device's idle share over a profiled window; the kernel is
     bitwise equal to its plain version at every shape phase 18 launched.
 19. nested documents, parent/child joins and geo fields, on a port node of
     its own on the card (5 shards, 0 replicas, `refresh_interval: -1`), in
     the shapes of the Elasticsearch 1.x guide's own examples: `blogposts`
     (5,000 posts, 10,000 before phase 27 and 7,000 until its review,
     around 50 seeded city centres with a `location` geo_point and 0-8
     nested `comments` of name, comment, age, stars and date, about
     20,000 Lucene documents, by
     `_bulk` with a refresh half
     way) and `company` (100 branches with a `geo_shape` area, 2,000
     `employee` children under `_parent: {type: branch}`, written one by
     one with `PUT ?parent=`: a `_bulk` sets no parent). 192 `_search`
     requests (384 until phase 27's review) from 32 connections in a
     seeded order, a twelfth each: a flat
     `match` (the card's `sparse_score` over nested packs), `nested` with
     `score_mode: avg`, a `bool` with a nested range filter, `filtered` with
     that filter, `filtered` with `geo_distance` (50 km), size-0
     `geo_distance` ranges with `geohash_grid` precision 3 (the aggregating
     launch), `geo_bounds` with a `nested` `avg` of `comments.stars`, a
     `_geo_distance` sort, a gauss geo decay, `has_child` (`max`),
     `has_parent` and a `geo_shape` filter; the run under
     `set_sync_debug_mode("error")`. Every response equals the node's own
     host query phases reduced (the card's families within 2 ulp,
     tie-tolerant; the host's bitwise; aggregations exact but sums); each
     family alone counts its device program on every shard (the card's) or
     `host` only with no launch (the host's); a DELETE of a post takes its
     comments out of the nested counts; after `_optimize` each shard's
     merged pack equals a fresh `pack_segment` and the nested range matches
     nothing on the card's `filtered` as on the host (a merge drops the
     children's doc values, the JAX package's behaviour). Requests/s, p50
     and p99 by family, `sparse_score` launches and ms a launch at each
     shape, the device's idle share over a profiled window; the kernel is
     bitwise equal to its plain version at every shape phase 19 launched.
 20. the search runtime, on phase 10's node before it closes. (a) 128 of
     phase 10's `bool` bodies as `dfs_query_then_fetch` and as
     `query_then_fetch` from 16 connections, each leg under
     `set_sync_debug_mode("error")`: every DFS page equals the shards' host
     query phases under `aggregate_dfs` of their `collect_dfs` (tie-tolerant
     within 2 ulp), every plain one the shards' own; every DFS plan launched
     outside the drainer (the batcher's `direct` count, nothing coalesced);
     the legs' requests/s and p50/p99, where their CPU goes, and the
     similarity-table flips (none: `corpus` is TF-IDF); then `dfs_bm25`, a
     BM25 index of 5,000 of phase 10's texts, and 64 DFS and plain bodies
     at once, each equal to its reference while the packs' tables flip (at
     least once). (b) 64 size-0 aggregating bodies on `catalog` three
     times: a miss pass; a hit pass with 320 shard hits, no launch, no pull
     and no serving counter moved, equal to the first; a 1,000-document
     `_bulk` and `_refresh`, the warmer's re-prime of every shard (0
     failed, every pack on the warmer pool); a third pass equal to a
     `request_cache: false` pass (sums within rel 1e-5) with the re-primed
     shard hits. (c) a size-100 scroll and a scan walked to their end equal
     to the buffered top 1,000, cleared, then 404; `_count` on three routes
     equal to the size-0 totals and the exact count, with `q=` too; an
     `_msearch` of 8 equal to the 8 searches; `preference=_shards:0,2`
     totalling those shards' counts; 16 `rescore` bodies equal to the
     shards' host query phases, bitwise, on the host path only. The kernel
     bitwise equal to its plain version at every shape phase 20 launched.
 21. fetch, on phase 10's node before it closes. (a) 128 of phase 10's
     `bool` bodies from 16 connections, plain and then with `highlight` (the
     plain highlighter on even requests and `fvh` on odd ones: `corpus`
     holds one text field), `fields: ["body"]`, `version` and a script
     field, each leg under `set_sync_debug_mode("error")`: every
     highlighted page equal to the plain leg's (ids, scores, shards in
     order) and each of its hits equal to the host path's fetch of it on
     its shard; both legs launch `sparse_score`, of the same order; each
     leg's requests/s, p50/p99, the search pool's CPU by span (the query
     phase, the fetch, `build_highlights` and each highlighter apart), CPU
     s by thread kind and the device's idle share over a profiled window of
     64. (b) `fetch_small` (3 shards, BM25, 2,000 of phase 10's texts with a
     title, a keyword tag, a `completion` and a `binary` field): `_suggest`
     with a term, a phrase, a completion and a fuzzy completion suggester
     twice (the second from the request cache, no launch, the same JSON),
     then a write and `_refresh` (the next answer holds the new top
     completion); `_explain` (its value the hit's score within 2 ulp),
     `_termvector` with term statistics, an `_mtermvectors` of 8, `_mlt`,
     an `indices` query, a `template` query and a terms lookup (each equal
     to its plain counterpart), each request's wall and launches printed.
     The kernel bitwise equal to its plain version at every shape phase 21
     launched.
 22. documents under search, on a node of its own (`indices.ttl.interval:
     1s`): `website` (5 shards, `refresh_interval: 1s`; type `blog`, 3,000
     posts (5,000 until phase 27's review) of phase 10's texts with `title`, `body`, one of 50 not-analyzed
     `tags` and `views`, `_timestamp` on; type `draft`, 500) and `sessions`
     (1 shard, `_ttl` default 3s). Timed: 256 requests (512 until phase
     27's review) from 16
     connections, 40% phase 10's `bool` searches, 25% `_update` scripts
     `ctx._source.views += n` on a zipf-hot set of 200 posts with
     `retry_on_conflict: 5`, 10% `_update` with a `doc` that replaces
     `title` and `body`, 10% `_mget` of 10 (half `docs`, half `ids`), 10%
     GET `_source` with `_source_include`, 5% `_create` (half taken: 409);
     then a `_bulk` of 250 `update` items, a delete-by-query of 5 tags
     (about 10% of the posts) while 128 searches run, `DELETE
     _mapping/draft`, and the TTL leg (2,000 sessions, then `_count` polled
     to 0). Checked, after a final `_refresh`: every acknowledged write read
     back (`views` equal to the acknowledged increments, each `doc` merge,
     each created id); 256 searches equal to the shards' host query phases,
     none naming a deleted, dropped or purged document; `_count` per tag
     equal to a count of the expected sources; `sparse_score` bitwise
     against its plain version at every shape the phase launched over the
     tombstoned views; no query-path pack after the gate. Printed:
     requests/s and p50/p99 by family, the mix's CPU by span (the query
     phase, `_update`, the background merges, the warm packs), conflicts and
     retries, an `_update`'s CPU by round trip and script, the delete-by-query's wall
     (resolve, tombstone, refresh, repack), searches/s beside writes and
     alone, the purge's lag from expiry to `_count` 0, the device's idle
     share over a profiled window, and the phase's launches.
 23. index lifecycle, on a node of its own, in the shape of Elasticsearch:
     The Definitive Guide's time-based indexes: a template `logs-*` (1
     shard, 0 replicas, `refresh_interval: -1`, `message`, not-analyzed
     `user_id` and `level`, `date`, the alias `last_7_days`), 7 day indexes
     of 2,000 events created by it, the write alias `logs_current` moved
     each day in one `_aliases` call (each day's last event written
     through it), a search warmer a day (a `bool` of 4 terms of df ranks
     50-500, so each day holds some) and 50
     filtered aliases `user_<n>`. The first `_refresh` runs the warmers
     (their launches counted). 64 `bool` searches through `last_7_days`
     (7 shards, sparse) and through the concrete indexes, 64 `match`
     searches through 8 `user_<n>` aliases (the dense filtered family) and
     the same bodies filtered on the concrete indexes, from 16
     connections: equal pages, and 16 of them held against the shards'
     host query phases (2 ulp, tie-tolerant); a profiled window. Retired:
     settings on the two oldest days (a write block: 403), both closed
     (`logs-*` and `last_7_days` searches, reads and writes answer 403),
     one opened (its `_count` and pages as before the close), both
     deleted; `torch.cuda.memory_allocated()` falls by at least 90% of the
     bytes the port counts resident for each (its packs and filter masks).
     Three cycles of create, fill, search and delete of one more day leave
     the allocated bytes within 5% of a day's resident bytes. `_cache/
     clear` brings the filter masks, the request cache and both breakers to
     0 and the searches answer as before; one call each of `_validate`,
     `_analyze`, `_mapping/field`, `_gateway/snapshot`, HEAD of index,
     type and alias, and GET of settings, aliases, templates and warmers.
     Printed: the wall p50 and max of create, alias swap, settings, close,
     open and delete, searches/s and p50/p99 of each leg, the warmers'
     launches and wall, the bytes each close and delete released, the
     device's idle share, and `sparse_score`'s launches and shapes, each
     held bitwise against its plain version.

 24. observing a search on the card, on phase 10's node before it closes:
     (a) 64 of phase 10's `bool` bodies with `?profile=true` from one
     connection: hits equal to the unprofiled answer, every shard's profile
     `device_sparse` with its segments and its device phase timed by CUDA
     events (a pair a launch); the phases' p50 and the device phase a launch
     against the kernel's own time at the shapes launched. (b) 256 of them
     (512 before phase 25 joined the run) from 64 connections at `search.trace.sample_rate` 0.0, then 1.0:
     requests/s of each and the ratio; one `PendingPull.wait` a batch and no
     `torch.cuda.synchronize` in either leg; every `rest` trace of `/_traces`
     holds rest → coordinator → transport → shard → batcher queue, dispatch
     and merge → device_pull, each device span a pull window its batch
     stamped. (d) `POST /_nodes/_local/profiler/start`, 16 warm-up
     searches, a sentinel kernel, 16 searches, `stop`: the Chrome trace's
     `sparse_score` kernel events after the sentinel equal the launches
     counted over those 16 (a capture on this node loses its first kernel
     records; a second start and a second stop answer 400). (c)
     `/_nodes/stats` twice (monotone counters; an unknown metric 400),
     `/_prometheus/metrics` under the text grammar, `/_insights/queries`
     holding the traffic's shape, and `corpus`'s resident bytes by the
     ledger against `torch.cuda.memory_allocated()` as its packs are dropped
     and packed again by one search (0.9-1.1). The kernel bitwise against
     its plain version at every shape the phase launched.
 25. the admin REST surface, on phase 10's node after phase 24; it ends the
     node. (a) `GET /_cat` and every route it lists, 200 `text/plain`; the
     nine tables built on the renderer read with `?v` (its header names the
     `?help` columns), `?help` and `?h=` of two aliases;
     `_cat/segments/corpus` all packed, the segments' resident bytes (from
     `/_segments`) equal to the ledger's postings and dense-plane tiers of
     `/corpus/_stats`; `_cat/batcher` around 256 of phase 10's `bool` bodies
     from 16 connections: `coalesced` up by the shard requests, `launches`
     up by the batches, `sparse_score` (smem plus global) up by at least
     the batches; `_cat/health` `device_ok`, then
     `device_degraded:pull:corpus` while that domain is open, then
     `device_ok` once a probe closes it; `_cat/caches` request hits up on a
     repeated size-0 body. (b) a transient
     `index.search.slowlog.threshold.query.warn` of `0ms` by `PUT
     /_cluster/settings`: the next search logs a slowlog line a shard; `1h`:
     none; `_cluster/stats` `docs.count` equal to the sum of `_count` over
     the node's indexes; `_cluster/state/metadata,routing_table/corpus` of
     `corpus` alone; `_cluster/pending_tasks` empty; a reroute with no
     commands acknowledged, the routing unchanged. (c) 64 of the bodies as
     SMILE and as CBOR bodies, and as JSON with `?format=smile`, `cbor` and
     `yaml` (where PyYAML imports; else `?format=yaml` must answer 500
     `serialization_exception` and a YAML body 400 `parse_exception`):
     every decoded answer's ids and scores bitwise the JSON answer's. (d) in
     a child (this script, `--locktrace-child`, 45 s limit) the port's lock
     tracer installed before anything of the port is imported, then a node
     on the card, 5,000 of phase 10's texts into 2 shards and 256 searches
     from 16 connections with a write, a `_refresh` and an `_optimize` among
     them: no lock-order cycle, `held_device_gets` 0 (no wait on the card
     under a held port lock), no `lock_stall` journalled; the locks,
     acquisitions and order edges printed. (e) `POST
     /_cluster/nodes/_local/_shutdown` answers the node's id; within 5 s the
     HTTP port refuses and the batcher's drainer has exited;
     `torch.cuda.memory_allocated()` before and after beside the ledger's
     resident bytes just before. The kernel bitwise against its plain
     version at every shape the phase and its child launched.
 26. two nodes over TCP in this process beside a one-node reference in a
     child process: 20,000 of phase 10's texts in 5 shards at 0 replicas,
     256 `bool` bodies half to each node bitwise the reference's, per node
     launches == batches == pulls; the second node closes and the first
     answers over the shards it holds.
 27. a replicated cluster: two nodes over TCP in this process; `replicas`
     (20,000 of phase 10's texts) and `replicas_live` (2,000 more), 5
     shards each at 0 replicas, flushed; a kept leg of 256 `bool` bodies
     over the primaries; then `number_of_replicas: 1` on both while a
     writer indexes new ids into `replicas_live` through the first node's
     HTTP, until green: each replica's recovery (files, bytes, reused,
     throttle), every acknowledged write on both copies at the same
     version, the `replicas` replicas' packs equal to the primaries' plane
     for plane, the 256 bodies half `_only_node` on each node bitwise the
     kept leg, `replicas_live` bodies on both nodes with bitwise scores
     and tie-tolerant hits, per node launches == batches == pulls and no
     synchronize; the second node is lost under a burst on the first,
     its query phases disconnected so that shards fail over (counted),
     then it closes: every `_shards.failed` 0, the promoted primaries
     answer bitwise,
     `memory_allocated()` falls by the departed node's resident bytes
     (0.99-1.01). The kernel bitwise at every shape either node launched.
 28. a slow copy and a snapshot: two nodes over TCP in this process
     (`search.hedge.burst: 24`); `adaptive` (10,000 of phase 10's texts,
     5 shards) flushed at 0 replicas, then raised to 1 (the replicas
     recover the flushed commit); each copy warmed until the coordinator's
     selector has `min_samples` on every copy and the EWMAs within 3x; 128
     `_primary` reference answers. From 16 connections: (a) 256 healthy
     bodies, bitwise the reference, each node's copies taking >= 0.3 of the
     query phases; (b) the second node's received query phases delayed
     0.75 s (a seeded FaultPolicy): first the JAX chaos test's shape (one
     group, one connection, 40 requests), p95 under 0.7 s with hedges won;
     then 256 bodies, its share <= 0.35, hedges issued and won within the
     budget, p50 under the delay, bitwise the reference, a profiled subset
     with a `winner: "hedge"` shard; (c) the fault cleared: within 15
     chunks of 16 the second node's copies take 5 selections a group in
     one chunk, with probes; (d) 32 `size: 0` bodies 4 times: every
     selection by affinity or a probe turn, each affinity pick the
     rendezvous winner of its spread set, every revisit of a copy a
     request-cache hit and no launch in a pass of revisits; (e) an fs
     repository, snapshot `s1`, `DELETE /adaptive` (`memory_allocated()`
     falls by the index's resident bytes, 0.99-1.01), restore and green:
     the primaries' packs equal the deleted ones, the allocated bytes
     return by the restored index's resident bytes (0.99-1.01), 128
     `_primary` bodies bitwise the reference, each node's `_count` the
     kept behaviour's (the replicas stay empty), a second snapshot reusing
     every segment blob. Per node launches + batches that found no block
     == batches == pulls and no synchronize throughout, no context left
     pinned, the kernel bitwise at every shape either node launched.

Every phase asserts. The line before the last holds the kernels' JSON record;
the last line is `{"ok": true, "device": {...}}`, printed only when every
phase passed. Without CUDA the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import fnmatch
import gc
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

AVG_LEN = 60  # mean terms per doc (poisson), clipped to [5, 400]
ZIPF_A = 1.35
SEGMENT_SHARES = (0.6, 0.3, 0.1)
TOMBSTONE_SEGMENT, TOMBSTONE_SHARE = 1, 0.01
TERMS_PER_QUERY = 4
RANKS = (50, 5000)  # df ranks the main-path query terms are drawn from
BOOL_RANKS = (20, 400)  # denser terms for the must/should/must_not batch
K = 100
K1, B = 1.2, 0.75

SERVE_REQUESTS, SERVE_CALLERS = 8192, 128  # phase 9's traffic
# phase 10's load and traffic (200,000 docs and 2,048 requests before phase
# 19 joined the run, 150,000 docs before phase 21 did, 100,000 docs and
# 1,024 requests before phase 25 did: cut for the run's time)
NODE_DOCS, NODE_REQUESTS, NODE_CALLERS = 50_000, 512, 64
NODE_BULK, NODE_SIZE, NODE_SHARDS = 1000, 10, 5  # docs a _bulk, hits a request, shards
NODE_PROFILED = 256  # requests in phase 10's profiled window (512 before phase 19)
# a search response's `_shards` on phase 10's node: every shard answered from
# the card, none degraded to the host path
SHARDS_OK = {"total": NODE_SHARDS, "successful": NODE_SHARDS, "degraded": 0, "failed": 0}
# phase 11's traffic, half phase 3's bool, half the other families: 256
# requests (2048 before phase 12 joined the run, 1024 before phase 13 did,
# 512 before phase 19 did) and a profiled window of 128 (256 before)
MIXED_REQUESTS, MIXED_PROFILED = 256, 128
MIXED_HOST = ("phrase", "bool_filter", "filtered", "prefix", "post_filter",
              "post_filter_all", "min_score")
MIXED_DENSE = ("filtered", "post_filter", "min_score")  # on the card's dense family
# phase 11 before `filtered`, `post_filter` and `min_score` moved to the card
# (2,048 requests; PERF.md, NVIDIA H100 80GB HBM3, 700.00 W): requests/s, and
# p50 / p99 ms by family, printed beside this run's. Its `post_filter`
# family sent the body that `post_filter_all` sends now (no query); nothing
# then sent phase 3's `bool` with a post filter.
HOST_FAMILIES_PHASE11 = {"requests_per_s": 12.6, "latency_ms": {
    "device": (4860.25, 9178.82), "phrase": (5121.28, 9039.02),
    "bool_filter": (4826.84, 7123.51), "filtered": (5038.40, 7792.09),
    "prefix": (4826.27, 7067.53), "post_filter": None,
    "post_filter_all": (4704.79, 6949.36), "min_score": (4849.22, 7432.51)}}
POP_MISSING = 7  # phase 2's `pop` column: 1 doc in 7 has no value
POP_RANGE, LIKES_RANGE = (1, 1000), (0, 1000)  # integer doc values, inclusive
# phase 12: queries a family batch, and of them host-checked (32 before
# phase 20 joined the run: cut for the command's time)
DENSE_BATCH, DENSE_CHECK = 256, 16
DENSE_FAMILIES = ("filtered", "post_filter", "min_score", "fs_rows", "fs_script")
FS_SCRIPT = "_score * log(2 + doc['likes'].value)"  # phase 12's script family
CAT_VALUES, CAT_ZIPF = 200, 1.3  # phase 2's keyword `cat`: zipf over 200 values
# phase 13's library leg: requests a family (64 before phase 16 joined the
# run, 32 before phase 19 did, 16 before phase 20 did: each is checked
# against the host path and CPU tensors at 1M docs, about 89 s for 32, cut
# for the run's time)
SORT_AGG_REQUESTS = 8
SORT_AGG_FAMILIES = ("sort_asc", "sort_desc_scores", "aggs_metric", "aggs_terms",
                     "aggs_hist", "sort_aggs", "post_filter_aggs")
SORT_AGG_COUNTER = {"sort_asc": "device_sort", "sort_desc_scores": "device_sort",
                    "aggs_metric": "device_aggs", "aggs_terms": "device_aggs",
                    "aggs_hist": "device_aggs", "sort_aggs": "device_sort",
                    "post_filter_aggs": "device_filtered", "facets": "host",
                    "sort_url": "device_sort"}
# phase 13's node leg: the `catalog` index (5 shards) and its traffic, the
# library leg's families plus a `facets` body and a `?sort=pop:desc` URL
# (50,000 docs and 256 requests before phase 18 joined the run, 25,000 docs
# before phase 25 did: cut for the run's time)
CATALOG_DOCS, CATALOG_REQUESTS = 12_500, 128
AGG_RTOL = 1e-5  # a sum or average from the card (tests/test_device_aggs.py)
# phase 14's node leg: the `writes` index (5 shards), its rounds of a _bulk
# of NODE_BULK docs, _refresh and WRITE_REQUESTS _search requests
WRITE_DOCS, WRITE_ROUNDS, WRITE_REQUESTS = 10_000, 4, 64
FILTER_TERMS = 20  # terms of phase 11's `terms` filters, df ranks BOOL_RANKS
SERVE_SIZES = (10, 100)  # phase 9: half the requests each, k buckets 16 and 128
SERVE_PROFILED = 1024  # requests in phase 9's profiled window
SPIN_CYCLES = 40_000_000  # phase 9's stand-in for batch N+1: ~20 ms at ~2 GHz
TB_MAX = 512  # ops/scoring.py launch_flat_sparse: past it a query takes the dense path
# phase 15 (a): connections, bodies (phase 3's bool; each dense family), and
# the domains armed in turn: (domain, kind, the families whose launch meets
# its seam, the families its open circuit sends to the host path)
FAULT_CONNECTIONS, FAULT_BOOL, FAULT_FAMILY = 16, 16, 8
# the card's and the first (pull:*) domain's degraded window send the bodies
# this many times: the two request rates compared over 240 requests each
FAULT_RATE_REPS = 5
FAULT_DOMAINS = (
    ("pull:*", "transfer", {"bool", "filtered"},
     {"bool", "filtered", "function_score", "sort", "aggs"}),
    ("compile:sparse", "launch", {"bool"}, {"bool"}),
    ("compile:filtered", "launch", {"filtered"}, {"filtered"}),
    ("compile:function_score", "launch", {"function_score"}, {"function_score"}),
    ("compile:sorted", "launch", {"sort"}, {"sort"}),
    ("compile:aggs", "launch", {"aggs"}, {"aggs"}),
    ("pack:writes", "launch", {"writes"}, {"writes"}))
FAULT_COUNTER = {"bool": "device_sparse", "writes": "device_sparse",
                 "filtered": "device_filtered",
                 "function_score": "device_function_score",
                 "sort": "device_sort", "aggs": "device_aggs"}
SPLIT_DOCS = 2000  # phase 15 (a)'s 1-shard `splits` index for the oom step
RECOVER_S = 15.0  # a disarmed domain closes within this
# phase 15 (a)'s defect: dynamic shared memory past the card's 227 KB a block,
# which the CUDA runtime refuses before the launch (a code no search degrades on)
DEFECT_SHARED_BYTES = 1 << 20
# phase 15 (b): the child's node and searches, and its time limit (the
# restart child's too)
STICKY_DOCS, STICKY_SHARDS, STICKY_SEARCHES, STICKY_TIMEOUT_S = 5000, 2, 32, 60
# phase 17: the restarted index's texts (10,000, cut from 20,000 for the
# run's time) and recorded searches, the pull's stall, and the restarted
# node's watchdog period
RESTART_DOCS, RESTART_SEARCHES, RESTART_STALL_S = 10_000, 64, 2.0
RESTART_SETTINGS = {"watchdog.interval": "250ms"}
ULPS = 2  # the dense path sums in clause order, a reference in its own (tests/test_torch_dense.py)
# phase 16: the library leg's registry and documents (16, cut from 64 and
# then 32 for the run's time); the node leg's registered queries (1,000, cut from
# PERC_QUERIES), _percolate requests (128, cut from 256) and connections,
# _mpercolate bodies (8, cut from 16) and their items, existing documents
# (and _percolate/count requests), and the queries deleted
PERC_QUERIES, PERC_DOCS = 10_000, 16
PERC_NODE_QUERIES, PERC_REQUESTS, PERC_CONNECTIONS = 1000, 128, 16
PERC_MULTI, PERC_MULTI_ITEMS, PERC_EXISTING, PERC_DELETES = 8, 8, 16, 100
# phase 18: the `library` index (3,000 docs, cut from a real deployment's
# millions for the run's time; 20,000 before phase 19 joined the run,
# 10,000 before phase 27 did, 6,000 until a 1146 s run on a slow host,
# 4,000 before phase 28 joined the run), `library_dfr` (2,000 of them;
# 5,000, then 2,500 before), the traffic (192 requests, 512 until that
# run, 256 before phase 28) and its connections; the text: stems, their
# zipf exponent, the stop words' share of tokens, mean tokens a body,
# synonym groups, tenants
ANALYSIS_DOCS, ANALYSIS_DFR_DOCS = 3_000, 2_000
ANALYSIS_REQUESTS, ANALYSIS_CALLERS = 192, 32
ANALYSIS_PROFILED = 128  # `library` requests in phase 18's profiled window
ANALYSIS_STEMS, ANALYSIS_ZIPF, ANALYSIS_STOP_SHARE = 2000, 1.2, 0.4
ANALYSIS_BODY, ANALYSIS_SYNONYMS, ANALYSIS_TENANTS = 60, 50, 16
# phase 19: `blogposts` (3,500 posts, cut from a real blog's hundreds of
# thousands for the run's time, 10,000 before phase 27 joined the run,
# 7,000 until a 1146 s run on a slow host, 5,000 before phase 28 joined
# it; about 14,000 Lucene documents
# with their nested comments) around GEO_CITIES seeded city centres, `company` (100
# branches, 2,000 employees, written one by one: a _bulk sets no parent),
# the traffic (128 requests, 384 until that run, 192 before phase 28), its
# connections and the profiled window
GEO_POSTS, GEO_BRANCHES, GEO_EMPLOYEES, GEO_CITIES = 3_500, 100, 2_000, 50
GEO_REQUESTS, GEO_CALLERS, GEO_PROFILED = 128, 32, 48
# phase 20 on phase 10's node: (a) phase 10's `bool` bodies sent as DFS and
# as plain, a BM25 index of phase 10's texts for the similarity-table flips
# and its mixed DFS + plain burst; (b) the request cache's size-0 bodies on
# `catalog` and the documents bulked between its passes; (c) rescore bodies;
# the connections of every leg
RUNTIME_DFS, RUNTIME_BM25_DOCS, RUNTIME_MIXED = 128, 5_000, 64
RUNTIME_CACHE, RUNTIME_CACHE_BULK, RUNTIME_RESCORE = 64, 1000, 16
RUNTIME_CONN = 16
# phase 21 on phase 10's node: (a) phase 10's `bool` bodies sent plain and
# highlighted, their connections and profiled window; (b) the small index's
# documents and shards
FETCH_REQUESTS, FETCH_CONN, FETCH_PROFILED = 128, 16, 64
FETCH_SMALL_DOCS, FETCH_SHARDS = 2000, 3
# phase 24 on phase 10's node: profiled bodies, the traffic of each traced
# leg (512 before phase 25 joined the run: cut for the run's time) and its
# connections, and the searches in the device profiler's window
OBS_PROFILED, OBS_TRACED, OBS_CONN, OBS_WINDOW = 64, 256, 64, 16
# phase 25 on phase 10's node: the `_cat` routes built on the table renderer,
# the burst read through `_cat/batcher` and its connections, the bodies sent
# in each content format, and the seconds a shutdown may take
ADMIN_CAT_TABLES = ("shards", "allocation", "count", "aliases", "thread_pool",
                    "batcher", "caches", "segments", "events")
ADMIN_BURST, ADMIN_CONN, ADMIN_FORMATS, ADMIN_SHUTDOWN_S = 256, 16, 64, 5.0
# phase 25 (d)'s child: documents, shards and searches, its time limit, and
# the held-wait threshold of the lock tracer's long-held list
LOCKTRACE_DOCS, LOCKTRACE_SHARDS, LOCKTRACE_SEARCHES = 5_000, 2, 256
LOCKTRACE_TIMEOUT_S, LOCKTRACE_HELD_MS = 45, 50.0
# phase 22 on a node of its own: `website` posts (2,000, cut from a site's
# hundreds of thousands: from 20,000 after a 190 s phase on the card,
# from 10,000 after a 136 s phase on a slow host, where the background
# merges' Python walk took 36 CPU s of the mix, from 5,000 after a
# 100 s phase in a 1146 s run, and from 3,000 when phase 28 joined the
# run) and drafts, `sessions`;
# the timed traffic (192 requests, cut from 2,048 after the first run,
# from 1,024 after a 160 s phase at 10,000 posts, from 512 and from 256
# with the posts) and its connections, its mix by family, the hot posts and their
# zipf exponent, the tags and the tags deleted by query; the bulk of
# updates (200, cut from 1,000, 500 and 250 with it), the searches beside the delete-by-query,
# the checked searches, the update CPU leg, the no-write search leg and the
# profiled window (64 each, cut from 256 with it)
DOC_POSTS, DOC_DRAFTS, DOC_SESSIONS = 2_000, 500, 2_000
DOC_REQUESTS, DOC_CONN = 192, 16
DOC_MIX = (("search", 0.40), ("increment", 0.25), ("doc", 0.10), ("mget", 0.10),
           ("source", 0.10), ("create", 0.05))
DOC_HOT, DOC_HOT_ZIPF, DOC_TAGS, DOC_DBQ_TAGS = 200, 1.1, 50, 5
DOC_BULK_UPDATES, DOC_DBQ_SEARCHES, DOC_CHECKS = 200, 128, 256
DOC_UPDATE_CPU, DOC_SEARCH_ONLY, DOC_PROFILED = 64, 64, 64
DOC_TTL_S = 3.0  # `sessions`' default TTL; the purger runs every second
# phase 23 on a node of its own: time-based `logs-*` indexes, a day each
# (1,500 events a day, cut from a deployment's millions for the phase's
# 60 s, 2,000 before phase 28 joined the run; 7 days and 3
# create-fill-search-delete cycles of one more), the
# users their `user_id` is drawn from (zipf over 50) and the users given a
# filtered alias searched, the searches of each leg and their connections,
# the checked searches (half through `last_7_days`, half through the user
# aliases) and the profiled window of each kind (legs of 48, 16 checks and
# windows of 32, cut from 128, 64 and 64 after a 93.9 s phase on the card,
# 57.9 s of it the searches and their host checks, and the legs from 64
# when phase 28 joined the run)
LIFE_DAYS, LIFE_DAY_DOCS, LIFE_CYCLES = 7, 1_500, 3
LIFE_USERS, LIFE_USER_ZIPF, LIFE_ALIAS_USERS = 50, 1.2, 8
LIFE_REQUESTS, LIFE_CONN, LIFE_CHECKS, LIFE_PROFILED = 48, 16, 16, 32
LIFE_LEVELS = (("info", 0.8), ("warn", 0.15), ("error", 0.05))
# a closed or deleted day's device bytes (its packs and filter masks) that
# memory_allocated() must give back, and the growth over the cycles it may
# show, as shares of one day's resident bytes
LIFE_RELEASED_SHARE, LIFE_GROWTH_SHARE = 0.9, 0.05
# phase 26: two nodes over TCP beside a one-node reference: the documents
# (20,000 of phase 10's texts in 5 shards at 0 replicas), the searches of
# the timed run and their connections, and the searches after the leave
TWO_DOCS, TWO_REQUESTS, TWO_CONN, TWO_AFTER = 20_000, 256, 16, 64
# its warm-up searches a node, and the seconds its reference child may take
# to serve (its start, the bulk, the warm-up)
TWO_WARM, TWO_REF_TIMEOUT_S = 8, 120
# phase 27: a replicated cluster of two nodes over TCP: `replicas` (20,000
# of phase 10's texts, as phase 26's corpus) and `replicas_live` (2,000 more,
# and the writer's), 5 shards each, raised from 0 to 1 replica; the bodies
# of the kept and `_only_node` legs, the `replicas_live` bodies sent to
# both nodes, the connections, and the burst run across the node's loss
REP_DOCS, REP_LIVE_DOCS = 20_000, 2_000
REP_REQUESTS, REP_AFTER, REP_CONN, REP_LOSS = 256, 32, 16, 64
# phase 28: a slow copy and a snapshot on two nodes over TCP: `adaptive`
# (10,000 of phase 10's texts, 5 shards, 1 replica), the reference bodies
# and the bodies of each timed leg, the connections, the delay injected on
# the second node's received query phases (the JAX chaos test's) and the
# hedge burst (its setting); the recovery's chunks and their requests, the
# affinity leg's bodies and passes, the profiled subset, and the most
# warm-up chunks before the EWMAs must have converged
ADAPT_DOCS, ADAPT_REFS, ADAPT_LEG, ADAPT_CONN = 10_000, 128, 256, 16
ADAPT_DELAY_S, ADAPT_BURST = 0.75, 24
ADAPT_CHUNKS, ADAPT_CHUNK, ADAPT_AFFINITY, ADAPT_PASSES = 15, 16, 32, 4
ADAPT_PROFILED, ADAPT_WARM_CHUNKS = 16, 40
# ... the bodies of leg (b)'s round-robin run under the same fault
ADAPT_RR = 64
# ... and the JAX chaos test's own shape inside leg (b): one shard group,
# one connection, its healthy baseline and its timed requests
ADAPT_ONE_HEALTHY, ADAPT_ONE_SLOW = 10, 40

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # H100 SXM, non-tensor float32

BM25_SETTINGS = {"index.similarity.default.type": "BM25"}
TFIDF_SETTINGS = {}  # the index default, classic TF-IDF with coord
RTOL = 1e-6  # port (float32, tree-ordered sums) vs the term-at-a-time scorer

KERNELS = {
    "sparse_score": {
        "route": "cuda",
        "source": "elasticsearch_tpu_torch/csrc/sparse_score.cu",
        "replaces": "elasticsearch_tpu/ops/pallas_kernels.py:162",
    },
}


_T0 = time.monotonic()


def log(*parts) -> None:
    """A line of the run's log, after the seconds since the script started
    (where a run's time goes, phase by phase)."""
    print(f"{time.monotonic() - _T0:7.1f}s", *parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# corpus (modelled on bench.py build_corpus / gen_queries)
# ---------------------------------------------------------------------------


def build_corpus(n_docs: int, vocab: int, seed: int):
    """CSR postings of a zipf corpus: (terms, docs, freqs) sorted by (term,
    doc), and the per-doc field lengths."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.poisson(AVG_LEN, n_docs), 5, 400).astype(np.int64)
    term_of_tok = (rng.zipf(ZIPF_A, int(lengths.sum())).astype(np.int64) - 1) % vocab
    doc_of_tok = np.repeat(np.arange(n_docs, dtype=np.int64), lengths)
    # key order is (term, doc) order, so np.unique leaves the CSR sorted
    keys, counts = np.unique(term_of_tok * n_docs + doc_of_tok, return_counts=True)
    del term_of_tok, doc_of_tok
    terms = keys // n_docs
    docs = (keys % n_docs).astype(np.int32)
    return terms, docs, counts.astype(np.float32), lengths


def split_segments(terms, docs, freqs, lengths, vocab: int):
    """Per segment: (lo, hi, CSR arrays over the whole vocabulary) for doc
    ranges of SEGMENT_SHARES."""
    n = len(lengths)
    cuts = np.concatenate([[0], np.cumsum(np.round(np.asarray(SEGMENT_SHARES) * n))
                           .astype(np.int64)])
    cuts[-1] = n
    out = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        sel = (docs >= lo) & (docs < hi)
        t = terms[sel]
        offsets = np.zeros(vocab + 1, np.int64)
        np.cumsum(np.bincount(t, minlength=vocab), out=offsets[1:])
        out.append(dict(lo=int(lo), hi=int(hi), offsets=offsets,
                        docs=(docs[sel] - lo).astype(np.int32), freqs=freqs[sel],
                        lengths=lengths[lo:hi]))
    return out


def term_name(t: int) -> str:
    return f"t{t}"


SHARD_MAPPING = {"properties": {"body": {"type": "string"}, "pop": {"type": "long"},
                                "likes": {"type": "long"},
                                "cat": {"type": "string", "index": "not_analyzed"}}}


def doc_value_columns(n_docs: int, seed: int) -> dict:
    """Phase 2's numeric doc values, one per doc (NaN = none): `pop`,
    integers in POP_RANGE with 1 doc in POP_MISSING without one, and
    `likes`, integers in LIKES_RANGE on every doc."""
    rng = np.random.default_rng(seed)
    pop = rng.integers(POP_RANGE[0], POP_RANGE[1] + 1, n_docs).astype(np.float64)
    pop[rng.random(n_docs) < 1.0 / POP_MISSING] = np.nan
    likes = rng.integers(LIKES_RANGE[0], LIKES_RANGE[1] + 1, n_docs).astype(np.float64)
    return {"pop": pop, "likes": likes}


def cat_column(n_docs: int, seed: int) -> np.ndarray:
    """Phase 2's keyword `cat`, one value a doc: the rank of one of
    CAT_VALUES values, zipf(CAT_ZIPF) over them."""
    rng = np.random.default_rng(seed)
    return ((rng.zipf(CAT_ZIPF, n_docs) - 1) % CAT_VALUES).astype(np.int32)


def cat_name(c: int) -> str:
    return f"c{c:03d}"  # zero-padded: the names sort as the ranks do


def dv_str_slice(cats: np.ndarray, lo: int, hi: int):
    """A segment's `dv_str` entry (sorted values, offsets, ordinals) for docs
    lo..hi of the one-value `cat` column."""
    uniq, inv = np.unique(cats[lo:hi], return_inverse=True)
    return ([cat_name(int(c)) for c in uniq], np.arange(hi - lo + 1, dtype=np.int64),
            inv.astype(np.int32))


def dv_slice(col: np.ndarray, lo: int, hi: int):
    """A segment's `dv_num` entry (offsets, values) for docs lo..hi of a
    one-value-or-none column."""
    part = col[lo:hi]
    has = np.isfinite(part)
    offsets = np.zeros(len(part) + 1, np.int64)
    np.cumsum(has, out=offsets[1:])
    return offsets, part[has]


# ---------------------------------------------------------------------------
# independent reference scorer (numpy, term at a time, float32)
# ---------------------------------------------------------------------------


def _decode_byte315(b: np.ndarray) -> np.ndarray:
    bits = (b.astype(np.int32) << 21) + ((63 - 15) << 24)
    return np.where(b == 0, np.float32(0.0), bits.view(np.float32))


class Reference:
    """Lucene 4 BM25 / classic TF-IDF bool scoring over the segments' CSR
    arrays, one dense score array per segment, skipping tombstones."""

    def __init__(self, segs: list[dict], norm_bytes: list[np.ndarray],
                 lives: list[np.ndarray]):
        self.segs, self.norm_bytes, self.lives = segs, norm_bytes, lives
        self.max_doc = sum(s["hi"] - s["lo"] for s in segs)
        self.df = sum(np.diff(s["offsets"]) for s in segs)
        self.avgdl = np.float32(sum(int(s["lengths"].sum()) for s in segs)
                                / self.max_doc)

    def search(self, clauses, msm: int, sim: str, k: int):
        """clauses: [(term id, group)] with group in should/must/must_not.
        Returns (total, scores of every doc (-inf where no match), matched)."""
        N = self.max_doc
        scoring = [(t, g) for (t, g) in clauses if g != "must_not"]
        n_must = sum(1 for _t, g in clauses if g == "must")
        if sim == "bm25":
            idf = {t: np.float32(np.log(1.0 + (N - self.df[t] + 0.5)
                                        / (self.df[t] + 0.5))) for t, _g in clauses}
            weight = {t: np.float32(idf[t] * np.float32(K1 + 1.0)) for t in idf}
        else:
            idf = {t: np.float32(1.0 + np.log(N / (self.df[t] + 1.0)))
                   for t, _g in clauses}
            qn = np.float32(1.0 / np.sqrt(sum(float(idf[t]) ** 2
                                              for t, _g in scoring)))
            weight = {t: np.float32(idf[t] * idf[t] * qn) for t in idf}
        all_scores, all_match = [], []
        for seg, nb, live in zip(self.segs, self.norm_bytes, self.lives):
            n = seg["hi"] - seg["lo"]
            f_norm = _decode_byte315(nb)
            if sim == "bm25":
                with np.errstate(divide="ignore"):
                    dl = np.where(f_norm > 0, 1.0 / (f_norm * f_norm), 0.0)
                denom = (K1 * (1.0 - B + B * dl / self.avgdl)).astype(np.float32)
            score = np.zeros(n, np.float32)
            n_should = np.zeros(n, np.int32)
            n_must_hit = np.zeros(n, np.int32)
            n_not = np.zeros(n, np.int32)
            for t, g in clauses:
                s, e = seg["offsets"][t], seg["offsets"][t + 1]
                d, f = seg["docs"][s:e], seg["freqs"][s:e]
                if g == "must_not":
                    n_not[d] += 1
                    continue
                (n_must_hit if g == "must" else n_should)[d] += 1
                if sim == "bm25":
                    score[d] += weight[t] * (f / (f + denom[d]))
                else:
                    score[d] += weight[t] * (np.sqrt(f) * f_norm[d])
            overlap = n_should + n_must_hit
            match = (live & (n_must_hit == n_must) & (n_should >= msm)
                     & (n_not == 0) & (overlap > 0))
            if sim == "tfidf" and len(scoring) > 1:
                score = score * (overlap.astype(np.float32) / np.float32(len(scoring)))
            all_scores.append(np.where(match, score, -np.inf))
            all_match.append(match)
        match = np.concatenate(all_match)
        return int(match.sum()), np.concatenate(all_scores), match


def check_hits(name: str, top, ref_total: int, ref_scores: np.ndarray, k: int):
    """The port's TopDocs against the reference: same total; min(k, total)
    hits, each a matching doc with its reference score within RTOL; no
    non-hit scoring above the k-th hit; order by score, where only near-equal
    scores may swap."""
    assert top.total == ref_total, f"{name}: total {top.total} != {ref_total}"
    assert len(top.hits) == min(k, ref_total), f"{name}: {len(top.hits)} hits"
    if not top.hits:
        return
    scores = np.array([s for s, _d in top.hits], np.float64)
    docs = np.array([d for _s, d in top.hits], np.int64)
    ref = ref_scores[docs].astype(np.float64)
    assert np.all(np.isfinite(ref)), f"{name}: a hit the reference does not match"
    tol = RTOL * np.abs(ref)
    assert np.all(np.abs(scores - ref) <= tol), (
        f"{name}: max rel err {np.max(np.abs(scores - ref) / np.abs(ref))}")
    assert np.all(np.diff(ref) <= tol[1:] + tol[:-1]), f"{name}: order"
    if len(docs) == k:
        rest = ref_scores.astype(np.float64).copy()
        rest[docs] = -np.inf
        assert rest.max() <= ref[-1] * (1 + 2 * RTOL), f"{name}: missed a doc"


# ---------------------------------------------------------------------------
# kernel records: every launch's inputs, timing, bounds
# ---------------------------------------------------------------------------


class LaunchRecorder:
    """Wraps the scoring module's `sparse_score`, until `close()`, to keep
    the inputs of the first launch of every bucket shape and of every launch
    of one chosen batch. It launches nothing itself and counts nothing.
    With `copy_inputs` it keeps copies of the first launch's tensors (their
    bytes in `held_bytes`), so it holds no pack of an index that closes."""

    def __init__(self, scoring_module, sparse_score, copy_inputs: bool = False):
        self.shapes: dict = {}  # shape key -> (args, kwargs, launches)
        self.batch: list | None = None
        self.held_bytes = 0
        self._orig = sparse_score
        self._module = scoring_module

        def keep(a):
            if copy_inputs and hasattr(a, "clone"):
                self.held_bytes += a.numel() * a.element_size()
                return a.clone()
            return a

        def recording(*args, **kwargs):
            key = (tuple(args[0].shape), str(args[10].dtype), kwargs["k"],
                   kwargs["passes"], kwargs["simple"], kwargs["use_coord"])
            entry = self.shapes.get(key)
            if entry is None:
                entry = self.shapes[key] = [tuple(keep(a) for a in args), kwargs, 0]
            entry[2] += 1
            if self.batch is not None:
                self.batch.append((args, kwargs))
            return self._orig(*args, **kwargs)

        scoring_module.sparse_score = recording

    def close(self) -> None:
        self._module.sparse_score = self._orig


class GcPauses:
    """Host wall time spent in the interpreter's garbage collector since the
    last `take()`, and since construction the collections and their ms by
    generation (`by_gen`: a full collection walks every tracked object)."""

    def __init__(self):
        self.ms = 0.0
        self._t0 = None
        self.by_gen = {g: dict(collections=0, ms=0.0) for g in range(3)}
        gc.callbacks.append(self._callback)

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            ms = (time.perf_counter() - self._t0) * 1e3
            self.ms += ms
            gen = self.by_gen[info["generation"]]
            gen["collections"] += 1
            gen["ms"] += ms
            self._t0 = None

    def take(self) -> float:
        ms, self.ms = self.ms, 0.0
        return ms

    def close(self) -> None:
        gc.callbacks.remove(self._callback)


GRID_TBS = (8, 16, 32, 64, 128, 256, 512)
GRID_QB = 16
GRID_CLAUSES = 8  # clauses a grid query splits its blocks into: passes = 3
GRID_MODES = {"simple": (True, False), "bool": (False, False), "coord": (False, True)}
GRID_DOC_PAD = 1 << 20


def grid_planes(rng, TB: int, tf: str):
    """Synthetic [NB, 128] planes for one grid rung: Qb·TB random block rows
    over TB·32 docs (each doc about 4 times a query row, across clauses),
    10% dead slots; then a row of 20 docs (fewer matches than k) and the
    all-sentinel row last."""
    NB = GRID_QB * TB + 2
    docs = rng.integers(0, TB * 32, (NB, 128)).astype(np.int32)
    docs[rng.random((NB, 128)) < 0.1] = GRID_DOC_PAD
    docs[NB - 2] = rng.integers(0, 20, 128)
    docs[NB - 1] = GRID_DOC_PAD
    if tf == "u8":
        tfs = rng.integers(1, 256, (NB, 128)).astype(np.uint8)
    elif tf == "i16":
        tfs = rng.integers(1, 3000, (NB, 128)).astype(np.int16)
    else:
        tfs = (rng.random((NB, 128)) * 40 + 0.25).astype(np.float32)
    nb = rng.integers(0, 256, (NB, 128)).astype(np.uint8)
    return docs, tfs, nb


def grid_queries(rng, TB: int, NB: int, simple: bool, use_coord: bool):
    """[Qb, TB] clause arrays: each row's blocks split into GRID_CLAUSES
    clauses (bool: clause 0 must, clause 6 must_not, the rest should, msm 2);
    row 0 holds only the 20-doc row, row 1 only the sentinel row."""
    few, sentinel = NB - 2, NB - 1
    qblk = rng.integers(0, NB - 2, (GRID_QB, TB)).astype(np.int32)
    qblk[0] = sentinel
    qblk[0, 0] = few
    qblk[1] = sentinel
    clause = np.arange(TB) * GRID_CLAUSES // TB  # clause of each block column
    group = np.where(clause == 0, 1, np.where(clause == 6, 2, 0))
    if simple:
        group[:] = 0
    qcnt = np.where(group == 0, 1, np.where(group == 1, 1 << 10, 1 << 20))
    w = (rng.random((GRID_QB, GRID_CLAUSES)) * 3 + 0.1).astype(np.float32)
    qw = np.where(group == 2, np.float32(0.0), w[:, clause]).astype(np.float32)
    qconst = (rng.random((GRID_QB, GRID_CLAUSES)) < 0.1)[:, clause]
    qfid = rng.integers(0, 2, (GRID_QB, GRID_CLAUSES)).astype(np.int32)[:, clause]
    n_must = np.full(GRID_QB, 0 if simple else 1, np.int32)
    msm = np.full(GRID_QB, 1 if simple else 2, np.int32)
    coord = (rng.random((GRID_QB, GRID_CLAUSES + 1)) + 0.25).astype(np.float32)
    if not use_coord:
        coord[:] = 1.0
    return dict(qblk=qblk, qw=qw, qconst=qconst,
                qcnt=np.broadcast_to(qcnt, (GRID_QB, TB)).astype(np.int32),
                qfid=qfid, n_must=n_must, msm=msm, coord=coord)


def kernel_grid(device, seed: int, tbs=GRID_TBS) -> dict:
    """The kernel against its plain version on synthetic inputs, bitwise:
    every TB rung × {simple, bool, bool + coord} × tf plane {u8, i16, f32},
    k = 100 (a row with fewer matches than k, a row all sentinel), plus
    k = P at the smallest rung. Returns the checked cases and the kernel's
    launches by name."""
    import torch

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.ops.sparse_kernels import (
        sparse_score, sparse_score_plain)

    rng = np.random.default_rng(seed)
    caches = torch.from_numpy((rng.random((2, 256)) * 2 + 0.1).astype(np.float32)).to(device)
    modes = torch.tensor([0, 1], dtype=torch.int32, device=device)  # BM25, TF-IDF
    before = cudaenv.LAUNCHES.snapshot()
    cases = 0
    for TB in tbs:
        for tf in ("u8", "i16", "f32"):
            docs, tfs, nb = grid_planes(rng, TB, tf)
            planes = [torch.from_numpy(a).to(device) for a in (docs, tfs, nb)]
            for mode, (simple, use_coord) in GRID_MODES.items():
                q = {n: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for n, a in grid_queries(rng, TB, len(docs), simple, use_coord).items()}
                args = (q["qblk"], q["qw"], q["qconst"], q["qcnt"], q["qfid"],
                        modes[q["qfid"].long()], q["n_must"], q["msm"], q["coord"],
                        *planes, caches)
                ks = (min(K, TB * 128),) + ((TB * 128,) if TB == min(tbs) else ())
                for k in ks:
                    kw = dict(k=k, doc_pad=GRID_DOC_PAD, passes=3, simple=simple,
                              use_coord=use_coord)
                    got = sparse_score(*args, **kw)
                    want = sparse_score_plain(*args, **kw)
                    where = f"grid TB={TB} tf={tf} {mode} k={k}"
                    for g, w_, what in zip(got, want, ("scores", "docs", "totals")):
                        assert torch.equal(g, w_), f"kernel != plain on {what} at {where}"
                    totals = want[2].tolist()
                    assert totals[0] < k and totals[1] == 0, f"{where}: edge rows {totals[:2]}"
                    assert bool(torch.isneginf(want[0][0, totals[0]:]).all()), where
                    assert bool((want[1][1] == GRID_DOC_PAD).all()), where
                    assert max(totals[2:]) > 0, f"{where}: no row matched"
                    cases += 1
    after = cudaenv.LAUNCHES.snapshot()
    launches = {n: after.get(n, 0) - before.get(n, 0) for n in after
                if after.get(n, 0) != before.get(n, 0)}
    return dict(cases=cases, launches=launches)


def check_shapes(shapes: dict) -> float:
    """The kernel against its plain version on each recorded launch's own
    inputs, bitwise; returns the largest absolute score difference."""
    import torch

    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score, sparse_score_plain

    max_err = 0.0
    for key, (args, kwargs, _n) in shapes.items():
        got = sparse_score(*args, **kwargs)
        want = sparse_score_plain(*args, **kwargs)
        for g, w, what in zip(got, want, ("scores", "docs", "totals")):
            assert torch.equal(g, w), f"kernel != plain on {what} at {key}"
        fin = torch.isfinite(want[0])
        if fin.any():
            max_err = max(max_err, float((got[0][fin] - want[0][fin]).abs().max()))
    return max_err


def launch_bound(args, kwargs) -> tuple[float, float, int]:
    """(bytes, operations, real block rows) the launch's function must move
    and do: each touched real postings block row (doc i32 + tf + norm byte)
    read once, the clause arrays, LUTs and outputs; a few float operations
    per posting plus the segment-sum steps."""
    qblk, blk_docs, blk_tf, caches, coord = args[0], args[9], args[10], args[12], args[8]
    Qb, TB = qblk.shape
    k = kwargs["k"]
    sentinel = blk_docs.shape[0] - 1
    real = int((qblk != sentinel).sum().item())
    posting = 4 + blk_tf.element_size() + 1
    clause = Qb * TB * (4 + 4 + 1 + 4 + 4 + 4)  # qblk qw qconst qcnt qfid qmode
    per_query = Qb * (4 + 4 + 4 * coord.shape[1])  # n_must msm coord
    out = Qb * k * (4 + 4) + Qb * 4
    nbytes = real * 128 * posting + clause + per_query + caches.numel() * 4 + out
    ops = real * 128 * (6 + kwargs["passes"])
    return float(nbytes), float(ops), real


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, device, reps: int) -> float:
    """Mean ms of `fn` over `reps` runs after one warm run: CUDA events on the
    card (host clock on the CPU, for rehearsals only)."""
    import torch

    fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device ms of `fn` on the card without the host's launch cost:
    `reps` calls captured in one CUDA graph after a warm call, the graph
    replayed 3 times between CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (3 * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def run(device, *, n_docs: int, vocab: int, n_batches: int, batch: int,
        bool_batch: int, n_check: int, seed: int, small_docs: int,
        serve_requests: int = SERVE_REQUESTS,
        serve_callers: int = SERVE_CALLERS, node_docs: int = NODE_DOCS,
        node_requests: int = NODE_REQUESTS,
        node_callers: int = NODE_CALLERS,
        mixed_requests: int = MIXED_REQUESTS, dense_batch: int = DENSE_BATCH,
        dense_check: int = DENSE_CHECK, sort_agg_requests: int = SORT_AGG_REQUESTS,
        catalog_docs: int = CATALOG_DOCS,
        catalog_requests: int = CATALOG_REQUESTS, write_docs: int = WRITE_DOCS,
        write_requests: int = WRITE_REQUESTS, perc_queries: int = PERC_QUERIES,
        perc_docs: int = PERC_DOCS, perc_node_queries: int = PERC_NODE_QUERIES,
        perc_requests: int = PERC_REQUESTS, analysis_docs: int = ANALYSIS_DOCS,
        analysis_dfr_docs: int = ANALYSIS_DFR_DOCS,
        analysis_requests: int = ANALYSIS_REQUESTS, geo_posts: int = GEO_POSTS,
        geo_branches: int = GEO_BRANCHES, geo_employees: int = GEO_EMPLOYEES,
        geo_requests: int = GEO_REQUESTS, runtime_dfs: int = RUNTIME_DFS,
        runtime_bm25_docs: int = RUNTIME_BM25_DOCS, runtime_mixed: int = RUNTIME_MIXED,
        runtime_cache: int = RUNTIME_CACHE, runtime_rescore: int = RUNTIME_RESCORE,
        fetch_requests: int = FETCH_REQUESTS, fetch_docs: int = FETCH_SMALL_DOCS,
        doc_posts: int = DOC_POSTS, doc_drafts: int = DOC_DRAFTS,
        doc_sessions: int = DOC_SESSIONS, doc_requests: int = DOC_REQUESTS,
        doc_bulk_updates: int = DOC_BULK_UPDATES, doc_checks: int = DOC_CHECKS) -> dict:
    import torch

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.common.smallfloat import encode_norm
    from elasticsearch_tpu_torch.convert import segment_from_arrays
    from elasticsearch_tpu_torch.index.engine import Searcher
    from elasticsearch_tpu_torch.mapper import MapperService
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.device_index import (
        packed_for, packed_resident_bytes)
    from elasticsearch_tpu_torch.ops.sparse_kernels import (
        _launch_plan, sparse_score, sparse_score_plain)
    from elasticsearch_tpu_torch.search import (
        ShardContext, SimilarityService, dispatch_shard_batch, parse_query)

    on_card = device.type == "cuda"
    report: dict = {"device": str(device)}
    recorder = LaunchRecorder(scoring, sparse_score)

    # -- 1. card facts, kernel builds ---------------------------------------
    if on_card:
        report["card"] = card_line()
        nvcc = subprocess.run([cudaenv.nvcc_path(), "--version"],
                              capture_output=True, text=True, timeout=60)
        log("[1] card:", report["card"])
        log("[1] torch", torch.__version__, "cuda", torch.version.cuda, "nvcc",
            nvcc.stdout.strip().splitlines()[-1])
        t0 = time.perf_counter()
        logs = cudaenv.build_all()
        report["build_s"] = time.perf_counter() - t0
        for name, out in logs.items():
            log(f"[1] built {name} in {report['build_s']:.1f} s")
            for line in out.splitlines():
                if "registers" in line or "spill" in line:
                    log("[1]   ptxas:", line.strip())

    # -- 2. the shard ------------------------------------------------------
    t0 = time.perf_counter()
    terms, docs, freqs, lengths = build_corpus(n_docs, vocab, seed)
    df = np.bincount(terms, minlength=vocab)
    csr = split_segments(terms, docs, freqs, lengths, vocab)
    n_postings = len(docs)
    del terms, docs, freqs
    term_dict = {"body": {term_name(t): t for t in range(vocab)}}
    columns = doc_value_columns(n_docs, seed + 11)
    cats = cat_column(n_docs, seed + 12)
    segs = []
    for g, s in enumerate(csr):
        n = s["hi"] - s["lo"]
        segs.append(segment_from_arrays(
            term_dict, s["offsets"], s["docs"], s["freqs"],
            {"body": encode_norm(s["lengths"])},
            {"body": {"doc_count": n, "sum_ttf": int(s["lengths"].sum()),
                      "sum_dfs": len(s["docs"])}},
            np.ones(n, bool), np.ones(n, bool), gen=g,
            dv_num={f: dv_slice(col, s["lo"], s["hi"]) for f, col in columns.items()},
            dv_str={"cat": dv_str_slice(cats, s["lo"], s["hi"])}))
    report["corpus_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for seg in segs:
        packed_for(seg, device)
    rng = np.random.default_rng(seed + 1)
    dead_seg = segs[TOMBSTONE_SEGMENT]
    dead = rng.choice(dead_seg.doc_count, int(dead_seg.doc_count * TOMBSTONE_SHARE),
                      replace=False)
    for local in dead:
        dead_seg.delete_doc(int(local))
    packs = [packed_for(seg, device) for seg in segs]  # re-masks the tombstones
    if on_card:
        torch.cuda.synchronize()
    report["pack_s"] = time.perf_counter() - t0
    resident = sum(packed_resident_bytes(p) for p in packs)
    slots = sum(p.blk_docs.numel() for p in packs)
    report.update(docs=n_docs, vocab=vocab, postings=n_postings,
                  segments=[s["hi"] - s["lo"] for s in csr],
                  tombstones=len(dead), resident_bytes=resident, slots=slots,
                  tf_layouts=[p.tf_layout for p in packs])
    log(f"[2] {n_docs} docs, {vocab} terms, {n_postings} postings in "
        f"{report['segments']} docs/segment, {len(dead)} tombstones; doc values "
        + ", ".join(f"{f} on {int(np.isfinite(c).sum())} docs" for f, c in columns.items())
        + f", cat ({CAT_VALUES} values, zipf {CAT_ZIPF}) on every doc; corpus "
        f"{report['corpus_s']:.1f} s, pack {report['pack_s']:.1f} s; resident "
        f"{resident / 1e9:.3f} GB over {slots} slots "
        f"({resident / max(slots, 1):.2f} B/slot), tf {report['tf_layouts']}")

    def context(settings: dict, dev) -> ShardContext:
        svc = MapperService(Settings.from_flat(settings))
        svc.put_mapping("doc", SHARD_MAPPING)
        return ShardContext(Searcher(segs), svc,
                            SimilarityService(Settings.from_flat(settings), svc),
                            device=dev)

    def bool_body(clauses, msm=None):
        body = {}
        for t, g in clauses:
            body.setdefault(g, []).append({"term": {"body": term_name(int(t))}})
        if msm is not None:
            body["minimum_should_match"] = msm
        return {"bool": body}

    ranked = np.argsort(-df, kind="stable")
    pool = ranked[RANKS[0]: RANKS[1]]
    ref = Reference(csr, [seg.norms["body"] for seg in segs],
                    [seg.live & seg.parent_mask for seg in segs])

    # -- 3. main path --------------------------------------------------------
    bm25 = context(BM25_SETTINGS, device)
    qrng = np.random.default_rng(seed + 2)
    batches = []
    for _ in range(n_batches + 1):  # the first batch warms up
        rows = qrng.choice(pool, size=(batch, TERMS_PER_QUERY))
        clause_rows = [[(t, "should") for t in row] for row in rows]
        batches.append((clause_rows, [parse_query(bool_body(c)) for c in clause_rows]))

    gc_pauses = GcPauses()

    def run_batch(ctx, queries):
        gc_pauses.take()
        t0 = time.perf_counter()
        if on_card:
            torch.cuda.set_sync_debug_mode("error")
        try:
            pending = dispatch_shard_batch(ctx, queries, K)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(0)
        t1 = time.perf_counter()
        results = pending.merge()
        overflow = sum(len(sub) for part in pending.parts if part.kind == "plain"
                       for (_s, _b, _p, _l, dense) in part.seg_work
                       for (sub, _r) in dense or ())
        return (results, overflow, (time.perf_counter() - t0) * 1e3, (t1 - t0) * 1e3,
                gc_pauses.take())

    # set-up before the timed batches: one warm-up batch, then the dense
    # fallback's first use (the most frequent term overflows tb_max in every
    # segment: it faults in each segment's f32 plane), timed cold and warm
    run_batch(bm25, batches[0][1])
    head = [parse_query(bool_body([(ranked[0], "should")]))]
    cold_ms = run_batch(bm25, head)[2]
    warm_ms = run_batch(bm25, head)[2]
    report["dense_first_use_ms"] = dict(cold=cold_ms, warm=warm_ms)
    log(f"[3] set-up: dense fallback's first use {cold_ms:.2f} ms, then {warm_ms:.2f} ms "
        f"(one query over the most frequent term, all {len(segs)} segments)")
    cudaenv.LAUNCHES.reset()
    gc_before = {g: dict(v) for g, v in gc_pauses.by_gen.items()}
    # the pools of staging sets (ops/scoring.SparseScratchPool), one a
    # segment's pack
    pools = list({id(p): p for p in (packed_for(seg, device).sparse_scratch
                                     for seg in segs)}.values())
    scratch_before = (sum(p.allocs for p in pools), sum(p.reuses for p in pools))
    lat, dispatch, gc_ms, overflows, main_results = [], [], [], [], None
    for bi, (_c, queries) in enumerate(batches[1:]):
        recorder.batch = [] if bi == 0 else None
        results, overflow, ms, dispatch_ms, gc_batch_ms = run_batch(bm25, queries)
        if bi == 0:
            main_results, main_batch = results, recorder.batch
        lat.append(ms)
        dispatch.append(dispatch_ms)
        gc_ms.append(gc_batch_ms)
        overflows.append(overflow)
    overflow_pairs = sum(overflows)
    recorder.batch = None
    main_launches = cudaenv.LAUNCHES.snapshot()
    gc_gens = {g: {k: v[k] - gc_before[g][k] for k in v}
               for g, v in gc_pauses.by_gen.items()}
    lat_a = np.asarray(lat)
    report["main"] = dict(
        batches=n_batches, batch=batch, k=K, latency_ms=lat, dispatch_ms=dispatch,
        gc_ms=gc_ms, gc_by_generation=gc_gens, overflow_per_batch=overflows,
        p50_ms=float(np.percentile(lat_a, 50)), p99_ms=float(np.percentile(lat_a, 99)),
        qps=float(n_batches * batch / (lat_a.sum() / 1e3)),
        overflow_query_segments=overflow_pairs,
        query_segments=n_batches * batch * len(segs), launches=main_launches)
    m = report["main"]
    # the staging sets over the timed batches, then a warmed repeat batch,
    # which must allocate none
    timed = (sum(p.allocs for p in pools), sum(p.reuses for p in pools))
    run_batch(bm25, batches[1][1])
    repeat_allocs = sum(p.allocs for p in pools) - timed[0]
    m["scratch"] = dict(allocs=timed[0] - scratch_before[0],
                        reuses=timed[1] - scratch_before[1],
                        repeat_allocs=repeat_allocs)
    assert repeat_allocs == 0, f"a warmed repeat batch allocated {repeat_allocs} sets"
    log(f"[3] staging: {m['scratch']['allocs']} staging sets allocated and "
        f"{m['scratch']['reuses']} reused over the {n_batches} timed batches "
        f"(one buffer and one host->device copy a launch); a warmed repeat batch "
        f"allocated "
        f"{repeat_allocs}")
    log(f"[3] {n_batches} x {batch} queries: {m['qps']:.1f} QPS, batch p50 "
        f"{m['p50_ms']:.2f} ms p99 {m['p99_ms']:.2f} ms (dispatch half p50 "
        f"{np.median(dispatch):.2f} ms, garbage collection {sum(gc_ms):.1f} ms in "
        f"all; collections, ms by generation "
        + ", ".join(f"{g}: {v['collections']}, {v['ms']:.1f}" for g, v in gc_gens.items())
        + f"); {overflow_pairs} of "
        f"{m['query_segments']} (query, segment) pairs past tb_max -> dense path; "
        f"launches {main_launches}")
    for r in main_results:
        assert len(r.hits) <= K and all(np.isfinite(s) for s, _d in r.hits)
    if on_card:
        for name in KERNELS:
            assert main_launches.get(name, 0) > 0, f"{name} never launched on the main path"
        for variant in ("sparse_score.smem", "sparse_score.global"):
            assert main_launches.get(variant, 0) > 0, (
                f"{variant} never launched on the main path")

    # -- 4. non-simple batches -------------------------------------------------
    bool_pool = ranked[BOOL_RANKS[0]: BOOL_RANKS[1]]
    brng = np.random.default_rng(seed + 3)
    bool_clauses = []
    for _ in range(bool_batch):
        t = brng.choice(bool_pool, 5, replace=False)
        bool_clauses.append([(t[0], "must"), (t[1], "should"), (t[2], "should"),
                             (t[3], "should"), (t[4], "must_not")])
    bool_queries = [parse_query(bool_body(c, msm=2)) for c in bool_clauses]
    bool_results = {}
    cudaenv.LAUNCHES.reset()
    for sim, settings in (("bm25", BM25_SETTINGS), ("tfidf", TFIDF_SETTINGS)):
        results, overflow, ms, _d, _g = run_batch(context(settings, device), bool_queries)
        bool_results[sim] = results
        report[f"bool_{sim}"] = dict(queries=bool_batch, ms=ms,
                                     overflow_query_segments=overflow,
                                     matched=sum(r.total for r in results))
        log(f"[4] bool must+should+must_not msm=2 under {sim}: {ms:.2f} ms, "
            f"{overflow} pairs on the dense path, "
            f"{sum(1 for r in results if r.total)} of {bool_batch} queries match")
    bool_launches = cudaenv.LAUNCHES.snapshot()
    report["bool_launches"] = bool_launches
    gc_pauses.close()
    recorder.close()
    report["resident_bytes_after_dense"] = sum(packed_resident_bytes(p) for p in packs)
    log(f"[4] resident after the dense path ran: "
        f"{report['resident_bytes_after_dense'] / 1e9:.3f} GB (the lazy f32 plane "
        f"of {sum(p.blk_freqs is not None for p in packs)} segments)")
    if on_card:
        for name in KERNELS:
            assert bool_launches.get(name, 0) > 0, f"{name} never launched in phase 4"

    # -- 5. kernel against plain, every launched shape -----------------------
    max_err = check_shapes(recorder.shapes)
    report["kernel_vs_plain"] = dict(shapes=len(recorder.shapes), max_abs_err=max_err)
    log(f"[5] sparse_score == plain (bitwise: scores, docs, totals) at all "
        f"{len(recorder.shapes)} launched shapes; max abs err {max_err}")
    grid = kernel_grid(device, seed + 6)
    report["kernel_grid"] = grid
    log(f"[5b] sparse_score == plain (bitwise) on {grid['cases']} synthetic cases; "
        f"launches {grid['launches']}")
    if on_card:
        for variant in ("sparse_score.smem", "sparse_score.global"):
            assert grid["launches"].get(variant, 0) > 0, f"{variant} never launched in 5b"

    # -- 6. end to end against the reference scorer ----------------------------
    checked = 0
    crng = np.random.default_rng(seed + 4)
    main_clauses = batches[1][0]
    for qi in crng.choice(len(main_results), min(n_check, len(main_results)), replace=False):
        cl = [(int(t), g) for t, g in main_clauses[qi]]
        total, scores, _m = ref.search(cl, msm=1, sim="bm25", k=K)
        check_hits(f"main q{qi}", main_results[qi], total, scores, K)
        checked += 1
    for sim, results in bool_results.items():
        for qi in crng.choice(len(results), min(n_check, len(results)), replace=False):
            cl = [(int(t), g) for t, g in bool_clauses[qi]]
            total, scores, _m = ref.search(cl, msm=2, sim=sim, k=K)
            check_hits(f"bool {sim} q{qi}", results[qi], total, scores, K)
            checked += 1
    report["reference_checked"] = checked
    log(f"[6] {checked} queries match the numpy term-at-a-time scorer "
        f"(totals exact, scores rtol {RTOL}, order up to near-ties)")

    # -- 7. the normal indexing path, small --------------------------------
    small = small_index_check(device, small_docs, seed + 5)
    report["small_index"] = small
    log(f"[7] {small['docs']} docs through mapper -> analyzer -> SegmentBuilder "
        f"-> {small['segments']} segments: {small['queries']} queries, hits on "
        f"{device} == hits on cpu ({small['hits']} hits)")

    # -- 8. times ------------------------------------------------------------
    shapes = []
    for key, (args, kwargs, n) in sorted(recorder.shapes.items()):
        nbytes, ops, real = launch_bound(args, kwargs)
        b_ms, b_by = bound_ms(nbytes, ops)
        reps = 20 if args[0].shape[1] < 256 else 5
        k_ms = time_ms(lambda: sparse_score(*args, **kwargs), device, reps)
        p_ms = time_ms(lambda: sparse_score_plain(*args, **kwargs), device, reps)
        k_graph = p_graph = None
        if on_card:
            k_graph = graph_ms(lambda: sparse_score(*args, **kwargs), reps)
            p_graph = graph_ms(lambda: sparse_score_plain(*args, **kwargs), reps)
        shapes.append(dict(Qb=key[0][0], TB=key[0][1], tf=key[1], k=key[2],
                           variant=_launch_plan(*key[0], key[4]).variant,
                           passes=key[3], simple=key[4], use_coord=key[5],
                           launches=n, real_blocks=real, ms=k_ms, plain_ms=p_ms,
                           graph_ms=k_graph, plain_graph_ms=p_graph,
                           bound_ms=b_ms, bound_by=b_by))
    report["shapes"] = shapes
    log("[8] per shape (launches: phases 3-4 with their warm-up): Qb TB tf k passes "
        "simple coord variant "
        "| launches | kernel ms | plain ms | bound ms | in a CUDA graph: kernel ms, plain ms")
    for s in shapes:
        log(f"[8]   {s['Qb']:5d} {s['TB']:4d} {s['tf']:>13s} {s['k']:4d} "
            f"{s['passes']} {int(s['simple'])} {int(s['use_coord'])} {s['variant']:>6s} "
            f"| {s['launches']:4d} "
            f"| {s['ms']:.4f} | {s['plain_ms']:.4f} | {s['bound_ms']:.5f} ({s['bound_by']})"
            + (f" | {s['graph_ms']:.4f}, {s['plain_graph_ms']:.4f}" if on_card else ""))

    def replay(fn):
        def go():
            for a, kw in main_batch:
                fn(*a, **kw)
        return go

    nbytes = sum(launch_bound(a, kw)[0] for a, kw in main_batch)
    ops = sum(launch_bound(a, kw)[1] for a, kw in main_batch)
    b_ms, b_by = bound_ms(nbytes, ops)
    k_ms = time_ms(replay(sparse_score), device, 5)
    p_ms = time_ms(replay(sparse_score_plain), device, 5)
    k_graph = graph_ms(replay(sparse_score), 2) if on_card else None
    p_graph = graph_ms(replay(sparse_score_plain), 2) if on_card else None
    report["main_batch_kernels"] = dict(launches=len(main_batch), ms=k_ms,
                                        plain_ms=p_ms, graph_ms=k_graph,
                                        plain_graph_ms=p_graph, bound_ms=b_ms,
                                        bound_by=b_by, bytes=nbytes, ops=ops)
    log(f"[8] one main-path batch's {len(main_batch)} sparse_score launches: "
        f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{nbytes / 1e6:.1f} MB)"
        + (f"; in a CUDA graph: kernel {k_graph:.3f} ms, plain {p_graph:.3f} ms"
           if on_card else ""))
    if on_card:
        prof = profile_batch(bm25, batches[1][1])
        report["profiled_batch"] = prof
        if prof["device_busy_ms"]:
            log(f"[8] profiled main-path batch: wall {prof['wall_ms']:.2f} ms, device "
                f"busy {prof['device_busy_ms']:.3f} ms, idle share {prof['idle_share']:.4f}")
            for name, ms, n in prof["top"]:
                log(f"[8]   {ms:9.3f} ms {n:5d}x {name}")
        else:
            log("[8] profiled main-path batch: the profiler saw no device time "
                "(device idle share not measured)")
        report["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        log(f"[8] peak device memory allocated {report['peak_allocated_bytes'] / 1e9:.2f} GB")

    # -- 9. serving concurrent single requests through the DeviceBatcher -------
    serving = serving_phase(device, bm25, packs, pool, seed=seed + 7,
                            n_requests=serve_requests, n_callers=serve_callers)
    report["serving"] = serving
    reduce = shard_reduce_check(device, small_docs, seed + 8)
    report["shard_reduce"] = reduce
    log(f"[9] 2-shard reduce at {reduce['docs']} docs: execute_query_phase on each "
        f"shard, sort_docs: merged hits on {device} == on cpu for "
        f"{reduce['queries']} queries ({reduce['hits']} hits)")

    # -- 10. the node over HTTP -----------------------------------------------
    node = node_phase(device, vocab=vocab, seed=seed + 9, n_docs=node_docs,
                      n_requests=node_requests, n_callers=node_callers,
                      mixed_requests=mixed_requests, catalog_docs=catalog_docs,
                      catalog_requests=catalog_requests, write_docs=write_docs,
                      write_requests=write_requests, perc_queries=perc_queries,
                      perc_docs=perc_docs, perc_node_queries=perc_node_queries,
                      perc_requests=perc_requests, runtime=dict(
                          n_dfs=runtime_dfs, n_bm25_docs=runtime_bm25_docs,
                          n_mixed=runtime_mixed, n_cache=runtime_cache,
                          n_rescore=runtime_rescore),
                      fetch=dict(n_requests=fetch_requests, n_small=fetch_docs))
    report["node"] = node

    # -- 12. the dense request-feature family at full width -------------------
    report["dense_family"] = dense_family_phase(
        device, segs, ranked, seed=seed + 10, batch=dense_batch, n_check=dense_check)

    # -- 13. field sort and aggregations at full width (the node leg ran on
    # phase 10's node, before it closed) -------------------------------------
    report["sort_aggs"] = sort_agg_phase(device, segs, ranked, seed=seed + 13,
                                         n_requests=sort_agg_requests)

    # -- 14. the write path: B7's concat at full width on phase 2's corpus
    # without tombstones (the node leg ran on phase 10's node, before it
    # closed) ---------------------------------------------------------------
    report["write_path"] = write_path_phase(
        device, csr, vocab, [[t for t, _g in c] for c in batches[1][0]], seed=seed + 14)

    # phases 1-14 served nothing on the host path by degrade: every degrade
    # and device error of the process is phase 15's, phase 16's armed
    # percolations' or phase 25 (a)'s armed health window's
    from elasticsearch_tpu_torch.search import SERVING_COUNTERS
    faults, perc = node["faults"]["counted"], node["percolate"]["counted"]
    admin = node["admin"]["counted"]
    for key in ("degraded", "device_errors"):
        assert SERVING_COUNTERS[key] == faults[key] + perc[key] + admin[key], \
            (f"{key}: {SERVING_COUNTERS[key]} in the run, {faults[key]} of them phase "
             f"15's, {perc[key]} phase 16's, {admin[key]} phase 25's")

    # -- 18. analysis, similarities and the flat mapper on a node of its own --
    report["analysis"] = analysis = analysis_phase(
        device, seed=seed + 18, n_docs=analysis_docs, n_dfr_docs=analysis_dfr_docs,
        n_requests=analysis_requests, phase10_docs_per_s=node["bulk_docs_per_s"])

    # -- 19. nested documents, parent/child joins and geo fields on a node of
    # its own -----------------------------------------------------------------
    report["geo_nested"] = geo = geo_nested_phase(
        device, seed=seed + 19, n_posts=geo_posts, n_branches=geo_branches,
        n_employees=geo_employees, n_requests=geo_requests)

    # -- 22. documents under search on a node of its own ----------------------
    report["documents"] = documents = documents_phase(
        device, vocab=vocab, seed=seed + 22, n_posts=doc_posts, n_drafts=doc_drafts,
        n_sessions=doc_sessions, n_requests=doc_requests,
        n_bulk_updates=doc_bulk_updates, n_checks=doc_checks)

    # -- 23. index lifecycle on a node of its own -----------------------------
    report["lifecycle"] = lifecycle = lifecycle_phase(device, vocab=vocab,
                                                      seed=seed + 23)

    # -- 26. two nodes over TCP, beside a one-node reference -------------------
    report["two_nodes"] = two = two_node_phase(device, vocab=vocab, seed=seed + 9)

    # -- 27. a replicated cluster: replicas, peer recovery, a node's loss -----
    report["replicas"] = rep = replica_phase(device, vocab=vocab, seed=seed + 9)

    # -- 28. a slow copy, hedges, cache affinity, snapshot and restore --------
    report["adaptive"] = adapt = adaptive_phase(device, vocab=vocab, seed=seed + 9)

    report["kernels"] = [dict(
        name="sparse_score", **KERNELS["sparse_score"],
        launches=main_launches.get("sparse_score", 0), max_abs_err=max_err,
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        # phase 10's timed run and phase 20's, 21's, 24's and 25's legs, on
        # phase 10's node, and phase 25's lock-trace child
        node_launches=node["launches"].get("sparse_score", 0)
        + node["runtime"]["launches"].get("sparse_score", 0)
        + node["fetch"]["launches"].get("sparse_score", 0)
        + node["observe"]["launches"].get("sparse_score", 0)
        + node["admin"]["launches"].get("sparse_score", 0)
        + node["admin"]["locktrace"]["launches"],
        node_max_abs_err=node["kernel_max_abs_err"],
        runtime_launches=node["runtime"]["launches"].get("sparse_score", 0),
        runtime_shapes=[(s["Qb"], s["TB"], s["k"], s["launches"])
                        for s in node["runtime"]["kernel_shapes"]],
        runtime_max_abs_err=node["runtime"]["kernel_max_abs_err"],
        fetch_launches=node["fetch"]["launches"].get("sparse_score", 0),
        fetch_shapes=[(s["Qb"], s["TB"], s["k"], s["launches"])
                      for s in node["fetch"]["kernel_shapes"]],
        fetch_max_abs_err=node["fetch"]["kernel_max_abs_err"],
        observe_launches=node["observe"]["launches"].get("sparse_score", 0),
        observe_shapes=[(s["Qb"], s["TB"], s["k"], s["launches"])
                        for s in node["observe"]["kernel_shapes"]],
        observe_max_abs_err=node["observe"]["kernel_max_abs_err"],
        admin_launches=node["admin"]["launches"].get("sparse_score", 0),
        admin_shapes=[(s["Qb"], s["TB"], s["k"], s["launches"])
                      for s in node["admin"]["kernel_shapes"]],
        admin_max_abs_err=node["admin"]["kernel_max_abs_err"],
        locktrace_launches=node["admin"]["locktrace"]["launches"],
        locktrace_max_abs_err=node["admin"]["locktrace"]["max_abs_err"],
        mixed_launches=node["mixed"]["launches"].get("sparse_score", 0),
        mixed_max_abs_err=node["mixed"]["kernel_max_abs_err"],
        dense_family_max_abs_err=report["dense_family"]["kernel_max_abs_err"],
        fault_launches=node["faults"]["launches"],
        percolate_launches=node["percolate"]["node"]["launches"],
        percolate_shapes=[(s["Qb"], s["TB"], s["k"])
                          for s in node["percolate"]["library"]["shapes"]],
        percolate_max_abs_err=node["percolate"]["library"]["kernel_max_abs_err"],
        analysis_launches=analysis["launches"].get("sparse_score", 0),
        analysis_shapes=[(s["Qb"], s["TB"], s["k"]) for s in analysis["kernel_shapes"]],
        analysis_max_abs_err=analysis["kernel_max_abs_err"],
        geo_nested_launches=geo["launches"].get("sparse_score", 0),
        geo_nested_shapes=[(s["Qb"], s["TB"], s["k"], s["launches"])
                           for s in geo["kernel_shapes"]],
        geo_nested_max_abs_err=geo["kernel_max_abs_err"],
        documents_launches=documents["launches"].get("sparse_score", 0),
        documents_shapes=[(s["Qb"], s["TB"], s["k"], s["launches"])
                          for s in documents["kernel_shapes"]],
        documents_max_abs_err=documents["kernel_max_abs_err"],
        lifecycle_launches=lifecycle["launches"].get("sparse_score", 0),
        lifecycle_warmer_launches=lifecycle["refresh"]["warmer_launches"],
        lifecycle_shapes=[(s["Qb"], s["TB"], s["k"], s["launches"])
                          for s in lifecycle["kernel_shapes"]],
        lifecycle_max_abs_err=lifecycle["kernel_max_abs_err"],
        two_node_launches={n: v["launches"] for n, v in two["by_node"].items()
                           if n != "other"},
        two_node_shapes=[(s["Qb"], s["TB"], s["k"], s["launches"])
                         for s in two["kernel_shapes"]],
        two_node_max_abs_err=two["kernel_max_abs_err"],
        replica_launches={n: v["launches"] for n, v in rep["by_node"].items()
                          if n != "other"},
        replica_shapes=[(s["Qb"], s["TB"], s["k"], s["launches"])
                        for s in rep["kernel_shapes"]],
        replica_max_abs_err=rep["kernel_max_abs_err"],
        adaptive_launches={n: v["launches"] for n, v in adapt["by_node"].items()
                           if n != "other"},
        adaptive_hedges=adapt["slow"]["hedges_issued"],
        adaptive_shapes=[(s["Qb"], s["TB"], s["k"], s["launches"])
                         for s in adapt["kernel_shapes"]],
        adaptive_max_abs_err=adapt["kernel_max_abs_err"])]
    return report


def within_ulps(a: float, b: float, ulps: int) -> bool:
    ia = np.array(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.array(b, np.float32).view(np.int32).astype(np.int64)
    return abs(int(ia) - int(ib)) <= ulps


def tie_tolerant_equal(got, want, ulps: int = ULPS) -> bool:
    """Same doc set, per-doc scores within `ulps`, identical order except
    inside groups of scores within `ulps` of each other."""
    if sorted(d for _, d in got) != sorted(d for _, d in want):
        return False
    want_by = {d: s for s, d in want}
    if not all(within_ulps(s, want_by[d], ulps) for s, d in got):
        return False
    pos = {d: i for i, (_, d) in enumerate(got)}
    for i, (sa, a) in enumerate(want):
        for sb, b in want[i + 1:]:
            if not within_ulps(sa, sb, 2 * ulps) and pos[a] > pos[b]:
                return False
    return True


def serve(ctx, bodies: list, n_callers: int, sync_error: bool):
    """`bodies` sent by `n_callers` threads at once, each request on its own
    through `execute_query_phase(ctx, parse_search_body(body))`, back to
    back (caller c sends bodies c, c + n_callers, ...). With `sync_error`
    the whole run is under `torch.cuda.set_sync_debug_mode("error")`.
    Returns (results, per-request ms, wall s, errors)."""
    import torch

    from elasticsearch_tpu_torch.search import execute_query_phase, parse_search_body

    n = len(bodies)
    results, lat_ms, errors = [None] * n, np.zeros(n), []
    start = threading.Barrier(n_callers + 1)

    def caller(c):
        start.wait()
        for i in range(c, n, n_callers):
            t0 = time.perf_counter()
            try:
                results[i] = execute_query_phase(ctx, parse_search_body(bodies[i]))
            except Exception as e:  # noqa: BLE001 — every error fails the phase below
                errors.append((i, repr(e)))
            lat_ms[i] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=caller, args=(c,), daemon=True)
               for c in range(n_callers)]
    for t in threads:
        t.start()
    if sync_error:
        torch.cuda.set_sync_debug_mode("error")
    try:
        start.wait()
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=600)
        wall_s = time.perf_counter() - t0
    finally:
        if sync_error:
            torch.cuda.set_sync_debug_mode(0)
    assert not any(t.is_alive() for t in threads), "a serving caller hung"
    return results, lat_ms, wall_s, errors


def serving_phase(device, base, packs, pool, *, seed: int, n_requests: int,
                  n_callers: int) -> dict:
    """Phase 9: `n_requests` single-request search bodies (phase 3's traffic:
    a bool of 4 should BM25 terms from df ranks 50-5000; half size 10, half
    size 100) from `n_callers` concurrent callers through a DeviceBatcher at
    the JAX package's default settings, on the phase 2 shard. Every response
    is held against `search_shard_batch` at the same k before any time is
    kept; then one window is profiled for the device's idle share, and the
    merge's wait is held against a spin kernel enqueued after a dispatch."""
    import torch

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score
    from elasticsearch_tpu_torch.search import (
        SERVING_COUNTERS, DeviceBatcher, ShardContext, parse_query, search_shard_batch)

    on_card = device.type == "cuda"
    rng = np.random.default_rng(seed)
    rows = rng.choice(pool, size=(n_requests, TERMS_PER_QUERY))
    # page sizes in a random order: callers answered by one batch come back
    # together, and with a size fixed per caller (or per round) each such
    # cohort would be one k-bucket key that always fills one batch alone
    sizes = rng.permutation(np.resize(np.asarray(SERVE_SIZES), n_requests))
    bodies = [{"query": {"bool": {"should": [{"term": {"body": term_name(int(t))}}
                                             for t in row]}},
               "size": int(size)} for row, size in zip(rows, sizes)]
    # a (query, segment) pair past tb_max takes the dense path, which sums
    # in clause order, not the reference's: those queries are held within ULPS
    blocks = np.stack([np.diff(p.term_blk_start)[rows].sum(axis=1) for p in packs],
                      axis=1)
    dense = (blocks > TB_MAX).any(axis=1)
    want = [None] * n_requests
    for size in SERVE_SIZES:
        idx = np.flatnonzero(sizes == size)
        for lo in range(0, len(idx), 1024):
            chunk = idx[lo: lo + 1024]
            tops = search_shard_batch(base, [parse_query(bodies[i]["query"])
                                             for i in chunk], size)
            for i, td in zip(chunk, tops):
                want[i] = (td.total, td.hits)

    def serving_ctx():
        return ShardContext(base.searcher, base.mapper_service,
                            base.similarity_service, device=device,
                            batcher=DeviceBatcher())

    recorder = LaunchRecorder(scoring, sparse_score)
    try:
        warm = serving_ctx()  # first use of the k-16 and k-128 buckets, untimed
        try:
            warm_errors = serve(warm, bodies[: 2 * n_callers], n_callers,
                                sync_error=False)[3]
            assert not warm_errors, warm_errors[:3]
        finally:
            warm.batcher.shutdown()
        ctx = serving_ctx()
        errors_before = SERVING_COUNTERS["device_errors"]
        cudaenv.LAUNCHES.reset()
        try:
            results, lat_ms, wall_s, errors = serve(ctx, bodies, n_callers,
                                                    sync_error=on_card)
        finally:
            launches = cudaenv.LAUNCHES.snapshot()
            stats = ctx.batcher.stats()
            ctx.batcher.shutdown()
    finally:
        recorder.close()
    device_errors = SERVING_COUNTERS["device_errors"] - errors_before

    # correctness, before any time is kept
    assert not errors, f"{len(errors)} requests failed, first {errors[:3]}"
    n_dense = 0
    for i, (r, (total, hits)) in enumerate(zip(results, want)):
        got = [(sc, d) for sc, d, _sv in r.docs]
        assert r.total == total, f"request {i}: total {r.total} != {total}"
        if dense[i]:
            n_dense += 1
            assert tie_tolerant_equal(got, hits), f"request {i} (dense path): hits"
        else:
            assert got == hits, f"request {i}: hits differ from search_shard_batch"
    if on_card:
        assert launches.get("sparse_score", 0) > 0, "sparse_score never launched in phase 9"
    assert stats["launches"] > 0 and stats["occupancy_mean"] > 1, stats
    assert stats["splits"] == 0 and stats["pending_flushes"] > 0, stats
    assert device_errors == 0, f"{device_errors} device errors"
    max_err = check_shapes(recorder.shapes)

    out = dict(
        requests=n_requests, callers=n_callers, sizes=list(SERVE_SIZES),
        dense_requests=n_dense, wall_s=wall_s, requests_per_s=n_requests / wall_s,
        latency_ms=dict(p50=float(np.percentile(lat_ms, 50)),
                        p99=float(np.percentile(lat_ms, 99)),
                        max=float(lat_ms.max()), mean=float(lat_ms.mean())),
        batcher=stats, launches=launches, device_errors=device_errors,
        kernel_shapes=len(recorder.shapes), kernel_max_abs_err=max_err,
        sync_debug="error over the whole serving run" if on_card else None)
    log(f"[9] {n_requests} single requests from {n_callers} callers through the "
        f"DeviceBatcher: {out['requests_per_s']:.1f} requests/s, latency p50 "
        f"{out['latency_ms']['p50']:.2f} ms p99 {out['latency_ms']['p99']:.2f} ms "
        f"max {out['latency_ms']['max']:.2f} ms; every response == search_shard_batch "
        f"({n_dense} on the dense path within {ULPS} ulp, the rest bitwise)")
    log(f"[9] batches {stats['launches']}, occupancy mean {stats['occupancy_mean']}; "
        f"flushes full {stats['full_flushes']} linger {stats['linger_flushes']} "
        f"deadline {stats['deadline_flushes']} pending {stats['pending_flushes']}; "
        f"bypassed {stats['bypassed']}, splits {stats['splits']}; batch service "
        f"p50 {stats['batch']['p50_ms']} ms p99 {stats['batch']['p99_ms']} ms; "
        f"launches {launches}")
    log(f"[9] sparse_score == plain (bitwise) at all {len(recorder.shapes)} shapes "
        f"phase 9 launched; max abs err {max_err}")
    mw = stats["merge_wait"]
    log(f"[9] {mw['count']} batches merged while the next batch was already "
        f"launched: the merge's wait p50 {mw['p50_ms']} ms, p99 {mw['p99_ms']} ms, "
        f"mean {mw['mean_ms']} ms")

    if on_card:
        ctx = serving_ctx()
        try:
            out["profiled"] = profile_serving(ctx, bodies[:SERVE_PROFILED], n_callers)
            window = ctx.batcher.stats()
        finally:
            ctx.batcher.shutdown()
        prof = out["profiled"]
        prof.update(batches=window["launches"], merge_wait=window["merge_wait"])
        if prof["device_busy_ms"]:
            prof["device_busy_per_batch_ms"] = prof["device_busy_ms"] / window["launches"]
            log(f"[9] profiled window of {SERVE_PROFILED} requests: wall "
                f"{prof['wall_ms']:.2f} ms, device busy {prof['device_busy_ms']:.3f} ms, "
                f"idle share {prof['idle_share']:.4f}; {window['launches']} batches, "
                f"device busy {prof['device_busy_per_batch_ms']:.3f} ms a batch (what a "
                f"merge waits at most if its copies queue behind the next batch's "
                f"launches) against a merge wait of p50 {window['merge_wait']['p50_ms']} "
                f"ms, p99 {window['merge_wait']['p99_ms']} ms over "
                f"{window['merge_wait']['count']} overlapped merges")
            for name, ms, n in prof["top"]:
                log(f"[9]   {ms:9.3f} ms {n:5d}x {name}")
        else:
            log("[9] profiled window: the profiler saw no device time "
                "(device idle share not measured)")
        check = merge_wait_check(base, [parse_query(b["query"]) for b in
                                        bodies[:64]], 16)
        out["merge_wait_check"] = check
        log(f"[9] batch N's merge with a {check['spin_ms']:.2f} ms spin kernel "
            f"enqueued after its dispatch (standing in for batch N+1): wait "
            f"{np.median(check['split_wait_ms']):.3f} ms with the copies enqueued at "
            f"the end of the dispatch, {np.median(check['at_merge_wait_ms']):.3f} ms "
            f"with copies enqueued at merge time (medians of {len(check['split_wait_ms'])})")
    return out


def merge_wait_check(ctx, queries, k: int, reps: int = 5) -> dict:
    """Batch N's merge waits for N's own device work only. After N's
    dispatch a spin kernel (`torch.cuda._sleep`) stands in for batch N+1's
    launches: N's merge, whose copies were enqueued at the end of its
    dispatch (`cudaenv.pull_async`), does not wait for the spin, while
    copies enqueued at merge time (`cudaenv.pull`, the order before the
    split) do."""
    import torch

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.search.execute import dispatch_flat_batch, lower_flat

    plans = [lower_flat(q, ctx) for q in queries]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    end.record()
    end.synchronize()
    spin_ms = start.elapsed_time(end)
    split_ms, at_merge_ms = [], []
    for _ in range(reps):
        pending = dispatch_flat_batch(plans, ctx, k)
        torch.cuda._sleep(SPIN_CYCLES)
        pending.merge()
        split_ms.append((pending.pull_t1 - pending.pull_t0) * 1e3)
        torch.cuda.synchronize()
        pending = dispatch_flat_batch(plans, ctx, k)
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        cudaenv.pull(pending.tensors())
        at_merge_ms.append((time.perf_counter() - t0) * 1e3)
        pending.merge()
        torch.cuda.synchronize()
    out = dict(queries=len(plans), k=k, spin_ms=spin_ms, split_wait_ms=split_ms,
               at_merge_wait_ms=at_merge_ms)
    assert np.median(at_merge_ms) - np.median(split_ms) > 0.5 * spin_ms, out
    return out


def profile_serving(ctx, bodies, n_callers) -> dict:
    """One window of phase 9 under torch.profiler (device activity only, so
    the callers' host work is not slowed by tracing): wall time, device busy
    time by name, the device's idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _r, _l, wall_s, errors = serve(ctx, bodies, n_callers, sync_error=False)
    assert not errors, errors[:3]
    return device_busy(prof, wall_s * 1e3)


def device_busy(prof, wall_ms: float) -> dict:
    """Device busy time by name from a profile, and its idle share."""
    import torch

    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((e.key[:90], us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(ms for _n, ms, _c in rows)
    copies = {name: n for name, _ms, n in rows if name.startswith("Memcpy")}
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=(1.0 - busy / wall_ms) if busy else None, top=rows[:12],
                copies=copies)


THREAD_KINDS = (("estpu_torch[search_batcher]", "drainer"),
                ("estpu_torch[search]", "search pool"),
                ("estpu_torch[generic]", "generic pool"),
                ("process_request_thread", "HTTP handlers"))


def thread_cpu_s() -> dict:
    """CPU seconds (user + system) of each live thread of this process, from
    /proc/self/task: {native thread id: (kind, seconds)}."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for t in threading.enumerate():
        try:
            stat = Path(f"/proc/self/task/{t.native_id}/stat").read_text()
        except OSError:
            continue
        fields = stat.rsplit(")", 1)[1].split()  # fields 3.. of proc(5)
        kind = next((k for prefix, k in THREAD_KINDS if prefix in t.name), "other")
        out[t.native_id] = (kind, (int(fields[11]) + int(fields[12])) / tick)
    return out


def host_cpu_split(before: dict, after: dict, process_s: float) -> dict:
    """CPU seconds by thread kind between two `thread_cpu_s` readings; what
    the process spent beyond them (threads that ended meanwhile, such as
    the HTTP client threads, and the main thread) is `rest`."""
    split: dict[str, float] = {}
    for tid, (kind, s) in after.items():
        split[kind] = split.get(kind, 0.0) + s - before.get(tid, (kind, 0.0))[1]
    split.pop("other", None)
    split["rest"] = process_s - sum(split.values())
    return split


class SpanClock:
    """Calls, thread-CPU seconds and wall seconds spent inside chosen
    functions of the port while installed (a `with` block), summed over the
    threads that call them: [(span name, owner, attribute)] targets. A span
    nested in another is counted in both."""

    def __init__(self, targets: list):
        self.targets = targets
        self.lock = threading.Lock()
        self.spans = {name: [0, 0.0, 0.0] for name, _owner, _attr in targets}
        self.saved: list = []

    def __enter__(self):
        for name, owner, attr in self.targets:
            fn = getattr(owner, attr)
            self.saved.append((owner, attr, fn))
            setattr(owner, attr, self._timed(self.spans[name], fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self.saved):
            setattr(owner, attr, fn)
        self.saved.clear()

    def _timed(self, span: list, fn):
        lock = self.lock

        def timed(*args, **kwargs):
            c0, w0 = time.thread_time(), time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                c, w = time.thread_time() - c0, time.perf_counter() - w0
                with lock:
                    span[0] += 1
                    span[1] += c
                    span[2] += w
        return timed

    def report(self) -> dict:
        return {name: dict(calls=n, cpu_s=c, wall_s=w)
                for name, (n, c, w) in self.spans.items()}


def shard_reduce_check(device, n_docs: int, seed: int) -> dict:
    """Phase 7's documents split into two shards (one segment each):
    `execute_query_phase` on each shard, then `sort_docs`, on `device` and on
    the CPU — identical merged hits."""
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.engine import Searcher
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder
    from elasticsearch_tpu_torch.mapper import MapperService
    from elasticsearch_tpu_torch.search import (
        ShardContext, SimilarityService, execute_query_phase, parse_search_body,
        sort_docs)

    svc = MapperService(Settings.from_flat(BM25_SETTINGS))
    sims = SimilarityService(Settings.from_flat(BM25_SETTINGS), svc)
    sources = small_sources(n_docs, seed)
    shards = []
    for lo, hi in ((0, n_docs // 2), (n_docs // 2, n_docs)):
        b = SegmentBuilder(0)
        for i in range(lo, hi):
            b.add(svc.mapper_for("doc").parse(sources[i], str(i)))
        shards.append(Searcher([b.freeze()]))
    out = {}
    for dev in (device, "cpu"):
        ctxs = [ShardContext(sh, svc, sims, device=dev) for sh in shards]
        merged = []
        for query in SMALL_BODIES:
            req = parse_search_body({"query": query, "size": 20})
            m = sort_docs(req, [execute_query_phase(c, req, shard_id=i)
                                for i, c in enumerate(ctxs)])
            merged.append((m.total, m.hits))
        out[str(dev)] = merged
    assert out[str(device)] == out["cpu"], "2-shard reduce: card hits differ from cpu hits"
    n_hits = sum(len(h) for _t, h in out["cpu"])
    assert n_hits > 0 and all(t > 0 for t, _h in out["cpu"])
    assert {s for _t, h in out["cpu"] for (_sc, s, _d, _v) in h} == {0, 1}
    return dict(docs=n_docs, queries=len(SMALL_BODIES), hits=n_hits)


def profile_batch(ctx, queries) -> dict:
    """One main-path batch under torch.profiler: host wall time, device busy
    time (kernels and copies, one stream) by name, and the device's idle
    share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from elasticsearch_tpu_torch.search import dispatch_shard_batch

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dispatch_shard_batch(ctx, queries, K).merge()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_busy(prof, wall_ms)


def small_index_check(device, n_docs: int, seed: int) -> dict:
    """About `n_docs` docs through the mapper, analyzer and SegmentBuilder
    into two segments (one tombstone), searched on `device` and on the CPU."""
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.engine import Searcher
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder
    from elasticsearch_tpu_torch.mapper import MapperService
    from elasticsearch_tpu_torch.search import (
        ShardContext, SimilarityService, parse_query, search_shard_batch)

    svc = MapperService(Settings.from_flat(BM25_SETTINGS))
    sources = small_sources(n_docs, seed)
    segs = []
    for g, (lo, hi) in enumerate(((0, n_docs * 2 // 3), (n_docs * 2 // 3, n_docs))):
        b = SegmentBuilder(g)
        for i in range(lo, hi):
            b.add(svc.mapper_for("doc").parse(sources[i], str(i)))
        segs.append(b.freeze())
    segs[0].delete_doc(3)
    queries = [parse_query(b) for b in SMALL_BODIES]
    sims = SimilarityService(Settings.from_flat(BM25_SETTINGS), svc)
    out = {}
    for dev in (device, "cpu"):
        ctx = ShardContext(Searcher(segs), svc, sims, device=dev)
        out[str(dev)] = [(r.total, r.hits) for r in search_shard_batch(ctx, queries, 20)]
    got, want = out[str(device)], out["cpu"]
    assert got == want, "small index: card hits differ from cpu hits"
    n_hits = sum(len(h) for _t, h in want)
    assert n_hits > 0 and all(t > 0 for t, _h in want)
    return dict(docs=n_docs, segments=len(segs), queries=len(queries), hits=n_hits)


def node_corpus(n_docs: int, vocab: int, seed: int):
    """Phase 10's documents: phase 2's generator (zipf(1.35) term ranks over
    `vocab`, poisson(60) terms a doc clipped to [5, 400]) rendered as text of
    tokens `t<rank>`, and the (term, doc) CSR of the whole corpus for exact
    totals. Returns (texts, offsets[vocab + 1], docs)."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.poisson(AVG_LEN, n_docs), 5, 400).astype(np.int64)
    toks = (rng.zipf(ZIPF_A, int(lengths.sum())).astype(np.int64) - 1) % vocab
    names = [term_name(t) for t in range(vocab)]
    bounds = np.concatenate([[0], np.cumsum(lengths)]).tolist()
    tok_list = toks.tolist()
    texts = [" ".join(map(names.__getitem__, tok_list[lo:hi]))
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    del tok_list
    doc_of_tok = np.repeat(np.arange(n_docs, dtype=np.int64), lengths)
    keys = np.unique(toks * n_docs + doc_of_tok)
    offsets = np.zeros(vocab + 1, np.int64)
    np.cumsum(np.bincount(keys // n_docs, minlength=vocab), out=offsets[1:])
    return texts, offsets, (keys % n_docs).astype(np.int64)


def http_json(conn, method: str, path: str, body=None, ndjson: str | None = None):
    """One request on a keep-alive connection: (status, parsed JSON)."""
    if ndjson is not None:
        data, ctype = ndjson.encode(), "application/x-ndjson"
    else:
        data = None if body is None else json.dumps(body).encode()
        ctype = "application/json"
    conn.request(method, path, body=data, headers={"Content-Type": ctype})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def uncached(body: dict) -> dict:
    """A `size: 0` body (one the node's request cache would answer once it
    has seen it) asked to skip the cache: the phases that count each
    request's launches and serving counters send their size-0 bodies so;
    phase 20 measures the cache itself."""
    return {**body, "request_cache": False} if body.get("size") == 0 else body


def http_clients(port: int, bodies: list, n_callers: int, pipe) -> None:
    """Phase 10's HTTP clients, in a process of their own (a search front
    end's connections do not share the node's interpreter): `n_callers`
    threads, each on its own keep-alive connection, send `bodies` as `POST
    /corpus/_search` back to back (caller c sends bodies c, c + n_callers,
    ...); a (path, body) pair goes to its own path. On `pipe`: sends "connected" once every connection is open, waits
    for "go", sends (responses, per-request ms, wall s, errors) when the
    last answer is in, and closes its connections on "close"."""
    import http.client

    n = len(bodies)
    responses, lat_ms, errors = [None] * n, np.zeros(n), []
    connected, start, done = (threading.Barrier(n_callers + 1) for _ in range(3))
    close = threading.Event()

    def caller(c):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            try:  # connect before the clock starts; a failure fails the phase
                conn.connect()
            except OSError as e:
                errors.append((c, repr(e)))
            connected.wait(timeout=120)
            start.wait(timeout=600)
            for i in range(c, n, n_callers):
                t0 = time.perf_counter()
                try:
                    path, body = bodies[i] if isinstance(bodies[i], tuple) \
                        else ("/corpus/_search", bodies[i])
                    responses[i] = http_json(conn, "POST", path, body)
                except Exception as e:  # noqa: BLE001 — every error fails the phase
                    errors.append((i, repr(e)))
                lat_ms[i] = (time.perf_counter() - t0) * 1e3
            done.wait(timeout=900)
            close.wait(timeout=600)
        finally:
            conn.close()

    threads = [threading.Thread(target=caller, args=(c,), daemon=True)
               for c in range(n_callers)]
    for t in threads:
        t.start()
    connected.wait(timeout=120)
    pipe.send("connected")
    assert pipe.recv() == "go"
    start.wait(timeout=600)
    t0 = time.perf_counter()
    done.wait(timeout=900)
    pipe.send((responses, lat_ms, time.perf_counter() - t0, errors))
    assert pipe.recv() == "close"
    close.set()
    for t in threads:
        t.join(timeout=60)


def serve_http(port: int, bodies: list, n_callers: int, sync_error: bool,
               window=None):
    """Run `http_clients` in a process of its own against the node on
    `port`. Returns (responses, per-request ms, wall s, errors, the node
    process's CPU s by thread kind over the run: read while every connection
    and its server thread is still open). `window`, a context manager, is
    entered as the clients start and left as they finish."""
    import contextlib
    import multiprocessing

    import torch

    def recv(conn, proc, timeout: float):
        if not conn.poll(timeout):
            raise TimeoutError(f"the HTTP client process sent nothing in {timeout} s "
                               f"(alive: {proc.is_alive()})")
        return conn.recv()

    ctx = multiprocessing.get_context("spawn")
    here, there = ctx.Pipe()
    proc = ctx.Process(target=http_clients, args=(port, bodies, n_callers, there),
                       daemon=True, name="http-clients")
    proc.start()
    try:
        assert recv(here, proc, 180) == "connected"
        if sync_error:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with window or contextlib.nullcontext():
                cpu_before, process_before = thread_cpu_s(), time.process_time()
                here.send("go")
                responses, lat_ms, wall_s, errors = recv(here, proc, 900)
                host_cpu = host_cpu_split(cpu_before, thread_cpu_s(),
                                          time.process_time() - process_before)
        finally:
            if sync_error:
                torch.cuda.set_sync_debug_mode(0)
        here.send("close")
        proc.join(timeout=60)
        assert proc.exitcode == 0, f"HTTP client process exit code {proc.exitcode}"
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=10)
    return responses, lat_ms, wall_s, errors, host_cpu


def node_phase(device, *, vocab: int, seed: int, n_docs: int, n_requests: int,
               n_callers: int, mixed_requests: int = MIXED_REQUESTS,
               catalog_docs: int = CATALOG_DOCS,
               catalog_requests: int = CATALOG_REQUESTS, write_docs: int = WRITE_DOCS,
               write_requests: int = WRITE_REQUESTS, perc_queries: int = PERC_QUERIES,
               perc_docs: int = PERC_DOCS, perc_node_queries: int = PERC_NODE_QUERIES,
               perc_requests: int = PERC_REQUESTS, runtime: dict | None = None,
               fetch: dict | None = None) -> dict:
    """Phase 10: a port Node on `device` serving REST over HTTP — index
    creation, `_bulk` into each shard's durable Engine, `_refresh`, then
    concurrent `_search` requests checked against exact totals and the
    shards' own `search_shard_batch`, with the kernel launched from the
    node's DeviceBatcher."""
    import http.client

    import torch

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score
    from elasticsearch_tpu_torch.search import (
        SERVING_COUNTERS, ShardContext, parse_query, search_shard_batch)
    from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry

    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    texts, offsets, inv_docs = node_corpus(n_docs, vocab, seed)
    corpus_s = time.perf_counter() - t0
    data_path = Path(__file__).resolve().parent / "build" / f"chip_smoke_node_{os.getpid()}"
    shutil.rmtree(data_path, ignore_errors=True)
    # the node as `python -m elasticsearch_tpu_torch` starts it: every pool
    # at its default size (search: 8 threads, each held by one shard query
    # phase until its batch is merged)
    node = Node(name="smoke", registry=LocalTransportRegistry(), data_path=str(data_path),
                settings={"node.device": str(device)}).start()
    recorder = None
    try:
        port = node.start_http(0).port
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        st, r = http_json(conn, "PUT", "/corpus", {"settings": {"refresh_interval": -1}})
        assert st == 200 and r["acknowledged"], r
        st, health = http_json(conn, "GET", "/_cluster/health")
        assert st == 200 and health["status"] == "yellow" and \
            health["active_primary_shards"] == NODE_SHARDS, health

        # -- load: _bulk over HTTP, then _refresh ---------------------------
        t0 = time.perf_counter()
        for lo in range(0, n_docs, NODE_BULK):
            lines = []
            for i in range(lo, min(lo + NODE_BULK, n_docs)):
                lines.append(json.dumps({"index": {"_index": "corpus", "_type": "doc",
                                                   "_id": str(i)}}))
                lines.append(json.dumps({"body": texts[i]}))
            st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
            assert st == 200 and not r["errors"], (st, r.get("items", [])[:2])
        bulk_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        st, r = http_json(conn, "POST", "/corpus/_refresh")
        assert st == 200 and r["_shards"] == {"total": NODE_SHARDS,
                                              "successful": NODE_SHARDS, "failed": 0}, r
        refresh_s = time.perf_counter() - t0
        conn.close()
        svc = node.indices.index_service("corpus")
        engines = [svc.shard(sid).engine for sid in range(NODE_SHARDS)]
        searchers = [e.acquire_searcher() for e in engines]
        seg_docs = [[s.doc_count for s in sr.segments] for sr in searchers]
        assert sum(map(sum, seg_docs)) == n_docs, seg_docs
        log(f"[10] node on {device}: {n_docs} docs over HTTP in _bulk requests of "
            f"{NODE_BULK} into {NODE_SHARDS} shards: {n_docs / bulk_s:.1f} docs/s "
            f"({bulk_s:.1f} s; text rendered in {corpus_s:.1f} s), _refresh "
            f"{refresh_s:.2f} s; segments per shard {[len(d) for d in seg_docs]}")

        # -- traffic and its references -------------------------------------
        df = np.diff(offsets)
        ranked = np.argsort(-df, kind="stable")
        rng = np.random.default_rng(seed + 1)
        rows = rng.choice(ranked[RANKS[0]: RANKS[1]], size=(n_requests, TERMS_PER_QUERY))
        bodies = [{"query": {"bool": {"should": [{"term": {"body": term_name(int(t))}}
                                                 for t in row]}},
                   "size": NODE_SIZE} for row in rows]
        totals = [int(np.unique(np.concatenate(
            [inv_docs[offsets[t]: offsets[t + 1]] for t in row])).size) for row in rows]
        want = [[] for _ in range(n_requests)]
        for sid, searcher in enumerate(searchers):
            ctx = ShardContext(searcher, svc.mapper_service, svc.similarity_service,
                               device=device)
            for lo in range(0, n_requests, 1024):
                tops = search_shard_batch(ctx, [parse_query(b["query"])
                                                for b in bodies[lo: lo + 1024]], NODE_SIZE)
                for i, td in enumerate(tops, start=lo):
                    want[i].extend((score, sid, doc) for score, doc in td.hits)
        for i, entries in enumerate(want):
            entries.sort(key=lambda e: (-e[0], e[1], e[2]))
            hits = []
            for score, sid, doc in entries[:NODE_SIZE]:
                seg, local = searchers[sid].resolve(doc)
                hits.append((seg.ids[local], score, sid))
            want[i] = hits

        recorder = LaunchRecorder(scoring, sparse_score)
        # first query per shard packs its segments: warm before the timed run
        warm = serve_http(port, bodies[: 2 * n_callers], n_callers, sync_error=False)
        assert not warm[3], warm[3][:3]
        errors_before = SERVING_COUNTERS["device_errors"]
        stats_before = node.search_batcher.stats()
        cudaenv.LAUNCHES.reset()
        responses, lat_ms, wall_s, errors, host_cpu = serve_http(
            port, bodies, n_callers, sync_error=on_card)
        launches = cudaenv.LAUNCHES.snapshot()
        stats = node.search_batcher.stats()
        device_errors = SERVING_COUNTERS["device_errors"] - errors_before

        # correctness, before any time is kept
        assert not errors, f"{len(errors)} requests failed, first {errors[:3]}"
        for i, (st, r) in enumerate(responses):
            assert st == 200, (i, r)
            assert r["_shards"] == SHARDS_OK, (i, r["_shards"])
            assert r["hits"]["total"] == totals[i], \
                f"request {i}: total {r['hits']['total']} != exact {totals[i]}"
            got = [(h["_id"], h["_score"], h["_shard"]) for h in r["hits"]["hits"]]
            assert got == want[i], f"request {i}: hits differ from the shards' reference"
            assert all(h["_source"] == {"body": texts[int(h["_id"])]}
                       for h in r["hits"]["hits"]), f"request {i}: _source"
        if on_card:
            assert launches.get("sparse_score", 0) > 0, \
                "sparse_score never launched in phase 10"
        assert device_errors == 0, f"{device_errors} device errors"
        batches = stats["launches"] - stats_before["launches"]
        items = stats["coalesced"] - stats_before["coalesced"]
        flushes = {f: stats[f"{f}_flushes"] - stats_before[f"{f}_flushes"]
                   for f in ("full", "linger", "deadline", "pending")}
        recorder.close()
        max_err = check_shapes(recorder.shapes)
        out = dict(
            docs=n_docs, shards=NODE_SHARDS, bulk=NODE_BULK, bulk_s=bulk_s,
            bulk_docs_per_s=n_docs / bulk_s, refresh_s=refresh_s,
            segments_per_shard=[len(d) for d in seg_docs],
            requests=n_requests, callers=n_callers,
            search_pool_threads=node.threadpool.stats()["search"]["threads"], wall_s=wall_s,
            requests_per_s=n_requests / wall_s,
            latency_ms=dict(p50=float(np.percentile(lat_ms, 50)),
                            p99=float(np.percentile(lat_ms, 99)),
                            max=float(lat_ms.max()), mean=float(lat_ms.mean())),
            batches=batches, occupancy_mean=items / max(batches, 1), flushes=flushes,
            batch_service_ms=stats["batch"], host_cpu_s=host_cpu,
            bypassed=stats["bypassed"] - stats_before["bypassed"],
            launches=launches, device_errors=device_errors,
            kernel_shapes=len(recorder.shapes), kernel_max_abs_err=max_err,
            sync_debug="error over the whole timed run" if on_card else None)
        log(f"[10] {n_requests} _search requests over HTTP from {n_callers} "
            f"connections (search pool {out['search_pool_threads']} threads): "
            f"{out['requests_per_s']:.1f} requests/s, latency p50 "
            f"{out['latency_ms']['p50']:.2f} ms p99 {out['latency_ms']['p99']:.2f} ms "
            f"max {out['latency_ms']['max']:.2f} ms; every total == the exact count, "
            f"every page == the shards' search_shard_batch reduced (ids, scores, shards)")
        log(f"[10] node batcher: {batches} batches, occupancy mean "
            f"{out['occupancy_mean']:.3f}; flushes {flushes}; bypassed {out['bypassed']}; "
            f"batch service (all runs) p50 {stats['batch']['p50_ms']} ms p99 "
            f"{stats['batch']['p99_ms']} ms; launches {launches}")
        log(f"[10] host CPU s over the {wall_s:.2f} s timed run, by thread kind: "
            + ", ".join(f"{k} {v:.2f} ({v / wall_s:.3f} of wall)"
                        for k, v in host_cpu.items()))
        log(f"[10] sparse_score == plain (bitwise) at all {len(recorder.shapes)} shapes "
            f"phase 10 launched; max abs err {max_err}")
        if on_card:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            before = node.search_batcher.stats()["launches"]
            launches0 = cudaenv.LAUNCHES.snapshot().get("sparse_score", 0)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _r, _l, pwall_s, perrors, pcpu = serve_http(
                    port, bodies[:NODE_PROFILED], n_callers, sync_error=False)
            assert not perrors, perrors[:3]
            out["profiled"] = device_busy(prof, pwall_s * 1e3)
            out["profiled"]["batches"] = node.search_batcher.stats()["launches"] - before
            p = out["profiled"]
            # 17 (b): the staging's host->device copies a sparse_score launch
            # (eight copies a launch before the staging was pooled into one
            # buffer) and the drainer's CPU in the window
            p["sparse_launches"] = (cudaenv.LAUNCHES.snapshot().get("sparse_score", 0)
                                    - launches0)
            p["htod_copies"] = sum(n for name, n in p["copies"].items() if "HtoD" in name)
            p["htod_per_launch"] = p["htod_copies"] / max(p["sparse_launches"], 1)
            p["host_cpu_s"] = pcpu
            if p["device_busy_ms"]:
                log(f"[10] profiled window of {NODE_PROFILED} requests: wall "
                    f"{p['wall_ms']:.2f} ms, device busy {p['device_busy_ms']:.3f} ms, "
                    f"idle share {p['idle_share']:.4f}, {p['batches']} batches")
                for name, ms, n in p["top"]:
                    log(f"[10]   {ms:9.3f} ms {n:5d}x {name}")
                log(f"[17] (b) staging in phase 10's profiled window: {p['htod_copies']} "
                    f"host->device copies for {p['sparse_launches']} sparse_score launches, "
                    f"{p['htod_per_launch']:.3f} a launch ({p['copies']}); drainer CPU "
                    f"{pcpu.get('drainer', 0.0):.2f} s over the {pwall_s:.2f} s window")
                assert p["sparse_launches"] > 0 and p["htod_per_launch"] < 2.0, p["copies"]
            else:
                log("[10] profiled window: the profiler saw no device time "
                    "(device idle share and copies a launch not measured)")
        out["mixed"] = mixed_phase(
            device, node, port, texts=texts, offsets=offsets, inv_docs=inv_docs,
            searchers=searchers, seed=seed + 2, n_requests=mixed_requests,
            n_callers=n_callers)
        out["catalog"] = catalog_phase(
            device, node, port, texts=texts, offsets=offsets, inv_docs=inv_docs,
            seed=seed + 3, n_docs=min(catalog_docs, n_docs),
            n_requests=catalog_requests, n_callers=n_callers)
        out["writes"] = writes_node_phase(
            device, node, port, texts=texts, offsets=offsets, inv_docs=inv_docs,
            seed=seed + 4, n_docs=min(write_docs, n_docs - WRITE_ROUNDS * NODE_BULK),
            n_requests=write_requests, n_callers=n_callers)
        # -- 15. device faults on the card ----------------------------------
        out["faults"] = faults_phase(device, node, port, texts=texts, ranked=ranked,
                                     bool_bodies=bodies, seed=seed + 5)
        if on_card:
            out["sticky"] = sticky_phase(device, texts, bodies)
        else:
            log("[15] (b) the sticky fault needs the card: not run on the CPU")
        # -- 16. the percolator on the card ---------------------------------
        out["percolate"] = percolate_phase(
            device, node, port, texts=texts, ranked=ranked, seed=seed + 6,
            n_queries=perc_queries, n_docs=perc_docs, node_queries=perc_node_queries,
            n_requests=perc_requests)
        # -- 17. restart and serving hygiene --------------------------------
        out["restart"] = restart_phase(device, node, texts=texts, bodies=bodies)
        # -- 20. the search runtime -----------------------------------------
        out["runtime"] = runtime_phase(
            device, node, port, texts=texts, offsets=offsets, inv_docs=inv_docs,
            bodies=bodies, catalog_docs=out["catalog"]["docs"], seed=seed + 20,
            **(runtime or {}))
        # -- 21. fetch: highlighting, suggesters, term vectors ---------------
        out["fetch"] = fetch_phase(device, node, port, texts=texts, bodies=bodies,
                                   seed=seed + 21, **(fetch or {}))
        # -- 24. observing a search on the card -------------------------------
        recorder.shapes.clear()  # its kept inputs would hold corpus packs
        out["observe"] = observe_phase(device, node, port, bodies=bodies)
        # -- 25. the admin REST surface; it ends the node ---------------------
        out["admin"] = admin_phase(device, node, port, texts=texts, bodies=bodies)
        return out
    finally:
        if recorder is not None:
            recorder.close()
        node.close()
        shutil.rmtree(data_path, ignore_errors=True)


def prom_families(text: str) -> dict:
    """The Prometheus text format, line by line: `# TYPE name type` or a
    sample `name{label="v",...} value`, every family's samples one
    contiguous group (a histogram's _bucket, _sum and _count under its
    name). Returns {family: samples}; raises AssertionError otherwise."""
    import re

    sample = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
                        r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? (\S+)$')
    types, counts, seen, current = {}, {}, set(), None
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE"):
            _h, _t, name, typ = line.split()
            assert name not in types and typ in ("counter", "gauge", "histogram"), line
            types[name] = typ
            continue
        m = sample.match(line)
        assert m, f"malformed sample line {line!r}"
        float(m.group(4).replace("+Inf", "inf"))
        name = family = m.group(1)
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and types.get(name[: -len(suffix)]) == "histogram":
                family = name[: -len(suffix)]
        assert family in types, f"sample of untyped family {family}"
        if family != current:
            assert family not in seen, f"family {family} interleaved"
            seen.add(family)
            current = family
        counts[family] = counts.get(family, 0) + 1
    return counts


def observe_phase(device, node, port: int, *, bodies,
                  n_profiled: int = OBS_PROFILED, n_traced: int = OBS_TRACED,
                  n_conn: int = OBS_CONN, n_window: int = OBS_WINDOW) -> dict:
    """Phase 24, on phase 10's node before it closes: observing a search on
    the card. (a) `n_profiled` of phase 10's `bool` bodies with
    `?profile=true` from one connection (a shard's event pairs time what the
    one stream runs between its records, so concurrent profiled requests
    would time each other's kernels): hits equal to the unprofiled answer,
    every shard's
    profile `device_sparse` with its segments, its device phase timed by
    CUDA events (every DeviceClock read on the card, one pair a launch);
    the per-phase split at p50 and the device phase a launch against the
    kernel's own time at the shapes launched. (b) `n_traced` bodies from
    `n_conn` connections at `search.trace.sample_rate` 0.0, then 1.0:
    requests/s of each and their ratio; each leg waits once a batch
    (`PendingPull.wait` counted against the batcher's batches) and never
    calls `torch.cuda.synchronize`; every `rest` trace in `/_traces` holds
    the chain rest → coordinator → transport → shard → batcher.queue →
    batcher.dispatch → batcher.merge → device_pull, each device_pull span
    exactly a pull window its batch's merge stamped. (c) `/_nodes/stats`
    twice (monotone counters), `/_prometheus/metrics` under the text
    grammar, `/_insights/queries` holding the traffic's shape with every
    shard phase counted, and the ledger's resident bytes of `corpus`
    against `torch.cuda.memory_allocated()` when its packs are dropped and
    packed again. (d) `torch.profiler` through the REST routes: `n_window`
    warm-up searches, a sentinel kernel (`torch.cuda._sleep`), then
    `n_window` searches whose launches are counted: the Chrome trace's
    `sparse_score` kernel events after the sentinel equal them (on phase
    10's node a capture loses its first kernel records, PERF.md §7). `sparse_score` against its
    plain version at every shape the phase launched."""
    import http.client

    import torch

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.common import profile as tprofile
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.device_index import (
        drop_segment_packs, pack_cache_key)
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score
    from elasticsearch_tpu_torch.search import execute as texecute

    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    out: dict = {}
    launches: dict = {}
    recorder = LaunchRecorder(scoring, sparse_score, copy_inputs=True)

    def take() -> dict:
        snap = cudaenv.LAUNCHES.snapshot()
        cudaenv.LAUNCHES.reset()
        for name, n in snap.items():
            launches[name] = launches.get(name, 0) + n
        return snap

    def search_reqs(bs, params=""):
        return [("POST", f"/corpus/_search{params}", b, None) for b in bs]

    try:
        cudaenv.LAUNCHES.reset()  # what earlier phases launched is not this one's
        # -- (a) profiled searches ---------------------------------------------
        chosen = bodies[:n_profiled]
        plain, _l, _w = http_requests(port, search_reqs(chosen), n_conn)
        clocks = []
        orig_elapsed = tprofile.DeviceClock.elapsed_s

        def elapsed(clock):
            s = orig_elapsed(clock)
            clocks.append((clock.cuda, clock.launches, len(clock._pairs)))
            return s

        tprofile.DeviceClock.elapsed_s = elapsed
        try:
            take()
            # one connection: a shard's event pairs share the stream with
            # whatever other threads launch between its records, so
            # concurrent profiled traffic would time its neighbours' kernels
            prof_resp, prof_lat, prof_wall = http_requests(
                port, search_reqs(chosen, "?profile=true"), 1)
            prof_launches = take().get("sparse_score", 0)
        finally:
            tprofile.DeviceClock.elapsed_s = orig_elapsed
        phases: dict = {}
        per_launch = []
        for i, ((st0, p), (st1, r)) in enumerate(zip(plain, prof_resp)):
            assert st0 == st1 == 200 and r["_shards"] == SHARDS_OK, (i, r)
            assert r["hits"] == p["hits"], f"profiled request {i}: hits differ"
            shards = r["profile"]["shards"]
            assert sorted(s["shard"] for s in shards) == list(range(NODE_SHARDS)), i
            for s in shards:
                assert s["plan"]["outcome"] == "device_sparse", (i, s["plan"])
                assert s["segments"] and s["batcher"] == {"bypassed": True,
                                                          "reason": "profile"}
                assert all(seg["path"] == ("sparse_fused" if on_card else "sparse_composed")
                           for seg in s["segments"]), s["segments"]
                for name, ms in s["phases_ms"].items():
                    phases.setdefault(name, []).append(ms)
                n = sum(seg["buckets"] for seg in s["segments"])
                if n:
                    per_launch.append(s["phases_ms"]["device"] / n)
        assert clocks and len(clocks) == n_profiled * NODE_SHARDS, len(clocks)
        if on_card:
            # every clock timed its launches with a CUDA event pair each
            assert all(cuda and pairs == n_l > 0 for cuda, n_l, pairs in clocks), clocks[:4]
            assert prof_launches > 0
        kernel_ms = []
        for args, kwargs, n_l in recorder.shapes.values():
            kernel_ms.append((time_ms(lambda a=args, k=kwargs: sparse_score(*a, **k),
                                      device, 20), n_l))
        own = (sum(ms * n for ms, n in kernel_ms) / max(sum(n for _m, n in kernel_ms), 1)
               if kernel_ms else None)
        split = {k: float(np.percentile(v, 50)) for k, v in phases.items()}
        out["profiled"] = dict(requests=n_profiled, wall_s=prof_wall,
                               p50_ms=float(np.percentile(prof_lat, 50)),
                               phases_p50_ms=split, launches=prof_launches,
                               device_ms_a_launch_p50=float(np.percentile(per_launch, 50)),
                               kernel_ms_a_launch=own, clocks=len(clocks))
        log(f"[24] (a) {n_profiled} of phase 10's bool bodies with ?profile=true from "
            f"one connection: every page == the unprofiled answer; every shard "
            f"device_sparse, its device phase timed by "
            + ("CUDA events (one pair a launch)" if on_card else "perf_counter")
            + f"; {prof_launches} sparse_score launches; phases p50 (ms) "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
        log(f"[24] (a) device phase a launch p50 {out['profiled']['device_ms_a_launch_p50']:.4f}"
            f" ms against the kernel's own {own if own is None else round(own, 4)} ms at the "
            f"{len(kernel_ms)} shapes launched (CUDA events, 20 reps a shape)")

        # -- (b) traced against untraced ---------------------------------------
        waits, syncs, windows = [0], [0], []
        lock = threading.Lock()
        orig_wait = cudaenv.PendingPull.wait
        orig_sync = torch.cuda.synchronize
        orig_merge = texecute._PendingFlat.merge

        def counted_wait(self):
            with lock:
                waits[0] += 1
            return orig_wait(self)

        def counted_sync(*a, **k):
            with lock:
                syncs[0] += 1
            return orig_sync(*a, **k)

        def stamped_merge(self):
            res = orig_merge(self)
            with lock:
                windows.append((self.pull_t0, self.pull_t1))
            return res

        traced = bodies[:n_traced]
        legs = {}
        old_rate = node.tracer.sample_rate
        cudaenv.PendingPull.wait = counted_wait
        torch.cuda.synchronize = counted_sync
        texecute._PendingFlat.merge = stamped_merge
        try:
            for rate in (0.0, 1.0):
                node.tracer.sample_rate = rate
                waits[0] = syncs[0] = 0
                b0 = node.search_batcher.stats()["launches"]
                s0 = node.tracer.stats()["sampled"]
                take()
                got, lat, wall = http_requests(port, search_reqs(traced), n_conn)
                sparse = take().get("sparse_score", 0)
                batches = node.search_batcher.stats()["launches"] - b0
                for i, (st, r) in enumerate(got):
                    assert st == 200 and r["_shards"] == SHARDS_OK, (rate, i, r)
                legs[rate] = dict(requests_per_s=n_traced / wall, wall_s=wall,
                                  p50_ms=float(np.percentile(lat, 50)),
                                  p99_ms=float(np.percentile(lat, 99)),
                                  waits=waits[0], batches=batches, syncs=syncs[0],
                                  sampled=node.tracer.stats()["sampled"] - s0,
                                  sparse_launches=sparse)
                assert waits[0] == batches > 0 and syncs[0] == 0, legs[rate]
        finally:
            node.tracer.sample_rate = old_rate
            cudaenv.PendingPull.wait = orig_wait
            torch.cuda.synchronize = orig_sync
            texecute._PendingFlat.merge = orig_merge
        assert legs[0.0]["sampled"] == 0 and legs[1.0]["sampled"] >= n_traced
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        st, tr = http_json(conn, "GET", "/_traces")
        assert st == 200
        window_set = set(windows)
        rest_traces = [t for t in tr["traces"] if t["name"] == "rest"]
        assert rest_traces
        chain = ("rest", "coordinator", "transport[indices:data/read/search[phase/query]]",
                 "shard", "batcher.queue", "batcher.dispatch", "batcher.merge", "device_pull")
        pulls = 0
        for t in rest_traces:
            by_id = {s["id"]: s for s in t["spans"]}
            names = {s["name"] for s in t["spans"]}
            assert set(chain) <= names, (t["trace_id"], sorted(names))
            for s in t["spans"]:
                if s["name"] != "device_pull":
                    continue
                merge = by_id[s["parent"]]
                assert merge["name"] == "batcher.merge"
                assert by_id[merge["parent"]]["name"] == "shard"
                assert (s["t0"], s["t1"]) in window_set, "device span off its pull window"
                assert merge["t0"] <= s["t0"] <= s["t1"] <= merge["t1"]
                pulls += 1
        ratio = legs[1.0]["requests_per_s"] / legs[0.0]["requests_per_s"]
        out["traced"] = dict(untraced=legs[0.0], traced=legs[1.0], ratio=ratio,
                             rest_traces_checked=len(rest_traces), device_spans=pulls)
        for rate, leg in legs.items():
            log(f"[24] (b) sample rate {rate}: {n_traced} requests from {n_conn} "
                f"connections, {leg['requests_per_s']:.1f} requests/s, p50 "
                f"{leg['p50_ms']:.2f} ms p99 {leg['p99_ms']:.2f} ms; {leg['batches']} "
                f"batches, {leg['waits']} PendingPull.wait calls, {leg['syncs']} "
                f"torch.cuda.synchronize calls, {leg['sampled']} traces sampled")
        log(f"[24] (b) traced/untraced requests/s {ratio:.4f}; {len(rest_traces)} rest "
            f"traces in /_traces hold the chain {' -> '.join(chain)}; each of their "
            f"{pulls} device spans is a pull window its batch's merge stamped")

        # -- (d) the device profiler -------------------------------------------
        st, r = http_json(conn, "POST", "/_nodes/_local/profiler/start")
        assert st == 200 and r["started"], r
        try:
            st2, r2 = http_json(conn, "POST", "/_nodes/_local/profiler/start")
            assert st2 == 400, r2
            # the window follows a warm-up inside the capture and a sentinel
            # kernel: on this node a capture's first kernel records are lost
            # (PERF.md §7), so the window is the kernels after the sentinel
            take()
            http_requests(port, search_reqs(bodies[n_window: 2 * n_window]), 4)
            warm_launches = take().get("sparse_score", 0)
            if on_card:
                torch.cuda._sleep(1000)
            got, _lat, pwall = http_requests(port, search_reqs(bodies[:n_window]), 4)
            counted = take()
            window_launches = counted.get("sparse_score", 0)
            assert all(s == 200 for s, _r in got)
        finally:
            st, r = http_json(conn, "POST", "/_nodes/_local/profiler/stop")
        assert st == 200 and r["stopped"] and r["files"], r
        with open(r["files"][0]) as fh:
            events = json.load(fh)["traceEvents"]
        captured = [e for e in events if e.get("cat") == "kernel"
                    and "sparse_score" in str(e.get("name"))]
        sentinel = [e["ts"] for e in events if e.get("cat") == "kernel"
                    and "spin_kernel" in str(e.get("name"))]
        if on_card:
            assert len(sentinel) == 1, f"{len(sentinel)} sentinel kernels in the trace"
        kernels = [e for e in captured if not sentinel or e["ts"] > sentinel[0]]
        by_symbol: dict = {}
        for e in kernels:
            by_symbol[e["name"]] = by_symbol.get(e["name"], 0) + 1
        trace_bytes = os.path.getsize(r["files"][0])
        shutil.rmtree(r["dir"], ignore_errors=True)
        st, r = http_json(conn, "POST", "/_nodes/_local/profiler/stop")
        assert st == 400, r
        out["profiler"] = dict(searches=n_window, wall_s=pwall, launches=window_launches,
                               counted=counted, kernel_events=len(kernels),
                               trace_bytes=trace_bytes, by_symbol=by_symbol,
                               capture_launches=warm_launches + window_launches,
                               capture_kernel_events=len(captured))
        log(f"[24] (d) torch.profiler over {n_window} warm-up and {n_window} window "
            f"searches: {len(kernels)} sparse_score kernel events after the sentinel in "
            f"the Chrome trace ({trace_bytes} B), {window_launches} launches counted over "
            f"the window ({counted}); by symbol {by_symbol}; the whole capture held "
            f"{len(captured)} of {warm_launches + window_launches} launches")
        if on_card:
            assert len(kernels) == window_launches > 0, (len(kernels), window_launches)

        # -- (c) stats against the card ----------------------------------------
        st, s1 = http_json(conn, "GET", "/_nodes/stats")
        assert st == 200
        http_requests(port, search_reqs(bodies[:8]), 4)
        st, s2 = http_json(conn, "GET", "/_nodes/stats")
        (a,), (b,) = s1["nodes"].values(), s2["nodes"].values()
        monotone = [
            ("transport.tx_count", lambda x: x["transport"]["tx_count"]),
            ("transport.rx_count", lambda x: x["transport"]["rx_count"]),
            ("search.latency.count", lambda x: x["search"]["latency"]["count"]),
            ("search.batcher.launches", lambda x: x["search"]["batcher"]["launches"]),
            ("search.batcher.coalesced", lambda x: x["search"]["batcher"]["coalesced"]),
            ("search_serving.device_sparse", lambda x: x["search_serving"]["device_sparse"]),
            ("tracing.finished", lambda x: x["tracing"]["finished"]),
            ("thread_pool.search.completed",
             lambda x: x["thread_pool"]["search"]["completed"]),
            ("device.kernels.launches", lambda x: sum(x["device"]["kernels"]["launches"]
                                                      .values()))]
        for name, get in monotone:
            assert get(b) >= get(a), (name, get(a), get(b))
        assert b["search"]["latency"]["count"] > a["search"]["latency"]["count"]
        st, _h = http_json(conn, "GET", "/_nodes/stats/bogus")
        assert st == 400
        conn.request("GET", "/_prometheus/metrics")
        resp = conn.getresponse()
        prom = resp.read().decode()
        assert resp.status == 200
        families = prom_families(prom)
        assert families["estpu_cuda_kernel_launches_total"] >= 1
        assert "estpu_jax_compile_events_total" not in families
        sid, _shape = node.insights.fingerprint(bodies[0])
        expect = {node.insights.fingerprint(bd)[0] for bd in bodies[:n_traced]}
        st, ins = http_json(conn, "GET", "/_insights/queries?size=1000")
        assert st == 200
        shapes = {e["shape_id"]: e for e in ins["shapes"]}
        assert expect == {sid} and sid in shapes, (expect, list(shapes)[:5])
        assert shapes[sid]["outcomes"].get("device_sparse", 0) >= \
            (2 * n_profiled + 2 * n_traced + n_window + 8) * NODE_SHARDS
        # the ledger's resident bytes of `corpus` against the allocator: drop
        # the packs, then pack them again with one search
        st, dev = http_json(conn, "GET", "/_nodes/stats/device")
        ledger = next(iter(dev["nodes"].values()))["device"]["indices"]["corpus"]
        svc = node.indices.index_service("corpus")
        segs = [seg for sid_ in range(NODE_SHARDS)
                for seg in svc.shard(sid_).engine.acquire_searcher().segments]
        recorder.close()
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_allocated(device) if on_card else 0
        drop_segment_packs(segs)
        for seg in segs:
            node.filter_cache.clear_segment(seg)
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
        alloc1 = torch.cuda.memory_allocated(device) if on_card else 0
        assert not any(seg._device_cache.get(pack_cache_key(device)) for seg in segs)
        got, _lat, _w = http_requests(port, search_reqs(bodies[:1]), 1)
        assert got[0][0] == 200
        if on_card:
            torch.cuda.synchronize()
        alloc2 = torch.cuda.memory_allocated(device) if on_card else 0
        st, dev = http_json(conn, "GET", "/_nodes/stats/device")
        ledger2 = next(iter(dev["nodes"].values()))["device"]["indices"]["corpus"]
        conn.close()
        released, packed = alloc0 - alloc1, alloc2 - alloc1
        out["resident"] = dict(
            ledger_bytes=ledger["total_bytes"], ledger_tiers=ledger["totals"],
            released_bytes=released, repacked_ledger_bytes=ledger2["total_bytes"],
            repacked_bytes=packed,
            release_ratio=(ledger["total_bytes"] / released) if released else None,
            repack_ratio=(ledger2["total_bytes"] / packed) if packed else None)
        res = out["resident"]
        if on_card:
            assert 0.9 <= res["repack_ratio"] <= 1.1, res
        log(f"[24] (c) /_nodes/stats twice: {len(monotone)} counters monotone; "
            f"/_prometheus/metrics parses ({len(families)} families, each one contiguous "
            f"group, estpu_cuda_kernel_* present, no estpu_jax_*); /_insights/queries "
            f"holds the traffic's shape {sid} ({shapes[sid]['count']} shard phases)")
        log(f"[24] (c) corpus resident by the ledger {res['ledger_bytes']} B "
            f"{res['ledger_tiers']}; memory_allocated() released {released} B when its "
            f"packs dropped (ledger/released "
            f"{'not measured' if res['release_ratio'] is None else round(res['release_ratio'], 4)}"
            f"), grew {packed} B when one search packed them again against the ledger's "
            f"{res['repacked_ledger_bytes']} B (ledger/allocated "
            f"{'not measured' if res['repack_ratio'] is None else round(res['repack_ratio'], 4)})")
        out["kernel_shapes"] = [dict(Qb=k[0][0], TB=k[0][1], k=k[2], launches=v[2])
                                for k, v in recorder.shapes.items()]
        out["kernel_max_abs_err"] = check_shapes(recorder.shapes)
        take()
        out["launches"] = launches
        out["wall_s"] = time.perf_counter() - t_phase
        log(f"[24] sparse_score == plain (bitwise) at all {len(recorder.shapes)} shapes "
            f"phase 24 launched ({launches.get('sparse_score', 0)} launches); max abs err "
            f"{out['kernel_max_abs_err']}; phase 24 took {out['wall_s']:.1f} s")
        return out
    finally:
        recorder.close()


def http_raw(conn, method: str, path: str, data: bytes | None = None,
             ctype: str | None = None):
    """One request of raw bytes on a keep-alive connection: (status,
    Content-Type, body bytes)."""
    conn.request(method, path, body=data, headers={"Content-Type": ctype} if ctype else {})
    resp = conn.getresponse()
    return resp.status, resp.getheader("Content-Type"), resp.read()


def cat_text(port: int, path: str) -> str:
    """A `_cat` route's answer, which must be 200 `text/plain`."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        st, ctype, raw = http_raw(conn, "GET", path)
    finally:
        conn.close()
    assert (st, ctype) == (200, "text/plain"), (path, st, ctype, raw[:300])
    return raw.decode()


def cat_numbers(port: int, path: str) -> list[float]:
    """The one row of a `_cat` table read with `?h=`, as numbers."""
    return [float(c) for c in cat_text(port, path).split()]


def refuses(port: int) -> bool:
    import socket

    try:
        socket.create_connection(("127.0.0.1", port), timeout=1).close()
    except OSError:
        return True
    return False


def admin_phase(device, node, port: int, *, texts, bodies,
                n_burst: int = ADMIN_BURST, n_formats: int = ADMIN_FORMATS) -> dict:
    """Phase 25, on phase 10's node after phase 24, which it ends: the admin
    REST surface on a node whose packs are on the card. (a) `/_cat` and
    every route it lists (200 `text/plain`); the `_cat_table` routes with
    `?v`, `?help` and `?h=` of two aliases; `_cat/segments/corpus` packed,
    its resident bytes (from `/_segments`) equal to the ledger's postings
    and dense-plane tiers; `_cat/batcher` across a burst of `n_burst`
    `bool` bodies from ADMIN_CONN connections; `_cat/health` through an
    open `pull:corpus` domain and its recovery; `_cat/caches` request hits
    on a repeated size-0 body. (b) `_cluster/settings` arming and disarming
    the slowlog, `_cluster/stats` against `_count`, `_cluster/state` of one
    index, `pending_tasks`, a reroute with no commands. (c) `n_formats`
    bodies as SMILE and as CBOR bodies and with `?format=` smile, cbor and
    yaml: the JSON answer's hits. (d) the lock tracer in a child process.
    (e) `_shutdown` of the node: its HTTP port and the batcher's drainer
    stop within ADMIN_SHUTDOWN_S; `torch.cuda.memory_allocated()` before
    and after beside the ledger's resident bytes. `sparse_score` against
    its plain version at every shape the phase launched."""
    import http.client
    import logging

    import torch

    from elasticsearch_tpu_torch.common import cudaenv, xcontent
    from elasticsearch_tpu_torch.common.devicehealth import CLOSED, DEVICE_HEALTH
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score
    from elasticsearch_tpu_torch.search import SERVING_COUNTERS
    from elasticsearch_tpu_torch.transport.faults import DEVICE_FAULTS

    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    out: dict = {}
    launches: dict = {}
    recorder = LaunchRecorder(scoring, sparse_score, copy_inputs=True)

    def take() -> dict:
        snap = cudaenv.LAUNCHES.snapshot()
        cudaenv.LAUNCHES.reset()
        for name, n in snap.items():
            launches[name] = launches.get(name, 0) + n
        return snap

    def search_reqs(bs, params=""):
        return [("POST", f"/corpus/_search{params}", b, None) for b in bs]

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    counted0 = dict(SERVING_COUNTERS)
    try:
        cudaenv.LAUNCHES.reset()  # what earlier phases launched is not this one's
        # -- (a) _cat ----------------------------------------------------------
        t0 = time.perf_counter()
        listing = [ln.split("/_cat/")[1] for ln in cat_text(port, "/_cat").splitlines()]
        assert set(ADMIN_CAT_TABLES) < set(listing), listing
        for route in listing:
            cat_text(port, f"/_cat/{route}")
        for route in ADMIN_CAT_TABLES:
            help_rows = [ln.split(" | ") for ln in
                         cat_text(port, f"/_cat/{route}?help").splitlines()]
            names = [r[0] for r in help_rows]
            header = cat_text(port, f"/_cat/{route}?v").splitlines()[0].split()
            # thread_pool's default view is a part of its columns
            assert header == names or (route == "thread_pool" and set(header) < set(names)), \
                (route, header, names)
            aliases = [r[1] for r in help_rows if r[1] != r[0]][:2]
            got = cat_text(port, f"/_cat/{route}?v&h={','.join(aliases)}")
            assert got.splitlines()[0].split() == aliases, (route, aliases, got)
        seg_rows = [ln.split() for ln in
                    cat_text(port, "/_cat/segments/corpus?v").splitlines()]
        col = seg_rows[0].index("packed")
        assert seg_rows[1:] and all(r[col] == "true" for r in seg_rows[1:]), seg_rows[:3]
        st, segs = http_json(conn, "GET", "/corpus/_segments")
        assert st == 200
        resident = sum(seg["device"]["resident_bytes"]
                       for shard in segs["indices"]["corpus"]["shards"].values()
                       for copy in shard for seg in copy["segments"].values())
        st, stats = http_json(conn, "GET", "/corpus/_stats")
        tiers = stats["indices"]["corpus"]["device"]["totals"]
        assert resident == tiers["postings"] + tiers["dense_plane"], (resident, tiers)
        assert len(seg_rows) - 1 == sum(len(copy["segments"]) for shard in
                                        segs["indices"]["corpus"]["shards"].values()
                                        for copy in shard)
        cat_s = time.perf_counter() - t0
        # the batcher across a burst
        take()
        b0 = cat_numbers(port, "/_cat/batcher?h=launches,coalesced,bypassed")
        burst, _lat, burst_wall = http_requests(port, search_reqs(bodies[:n_burst]),
                                                ADMIN_CONN)
        b1 = cat_numbers(port, "/_cat/batcher?h=launches,coalesced,bypassed")
        burst_launches = take()
        for i, (st, r) in enumerate(burst):
            assert st == 200 and r["_shards"] == SHARDS_OK, (i, r.get("_shards", r))
        d_launch, d_items, d_bypass = (int(b - a) for a, b in zip(b0, b1))
        assert d_items == n_burst * NODE_SHARDS - d_bypass and d_bypass == 0, (b0, b1)
        assert 0 < d_launch <= d_items, (b0, b1)
        kernel_launches = (burst_launches.get("sparse_score.smem", 0)
                           + burst_launches.get("sparse_score.global", 0))
        if on_card:
            assert kernel_launches >= d_launch, (burst_launches, d_launch)
        out["batcher"] = dict(requests=n_burst, batches=d_launch, coalesced=d_items,
                              occupancy=d_items / d_launch, wall_s=burst_wall,
                              requests_per_s=n_burst / burst_wall,
                              sparse_score=kernel_launches)
        log(f"[25] (a) /_cat lists {len(listing)} routes, each 200 text/plain; the "
            f"{len(ADMIN_CAT_TABLES)} tables' ?v headers name their ?help columns and "
            f"?h= takes aliases ({cat_s:.2f} s); _cat/segments/corpus: "
            f"{len(seg_rows) - 1} segments all packed, their resident bytes {resident} B "
            f"== the ledger's postings + dense_plane tiers")
        log(f"[25] (a) _cat/batcher across {n_burst} searches from {ADMIN_CONN} "
            f"connections ({out['batcher']['requests_per_s']:.1f} requests/s): coalesced "
            f"+{d_items} (= {n_burst} x {NODE_SHARDS} shards), launches +{d_launch} "
            f"(occupancy {d_items / d_launch:.2f}), sparse_score smem+global +"
            f"{kernel_launches}")
        # health through an open fault domain
        health = [cat_text(port, "/_cat/health").split()[-1]]
        assert health[0] == "device_ok", health
        window0 = dict(SERVING_COUNTERS)
        DEVICE_FAULTS.arm(error="transfer", domain="pull:corpus", times=10 ** 6)
        try:
            got, _l, _w = http_requests(port, search_reqs(bodies[:1]), 1)
            assert got[0][0] == 200 and got[0][1]["_shards"]["degraded"] >= 1, got[0]
            health.append(cat_text(port, "/_cat/health").split()[-1])
            assert health[1] == "device_degraded:pull:corpus", health
        finally:
            DEVICE_FAULTS.disarm()
        t_dis = time.perf_counter()
        while DEVICE_HEALTH.state("pull:corpus") != CLOSED:
            assert time.perf_counter() - t_dis < RECOVER_S, DEVICE_HEALTH.stats()
            http_requests(port, search_reqs(bodies[:1]), 1)
        recover_s = time.perf_counter() - t_dis
        health.append(cat_text(port, "/_cat/health").split()[-1])
        assert health[2] == "device_ok", health
        DEVICE_HEALTH.reset()
        # the armed window's degrades: the run holds every degrade of the
        # process to the phases that arm faults
        window = {k: SERVING_COUNTERS[k] - window0[k] for k in ("degraded", "device_errors")}
        # the request cache's hits on a repeated size-0 body
        c0 = cat_numbers(port, "/_cat/caches?h=hits")
        zero = {"query": bodies[0]["query"], "size": 0}
        for _ in range(2):
            st, r = http_json(conn, "POST", "/corpus/_search", zero)
            assert st == 200, r
        c1 = cat_numbers(port, "/_cat/caches?h=hits")
        assert c1[0] - c0[0] >= NODE_SHARDS and c1[1] == c0[1], (c0, c1)
        out["cat"] = dict(routes=listing, tables=list(ADMIN_CAT_TABLES), wall_s=cat_s,
                          segments=len(seg_rows) - 1, resident_bytes=resident,
                          health=health, recover_s=recover_s,
                          request_cache_hits=int(c1[0] - c0[0]))
        log(f"[25] (a) _cat/health {health[0]} -> {health[1]} while the domain is open "
            f"-> {health[2]} {recover_s:.3f} s after the disarm; _cat/caches request "
            f"hits +{int(c1[0] - c0[0])} on a repeated size-0 body")

        # -- (b) _cluster/* ----------------------------------------------------
        key = "index.search.slowlog.threshold.query.warn"
        lines = {}

        class Capture(logging.Handler):
            def __init__(self):
                super().__init__()
                self.n = 0

            def emit(self, record):
                self.n += "slowlog" in record.getMessage()

        settings = {}
        for value in ("0ms", "1h"):
            st, r = http_json(conn, "PUT", "/_cluster/settings",
                              {"transient": {key: value}})
            assert st == 200 and r["acknowledged"], r
            st, settings[value] = http_json(conn, "GET", "/_cluster/settings")
            assert settings[value]["transient"]["index"]["search"]["slowlog"][
                "threshold"]["query"]["warn"] == value, settings[value]
            handler = Capture()
            logging.getLogger("estpu_torch.action").addHandler(handler)
            try:
                st, r = http_json(conn, "POST", "/corpus/_search", bodies[1])
            finally:
                logging.getLogger("estpu_torch.action").removeHandler(handler)
            assert st == 200
            lines[value] = handler.n
        assert lines == {"0ms": NODE_SHARDS, "1h": 0}, lines
        st, flat = http_json(conn, "GET", "/_cluster/settings?flat_settings=true")
        assert flat["transient"] == {key: "1h"}, flat
        st, cstats = http_json(conn, "GET", "/_cluster/stats")
        assert st == 200
        names = sorted(node.cluster_service.state.metadata.index_names())
        counts = {n: http_json(conn, "GET", f"/{n}/_count")[1]["count"] for n in names}
        assert cstats["indices"]["docs"]["count"] == sum(counts.values()), (cstats, counts)
        assert cstats["indices"]["count"] == len(names)
        st, one = http_json(conn, "GET", "/_cluster/state/metadata,routing_table/corpus")
        assert st == 200 and list(one["metadata"]["indices"]) == ["corpus"] and \
            list(one["routing_table"]["indices"]) == ["corpus"], list(one)
        st, tasks = http_json(conn, "GET", "/_cluster/pending_tasks")
        assert st == 200 and tasks == {"tasks": []}, tasks
        st, before = http_json(conn, "GET", "/_cluster/state/routing_table")
        st, rr = http_json(conn, "POST", "/_cluster/reroute")
        assert st == 200 and rr["acknowledged"], rr
        st, after = http_json(conn, "GET", "/_cluster/state/routing_table")
        assert after["routing_table"] == before["routing_table"]
        out["cluster"] = dict(slowlog_lines=lines, docs=cstats["indices"]["docs"],
                              indices=counts, state_version=rr["state_version"])
        log(f"[25] (b) PUT _cluster/settings transient {key}: 0ms -> {lines['0ms']} "
            f"slowlog lines on the next search (one a shard), 1h -> {lines['1h']}; "
            f"_cluster/stats docs.count {cstats['indices']['docs']['count']} == the sum "
            f"of _count over {len(names)} indexes; _cluster/state of corpus alone; "
            f"pending_tasks empty; reroute acknowledged, routing unchanged")

        # -- (c) content formats -----------------------------------------------
        chosen = bodies[2: 2 + n_formats]
        plain, _l, _w = http_requests(port, search_reqs(chosen), ADMIN_CONN)
        want = [[(h["_id"], h["_score"]) for h in r["hits"]["hits"]] for _st, r in plain]
        try:
            import yaml  # noqa: F401 — the YAML leg needs PyYAML
            yaml_ok = True
        except ImportError:
            yaml_ok = False
        legs = [("smile body", xcontent.SMILE, ""), ("cbor body", xcontent.CBOR, ""),
                ("?format=smile", xcontent.SMILE, "?format=smile"),
                ("?format=cbor", xcontent.CBOR, "?format=cbor")]
        if yaml_ok:
            legs.append(("?format=yaml", xcontent.YAML, "?format=yaml"))
        formats = {}
        for name, fmt, params in legs:
            if name.endswith("body"):
                def send(c, i, fmt=fmt):
                    return http_raw(c, "POST", "/corpus/_search",
                                    xcontent.dumps(chosen[i], fmt),
                                    xcontent.CONTENT_TYPES[fmt])
            else:
                def send(c, i, params=params):
                    return http_raw(c, "POST", f"/corpus/_search{params}",
                                    json.dumps(chosen[i]).encode(), "application/json")
            answers, _lat, wall = pooled_requests(port, len(chosen), ADMIN_CONN, send)
            for i, (st, ctype, raw) in enumerate(answers):
                assert (st, ctype) == (200, xcontent.CONTENT_TYPES[fmt]), (name, i, st, raw[:200])
                r = xcontent.loads(raw, fmt)
                got = [(h["_id"], h["_score"]) for h in r["hits"]["hits"]]
                assert got == want[i], (name, i)
            formats[name] = dict(requests=len(chosen), wall_s=wall)
        if not yaml_ok:
            st, ctype, raw = http_raw(conn, "POST", "/corpus/_search?format=yaml",
                                      json.dumps(chosen[0]).encode(), "application/json")
            err = json.loads(raw)
            assert st == 500 and err["error"]["type"] == "serialization_exception", raw
            st, ctype, raw = http_raw(conn, "POST", "/corpus/_search", b"query: {}",
                                      "application/yaml")
            err = json.loads(raw)
            assert st == 400 and err["error"]["type"] == "parse_exception", raw
        out["formats"] = dict(legs=formats, yaml="served" if yaml_ok else
                              "PyYAML missing: ?format=yaml 500 serialization_exception, "
                              "a YAML body 400 parse_exception")
        log(f"[25] (c) {len(chosen)} bool bodies each way "
            + ", ".join(f"{k} {v['requests'] / v['wall_s']:.1f}/s" for k, v in formats.items())
            + f": every answer's ids and scores bitwise the JSON answer's; YAML: "
            f"{out['formats']['yaml']}")

        # -- (d) the lock tracer on the card, in a child -----------------------
        out["locktrace"] = locktrace_phase(device, texts, bodies)

        counted = {k: SERVING_COUNTERS[k] - counted0[k] for k in ("degraded", "device_errors")}
        assert counted == window and counted["degraded"] >= NODE_SHARDS, (counted, window)
        out["counted"] = counted
        # the phase's kernel shapes against the plain version, before the
        # shutdown (the recorder's copies must not count as resident)
        out["kernel_shapes"] = [dict(Qb=k[0][0], TB=k[0][1], k=k[2], launches=v[2])
                                for k, v in recorder.shapes.items()]
        out["kernel_max_abs_err"] = check_shapes(recorder.shapes)
        recorder.close()
        recorder.shapes.clear()
        take()

        # -- (e) shutdown ------------------------------------------------------
        st, dev = http_json(conn, "GET", "/_nodes/stats/device")
        ledger = next(iter(dev["nodes"].values()))["device"]
        drainer = node.search_batcher.drainer_thread
        assert drainer is not None and drainer.is_alive()
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_allocated(device) if on_card else 0
        st, r = http_json(conn, "POST", "/_cluster/nodes/_local/_shutdown")
        t_shut = time.perf_counter()
        assert st == 200 and r["nodes"] == {node.node_id: {"name": node.name}}, r
        conn.close()
        while not (refuses(port) and not drainer.is_alive()):
            assert time.perf_counter() - t_shut < ADMIN_SHUTDOWN_S, \
                ("the node still runs", refuses(port), drainer.is_alive())
            time.sleep(0.02)
        stop_s = time.perf_counter() - t_shut
        assert node._closed
        gc.collect()
        if on_card:
            torch.cuda.synchronize()
        alloc1 = torch.cuda.memory_allocated(device) if on_card else 0
        released = alloc0 - alloc1
        out["shutdown"] = dict(
            stop_s=stop_s, ledger_bytes=ledger["total_bytes"], ledger_tiers=ledger["totals"],
            allocated_before=alloc0, allocated_after=alloc1, released_bytes=released,
            released_over_ledger=(released / ledger["total_bytes"])
            if on_card and ledger["total_bytes"] else None)
        sd = out["shutdown"]
        log(f"[25] (e) POST /_cluster/nodes/_local/_shutdown: the HTTP port refuses and "
            f"the batcher's drainer has exited {stop_s:.3f} s after the answer; "
            f"memory_allocated() {alloc0} B -> {alloc1} B (released {released} B) beside "
            f"the ledger's {ledger['total_bytes']} B resident just before "
            f"({ledger['totals']}); released/ledger "
            f"{'not measured' if sd['released_over_ledger'] is None else round(sd['released_over_ledger'], 4)}")
        out["launches"] = launches
        out["wall_s"] = time.perf_counter() - t_phase
        log(f"[25] sparse_score == plain (bitwise) at all {len(out['kernel_shapes'])} "
            f"shapes phase 25 launched ({launches.get('sparse_score', 0)} launches, the "
            f"lock-trace child's {out['locktrace']['launches']} apart, its own shapes "
            f"checked there); phase 25 took {out['wall_s']:.1f} s")
        return out
    finally:
        recorder.close()
        DEVICE_FAULTS.disarm()
        conn.close()


def locktrace_phase(device, texts, bodies) -> dict:
    """Phase 25 (d): the lock tracer over a node on the card, in a child
    process (this script with `--locktrace-child`, LOCKTRACE_TIMEOUT_S):
    no lock-order cycle, no wait on the card under a held lock, no
    `lock_stall` journalled."""
    here = Path(__file__).resolve().parent
    work = here / "build" / f"chip_smoke_locktrace_{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    inp = work / "input.json"
    inp.write_text(json.dumps({"texts": texts[:LOCKTRACE_DOCS],
                               "bodies": bodies[:LOCKTRACE_SEARCHES],
                               "device": str(device), "work": str(work)}))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--locktrace-child", str(inp)], cwd=here,
                              capture_output=True, text=True, timeout=LOCKTRACE_TIMEOUT_S)
    finally:
        wall_s = time.perf_counter() - t0
        shutil.rmtree(work, ignore_errors=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert proc.returncode == 0 and lines, (
        f"the lock-trace child failed (exit {proc.returncode}):\n"
        + proc.stdout[-2000:] + proc.stderr[-4000:])
    res = json.loads(lines[-1])
    assert res["cycle"] is None, res["cycle"]
    assert res["held_device_gets"] == 0 and res["long_held"] == [], res
    assert res["lock_stall"] == 0, res
    assert res["searches"] == LOCKTRACE_SEARCHES and res["locks_created"] > 0, res
    if device.type == "cuda":
        assert res["launches"] > 0, res
    res["wall_s"] = wall_s
    log(f"[25] (d) lock tracer in a child ({wall_s:.1f} s): a node on {device}, "
        f"{LOCKTRACE_DOCS} docs bulked into {LOCKTRACE_SHARDS} shards "
        f"({res['bulk_docs_per_s']:.1f} docs/s), {LOCKTRACE_SEARCHES} searches from "
        f"{ADMIN_CONN} connections with a _refresh and an _optimize among them "
        f"({res['requests_per_s']:.1f} requests/s, {res['launches']} sparse_score "
        f"launches, bitwise == plain at {res['shapes']} shapes): {res['locks_created']} "
        f"port locks created, {res['acquisitions']} acquisitions, {res['edges']} order "
        f"edges, no cycle; held_device_gets {res['held_device_gets']} (no wait on the "
        f"card under a held lock); lock_stall events {res['lock_stall']}")
    return res


def locktrace_child(path: str) -> None:
    """The child of phase 25 (d): arms the port's lock tracer before any of
    the port is imported, then a node on the card, its bulk and its
    traffic; prints one JSON line."""
    from elasticsearch_tpu_torch.common import locktrace

    tracer = locktrace.install(held_ms_threshold=LOCKTRACE_HELD_MS)
    import http.client

    import torch

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score
    from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry

    inp = json.loads(Path(path).read_text())
    device = torch.device(inp["device"])
    texts, bodies = inp["texts"], inp["bodies"]
    node = Node(name="locktrace", registry=LocalTransportRegistry(),
                data_path=str(Path(inp["work"]) / "data"),
                settings={"node.device": str(device), "watchdog.interval": "250ms"}).start()
    recorder = LaunchRecorder(scoring, sparse_score)
    try:
        port = node.start_http(0).port
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        st, r = http_json(conn, "PUT", "/traced", {"settings": {
            "number_of_shards": LOCKTRACE_SHARDS, "refresh_interval": -1}})
        assert st == 200, r
        t0 = time.perf_counter()
        for lo in range(0, len(texts), NODE_BULK):
            lines = []
            for i in range(lo, min(lo + NODE_BULK, len(texts))):
                lines.append(json.dumps({"index": {"_index": "traced", "_type": "doc",
                                                   "_id": str(i)}}))
                lines.append(json.dumps({"body": texts[i]}))
            st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
            assert st == 200 and not r["errors"], r
        bulk_s = time.perf_counter() - t0
        st, r = http_json(conn, "POST", "/traced/_refresh")
        assert st == 200, r
        st, r = http_json(conn, "POST", "/traced/_search", bodies[0])  # the warmer's gate
        assert st == 200, r
        conn.close()
        cudaenv.LAUNCHES.reset()
        reqs = [("POST", "/traced/_search", b, None) for b in bodies]
        # a write, a refresh and an optimize among the searches: the warmer
        # and merge pools pack beside the drainer
        mid = len(reqs) // 2
        reqs[mid: mid] = [("PUT", "/traced/doc/extra", {"body": texts[0]}, None),
                          ("POST", "/traced/_refresh", None, None),
                          ("POST", "/traced/_optimize", None, None)]
        t0 = time.perf_counter()
        got, _lat, wall = http_requests(port, reqs, ADMIN_CONN)
        searches = 0
        for (method, p, _b, _n), (st, r) in zip(reqs, got):
            assert st in (200, 201), (method, p, r)
            searches += p.endswith("_search")
        deadline = time.monotonic() + 10.0
        while True:  # the warmer's packs finish before the counts are read
            w = node.warmer.stats()
            if w["packs_done"] >= w["packs_scheduled"] or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        time.sleep(0.3)  # a watchdog tick after the traffic
        node.watchdog.tick()
        launches = cudaenv.LAUNCHES.snapshot().get("sparse_score", 0)
        stalls = sum(1 for e in node.events.events() if e["type"] == "lock_stall")
        snap = tracer.snapshot()
        cycle = tracer.find_cycle()
        recorder.close()
        max_err = check_shapes(recorder.shapes)
    finally:
        recorder.close()
        node.close()
    print(json.dumps({
        **snap, "cycle": cycle, "lock_stall": stalls, "searches": searches,
        "launches": launches, "shapes": len(recorder.shapes), "max_abs_err": max_err,
        "bulk_docs_per_s": len(texts) / bulk_s, "requests_per_s": len(reqs) / wall}),
        flush=True)


def term_docs(offsets, inv_docs, terms) -> np.ndarray:
    """The sorted docs that hold any of `terms`, from phase 10's CSR."""
    return np.unique(np.concatenate([inv_docs[offsets[t]: offsets[t + 1]]
                                     for t in terms]))


def mixed_bodies(rng, texts, offsets, inv_docs, n_requests: int):
    """Phase 11's traffic in a seeded random order: [(family, body, exact
    total or None)]. The `min_score` bodies carry no threshold yet."""
    df = np.diff(offsets)
    ranked = np.argsort(-df, kind="stable")
    pool, dense = ranked[RANKS[0]: RANKS[1]], ranked[BOOL_RANKS[0]: BOOL_RANKS[1]]

    def should(row):
        return {"bool": {"should": [{"term": {"body": term_name(int(t))}} for t in row]}}

    def terms_filter(row):
        return {"terms": {"body": [term_name(int(t)) for t in row]}}

    n_host = n_requests // 2
    out = [("device", {"query": should(row), "size": NODE_SIZE}, None)
           for row in rng.choice(pool, size=(n_requests - n_host, TERMS_PER_QUERY))]
    for i, family in enumerate(MIXED_HOST):
        for _ in range(n_host // len(MIXED_HOST) + (i < n_host % len(MIXED_HOST))):
            total = None
            if family == "phrase":
                toks = texts[int(rng.integers(len(texts)))].split()
                j = int(rng.integers(len(toks) - 1))
                body = {"query": {"match_phrase": {"body": f"{toks[j]} {toks[j + 1]}"}}}
            elif family == "bool_filter":
                must, filt = rng.choice(pool), rng.choice(dense, FILTER_TERMS, replace=False)
                body = {"query": {"bool": {"must": [{"term": {"body": term_name(int(must))}}],
                                           "filter": [terms_filter(filt)]}}}
                total = np.intersect1d(term_docs(offsets, inv_docs, [must]),
                                       term_docs(offsets, inv_docs, filt)).size
            elif family == "filtered":
                row = rng.choice(pool, TERMS_PER_QUERY)
                filt = rng.choice(dense, FILTER_TERMS, replace=False)
                body = {"query": {"filtered": {"query": should(row),
                                               "filter": terms_filter(filt)}}}
                total = np.intersect1d(term_docs(offsets, inv_docs, row),
                                       term_docs(offsets, inv_docs, filt)).size
            elif family == "prefix":
                prefix = f"t{int(rng.integers(200, 1000))}"
                body = {"query": {"constant_score": {"filter": {
                    "prefix": {"body": prefix}}}}}
            elif family == "post_filter":
                row, t = rng.choice(pool, TERMS_PER_QUERY), int(rng.choice(dense))
                body = {"query": should(row), "post_filter": {"term": {"body": term_name(t)}}}
                total = np.intersect1d(term_docs(offsets, inv_docs, row),
                                       term_docs(offsets, inv_docs, [t])).size
            elif family == "post_filter_all":  # no query: match_all, on the host
                t = int(rng.choice(dense))
                body = {"post_filter": {"term": {"body": term_name(t)}}}
                total = int(df[t])
            else:  # min_score
                body = {"query": should(rng.choice(pool, TERMS_PER_QUERY))}
            body["size"] = NODE_SIZE
            out.append((family, body, None if total is None else int(total)))
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def host_reference(ctxs, body: dict):
    """Each shard's host query phase, reduced by score desc, shard, doc:
    (total, [(score, shard, doc)] of the page, top score)."""
    from elasticsearch_tpu_torch.search import execute_query_phase, parse_search_body

    req = parse_search_body(body)
    entries, total, top = [], 0, float("nan")
    for sid, ctx in enumerate(ctxs):
        r = execute_query_phase(ctx, req, use_device=False, shard_id=sid)
        total += r.total
        entries.extend((score, sid, doc) for score, doc, _sv in r.docs)
        if r.max_score == r.max_score:
            top = r.max_score if top != top else max(top, r.max_score)
    entries.sort(key=lambda e: (-e[0], e[1], e[2]))
    return total, entries[: req.from_ + req.size], top


def mixed_phase(device, node, port: int, *, texts, offsets, inv_docs, searchers,
                seed: int, n_requests: int, n_callers: int) -> dict:
    """Phase 11: phase 10's node serves bodies that lower to the card's
    sparse path and bodies the host scorer serves, side by side, from the
    same connections; every response is held against the shards' host query
    phases."""
    import torch

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score
    from elasticsearch_tpu_torch.search import (
        SERVING_COUNTERS, ShardContext, parse_query, search_shard_batch)

    on_card = device.type == "cuda"
    card = card_line() if on_card else f"{device} (a rehearsal: no card)"
    svc = node.indices.index_service("corpus")
    ctxs = [ShardContext(sr, svc.mapper_service, svc.similarity_service, device=device)
            for sr in searchers]
    rng = np.random.default_rng(seed)
    traffic = mixed_bodies(rng, texts, offsets, inv_docs, n_requests)
    for family, body, _total in traffic:
        if family == "min_score":
            _t, _e, top = host_reference(ctxs, body)
            assert top == top, f"min_score body without a hit: {body}"
            body["min_score"] = top / 2
    bodies = [body for _f, body, _t in traffic]
    families = np.array([f for f, _b, _t in traffic])

    recorder = LaunchRecorder(scoring, sparse_score)
    try:
        before = dict(SERVING_COUNTERS)
        stats_before = node.search_batcher.stats()
        cudaenv.LAUNCHES.reset()
        responses, lat_ms, wall_s, errors, host_cpu = serve_http(
            port, bodies, n_callers, sync_error=on_card)
        launches = cudaenv.LAUNCHES.snapshot()
        counted = {k: SERVING_COUNTERS[k] - before[k] for k in SERVING_COUNTERS}
        stats = node.search_batcher.stats()
    finally:
        recorder.close()
    batches = stats["launches"] - stats_before["launches"]
    items = stats["coalesced"] - stats_before["coalesced"]

    # correctness, before any time is kept
    assert not errors, f"{len(errors)} requests failed, first {errors[:3]}"
    n_device = int((families == "device").sum())
    n_dense = int(np.isin(families, MIXED_DENSE).sum())
    n_host = n_requests - n_device - n_dense
    assert counted == {"device_sparse": NODE_SHARDS * n_device,
                       "device_filtered": NODE_SHARDS * n_dense,
                       "device_function_score": 0, "device_aggs": 0,
                       "device_sort": 0, "device_percolate": 0,
                       "device_percolate_fallbacks": 0, "device_errors": 0, "degraded": 0,
                       "host": NODE_SHARDS * n_host}, counted
    device_idx = [i for i, f in enumerate(families) if f == "device"]
    card_ref = {}
    for lo in range(0, len(device_idx), 1024):
        chunk = device_idx[lo: lo + 1024]
        for sid, ctx in enumerate(ctxs):
            tops = search_shard_batch(ctx, [parse_query(bodies[i]["query"]) for i in chunk],
                                      NODE_SIZE)
            for i, td in zip(chunk, tops):
                card_ref.setdefault(i, []).extend((s, sid, d) for s, d in td.hits)
    def ident(sid: int, doc: int) -> str:
        seg, local = searchers[sid].resolve(doc)
        return seg.ids[local]

    exact_device = 0
    exact_dense = dict.fromkeys(MIXED_DENSE, 0)
    for i, ((st, r), (family, body, total)) in enumerate(zip(responses, traffic)):
        assert st == 200, (i, family, r)
        assert r["_shards"] == SHARDS_OK, (i, family, r["_shards"])
        ref_total, entries, _top = host_reference(ctxs, body)
        assert r["hits"]["total"] == ref_total, (i, family, r["hits"]["total"], ref_total)
        if total is not None:
            assert ref_total == total, f"request {i} ({family}): total != exact {total}"
        got = [(h["_score"], (h["_id"], h["_shard"])) for h in r["hits"]["hits"]]
        want = [(score, (ident(sid, doc), sid)) for score, sid, doc in entries]
        if family in MIXED_DENSE:
            assert tie_tolerant_equal(got, want), \
                f"request {i} ({family}): card hits != host hits within {ULPS} ulp"
            exact_dense[family] += got == want
            continue
        if family != "device":
            assert got == want, f"request {i} ({family}): hits != the host query phases"
            continue
        assert tie_tolerant_equal(got, want), \
            f"request {i}: card hits != host hits within {ULPS} ulp"
        exact_device += got == want
        card_hits = sorted(card_ref[i], key=lambda e: (-e[0], e[1], e[2]))[:NODE_SIZE]
        assert [(s, (ident(sid, d), sid)) for s, sid, d in card_hits] == got, \
            f"request {i}: hits != the shards' search_shard_batch"
    if on_card:
        assert launches.get("sparse_score", 0) > 0, "sparse_score never launched in phase 11"
    max_err = check_shapes(recorder.shapes)

    by_family = {}
    for family in ("device",) + MIXED_HOST:
        lat = lat_ms[families == family]
        by_family[family] = dict(requests=int(len(lat)),
                                 p50_ms=float(np.percentile(lat, 50)),
                                 p99_ms=float(np.percentile(lat, 99)))
    dense_bitwise = {f: exact_dense[f] / max(int((families == f).sum()), 1)
                     for f in MIXED_DENSE}
    out = dict(requests=n_requests, callers=n_callers, wall_s=wall_s,
               requests_per_s=n_requests / wall_s, latency_by_family=by_family,
               serving_counters=counted, launches=launches, host_cpu_s=host_cpu,
               device_bitwise_share=exact_device / max(n_device, 1),
               dense_bitwise_share=dense_bitwise, batches=batches,
               occupancy_mean=items / max(batches, 1), batch_service_ms=stats["batch"],
               kernel_shapes=len(recorder.shapes), kernel_max_abs_err=max_err,
               card=card,
               sync_debug="error over the whole timed run" if on_card else None)
    log(f"[11] mixed traffic on the node: {n_requests} _search requests from "
        f"{n_callers} connections, {n_device} to the card's sparse path, {n_dense} to "
        f"its dense family, {n_host} to the host scorer: {out['requests_per_s']:.1f} "
        f"requests/s ({wall_s:.2f} s; with those families on the host: "
        f"{HOST_FAMILIES_PHASE11['requests_per_s']}); "
        f"{card}")
    for family, v in by_family.items():
        was = HOST_FAMILIES_PHASE11["latency_ms"][family]
        where = "sparse" if family == "device" else \
            "dense" if family in MIXED_DENSE else "host"
        before = "no such family" if was is None else f"p50 {was[0]}, p99 {was[1]}"
        if family == "post_filter_all":
            before += ", sent as `post_filter`"
        log(f"[11]   {family:15s} ({where:6s}) {v['requests']:5d} requests: p50 "
            f"{v['p50_ms']:.2f} ms, p99 {v['p99_ms']:.2f} ms (before the move: "
            f"{before}); {card}")
    log(f"[11] every response == the shards' host query phases reduced (host half "
        f"bitwise; the card's within {ULPS} ulp, tie-tolerant: the sparse half "
        f"{out['device_bitwise_share']:.4f} bitwise, and bitwise == "
        f"search_shard_batch; the dense families bitwise "
        + ", ".join(f"{f} {v:.4f}" for f, v in dense_bitwise.items())
        + f"); filter-family totals == exact counts; serving counters {counted}; "
        f"launches {launches}")
    log(f"[11] host CPU s over the {wall_s:.2f} s timed run, by thread kind: "
        + ", ".join(f"{k} {v:.2f} ({v / wall_s:.3f} of wall)" for k, v in host_cpu.items())
        + f"; node batcher {batches} batches, occupancy mean {out['occupancy_mean']:.3f}, "
        f"batch service (all runs) p50 {stats['batch']['p50_ms']} ms p99 "
        f"{stats['batch']['p99_ms']} ms; {card}")
    log(f"[11] sparse_score == plain (bitwise) at all {len(recorder.shapes)} shapes "
        f"phase 11 launched; max abs err {max_err}")
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _r, _l, pwall_s, perrors, _cpu = serve_http(
                port, bodies[:MIXED_PROFILED], n_callers, sync_error=False)
        assert not perrors, perrors[:3]
        out["profiled"] = p = device_busy(prof, pwall_s * 1e3)
        if p["device_busy_ms"]:
            log(f"[11] profiled window of {MIXED_PROFILED} mixed requests: wall "
                f"{p['wall_ms']:.2f} ms, device busy {p['device_busy_ms']:.3f} ms, "
                f"idle share {p['idle_share']:.4f}; {card}")
        else:
            log("[11] profiled window: the profiler saw no device time "
                "(device idle share not measured)")
    return out


def tie_tolerant_close(got, want, rel: float) -> bool:
    """`tie_tolerant_equal` at a relative tolerance: the same doc set, each
    score within `rel`, the same order except between scores within 2 rel."""
    if sorted(d for _, d in got) != sorted(d for _, d in want):
        return False
    want_by = {d: s for s, d in want}
    if not all(abs(s - want_by[d]) <= rel * abs(want_by[d]) for s, d in got):
        return False
    pos = {d: i for i, (_, d) in enumerate(got)}
    for i, (sa, a) in enumerate(want):
        for sb, b in want[i + 1:]:
            if abs(sa - sb) > 2 * rel * abs(sa) and pos[a] > pos[b]:
                return False
    return True


def dense_family_bodies(rng, ranked, n: int) -> dict:
    """Phase 12's traffic, `n` bodies a family: phase 3's 4-term `bool`
    under each feature. filtered: a 20-term `terms` filter (df ranks
    20-400); post_filter: a term filter (df ranks 20-400); min_score: the
    query alone (its threshold is set from its own top score); fs_rows: one
    spec for the whole family, `field_value_factor` on `pop` (log1p) times
    a filtered weight, added to the score; fs_script: FS_SCRIPT, multiplied
    in."""
    pool, dense = ranked[RANKS[0]: RANKS[1]], ranked[BOOL_RANKS[0]: BOOL_RANKS[1]]

    def should():
        return {"bool": {"should": [{"term": {"body": term_name(int(t))}}
                                    for t in rng.choice(pool, TERMS_PER_QUERY)]}}

    def terms(k):
        return [term_name(int(t)) for t in rng.choice(dense, k, replace=False)]

    out = {f: [] for f in DENSE_FAMILIES}
    for _ in range(n):
        out["filtered"].append({"query": {"filtered": {
            "query": should(), "filter": {"terms": {"body": terms(FILTER_TERMS)}}}}})
        out["post_filter"].append({"query": should(),
                                   "post_filter": {"term": {"body": terms(1)[0]}}})
        out["min_score"].append({"query": should()})
        out["fs_rows"].append({"query": {"function_score": {
            "query": should(),
            "functions": [{"field_value_factor": {"field": "pop", "modifier": "log1p",
                                                  "missing": 1}},
                          {"filter": {"range": {"pop": {"gte": 500}}}, "weight": 2}],
            "boost_mode": "sum"}}})
        out["fs_script"].append({"query": {"function_score": {
            "query": should(), "script_score": {"script": FS_SCRIPT}}}})
    for bodies in out.values():
        for b in bodies:
            b["size"] = K
    return out


def dense_family_phase(device, segs, ranked, *, seed: int, batch: int,
                       n_check: int) -> dict:
    """Phase 12: the dense request-feature family at full width on phase
    2's shard. For each family, one batch of `batch` requests' plans (the
    service's own routing, `device_plan`) through `dispatch_flat_batch`,
    twice: cold (every filter mask built on the host, then made resident in
    the DeviceFilterCache) and warm (the masks resident). Everything after
    the set-up runs under `set_sync_debug_mode("error")`. `n_check` queries a
    family are held against the host scorer, every query against the same
    ops on CPU tensors."""
    import torch

    from elasticsearch_tpu_torch.common.breaker import CircuitBreakerService
    from elasticsearch_tpu_torch.common.errors import ScriptError
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.engine import Searcher
    from elasticsearch_tpu_torch.mapper import MapperService
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.device_index import DeviceFilterCache, packed_for
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score
    from elasticsearch_tpu_torch.search import (
        ShardContext, SimilarityService, execute_query_phase, parse_query,
        parse_search_body, search_shard_batch)
    from elasticsearch_tpu_torch.search import execute as texecute
    from elasticsearch_tpu_torch.search.service import device_plan

    on_card = device.type == "cuda"
    card = card_line() if on_card else f"{device} (a rehearsal: no card)"
    settings = Settings.from_flat({**BM25_SETTINGS,
                                   "indices.filter_cache.min_sightings": 1})
    svc = MapperService(settings)
    svc.put_mapping("doc", SHARD_MAPPING)
    sims = SimilarityService(settings, svc)
    breakers = CircuitBreakerService(settings)
    fcache = DeviceFilterCache(settings, breaker=breakers.breaker("fielddata"))
    ctx = ShardContext(Searcher(segs), svc, sims, device=device, breakers=breakers,
                       filter_cache=fcache)
    cpu_ctx = ShardContext(Searcher(segs), svc, sims, device="cpu")
    rng = np.random.default_rng(seed)
    bodies = dense_family_bodies(rng, ranked, batch)

    # set-up, before the clock: each min_score body's threshold is half its
    # query's own top score (one plain batch on the card's sparse path)
    recorder = LaunchRecorder(scoring, sparse_score)
    try:
        tops = search_shard_batch(ctx, [parse_query(b["query"])
                                        for b in bodies["min_score"]], 1)
    finally:
        recorder.close()
    for b, td in zip(bodies["min_score"], tops):
        assert td.hits, f"min_score body without a hit: {b}"
        b["min_score"] = td.max_score / 2
    t0 = time.perf_counter()
    for seg in segs:
        packed_for(seg, torch.device("cpu"))  # the CPU leg's packs
    cpu_pack_s = time.perf_counter() - t0
    reqs = {f: [parse_search_body(b) for b in bs] for f, bs in bodies.items()}
    routed = {f: [device_plan(ctx, r) for r in rs] for f, rs in reqs.items()}
    want_counter = {"filtered": "device_filtered", "post_filter": "device_filtered",
                    "min_score": "device_filtered", "fs_rows": "device_function_score",
                    "fs_script": "device_function_score"}
    for f, rs in routed.items():
        assert all(r is not None and r[1] == want_counter[f] for r in rs), f
    plans = {f: [plan for plan, _c in rs] for f, rs in routed.items()}

    reruns = []
    host_search = texecute._host_search
    texecute._host_search = lambda c, q, k, **kw: reruns.append(q) or host_search(c, q, k, **kw)
    out = {"card": card, "batch": batch, "cpu_pack_s": cpu_pack_s, "families": {}}
    results = {}
    handed_back = 0  # queries a merge hands back to the host scorer
    if on_card:
        torch.cuda.set_sync_debug_mode("error")
    try:
        for f in DENSE_FAMILIES:
            rows = []
            for pass_name in ("cold", "warm"):
                before = fcache.stats()
                start = torch.cuda.Event(enable_timing=True) if on_card else None
                end = torch.cuda.Event(enable_timing=True) if on_card else None
                t0 = time.perf_counter()
                if on_card:
                    start.record()
                # the host inputs, as a node's search thread builds them
                preps = texecute.prepare_dense(plans[f], ctx)
                tp = time.perf_counter()
                pending = texecute.dispatch_flat_batch(plans[f], ctx, K, preps)
                if on_card:
                    end.record()
                t1 = time.perf_counter()
                res = pending.merge()
                wall_ms = (time.perf_counter() - t0) * 1e3
                ev_ms = None
                if on_card:
                    end.synchronize()
                    ev_ms = start.elapsed_time(end)
                after = fcache.stats()
                handed_back += sum(td is None for td in res)
                rows.append(dict(
                    pass_=pass_name, wall_ms=wall_ms, dispatch_ms=(t1 - t0) * 1e3,
                    prepare_ms=(tp - t0) * 1e3, device_ms=ev_ms,
                    launches=sum(len(ls) for part in pending.parts if part.kind == "dense"
                                 for (_s, _b, _d, ls) in part.seg_work),
                    copies=len(pending.tensors()),
                    cache_hits=after["hits"] - before["hits"],
                    cache_builds=after["builds"] - before["builds"],
                    cache_bytes=after["memory_size_in_bytes"]))
                if pass_name == "cold":
                    results[f] = res
                else:  # resident masks: the same answers
                    for a, b in zip(res, results[f]):
                        assert a.total == b.total and (
                            tie_tolerant_close(a.hits, b.hits, 1e-5) if f == "fs_script"
                            else tie_tolerant_equal(a.hits, b.hits)), \
                            f"{f}: the warm pass differs from the cold one"
            out["families"][f] = rows
        assert not handed_back and not reruns, \
            f"{handed_back} queries handed back to the host scorer"

        # the script on `pop`, missing on 1 doc in 7: every query is
        # flagged bad, reruns on the host scorer, and raises there as the
        # JAX package's does
        pop_q = parse_query({"function_score": {
            "query": bodies["fs_script"][0]["query"]["function_score"]["query"],
            "script_score": {"script": "_score * log(2 + doc['pop'].value)"}}})
        try:
            search_shard_batch(ctx, [pop_q], K)
            raise AssertionError("the pop script did not raise")
        except ScriptError:
            pass
        assert len(reruns) == 1
        texecute._host_search = host_search

        # correctness: n_check queries a family against the host scorer and
        # against the same ops on CPU tensors (every query of the batch on
        # CPU tensors until phase 26 joined the run: 57-60 s of the
        # command, cut for its time)
        checked = {}
        for f in DENSE_FAMILIES:
            idx = rng.choice(batch, min(n_check, batch), replace=False)
            for i in idx:
                ref = execute_query_phase(cpu_ctx, reqs[f][i], use_device=False)
                got = [(s, d) for s, d in results[f][i].hits]
                want = [(s, d) for s, d, _v in ref.docs]
                assert results[f][i].total == ref.total, (f, i, "total vs host")
                if f == "fs_script":
                    assert tie_tolerant_close(got, want, 1e-5), (f, i, "host")
                else:
                    assert tie_tolerant_equal(got, want), (f, i, "host")
            t0 = time.perf_counter()
            cpu_plans = [device_plan(cpu_ctx, reqs[f][i])[0] for i in idx]
            cpu_res = texecute.dispatch_flat_batch(cpu_plans, cpu_ctx, K).merge()
            cpu_s = time.perf_counter() - t0
            bitwise = 0
            for i, b in zip(idx, cpu_res):
                a = results[f][i]
                assert a.total == b.total, (f, i, "total vs cpu")
                if f == "fs_script":
                    assert tie_tolerant_close(a.hits, b.hits, 1e-5), (f, i, "cpu")
                else:
                    assert tie_tolerant_equal(a.hits, b.hits), (f, i, "cpu")
                bitwise += a.hits == b.hits
            checked[f] = dict(host=len(idx), cpu=len(idx),
                              cpu_bitwise_share=bitwise / len(idx),
                              cpu_s=cpu_s, matched=sum(r.total for r in results[f]))
        out["checked"] = checked
    finally:
        texecute._host_search = host_search
        if on_card:
            torch.cuda.set_sync_debug_mode(0)
    max_err = check_shapes(recorder.shapes)
    out.update(kernel_shapes=len(recorder.shapes), kernel_max_abs_err=max_err,
               cache=fcache.stats(), fielddata_used=breakers.breaker("fielddata").used,
               sync_debug="error after the set-up" if on_card else None)
    log(f"[12] the dense family on phase 2's shard ({len(segs)} segments, "
        f"{sum(s.doc_count for s in segs)} docs), batches of {batch} a family, "
        f"top-{K}; {card}")
    log("[12]   family      pass | ms a batch: events, host wall (dispatch; of it the "
        "host inputs) | dense launches | copies | filter cache hits, builds, resident bytes")
    for f, rows in out["families"].items():
        for r in rows:
            ev = f"{r['device_ms']:.3f}" if r["device_ms"] is not None else "not measured"
            log(f"[12]   {f:11s} {r['pass_']:4s} | {ev}, {r['wall_ms']:.2f} "
                f"({r['dispatch_ms']:.2f}; {r['prepare_ms']:.2f}) | {r['launches']} | "
                f"{r['copies']} | "
                f"{r['cache_hits']}, {r['cache_builds']}, {r['cache_bytes']}")
    for f, c in out["checked"].items():
        log(f"[12]   {f:11s} {c['host']} queries == the host scorer ("
            + ("5 decimals" if f == "fs_script" else f"{ULPS} ulp, tie-tolerant")
            + f", totals exact), the same {c['cpu']} == the same ops on CPU tensors "
            f"({c['cpu_bitwise_share']:.4f} bitwise; {c['cpu_s']:.1f} s on the CPU); "
            f"{c['matched']} matches")
    log(f"[12] no query reran on the host scorer; the script on pop (missing on 1 "
        f"doc in {POP_MISSING}) flagged its query, reran it on the host scorer and "
        f"raised ScriptError there; filter cache {out['cache']}; fielddata breaker "
        f"{out['fielddata_used']} bytes; sparse_score == plain (bitwise) at all "
        f"{len(recorder.shapes)} shapes the set-up launched; max abs err {max_err}")
    return out


def sort_agg_bodies(rng, pool, dense, n: int) -> dict:
    """Phase 13's traffic, `n` bodies a family, each over phase 3's 4-term
    `bool`: sort_asc (`pop` asc, missing last, top-100), sort_desc_scores
    (`likes` desc with track_scores, size 10), aggs_metric (size 0; stats of
    `likes`, avg and value_count of `pop`), aggs_terms (terms on `cat`, size
    10, an avg of `pop` under each), aggs_hist (histogram of `likes`, interval
    50; a range of `pop`), sort_aggs (sort on `pop`, stats of `likes`) and
    post_filter_aggs (a term post filter, df ranks 20-400, and terms on
    `cat`)."""
    def should():
        return {"bool": {"should": [{"term": {"body": term_name(int(t))}}
                                    for t in rng.choice(pool, TERMS_PER_QUERY)]}}

    out = {f: [] for f in SORT_AGG_FAMILIES}
    for _ in range(n):
        out["sort_asc"].append({"query": should(), "size": K, "sort": [
            {"pop": {"order": "asc", "missing": "_last"}}]})
        out["sort_desc_scores"].append({"query": should(), "size": 10,
                                        "sort": [{"likes": "desc"}], "track_scores": True})
        out["aggs_metric"].append({"query": should(), "size": 0, "aggs": {
            "likes_stats": {"stats": {"field": "likes"}},
            "pop_avg": {"avg": {"field": "pop"}},
            "pop_count": {"value_count": {"field": "pop"}}}})
        out["aggs_terms"].append({"query": should(), "size": 0, "aggs": {
            "cats": {"terms": {"field": "cat", "size": 10},
                     "aggs": {"pop_avg": {"avg": {"field": "pop"}}}}}})
        out["aggs_hist"].append({"query": should(), "size": 0, "aggs": {
            "likes_hist": {"histogram": {"field": "likes", "interval": 50}},
            "pop_ranges": {"range": {"field": "pop", "ranges": [
                {"to": 250}, {"from": 250, "to": 750}, {"from": 750}]}}}})
        out["sort_aggs"].append({"query": should(), "size": 10,
                                 "sort": [{"pop": "asc"}],
                                 "aggs": {"likes_stats": {"stats": {"field": "likes"}}}})
        out["post_filter_aggs"].append({
            "query": should(), "size": 10,
            "post_filter": {"term": {"body": term_name(int(rng.choice(dense)))}},
            "aggs": {"cats": {"terms": {"field": "cat", "size": 10}}}})
    return out


# the reduced fields that come from a float32 sum on the card, compared
# within AGG_RTOL; an avg or sum agg's `value` is one too (`sum_agg_names`)
AGG_SUM_KEYS = ("sum", "avg", "sum_of_squares", "variance", "std_deviation",
                "std_deviation_bounds")


def sum_agg_names(aggs: dict) -> set:
    """The names of a body's avg and sum aggregations, at any depth."""
    out = set()
    for name, spec in aggs.items():
        if "avg" in spec or "sum" in spec:
            out.add(name)
        out |= sum_agg_names(spec.get("aggs") or spec.get("aggregations") or {})
    return out


def agg_close(got, want, body: dict, rel: float = AGG_RTOL, path: str = "",
              name: str | None = None, loose: bool = False) -> None:
    """Reduced aggregations within tests/test_device_aggs.py's bar: the sums
    and what derives from them (AGG_SUM_KEYS, the `value` of the body's avg
    and sum aggs) within `rel`; counts, keys, min, max and every other
    value exact."""
    if isinstance(got, dict) and isinstance(want, dict):
        assert set(got) == set(want), (path, got, want)
        sums = sum_agg_names(body.get("aggs") or body.get("aggregations") or {})
        for key in got:
            agg_close(got[key], want[key], body, rel, f"{path}.{key}", key,
                      loose or key in AGG_SUM_KEYS or (key == "value" and name in sums))
    elif isinstance(got, list) and isinstance(want, list):
        assert len(got) == len(want), (path, got, want)
        for i, (a, b) in enumerate(zip(got, want)):
            agg_close(a, b, body, rel, f"{path}[{i}]", name, loose)
    elif loose and isinstance(got, (int, float)) and isinstance(want, (int, float)):
        assert abs(got - want) <= rel * abs(want), (path, got, want)
    else:
        assert got == want, (path, got, want)


def shard_docs_match(got, want, sorted_hits: bool) -> bool:
    """A query phase's docs [(score, doc, sort values)] against a reference:
    a sorted search in the same order with the same sort values, its scores
    NaN together or within 2 ulp; a scored one tie-tolerant within 2 ulp."""
    if not sorted_hits:
        return tie_tolerant_equal([(s, d) for s, d, _v in got],
                                  [(s, d) for s, d, _v in want])
    if [(d, v) for _s, d, v in got] != [(d, v) for _s, d, v in want]:
        return False
    return all((a != a and b != b) or within_ulps(a, b, ULPS)
               for (a, _d, _v), (b, _e, _w) in zip(got, want))


class CallCounts:
    """Counts, until `close()`, the dense launches of the sorted, aggregating
    and filtered launchers and the device→host pulls of the service, with the
    tensors each pull copies. It launches and copies nothing itself."""

    def __init__(self, texecute, tservice):
        self.launches = 0
        self.pulls = 0
        self.copies = 0
        self._saved = []
        for name in ("score_agg_batch_async", "score_sorted_batch_async",
                     "score_filtered_batch_async"):
            self._wrap(texecute, name, self._launch)
        self._wrap(tservice, "pull_async", self._pull)

    def _wrap(self, module, name, counter):
        orig = getattr(module, name)
        self._saved.append((module, name, orig))

        def counted(*args, **kwargs):
            counter(args)
            return orig(*args, **kwargs)

        setattr(module, name, counted)

    def _launch(self, _args):
        self.launches += 1

    def _pull(self, args):
        self.pulls += 1
        self.copies += len(args[0])

    def take(self) -> tuple[int, int, int]:
        out = (self.launches, self.pulls, self.copies)
        self.launches = self.pulls = self.copies = 0
        return out

    def close(self) -> None:
        for module, name, orig in self._saved:
            setattr(module, name, orig)


def agg_resident_bytes(packs) -> tuple[int, int]:
    """(bytes of the resident agg-row stacks, of the bucket pair columns)."""
    def nbytes(t):
        return t.numel() * t.element_size()

    rows = sum(nbytes(t) for p in packs for t in p.agg_stacks.values())
    cols = sum(nbytes(c[0]) + nbytes(c[1]) for p in packs for c in p.bucket_cols.values())
    return rows, cols


def sort_agg_phase(device, segs, ranked, *, seed: int, n_requests: int) -> dict:
    """Phase 13, the library leg: `n_requests` bodies a family of
    `sort_agg_bodies` through `parse_search_body` → `execute_query_phase` on
    phase 2's shard, one caller, the timed run under
    `set_sync_debug_mode("error")`. Every response equals the same request on
    the host path (`use_device=False`) and on CPU tensors; the serving
    counters show each family's device branch; one device→host pull a
    request."""
    import torch

    from elasticsearch_tpu_torch.common.breaker import CircuitBreakerService
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.engine import Searcher
    from elasticsearch_tpu_torch.mapper import MapperService
    from elasticsearch_tpu_torch.ops.device_index import packed_for
    from elasticsearch_tpu_torch.search import (
        SERVING_COUNTERS, ShardContext, SimilarityService, execute_query_phase,
        parse_search_body)
    from elasticsearch_tpu_torch.search import execute as texecute
    from elasticsearch_tpu_torch.search import service as tservice
    from elasticsearch_tpu_torch.search.aggregations import reduce_aggs

    on_card = device.type == "cuda"
    card = card_line() if on_card else f"{device} (a rehearsal: no card)"
    settings = Settings.from_flat(BM25_SETTINGS)
    svc = MapperService(settings)
    svc.put_mapping("doc", SHARD_MAPPING)
    sims = SimilarityService(settings, svc)
    breakers = CircuitBreakerService(settings)
    ctx = ShardContext(Searcher(segs), svc, sims, device=device, breakers=breakers)
    cpu_ctx = ShardContext(Searcher(segs), svc, sims, device="cpu")
    rng = np.random.default_rng(seed)
    bodies = sort_agg_bodies(rng, ranked[RANKS[0]: RANKS[1]],
                             ranked[BOOL_RANKS[0]: BOOL_RANKS[1]], n_requests)
    reqs = {f: [parse_search_body(b) for b in bs] for f, bs in bodies.items()}

    # set-up, before the clock: one request a family builds the agg rows,
    # bucket columns and sort keys
    t0 = time.perf_counter()
    for f in SORT_AGG_FAMILIES:
        execute_query_phase(ctx, reqs[f][0])
    warm_s = time.perf_counter() - t0
    packs = [packed_for(seg, device) for seg in segs]
    counts = CallCounts(texecute, tservice)
    before = dict(SERVING_COUNTERS)
    results, rows = {}, {}
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    try:
        for f in SORT_AGG_FAMILIES:
            res, walls, events, calls = [], [], [], []
            for req in reqs[f]:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)) if on_card else None
                t0 = time.perf_counter()
                if on_card:
                    ev[0].record()
                res.append(execute_query_phase(ctx, req))
                if on_card:
                    ev[1].record()
                walls.append((time.perf_counter() - t0) * 1e3)
                events.append(ev)
                calls.append(counts.take())
            results[f] = res
            rows[f] = (walls, events, calls)
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode(0)
        counts.close()
    counted = {k: v - before[k] for k, v in SERVING_COUNTERS.items() if v != before[k]}
    want_counted = {}
    for f in SORT_AGG_FAMILIES:
        want_counted[SORT_AGG_COUNTER[f]] = want_counted.get(SORT_AGG_COUNTER[f], 0) \
            + n_requests
    assert counted == want_counted, f"serving counters {counted} != {want_counted}"
    if on_card:
        torch.cuda.synchronize()
    out = {"card": card, "requests_a_family": n_requests, "warm_s": warm_s,
           "families": {}}
    for f, (walls, events, calls) in rows.items():
        dev_ms = [a.elapsed_time(b) for a, b in events] if on_card else None
        pulls = {c[1] for c in calls}
        assert pulls == {1}, f"{f}: device→host pulls a request {pulls}"
        out["families"][f] = dict(
            wall_ms_p50=float(np.percentile(walls, 50)), wall_ms_mean=float(np.mean(walls)),
            events_ms_p50=float(np.percentile(dev_ms, 50)) if dev_ms else None,
            events_ms_mean=float(np.mean(dev_ms)) if dev_ms else None,
            launches=sorted({c[0] for c in calls}), copies=sorted({c[2] for c in calls}),
            matched=sum(r.total for r in results[f]))
    rows_b, cols_b = agg_resident_bytes(packs)
    out.update(agg_rows_bytes=rows_b, bucket_cols_bytes=cols_b,
               fielddata_used=breakers.breaker("fielddata").used)

    # correctness: every response against the host path and the CPU tensors
    t0 = time.perf_counter()
    for f in SORT_AGG_FAMILIES:
        sorted_hits = bool(reqs[f][0].sort)
        for i, (req, got) in enumerate(zip(reqs[f], results[f])):
            for ref_name, ref in (("host", execute_query_phase(ctx, req, use_device=False)),
                                  ("cpu", execute_query_phase(cpu_ctx, req))):
                assert got.total == ref.total, (f, i, ref_name, "total")
                assert shard_docs_match(got.docs, ref.docs, sorted_hits), \
                    (f, i, ref_name, "hits")
                assert (got.max_score != got.max_score) == (ref.max_score != ref.max_score)
                if got.max_score == got.max_score:
                    assert within_ulps(got.max_score, ref.max_score, ULPS), (f, i, ref_name)
                if req.aggs:
                    agg_close(reduce_aggs(req.aggs, got.agg_partials),
                              reduce_aggs(req.aggs, ref.agg_partials), req.body,
                              AGG_RTOL, f"{f}[{i}] {ref_name}")
            if sorted_hits and not req.track_scores:
                assert all(s != s for s, _d, _v in got.docs), (f, i, "score not null")
    out["check_s"] = time.perf_counter() - t0

    if on_card:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            execute_query_phase(ctx, reqs["aggs_terms"][1])
            wall_ms = (time.perf_counter() - t0) * 1e3
        out["profiled_aggs_terms"] = device_busy(prof, wall_ms)

    log(f"[13] field sort and aggregations on phase 2's shard ({len(segs)} segments, "
        f"{sum(s.doc_count for s in segs)} docs): {n_requests} requests a family, one "
        f"caller, through parse_search_body -> execute_query_phase; {card}")
    log("[13]   family           | ms a request: events p50 / mean, host wall p50 / mean "
        "| dense launches, pulls, copies a request | matches")
    for f, r in out["families"].items():
        ev = (f"{r['events_ms_p50']:.3f} / {r['events_ms_mean']:.3f}"
              if r["events_ms_p50"] is not None else "not measured")
        log(f"[13]   {f:16s} | {ev}, {r['wall_ms_p50']:.3f} / {r['wall_ms_mean']:.3f} "
            f"| {r['launches']}, 1, {r['copies']} | {r['matched']}")
    log(f"[13] serving counters over the run {counted}; every response == the host path "
        f"and == the same ops on CPU tensors (hits, sort values, totals exact; scores "
        f"{ULPS} ulp; aggregations: counts, keys, min, max exact, sums rel {AGG_RTOL}) "
        f"({out['check_s']:.1f} s); resident agg rows {rows_b} bytes, bucket columns "
        f"{cols_b} bytes; fielddata breaker {out['fielddata_used']} bytes; set-up "
        f"{warm_s:.2f} s")
    p = out.get("profiled_aggs_terms")
    if p and p["device_busy_ms"]:
        log(f"[13] one aggs_terms request under torch.profiler: wall {p['wall_ms']:.3f} ms, "
            f"device busy {p['device_busy_ms']:.3f} ms, idle share {p['idle_share']:.4f}")
        for name, ms, n in p["top"]:
            log(f"[13]   {ms:9.3f} ms {n:5d}x {name}")
    elif on_card:
        log("[13] profiled aggs_terms request: the profiler saw no device time (not measured)")
    return out


def catalog_phase(device, node, port: int, *, texts, offsets, inv_docs, seed: int,
                  n_docs: int, n_requests: int, n_callers: int) -> dict:
    """Phase 13, the node leg, on phase 10's node: a `catalog` index of 5
    shards (`refresh_interval: -1`) with `n_docs` of phase 10's texts and
    the `pop`, `likes` and `cat` doc values, bulked over HTTP; then
    `n_requests` `_search` requests from the same connections, drawn in a
    seeded order from the library leg's families, a `facets` body and a
    `?sort=pop:desc` URL, the timed run under `set_sync_debug_mode("error")`.
    Every response equals the shards' host query phases reduced by the port's
    `sort_docs` and `merge_responses`; totals equal exact numpy counts."""
    import http.client

    from elasticsearch_tpu_torch import actions as tactions
    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.search import (
        SERVING_COUNTERS, ShardContext, execute_query_phase, merge_responses,
        parse_search_body, sort_docs)
    from elasticsearch_tpu_torch.search import execute as texecute
    from elasticsearch_tpu_torch.search import service as tservice

    on_card = device.type == "cuda"
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    st, r = http_json(conn, "PUT", "/catalog", {
        "settings": {"number_of_shards": NODE_SHARDS, "refresh_interval": -1},
        "mappings": {"doc": SHARD_MAPPING}})
    assert st == 200 and r["acknowledged"], r
    columns = doc_value_columns(n_docs, seed)
    cats = cat_column(n_docs, seed + 1)
    t0 = time.perf_counter()
    for lo in range(0, n_docs, NODE_BULK):
        lines = []
        for i in range(lo, min(lo + NODE_BULK, n_docs)):
            src = {"body": texts[i], "likes": int(columns["likes"][i]),
                   "cat": cat_name(int(cats[i]))}
            if np.isfinite(columns["pop"][i]):
                src["pop"] = int(columns["pop"][i])
            lines.append(json.dumps({"index": {"_index": "catalog", "_type": "doc",
                                               "_id": str(i)}}))
            lines.append(json.dumps(src))
        st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
        assert st == 200 and not r["errors"], (st, r.get("items", [])[:2])
    bulk_s = time.perf_counter() - t0
    st, r = http_json(conn, "POST", "/catalog/_refresh")
    assert st == 200 and r["_shards"]["failed"] == 0, r
    conn.close()
    svc = node.indices.index_service("catalog")
    searchers = [svc.shard(sid).engine.acquire_searcher() for sid in range(NODE_SHARDS)]
    assert sum(sr.max_doc for sr in searchers) == n_docs
    ctxs = [ShardContext(sr, svc.mapper_service, svc.similarity_service, device=device)
            for sr in searchers]

    # the traffic: df ranks within the catalog's docs
    inside = np.concatenate([[0], np.cumsum(inv_docs < n_docs)])
    df = inside[offsets[1:]] - inside[offsets[:-1]]
    ranked = np.argsort(-df, kind="stable")
    rng = np.random.default_rng(seed + 2)
    per = n_requests // (len(SORT_AGG_FAMILIES) + 2) + 1
    fam = sort_agg_bodies(rng, ranked[RANKS[0]: RANKS[1]],
                          ranked[BOOL_RANKS[0]: BOOL_RANKS[1]], per)
    pool = ranked[RANKS[0]: RANKS[1]]

    def should():
        return {"bool": {"should": [{"term": {"body": term_name(int(t))}}
                                    for t in rng.choice(pool, TERMS_PER_QUERY)]}}

    fam["facets"] = [{"query": should(), "size": 5, "facets": {
        "cats": {"terms": {"field": "cat", "size": 10}}}} for _ in range(per)]
    fam["sort_url"] = [{"query": should(), "size": 10} for _ in range(per)]
    entries = [(f, uncached(b)) for f, bs in fam.items() for b in bs]
    entries = [entries[i] for i in rng.permutation(len(entries))[:n_requests]]

    def path_of(f: str) -> str:
        return "/catalog/_search" + ("?sort=pop:desc" if f == "sort_url" else "")

    def exact_total(body) -> int:
        terms = [int(c["term"]["body"][1:]) for c in body["query"]["bool"]["should"]]
        docs = term_docs(offsets, inv_docs, terms)
        if "post_filter" in body:
            docs = np.intersect1d(docs, term_docs(
                offsets, inv_docs, [int(body["post_filter"]["term"]["body"][1:])]))
        return int((docs < n_docs).sum())

    requests = [(path_of(f), b) for f, b in entries]
    # first sightings pack each shard's segments and build its agg rows,
    # bucket columns and sort keys: warm before the clock
    warm = serve_http(port, requests[: 2 * n_callers]
                      + [(path_of(f), uncached(bs[0])) for f, bs in fam.items()],
                      n_callers, sync_error=False)
    assert not warm[3], warm[3][:3]
    before = dict(SERVING_COUNTERS)
    # where the search pool's CPU goes: the shard query phase (its pull
    # wait, the spin of `torch.cuda.Event.synchronize`, and its general host
    # path inside it), the partials' pickling, the fetch phase and the
    # coordinator's reduce
    clock = SpanClock([
        ("query phase", tactions, "execute_query_phase"),
        ("query phase: pull wait", cudaenv.PendingPull, "wait"),
        ("query phase: general host path", tservice, "_general_host_path"),
        ("query phase: sorted launches", texecute, "score_sorted_batch_async"),
        ("query phase: aggregating launches", texecute, "score_agg_batch_async"),
        ("query phase: filtered launches", texecute, "score_filtered_batch_async"),
        ("encode partials", tactions, "_encode_partials"),
        ("fetch phase", tactions, "execute_fetch_phase"),
        ("coordinator: sort_docs", tactions, "sort_docs"),
        ("coordinator: merge_responses", tactions, "merge_responses")])
    responses, lat_ms, wall_s, errors, host_cpu = serve_http(
        port, requests, n_callers, sync_error=on_card, window=clock)
    spans = clock.report()
    counted = {k: v - before[k] for k, v in SERVING_COUNTERS.items() if v != before[k]}
    assert not errors, f"{len(errors)} requests failed, first {errors[:3]}"
    want_counted = {}
    for f, _b in entries:
        c = SORT_AGG_COUNTER[f]
        want_counted[c] = want_counted.get(c, 0) + NODE_SHARDS
    assert counted == want_counted, f"serving counters {counted} != {want_counted}"

    # every response against the shards' host query phases, reduced
    t0 = time.perf_counter()
    for i, ((f, body), (st, r)) in enumerate(zip(entries, responses)):
        assert st == 200, (i, f, r)
        assert r["_shards"] == SHARDS_OK, (i, r["_shards"])
        req = parse_search_body(dict(body, sort=[{"pop": "desc"}]) if f == "sort_url"
                                else body)
        res = [execute_query_phase(c, req, use_device=False, shard_id=sid)
               for sid, c in enumerate(ctxs)]
        merged = sort_docs(req, res)
        want = merge_responses(req, merged, res, [], took_ms=0,
                               total_shards=NODE_SHARDS, successful=NODE_SHARDS)
        assert r["hits"]["total"] == want["hits"]["total"] == exact_total(body), \
            (i, f, "total")
        want_hits = []
        for score, sid, doc, sv in merged.hits[req.from_: req.from_ + req.size]:
            seg, local = searchers[sid].resolve(doc)
            want_hits.append((score, (sid, seg.ids[local]), sv))
        got_hits = [(float("nan") if h["_score"] is None else h["_score"],
                     (h["_shard"], h["_id"]), h.get("sort")) for h in r["hits"]["hits"]]
        assert shard_docs_match(got_hits, want_hits, bool(req.sort)), (i, f, "hits")
        if req.aggs:
            agg_close(r["aggregations"], want["aggregations"], req.body, AGG_RTOL,
                      f"{f}[{i}]")
        if req.facets:
            assert r["facets"] == want["facets"], (i, f, "facets")
    check_s = time.perf_counter() - t0
    by_family = {}
    for f in fam:
        lat = np.asarray([ms for (g, _b), ms in zip(entries, lat_ms) if g == f])
        if len(lat):
            by_family[f] = dict(requests=len(lat), p50=float(np.percentile(lat, 50)),
                                p99=float(np.percentile(lat, 99)))
    out = dict(docs=n_docs, bulk_s=bulk_s, bulk_docs_per_s=n_docs / bulk_s,
               segments_per_shard=[len(sr.segments) for sr in searchers],
               requests=len(entries), callers=n_callers, wall_s=wall_s,
               requests_per_s=len(entries) / wall_s, latency_ms=by_family,
               counters=counted, host_cpu_s=host_cpu, spans=spans,
               check_s=check_s,
               sync_debug="error over the whole timed run" if on_card else None)
    log(f"[13] node leg on phase 10's node: `catalog`, {NODE_SHARDS} shards, {n_docs} docs "
        f"bulked over HTTP at {out['bulk_docs_per_s']:.1f} docs/s; {len(entries)} _search "
        f"requests from {n_callers} connections: {out['requests_per_s']:.1f} requests/s; "
        f"serving counters {counted}; every response == the shards' host query phases "
        f"reduced (hits, sort values, totals == exact counts; aggregations: counts, "
        f"keys, min, max exact, sums rel {AGG_RTOL}; facets exact; {check_s:.1f} s)")
    for f, v in by_family.items():
        log(f"[13]   {f:16s} {v['requests']:4d} requests, p50 {v['p50']:.2f} ms, "
            f"p99 {v['p99']:.2f} ms")
    log("[13] node leg CPU s by thread kind over the "
        f"{wall_s:.2f} s window: "
        + ", ".join(f"{k} {v:.2f}" for k, v in host_cpu.items()))
    for name, v in spans.items():
        log(f"[13]   span {name:35s} {v['calls']:5d} calls, CPU {v['cpu_s']:.2f} s, "
            f"wall {v['wall_s']:.2f} s")
    return out


def merged_csr(csr: list, vocab: int):
    """The CSR of phase 2's three segments as one segment, in one piece:
    each term's postings of segment 0, then 1, then 2, doc ids rebased (what
    `merge_segments` makes of fully live sources, without its walk over
    every posting). Returns (offsets, docs, freqs, lengths)."""
    from elasticsearch_tpu_torch.ops.device_index import expand_ranges

    counts = [np.diff(s["offsets"]) for s in csr]
    offsets = np.zeros(vocab + 1, np.int64)
    np.cumsum(np.sum(counts, axis=0), out=offsets[1:])
    docs = np.empty(int(offsets[-1]), np.int32)
    freqs = np.empty(int(offsets[-1]), np.float32)
    prior = offsets[:-1].copy()
    for s, c in zip(csr, counts):
        dest = expand_ranges(prior, c)
        docs[dest] = s["docs"] + s["lo"]
        freqs[dest] = s["freqs"]
        prior += c
    return offsets, docs, freqs, np.concatenate([s["lengths"] for s in csr])


def csr_segment(term_dict, offsets, docs, freqs, lengths, gen: int):
    """A fully live port segment of one text field from CSR arrays."""
    from elasticsearch_tpu_torch.common.smallfloat import encode_norm
    from elasticsearch_tpu_torch.convert import segment_from_arrays

    n = len(lengths)
    return segment_from_arrays(
        term_dict, offsets, docs, freqs, {"body": encode_norm(lengths)},
        {"body": {"doc_count": n, "sum_ttf": int(lengths.sum()), "sum_dfs": len(docs)}},
        np.ones(n, bool), np.ones(n, bool), gen=gen)


def packs_equal(a, b) -> list:
    """The fields where two packs differ (tensors bitwise, on the card)."""
    import torch

    bad = [f for f in ("gen", "doc_count", "doc_pad", "tf_layout", "tf_integral",
                       "live_gen") if getattr(a, f) != getattr(b, f)]
    for f in ("blk_docs", "blk_tf", "blk_nb", "live_parent"):
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            bad.append(f)
    if a.norm_bytes.keys() != b.norm_bytes.keys() or not all(
            torch.equal(a.norm_bytes[f], b.norm_bytes[f]) for f in a.norm_bytes):
        bad.append("norm_bytes")
    for f in ("term_blk_start", "host_docs", "host_freqs"):
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            bad.append(f)
    return bad


def plane_bytes(p) -> int:
    return sum(t.numel() * t.element_size() for t in (p.blk_docs, p.blk_tf, p.blk_nb))


def write_path_phase(device, csr: list, vocab: int, query_rows, *, seed: int) -> dict:
    """Phase 14, the library leg, on phase 2's corpus without tombstones: the
    three segments packed on the card, their merged segment built from the
    same CSR in one piece, packed by `pack_segment_concat` (B7 on the card:
    host half and device program timed apart) and by the staged
    `pack_segment`, every field held bitwise; then phase 3's queries over
    the merged pack and over the three sources, hits held equal."""
    import torch

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.index.engine import Searcher
    from elasticsearch_tpu_torch.mapper import MapperService
    from elasticsearch_tpu_torch.ops import device_index, scoring
    from elasticsearch_tpu_torch.ops.device_index import (
        BLOCK, concat_source_packs, pack_cache_key, pack_segment, pack_segment_concat,
        pack_shape_math, packed_for, tf_plane_itemsize)
    from elasticsearch_tpu_torch.search import (
        ShardContext, SimilarityService, parse_query, search_shard_batch)

    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    term_dict = {"body": {term_name(t): t for t in range(vocab)}}
    sources = [csr_segment(term_dict, s["offsets"], s["docs"], s["freqs"], s["lengths"],
                           gen=g) for g, s in enumerate(csr)]
    t0 = time.perf_counter()
    src_packs = [packed_for(seg, device) for seg in sources]
    sync()
    sources_pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    merged = csr_segment(term_dict, *merged_csr(csr, vocab), gen=len(csr))
    merged_build_s = time.perf_counter() - t0
    assert concat_source_packs(sources, device) is not None, "sources not eligible"

    # B7: the device program's CUDA events and host call time, inside the
    # concat's host wall
    program = {}
    real_program = scoring.concat_pack_planes

    def timed_program(*args, **kwargs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if on_card else None
        if ev:
            ev[0].record()
        t = time.perf_counter()
        out = real_program(*args, **kwargs)
        program["host_s"] = time.perf_counter() - t
        if ev:
            ev[1].record()
        program["events"], program["args"], program["kwargs"] = ev, args, kwargs
        return out

    real_tables = device_index.concat_tables

    def timed_tables(*args, **kwargs):
        t = time.perf_counter()
        out = real_tables(*args, **kwargs)
        program["tables_s"] = time.perf_counter() - t
        return out

    scoring.concat_pack_planes = timed_program
    device_index.concat_tables = timed_tables
    runs = []
    try:
        for _ in range(2):  # the first call warms the allocator
            t0 = time.perf_counter()
            concat = pack_segment_concat(merged, sources, device)
            returned_s = time.perf_counter() - t0
            sync()
            assert concat is not None, "pack_segment_concat refused eligible sources"
            ev = program["events"]
            runs.append(dict(wall_s=time.perf_counter() - t0, returned_s=returned_s,
                             host_s=program["host_s"], tables_s=program["tables_s"],
                             events_ms=ev[0].elapsed_time(ev[1]) if ev else None))
            if len(runs) == 1:
                del concat
    finally:
        scoring.concat_pack_planes = real_program
        device_index.concat_tables = real_tables
    args, kwargs = program["args"], program["kwargs"]
    graph_program_ms = None
    if on_card:
        try:
            graph_program_ms = graph_ms(lambda: real_program(*args, **kwargs), 1)
        except Exception as e:  # noqa: BLE001 — a time, not a check
            graph_program_ms = f"not measured: {e!r}"
    del args, kwargs, program["args"], program["kwargs"]
    t0 = time.perf_counter()
    staged = pack_segment(merged, device)
    sync()
    staged_s = time.perf_counter() - t0
    bad = packs_equal(concat, staged)
    assert not bad, f"concat pack != staged pack in {bad}"

    NBpad, Dpad, layout = pack_shape_math(merged)
    W, T = len(sources), vocab
    norm_cols = Dpad * (1 + len(merged.norms))  # live mask + norm bytes
    staged_upload = NBpad * BLOCK * (4 + tf_plane_itemsize(layout) + 1) + norm_cols
    tables = NBpad * 4 * 2 + (2 * W + 1) * T * 4 + W * 4 * 2
    concat_upload = tables + norm_cols
    b7_bytes = sum(plane_bytes(p) for p in src_packs) + tables + plane_bytes(concat)
    b7_bound_ms, b7_bound_by = bound_ms(b7_bytes, 0.0)

    # phase 3's queries over 1 merged segment and over the 3 sources
    def ctx_for(segs):
        settings = Settings.from_flat(BM25_SETTINGS)
        svc = MapperService(settings)
        svc.put_mapping("doc", SHARD_MAPPING)
        return ShardContext(Searcher(segs), svc, SimilarityService(settings, svc),
                            device=device)

    def dense(p, row) -> bool:  # past tb_max: the dense fallback
        return sum(int(p.term_blk_start[t + 1] - p.term_blk_start[t]) for t in row) > TB_MAX

    rows = query_rows[:64]
    queries = [parse_query({"bool": {"should": [{"term": {"body": term_name(int(t))}}
                                                for t in row]}}) for row in rows]
    merged._device_cache[pack_cache_key(device)] = concat
    results, per = {}, {}
    for name, segs in (("merged", [merged]), ("sources", sources)):
        ctx = ctx_for(segs)
        search_shard_batch(ctx, queries, K)  # the lazy dense planes, if any
        cudaenv.LAUNCHES.reset()
        t0 = time.perf_counter()
        results[name] = search_shard_batch(ctx, queries, K)
        ms = (time.perf_counter() - t0) * 1e3
        per[name] = dict(segments=len(segs), ms=ms,
                         launches=cudaenv.LAUNCHES.snapshot().get("sparse_score", 0))
    bitwise = tolerant = 0
    for i, (m, s) in enumerate(zip(results["merged"], results["sources"])):
        assert m.total == s.total, f"query {i}: total {m.total} != {s.total}"
        if dense(concat, rows[i]) or any(dense(p, rows[i]) for p in src_packs):
            # the dense fallback's sums differ in the last place between the
            # merged segment and its sources: 2 ulp, tie-tolerant
            assert tie_tolerant_equal(m.hits, s.hits), f"query {i}: hits differ"
            tolerant += 1
        else:
            assert m.hits == s.hits, f"query {i}: hits not bitwise equal"
            bitwise += 1
    out = dict(
        docs=merged.doc_count, postings=len(merged.post_docs), slots=NBpad * BLOCK,
        tf_layout=layout, sources_pack_s=sources_pack_s, merged_build_s=merged_build_s,
        concat_runs=runs, concat_wall_s=runs[-1]["wall_s"],
        concat_host_half_s=runs[-1]["returned_s"] - runs[-1]["host_s"],
        concat_tables_s=runs[-1]["tables_s"],
        program_events_ms=runs[-1].get("events_ms"), program_graph_ms=graph_program_ms,
        staged_s=staged_s, concat_upload_bytes=concat_upload,
        staged_upload_bytes=staged_upload, b7_bytes=b7_bytes, b7_bound_ms=b7_bound_ms,
        b7_bound_by=b7_bound_by, queries=len(queries), bitwise=bitwise,
        tolerant=tolerant, search=per)
    log(f"[14] library leg: {merged.doc_count} docs, {out['postings']} postings in 3 fully "
        f"live segments, packed in {sources_pack_s:.2f} s; merged segment from the same "
        f"CSR in {merged_build_s:.2f} s; pack_segment_concat == pack_segment(merged) in "
        f"every field (bitwise, {out['slots']} slots, tf {layout})")
    log(f"[14] B7 concat: wall {out['concat_wall_s'] * 1e3:.3f} ms (first call "
        f"{runs[0]['wall_s'] * 1e3:.3f} ms), host half {out['concat_host_half_s'] * 1e3:.3f} ms "
        f"(of it the per-term tables {out['concat_tables_s'] * 1e3:.3f} ms, the rest the "
        f"retained host copies and the columns), "
        f"device program {out['program_events_ms']} ms (events; host call "
        f"{runs[-1]['host_s'] * 1e3:.3f} ms), in a CUDA graph {graph_program_ms} ms; bound "
        f"{b7_bound_ms:.4f} ms ({b7_bound_by}, {b7_bytes / 1e6:.1f} MB); uploads "
        f"{concat_upload / 1e6:.2f} MB against the staged pack's "
        f"{staged_upload / 1e6:.2f} MB, which took {staged_s * 1e3:.3f} ms (host wall)")
    log(f"[14] {len(queries)} of phase 3's queries, top-{K}: hits over 1 merged segment == "
        f"over the 3 sources ({bitwise} bitwise, {tolerant} within {ULPS} ulp: the dense "
        f"fallback); sparse_score launches, ms a batch: 1 segment "
        f"{per['merged']['launches']}, {per['merged']['ms']:.3f}; 3 segments "
        f"{per['sources']['launches']}, {per['sources']['ms']:.3f}")
    for seg in (merged, *sources):
        seg._device_cache.clear()
    del concat, staged, src_packs, results
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


def writes_node_phase(device, node, port: int, *, texts, offsets, inv_docs, seed: int,
                      n_docs: int, n_requests: int, n_callers: int) -> dict:
    """Phase 14, the node leg, on phase 10's node: a `writes` index (5
    shards, `refresh_interval: -1`) of `n_docs` of phase 10's texts; one
    `_search` opens the warmer's gate; then WRITE_ROUNDS rounds of a
    `_bulk` of NODE_BULK new docs, `_refresh`, a wait for the warmer, and
    `n_requests` `_search` requests under `set_sync_debug_mode("error")`,
    every response held against exact totals and the shards'
    `search_shard_batch`; every pack after the gate on the warmer or merge
    pool; then `_optimize`: one segment a shard, packed by the concat on
    the merge pool, the same hits."""
    import http.client

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.ops.device_index import PACK_LEDGER
    from elasticsearch_tpu_torch.search import ShardContext, parse_query, search_shard_batch

    on_card = device.type == "cuda"
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    st, r = http_json(conn, "PUT", "/writes", {"settings": {
        "number_of_shards": NODE_SHARDS, "refresh_interval": -1}})
    assert st == 200 and r["acknowledged"], r
    indexed = 0

    def bulk(lo, hi):
        for a in range(lo, hi, NODE_BULK):
            lines = []
            for i in range(a, min(a + NODE_BULK, hi)):
                lines.append(json.dumps({"index": {"_index": "writes", "_type": "doc",
                                                   "_id": str(i)}}))
                lines.append(json.dumps({"body": texts[i]}))
            st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
            assert st == 200 and not r["errors"], (st, r.get("items", [])[:2])
        st, r = http_json(conn, "POST", "/writes/_refresh")
        assert st == 200 and r["_shards"]["failed"] == 0, r

    t0 = time.perf_counter()
    bulk(0, n_docs)
    indexed = n_docs
    load_s = time.perf_counter() - t0
    svc = node.indices.index_service("writes")
    engines = [svc.shard(sid).engine for sid in range(NODE_SHARDS)]

    inside = np.concatenate([[0], np.cumsum(inv_docs < n_docs)])
    df = inside[offsets[1:]] - inside[offsets[:-1]]
    ranked = np.argsort(-df, kind="stable")
    rng = np.random.default_rng(seed)
    rows = rng.choice(ranked[RANKS[0]: RANKS[1]], size=(n_requests, TERMS_PER_QUERY))
    bodies = [{"query": {"bool": {"should": [{"term": {"body": term_name(int(t))}}
                                             for t in row]}}, "size": NODE_SIZE}
              for row in rows]

    def drained() -> bool:
        st = node.warmer.stats()
        return st["packs_done"] >= st["packs_scheduled"]

    def wait_drained(timeout=120.0):
        deadline = time.perf_counter() + timeout
        while not drained():
            assert time.perf_counter() < deadline, f"warmer not drained: {node.warmer.stats()}"
            time.sleep(0.01)

    def check(responses, step):
        """Each response against the exact total over the indexed docs and
        the shards' search_shard_batch reduced by score desc, shard, doc."""
        searchers = [e.acquire_searcher() for e in engines]
        want = [[] for _ in bodies]
        for sid, searcher in enumerate(searchers):
            ctx = ShardContext(searcher, svc.mapper_service, svc.similarity_service,
                               device=device)
            tops = search_shard_batch(ctx, [parse_query(b["query"]) for b in bodies],
                                      NODE_SIZE)
            for i, td in enumerate(tops):
                want[i].extend((score, sid, doc) for score, doc in td.hits)
        hits = []
        for i, ((st, r), row) in enumerate(zip(responses, rows)):
            assert st == 200, (step, i, r)
            assert r["_shards"] == SHARDS_OK, (step, i, r["_shards"])
            docs = term_docs(offsets, inv_docs, [int(t) for t in row])
            assert r["hits"]["total"] == int((docs < indexed).sum()), (step, i, "total")
            want[i].sort(key=lambda e: (-e[0], e[1], e[2]))
            ref = []
            for score, sid, doc in want[i][:NODE_SIZE]:
                seg, local = searchers[sid].resolve(doc)
                ref.append((seg.ids[local], score, sid))
            got = [(h["_id"], h["_score"], h["_shard"]) for h in r["hits"]["hits"]]
            assert got == ref, (step, i, "hits")
            hits.append(got)
        return hits

    # the gate: the first search packs inline, by design; nothing after it may
    st, r = http_json(conn, "POST", "/writes/_search", bodies[0])
    assert st == 200 and all(e.search_active for e in engines), r
    wait_drained()
    PACK_LEDGER.forget("writes")
    rounds = []
    for rnd in range(WRITE_ROUNDS):
        t0 = time.perf_counter()
        bulk(indexed, indexed + NODE_BULK)
        indexed += NODE_BULK
        refresh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        wait_drained()
        warm_s = time.perf_counter() - t0
        cudaenv.LAUNCHES.reset()
        responses, lat_ms, wall_s, errors, _cpu = serve_http(
            port, [("/writes/_search", b) for b in bodies], n_callers, sync_error=on_card)
        assert not errors, f"round {rnd}: {len(errors)} requests failed, first {errors[:3]}"
        launches = cudaenv.LAUNCHES.snapshot().get("sparse_score", 0)
        before_hits = check(responses, f"round {rnd}")
        rounds.append(dict(bulk_refresh_s=refresh_s, warm_wait_s=warm_s,
                           segments=[e.segment_count() for e in engines],
                           requests_per_s=len(bodies) / wall_s,
                           p50_ms=float(np.percentile(lat_ms, 50)),
                           launches_per_request=launches / len(bodies)))
    ledger = PACK_LEDGER.stats("writes")
    assert ledger["delta_packs"] >= WRITE_ROUNDS * NODE_SHARDS, ledger
    assert set(ledger["pools"]) <= {"warmer", "merge"}, ledger["pools"]
    if on_card:
        assert rounds[-1]["launches_per_request"] > 0, "sparse_score never launched"

    # _optimize: one segment a shard, packed by the concat on the merge pool
    before = rounds[-1]
    PACK_LEDGER.forget("writes")
    t0 = time.perf_counter()
    st, r = http_json(conn, "POST", "/writes/_optimize")
    assert st == 200 and r["_shards"]["failed"] == 0, r
    optimize_s = time.perf_counter() - t0
    wait_drained()
    compact_s = time.perf_counter() - t0
    conn.close()
    assert [e.segment_count() for e in engines] == [1] * NODE_SHARDS
    ledger_opt = PACK_LEDGER.stats("writes")
    compacts = [e for e in ledger_opt["recent"] if e["kind"] == "compact"]
    assert ledger_opt["compacts"] == NODE_SHARDS and set(ledger_opt["pools"]) == {"merge"}, \
        ledger_opt
    assert all(e["method"] == "concat" for e in compacts), compacts
    cudaenv.LAUNCHES.reset()
    responses, lat_ms, wall_s, errors, _cpu = serve_http(
        port, [("/writes/_search", b) for b in bodies], n_callers, sync_error=on_card)
    assert not errors, f"after _optimize: {len(errors)} requests failed, first {errors[:3]}"
    launches = cudaenv.LAUNCHES.snapshot().get("sparse_score", 0)
    after_hits = check(responses, "after _optimize")
    assert after_hits == before_hits, "hits changed across _optimize"
    after = dict(requests_per_s=len(bodies) / wall_s, p50_ms=float(np.percentile(lat_ms, 50)),
                 launches_per_request=launches / len(bodies))
    out = dict(docs=indexed, load_s=load_s, rounds=rounds, ledger=ledger,
               optimize_s=optimize_s, compact_s=compact_s,
               compact_ms=[e["ms"] for e in compacts], before=before, after=after,
               requests=len(bodies), callers=n_callers,
               sync_debug="error over each round's requests" if on_card else None)
    log(f"[14] node leg on phase 10's node: `writes`, {NODE_SHARDS} shards, {n_docs} docs "
        f"({load_s:.1f} s), then {WRITE_ROUNDS} rounds of _bulk {NODE_BULK} + _refresh + "
        f"{len(bodies)} _search: every response == exact totals and the shards' "
        f"search_shard_batch; after the gate {ledger['delta_packs']} delta packs, "
        f"{ledger['remasks']} remasks, {ledger['packs']} packs, pools {ledger['pools']} "
        f"(zero on the query path)")
    for i, rd in enumerate(rounds):
        log(f"[14]   round {i}: bulk+refresh {rd['bulk_refresh_s']:.2f} s, warmer "
            f"{rd['warm_wait_s']:.3f} s, segments {rd['segments']}, "
            f"{rd['requests_per_s']:.1f} requests/s, p50 {rd['p50_ms']:.2f} ms, "
            f"{rd['launches_per_request']:.3f} launches a request")
    log(f"[14] _optimize {optimize_s:.2f} s, compaction packs (concat, merge pool) "
        f"{out['compact_ms']} ms; before / after on the same {len(bodies)} bodies: "
        f"{before['requests_per_s']:.1f} / {after['requests_per_s']:.1f} requests/s, p50 "
        f"{before['p50_ms']:.2f} / {after['p50_ms']:.2f} ms, sparse_score launches a "
        f"request {before['launches_per_request']:.3f} / "
        f"{after['launches_per_request']:.3f}; hits (ids, shards, float32 scores) unchanged")
    return out


# ---------------------------------------------------------------------------
# phase 15: device faults on the card
# ---------------------------------------------------------------------------


def fetch_phase(device, node, port: int, *, texts, bodies, seed: int,
                n_requests: int = FETCH_REQUESTS, n_small: int = FETCH_SMALL_DOCS,
                n_conn: int = FETCH_CONN) -> dict:
    """Phase 21, on phase 10's node before it closes: the fetch slice. (a)
    `n_requests` of phase 10's `bool` bodies from `n_conn` connections, plain
    and with `highlight` (the plain highlighter on even requests, `fvh` on
    odd ones: `corpus` holds one text field), `fields`, `version` and a
    script field; each leg's requests/s, p50/p99, the search pool's CPU by
    span, its `sparse_score` launches and, on the card, the device's idle
    share over a profiled window; every highlighted page equal to the plain
    leg's and each hit equal to the host path's fetch of it. (b) on a small
    index of its own with a `completion` and a `binary` field: `_suggest`
    (term, phrase, completion, fuzzy) twice around a write and a `_refresh`
    with the request cache on, `_explain`, `_termvector` with term
    statistics, an `_mtermvectors` of 8, `_mlt`, an `indices` query, a
    `template` query and a terms lookup, each checked, its wall and launches
    printed. `sparse_score` against its plain version at every shape the
    phase launched."""
    import contextlib

    import torch

    from elasticsearch_tpu_torch import actions as tactions
    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score
    from elasticsearch_tpu_torch.search import ShardContext, parse_search_body
    from elasticsearch_tpu_torch.search import fetch as tfetch
    from elasticsearch_tpu_torch.search import service as tservice

    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    out: dict = {}
    launches: dict = {}
    recorder = LaunchRecorder(scoring, sparse_score)

    def take() -> dict:
        """Launches since the last take, counted into the phase's, and the
        counts set to 0 again."""
        snap = cudaenv.LAUNCHES.snapshot()
        cudaenv.LAUNCHES.reset()
        for name, n in snap.items():
            launches[name] = launches.get(name, 0) + n
        return snap

    def clock():
        """Where a leg's time goes: the shard's query phase and inside it the
        `sparse_score` launches, the fetch phase and inside it each hit's
        assembly, its highlights and the two highlighters, and the
        coordinator's reduce."""
        return SpanClock([
            ("query phase", tactions, "execute_query_phase"),
            ("query phase:   sparse_score launch", scoring, "sparse_score"),
            ("fetch phase", tactions, "execute_fetch_phase"),
            ("fetch:   build_hit", tservice, "build_hit"),
            ("fetch:     build_highlights", tfetch, "build_highlights"),
            ("fetch:       highlight_field (plain)", tfetch, "highlight_field"),
            ("fetch:       fvh_highlight_field", tfetch, "fvh_highlight_field"),
            ("coordinator: sort_docs", tactions, "sort_docs"),
            ("coordinator: merge_responses", tactions, "merge_responses")])

    def leg(requests, profiled: bool):
        """One leg from `n_conn` connections: (responses, stats, spans,
        CPU s by thread kind); on the card a second, profiled pass of its
        first FETCH_PROFILED requests gives the device's idle share."""
        take()
        c = clock()
        if on_card:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with c:
                cpu0, process0 = thread_cpu_s(), time.process_time()
                got, lat, wall = http_requests(port, requests, n_conn)
                cpu = host_cpu_split(cpu0, thread_cpu_s(), time.process_time() - process0)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(0)
        sparse = take().get("sparse_score", 0)
        for i, (st, r) in enumerate(got):
            assert st == 200 and r["_shards"] == SHARDS_OK, (i, r)
        stats = dict(requests=len(requests), requests_per_s=len(requests) / wall,
                     p50_ms=float(np.percentile(lat, 50)),
                     p99_ms=float(np.percentile(lat, 99)), wall_s=wall,
                     sparse_launches=sparse)
        if on_card and profiled:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _g, _l, pwall = http_requests(port, requests[:FETCH_PROFILED], n_conn)
            p = device_busy(prof, pwall * 1e3)
            stats["idle_share"] = p["idle_share"]
            stats["profiled"] = dict(requests=FETCH_PROFILED, wall_ms=p["wall_ms"],
                                     device_busy_ms=p["device_busy_ms"], top=p["top"][:5])
            take()
        return got, stats, c.report(), cpu

    try:
        # -- (a) highlighted traffic on `corpus` -------------------------------
        n = min(n_requests, len(bodies))
        plain = [("POST", "/corpus/_search", b, None) for b in bodies[:n]]
        rich_bodies = [{**b, "fields": ["body"], "version": True,
                        "script_fields": {"twice": {"script": "_score * 2"}},
                        "highlight": {"fields": {"body": {} if i % 2 == 0
                                                 else {"type": "fvh"}}}}
                       for i, b in enumerate(bodies[:n])]
        rich = [("POST", "/corpus/_search", b, None) for b in rich_bodies]
        cudaenv.LAUNCHES.reset()  # what earlier phases launched is not this one's
        plain_resp, plain_stats, plain_spans, plain_cpu = leg(plain, profiled=True)
        rich_resp, rich_stats, rich_spans, rich_cpu = leg(rich, profiled=True)
        # correctness: the same pages as the plain leg; each hit the host
        # path's fetch of it on its shard's context
        svc = node.indices.index_service("corpus")
        host = [ShardContext(svc.shard(sid).engine.acquire_searcher(), svc.mapper_service,
                             svc.similarity_service, device="cpu", index_name="corpus")
                for sid in range(NODE_SHARDS)]
        where = [{} for _ in host]
        for sid, ctx in enumerate(host):
            for seg, base in zip(ctx.searcher.segments, ctx.searcher.bases):
                for local, doc_id in enumerate(seg.ids):
                    where[sid][doc_id] = base + local
        highlighted = 0
        for i, ((_s1, p), (_s2, r)) in enumerate(zip(plain_resp, rich_resp)):
            assert [(h["_id"], h["_score"], h["_shard"]) for h in r["hits"]["hits"]] == \
                [(h["_id"], h["_score"], h["_shard"]) for h in p["hits"]["hits"]], i
            req = parse_search_body(rich_bodies[i])
            for h in r["hits"]["hits"]:
                sid = h["_shard"]
                (want,) = tservice.execute_fetch_phase(
                    host[sid], req, [(h["_score"], where[sid][h["_id"]], None)],
                    index_name="corpus", shard_id=sid)
                assert h == want, (i, h, want)
                assert h["_version"] == 1 and h["fields"]["body"] == [texts[int(h["_id"])]]
                highlighted += "highlight" in h
        assert highlighted > 0
        if on_card:
            for stats in (plain_stats, rich_stats):
                assert stats["sparse_launches"] > 0, stats
            ratio = rich_stats["sparse_launches"] / plain_stats["sparse_launches"]
            assert 0.25 <= ratio <= 4.0, (plain_stats, rich_stats)
        out["traffic"] = dict(
            plain=plain_stats, highlighted=rich_stats, hits_highlighted=highlighted,
            spans=dict(plain=plain_spans, highlighted=rich_spans),
            host_cpu_s=dict(plain=plain_cpu, highlighted=rich_cpu))
        a = out["traffic"]
        for name, stats in (("plain", plain_stats), ("highlighted", rich_stats)):
            log(f"[21] (a) {name} leg: {n} of phase 10's bool bodies from {n_conn} "
                f"connections, {stats['requests_per_s']:.1f} requests/s, p50 "
                f"{stats['p50_ms']:.2f} ms p99 {stats['p99_ms']:.2f} ms, "
                f"{stats['sparse_launches']} sparse_score launches"
                + (f", device idle share {stats['idle_share']:.4f} over a profiled "
                   f"window of {FETCH_PROFILED}" if stats.get("idle_share") is not None
                   else ", device idle share not measured"))
            log(f"[21] (a) {name} leg, CPU s by thread kind over {stats['wall_s']:.2f} s: "
                + ", ".join(f"{k} {v:.2f}" for k, v in a["host_cpu_s"][name].items()))
            for span, v in a["spans"][name].items():
                log(f"[21]   span {span:38s} {v['calls']:5d} calls, CPU {v['cpu_s']:.3f} s, "
                    f"wall {v['wall_s']:.3f} s")
        log(f"[21] (a) every highlighted page == the plain leg's (ids, scores, shards); "
            f"each hit == the host path's fetch of it ({highlighted} hits highlighted, "
            f"plain on even requests, fvh on odd ones)")

        # -- (b) the rest of the slice on a small index of its own -------------
        out["small"] = fetch_small_index(port, texts, n_small, seed, take)
        recorder.close()
        out["kernel_shapes"] = [dict(Qb=k[0][0], TB=k[0][1], k=k[2], launches=v[2])
                                for k, v in recorder.shapes.items()]
        out["kernel_max_abs_err"] = check_shapes(recorder.shapes)
        out["launches"] = launches
        out["wall_s"] = time.perf_counter() - t_phase
        log(f"[21] sparse_score == plain (bitwise) at all {len(recorder.shapes)} shapes "
            f"phase 21 launched ({launches.get('sparse_score', 0)} launches); max abs err "
            f"{out['kernel_max_abs_err']}; phase 21 took {out['wall_s']:.1f} s")
        return out
    finally:
        recorder.close()


def fetch_small_index(port: int, texts, n_docs: int, seed: int, take) -> dict:
    """Phase 21 (b): `fetch_small` (`FETCH_SHARDS` shards, BM25) of `n_docs`
    of phase 10's texts with a title, a `completion` and a `binary` field and
    a keyword tag, and a lookup document; then each request of the slice's
    surface once, checked, with its wall and launches."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    rng = np.random.default_rng(seed)
    walls: dict = {}

    def req(name, method, path, body=None, ndjson=None, status=200):
        take()
        t0 = time.perf_counter()
        st, r = http_json(conn, method, path, body, ndjson=ndjson)
        walls[name] = dict(wall_ms=(time.perf_counter() - t0) * 1e3,
                           launches=take().get("sparse_score", 0))
        assert st == status, (name, st, r)
        return r

    try:
        # BM25: no query norm, so the host scorer's indices query and the
        # card's plain query score alike (within 2 ulp)
        st, r = http_json(conn, "PUT", "/fetch_small", {
            "settings": {"number_of_shards": FETCH_SHARDS, "refresh_interval": -1,
                         "index": {"similarity": {"default": {"type": "BM25"}}}},
            "mappings": {"doc": {"properties": {
                "title": {"type": "string"}, "body": {"type": "string"},
                "tag": {"type": "string", "index": "not_analyzed"},
                "suggest": {"type": "completion"}, "blob": {"type": "binary"}}}}})
        assert st == 200 and r["primaries_active"], r
        docs = []
        for i in range(n_docs):
            words = texts[i].split()
            docs.append({"title": " ".join(words[:3]), "body": texts[i],
                         "tag": words[0], "blob": "aGVsbG8=",
                         "suggest": {"input": [" ".join(words[:2]), words[2]],
                                     "output": f"{words[0]} {words[1]} #{i}",
                                     "weight": int(rng.integers(1, 1000))}})
        t0 = time.perf_counter()
        lines = []
        for i, d in enumerate(docs):
            lines += [json.dumps({"index": {"_index": "fetch_small", "_type": "doc",
                                            "_id": str(i)}}), json.dumps(d)]
        st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
        assert st == 200 and not r["errors"], r.get("items", [])[:2]
        tags = sorted({d["tag"] for d in docs[:40]})[:5]
        st, r = http_json(conn, "PUT", "/fetch_small/lists/l1", {"tags": tags})
        assert st == 201, r
        st, r = http_json(conn, "POST", "/fetch_small/_refresh")
        assert st == 200 and r["_shards"]["failed"] == 0, r
        load_s = time.perf_counter() - t0
        # warm each shard's first search (it packs the shard inline)
        http_json(conn, "POST", "/fetch_small/_search",
                  {"query": {"match": {"body": docs[0]["tag"]}}, "request_cache": False})

        # _suggest: term, phrase, completion and fuzzy completion, twice
        # (the second from the request cache), then a write and a refresh
        w = docs[7]["body"].split()
        long = next((t for t in w if len(t) >= 5), w[0])
        typo = long[:-1] + ("9" if long[-1] != "9" else "8")
        prefix = docs[3]["suggest"]["input"][0][:3]
        suggest = {"term": {"text": typo, "term": {"field": "body", "suggest_mode": "always"}},
                   "phrase": {"text": f"{w[1]} {typo}", "phrase": {"field": "body"}},
                   "completion": {"text": prefix, "completion": {"field": "suggest"}},
                   "fuzzy": {"text": prefix + "x", "completion": {
                       "field": "suggest", "fuzzy": {"fuzziness": 1}}}}
        first = req("suggest (miss)", "POST", "/fetch_small/_suggest", suggest)
        second = req("suggest (hit)", "POST", "/fetch_small/_suggest", suggest)
        assert second == first and walls["suggest (hit)"]["launches"] == 0
        assert all(first[k][0]["options"] for k in ("term", "completion", "fuzzy")), first
        top = {"input": prefix + "zz", "output": "the new top", "weight": 100_000}
        st, r = http_json(conn, "PUT", "/fetch_small/doc/new", {
            "title": "new", "body": w[1], "suggest": top})
        assert st == 201, r
        assert http_json(conn, "POST", "/fetch_small/_refresh")[0] == 200
        third = req("suggest (after refresh)", "POST", "/fetch_small/_suggest", suggest)
        assert third["completion"][0]["options"][0]["text"] == "the new top", third

        # _explain: matched, its value the hit's score (the explain search's
        # bool with an ids filter runs on the host scorer: within 2 ulp)
        q = {"match": {"body": " ".join(w[:2])}}
        r = req("search (for explain)", "POST", "/fetch_small/_search", {"query": q, "size": 1})
        hit = r["hits"]["hits"][0]
        r = req("explain", "POST", f"/fetch_small/doc/{hit['_id']}/_explain", {"query": q})
        assert r["matched"] and within_ulps(r["explanation"]["value"], hit["_score"], ULPS), \
            (r, hit)

        # term vectors: each field's tokens and statistics
        r = req("termvector", "GET", "/fetch_small/doc/7/_termvector?term_statistics=true")
        tv = r["term_vectors"]["body"]
        assert sum(t["term_freq"] for t in tv["terms"].values()) == len(w)
        assert all(t["doc_freq"] >= 1 and t["ttf"] >= t["term_freq"]
                   for t in tv["terms"].values())
        r = req("mtermvectors of 8", "POST", "/fetch_small/doc/_mtermvectors",
                {"ids": [str(i) for i in range(8)]})
        assert len(r["docs"]) == 8 and all(d["found"] for d in r["docs"])

        # more like this: similar documents, the document itself excluded
        r = req("mlt", "GET", "/fetch_small/doc/7/_mlt?min_term_freq=1&min_doc_freq=1"
                "&mlt_fields=body")
        assert r["hits"]["total"] > 0 and "7" not in [h["_id"] for h in r["hits"]["hits"]]

        # indices query, template query, terms lookup: each equal to its
        # plain counterpart (the indices query runs on the host scorer: the
        # same order within 2 ulp, tie-tolerant)
        plain_q = {"match": {"body": " ".join(w[2:5])}}
        want = req("plain query", "POST", "/fetch_small/_search", {"query": plain_q})

        def page(resp):
            return [(h["_score"], (h["_shard"], h["_id"])) for h in resp["hits"]["hits"]]

        r = req("indices query", "POST", "/fetch_small/_search", {"query": {"indices": {
            "indices": ["fetch_*"], "query": plain_q, "no_match_query": "none"}}})
        assert r["hits"]["total"] == want["hits"]["total"]
        assert tie_tolerant_equal(page(r), page(want)), "indices query"
        r = req("template query", "POST", "/fetch_small/_search", {"query": {"template": {
            "query": {"match": {"body": "{{q}}"}}, "params": {"q": " ".join(w[2:5])}}}})
        assert r["hits"] == want["hits"], "template query"
        literal = {"filtered": {"query": plain_q, "filter": {"terms": {"tag": tags}}}}
        lookup = {"filtered": {"query": plain_q, "filter": {"terms": {"tag": {
            "index": "fetch_small", "type": "lists", "id": "l1", "path": "tags"}}}}}
        want = req("terms literal", "POST", "/fetch_small/_search", {"query": literal})
        r = req("terms lookup", "POST", "/fetch_small/_search", {"query": lookup})
        assert r["hits"] == want["hits"], ("terms lookup", r["hits"], want["hits"])
        log(f"[21] (b) `fetch_small` ({FETCH_SHARDS} shards, {n_docs} docs with a "
            f"completion and a binary field) loaded in {load_s:.1f} s; each request "
            f"checked, wall ms and sparse_score launches:")
        for name, v in walls.items():
            log(f"[21]   {name:26s} {v['wall_ms']:9.2f} ms {v['launches']:4d} launches")
        return dict(docs=n_docs, load_s=load_s, requests=walls)
    finally:
        conn.close()


def pooled_requests(port: int, n: int, n_conn: int, send) -> tuple[list, np.ndarray, float]:
    """`send(conn, i)` for each i < n from `n_conn` threads of this process,
    each on its own keep-alive connection: (results, per-request ms, wall
    s)."""
    import http.client
    from concurrent.futures import ThreadPoolExecutor

    out, lat_ms = [None] * n, np.zeros(n)
    local = threading.local()
    conns = []

    def one(i):
        conn = getattr(local, "conn", None)
        if conn is None:
            conn = local.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            conns.append(conn)
        t0 = time.perf_counter()
        out[i] = send(conn, i)
        lat_ms[i] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(n_conn) as ex:
            list(ex.map(one, range(n)))
    finally:
        for conn in conns:
            conn.close()
    return out, lat_ms, time.perf_counter() - t0


def http_requests(port: int, requests: list, n_conn: int) -> tuple[list, np.ndarray, float]:
    """`requests` [(method, path, JSON body or None, NDJSON text or None)]
    sent by `n_conn` threads of this process, each on its own keep-alive
    connection: (responses, per-request ms, wall s)."""
    def send(conn, i):
        method, path, body, ndjson = requests[i]
        return http_json(conn, method, path, body, ndjson=ndjson)

    return pooled_requests(port, len(requests), n_conn, send)


def http_burst(port: int, requests: list, n_conn: int) -> tuple[list, float]:
    """`requests` [(path, body)] POSTed by `n_conn` threads of this process,
    each on its own keep-alive connection: (responses, wall s)."""
    out, _lat_ms, wall_s = http_requests(
        port, [("POST", path, body, None) for path, body in requests], n_conn)
    return out, wall_s


def fault_hits(family: str, r: dict) -> list:
    """A response's page as phase 13's comparator reads it: [(score, (shard,
    id), sort values)]."""
    return [(float("nan") if h["_score"] is None else h["_score"],
             (h["_shard"], h["_id"]), h.get("sort")) for h in r["hits"]["hits"]]


def at_fault_bar(family: str, body: dict, got: dict, want: dict) -> None:
    """Phase 15's bar between a degraded answer and the card's: totals
    exact; a field sort in the same order with the same sort values; scores
    tie-tolerant within 2 ulp (the host scorer against the card, tests/
    test_torch_host_scorer.py's bar); aggregations as phase 13 holds them."""
    assert got["hits"]["total"] == want["hits"]["total"], (family, "total")
    assert shard_docs_match(fault_hits(family, got), fault_hits(family, want),
                            family == "sort"), (family, "hits")
    if family == "aggs":
        agg_close(got["aggregations"], want["aggregations"], body)


def faults_phase(device, node, port: int, *, texts, ranked, bool_bodies, seed: int,
                 n_conn: int = FAULT_CONNECTIONS) -> dict:
    """Phase 15 (a), on phase 10's node: the device fault domains on the
    card. Pins the card's answers to FAULT_BOOL of phase 3's `bool` bodies
    (`corpus`) and FAULT_FAMILY each of `filtered`, function_score rows,
    a field sort and a terms agg (`catalog`), then arms each domain of
    FAULT_DOMAINS in turn with a persistent kind: the blocked families
    answer 200 from the host path at their bar with `_shards.degraded`, the
    domain is open, the blocked family launches nothing (`sparse_score`'s
    count, the dense families' serving counters) under
    `set_sync_debug_mode("error")` while the others stay on the card; then
    disarms and waits for the probe to close it. `pack:writes` is armed
    before a 1,000-doc `_bulk` and `_refresh` into phase 14's `writes`
    index, its answers held against the shards' host query phases. Last,
    `oom` twice at `pull:corpus`: the circuit stays closed, the batch is
    split and the neighbours are served by the card. The card's answers and
    the `pull:*` window are sent FAULT_RATE_REPS times over, the two request
    rates compared."""
    import http.client

    import torch

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.common.devicehealth import CLOSED, DEVICE_HEALTH, OPEN
    from elasticsearch_tpu_torch.search import SERVING_COUNTERS, ShardContext
    from elasticsearch_tpu_torch.transport.faults import DEVICE_FAULTS

    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    assert SERVING_COUNTERS["degraded"] == 0 and SERVING_COUNTERS["device_errors"] == 0, \
        f"phases before 15 degraded: {SERVING_COUNTERS}"
    # a warm pack that failed on the card is recorded by the warmer, not by
    # the serving counters
    assert not DEVICE_HEALTH.dirty, f"phases before 15 failed: {DEVICE_HEALTH.stats()}"
    assert node.warmer.stats()["pack_failures"] == 0, node.warmer.stats()
    counted0 = dict(SERVING_COUNTERS)
    rng = np.random.default_rng(seed)
    dense = dense_family_bodies(rng, ranked, FAULT_FAMILY)
    sa = sort_agg_bodies(rng, ranked[RANKS[0]: RANKS[1]],
                         ranked[BOOL_RANKS[0]: BOOL_RANKS[1]], FAULT_FAMILY)
    entries = ([("bool", "/corpus/_search", b) for b in bool_bodies[:FAULT_BOOL]]
               + [("filtered", "/catalog/_search", b) for b in dense["filtered"]]
               + [("function_score", "/catalog/_search", b) for b in dense["fs_rows"]]
               + [("sort", "/catalog/_search", b) for b in sa["sort_asc"]]
               + [("aggs", "/catalog/_search", uncached(b)) for b in sa["aggs_terms"]])
    writes = [("writes", "/writes/_search", b) for b in bool_bodies[:FAULT_BOOL]]
    launched = {"sparse_score": 0}

    def take_launches() -> int:
        n = cudaenv.LAUNCHES.snapshot().get("sparse_score", 0)
        cudaenv.LAUNCHES.reset()
        launched["sparse_score"] += n
        return n

    def send(batch, sync_error=False):
        if sync_error and on_card:
            torch.cuda.set_sync_debug_mode("error")
        try:
            responses, wall = http_burst(port, [(p, b) for _f, p, b in batch], n_conn)
        finally:
            if sync_error and on_card:
                torch.cuda.set_sync_debug_mode(0)
        for (f, _p, _b), (st, r) in zip(batch, responses):
            assert st == 200, (f, r)
        return [r for _st, r in responses], wall

    def deltas(before) -> dict:
        return {k: SERVING_COUNTERS[k] - before[k] for k in SERVING_COUNTERS}

    # -- the card's answers, pinned ------------------------------------------
    DEVICE_HEALTH.reset()
    take_launches()
    before = dict(SERVING_COUNTERS)
    base, base_wall = send(entries * FAULT_RATE_REPS)
    base_requests = len(base)
    d = deltas(before)
    for (f, _p, _b), r in zip(entries * FAULT_RATE_REPS, base):
        assert r["_shards"] == SHARDS_OK, (f, r["_shards"])
    for i, ((f, _p, b), r) in enumerate(zip(entries * FAULT_RATE_REPS, base)):
        at_fault_bar(f, b, r, base[i % len(entries)])
    base = base[: len(entries)]
    per = {f: FAULT_RATE_REPS * sum(1 for g, _p, _b in entries if g == f)
           for f in FAULT_COUNTER}
    for f, counter in FAULT_COUNTER.items():
        if f in per:
            assert d[counter] >= NODE_SHARDS * per[f], (f, d)
    assert d["degraded"] == 0 and d["device_errors"] == 0, d
    base_launches = take_launches()
    if on_card:
        assert base_launches > 0, "sparse_score never launched in phase 15's baseline"

    svc = node.indices.index_service("writes")
    write_engines = [svc.shard(sid).engine for sid in range(NODE_SHARDS)]
    write_ctxs = None

    def writes_ref(body) -> dict:
        """The shards' host query phases on `writes`, reduced, as a response."""
        total, ents, _top = host_reference(write_ctxs, body)
        searchers = [c.searcher for c in write_ctxs]
        hits = []
        for score, sid, doc in ents:
            seg, local = searchers[sid].resolve(doc)
            hits.append({"_score": score, "_shard": sid, "_id": seg.ids[local]})
        return {"hits": {"total": total, "hits": hits}}

    # the most segments a shard of a searched index holds (a probe's launches)
    seg_max = max(len(node.indices.index_service(ix).shard(sid).engine
                      .acquire_searcher().segments)
                  for ix in ("corpus", "writes") for sid in range(NODE_SHARDS)) + 1
    domains = []
    try:
        for domain, kind, tripping, blocked in FAULT_DOMAINS:
            batch = writes if domain.startswith("pack:") else entries
            t_arm = time.perf_counter()
            DEVICE_FAULTS.arm(error=kind, domain=domain, times=10 ** 6)
            try:
                if domain.startswith("pack:"):
                    conn_lines = []
                    lo = len(texts) - NODE_BULK
                    for i in range(lo, len(texts)):
                        conn_lines.append(json.dumps({"index": {
                            "_index": "writes", "_type": "doc", "_id": f"f{i}"}}))
                        conn_lines.append(json.dumps({"body": texts[i]}))
                    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
                    st, r = http_json(conn, "POST", "/_bulk",
                                      ndjson="\n".join(conn_lines) + "\n")
                    assert st == 200 and not r["errors"], (st, r.get("items", [])[:2])
                    st, r = http_json(conn, "POST", "/writes/_refresh")
                    conn.close()
                    assert st == 200 and r["_shards"]["failed"] == 0, r
                    write_ctxs = [ShardContext(e.acquire_searcher(), svc.mapper_service,
                                               svc.similarity_service, device=device)
                                  for e in write_engines]
                    want = [writes_ref(b) for _f, _p, b in batch]
                else:
                    want = base
                # the trip: one request of each family that meets the seam
                first = {}
                for i, (f, _p, _b) in enumerate(batch):
                    if f in tripping:
                        first.setdefault(f, i)
                trip, _w = send([batch[i] for i in first.values()])
                trip_s = time.perf_counter() - t_arm
                for i, r in zip(first.values(), trip):
                    f, _p, b = batch[i]
                    assert r["_shards"]["degraded"] >= 1, (domain, f, r["_shards"])
                    at_fault_bar(f, b, r, want[i])
                opened = sorted(dom for dom, c in DEVICE_HEALTH.stats()["domains"].items()
                                if c["state"] == OPEN)
                assert opened, (domain, DEVICE_HEALTH.stats())
                assert all(fnmatch.fnmatchcase(dom, domain) for dom in opened), \
                    (domain, opened)
                # the degraded window: the blocked families launch nothing
                # but the half-open probes the circuit admits (each fails
                # again while armed, and its request degrades too)
                take_launches()
                before = dict(SERVING_COUNTERS)
                probes0 = DEVICE_HEALTH.stats()["probes"]
                window = batch * (FAULT_RATE_REPS if not domains else 1)
                got, wall = send(window, sync_error=True)
                d = deltas(before)
                win_launches = take_launches()
                win_probes = DEVICE_HEALTH.stats()["probes"] - probes0
                for i, ((f, _p, b), r) in enumerate(zip(window, got)):
                    want_deg = NODE_SHARDS if f in blocked else 0
                    assert r["_shards"]["degraded"] == want_deg, (domain, f, r["_shards"])
                    at_fault_bar(f, b, r, want[i % len(batch)])
                for f, counter in FAULT_COUNTER.items():
                    n = sum(1 for g, _p, _b in window if g == f)
                    if f in blocked:
                        assert d[counter] == 0, (domain, f, counter, d)
                    elif n:
                        assert d[counter] >= NODE_SHARDS * n, (domain, f, counter, d)
                if {"bool", "writes"} & blocked:
                    # a probe's shard phase launches once a segment at most
                    assert win_launches <= win_probes * seg_max, \
                        (domain, win_launches, win_probes)
                elif on_card:
                    assert win_launches > 0, (domain, "sparse_score stopped")
                n_blocked = sum(1 for f, _p, _b in window if f in blocked)
                assert d["degraded"] == NODE_SHARDS * n_blocked, (domain, d)
            finally:
                DEVICE_FAULTS.disarm()
            # recovery: searches past the backoff window are the probes
            t_dis = time.perf_counter()
            probes = [batch[i] for i in first.values()]
            while DEVICE_HEALTH.any_open:
                assert time.perf_counter() - t_dis < RECOVER_S, \
                    (domain, "not recovered", DEVICE_HEALTH.stats())
                for (f, _p, b), r, i in zip(probes, send(probes)[0], first.values()):
                    at_fault_bar(f, b, r, want[i])
            recover_s = time.perf_counter() - t_dis
            take_launches()
            after, _w = send(probes)
            for (f, _p, b), r, i in zip(probes, after, first.values()):
                assert r["_shards"]["degraded"] == 0, (domain, f, r["_shards"])
                at_fault_bar(f, b, r, want[i])
            after_launches = take_launches()
            if on_card and {"bool", "writes"} & blocked:
                assert after_launches > 0, (domain, "sparse_score did not launch again")
            st = DEVICE_HEALTH.stats()
            domains.append(dict(
                domain=domain, kind=kind, blocked=sorted(blocked), opened=opened,
                trip_s=trip_s, recover_s=recover_s, requests=len(window),
                degraded=d["degraded"], requests_per_s=len(window) / wall,
                window_launches=win_launches, window_probes=win_probes,
                after_launches=after_launches,
                probes=st["probes"], recoveries=st["recoveries"],
                failures=st["failures"]))
            assert st["recoveries"] >= len(opened), (domain, st)
            DEVICE_HEALTH.reset()

        # -- oom twice at pull:splits: contained, the circuit stays closed --
        # (one shard, so the concurrent searches share a key and coalesce)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        st, r = http_json(conn, "PUT", "/splits", {"settings": {
            "number_of_shards": 1, "refresh_interval": -1}})
        assert st == 200, r
        lines = []
        for i in range(min(SPLIT_DOCS, len(texts))):
            lines.append(json.dumps({"index": {"_index": "splits", "_type": "doc",
                                               "_id": str(i)}}))
            lines.append(json.dumps({"body": texts[i]}))
        st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
        assert st == 200 and not r["errors"], (st, r.get("items", [])[:2])
        st, r = http_json(conn, "POST", "/splits/_refresh")
        conn.close()
        bools = [("bool", "/splits/_search", b) for b in bool_bodies[:FAULT_BOOL]]
        pinned, _w = send(bools)  # packs the shard; the card's answers
        batcher = node.search_batcher
        linger = batcher.linger_s
        batcher.linger_s = 0.02  # hold the first batch open for its neighbours
        splits0 = batcher.stats()["device_splits"]
        before = dict(SERVING_COUNTERS)
        injected0 = DEVICE_FAULTS.injected
        DEVICE_FAULTS.arm(error="oom", domain="pull:splits", times=2)
        try:
            got, _w = send(bools)
        finally:
            DEVICE_FAULTS.disarm()
            batcher.linger_s = linger
        d = deltas(before)
        deg = sum(r["_shards"]["degraded"] for r in got)
        for (f, _p, b), r, p in zip(bools, got, pinned):
            at_fault_bar(f, b, r, p)
        splits = batcher.stats()["device_splits"] - splits0
        assert DEVICE_FAULTS.injected - injected0 == 2
        assert deg <= 2 and d["degraded"] == deg, (deg, d)
        assert DEVICE_HEALTH.state("pull:splits") == CLOSED and not DEVICE_HEALTH.any_open
        assert splits >= 1, f"device_splits did not grow ({splits})"
        assert d["device_sparse"] == len(bools) - deg, d
        oom = dict(requests=len(bools), degraded=deg, device_splits=splits,
                   device_sparse=d["device_sparse"],
                   failures=DEVICE_HEALTH.stats()["failures"])

        # -- a defect on the card: the wrapper's launch refused as planned --
        # (the search answers 500 and moves no circuit; the next launches)
        defect = None
        if on_card:
            defect = defect_step(port, bools[0][2], pinned[0], take_launches)
    finally:
        DEVICE_FAULTS.disarm()
        DEVICE_HEALTH.reset()
        take_launches()

    pull = domains[0]
    out = dict(base_requests=base_requests, base_requests_per_s=base_requests / base_wall,
               degraded_requests_per_s=pull["requests_per_s"], trip_s=pull["trip_s"],
               recover_s=[dm["recover_s"] for dm in domains], domains=domains, oom=oom,
               defect=defect, launches=launched["sparse_score"], connections=n_conn,
               wall_s=time.perf_counter() - t_phase,
               counted={k: v - counted0[k] for k, v in SERVING_COUNTERS.items()},
               sync_debug="error over each degraded window" if on_card else None)
    log(f"[15] (a) device faults on phase 10's node, {n_conn} connections: the card's "
        f"answers to {len(entries)} bodies ({FAULT_BOOL} bool on `corpus`; "
        f"{FAULT_FAMILY} each filtered, function_score, sort, aggs on `catalog`) pinned, "
        f"{base_requests} requests at {out['base_requests_per_s']:.1f} requests/s")
    for dm in domains:
        log(f"[15]   {dm['domain']:24s} ({dm['kind']}): blocks {dm['blocked']}; opened "
            f"{dm['opened']} in {dm['trip_s']:.3f} s; {dm['requests']} requests degraded "
            f"{dm['degraded']} shard phases at {dm['requests_per_s']:.1f} requests/s, "
            f"sparse_score {dm['window_launches']} launches in the window (by "
            f"{dm['window_probes']} probes); recovered in "
            f"{dm['recover_s']:.3f} s ({dm['probes']} probes), then {dm['after_launches']} "
            f"launches")
    log(f"[15]   time to trip (pull:*) {out['trip_s']:.3f} s; requests/s degraded "
        f"{out['degraded_requests_per_s']:.1f} against {out['base_requests_per_s']:.1f} on "
        f"the card (the same {len(entries)} bodies, {pull['requests']} and "
        f"{base_requests} requests); time to recover "
        f"{min(out['recover_s']):.3f}-{max(out['recover_s']):.3f} s")
    log(f"[15]   oom x2 at pull:splits (1 shard): {oom['requests']} requests, "
        f"{oom['degraded']} degraded, device_splits +{oom['device_splits']}, "
        f"{oom['device_sparse']} served on the card, circuit closed; sparse_score "
        f"{out['launches']} launches over phase 15 (a), {out['wall_s']:.1f} s")
    if defect is not None:
        log(f"[15]   defect: a launch planned with {DEFECT_SHARED_BYTES} shared bytes -> "
            f"HTTP {defect['status']} ({defect['reason']}; {defect['classified']}), "
            f"device_errors +{defect['device_errors']}, degraded +{defect['degraded']}, "
            f"no circuit; the next search 200 on the card ({defect['after_launches']} "
            f"launches)")
    return out


def defect_step(port: int, body: dict, pinned: dict, take_launches) -> dict:
    """One `bool` search on `splits` whose `sparse_score` launch is planned
    with DEFECT_SHARED_BYTES of shared memory: the CUDA runtime refuses it, the
    wrapper raises its code as a CudaError of the kernel, and the search
    answers 500 with no degrade and no circuit moved (a defect is the
    program's, common/devicehealth); the next search, planned as usual, is
    served by the card."""
    import dataclasses
    import http.client
    import re

    from elasticsearch_tpu_torch.common.cudaenv import CudaError
    from elasticsearch_tpu_torch.common.devicehealth import (DEVICE_HEALTH,
                                                             classify_device_error)
    from elasticsearch_tpu_torch.ops import sparse_kernels
    from elasticsearch_tpu_torch.search import SERVING_COUNTERS

    plan_fn = sparse_kernels._launch_plan
    before = dict(SERVING_COUNTERS)
    health = DEVICE_HEALTH.stats()
    take_launches()
    sparse_kernels._launch_plan = lambda Qb, TB, simple: dataclasses.replace(
        plan_fn(Qb, TB, simple), shared_bytes=DEFECT_SHARED_BYTES)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        st, r = http_json(conn, "POST", "/splits/_search", body)
    finally:
        sparse_kernels._launch_plan = plan_fn
    d = {k: SERVING_COUNTERS[k] - before[k] for k in ("device_errors", "degraded")}
    refused = take_launches()
    reason = r.get("error", {}).get("reason", "") if isinstance(r.get("error"), dict) else ""
    assert st == 500 and r["error"]["type"] == "CudaError", (st, r)
    found = re.search(r"sparse_score launch failed: CUDA error (\d+)", reason)
    assert found, reason
    code = int(found.group(1))
    classified = classify_device_error(CudaError(code, reason, kernel="sparse_score"))
    assert classified == "defect", (code, classified)
    assert d == {"device_errors": 1, "degraded": 0}, d
    assert refused == 0, refused
    assert DEVICE_HEALTH.stats() == health, (health, DEVICE_HEALTH.stats())
    st2, r2 = http_json(conn, "POST", "/splits/_search", body)
    conn.close()
    assert st2 == 200 and r2["_shards"]["degraded"] == 0, (st2, r2.get("_shards"))
    at_fault_bar("bool", body, r2, pinned)
    after = take_launches()
    assert after > 0, "sparse_score did not launch after the defect"
    return dict(status=st, reason=reason, code=code, classified=classified,
                after_launches=after, **d)


def sticky_phase(device, texts, bool_bodies) -> dict:
    """Phase 15 (b): a real sticky fault, in a child process (this script
    with `--sticky-child`): a node of STICKY_SHARDS shards over
    STICKY_DOCS of phase 10's texts, STICKY_SEARCHES `bool` searches pinned
    on the card, a device-side assert, the same searches again — each 200,
    bitwise equal to the shards' host query phases, within 2 ulp of the
    pinned ones, every shard degraded, every failure persistent. The child
    prints one JSON line; this checks it field by field and reports the
    child's exit status."""
    from elasticsearch_tpu_torch.common import cudaenv

    here = Path(__file__).resolve().parent
    work = here / "build" / f"chip_smoke_sticky_{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    inp = work / "input.json"
    inp.write_text(json.dumps({"texts": texts[:STICKY_DOCS],
                               "bodies": bool_bodies[:STICKY_SEARCHES],
                               "device": str(device), "work": str(work)}))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--sticky-child", str(inp)], cwd=here,
                              capture_output=True, text=True, timeout=STICKY_TIMEOUT_S)
    finally:
        wall_s = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert lines, (f"the sticky child printed no result (exit {proc.returncode}):\n"
                   + proc.stdout[-2000:] + proc.stderr[-4000:])
    res = json.loads(lines[-1])
    assert res["built_at_start"] == cudaenv.kernel_sources(), res["built_at_start"]
    assert sorted(res["start_checks"]) == cudaenv.kernel_sources() and \
        all(n > 0 for n in res["start_checks"].values()), res["start_checks"]
    assert res["nvcc_after_start"] == 0, res
    assert res["pinned_degraded"] == 0 and res["pinned_launches"] > 0, res
    assert res["pinned_within_bar"] == STICKY_SEARCHES, res
    assert res["assert_code"] == 710 and res["assert_class"] == "persistent", res
    assert res["status"] == [200] * STICKY_SEARCHES, res["status"]
    assert res["degraded"] == [STICKY_SHARDS] * STICKY_SEARCHES, res["degraded"]
    assert res["bitwise_host"] == STICKY_SEARCHES, res
    assert res["within_bar_pinned"] == STICKY_SEARCHES, res
    assert res["failures"]["transient"] == 0 and res["failures"]["persistent"] >= 1, res
    res.update(exit_code=proc.returncode, wall_s=wall_s)
    log(f"[15] (b) sticky fault in a child process ({wall_s:.1f} s, exit code "
        f"{proc.returncode}): node start built {res['built_at_start']} and checked "
        f"{res['start_checks']} launches in {res['build_s']:.1f} s, no nvcc after it; "
        f"{STICKY_SEARCHES} searches pinned on the "
        f"card ({res['pinned_launches']} sparse_score launches); {res['assert_error']} "
        f"-> code {res['assert_code']}, {res['assert_class']}; then {STICKY_SEARCHES} "
        f"searches: all 200, _shards.degraded {STICKY_SHARDS} each, bitwise equal to the "
        f"host query phases and within {ULPS} ulp of the pinned ones, at "
        f"{res['degraded_requests_per_s']:.1f} requests/s; failures {res['failures']}, "
        f"open {res['open']}")

    # the restart: a second process over the same path.data
    rinp = work / "restart.json"
    rinp.write_text(json.dumps({"bodies": bool_bodies[:STICKY_SEARCHES],
                                "pages": res.pop("pinned_pages"),
                                "totals": res.pop("pinned_totals"),
                                "device": str(device), "work": str(work)}))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--restart-child", str(rinp)], cwd=here,
                              capture_output=True, text=True, timeout=STICKY_TIMEOUT_S)
    finally:
        restart_wall_s = time.perf_counter() - t0
        shutil.rmtree(work, ignore_errors=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert proc.returncode == 0 and lines, (
        f"the restart child failed (exit {proc.returncode}):\n"
        + proc.stdout[-2000:] + proc.stderr[-4000:])
    rs = json.loads(lines[-1])
    assert rs["built_at_start"] == [], rs  # every kernel was built: no nvcc
    assert sorted(rs["start_checks"]) == cudaenv.kernel_sources() and \
        all(n > 0 for n in rs["start_checks"].values()), rs["start_checks"]
    assert rs["status"] == [200] * STICKY_SEARCHES, rs["status"]
    assert rs["degraded"] == 0 and rs["launches"] > 0, rs
    assert rs["bitwise_pinned"] == STICKY_SEARCHES, rs
    rs.update(wall_s=restart_wall_s)
    res["restart"] = rs
    log(f"[15] (b) restart in a second process ({restart_wall_s:.1f} s): node start "
        f"{rs['start_s']:.2f} s (kernels current, start check {rs['start_checks']} in "
        f"{rs['build_s']:.2f} s), shards recovered from their stores in "
        f"{rs['recover_s']:.2f} s; {STICKY_SEARCHES} searches all 200 on the card "
        f"(degraded 0, {rs['launches']} sparse_score launches, "
        f"{rs['requests_per_s']:.1f} requests/s), bitwise equal to the answers pinned "
        f"before the fault")
    return res


def sticky_child(path: str) -> None:
    """The child of phase 15 (b); prints one JSON line, then leaves with
    os._exit (the poisoned context's teardown may abort)."""
    import http.client

    import torch

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.common.devicehealth import (
        DEVICE_HEALTH, classify_device_error, cuda_error_code)
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.search import SERVING_COUNTERS, ShardContext
    from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry

    inp = json.loads(Path(path).read_text())
    work = Path(inp["work"])
    device = torch.device(inp["device"])
    texts, bodies = inp["texts"], inp["bodies"]
    # a fresh build directory: the node's start builds every kernel
    cudaenv.BUILD_DIR = work / "kernels"
    t0 = time.perf_counter()
    node = Node(name="sticky", registry=LocalTransportRegistry(),
                data_path=str(work / "data"), settings={"node.device": str(device)}).start()
    build_s = time.perf_counter() - t0
    nvcc = []
    popen = cudaenv.subprocess.Popen

    def counting_popen(*a, **k):
        nvcc.append(a)
        return popen(*a, **k)

    cudaenv.subprocess.Popen = counting_popen
    port = node.start_http(0).port
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    st, r = http_json(conn, "PUT", "/sticky", {"settings": {
        "number_of_shards": STICKY_SHARDS, "refresh_interval": -1}})
    assert st == 200, r
    for lo in range(0, len(texts), NODE_BULK):
        lines = []
        for i in range(lo, min(lo + NODE_BULK, len(texts))):
            lines.append(json.dumps({"index": {"_index": "sticky", "_type": "doc",
                                               "_id": str(i)}}))
            lines.append(json.dumps({"body": texts[i]}))
        st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
        assert st == 200 and not r["errors"], r
    st, r = http_json(conn, "POST", "/sticky/_refresh")
    assert st == 200, r
    # the shards' segments and a commit on disk: this process leaves with
    # os._exit, which would lose a translog's buffered tail, and the restart
    # child recovers from these stores
    st, r = http_json(conn, "POST", "/sticky/_flush")
    assert st == 200, r

    cudaenv.LAUNCHES.reset()
    pinned = [http_json(conn, "POST", "/sticky/_search", b)[1] for b in bodies]
    pinned_launches = cudaenv.LAUNCHES.snapshot().get("sparse_score", 0)
    svc = node.indices.index_service("sticky")
    ctxs = [ShardContext(svc.shard(sid).engine.acquire_searcher(), svc.mapper_service,
                         svc.similarity_service, device=device)
            for sid in range(STICKY_SHARDS)]
    refs = []
    for b in bodies:
        total, ents, _top = host_reference(ctxs, b)
        hits = []
        for score, sid, doc in ents:
            seg, local = ctxs[sid].searcher.resolve(doc)
            hits.append((score, (sid, seg.ids[local])))
        refs.append((total, hits))
    # the fault: an out-of-range index on the card, then a synchronize
    x = torch.zeros(8, device=device)
    idx = torch.full((1,), 1 << 20, dtype=torch.long, device=device)
    err = None
    try:
        x[idx].sum()
        torch.cuda.synchronize(device)
    except Exception as e:  # noqa: BLE001 — the sticky error itself
        err = e
    code = cuda_error_code(err)[1] if err is not None else None
    status, degraded, bitwise, within = [], [], 0, 0
    t1 = time.perf_counter()
    for b, p, (total, hits) in zip(bodies, pinned, refs):
        st, r = http_json(conn, "POST", "/sticky/_search", b)
        status.append(st)
        if st != 200:
            degraded.append(None)
            continue
        degraded.append(r["_shards"].get("degraded"))
        bitwise += int(r["hits"]["total"] == total and page(r) == hits)
        within += int(r["hits"]["total"] == p["hits"]["total"]
                      and tie_tolerant_equal(page(r), page(p)))
    wall = time.perf_counter() - t1
    stats = DEVICE_HEALTH.stats()
    res = dict(
        built_at_start=sorted(node.kernel_builds), build_s=build_s,
        start_checks=node.kernel_checks,
        nvcc_after_start=len(nvcc),
        pinned_degraded=sum(r["_shards"]["degraded"] for r in pinned),
        pinned_launches=pinned_launches,
        pinned_within_bar=sum(int(tie_tolerant_equal(page(p), hits) and p["hits"]["total"] == t)
                              for p, (t, hits) in zip(pinned, refs)),
        assert_error=f"{type(err).__name__}: {str(err).splitlines()[0]}" if err else None,
        assert_code=code,
        assert_class=classify_device_error(err) if err is not None else None,
        status=status, degraded=degraded, bitwise_host=bitwise, within_bar_pinned=within,
        degraded_requests_per_s=len(bodies) / wall, failures=stats["failures"],
        open=sorted(d for d, c in stats["domains"].items() if c["state"] != "closed"),
        counters={k: SERVING_COUNTERS[k] for k in ("degraded", "device_errors")},
        pinned_pages=[page(p) for p in pinned],
        pinned_totals=[p["hits"]["total"] for p in pinned])
    print(json.dumps(res), flush=True)
    sys.stderr.flush()
    os._exit(0)


def page(r) -> list:
    """A search response's hits as (score, (shard, id)) pairs."""
    return [(h["_score"], (h["_shard"], h["_id"])) for h in r["hits"]["hits"]]


def restart_child(path: str) -> None:
    """Phase 15 (b)'s second child: a node on the card over the sticky
    child's `path.data` and build directory; prints one JSON line."""
    import http.client

    import torch

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.search import SERVING_COUNTERS
    from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry

    inp = json.loads(Path(path).read_text())
    work = Path(inp["work"])
    device = torch.device(inp["device"])
    cudaenv.BUILD_DIR = work / "kernels"  # the sticky child built there
    t0 = time.perf_counter()
    node = Node(name="sticky", registry=LocalTransportRegistry(),
                data_path=str(work / "data"), settings={"node.device": str(device)}).start()
    try:
        start_s = time.perf_counter() - t0
        conn = http.client.HTTPConnection("127.0.0.1", node.start_http(0).port, timeout=120)
        while True:  # the shards recover from their stores
            st, health = http_json(conn, "GET", "/_cluster/health/sticky")
            if st == 200 and health["active_primary_shards"] == STICKY_SHARDS:
                break
            assert time.perf_counter() - t0 < STICKY_TIMEOUT_S / 2, health
            time.sleep(0.02)
        recover_s = time.perf_counter() - t0 - start_s
        cudaenv.LAUNCHES.reset()
        degraded0 = SERVING_COUNTERS["degraded"]
        t1 = time.perf_counter()
        answers = [http_json(conn, "POST", "/sticky/_search", b) for b in inp["bodies"]]
        wall = time.perf_counter() - t1
        conn.close()
        bitwise = sum(
            int(st == 200 and r["hits"]["total"] == total
                and json.loads(json.dumps(page(r))) == pinned)
            for (st, r), pinned, total in zip(answers, inp["pages"], inp["totals"]))
        res = dict(built_at_start=sorted(node.kernel_builds), start_checks=node.kernel_checks,
                   start_s=start_s, build_s=node.kernel_build_s, recover_s=recover_s,
                   status=[st for st, _r in answers],
                   degraded=sum(r["_shards"]["degraded"] for _st, r in answers)
                   + SERVING_COUNTERS["degraded"] - degraded0,
                   launches=cudaenv.LAUNCHES.snapshot().get("sparse_score", 0),
                   bitwise_pinned=bitwise, requests_per_s=len(answers) / wall)
    finally:
        node.close()
    print(json.dumps(res), flush=True)


# ---------------------------------------------------------------------------
# phase 16: the percolator on the card
# ---------------------------------------------------------------------------


def percolator_queries(rng, texts, ranked, n: int) -> list[dict]:
    """Phase 16's registry, a quarter of each kind: `match` of 1-3 terms,
    `term`, `bool` of a `must` term and a `must_not` term (terms from phase
    3's df ranks), and `match_phrase` of two adjacent tokens of a corpus
    text, neither among the RANKS[0] most frequent terms (host-only: a
    phrase does not lower flat)."""
    pool = ranked[RANKS[0]: RANKS[1]]
    common = {term_name(int(t)) for t in ranked[: RANKS[0]]}
    t = lambda: term_name(int(rng.choice(pool)))  # noqa: E731
    out = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            out.append({"match": {"body": " ".join(t() for _ in range(rng.integers(1, 4)))}})
        elif kind == 1:
            out.append({"term": {"body": t()}})
        elif kind == 2:
            out.append({"bool": {"must": [{"term": {"body": t()}}],
                                 "must_not": [{"term": {"body": t()}}]}})
        else:
            pairs = []
            while not pairs:
                toks = texts[int(rng.integers(len(texts)))].split()
                pairs = [j for j in range(len(toks) - 1)
                         if toks[j] not in common and toks[j + 1] not in common]
            at = pairs[int(rng.integers(len(pairs)))]
            out.append({"match_phrase": {"body": f"{toks[at]} {toks[at + 1]}"}})
    return out


class PullCounts:
    """Counts, until `close()`, the batched device→host pulls of the flat
    path (`search/execute.py`'s `pull_async`). It pulls nothing itself."""

    def __init__(self, texecute):
        self.n = 0
        self._module, self._orig = texecute, texecute.pull_async

        def counted(tensors):
            self.n += 1
            return self._orig(tensors)

        texecute.pull_async = counted

    def close(self) -> None:
        self._module.pull_async = self._orig


def host_loop(registry, doc: dict, mapper_service, device) -> list[str]:
    """The registry's pure host loop on the same document (its batch gate
    raised for the call)."""
    cls = type(registry)
    gate = cls.DEVICE_BATCH_MIN
    cls.DEVICE_BATCH_MIN = 1 << 62
    try:
        return registry.percolate(doc, mapper_service, device=device)
    finally:
        cls.DEVICE_BATCH_MIN = gate


def percolate_phase(device, node, port: int, *, texts, ranked, seed: int,
                    n_queries: int = PERC_QUERIES, n_docs: int = PERC_DOCS,
                    node_queries: int = PERC_NODE_QUERIES,
                    n_requests: int = PERC_REQUESTS) -> dict:
    """Phase 16: the percolator on the card. (a) The library leg: a
    registry of `n_queries` over phase 10's vocabulary percolates `n_docs` of
    phase 10's texts on the card and on its host loop. (b) The node leg, on
    phase 10's node: an `alerts` index (1 shard, 0 replicas) with
    `node_queries` of them registered over HTTP, `_percolate`,
    `_mpercolate`, existing-document and `_percolate/count` traffic, a
    DELETE of 100 queries, and the `compile:percolate` domain armed and
    recovered."""
    import http.client

    import torch

    from elasticsearch_tpu_torch import percolator as tperc
    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.common.devicehealth import CLOSED, DEVICE_HEALTH, OPEN
    from elasticsearch_tpu_torch.common.settings import Settings
    from elasticsearch_tpu_torch.mapper import MapperService
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.device_index import PACK_LEDGER, packed_for
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score, sparse_score_plain
    from elasticsearch_tpu_torch.search import SERVING_COUNTERS
    from elasticsearch_tpu_torch.search import execute as texecute
    from elasticsearch_tpu_torch.transport.faults import DEVICE_FAULTS

    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    counted0 = dict(SERVING_COUNTERS)
    rng = np.random.default_rng(seed)
    bodies = percolator_queries(rng, texts, ranked, n_queries)
    docs = [{"body": texts[int(i)]} for i in rng.choice(len(texts), n_docs, replace=False)]

    # -- (a) the library leg --------------------------------------------------
    registry = tperc.PercolatorRegistry()
    for i, q in enumerate(bodies):
        registry.register(f"p{i}", {"query": q})
    svc = MapperService(Settings.from_flat({}))
    svc.put_mapping("doc", {"properties": {"body": {"type": "string"}}})
    host_loop(registry, docs[0], svc, device)  # warm the host scorer's paths
    registry.percolate(docs[0], svc, device=device)  # and the card's
    recorder = LaunchRecorder(scoring, sparse_score)
    pulls = PullCounts(texecute)
    before = dict(SERVING_COUNTERS)
    packs_before = PACK_LEDGER.stats("_unattributed").get("packs", 0)
    card, card_s, launches, pulled = [], [], [], []
    try:
        for doc in docs:
            snap, n_pulls = cudaenv.LAUNCHES.snapshot(), pulls.n
            t0 = time.perf_counter()
            card.append(registry.percolate(doc, svc, device=device))
            card_s.append(time.perf_counter() - t0)
            after = cudaenv.LAUNCHES.snapshot()
            launches.append({k: after[k] - snap.get(k, 0) for k in after
                             if after[k] != snap.get(k, 0)})
            pulled.append(pulls.n - n_pulls)
    finally:
        recorder.close()
        pulls.close()
    host, host_s = [], []
    for doc in docs:
        t0 = time.perf_counter()
        host.append(host_loop(registry, doc, svc, device))
        host_s.append(time.perf_counter() - t0)
    counted = {k: SERVING_COUNTERS[k] - before[k] for k in SERVING_COUNTERS
               if SERVING_COUNTERS[k] != before[k]}
    packs = PACK_LEDGER.stats("_unattributed").get("packs", 0) - packs_before
    for d, (got, want) in enumerate(zip(card, host)):
        assert got == want, f"document {d}: the card's matches != the host loop's"
    assert counted.get("device_percolate", 0) == n_docs, counted
    assert not counted.get("device_percolate_fallbacks") and \
        not counted.get("device_errors") and not counted.get("degraded"), counted
    assert all(p == 1 for p in pulled), f"pulls a percolation {pulled}"
    assert packs == n_docs, f"{packs} unattributed packs for {n_docs} percolations"
    if on_card:
        for d, n in enumerate(launches):
            assert n.get("sparse_score.smem", 0) > 0, \
                f"document {d}: sparse_score.smem did not launch ({n})"
    shapes = sorted(recorder.shapes)
    assert all(key[2] == 1 for key in shapes), f"a launch not at k = 1: {shapes}"
    max_err = check_shapes(recorder.shapes)
    # each launched shape timed as phase 8 times the main path's: CUDA events
    # around host launches, and on the card a CUDA graph (device time)
    timed = []
    for key in shapes:
        args, kwargs, n = recorder.shapes[key]
        nbytes, ops, real = launch_bound(args, kwargs)
        b_ms, b_by = bound_ms(nbytes, ops)
        timed.append(dict(
            Qb=key[0][0], TB=key[0][1], tf=key[1], k=key[2], passes=key[3],
            simple=key[4], launches=n, real_blocks=real, bound_ms=b_ms, bound_by=b_by,
            ms=time_ms(lambda: sparse_score(*args, **kwargs), device, 20),
            plain_ms=time_ms(lambda: sparse_score_plain(*args, **kwargs), device, 20),
            graph_ms=graph_ms(lambda: sparse_score(*args, **kwargs), 20) if on_card else None,
            plain_graph_ms=graph_ms(lambda: sparse_score_plain(*args, **kwargs), 20)
            if on_card else None))
    flat = len(tperc.split_flat(list(registry._queries.items()),
                                tperc.one_doc_context(docs[0], svc, "doc", device))[0])

    # one percolation's wall, step by step (docs[1])
    items = list(registry._queries.items())
    split: dict = {}
    t0 = time.perf_counter()
    ctx = tperc.one_doc_context(docs[1], svc, "doc", device)
    split["parse_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    packed = packed_for(ctx.searcher.segments[0], device)
    if on_card:
        torch.cuda.synchronize()
    split["pack_ms"] = (time.perf_counter() - t0) * 1e3
    split["pack_bytes"] = PACK_LEDGER.stats("_unattributed")["recent"][-1]["bytes"]
    split["pack_slots"] = int(packed.blk_docs.numel())
    t0 = time.perf_counter()
    plans, qids, rest = tperc.split_flat(items, ctx)
    split["lower_ms"] = (time.perf_counter() - t0) * 1e3
    if on_card:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    t0 = time.perf_counter()
    pending = texecute.dispatch_flat_batch(plans, ctx, 1)
    split["dispatch_ms"] = (time.perf_counter() - t0) * 1e3
    if on_card:
        ev[1].record()
    t0 = time.perf_counter()
    tds = pending.merge()
    split["pull_ms"] = (time.perf_counter() - t0) * 1e3
    if on_card:
        split["events_ms"] = ev[0].elapsed_time(ev[1])
    t0 = time.perf_counter()
    rest_matches = tperc.host_matches(rest, ctx)
    split["host_only_ms"] = (time.perf_counter() - t0) * 1e3
    split["host_only_queries"] = len(rest)
    assert sorted([q for q, td in zip(qids, tds) if td.total > 0] + rest_matches) == host[1]

    library = dict(
        queries=n_queries, flat=flat, docs=n_docs,
        matches_mean=float(np.mean([len(m) for m in card])),
        card_per_s=n_docs / sum(card_s), host_per_s=n_docs / sum(host_s),
        card_ms=dict(p50=float(np.median(card_s) * 1e3), max=float(max(card_s) * 1e3)),
        host_ms=dict(p50=float(np.median(host_s) * 1e3), max=float(max(host_s) * 1e3)),
        launches_per_percolation=float(np.mean([sum(v for k, v in n.items() if "." in k)
                                                for n in launches])) if on_card else None,
        pulls_per_percolation=float(np.mean(pulled)), unattributed_packs=packs,
        shapes=timed, kernel_max_abs_err=max_err, split=split, counted=counted,
        wall_s=time.perf_counter() - t_phase)
    log(f"[16] (a) {library['wall_s']:.1f} s: {n_queries} registered queries ({flat} "
        f"lower flat) over phase 10's vocabulary, {n_docs} of phase 10's texts: the card's matches == the host "
        f"loop's for every document ({library['matches_mean']:.1f} matches a document); "
        f"{library['card_per_s']:.2f} percolations/s on the card (p50 "
        f"{library['card_ms']['p50']:.1f} ms) against {library['host_per_s']:.2f} on the "
        f"host loop (p50 {library['host_ms']['p50']:.1f} ms); launches a percolation "
        f"{library['launches_per_percolation']}, pulls {library['pulls_per_percolation']}, "
        f"one-document packs {packs} (under _unattributed)")
    log(f"[16] (a) sparse_score == plain (bitwise) at all {len(timed)} shapes the "
        f"percolations launched; max abs err {max_err}. Per shape: Qb TB k tf passes "
        f"simple | launches | kernel ms | plain ms | bound ms"
        + (" | in a CUDA graph: kernel ms, plain ms" if on_card else ""))
    for t in timed:
        log(f"[16]   {t['Qb']:5d} {t['TB']:3d} {t['k']} {t['tf']:>13s} {t['passes']} "
            f"{int(t['simple'])} | {t['launches']:3d} | {t['ms']:.4f} | {t['plain_ms']:.4f} "
            f"| {t['bound_ms']:.3g} ({t['bound_by']})"
            + (f" | {t['graph_ms']:.4f}, {t['plain_graph_ms']:.4f}" if on_card else ""))
    log(f"[16] (a) one percolation: parse {split['parse_ms']:.2f} ms, one-doc pack "
        f"{split['pack_ms']:.2f} ms ({split['pack_bytes']} B, {split['pack_slots']} slots), "
        f"lowering {split['lower_ms']:.1f} ms, dispatch (plan + launch) "
        f"{split['dispatch_ms']:.1f} ms"
        + (f" (CUDA events around it: {split['events_ms']:.3f} ms, the device waiting "
           f"on the host)" if on_card else "")
        + f", pull {split['pull_ms']:.2f} ms, host-only queries "
        f"{split['host_only_ms']:.1f} ms ({len(rest)})")

    # -- (b) the node leg -----------------------------------------------------
    t_node = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    for index in ("alerts", "alert_docs"):
        st, r = http_json(conn, "PUT", f"/{index}", {"settings": {
            "number_of_shards": 1, "number_of_replicas": 0, "refresh_interval": -1}})
        assert st == 200 and r["acknowledged"], r
    conn.close()
    reg_reqs = [("PUT", f"/alerts/.percolator/a{i}", {"query": q}, None)
                for i, q in enumerate(bodies[:node_queries])]
    t0 = time.perf_counter()
    res, _lat, _w = http_requests(port, reg_reqs, PERC_CONNECTIONS)
    register_s = time.perf_counter() - t0
    assert all(st == 201 for st, _r in res), [r for st, r in res if st != 201][:2]
    nreg = node.percolator.registry("alerts")
    assert nreg.count() == node_queries
    nsvc = node.indices.index_service("alerts").mapper_service

    def references():
        return [host_loop(nreg, doc, nsvc, node.device) for doc in docs]

    def answer(matches):
        return {"total": len(matches),
                "_shards": {"total": 1, "successful": 1, "failed": 0},
                "matches": [{"_index": "alerts", "_id": q} for q in matches]}

    refs = references()
    before = dict(SERVING_COUNTERS)
    snap = cudaenv.LAUNCHES.snapshot()
    perc = [("POST", "/alerts/doc/_percolate", {"doc": docs[i % n_docs]}, None)
            for i in range(n_requests)]
    res, lat_ms, wall_s = http_requests(port, perc, PERC_CONNECTIONS)
    node_launches = cudaenv.LAUNCHES.snapshot().get("sparse_score", 0) - snap.get("sparse_score", 0)
    for i, (st, r) in enumerate(res):
        assert st == 200 and r == answer(refs[i % n_docs]), (i, st, r)
    served = SERVING_COUNTERS["device_percolate"] - before["device_percolate"]
    assert served == n_requests, f"{served} of {n_requests} percolations on the card"
    if on_card:  # a document that shares no term with a flat query launches nothing
        assert node_launches > 0, "sparse_score never launched in phase 16's node leg"

    # _mpercolate (one missing document a body), existing documents (GET
    # first) and _percolate/count
    res, _l, _w = http_requests(port, [("PUT", f"/alert_docs/doc/e{i}", docs[i % n_docs], None)
                                       for i in range(PERC_EXISTING)], PERC_CONNECTIONS)
    assert all(st == 201 for st, _r in res), res[:2]
    missing = [{"percolate": {"index": "alert_docs", "id": "missing",
                              "percolate_index": "alerts"}}, {}]
    mbodies = []
    for b in range(PERC_MULTI):
        lines = []
        for j in range(PERC_MULTI_ITEMS - 1):
            lines += [{"percolate": {"index": "alerts", "type": "doc"}},
                      {"doc": docs[(b * PERC_MULTI_ITEMS + j) % n_docs]}]
        lines += missing
        mbodies.append("\n".join(json.dumps(x) for x in lines) + "\n")
    gets, _l, _w = http_requests(port, [("GET", f"/alert_docs/doc/e{i}", None, None)
                                        for i in range(PERC_EXISTING)], PERC_CONNECTIONS)
    for i, (st, r) in enumerate(gets):
        assert st == 200 and r["found"] and r["_source"] == docs[i % n_docs], (i, st, r)
    mixed = [("POST", "/_mpercolate", None, body) for body in mbodies] + \
        [("GET", f"/alert_docs/doc/e{i}/_percolate?percolate_index=alerts", None, None)
         for i in range(PERC_EXISTING)] + \
        [("POST", "/alerts/doc/_percolate/count", {"doc": docs[i % n_docs]}, None)
         for i in range(PERC_EXISTING)]
    res, _l, mixed_s = http_requests(port, mixed, PERC_CONNECTIONS)
    for b, (st, r) in enumerate(res[:PERC_MULTI]):
        assert st == 200 and len(r["responses"]) == PERC_MULTI_ITEMS, (b, st)
        for j, item in enumerate(r["responses"][:-1]):
            assert item == answer(refs[(b * PERC_MULTI_ITEMS + j) % n_docs]), (b, j, item)
        assert r["responses"][-1]["status"] == 404 and \
            r["responses"][-1]["error"].startswith("DocumentMissingException["), r
    for i, (st, r) in enumerate(res[PERC_MULTI: PERC_MULTI + PERC_EXISTING]):
        assert st == 200 and r == answer(refs[i % n_docs]), (i, st, r)
    for i, (st, r) in enumerate(res[PERC_MULTI + PERC_EXISTING:]):
        assert st == 200 and r == {"total": len(refs[i % n_docs]),
                                   "_shards": answer([])["_shards"]}, (i, st, r)

    # DELETE 100 queries, the matched ones first: no later answer names them
    matched = sorted({q for m in refs for q in m}, key=lambda q: int(q[1:]))
    rest_ids = [f"a{i}" for i in range(node_queries) if f"a{i}" not in set(matched)]
    gone = (matched + rest_ids)[:PERC_DELETES]
    res, _l, _w = http_requests(port, [("DELETE", f"/alerts/.percolator/{q}", None, None)
                                       for q in gone], PERC_CONNECTIONS)
    assert all(st == 200 and r["found"] for st, r in res), res[:2]
    assert nreg.count() == node_queries - len(gone)
    refs = references()
    assert not set(gone) & {q for m in refs for q in m}
    res, _l, _w = http_requests(port, perc[:n_docs], PERC_CONNECTIONS)
    for i, (st, r) in enumerate(res):
        assert st == 200 and r == answer(refs[i]), (i, st, r)
        assert not set(gone) & {m["_id"] for m in r["matches"]}

    # compile:percolate armed: the host loop answers; disarmed, the card again
    before = dict(SERVING_COUNTERS)
    snap = cudaenv.LAUNCHES.snapshot()
    DEVICE_FAULTS.arm(error="launch", domain=tperc.PERCOLATE_DOMAIN, times=1 << 30)
    try:
        res, _l, armed_s = http_requests(port, perc[:PERC_CONNECTIONS], PERC_CONNECTIONS)
        armed_launches = cudaenv.LAUNCHES.snapshot().get("sparse_score", 0) - \
            snap.get("sparse_score", 0)
        for i, (st, r) in enumerate(res):
            assert st == 200 and r == answer(refs[i % n_docs]), (i, st, r)
        assert DEVICE_HEALTH.state(tperc.PERCOLATE_DOMAIN) == OPEN
        d = {k: SERVING_COUNTERS[k] - before[k] for k in SERVING_COUNTERS}
        assert d["device_percolate"] == 0 and \
            d["device_percolate_fallbacks"] == PERC_CONNECTIONS, d
        assert armed_launches == 0, f"{armed_launches} launches while armed"
    finally:
        DEVICE_FAULTS.disarm()
    t_disarm = time.perf_counter()
    probes = 0
    while DEVICE_HEALTH.state(tperc.PERCOLATE_DOMAIN) != CLOSED:
        assert time.perf_counter() - t_disarm < RECOVER_S, DEVICE_HEALTH.stats()
        (st, r), = http_requests(port, perc[:1], 1)[0]
        assert st == 200 and r == answer(refs[0]), r
        probes += 1
        time.sleep(0.01)
    recover_s = time.perf_counter() - t_disarm
    # the card again: documents one at a time until one launches (a document
    # sharing no term with a flat query is a batch that launches nothing)
    served = SERVING_COUNTERS["device_percolate"]
    snap = cudaenv.LAUNCHES.snapshot()
    for i in range(n_docs):
        (st, r), = http_requests(port, perc[i: i + 1], 1)[0]
        assert st == 200 and r == answer(refs[i]), (i, st, r)
        assert SERVING_COUNTERS["device_percolate"] == served + i + 1
        after_launches = cudaenv.LAUNCHES.snapshot().get("sparse_score", 0) - \
            snap.get("sparse_score", 0)
        if after_launches or not on_card:
            break
    if on_card:
        assert after_launches > 0, "the card did not serve after the recovery"
    assert not PACK_LEDGER.stats("alerts"), "a percolation's pack attributed to `alerts`"
    out_node = dict(
        queries=node_queries, register_s=register_s, requests=n_requests,
        connections=PERC_CONNECTIONS, wall_s=wall_s, requests_per_s=n_requests / wall_s,
        latency_ms=dict(p50=float(np.percentile(lat_ms, 50)),
                        p99=float(np.percentile(lat_ms, 99)), max=float(lat_ms.max())),
        launches=node_launches, mixed_requests=len(mixed), mixed_s=mixed_s,
        deleted=len(gone), armed=dict(requests=PERC_CONNECTIONS, wall_s=armed_s,
                                      launches=armed_launches, recover_s=recover_s,
                                      probes=probes, after_launches=after_launches),
        leg_s=time.perf_counter() - t_node)
    log(f"[16] (b) {out_node['leg_s']:.1f} s on phase 10's node, `alerts` (1 shard, 0 "
        f"replicas): {node_queries} "
        f"queries registered over HTTP in {register_s:.1f} s; {n_requests} _percolate "
        f"requests from {PERC_CONNECTIONS} connections: {out_node['requests_per_s']:.1f} "
        f"requests/s, p50 {out_node['latency_ms']['p50']:.1f} ms p99 "
        f"{out_node['latency_ms']['p99']:.1f} ms, sparse_score {node_launches} launches; "
        f"every answer == the node's host loop")
    log(f"[16] (b) {PERC_MULTI} _mpercolate bodies of {PERC_MULTI_ITEMS} (one missing "
        f"document each: 404 in place), {PERC_EXISTING} existing documents (GET first) "
        f"and {PERC_EXISTING} _percolate/count in {mixed_s:.2f} s: == the host loop; "
        f"DELETE {len(gone)} queries: no later answer names them")
    log(f"[16] (b) compile:percolate armed: {PERC_CONNECTIONS} answers 200 from the host "
        f"loop in {armed_s:.2f} s, 0 launches, fallbacks +{PERC_CONNECTIONS}; disarmed, "
        f"closed in {recover_s:.3f} s ({probes} probes), then the card ({after_launches} "
        f"launches)")
    out = dict(library=library, node=out_node, wall_s=time.perf_counter() - t_phase,
               counted={k: v - counted0[k] for k, v in SERVING_COUNTERS.items()})
    log(f"[16] {out['wall_s']:.1f} s in all")
    return out


# ---------------------------------------------------------------------------
# phase 17: restart and serving hygiene
# ---------------------------------------------------------------------------


def http_headers(conn, method: str, path: str, body=None):
    """One request on a keep-alive connection: (status, JSON, headers)."""
    conn.request(method, path, body=None if body is None else json.dumps(body).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read()), dict(resp.getheaders())


def restart_phase(device, node10, *, texts, bodies, n_docs: int = RESTART_DOCS,
                  n_searches: int = RESTART_SEARCHES) -> dict:
    """Phase 17 (a), (c) and (d) (its (b) is printed by phases 3 and 10): a
    node closed after writes at every stage of durability restarts in this
    process over its data, answers as before, rejects an unservable budget,
    and journals a stalled pull. `node10` is phase 10's node, whose journal
    holds phase 15's trips and recoveries."""
    import http.client

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.device_index import PACK_LEDGER
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score
    from elasticsearch_tpu_torch.transport.faults import DEVICE_PULL
    from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    journal = node10.events.stats()["by_type"]
    if on_card:  # phase 15's windows tripped and closed domains on the card
        assert journal["device_degraded"] >= 1 and journal["device_recovered"] >= 1, journal
    n = min(n_docs, len(texts))
    a, b = int(n * 0.4), int(n * 0.8)
    idx = "restart"
    data_path = Path(__file__).resolve().parent / "build" / f"chip_smoke_restart_{os.getpid()}"
    shutil.rmtree(data_path, ignore_errors=True)
    settings = {"node.device": str(device), **RESTART_SETTINGS}
    searches = bodies[:n_searches]

    def bulk(conn, lo, hi, offset=0):
        for start in range(lo, hi, NODE_BULK):
            lines = []
            for i in range(start, min(start + NODE_BULK, hi)):
                lines.append(json.dumps({"index": {"_index": idx, "_type": "doc",
                                                   "_id": str(i)}}))
                lines.append(json.dumps({"body": texts[i + offset]}))
            st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
            assert st == 200 and not r["errors"], (st, r.get("items", [])[:2])

    def answers(conn):
        out = []
        for body in searches:
            st, r = http_json(conn, "POST", f"/{idx}/_search", body)
            assert st == 200 and r["_shards"]["failed"] == 0, (st, r)
            out.append((r["hits"]["total"],
                        [(h["_id"], h["_score"], h["_shard"]) for h in r["hits"]["hits"]]))
        return out

    recorder = LaunchRecorder(scoring, sparse_score)
    node = Node(name="restart", registry=LocalTransportRegistry(),
                data_path=str(data_path), settings=settings).start()
    try:
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", node.start_http(0).port, timeout=600)
        st, r = http_json(conn, "PUT", f"/{idx}", {"settings": {
            "number_of_shards": 2, "number_of_replicas": 0, "refresh_interval": -1}})
        assert st == 200, r
        bulk(conn, 0, a)
        assert http_json(conn, "POST", f"/{idx}/_refresh")[0] == 200
        bulk(conn, a, b)
        bulk(conn, 0, 10, offset=b)  # overwrites across the segments
        assert http_json(conn, "POST", f"/{idx}/_refresh")[0] == 200
        assert http_json(conn, "POST", f"/{idx}/_flush")[0] == 200
        # after the flush: the translog alone holds what follows
        st, r = http_json(conn, "DELETE", f"/{idx}/doc/{a}")
        assert st == 200 and r["found"], r
        bulk(conn, b, n)
        st, r = http_json(conn, "PUT", f"/{idx}/doc/dyn", {"body": texts[0], "tag": "dynamic"})
        assert st == 201, r
        assert http_json(conn, "POST", f"/{idx}/_refresh")[0] == 200
        load_s = time.perf_counter() - t0
        recorded = answers(conn)
        gets = {i: http_json(conn, "GET", f"/{idx}/doc/{i}") for i in (str(n - 1), "dyn", str(a))}
        conn.close()
    finally:
        node.close()
    PACK_LEDGER.forget(idx)

    # -- the restart -----------------------------------------------------
    t0 = time.perf_counter()
    node = Node(name="restart", registry=LocalTransportRegistry(),
                data_path=str(data_path), settings=settings).start()
    try:
        start_s = time.perf_counter() - t0
        conn = http.client.HTTPConnection("127.0.0.1", node.start_http(0).port, timeout=600)
        while True:
            st, health = http_json(conn, "GET", f"/_cluster/health/{idx}")
            if st == 200 and health["status"] == "green":
                break
            assert time.perf_counter() - t0 < 60, health
            time.sleep(0.01)
        green_s = time.perf_counter() - t0 - start_s
        props = node.cluster_service.state.metadata.index(idx).mappings_dict()["doc"]["properties"]
        assert "tag" in props, props
        for i, want in gets.items():
            assert http_json(conn, "GET", f"/{idx}/doc/{i}") == want, i
        assert gets[str(a)][0] == 404 and gets["dyn"][1]["_source"]["tag"] == "dynamic"
        cudaenv.LAUNCHES.reset()
        t1 = time.perf_counter()
        first = answers(conn)[:1]
        first_s = time.perf_counter() - t1
        packs = {k: v for k, v in PACK_LEDGER.stats(idx).items()
                 if k in ("packs", "delta_packs", "remasks", "compacts", "pools")}
        got = first + answers(conn)[1:]
        assert got == recorded, [i for i, (g, w) in enumerate(zip(got, recorded)) if g != w]
        launches = cudaenv.LAUNCHES.snapshot().get("sparse_score", 0)
        if on_card:
            assert launches > 0, "sparse_score never launched on the restarted node"
        log(f"[17] (a) `{idx}`: {n} texts in 2 shards ({load_s:.1f} s: two _bulk rounds "
            f"and refreshes, a _flush, a DELETE, a third _bulk and a dynamic field in the "
            f"translog); closed and restarted over the same data: start "
            f"{start_s:.2f} s (its kernel check {node.kernel_build_s:.2f} s, the "
            f"gateway's metadata {start_s - node.kernel_build_s:.2f} s), stores and "
            f"translogs to green {green_s:.2f} s, the first search {first_s * 1e3:.1f} ms "
            f"with its inline packs {packs}; GETs, the mapping and {len(got)} searches "
            f"bitwise as before the close ({launches} sparse_score launches)")

        # -- (c) admission --------------------------------------------------
        adm = node.actions.admission.stats()
        assert adm["observed"] >= 10, adm
        st, r, headers = http_headers(conn, "POST", f"/{idx}/_search?timeout=1ms", searches[0])
        adm2 = node.actions.admission.stats()
        assert st == 429 and int(headers["Retry-After"]) >= 1, (st, r, adm)
        assert adm2["rejected"] == adm["rejected"] + 1, adm2
        st, r = http_json(conn, "POST", f"/{idx}/_search", searches[0])
        assert st == 200 and r["hits"]["total"] == recorded[0][0], (st, r)
        log(f"[17] (c) admission after {adm['observed']} observed shard phases (EWMA "
            f"{adm['ewma_shard_phase_ms']} ms, p50 {adm['shard_phase']['p50_ms']} ms): "
            f"?timeout=1ms -> 429 with Retry-After {headers['Retry-After']}, "
            f"rejected {adm2['rejected']}; a body without a timeout -> 200")

        # -- (d) the watchdog ------------------------------------------------
        dog = node.watchdog
        out = {}

        def stalled():
            c2 = http.client.HTTPConnection("127.0.0.1", conn.port, timeout=60)
            t = time.perf_counter()
            out["r"] = http_json(c2, "POST", f"/{idx}/_search", searches[1])
            out["dt"] = time.perf_counter() - t
            c2.close()

        seq0 = max((e["seq"] for e in node.events.events()), default=0)
        threshold = max(dog.batch_min_s, dog.batch_factor * node.search_batcher._ewma_cost)
        DEVICE_PULL.arm(RESTART_STALL_S, index=idx, times=1)
        try:
            th = threading.Thread(target=stalled)
            t_start = time.perf_counter()
            th.start()
            ev = None
            while ev is None and time.perf_counter() - t_start < RESTART_STALL_S:
                ev = next((e for e in node.events.events() if e["type"] == "batch_stall"
                           and e["seq"] > seq0 and e["attrs"]["shard"] == idx), None)
                time.sleep(0.01)
            detected_s = time.perf_counter() - t_start
            th.join(60)
        finally:
            DEVICE_PULL.disarm()
        assert ev is not None, "no batch_stall event during the stall"
        assert detected_s <= threshold + 2 * dog.interval_s + 0.35, (detected_s, threshold)
        st, r = out["r"]
        assert st == 200 and out["dt"] >= RESTART_STALL_S, (st, out["dt"])
        assert (r["hits"]["total"], [(h["_id"], h["_score"], h["_shard"])
                                     for h in r["hits"]["hits"]]) == recorded[1]
        log(f"[17] (d) DEVICE_PULL stalled one `{idx}` pull {RESTART_STALL_S:.1f} s: "
            f"batch_stall (batch {ev['attrs']['batch']}, age {ev['attrs']['age_ms']} ms) "
            f"in the journal {detected_s:.2f} s after the search (threshold "
            f"{threshold:.2f} s, period {dog.interval_s:.2f} s); the search answered 200 "
            f"in {out['dt']:.2f} s with its recorded hits; phase 10's journal: "
            f"device_degraded {journal['device_degraded']}, device_recovered "
            f"{journal['device_recovered']} (phase 15's windows)")
        conn.close()
        events = node.events.stats()
    finally:
        node.close()
        recorder.close()
        shutil.rmtree(data_path, ignore_errors=True)
        PACK_LEDGER.forget(idx)
    max_err = check_shapes(recorder.shapes)
    wall_s = time.perf_counter() - t_phase
    log(f"[17] sparse_score == plain (bitwise) at all {len(recorder.shapes)} shapes "
        f"phase 17 launched; max abs err {max_err}; {wall_s:.1f} s in all")
    return dict(docs=n, load_s=load_s, start_s=start_s, kernel_check_s=node.kernel_build_s,
                green_s=green_s, first_search_ms=first_s * 1e3, packs=packs,
                searches=len(got), launches=launches, admission=adm2,
                stall=dict(detected_s=detected_s, threshold_s=threshold,
                           period_s=dog.interval_s, search_s=out["dt"]),
                events=events, phase10_journal=journal, kernel_shapes=len(recorder.shapes),
                kernel_max_abs_err=max_err, wall_s=wall_s)


# ---------------------------------------------------------------------------
# phase 18: analysis, similarities and the flat mapper on the card
# ---------------------------------------------------------------------------

# Lucene's English stop set (StopAnalyzer.ENGLISH_STOP_WORDS_SET, the port's
# analysis/core.py ENGLISH_STOP_WORDS)
ENGLISH_STOP = ("a an and are as at be but by for if in into is it no not of on or "
                "such that the their then there these they this to was will with").split()
ANALYSIS_SUFFIXES = ("", "s", "es", "ed", "ing", "ation", "ness")
_CONSONANTS, _VOWELS = "bcdfghklmnprstvwz", "aeiou"


def runtime_phase(device, node, port: int, *, texts, offsets, inv_docs, bodies,
                  catalog_docs: int, seed: int, n_dfs: int = RUNTIME_DFS,
                  n_bm25_docs: int = RUNTIME_BM25_DOCS, n_mixed: int = RUNTIME_MIXED,
                  n_cache: int = RUNTIME_CACHE, n_bulk: int = RUNTIME_CACHE_BULK,
                  n_rescore: int = RUNTIME_RESCORE, n_conn: int = RUNTIME_CONN) -> dict:
    """Phase 20, on phase 10's node before it closes: the search runtime.
    (a) `n_dfs` of phase 10's `bool` bodies as `dfs_query_then_fetch` and as
    `query_then_fetch` from `n_conn` connections, each leg under
    `set_sync_debug_mode("error")`; every DFS answer against the shards'
    host query phases under `aggregate_dfs` of their `collect_dfs`, every
    plain one against the shards' own; then a BM25 index of `n_bm25_docs`
    of phase 10's texts and a burst of `n_mixed` DFS and plain bodies at
    once, whose answers hold while the packs' similarity tables flip. (b)
    `n_cache` size-0 aggregating bodies on `catalog` three times: a miss
    pass, a hit pass that launches nothing, then after a `_bulk` of
    `n_bulk` documents, `_refresh` and the warmer's re-prime a third pass
    equal to a `request_cache: false` pass. (c) a scroll and a scan walk,
    `_count` on three routes and with `q=`, an `_msearch` of 8,
    `preference=_shards:0,2` and `n_rescore` rescore bodies against the
    host path. `sparse_score` against its plain version at every shape the
    phase launched."""
    import contextlib
    import http.client

    import torch

    from elasticsearch_tpu_torch import actions as tactions
    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.device_index import PACK_LEDGER, SIM_SWAPS
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score
    from elasticsearch_tpu_torch.search import (
        SERVING_COUNTERS, DeviceBatcher, ShardContext, execute_query_phase, parse_query)
    from elasticsearch_tpu_torch.search import execute as texecute
    from elasticsearch_tpu_torch.search import service as tservice
    from elasticsearch_tpu_torch.search.controller import aggregate_dfs, collect_dfs

    on_card = device.type == "cuda"
    t_phase = time.perf_counter()
    out: dict = {}
    launches: dict = {}
    recorder = LaunchRecorder(scoring, sparse_score)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def take() -> dict:
        """This leg's launches since the last take, counted into the
        phase's, and the counts set to 0 again."""
        snap = cudaenv.LAUNCHES.snapshot()
        cudaenv.LAUNCHES.reset()
        for name, n in snap.items():
            launches[name] = launches.get(name, 0) + n
        return snap

    def timed(requests, sync_error: bool, clock=None):
        """`requests` from `n_conn` connections of this process; with a
        `clock` (a SpanClock) also the node process's CPU s by thread kind
        over the run, in `clock.host_cpu`."""
        if sync_error and on_card:
            torch.cuda.set_sync_debug_mode("error")
        try:
            with clock or contextlib.nullcontext():
                cpu0, process0 = thread_cpu_s(), time.process_time()
                got, lat, wall = http_requests(port, requests, n_conn)
                if clock is not None:
                    clock.host_cpu = host_cpu_split(cpu0, thread_cpu_s(),
                                                    time.process_time() - process0)
        finally:
            if sync_error and on_card:
                torch.cuda.set_sync_debug_mode(0)
        for i, (st, r) in enumerate(got):
            assert st == 200, (i, requests[i][1], r)
        return got, lat, wall

    def clock():
        """Where a leg's time goes: the shard's DFS collection, the query
        phase, its direct launches (DFS) or its wait on the batcher
        (plain), and inside either the steps of a flat batch (summed over
        the search threads and the drainer), the pull wait, the fetch and
        the coordinator's reduce."""
        return SpanClock([
            ("dfs phase: collect_dfs", tactions, "collect_dfs"),
            ("query phase", tactions, "execute_query_phase"),
            ("query phase: direct launch and merge", tservice, "execute_flat_batch"),
            ("query phase: through the batcher", DeviceBatcher, "execute"),
            ("flat batch: finalize_flat", texecute, "finalize_flat"),
            ("flat batch: _assemble_batch", texecute, "_assemble_batch"),
            ("flat batch: packed_for", texecute, "packed_for"),
            ("flat batch: ensure_sim_tables", texecute, "ensure_sim_tables"),
            ("flat batch: launch_flat_sparse", texecute, "launch_flat_sparse"),
            ("flat batch:   plan_sparse_buckets", scoring, "plan_sparse_buckets"),
            ("flat batch:   staging copy to device", scoring.StagingSet, "to_device"),
            ("flat batch:   _sparse_impl", scoring, "_sparse_impl"),
            ("flat batch:     sparse_score launch", scoring, "sparse_score"),
            ("flat batch: prepare_dense", texecute, "prepare_dense"),
            ("flat batch: merge", texecute._PendingFlat, "merge"),
            ("pull wait", cudaenv.PendingPull, "wait"),
            ("fetch phase", tactions, "execute_fetch_phase"),
            ("coordinator: sort_docs", tactions, "sort_docs"),
            ("coordinator: merge_responses", tactions, "merge_responses")])

    def cache_clock():
        """Where a size-0 pass's time goes on the shard (the search pool)
        and the coordinator: the request's parse and context, the cache's
        key, lookup and decode, the pin, the query phase a miss runs, and
        the reduce of the aggregation partials."""
        return SpanClock([
            ("coordinator: search", tactions.ActionModule, "search"),
            ("shard: parse_search_body", tactions, "parse_search_body"),
            ("shard: _shard_ctx", tactions.ActionModule, "_shard_ctx"),
            ("shard: request_fingerprint", tactions, "request_fingerprint"),
            ("shard: cache get", type(node.request_cache), "get"),
            ("shard: decode cached partial", tactions, "_decode_cached_partial"),
            ("shard: encode partial", tactions, "_encode_cached_partial"),
            ("shard: cache put", type(node.request_cache), "put"),
            ("shard: _pin_context", tactions.ActionModule, "_pin_context"),
            ("shard: query phase (miss)", tactions, "execute_query_phase"),
            ("coordinator: decode partials", tactions, "_decode_partials"),
            ("coordinator: sort_docs", tactions, "sort_docs"),
            ("coordinator: merge_responses", tactions, "merge_responses"),
            ("fetch phase", tactions, "execute_fetch_phase")])

    def lat_stats(lat, wall, n) -> dict:
        return dict(requests=n, requests_per_s=n / wall,
                    p50_ms=float(np.percentile(lat, 50)), p99_ms=float(np.percentile(lat, 99)))

    def ctxs_of(index: str, stats=None):
        svc = node.indices.index_service(index)
        return [ShardContext(svc.shard(sid).engine.acquire_searcher(), svc.mapper_service,
                             svc.similarity_service, device=device, global_stats=stats)
                for sid in range(NODE_SHARDS)]

    def dfs_ctxs(ctxs, body):
        q = parse_query(body["query"])
        agg = aggregate_dfs([collect_dfs(c, q, shard_id=i) for i, c in enumerate(ctxs)])
        return [ShardContext(c.searcher, c.mapper_service, c.similarity_service,
                             device=device, global_stats=agg) for c in ctxs]

    def check_page(r, ctxs, body, exact: bool = False) -> bool:
        """The response against the shards' host query phases reduced:
        the total exactly, the page tie-tolerant within 2 ulp (bitwise
        when `exact`); returns whether the page was bitwise equal."""
        total, page, _top = host_reference(ctxs, body)
        assert r["_shards"] == SHARDS_OK, r["_shards"]
        assert r["hits"]["total"] == total, (r["hits"]["total"], total)
        got = [(h["_score"], (h["_shard"], h["_id"])) for h in r["hits"]["hits"]]
        want = []
        for score, sid, doc in page:
            seg, local = ctxs[sid].searcher.resolve(doc)
            want.append((score, (sid, seg.ids[local])))
        if exact:
            assert got == want, body
        else:
            assert tie_tolerant_equal(got, want), body
        return got == want

    try:
        # -- (a) DFS on phase 10's `corpus` (TF-IDF) ------------------------
        dfs_bodies = bodies[:n_dfs]
        plain_req = [("POST", "/corpus/_search", b, None) for b in dfs_bodies]
        dfs_req = [("POST", "/corpus/_search?search_type=dfs_query_then_fetch", b, None)
                   for b in dfs_bodies]
        stats0, swaps0 = node.search_batcher.stats(), SIM_SWAPS["changed"]
        cudaenv.LAUNCHES.reset()  # what earlier phases launched is not this one's
        dfs_clock, plain_clock = clock(), clock()
        dfs_resp, dfs_lat, dfs_wall = timed(dfs_req, sync_error=True, clock=dfs_clock)
        dfs_launch = take()
        stats1, swaps1 = node.search_batcher.stats(), SIM_SWAPS["changed"]
        plain_resp, plain_lat, plain_wall = timed(plain_req, sync_error=True,
                                                  clock=plain_clock)
        plain_launch = take()
        stats2 = node.search_batcher.stats()
        host = ctxs_of("corpus")
        bitwise = sum(check_page(r, dfs_ctxs(host, b), b)
                      for b, (_st, r) in zip(dfs_bodies, dfs_resp))
        for b, (_st, r) in zip(dfs_bodies, plain_resp):
            check_page(r, host, b)
        differs = sum(d[1]["hits"]["hits"] != p[1]["hits"]["hits"]
                      for d, p in zip(dfs_resp, plain_resp))
        direct = stats1["direct"] - stats0["direct"]
        assert direct == n_dfs * NODE_SHARDS, direct  # no DFS plan was queued
        assert stats1["coalesced"] == stats0["coalesced"], "a DFS plan entered the batcher"
        assert stats2["direct"] == stats1["direct"]
        if on_card:
            assert dfs_launch.get("sparse_score", 0) > 0, dfs_launch
            assert plain_launch.get("sparse_score", 0) > 0, plain_launch
        assert differs > 0, "the index's statistics changed no page"
        out["dfs"] = dict(dfs=lat_stats(dfs_lat, dfs_wall, n_dfs),
                          plain=lat_stats(plain_lat, plain_wall, n_dfs),
                          direct_launches=direct,
                          dfs_sparse_launches=dfs_launch.get("sparse_score", 0),
                          plain_sparse_launches=plain_launch.get("sparse_score", 0),
                          plain_batches=stats2["launches"] - stats1["launches"],
                          flips=swaps1 - swaps0, bitwise_pages=int(bitwise),
                          pages_changed_by_dfs=int(differs),
                          spans=dict(dfs=dfs_clock.report(), plain=plain_clock.report()),
                          host_cpu_s=dict(dfs=dfs_clock.host_cpu, plain=plain_clock.host_cpu))
        a = out["dfs"]
        log(f"[20] (a) `corpus` (TF-IDF, {NODE_SHARDS} shards): {n_dfs} "
            f"dfs_query_then_fetch from {n_conn} connections at "
            f"{a['dfs']['requests_per_s']:.1f} requests/s (p50 {a['dfs']['p50_ms']:.2f} ms, "
            f"p99 {a['dfs']['p99_ms']:.2f} ms) against query_then_fetch's "
            f"{a['plain']['requests_per_s']:.1f} (p50 {a['plain']['p50_ms']:.2f} ms, p99 "
            f"{a['plain']['p99_ms']:.2f} ms); {direct} DFS plans launched outside the "
            f"drainer ({a['dfs_sparse_launches']} sparse_score launches) against "
            f"{a['plain_batches']} batches for the plain leg; similarity-table flips "
            f"{a['flips']}; every DFS page == the shards' host query phases under "
            f"aggregate_dfs (tie-tolerant 2 ulp; {bitwise} of {n_dfs} bitwise), "
            f"{differs} pages differ from the plain leg's")
        for leg, wall in (("dfs", dfs_wall), ("plain", plain_wall)):
            log(f"[20] (a) {leg} leg, CPU s by thread kind over its {wall:.2f} s: "
                + ", ".join(f"{k} {v:.2f}" for k, v in a["host_cpu_s"][leg].items()))
            for name, v in a["spans"][leg].items():
                log(f"[20]   span {name:38s} {v['calls']:5d} calls, CPU {v['cpu_s']:.2f} s, "
                    f"wall {v['wall_s']:.2f} s")

        # -- (a) the flips: a BM25 index, DFS and plain at once --------------
        n_bm25 = min(n_bm25_docs, len(texts))
        st, r = http_json(conn, "PUT", "/dfs_bm25", {"settings": {
            "number_of_shards": NODE_SHARDS, "refresh_interval": -1,
            "index": {"similarity": {"default": {"type": "BM25"}}}}})
        assert st == 200 and r["acknowledged"], r
        t0 = time.perf_counter()
        for lo in range(0, n_bm25, NODE_BULK):
            lines = []
            for i in range(lo, min(lo + NODE_BULK, n_bm25)):
                lines.append(json.dumps({"index": {"_index": "dfs_bm25", "_type": "doc",
                                                   "_id": str(i)}}))
                lines.append(json.dumps({"body": texts[i]}))
            st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
            assert st == 200 and not r["errors"], (st, r.get("items", [])[:2])
        st, r = http_json(conn, "POST", "/dfs_bm25/_refresh")
        assert st == 200 and r["_shards"]["failed"] == 0, r
        bm25_load_s = time.perf_counter() - t0
        inside = np.concatenate([[0], np.cumsum(inv_docs < n_bm25)])
        bdf = inside[offsets[1:]] - inside[offsets[:-1]]
        branked = np.argsort(-bdf, kind="stable")
        rng = np.random.default_rng(seed)
        rows = rng.choice(branked[BOOL_RANKS[0]: BOOL_RANKS[1]], size=(n_mixed, TERMS_PER_QUERY))
        mixed = [{"query": {"bool": {"should": [{"term": {"body": term_name(int(t))}}
                                                for t in row]}}, "size": NODE_SIZE}
                 for row in rows]
        # each shard's first search packs it inline: warm before the burst
        timed([("POST", "/dfs_bm25/_search", b, None) for b in mixed[:2 * n_conn]], False)
        mixed_req = [("POST", "/dfs_bm25/_search" + (
            "?search_type=dfs_query_then_fetch" if i % 2 == 0 else ""), b, None)
            for i, b in enumerate(mixed)]
        swaps0 = SIM_SWAPS["changed"]
        take()
        mixed_resp, mixed_lat, mixed_wall = timed(mixed_req, sync_error=True)
        mixed_launch = take()
        flips = SIM_SWAPS["changed"] - swaps0
        bhost = ctxs_of("dfs_bm25")
        for i, (b, (_st, r)) in enumerate(zip(mixed, mixed_resp)):
            check_page(r, dfs_ctxs(bhost, b) if i % 2 == 0 else bhost, b)
        assert flips > 0, "the BM25 packs' tables never flipped under DFS and plain"
        out["dfs_bm25"] = dict(docs=n_bm25, load_s=bm25_load_s, flips=flips,
                               sparse_launches=mixed_launch.get("sparse_score", 0),
                               **lat_stats(mixed_lat, mixed_wall, n_mixed))
        log(f"[20] (a) `dfs_bm25` (BM25, {n_bm25} docs, loaded in {bm25_load_s:.1f} s): "
            f"{n_mixed} requests, DFS and plain alternating, at "
            f"{out['dfs_bm25']['requests_per_s']:.1f} requests/s; {flips} similarity-table "
            f"flips over the burst; every page == its host reference (the DFS ones under "
            f"aggregate_dfs, tie-tolerant 2 ulp)")

        # -- (b) the shard request cache on `catalog` -------------------------
        inside = np.concatenate([[0], np.cumsum(inv_docs < catalog_docs)])
        cdf = inside[offsets[1:]] - inside[offsets[:-1]]
        cranked = np.argsort(-cdf, kind="stable")
        fam = sort_agg_bodies(np.random.default_rng(seed + 1), cranked[RANKS[0]: RANKS[1]],
                              cranked[BOOL_RANKS[0]: BOOL_RANKS[1]], n_cache // 3 + 1)
        cache_bodies = [b for trio in zip(fam["aggs_metric"], fam["aggs_terms"],
                                          fam["aggs_hist"]) for b in trio][:n_cache]
        cache_req = [("POST", "/catalog/_search", b, None) for b in cache_bodies]
        rcache = node.request_cache
        calls, pulls = CallCounts(texecute, tservice), PullCounts(texecute)
        try:
            rc0 = rcache.stats()
            miss_clock, hit_clock = cache_clock(), cache_clock()
            pass1, lat1, wall1 = timed(cache_req, sync_error=False, clock=miss_clock)
            rc1 = rcache.stats()
            take()
            calls.take()
            pulls.n = 0
            counters = dict(SERVING_COUNTERS)
            pass2, lat2, wall2 = timed(cache_req, sync_error=True, clock=hit_clock)
            hit_launch, (dense_launches, dense_pulls, _c), flat_pulls = \
                take(), calls.take(), pulls.n
            rc2 = rcache.stats()
        finally:
            calls.close()
            pulls.close()
        assert rc1["misses"] - rc0["misses"] == n_cache * NODE_SHARDS, (rc0, rc1)
        assert rc1["stores"] - rc0["stores"] == n_cache * NODE_SHARDS, (rc0, rc1)
        assert (rc2["hits"] - rc1["hits"], rc2["misses"] - rc1["misses"]) == \
            (n_cache * NODE_SHARDS, 0), (rc1, rc2)
        assert not sum(hit_launch.values()) and not dense_launches and \
            not dense_pulls and not flat_pulls, (hit_launch, dense_launches, dense_pulls,
                                                 flat_pulls)
        assert dict(SERVING_COUNTERS) == counters, "a hit reached a query phase"
        for (_s1, r1), (_s2, r2) in zip(pass1, pass2):
            assert (r2["hits"], r2["_shards"], r2["aggregations"]) == \
                (r1["hits"], r1["_shards"], r1["aggregations"])
        # a write, the refresh, and the warmer's re-prime of the new views
        PACK_LEDGER.forget("catalog")
        warm0 = node.warmer.stats()
        lo = catalog_docs
        hi = min(lo + n_bulk, len(texts))
        wrng = np.random.default_rng(seed + 2)
        lines = []
        for i in range(lo, hi):
            lines.append(json.dumps({"index": {"_index": "catalog", "_type": "doc",
                                               "_id": str(i)}}))
            lines.append(json.dumps({"body": texts[i], "likes": int(wrng.integers(0, 1001)),
                                     "pop": int(wrng.integers(1, 1001)),
                                     "cat": cat_name(int(wrng.integers(CAT_VALUES)))}))
        st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
        assert st == 200 and not r["errors"], (st, r.get("items", [])[:2])
        t_write = time.perf_counter()
        st, r = http_json(conn, "POST", "/catalog/_refresh")
        assert st == 200 and r["_shards"]["failed"] == 0, r
        deadline = time.perf_counter() + 60.0
        while True:
            w = node.warmer.stats()
            if w["reprimes"] - warm0["reprimes"] >= NODE_SHARDS and \
                    w["packs_done"] >= w["packs_scheduled"]:
                break
            assert time.perf_counter() < deadline, f"the re-prime never finished: {w}"
            time.sleep(0.01)
        reprime_s = time.perf_counter() - t_write
        assert w["query_failures"] == warm0["query_failures"], w
        assert w["pack_failures"] == warm0["pack_failures"], w
        rc3 = rcache.stats()
        take()
        pass3, lat3, wall3 = timed(cache_req, sync_error=False)
        pass3_launch = take()
        rc4 = rcache.stats()
        fresh, _lat, _wall = timed([("POST", "/catalog/_search", uncached(b), None)
                                    for b in cache_bodies], sync_error=False)
        ledger = PACK_LEDGER.stats("catalog")
        assert ledger and set(ledger["pools"]) <= {"warmer", "merge"}, ledger
        hits3 = rc4["hits"] - rc3["hits"]
        assert hits3 > 0, (rc3, rc4)
        for b, (_s3, r3), (_s4, r4) in zip(cache_bodies, pass3, fresh):
            assert (r3["hits"], r3["_shards"]) == (r4["hits"], r4["_shards"]), b
            agg_close(r3["aggregations"], r4["aggregations"], b)
        assert sum(r["hits"]["total"] for _s, r in pass3) >= \
            sum(r["hits"]["total"] for _s, r in pass1)
        out["cache"] = dict(
            bodies=n_cache, miss=lat_stats(lat1, wall1, n_cache),
            hit=lat_stats(lat2, wall2, n_cache), after_refresh=lat_stats(lat3, wall3, n_cache),
            shard_hits=rc2["hits"] - rc1["hits"], hit_launches=sum(hit_launch.values()),
            hit_pulls=dense_pulls + flat_pulls, bulk_docs=hi - lo, reprime_s=reprime_s,
            reprimes=w["reprimes"] - warm0["reprimes"],
            queries_warmed=w["queries_warmed"] - warm0["queries_warmed"],
            query_failures=w["query_failures"] - warm0["query_failures"],
            filters_seeded=w["filters_seeded"] - warm0["filters_seeded"],
            pass3_shard_hits=hits3, pass3_launches=pass3_launch,
            pack_pools=ledger["pools"], entries=rc4["entries"],
            memory_bytes=rc4["memory_size_in_bytes"], compressions=rc4["compressions"],
            spans=dict(miss=miss_clock.report(), hit=hit_clock.report()),
            host_cpu_s=dict(miss=miss_clock.host_cpu, hit=hit_clock.host_cpu))
        c = out["cache"]
        log(f"[20] (b) request cache on `catalog`: {n_cache} size-0 aggregating bodies, "
            f"miss pass p50 {c['miss']['p50_ms']:.2f} ms ({c['miss']['requests_per_s']:.1f} "
            f"requests/s), hit pass p50 {c['hit']['p50_ms']:.2f} ms "
            f"({c['hit']['requests_per_s']:.1f} requests/s): {c['shard_hits']} shard hits, "
            f"0 launches and 0 pulls, answers == the miss pass; a {c['bulk_docs']}-doc _bulk "
            f"and _refresh, {c['reprimes']} re-primes ({c['queries_warmed']} bodies warmed, "
            f"0 failed, {c['filters_seeded']} filter keys seeded) in {reprime_s:.2f} s; "
            f"the next pass: {hits3} shard hits, p50 {c['after_refresh']['p50_ms']:.2f} ms, "
            f"every answer == a request_cache=false pass (sums rel {AGG_RTOL}); packs "
            f"by pool {ledger['pools']}; {c['entries']} entries, {c['memory_bytes']} bytes")
        for leg, wall in (("miss", wall1), ("hit", wall2)):
            log(f"[20] (b) {leg} pass, CPU s by thread kind over its {wall:.2f} s: "
                + ", ".join(f"{k} {v:.2f}" for k, v in c["host_cpu_s"][leg].items()))
            for name, v in c["spans"][leg].items():
                log(f"[20]   span {name:38s} {v['calls']:5d} calls, CPU {v['cpu_s']:.3f} s, "
                    f"wall {v['wall_s']:.3f} s")

        # -- (c) scroll, scan, _count, _msearch, preference, rescore ---------
        svc = node.indices.index_service("corpus")
        pool = np.argsort(-np.diff(offsets), kind="stable")[RANKS[0]: RANKS[0] + 40]
        scroll_body = {"query": {"match": {"body": " ".join(
            term_name(int(t)) for t in pool[:2])}}, "size": 100}
        st, full = http_json(conn, "POST", "/corpus/_search", {**scroll_body, "size": 1000})
        assert st == 200 and len(full["hits"]["hits"]) == min(1000, full["hits"]["total"])
        walks = {}
        for kind, path in (("scroll", "/corpus/_search?scroll=1m"),
                           ("scan", "/corpus/_search?scroll=1m&search_type=scan")):
            st, first = http_json(conn, "POST", path, scroll_body)
            assert st == 200, first
            sid, seen, pages = first["_scroll_id"], list(first["hits"]["hits"]), 1
            assert len(seen) == (0 if kind == "scan" else 100)
            while True:
                st, r = http_json(conn, "POST", "/_search/scroll", {"scroll_id": sid})
                assert st == 200 and r["hits"]["total"] == len(full["hits"]["hits"]), r
                if not r["hits"]["hits"]:
                    break
                seen.extend(r["hits"]["hits"])
                pages += 1
            assert seen == full["hits"]["hits"], f"the {kind} walk != the buffered top"
            st, r = http_json(conn, "DELETE", f"/_search/scroll/{sid}")
            assert st == 200 and r == {"succeeded": True}
            st, r = http_json(conn, "POST", "/_search/scroll", {"scroll_id": sid})
            assert st == 404 and r["error"]["type"] == "SearchContextMissingException", r
            walks[kind] = pages
        count_body = {"query": bodies[0]["query"]}
        counts = {}
        for path in ("/corpus/_count", "/corpus/doc/_count", "/_count"):
            st, r = http_json(conn, "POST", path, count_body)
            st2, s = http_json(conn, "POST", path.replace("_count", "_search"),
                               {**count_body, "size": 0})
            assert st == st2 == 200 and r["count"] == s["hits"]["total"], (path, r, s)
            counts[path] = r["count"]
        terms = [int(c["term"]["body"][1:]) for c in bodies[0]["query"]["bool"]["should"]]
        exact = int(term_docs(offsets, inv_docs, terms).size)
        assert counts["/corpus/_count"] == counts["/corpus/doc/_count"] == exact
        q = term_name(int(pool[3]))
        st, r = http_json(conn, "GET", f"/corpus/_count?q=body:{q}")
        st2, s = http_json(conn, "GET", f"/corpus/_search?q=body:{q}&size=0")
        assert st == st2 == 200 and r["count"] == s["hits"]["total"] == \
            int(term_docs(offsets, inv_docs, [int(pool[3])]).size), (r, s)
        ms_bodies = bodies[:8]
        ndjson = "".join(json.dumps({"index": "corpus"}) + "\n" + json.dumps(b) + "\n"
                         for b in ms_bodies)
        st, ms = http_json(conn, "POST", "/_msearch", ndjson=ndjson)
        assert st == 200 and len(ms["responses"]) == 8, ms
        for b, got in zip(ms_bodies, ms["responses"]):
            st, one = http_json(conn, "POST", "/corpus/_search", b)
            assert st == 200 and (got["hits"], got["_shards"]) == (one["hits"], one["_shards"])
        pref_body = bodies[1]
        st, r = http_json(conn, "POST", "/corpus/_search?preference=_shards:0,2", pref_body)
        assert st == 200 and r["_shards"]["total"] == 2, r
        assert {h["_shard"] for h in r["hits"]["hits"]} <= {0, 2}
        per_shard = [execute_query_phase(host[sid], tservice.parse_search_body(pref_body),
                                         use_device=False).total for sid in (0, 2)]
        assert r["hits"]["total"] == sum(per_shard), (r["hits"]["total"], per_shard)
        rescore_bodies = [dict(b, size=20, rescore={"window_size": 50, "query": {
            "rescore_query": {"match": {"body": " ".join(
                term_name(int(t)) for t in pool[5 + 2 * i: 7 + 2 * i])}},
            "query_weight": 0.7, "rescore_query_weight": 1.5}})
            for i, b in enumerate(bodies[2: 2 + n_rescore])]
        counters = dict(SERVING_COUNTERS)
        take()
        rs_resp, _lat, _wall = timed([("POST", "/corpus/_search", b, None)
                                      for b in rescore_bodies], sync_error=False)
        rescore_launch = take()
        moved = {k: v - counters[k] for k, v in SERVING_COUNTERS.items() if v != counters[k]}
        assert moved == {"host": n_rescore * NODE_SHARDS}, moved
        assert not sum(rescore_launch.values()), rescore_launch
        for b, (_st, r) in zip(rescore_bodies, rs_resp):
            check_page(r, host, b, exact=True)
        out["rest"] = dict(scroll_pages=walks["scroll"], scan_pages=walks["scan"],
                           buffered=len(full["hits"]["hits"]), counts=counts,
                           msearch=len(ms_bodies), preference_total=r["hits"]["total"],
                           rescore=n_rescore)
        log(f"[20] (c) scroll: {walks['scroll']} pages of 100 == the buffered top "
            f"{len(full['hits']['hits'])}, scan: {walks['scan']} pages (the first empty) == "
            f"it, both cleared then 404; _count {counts} == the size-0 totals (and the "
            f"exact count), with q= too; _msearch of 8 == the 8 searches; "
            f"preference=_shards:0,2 total == shards 0 and 2's; {n_rescore} rescore bodies "
            f"== the shards' host query phases reduced (bitwise, host path only)")
        conn.close()
        recorder.close()
        out["kernel_shapes"] = [dict(Qb=k[0][0], TB=k[0][1], k=k[2], launches=v[2])
                                for k, v in recorder.shapes.items()]
        out["kernel_max_abs_err"] = check_shapes(recorder.shapes)
        out["launches"] = launches
        out["wall_s"] = time.perf_counter() - t_phase
        log(f"[20] sparse_score == plain (bitwise) at all {len(recorder.shapes)} shapes "
            f"phase 20 launched ({launches.get('sparse_score', 0)} launches); max abs err "
            f"{out['kernel_max_abs_err']}; phase 20 took {out['wall_s']:.1f} s")
        return out
    finally:
        recorder.close()
        conn.close()


def analysis_vocab(rng, n_stems: int) -> list[str]:
    """`n_stems` distinct pronounceable stems (2-3 consonant-vowel
    syllables and a closing consonant), seeded."""
    stems, seen = [], set()
    while len(stems) < n_stems:
        n = int(rng.integers(2, 4))
        w = "".join(_CONSONANTS[int(rng.integers(len(_CONSONANTS)))]
                    + _VOWELS[int(rng.integers(len(_VOWELS)))] for _ in range(n))
        w += _CONSONANTS[int(rng.integers(len(_CONSONANTS)))]
        if w not in seen:
            seen.add(w)
            stems.append(w)
    return stems


class EnglishText:
    """Phase 18's English-like text: stems drawn zipf(ANALYSIS_ZIPF) under
    the suffixes, the stop words mixed in at ANALYSIS_STOP_SHARE."""

    def __init__(self, rng, stems: list[str]):
        self.rng, self.stems = rng, stems
        p = 1.0 / np.arange(1, len(stems) + 1) ** ANALYSIS_ZIPF
        self.cdf = np.cumsum(p / p.sum())

    def words(self, n: int, stop_share: float = ANALYSIS_STOP_SHARE) -> list[str]:
        rng = self.rng
        ranks = np.minimum(np.searchsorted(self.cdf, rng.random(n)), len(self.stems) - 1)
        suffix = rng.integers(0, len(ANALYSIS_SUFFIXES), n)
        stop = rng.random(n) < stop_share
        stops = rng.integers(0, len(ENGLISH_STOP), n)
        return [ENGLISH_STOP[int(stops[i])] if stop[i] else
                self.stems[int(ranks[i])] + ANALYSIS_SUFFIXES[int(suffix[i])]
                for i in range(n)]


def analysis_documents(n_docs: int, seed: int):
    """(stems, synonym rules, documents) of phase 18's `library` index."""
    rng = np.random.default_rng(seed)
    stems = analysis_vocab(rng, ANALYSIS_STEMS)
    text = EnglishText(rng, stems)
    groups = rng.choice(500, size=(ANALYSIS_SYNONYMS, 3), replace=False)
    rules = [",".join(stems[int(i)] for i in g[: 2 + int(rng.integers(0, 2))])
             for g in groups]
    docs = []
    for i in range(n_docs):
        words = text.words(max(1, int(rng.poisson(ANALYSIS_BODY))))
        if rng.random() < 0.3:  # a little markup
            a = int(rng.integers(0, len(words)))
            words[a] = f"<b>{words[a]}</b>"
            words.insert(0, "<p>")
            words.append("</p>")
        body = " ".join(words)
        docs.append({
            "title": " ".join(text.words(int(rng.integers(6, 13)), stop_share=0.25)),
            "body": body,
            "words": len(words),
            "client_ip": "%d.%d.%d.%d" % tuple(int(x) for x in rng.integers(1, 255, 4)),
            "views": int(rng.integers(0, 100_000)),
            "tenant": f"tenant{int(rng.integers(0, ANALYSIS_TENANTS))}",
            "published": f"2014-{1 + i % 12:02d}-{1 + i % 28:02d}T{i % 24:02d}:00:00Z"})
    return stems, rules, docs


def analysis_index_body(rules: list[str], n_shards: int, similarity: dict) -> dict:
    """The `library` index: an `english` title with a not-analyzed `raw` and
    a `shingles` sub-field, a `body_en` body (html_strip, standard,
    lowercase, stop, synonyms, porter_stem) with a `copy_to` catch-all and a
    token_count sub-field, `ip`, `integer`, `token_count`, `_routing.path`
    and `_timestamp`. As in the JAX package, parsing fills no sub-field, so
    the title also copies into `title_shingles` and `title_raw`, which the
    shingle and exact-match traffic reads."""
    return {
        "settings": {
            "number_of_shards": n_shards, "number_of_replicas": 0,
            "refresh_interval": -1,
            "index": {"similarity": {"default": similarity}},
            "analysis": {
                "filter": {"syn": {"type": "synonym", "synonyms": rules},
                           "sh": {"type": "shingle", "min_shingle_size": 2,
                                  "max_shingle_size": 3}},
                "analyzer": {
                    "body_en": {"char_filter": ["html_strip"], "tokenizer": "standard",
                                "filter": ["lowercase", "stop", "syn", "porter_stem"]},
                    "shingles": {"tokenizer": "standard",
                                 "filter": ["lowercase", "sh"]}}}},
        "mappings": {
            "book": {
                "_routing": {"path": "tenant"},
                "_timestamp": {"enabled": True, "path": "published"},
                "properties": {
                    "title": {"type": "string", "analyzer": "english",
                              "fields": {"raw": {"type": "string",
                                                 "index": "not_analyzed"},
                                         "shingles": {"type": "string",
                                                      "analyzer": "shingles"}},
                              "copy_to": ["title_shingles", "title_raw"]},
                    "title_shingles": {"type": "string", "analyzer": "shingles"},
                    "title_raw": {"type": "string", "index": "not_analyzed"},
                    "body": {"type": "string", "analyzer": "body_en",
                             "copy_to": "all_text",
                             "fields": {"length": {"type": "token_count",
                                                   "analyzer": "standard"}}},
                    "words": {"type": "token_count", "analyzer": "standard"},
                    "client_ip": {"type": "ip"},
                    "views": {"type": "integer"},
                    "tenant": {"type": "string", "index": "not_analyzed"},
                    "published": {"type": "date"}}},
            "private": {"_routing": {"required": True},
                        "properties": {"body": {"type": "string",
                                                "analyzer": "body_en"}}}}}


def analysis_traffic(rng, stems, docs, analysis, n_requests: int) -> list[tuple]:
    """Phase 18's requests in a seeded order: (family, index, body), an
    eighth each of `match` on `body`, `match` on the title's shingles, an
    exact title, `query_string` on the catch-all with the english analyzer,
    a 4-term `bool` across title and body, `multi_match`, `ip_range` and a
    sort on a token_count field (a sixteenth each), and the `match` bodies
    sent to `library_dfr`."""
    text = EnglishText(rng, stems)
    per = n_requests // 8
    english, body_en = analysis.analyzer("english"), analysis.analyzer("body_en")

    def term(analyzer):
        while True:
            terms = analyzer.terms(text.words(1, stop_share=0.0)[0])
            if terms:
                return terms[0]

    out = []
    for _ in range(per):
        out.append(("match", "library", {"query": {"match": {
            "body": " ".join(text.words(int(rng.integers(2, 5)), 0.0))}}, "size": 10}))
        out.append(("shingles", "library", {"query": {"match": {
            "title_shingles": " ".join(text.words(int(rng.integers(2, 4)), 0.0))}},
            "size": 10}))
        out.append(("raw", "library", {"query": {"term": {
            "title_raw": docs[int(rng.integers(len(docs)))]["title"]}}, "size": 10}))
        out.append(("query_string", "library", {"query": {"query_string": {
            "query": " ".join(text.words(int(rng.integers(2, 4)), 0.0)),
            "default_field": "all_text", "analyzer": "english"}}, "size": 10}))
        out.append(("bool", "library", {"query": {"bool": {"should": [
            {"term": {"title": term(english)}}, {"term": {"body": term(body_en)}},
            {"term": {"title": term(english)}}, {"term": {"body": term(body_en)}}]}},
            "size": 10}))
        out.append(("multi_match", "library", {"query": {"multi_match": {
            "query": " ".join(text.words(int(rng.integers(2, 4)), 0.0)),
            "fields": ["title", "body"]}}, "size": 10}))
        out.append(("dfr", "library_dfr", {"query": {"match": {
            "body": " ".join(text.words(int(rng.integers(2, 5)), 0.0))}}, "size": 10}))
    for _ in range(per // 2):
        out.append(("ip_range", "library", uncached({"query": {"match": {
            "body": " ".join(text.words(2, 0.0))}}, "size": 0, "aggs": {"ips": {
                "ip_range": {"field": "client_ip", "ranges": [
                    {"to": "64.0.0.0"}, {"from": "64.0.0.0", "to": "128.0.0.0"},
                    {"from": "128.0.0.0", "to": "192.168.0.0"},
                    {"from": "192.168.0.0"}]}}}})))
        out.append(("sort", "library", {"query": {"match": {
            "body": " ".join(text.words(2, 0.0))}}, "size": 10,
            "sort": [{"words": {"order": "desc"}}]}))
    return [out[i] for i in rng.permutation(len(out))]


def analysis_phase(device, *, seed: int, n_docs: int = ANALYSIS_DOCS,
                   n_dfr_docs: int = ANALYSIS_DFR_DOCS,
                   n_requests: int = ANALYSIS_REQUESTS,
                   n_callers: int = ANALYSIS_CALLERS,
                   phase10_docs_per_s: float | None = None) -> dict:
    """Phase 18: a port Node of its own on `device` (5 shards, like phase
    10's) holding `library`, a site-search index with custom analysis, the
    flat mapper's multi-fields, copy_to, ip, token_count, `_routing` and
    `_timestamp`, and BM25 with its own k1 and b, and `library_dfr` (1
    shard, DFR). Every response equals the node's own host query phases
    reduced; `library_dfr` launches nothing on the card."""
    import http.client

    import torch

    from elasticsearch_tpu_torch import actions as tactions
    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.mapper.core import DocumentMapper
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score, sparse_score_plain
    from elasticsearch_tpu_torch.search import (
        SERVING_COUNTERS, ShardContext, execute_query_phase, merge_responses,
        parse_search_body, sort_docs)
    from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    card = card_line() if on_card else f"{device} (a rehearsal: no card)"
    stems, rules, docs = analysis_documents(n_docs, seed)
    steps = {"documents": time.perf_counter() - t_phase}
    data_path = Path(__file__).resolve().parent / "build" / f"chip_smoke_analysis_{os.getpid()}"
    shutil.rmtree(data_path, ignore_errors=True)
    node = Node(name="analysis", registry=LocalTransportRegistry(), data_path=str(data_path),
                settings={"node.device": str(device)}).start()
    recorder = None
    try:
        port = node.start_http(0).port
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        st, r = http_json(conn, "PUT", "/library", analysis_index_body(
            rules, NODE_SHARDS, {"type": "BM25", "k1": 1.4, "b": 0.6}))
        assert st == 200 and r["acknowledged"], r
        st, r = http_json(conn, "PUT", "/library_dfr", analysis_index_body(
            rules, 1, {"type": "DFR", "basic_model": "g", "after_effect": "l",
                       "normalization": "h2"}))
        assert st == 200 and r["acknowledged"], r

        # -- the bulk, with the mapper's parse timed in its own threads ------
        parse_cpu = {"s": 0.0, "docs": 0}
        lock = threading.Lock()
        orig_parse = DocumentMapper.parse

        def timed_parse(self, *a, **kw):
            t0 = time.thread_time()
            try:
                return orig_parse(self, *a, **kw)
            finally:
                dt = time.thread_time() - t0
                with lock:
                    parse_cpu["s"] += dt
                    parse_cpu["docs"] += 1

        def bulk(index, lo, hi):
            for start in range(lo, hi, NODE_BULK):
                lines = []
                for i in range(start, min(start + NODE_BULK, hi)):
                    lines.append(json.dumps({"index": {"_index": index, "_type": "book",
                                                       "_id": str(i)}}))
                    lines.append(json.dumps(docs[i]))
                st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
                assert st == 200 and not r["errors"], (st, r.get("items", [])[:2])

        DocumentMapper.parse = timed_parse
        try:
            t0 = time.perf_counter()
            bulk("library", 0, n_docs)
            bulk_s = time.perf_counter() - t0
        finally:
            DocumentMapper.parse = orig_parse
        t0 = time.perf_counter()
        bulk("library_dfr", 0, min(n_dfr_docs, n_docs))
        steps["bulk"], steps["bulk_dfr"] = bulk_s, time.perf_counter() - t0
        for index in ("library", "library_dfr"):
            st, r = http_json(conn, "POST", f"/{index}/_refresh")
            assert st == 200 and r["_shards"]["failed"] == 0, r
        parse_ms = parse_cpu["s"] * 1e3 / max(parse_cpu["docs"], 1)

        # -- the mapping and the routing rules -------------------------------
        st, m = http_json(conn, "GET", "/library/_mapping")
        assert st == 200, m
        props = m["library"]["mappings"]["book"]["properties"]
        assert set(props["title"]["fields"]) == {"raw", "shingles"}, props["title"]
        assert props["title"]["copy_to"] == ["title_shingles", "title_raw"], props["title"]
        # the mapping as the index was created with it (a `_bulk` does not
        # put the dynamic copy_to target into the cluster's mapping)
        assert props["body"]["copy_to"] == "all_text" and \
            props["body"]["fields"]["length"]["type"] == "token_count", props["body"]
        assert props["client_ip"] == {"type": "ip"}, props
        assert m["library"]["mappings"]["book"]["_routing"] == {"path": "tenant"}
        st, r = http_json(conn, "PUT", "/library/private/p1", {"body": "no routing"})
        assert st == 400 and r["error"]["type"] == "RoutingMissingException", (st, r)
        st, r = http_json(conn, "PUT", "/library/private/p1?routing=tenant1",
                          {"body": "routed"})
        assert st == 201, (st, r)
        # a _bulk item is not checked for its routing, in either package
        st, r = http_json(conn, "POST", "/_bulk", ndjson=json.dumps(
            {"index": {"_index": "library", "_type": "private", "_id": "p2"}}) + "\n"
            + json.dumps({"body": "bulk without routing"}) + "\n")
        assert st == 200 and not r["errors"] and \
            r["items"][0]["index"]["status"] == 201, r
        st, r = http_json(conn, "GET", "/library/book/7")
        assert st == 200 and r["_source"] == docs[7], r
        st, r = http_json(conn, "POST", "/library/_refresh")
        assert st == 200, r
        conn.close()

        svc = {i: node.indices.index_service(i) for i in ("library", "library_dfr")}
        searchers = {i: [svc[i].shard(sid).engine.acquire_searcher()
                         for sid in sorted(svc[i].shards)] for i in svc}
        ctxs = {i: [ShardContext(sr, svc[i].mapper_service, svc[i].similarity_service,
                                 device=device) for sr in searchers[i]] for i in svc}
        assert sum(sr.max_doc for sr in searchers["library"]) == n_docs + 2
        fields = sorted(searchers["library"][0].segments[0].term_dict)
        terms = {f: sum(len(s.segments[0].term_dict.get(f, ())) for s in
                        searchers["library"]) for f in ("title", "title_shingles", "body",
                                                        "all_text")}
        log(f"[18] `library` on {device}: {n_docs} docs over HTTP in _bulk requests of "
            f"{NODE_BULK} into {NODE_SHARDS} shards: {n_docs / bulk_s:.1f} docs/s "
            f"({bulk_s:.1f} s; phase 10 "
            + (f"{phase10_docs_per_s:.1f}" if phase10_docs_per_s else "not run")
            + f" docs/s with the standard analyzer); DocumentMapper.parse {parse_ms:.3f} "
            f"CPU ms a document over {parse_cpu['docs']} parses; {len(fields)} indexed "
            f"fields a segment; terms a shard's first segment summed: {terms}; "
            f"`library_dfr` {min(n_dfr_docs, n_docs)} docs, 1 shard; {card}")

        # -- the traffic ------------------------------------------------------
        rng = np.random.default_rng(seed + 1)
        traffic = analysis_traffic(rng, stems, docs, svc["library"].mapper_service.analysis,
                                   n_requests)
        requests = [(f"/{index}/_search", body) for _f, index, body in traffic]
        families = np.array([f for f, _i, _b in traffic])
        # first sightings pack each shard and build its sort keys and bucket
        # columns: warm before the clock
        t0 = time.perf_counter()
        warm = serve_http(port, requests[: 2 * n_callers], n_callers, sync_error=False)
        assert not warm[3], warm[3][:3]
        steps["warm"] = time.perf_counter() - t0
        recorder = LaunchRecorder(scoring, sparse_score)
        before = dict(SERVING_COUNTERS)
        cudaenv.LAUNCHES.reset()
        responses, lat_ms, wall_s, errors, host_cpu = serve_http(
            port, requests, n_callers, sync_error=on_card)
        launches = cudaenv.LAUNCHES.snapshot()
        counted = {k: v - before[k] for k, v in SERVING_COUNTERS.items() if v != before[k]}
        recorder.close()
        steps["run"] = wall_s
        assert not errors, f"{len(errors)} requests failed, first {errors[:3]}"
        n_of = {f: int((families == f).sum()) for f in set(families)}
        assert counted.get("device_sparse", 0) > 0, counted
        assert counted.get("device_aggs", 0) == NODE_SHARDS * n_of["ip_range"], counted
        assert counted.get("device_sort", 0) == NODE_SHARDS * n_of["sort"], counted
        assert counted.get("degraded", 0) == 0 and counted.get("device_errors", 0) == 0, \
            counted
        if on_card:
            assert launches.get("sparse_score", 0) > 0, "sparse_score never launched in phase 18"

        # -- every response against the node's own host query phases ----------
        t0 = time.perf_counter()
        exact = dict.fromkeys(n_of, 0)
        for i, ((family, index, body), (st, r)) in enumerate(zip(traffic, responses)):
            shards = len(ctxs[index])
            assert st == 200, (i, family, r)
            assert r["_shards"] == {"total": shards, "successful": shards,
                                    "degraded": 0, "failed": 0}, (i, r["_shards"])
            req = parse_search_body(body)
            res = [execute_query_phase(c, req, use_device=False, shard_id=sid)
                   for sid, c in enumerate(ctxs[index])]
            merged = sort_docs(req, res)
            want = merge_responses(req, merged, res, [], took_ms=0,
                                   total_shards=shards, successful=shards)
            assert r["hits"]["total"] == want["hits"]["total"], (i, family, "total")
            want_hits = []
            for score, sid, doc, sv in merged.hits[req.from_: req.from_ + req.size]:
                seg, local = searchers[index][sid].resolve(doc)
                want_hits.append((score, (sid, seg.ids[local]), sv))
            got_hits = [(float("nan") if h["_score"] is None else h["_score"],
                         (h["_shard"], h["_id"]), h.get("sort")) for h in r["hits"]["hits"]]
            if family == "dfr":  # both answers from the host scorer
                assert got_hits == want_hits, (i, family, "hits")
            else:
                assert shard_docs_match(got_hits, want_hits, bool(req.sort)), \
                    (i, family, "hits")
            exact[family] += same_hits_exact(got_hits, want_hits)
            if req.aggs:
                agg_close(r["aggregations"], want["aggregations"], req.body, AGG_RTOL,
                          f"{family}[{i}]")
                assert sum(b["doc_count"] for b in r["aggregations"]["ips"]["buckets"]) \
                    == r["hits"]["total"], (i, r["aggregations"])
        check_s = steps["check"] = time.perf_counter() - t0
        totals = {f: int(sum(r["hits"]["total"] for (g, _i, _b), (_s, r)
                             in zip(traffic, responses) if g == f)) for f in n_of}
        assert all(v > 0 for v in totals.values()), totals

        # -- library_dfr alone: no device work --------------------------------
        dfr = [req for req, f in zip(requests, families) if f == "dfr"]
        before = dict(SERVING_COUNTERS)
        cudaenv.LAUNCHES.reset()
        d_resp, _dl, d_wall, d_err, _dc = serve_http(port, dfr, n_callers, sync_error=on_card)
        dfr_launches = cudaenv.LAUNCHES.snapshot()
        steps["dfr_run"] = d_wall
        dfr_counted = {k: v - before[k] for k, v in SERVING_COUNTERS.items() if v != before[k]}
        assert not d_err, d_err[:3]
        assert dfr_counted == {"host": len(dfr)}, dfr_counted
        assert not any(dfr_launches.values()), dfr_launches
        want_dfr = [r for (f, _i, _b), r in zip(traffic, responses) if f == "dfr"]
        assert [r["hits"] for _s, r in d_resp] == [r["hits"] for _s, r in want_dfr]

        # -- the kernel at phase 18's shapes -----------------------------------
        t0 = time.perf_counter()
        max_err = check_shapes(recorder.shapes)
        shapes = []
        for key, (args, kwargs, n) in recorder.shapes.items():
            nbytes, ops, _real = launch_bound(args, kwargs)
            b_ms, b_by = bound_ms(nbytes, ops)
            shapes.append(dict(
                Qb=int(args[0].shape[0]), TB=int(args[0].shape[1]), tf=str(args[10].dtype),
                k=kwargs["k"], passes=kwargs["passes"], simple=kwargs["simple"],
                use_coord=kwargs["use_coord"], launches=n, ms=time_ms(lambda: sparse_score(*args, **kwargs), device, 5),
                plain_ms=time_ms(lambda: sparse_score_plain(*args, **kwargs), device, 5),
                bound_ms=b_ms, bound_by=b_by))

        steps["kernel_checks"] = time.perf_counter() - t0
        by_family = {}
        for f in n_of:
            lat = lat_ms[families == f]
            by_family[f] = dict(requests=int(len(lat)), p50_ms=float(np.percentile(lat, 50)),
                                p99_ms=float(np.percentile(lat, 99)),
                                bitwise_share=exact[f] / max(n_of[f], 1))
        out = dict(docs=n_docs, dfr_docs=min(n_dfr_docs, n_docs), shards=NODE_SHARDS,
                   bulk_s=bulk_s, bulk_docs_per_s=n_docs / bulk_s,
                   phase10_docs_per_s=phase10_docs_per_s, parse_cpu_ms_a_doc=parse_ms,
                   fields_a_segment=len(fields), terms=terms, requests=len(traffic),
                   callers=n_callers, wall_s=wall_s,
                   requests_per_s=len(traffic) / wall_s, latency_by_family=by_family,
                   counters=counted, launches=launches, host_cpu_s=host_cpu,
                   check_s=check_s, hits_by_family=totals, dfr_wall_s=d_wall,
                   dfr_counters=dfr_counted, dfr_launches=dfr_launches,
                   kernel_shapes=shapes, kernel_max_abs_err=max_err, card=card,
                   sync_debug="error over both timed runs" if on_card else None)
        log(f"[18] {len(traffic)} _search requests from {n_callers} connections: "
            f"{out['requests_per_s']:.1f} requests/s ({wall_s:.2f} s); serving counters "
            f"{counted}; launches {launches}; every response == the node's host query "
            f"phases reduced (card families within {ULPS} ulp, tie-tolerant; `dfr` "
            f"bitwise; ip_range counts exact; {check_s:.1f} s); {card}")
        for f, v in by_family.items():
            log(f"[18]   {f:13s} {v['requests']:4d} requests: p50 {v['p50_ms']:.2f} ms, "
                f"p99 {v['p99_ms']:.2f} ms, bitwise {v['bitwise_share']:.4f}, hits "
                f"{totals[f]}")
        log(f"[18] `library_dfr` alone: {len(dfr)} requests in {d_wall:.2f} s, counters "
            f"{dfr_counted}, launches {dfr_launches or 'none'}; hits == the mixed run's")
        log(f"[18] host CPU s over the {wall_s:.2f} s run, by thread kind: "
            + ", ".join(f"{k} {v:.2f}" for k, v in host_cpu.items()))
        for sh in shapes:
            log(f"[18]   sparse_score Qb {sh['Qb']} TB {sh['TB']} {sh['tf']} k {sh['k']} "
                f"passes {sh['passes']} simple {sh['simple']} coord {sh['use_coord']}: "
                f"{sh['launches']} launches, "
                f"{sh['ms']:.4f} ms a launch (plain {sh['plain_ms']:.4f}, bound "
                f"{sh['bound_ms']:.6f} {sh['bound_by']})")
        log(f"[18] sparse_score == plain (bitwise) at all {len(shapes)} shapes phase 18 "
            f"launched; max abs err {max_err}")
        if on_card:
            from torch.profiler import ProfilerActivity, profile

            lib = [req for req, f in zip(requests, families)
                   if f != "dfr"][:ANALYSIS_PROFILED]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _r, _l, pwall_s, perrors, _c = serve_http(port, lib, n_callers,
                                                          sync_error=False)
            steps["profiled"] = time.perf_counter() - t0
            assert not perrors, perrors[:3]
            out["profiled"] = p = device_busy(prof, pwall_s * 1e3)
            if p["device_busy_ms"]:
                log(f"[18] profiled window of {len(lib)} `library` requests: wall "
                    f"{p['wall_ms']:.2f} ms, device busy {p['device_busy_ms']:.3f} ms, "
                    f"idle share {p['idle_share']:.4f}; {card}")
                for name, ms, n in p["top"][:6]:
                    log(f"[18]   {ms:9.3f} ms {n:5d}x {name}")
            else:
                log("[18] profiled window: the profiler saw no device time "
                    "(device idle share not measured)")
        out["wall_phase_s"] = time.perf_counter() - t_phase
        out["steps_s"] = steps
        log(f"[18] phase 18 took {out['wall_phase_s']:.1f} s; by step (s): "
            + ", ".join(f"{k} {v:.1f}" for k, v in steps.items()))
        return out
    finally:
        if recorder is not None:
            recorder.close()
        node.close()
        shutil.rmtree(data_path, ignore_errors=True)
        from elasticsearch_tpu_torch.ops.device_index import PACK_LEDGER

        for index in ("library", "library_dfr"):
            PACK_LEDGER.forget(index)


# ---------------------------------------------------------------------------
# phase 19: nested documents, parent/child joins and geo fields
# ---------------------------------------------------------------------------

GEO_FAMILIES = (  # (family, index, on the card)
    ("flat", "blogposts", True), ("nested", "blogposts", False),
    ("nested_range", "blogposts", False), ("nested_filtered", "blogposts", True),
    ("geo_distance", "blogposts", True), ("geo_buckets", "blogposts", True),
    ("geo_host_aggs", "blogposts", False), ("geo_sort", "blogposts", False),
    ("geo_decay", "blogposts", True), ("has_child", "company", False),
    ("has_parent", "company", False), ("geo_shape", "company", True))
BLOG_MAPPING = {"properties": {
    "title": {"type": "string"}, "body": {"type": "string"},
    "location": {"type": "geo_point"},
    "comments": {"type": "nested", "properties": {
        "name": {"type": "string", "index": "not_analyzed"},
        "comment": {"type": "string"}, "age": {"type": "integer"},
        "stars": {"type": "integer"}, "date": {"type": "date"}}}}}
COMPANY_MAPPINGS = {
    "branch": {"properties": {"name": {"type": "string"},
                              "city": {"type": "string", "index": "not_analyzed"},
                              "country": {"type": "string", "index": "not_analyzed"},
                              "area": {"type": "geo_shape"}}},
    "employee": {"_parent": {"type": "branch"},
                 "properties": {"name": {"type": "string"}, "dob": {"type": "date"},
                                "hobby": {"type": "string"}}}}


def geo_documents(n_posts: int, n_branches: int, n_employees: int, seed: int):
    """Phase 19's data, in the shapes of the Elasticsearch 1.x guide's own
    examples: blog posts with a `location` around GEO_CITIES seeded city
    centres and 0-8 nested comments (name, comment, age, stars, date), and
    a company's branches (a `geo_shape` area around a city) with employees
    under them. Returns (cities, stems, posts, branches, employees)."""
    rng = np.random.default_rng(seed)
    stems = analysis_vocab(rng, 3000)
    text = EnglishText(rng, stems)
    cities = np.stack([rng.uniform(-50, 65, GEO_CITIES),
                       rng.uniform(-150, 150, GEO_CITIES)], axis=1)
    names = [f"{stems[int(i)]}_{j}" for j, i in enumerate(rng.integers(0, 500, 200))]
    posts = []
    for i in range(n_posts):
        lat, lon = cities[int(rng.integers(GEO_CITIES))]
        post = {"title": " ".join(text.words(int(rng.integers(4, 10)), stop_share=0.2)),
                "body": " ".join(text.words(max(3, int(rng.poisson(40))))),
                "location": {"lat": float(np.clip(lat + rng.normal(0, 0.3), -89, 89)),
                             "lon": float(np.clip(lon + rng.normal(0, 0.3), -179, 179))}}
        n = int(rng.integers(0, 9))
        if n:
            post["comments"] = [{
                "name": names[int(rng.integers(len(names)))],
                "comment": " ".join(text.words(max(2, int(rng.poisson(10))))),
                "age": int(rng.integers(16, 80)), "stars": int(rng.integers(1, 6)),
                "date": f"2014-{1 + int(rng.integers(12)):02d}-{1 + int(rng.integers(28)):02d}"}
                for _ in range(n)]
        posts.append(post)
    branches = []
    for i in range(n_branches):
        c = int(rng.integers(GEO_CITIES))
        lat, lon = cities[c]
        w = float(rng.uniform(0.2, 1.5))
        branches.append((f"br{i}", {
            "name": f"branch {' '.join(text.words(2, stop_share=0.0))} {i}",
            "city": f"city{c}", "country": f"country{c % 12}",
            "area": {"type": "envelope", "coordinates": [[float(lon - w), float(lat + w)],
                                                         [float(lon + w), float(lat - w)]]}}))
    hobbies = stems[:40]
    employees = [(f"e{i}", f"br{int(rng.integers(n_branches))}", {
        "name": f"{names[int(rng.integers(len(names)))]} {stems[int(rng.integers(3000))]}",
        "dob": f"19{int(rng.integers(50, 99))}-{1 + int(rng.integers(12)):02d}-"
               f"{1 + int(rng.integers(28)):02d}",
        "hobby": " ".join(hobbies[int(h)] for h in rng.integers(0, 40, 2))})
        for i in range(n_employees)]
    return cities, stems, posts, branches, employees


def geo_traffic(rng, cities, stems, n_requests: int) -> list[tuple]:
    """(family, index, body): the GEO_FAMILIES in a seeded order, each an
    equal share; words drawn from the `top` most common stems (a geo
    family's from the 30 most common, so its filter has hits to gate)."""
    def words(n, top=300):
        return " ".join(stems[int(i)] for i in rng.integers(0, top, n))

    def city():
        lat, lon = cities[int(rng.integers(GEO_CITIES))]
        return {"lat": float(lat), "lon": float(lon)}

    nested_range = {"nested": {"path": "comments", "query": {
        "range": {"comments.stars": {"gte": 4}}}}}
    out = []
    order = rng.permutation(np.arange(n_requests) % len(GEO_FAMILIES))
    for fi in order:
        family, index, _card = GEO_FAMILIES[int(fi)]
        if family == "flat":
            body = {"query": {"match": {"body": words(3)}}}
        elif family == "nested":
            body = {"query": {"nested": {"path": "comments", "score_mode": "avg", "query": {
                "match": {"comments.comment": words(2)}}}}}
        elif family == "nested_range":
            body = {"query": {"bool": {"must": [{"match": {"body": words(2)}}],
                                       "filter": [nested_range]}}}
        elif family == "nested_filtered":
            body = {"query": {"filtered": {"query": {"match": {"body": words(2)}},
                                           "filter": nested_range}}}
        elif family == "geo_distance":
            body = {"query": {"filtered": {"query": {"match": {"body": words(2, 30)}},
                                           "filter": {"geo_distance": {
                                               "distance": "50km", "location": city()}}}}}
        elif family == "geo_buckets":
            body = {"size": 0, "query": {"match": {"body": words(2)}}, "aggs": {
                "rings": {"geo_distance": {"field": "location", "origin": city(),
                                           "unit": "km", "ranges": [
                                               {"to": 100}, {"from": 100, "to": 1000},
                                               {"from": 1000}]}},
                "grid": {"geohash_grid": {"field": "location", "precision": 3}}}}
        elif family == "geo_host_aggs":
            body = {"size": 0, "query": {"match": {"body": words(2)}}, "aggs": {
                "bounds": {"geo_bounds": {"field": "location"}},
                "comments": {"nested": {"path": "comments"}, "aggs": {
                    "stars": {"avg": {"field": "comments.stars"}}}}}}
        elif family == "geo_sort":
            body = {"query": {"match": {"body": words(2)}}, "sort": [
                {"_geo_distance": {"location": city(), "order": "asc", "unit": "km"}}]}
        elif family == "geo_decay":
            body = {"query": {"function_score": {
                "query": {"match": {"body": words(2)}},
                "functions": [{"gauss": {"location": {"origin": city(),
                                                      "scale": "100km"}}}]}}}
        elif family == "has_child":
            body = {"query": {"has_child": {"type": "employee", "score_mode": "max",
                                            "query": {"match": {"hobby": words(2, 40)}}}}}
        elif family == "has_parent":
            body = {"query": {"has_parent": {"parent_type": "branch", "query": {
                "term": {"country": f"country{int(rng.integers(12))}"}}}}}
        else:  # geo_shape
            c = city()
            body = {"query": {"filtered": {
                "query": {"match": {"name": f"branch {words(1, 30)}"}},
                "filter": {"geo_shape": {"area": {"shape": {
                    "type": "envelope",
                    "coordinates": [[c["lon"] - 2, c["lat"] + 2],
                                    [c["lon"] + 2, c["lat"] - 2]]}}}}}}}
        body.setdefault("size", 10)
        out.append((family, index, uncached(body)))
    return out


def put_many(port: int, puts: list, n_conn: int = 16) -> None:
    """Single-document PUTs from `n_conn` keep-alive connections at once
    (one connection waits out a delayed ACK on every small response)."""
    import http.client

    def worker(c):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            for path, src in puts[c::n_conn]:
                st, r = http_json(conn, "PUT", path, src)
                assert st == 201, (path, st, r)
        finally:
            conn.close()

    errors = []

    def run(c):
        try:
            worker(c)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(c,)) for c in range(n_conn)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def same_hits_exact(got, want) -> bool:
    """Host pages: equal ids and sort values, scores bitwise (NaN with NaN)."""
    return len(got) == len(want) and all(
        g[1:] == w[1:] and (g[0] == w[0] or (g[0] != g[0] and w[0] != w[0]))
        for g, w in zip(got, want))


def geo_nested_phase(device, *, seed: int, n_posts: int = GEO_POSTS,
                     n_branches: int = GEO_BRANCHES, n_employees: int = GEO_EMPLOYEES,
                     n_requests: int = GEO_REQUESTS,
                     n_callers: int = GEO_CALLERS) -> dict:
    """Phase 19: a port Node of its own on `device` (5 shards, 0 replicas,
    `refresh_interval: -1`) holding `blogposts` (nested comments, a
    geo_point) and `company` (branches with a geo_shape area, employees
    under `_parent`, written one by one with `?parent=`). Every response
    equals the node's own host query phases reduced; `sparse_score` runs
    over nested packs and is bitwise at each launched shape; each family
    alone launches the card's programs or none; a DELETE takes a post's
    comments out of every count; an `_optimize`'s merged packs equal fresh
    packs and lose the children's doc values on the card as on the host."""
    import http.client

    import torch

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.device_index import (PACK_LEDGER, pack_cache_key,
                                                          pack_segment, packed_for)
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score, sparse_score_plain
    from elasticsearch_tpu_torch.search import (
        SERVING_COUNTERS, ShardContext, execute_query_phase, merge_responses,
        parse_search_body, sort_docs)
    from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    card = card_line() if on_card else f"{device} (a rehearsal: no card)"
    cities, stems, posts, branches, employees = geo_documents(
        n_posts, n_branches, n_employees, seed)
    n_comments = sum(len(p.get("comments", ())) for p in posts)
    steps = {"documents": time.perf_counter() - t_phase}
    data_path = Path(__file__).resolve().parent / "build" / f"chip_smoke_geo_{os.getpid()}"
    shutil.rmtree(data_path, ignore_errors=True)
    node = Node(name="geo", registry=LocalTransportRegistry(), data_path=str(data_path),
                settings={"node.device": str(device)}).start()
    recorder = None
    settings = {"number_of_shards": NODE_SHARDS, "number_of_replicas": 0,
                "refresh_interval": -1}
    try:
        port = node.start_http(0).port
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        for index, mappings in (("blogposts", {"blogpost": BLOG_MAPPING}),
                                ("company", COMPANY_MAPPINGS)):
            st, r = http_json(conn, "PUT", f"/{index}",
                              {"settings": settings, "mappings": mappings})
            assert st == 200 and r["acknowledged"], r

        # -- the writes: posts by _bulk (two refreshes: two segments a shard),
        # branches and employees one by one (a _bulk sets no parent) ----------
        t0 = time.perf_counter()
        for lo, hi in ((0, n_posts // 2), (n_posts // 2, n_posts)):
            for start in range(lo, hi, NODE_BULK):
                lines = []
                for i in range(start, min(start + NODE_BULK, hi)):
                    lines.append(json.dumps({"index": {"_index": "blogposts",
                                                       "_type": "blogpost",
                                                       "_id": str(i)}}))
                    lines.append(json.dumps(posts[i]))
                st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
                assert st == 200 and not r["errors"], (st, r.get("items", [])[:2])
            st, r = http_json(conn, "POST", "/blogposts/_refresh")
            assert st == 200, r
        bulk_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        put_many(port, [(f"/company/branch/{bid}", src) for bid, src in branches])
        st, r = http_json(conn, "POST", "/company/_refresh")
        put_many(port, [(f"/company/employee/{eid}?parent={parent}", src)
                        for eid, parent, src in employees])
        singles_s = time.perf_counter() - t0
        st, r = http_json(conn, "PUT", "/company/employee/orphan", {"name": "no parent"})
        assert st == 400 and r["error"]["type"] == "RoutingMissingException", (st, r)
        st, r = http_json(conn, "GET", f"/company/employee/{employees[0][0]}"
                                       f"?parent={employees[0][1]}")
        assert st == 200 and r["_source"] == employees[0][2], r
        for index in ("blogposts", "company"):
            st, r = http_json(conn, "POST", f"/{index}/_refresh")
            assert st == 200 and r["_shards"]["failed"] == 0, r
        steps["bulk"], steps["singles"] = bulk_s, singles_s

        svc = {i: node.indices.index_service(i) for i in ("blogposts", "company")}

        def contexts():
            searchers = {i: [svc[i].shard(sid).engine.acquire_searcher()
                             for sid in sorted(svc[i].shards)] for i in svc}
            return searchers, {i: [ShardContext(sr, svc[i].mapper_service,
                                                svc[i].similarity_service, device=device)
                                   for sr in searchers[i]] for i in svc}

        searchers, ctxs = contexts()
        lucene_docs = sum(sr.max_doc for sr in searchers["blogposts"])
        assert lucene_docs == n_posts + n_comments, (lucene_docs, n_posts, n_comments)
        log(f"[19] `blogposts` on {device}: {n_posts} posts with {n_comments} nested "
            f"comments ({lucene_docs} Lucene documents) over HTTP in _bulk requests of "
            f"{NODE_BULK} into {NODE_SHARDS} shards: {n_posts / bulk_s:.1f} posts/s "
            f"({lucene_docs / bulk_s:.1f} documents/s, {bulk_s:.1f} s); `company`: "
            f"{n_branches} branches and {n_employees} employees by single-document PUT "
            f"?parent= in {singles_s:.1f} s; {card}")

        # -- the traffic --------------------------------------------------------
        rng = np.random.default_rng(seed + 1)
        traffic = geo_traffic(rng, cities, stems, n_requests)
        requests = [(f"/{index}/_search", body) for _f, index, body in traffic]
        families = np.array([f for f, _i, _b in traffic])
        t0 = time.perf_counter()  # first sightings pack each shard: warm first
        warm = serve_http(port, requests[:n_callers], n_callers, sync_error=False)
        assert not warm[3], warm[3][:3]
        steps["warm"] = time.perf_counter() - t0
        recorder = LaunchRecorder(scoring, sparse_score)
        before = dict(SERVING_COUNTERS)
        cudaenv.LAUNCHES.reset()
        responses, lat_ms, wall_s, errors, host_cpu = serve_http(
            port, requests, n_callers, sync_error=on_card)
        launches = cudaenv.LAUNCHES.snapshot()
        counted = {k: v - before[k] for k, v in SERVING_COUNTERS.items() if v != before[k]}
        recorder.close()
        steps["run"] = wall_s
        assert not errors, f"{len(errors)} requests failed, first {errors[:3]}"
        assert counted.get("degraded", 0) == 0 and counted.get("device_errors", 0) == 0, \
            counted
        if on_card:
            assert launches.get("sparse_score", 0) > 0, "sparse_score never launched in phase 19"

        # -- every response against the node's own host query phases ----------
        t0 = time.perf_counter()
        card_family = {f: c for f, _i, c in GEO_FAMILIES}

        def check(family, index, body, st, r, tag):
            shards = len(ctxs[index])
            assert st == 200, (tag, family, r)
            assert r["_shards"] == {"total": shards, "successful": shards,
                                    "degraded": 0, "failed": 0}, (tag, r["_shards"])
            req = parse_search_body(body)
            res = [execute_query_phase(c, req, use_device=False, shard_id=sid)
                   for sid, c in enumerate(ctxs[index])]
            merged = sort_docs(req, res)
            want = merge_responses(req, merged, res, [], took_ms=0,
                                   total_shards=shards, successful=shards)
            assert r["hits"]["total"] == want["hits"]["total"], (tag, family, "total")
            want_hits = []
            for score, sid, doc, sv in merged.hits[req.from_: req.from_ + req.size]:
                seg, local = searchers[index][sid].resolve(doc)
                want_hits.append((score, (sid, seg.ids[local]), sv))
            got_hits = [(float("nan") if h["_score"] is None else h["_score"],
                         (h["_shard"], h["_id"]), h.get("sort")) for h in r["hits"]["hits"]]
            if card_family[family]:
                assert shard_docs_match(got_hits, want_hits, bool(req.sort)), \
                    (tag, family, "hits")
            else:  # both from the host scorer
                assert same_hits_exact(got_hits, want_hits), (tag, family, "hits")
            if req.aggs:
                agg_close(r["aggregations"], want["aggregations"], req.body, AGG_RTOL,
                          f"{family}[{tag}]")
            return r["hits"]["total"]

        totals = dict.fromkeys(set(families), 0)
        for i, ((family, index, body), (st, r)) in enumerate(zip(traffic, responses)):
            totals[family] += check(family, index, body, st, r, i)
        check_s = steps["check"] = time.perf_counter() - t0
        assert all(v > 0 for v in totals.values()), totals

        # -- each family alone: the card's launch its programs, the host's none
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        alone = {}
        for family, index, is_card in GEO_FAMILIES:
            bodies = [b for f, _i, b in traffic if f == family][:4]
            before = dict(SERVING_COUNTERS)
            cudaenv.LAUNCHES.reset()
            for body in bodies:
                st, r = http_json(conn, "POST", f"/{index}/_search", body)
                assert st == 200, r
            fam_launches = cudaenv.LAUNCHES.snapshot()
            fam_counted = {k: v - before[k] for k, v in SERVING_COUNTERS.items()
                           if v != before[k]}
            device_counted = {k: v for k, v in fam_counted.items() if k.startswith("device_")}
            alone[family] = dict(counters=fam_counted, launches=fam_launches)
            if is_card:
                assert sum(device_counted.values()) == NODE_SHARDS * len(bodies), \
                    (family, fam_counted)
                if family == "flat" and on_card:
                    assert fam_launches.get("sparse_score", 0) > 0, (family, fam_launches)
            else:
                assert fam_counted == {"host": NODE_SHARDS * len(bodies)}, \
                    (family, fam_counted)
                assert not any(fam_launches.values()), (family, fam_launches)
        steps["alone"] = time.perf_counter() - t0

        # -- a DELETE of a post with comments: its children leave every count --
        count_body = {"size": 0, "query": {"match_all": {}}, "aggs": {
            "c": {"nested": {"path": "comments"}, "aggs": {
                "stars": {"stats": {"field": "comments.stars"}}}}}}
        victim = next(i for i, p in enumerate(posts) if len(p.get("comments", ())) >= 3)
        st, r0 = http_json(conn, "POST", "/blogposts/_search", count_body)
        assert st == 200, r0
        st, r = http_json(conn, "DELETE", f"/blogposts/blogpost/{victim}")
        assert st == 200 and r["found"], r
        st, r = http_json(conn, "POST", "/blogposts/_refresh")
        st, r1 = http_json(conn, "POST", "/blogposts/_search", count_body)
        assert st == 200, r1
        gone = len(posts[victim]["comments"])
        assert r1["hits"]["total"] == r0["hits"]["total"] - 1, (r0["hits"], r1["hits"])
        assert r1["aggregations"]["c"]["doc_count"] == \
            r0["aggregations"]["c"]["doc_count"] - gone, (r0["aggregations"], r1["aggregations"])
        assert r1["aggregations"]["c"]["stars"]["count"] == \
            r0["aggregations"]["c"]["stars"]["count"] - gone
        searchers, ctxs = contexts()
        assert sum(sr.max_doc for sr in searchers["blogposts"]) == lucene_docs
        assert sum(seg.live_count() for sr in searchers["blogposts"]
                   for seg in sr.segments) == n_posts - 1

        # -- _optimize: merged packs equal fresh packs; the children's doc
        # values are gone, on the card as on the host -------------------------
        ranged = [(f, i, b) for f, i, b in traffic
                  if f in ("nested_range", "nested_filtered")][:8]
        pre = [http_json(conn, "POST", f"/{i}/_search", b)[1]["hits"]["total"]
               for _f, i, b in ranged]
        assert sum(pre) > 0, pre
        t0 = time.perf_counter()
        st, r = http_json(conn, "POST", "/blogposts/_optimize")
        assert st == 200, r
        deadline = time.perf_counter() + 120
        while True:
            w = node.warmer.stats()
            if w["packs_done"] >= w["packs_scheduled"]:
                break
            assert time.perf_counter() < deadline, f"warmer not drained: {w}"
            time.sleep(0.05)
        steps["optimize"] = time.perf_counter() - t0
        searchers, ctxs = contexts()
        key = pack_cache_key(device)
        bad = []
        for sr in searchers["blogposts"]:
            assert len(sr.segments) == 1, len(sr.segments)
            seg = sr.segments[0]
            merged_pack = seg._device_cache.get(key) or packed_for(seg, device)
            bad += packs_equal(merged_pack, pack_segment(seg, device))
            assert not any(f.startswith("comments.") for f in seg.dv_num), sorted(seg.dv_num)
        assert not bad, f"merged packs differ from fresh packs in {bad}"
        before = dict(SERVING_COUNTERS)
        for (family, index, body), n_pre in zip(ranged, pre):
            st, r = http_json(conn, "POST", f"/{index}/_search", body)
            assert check(family, index, body, st, r, "optimized") == 0, (family, n_pre)
        post_counted = {k: v - before[k] for k, v in SERVING_COUNTERS.items()
                        if v != before[k]}
        assert post_counted.get("device_filtered", 0) > 0, post_counted
        for family in ("flat", "geo_buckets", "has_child"):
            f, index, body = next(t for t in traffic if t[0] == family)
            st, r = http_json(conn, "POST", f"/{index}/_search", body)
            check(f, index, body, st, r, "optimized")
        conn.close()

        # -- the kernel at phase 19's shapes -----------------------------------
        t0 = time.perf_counter()
        max_err = check_shapes(recorder.shapes)
        shapes = []
        for _key, (args, kwargs, n) in recorder.shapes.items():
            nbytes, ops, _real = launch_bound(args, kwargs)
            b_ms, b_by = bound_ms(nbytes, ops)
            shapes.append(dict(
                Qb=int(args[0].shape[0]), TB=int(args[0].shape[1]), tf=str(args[10].dtype),
                k=kwargs["k"], passes=kwargs["passes"], simple=kwargs["simple"],
                use_coord=kwargs["use_coord"], launches=n,
                ms=time_ms(lambda: sparse_score(*args, **kwargs), device, 5),
                plain_ms=time_ms(lambda: sparse_score_plain(*args, **kwargs), device, 5),
                bound_ms=b_ms, bound_by=b_by))
        steps["kernel_checks"] = time.perf_counter() - t0
        by_family = {}
        for f in sorted(set(families)):
            lat = lat_ms[families == f]
            by_family[f] = dict(requests=int(len(lat)), p50_ms=float(np.percentile(lat, 50)),
                                p99_ms=float(np.percentile(lat, 99)), hits=totals[f])
        out = dict(posts=n_posts, comments=n_comments, lucene_docs=lucene_docs,
                   branches=n_branches, employees=n_employees, shards=NODE_SHARDS,
                   bulk_s=bulk_s, singles_s=singles_s, requests=len(traffic),
                   callers=n_callers, wall_s=wall_s, requests_per_s=len(traffic) / wall_s,
                   latency_by_family=by_family, counters=counted, launches=launches,
                   alone=alone, host_cpu_s=host_cpu, check_s=check_s,
                   kernel_shapes=shapes, kernel_max_abs_err=max_err, card=card,
                   sync_debug="error over the timed run" if on_card else None)
        log(f"[19] {len(traffic)} _search requests from {n_callers} connections: "
            f"{out['requests_per_s']:.1f} requests/s ({wall_s:.2f} s); serving counters "
            f"{counted}; launches {launches}; every response == the node's host query "
            f"phases reduced (card families within {ULPS} ulp, tie-tolerant; host "
            f"families bitwise; aggregations exact but sums; {check_s:.1f} s); {card}")
        for f, v in by_family.items():
            log(f"[19]   {f:15s} {v['requests']:4d} requests: p50 {v['p50_ms']:.2f} ms, "
                f"p99 {v['p99_ms']:.2f} ms, hits {v['hits']}; alone "
                f"{alone[f]['counters']}, launches {alone[f]['launches'] or 'none'}")
        log(f"[19] DELETE of post {victim}: its {gone} comments left the nested count; "
            f"_optimize to 1 segment a shard in {steps['optimize']:.2f} s: merged packs == "
            f"fresh packs, the nested range matches 0 on the card's `filtered` and the "
            f"host (children's doc values dropped, the JAX package's behaviour)")
        log(f"[19] host CPU s over the {wall_s:.2f} s run, by thread kind: "
            + ", ".join(f"{k} {v:.2f}" for k, v in host_cpu.items()))
        for sh in shapes:
            log(f"[19]   sparse_score Qb {sh['Qb']} TB {sh['TB']} {sh['tf']} k {sh['k']} "
                f"passes {sh['passes']} simple {sh['simple']} coord {sh['use_coord']}: "
                f"{sh['launches']} launches, {sh['ms']:.4f} ms a launch (plain "
                f"{sh['plain_ms']:.4f}, bound {sh['bound_ms']:.6f} {sh['bound_by']})")
        log(f"[19] sparse_score == plain (bitwise) at all {len(shapes)} shapes phase 19 "
            f"launched over nested packs; max abs err {max_err}")
        if on_card:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _r, _l, pwall_s, perrors, _c = serve_http(port, requests[:GEO_PROFILED],
                                                          n_callers, sync_error=False)
            steps["profiled"] = time.perf_counter() - t0
            assert not perrors, perrors[:3]
            out["profiled"] = p = device_busy(prof, pwall_s * 1e3)
            if p["device_busy_ms"]:
                log(f"[19] profiled window of {GEO_PROFILED} requests: wall "
                    f"{p['wall_ms']:.2f} ms, device busy {p['device_busy_ms']:.3f} ms, "
                    f"idle share {p['idle_share']:.4f}; {card}")
                for name, ms, n in p["top"][:6]:
                    log(f"[19]   {ms:9.3f} ms {n:5d}x {name}")
            else:
                log("[19] profiled window: the profiler saw no device time "
                    "(device idle share not measured)")
        out["wall_phase_s"] = time.perf_counter() - t_phase
        out["steps_s"] = steps
        log(f"[19] phase 19 took {out['wall_phase_s']:.1f} s; by step (s): "
            + ", ".join(f"{k} {v:.1f}" for k, v in steps.items()))
        return out
    finally:
        if recorder is not None:
            recorder.close()
        node.close()
        shutil.rmtree(data_path, ignore_errors=True)
        for index in ("blogposts", "company"):
            PACK_LEDGER.forget(index)


# ---------------------------------------------------------------------------
# phase 22: documents under search
# ---------------------------------------------------------------------------

DOC_BLOG = {"properties": {"title": {"type": "string"}, "body": {"type": "string"},
                           "tags": {"type": "string", "index": "not_analyzed"},
                           "views": {"type": "integer"}},
            "_timestamp": {"enabled": True}}


def tag_name(t: int) -> str:
    return f"tag{t:02d}"


class ConflictCount:
    """Counts, while installed (a `with` block), the VersionConflictErrors
    the index round trip of an `_update` raises (each is retried while
    `retry_on_conflict` lasts, then answered 409)."""

    def __init__(self, owner):
        self.owner, self.n, self.lock = owner, 0, threading.Lock()

    def __enter__(self):
        from elasticsearch_tpu_torch.common.errors import VersionConflictError

        self.orig = orig = self.owner.index_doc
        counter = self

        def index_doc(*args, **kwargs):
            try:
                return orig(*args, **kwargs)
            except VersionConflictError:
                with counter.lock:
                    counter.n += 1
                raise

        self.owner.index_doc = index_doc
        return self

    def __exit__(self, *exc):
        self.owner.index_doc = self.orig


def documents_phase(device, *, vocab: int, seed: int, n_posts: int = DOC_POSTS,
                    n_drafts: int = DOC_DRAFTS, n_sessions: int = DOC_SESSIONS,
                    n_requests: int = DOC_REQUESTS, n_bulk_updates: int = DOC_BULK_UPDATES,
                    n_checks: int = DOC_CHECKS, n_conn: int = DOC_CONN) -> dict:
    """Phase 22: a port Node of its own on `device` (`indices.ttl.interval:
    1s`) holding `website` (5 shards, `refresh_interval: 1s`; `blog` posts
    and `draft`s) and `sessions` (1 shard, `_ttl` default 3s): search on the
    card while documents are updated, created, deleted by query, dropped
    with their type and expired. Every acknowledged write is read back,
    every checked search equals the shards' host query phases and names no
    deleted document, and `sparse_score` is bitwise against its plain
    version at every shape the phase launched over the tombstoned views."""
    import http.client
    from collections import Counter

    import torch

    from elasticsearch_tpu_torch import actions as tactions
    from elasticsearch_tpu_torch import warmer as twarmer
    from elasticsearch_tpu_torch.actions import A_GET, A_INDEX_PRIMARY, A_SHARD_BROADCAST
    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.index import engine as tengine
    from elasticsearch_tpu_torch.index.engine import Engine
    from elasticsearch_tpu_torch.mapper.core import DocumentMapper
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.device_index import PACK_LEDGER
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score
    from elasticsearch_tpu_torch.script import UpdateScript
    from elasticsearch_tpu_torch.search import (
        ShardContext, execute_query_phase, parse_search_body, sort_docs)
    from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    card = card_line() if on_card else f"{device} (a rehearsal: no card)"
    rng = np.random.default_rng(seed)
    n_extra = 1024  # texts for the `doc` updates and the created posts
    texts, offsets, inv_docs = node_corpus(n_posts + n_extra, vocab, seed)
    tag_of = rng.integers(0, DOC_TAGS, n_posts)
    dbq_tags = [tag_name(t) for t in range(10, 10 + DOC_DBQ_TAGS)]

    def post(text: str, tag: int) -> dict:
        return {"title": " ".join(text.split()[:5]), "body": text,
                "tags": [tag_name(int(tag))], "views": 0}

    expected = {str(i): post(texts[i], tag_of[i]) for i in range(n_posts)}
    safe = [str(i) for i in rng.permutation(n_posts) if tag_name(tag_of[i]) not in dbq_tags]
    hot = safe[:DOC_HOT]
    hot_p = 1.0 / np.arange(1, DOC_HOT + 1) ** DOC_HOT_ZIPF
    hot_p /= hot_p.sum()
    doc_ids = iter(safe[DOC_HOT:])  # each `doc` update edits a post of its own
    extra = iter(range(n_posts, n_posts + n_extra))
    new_ids = iter(range(10 ** 6))
    df = np.diff(offsets)
    ranked = np.argsort(-df, kind="stable")
    rows = rng.choice(ranked[RANKS[0]: RANKS[1]], size=(4096, TERMS_PER_QUERY))
    bodies = [{"query": {"bool": {"should": [{"term": {"body": term_name(int(t))}}
                                             for t in row]}}, "size": NODE_SIZE}
              for row in rows]
    body_it = iter(bodies)
    families = [f for f, _p in DOC_MIX]
    mix_p = np.array([p for _f, p in DOC_MIX])

    def traffic(n: int):
        """`n` requests of the mix: [(method, path, body, None)] and beside
        each (family, key, what it writes when acknowledged)."""
        reqs, meta = [], []
        for fam in rng.choice(families, size=n, p=mix_p / mix_p.sum()):
            if fam == "search":
                reqs.append(("POST", "/website/_search", next(body_it), None))
                meta.append((fam, None, None))
            elif fam == "increment":
                key = hot[int(rng.choice(DOC_HOT, p=hot_p))]
                reqs.append(("POST", f"/website/blog/{key}/_update?retry_on_conflict=5",
                             {"script": "ctx._source.views += n", "params": {"n": 1}}, None))
                meta.append((fam, key, None))
            elif fam == "doc":
                key, new = next(doc_ids), post(texts[next(extra)], 0)
                edit = {"title": new["title"], "body": new["body"]}
                reqs.append(("POST", f"/website/blog/{key}/_update", {"doc": edit}, None))
                meta.append((fam, key, edit))
            elif fam == "mget":
                ids = [str(i) for i in rng.choice(n_posts, 10, replace=False)]
                if rng.random() < 0.5:
                    reqs.append(("POST", "/website/blog/_mget", {"ids": ids}, None))
                else:
                    reqs.append(("POST", "/_mget", {"docs": [
                        {"_index": "website", "_type": "blog", "_id": i} for i in ids]}, None))
                meta.append((fam, ids, None))
            elif fam == "source":
                key = str(int(rng.integers(n_posts)))
                reqs.append(("GET", f"/website/blog/{key}/_source?_source_include=title,views",
                             None, None))
                meta.append((fam, key, None))
            else:  # create: half new ids, half taken
                if rng.random() < 0.5:
                    key = f"new{next(new_ids)}"
                    src = post(texts[next(extra)], rng.integers(DOC_TAGS))
                else:
                    key, src = str(int(rng.integers(n_posts))), {"title": "taken"}
                reqs.append(("PUT", f"/website/blog/{key}/_create", src, None))
                meta.append((fam, key, src))
        return reqs, meta

    acked = Counter()  # hot post -> acknowledged increments
    tally = Counter()  # (family, outcome) -> requests

    def account(meta, responses):
        """Fold a leg's answers into `expected` and the tallies; a request
        that failed in a way its family does not allow fails the phase."""
        for (fam, key, payload), (st, r) in zip(meta, responses):
            if fam == "search":
                assert st == 200 and r["_shards"] == SHARDS_OK, (fam, st, r)
            elif fam == "increment":
                assert st in (200, 409), (fam, key, st, r)
                if st == 200:
                    acked[key] += 1
                    expected[key]["views"] += 1
            elif fam == "doc":
                assert st == 200, (fam, key, st, r)
                expected[key].update(payload)
            elif fam == "mget":
                assert st == 200 and [d["_id"] for d in r["docs"]] == key and \
                    all(d["found"] for d in r["docs"]), (fam, st, r)
            elif fam == "source":
                assert st == 200 and "title" in r and set(r) <= {"title", "views"}, r
            else:
                taken = not key.startswith("new")
                assert st == (409 if taken else 201), (fam, key, st, r)
                if not taken:
                    expected[key] = dict(payload)
            tally[(fam, st)] += 1

    data_path = Path(__file__).resolve().parent / "build" / f"chip_smoke_docs_{os.getpid()}"
    shutil.rmtree(data_path, ignore_errors=True)
    node = Node(name="documents", registry=LocalTransportRegistry(),
                data_path=str(data_path),
                settings={"node.device": str(device), "indices.ttl.interval": "1s"}).start()
    recorder = None
    launches: dict = {}
    steps: dict = {}

    def take() -> dict:
        snap = cudaenv.LAUNCHES.snapshot()
        cudaenv.LAUNCHES.reset()
        for name, n in snap.items():
            launches[name] = launches.get(name, 0) + n
        return snap

    def drained() -> bool:
        st = node.warmer.stats()
        return st["packs_done"] >= st["packs_scheduled"]

    def wait_drained(timeout: float = 120.0):
        deadline = time.perf_counter() + timeout
        while not drained():
            assert time.perf_counter() < deadline, f"warmer not drained: {node.warmer.stats()}"
            time.sleep(0.01)

    def by_family(meta, lat_ms) -> dict:
        fams = np.array([m[0] for m in meta])
        out = {}
        for f in families:
            lat = lat_ms[fams == f]
            if len(lat):
                out[f] = dict(requests=int(len(lat)), p50_ms=float(np.percentile(lat, 50)),
                              p99_ms=float(np.percentile(lat, 99)))
        return out

    try:
        port = node.start_http(0).port
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        st, r = http_json(conn, "PUT", "/website", {
            "settings": {"number_of_shards": NODE_SHARDS, "number_of_replicas": 0,
                         "refresh_interval": "1s"},
            "mappings": {"blog": DOC_BLOG, "draft": DOC_BLOG}})
        assert st == 200 and r["acknowledged"], r
        st, r = http_json(conn, "PUT", "/sessions", {
            "settings": {"number_of_shards": 1, "number_of_replicas": 0},
            "mappings": {"session": {"_ttl": {"enabled": True, "default": f"{DOC_TTL_S:g}s"},
                                     "properties": {"user": {"type": "string",
                                                             "index": "not_analyzed"}}}}})
        assert st == 200 and r["acknowledged"], r

        # -- the posts and drafts by _bulk ----------------------------------
        t0 = time.perf_counter()
        docs = [("blog", str(i), expected[str(i)]) for i in range(n_posts)] + \
            [("draft", f"d{i}", post(texts[i], 40 + i % 10)) for i in range(n_drafts)]
        for lo in range(0, len(docs), NODE_BULK):
            lines = []
            for type_name, doc_id, src in docs[lo: lo + NODE_BULK]:
                lines.append(json.dumps({"index": {"_index": "website", "_type": type_name,
                                                   "_id": doc_id}}))
                lines.append(json.dumps(src))
            st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
            assert st == 200 and not r["errors"], (st, r.get("items", [])[:2])
        st, r = http_json(conn, "POST", "/website/_refresh")
        assert st == 200 and r["_shards"]["failed"] == 0, r
        steps["bulk"] = bulk_s = time.perf_counter() - t0
        log(f"[22] `website` on {device}: {n_posts} posts and {n_drafts} drafts over HTTP "
            f"in _bulk requests of {NODE_BULK} into {NODE_SHARDS} shards: "
            f"{len(docs) / bulk_s:.1f} docs/s ({bulk_s:.1f} s); {card}")

        # -- the gate: every shard's first search packs inline; none after --
        t0 = time.perf_counter()
        warm, _l, _w = http_requests(port, [("POST", "/website/_search", b, None)
                                            for b in bodies[-2 * n_conn:]], n_conn)
        assert all(st == 200 for st, _r in warm), warm[:2]
        wait_drained()
        PACK_LEDGER.forget("website")
        stolen0 = node.warmer.stats()["packs_stolen"]
        steps["warm"] = time.perf_counter() - t0
        recorder = LaunchRecorder(scoring, sparse_score)
        # the phase counts from here: nothing launched before (an earlier
        # phase, this phase's gate) is its own
        cudaenv.LAUNCHES.reset()

        # -- searches alone: the same bodies with no writes on this node -----
        alone_bodies = bodies[-2 * n_conn - DOC_SEARCH_ONLY: -2 * n_conn]
        got, lat, wall = http_requests(port, [("POST", "/website/_search", b, None)
                                              for b in alone_bodies], n_conn)
        assert all(st == 200 and r["_shards"] == SHARDS_OK for st, r in got), got[:2]
        alone = dict(requests=len(alone_bodies), searches_per_s=len(alone_bodies) / wall,
                     p50_ms=float(np.percentile(lat, 50)),
                     p99_ms=float(np.percentile(lat, 99)),
                     sparse_launches=take().get("sparse_score", 0))
        steps["searches_alone"] = wall

        # -- the timed mix ----------------------------------------------------
        reqs, meta = traffic(n_requests)
        counter = ConflictCount(tactions.ActionModule)
        mclock = SpanClock([
            ("query phase (search pool)", tactions, "execute_query_phase"),
            ("_update (coordinator)", tactions.ActionModule, "update_doc"),
            ("refresh (refresh pool and writes)", Engine, "refresh"),
            ("merge_segments (merge pool)", tengine, "merge_segments"),
            ("warm packs (warmer and merge pools)", twarmer, "run_warm")])
        with counter, mclock:
            cpu0, process0 = thread_cpu_s(), time.process_time()
            responses, lat_ms, wall_s = http_requests(port, reqs, n_conn)
            host_cpu = host_cpu_split(cpu0, thread_cpu_s(), time.process_time() - process0)
        account(meta, responses)
        mix_tally = {f"{f}:{s}": n for (f, s), n in sorted(tally.items())}
        mixed_launches = take()
        steps["mixed"] = wall_s
        n_search = sum(1 for m in meta if m[0] == "search")
        exhausted = tally[("increment", 409)]
        mixed = dict(requests=len(reqs), connections=n_conn, wall_s=wall_s,
                     requests_per_s=len(reqs) / wall_s, searches=n_search,
                     searches_per_s=n_search / wall_s,
                     latency_by_family=by_family(meta, lat_ms), host_cpu_s=host_cpu,
                     process_cpu_s=sum(host_cpu.values()), spans=mclock.report(),
                     conflicts=counter.n, retries=counter.n - exhausted,
                     increments_409=exhausted, launches=mixed_launches)
        if on_card:
            assert mixed_launches.get("sparse_score", 0) > 0, "no launch beside the writes"

        # -- the device's idle share over a profiled window of the mix ---------
        if on_card:
            from torch.profiler import ProfilerActivity, profile

            preqs, pmeta = traffic(DOC_PROFILED)
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                presp, _pl, pwall = http_requests(port, preqs, n_conn)
            account(pmeta, presp)
            mixed["profiled"] = device_busy(prof, pwall * 1e3)
            take()
            steps["profiled"] = time.perf_counter() - t0

        # -- an _update's CPU: its get round trip, its script, its index round
        # trip (4 connections, nothing else running) ----------------------------
        ureqs, umeta = [], []
        for _ in range(DOC_UPDATE_CPU):
            key = hot[int(rng.choice(DOC_HOT, p=hot_p))]
            ureqs.append(("POST", f"/website/blog/{key}/_update?retry_on_conflict=5",
                          {"script": "ctx._source.views += n", "params": {"n": 1}}, None))
            umeta.append(("increment", key, None))
        handlers = node.transport.handlers
        uclock = SpanClock([
            ("_update (coordinator)", tactions.ActionModule, "update_doc"),
            ("  get round trip", tactions.ActionModule, "get_doc"),
            ("    shard GET (get pool)", handlers[A_GET], "fn"),
            ("  script", UpdateScript, "run"),
            ("  index round trip", tactions.ActionModule, "index_doc"),
            ("    shard index (index pool)", handlers[A_INDEX_PRIMARY], "fn"),
            ("      mapper parse", DocumentMapper, "parse")])
        with uclock:
            uresp, ulat, uwall = http_requests(port, ureqs, 4)
        steps["update_cpu"] = uwall
        account(umeta, uresp)
        update_cpu = dict(requests=len(ureqs), wall_s=uwall,
                          p50_ms=float(np.percentile(ulat, 50)), spans=uclock.report())

        # -- a _bulk of update items -------------------------------------------
        keys = [hot[int(i)] for i in rng.choice(DOC_HOT, size=n_bulk_updates, p=hot_p)]
        lines = []
        for key in keys:
            lines += [json.dumps({"update": {"_index": "website", "_type": "blog",
                                             "_id": key}}),
                      json.dumps({"script": "ctx._source.views += 1"})]
        t0 = time.perf_counter()
        st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
        steps["bulk_updates"] = bulk_updates_s = time.perf_counter() - t0
        assert st == 200 and not r["errors"], [i for i in r["items"] if "error" in i["update"]][:2]
        for key, item in zip(keys, r["items"]):
            assert item["update"]["status"] == 200 and item["update"]["_id"] == key, item
            acked[key] += 1
            expected[key]["views"] += 1

        # -- delete-by-query of 5 tags while searches run ----------------------
        deleted = {k for k, src in expected.items() if set(src["tags"]) & set(dbq_tags)}
        dclock = SpanClock([
            ("shard delete-by-query (management pool)", handlers[A_SHARD_BROADCAST], "fn"),
            ("  resolve (host_match_mask)", tactions, "host_match_mask"),
            ("  tombstone (delete_by_uids)", Engine, "delete_by_uids"),
            ("  refresh (every caller)", Engine, "refresh")])
        beside = {}
        searches = [("POST", "/website/_search", next(body_it), None)
                    for _ in range(DOC_DBQ_SEARCHES)]
        runner = threading.Thread(target=lambda: beside.update(
            r=http_requests(port, searches, n_conn)))
        with dclock:
            runner.start()
            t0 = time.perf_counter()
            st, r = http_json(conn, "DELETE", "/website/blog/_query", {"query": {
                "filtered": {"filter": {"terms": {"tags": dbq_tags}}}}})
            dbq_s = time.perf_counter() - t0
            runner.join(timeout=600)
        assert st == 200 and r["_indices"]["website"]["deleted"] == len(deleted), \
            (r, len(deleted))
        t0 = time.perf_counter()
        wait_drained()
        repack_s = time.perf_counter() - t0
        got, blat, bwall = beside["r"]
        assert all(s == 200 and g["_shards"] == SHARDS_OK for s, g in got), got[:2]
        for key in deleted:
            expected.pop(key)
        dbq = dict(deleted=len(deleted), share=len(deleted) / (n_posts + sum(
            1 for k in expected if k.startswith("new"))), wall_s=dbq_s, repack_s=repack_s,
                   spans=dclock.report(), searches_beside=len(searches),
                   searches_beside_per_s=len(searches) / bwall,
                   searches_beside_p50_ms=float(np.percentile(blat, 50)),
                   searches_beside_p99_ms=float(np.percentile(blat, 99)))
        steps["delete_by_query"] = bwall
        take()

        # -- DELETE _mapping of `draft` ----------------------------------------
        t0 = time.perf_counter()
        st, r = http_json(conn, "DELETE", "/website/_mapping/draft")
        drop_s = time.perf_counter() - t0
        assert st == 200 and r == {"acknowledged": True}, r
        st, r = http_json(conn, "GET", "/website/_mapping")
        assert st == 200 and list(r["website"]["mappings"]) == ["blog"], r

        # -- the TTL leg: sessions expire and the purger deletes them -----------
        t0 = time.perf_counter()
        for lo in range(0, n_sessions, NODE_BULK):
            lines = []
            for i in range(lo, min(lo + NODE_BULK, n_sessions)):
                lines += [json.dumps({"index": {"_index": "sessions", "_type": "session",
                                                "_id": str(i)}}),
                          json.dumps({"user": f"u{i % 97}"})]
            st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
            assert st == 200 and not r["errors"], r.get("items", [])[:2]
        t_written = time.perf_counter()
        st, r = http_json(conn, "POST", "/sessions/_refresh")
        st, r = http_json(conn, "GET", "/sessions/_count")
        assert st == 200 and r["count"] > 0, r
        counted = r["count"]
        while True:
            st, r = http_json(conn, "GET", "/sessions/_count")
            if r["count"] == 0:
                break
            assert time.perf_counter() - t_written < DOC_TTL_S + 30, r
            time.sleep(0.05)
        purge_lag_s = time.perf_counter() - (t_written + DOC_TTL_S)
        ttl = dict(sessions=n_sessions, bulk_s=t_written - t0, counted_after_bulk=counted,
                   lag_s=purge_lag_s)
        steps["ttl"] = time.perf_counter() - t0

        # -- the checks, after a final _refresh --------------------------------
        t0 = time.perf_counter()
        st, r = http_json(conn, "POST", "/website/_refresh")
        assert st == 200, r
        wait_drained()
        # since the gate, every query-path pack was a warm pack the warmer had
        # scheduled and a racing search ran first (a steal, by design since
        # the write path's slice): no view went unscheduled
        ledger = PACK_LEDGER.stats("website")
        query_path = {p: n for p, n in ledger.get("pools", {}).items()
                      if p not in ("warmer", "merge")}
        stolen = node.warmer.stats()["packs_stolen"] - stolen0
        assert sum(query_path.values()) == stolen, (ledger.get("pools"), stolen)
        PACK_LEDGER.forget("website")
        # every acknowledged write read back (and every deleted one gone)
        keys = sorted(set(expected) | deleted | {k for k in hot})
        wrong = []
        for lo in range(0, len(keys), 500):
            chunk = keys[lo: lo + 500]
            st, r = http_json(conn, "POST", "/website/blog/_mget", {"ids": chunk})
            assert st == 200, r
            for key, d in zip(chunk, r["docs"]):
                want = expected.get(key)
                if (want is None) == d["found"] or (want is not None and d["_source"] != want):
                    wrong.append((key, d, want))
        assert not wrong, wrong[:3]
        assert all(expected[k]["views"] == acked[k] for k in hot), "views != acknowledged"
        # the checked searches, through the card over the tombstoned views
        svc = node.indices.index_service("website")
        check_bodies = [next(body_it) for _ in range(n_checks)]
        take()
        got, _l, check_wall = http_requests(port, [("POST", "/website/_search", b, None)
                                                   for b in check_bodies], n_conn)
        check_launches = take()
        searchers = [svc.shard(sid).engine.acquire_searcher() for sid in range(NODE_SHARDS)]
        dead = sum(int((~seg.live).sum()) for sr in searchers for seg in sr.segments)
        assert dead > 0, "no tombstone in the views the checks searched"
        ctxs = [ShardContext(sr, svc.mapper_service, svc.similarity_service, device=device)
                for sr in searchers]
        hits_seen = 0
        for i, ((st, r), body) in enumerate(zip(got, check_bodies)):
            assert st == 200 and r["_shards"] == SHARDS_OK, (i, r)
            req = parse_search_body(body)
            res = [execute_query_phase(c, req, use_device=False, shard_id=sid)
                   for sid, c in enumerate(ctxs)]
            merged = sort_docs(req, res)
            assert r["hits"]["total"] == merged.total, (i, r["hits"]["total"], merged.total)
            want = []
            for score, sid, doc, sv in merged.hits[: req.size]:
                seg, local = searchers[sid].resolve(doc)
                want.append((score, (sid, seg.ids[local]), sv))
            have = [(h["_score"], (h["_shard"], h["_id"]), None) for h in r["hits"]["hits"]]
            assert shard_docs_match(have, want, False), (i, have, want)
            for h in r["hits"]["hits"]:
                assert h["_type"] == "blog" and h["_id"] in expected, h
            hits_seen += len(have)
        assert hits_seen > 0
        if on_card:
            assert check_launches.get("sparse_score", 0) > 0, check_launches
        # _count per tag, against the expected sources
        by_tag = Counter(t for src in expected.values() for t in src["tags"])
        for t in range(DOC_TAGS):
            st, r = http_json(conn, "POST", "/website/_count",
                              {"query": {"term": {"tags": tag_name(t)}}})
            assert st == 200 and r["count"] == by_tag.get(tag_name(t), 0), (t, r)
        st, r = http_json(conn, "POST", "/website/_count", {"query": {"filtered": {
            "filter": {"type": {"value": "draft"}}}}})
        assert r["count"] == 0, r
        st, r = http_json(conn, "POST", "/sessions/_search", {"query": {"match_all": {}}})
        assert st == 200 and r["hits"]["total"] == 0, r
        # and none at all over the checks, on the drained views
        check_pools = dict(PACK_LEDGER.stats("website").get("pools", {}))
        assert set(check_pools) <= {"warmer", "merge"}, check_pools
        steps["checks"] = time.perf_counter() - t0
        conn.close()
        take()  # the `_count` checks' launches too
        recorder.close()

        # -- the kernel at phase 22's shapes ---------------------------------
        t0 = time.perf_counter()
        recorded = sum(n for _args, _kwargs, n in recorder.shapes.values())
        if on_card:  # every counted launch is one the shapes' checks hold
            assert launches.get("sparse_score", 0) == recorded, (launches, recorded)
        max_err = check_shapes(recorder.shapes)
        shapes = [dict(Qb=int(args[0].shape[0]), TB=int(args[0].shape[1]),
                       tf=str(args[10].dtype), k=kwargs["k"], launches=n)
                  for _key, (args, kwargs, n) in recorder.shapes.items()]
        steps["kernel_checks"] = time.perf_counter() - t0
        out = dict(posts=n_posts, drafts=n_drafts, card=card, bulk_s=bulk_s,
                   searches_alone=alone, mixed=mixed, update_cpu=update_cpu,
                   bulk_updates=dict(items=n_bulk_updates, wall_s=bulk_updates_s),
                   delete_by_query=dbq, drop_type_s=drop_s, ttl=ttl,
                   checks=dict(searches=n_checks, wall_s=check_wall, hits=hits_seen,
                               dead_docs=dead, launches=check_launches,
                               ledger_pools=check_pools),
                   packs=dict(pools=dict(ledger.get("pools", {})), query_path=query_path,
                              stolen=stolen),
                   tally=mix_tally,
                   tally_all_legs={f"{f}:{s}": n for (f, s), n in sorted(tally.items())},
                   launches=launches, kernel_shapes=shapes, kernel_max_abs_err=max_err)

        log(f"[22] searches alone: {alone['requests']} of phase 10's bool bodies from "
            f"{n_conn} connections, {alone['searches_per_s']:.1f} searches/s, p50 "
            f"{alone['p50_ms']:.2f} ms p99 {alone['p99_ms']:.2f} ms; {card}")
        log(f"[22] the mix: {mixed['requests']} requests from {n_conn} connections, "
            f"{mixed['requests_per_s']:.1f} requests/s ({wall_s:.2f} s), of them "
            f"{n_search} searches: {mixed['searches_per_s']:.1f} searches/s beside the "
            f"writes; the mix's outcomes {mix_tally}; {card}")
        for f, v in mixed["latency_by_family"].items():
            log(f"[22]   {f:10s} {v['requests']:5d} requests: p50 {v['p50_ms']:.2f} ms, "
                f"p99 {v['p99_ms']:.2f} ms")
        log(f"[22] conflicts: {mixed['conflicts']} version conflicts on the index round "
            f"trip, {mixed['retries']} retried, {mixed['increments_409']} increments "
            f"answered 409 after retry_on_conflict 5")
        log(f"[22] CPU s by thread kind over the mix ({mixed['process_cpu_s']:.2f} s of "
            f"the process in {wall_s:.2f} s): "
            + ", ".join(f"{k} {v:.2f}" for k, v in host_cpu.items()))
        for span, v in mixed["spans"].items():
            log(f"[22]   span {span:38s} {v['calls']:5d} calls, CPU {v['cpu_s']:.3f} s, "
                f"wall {v['wall_s']:.3f} s")
        if mixed.get("profiled"):
            p = mixed["profiled"]
            if p["device_busy_ms"]:
                log(f"[22] profiled window of {DOC_PROFILED} mixed requests: wall "
                    f"{p['wall_ms']:.2f} ms, device busy {p['device_busy_ms']:.3f} ms, "
                    f"idle share {p['idle_share']:.4f}; {card}")
                for name, ms, n in p["top"][:6]:
                    log(f"[22]   {ms:9.3f} ms {n:5d}x {name}")
            else:
                log("[22] profiled window: the profiler saw no device time "
                    "(device idle share not measured)")
        log(f"[22] an _update's CPU ({DOC_UPDATE_CPU} increments from 4 connections, "
            f"p50 {update_cpu['p50_ms']:.2f} ms):")
        for span, v in update_cpu["spans"].items():
            log(f"[22]   span {span:32s} {v['calls']:5d} calls, CPU "
                f"{v['cpu_s'] * 1e3 / max(v['calls'], 1):.3f} ms a call, wall "
                f"{v['wall_s'] * 1e3 / max(v['calls'], 1):.3f} ms a call")
        log(f"[22] _bulk of {n_bulk_updates} update items: {bulk_updates_s:.2f} s "
            f"({n_bulk_updates / bulk_updates_s:.1f} updates/s)")
        log(f"[22] delete-by-query of {DOC_DBQ_TAGS} tags: {len(deleted)} posts "
            f"({dbq['share']:.3f} of them) in {dbq_s:.3f} s, the warmer's repack after it "
            f"{repack_s:.3f} s; {len(searches)} searches beside it at "
            f"{dbq['searches_beside_per_s']:.1f} searches/s, p50 "
            f"{dbq['searches_beside_p50_ms']:.2f} ms, p99 "
            f"{dbq['searches_beside_p99_ms']:.2f} ms")
        for span, v in dbq["spans"].items():
            log(f"[22]   span {span:42s} {v['calls']:5d} calls, CPU {v['cpu_s']:.3f} s, "
                f"wall {v['wall_s']:.3f} s")
        log(f"[22] DELETE _mapping/draft ({n_drafts} drafts) in {drop_s:.3f} s; TTL: "
            f"{n_sessions} sessions bulked in {ttl['bulk_s']:.2f} s, `_count` 0 "
            f"{purge_lag_s:.2f} s after the last one's expiry (purger every 1 s)")
        log(f"[22] checks: every acknowledged write read back ({len(keys)} ids by _mget; "
            f"{sum(acked.values())} increments on {DOC_HOT} hot posts); {n_checks} searches "
            f"== the shards' host query phases (within {ULPS} ulp, tie-tolerant; "
            f"{hits_seen} hits, none deleted, dropped or purged) over views holding "
            f"{dead} tombstones; `_count` per tag == the expected sources")
        log(f"[22] packs since the gate by pool {dict(ledger.get('pools', {}))}: "
            f"{sum(query_path.values())} on the query path, each a warm pack the warmer "
            f"had scheduled and a racing search ran first ({stolen} stolen); none over "
            f"the checks")
        for sh in shapes:
            log(f"[22]   sparse_score Qb {sh['Qb']} TB {sh['TB']} {sh['tf']} k {sh['k']}: "
                f"{sh['launches']} launches")
        log(f"[22] sparse_score == plain (bitwise) at all {len(shapes)} shapes phase 22 "
            f"launched ({launches.get('sparse_score', 0)} launches in the phase, "
            f"{recorded} of them recorded at those shapes); max abs "
            f"err {max_err}")
        out["wall_phase_s"] = time.perf_counter() - t_phase
        out["steps_s"] = steps
        log(f"[22] phase 22 took {out['wall_phase_s']:.1f} s; by step (s): "
            + ", ".join(f"{k} {v:.1f}" for k, v in steps.items()))
        return out
    finally:
        if recorder is not None:
            recorder.close()
        node.close()
        shutil.rmtree(data_path, ignore_errors=True)



# ---------------------------------------------------------------------------
# phase 23: index lifecycle
# ---------------------------------------------------------------------------


def day_name(d: int) -> str:
    return f"logs-2014.01.{d + 1:02d}"


def lifecycle_phase(device, *, vocab: int, seed: int, n_days: int = LIFE_DAYS,
                    day_docs: int = LIFE_DAY_DOCS, n_cycles: int = LIFE_CYCLES,
                    n_requests: int = LIFE_REQUESTS, n_checks: int = LIFE_CHECKS,
                    n_conn: int = LIFE_CONN) -> dict:
    """Phase 23: a port Node of its own on `device` holding time-based
    indexes in the shape of Elasticsearch: The Definitive Guide (1.x),
    "Index per Time Frame", "Index Templates", "Retiring Data" and "Faking
    Index per User with Aliases": a template `logs-*` (1 shard, 0
    replicas, `refresh_interval: -1`, `message` text, not-analyzed
    `user_id` and `level`, a `date`, the alias `last_7_days`), a day index a
    day created by it, the write alias `logs_current` moved each day in one
    `_aliases` call, a search warmer a day and filtered aliases `user_<n>`.
    The days fill, their searches run through the aliases (7 shards sparse;
    filtered aliases on the dense filtered family) and are held against the
    shards' host query phases; the oldest days are retired (settings,
    close, open, delete) and the card's memory checked to go back; the
    caches clear; one call of each remaining route. `sparse_score` bitwise
    against its plain version at every shape the phase launched, the
    warmers' launches among them."""
    import http.client

    import torch

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.device_index import (
        _SegmentFilterMasks, pack_cache_key, packed_resident_bytes)
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score
    from elasticsearch_tpu_torch.search import (
        ShardContext, execute_query_phase, parse_search_body, sort_docs)
    from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    card = card_line() if on_card else f"{device} (a rehearsal: no card)"
    rng = np.random.default_rng(seed)
    total_days = n_days + n_cycles
    texts, offsets, _inv = node_corpus(total_days * day_docs, vocab, seed)
    user_p = 1.0 / np.arange(1, LIFE_USERS + 1) ** LIFE_USER_ZIPF
    user_p /= user_p.sum()
    levels = [lv for lv, _p in LIFE_LEVELS]
    level_p = np.array([p for _lv, p in LIFE_LEVELS])
    ranked = np.argsort(-np.diff(offsets), kind="stable")

    def bool_body():
        row = rng.choice(ranked[RANKS[0]: RANKS[1]], TERMS_PER_QUERY)
        return {"query": {"bool": {"should": [{"term": {"message": term_name(int(t))}}
                                              for t in row]}}, "size": NODE_SIZE}

    def match_body():
        row = rng.choice(ranked[RANKS[0] // 10: RANKS[1] // 10], 2)
        return {"query": {"match": {"message": " ".join(term_name(int(t))
                                                        for t in row)}},
                "size": NODE_SIZE}

    def events(d: int) -> list:
        users = rng.choice(LIFE_USERS, day_docs, p=user_p)
        lv = rng.choice(len(levels), day_docs, p=level_p)
        return [{"message": texts[d * day_docs + i], "user_id": f"u{int(users[i])}",
                 "level": levels[int(lv[i])],
                 "date": f"2014-01-{d + 1:02d}T{i * 86399 // day_docs // 3600:02d}:00:00"}
                for i in range(day_docs)]

    data_path = Path(__file__).resolve().parent / "build" / f"chip_smoke_life_{os.getpid()}"
    shutil.rmtree(data_path, ignore_errors=True)
    # the guide's hot-warm layout on one node: the node is the `cold` box
    # too, so a retired day (`include.box_type: cold`) stays allocated here
    # under the allocator's filter decider
    node = Node(name="lifecycle", registry=LocalTransportRegistry(),
                data_path=str(data_path), settings={"node.device": str(device),
                                                    "node.attr.box_type": "cold"}).start()
    recorder = None
    launches: dict = {}
    steps: dict = {}
    walls = {k: [] for k in ("create", "alias_swap", "settings", "close", "open",
                             "delete")}

    def take() -> dict:
        snap = cudaenv.LAUNCHES.snapshot()
        cudaenv.LAUNCHES.reset()
        for name, n in snap.items():
            launches[name] = launches.get(name, 0) + n
        return snap

    def wait_drained(timeout: float = 120.0):
        deadline = time.perf_counter() + timeout
        while True:
            st = node.warmer.stats()
            if st["packs_done"] >= st["packs_scheduled"] and \
                    node.search_batcher.stats()["queue"] == 0:
                return
            assert time.perf_counter() < deadline, f"not drained: {st}"
            time.sleep(0.01)

    def allocated() -> int:
        """The card's allocated bytes once the warmer and the batcher are
        drained and the collector ran, less the recorder's input copies."""
        wait_drained()
        gc.collect()
        if not on_card:
            return 0
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated() - recorder.held_bytes

    def resident(index: str) -> int:
        """The bytes the port counts resident for an index: its segments'
        packed planes (`packed_resident_bytes`) and filter masks."""
        svc = node.indices.indices.get(index)
        out = 0
        for shard in (svc.shards.values() if svc else ()):
            for seg in shard.engine.acquire_searcher().segments:
                packed = seg._device_cache.get(pack_cache_key(device))
                if packed is not None:
                    out += packed_resident_bytes(packed)
                out += sum(h.bytes for h in list(seg._device_cache.values())
                           if isinstance(h, _SegmentFilterMasks))
        return out

    def timed(kind: str, conn, method: str, path: str, body=None):
        t0 = time.perf_counter()
        st, r = http_json(conn, method, path, body)
        walls[kind].append((time.perf_counter() - t0) * 1e3)
        assert st == 200 and r.get("acknowledged"), (kind, path, st, r)
        return r

    def check(expr: str, bodies: list, got: list, alias_filter=None) -> int:
        """Each response against the shards' host query phases over the
        indices `expr` resolves to (a filtered alias's filter wrapped in as
        its shards wrap it): tie-tolerant within 2 ulp. Returns the hits."""
        names = node.cluster_service.state.metadata.resolve_indices(expr)
        searchers, ctxs = [], []
        for name in names:
            svc = node.indices.index_service(name)
            sr = svc.shard(0).engine.acquire_searcher()
            searchers.append(sr)
            ctxs.append(ShardContext(sr, svc.mapper_service, svc.similarity_service,
                                     device=device))
        seen = 0
        for body, (st, r) in zip(bodies, got):
            assert st == 200 and r["_shards"]["failed"] == 0 and \
                r["_shards"]["degraded"] == 0, (expr, st, r)
            if alias_filter is not None:
                body = {**body, "query": {"filtered": {"query": body["query"],
                                                       "filter": alias_filter}}}
            req = parse_search_body(body)
            merged = sort_docs(req, [execute_query_phase(c, req, use_device=False,
                                                         shard_id=o)
                                     for o, c in enumerate(ctxs)])
            assert r["hits"]["total"] == merged.total, (expr, r["hits"]["total"],
                                                        merged.total)
            want = []
            for score, o, doc, sv in merged.hits[: req.size]:
                seg, local = searchers[o].resolve(doc)
                want.append((score, (names[o], seg.ids[local]), sv))
            have = [(h["_score"], (h["_index"], h["_id"]), None)
                    for h in r["hits"]["hits"]]
            assert shard_docs_match(have, want, False), (expr, have, want)
            seen += len(have)
        return seen

    def leg(path: str, bodies: list) -> dict:
        got, lat, wall = http_requests(port, [("POST", path, b, None) for b in bodies],
                                       n_conn)
        return dict(got=got, requests=len(bodies), searches_per_s=len(bodies) / wall,
                    p50_ms=float(np.percentile(lat, 50)),
                    p99_ms=float(np.percentile(lat, 99)), wall_s=wall)

    def stats_of(lg: dict) -> dict:
        return {k: v for k, v in lg.items() if k != "got"}

    try:
        port = node.start_http(0).port
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

        # -- the template, the days, the write alias, the warmers -------------
        t0 = time.perf_counter()
        st, r = http_json(conn, "PUT", "/_template/logs", {
            "template": "logs-*", "order": 0,
            "settings": {"number_of_shards": 1, "number_of_replicas": 0,
                         "refresh_interval": -1},
            "mappings": {"event": {"properties": {
                "message": {"type": "string"},
                "user_id": {"type": "string", "index": "not_analyzed"},
                "level": {"type": "string", "index": "not_analyzed"},
                "date": {"type": "date"}}}},
            "aliases": {"last_7_days": {}}})
        assert st == 200 and r == {"acknowledged": True}, r
        day_events = {}
        # a day's warmer: a `bool` of denser terms (df ranks 50-500), so each
        # day holds some of them and its warmer launches
        warmer_bodies = [{"query": {"bool": {"should": [
            {"term": {"message": term_name(int(t))}}
            for t in rng.choice(ranked[RANKS[0]: RANKS[1] // 10], TERMS_PER_QUERY)]}},
            "size": NODE_SIZE} for _ in range(total_days)]
        bulk_s = 0.0
        for d in range(n_days):
            day = day_name(d)
            timed("create", conn, "PUT", f"/{day}")
            actions = [{"add": {"index": day, "alias": "logs_current"}}]
            if d:
                actions.insert(0, {"remove": {"index": day_name(d - 1),
                                              "alias": "logs_current"}})
            timed("alias_swap", conn, "POST", "/_aliases", {"actions": actions})
            st, r = http_json(conn, "PUT", f"/{day}/_warmer/day_warmer",
                              warmer_bodies[d])
            assert st == 200, r
            day_events[day] = events(d)
            tb = time.perf_counter()
            docs = day_events[day]
            for lo in range(0, len(docs) - 1, NODE_BULK):
                lines = []
                for i in range(lo, min(lo + NODE_BULK, len(docs) - 1)):
                    lines += [json.dumps({"index": {"_index": day, "_type": "event",
                                                    "_id": str(i)}}),
                              json.dumps(docs[i])]
                st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
                assert st == 200 and not r["errors"], r.get("items", [])[:2]
            # the day's last event through the write alias
            st, r = http_json(conn, "PUT", f"/logs_current/event/{len(docs) - 1}",
                              docs[-1])
            assert st == 201 and r["_index"] == day, r
            bulk_s += time.perf_counter() - tb
        st, r = http_json(conn, "GET", "/_alias/logs_current")
        assert list(r) == [day_name(n_days - 1)], r
        users = [f"u{u}" for u in range(LIFE_USERS)]
        st, r = http_json(conn, "POST", "/_aliases", {"actions": [
            {"add": {"index": "logs-*", "alias": f"user_{u}",
                     "filter": {"term": {"user_id": u}}, "routing": u}} for u in users]})
        assert st == 200, r
        steps["create_fill"] = time.perf_counter() - t0

        # the phase counts from here; the first refresh runs each day's
        # warmer on its new view (through the batcher: the day's first
        # search, which packs it inline)
        recorder = LaunchRecorder(scoring, sparse_score, copy_inputs=True)
        cudaenv.LAUNCHES.reset()
        t0 = time.perf_counter()
        st, r = http_json(conn, "POST", "/_refresh")
        refresh_ms = (time.perf_counter() - t0) * 1e3
        assert st == 200 and r["_shards"]["failed"] == 0, r
        warm_launches = take().get("sparse_score", 0)
        if on_card:
            assert warm_launches >= n_days, ("warmers launched nothing", warm_launches)
        wait_drained()
        counts = {}
        for d in range(n_days):
            st, r = http_json(conn, "GET", f"/{day_name(d)}/_count")
            assert r["count"] == day_docs, (d, r)
            counts[day_name(d)] = r["count"]

        # -- searches through the aliases, against the concrete indexes ------
        t0 = time.perf_counter()
        concrete = ",".join(day_name(d) for d in range(n_days))
        alias_users = [users[int(u)] for u in
                       np.argsort(-user_p, kind="stable")[:LIFE_ALIAS_USERS]]
        b7 = [bool_body() for _ in range(n_requests)]
        bu = [match_body() for _ in range(n_requests)]
        # warm every day's filter masks' first sighting and every shape's
        # first launch outside the clocks
        leg("/last_7_days/_search", b7[:n_conn])
        for u in alias_users:
            leg(f"/user_{u}/_search", bu[:2])
        legs = {"last_7_days": leg("/last_7_days/_search", b7),
                "concrete": leg(f"/{concrete}/_search", b7)}
        per_user = [(u, bu[i::LIFE_ALIAS_USERS]) for i, u in enumerate(alias_users)]
        got_alias, lat_alias, t_alias = [], [], time.perf_counter()
        for u, bodies in per_user:
            lg = leg(f"/user_{u}/_search", bodies)
            got_alias.append((u, bodies, lg["got"]))
        alias_wall = time.perf_counter() - t_alias
        filtered = [{**b, "query": {"filtered": {"query": b["query"], "filter": {
            "term": {"user_id": u}}}}} for u, bodies in per_user for b in bodies]
        legs["user_aliases"] = dict(requests=len(filtered),
                                    searches_per_s=len(filtered) / alias_wall,
                                    wall_s=alias_wall)
        legs["concrete_filtered"] = leg(f"/{concrete}/_search", filtered)
        assert [r["hits"] for _s, r in legs["last_7_days"]["got"]] == \
            [r["hits"] for _s, r in legs["concrete"]["got"]]
        i = 0
        for u, bodies, got in got_alias:
            for (_st, r), (_st2, r2) in zip(got, legs["concrete_filtered"]["got"][
                    i: i + len(bodies)]):
                assert r["hits"] == r2["hits"], u
            i += len(bodies)
        search_launches = take()
        hits_checked = check("last_7_days", b7[: n_checks // 2], legs["last_7_days"]["got"])
        for u, bodies, got in got_alias:
            hits_checked += check(f"user_{u}",
                                  bodies[: max(1, n_checks // 2 // len(per_user))],
                                  got, alias_filter={"term": {"user_id": u}})
        assert hits_checked > 0
        profiled = None
        if on_card:
            from torch.profiler import ProfilerActivity, profile

            pbodies = [(f"/user_{alias_users[i % len(alias_users)]}/_search", b)
                       for i, b in enumerate(bu[:LIFE_PROFILED])] + \
                [("/last_7_days/_search", b) for b in b7[:LIFE_PROFILED]]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _g, pwall = http_burst(port, pbodies, n_conn)
            profiled = device_busy(prof, pwall * 1e3)
        take()
        steps["search"] = time.perf_counter() - t0

        # -- retire: settings, close two, open one, delete the oldest ---------
        t0 = time.perf_counter()
        old = [day_name(0), day_name(1)]
        for day in old:
            timed("settings", conn, "PUT", f"/{day}/_settings", {"settings": {
                "index.routing.allocation.include.box_type": "cold",
                "index.blocks.write": True}})
        st, r = http_json(conn, "PUT", f"/{old[0]}/event/x", {"message": "late"})
        assert st == 403, r  # the write block of a retired day
        keep_bodies = b7[:8]
        before_close = [http_json(conn, "POST", f"/{old[1]}/_search", b)[1]["hits"]
                        for b in keep_bodies]
        released = {}
        for day in old:
            res = resident(day)
            a0 = allocated()
            timed("close", conn, "POST", f"/{day}/_close")
            a1 = allocated()
            released[f"close {day}"] = dict(resident=res, released=a0 - a1)
        st, r = http_json(conn, "POST", "/logs-*/_search", b7[0])
        assert st == 403 and r["error"]["type"] == "ClusterBlockException", r
        st, r = http_json(conn, "POST", "/last_7_days/_search", b7[0])
        assert st == 403, r
        for method, path, body in (("GET", f"/{old[0]}/_count", None),
                                   ("PUT", f"/{old[1]}/event/x", {"message": "x"}),
                                   ("GET", f"/{old[1]}/event/1", None)):
            st, r = http_json(conn, method, path, body)
            assert st == 403, (path, r)
        timed("open", conn, "POST", f"/{old[1]}/_open")
        st, r = http_json(conn, "GET", f"/_cluster/health?wait_for_status=green")
        assert st == 200 and r["status"] == "green", r
        st, r = http_json(conn, "GET", f"/{old[1]}/_count")
        assert r["count"] == counts[old[1]], r
        after_open = [http_json(conn, "POST", f"/{old[1]}/_search", b)[1]["hits"]
                      for b in keep_bodies]
        assert after_open == before_close
        res = resident(old[0])  # closed: nothing resident
        a0 = allocated()
        timed("delete", conn, "DELETE", f"/{old[0]}")
        a1 = allocated()
        released[f"delete {old[0]}"] = dict(resident=res, released=a0 - a1)
        # a resident day's delete: the open day 1, searched first
        for b in keep_bodies:
            http_json(conn, "POST", f"/{old[1]}/_search", b)
        res = resident(old[1])
        a0 = allocated()
        timed("delete", conn, "DELETE", f"/{old[1]}")
        a1 = allocated()
        released[f"delete {old[1]}"] = dict(resident=res, released=a0 - a1)
        if on_card:
            for what, v in released.items():
                if what.startswith("close") or v["resident"]:
                    assert v["released"] >= LIFE_RELEASED_SHARE * v["resident"], (what, v)
        st, r = http_json(conn, "POST", "/last_7_days/_search", b7[0])
        assert st == 200 and r["_shards"]["total"] == n_days - 2, r
        take()
        steps["retire"] = time.perf_counter() - t0

        # -- cycles: create, fill, search and delete one more day -------------
        t0 = time.perf_counter()
        cycles = []
        for c in range(n_cycles):
            d = n_days + c
            day = day_name(d)
            timed("create", conn, "PUT", f"/{day}")
            docs = events(d)
            lines = []
            for i, src in enumerate(docs):
                lines += [json.dumps({"index": {"_index": day, "_type": "event",
                                                "_id": str(i)}}), json.dumps(src)]
            st, r = http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
            assert st == 200 and not r["errors"], r.get("items", [])[:2]
            st, r = http_json(conn, "POST", f"/{day}/_refresh")
            assert st == 200, r
            fbody = [{**b, "query": {"filtered": {"query": b["query"], "filter": {
                "term": {"user_id": alias_users[0]}}}}} for b in bu[:8]]
            got = leg(f"/{day}/_search", b7[:16] + fbody + fbody)["got"]
            assert all(st == 200 for st, _r in got), got[:2]
            res = resident(day)
            timed("delete", conn, "DELETE", f"/{day}")
            cycles.append(dict(day=day, resident=res, allocated=allocated()))
        if on_card:
            base = cycles[0]["allocated"]
            for cy in cycles[1:]:
                assert abs(cy["allocated"] - base) <= LIFE_GROWTH_SHARE * cycles[0]["resident"], \
                    cycles
        take()
        steps["cycles"] = time.perf_counter() - t0

        # -- the caches clear ------------------------------------------------
        t0 = time.perf_counter()
        fb = [(f"/user_{u}/_search", b) for u, bodies, _g in got_alias for b in bodies[:2]]
        first, _w = http_burst(port, fb, n_conn)
        before_clear = dict(filter=node.filter_cache.stats()["memory_size_in_bytes"],
                            request=node.request_cache.stats()["memory_size_in_bytes"])
        st, r = http_json(conn, "POST", "/_cache/clear?filter=true&request=true")
        assert st == 200 and r["_shards"]["failed"] == 0, r
        wait_drained()
        assert node.filter_cache.stats()["memory_size_in_bytes"] == 0
        assert node.request_cache.stats()["memory_size_in_bytes"] == 0
        assert not node.request_cache._entries
        assert node.breakers.breaker("fielddata").used == 0
        assert node.breakers.breaker("request").used == 0
        again, _w = http_burst(port, fb, n_conn)
        assert [r["hits"] for _s, r in again] == [r["hits"] for _s, r in first]
        take()
        steps["cache_clear"] = time.perf_counter() - t0

        # -- one call of each remaining route --------------------------------
        t0 = time.perf_counter()
        day = day_name(n_days - 1)

        def status(method, path, body=None) -> int:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            try:
                c.request(method, path, body=None if body is None else json.dumps(body),
                          headers={"Content-Type": "application/json"})
                resp = c.getresponse()
                resp.read()
                return resp.status
            finally:
                c.close()

        rest = {
            "validate": http_json(conn, "POST", f"/{day}/_validate/query",
                                  {"query": {"match": {"message": "t1"}}}),
            "analyze": http_json(conn, "GET", f"/{day}/_analyze?field=user_id&text=u7"),
            "field_mapping": http_json(conn, "GET", f"/{day}/_mapping/field/user_id"),
            "gateway_snapshot": http_json(conn, "POST", "/_gateway/snapshot"),
            "settings": http_json(conn, "GET", f"/{day}/_settings"),
            "aliases": http_json(conn, "GET", f"/{day}/_aliases"),
            "templates": http_json(conn, "GET", "/_template/logs"),
            "warmers": http_json(conn, "GET", f"/{day}/_warmer"),
        }
        assert rest["validate"][1]["valid"] is True and \
            rest["validate"][1]["_shards"]["total"] == 1, rest["validate"]
        assert [t["token"] for t in rest["analyze"][1]["tokens"]] == ["u7"]
        assert rest["field_mapping"][1][day]["mappings"]["event"]["user_id"][
            "mapping"]["user_id"]["index"] == "not_analyzed"
        assert rest["gateway_snapshot"][1]["_shards"]["total"] == 0
        assert rest["settings"][1][day]["settings"]["index"]["number_of_shards"] == "1"
        assert {"last_7_days", "logs_current", f"user_{users[0]}"} <= \
            set(rest["aliases"][1][day]["aliases"])
        assert rest["templates"][1]["logs"]["template"] == "logs-*"
        assert "day_warmer" in rest["warmers"][1][day]["warmers"]
        assert all(st == 200 for st, _r in rest.values()), \
            {k: st for k, (st, _r) in rest.items()}
        heads = {"index": status("HEAD", f"/{day}"), "type": status("HEAD", f"/{day}/event"),
                 "alias": status("HEAD", f"/{day}/_alias/logs_current"),
                 "missing index": status("HEAD", f"/{day_name(0)}")}
        assert heads == {"index": 200, "type": 200, "alias": 200, "missing index": 404}, heads
        steps["rest"] = time.perf_counter() - t0
        conn.close()
        take()
        recorder.close()

        # -- the kernel at phase 23's shapes ---------------------------------
        t0 = time.perf_counter()
        recorded = sum(n for _args, _kwargs, n in recorder.shapes.values())
        if on_card:  # every counted launch is one the shapes' checks hold
            assert launches.get("sparse_score", 0) == recorded, (launches, recorded)
        max_err = check_shapes(recorder.shapes)
        shapes = [dict(Qb=int(args[0].shape[0]), TB=int(args[0].shape[1]),
                       tf=str(args[10].dtype), k=kwargs["k"], launches=n)
                  for _key, (args, kwargs, n) in recorder.shapes.items()]
        steps["kernel_checks"] = time.perf_counter() - t0

        def p50_max(v):
            return dict(p50_ms=float(np.percentile(v, 50)), max_ms=float(max(v)), n=len(v))

        out = dict(days=n_days, day_docs=day_docs, cycles=cycles, card=card,
                   bulk_s=bulk_s, walls={k: p50_max(v) for k, v in walls.items() if v},
                   legs={k: stats_of(v) for k, v in legs.items()},
                   refresh=dict(ms=refresh_ms, warmer_launches=warm_launches,
                                warmers=n_days),
                   released=released, profiled=profiled, hits_checked=hits_checked,
                   search_launches=search_launches, cache_before_clear=before_clear,
                   heads=heads, launches=launches, kernel_shapes=shapes,
                   kernel_max_abs_err=max_err)
        log(f"[23] `logs-*` on {device}: {n_days} days of {day_docs} events by the "
            f"template (bulk {bulk_s:.1f} s, {n_days * day_docs / bulk_s:.1f} docs/s), "
            f"a warmer a day, `logs_current` moved each day, {LIFE_USERS} `user_<n>` "
            f"filtered aliases; {card}")
        for k, v in out["walls"].items():
            log(f"[23] {k:10s} wall p50 {v['p50_ms']:.2f} ms, max {v['max_ms']:.2f} ms "
                f"({v['n']} calls)")
        for k, v in out["legs"].items():
            log(f"[23] {k:17s} {v['requests']:4d} searches from {n_conn} connections: "
                f"{v['searches_per_s']:.1f} searches/s"
                + (f", p50 {v['p50_ms']:.2f} ms, p99 {v['p99_ms']:.2f} ms"
                   if "p50_ms" in v else "") + f"; {card}")
        log(f"[23] the refresh running the {n_days} warmers: {refresh_ms:.1f} ms, "
            f"{warm_launches} sparse_score launches ({warm_launches / n_days:.1f} a warmer)")
        for what, v in released.items():
            log(f"[23] {what}: {v['resident']} B resident, memory_allocated() fell "
                f"{v['released']} B" + (f" ({v['released'] / v['resident']:.3f} of it)"
                                       if v["resident"] else ""))
        log(f"[23] {n_cycles} cycles of create, fill, search, delete: allocated after each "
            f"{[c['allocated'] for c in cycles]} B, a day resident "
            f"{[c['resident'] for c in cycles]} B")
        log(f"[23] _cache/clear: filter masks {before_clear['filter']} B and request cache "
            f"{before_clear['request']} B -> 0; the breakers at 0; the filtered searches "
            f"answer as before")
        if profiled and profiled["device_busy_ms"]:
            log(f"[23] profiled window of {2 * LIFE_PROFILED} searches: wall "
                f"{profiled['wall_ms']:.2f} ms, device busy {profiled['device_busy_ms']:.3f} "
                f"ms, idle share {profiled['idle_share']:.4f}; {card}")
        elif on_card:
            log("[23] profiled window: the profiler saw no device time "
                "(device idle share not measured)")
        log(f"[23] checks: {hits_checked} hits == the shards' host query phases (within "
            f"{ULPS} ulp, tie-tolerant); a closed day refuses reads and writes (403), "
            f"`_open` restores its count and hits; HEAD {heads}")
        for sh in shapes:
            log(f"[23]   sparse_score Qb {sh['Qb']} TB {sh['TB']} {sh['tf']} k {sh['k']}: "
                f"{sh['launches']} launches")
        log(f"[23] sparse_score == plain (bitwise) at all {len(shapes)} shapes phase 23 "
            f"launched ({launches.get('sparse_score', 0)} launches in the phase, "
            f"{recorded} of them recorded at those shapes); max abs err {max_err}")
        out["wall_phase_s"] = time.perf_counter() - t_phase
        out["steps_s"] = steps
        log(f"[23] phase 23 took {out['wall_phase_s']:.1f} s; by step (s): "
            + ", ".join(f"{k} {v:.1f}" for k, v in steps.items()))
        return out
    finally:
        if recorder is not None:
            recorder.close()
        node.close()
        shutil.rmtree(data_path, ignore_errors=True)


def two_node_inputs(vocab: int, seed: int, n_docs: int, n_requests: int,
                    corpus_docs: int):
    """Phase 26's documents and bodies: phase 10's corpus of `corpus_docs`
    (the same draws) and its `bool` bodies, the first `n_docs` texts and
    `n_requests` bodies."""
    texts, offsets, _inv = node_corpus(corpus_docs, vocab, seed)
    ranked = np.argsort(-np.diff(offsets), kind="stable")
    rng = np.random.default_rng(seed + 1)
    rows = rng.choice(ranked[RANKS[0]: RANKS[1]], size=(n_requests, TERMS_PER_QUERY))
    return texts[:n_docs], [
        {"query": {"bool": {"should": [{"term": {"body": term_name(int(t))}}
                                       for t in row]}}, "size": NODE_SIZE}
        for row in rows]


def two_node_fill(client, texts: list, index: str = "corpus") -> None:
    """`index` (5 shards, 0 replicas, no refresh interval) created through
    `client`, the texts bulked under their ordinals as ids, a refresh."""
    r = client.create_index(index, {"settings": {
        "number_of_shards": NODE_SHARDS, "number_of_replicas": 0,
        "refresh_interval": -1}})
    assert r["acknowledged"], r
    h = client.cluster_health(index, wait_for_status="green", timeout=60)
    assert h["status"] == "green", h
    for lo in range(0, len(texts), NODE_BULK):
        r = client.bulk([{"action": {"index": {"_index": index, "_type": "doc",
                                               "_id": str(i)}},
                          "source": {"body": texts[i]}}
                         for i in range(lo, min(lo + NODE_BULK, len(texts)))])
        assert not r["errors"], r["items"][:2]
    r = client.refresh(index)
    assert r["_shards"]["failed"] == 0, r


def two_node_ref_child(path: str) -> None:
    """Phase 26's one-node reference, in a child process so its bulk runs
    beside the cluster's instead of after it under one interpreter lock: a
    `cuda` node on its own in-process transport takes the same texts
    (`two_node_fill`), warms its shards, serves HTTP, writes `{"port":
    ...}` to the input's `out` once it serves, and serves until its
    standard input closes (the parent closes it, or dies)."""
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry

    inp = json.loads(Path(path).read_text())
    t0 = time.perf_counter()
    texts, bodies = two_node_inputs(inp["vocab"], inp["seed"], inp["docs"],
                                    inp["warm"], inp["corpus_docs"])
    node = Node(name="n26ref", registry=LocalTransportRegistry(),
                settings={"node.device": inp["device"]},
                data_path=str(Path(inp["work"]) / "ref")).start()
    try:
        two_node_fill(node.client(), texts)
        port = node.start_http(0).port
        warm, _lat, _w = http_requests(port, [("POST", "/corpus/_search", b, None)
                                              for b in bodies], len(bodies))
        assert all(st == 200 for st, _r in warm)
        tmp = Path(inp["out"] + ".tmp")
        tmp.write_text(json.dumps({"port": port, "ready_s": time.perf_counter() - t0}))
        tmp.rename(inp["out"])
        sys.stdin.read()
    finally:
        node.close()


class NodePair:
    """Two port Nodes on `device` in this process forming one cluster over
    the TCP transport (127.0.0.1, port 0; the second seeded with the
    first's address; `settings` added to both), for phases 26-28, and what they read of each
    node: its resident bytes, whether its warmer and batcher are drained,
    and, inside `counting()`, its `sparse_score` launches and
    `PendingPull.wait` calls, told apart by the batcher's drainer thread
    (`estpu_torch[search_batcher][<node>]`), beside the process's
    `torch.cuda.synchronize` calls. `close()` closes the nodes, the second
    first."""

    def __init__(self, device, names: tuple, root: Path, phase: int,
                 settings: dict | None = None):
        self.device, self.names, self.root, self.phase = device, names, root, phase
        self.settings = settings or {}
        self.on_card = device.type == "cuda"
        self.nodes: list = []
        self.by_node = {n: dict(launches=0, waits=0, unlaunched=0)
                        for n in (*names, "other")}
        self.syncs = 0
        self.lock = threading.Lock()
        # set while a `counting()` block runs work it must not count
        self.paused = False
        # inside `counting()`, the real `torch.cuda.synchronize`
        self.uncounted_sync = None

    def start(self) -> tuple:
        """Boot both nodes and wait for one master; on the card each node
        ran its own kernel start check on the shared build."""
        from elasticsearch_tpu_torch.node import Node

        conf = {"node.device": str(self.device), "transport.type": "tcp",
                "transport.tcp.host": "127.0.0.1", "transport.tcp.port": 0,
                **self.settings}
        a = Node(name=self.names[0], settings=dict(conf), data_path=str(self.root / "a"))
        self.nodes.append(a)
        a.start(seeds=[])
        b = Node(name=self.names[1], settings={
            **conf, "discovery.zen.ping.unicast.hosts": [a.local_node.transport_address]},
            data_path=str(self.root / "b"))
        self.nodes.append(b)
        b.start()
        self.wait_for(lambda: all(n.cluster_service.state.nodes.size == 2 and
                                  n.cluster_service.state.nodes.master_id == self.names[0]
                                  for n in (a, b)), "two nodes under one master")
        if self.on_card:
            for n in (a, b):
                assert n.kernel_checks.get("sparse_score"), (n.name, n.kernel_checks)
        return a, b

    def wait_for(self, pred, what: str, timeout: float = 60.0) -> None:
        deadline = time.perf_counter() + timeout
        while not pred():
            assert time.perf_counter() < deadline, f"phase {self.phase}: {what} not reached"
            time.sleep(0.02)

    def owner(self) -> str:
        t = threading.current_thread().name
        return next((n for n in self.names if f"[{n}]" in t), "other")

    def resident(self, node) -> int:
        """The bytes the port counts resident for a node's shards: packed
        planes (`packed_resident_bytes`) and filter masks."""
        from elasticsearch_tpu_torch.ops.device_index import (
            _SegmentFilterMasks, pack_cache_key, packed_resident_bytes)

        out = 0
        for svc in list(node.indices.indices.values()):
            for shard in list(svc.shards.values()):
                for seg in shard.engine.acquire_searcher().segments:
                    packed = seg._device_cache.get(pack_cache_key(self.device))
                    if packed is not None:
                        out += packed_resident_bytes(packed)
                    out += sum(h.bytes for h in list(seg._device_cache.values())
                               if isinstance(h, _SegmentFilterMasks))
        return out

    def allocated(self, held_bytes: int) -> int:
        """`memory_allocated()` less the bytes a recorder holds (0 off the
        card), after a synchronize of its own that `counting()` does not
        count."""
        import torch

        gc.collect()
        if not self.on_card:
            return 0
        (self.uncounted_sync or torch.cuda.synchronize)()
        return torch.cuda.memory_allocated() - held_bytes

    @staticmethod
    def drained(node) -> bool:
        st = node.warmer.stats()
        return st["packs_done"] >= st["packs_scheduled"] and \
            node.search_batcher.stats()["queue"] == 0

    def snapshot(self) -> dict:
        with self.lock:
            return {k: dict(v) for k, v in self.by_node.items()}

    @contextmanager
    def counting(self):
        """Count, until the block ends, each node's `sparse_score` launches
        (through the scoring module's current `sparse_score`),
        `PendingPull.wait` calls and the batches its drainer dispatched that
        launched no `sparse_score` (`unlaunched`: every query of the batch
        found no block of its terms in the shard, so it scores nothing), and
        every `torch.cuda.synchronize`; none while `paused` is set."""
        import torch

        from elasticsearch_tpu_torch.common import cudaenv
        from elasticsearch_tpu_torch.ops import scoring
        from elasticsearch_tpu_torch.search import batcher

        inner, orig_wait, orig_sync = (scoring.sparse_score, cudaenv.PendingPull.wait,
                                       torch.cuda.synchronize)
        orig_dispatch = batcher._FlatFamily.dispatch

        def counted_dispatch(items, kb):
            owner = self.owner()
            with self.lock:
                before = self.by_node[owner]["launches"]
            handle = orig_dispatch(items, kb)
            with self.lock:
                if not self.paused and self.by_node[owner]["launches"] == before:
                    self.by_node[owner]["unlaunched"] += 1
            return handle

        def attributed(*args, **kwargs):
            with self.lock:
                if not self.paused:
                    self.by_node[self.owner()]["launches"] += 1
            return inner(*args, **kwargs)

        def counted_wait(pull):
            with self.lock:
                if not self.paused:
                    self.by_node[self.owner()]["waits"] += 1
            return orig_wait(pull)

        def counted_sync(*a, **k):
            with self.lock:
                if not self.paused:
                    self.syncs += 1
            return orig_sync(*a, **k)

        scoring.sparse_score = attributed
        cudaenv.PendingPull.wait = counted_wait
        torch.cuda.synchronize = counted_sync
        batcher._FlatFamily.dispatch = staticmethod(counted_dispatch)
        self.uncounted_sync = orig_sync
        try:
            yield self
        finally:
            self.uncounted_sync = None
            batcher._FlatFamily.dispatch = staticmethod(orig_dispatch)
            torch.cuda.synchronize = orig_sync
            cudaenv.PendingPull.wait = orig_wait
            scoring.sparse_score = inner

    def close(self) -> None:
        for n in reversed(self.nodes):
            n.close()


def two_node_phase(device, *, vocab: int, seed: int, n_docs: int = TWO_DOCS,
                   n_requests: int = TWO_REQUESTS, n_conn: int = TWO_CONN,
                   n_after: int = TWO_AFTER) -> dict:
    """Phase 26: two port Nodes on `device` in this process form one cluster
    over the TCP transport (127.0.0.1, port 0, the second seeded with the
    first's address), beside a one-node reference on its own in-process
    transport in a child process (`--two-node-ref-child`: its bulk runs
    beside the cluster's). The cluster's index (5 shards, 0 replicas: a small cluster
    spreading an index's primaries over its data nodes) and the
    reference's (the same shard count) take the same `n_docs` of phase
    10's texts under the same ids. Then `n_requests` of phase 10's `bool`
    bodies, half to each node's HTTP from `n_conn` connections, each hits
    JSON bitwise the reference's; each node launches `sparse_score` from
    its own batcher with one `PendingPull.wait` a batch and no
    `torch.cuda.synchronize`; `_cluster/stats`, `/_nodes` and `_cat/nodes`
    name both nodes. The second node closes: the master removes it and
    starts its primaries again, empty, on itself (the JAX master's
    behaviour at 0 replicas); `memory_allocated()` falls by the bytes the
    closed node's packs held; the first node answers the bodies over the
    shards it holds as the reference answers them restricted to those
    shards. The kernel bitwise against its plain version at every shape
    either node launched."""
    import http.client

    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score
    from elasticsearch_tpu_torch.search import SERVING_COUNTERS

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    card = card_line() if on_card else f"{device} (a rehearsal: no card)"
    root = Path(__file__).resolve().parent / "build" / f"chip_smoke_two_{os.getpid()}"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    # the reference starts first: its start and bulk run beside ours
    ref_out = root / "ref.json"
    (root / "ref_in.json").write_text(json.dumps({
        "vocab": vocab, "seed": seed, "docs": n_docs, "warm": TWO_WARM,
        "corpus_docs": max(n_docs, NODE_DOCS),
        "device": str(device), "work": str(root), "out": str(ref_out)}))
    ref_log = open(root / "ref.log", "w")
    child = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--two-node-ref-child",
         str(root / "ref_in.json")], cwd=Path(__file__).resolve().parent,
        stdin=subprocess.PIPE, stdout=subprocess.DEVNULL, stderr=ref_log, text=True)
    steps: dict = {}
    recorder = None
    names = ("n26a", "n26b")
    pair = NodePair(device, names, root, phase=26)
    wait_for, drained = pair.wait_for, pair.drained
    try:
        texts, bodies = two_node_inputs(vocab, seed, n_docs, n_requests,
                                        max(n_docs, NODE_DOCS))
        t0 = time.perf_counter()
        a, b = pair.start()
        steps["boot"] = time.perf_counter() - t0

        # -- the index: created through the node that is not master ----------
        t0 = time.perf_counter()
        two_node_fill(b.client(), texts)  # created through the node that is not master
        placed = {}
        for s in a.cluster_service.state.routing_table.index("corpus").all_shards():
            placed.setdefault(s.node_id, []).append(s.shard_id)
        assert sorted(map(len, placed.values())) == [2, 3], placed
        assert a.client().count("corpus")["count"] == n_docs
        steps["index_and_bulk"] = time.perf_counter() - t0

        # -- the surfaces that name both nodes --------------------------------
        ports = {n.name: n.start_http(0).port for n in (a, b)}
        conn = http.client.HTTPConnection("127.0.0.1", ports[names[1]], timeout=120)
        st, cs = http_json(conn, "GET", "/_cluster/stats")
        assert st == 200 and cs["nodes"]["count"]["total"] == 2, cs
        assert cs["indices"]["docs"]["count"] == n_docs, cs["indices"]
        st, ni = http_json(conn, "GET", "/_nodes")
        assert st == 200 and sorted(ni["nodes"]) == sorted(names), ni
        conn.close()
        cat = cat_text(ports[names[0]], "/_cat/nodes")
        assert sorted(line.split()[0] for line in cat.strip().splitlines()) == \
            sorted(names), cat

        # -- traffic: warm (each shard packs at its first search), wait for
        # the reference to serve (its bulk and warm-up then share neither
        # the card nor the host's cores with the timed run), then the
        # cluster's run half to each node ---------------------------------------
        t0 = time.perf_counter()
        for port in ports.values():
            warm, _lat, _w = http_requests(
                port, [("POST", "/corpus/_search", body, None)
                       for body in bodies[:TWO_WARM]], TWO_WARM)
            assert all(s == 200 for s, _r in warm)
        for n in (a, b):
            wait_for(lambda n=n: drained(n), f"{n.name}'s warmer drained")
        steps["warm"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        wait_for(lambda: ref_out.exists() or child.poll() is not None,
                 "the reference child serving", timeout=TWO_REF_TIMEOUT_S)
        assert ref_out.exists(), (child.returncode,
                                  (root / "ref.log").read_text()[-4000:])
        ref_port = json.loads(ref_out.read_text())["port"]
        steps["reference_wait"] = time.perf_counter() - t0

        recorder = LaunchRecorder(scoring, sparse_score, copy_inputs=True)
        batches0 = {n.name: n.search_batcher.stats()["launches"] for n in (a, b)}
        errors0 = SERVING_COUNTERS["device_errors"]
        cudaenv.LAUNCHES.reset()
        results: dict = {}

        def leg(name, part):
            results[name] = http_requests(
                ports[name], [("POST", "/corpus/_search", body, None) for body in part],
                max(1, n_conn // 2))

        with pair.counting():
            t0 = time.perf_counter()
            legs = [threading.Thread(target=leg, args=(names[i], bodies[i::2]))
                    for i in range(2)]
            for t in legs:
                t.start()
            for t in legs:
                t.join()
            wall = time.perf_counter() - t0
            launches = cudaenv.LAUNCHES.snapshot()
        by_node, syncs = pair.snapshot(), pair.syncs
        batches = {n.name: n.search_batcher.stats()["launches"] - batches0[n.name]
                   for n in (a, b)}
        assert SERVING_COUNTERS["device_errors"] == errors0

        # -- the reference's answers ------------------------------------------
        t0 = time.perf_counter()
        want, _lat, _w = http_requests(
            ref_port, [("POST", "/corpus/_search", body, None) for body in bodies], n_conn)
        steps["reference"] = time.perf_counter() - t0
        lat = np.concatenate([results[n][1] for n in names])
        got = [None] * n_requests
        for i, name in enumerate(names):
            got[i::2] = results[name][0]
        for i, ((st, r), (wst, w)) in enumerate(zip(got, want)):
            assert st == wst == 200, (i, r)
            assert r["_shards"] == SHARDS_OK, (i, r["_shards"])
            assert r["hits"] == w["hits"], f"request {i}: hits differ from the one-node reference"
        for name in names:
            assert by_node[name]["waits"] == batches[name] > 0, (name, by_node, batches)
            if on_card:
                assert by_node[name]["launches"] > 0, (name, by_node)
        assert syncs == 0 and by_node["other"]["launches"] == 0, (syncs, by_node)
        if on_card:
            assert launches.get("sparse_score", 0) == \
                sum(by_node[n]["launches"] for n in names), (launches, by_node)
        steps["traffic"] = wall

        # -- the kernel at every shape either node launched --------------------
        t0 = time.perf_counter()
        max_err = check_shapes(recorder.shapes)
        shapes = [dict(Qb=int(args[0].shape[0]), TB=int(args[0].shape[1]),
                       tf=str(args[10].dtype), k=kwargs["k"], launches=n)
                  for _key, (args, kwargs, n) in recorder.shapes.items()]
        steps["kernel_checks"] = time.perf_counter() - t0

        # -- the second node leaves --------------------------------------------
        t0 = time.perf_counter()
        a_shards = sorted(placed[names[0]])
        b_shards = sorted(placed[names[1]])
        wait_for(lambda: drained(b), "the second node drained")
        b_resident = pair.resident(b)
        before = pair.allocated(recorder.held_bytes)
        b.close()
        wait_for(lambda: a.cluster_service.state.nodes.size == 1, "the node removed")
        wait_for(lambda: a.client().cluster_health("corpus", timeout=0)["status"] == "green",
                 "green on one node")
        after = pair.allocated(recorder.held_bytes)
        released = before - after
        rows_after = [(s.shard_id, s.node_id) for s in
                      a.cluster_service.state.routing_table.index("corpus").all_shards()]
        assert rows_after == [(sid, names[0]) for sid in range(NODE_SHARDS)], rows_after
        if on_card:
            assert 0.97 * b_resident <= released <= 1.03 * b_resident, \
                (b_resident, before, after)
        pref = "_shards:" + ",".join(map(str, a_shards))
        part = bodies[:n_after]
        got_after, _l, _w = http_requests(
            ports[names[0]], [("POST", "/corpus/_search", body, None) for body in part],
            n_conn)
        want_after, _l, _w = http_requests(
            ref_port, [("POST", f"/corpus/_search?preference={pref}", body, None)
                       for body in part], n_conn)
        for i, ((st, r), (wst, w)) in enumerate(zip(got_after, want_after)):
            assert st == wst == 200 and r["_shards"]["failed"] == 0, (i, r)
            assert r["hits"] == w["hits"], f"request {i} after the leave"
        steps["leave"] = time.perf_counter() - t0

        out = dict(card=card, docs=n_docs, requests=n_requests, conn=n_conn,
                   ref_ready_s=json.loads(ref_out.read_text())["ready_s"],
                   placed={k: sorted(v) for k, v in placed.items()},
                   requests_per_s=n_requests / wall, wall_s=wall,
                   p50_ms=float(np.percentile(lat, 50)),
                   p99_ms=float(np.percentile(lat, 99)),
                   by_node=by_node, batches=batches,
                   launches=launches, kernel_shapes=shapes, kernel_max_abs_err=max_err,
                   departed=dict(shards=b_shards, resident=b_resident, released=released,
                                 share=(released / b_resident) if b_resident else None),
                   steps_s=steps)
        log(f"[26] two nodes on {device} over TCP, master {names[0]}: {n_docs} docs into "
            f"{NODE_SHARDS} shards at 0 replicas placed {out['placed']}; a one-node "
            f"reference with the same bulk in a child (serving after "
            f"{out['ref_ready_s']:.1f} s); {card}")
        log(f"[26] {n_requests} `bool` bodies, half to each node, from {n_conn} "
            f"connections: {out['requests_per_s']:.1f} requests/s, p50 "
            f"{out['p50_ms']:.2f} ms, p99 {out['p99_ms']:.2f} ms; every hits JSON == the "
            f"reference's (bitwise); {card}")
        for name in names:
            log(f"[26]   {name}: {by_node[name]['launches']} sparse_score launches, "
                f"{batches[name]} batches, {by_node[name]['waits']} PendingPull.wait "
                f"calls; torch.cuda.synchronize calls {syncs}")
        log(f"[26] `_cluster/stats`, `/_nodes` and `_cat/nodes` name both nodes")
        log(f"[26] {names[1]} closed: shards {b_shards} started again, empty, on "
            f"{names[0]}; resident {b_resident} B, memory_allocated() fell {released} B"
            + (f" ({released / b_resident:.4f} of it)" if b_resident else "")
            + f"; {n_after} bodies on {names[0]} == the reference over shards {a_shards}")
        for sh in shapes:
            log(f"[26]   sparse_score Qb {sh['Qb']} TB {sh['TB']} {sh['tf']} k {sh['k']}: "
                f"{sh['launches']} launches")
        log(f"[26] sparse_score == plain (bitwise) at all {len(shapes)} shapes phase 26 "
            f"launched; max abs err {max_err}")
        out["wall_phase_s"] = time.perf_counter() - t_phase
        log(f"[26] phase 26 took {out['wall_phase_s']:.1f} s; by step (s): "
            + ", ".join(f"{k} {v:.1f}" for k, v in steps.items()))
        return out
    finally:
        if recorder is not None:
            recorder.close()
        pair.close()
        try:
            child.stdin.close()  # the reference serves until this closes
            child.wait(timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            child.kill()
            child.wait()
        ref_log.close()
        shutil.rmtree(root, ignore_errors=True)


def shard_copies(node, index: str) -> dict:
    """shard id -> {document id: version} of the node's copy of each shard
    of `index` (its current view)."""
    out = {}
    svc = node.indices.indices.get(index)
    for sid, shard in list(svc.shards.items()) if svc is not None else []:
        docs = {}
        for seg in shard.engine.acquire_searcher().segments:
            for local in np.flatnonzero(seg.live & seg.parent_mask):
                docs[str(seg.ids[local])] = int(seg.versions[local])
        out[sid] = docs
    return out


def same_scores_tie_tolerant(a: dict, b: dict) -> bool:
    """Two answers of one body over copies whose segment layouts differ:
    the same total and max score, the page's scores bitwise in order, and
    the same ids inside every group of equal scores but the page's last
    (whose ties may go on past the page)."""
    ha, hb = a["hits"], b["hits"]
    if ha["total"] != hb["total"] or ha["max_score"] != hb["max_score"]:
        return False
    sa = [h["_score"] for h in ha["hits"]]
    if sa != [h["_score"] for h in hb["hits"]]:
        return False
    last = sa[-1] if sa else None
    group = lambda hits: sorted((h["_score"], h["_id"]) for h in hits  # noqa: E731
                                if h["_score"] != last)
    return group(ha["hits"]) == group(hb["hits"])


def replica_packs_diff(nodes, index: str, device) -> tuple[dict, int]:
    """Each shard's segments on the node holding its primary against the
    node holding its replica, pack by pack: ({shard/gen: differing
    fields}, segments compared). Holds no pack past its return."""
    from elasticsearch_tpu_torch.ops.device_index import pack_cache_key

    diffs, compared = {}, 0
    for sid in sorted(nodes[0].indices.indices[index].shards):
        segs = {}
        for n in nodes:
            shard = n.indices.indices[index].shards[sid]
            segs[shard.primary] = shard.engine.acquire_searcher().segments
        assert len(segs[True]) == len(segs[False]), sid
        for sp, sr in zip(segs[True], segs[False]):
            pp = sp._device_cache.get(pack_cache_key(device))
            pr = sr._device_cache.get(pack_cache_key(device))
            assert pp is not None and pr is not None and pp is not pr, sid
            bad = packs_equal(pp, pr)
            if bad:
                diffs[f"{sid}/{sp.gen}"] = bad
            compared += 1
    return diffs, compared


def replica_phase(device, *, vocab: int, seed: int, n_docs: int = REP_DOCS,
                  n_live: int = REP_LIVE_DOCS, n_requests: int = REP_REQUESTS,
                  n_after: int = REP_AFTER, n_conn: int = REP_CONN,
                  n_loss: int = REP_LOSS) -> dict:
    """Phase 27: a replicated cluster on the card. Two port Nodes on
    `device` in this process over the TCP transport, as in phase 26. Two
    indexes of 5 shards at 0 replicas: `replicas` (`n_docs` of phase 10's
    texts, flushed) and `replicas_live` (`n_live` more, flushed). A leg of
    `n_requests` `bool` bodies on `replicas` (its primaries) is kept; then
    a writer thread indexes new ids into `replicas_live` one at a time
    through the first node's HTTP while `number_of_replicas` goes to 1 on
    both indexes, until the cluster is green (60 s at most). Checked: every
    replica's recovery (files, bytes, reused, throttle); after a refresh
    `_count` of `replicas_live` with `_only_node` of either node equals the
    acknowledged writes, and each shard's copies hold the same ids at the
    same versions; each `replicas` segment's pack on the replica equals
    the primary's plane for plane (`packs_equal`: the replica loaded the
    flushed commit); the `n_requests` bodies again, half with
    `_only_node:<a>` to a and half with `_only_node:<b>` to b (each node
    reading its mix of primaries and replicas), each hits JSON bitwise the
    kept leg's; `n_after` bodies on `replicas_live` to both nodes, each
    node's copies only, scores bitwise and hits tie-tolerant between the
    nodes (the replicas replayed translog ops, so their segment layouts
    differ); per node, `sparse_score` launches == batches ==
    `PendingPull.wait` calls, and no `torch.cuda.synchronize`. Then the
    second node is lost while `n_loss` bodies run against the first: every
    query phase the first node sends it fails (a disconnect injected on
    the first node's transport), so the shards the burst routed there fail
    over to the first node's copies (at least one, counted), and it
    closes; every answer `_shards.failed` 0 and bitwise the kept leg; the
    first node's promoted primaries answer `n_loss` bodies bitwise too;
    `_count` equals the acknowledged writes; `memory_allocated()` falls
    0.99-1.01 of the closed node's resident bytes. The kernel bitwise
    against its plain version at every shape either node launched."""
    import http.client

    from elasticsearch_tpu_torch.actions import A_QUERY_PHASE
    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score
    from elasticsearch_tpu_torch.search import SERVING_COUNTERS
    from elasticsearch_tpu_torch.transport.faults import FaultPolicy

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    card = card_line() if on_card else f"{device} (a rehearsal: no card)"
    root = Path(__file__).resolve().parent / "build" / f"chip_smoke_rep_{os.getpid()}"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    names = ("n27a", "n27b")
    steps: dict = {}
    recorder = None
    pair = NodePair(device, names, root, phase=27)
    wait_for, drained = pair.wait_for, pair.drained
    stop_writer = threading.Event()
    writer = None
    policy = None

    def done(step: str, t0: float):
        steps[step] = time.perf_counter() - t0
        log(f"[27] {step} {steps[step]:.1f} s")

    def health(node, index) -> str:
        return node.client().cluster_health(index, timeout=0)["status"]

    def searches(port, index, part, pref=None):
        path = f"/{index}/_search" + (f"?preference={pref}" if pref else "")
        return http_requests(port, [("POST", path, body, None) for body in part],
                             max(1, min(n_conn, len(part))))

    try:
        texts, bodies = two_node_inputs(vocab, seed, max(n_docs, NODE_DOCS),
                                        n_requests, max(n_docs, NODE_DOCS))
        assert len(texts) >= n_docs + n_live + 1000, len(texts)
        t0 = time.perf_counter()
        a, b = pair.start()
        ports = {n.name: n.start_http(0).port for n in (a, b)}
        done("boot", t0)

        # -- both indexes at 0 replicas, flushed -----------------------------
        t0 = time.perf_counter()
        two_node_fill(b.client(), texts[:n_docs], index="replicas")
        two_node_fill(b.client(), texts[n_docs:n_docs + n_live], index="replicas_live")
        for index in ("replicas", "replicas_live"):
            assert a.client().flush(index)["_shards"]["failed"] == 0
        done("index_bulk_flush", t0)

        # -- the kept leg: every body over the primaries ------------------------
        t0 = time.perf_counter()
        kept, _l, _w = searches(ports[names[0]], "replicas", bodies)
        for i, (st, r) in enumerate(kept):
            assert st == 200 and r["_shards"] == SHARDS_OK, (i, r.get("_shards"))
        done("kept_leg", t0)

        # -- a writer thread while both indexes go to 1 replica ----------------
        t0 = time.perf_counter()
        acked: dict = {}
        errors: list = []
        extra = texts[n_docs + n_live:]

        def write():
            conn = http.client.HTTPConnection("127.0.0.1", ports[names[0]], timeout=60)
            try:
                j = 0
                while not stop_writer.is_set() and j < len(extra):
                    st, r = http_json(conn, "PUT", f"/replicas_live/doc/w{j}",
                                      {"body": extra[j]})
                    if st == 201:
                        acked[f"w{j}"] = r["_version"]
                    else:
                        errors.append((st, r))
                    j += 1
            finally:
                conn.close()

        writer = threading.Thread(target=write, name="phase27-writer", daemon=True)
        writer.start()
        wait_for(lambda: len(acked) >= 20 or errors, "the writer's first writes")
        conn = http.client.HTTPConnection("127.0.0.1", ports[names[0]], timeout=120)
        st, r = http_json(conn, "PUT", "/replicas,replicas_live/_settings",
                          {"number_of_replicas": 1})
        conn.close()
        assert st == 200 and r.get("acknowledged"), r
        at_raise = len(acked)
        wait_for(lambda: health(a, None) == "green", "green", timeout=60)
        stop_writer.set()
        writer.join(timeout=30)
        assert not writer.is_alive() and not errors, errors[:2]
        done("recovery_under_writes", t0)
        recoveries = {}
        for n in (a, b):
            for index, svc in n.indices.indices.items():
                for sid, shard in svc.shards.items():
                    if not shard.primary:
                        recoveries[f"{index}/{sid}@{n.name}"] = dict(shard.recovery_info)
        assert len(recoveries) == 2 * NODE_SHARDS, recoveries
        assert all(r["files"] > 0 and r["bytes"] > 0 for r in recoveries.values()), \
            recoveries

        # -- every acknowledged write on both copies ---------------------------
        t0 = time.perf_counter()
        for index in ("replicas", "replicas_live"):
            assert a.client().refresh(index)["_shards"]["failed"] == 0
        counts = {n: a.client().search("replicas_live", {"size": 0},
                                       preference=f"_only_node:{n}")["hits"]["total"]
                  for n in names}
        assert counts[names[0]] == counts[names[1]] == n_live + len(acked), \
            (counts, n_live, len(acked))
        copies = {n.name: shard_copies(n, "replicas_live") for n in (a, b)}
        assert sorted(copies[names[0]]) == sorted(copies[names[1]]) == \
            list(range(NODE_SHARDS))
        for sid in range(NODE_SHARDS):
            assert copies[names[0]][sid] == copies[names[1]][sid], sid
        held = {k: v for docs in copies[names[0]].values() for k, v in docs.items()}
        assert all(held.get(k) == v for k, v in acked.items())
        placed = {n.name: {index: sorted(
            (sid, "p" if sh.primary else "r") for sid, sh in svc.shards.items())
            for index, svc in n.indices.indices.items()} for n in (a, b)}
        for n in names:  # each node reads a mix of primaries and replicas
            kinds = {k for _sid, k in placed[n]["replicas"]}
            assert kinds == {"p", "r"}, placed
        done("writes_checked", t0)

        # -- warm the replicas (a copy packs at its first search), then the
        # packs of the flushed commit, plane for plane -------------------------
        t0 = time.perf_counter()
        for n in names:
            for index in ("replicas", "replicas_live"):
                warm, _l, _w = searches(ports[n], index, bodies[:TWO_WARM],
                                        pref=f"_only_node:{n}")
                assert all(st == 200 for st, _r in warm)
        for n in (a, b):
            wait_for(lambda n=n: drained(n), f"{n.name}'s warmer drained")
        pack_diffs, pack_segments = replica_packs_diff((a, b), "replicas", device)
        assert pack_segments >= NODE_SHARDS and not pack_diffs, pack_diffs
        resident_by = {n.name: pair.resident(n) for n in (a, b)}
        done("warm_and_packs", t0)

        # -- each node's copies: bitwise the kept leg; after the writes,
        # scores bitwise and hits tie-tolerant between the nodes ---------------
        recorder = LaunchRecorder(scoring, sparse_score, copy_inputs=True)
        batches0 = {n.name: n.search_batcher.stats()["launches"] for n in (a, b)}
        errors0 = SERVING_COUNTERS["device_errors"]
        cudaenv.LAUNCHES.reset()
        results: dict = {}

        def leg(name, index, part):
            results[(name, index)] = searches(ports[name], index, part,
                                              pref=f"_only_node:{name}")

        def legs(args):
            threads = [threading.Thread(target=leg, args=a) for a in args]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        with pair.counting():
            t0 = time.perf_counter()
            legs([(names[i], "replicas", bodies[i::2]) for i in range(2)])
            wall = time.perf_counter() - t0
            # the `replicas` leg's own counts: one segment a shard copy, so
            # one launch a batch (the `replicas_live` copies hold several
            # segments, a launch each)
            kept_counts = pair.snapshot()
            kept_batches = {n.name: n.search_batcher.stats()["launches"] - batches0[n.name]
                            for n in (a, b)}
            kept_launches = cudaenv.LAUNCHES.snapshot()
            t0 = time.perf_counter()
            legs([(n, "replicas_live", bodies[:n_after]) for n in names])
            wall_after = time.perf_counter() - t0
            launches = cudaenv.LAUNCHES.snapshot()
        by_node, syncs = pair.snapshot(), pair.syncs
        batches = {n.name: n.search_batcher.stats()["launches"] - batches0[n.name]
                   for n in (a, b)}
        assert SERVING_COUNTERS["device_errors"] == errors0
        got = [None] * n_requests
        for i, name in enumerate(names):
            got[i::2] = results[(name, "replicas")][0]
        for i, ((st, r), (_kst, k)) in enumerate(zip(got, kept)):
            assert st == 200 and r["_shards"] == SHARDS_OK, (i, r.get("_shards"))
            assert r["hits"] == k["hits"], f"request {i}: hits differ from the kept leg"
        live_a, live_b = (results[(n, "replicas_live")][0] for n in names)
        for i, ((sa, ra), (sb, rb)) in enumerate(zip(live_a, live_b)):
            assert sa == sb == 200 and ra["_shards"] == rb["_shards"] == SHARDS_OK, i
            assert same_scores_tie_tolerant(ra, rb), f"live request {i}"
        for name in names:
            assert kept_counts[name]["waits"] == kept_batches[name] > 0, \
                (name, kept_counts, kept_batches)
            assert by_node[name]["waits"] == batches[name], (name, by_node, batches)
            if on_card:
                assert kept_counts[name]["launches"] == kept_batches[name], \
                    (name, kept_counts, kept_batches)
                assert by_node[name]["launches"] >= batches[name], (name, by_node, batches)
        assert syncs == 0 and by_node["other"]["launches"] == 0, (syncs, by_node)
        if on_card:
            assert kept_launches.get("sparse_score", 0) == \
                sum(kept_counts[n]["launches"] for n in names), (kept_launches, kept_counts)
            assert launches.get("sparse_score", 0) == \
                sum(by_node[n]["launches"] for n in names), (launches, by_node)
        lat = np.concatenate([results[(n, "replicas")][1] for n in names])
        steps["searches"] = wall + wall_after
        log(f"[27] searches {steps['searches']:.1f} s")

        t0 = time.perf_counter()
        max_err = check_shapes(recorder.shapes)
        shapes = [dict(Qb=int(args[0].shape[0]), TB=int(args[0].shape[1]),
                       tf=str(args[10].dtype), k=kwargs["k"], launches=n)
                  for _key, (args, kwargs, n) in recorder.shapes.items()]
        done("kernel_checks", t0)

        # -- the second node is lost under a burst on the first: first every
        # query phase the first node sends it fails (a disconnect injected
        # on the first node's transport), so each shard the burst routed
        # there fails over to the first node's copy; then it leaves and
        # the master promotes the first node's replicas -----------------------
        t0 = time.perf_counter()
        wait_for(lambda: drained(b), "the second node drained")
        b_resident = pair.resident(b)
        before = pair.allocated(recorder.held_bytes)
        burst: dict = {}

        def run_burst():
            burst["out"] = searches(ports[names[0]], "replicas", bodies[:n_loss])

        policy = FaultPolicy(seed).install(a.transport)
        failed_over = policy.disconnect(action=A_QUERY_PHASE,
                                        node=b.local_node.transport_address)
        bt = threading.Thread(target=run_burst, name="phase27-burst")
        bt.start()
        wait_for(lambda: failed_over.hits >= 1 or not bt.is_alive(),
                 "a query phase failed over")
        b.close()
        bt.join()
        FaultPolicy.uninstall(a.transport)
        assert failed_over.hits >= 1, "no query phase failed over"
        wait_for(lambda: a.cluster_service.state.nodes.size == 1, "the node removed")
        wait_for(lambda: health(a, "replicas") == "yellow" and
                 health(a, "replicas_live") == "yellow", "every primary on one node")
        for i, (st, r) in enumerate(burst["out"][0]):
            assert st == 200 and r["_shards"]["failed"] == 0, (i, r.get("_shards"))
            assert r["hits"] == kept[i][1]["hits"], f"burst request {i}"
        after = pair.allocated(recorder.held_bytes)
        released = before - after
        if on_card:
            assert 0.99 * b_resident <= released <= 1.01 * b_resident, \
                (b_resident, before, after)
        rows = [(s.shard_id, s.primary, s.node_id, s.state) for s in
                a.cluster_service.state.routing_table.index("replicas").all_shards()]
        assert sorted(r for r in rows if r[1]) == \
            [(sid, True, names[0], "STARTED") for sid in range(NODE_SHARDS)], rows
        promoted, _l, _w = searches(ports[names[0]], "replicas", bodies[:n_loss])
        for i, (st, r) in enumerate(promoted):
            assert st == 200 and r["_shards"] == SHARDS_OK, (i, r.get("_shards"))
            assert r["hits"] == kept[i][1]["hits"], f"request {i} after the loss"
        count_after = a.client().count("replicas_live")["count"]
        assert count_after == n_live + len(acked), (count_after, len(acked))
        done("node_loss", t0)

        out = dict(card=card, docs=n_docs, live_docs=n_live, writes=len(acked),
                   writes_at_raise=at_raise, recoveries=recoveries, placed=placed,
                   pack_segments=pack_segments, resident=resident_by,
                   requests=n_requests, requests_per_s=n_requests / wall,
                   p50_ms=float(np.percentile(lat, 50)),
                   p99_ms=float(np.percentile(lat, 99)),
                   by_node=by_node, batches=batches,
                   kept_by_node=kept_counts, kept_batches=kept_batches,
                   launches=launches, kernel_shapes=shapes, kernel_max_abs_err=max_err,
                   departed=dict(resident=b_resident, released=released,
                                 share=(released / b_resident) if b_resident else None,
                                 failed_over=failed_over.hits,
                                 close_drain=b.close_drain),
                   steps_s=steps)
        log(f"[27] two nodes on {device} over TCP, master {names[0]}: `replicas` "
            f"{n_docs} docs and `replicas_live` {n_live}, 5 shards each, flushed, "
            f"raised to 1 replica under {len(acked)} single-document writes "
            f"({at_raise} before the raise); green in "
            f"{steps['recovery_under_writes']:.1f} s; {card}")
        for key, rec in sorted(recoveries.items()):
            log(f"[27]   recovery {key}: {rec['files']} files, {rec['bytes']} B, "
                f"{rec['reused']} reused, throttled {rec['throttle_ms']} ms")
        log(f"[27] `replicas_live` `_count` {counts[names[0]]} on either node's copies "
            f"== {n_live} bulked + {len(acked)} acknowledged; each shard's copies hold "
            f"the same ids at the same versions")
        log(f"[27] `replicas`: {pack_segments} segments' replica packs == the "
            f"primary's (plane for plane); resident {names[0]} {resident_by[names[0]]} B, "
            f"{names[1]} {resident_by[names[1]]} B; placement {placed}")
        log(f"[27] {n_requests} `bool` bodies, half `_only_node` on each node, from "
            f"{n_conn} connections: {out['requests_per_s']:.1f} requests/s, p50 "
            f"{out['p50_ms']:.2f} ms, p99 {out['p99_ms']:.2f} ms; every hits JSON == the "
            f"kept leg's (bitwise); {n_after} bodies on `replicas_live` per node: scores "
            f"bitwise, hits tie-tolerant between the nodes; {card}")
        for name in names:
            log(f"[27]   {name}: `replicas` leg {kept_counts[name]['launches']} "
                f"sparse_score launches, {kept_batches[name]} batches, "
                f"{kept_counts[name]['waits']} PendingPull.wait calls; both legs "
                f"{by_node[name]['launches']} launches, {batches[name]} batches, "
                f"{by_node[name]['waits']} waits; torch.cuda.synchronize calls {syncs}")
        log(f"[27] {names[1]} lost under {n_loss} bodies on {names[0]}: "
            f"{failed_over.hits} query phases failed over from it to {names[0]}'s "
            f"copies, then it left (its close waited {b.close_drain['waited_s']:.3f} s "
            f"for {b.close_drain['contexts']} pinned contexts); every "
            f"`_shards.failed` 0, hits == the kept leg's; promoted primaries answer "
            f"{n_loss} more bitwise; `_count` {count_after}; resident {b_resident} B, "
            f"memory_allocated() fell {released} B"
            + (f" ({released / b_resident:.4f} of it)" if b_resident else ""))
        for sh in shapes:
            log(f"[27]   sparse_score Qb {sh['Qb']} TB {sh['TB']} {sh['tf']} k {sh['k']}: "
                f"{sh['launches']} launches")
        log(f"[27] sparse_score == plain (bitwise) at all {len(shapes)} shapes phase 27 "
            f"launched; max abs err {max_err}")
        out["wall_phase_s"] = time.perf_counter() - t_phase
        log(f"[27] phase 27 took {out['wall_phase_s']:.1f} s; by step (s): "
            + ", ".join(f"{k} {v:.1f}" for k, v in steps.items()))
        return out
    finally:
        stop_writer.set()
        if writer is not None:
            writer.join(timeout=30)
        if policy is not None:
            FaultPolicy.uninstall(pair.nodes[0].transport)
        if recorder is not None:
            recorder.close()
        pair.close()
        shutil.rmtree(root, ignore_errors=True)


class QueryPhaseTally:
    """Counts, until `close()`, the query phases each node's transport
    hands to its handler (after any received-side fault's delay): by node,
    primary attempts and hedged attempts apart, for each (body, shard)
    the nodes that ran it, and every arrival in order as ((body, shard),
    node). `take()` returns the three since the last take."""

    def __init__(self, nodes):
        from elasticsearch_tpu_torch.actions import A_QUERY_PHASE

        self.lock = threading.Lock()
        self.names = [n.name for n in nodes]
        self._reset()
        self._wrapped = []
        for n in nodes:
            handler = n.transport.handlers[A_QUERY_PHASE]
            inner = handler.fn

            def counted(request, channel, name=n.name, inner=inner):
                key = (json.dumps(request.get("body"), sort_keys=True), request["shard"])
                with self.lock:
                    self.by_node[name]["hedge" if request.get("hedge") else "primary"] += 1
                    self.landed.setdefault(key, set()).add(name)
                    self.arrivals.append((key, name))
                return inner(request, channel)

            handler.fn = counted
            self._wrapped.append((handler, inner))

    def _reset(self):
        self.by_node = {n: dict(primary=0, hedge=0) for n in self.names}
        self.landed: dict = {}
        self.arrivals: list = []

    def take(self) -> tuple[dict, dict, list]:
        with self.lock:
            out = ({k: dict(v) for k, v in self.by_node.items()}, dict(self.landed),
                   list(self.arrivals))
            self._reset()
        return out

    def close(self) -> None:
        for handler, inner in self._wrapped:
            handler.fn = inner


@contextlib.contextmanager
def phase_timer(node):
    """Time each shard query phase `node` coordinates while the block runs,
    from its first attempt to the answer of its chain (a hedge's too), in
    ms: the latency that replica selection and hedging act on."""
    actions = node.actions
    inner = actions._query_shard_async
    out: list = []

    def timed(*args, **kwargs):
        t0 = time.monotonic()
        fut = inner(*args, **kwargs)
        fut.add_done_callback(lambda f: out.append(
            1000.0 * (getattr(f, "completed_at", None) or time.monotonic()) - 1000.0 * t0))
        return fut

    actions._query_shard_async = timed
    try:
        yield out
    finally:
        del actions._query_shard_async


def hold_restore_swaps(nodes) -> None:
    """Hold each node's restore-shard handler until every copy of the
    restored index is started, so each replica has finished its recovery
    from the still-empty primary before the primary's files are replaced:
    the order a quiet cluster shows (which comes first is a race on both
    packages; tests/test_torch_snapshots.py holds the JAX cluster's swaps
    the same way)."""
    from elasticsearch_tpu_torch.snapshots import A_RESTORE_SHARD

    for n in nodes:
        handler = n.transport.handlers[A_RESTORE_SHARD]
        inner = handler.fn

        def held(request, channel, n=n, inner=inner):
            deadline = time.perf_counter() + 60.0
            while True:
                table = n.cluster_service.state.routing_table.index(request["index"])
                if table is not None and all(s.state == "STARTED"
                                             for s in table.all_shards()):
                    break
                assert time.perf_counter() < deadline, "the restored copies never started"
                time.sleep(0.01)
            return inner(request, channel)

        handler.fn = held


def pack_copy(p):
    """A host copy of a pack's fields that `packs_equal` reads, holding
    nothing on the card."""
    from types import SimpleNamespace

    fields = {f: getattr(p, f) for f in ("gen", "doc_count", "doc_pad", "tf_layout",
                                         "tf_integral", "live_gen", "term_blk_start",
                                         "host_docs", "host_freqs")}
    for f in ("blk_docs", "blk_tf", "blk_nb", "live_parent"):
        fields[f] = getattr(p, f).cpu()
    fields["norm_bytes"] = {k: v.cpu() for k, v in p.norm_bytes.items()}
    return SimpleNamespace(**fields)


def primary_packs(nodes, index: str, device) -> dict:
    """(shard, segment gen) -> a host copy of the primary's pack, for every
    segment of `index`'s primaries that holds a pack on `device`."""
    from elasticsearch_tpu_torch.ops.device_index import pack_cache_key

    out = {}
    for n in nodes:
        svc = n.indices.indices.get(index)
        for sid, shard in list(svc.shards.items()) if svc is not None else []:
            if not shard.primary:
                continue
            for seg in shard.engine.acquire_searcher().segments:
                p = seg._device_cache.get(pack_cache_key(device))
                if p is not None:
                    out[(sid, seg.gen)] = pack_copy(p)
    return out


def adaptive_phase(device, *, vocab: int, seed: int, n_docs: int = ADAPT_DOCS,
                   n_refs: int = ADAPT_REFS, n_leg: int = ADAPT_LEG,
                   n_conn: int = ADAPT_CONN, delay_s: float = ADAPT_DELAY_S,
                   n_chunks: int = ADAPT_CHUNKS, chunk: int = ADAPT_CHUNK,
                   n_affinity: int = ADAPT_AFFINITY, n_profiled: int = ADAPT_PROFILED,
                   n_rr: int = ADAPT_RR, settings: dict | None = None) -> dict:
    """Phase 28: adaptive replica selection, hedged query phases,
    cache-affinity routing and snapshot/restore on the card. Two port Nodes
    on `device` in this process over the TCP transport, as in phases 26-27,
    with the JAX chaos test's hedge burst (and `settings`, JAX keys, on
    both nodes). `adaptive` (`n_docs` of phase
    10's texts, 5 shards) is bulked and flushed at 0 replicas, then raised
    to 1 replica, so each replica recovers its primary's flushed commit and
    either copy answers a body bitwise. Each copy is warmed with
    `_only_node` to each node, then with preference-free traffic until the
    first node's selector (the coordinator's: every leg is sent to it) has
    `min_samples` on all 10 copies and their EWMAs are within 3x. Then
    `n_refs` `bool` bodies with `preference=_primary` are the reference.
    Each leg is sent from `n_conn` connections to the first node, with no
    preference unless it says so:

    (a) healthy, `n_leg` bodies: every hits JSON bitwise the reference,
        each node taking >= 0.3 of the query phases (a tally of the phases
        each node's transport ran);
    (b) a seeded FaultPolicy on the second node delays every query phase
        it receives by `delay_s`. First the JAX chaos test's own shape
        (tests/test_adaptive_routing.py): one group (`_shards:0`, which
        keeps hedging), one connection, `ADAPT_ONE_HEALTHY` requests before
        the fault and `ADAPT_ONE_SLOW` from its start: p95 < 0.7 s and <
        max(2 x the healthy p99, 0.45 s), hedges issued and won, bitwise
        the shard's `_primary` answers. Then `n_leg` bodies: its share of
        the query phases <= 0.35, hedges issued and won (> 0) and issued
        <= the budget's ratio x primary attempts + its burst, every hits
        JSON bitwise the reference; then `n_profiled` profiled bodies with
        the soft `_prefer_node:<second>` (which keeps hedging) from 4
        connections, bitwise too, at least one shard's profile `winner:
        "hedge"`; then `n_rr` bodies with the coordinator's selector off
        (round-robin, hedging on), bitwise too, measured beside the leg.
        Each shard phase of the leg is timed from its first attempt to its
        chain's answer (`phase_timer`): their p50 is under the delay.
        (Under `n_conn` connections the selector's (1 + outstanding) term
        keeps the slow copy in the spread set while the fast one is busy,
        and the budget hedges about a quarter of its attempts, so under the
        JAX selector's rules a request of five groups waits for the delay
        about half the time: its p50 and p95 are printed, not held);
    (c) the fault cleared: within `n_chunks` chunks of `chunk` requests,
        the second node's copies are selected 5 times a group in one chunk
        (the JAX test's 5 of 16 for one copy, summed over the 5 groups),
        and the selector counted probes;
    (d) `n_affinity` bodies at `size: 0`, each sent `ADAPT_PASSES` times
        (pass by pass) from one connection, every selection recorded with
        the spread set it was made from: each is an affinity selection or
        a probe turn (a copy outside the spread set, every 8th selection
        of its group), each affinity pick is the rendezvous winner of its
        spread set and each probe lies outside it, every query phase a
        copy had run before is a request-cache hit there (and every first
        one a miss), and a pass of revisits only launches no
        `sparse_score`; then `n_affinity` more from `n_conn` connections,
        measured;
    (e) `PUT /_snapshot/backup` (fs, a directory under the phase's root),
        `PUT /_snapshot/backup/s1`, `DELETE /adaptive`:
        `memory_allocated()` falls by 0.99-1.01 of the bytes the port
        counts resident for the index; `POST .../s1/_restore`, green; after
        128 `_primary` bodies (bitwise the reference) the restored
        primaries' packs equal the deleted primaries' (`packs_equal`) and
        `memory_allocated()` rose by 0.99-1.01 of the restored index's
        resident bytes; each node's `_only_node` `_count` is the kept
        behaviour's (the primaries hold every document, the replicas
        recovered from the still-empty primaries: as on the JAX cluster,
        pinned in tests/test_torch_snapshots.py); snapshot `s2` reuses
        every segment blob of `s1`.

    The checks of (a)-(e) are each logged as they are made and the phase
    fails after (e) if any failed. Throughout (a)-(e), per node,
    `sparse_score` launches + batches whose queries found no block of
    their terms (which launch nothing) == batches == `PendingPull.wait`
    calls, and no `torch.cuda.synchronize`; at the end
    no context is pinned on either node, and the kernel is bitwise against
    its plain version at every shape either node launched."""
    import http.client

    from elasticsearch_tpu_torch.actions import A_QUERY_PHASE
    from elasticsearch_tpu_torch.cluster.routing import OperationRouting
    from elasticsearch_tpu_torch.common import cudaenv
    from elasticsearch_tpu_torch.ops import scoring
    from elasticsearch_tpu_torch.ops.sparse_kernels import sparse_score
    from elasticsearch_tpu_torch.search import SERVING_COUNTERS
    from elasticsearch_tpu_torch.transport.faults import FaultPolicy

    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    card = card_line() if on_card else f"{device} (a rehearsal: no card)"
    root = Path(__file__).resolve().parent / "build" / f"chip_smoke_adapt_{os.getpid()}"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    names = ("n28a", "n28b")
    index = "adaptive"
    steps: dict = {}
    recorder = tally = None
    pair = NodePair(device, names, root, phase=28,
                    settings={"search.hedge.burst": ADAPT_BURST, **(settings or {})})
    wait_for = pair.wait_for
    failed: list = []

    def check(ok: bool, what: str, *values) -> bool:
        if not ok:
            failed.append(f"{what}: {values}")
            log(f"[28] CHECK FAILED {what}: {values}")
        return ok

    by_step: dict = {}  # step -> node -> [batches, launches, waits] in it
    last = {}

    def done(step: str, t0: float):
        steps[step] = time.perf_counter() - t0
        counts = pair.snapshot()
        now = {n.name: [n.search_batcher.stats()["launches"]] +
               [counts[n.name][c] for c in ("launches", "unlaunched", "waits")]
               for n in pair.nodes}
        by_step[step] = {k: [x - y for x, y in zip(v, last.get(k, [0, 0, 0, 0]))]
                         for k, v in now.items()}
        last.update(now)
        log(f"[28] {step} {steps[step]:.1f} s; batches, launches, batches without "
            f"a launch, waits by node {by_step[step]}")

    def send(port, part, pref=None, profile=False, conn=n_conn):
        params = [f"preference={pref}"] if pref else []
        if profile:
            params.append("profile=true")
        path = f"/{index}/_search" + ("?" + "&".join(params) if params else "")
        return http_requests(port, [("POST", path, body, None) for body in part],
                             max(1, min(conn, len(part))))

    def ok_hits(results, refs, what, shards=SHARDS_OK):
        for i, ((st, r), want) in enumerate(zip(results, refs)):
            assert st == 200 and r["_shards"] == shards, (what, i, st, r.get("_shards"))
            assert r["hits"] == want["hits"], f"{what} request {i}: hits differ"

    ONE_SHARD_OK = {"total": 1, "successful": 1, "degraded": 0, "failed": 0}

    def copy_keys(node_name):
        return [f"{node_name}/{index}/{sid}" for sid in range(NODE_SHARDS)]

    try:
        texts, bodies = two_node_inputs(vocab, seed, n_docs, n_refs,
                                        max(n_docs, NODE_DOCS))
        t0 = time.perf_counter()
        a, b = pair.start()
        ports = {n.name: n.start_http(0).port for n in (a, b)}
        sel = a.adaptive_routing
        done("boot", t0)

        # -- `adaptive` flushed at 0 replicas, then a replica of each shard
        # recovers the flushed commit ----------------------------------------
        t0 = time.perf_counter()
        two_node_fill(b.client(), texts, index=index)
        assert a.client().flush(index)["_shards"]["failed"] == 0
        r = a.client().update_settings(index, {"number_of_replicas": 1})
        assert r.get("acknowledged"), r
        wait_for(lambda: a.client().cluster_health(index, timeout=0)["status"] == "green",
                 "green", timeout=60)
        done("index_flush_replicate", t0)

        # -- warm each copy, then until the selector is warm and even -------
        t0 = time.perf_counter()
        for n in names:
            warm, _l, _w = send(ports[n], bodies[:TWO_WARM], pref=f"_only_node:{n}")
            assert all(st == 200 for st, _r in warm)
        for n in (a, b):
            wait_for(lambda n=n: pair.drained(n), f"{n.name}'s warmer drained")
        keys = copy_keys(names[0]) + copy_keys(names[1])
        warm_chunks = 0
        while True:
            warm, _l, _w = send(ports[names[0]], bodies[:2 * n_conn])
            assert all(st == 200 for st, _r in warm)
            warm_chunks += 1
            copies = sel.stats()["copies"]
            if all(k in copies and copies[k]["samples"] >= sel.min_samples for k in keys):
                ew = [copies[k]["ewma_ms"] for k in keys]
                if max(ew) <= 3.0 * min(ew):
                    break
            assert warm_chunks < ADAPT_WARM_CHUNKS, \
                f"phase 28: the EWMAs never converged: {copies}"
        warm_ewma = {k: copies[k]["ewma_ms"] for k in keys}
        refs, _l, _w = send(ports[names[0]], bodies, pref="_primary")
        for i, (st, r) in enumerate(refs):
            assert st == 200 and r["_shards"] == SHARDS_OK, (i, r.get("_shards"))
        refs = [r for _st, r in refs]
        # the one-group references: shard 0's primary alone
        one_bodies = bodies[:ADAPT_ONE_SLOW]
        one_refs, _l, _w = send(ports[names[0]], one_bodies, pref="_shards:0;_primary")
        assert all(st == 200 for st, _r in one_refs)
        one_refs = [r for _st, r in one_refs]
        done("warm_and_reference", t0)

        leg_bodies = [bodies[i % n_refs] for i in range(n_leg)]
        leg_refs = [refs[i % n_refs] for i in range(n_leg)]
        recorder = LaunchRecorder(scoring, sparse_score, copy_inputs=True)
        tally = QueryPhaseTally((a, b))
        batches0 = {n.name: n.search_batcher.stats()["launches"] for n in (a, b)}
        errors0 = SERVING_COUNTERS["device_errors"]
        cudaenv.LAUNCHES.reset()
        out: dict = {}
        with pair.counting():
            # -- (a) healthy ---------------------------------------------------
            t0 = time.perf_counter()
            tally.take()
            got, lat_a, wall = send(ports[names[0]], leg_bodies)
            ok_hits(got, leg_refs, "healthy")
            phases_a, _landed, _arr = tally.take()
            total = sum(v["primary"] + v["hedge"] for v in phases_a.values())
            share_a = {n: (v["primary"] + v["hedge"]) / total for n, v in phases_a.items()}
            check(all(s >= 0.3 for s in share_a.values()), "(a) each node's share >= 0.3",
                  share_a, phases_a)
            out["healthy"] = dict(requests_per_s=n_leg / wall,
                                  p50_ms=float(np.percentile(lat_a, 50)),
                                  p95_ms=float(np.percentile(lat_a, 95)),
                                  p99_ms=float(np.percentile(lat_a, 99)),
                                  phases=phases_a, share=share_a)
            done("healthy", t0)

            # -- (b) the second node's received query phases delayed ----------
            t0 = time.perf_counter()
            # first the JAX chaos test's shape: one shard group (`_shards:0`
            # keeps hedging), one connection, a healthy baseline, then the
            # fault and its timed requests from the moment it is installed
            one_h, lat_1h, _w = send(ports[names[0]], one_bodies[:ADAPT_ONE_HEALTHY],
                                     pref="_shards:0", conn=1)
            ok_hits(one_h, one_refs, "one group, healthy", ONE_SHARD_OK)
            policy = FaultPolicy(seed).install(b.transport)
            rule = policy.delay(delay_s, action=A_QUERY_PHASE, direction="recv")
            h00 = sel.hedges.stats()
            one_s, lat_1s, _w = send(ports[names[0]], one_bodies, pref="_shards:0", conn=1)
            ok_hits(one_s, one_refs, "one group, slow copy", ONE_SHARD_OK)
            h0 = sel.hedges.stats()
            one_phases, _landed, _arr = tally.take()
            one_sorted = sorted(lat_1s)
            one_p95 = float(one_sorted[int(0.95 * len(one_sorted)) - 1])
            one_p99h = float(max(lat_1h))
            check(one_p95 < 700.0, "(b) one group: p95 < 700 ms", one_p95, one_sorted[-5:])
            check(one_p95 < max(2.0 * one_p99h, 450.0),
                  "(b) one group: p95 < max(2 x healthy p99, 450 ms)", one_p95, one_p99h)
            check(h0["issued"] > h00["issued"] and h0["won"] > h00["won"],
                  "(b) one group: hedges issued and won", h00, h0)
            out["one_group"] = dict(requests=len(one_bodies), healthy_p99_ms=one_p99h,
                                    p50_ms=float(np.percentile(lat_1s, 50)), p95_ms=one_p95,
                                    max_ms=float(one_sorted[-1]), phases=one_phases,
                                    hedges_issued=h0["issued"] - h00["issued"],
                                    hedges_won=h0["won"] - h00["won"])
            # then the leg: every group, `n_conn` connections, each shard's
            # query phase timed from its first attempt to the chain's answer
            st0 = sel.stats()
            with phase_timer(a) as phase_b:
                got, lat_b, wall = send(ports[names[0]], leg_bodies)
            h1 = sel.hedges.stats()
            st1 = sel.stats()
            phases_b, _landed, _arr = tally.take()
            kinds_b = {k: v - st0["selections"][k] for k, v in st1["selections"].items()}
            picked_b = {n: sum(st1["copies"][k]["selected"] - st0["copies"][k]["selected"]
                               for k in copy_keys(n)) for n in names}
            copies_b = {k: {f: st1["copies"][k][f] for f in
                            ("ewma_ms", "p99_ms", "outstanding", "queue")}
                        for k in keys}
            ok_hits(got, leg_refs, "slow copy")
            total = sum(v["primary"] + v["hedge"] for v in phases_b.values())
            share_b = (phases_b[names[1]]["primary"] + phases_b[names[1]]["hedge"]) / total
            primaries = sum(v["primary"] for v in phases_b.values())
            issued, won = h1["issued"] - h0["issued"], h1["won"] - h0["won"]
            p95_b = float(np.percentile(lat_b, 95))
            log(f"[28] (b) p50 {np.percentile(lat_b, 50):.2f} ms, p95 {p95_b:.2f} ms, "
                f"query phases {phases_b} (share {share_b:.3f}), hedges issued {issued}, "
                f"won {won}, budget exhausted "
                f"{h1['budget_exhausted'] - h0['budget_exhausted']}, {primaries} primary "
                f"attempts; healthy p50 {out['healthy']['p50_ms']:.2f} ms, p95 "
                f"{out['healthy']['p95_ms']:.2f} ms")
            check(share_b <= 0.35, "(b) the slow node's share <= 0.35", share_b, phases_b)
            check(issued > 0 and won > 0, "(b) hedges issued and won", h0, h1)
            check(issued <= h1["ratio"] * primaries + h1["burst"],
                  "(b) hedges within the budget", issued, primaries, h1)
            log(f"[28] (b) selections in the leg {kinds_b}, copies picked by node "
                f"{picked_b}; the copies after it {copies_b}")
            # under `n_conn` connections the selector's (1 + outstanding)
            # term keeps the slow copy in the spread set while the fast one
            # is busy, and the budget hedges about a quarter of its
            # attempts: the JAX selector's rules bound a shard's query
            # phase, not a request of five, whose p50 and p95 follow the
            # host's speed around the delay (printed, not held; the
            # one-group run above holds the request's p95)
            check(len(phase_b) == NODE_SHARDS * n_leg, "(b) every shard phase timed",
                  len(phase_b))
            check(float(np.percentile(phase_b, 50)) < 1000.0 * delay_s,
                  "(b) the shard phases' p50 under the delay",
                  float(np.percentile(phase_b, 50)), float(np.percentile(phase_b, 95)))
            # a profiled shard phase launches on its search thread, outside
            # the batcher: those launches and pulls are left out of the
            # per-node counts (and of the process's launch count)
            pair.paused = True
            k0 = cudaenv.LAUNCHES.snapshot().get("sparse_score", 0)
            prof, _l, _w = send(ports[names[0]], leg_bodies[:n_profiled],
                                pref=f"_prefer_node:{names[1]}", profile=True, conn=4)
            profiled_launches = cudaenv.LAUNCHES.snapshot().get("sparse_score", 0) - k0
            pair.paused = False
            winners = {}
            for i, ((st, r), want) in enumerate(zip(prof, leg_refs)):
                assert st == 200 and r["_shards"]["failed"] == 0, (i, r.get("_shards"))
                assert r["hits"] == want["hits"], f"profiled request {i}: hits differ"
                for sh in r["profile"]["shards"]:
                    winners[sh["winner"]] = winners.get(sh["winner"], 0) + 1
            check(winners.get("hedge", 0) >= 1, "(b) a profiled `winner: hedge`", winners)
            h2 = sel.hedges.stats()
            tally.take()
            # the same load with the coordinator's selector off (measured):
            # the routing round-robins, hedging and its budget stay on
            sel.enabled = False
            try:
                with phase_timer(a) as phase_rr:
                    got, lat_rr, _w = send(ports[names[0]], leg_bodies[:n_rr])
            finally:
                sel.enabled = True
            ok_hits(got, leg_refs[:n_rr], "slow copy, round-robin")
            phases_rr, _landed, _arr = tally.take()
            h3 = sel.hedges.stats()
            total = sum(v["primary"] + v["hedge"] for v in phases_rr.values())
            share_rr = (phases_rr[names[1]]["primary"] +
                        phases_rr[names[1]]["hedge"]) / total
            over = {"adaptive": float(np.mean(np.asarray(lat_b) >= 1000.0 * delay_s)),
                    "round_robin": float(np.mean(np.asarray(lat_rr) >= 1000.0 * delay_s))}
            mean_b, mean_rr = float(np.mean(lat_b)), float(np.mean(lat_rr))
            log(f"[28] (b) round-robin under the delay, {n_rr} bodies: mean "
                f"{mean_rr:.2f} ms (adaptive {mean_b:.2f}), p50 "
                f"{np.percentile(lat_rr, 50):.2f} ms (adaptive "
                f"{np.percentile(lat_b, 50):.2f}), share over the delay {over}, "
                f"{names[1]}'s share {share_rr:.3f}, hedges issued "
                f"{h3['issued'] - h2['issued']}; shard phases p50 "
                f"{np.percentile(phase_rr, 50):.2f} ms (adaptive "
                f"{np.percentile(phase_b, 50):.2f}), p95 {np.percentile(phase_rr, 95):.2f} "
                f"ms (adaptive {np.percentile(phase_b, 95):.2f})")
            out["slow"] = dict(delay_s=delay_s, delayed=rule.hits,
                               requests_per_s=n_leg / wall,
                               p50_ms=float(np.percentile(lat_b, 50)), p95_ms=p95_b,
                               p99_ms=float(np.percentile(lat_b, 99)),
                               phases=phases_b, share=share_b, primary_attempts=primaries,
                               hedges_issued=issued, hedges_won=won,
                               budget_exhausted=h1["budget_exhausted"] - h0["budget_exhausted"],
                               profiled=n_profiled, winners=winners,
                               profiled_launches=profiled_launches,
                               profiled_hedges_issued=h2["issued"] - h1["issued"],
                               selections=kinds_b, picked=picked_b, copies=copies_b,
                               mean_ms=mean_b, over_delay=over,
                               phase_p50_ms=float(np.percentile(phase_b, 50)),
                               phase_p95_ms=float(np.percentile(phase_b, 95)),
                               round_robin=dict(requests=n_rr, mean_ms=mean_rr,
                                                phase_p50_ms=float(np.percentile(phase_rr, 50)),
                                                phase_p95_ms=float(np.percentile(phase_rr, 95)),
                                                p50_ms=float(np.percentile(lat_rr, 50)),
                                                p95_ms=float(np.percentile(lat_rr, 95)),
                                                phases=phases_rr, share=share_rr,
                                                hedges_issued=h3["issued"] - h2["issued"]))
            done("slow_copy", t0)

            # -- (c) the fault cleared: the copy rejoins the rotation ----------
            t0 = time.perf_counter()
            policy.clear()
            FaultPolicy.uninstall(b.transport)
            probes0 = sel.stats()["probes"]
            rejoined = None
            picks = []
            for c in range(n_chunks):
                before = sel.stats()["copies"]
                got, _l, _w = send(ports[names[0]], leg_bodies[c * chunk:(c + 1) * chunk])
                ok_hits(got, leg_refs[c * chunk:(c + 1) * chunk], "recovery")
                after = sel.stats()["copies"]
                picked = sum(after[k]["selected"] - before[k]["selected"]
                             for k in copy_keys(names[1]))
                picks.append(picked)
                if picked >= 5 * NODE_SHARDS:
                    rejoined = c
                    break
            probes = sel.stats()["probes"] - probes0
            check(rejoined is not None and probes > 0, "(c) the copy rejoins, with probes",
                  picks, probes, sel.stats()["copies"])
            tally.take()
            out["recovery"] = dict(chunks=None if rejoined is None else rejoined + 1,
                                   picks=picks, probes=probes)
            done("recovery", t0)

            # -- (d) cache affinity: pass by pass, from one connection (held
            # to every check), then from `n_conn` (measured) -----------------
            t0 = time.perf_counter()

            def spread_set(active) -> set:
                """The copies `select` may pick by affinity right now: the
                ones within the spread of the best score among those not
                quarantined (all of them when every copy is), as
                `AdaptiveReplicaSelector.select` computes them."""
                now = time.monotonic()
                hl, qt = sel.failure_halflife_s, sel.quarantine_failures
                scored = [(sel._copy(sel.key(c)).score(now, hl), c,
                           sel._copy(sel.key(c)).quarantined(now, hl, qt)) for c in active]
                healthy = [(sc, c) for sc, c, q in scored if not q] or \
                    [(sc, c) for sc, c, _q in scored]
                best = min(sc for sc, _c in healthy)
                return {c.node_id for sc, c in healthy if sc <= best * sel.spread + 1e-4}

            def affinity_leg(part, conn, record: bool):
                """`ADAPT_PASSES` passes of `part` from `conn` connections.
                With `record`, every selection is logged with its kind and
                the spread set it was made from (a serial leg: no other
                selection runs between the two reads)."""
                selections: list = []
                if record:
                    inner_select = sel.select

                    def recording(active, affinity=None):
                        spread = spread_set(active)
                        k0 = dict(sel.selections)
                        pick = inner_select(active, affinity=affinity)
                        kind = next(k for k, v in sel.selections.items() if v != k0[k])
                        selections.append((affinity, active[0].shard_id, kind,
                                           pick.node_id, spread, len(active)))
                        return pick

                    sel.select = recording
                kinds0 = dict(sel.stats()["selections"])
                hits0 = [sum(n.request_cache.stats()["hits"] for n in (a, b))]
                totals, by_pass, hits_by_pass, kinds_by_pass, ewma_by_pass = \
                    None, [], [], [], []
                seen: dict = {}  # (body, shard) -> the nodes that ran it so far
                revisits, new_visits = [], []
                tally.take()
                try:
                    for p in range(ADAPT_PASSES):
                        before = pair.snapshot()
                        k_before = dict(sel.stats()["selections"])
                        copies = sel.stats()["copies"]
                        ewma_by_pass.append({n: [copies[k]["ewma_ms"] for k in copy_keys(n)]
                                             for n in names})
                        got, _l, _w = send(ports[names[0]], part, conn=conn)
                        after = pair.snapshot()
                        by_pass.append(sum(after[n]["launches"] - before[n]["launches"]
                                           for n in names))
                        kinds_by_pass.append({k: v - k_before[k] for k, v in
                                              sel.stats()["selections"].items()
                                              if v - k_before[k]})
                        hits_now = sum(n.request_cache.stats()["hits"] for n in (a, b))
                        hits_by_pass.append(hits_now - hits0[-1])
                        hits0.append(hits_now)
                        for i, (st, r) in enumerate(got):
                            assert st == 200 and r["_shards"] == SHARDS_OK, \
                                (p, i, r.get("_shards"))
                        now = [r["hits"]["total"] for _st, r in got]
                        assert totals is None or now == totals, (p, now, totals)
                        totals = now
                        _phases, _landed, arrivals = tally.take()
                        old = new = 0
                        for key, node in arrivals:
                            if node in seen.get(key, ()):
                                old += 1
                            else:
                                new += 1
                                seen.setdefault(key, set()).add(node)
                        revisits.append(old)
                        new_visits.append(new)
                finally:
                    if record:
                        del sel.select
                kinds = sel.stats()["selections"]
                wrong = [x for x in selections
                         if (x[2] == "affinity" and x[3] != OperationRouting.rendezvous(
                             x[0], [c for c in a.cluster_service.state.routing_table
                                    .index(index).shard(x[1]).active_shards()
                                    if c.node_id in x[4]]).node_id)
                         or (x[2] == "probe" and x[3] in x[4])]
                narrowed = sum(1 for x in selections
                               if x[2] == "affinity" and len(x[4]) < x[5])
                return dict(bodies=len(part), conn=conn,
                            selections=kinds["affinity"] - kinds0["affinity"],
                            by_kind={k: v - kinds0[k] for k, v in kinds.items()},
                            recorded=len(selections), wrong=len(wrong), wrong_first=wrong[:4],
                            narrowed=narrowed,
                            launches_by_pass=by_pass, hits_by_pass=hits_by_pass,
                            revisits_by_pass=revisits, new_visits_by_pass=new_visits,
                            kinds_by_pass=kinds_by_pass, ewma_ms_by_pass=ewma_by_pass,
                            pairs=len(seen),
                            spread=sum(1 for v in seen.values() if len(v) != 1))

            zero = [{**body, "size": 0} for body in bodies[:2 * n_affinity]]
            af = affinity_leg(zero[:n_affinity], 1, record=True)
            want = ADAPT_PASSES * n_affinity * NODE_SHARDS
            # every selection by affinity but the probe turns (every 8th
            # selection of a group while one of its copies is outside the
            # spread set), each affinity pick the rendezvous winner of its
            # spread set and each probe outside it
            check(af["recorded"] == want and
                  af["by_kind"].get("affinity", 0) + af["by_kind"].get("probe", 0) == want,
                  "(d) every selection by affinity or a probe turn", af)
            check(af["wrong"] == 0, "(d) each pick the rendezvous winner of its spread set", af)
            # each (body, shard) that a copy ran before is a request-cache
            # hit there, and a pass whose every phase was such a revisit
            # launches nothing
            check(af["hits_by_pass"][0] == 0 and af["hits_by_pass"][1:] == af["revisits_by_pass"][1:],
                  "(d) every revisit a request-cache hit, every first visit a miss", af)
            if on_card:
                check(af["launches_by_pass"][0] > 0 and
                      all(n == 0 for n, new in zip(af["launches_by_pass"][1:],
                                                   af["new_visits_by_pass"][1:]) if new == 0),
                      "(d) no launch in a pass of revisits only", af)
            out["affinity"] = af
            out["affinity_concurrent"] = affinity_leg(zero[n_affinity:], n_conn, record=False)
            done("affinity", t0)

            # -- (e) snapshot, delete, restore ----------------------------------
            t0 = time.perf_counter()
            repo = root / "repo"
            conn = http.client.HTTPConnection("127.0.0.1", ports[names[0]], timeout=300)
            try:
                st, r = http_json(conn, "PUT", "/_snapshot/backup",
                                  {"type": "fs", "settings": {"location": str(repo)}})
                assert st == 200 and r["acknowledged"], r
                st, r = http_json(conn, "PUT", "/_snapshot/backup/s1", {"indices": index})
                assert st == 200 and r["snapshot"]["state"] == "SUCCESS", r
                blobs_s1 = set(os.listdir(repo / "blobs"))
                for n in (a, b):
                    wait_for(lambda n=n: pair.drained(n), f"{n.name}'s warmer drained")
                deleted_packs = primary_packs((a, b), index, device)
                resident = sum(pair.resident(n) for n in (a, b))
                before = pair.allocated(recorder.held_bytes)
                st, r = http_json(conn, "DELETE", f"/{index}")
                assert st == 200 and r["acknowledged"], r
                wait_for(lambda: all(index not in n.indices.indices for n in (a, b)),
                         "the index removed on both nodes")
                after_delete = pair.allocated(recorder.held_bytes)
                released = before - after_delete
                hold_restore_swaps((a, b))
                st, r = http_json(conn, "POST", "/_snapshot/backup/s1/_restore")
                assert st == 200 and r["snapshot"]["indices"] == [index], r
                st, r = http_json(conn, "GET", f"/_cluster/health/{index}"
                                  "?wait_for_status=green&timeout=60s")
                assert st == 200 and r["status"] == "green", r
            finally:
                conn.close()
            got, _l, _w = send(ports[names[0]], bodies, pref="_primary")
            ok_hits(got, refs, "restored")
            for n in (a, b):
                wait_for(lambda n=n: pair.drained(n), f"{n.name}'s warmer drained")
            restored_packs = primary_packs((a, b), index, device)
            assert sorted(restored_packs) == sorted(deleted_packs), \
                (sorted(restored_packs), sorted(deleted_packs))
            pack_diffs = {k: bad for k in deleted_packs
                          if (bad := packs_equal(deleted_packs[k], restored_packs[k]))}
            assert not pack_diffs, pack_diffs
            packs_compared = len(deleted_packs)
            del deleted_packs, restored_packs
            restored_resident = sum(pair.resident(n) for n in (a, b))
            rose = pair.allocated(recorder.held_bytes) - after_delete
            if on_card:
                check(0.99 * resident <= released <= 1.01 * resident,
                      "(e) the delete gives back the resident bytes", resident, released)
                check(0.99 * restored_resident <= rose <= 1.01 * restored_resident,
                      "(e) the restore takes the restored resident bytes",
                      restored_resident, rose)
            state = a.cluster_service.state
            per_shard = {}
            for sid in range(NODE_SHARDS):
                per_shard[sid] = a.client().search(
                    index, {"size": 0}, preference=f"_shards:{sid};_primary")["hits"]["total"]
            kept = {n: sum(per_shard[s.shard_id] for s in
                           state.routing_table.index(index).all_shards()
                           if s.primary and s.node_id == n) for n in names}
            counts = {n: a.client().search(index, {"size": 0},
                                           preference=f"_only_node:{n}")["hits"]["total"]
                      for n in names}
            check(counts == kept and sum(per_shard.values()) == n_docs,
                  "(e) each node's count the kept behaviour's", counts, kept, per_shard)
            conn = http.client.HTTPConnection("127.0.0.1", ports[names[0]], timeout=300)
            try:
                st, r = http_json(conn, "PUT", "/_snapshot/backup/s2", {"indices": index})
                assert st == 200 and r["snapshot"]["state"] == "SUCCESS", r
            finally:
                conn.close()
            s2 = json.loads((repo / "snapshots" / "s2.json").read_text())
            s2_files = [blob for sh in s2["indices"][index]["shards"].values()
                        for blob in sh["files"].values()]
            s2_segs = [f for f in s2_files if "_seg_" in f]
            reused = [f for f in s2_files if f in blobs_s1]
            assert s2_segs and set(s2_segs) <= blobs_s1, (s2_segs, sorted(blobs_s1))
            out["snapshot"] = dict(resident=resident, released=released,
                                   restored_resident=restored_resident, rose=rose,
                                   packs_compared=packs_compared,
                                   counts=counts, kept=kept, per_shard=per_shard,
                                   s1_blobs=len(blobs_s1), s2_files=len(s2_files),
                                   s2_reused=len(reused), s2_segment_files=len(s2_segs))
            done("snapshot_restore", t0)
            launches = cudaenv.LAUNCHES.snapshot()
        by_node, syncs = pair.snapshot(), pair.syncs
        batches = {n.name: n.search_batcher.stats()["launches"] - batches0[n.name]
                   for n in (a, b)}
        assert SERVING_COUNTERS["device_errors"] == errors0
        for name in names:
            # one launch a batch (one segment a shard, one bucket), but for a
            # batch whose queries found no block of their terms in the shard
            assert by_node[name]["waits"] == batches[name] > 0, (name, by_node, batches)
            assert by_node[name]["launches"] + by_node[name]["unlaunched"] == \
                batches[name], (name, by_node, batches, by_step)
        assert syncs == 0 and by_node["other"]["launches"] == 0, (syncs, by_node)
        if on_card:
            assert launches.get("sparse_score", 0) - out["slow"]["profiled_launches"] == \
                sum(by_node[n]["launches"] for n in names), (launches, by_node)
        wait_for(lambda: not a.actions._pinned and not b.actions._pinned,
                 "no context pinned", timeout=30)
        assert not failed, f"phase 28: {len(failed)} checks failed: {failed}"
        t0 = time.perf_counter()
        max_err = check_shapes(recorder.shapes)
        shapes = [dict(Qb=int(args[0].shape[0]), TB=int(args[0].shape[1]),
                       tf=str(args[10].dtype), k=kwargs["k"], launches=n)
                  for _key, (args, kwargs, n) in recorder.shapes.items()]
        done("kernel_checks", t0)
        out.update(card=card, docs=n_docs, warm_chunks=warm_chunks, warm_ewma_ms=warm_ewma,
                   by_node=by_node, batches=batches, launches=launches,
                   kernel_shapes=shapes, kernel_max_abs_err=max_err, steps_s=steps)
        h, s, rc, af, afc, sn = (out[k] for k in ("healthy", "slow", "recovery", "affinity",
                                                   "affinity_concurrent", "snapshot"))
        log(f"[28] two nodes on {device} over TCP, master {names[0]}: `{index}` "
            f"{n_docs} docs, 5 shards, flushed, then 1 replica (recovered from the "
            f"flush); warmed in {warm_chunks} chunks to EWMAs "
            f"{min(warm_ewma.values()):.2f}-{max(warm_ewma.values()):.2f} ms; {card}")
        log(f"[28] (a) healthy: {n_leg} bodies from {n_conn} connections: "
            f"{h['requests_per_s']:.1f} requests/s, p50 {h['p50_ms']:.2f} ms, p95 "
            f"{h['p95_ms']:.2f} ms, p99 {h['p99_ms']:.2f} ms; query phases {h['phases']} "
            f"(shares {', '.join(f'{k} {v:.3f}' for k, v in h['share'].items())}); "
            f"hits bitwise the `_primary` reference")
        log(f"[28] (b) {names[1]}'s received query phases delayed {delay_s} s "
            f"({s['delayed']} delayed): {s['requests_per_s']:.1f} requests/s, p50 "
            f"{s['p50_ms']:.2f} ms, p95 {s['p95_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms; "
            f"query phases {s['phases']} ({names[1]}'s share {s['share']:.3f}); hedges "
            f"issued {s['hedges_issued']}, won {s['hedges_won']}, budget exhausted "
            f"{s['budget_exhausted']} for {s['primary_attempts']} primary attempts; "
            f"hits bitwise; {n_profiled} profiled with `_prefer_node:{names[1]}`: "
            f"winners {s['winners']}")
        rr = s["round_robin"]
        log(f"[28] (b) shard phases p50 {s['phase_p50_ms']:.2f} ms, p95 "
            f"{s['phase_p95_ms']:.2f} ms; request mean {s['mean_ms']:.2f} ms; the leg's "
            f"selections {s['selections']}; share of requests over the delay "
            f"{s['over_delay']}; round-robin under the same fault ({rr['requests']} "
            f"bodies, measured): request mean {rr['mean_ms']:.2f} ms, p50 "
            f"{rr['p50_ms']:.2f} ms, p95 {rr['p95_ms']:.2f} ms, shard phases p50 "
            f"{rr['phase_p50_ms']:.2f} ms, p95 {rr['phase_p95_ms']:.2f} ms, "
            f"{names[1]}'s share {rr['share']:.3f}, hedges issued {rr['hedges_issued']}")
        og = out["one_group"]
        log(f"[28] (b) one group (`_shards:0`), one connection, as the JAX chaos test: "
            f"healthy p99 {og['healthy_p99_ms']:.2f} ms; {og['requests']} requests under "
            f"the delay: p50 {og['p50_ms']:.2f} ms, p95 {og['p95_ms']:.2f} ms, max "
            f"{og['max_ms']:.2f} ms, query phases {og['phases']}, hedges issued "
            f"{og['hedges_issued']}, won {og['hedges_won']}")
        log(f"[28] (c) fault cleared: {names[1]}'s copies selected {rc['picks']} in "
            f"chunks of {chunk}; rejoined in chunk {rc['chunks']}, {rc['probes']} probes")
        for leg in (af, afc):
            recorded = (f"; {leg['narrowed']} affinity picks from a spread set of one "
                        f"copy, {leg['wrong']} not the rendezvous winner"
                        if leg["recorded"] else "")
            log(f"[28] (d) {leg['bodies']} `size: 0` bodies x {ADAPT_PASSES} from "
                f"{leg['conn']} connection(s): selections {leg['by_kind']} (by pass "
                f"{leg['kinds_by_pass']}{recorded}), "
                f"{leg['spread']} of {leg['pairs']} (body, shard) pairs on two copies; by "
                f"pass: request-cache hits {leg['hits_by_pass']}, revisits "
                f"{leg['revisits_by_pass']}, first visits {leg['new_visits_by_pass']}, "
                f"sparse_score launches {leg['launches_by_pass']}")
        log(f"[28] (e) snapshot s1 ({sn['s1_blobs']} blobs), DELETE: resident "
            f"{sn['resident']} B, memory_allocated() fell {sn['released']} B"
            + (f" ({sn['released'] / sn['resident']:.4f} of it)" if sn['resident'] else "")
            + f"; restored, green, {n_refs} `_primary` bodies bitwise, the primaries' "
            f"{sn['packs_compared']} packs == the deleted ones; resident {sn['restored_resident']} B, memory_allocated() rose "
            f"{sn['rose']} B"
            + (f" ({sn['rose'] / sn['restored_resident']:.4f} of it)"
               if sn['restored_resident'] else "")
            + f"; `_only_node` `_count` {sn['counts']} == the kept behaviour's "
            f"{sn['kept']} (primaries per shard {sn['per_shard']}); s2: {sn['s2_reused']} "
            f"of {sn['s2_files']} files reused, every one of its {sn['s2_segment_files']} "
            f"segment files")
        for name in names:
            log(f"[28]   {name}: {by_node[name]['launches']} sparse_score launches, "
                f"{batches[name]} batches ({by_node[name]['unlaunched']} of them found no "
                f"block to score), {by_node[name]['waits']} PendingPull.wait calls; "
                f"torch.cuda.synchronize calls {syncs}")
        for sh in shapes:
            log(f"[28]   sparse_score Qb {sh['Qb']} TB {sh['TB']} {sh['tf']} k {sh['k']}: "
                f"{sh['launches']} launches")
        log(f"[28] sparse_score == plain (bitwise) at all {len(shapes)} shapes phase 28 "
            f"launched; max abs err {max_err}")
        out["wall_phase_s"] = time.perf_counter() - t_phase
        log(f"[28] phase 28 took {out['wall_phase_s']:.1f} s; by step (s): "
            + ", ".join(f"{k} {v:.1f}" for k, v in steps.items()))
        return out
    finally:
        if tally is not None:
            tally.close()
        if pair.nodes:
            FaultPolicy.uninstall(pair.nodes[-1].transport)
        if recorder is not None:
            recorder.close()
        pair.close()
        shutil.rmtree(root, ignore_errors=True)


def small_sources(n_docs: int, seed: int) -> list[dict]:
    """Phase 7's documents: a zipf(1.1) text over 400 words, a short title
    and a body of 10-120 words each."""
    rng = np.random.default_rng(seed)
    words = [f"word{i}" for i in range(400)]
    p = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    p /= p.sum()

    def text(n):
        return " ".join(rng.choice(words, n, p=p))

    return [{"title": text(int(rng.integers(2, 8))),
             "body": text(int(rng.integers(10, 120)))} for _ in range(n_docs)]


SMALL_BODIES = [
    {"match": {"body": "word1 word7 word30"}},
    {"match": {"body": {"query": "word2 word5", "operator": "and"}}},
    {"match": {"body": {"query": "word3 word9 word40 word77",
                        "minimum_should_match": "75%"}}},
    {"match": {"title": {"query": "word4 word11", "boost": 2.0}}},
    {"bool": {"must": [{"match": {"body": "word6"}}],
              "should": [{"term": {"body": "word8"}}, {"match": {"title": "word12"}}],
              "must_not": [{"term": {"body": "word13"}}]}},
    {"bool": {"should": [{"term": {"body": "word14"}}, {"term": {"body": "word15"}},
                         {"term": {"title": "word16"}}],
              "minimum_should_match": 2}},
    {"match": {"_all": "word17 word18"}},
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--vocab", type=int, default=200_000)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--bool-batch", type=int, default=256)
    ap.add_argument("--check", type=int, default=64,
                    help="queries per batch kind held against the reference scorer")
    ap.add_argument("--small-docs", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--node-docs", type=int, default=NODE_DOCS,
                    help="phase 10: docs bulked into the node")
    ap.add_argument("--node-requests", type=int, default=NODE_REQUESTS,
                    help="phase 10: _search requests in the timed run")
    ap.add_argument("--report", help="also write the full report as JSON here")
    ap.add_argument("--sticky-child", help=argparse.SUPPRESS)  # phase 15 (b)'s child
    ap.add_argument("--restart-child", help=argparse.SUPPRESS)  # ... and its restart
    ap.add_argument("--locktrace-child", help=argparse.SUPPRESS)  # phase 25 (d)'s child
    ap.add_argument("--two-node-ref-child", help=argparse.SUPPRESS)  # phase 26's reference
    args = ap.parse_args()
    if args.two_node_ref_child:
        two_node_ref_child(args.two_node_ref_child)
        return 0
    if args.locktrace_child:
        locktrace_child(args.locktrace_child)
        return 0
    if args.sticky_child:
        sticky_child(args.sticky_child)  # leaves with os._exit
    if args.restart_child:
        restart_child(args.restart_child)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs the card",
              file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent
    if not (here / "elasticsearch_tpu_torch").is_dir() or shutil.which("nvidia-smi") is None:
        print("chip_smoke: run from a checkout of the repository on a machine "
              "with nvidia-smi", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    report = run(torch.device("cuda", 0), n_docs=args.docs, vocab=args.vocab,
                 n_batches=args.batches, batch=args.batch,
                 bool_batch=args.bool_batch, n_check=args.check, seed=args.seed,
                 small_docs=args.small_docs, node_docs=args.node_docs,
                 node_requests=args.node_requests)
    report["wall_s"] = time.perf_counter() - t0
    log(f"[8] every number above: {report['card']}; wall {report['wall_s']:.1f} s")
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": report["kernels"]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
