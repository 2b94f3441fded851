#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--docs N] [--vocab V] [--batches B] [--batch Q]
                          [--node-docs N] [--node-requests R] [--report PATH]

Drives the port's main path — the shard query phase of batched BM25
bool-of-terms search, top-100 per query — through its public entry points
(`ShardContext` → `search_shard_batch`) at the data size of a real shard,
then the serving path — concurrent single requests through
`parse_search_body` → `execute_query_phase` → the `DeviceBatcher` — then a
port `Node` serving REST `_bulk` and `_search` over HTTP, and holds every
hand-written kernel of those paths against its plain torch version on the
card. Phases:

  1. card facts (nvidia-smi, torch / CUDA / nvcc versions), build the kernels
     from `elasticsearch_tpu_torch/csrc` (one nvcc per source, all at once);
  2. a zipf(1.35) CSR corpus of 1,000,000 docs over a 200k-term vocabulary
     (about 60 terms a doc, one text field), split into 3 segments of
     600k / 300k / 100k docs, 1% of one segment tombstoned, packed on the card;
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
     `refresh_interval: -1`; 200,000 docs
     (phase 2's generator rendered as tokens `t<rank>`) in `_bulk` requests
     of 1,000 through the host analyzer into each shard's durable Engine,
     then `_refresh`; 4,096 `_search` requests (phase 3's 4-term `bool` of
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
 11. mixed traffic on phase 10's node and index: 2,048 `_search` requests
     from the same 64 connections in a seeded random order, half phase 3's
     4-term `bool` (the card's sparse path through the node's batcher), half
     bodies the host scorer serves, a sixth each: `match_phrase` of two
     adjacent tokens of a corpus doc; `bool` of a `must` term with a
     `filter` of 20 `terms` (df ranks 20-400); `filtered`: phase 3's `bool`
     with such a `terms` filter; `constant_score` over a 4-character
     `prefix` (`t` and 3 digits, ~111 terms); no query (match_all) with a
     `post_filter` term (df ranks 20-400); phase 3's `bool` with `min_score`
     at half its own top score (the port's host search, before the clock).
     The whole timed run under `set_sync_debug_mode("error")`. Every
     response's total, ids, scores and shards equal each shard's host query
     phase (`execute_query_phase(..., use_device=False)`) reduced by score
     desc, shard, doc: bitwise for the host half; for the card's half the
     same order within 2 ulp, tie-tolerant (the share that is bitwise is
     printed), and bitwise against each shard's `search_shard_batch`. The
     totals of the filter families equal exact numpy counts; the serving
     counters show 5 host shard phases a host request and 5 sparse ones a
     device request, and no device error; the kernel is bitwise equal to
     its plain version at every shape phase 11 launched. Requests/s of the
     mix, p50/p99 by family, the node's CPU seconds by thread kind and the
     device's idle share over a profiled window.

Every phase asserts. The line before the last holds the kernels' JSON record;
the last line is `{"ok": true, "device": {...}}`, printed only when every
phase passed. Without CUDA the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import threading
import time
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
NODE_DOCS, NODE_REQUESTS, NODE_CALLERS = 200_000, 4096, 64  # phase 10's load and traffic
NODE_BULK, NODE_SIZE, NODE_SHARDS = 1000, 10, 5  # docs a _bulk, hits a request, shards
NODE_PROFILED = 512  # requests in phase 10's profiled window
MIXED_REQUESTS = 2048  # phase 11's traffic: half the card's, half the host's
MIXED_HOST = ("phrase", "bool_filter", "filtered", "prefix", "post_filter", "min_score")
FILTER_TERMS = 20  # terms of phase 11's `terms` filters, df ranks BOOL_RANKS
SERVE_SIZES = (10, 100)  # phase 9: half the requests each, k buckets 16 and 128
SERVE_PROFILED = 1024  # requests in phase 9's profiled window
SPIN_CYCLES = 40_000_000  # phase 9's stand-in for batch N+1: ~20 ms at ~2 GHz
TB_MAX = 512  # ops/scoring.py launch_flat_sparse: past it a query takes the dense path
ULPS = 2  # the dense path's scatter-add order is not fixed (tests/test_torch_dense.py)

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


def log(*parts) -> None:
    print(*parts, flush=True)


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
    of one chosen batch. It launches nothing itself and counts nothing."""

    def __init__(self, scoring_module, sparse_score):
        self.shapes: dict = {}  # shape key -> (args, kwargs, launches)
        self.batch: list | None = None
        self._orig = sparse_score
        self._module = scoring_module

        def recording(*args, **kwargs):
            key = (tuple(args[0].shape), str(args[10].dtype), kwargs["k"],
                   kwargs["passes"], kwargs["simple"], kwargs["use_coord"])
            entry = self.shapes.setdefault(key, [args, kwargs, 0])
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
        mixed_requests: int = MIXED_REQUESTS) -> dict:
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
    segs = []
    for g, s in enumerate(csr):
        n = s["hi"] - s["lo"]
        segs.append(segment_from_arrays(
            term_dict, s["offsets"], s["docs"], s["freqs"],
            {"body": encode_norm(s["lengths"])},
            {"body": {"doc_count": n, "sum_ttf": int(s["lengths"].sum()),
                      "sum_dfs": len(s["docs"])}},
            np.ones(n, bool), np.ones(n, bool), gen=g))
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
        f"{report['segments']} docs/segment, {len(dead)} tombstones; corpus "
        f"{report['corpus_s']:.1f} s, pack {report['pack_s']:.1f} s; resident "
        f"{resident / 1e9:.3f} GB over {slots} slots "
        f"({resident / max(slots, 1):.2f} B/slot), tf {report['tf_layouts']}")

    def context(settings: dict, dev) -> ShardContext:
        svc = MapperService(Settings.from_flat(settings))
        svc.put_mapping("doc", {"properties": {"body": {"type": "string"}}})
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
        overflow = sum(len(sub) for (_s, _b, _p, _l, dense) in pending.seg_work
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
                      mixed_requests=mixed_requests)
    report["node"] = node

    report["kernels"] = [dict(
        name="sparse_score", **KERNELS["sparse_score"],
        launches=main_launches.get("sparse_score", 0), max_abs_err=max_err,
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        node_launches=node["launches"].get("sparse_score", 0),
        node_max_abs_err=node["kernel_max_abs_err"],
        mixed_launches=node["mixed"]["launches"].get("sparse_score", 0),
        mixed_max_abs_err=node["mixed"]["kernel_max_abs_err"])]
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
    # a (query, segment) pair past tb_max takes the dense path, whose
    # scatter-add order is not fixed: those queries are held within ULPS
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
    from elasticsearch_tpu_torch.search.execute import (
        _result_tensors, dispatch_flat_batch, lower_flat)

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
        cudaenv.pull(_result_tensors(pending.seg_work))
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
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=(1.0 - busy / wall_ms) if busy else None, top=rows[:12])


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


def http_clients(port: int, bodies: list, n_callers: int, pipe) -> None:
    """Phase 10's HTTP clients, in a process of their own (a search front
    end's connections do not share the node's interpreter): `n_callers`
    threads, each on its own keep-alive connection, send `bodies` as `POST
    /corpus/_search` back to back (caller c sends bodies c, c + n_callers,
    ...). On `pipe`: sends "connected" once every connection is open, waits
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
                    responses[i] = http_json(conn, "POST", "/corpus/_search", bodies[i])
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


def serve_http(port: int, bodies: list, n_callers: int, sync_error: bool):
    """Run `http_clients` in a process of its own against the node on
    `port`. Returns (responses, per-request ms, wall s, errors, the node
    process's CPU s by thread kind over the run: read while every connection
    and its server thread is still open)."""
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
               n_callers: int, mixed_requests: int = MIXED_REQUESTS) -> dict:
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
            assert r["_shards"] == {"total": NODE_SHARDS, "successful": NODE_SHARDS,
                                    "failed": 0}, (i, r["_shards"])
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
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _r, _l, pwall_s, perrors, _cpu = serve_http(
                    port, bodies[:NODE_PROFILED], n_callers, sync_error=False)
            assert not perrors, perrors[:3]
            out["profiled"] = device_busy(prof, pwall_s * 1e3)
            out["profiled"]["batches"] = node.search_batcher.stats()["launches"] - before
            p = out["profiled"]
            if p["device_busy_ms"]:
                log(f"[10] profiled window of {NODE_PROFILED} requests: wall "
                    f"{p['wall_ms']:.2f} ms, device busy {p['device_busy_ms']:.3f} ms, "
                    f"idle share {p['idle_share']:.4f}, {p['batches']} batches")
                for name, ms, n in p["top"]:
                    log(f"[10]   {ms:9.3f} ms {n:5d}x {name}")
            else:
                log("[10] profiled window: the profiler saw no device time "
                    "(device idle share not measured)")
        out["mixed"] = mixed_phase(
            device, node, port, texts=texts, offsets=offsets, inv_docs=inv_docs,
            searchers=searchers, seed=seed + 2, n_requests=mixed_requests,
            n_callers=n_callers)
        return out
    finally:
        if recorder is not None:
            recorder.close()
        node.close()
        shutil.rmtree(data_path, ignore_errors=True)


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
        cudaenv.LAUNCHES.reset()
        responses, lat_ms, wall_s, errors, host_cpu = serve_http(
            port, bodies, n_callers, sync_error=on_card)
        launches = cudaenv.LAUNCHES.snapshot()
        counted = {k: SERVING_COUNTERS[k] - before[k] for k in SERVING_COUNTERS}
    finally:
        recorder.close()

    # correctness, before any time is kept
    assert not errors, f"{len(errors)} requests failed, first {errors[:3]}"
    n_device = int((families == "device").sum())
    n_host = n_requests - n_device
    assert counted == {"device_sparse": NODE_SHARDS * n_device, "device_errors": 0,
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
    for i, ((st, r), (family, body, total)) in enumerate(zip(responses, traffic)):
        assert st == 200, (i, family, r)
        assert r["_shards"] == {"total": NODE_SHARDS, "successful": NODE_SHARDS,
                                "failed": 0}, (i, family, r["_shards"])
        ref_total, entries, _top = host_reference(ctxs, body)
        assert r["hits"]["total"] == ref_total, (i, family, r["hits"]["total"], ref_total)
        if total is not None:
            assert ref_total == total, f"request {i} ({family}): total != exact {total}"
        got = [(h["_score"], (h["_id"], h["_shard"])) for h in r["hits"]["hits"]]
        want = [(score, (ident(sid, doc), sid)) for score, sid, doc in entries]
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
    out = dict(requests=n_requests, callers=n_callers, wall_s=wall_s,
               requests_per_s=n_requests / wall_s, latency_by_family=by_family,
               serving_counters=counted, launches=launches, host_cpu_s=host_cpu,
               device_bitwise_share=exact_device / max(n_device, 1),
               kernel_shapes=len(recorder.shapes), kernel_max_abs_err=max_err,
               card=card,
               sync_debug="error over the whole timed run" if on_card else None)
    log(f"[11] mixed traffic on the node: {n_requests} _search requests from "
        f"{n_callers} connections, {n_device} to the card, {n_host} to the host "
        f"scorer: {out['requests_per_s']:.1f} requests/s ({wall_s:.2f} s); {card}")
    for family, v in by_family.items():
        log(f"[11]   {family:11s} {v['requests']:5d} requests: p50 {v['p50_ms']:.2f} ms, "
            f"p99 {v['p99_ms']:.2f} ms; {card}")
    log(f"[11] every response == the shards' host query phases reduced (host half "
        f"bitwise; card half within {ULPS} ulp, tie-tolerant, "
        f"{out['device_bitwise_share']:.4f} of it bitwise, and bitwise == "
        f"search_shard_batch); filter-family totals == exact counts; serving "
        f"counters {counted}; launches {launches}")
    log(f"[11] host CPU s over the {wall_s:.2f} s timed run, by thread kind: "
        + ", ".join(f"{k} {v:.2f} ({v / wall_s:.3f} of wall)" for k, v in host_cpu.items())
        + f"; {card}")
    log(f"[11] sparse_score == plain (bitwise) at all {len(recorder.shapes)} shapes "
        f"phase 11 launched; max abs err {max_err}")
    if on_card:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _r, _l, pwall_s, perrors, _cpu = serve_http(
                port, bodies[:NODE_PROFILED], n_callers, sync_error=False)
        assert not perrors, perrors[:3]
        out["profiled"] = p = device_busy(prof, pwall_s * 1e3)
        if p["device_busy_ms"]:
            log(f"[11] profiled window of {NODE_PROFILED} mixed requests: wall "
                f"{p['wall_ms']:.2f} ms, device busy {p['device_busy_ms']:.3f} ms, "
                f"idle share {p['idle_share']:.4f}; {card}")
        else:
            log("[11] profiled window: the profiler saw no device time "
                "(device idle share not measured)")
    return out


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
    args = ap.parse_args()

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
