#!/usr/bin/env python3
"""Measurements of a port node, and of one of its device steps, on one
NVIDIA card, for one tree of the repository, so that two trees can be
compared in one call to the card:

    python3 chip_probe.py coordinator [--tree DIR] [--out PATH]
    python3 chip_probe.py dense-repeat [--tree DIR] [--out PATH]
    python3 chip_probe.py accumulate [--out PATH]

`--tree DIR` imports `elasticsearch_tpu_torch` and `chip_smoke` from DIR
(an unpacked `git archive` of another commit, say) instead of this
checkout. Run the trees alternately (A, B, B, A) in one call and compare
within it: the card's host differs from call to call.

- `coordinator`: phase 10 of `chip_smoke.py` at its size (50,000 of its
  texts bulked over HTTP into 5 shards of one node, 512 of its `bool`
  bodies from 64 connections, `--reps` timed runs after a warm-up), then a
  request-cache pass on the same index (`--cache-bodies` of those bodies
  at `size: 0`, sent once to store each shard's answer, then `--reps`
  timed passes answered from every shard's cache with no launch). Prints
  and writes requests/s and p50/p99 of each run.
- `dense-repeat`: phase 21 (b)'s `fetch_small` shape (2,000 of phase 10's
  texts with a keyword tag, 3 shards, BM25, a refresh after the bulk and
  after each of two later writes) and its literal `filtered` body (a
  3-word `match` under a `terms` filter of 5 tags, which the card's dense
  family serves), sent `--repeats` times one after another and
  `--repeats` times from 16 connections, `request_cache: false`. Prints
  and writes how many distinct hits JSON came back and the largest score
  difference from the first answer in units in the last place.
- `accumulate`: the dense family's float32 accumulation alone
  (`ops/scoring.py _dense_accumulate`) at 10^5, 10^6 and 10^7
  contributions in 4 clause slots into 256 rows of 100,000 docs: one
  `index_add_` (atomics, in no fixed order), one `index_add_` a slot (what
  the port runs on the card) and `index_put_` with `accumulate` (a sort),
  ms by CUDA events (median of 20 after 3 warm-ups), and whether each
  gives the same sums twice.

Each run prints the card's name and power limit. It exits 2 without CUDA
(`--device cpu` rehearses the steps on the CPU at a small size).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from pathlib import Path


def _setup(tree: str | None):
    if tree:
        sys.path.insert(0, str(Path(tree).resolve()))
    else:
        sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke

    return chip_smoke


def _node(cs, work: Path, device: str):
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.transport.local import LocalTransportRegistry

    shutil.rmtree(work, ignore_errors=True)
    return Node(name="probe", registry=LocalTransportRegistry(), data_path=str(work),
                settings={"node.device": device}).start()


def _rate(lat_ms, wall_s, n) -> dict:
    import numpy as np

    return dict(requests_per_s=n / wall_s, p50_ms=float(np.percentile(lat_ms, 50)),
                p99_ms=float(np.percentile(lat_ms, 99)), wall_s=wall_s)


def coordinator(cs, args, work: Path) -> dict:
    import http.client

    import numpy as np

    texts, offsets, _inv = cs.node_corpus(args.docs, args.vocab, args.seed)
    ranked = np.argsort(-np.diff(offsets), kind="stable")
    rng = np.random.default_rng(args.seed + 1)
    rows = rng.choice(ranked[cs.RANKS[0]: cs.RANKS[1]],
                      size=(args.requests, cs.TERMS_PER_QUERY))
    bodies = [{"query": {"bool": {"should": [{"term": {"body": cs.term_name(int(t))}}
                                             for t in row]}}, "size": cs.NODE_SIZE}
              for row in rows]
    node = _node(cs, work, args.device)
    try:
        port = node.start_http(0).port
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        st, r = cs.http_json(conn, "PUT", "/corpus", {"settings": {"refresh_interval": -1}})
        assert st == 200, r
        t0 = time.perf_counter()
        for lo in range(0, args.docs, cs.NODE_BULK):
            lines = []
            for i in range(lo, min(lo + cs.NODE_BULK, args.docs)):
                lines.append(json.dumps({"index": {"_index": "corpus", "_type": "doc",
                                                   "_id": str(i)}}))
                lines.append(json.dumps({"body": texts[i]}))
            st, r = cs.http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
            assert st == 200 and not r["errors"], r.get("items", [])[:2]
        assert cs.http_json(conn, "POST", "/corpus/_refresh")[0] == 200
        bulk_s = time.perf_counter() - t0
        conn.close()
        warm = cs.serve_http(port, bodies[: 2 * args.callers], args.callers,
                             sync_error=False)
        assert not warm[3], warm[3][:3]
        out = dict(bulk_s=bulk_s, serve=[], cache_hit=[])
        for _ in range(args.reps):
            resp, lat, wall, errors, _cpu = cs.serve_http(port, bodies, args.callers,
                                                         sync_error=False)
            assert not errors and all(st == 200 for st, _r in resp), errors[:3]
            out["serve"].append(_rate(lat, wall, len(bodies)))
        cached = [{"query": b["query"], "size": 0} for b in bodies[: args.cache_bodies]]
        first, _l, _w, errors, _c = cs.serve_http(port, cached, min(args.callers, 16),
                                                  sync_error=False)
        assert not errors
        stats0 = node.request_cache.stats()
        for _ in range(args.reps):
            resp, lat, wall, errors, _cpu = cs.serve_http(port, cached,
                                                         min(args.callers, 16),
                                                         sync_error=False)
            assert not errors and [r["hits"] for _s, r in resp] == \
                [r["hits"] for _s, r in first], errors[:3]
            out["cache_hit"].append(_rate(lat, wall, len(cached)))
        stats1 = node.request_cache.stats()
        assert stats1["hits"] - stats0["hits"] == \
            args.reps * len(cached) * cs.NODE_SHARDS, (stats0, stats1)
        assert stats1["misses"] == stats0["misses"], (stats0, stats1)
        return out
    finally:
        node.close()


def _ulps(a: float, b: float) -> int:
    import numpy as np

    ia = int(np.float32(a).view(np.int32))
    ib = int(np.float32(b).view(np.int32))
    return abs(ia - ib)


def dense_repeat(cs, args, work: Path) -> dict:
    import http.client
    from concurrent.futures import ThreadPoolExecutor

    texts, _off, _inv = cs.node_corpus(args.corpus_docs, args.vocab, args.seed)
    node = _node(cs, work, args.device)
    try:
        port = node.start_http(0).port
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        st, r = cs.http_json(conn, "PUT", "/dense", {
            "settings": {"number_of_shards": 3, "refresh_interval": -1,
                         "index": {"similarity": {"default": {"type": "BM25"}}}},
            "mappings": {"doc": {"properties": {
                "body": {"type": "string"},
                "tag": {"type": "string", "index": "not_analyzed"}}}}})
        assert st == 200, r
        docs = [{"body": texts[i], "tag": texts[i].split()[0]} for i in range(args.docs)]
        lines = []
        for i, d in enumerate(docs):
            lines += [json.dumps({"index": {"_index": "dense", "_type": "doc",
                                            "_id": str(i)}}), json.dumps(d)]
        st, r = cs.http_json(conn, "POST", "/_bulk", ndjson="\n".join(lines) + "\n")
        assert st == 200 and not r["errors"]
        assert cs.http_json(conn, "POST", "/dense/_refresh")[0] == 200
        w = texts[7].split()
        for doc_id, body in (("extra1", w[1]), ("extra2", w[3])):
            assert cs.http_json(conn, "PUT", f"/dense/doc/{doc_id}",
                                {"body": body, "tag": "extra"})[0] == 201
            assert cs.http_json(conn, "POST", "/dense/_refresh")[0] == 200
        tags = sorted({d["tag"] for d in docs[:40]})[:5]
        body = {"query": {"filtered": {"query": {"match": {"body": " ".join(w[2:5])}},
                                       "filter": {"terms": {"tag": tags}}}},
                "request_cache": False}
        st, first = cs.http_json(conn, "POST", "/dense/_search", body)
        assert st == 200 and first["hits"]["total"] > 0, first

        def compare(answers) -> dict:
            distinct = {json.dumps(a["hits"], sort_keys=True) for a in answers}
            worst = 0
            ref = {(h["_shard"], h["_id"]): h["_score"] for h in first["hits"]["hits"]}
            for a in answers:
                for h in a["hits"]["hits"]:
                    key = (h["_shard"], h["_id"])
                    if key in ref:
                        worst = max(worst, _ulps(h["_score"], ref[key]))
            return dict(answers=len(answers),
                        differ_from_first=sum(a["hits"] != first["hits"] for a in answers),
                        distinct=len(distinct), max_ulps_same_doc=worst)

        seq = []
        for _ in range(args.repeats):
            st, r = cs.http_json(conn, "POST", "/dense/_search", body)
            assert st == 200
            seq.append(r)
        conn.close()

        def one(_i):
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            try:
                st, r = cs.http_json(c, "POST", "/dense/_search", body)
                assert st == 200
                return r
            finally:
                c.close()

        with ThreadPoolExecutor(16) as ex:
            conc = list(ex.map(one, range(args.repeats)))
        return dict(total=first["hits"]["total"], sequential=compare(seq),
                    concurrent=compare(conc))
    finally:
        node.close()


def accumulate(cs, args, work: Path) -> dict:
    import numpy as np
    import torch

    dev = torch.device(args.device)
    rows, docs, n_slots = 256, 100_000, 4
    out = {}
    for n in (10**5, 10**6, 10**7):
        # n contributions in n_slots slots, no cell twice inside a slot (a
        # clause's postings: one doc once), as the dense family's rows
        rng = np.random.default_rng(args.seed + n)
        per = n // n_slots
        idx = torch.from_numpy(np.concatenate(
            [rng.choice(rows * docs, per, replace=False) for _ in range(n_slots)])).to(dev)
        vals = torch.from_numpy(rng.random(per * n_slots, dtype=np.float32)).to(dev)
        bounds = [j * per for j in range(n_slots + 1)]

        def one():
            z = torch.zeros(rows * docs, dtype=torch.float32, device=dev)
            return z.index_add_(0, idx, vals)

        def by_slot():
            z = torch.zeros(rows * docs, dtype=torch.float32, device=dev)
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                z.index_add_(0, idx[lo:hi], vals[lo:hi])
            return z

        def put():
            z = torch.zeros(rows * docs, dtype=torch.float32, device=dev)
            return z.index_put_((idx,), vals, accumulate=True)

        row = {}
        for name, fn in (("index_add_", one), ("index_add_by_slot", by_slot),
                         ("index_put_accumulate", put)):
            same = bool(torch.equal(fn(), fn()))
            ms = None
            if dev.type == "cuda":
                for _ in range(3):
                    fn()
                times = []
                for _ in range(20):
                    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    t0.record()
                    fn()
                    t1.record()
                    t1.synchronize()
                    times.append(t0.elapsed_time(t1))
                ms = float(np.median(times))
            row[name] = dict(ms=ms, same_twice=same)
        out[str(n)] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("coordinator", "dense-repeat", "accumulate"))
    ap.add_argument("--tree", help="import the port and chip_smoke from this tree")
    ap.add_argument("--out", help="also write the result as JSON here")
    ap.add_argument("--docs", type=int)
    ap.add_argument("--corpus-docs", type=int, default=50_000)
    ap.add_argument("--vocab", type=int, default=200_000)
    ap.add_argument("--seed", type=int, default=1243)  # phase 10's: run()'s seed + 9
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--callers", type=int, default=64)
    ap.add_argument("--cache-bodies", type=int, default=64)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=200)
    ap.add_argument("--device", default="cuda:0",
                    help="`cpu` rehearses the steps at a small size (no card numbers)")
    args = ap.parse_args()
    cs = _setup(args.tree)
    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("chip_probe.py: no CUDA device", file=sys.stderr)
        return 2
    work = Path(__file__).resolve().parent / "build" / f"chip_probe_{os.getpid()}"
    t0 = time.perf_counter()
    try:
        if args.what == "coordinator":
            args.docs = args.docs or cs.NODE_DOCS
            out = coordinator(cs, args, work)
        elif args.what == "dense-repeat":
            args.docs = args.docs or 2000
            out = dense_repeat(cs, args, work)
        else:
            out = accumulate(cs, args, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    card = cs.card_line() if args.device != "cpu" else "cpu (a rehearsal: no card)"
    out = dict(what=args.what, tree=args.tree or ".", card=card,
               seconds=time.perf_counter() - t0, **out)
    print(json.dumps(out))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
