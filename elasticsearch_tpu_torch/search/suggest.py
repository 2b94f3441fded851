"""Suggesters: term (spellcheck), phrase and completion (a copy of the JAX
package's `search/suggest.py`).

The term suggester follows Lucene's DirectSpellChecker contract: candidate
terms of the field within `max_edits` of each analyzed input token, ranked
by (similarity desc, doc_freq desc, term asc), under `prefix_length`,
`min_word_length` and `suggest_mode`. The phrase suggester combines each
token's term candidates in a beam by their document frequencies. The
completion suggester serves weighted prefix lookups (fuzzy ones too) from a
trie built per segment from the `_source` values of a `completion` field
(as in the JAX package, the trie reads the source, not the field's doc
values), cached on the segment object.

`run_suggest` runs a body's suggesters on one shard: the shard's query
phase calls it before any device branch, and the coordinator merges the
shards' entries (search/controller.py `_merge_suggest`). Every suggester
runs on the host."""

from __future__ import annotations

import heapq

from .execute import _within_edits
from .fetch import extract_field


def _edit_distance(a: str, b: str) -> int:
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def term_suggest(ctx, spec: dict, global_text: str | None = None) -> dict:
    text = spec.get("text", global_text or "")
    term_spec = spec.get("term", {})
    field = term_spec.get("field", "_all")
    size = int(term_spec.get("size", 5))
    max_edits = int(term_spec.get("max_edits", 2))
    prefix_len = int(term_spec.get("prefix_length", term_spec.get("prefix_len", 1)))
    min_word_length = int(term_spec.get("min_word_length", 4))
    suggest_mode = term_spec.get("suggest_mode", "missing")
    analyzer = ctx.mapper_service.search_analyzer_for(field)
    out_entries = []
    for tok in analyzer.analyze(text):
        word = tok.term
        options = []
        word_df = ctx.doc_freq(field, word)
        if suggest_mode == "missing" and word_df > 0:
            out_entries.append({"text": word, "offset": tok.start,
                                "length": tok.end - tok.start, "options": []})
            continue
        if len(word) >= min_word_length:
            seen = {}
            for term in ctx.all_terms(field):
                if term == word:
                    continue
                if prefix_len and term[:prefix_len] != word[:prefix_len]:
                    continue
                if abs(len(term) - len(word)) > max_edits:
                    continue
                if not _within_edits(word, term, max_edits):
                    continue
                df = ctx.doc_freq(field, term)
                if df <= 0:
                    continue
                if suggest_mode == "popular" and df <= word_df:
                    continue
                dist = _edit_distance(word, term)
                score = 1.0 - dist / max(len(word), len(term))
                seen[term] = (score, df)
            options = [
                {"text": t, "score": round(s, 6), "freq": df}
                for t, (s, df) in sorted(
                    seen.items(), key=lambda kv: (-kv[1][0], -kv[1][1], kv[0])
                )[:size]
            ]
        out_entries.append({
            "text": word, "offset": tok.start, "length": tok.end - tok.start,
            "options": options,
        })
    return {"entries": out_entries}


def phrase_suggest(ctx, spec: dict, global_text: str | None = None) -> dict:
    text = spec.get("text", global_text or "")
    pspec = spec.get("phrase", {})
    field = pspec.get("field", "_all")
    size = int(pspec.get("size", 5))
    analyzer = ctx.mapper_service.search_analyzer_for(field)
    tokens = [t.term for t in analyzer.analyze(text)]
    if not tokens:
        return {"entries": [{"text": text, "offset": 0, "length": len(text), "options": []}]}
    per_token: list[list[tuple[str, float]]] = []
    max_doc = max(ctx.max_doc, 1)
    for word in tokens:
        cands = [(word, ctx.doc_freq(field, word))]
        tspec = {"term": {"field": field, "size": 3, "suggest_mode": "always"},
                 "text": word}
        sugg = term_suggest(ctx, tspec)
        for opt in sugg["entries"][0]["options"]:
            cands.append((opt["text"], opt["freq"]))
        scored = [(t, (df + 0.5) / max_doc) for t, df in cands]
        scored.sort(key=lambda x: -x[1])
        per_token.append(scored[:3])
    # beam over candidate combinations
    beams: list[tuple[float, list[str]]] = [(1.0, [])]
    for cands in per_token:
        new_beams = []
        for score, words in beams:
            for term, p in cands:
                new_beams.append((score * p, words + [term]))
        new_beams.sort(key=lambda b: -b[0])
        beams = new_beams[: max(size * 2, 10)]
    options = []
    seen = set()
    for score, words in beams:
        phrase = " ".join(words)
        if phrase in seen:
            continue
        seen.add(phrase)
        options.append({"text": phrase, "score": round(score, 9)})
        if len(options) >= size:
            break
    # drop the identity suggestion if it ranks first and equals input
    return {"entries": [{
        "text": text, "offset": 0, "length": len(text), "options": options,
    }]}


class _TrieNode:
    __slots__ = ("children", "max_weight", "outputs")

    def __init__(self):
        self.children: dict[str, _TrieNode] = {}
        self.max_weight = float("-inf")
        self.outputs: list[tuple[float, str, dict | None]] = []  # terminal entries


class CompletionIndex:
    """Weighted prefix trie with per-node max-weight — the FST analogue of Lucene's
    Completion090PostingsFormat (ref: search/suggest/completion/): top-k prefix
    lookup is best-first over max_weight, touching O(k · depth) nodes instead of
    scanning every completion under the prefix. Optional fuzzy prefix matching via a
    banded edit-distance walk (the suggester's XFuzzySuggester role)."""

    def __init__(self):
        self.root = _TrieNode()
        self.count = 0

    def add(self, input_text: str, output: str, weight: float = 1.0, payload=None):
        w = float(weight)
        node = self.root
        node.max_weight = max(node.max_weight, w)
        for ch in input_text.lower():
            node = node.children.setdefault(ch, _TrieNode())
            node.max_weight = max(node.max_weight, w)
        node.outputs.append((w, output, payload))
        self.count += 1

    # ------------------------------------------------------------------ lookup
    def _descend(self, prefix: str) -> _TrieNode | None:
        node = self.root
        for ch in prefix:
            node = node.children.get(ch)
            if node is None:
                return None
        return node

    def _fuzzy_roots(self, prefix: str, fuzziness: int,
                     prefix_length: int) -> list[tuple[_TrieNode, str]]:
        """All trie nodes reachable by consuming `prefix` with ≤ fuzziness edits;
        the first prefix_length chars must match exactly (ES fuzzy completion
        defaults: fuzziness 1, prefix_length 1)."""
        node = self.root
        exact, rest = prefix[:prefix_length], prefix[prefix_length:]
        for ch in exact:
            node = node.children.get(ch)
            if node is None:
                return []
        # banded Levenshtein over the remaining prefix
        results: dict[int, tuple[_TrieNode, str]] = {}
        start_row = list(range(len(rest) + 1))
        stack = [(node, exact, start_row)]
        while stack:
            n, path, row = stack.pop()
            if row[-1] <= fuzziness:
                key = id(n)
                if key not in results:
                    results[key] = (n, path)
            if min(row) > fuzziness:
                continue
            for ch, child in n.children.items():
                new_row = [row[0] + 1]
                for i in range(1, len(rest) + 1):
                    cost = 0 if rest[i - 1] == ch else 1
                    new_row.append(min(new_row[i - 1] + 1, row[i] + 1,
                                       row[i - 1] + cost))
                stack.append((child, path + ch, new_row))
        return list(results.values())

    def suggest(self, prefix: str, size: int = 5,
                fuzzy: dict | None = None) -> list[dict]:
        prefix = prefix.lower()
        if fuzzy:
            fz = fuzzy.get("fuzziness", 1)
            if fz in ("AUTO", "auto"):
                fz = 0 if len(prefix) < 3 else (1 if len(prefix) < 6 else 2)
            roots = self._fuzzy_roots(prefix, int(fz),
                                      int(fuzzy.get("prefix_length", 1)))
        else:
            node = self._descend(prefix)
            roots = [(node, prefix)] if node is not None else []
        if not roots:
            return []
        # best-first: heap over (-max_weight) of frontier nodes and found entries
        seq = 0
        heap = []
        for node, _path in roots:
            heap.append((-node.max_weight, seq := seq + 1, node))
        heapq.heapify(heap)
        result: list[dict] = []
        seen: set[str] = set()
        candidates: list[tuple[float, str, dict | None]] = []
        while heap and len(result) < size:
            neg_w, _, node = heapq.heappop(heap)
            # flush any found entries at least as good as the rest of the frontier
            for w, output, payload in sorted(node.outputs, reverse=True,
                                             key=lambda e: e[0]):
                heapq.heappush(heap, (-w, seq := seq + 1,
                                      _Terminal(w, output, payload)))
            if isinstance(node, _Terminal):
                if node.output not in seen:
                    seen.add(node.output)
                    opt = {"text": node.output, "score": node.weight}
                    if node.payload is not None:
                        opt["payload"] = node.payload
                    result.append(opt)
                continue
            for child in node.children.values():
                heapq.heappush(heap, (-child.max_weight, seq := seq + 1, child))
        return result


class _Terminal:
    """Heap entry for a completed suggestion (weight is exact, not an upper bound)."""

    __slots__ = ("weight", "output", "payload", "children", "outputs", "max_weight")

    def __init__(self, weight: float, output: str, payload):
        self.weight = weight
        self.output = output
        self.payload = payload
        self.children = {}
        self.outputs = []
        self.max_weight = weight


def segment_completion_trie(seg, field: str) -> CompletionIndex:
    """Build (and cache on the write-once segment) the completion trie for one
    completion-typed field, from stored sources. Entry forms per the reference's
    CompletionFieldMapper: "text", ["a","b"], or
    {"input": [...], "output": "...", "weight": N, "payload": {...}}."""
    cache = getattr(seg, "_completion_tries", None)
    if cache is None:
        cache = {}
        seg._completion_tries = cache
    trie = cache.get(field)
    if trie is not None:
        return trie
    trie = CompletionIndex()
    for local in range(seg.doc_count):
        if not seg.live[local] or seg.stored[local] is None:
            continue
        for v in extract_field(seg.stored[local], field):
            if isinstance(v, dict):
                inputs = v.get("input", [])
                inputs = [inputs] if isinstance(inputs, str) else list(inputs)
                output = v.get("output") or (inputs[0] if inputs else "")
                weight = float(v.get("weight", 1.0))
                payload = v.get("payload")
                for inp in inputs:
                    trie.add(str(inp), str(output), weight, payload)
            elif isinstance(v, list):
                for inp in v:
                    trie.add(str(inp), str(inp))
            elif v is not None:
                trie.add(str(v), str(v))
    cache[field] = trie
    return trie


def completion_suggest(ctx, name: str, spec: dict,
                       global_text: str | None = None) -> dict:
    """Completion across segments: per-segment tries merged by weight."""
    comp_spec = spec.get("completion") or {}
    prefix = spec.get("text", spec.get("prefix", global_text or ""))
    field = comp_spec.get("field", name)
    size = int(comp_spec.get("size", 5))
    fuzzy = comp_spec.get("fuzzy")
    if fuzzy is True:
        fuzzy = {}
    options: list[dict] = []
    # legacy hook: a shard-level index set on the context wins (tests / percolator)
    shard_index = getattr(ctx, "completion_index", None)
    if shard_index is not None:
        options = shard_index.suggest(prefix, size, fuzzy=fuzzy)
    else:
        merged: dict[str, dict] = {}
        for seg in ctx.searcher.segments:
            for opt in segment_completion_trie(seg, field).suggest(
                    prefix, size, fuzzy=fuzzy):
                prev = merged.get(opt["text"])
                if prev is None or opt["score"] > prev["score"]:
                    merged[opt["text"]] = opt
        options = sorted(merged.values(), key=lambda o: (-o["score"], o["text"]))[:size]
    return {"entries": [{"text": prefix, "offset": 0, "length": len(prefix),
                         "options": options}]}


def run_suggest(ctx, suggest_body: dict) -> dict:
    out = {}
    global_text = suggest_body.get("text")
    for name, spec in suggest_body.items():
        if name == "text":
            continue
        if "term" in spec:
            r = term_suggest(ctx, spec, global_text)
        elif "phrase" in spec:
            r = phrase_suggest(ctx, spec, global_text)
        elif "completion" in spec:
            r = completion_suggest(ctx, name, spec, global_text)
        else:
            continue
        out[name] = r["entries"]
    return out
