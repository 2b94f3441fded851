"""Fetch phase: hydrate winning doc ids into hits (a copy of the JAX
package's `search/fetch.py`).

A hit carries `_index`, `_type`, `_id`, `_score` (null in a sorted search
without `track_scores`), `_shard`, `_source` — the source whole, left out
(`"_source": false`) or filtered by includes/excludes patterns; a `fields`
(or `stored_fields`) list leaves it out unless it names `_source` — and, when
the body asks, `_version`, `fields` (each listed field's values from the
source by dotted path; a multi-field or `copy_to` target has no value of its
own there, so it is left out, as in the JAX package), the `script_fields`
(a script that raises gives `[None]`, as in the JAX package), `highlight`
and, in a sorted search, its `sort` values.

Highlighting re-analyzes each hit's `_source` value with the field's search
analyzer. The plain highlighter marks every token of the query's terms for
the field and packs them into fragments of `fragment_size` (most matches
first); the fast-vector highlighter (`fvh`, `fast-vector-highlighter`, and
`postings`, which shares its path here) marks a phrase of the query as one
unit, scores fragments by the weight of their matches and snaps their edges
to boundary characters within `boundary_max_scan`."""

from __future__ import annotations

import fnmatch
from typing import Any

from ..script import compile_script
from .execute import parse_query_string
from .filters import DocAccess
from .queries import (
    BoolQuery,
    FilteredQuery,
    MatchQuery,
    MultiMatchQuery,
    PhraseQuery,
    Query,
    QueryStringQuery,
    TermQuery,
)


def filter_source(source: dict, includes, excludes) -> dict:
    if not includes and not excludes:
        return source

    def walk(obj, path=""):
        if not isinstance(obj, dict):
            return obj
        out = {}
        for k, v in obj.items():
            p = f"{path}{k}"
            if isinstance(v, dict):
                sub = walk(v, p + ".")
                if (sub or _included(p, includes)) and not _excluded(p, excludes):
                    out[k] = sub
            elif _included(p, includes) and not _excluded(p, excludes):
                out[k] = v
        return out

    return walk(source)


def _included(path: str, includes) -> bool:
    if not includes:
        return True
    # a pattern naming an ancestor keeps the whole subtree; one naming a
    # descendant keeps walking through this node
    return any(fnmatch.fnmatch(path, pat) or pat.startswith(path + ".")
               or path.startswith(pat + ".") for pat in includes)


def _excluded(path: str, excludes) -> bool:
    return any(fnmatch.fnmatch(path, pat) for pat in (excludes or []))


def source_spec(body: dict):
    """The `_source` directive: bool / str / list / {includes, excludes} →
    (enabled, includes, excludes)."""
    spec = body.get("_source")
    if spec is None or spec is True:
        return True, [], []
    if spec is False:
        return False, [], []
    if isinstance(spec, str):
        return True, [spec], []
    if isinstance(spec, list):
        return True, spec, []

    def as_list(v):
        if v is None:
            return []
        return [v] if isinstance(v, str) else list(v)

    return True, as_list(spec.get("includes") or spec.get("include")), \
        as_list(spec.get("excludes") or spec.get("exclude"))


def extract_field(source: dict, path: str) -> list:
    """Dotted-path field extraction from _source (for "fields": [...])."""
    node: Any = source
    for part in path.split("."):
        if isinstance(node, list):
            node = [n.get(part) for n in node if isinstance(n, dict)]
        elif isinstance(node, dict):
            node = node.get(part)
        else:
            return []
        if node is None:
            return []
    if isinstance(node, list):
        return [n for n in node if n is not None]
    return [node]


# ---------------------------------------------------------------------------
# highlight (plain highlighter — ref: search/highlight/PlainHighlighter)
# ---------------------------------------------------------------------------


def query_terms_for_field(query: Query, field: str, ctx) -> set[str]:
    out: set[str] = set()

    def walk(q):
        if isinstance(q, TermQuery) and q.field in (field, "_all"):
            out.add(str(q.value).lower())
        elif isinstance(q, MatchQuery) and q.field in (field, "_all"):
            out.update(ctx.analyze(field, q.text))
        elif isinstance(q, PhraseQuery) and q.field in (field, "_all"):
            out.update(ctx.analyze(field, q.text))
        elif isinstance(q, MultiMatchQuery):
            for fspec in q.fields:
                fname = fspec.split("^")[0]
                if fname in (field, "_all"):
                    out.update(ctx.analyze(field, q.text))
        elif isinstance(q, BoolQuery):
            for sub in q.must + q.should:
                walk(sub)
        elif isinstance(q, FilteredQuery):
            walk(q.query)
        elif isinstance(q, QueryStringQuery):
            walk(parse_query_string(q, ctx))
        elif hasattr(q, "query") and isinstance(getattr(q, "query"), Query):
            walk(q.query)
        elif hasattr(q, "queries"):
            for sub in q.queries:
                walk(sub)

    walk(query)
    return out


def highlight_field(text: str, terms: set[str], ctx, field: str,
                    fragment_size: int = 100, number_of_fragments: int = 5,
                    pre_tag: str = "<em>", post_tag: str = "</em>") -> list[str]:
    if not text or not terms:
        return []
    analyzer = ctx.mapper_service.search_analyzer_for(field)
    tokens = analyzer.analyze(text)
    spans = [(t.start, t.end) for t in tokens if t.term.lower() in terms]
    if not spans:
        return []
    if number_of_fragments == 0:
        # highlight whole field
        return [_mark(text, spans, pre_tag, post_tag)]
    fragments: list[tuple[int, int, list[tuple[int, int]]]] = []
    for start, end in spans:
        placed = False
        for i, (fs, fe, fspans) in enumerate(fragments):
            if start < fe:
                fragments[i] = (fs, max(fe, min(len(text), start + fragment_size)), fspans + [(start, end)])
                placed = True
                break
        if not placed:
            fs = max(0, start - fragment_size // 4)
            fe = min(len(text), fs + fragment_size)
            fragments.append((fs, fe, [(start, end)]))
    out = []
    fragments.sort(key=lambda f: -len(f[2]))  # most matches first (Lucene frag scoring)
    for fs, fe, fspans in fragments[:number_of_fragments]:
        frag = text[fs:fe]
        rel = [(s - fs, e - fs) for s, e in fspans if s >= fs and e <= fe]
        out.append(_mark(frag, rel, pre_tag, post_tag))
    return out


def _mark(text: str, spans: list[tuple[int, int]], pre: str, post: str) -> str:
    out = []
    last = 0
    for s, e in sorted(set(spans)):
        if s < last:
            continue
        out.append(text[last:s])
        out.append(pre)
        out.append(text[s:e])
        out.append(post)
        last = e
    out.append(text[last:])
    return "".join(out)


def query_phrases_for_field(query: Query, field: str, ctx) -> list[list[str]]:
    """Phrase term sequences targeting this field (for phrase-unit highlighting)."""
    out: list[list[str]] = []

    def walk(q):
        if isinstance(q, PhraseQuery) and q.field in (field, "_all"):
            terms = ctx.analyze(field, q.text)
            if len(terms) > 1:
                out.append(terms)
        elif isinstance(q, BoolQuery):
            for sub in q.must + q.should:
                walk(sub)
        elif isinstance(q, FilteredQuery):
            walk(q.query)
        elif hasattr(q, "query") and isinstance(getattr(q, "query"), Query):
            walk(q.query)
        elif hasattr(q, "queries"):
            for sub in q.queries:
                walk(sub)

    walk(query)
    return out


_BOUNDARY_CHARS = set(".,!? \t\n")


def fvh_highlight_field(text: str, terms: set[str], phrases: list[list[str]],
                        ctx, field: str, fragment_size: int = 100,
                        number_of_fragments: int = 5, pre_tag: str = "<em>",
                        post_tag: str = "</em>", boundary_max_scan: int = 20) -> list[str]:
    """Fast-vector-highlighter semantics (ref: search/highlight/ FVH wiring over
    Lucene's vectorhighlight): phrase matches highlight as ONE unit (not per word),
    fragments are scored by total match weight (phrases weigh their length), and
    fragment edges snap to boundary characters within boundary_max_scan."""
    if not text or (not terms and not phrases):
        return []
    analyzer = ctx.mapper_service.search_analyzer_for(field)
    tokens = analyzer.analyze(text)
    if not tokens:
        return []
    # phrase spans: consecutive-position runs matching the phrase in order
    spans: list[tuple[int, int, float]] = []  # (start_off, end_off, weight)
    phrase_positions: set[int] = set()
    by_pos = {t.position: t for t in tokens}
    for phrase in phrases:
        n = len(phrase)
        for t in tokens:
            if t.term.lower() != phrase[0]:
                continue
            run = [t]
            for j in range(1, n):
                nxt = by_pos.get(t.position + j)
                if nxt is None or nxt.term.lower() != phrase[j]:
                    run = None
                    break
                run.append(nxt)
            if run:
                spans.append((run[0].start, run[-1].end, float(n)))
                phrase_positions.update(x.position for x in run)
    for t in tokens:
        if t.term.lower() in terms and t.position not in phrase_positions:
            spans.append((t.start, t.end, 1.0))
    if not spans:
        return []
    spans.sort()
    if number_of_fragments == 0:
        return [_mark(text, [(s, e) for s, e, _ in spans], pre_tag, post_tag)]

    def snap(pos: int, forward: bool) -> int:
        """Move a fragment edge to the nearest boundary char within the scan window."""
        if forward:
            for i in range(pos, min(len(text), pos + boundary_max_scan)):
                if text[i] in _BOUNDARY_CHARS:
                    return i + (1 if text[i] != " " else 0)
            return pos
        for i in range(pos, max(0, pos - boundary_max_scan), -1):
            if text[i - 1] in _BOUNDARY_CHARS:
                return i
        return pos

    # greedy fragment packing: group spans into windows of fragment_size
    frags: list[tuple[float, int, int, list[tuple[int, int]]]] = []
    i = 0
    while i < len(spans):
        fs = snap(max(0, spans[i][0] - fragment_size // 4), forward=False)
        fe_limit = fs + fragment_size
        window: list[tuple[int, int]] = []
        weight = 0.0
        j = i
        while j < len(spans) and spans[j][1] <= fe_limit:
            window.append((spans[j][0], spans[j][1]))
            weight += spans[j][2]
            j += 1
        if not window:  # single span longer than the fragment
            window = [(spans[i][0], spans[i][1])]
            weight = spans[i][2]
            j = i + 1
        fe = snap(min(len(text), max(e for _, e in window) + fragment_size // 4),
                  forward=True)
        frags.append((weight, fs, max(fe, max(e for _, e in window)), window))
        i = j
    frags.sort(key=lambda f: -f[0])  # highest total match weight first
    out = []
    for _w, fs, fe, window in frags[:number_of_fragments]:
        rel = [(s - fs, e - fs) for s, e in window]
        out.append(_mark(text[fs:fe], rel, pre_tag, post_tag))
    return out


def build_highlights(query: Query, hl_spec: dict, seg, local: int, ctx) -> dict:
    source = seg.stored[local] or {}
    out = {}
    global_pre = (hl_spec.get("pre_tags") or ["<em>"])[0]
    global_post = (hl_spec.get("post_tags") or ["</em>"])[0]
    for field, fopts in (hl_spec.get("fields") or {}).items():
        fopts = fopts or {}
        terms = query_terms_for_field(query, field, ctx)
        vals = extract_field(source, field)
        hl_type = fopts.get("type", hl_spec.get("type", "plain"))
        kwargs = dict(
            fragment_size=int(fopts.get("fragment_size", hl_spec.get("fragment_size", 100))),
            number_of_fragments=int(fopts.get("number_of_fragments",
                                              hl_spec.get("number_of_fragments", 5))),
            pre_tag=(fopts.get("pre_tags") or [global_pre])[0],
            post_tag=(fopts.get("post_tags") or [global_post])[0],
        )
        frags: list[str] = []
        for v in vals:
            if hl_type in ("fvh", "fast-vector-highlighter", "postings"):
                # postings highlighter shares the offsets-based path here — both
                # highlight from positions+offsets rather than re-scanning
                phrases = query_phrases_for_field(query, field, ctx)
                frags.extend(fvh_highlight_field(
                    str(v), terms, phrases, ctx, field,
                    boundary_max_scan=int(fopts.get("boundary_max_scan",
                                                    hl_spec.get("boundary_max_scan", 20))),
                    **kwargs))
            else:
                frags.extend(highlight_field(str(v), terms, ctx, field, **kwargs))
        if frags:
            out[field] = frags
    return out


# ---------------------------------------------------------------------------
# hit assembly
# ---------------------------------------------------------------------------


def build_hit(seg, local: int, score: float, body: dict, query: Query, ctx,
              index_name: str = "index", sort_values: list | None = None,
              shard_id: int | None = None) -> dict:
    hit: dict[str, Any] = {
        "_index": index_name,
        "_type": seg.types[local],
        "_id": seg.ids[local],
        "_score": None if score != score else score,  # NaN → null (sorted results)
    }
    if shard_id is not None:
        hit["_shard"] = shard_id
    enabled, includes, excludes = source_spec(body)
    fields_directive = body.get("fields") or body.get("stored_fields")
    if fields_directive and body.get("_source") is None:
        # a fields list suppresses _source unless it names "_source" itself
        # (ref: fetch/FieldsParseElement source handling)
        listed = [fields_directive] if isinstance(fields_directive, str) \
            else list(fields_directive)
        enabled = "_source" in listed
    if enabled and seg.stored[local] is not None:
        hit["_source"] = filter_source(seg.stored[local], includes, excludes)
    if body.get("version"):
        hit["_version"] = int(seg.versions[local])
    fields_spec = body.get("fields") or body.get("stored_fields")
    if fields_spec:
        if isinstance(fields_spec, str):
            fields_spec = [fields_spec]
        fields_out = {}
        for f in fields_spec:
            if f == "_source":
                continue
            vals = extract_field(seg.stored[local] or {}, f)
            if vals:
                fields_out[f] = vals
        if fields_out:
            hit["fields"] = fields_out
    script_fields = body.get("script_fields")
    if script_fields:
        sf_out = hit.setdefault("fields", {})
        for name, sspec in script_fields.items():
            fn = compile_script(sspec.get("script", ""), sspec.get("params", {}))
            try:
                sf_out[name] = [fn(DocAccess(seg, local), _score=score if score == score else 0.0)]
            except Exception:  # noqa: BLE001
                sf_out[name] = [None]
    if body.get("highlight"):
        hl = build_highlights(query, body["highlight"], seg, local, ctx)
        if hl:
            hit["highlight"] = hl
    if sort_values is not None:
        hit["sort"] = sort_values
    return hit
