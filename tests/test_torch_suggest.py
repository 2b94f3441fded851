"""The port's suggesters (search/suggest.py) against the JAX package's.

Module against module: tests/test_suggest_highlight.py `TestCompletionTrie`
and `TestCompletionField` and tests/test_search_runtime.py `TestSuggest` on
the port, and for seeded tries, completion fields over two segments and
term and phrase suggestions under every option, the same output as the JAX
package's (JSON equality).

Node against node over REST (3 shards, a `completion` and a `binary` field,
which the port maps since its repair): `_suggest` at both routes, `suggest`
beside a query in `_search` and `_msearch`, merged across shards in the JAX
coordinator's order. A shard degraded to the host path still carries its
suggestions. `_suggest` is a size-0 body, so the shard request cache takes
it: a repeat answers the same JSON from the cache (zlib-compressed entries
too), and a refresh after a write invalidates the written shard's entries,
so the next answer holds the new document's suggestion."""

import json

import numpy as np
import pytest

from elasticsearch_tpu_torch.common.devicehealth import DEVICE_HEALTH
from elasticsearch_tpu_torch.index.engine import Engine as TEngine
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.search import ShardContext
from elasticsearch_tpu_torch.search.suggest import CompletionIndex, run_suggest
from elasticsearch_tpu_torch.transport.faults import DEVICE_FAULTS
from tests.test_torch_fetch import _jax_run, _run, products  # noqa: F401 — fixture
from tests.test_torch_node import _bulk_and_refresh, _node_pair, call

TRIE_ENTRIES = [("nirvana", 10), ("nevermind", 8), ("nine inch nails", 9),
                ("nina simone", 7), ("queen", 5), ("nirvana live", 6)]


def _tries():
    from elasticsearch_tpu.search.suggest import CompletionIndex as JCompletionIndex

    out = []
    for cls in (JCompletionIndex, CompletionIndex):
        c = cls()
        for t, w in TRIE_ENTRIES:
            c.add(t, t, w)
        out.append(c)
    return out


# -- tests/test_suggest_highlight.py TestCompletionTrie, on the port ----------

class TestCompletionTrie:
    def setup_method(self):
        self.j, self.c = _tries()

    def test_prefix_topk_by_weight(self):
        opts = self.c.suggest("ni", 3)
        assert [o["text"] for o in opts] == ["nirvana", "nine inch nails", "nina simone"]
        assert [o["score"] for o in opts] == [10.0, 9.0, 7.0]

    def test_size_limits(self):
        assert len(self.c.suggest("n", 2)) == 2

    def test_no_match(self):
        assert self.c.suggest("xyz", 5) == []

    def test_empty_prefix_returns_global_topk(self):
        assert [o["text"] for o in self.c.suggest("", 2)] == ["nirvana", "nine inch nails"]

    def test_fuzzy_one_edit(self):
        opts = self.c.suggest("nevermnd", 3, fuzzy={"fuzziness": 1})
        assert [o["text"] for o in opts] == ["nevermind"]

    def test_fuzzy_prefix_length_guard(self):
        assert self.c.suggest("xevermind", 3, fuzzy={"fuzziness": 1}) == []

    def test_fuzzy_auto(self):
        assert self.c.suggest("nirvana", 3, fuzzy={"fuzziness": "AUTO"})[0]["text"] == \
            "nirvana"

    def test_dedup_outputs(self):
        c = CompletionIndex()
        c.add("foo bar", "foo", 5)
        c.add("foo baz", "foo", 3)
        opts = c.suggest("foo", 5)
        assert len(opts) == 1 and opts[0]["score"] == 5.0

    @pytest.mark.parametrize("prefix,size,fuzzy", [
        ("n", 10, None), ("ni", 1, None), ("NIR", 5, None), ("q", 3, None),
        ("nirvna", 5, {"fuzziness": 1}), ("nevrmnd", 5, {"fuzziness": 2}),
        ("nin", 5, {"fuzziness": "AUTO", "prefix_length": 2}), ("", 6, None),
        ("zz", 5, {"fuzziness": 1, "prefix_length": 0})])
    def test_matches_jax(self, prefix, size, fuzzy):
        assert self.c.suggest(prefix, size, fuzzy=fuzzy) == \
            self.j.suggest(prefix, size, fuzzy=fuzzy)

    def test_seeded_trie_matches_jax(self):
        from elasticsearch_tpu.search.suggest import CompletionIndex as JCompletionIndex

        rng = np.random.default_rng(1603)
        letters = list("abcdeno")
        j, c = JCompletionIndex(), CompletionIndex()
        for i in range(300):
            text = "".join(rng.choice(letters, int(rng.integers(2, 9))))
            w = float(rng.integers(1, 50))
            out = text if i % 3 else f"out{i % 17}"
            for trie in (j, c):
                trie.add(text, out, w, {"i": i} if i % 5 == 0 else None)
        for prefix in ("a", "ab", "nod", "eee", "x", "dc"):
            for fuzzy in (None, {"fuzziness": 1}, {"fuzziness": 2, "prefix_length": 0}):
                assert c.suggest(prefix, 7, fuzzy=fuzzy) == j.suggest(prefix, 7, fuzzy=fuzzy)


# -- TestCompletionField, module against module --------------------------------

SONG_MAPPING = {"properties": {"suggest": {"type": "completion"},
                               "title": {"type": "string"}, "body": {"type": "string"}}}
SONGS = [{"suggest": {"input": ["Nirvana", "Nevermind"], "output": "Nirvana - Nevermind",
                      "weight": 34, "payload": {"id": 1}}, "title": "Nevermind"},
         {"suggest": "Nine Inch Nails", "title": "NIN"},
         {"suggest": {"input": "Nina Simone", "weight": 50}}]


@pytest.fixture(scope="module")
def song_ctxs(tmp_path_factory):
    """(JAX context, port context) over SONGS: the third in a second segment."""
    from elasticsearch_tpu.index import Engine as JEngine
    from elasticsearch_tpu.mapper import MapperService as JMapperService
    from elasticsearch_tpu.search import ShardContext as JShardContext

    out, engines = [], []
    for mapper, engine in ((JMapperService(), JEngine), (TMapperService(), TEngine)):
        mapper.put_mapping("song", SONG_MAPPING)
        e = engine(str(tmp_path_factory.mktemp("songs")), mapper)
        engines.append(e)
        for i, d in enumerate(SONGS):
            e.index("song", str(i + 1), d)
            if i == 1:
                e.refresh()
        e.refresh()
        out.append(mapper)
    yield (JShardContext(engines[0].acquire_searcher(), out[0]),
           ShardContext(engines[1].acquire_searcher(), out[1], device="cpu"))
    for e in engines:
        e.close()


def test_multi_input_payload(song_ctxs):
    _j, ctx = song_ctxs
    opts = run_suggest(ctx, {"s": {"text": "nev", "completion": {"field": "suggest"}}})[
        "s"][0]["options"]
    assert opts[0]["text"] == "Nirvana - Nevermind" and opts[0]["payload"] == {"id": 1}


def test_cross_segment_weight_order(song_ctxs):
    _j, ctx = song_ctxs
    opts = run_suggest(ctx, {"s": {"text": "ni", "completion": {"field": "suggest"}}})[
        "s"][0]["options"]
    assert [o["text"] for o in opts] == ["Nina Simone", "Nirvana - Nevermind",
                                        "Nine Inch Nails"]


def test_fuzzy_through_api(song_ctxs):
    _j, ctx = song_ctxs
    r = run_suggest(ctx, {"s": {"text": "nrvana", "completion": {
        "field": "suggest", "fuzzy": {"fuzziness": 1, "prefix_length": 1}}}})
    assert r["s"][0]["options"][0]["text"] == "Nirvana - Nevermind"


COMPLETION_BODIES = [
    {"s": {"text": "n", "completion": {"field": "suggest"}}},
    {"s": {"text": "n", "completion": {"field": "suggest", "size": 2}}},
    {"s": {"prefix": "NIN", "completion": {"field": "suggest"}}},
    {"text": "nine", "s": {"completion": {"field": "suggest", "fuzzy": True}},
     "t": {"completion": {"field": "suggest", "fuzzy": {"fuzziness": "AUTO"}}}},
    {"suggest": {"text": "nevermond", "completion": {"fuzzy": {"fuzziness": 2}}}},
    {"s": {"text": "zzz", "completion": {"field": "suggest"}}},
]


@pytest.mark.parametrize("i", range(len(COMPLETION_BODIES)))
def test_completion_matches_jax(song_ctxs, i):
    from elasticsearch_tpu.search.suggest import run_suggest as jrun

    jctx, ctx = song_ctxs
    body = COMPLETION_BODIES[i]
    assert json.dumps(run_suggest(ctx, body)) == json.dumps(jrun(jctx, body))


# -- tests/test_search_runtime.py TestSuggest, and term / phrase options -------

def test_term_suggester(products):
    _j, ctx = products
    r = _run(ctx, {"size": 0, "suggest": {"fix": {"text": "widgit",
                                                  "term": {"field": "name"}}}})
    opts = r["suggest"]["fix"][0]["options"]
    assert opts and opts[0]["text"] == "widget"


def test_phrase_suggester(products):
    _j, ctx = products
    r = _run(ctx, {"size": 0, "suggest": {"fix": {"text": "red widgit",
                                                  "phrase": {"field": "name"}}}})
    assert "red widget" in [o["text"] for o in r["suggest"]["fix"][0]["options"]]


TERM_BODIES = [
    {"fix": {"text": "widgit gadgt", "term": {"field": "name"}}},
    {"fix": {"text": "red widgit", "term": {"field": "name", "suggest_mode": "always",
                                            "size": 2}}},
    {"fix": {"text": "gizmoo", "term": {"field": "name", "suggest_mode": "popular"}}},
    {"fix": {"text": "xidget", "term": {"field": "name", "prefix_length": 0,
                                        "max_edits": 1}}},
    {"fix": {"text": "red", "term": {"field": "name", "min_word_length": 2,
                                     "suggest_mode": "always"}}},
    {"text": "yelow gizmo", "a": {"term": {"field": "name"}},
     "b": {"phrase": {"field": "name", "size": 3}}},
    {"fix": {"text": "blu widgit delux", "phrase": {"field": "name"}}},
    {"fix": {"text": "", "phrase": {"field": "name"}}},
    {"fix": {"text": "widgit", "term": {"field": "no_such_field"}}},
]


@pytest.mark.parametrize("i", range(len(TERM_BODIES)))
def test_term_and_phrase_match_jax(products, i):
    jctx, ctx = products
    body = {"size": 0, "suggest": TERM_BODIES[i]}
    got = _run(ctx, body)["suggest"]
    assert got and json.dumps(got) == json.dumps(_jax_run(jctx, body)["suggest"])


# -- node against node ---------------------------------------------------------

VOCAB = ["search", "engine", "shard", "index", "token", "phrase", "river", "stone",
         "market", "turtle", "green", "night", "quick", "brown", "lazy"]
ARTISTS = ["Nirvana", "Nine Inch Nails", "Nina Simone", "Neil Young", "Nick Cave",
           "Norah Jones", "Queen", "Quicksilver", "Radiohead", "Ramones"]
SG_MAPPING = {"properties": {"title": {"type": "string"}, "body": {"type": "string"},
                             "suggest": {"type": "completion"},
                             "blob": {"type": "binary"}}}


def _sg_docs(n: int = 60, seed: int = 1604) -> list[dict]:
    rng = np.random.default_rng(seed)
    docs = []
    for i in range(n):
        artist = ARTISTS[i % len(ARTISTS)]
        entry = artist if i % 3 == 0 else {
            "input": [artist, artist.split()[-1]], "output": f"{artist} #{i}",
            "weight": int(rng.integers(1, 100)), **({"payload": {"i": i}} if i % 4 else {})}
        docs.append({"title": " ".join(rng.choice(VOCAB, 2)),
                     "body": " ".join(rng.choice(VOCAB, int(rng.integers(4, 14)))),
                     "suggest": entry, "blob": "aGVsbG8="})
    return docs


def _sg_bulk(docs, start=0) -> str:
    lines = []
    for i, d in enumerate(docs, start=start):
        lines += [{"index": {"_index": "sg", "_type": "doc", "_id": str(i)}}, d]
    return "\n".join(json.dumps(x) for x in lines) + "\n"


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    docs = _sg_docs()

    def fill(base):
        st, r = call(base, "PUT", "/sg", {"settings": {"number_of_shards": 3,
                                                       "refresh_interval": -1},
                                          "mappings": {"doc": SG_MAPPING}})
        assert st == 200 and r["primaries_active"], r
        _bulk_and_refresh(base, [_sg_bulk(docs[:30]), _sg_bulk(docs[30:], start=30)])

    yield from _node_pair(tmp_path_factory, fill)


SUGGESTS = {
    "term": {"fix": {"text": "serch engnie", "term": {"field": "body"}}},
    "phrase": {"fix": {"text": "quik brwn river", "phrase": {"field": "body"}}},
    "completion": {"artist": {"text": "ni", "completion": {"field": "suggest"}}},
    "fuzzy": {"artist": {"text": "nirvna", "completion": {"field": "suggest",
                                                          "fuzzy": {"fuzziness": 1}}}},
    "mixed": {"text": "shrd", "a": {"term": {"field": "title", "suggest_mode": "always"}},
              "b": {"text": "nin", "completion": {"field": "suggest", "size": 3}}},
}


def _both(nodes, method, path, body=None, raw=None):
    pbase, jbase, _p = nodes
    (pst, pr), (jst, jr) = (call(b, method, path, body, raw=raw) for b in (pbase, jbase))
    assert pst == jst == 200, (pr, jr)
    return pr, jr


@pytest.mark.parametrize("name", list(SUGGESTS))
@pytest.mark.parametrize("path", ["/sg/_suggest", "/_suggest"])
def test_suggest_route_matches_jax_node(nodes, name, path):
    pr, jr = _both(nodes, "POST", path, SUGGESTS[name])
    assert any(e["options"] for entries in pr.values() for e in entries)
    assert json.dumps(pr) == json.dumps(jr)


def test_suggest_in_search_and_msearch_matches_jax_node(nodes):
    body = {"query": {"match": {"body": "river stone"}}, "size": 5,
            "suggest": SUGGESTS["mixed"], "highlight": {"fields": {"body": {}}}}
    pr, jr = _both(nodes, "POST", "/sg/_search", body)
    assert pr["suggest"] and (pr["hits"], pr["suggest"]) == (jr["hits"], jr["suggest"])
    ndjson = "".join(json.dumps({"index": "sg"}) + "\n" + json.dumps(
        {"size": 2, "suggest": SUGGESTS[n]}) + "\n" for n in ("term", "fuzzy"))
    pr, jr = _both(nodes, "POST", "/_msearch", raw=ndjson)
    assert [r["suggest"] for r in pr["responses"]] == [r["suggest"] for r in jr["responses"]]


def test_degraded_shard_carries_its_suggestions(nodes):
    """The suggesters never touch the card: with every shard degraded to
    the host path, the answer still holds the suggestions, the JAX node's."""
    body = {"query": {"match": {"body": "turtle"}}, "request_cache": False,
            "suggest": SUGGESTS["mixed"]}
    pbase, jbase, _p = nodes
    _st, jr = call(jbase, "POST", "/sg/_search", body)
    DEVICE_FAULTS.arm(error="transfer", domain="pull:sg", times=10 ** 6)
    try:
        st, pr = call(pbase, "POST", "/sg/_search", body)
    finally:
        DEVICE_FAULTS.disarm()
        DEVICE_HEALTH.reset()
    assert st == 200 and pr["_shards"]["degraded"] == 3, pr["_shards"]
    assert pr["suggest"] == jr["suggest"] and pr["hits"]["total"] == jr["hits"]["total"]


def test_request_cache_answers_suggest_and_a_refresh_invalidates_it(nodes):
    pbase, jbase, pnode = nodes
    rcache = pnode.request_cache
    long_text = " ".join(f"{w}x" for w in VOCAB * 3)  # entries past the zlib floor
    # bodies no other test sends (an earlier one would have stored them)
    bodies = [{"artist": {"text": "nirvan", "completion": {
        "field": "suggest", "size": 4, "fuzzy": {"fuzziness": 1}}}},
        {"fix": {"text": long_text, "term": {"field": "body"}}}]
    s0 = rcache.stats()
    first = [call(pbase, "POST", "/sg/_suggest", b)[1] for b in bodies]
    s1 = rcache.stats()
    again = [call(pbase, "POST", "/sg/_suggest", b)[1] for b in bodies]
    s2 = rcache.stats()
    assert (s1["misses"] - s0["misses"], s1["stores"] - s0["stores"]) == (6, 6), (s0, s1)
    assert (s2["hits"] - s1["hits"], s2["misses"] - s1["misses"]) == (6, 0), (s1, s2)
    assert s1["compressions"] > s0["compressions"]
    assert json.dumps(again) == json.dumps(first)
    # a write and a refresh: the new view's entries miss and see the write
    doc = {"title": "new", "body": "river", "suggest": {
        "input": "Nirvana Unplugged", "output": "Nirvana Unplugged", "weight": 1000}}
    for base in (pbase, jbase):
        assert call(base, "PUT", "/sg/doc/new1", doc)[0] == 201
        assert call(base, "POST", "/sg/_refresh")[0] == 200
    after, jafter = _both(nodes, "POST", "/sg/_suggest", bodies[0])
    # the written shard's entries of the old view went; the answer comes
    # from the new view (run, or stored by the warmer's re-prime)
    assert rcache.stats()["invalidations"] > s2["invalidations"]
    assert after != first[0] and json.dumps(after) == json.dumps(jafter)
    assert after["artist"][0]["options"][0]["text"] == "Nirvana Unplugged"
