"""The port's analysis chain (`elasticsearch_tpu_torch/analysis/core.py`)
against the JAX package's: every tokenizer, char filter, token filter and
built-in analyzer, custom analyzers built from `index.analysis.*` settings,
and the errors of unknown types. Tokens must be equal token for token:
term, position, start and end.

The texts are seeded: words drawn with numpy from a pool that holds
unicode, apostrophes, HTML, URLs and e-mail addresses, digits and long
tokens. The cases of `tests/test_analysis_mapper.py::TestAnalysis` run here
as parametrised cases, each against the JAX package's answer and its own
literal expectation."""

from __future__ import annotations

import numpy as np
import pytest

from elasticsearch_tpu.analysis import core as jcore
from elasticsearch_tpu.common.errors import IllegalArgumentError as JIllegal
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu_torch.analysis import core as tcore
from elasticsearch_tpu_torch.common.errors import IllegalArgumentError
from elasticsearch_tpu_torch.common.settings import Settings

WORDS = [
    "The", "quick", "Brown", "fox", "jumped", "over", "lazy", "dogs", "running",
    "runs", "ran", "happiness", "generalization", "caresses", "ponies", "ties",
    "cats", "agreed", "plastered", "motoring", "sing", "conflated", "troubled",
    "sized", "hopping", "tanned", "falling", "hissing", "fizzed", "failing",
    "filing", "happy", "sky", "relational", "conditional", "rational",
    "valenci", "hesitanci", "digitizer", "conformabli", "radicalli",
    "differentli", "vileli", "analogousli", "vietnamization", "predication",
    "operator", "feudalism", "decisiveness", "hopefulness", "callousness",
    "formaliti", "sensitiviti", "sensibiliti", "triplicate", "formative",
    "formalize", "electriciti", "electrical", "hopeful", "goodness", "revival",
    "allowance", "inference", "airliner", "gyroscopic", "adjustable",
    "defensible", "irritant", "replacement", "adjustment", "dependent",
    "adoption", "homologou", "communism", "activate", "angulariti",
    "homologous", "effective", "bowdlerize", "probate", "rate", "cease",
    "controll", "roll", "Déjà", "vu", "naïve", "café", "Ærøskøbing", "straße",
    "rock'n'roll", "Bob's", "l'avion", "d'essai", "O’Neil", "e-mail",
    "user@example.com", "http://example.com/a/b?c=d", "https://x.org",
    "<b>Bold</b>", "<p>para</p>", "&amp;", "&#169;", "a/b/c", "foo_bar",
    "WiFi4Home", "PowerShot500", "x" * 300, "2014-01-01", "123", "456-789",
    "3.14", "A", "an", "and", "is", "it", "no", "not", "of", "on", "such",
    "that", "their", "then", "there", "these", "they", "this", "to", "was",
    "will", "with", "fast", "speedy", ",", "!", "?", "--", "  ", "\t",
]


def _texts(seed: int, n: int = 24) -> list[str]:
    rng = np.random.default_rng(seed)
    out = ["", " ", "The Quick-Brown Fox, jumped! Over 2 dogs.",
           "rock'n'roll and Bob's burgers", "unicode Déjà vu naïve café",
           "<b>Bold</b> move &amp; more", "mail user@example.com or "
           "http://example.com/x?y=1 now", "a/b/c/d", "king of spain"]
    for _ in range(n):
        k = int(rng.integers(1, 14))
        out.append(" ".join(WORDS[int(i)] for i in rng.integers(0, len(WORDS), k)))
    return out


TEXTS = _texts(1234)


def _toks(tokens) -> list[tuple]:
    return [(t.term, t.position, t.start, t.end) for t in tokens]


def _pair(flat: dict):
    return (jcore.AnalysisService(JSettings.from_flat(flat)),
            tcore.AnalysisService(Settings.from_flat(flat)))


def _assert_same(flat: dict, name: str, texts=TEXTS):
    jsvc, tsvc = _pair(flat)
    ja, ta = jsvc.analyzer(name), tsvc.analyzer(name)
    for text in texts:
        assert _toks(ta.analyze(text)) == _toks(ja.analyze(text)), (name, text)
        assert ta.index_tokens(text) == ja.index_tokens(text), (name, text)
        assert ta.terms(text) == ja.terms(text), (name, text)


def test_registries_cover_the_jax_package():
    assert set(tcore.TOKENIZERS) == set(jcore.TOKENIZERS)
    assert set(tcore.TOKEN_FILTERS) == set(jcore.TOKEN_FILTERS)
    assert set(tcore._PARAMETRIC_FILTERS) == set(jcore._PARAMETRIC_FILTERS)
    assert set(tcore.CHAR_FILTERS) == set(jcore.CHAR_FILTERS)
    assert set(tcore._PARAMETRIC_CHAR_FILTERS) == set(jcore._PARAMETRIC_CHAR_FILTERS)
    assert set(tcore._builtin_analyzers()) == set(jcore.ANALYZERS)
    assert tcore.ENGLISH_STOP_WORDS == jcore.ENGLISH_STOP_WORDS


@pytest.mark.parametrize("name", sorted(jcore.ANALYZERS))
def test_builtin_analyzer(name):
    _assert_same({}, name)


@pytest.mark.parametrize("tokenizer", sorted(jcore.TOKENIZERS))
def test_tokenizer(tokenizer):
    _assert_same({"index.analysis.analyzer.a.tokenizer": tokenizer}, "a")


TOKENIZER_CONFS = [
    {"type": "standard", "max_token_length": 5},
    {"type": "ngram", "min_gram": 2, "max_gram": 3},
    {"type": "edge_ngram", "min_gram": 1, "max_gram": 4},
    {"type": "path_hierarchy", "delimiter": "/"},
    {"type": "path_hierarchy", "delimiter": "-"},
    {"type": "pattern"},
    {"type": "pattern", "pattern": ","},
    {"type": "pattern", "pattern": r"(\w+)@(\w+)", "group": 1},
    {"type": "uax_url_email"},
]


@pytest.mark.parametrize("conf", TOKENIZER_CONFS, ids=lambda c: "-".join(
    str(v) for v in c.values()))
def test_configured_tokenizer(conf):
    flat = {f"index.analysis.tokenizer.t.{k}": v for k, v in conf.items()}
    flat["index.analysis.analyzer.a.tokenizer"] = "t"
    _assert_same(flat, "a")


@pytest.mark.parametrize("filt", sorted(set(jcore.TOKEN_FILTERS) | set(jcore._PARAMETRIC_FILTERS)))
def test_token_filter_by_name(filt):
    """A filter named in an analyzer without settings of its own."""
    _assert_same({"index.analysis.analyzer.a.tokenizer": "standard",
                  "index.analysis.analyzer.a.filter": ["lowercase", filt]}, "a")


FILTER_CONFS = [
    {"type": "stop", "stopwords": ["quick", "Fox"]},
    {"type": "stop", "stopwords": "_none_"},
    {"type": "stop", "stopwords": "_english_"},
    {"type": "length", "min": 3, "max": 6},
    {"type": "truncate", "length": 4},
    {"type": "shingle", "min_shingle_size": 2, "max_shingle_size": 3},
    {"type": "shingle", "output_unigrams": False, "token_separator": "_"},
    {"type": "ngram", "min_gram": 2, "max_gram": 3},
    {"type": "edge_ngram", "min_gram": 2, "max_gram": 4},
    {"type": "synonym", "synonyms": ["quick,fast,speedy", "dogs => hounds, canines"]},
    {"type": "keyword_marker", "keywords": ["running", "happiness"]},
    {"type": "elision"},
    {"type": "elision", "articles": ["l", "d"]},
    {"type": "common_grams", "common_words": ["the", "of", "and"]},
    {"type": "common_grams", "common_words": ["The"], "ignore_case": True},
    {"type": "common_grams", "common_words": ["of", "the"], "query_mode": True},
    {"type": "stemmer_override", "rules": ["running => sprint", "dogs=>hound"]},
    {"type": "pattern_capture", "patterns": [r"(\w+)@(\w+)", r"(\d+)"]},
    {"type": "pattern_capture", "patterns": [r"(\d+)"], "preserve_original": False},
    {"type": "porter_stem"},
    {"type": "kstem"},
    {"type": "word_delimiter"},
    {"type": "asciifolding"},
    {"type": "unique"},
    {"type": "reverse"},
    {"type": "trim"},
    {"type": "uppercase"},
]


@pytest.mark.parametrize("conf", FILTER_CONFS, ids=lambda c: "-".join(
    str(v) for v in c.values())[:60])
@pytest.mark.parametrize("tokenizer", ["standard", "whitespace"])
def test_configured_token_filter(conf, tokenizer):
    flat = {f"index.analysis.filter.f.{k}": v for k, v in conf.items()}
    flat["index.analysis.analyzer.a.tokenizer"] = tokenizer
    # the keyword mark must be stripped whether or not a stemmer follows
    flat["index.analysis.analyzer.a.filter"] = ["lowercase", "f", "porter_stem"]
    flat["index.analysis.analyzer.b.tokenizer"] = tokenizer
    flat["index.analysis.analyzer.b.filter"] = ["f"]
    _assert_same(flat, "a")
    _assert_same(flat, "b")


CHAR_CONFS = [
    {"type": "html_strip"},
    {"type": "mapping", "mappings": ["ph => f", "& => and", "ß=>ss"]},
    {"type": "pattern_replace", "pattern": r"(\d+)-(\d+)", "replacement": "$1$2"},
    {"type": "pattern_replace", "pattern": r"[aeiou]", "replacement": ""},
]


@pytest.mark.parametrize("conf", CHAR_CONFS, ids=lambda c: c["type"] + str(len(c)))
def test_char_filter(conf):
    flat = {f"index.analysis.char_filter.c.{k}": v for k, v in conf.items()}
    flat.update({"index.analysis.analyzer.a.tokenizer": "standard",
                 "index.analysis.analyzer.a.char_filter": ["c"],
                 "index.analysis.analyzer.a.filter": ["lowercase"],
                 "index.analysis.analyzer.b.tokenizer": "whitespace",
                 "index.analysis.analyzer.b.char_filter": ["html_strip", "c"]})
    _assert_same(flat, "a")
    _assert_same(flat, "b")


def test_typed_builtin_analyzers_and_standard_stopwords():
    flat = {"index.analysis.analyzer.e.type": "english",
            "index.analysis.analyzer.s.type": "standard",
            "index.analysis.analyzer.s.stopwords": ["quick", "the"],
            "index.analysis.analyzer.w.type": "whitespace",
            "index.analysis.analyzer.default.type": "english",
            # the short `analysis.` prefix is read when no `index.analysis.` key is set
            }
    for name in ("e", "s", "w", "default"):
        _assert_same(flat, name)
    short = {"analysis.analyzer.x.tokenizer": "letter",
             "analysis.analyzer.x.filter": "lowercase,stop"}
    _assert_same(short, "x")


def test_body_en_chain_of_the_smoke_index():
    """The chain `chip_smoke.py` phase 18 indexes with: html_strip, standard,
    lowercase, stop, a synonym filter over stems, porter_stem."""
    flat = {"index.analysis.filter.syn.type": "synonym",
            "index.analysis.filter.syn.synonyms": ["quick,fast,speedy",
                                                   "dogs,hounds", "run,sprint"],
            "index.analysis.analyzer.body_en.char_filter": ["html_strip"],
            "index.analysis.analyzer.body_en.tokenizer": "standard",
            "index.analysis.analyzer.body_en.filter": ["lowercase", "stop", "syn",
                                                       "porter_stem"],
            "index.analysis.filter.sh.type": "shingle",
            "index.analysis.filter.sh.max_shingle_size": 3,
            "index.analysis.analyzer.shingles.tokenizer": "standard",
            "index.analysis.analyzer.shingles.filter": ["lowercase", "sh"]}
    _assert_same(flat, "body_en")
    _assert_same(flat, "shingles")


# --- the cases of tests/test_analysis_mapper.py::TestAnalysis -------------

ANALYSIS_CASES = [
    ("standard", {}, "standard", "The Quick-Brown Fox, jumped! Over 2 dogs.",
     ["the", "quick", "brown", "fox", "jumped", "over", "2", "dogs"]),
    ("whitespace", {}, "whitespace", "Foo BAR-baz", ["Foo", "BAR-baz"]),
    ("keyword", {}, "keyword", "New York", ["New York"]),
    ("stop", {}, "stop", "the quick fox", ["quick", "fox"]),
    ("english", {}, "english", "the running dogs jumped", ["run", "dog", "jump"]),
    ("positions", {}, "standard", "alpha beta gamma", ["alpha", "beta", "gamma"]),
    ("custom", {"index.analysis.analyzer.my.tokenizer": "whitespace",
                "index.analysis.analyzer.my.filter": ["lowercase", "my_stop"],
                "index.analysis.filter.my_stop.type": "stop",
                "index.analysis.filter.my_stop.stopwords": ["foo"]},
     "my", "Foo BAR", ["bar"]),
    ("edge_ngram", {"index.analysis.analyzer.ng.tokenizer": "standard",
                    "index.analysis.analyzer.ng.filter": ["lowercase", "eg"],
                    "index.analysis.filter.eg.type": "edge_ngram",
                    "index.analysis.filter.eg.min_gram": 2,
                    "index.analysis.filter.eg.max_gram": 4},
     "ng", "hello", ["he", "hel", "hell"]),
    ("shingle", {"index.analysis.analyzer.sh.tokenizer": "standard",
                 "index.analysis.analyzer.sh.filter": ["lowercase", "shingle"]},
     "sh", "Quick Brown Fox",
     ["quick", "quick brown", "brown", "brown fox", "fox"]),
    ("elision", {"index.analysis.analyzer.fr.tokenizer": "standard",
                 "index.analysis.analyzer.fr.filter": ["lowercase", "el"],
                 "index.analysis.filter.el.type": "elision",
                 "index.analysis.filter.el.articles": ["l", "d"]},
     "fr", "L'avion d'essai", ["avion", "essai"]),
    ("common_grams", {"index.analysis.analyzer.cg.tokenizer": "standard",
                      "index.analysis.analyzer.cg.filter": ["lowercase", "cg"],
                      "index.analysis.filter.cg.type": "common_grams",
                      "index.analysis.filter.cg.common_words": ["the", "of"]},
     "cg", "king of spain", ["king", "king_of", "of", "of_spain", "spain"]),
    ("stemmer_override", {"index.analysis.analyzer.so.tokenizer": "standard",
                          "index.analysis.analyzer.so.filter": ["lowercase", "so",
                                                                "porter_stem"],
                          "index.analysis.filter.so.type": "stemmer_override",
                          "index.analysis.filter.so.rules": ["running => sprint"]},
     "so", "running jumping", ["sprint", "jump"]),
    ("stemmer_override_unstemmed", {
        "index.analysis.analyzer.so2.tokenizer": "standard",
        "index.analysis.analyzer.so2.filter": ["lowercase", "so"],
        "index.analysis.filter.so.type": "stemmer_override",
        "index.analysis.filter.so.rules": ["running => sprint"]},
     "so2", "running", ["sprint"]),
    ("common_grams_case", {"index.analysis.analyzer.cs.tokenizer": "whitespace",
                           "index.analysis.analyzer.cs.filter": ["cs"],
                           "index.analysis.filter.cs.type": "common_grams",
                           "index.analysis.filter.cs.common_words": ["The"]},
     "cs", "The cat", ["The", "The_cat", "cat"]),
    ("common_grams_query_mode", {"index.analysis.analyzer.qm.tokenizer": "whitespace",
                                 "index.analysis.analyzer.qm.filter": ["lowercase", "qm"],
                                 "index.analysis.filter.qm.type": "common_grams",
                                 "index.analysis.filter.qm.common_words": ["of"],
                                 "index.analysis.filter.qm.query_mode": True},
     "qm", "of quick brown", ["of_quick", "quick", "brown"]),
    ("pattern_capture", {"index.analysis.analyzer.pc.tokenizer": "whitespace",
                         "index.analysis.analyzer.pc.filter": ["lowercase", "pc"],
                         "index.analysis.filter.pc.type": "pattern_capture",
                         "index.analysis.filter.pc.patterns": ["(\\w+)@(\\w+)"]},
     "pc", "user@example", ["user@example", "user", "example"]),
    ("synonym", {"index.analysis.analyzer.syn.tokenizer": "standard",
                 "index.analysis.analyzer.syn.filter": ["lowercase", "mysyn"],
                 "index.analysis.filter.mysyn.type": "synonym",
                 "index.analysis.filter.mysyn.synonyms": ["quick,fast"]},
     "syn", "quick", ["quick", "fast"]),
    ("html_strip", {"index.analysis.analyzer.h.tokenizer": "standard",
                    "index.analysis.analyzer.h.char_filter": ["html_strip"],
                    "index.analysis.analyzer.h.filter": ["lowercase"]},
     "h", "<b>Bold</b> move", ["bold", "move"]),
]


@pytest.mark.parametrize("case", ANALYSIS_CASES, ids=lambda c: c[0])
def test_jax_analysis_case(case):
    _id, flat, name, text, expected = case
    jsvc, tsvc = _pair(flat)
    assert _toks(tsvc.analyzer(name).analyze(text)) == \
        _toks(jsvc.analyzer(name).analyze(text))
    assert tsvc.analyzer(name).terms(text) == expected
    _assert_same(flat, name)


# --- errors ---------------------------------------------------------------

BAD_SETTINGS = [
    {"index.analysis.tokenizer.t.type": "nope"},
    {"index.analysis.filter.f.type": "nope"},
    {"index.analysis.char_filter.c.type": "nope"},
    {"index.analysis.analyzer.a.tokenizer": "nope"},
    {"index.analysis.analyzer.a.tokenizer": "standard",
     "index.analysis.analyzer.a.filter": ["lowercase", "nope"]},
    {"index.analysis.analyzer.a.tokenizer": "standard",
     "index.analysis.analyzer.a.char_filter": ["nope"]},
]


@pytest.mark.parametrize("flat", BAD_SETTINGS, ids=lambda f: sorted(f)[-1])
def test_unknown_types_raise_with_the_jax_message(flat):
    with pytest.raises(JIllegal) as jerr:
        jcore.AnalysisService(JSettings.from_flat(flat))
    with pytest.raises(IllegalArgumentError) as terr:
        tcore.AnalysisService(Settings.from_flat(flat))
    assert str(terr.value) == str(jerr.value)


def test_unknown_analyzer_name_raises_with_the_jax_message():
    with pytest.raises(JIllegal) as jerr:
        jcore.AnalysisService().analyzer("nope")
    with pytest.raises(IllegalArgumentError) as terr:
        tcore.AnalysisService().analyzer("nope")
    assert str(terr.value) == str(jerr.value)
