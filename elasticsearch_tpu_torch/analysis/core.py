"""Tokenizers, token filters, char filters, analyzers and the per-index
AnalysisService: a copy of the JAX package's `analysis/core.py` on its
pure-Python path (the native tokenizer is left out; it gives the same terms).

- tokenizers: standard, whitespace, letter, lowercase, keyword, ngram, edge_ngram,
  path_hierarchy, pattern, uax_url_email (approximated)
- token filters: lowercase, uppercase, stop, asciifolding, length, trim, truncate,
  unique, reverse, kstem/porter_stem (light english stemmer), snowball (≈ porter),
  shingle, ngram, edge_ngram, word_delimiter (simplified), keyword_marker, synonym
- char filters: html_strip, mapping, pattern_replace
- analyzers: standard, simple, whitespace, keyword, stop, english, pattern

The standard tokenizer approximates Lucene's StandardTokenizer (UAX#29 word
boundaries) with a unicode-aware regex, exactly as the JAX package does, so both
packages index the same terms at the same positions.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass
from typing import Callable, Iterable

from ..common.errors import IllegalArgumentError
from ..common.settings import Settings


@dataclass
class Token:
    __slots__ = ("term", "position", "start", "end")
    term: str
    position: int
    start: int
    end: int


# ---------------------------------------------------------------------------
# char filters
# ---------------------------------------------------------------------------

_HTML_RE = re.compile(r"<[^>]*>|&[a-zA-Z]+;|&#\d+;")


def html_strip_char_filter(text: str, settings: Settings | None = None) -> str:
    return _HTML_RE.sub(" ", text)


def make_mapping_char_filter(settings: Settings):
    mappings = []
    for rule in settings.get_list("mappings"):
        if "=>" in rule:
            src, dst = rule.split("=>", 1)
            mappings.append((src.strip(), dst.strip()))

    def apply(text: str, _settings=None) -> str:
        for src, dst in mappings:
            text = text.replace(src, dst)
        return text

    return apply


def make_pattern_replace_char_filter(settings: Settings):
    pattern = re.compile(settings.get_str("pattern", ""))
    replacement = settings.get_str("replacement", "")

    def apply(text: str, _settings=None) -> str:
        return pattern.sub(replacement, text)

    return apply


# ---------------------------------------------------------------------------
# tokenizers
# ---------------------------------------------------------------------------

# UAX#29-ish word: letters/digits runs, keeping internal apostrophes & periods out
_STANDARD_RE = re.compile(r"[^\W_]+(?:['’][^\W_]+)*", re.UNICODE)
_LETTER_RE = re.compile(r"[^\W\d_]+", re.UNICODE)
_WHITESPACE_RE = re.compile(r"\S+")


def _regex_tokenize(text: str, pattern: re.Pattern, max_token_length: int = 255) -> list[Token]:
    tokens = []
    pos = 0
    for m in pattern.finditer(text):
        term = m.group(0)
        if len(term) > max_token_length:
            continue
        tokens.append(Token(term, pos, m.start(), m.end()))
        pos += 1
    return tokens


def standard_tokenizer(text: str, settings: Settings | None = None) -> list[Token]:
    max_len = settings.get_int("max_token_length", 255) if settings else 255
    return _regex_tokenize(text, _STANDARD_RE, max_len)


def whitespace_tokenizer(text: str, settings: Settings | None = None) -> list[Token]:
    return _regex_tokenize(text, _WHITESPACE_RE)


def letter_tokenizer(text: str, settings: Settings | None = None) -> list[Token]:
    return _regex_tokenize(text, _LETTER_RE)


def lowercase_tokenizer(text: str, settings: Settings | None = None) -> list[Token]:
    return [Token(t.term.lower(), t.position, t.start, t.end) for t in letter_tokenizer(text)]


def keyword_tokenizer(text: str, settings: Settings | None = None) -> list[Token]:
    return [Token(text, 0, 0, len(text))] if text else []


def make_ngram_tokens(term: str, min_gram: int, max_gram: int, edge: bool) -> Iterable[str]:
    n = len(term)
    if edge:
        for g in range(min_gram, max_gram + 1):
            if g <= n:
                yield term[:g]
    else:
        for start in range(n):
            for g in range(min_gram, max_gram + 1):
                if start + g <= n:
                    yield term[start : start + g]


def ngram_tokenizer(text: str, settings: Settings | None = None) -> list[Token]:
    s = settings or Settings.EMPTY
    min_gram = s.get_int("min_gram", 1)
    max_gram = s.get_int("max_gram", 2)
    tokens = []
    pos = 0
    for start in range(len(text)):
        for g in range(min_gram, max_gram + 1):
            if start + g <= len(text):
                tokens.append(Token(text[start : start + g], pos, start, start + g))
                pos += 1
    return tokens


def edge_ngram_tokenizer(text: str, settings: Settings | None = None) -> list[Token]:
    s = settings or Settings.EMPTY
    min_gram = s.get_int("min_gram", 1)
    max_gram = s.get_int("max_gram", 2)
    return [
        Token(text[:g], i, 0, g)
        for i, g in enumerate(range(min_gram, min(max_gram, len(text)) + 1))
    ]


def path_hierarchy_tokenizer(text: str, settings: Settings | None = None) -> list[Token]:
    s = settings or Settings.EMPTY
    delim = s.get_str("delimiter", "/")
    parts = text.split(delim)
    tokens = []
    acc = ""
    for i, p in enumerate(parts):
        acc = p if i == 0 else acc + delim + p
        if acc:
            tokens.append(Token(acc, 0, 0, len(acc)))
    return tokens


def make_pattern_tokenizer(settings: Settings):
    pattern = re.compile(settings.get_str("pattern", r"\W+"))
    group = settings.get_int("group", -1)

    def tokenize(text: str, _settings=None) -> list[Token]:
        if group >= 0:
            return [
                Token(m.group(group), i, m.start(group), m.end(group))
                for i, m in enumerate(pattern.finditer(text))
                if m.group(group)
            ]
        tokens = []
        pos = 0
        last = 0
        for m in pattern.finditer(text):
            if m.start() > last:
                tokens.append(Token(text[last : m.start()], pos, last, m.start()))
                pos += 1
            last = m.end()
        if last < len(text):
            tokens.append(Token(text[last:], pos, last, len(text)))
        return tokens

    return tokenize


_URL_EMAIL_RE = re.compile(
    r"[a-zA-Z0-9.+-]+@[a-zA-Z0-9.-]+\.[a-zA-Z]{2,}|https?://\S+|" + _STANDARD_RE.pattern,
    re.UNICODE,
)


def uax_url_email_tokenizer(text: str, settings: Settings | None = None) -> list[Token]:
    return _regex_tokenize(text, _URL_EMAIL_RE)


TOKENIZERS: dict[str, Callable] = {
    "standard": standard_tokenizer,
    "whitespace": whitespace_tokenizer,
    "letter": letter_tokenizer,
    "lowercase": lowercase_tokenizer,
    "keyword": keyword_tokenizer,
    "ngram": ngram_tokenizer,
    "nGram": ngram_tokenizer,
    "edge_ngram": edge_ngram_tokenizer,
    "edgeNGram": edge_ngram_tokenizer,
    "path_hierarchy": path_hierarchy_tokenizer,
    "uax_url_email": uax_url_email_tokenizer,
}

# ---------------------------------------------------------------------------
# token filters
# ---------------------------------------------------------------------------

# Lucene's default English stopword set (StopAnalyzer.ENGLISH_STOP_WORDS_SET)
ENGLISH_STOP_WORDS = frozenset(
    "a an and are as at be but by for if in into is it no not of on or such that the "
    "their then there these they this to was will with".split()
)


def lowercase_filter(tokens: list[Token], settings: Settings | None = None) -> list[Token]:
    for t in tokens:
        t.term = t.term.lower()
    return tokens


def uppercase_filter(tokens: list[Token], settings: Settings | None = None) -> list[Token]:
    for t in tokens:
        t.term = t.term.upper()
    return tokens


def make_stop_filter(settings: Settings):
    words = settings.get_list("stopwords")
    if not words or words == ["_english_"]:
        stopset = ENGLISH_STOP_WORDS
    elif words == ["_none_"]:
        stopset = frozenset()
    else:
        stopset = frozenset(w.lower() for w in words)

    def apply(tokens: list[Token], _settings=None) -> list[Token]:
        # preserves position increments (gaps) like Lucene's StopFilter
        return [t for t in tokens if t.term.lower() not in stopset]

    return apply


def stop_filter(tokens: list[Token], settings: Settings | None = None) -> list[Token]:
    return [t for t in tokens if t.term.lower() not in ENGLISH_STOP_WORDS]


def asciifolding_filter(tokens: list[Token], settings: Settings | None = None) -> list[Token]:
    for t in tokens:
        t.term = (
            unicodedata.normalize("NFKD", t.term).encode("ascii", "ignore").decode("ascii")
        ) or t.term
    return tokens


def make_length_filter(settings: Settings):
    mn = settings.get_int("min", 0)
    mx = settings.get_int("max", 2**31 - 1)

    def apply(tokens: list[Token], _settings=None) -> list[Token]:
        return [t for t in tokens if mn <= len(t.term) <= mx]

    return apply


def trim_filter(tokens: list[Token], settings: Settings | None = None) -> list[Token]:
    for t in tokens:
        t.term = t.term.strip()
    return [t for t in tokens if t.term]


def make_truncate_filter(settings: Settings):
    length = settings.get_int("length", 10)

    def apply(tokens: list[Token], _settings=None) -> list[Token]:
        for t in tokens:
            t.term = t.term[:length]
        return tokens

    return apply


_FRENCH_ARTICLES = ("l", "m", "t", "qu", "n", "s", "j")


def make_elision_filter(settings: Settings):
    """Strip elided articles (l'avion → avion).
    ref: index/analysis/ElisionTokenFilterFactory.java — articles configurable,
    French defaults."""
    articles = frozenset(a.lower() for a in
                         (settings.get_list("articles") or _FRENCH_ARTICLES))

    def apply(tokens: list[Token], _settings=None) -> list[Token]:
        for t in tokens:
            for sep in ("'", "’"):
                i = t.term.find(sep)
                if i > 0 and t.term[:i].lower() in articles:
                    t.term = t.term[i + 1:]
                    break
        return [t for t in tokens if t.term]

    return apply


def make_common_grams_filter(settings: Settings):
    """Bigram tokens over common words, at the same positions as the unigrams
    (ref: index/analysis/CommonGramsTokenFilterFactory.java; query_mode drops the
    unigrams the bigrams cover)."""
    ignore_case = settings.get_bool("ignore_case", False)
    query_mode = settings.get_bool("query_mode", False)
    words = settings.get_list("common_words") or ()
    common = frozenset(w.lower() for w in words) if ignore_case else frozenset(words)

    def is_common(term: str) -> bool:
        return (term.lower() if ignore_case else term) in common

    def apply(tokens: list[Token], _settings=None) -> list[Token]:
        n = len(tokens)
        flags = [is_common(t.term) for t in tokens]
        # bigram between i and i+1 whenever either side is common
        has_gram = [i + 1 < n and (flags[i] or flags[i + 1]) for i in range(n)]
        out: list[Token] = []
        for i, t in enumerate(tokens):
            # query_mode (CommonGramsQueryFilter): drop a unigram when a bigram
            # STARTS at it (the gram replaces its look-behind buffer), and drop
            # the FINAL unigram when a bigram ends at it (the filter's
            # end-of-stream `GRAM_TYPE.equals(previousType)` check). A middle
            # unigram that only ENDS a bigram survives: "the quick brown" →
            # [the_quick, quick, brown]
            drop = query_mode and (
                has_gram[i] or (i == n - 1 and i > 0 and has_gram[i - 1]))
            if not drop:
                out.append(t)
            if has_gram[i]:
                nxt = tokens[i + 1]
                out.append(Token(f"{t.term}_{nxt.term}", t.position, t.start,
                                 nxt.end))
        return out

    return apply


def make_stemmer_override_filter(settings: Settings):
    """Exact-match stemming overrides applied BEFORE stemmers; matched terms are
    keyword-marked so stemmers leave them alone
    (ref: index/analysis/StemmerOverrideTokenFilterFactory.java, rules "a => b")."""
    rules = {}
    for rule in settings.get_list("rules") or ():
        src, _, dst = str(rule).partition("=>")
        if dst:
            rules[src.strip()] = dst.strip()

    def apply(tokens: list[Token], _settings=None) -> list[Token]:
        for t in tokens:
            dst = rules.get(t.term)
            if dst is not None:
                t.term = "\x00" + dst  # keyword-mark; stemmers unmark
        return tokens

    return apply


def make_pattern_capture_filter(settings: Settings):
    """Emit each regex capture group as a token at the original position
    (ref: index/analysis/PatternCaptureGroupTokenFilterFactory.java)."""
    patterns = [re.compile(p) for p in settings.get_list("patterns") or ()]
    preserve = settings.get_bool("preserve_original", True)

    def apply(tokens: list[Token], _settings=None) -> list[Token]:
        out: list[Token] = []
        for t in tokens:
            emitted = set()
            if preserve:
                out.append(t)
                emitted.add(t.term)
            for pat in patterns:
                for m in pat.finditer(t.term):
                    groups = m.groups() or (m.group(0),)
                    for g in groups:
                        if g and g not in emitted:
                            emitted.add(g)
                            out.append(Token(g, t.position, t.start, t.end))
            if not preserve and not emitted:
                out.append(t)  # no groups matched: keep the original
        return out

    return apply


def unique_filter(tokens: list[Token], settings: Settings | None = None) -> list[Token]:
    seen = set()
    out = []
    for t in tokens:
        if t.term not in seen:
            seen.add(t.term)
            out.append(t)
    return out


def reverse_filter(tokens: list[Token], settings: Settings | None = None) -> list[Token]:
    for t in tokens:
        t.term = t.term[::-1]
    return tokens


def porter_stem_filter(tokens: list[Token], settings: Settings | None = None) -> list[Token]:
    for t in tokens:
        t.term = _porter_stem(t.term)
    return tokens


def kstem_filter(tokens: list[Token], settings: Settings | None = None) -> list[Token]:
    # light english stemmer: plural + common suffix strip (approximation of KStem)
    for t in tokens:
        t.term = _light_english_stem(t.term)
    return tokens


def make_shingle_filter(settings: Settings):
    min_size = settings.get_int("min_shingle_size", 2)
    max_size = settings.get_int("max_shingle_size", 2)
    sep = settings.get_str("token_separator", " ")
    output_unigrams = settings.get_bool("output_unigrams", True)

    def apply(tokens: list[Token], _settings=None) -> list[Token]:
        out = list(tokens) if output_unigrams else []
        for size in range(min_size, max_size + 1):
            for i in range(len(tokens) - size + 1):
                window = tokens[i : i + size]
                out.append(
                    Token(sep.join(t.term for t in window), window[0].position,
                          window[0].start, window[-1].end)
                )
        out.sort(key=lambda t: (t.position, t.end))
        return out

    return apply


def make_ngram_filter(settings: Settings, edge: bool = False):
    min_gram = settings.get_int("min_gram", 1)
    max_gram = settings.get_int("max_gram", 2)

    def apply(tokens: list[Token], _settings=None) -> list[Token]:
        out = []
        for t in tokens:
            for g in make_ngram_tokens(t.term, min_gram, max_gram, edge):
                out.append(Token(g, t.position, t.start, t.end))
        return out

    return apply


_WORD_DELIM_RE = re.compile(r"[^a-zA-Z0-9]+|(?<=[a-z])(?=[A-Z])|(?<=[A-Za-z])(?=\d)|(?<=\d)(?=[A-Za-z])")


def word_delimiter_filter(tokens: list[Token], settings: Settings | None = None) -> list[Token]:
    out = []
    for t in tokens:
        parts = [p for p in _WORD_DELIM_RE.split(t.term) if p]
        if len(parts) <= 1:
            out.append(t)
        else:
            for p in parts:
                out.append(Token(p, t.position, t.start, t.end))
    return out


def make_synonym_filter(settings: Settings):
    table: dict[str, list[str]] = {}
    for rule in settings.get_list("synonyms"):
        if "=>" in rule:
            lhs, rhs = rule.split("=>", 1)
            targets = [w.strip() for w in rhs.split(",") if w.strip()]
            for src in lhs.split(","):
                table[src.strip()] = targets
        else:
            group = [w.strip() for w in rule.split(",") if w.strip()]
            for w in group:
                table[w] = group

    def apply(tokens: list[Token], _settings=None) -> list[Token]:
        out = []
        for t in tokens:
            subs = table.get(t.term)
            if subs is None:
                out.append(t)
            else:
                for s in subs:
                    out.append(Token(s, t.position, t.start, t.end))
        return out

    return apply


def make_keyword_marker_filter(settings: Settings):
    keywords = frozenset(settings.get_list("keywords"))

    def apply(tokens: list[Token], _settings=None) -> list[Token]:
        for t in tokens:
            if t.term in keywords:
                t.term = "\x00" + t.term  # mark; stemmers unmark
        return tokens

    return apply


# --- stemmers --------------------------------------------------------------


def _light_english_stem(word: str) -> str:
    if word.startswith("\x00"):
        return word[1:]
    if len(word) < 4:
        return word
    if word.endswith("ies") and len(word) > 4:
        return word[:-3] + "y"
    if word.endswith("es") and not word.endswith(("ses", "zes", "xes")):
        return word[:-1]
    if word.endswith("s") and not word.endswith(("ss", "us", "is")):
        return word[:-1]
    return word


_VOWELS = set("aeiou")


def _measure(stem: str) -> int:
    """Porter 'measure' m: number of VC sequences."""
    cv = []
    for i, ch in enumerate(stem):
        is_v = ch in _VOWELS or (ch == "y" and i > 0 and stem[i - 1] not in _VOWELS)
        cv.append("v" if is_v else "c")
    s = "".join(cv)
    return len(re.findall(r"v+c+", s))


def _has_vowel(stem: str) -> bool:
    return any(
        ch in _VOWELS or (ch == "y" and i > 0 and stem[i - 1] not in _VOWELS)
        for i, ch in enumerate(stem)
    )


def _porter_stem(word: str) -> str:
    """Porter stemmer (1980 algorithm, steps 1-5). Implemented from the published
    algorithm description; matches Lucene's PorterStemFilter output on common English."""
    if word.startswith("\x00"):
        return word[1:]
    w = word
    if len(w) <= 2:
        return w

    def ends_cvc(s: str) -> bool:
        if len(s) < 3:
            return False
        c1, v, c2 = s[-3], s[-2], s[-1]
        return (
            c1 not in _VOWELS
            and (v in _VOWELS or (v == "y" and c1 not in _VOWELS))
            and c2 not in _VOWELS
            and c2 not in "wxy"
        )

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b
    flag_1b = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed") and _has_vowel(w[:-2]):
        w = w[:-2]
        flag_1b = True
    elif w.endswith("ing") and _has_vowel(w[:-3]):
        w = w[:-3]
        flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif len(w) >= 2 and w[-1] == w[-2] and w[-1] not in "lsz" and w[-1] not in _VOWELS:
            w = w[:-1]
        elif _measure(w) == 1 and ends_cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    step2 = [
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ]
    for suf, rep in step2:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 3
    step3 = [
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ]
    for suf, rep in step3:
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 4
    step4 = [
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement", "ment",
        "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ]
    for suf in sorted(step4, key=len, reverse=True):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                w = stem
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" and _measure(w[:-3]) > 1:
            w = w[:-3]
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not ends_cvc(stem)):
            w = stem
    # step 5b
    if len(w) >= 2 and w.endswith("ll") and _measure(w) > 1:
        w = w[:-1]
    return w


TOKEN_FILTERS: dict[str, Callable] = {
    "lowercase": lowercase_filter,
    "uppercase": uppercase_filter,
    "stop": stop_filter,
    "asciifolding": asciifolding_filter,
    "trim": trim_filter,
    "unique": unique_filter,
    "reverse": reverse_filter,
    "porter_stem": porter_stem_filter,
    "porterStem": porter_stem_filter,
    "snowball": porter_stem_filter,
    "stemmer": porter_stem_filter,
    "kstem": kstem_filter,
    "word_delimiter": word_delimiter_filter,
    "standard": lambda tokens, settings=None: tokens,  # StandardFilter is a no-op in 4.7
}

_PARAMETRIC_FILTERS: dict[str, Callable[[Settings], Callable]] = {
    "stop": make_stop_filter,
    "length": make_length_filter,
    "truncate": make_truncate_filter,
    "shingle": make_shingle_filter,
    "ngram": lambda s: make_ngram_filter(s, edge=False),
    "nGram": lambda s: make_ngram_filter(s, edge=False),
    "edge_ngram": lambda s: make_ngram_filter(s, edge=True),
    "edgeNGram": lambda s: make_ngram_filter(s, edge=True),
    "synonym": make_synonym_filter,
    "keyword_marker": make_keyword_marker_filter,
    "elision": make_elision_filter,
    "common_grams": make_common_grams_filter,
    "stemmer_override": make_stemmer_override_filter,
    "pattern_capture": make_pattern_capture_filter,
}

CHAR_FILTERS: dict[str, Callable] = {
    "html_strip": html_strip_char_filter,
}

_PARAMETRIC_CHAR_FILTERS = {
    "mapping": make_mapping_char_filter,
    "pattern_replace": make_pattern_replace_char_filter,
}


# ---------------------------------------------------------------------------
# analyzers
# ---------------------------------------------------------------------------


class Analyzer:
    """A full analysis chain: char filters → tokenizer → token filters."""

    def __init__(self, name: str, tokenizer: Callable, filters: list[Callable] | None = None,
                 char_filters: list[Callable] | None = None,
                 tokenizer_settings: Settings | None = None):
        self.name = name
        self.tokenizer = tokenizer
        self.filters = filters or []
        self.char_filters = char_filters or []
        self.tokenizer_settings = tokenizer_settings

    def analyze(self, text: str) -> list[Token]:
        if text is None:
            return []
        for cf in self.char_filters:
            text = cf(text)
        tokens = self.tokenizer(text, self.tokenizer_settings)
        for f in self.filters:
            tokens = f(tokens)
        # keyword marks (\x00 prefix from keyword_marker/stemmer_override) protect
        # terms from stemmers mid-chain; whatever survives to the end must be
        # stripped or the control byte would be INDEXED into the term
        for t in tokens:
            if t.term.startswith("\x00"):
                t.term = t.term[1:]
        return tokens

    def terms(self, text: str) -> list[str]:
        return [t.term for t in self.analyze(text)]

    def index_tokens(self, text: str) -> list[tuple[str, int]]:
        """(term, position) pairs — what the segment builder needs (offsets
        are only needed at fetch/highlight time, which re-analyzes)."""
        return [(t.term, t.position) for t in self.analyze(text)]


def _builtin_analyzers() -> dict[str, Analyzer]:
    return {
        "standard": Analyzer("standard", standard_tokenizer, [lowercase_filter]),
        "simple": Analyzer("simple", lowercase_tokenizer),
        "whitespace": Analyzer("whitespace", whitespace_tokenizer),
        "keyword": Analyzer("keyword", keyword_tokenizer),
        "stop": Analyzer("stop", lowercase_tokenizer, [stop_filter]),
        "english": Analyzer("english", standard_tokenizer,
                            [lowercase_filter, stop_filter, porter_stem_filter]),
        "default": Analyzer("standard", standard_tokenizer, [lowercase_filter]),
    }


# the built-in analyzers by name, for a request that names one without an
# index (`_analyze?analyzer=`)
ANALYZERS = _builtin_analyzers()


def get_analyzer(name: str) -> Analyzer:
    a = ANALYZERS.get(name)
    if a is None:
        raise IllegalArgumentError(f"unknown analyzer [{name}]")
    return a


class AnalysisService:
    """Per-index analyzer registry built from index settings
    (`index.analysis.{analyzer,tokenizer,filter,char_filter}.*` groups), mirroring
    index/analysis/AnalysisService.java."""

    def __init__(self, index_settings: Settings | None = None):
        self.analyzers: dict[str, Analyzer] = dict(_builtin_analyzers())
        settings = index_settings or Settings.EMPTY
        analysis = settings.by_prefix("index.analysis.") if any(
            k.startswith("index.analysis.") for k in settings
        ) else settings.by_prefix("analysis.")

        custom_tokenizers: dict[str, Callable] = {}
        for name, conf in analysis.groups("tokenizer.").items():
            ttype = conf.get_str("type", "standard")
            if ttype == "pattern":
                custom_tokenizers[name] = make_pattern_tokenizer(conf)
            elif ttype in TOKENIZERS:
                base = TOKENIZERS[ttype]
                custom_tokenizers[name] = (lambda b, c: lambda text, _s=None: b(text, c))(base, conf)
            else:
                raise IllegalArgumentError(f"unknown tokenizer type [{ttype}] for [{name}]")

        custom_filters: dict[str, Callable] = {}
        for name, conf in analysis.groups("filter.").items():
            ftype = conf.get_str("type", name)
            if ftype in _PARAMETRIC_FILTERS:
                custom_filters[name] = _PARAMETRIC_FILTERS[ftype](conf)
            elif ftype in TOKEN_FILTERS:
                custom_filters[name] = TOKEN_FILTERS[ftype]
            else:
                raise IllegalArgumentError(f"unknown token filter type [{ftype}] for [{name}]")

        custom_char_filters: dict[str, Callable] = {}
        for name, conf in analysis.groups("char_filter.").items():
            ctype = conf.get_str("type", name)
            if ctype in _PARAMETRIC_CHAR_FILTERS:
                custom_char_filters[name] = _PARAMETRIC_CHAR_FILTERS[ctype](conf)
            elif ctype in CHAR_FILTERS:
                custom_char_filters[name] = CHAR_FILTERS[ctype]
            else:
                raise IllegalArgumentError(f"unknown char filter type [{ctype}] for [{name}]")

        for name, conf in analysis.groups("analyzer.").items():
            atype = conf.get_str("type", "custom")
            if atype != "custom" and atype in self.analyzers:
                if atype == "standard" and conf.get("stopwords"):
                    self.analyzers[name] = Analyzer(
                        name, standard_tokenizer, [lowercase_filter, make_stop_filter(conf)]
                    )
                else:
                    self.analyzers[name] = self.analyzers[atype]
                continue
            tok_name = conf.get_str("tokenizer", "standard")
            tokenizer = custom_tokenizers.get(tok_name) or TOKENIZERS.get(tok_name)
            if tokenizer is None:
                raise IllegalArgumentError(f"unknown tokenizer [{tok_name}] in analyzer [{name}]")
            filters = []
            for fname in conf.get_list("filter"):
                f = custom_filters.get(fname) or TOKEN_FILTERS.get(fname)
                if f is None and fname in _PARAMETRIC_FILTERS:
                    f = _PARAMETRIC_FILTERS[fname](Settings.EMPTY)
                if f is None:
                    raise IllegalArgumentError(f"unknown filter [{fname}] in analyzer [{name}]")
                filters.append(f)
            char_filters = []
            for cname in conf.get_list("char_filter"):
                cf = custom_char_filters.get(cname) or CHAR_FILTERS.get(cname)
                if cf is None:
                    raise IllegalArgumentError(f"unknown char_filter [{cname}] in analyzer [{name}]")
                char_filters.append(cf)
            self.analyzers[name] = Analyzer(name, tokenizer, filters, char_filters)

    def analyzer(self, name: str | None) -> Analyzer:
        if name is None:
            return self.analyzers["default"]
        a = self.analyzers.get(name)
        if a is None:
            raise IllegalArgumentError(f"unknown analyzer [{name}]")
        return a
