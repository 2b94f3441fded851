"""The analysis chain of the default `string` mapping: the standard analyzer
(standard tokenizer + lowercase), on the pure-Python path (a trimmed copy of
the JAX package's `analysis/core.py`).

The standard tokenizer approximates Lucene's StandardTokenizer (UAX#29 word
boundaries) with a unicode-aware regex, exactly as the JAX package does, so
both packages index the same terms at the same positions."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable

from ..common.errors import IllegalArgumentError
from ..common.settings import Settings


@dataclass
class Token:
    __slots__ = ("term", "position", "start", "end")
    term: str
    position: int
    start: int
    end: int


# UAX#29-ish word: letters/digits runs, keeping internal apostrophes
_STANDARD_RE = re.compile(r"[^\W_]+(?:['’][^\W_]+)*", re.UNICODE)


def standard_tokenizer(text: str, max_token_length: int = 255) -> list[Token]:
    tokens = []
    pos = 0
    for m in _STANDARD_RE.finditer(text):
        term = m.group(0)
        if len(term) > max_token_length:
            continue
        tokens.append(Token(term, pos, m.start(), m.end()))
        pos += 1
    return tokens


def lowercase_filter(tokens: list[Token]) -> list[Token]:
    for t in tokens:
        t.term = t.term.lower()
    return tokens


class Analyzer:
    """A tokenizer followed by token filters."""

    def __init__(self, name: str, tokenizer: Callable,
                 filters: list[Callable] | None = None):
        self.name = name
        self.tokenizer = tokenizer
        self.filters = filters or []

    def analyze(self, text: str) -> list[Token]:
        if text is None:
            return []
        tokens = self.tokenizer(text)
        for f in self.filters:
            tokens = f(tokens)
        return tokens

    def terms(self, text: str) -> list[str]:
        return [t.term for t in self.analyze(text)]

    def index_tokens(self, text: str) -> list[tuple[str, int]]:
        """(term, position) pairs — what the segment builder needs."""
        return [(t.term, t.position) for t in self.analyze(text)]


def _builtin_analyzers() -> dict[str, Analyzer]:
    standard = Analyzer("standard", standard_tokenizer, [lowercase_filter])
    return {"standard": standard, "default": standard}


class AnalysisService:
    """Per-index analyzer registry. This slice of the port serves the built-in
    standard analyzer only; custom analysis settings raise."""

    def __init__(self, index_settings: Settings | None = None):
        settings = index_settings or Settings.EMPTY
        if any(k.startswith(("index.analysis.", "analysis.")) for k in settings):
            raise IllegalArgumentError(
                "custom analysis settings are not ported yet (a later slice "
                "of the port); this slice serves the standard analyzer")
        self.analyzers: dict[str, Analyzer] = _builtin_analyzers()

    def analyzer(self, name: str | None) -> Analyzer:
        if name is None:
            return self.analyzers["default"]
        a = self.analyzers.get(name)
        if a is None:
            raise IllegalArgumentError(
                f"unknown analyzer [{name}] (this slice of the port serves "
                "the standard analyzer)")
        return a
