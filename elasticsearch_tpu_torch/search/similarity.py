"""Similarity: Lucene-exact BM25 and classic TF-IDF (a trimmed copy of the
JAX package's `search/similarity.py`).

Each similarity gives the device two artifacts per (field, query): a scalar
per-term weight and a 256-entry norm-decode table (`norm_cache`), so the
scoring kernel is pure gather + arithmetic. All arithmetic is float32, as in
Lucene. The freq/norm-generic similarities (DFR, IB, LM*) score on the host
scorer, a later slice of the port."""

from __future__ import annotations

import math

import numpy as np

from ..common.errors import IllegalArgumentError
from ..common.settings import Settings
from ..common.smallfloat import NORM_TABLE, decode_norm_doclen


class Similarity:
    name = "base"

    def norm_cache(self, field_stats, max_docs: int) -> np.ndarray:
        """256-entry table indexed by the norm byte; meaning is similarity-specific."""
        raise NotImplementedError


class TFIDFSimilarity(Similarity):
    """Lucene DefaultSimilarity: tf = sqrt(freq), idf = 1 + ln(maxDocs/(df+1)),
    queryNorm = 1/sqrt(Σ (idf·boost)²), coord = overlap/maxOverlap."""

    name = "default"

    @staticmethod
    def idf(df: int, max_docs: int) -> float:
        return np.float32(1.0 + math.log(max_docs / (df + 1.0)))

    def norm_cache(self, field_stats, max_docs: int) -> np.ndarray:
        # TF-IDF: the decoded norm multiplies the score directly
        return NORM_TABLE.astype(np.float32)

    @staticmethod
    def query_norm(sum_sq_weights: float) -> float:
        if sum_sq_weights <= 0:
            return 1.0
        return np.float32(1.0 / math.sqrt(sum_sq_weights))


class BM25Similarity(Similarity):
    """Lucene 4.7 BM25Similarity: idf = ln(1 + (N - df + 0.5)/(df + 0.5)),
    tfNorm = freq·(k1+1) / (freq + k1·(1 - b + b·dl/avgdl))."""

    name = "BM25"

    def __init__(self, k1: float = 1.2, b: float = 0.75):
        self.k1 = float(k1)
        self.b = float(b)

    @staticmethod
    def idf(df: int, max_docs: int) -> float:
        return np.float32(math.log(1.0 + (max_docs - df + 0.5) / (df + 0.5)))

    def norm_cache(self, field_stats, max_docs: int) -> np.ndarray:
        """cache[b] = k1 * (1 - b + b * dl(byte)/avgdl) — the denominator addend."""
        sum_ttf = getattr(field_stats, "sum_ttf", 0) if field_stats else 0
        avgdl = (np.float32(1.0) if sum_ttf <= 0 or max_docs <= 0
                 else np.float32(sum_ttf / max_docs))
        dl = decode_norm_doclen(np.arange(256, dtype=np.uint8))
        return (self.k1 * (1.0 - self.b + self.b * dl / avgdl)).astype(np.float32)


_REGISTRY = {
    "default": TFIDFSimilarity,
    "tfidf": TFIDFSimilarity,
    "BM25": BM25Similarity,
    "bm25": BM25Similarity,
}


class SimilarityService:
    """Per-index similarity resolution: named configs from
    `index.similarity.<name>.*` settings, default from
    `index.similarity.default.type` (TF-IDF when unset)."""

    def __init__(self, index_settings: Settings | None = None,
                 mapper_service=None):
        settings = index_settings or Settings.EMPTY
        self.mapper_service = mapper_service
        self._named: dict[str, Similarity] = {}
        for name, conf in settings.groups("index.similarity.").items():
            stype = conf.get_str("type", name)
            self._named[name] = self._build(stype, conf)
        self.default: Similarity = self._named.get("default", TFIDFSimilarity())

    @staticmethod
    def _build(stype: str, conf: Settings) -> Similarity:
        cls = _REGISTRY.get(stype)
        if cls is None:
            raise IllegalArgumentError(
                f"similarity type [{stype}] is not ported yet (a later slice "
                "of the port serves DFR/IB/LM on the host scorer)")
        if cls is BM25Similarity:
            return BM25Similarity(conf.get_float("k1", 1.2), conf.get_float("b", 0.75))
        return cls()

    def for_field(self, field: str) -> Similarity:
        # string field mappings carry no per-field similarity in this slice,
        # so every field scores with the index default
        return self.default
