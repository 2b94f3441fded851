"""Similarity: Lucene-exact BM25 and classic TF-IDF, and the freq/norm
similarities DFR, IB, LMDirichlet and LMJelinekMercer (a copy of the JAX
package's `search/similarity.py`).

BM25 and TF-IDF give the device two artifacts per (field, query): a scalar
per-term weight and a 256-entry norm-decode table (`norm_cache`), so the
scoring kernel is pure gather + arithmetic. All arithmetic is float32, as in
Lucene. The freq/norm similarities (`FreqNormSimilarity.score_freqs`) score
on the host scorer only, as in the JAX package."""

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


class FreqNormSimilarity(Similarity):
    """Base for similarities scored as f(freq, doc_len, corpus stats) — the shape of
    Lucene's SimilarityBase, which the reference's DFR/IB providers build on
    (index/similarity/DFRSimilarityProvider.java, IBSimilarityProvider.java).

    These run on the host scorer path (the device kernel keeps its two fused
    fast-path modes, BM25/TF-IDF; queries over DFR/IB fields lower to host)."""

    def term_weight(self, boost: float, df: int, max_docs: int) -> float:
        return float(boost)

    def norm_cache(self, field_stats, max_docs: int) -> np.ndarray:
        return NORM_TABLE.astype(np.float32)

    def score_freqs(self, freqs: np.ndarray, doc_len: np.ndarray, df: int,
                    ttf: int, field_stats, max_docs: int,
                    boost: float) -> np.ndarray:
        """Vectorized over a term's postings: freqs[i] occurrences in a doc of
        doc_len[i] tokens → per-doc contribution."""
        raise NotImplementedError

    @staticmethod
    def _avgdl(field_stats, max_docs: int) -> float:
        sum_ttf = getattr(field_stats, "sum_ttf", 0) if field_stats else 0
        docs = getattr(field_stats, "doc_count", 0) or max_docs
        return float(sum_ttf) / docs if sum_ttf > 0 and docs > 0 else 1.0


_LOG2 = math.log(2.0)


def _log2(x):
    return np.log(np.maximum(x, 1e-12)) / _LOG2


class DFRSimilarity(FreqNormSimilarity):
    """Divergence-from-randomness framework (Amati & van Rijsbergen): score =
    boost · basic_model(tfn) · after_effect(tfn), tfn = length-normalized tf.
    Models/effects/normalizations match the reference's option set
    (DFRSimilarityProvider.java: be/d/g/if/in/ine × no/b/l × no/h1/h2/h3/z)."""

    name = "DFR"

    def __init__(self, basic_model: str = "g", after_effect: str = "l",
                 normalization: str = "h2", c: float = 1.0, mu: float = 800.0,
                 z: float = 0.3):
        self.basic_model = basic_model.lower()
        self.after_effect = after_effect.lower()
        self.normalization = normalization.lower()
        self.c, self.mu, self.z = float(c), float(mu), float(z)

    def _tfn(self, freqs, doc_len, field_stats, max_docs, ttf):
        avgdl = self._avgdl(field_stats, max_docs)
        dl = np.maximum(doc_len.astype(np.float64), 1.0)
        f = freqs.astype(np.float64)
        if self.normalization in ("no", "none"):
            return f
        if self.normalization == "h1":
            return f * (avgdl / dl)
        if self.normalization == "h2":
            return f * _log2(1.0 + self.c * avgdl / dl)
        if self.normalization == "h3":
            sum_ttf = (getattr(field_stats, "sum_ttf", 0) if field_stats else 0) or 1
            p = (ttf + 1.0) / (sum_ttf + 1.0)
            return (f + self.mu * p) / (dl + self.mu) * self.mu
        if self.normalization == "z":
            return f * (avgdl / dl) ** self.z
        return f * _log2(1.0 + self.c * avgdl / dl)

    def score_freqs(self, freqs, doc_len, df, ttf, field_stats, max_docs, boost):
        N = max(max_docs, 1)
        n = max(df, 1)
        F = max(ttf, n)
        tfn = np.maximum(self._tfn(freqs, doc_len, field_stats, max_docs, ttf), 1e-9)
        lam = F / float(N)
        m = self.basic_model
        if m == "be":
            # Bose-Einstein (Bernoulli approximation)
            score = -_log2(1.0 / (1.0 + lam)) - tfn * _log2(lam / (1.0 + lam))
        elif m == "g":
            lg = F / float(N + F)
            score = -_log2(1.0 / (1.0 + lg)) - tfn * _log2(lg / (1.0 + lg))
        elif m == "p":
            # Poisson approximation via Stirling
            score = tfn * _log2(tfn / lam) + (lam - tfn) / _LOG2 + \
                0.5 * _log2(2.0 * math.pi * tfn)
        elif m == "d":
            phi = tfn / (tfn + 1.0)
            score = tfn * _log2(tfn / lam) + (lam + 1.0 / 12.0 / tfn - tfn) / _LOG2 + \
                0.5 * _log2(2.0 * math.pi * tfn) * phi
        elif m == "in":
            score = tfn * _log2((N + 1.0) / (n + 0.5))
        elif m == "ine":
            ne = N * (1.0 - ((N - 1.0) / N) ** F)
            score = tfn * _log2((N + 1.0) / (ne + 0.5))
        else:  # "if" — inverse term frequency
            score = tfn * _log2((N + 1.0) / (F + 0.5))
        ae = self.after_effect
        if ae == "b":
            gain = (F + 1.0) / (n * (tfn + 1.0))
        elif ae in ("no", "none"):
            gain = 1.0
        else:  # "l" — Laplace
            gain = 1.0 / (tfn + 1.0)
        return np.maximum(boost * gain * score, 0.0).astype(np.float32)


class IBSimilarity(FreqNormSimilarity):
    """Information-based framework (Clinchant & Gaussier): score =
    boost · distribution(tfn, λ) with λ from df or ttf
    (ref: IBSimilarityProvider.java — distribution ll/spl, lambda df/ttf,
    normalization shared with DFR)."""

    name = "IB"

    def __init__(self, distribution: str = "ll", lambda_: str = "df",
                 normalization: str = "h2", c: float = 1.0):
        self.distribution = distribution.lower()
        self.lambda_ = lambda_.lower()
        self._norm = DFRSimilarity(normalization=normalization, c=c)

    def score_freqs(self, freqs, doc_len, df, ttf, field_stats, max_docs, boost):
        N = max(max_docs, 1)
        tfn = np.maximum(
            self._norm._tfn(freqs, doc_len, field_stats, max_docs, ttf), 1e-9)
        if self.lambda_ == "ttf":
            lam = (max(ttf, 1) + 1.0) / (N + 1.0)
        else:
            lam = (max(df, 1) + 1.0) / (N + 1.0)
        if self.distribution == "spl":
            score = -_log2((np.power(lam, tfn / (tfn + 1.0)) - lam) /
                           np.maximum(1.0 - lam, 1e-12))
        else:  # "ll" — log-logistic
            score = _log2((tfn + lam) / lam)
        return np.maximum(boost * score, 0.0).astype(np.float32)


class LMDirichletSimilarity(FreqNormSimilarity):
    """LM with Dirichlet smoothing (Lucene LMDirichletSimilarity shape)."""

    name = "LMDirichlet"

    def __init__(self, mu: float = 2000.0):
        self.mu = float(mu)

    def score_freqs(self, freqs, doc_len, df, ttf, field_stats, max_docs, boost):
        sum_ttf = (getattr(field_stats, "sum_ttf", 0) if field_stats else 0) or 1
        p = (max(ttf, 1) + 1.0) / (sum_ttf + 1.0)
        dl = np.maximum(doc_len.astype(np.float64), 0.0)
        score = np.log(1.0 + freqs / (self.mu * p)) + np.log(self.mu / (dl + self.mu))
        return np.maximum(boost * score, 0.0).astype(np.float32)


class LMJelinekMercerSimilarity(FreqNormSimilarity):
    """LM with Jelinek-Mercer smoothing (Lucene LMJelinekMercerSimilarity shape)."""

    name = "LMJelinekMercer"

    def __init__(self, lambda_: float = 0.1):
        self.lambda_ = float(lambda_)

    def score_freqs(self, freqs, doc_len, df, ttf, field_stats, max_docs, boost):
        sum_ttf = (getattr(field_stats, "sum_ttf", 0) if field_stats else 0) or 1
        p = (max(ttf, 1) + 1.0) / (sum_ttf + 1.0)
        dl = np.maximum(doc_len.astype(np.float64), 1.0)
        score = np.log(1.0 + ((1.0 - self.lambda_) * freqs / dl) / (self.lambda_ * p))
        return np.maximum(boost * score, 0.0).astype(np.float32)


_REGISTRY = {
    "default": TFIDFSimilarity,
    "tfidf": TFIDFSimilarity,
    "BM25": BM25Similarity,
    "bm25": BM25Similarity,
    "DFR": DFRSimilarity,
    "dfr": DFRSimilarity,
    "IB": IBSimilarity,
    "ib": IBSimilarity,
    "LMDirichlet": LMDirichletSimilarity,
    "LMJelinekMercer": LMJelinekMercerSimilarity,
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
            raise IllegalArgumentError(f"unknown similarity type [{stype}]")
        if cls is BM25Similarity:
            return BM25Similarity(conf.get_float("k1", 1.2), conf.get_float("b", 0.75))
        if cls is DFRSimilarity:
            return DFRSimilarity(
                basic_model=conf.get_str("basic_model", "g"),
                after_effect=conf.get_str("after_effect", "l"),
                normalization=conf.get_str("normalization", "h2"),
                c=conf.get_float("normalization.h2.c", conf.get_float("c", 1.0)),
                mu=conf.get_float("normalization.h3.mu", 800.0),
                z=conf.get_float("normalization.z.z", 0.3))
        if cls is IBSimilarity:
            return IBSimilarity(
                distribution=conf.get_str("distribution", "ll"),
                lambda_=conf.get_str("lambda", "df"),
                normalization=conf.get_str("normalization", "h2"),
                c=conf.get_float("normalization.h2.c", conf.get_float("c", 1.0)))
        if cls is LMDirichletSimilarity:
            return LMDirichletSimilarity(mu=conf.get_float("mu", 2000.0))
        if cls is LMJelinekMercerSimilarity:
            return LMJelinekMercerSimilarity(lambda_=conf.get_float("lambda", 0.1))
        return cls()

    def for_field(self, field: str) -> Similarity:
        # the JAX package's lookup, kept as is: its field types carry no
        # `similarity` attribute, so a mapping's `similarity` key has no effect
        # and every field scores with the index default
        if self.mapper_service is not None:
            ft = self.mapper_service.field_type(field)
            sim_name = getattr(ft, "similarity", None) if ft else None
            if sim_name and sim_name in self._named:
                return self._named[sim_name]
        return self.default
