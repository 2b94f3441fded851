"""The port's scripts against the JAX package's.

- The torch twin of the script vectorizer (the device tier of the
  function_score script family) equals the port's `ColumnVectorizer` and
  the JAX package's `jax_vectorizer_cls` on the same columns and scores:
  float32 against float32 within 4 ulp (transcendental functions are
  libraries' own roundings), against the float64 numpy tier at rtol 1e-6;
  the same NaN and infinity positions.
- Numbers the script combines with each other are float32 device values in
  the torch twin, as in `jax.numpy`.
- The sandbox: every escape and disallowed construct raises ScriptError in
  both packages at compile time; runtime domain errors and a missing value
  raise ScriptError per doc in both; the vectorizable subset is the same.
- The `script` filter over REST-shaped bodies matches the JAX package's
  masks on both packages' engines."""

import numpy as np
import pytest
import torch

from elasticsearch_tpu.common.errors import ScriptError as JScriptError
from elasticsearch_tpu.common.jaxenv import compile_tag
from elasticsearch_tpu.common.settings import Settings as JSettings
from elasticsearch_tpu.index.engine import Engine as JEngine
from elasticsearch_tpu.mapper.core import MapperService as JMapperService
from elasticsearch_tpu.script import ColumnVectorizer as JColumnVectorizer
from elasticsearch_tpu.script import compile_script as jcompile
from elasticsearch_tpu.script import jax_vectorizer_cls
from elasticsearch_tpu.script import script_vector_info as jvector_info
from elasticsearch_tpu.search import ShardContext as JShardContext
from elasticsearch_tpu.search.filters import DocAccess as JDocAccess
from elasticsearch_tpu.search.filters import segment_mask as jsegment_mask
from elasticsearch_tpu.search.queries import parse_filter as jparse_filter
from elasticsearch_tpu.search.similarity import SimilarityService as JSim
from elasticsearch_tpu_torch.common.errors import ScriptError
from elasticsearch_tpu_torch.common.settings import Settings as TSettings
from elasticsearch_tpu_torch.index.engine import Engine as TEngine
from elasticsearch_tpu_torch.mapper import MapperService as TMapperService
from elasticsearch_tpu_torch.script import (
    ColumnVectorizer, check_lang, compile_script, script_uses_score,
    script_vector_info, torch_vectorizer_cls)
from elasticsearch_tpu_torch.search import ShardContext, SimilarityService, parse_filter
from elasticsearch_tpu_torch.search.filters import DocAccess, segment_mask
from tests.test_torch_dense import _within_ulps

VECTOR_SCRIPTS = [
    "_score * 2",
    "_score * log(2 + doc['p'].value)",
    "_score * f + doc['p'].value / d",
    "_score if doc['p'].empty else _score + log(doc['p'].value)",
    "1 if doc['p'].empty else min(doc['p'].value, 10) + max(_score, 0.5)",
    "(doc['p'].value * f if doc['p'].value > 5 else doc['p'].value / f) - _score",
    "sqrt(abs(doc['p'].value - 5)) * exp(-_score)",
    "(not doc['p'].empty) and log(doc['p'].value + 1) or _score",
    "pow(_score, 2) + doc['q'].value % 3 - floor(doc['p'].value) // 2",
    "round(_score * 10) / 10 + ceil(doc['q'].value) + sin(_score) * cos(_score)",
    "tan(_score / 4) + log10(1 + doc['q'].value) - -_score",
    "_score * (2.5 * 1.3) + 1 / 3",
    "_score >= 1.5",
]
PARAMS = {"f": 2.0, "d": 10}


def _columns(seed: int = 3, D: int = 257):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 12, D)
    p[rng.random(D) < 0.15] = np.nan  # missing values
    p[:3] = (0.0, 1.0, 5.0)  # log(0) and exact ties at the branch point
    q = rng.integers(0, 9, D).astype(np.float64)
    scores = rng.uniform(0, 3, (2, D)).astype(np.float32)
    return {"p": p, "q": q}, scores


@pytest.mark.parametrize("src", VECTOR_SCRIPTS)
def test_torch_vectorizer_equals_numpy_and_jax(src):
    import jax.numpy as jnp

    cols, scores = _columns()
    script = compile_script(src, PARAMS)
    jscript = jcompile(src, PARAMS)
    assert script_vector_info(script) == jvector_info(jscript)
    assert script_vector_info(script)[0]
    f32 = {f: c.astype(np.float32) for f, c in cols.items()}
    tvec = torch_vectorizer_cls()(script, lambda f: torch.from_numpy(f32[f]),
                                  torch.from_numpy(scores))
    got = np.broadcast_to(tvec.vectorize().to(torch.float32).numpy(), scores.shape)
    with compile_tag("function_score"):
        jvec = jax_vectorizer_cls()(jscript, lambda f: jnp.asarray(f32[f]),
                                    jnp.asarray(scores))
        jax_out = np.broadcast_to(np.asarray(jvec.vectorize(), np.float32),
                                  scores.shape)
    host = np.broadcast_to(np.asarray(
        ColumnVectorizer(script, cols.get, scores.astype(np.float64)).vectorize(),
        np.float64), scores.shape)
    jhost = np.broadcast_to(np.asarray(
        JColumnVectorizer(jscript, cols.get, scores.astype(np.float64)).vectorize(),
        np.float64), scores.shape)
    np.testing.assert_array_equal(host, jhost)
    assert tvec.used_fields == jvec.used_fields
    for ref in (jax_out, host):
        fin = np.isfinite(ref)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=1e-6)
    fin = np.isfinite(jax_out)
    assert all(_within_ulps(a, b, 4) for a, b in zip(got[fin], jax_out[fin]))


def test_numbers_combine_in_float32_as_in_jax():
    """0.1 * 1.1 - 0.1 is 0.010000005 in float32 operations and 0.01 in
    Python's float64: the torch twin, like `jax.numpy`, computes numbers on
    the device in float32."""
    import jax.numpy as jnp

    src = "0.1 * 1.1 - 0.1 + _score * 0"
    scores = np.zeros((1, 2), np.float32)
    got = torch_vectorizer_cls()(compile_script(src), lambda f: None,
                                 torch.from_numpy(scores)).vectorize()
    with compile_tag("function_score"):
        want = jax_vectorizer_cls()(jcompile(src), lambda f: None,
                                    jnp.asarray(scores)).vectorize()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0].item() != np.float32(0.01)


ESCAPES = [
    "().__class__.__bases__[0].__subclasses__()",
    "__import__('os').system('true')",
    "open('/etc/hostname').read()",
    "(lambda: 1)()",
    "[x for x in range(3)]",
    "doc.__dict__",
    "exec('1')",
    "_score.real",
    "{'a': 1}",
    "x := 1",
    "getattr(doc, 'seg')",
    "1 if",
]


@pytest.mark.parametrize("src", ESCAPES)
def test_sandbox_escapes_raise_in_both(src):
    with pytest.raises(JScriptError):
        jcompile(src)
    with pytest.raises(ScriptError):
        compile_script(src)


def test_languages_and_score_readers():
    for lang in (None, "mvel", "expression", "native", "python"):
        check_lang(lang)
    with pytest.raises(ScriptError, match="script_lang"):
        compile_script("1", lang="groovy")
    assert script_uses_score(compile_script("_score + 1"))
    assert not script_uses_score(compile_script("_score + 1", {"_score": 2.0}))
    assert not script_uses_score(compile_script("doc['p'].value"))
    # outside the vectorizable subset in both packages
    for src in ("doc['p'].values[0]", "pow(2, 3, 5)", "1 in p"):
        assert script_vector_info(compile_script(src)) == jvector_info(jcompile(src))
        assert not script_vector_info(compile_script(src))[0]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(JAX context, port context) over the same 60 documents: a numeric
    `n` (missing on some, 0 on some) and a text field."""
    rng = np.random.default_rng(5)
    docs = []
    for i in range(60):
        d = {"t": "x y" if i % 2 else "y"}
        if i % 9:
            d["n"] = float(rng.integers(0, 20))
        docs.append(d)
    jsvc = JMapperService(JSettings.from_flat({}))
    jeng = JEngine(str(tmp_path_factory.mktemp("jax_script")), jsvc)
    tsvc = TMapperService(TSettings.from_flat({}))
    teng = TEngine(str(tmp_path_factory.mktemp("port_script")), tsvc)
    try:
        for eng in (jeng, teng):
            for i, d in enumerate(docs):
                eng.index("doc", str(i), d)
            eng.refresh()
        yield (JShardContext(jeng.acquire_searcher(), jsvc,
                             JSim(JSettings.from_flat({}), mapper_service=jsvc)),
               ShardContext(teng.acquire_searcher(), tsvc,
                            SimilarityService(TSettings.from_flat({}), tsvc),
                            device="cpu"))
    finally:
        jeng.close()
        teng.close()


@pytest.mark.parametrize("body", [
    {"script": {"script": "not doc['n'].empty and doc['n'].value > 7"}},
    {"script": {"script": "not doc['n'].empty and doc['n'].value % m == 0",
                "params": {"m": 3}}},
    {"script": {"script": "doc['n'].empty"}},
    {"bool": {"must": [{"script": {"script": "doc['n'].empty or doc['n'].value * 2 >= 10"}}],
              "must_not": [{"term": {"t": "x"}}]}},
])
def test_script_filter_masks_match_jax(engines, body):
    jctx, tctx = engines
    for jseg, tseg in zip(jctx.searcher.segments, tctx.searcher.segments):
        want = jsegment_mask(jseg, jparse_filter(body), jctx)
        np.testing.assert_array_equal(segment_mask(tseg, parse_filter(body), tctx), want)
        assert want.any()


@pytest.mark.parametrize("src", ["doc['n'].value > 7 and log(doc['n'].value) > 1",
                                 "doc['n'].value + 1"])
def test_runtime_errors_raise_in_both(engines, src):
    """A missing value compares as None (a TypeError) and log(0) is a
    domain error: both raise ScriptError per doc in both packages."""
    jctx, tctx = engines
    body = {"script": {"script": src}}
    with pytest.raises(JScriptError):
        jsegment_mask(jctx.searcher.segments[0], jparse_filter(body), jctx)
    with pytest.raises(ScriptError):
        segment_mask(tctx.searcher.segments[0], parse_filter(body), tctx)


def test_doc_access_reads_numbers_and_refuses_string_values(engines):
    """Numbers, then string doc values (`dv_str`): a script reading a
    string field answers with the doc's value, as the JAX package's
    DocAccess does (before the string doc values were ported it raised)."""
    jctx, tctx = engines
    seg = tctx.searcher.segments[0]
    local = next(i for i in range(seg.doc_count) if len(seg.num_values("n", i)))
    acc = DocAccess(seg, local)
    assert acc["n"].value == seg.num_values("n", local)[0] and not acc["n"].empty
    assert acc["absent"].empty and acc["absent"].value is None
    jseg = jctx.searcher.segments[0]
    for i in range(seg.doc_count):
        got = compile_script("doc['t'].value")(DocAccess(seg, i))
        assert got == jcompile("doc['t'].value")(JDocAccess(jseg, i))
        assert got in ("x y", "y")
