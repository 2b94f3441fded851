"""The port's HyperLogLog++ and t-digest (`common/sketches.py`) against the JAX
package's: the cases of tests/test_sketches.py, each run through both
packages on the same seeded inputs. Both are numpy, so every hash, register,
centroid, estimate and quantile must be bitwise the same; the accuracy bounds
of tests/test_sketches.py hold too. A port sketch must also cross the wire
(pickle) and merge as the JAX package's does."""

import pickle

import numpy as np
import pytest

from elasticsearch_tpu.common import sketches as jsk
from elasticsearch_tpu_torch.common import sketches as tsk


def _hll_pair(p, feed):
    """(port sketch, JAX sketch) after `feed(sketch)` on each."""
    out = []
    for mod in (tsk, jsk):
        h = mod.HyperLogLogPlusPlus(p)
        feed(h)
        out.append(h)
    t, j = out
    np.testing.assert_array_equal(t.registers, j.registers)
    assert t.cardinality() == j.cardinality()
    return t


def _td_pair(compression, feed):
    out = []
    for mod in (tsk, jsk):
        td = mod.TDigest(compression)
        feed(td)
        out.append(td)
    t, j = out
    for q in (0.0, 0.01, 0.25, 0.5, 0.75, 0.95, 0.99, 1.0):
        assert t.quantile(q) == j.quantile(q)
    np.testing.assert_array_equal(t.means, j.means)
    np.testing.assert_array_equal(t.weights, j.weights)
    return t


class TestHLL:
    def test_small_range_exact(self):
        h = _hll_pair(14, lambda h: h.add_values(np.arange(2000)))
        assert abs(h.cardinality() - 2000) <= 20

    def test_large_range_bounded_error(self):
        h = _hll_pair(14, lambda h: h.add_values(np.arange(1_000_000) * 31 + 7))
        assert abs(h.cardinality() - 1_000_000) / 1_000_000 < 0.02

    def test_duplicates_do_not_count(self):
        def feed(h):
            for _ in range(5):
                h.add_values(np.arange(10_000))
        h = _hll_pair(14, feed)
        assert abs(h.cardinality() - 10_000) / 10_000 < 0.02

    def test_strings(self):
        h = _hll_pair(14, lambda h: h.add_values([f"user-{i}" for i in range(50_000)]))
        assert abs(h.cardinality() - 50_000) / 50_000 < 0.02

    def test_merge_with_overlap_and_wire(self):
        def feed_parts(mod):
            parts = [mod.HyperLogLogPlusPlus(12) for _ in range(4)]
            for i, p in enumerate(parts):
                p.add_values(np.arange(i * 20_000, (i + 1) * 20_000 + 4_000))
            merged = parts[0]
            for p in parts[1:]:
                merged.merge(pickle.loads(pickle.dumps(p)))  # across the wire
            return merged
        t, j = feed_parts(tsk), feed_parts(jsk)
        np.testing.assert_array_equal(t.registers, j.registers)
        assert t.cardinality() == j.cardinality()
        assert abs(t.cardinality() - 84_000) / 84_000 < 0.03

    def test_bounded_memory(self):
        h = _hll_pair(14, lambda h: h.add_values(np.arange(1_000_000)))
        assert h.registers.nbytes == 1 << 14

    @pytest.mark.parametrize("threshold", [1, 100, 3000, 10_000, 10_000_000])
    def test_precision_mapping(self, threshold):
        assert tsk.precision_from_threshold(threshold) == \
            jsk.precision_from_threshold(threshold)
        assert 4 <= tsk.precision_from_threshold(threshold) <= 18
        assert tsk.precision_from_threshold(100) < tsk.precision_from_threshold(3000)

    def test_hash_stability(self):
        ints = np.array([1, 2, 3, -5, 2**40])
        floats = np.array([0.0, -0.0, 1.5, -2.25, np.inf])
        strs = ["abc", "abcd", "abc\x00", "", "ü" * 20, "x" * 70]
        np.testing.assert_array_equal(tsk.hash64_ints(ints), jsk.hash64_ints(ints))
        np.testing.assert_array_equal(tsk.hash64_ints(floats), jsk.hash64_ints(floats))
        np.testing.assert_array_equal(tsk.hash64_strs(strs), jsk.hash64_strs(strs))
        s1 = tsk.hash64_strs(["abc", "abcd", "abc\x00"])
        assert len(set(s1.tolist())) == 3  # prefix/padding must not collide
        f = tsk.hash64_ints(floats)
        assert f[0] == f[1]  # -0.0 hashes as 0.0

    def test_merge_precision_mismatch_rejected(self):
        with pytest.raises(ValueError):
            tsk.HyperLogLogPlusPlus(10).merge(tsk.HyperLogLogPlusPlus(12))
        with pytest.raises(ValueError):
            tsk.HyperLogLogPlusPlus(3)

    def test_port_sketch_merges_a_pickled_one(self):
        a = tsk.HyperLogLogPlusPlus(12)
        a.add_values(np.arange(5000))
        b = pickle.loads(pickle.dumps(a))
        b.add_values(np.arange(5000, 9000))
        a.merge(b)
        j = jsk.HyperLogLogPlusPlus(12)
        j.add_values(np.arange(9000))
        np.testing.assert_array_equal(a.registers, j.registers)


class TestTDigest:
    def test_accuracy_normal(self):
        data = np.random.default_rng(3).normal(100, 15, 300_000)

        def feed(td):
            for chunk in np.array_split(data, 30):
                td.add_values(chunk)
        td = _td_pair(100, feed)
        for q in (0.01, 0.5, 0.95, 0.99):
            assert td.quantile(q) == pytest.approx(np.quantile(data, q), rel=0.01)

    def test_accuracy_heavy_tail(self):
        data = np.random.default_rng(4).pareto(3, 300_000)
        td = _td_pair(100, lambda td: td.add_values(data))
        for q in (0.5, 0.99):
            assert td.quantile(q) == pytest.approx(np.quantile(data, q), rel=0.02)

    def test_bounded_memory(self):
        data = np.random.default_rng(5).normal(0, 1, 500_000)

        def feed(td):
            for chunk in np.array_split(data, 50):
                td.add_values(chunk)
            td._compress()
        td = _td_pair(100, feed)
        assert len(td.means) <= 2 * td.compression

    def test_merge_matches_combined(self):
        data = np.random.default_rng(6).exponential(2.0, 200_000)

        def merged(mod):
            parts = [mod.TDigest(100) for _ in range(8)]
            for i, td in enumerate(parts):
                td.add_values(data[i::8])
            out = parts[0]
            for td in parts[1:]:
                out.merge(pickle.loads(pickle.dumps(td)))
            return out
        t, j = merged(tsk), merged(jsk)
        assert t.total == j.total == len(data)
        for q in (0.5, 0.95, 0.99):
            assert t.quantile(q) == j.quantile(q)
            assert t.quantile(q) == pytest.approx(np.quantile(data, q), rel=0.02)

    def test_merge_small_digests_stays_sorted(self):
        def feed(a):
            b = type(a)(100)
            a.add_values(np.array([100.0, 200.0]))
            b.add_values(np.array([1.0, 2.0]))
            a.merge(b)
        a = _td_pair(100, feed)
        assert np.all(np.diff(a.means) >= 0)
        qs = [a.quantile(q) for q in (0.25, 0.5, 0.75)]
        assert qs == sorted(qs)
        assert a.quantile(0.25) < 100.0 < a.quantile(0.9)

    def test_tiny_inputs_exact_interpolation(self):
        td = _td_pair(100, lambda td: td.add_values(np.array([10.0, 20, 30, 40, 50, 60])))
        assert td.quantile(0.5) == pytest.approx(35.0)
        assert td.quantile(0.0) == pytest.approx(10.0)
        assert td.quantile(1.0) == pytest.approx(60.0)
        assert tsk.TDigest(100).quantile(0.5) is None

    def test_compression_knob(self):
        data = np.random.default_rng(8).normal(0, 1, 100_000)

        def feed(td):
            td.add_values(data)
            td._compress()
        small, big = _td_pair(20, feed), _td_pair(400, feed)
        assert len(small.means) < len(big.means)
