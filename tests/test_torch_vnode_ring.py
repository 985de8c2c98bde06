"""The port's token histogram, skew-aware CREATE and empty-range skip
(``repro_torch.core.ring``, ``HREngine(partitions=…)``) against the
reference's (``repro.core``), on the CPU.

Mirrors ``tests/test_vnode_ring.py``'s ``TestTokenHistogram``,
``TestSkewAwareCreate`` (not its ``rebalance`` case: migration is not
ported) and ``TestEmptyRangeSkip``. Histograms, ring starts, per-partition
statistics, imbalances and skip counts must equal the reference's; the
port's histogram on a device (``add_tokens(device=…)``, here the CPU: the
``ecdf_hist`` wrapper's plain version) must equal ``np.bincount`` exactly.
Every schema is explicit; the hypothesis properties are derandomized.
"""

import importlib
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as R
import repro_torch.core as T
from repro.core.tpch import generate_simulation

LAYOUTS = [("k0", "k1", "k2"), ("k1", "k2", "k0"), ("k2", "k0", "k1")]
CPU = torch.device("cpu")


def _zipf_columns(rng, n, bits, a=1.3):
    """Zipf(a)-skewed key columns: equal token splits put almost every
    row in the first partition."""
    return {c: (np.minimum(rng.zipf(a, n), 1 << b) - 1).astype(np.int64) for c, b in bits.items()}


def _mixed_queries(pkg, seed, schema, n=24, value_col="metric"):
    rng = np.random.default_rng(seed)
    cols = list(schema.bits)
    doms = {c: schema.max_value(c) + 1 for c in cols}
    lead, resid = cols[0], cols[-1]
    qs = []
    for i in range(n):
        agg = ("count", "sum", "select")[i % 3]
        u = rng.random()
        if u < 0.35:
            f = {lead: pkg.Eq(int(rng.integers(0, doms[lead])))}
        elif u < 0.65:
            lo = int(rng.integers(0, doms[lead] - 1))
            width = int(rng.integers(1, max(2, doms[lead] // 3)))
            f = {lead: pkg.Range(lo, min(lo + width, doms[lead]))}
        else:
            lo = int(rng.integers(0, doms[resid] - 1))
            f = {resid: pkg.Range(lo, min(lo + 2, doms[resid]))}
        qs.append(pkg.Query(filters=f, agg=agg, value_col=value_col if agg == "sum" else None))
    return qs


def _create(pkg, kc, vc, bits, *, rf, n_nodes=6, layouts=LAYOUTS, **kw):
    eng = pkg.HREngine(n_nodes=n_nodes, **({"device": "cpu"} if pkg is T else {}))
    eng.create_column_family(
        "cf", kc, vc, replication_factor=rf, layouts=layouts[:rf], schema=pkg.KeySchema(dict(bits)), **kw,
    )
    return eng


def _assert_oracle_equal(eng, oracle, qs):
    for q, (a, _), (b, _) in zip(qs, oracle.read_many("cf", qs), eng.read_many("cf", qs)):
        assert b.rows_matched == a.rows_matched, q
        if q.agg == "sum":
            np.testing.assert_allclose(b.value, a.value, rtol=1e-9)
        else:
            assert b.value == a.value, q


def _assert_reads_equal(ref_out, port_out):
    for (ra, pa), (rb, pb) in zip(ref_out, port_out):
        assert (pa.replica_id, pa.node_id) == (pb.replica_id, pb.node_id)
        assert (ra.rows_scanned, ra.rows_matched) == (rb.rows_scanned, rb.rows_matched)
        np.testing.assert_allclose(ra.value, rb.value, rtol=1e-5, atol=1e-3)
        if ra.selected is not None:
            np.testing.assert_array_equal(ra.selected, rb.selected)


class TestTokenHistogram:
    def test_masses_partition_the_total(self):
        toks = np.random.default_rng(0).integers(0, 1 << 16, 5_000)
        hist, ref = T.TokenHistogram.build(total_bits=16), R.TokenHistogram.build(total_bits=16)
        hist.add_tokens(toks)
        ref.add_tokens(toks)
        assert hist.total == 5_000 and (hist.n_bins, hist.shift) == (ref.n_bins, ref.shift)
        starts = T.TokenRing.build(T.KeySchema({"a": 8, "b": 8}), ("a", "b"), 4).starts
        masses = hist.partition_masses(starts)
        assert masses.shape == (4,)
        np.testing.assert_allclose(masses.sum(), 5_000)
        np.testing.assert_array_equal(masses, ref.partition_masses(starts))

    def test_uniform_tokens_balanced_skewed_not(self):
        rng = np.random.default_rng(1)
        starts = T.TokenRing.build(T.KeySchema({"a": 8, "b": 8}), ("a", "b"), 4).starts
        hist_u, hist_s = T.TokenHistogram.build(16), T.TokenHistogram.build(16)
        hist_u.add_tokens(rng.integers(0, 1 << 16, 20_000))
        hist_s.add_tokens(rng.integers(0, 1 << 12, 20_000))  # the low 1/16 only
        assert hist_u.imbalance(starts) < 1.1
        assert hist_s.imbalance(starts) > 3.0

    def test_quantile_starts_balance_the_masses(self):
        toks = np.random.default_rng(2).integers(0, 1 << 14, 30_000)  # skewed low
        hist, ref = T.TokenHistogram.build(20), R.TokenHistogram.build(20)
        hist.add_tokens(toks)
        ref.add_tokens(toks)
        starts = hist.quantile_starts(8)
        assert starts == ref.quantile_starts(8)
        assert len(starts) == 8 and starts[0] == 0
        assert hist.imbalance(starts) < 1.2
        empty = T.TokenHistogram.build(20)
        assert empty.quantile_starts(4) == R.TokenHistogram.build(20).quantile_starts(4)

    @pytest.mark.parametrize("total_bits", [9, 16, 30])
    def test_device_accumulation_matches_host(self, total_bits, monkeypatch):
        """``add_tokens(device=…)`` calls the ``ecdf_hist_many`` wrapper
        once (its plain version on a CPU tensor) with one int32 row of
        bins at bin width 1; counts equal the host ``np.bincount`` and the
        reference's kernel path."""
        H = importlib.import_module("repro_torch.kernels.ecdf_hist")
        calls = []
        real = H.ecdf_hist_many

        def spy(cols, *, n_bins, bin_widths):
            calls.append((cols.dtype, tuple(cols.shape), list(n_bins), list(bin_widths)))
            return real(cols, n_bins=n_bins, bin_widths=bin_widths)

        monkeypatch.setattr(H, "ecdf_hist_many", spy)
        toks = np.random.default_rng(3).integers(0, 1 << total_bits, 4_000)
        h_host, h_dev = T.TokenHistogram.build(total_bits), T.TokenHistogram.build(total_bits)
        ref = R.TokenHistogram.build(total_bits)
        h_host.add_tokens(toks)
        assert calls == []
        h_dev.add_tokens(toks, device=CPU)
        h_dev.add_tokens(toks[:0], device=CPU)  # an empty batch launches nothing
        assert calls == [(torch.int32, (1, 4_000), [h_dev.n_bins], [1])]
        ref.add_tokens(toks, device=True)
        np.testing.assert_array_equal(h_dev.counts, h_host.counts)
        np.testing.assert_array_equal(h_dev.counts, ref.counts)
        np.testing.assert_array_equal(h_dev.counts, np.bincount(toks >> h_dev.shift, minlength=h_dev.n_bins))

    def test_from_tokens_rounds_duplicate_runs(self):
        toks = np.concatenate([np.zeros(50, np.int64), np.arange(1, 51, dtype=np.int64)])
        ring = T.TokenRing.from_tokens(T.KeySchema({"a": 6}), ("a",), toks, 2)
        assert ring.starts == (0, 1)
        assert T.TokenRing.from_tokens(T.KeySchema({"a": 6}), ("a",), toks[:0], 3).starts == (0, 21, 42)

    def test_from_histogram_and_with_starts(self):
        bits = {"a": 8, "b": 8}
        toks = np.random.default_rng(4).integers(0, 1 << 12, 8_000)
        hist, ref_hist = T.TokenHistogram.build(16), R.TokenHistogram.build(16)
        hist.add_tokens(toks)
        ref_hist.add_tokens(toks)
        ring = T.TokenRing.from_histogram(T.KeySchema(bits), ("a", "b"), hist, 5)
        ref = R.TokenRing.from_histogram(R.KeySchema(bits), ("a", "b"), ref_hist, 5)
        assert ring.starts == ref.starts
        with pytest.raises(ValueError, match="histogram covers"):
            T.TokenRing.from_histogram(T.KeySchema({"a": 8}), ("a",), hist, 2)
        assert ring.with_starts((0, 7, 900)).starts == (0, 7, 900)
        for bad in ((1, 5), (0, 5, 5), (0, 1 << 16)):
            with pytest.raises(ValueError, match="ring starts"):
                ring.with_starts(bad)

    @settings(max_examples=25, deadline=None, derandomize=True, database=None)
    @given(
        bits=st.integers(min_value=2, max_value=20),
        n=st.integers(min_value=0, max_value=600),
        parts=st.integers(min_value=1, max_value=6),
        seed=st.integers(min_value=0, max_value=2**16),
    )
    def test_property_ring_and_histogram_match_reference(self, bits, n, parts, seed):
        """Exact-quantile rings from any token stream, and the histogram on
        the device path, equal the reference's."""
        parts = min(parts, 1 << bits)
        rng = np.random.default_rng(seed)
        toks = np.minimum(rng.zipf(1.5, n), 1 << bits) - 1
        try:
            ref = R.TokenRing.from_tokens(R.KeySchema({"a": bits}), ("a",), toks, parts)
        except ValueError as e:
            # boundaries bumped past the space's end: the port refuses too
            with pytest.raises(ValueError, match=re.escape(str(e))):
                T.TokenRing.from_tokens(T.KeySchema({"a": bits}), ("a",), toks, parts)
            return
        ring = T.TokenRing.from_tokens(T.KeySchema({"a": bits}), ("a",), toks, parts)
        assert ring.starts == ref.starts
        np.testing.assert_array_equal(ring.partition_of_tokens(toks), ref.partition_of_tokens(toks))
        hist, rhist = T.TokenHistogram.build(bits), R.TokenHistogram.build(bits)
        hist.add_tokens(toks, device=CPU)
        rhist.add_tokens(toks)
        np.testing.assert_array_equal(hist.counts, rhist.counts)
        assert hist.imbalance(ring.starts) == rhist.imbalance(ring.starts)


class TestPartitionTokens:
    def test_observe_tokens_and_may_contain(self):
        part = T.Partition(partition_id=0, token_lo=0, token_hi=99, replicas=[])
        assert not part.may_contain(0, 99)
        assert part.n_rows_committed == 0
        part.observe_tokens(np.array([40, 20, 30]))
        part.observe_tokens(np.array([], dtype=np.int64))
        assert (part.token_min, part.token_max) == (20, 40)
        assert part.may_contain(0, 20) and part.may_contain(40, 99) and part.may_contain(25, 26)
        assert not part.may_contain(0, 19) and not part.may_contain(41, 99)
        assert part.flushed_lsn == {} and part.hints == {} and part.stats is None


class TestSkewAwareCreate:
    def test_tokens_balance_beats_equal_splits(self):
        bits = {"k0": 8, "k1": 8, "k2": 8}
        rng = np.random.default_rng(5)
        kc = _zipf_columns(rng, 6_000, bits)
        vc = {"metric": rng.uniform(0, 1, 6_000)}
        eq = _create(T, kc, vc, bits, rf=2, partitions=4)
        tk = _create(T, kc, vc, bits, rf=2, partitions=4, partition_balance="tokens")
        ref = _create(R, kc, vc, bits, rf=2, partitions=4, partition_balance="tokens")
        ref_eq = _create(R, kc, vc, bits, rf=2, partitions=4)
        assert tk.column_families["cf"].ring.starts == ref.column_families["cf"].ring.starts
        assert tk.partition_imbalance("cf") == ref.partition_imbalance("cf") <= 1.25
        assert eq.partition_imbalance("cf") == ref_eq.partition_imbalance("cf") > tk.partition_imbalance("cf")
        oracle = _create(T, kc, vc, bits, rf=2, partitions=1)
        tq = _mixed_queries(T, 6, T.KeySchema(bits), n=18)
        _assert_reads_equal(ref.read_many("cf", _mixed_queries(R, 6, R.KeySchema(bits), n=18)), tk.read_many("cf", tq))
        _assert_oracle_equal(tk, oracle, tq)

    def test_invalid_balance_rejected(self):
        kc, vc, schema = generate_simulation(500, 3, seed=0)
        with pytest.raises(ValueError, match="partition_balance"):
            _create(T, kc, vc, schema.bits, rf=1, partitions=2, partition_balance="zipf")

    def test_per_partition_stats_cover_exactly_own_rows(self):
        kc, vc, schema = generate_simulation(3_000, 3, seed=7)
        eng, ref = (_create(pkg, kc, vc, schema.bits, rf=3, partitions=4) for pkg in (T, R))
        cf, rcf = eng.column_families["cf"], ref.column_families["cf"]
        assert sum(p.stats.n_rows for p in cf.partitions) == 3_000
        for p, rp in zip(cf.partitions, rcf.partitions):
            assert p.stats.n_rows == p.n_rows_committed == rp.stats.n_rows
            for c in p.stats.columns:
                np.testing.assert_array_equal(p.stats.columns[c].counts, rp.stats.columns[c].counts)
        assert _create(T, kc, vc, schema.bits, rf=3, partitions=1).column_families["cf"].partitions[0].stats is None

    def test_stats_track_routed_writes(self):
        kc, vc, schema = generate_simulation(2_000, 3, seed=8)
        rng = np.random.default_rng(8)
        bk = {c: rng.integers(0, schema.max_value(c) + 1, 300).astype(np.int64) for c in ("k0", "k1", "k2")}
        bv = {"metric": rng.uniform(0, 1, 300)}
        eng, ref = (_create(pkg, kc, vc, schema.bits, rf=3, partitions=3) for pkg in (T, R))
        eng.write("cf", bk, bv)
        ref.write("cf", bk, bv)
        cf, rcf = eng.column_families["cf"], ref.column_families["cf"]
        for p, rp in zip(cf.partitions, rcf.partitions):
            assert p.stats.n_rows == p.n_rows_committed == rp.stats.n_rows
            for c in p.stats.columns:
                np.testing.assert_array_equal(p.stats.columns[c].counts, rp.stats.columns[c].counts)
        assert sum(p.stats.n_rows for p in cf.partitions) == 2_300
        np.testing.assert_array_equal(cf.token_hist.counts, rcf.token_hist.counts)
        assert cf.token_hist.total == 2_300


class TestEmptyRangeSkip:
    BITS = {"k0": 4, "k1": 4}

    def _gapped(self, pkg, rf=2):
        """k0 in the upper half only: partition 0 of a 2-way equal split
        owns no rows."""
        rng = np.random.default_rng(50)
        n = 1_000
        kc = {"k0": rng.integers(8, 16, n).astype(np.int64), "k1": rng.integers(0, 16, n).astype(np.int64)}
        vc = {"metric": rng.uniform(0, 1, n)}
        eng = _create(pkg, kc, vc, self.BITS, rf=rf, n_nodes=4, layouts=[("k0", "k1"), ("k1", "k0")], partitions=2)
        return eng, n

    def test_empty_partition_skipped_not_scanned(self):
        (eng, n), (ref, _) = self._gapped(T), self._gapped(R)
        q = T.Query(filters={"k0": T.Range(0, 16)}, agg="count")
        (res, _), = eng.read_many("cf", [q])
        ref.read_many("cf", [R.Query(filters={"k0": R.Range(0, 16)}, agg="count")])
        assert res.value == n
        assert eng.stats["empty_partition_skips"] == ref.stats["empty_partition_skips"] >= 1
        assert eng.stats["result_cache_misses"] == ref.stats["result_cache_misses"] == 1

    def test_fully_skipped_query_yields_empty_result(self):
        eng, _ = self._gapped(T)
        skips0 = eng.stats["empty_partition_skips"]
        (res, rep), = eng.read_many("cf", [T.Query(filters={"k0": T.Eq(2)}, agg="select")])
        assert res.value == 0 and res.rows_matched == 0
        assert res.selected is not None and len(res.selected) == 0
        assert rep.replica_id == -1 and rep.node_id == -1
        assert eng.stats["empty_partition_skips"] > skips0
        (res, rep), = eng.read_many("cf", [T.Query(filters={"k0": T.Eq(3)}, agg="sum", value_col="metric")])
        assert res.selected is None and (res.value, rep.replica_id) == (0.0, -1)

    def test_skip_disarms_after_first_routed_write(self):
        eng, n = self._gapped(T)
        eng.write("cf", {"k0": np.array([2, 3]), "k1": np.array([1, 1])}, {"metric": np.array([0.5, 0.5])})
        assert eng.column_families["cf"].partitions[0].may_contain(0, 1 << 7)
        (res, _), = eng.read_many("cf", [T.Query(filters={"k0": T.Range(0, 8)}, agg="count")])
        assert res.value == 2
        (res, _), = eng.read_many("cf", [T.Query(filters={"k0": T.Range(0, 16)}, agg="count")])
        assert res.value == n + 2

    def test_skip_matches_unskipped_oracle_and_reference(self):
        (eng, _), (ref, _) = self._gapped(T, rf=1), self._gapped(R, rf=1)
        cf = eng.column_families["cf"]
        kc_o, vc_o = cf.partitions[1].commitlog.replay_columns()
        oracle = _create(T, kc_o, vc_o, self.BITS, rf=1, n_nodes=4, layouts=[("k0", "k1")], partitions=1)
        tq = _mixed_queries(T, 51, cf.schema, n=18)
        _assert_reads_equal(ref.read_many("cf", _mixed_queries(R, 51, R.KeySchema(self.BITS), n=18)), eng.read_many("cf", tq))
        assert eng.stats["empty_partition_skips"] == ref.stats["empty_partition_skips"] > 0
        _assert_oracle_equal(eng, oracle, tq)
