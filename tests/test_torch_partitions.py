"""Partitioned column families of the port (``repro_torch.core``: the token
ring, ``merge_partial_scans`` and the engine's scatter-gather ``read_many``
and routed writes), on ``device="cpu"``, against the reference
(``repro.core``) on the same numpy inputs.

Mirrors ``tests/test_partitioning.py`` (its token ring, partial-scan
merge, ``P = 1`` identity, read equivalence, write routing and device
path; hedged reads and node failure are not ported). Both engines get the
same explicit ``KeySchema`` and must agree on ring starts, HRCA layouts,
the replica picked for every query (``replica_id`` and ``node_id``),
``rows_scanned``, ``rows_matched``, counts and select indices exactly,
and sums within rtol 1e-5 / atol 1e-3; a ``P``-partition family must also
answer like the ``P = 1`` oracle over the same rows. The reference's
device-resident families run its kernels in Pallas interpret mode.
"""

import copy
import itertools

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.core.tpch import generate_orders, generate_simulation, orders_schema, q1_q2_workload

LAYOUTS = [("k0", "k1", "k2"), ("k1", "k2", "k0"), ("k2", "k0", "k1")]
RTOL, ATOL = 1e-5, 1e-3


def _tschema(schema):
    return T.KeySchema(dict(schema.bits))


def _mixed_queries(pkg, seed, schema, n=24, value_col="metric"):
    """Leading-key equalities (one partition), leading-key ranges (a span
    of partitions), residual-only filters (every partition), over the
    three aggregations, in ``pkg``'s query types."""
    rng = np.random.default_rng(seed)
    doms = {c: schema.max_value(c) + 1 for c in ("k0", "k1", "k2")}
    aggs = itertools.cycle(["count", "sum", "select"])
    qs = []
    for _ in range(n):
        agg = next(aggs)
        u = rng.random()
        if u < 0.35:
            f = {"k0": pkg.Eq(int(rng.integers(0, doms["k0"])))}
        elif u < 0.65:
            lo = int(rng.integers(0, doms["k0"] - 1))
            width = int(rng.integers(1, max(2, doms["k0"] // 3)))
            f = {"k0": pkg.Range(lo, min(lo + width, doms["k0"]))}
            if rng.random() < 0.5:
                f["k2"] = pkg.Eq(int(rng.integers(0, doms["k2"])))
        else:
            lo = int(rng.integers(0, doms["k1"] - 1))
            f = {"k1": pkg.Range(lo, min(lo + 2, doms["k1"]))}
        qs.append(pkg.Query(filters=f, agg=agg, value_col=value_col if agg == "sum" else None))
    return qs


def _pair(kc, vc, schema, *, partitions, rf=3, n_nodes=6, engine_kw=None, **cf_kw):
    """The reference and the port, each with the same column family."""
    engine_kw = engine_kw or {}
    ref = R.HREngine(n_nodes=n_nodes, **engine_kw)
    port = T.HREngine(n_nodes=n_nodes, device="cpu", **engine_kw)
    for eng, sch in ((ref, schema), (port, _tschema(schema))):
        eng.create_column_family(
            "cf", kc, vc, replication_factor=rf, layouts=LAYOUTS[:rf], schema=sch,
            partitions=partitions, **cf_kw,
        )
    return ref, port


def _batch(seed, schema, n):
    rng = np.random.default_rng(seed)
    bk = {c: rng.integers(0, schema.max_value(c) + 1, n).astype(np.int64) for c in ("k0", "k1", "k2")}
    return bk, {"metric": rng.uniform(0, 1, n)}


def _assert_results_equal(ref_out, port_out, *, routing=True):
    assert len(ref_out) == len(port_out)
    for (ra, pa), (rb, pb) in zip(ref_out, port_out):
        if routing:
            assert (pa.replica_id, pa.node_id) == (pb.replica_id, pb.node_id)
        assert (ra.rows_scanned, ra.rows_matched) == (rb.rows_scanned, rb.rows_matched)
        np.testing.assert_allclose(ra.value, rb.value, rtol=RTOL, atol=ATOL)
        if ra.selected is None:
            assert rb.selected is None
        else:
            np.testing.assert_array_equal(ra.selected, rb.selected)


def _selected_rows(eng, selected):
    """Materialize a partitioned (RF = 1) engine's global select indices
    into (keys..., value) rows, the form the P = 1 comparison uses."""
    cf = eng.column_families["cf"]
    offsets = eng._partition_row_offsets(cf)
    pids = np.searchsorted(offsets, selected, side="right") - 1
    rows = []
    for pid, g in zip(pids, selected):
        t = eng._table(cf, cf.partitions[int(pid)].replicas[0])
        li = int(g - offsets[int(pid)])
        rows.append(
            tuple(int(t.key_cols[c][li]) for c in cf.key_names)
            + (float(np.asarray(t.value_cols["metric"])[li]),)
        )
    return sorted(rows)


class TestTokenRing:
    @pytest.mark.parametrize("partitions", [1, 3, 5])
    def test_ranges_partition_the_space_as_the_reference(self, partitions):
        bits = {"a": 5, "b": 3}
        ring = T.TokenRing.build(T.KeySchema(bits), ("a", "b"), partitions)
        ref = R.TokenRing.build(R.KeySchema(bits), ("a", "b"), partitions)
        assert (ring.starts, ring.total_bits) == (ref.starts, ref.total_bits)
        prev_hi = -1
        for p in range(partitions):
            lo, hi = ring.token_range(p)
            assert (lo, hi) == ref.token_range(p)
            assert lo == prev_hi + 1 and hi >= lo
            prev_hi = hi
        assert prev_hi == (1 << ring.total_bits) - 1

    def test_partition_of_tokens_matches_reference(self):
        bits = {"a": 6, "b": 4}
        ring = T.TokenRing.build(T.KeySchema(bits), ("a", "b"), 7)
        ref = R.TokenRing.build(R.KeySchema(bits), ("a", "b"), 7)
        tokens = np.random.default_rng(0).integers(0, 1 << ring.total_bits, 500)
        pids = ring.partition_of_tokens(tokens)
        np.testing.assert_array_equal(pids, ref.partition_of_tokens(tokens))
        for t, p in zip(tokens, pids):
            lo, hi = ring.token_range(int(p))
            assert lo <= int(t) <= hi

    def test_rows_route_by_canonical_packing(self):
        schema = T.KeySchema({"a": 4, "b": 4})
        ring = T.TokenRing.build(schema, ("a", "b"), 4)
        kc = {"a": np.array([0, 5, 10, 15]), "b": np.array([0, 0, 0, 0])}
        np.testing.assert_array_equal(ring.partition_of_tokens(ring.tokens(kc, schema)), [0, 1, 2, 3])

    def test_span_partitions_pins_and_fans(self):
        spans = []
        for pkg in (T, R):
            schema = pkg.KeySchema({"a": 4, "b": 4})
            ring = pkg.TokenRing.build(schema, ("a", "b"), 4)
            qs = [
                pkg.Query(filters={"a": pkg.Eq(5)}),
                pkg.Query(filters={"a": pkg.Range(3, 13)}),
                pkg.Query(filters={"b": pkg.Eq(2)}),
                pkg.Query(filters={"a": pkg.Range(5, 5)}),
            ]
            p_lo, p_hi = ring.span_partitions(pkg.slab_bounds_many(qs, ("a", "b"), schema))
            spans.append((p_lo.tolist(), p_hi.tolist()))
        (p_lo, p_hi), ref = spans
        assert (p_lo, p_hi) == ref
        assert p_lo[0] == p_hi[0] == 1
        assert (p_lo[1], p_hi[1]) == (p_lo[2], p_hi[2]) == (0, 3)
        assert p_lo[3] == p_hi[3]

    def test_build_validation(self):
        schema = T.KeySchema({"a": 2})
        for n in (0, 5):
            with pytest.raises(ValueError, match="partitions"):
                T.TokenRing.build(schema, ("a",), n)

    def test_placement_consistent_with_engine(self):
        eng = T.HREngine(n_nodes=7, device="cpu")
        for rid in range(12):
            assert eng._place(rid, "orders") == T.place_replica("orders", rid, 7) == R.place_replica("orders", rid, 7)


class TestMergePartialScans:
    def test_aggregates_add_and_selects_offset(self):
        def merged(pkg):
            a = pkg.ScanResult(3.0, 10, 3, selected=np.array([0, 2, 5]))
            b = pkg.ScanResult(2.0, 4, 2, selected=np.array([1, 3]))
            s = pkg.merge_partial_scans([(pkg.ScanResult(1.5, 7, 4), 0), (pkg.ScanResult(2.5, 3, 1), 7)], "sum")
            return pkg.merge_partial_scans([(a, 0), (b, 100)], "select"), s

        (m, s), (rm, rs) = merged(T), merged(R)
        assert (m.value, m.rows_scanned, m.rows_matched) == (rm.value, rm.rows_scanned, rm.rows_matched) == (5.0, 14, 5)
        np.testing.assert_array_equal(m.selected, [0, 2, 5, 101, 103])
        np.testing.assert_array_equal(m.selected, rm.selected)
        assert (s.value, s.rows_scanned, s.rows_matched) == (rs.value, rs.rows_scanned, rs.rows_matched) == (4.0, 10, 5)
        assert s.selected is None

    def test_does_not_mutate_cached_partials(self):
        sel = np.array([4, 5])
        sel.setflags(write=False)  # as the result cache freezes it
        a = T.ScanResult(2.0, 2, 2, selected=sel)
        m = T.merge_partial_scans([(a, 10)], "select")
        np.testing.assert_array_equal(a.selected, [4, 5])
        np.testing.assert_array_equal(m.selected, [14, 15])
        assert m.selected.flags.writeable


class TestP1BitIdentity:
    """``partitions=1`` is the unpartitioned engine: one partition owning
    the whole token space, no per-partition statistics and no token
    histogram, tables and log equal to a direct build, and reads equal to
    the reference's."""

    def test_tables_and_log_match_direct_construction(self):
        kc, vc, schema = generate_simulation(4_000, 3, seed=3)
        ref, port = _pair(kc, vc, schema, partitions=1)
        cf = port.column_families["cf"]
        assert cf.ring.n_partitions == 1 and len(cf.partitions) == 1
        assert cf.token_hist is None and cf.partitions[0].stats is None and cf.next_vnode == 1
        assert cf.partitions[0].token_lo == 0
        for slot, r in enumerate(cf.replicas):
            assert r.replica_id == slot and r.partition_id == 0
            direct = T.SortedTable.from_columns(kc, vc, LAYOUTS[slot], _tschema(schema))
            t = port._table(cf, r)
            np.testing.assert_array_equal(t.packed, direct.packed)
            for c in kc:
                np.testing.assert_array_equal(t.key_cols[c], direct.key_cols[c])
            np.testing.assert_array_equal(np.asarray(t.value_cols["metric"]), np.asarray(direct.value_cols["metric"]))
            rt = ref._table(ref.column_families["cf"], ref.column_families["cf"].replicas[slot])
            assert t.stored_digest == rt.stored_digest
        (rec,) = cf.commitlog.replay()
        for c in kc:
            np.testing.assert_array_equal(rec.key_cols[c], np.asarray(kc[c]))

    def test_reads_and_selects_match_table_oracle_and_reference(self):
        kc, vc, schema = generate_simulation(4_000, 3, seed=3)
        ref, port = _pair(kc, vc, schema, partitions=1)
        cf = port.column_families["cf"]
        tq, rq = _mixed_queries(T, 7, schema, n=12), _mixed_queries(R, 7, schema, n=12)
        seq = [port.read("cf", q) for q in tq]
        for q, (res, rep) in zip(tq, seq):
            oracle = port._table(cf, cf.replicas[rep.replica_id]).execute(q)
            assert (res.value, res.rows_scanned) == (oracle.value, oracle.rows_scanned)
            if q.agg == "select":
                np.testing.assert_array_equal(res.selected, oracle.selected)
        _assert_results_equal([ref.read("cf", q) for q in rq], seq)
        assert port.stats["empty_partition_skips"] == 0


class TestPartitionedReadEquivalence:
    @pytest.mark.parametrize("partitions", [2, 4])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_read_many_matches_reference_and_p1_oracle(self, partitions, seed):
        kc, vc, schema = generate_simulation(8_000, 3, seed=seed)
        ref, port = _pair(kc, vc, schema, partitions=partitions)
        _, p1 = _pair(kc, vc, schema, partitions=1)
        assert port.stats["partitions"] == partitions
        tq = _mixed_queries(T, 100 + seed, schema, n=30)
        out = port.read_many("cf", tq)
        _assert_results_equal(ref.read_many("cf", _mixed_queries(R, 100 + seed, schema, n=30)), out)
        for q, (a, _), (b, _) in zip(tq, p1.read_many("cf", tq), out):
            assert b.rows_matched == a.rows_matched, q
            if q.agg == "sum":
                np.testing.assert_allclose(b.value, a.value, rtol=1e-9)
            else:
                assert b.value == a.value
            if q.agg == "select":
                assert len(b.selected) == b.rows_matched

    @pytest.mark.parametrize("partitions", [2, 4])
    def test_selected_rows_match_p1_oracle(self, partitions):
        kc, vc, schema = generate_simulation(5_000, 3, seed=5)
        ref, port = _pair(kc, vc, schema, partitions=partitions, rf=1)
        _, p1 = _pair(kc, vc, schema, partitions=1, rf=1)
        tq = [q for q in _mixed_queries(T, 11, schema, n=30) if q.agg == "select"]
        rq = [q for q in _mixed_queries(R, 11, schema, n=30) if q.agg == "select"]
        out = port.read_many("cf", tq)
        _assert_results_equal(ref.read_many("cf", rq), out)
        for q, (a, _), (b, _) in zip(tq, p1.read_many("cf", tq), out):
            assert _selected_rows(port, b.selected) == _selected_rows(p1, a.selected), q

    def test_equivalence_survives_staged_writes(self):
        """Routed writes under a group-commit threshold: the reads flush
        each partition's staged rows (the read barrier) and stay equal to
        the reference's."""
        kc, vc, schema = generate_simulation(6_000, 3, seed=9)
        ref, port = _pair(kc, vc, schema, partitions=3, memtable_rows=1 << 30)
        for i in range(3):
            bk, bv = _batch(13 + i, schema, 200)
            ref.write("cf", bk, bv)
            port.write("cf", bk, bv)
        assert port.stats["staged_rows"] == ref.stats["staged_rows"] > 0
        _assert_results_equal(
            ref.read_many("cf", _mixed_queries(R, 13, schema, n=18)),
            port.read_many("cf", _mixed_queries(T, 13, schema, n=18)),
        )
        # the barrier flushed exactly the replicas the reads went to
        assert port.stats["staged_rows"] == ref.stats["staged_rows"]
        assert port.stats["memtable_flushes"] == ref.stats["memtable_flushes"] > 0

    def test_single_partition_queries_touch_one_partition(self):
        kc, vc, schema = generate_simulation(3_000, 3, seed=1)
        _, port = _pair(kc, vc, schema, partitions=4)
        cf = port.column_families["cf"]
        q = T.Query(filters={"k0": T.Eq(1)}, agg="count")
        p_lo, p_hi = cf.ring.span_partitions(T.slab_bounds_many([q], cf.key_names, cf.schema))
        assert p_lo[0] == p_hi[0]
        before = [copy.deepcopy(p.rr_counter) for p in cf.partitions]
        port.read_many("cf", [q])
        draws = [next(p.rr_counter) - next(b) for p, b in zip(cf.partitions, before)]
        assert draws[int(p_lo[0])] == 1
        assert all(d == 0 for i, d in enumerate(draws) if i != int(p_lo[0]))

    def test_scalar_read_equals_batched_and_reference(self):
        kc, vc, schema = generate_simulation(3_000, 3, seed=2)
        ref, port = _pair(kc, vc, schema, partitions=4)
        port_b = copy.deepcopy(port)
        tq = _mixed_queries(T, 4, schema, n=10)
        seq = [port.read("cf", q) for q in tq]
        bat = port_b.read_many("cf", tq)
        for (rs, ps), (rb, pb) in zip(seq, bat):
            assert (rb.value, rb.rows_matched, pb.replica_id) == (rs.value, rs.rows_matched, ps.replica_id)
        _assert_results_equal([ref.read("cf", q) for q in _mixed_queries(R, 4, schema, n=10)], seq)

    def test_hrca_on_the_partition_blend_matches_reference(self):
        """HR layouts at P = 4 with token-quantile boundaries: HRCA runs
        on the row-weighted blend of the per-partition cost models, with
        the same ``hrca_kwargs``; same ring, layouts, placement and
        answers as the reference."""
        kc, vc = generate_orders(0.004, seed=2)
        n = len(kc["custkey"])
        wl = q1_q2_workload(n_instances=24, n_rows=n, seed=5)
        twl = T.Workload([T.Query(filters=q.filters, agg=q.agg, value_col=q.value_col) for q in wl.queries])
        kw = dict(k_max=300, seed=4)
        ref, port = R.HREngine(n_nodes=6), T.HREngine(n_nodes=6, device="cpu")
        for eng, w, sch in ((ref, wl, orders_schema()), (port, twl, T.KeySchema(dict(orders_schema().bits)))):
            eng.create_column_family(
                "o", kc, vc, replication_factor=3, mechanism="HR", workload=w, schema=sch,
                hrca_kwargs=kw, partitions=4, partition_balance="tokens",
            )
        rcf, pcf = ref.column_families["o"], port.column_families["o"]
        assert pcf.ring.starts == rcf.ring.starts
        assert port.layouts("o") == ref.layouts("o")
        assert pcf.hrca_result.cost == rcf.hrca_result.cost
        assert [r.node_id for r in pcf.replicas] == [r.node_id for r in rcf.replicas]
        assert port.partition_imbalance("o") == ref.partition_imbalance("o")
        qs = list(wl.queries[:12]) + [R.Query(filters=q.filters, agg="select") for q in wl.queries[12:]]
        _assert_results_equal(
            ref.read_many("o", qs),
            port.read_many("o", [T.Query(filters=q.filters, agg=q.agg, value_col=q.value_col) for q in qs]),
        )

    def test_uncached_reads_pay_their_scan(self):
        kc, vc, schema = generate_simulation(3_000, 3, seed=2)
        ref, port = _pair(kc, vc, schema, partitions=2, engine_kw={"result_cache": False})
        tq, rq = _mixed_queries(T, 6, schema, n=9), _mixed_queries(R, 6, schema, n=9)
        first = port.read_many("cf", tq)
        again = port.read_many("cf", tq)
        _assert_results_equal(ref.read_many("cf", rq), first)
        _assert_results_equal(ref.read_many("cf", rq), again)
        for (a, _), (b, _) in zip(first, again):
            assert a is not b or a.selected is None
        stats = port.stats
        assert stats["result_cache_hits"] == stats["result_cache_misses"] == stats["result_cache_entries"] == 0


class TestPartitionedWriteRouting:
    def test_rows_land_in_owning_partition_logs(self):
        kc, vc, schema = generate_simulation(4_000, 3, seed=6)
        ref, port = _pair(kc, vc, schema, partitions=4)
        for i in range(3):
            bk, bv = _batch(8 + i, schema, 150)
            ref.write("cf", bk, bv)
            port.write("cf", bk, bv)
        cf, rcf = port.column_families["cf"], ref.column_families["cf"]
        total = 0
        for part, rpart in zip(cf.partitions, rcf.partitions):
            kc_p, vc_p = part.commitlog.replay_columns()
            rkc, rvc = rpart.commitlog.replay_columns()
            for c in kc_p:
                np.testing.assert_array_equal(kc_p[c], rkc[c])
            np.testing.assert_array_equal(vc_p["metric"], rvc["metric"])
            tokens = cf.ring.tokens(kc_p, cf.schema)
            assert ((tokens >= part.token_lo) & (tokens <= part.token_hi)).all()
            assert (part.token_min, part.token_max) == (rpart.token_min, rpart.token_max)
            assert part.flushed_lsn == rpart.flushed_lsn
            total += part.commitlog.n_rows
        assert total == 4_000 + 3 * 150
        fps = [{port._table(cf, r).content_digest() for r in part.replicas} for part in cf.partitions]
        assert all(len(s) == 1 for s in fps)
        assert len({next(iter(s)) for s in fps}) == len(cf.partitions)

    def test_threshold_flush_covers_untouched_partitions(self):
        """Rows staged in one partition flush once over the threshold even
        when the write that trips it routes only to another partition:
        the check spans every replica."""
        schema = R.KeySchema({"k0": 4, "k1": 4})
        rng = np.random.default_rng(5)
        kc = {c: rng.integers(0, 16, 600).astype(np.int64) for c in ("k0", "k1")}
        vc = {"metric": rng.uniform(0, 1, 600)}
        for pkg, sch in ((R, schema), (T, _tschema(schema))):
            kw = {} if pkg is R else {"device": "cpu"}
            eng = pkg.HREngine(n_nodes=4, **kw)
            cf = eng.create_column_family(
                "cf", kc, vc, replication_factor=1, layouts=[("k0", "k1")], schema=sch,
                partitions=2, memtable_rows=1 << 30,
            )
            # 150 rows into partition 0 (k0 < 8) stay staged
            eng.write("cf", {"k0": np.full(150, 2, np.int64), "k1": np.zeros(150, np.int64)}, {"metric": np.zeros(150)})
            assert eng.stats["staged_rows"] == 150
            cf.memtable_rows = 100
            eng.write("cf", {"k0": np.full(5, 12, np.int64), "k1": np.zeros(5, np.int64)}, {"metric": np.zeros(5)})
            assert eng.stats["staged_rows"] == 0

    def test_empty_partition_stays_consistent(self):
        schema = R.KeySchema({"k0": 4, "k1": 4})
        n = 800
        rng = np.random.default_rng(3)
        kc = {"k0": rng.integers(8, 16, n).astype(np.int64), "k1": rng.integers(0, 16, n).astype(np.int64)}
        vc = {"metric": rng.uniform(0, 1, n)}
        eng = T.HREngine(n_nodes=4, device="cpu")
        cf = eng.create_column_family(
            "cf", kc, vc, replication_factor=2, layouts=[("k0", "k1"), ("k1", "k0")],
            schema=_tschema(schema), partitions=2,
        )
        assert len(cf.partitions[0].commitlog) == 1 and cf.partitions[0].n_rows_committed == 0
        assert len(eng._table(cf, cf.partitions[0].replicas[0])) == 0
        q = T.Query(filters={"k0": T.Range(0, 16)}, agg="count")
        assert eng.read_many("cf", [q])[0][0].value == n
        eng.write("cf", {"k0": np.array([2, 3]), "k1": np.array([1, 1])}, {"metric": np.array([0.5, 0.5])})
        assert eng.read_many("cf", [q])[0][0].value == n + 2
        (res, _), = eng.read_many("cf", [T.Query(filters={"k0": T.Range(0, 8)}, agg="select")])
        assert res.rows_matched == 2 and len(res.selected) == 2

    def test_partition_stats_and_token_histogram_match_reference(self):
        kc, vc, schema = generate_simulation(5_000, 3, seed=14)
        ref, port = _pair(kc, vc, schema, partitions=4, partition_balance="tokens")
        for i in range(2):
            bk, bv = _batch(30 + i, schema, 400)
            ref.write("cf", bk, bv)
            port.write("cf", bk, bv)
        cf, rcf = port.column_families["cf"], ref.column_families["cf"]
        np.testing.assert_array_equal(cf.token_hist.counts, rcf.token_hist.counts)
        for stats, rstats in [(cf.stats, rcf.stats)] + [(p.stats, q.stats) for p, q in zip(cf.partitions, rcf.partitions)]:
            assert stats.n_rows == rstats.n_rows
            for c in stats.columns:
                np.testing.assert_array_equal(stats.columns[c].counts, rstats.columns[c].counts)
                assert stats.columns[c].total == rstats.columns[c].total
        assert cf.next_vnode == rcf.next_vnode == 4


class TestPartitionedDevicePath:
    def test_device_partitioned_matches_reference_and_host(self):
        kc, vc, schema = generate_simulation(4_000, 3, seed=12)
        ref, port = _pair(kc, vc, schema, partitions=2, rf=2, device_resident=True)
        _, host = _pair(kc, vc, schema, partitions=2, rf=2)
        tq = _mixed_queries(T, 21, schema, n=18)
        out = port.read_many("cf", tq)
        _assert_results_equal(ref.read_many("cf", _mixed_queries(R, 21, schema, n=18)), out)
        _assert_results_equal(host.read_many("cf", tq), out)
        cf = port.column_families["cf"]
        assert all(port._table(cf, r).device_resident for r in cf.replicas)

    def test_device_partitioned_write_and_compact(self):
        """Write-through writes until a partition's run stack compacts on
        the device: every ``ScanResult`` field equal to the reference's
        before and after, selects index for index."""
        kc, vc, schema = generate_simulation(2_000, 3, seed=12)
        ref = R.HREngine(n_nodes=4, compaction=R.CompactionPolicy(appended_frac=0.1))
        port = T.HREngine(n_nodes=4, device="cpu")
        port.compaction = T.CompactionPolicy(appended_frac=0.1)
        for eng, sch in ((ref, schema), (port, _tschema(schema))):
            eng.create_column_family(
                "cf", kc, vc, replication_factor=2, layouts=LAYOUTS[:2], schema=sch,
                partitions=2, device_resident=True,
            )
        tq, rq = _mixed_queries(T, 22, schema, n=12), _mixed_queries(R, 22, schema, n=12)
        _assert_results_equal(ref.read_many("cf", rq), port.read_many("cf", tq))
        for i in range(3):
            bk, bv = _batch(40 + i, schema, 300)
            ref.write("cf", bk, bv)
            port.write("cf", bk, bv)
        assert port.stats["compactions"] == ref.stats["compactions"] >= 1
        _assert_results_equal(ref.read_many("cf", rq), port.read_many("cf", tq))
        cf, rcf = port.column_families["cf"], ref.column_families["cf"]
        np.testing.assert_array_equal(cf.token_hist.counts, rcf.token_hist.counts)
        for r, rr in zip(cf.replicas, rcf.replicas):
            np.testing.assert_array_equal(
                port._table(cf, r)._device["keys"].numpy(), np.asarray(ref._table(rcf, rr)._device["keys"])
            )

    def test_device_partitioned_views_match_reference(self):
        """A device-resident ``views=True, partitions=2`` family: the
        per-partition view cap routes like the reference's, and the view
        answers equal the reference's (and the port's fused scan)."""
        kc, vc, schema = generate_simulation(6_000, 3, seed=15)
        ref, port = _pair(kc, vc, schema, partitions=2, device_resident=True, views=True)
        _, fused = _pair(kc, vc, schema, partitions=2, device_resident=True)
        tq = [q for q in _mixed_queries(T, 23, schema, n=18) if q.agg != "select"]
        rq = [q for q in _mixed_queries(R, 23, schema, n=18) if q.agg != "select"]
        out = port.read_many("cf", tq)
        _assert_results_equal(ref.read_many("cf", rq), out)
        _assert_results_equal(fused.read_many("cf", tq), out, routing=False)
        assert port.stats["view_hits"] == ref.stats["view_hits"] > 0
        bk, bv = _batch(50, schema, 500)
        ref.write("cf", bk, bv)
        port.write("cf", bk, bv)
        _assert_results_equal(ref.read_many("cf", rq), port.read_many("cf", tq))
