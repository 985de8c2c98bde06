"""Materialized per-slab views of the port (``repro_torch.core.storage.views``
and ``repro_torch.kernels.block_agg``) against the reference's
(``repro.core.storage.views``, ``repro.kernels.block_agg``), on the CPU.

Two bars, as in ``tests/test_views.py``:

* inside the port, a view-served sum or count equals the port's own fused
  scan **bit for bit** (float ``==``), with ``rows_matched`` and
  ``rows_scanned`` equal: on a fresh build, after a write drip, after a
  compaction, and on an older table after a second append into the same
  tensors;
* against the reference, counts, rows, replica choices and view counters
  are equal; sums agree within rtol 1e-5 / atol 1e-3 (the two packages
  reduce a block in different orders).

The reference's kernels run in Pallas interpret mode, as its own tests run
them on the CPU; the port's wrappers run their plain versions on CPU
tensors. Every schema is pinned (``generate_simulation`` returns one).
"""

import copy

import numpy as np
import pytest
import torch

import repro.core as R
import repro.kernels as RK
import repro_torch.core as T
import repro_torch.kernels as TK
from repro.core.storage import views as rviews
from repro.core.storage.memtable import sort_run as r_sort_run
from repro.core.tpch import generate_simulation as r_generate_simulation
from repro_torch.core.storage import views as tviews
from repro_torch.core.storage.memtable import sort_run as t_sort_run
from repro_torch.core.tpch import generate_simulation
from repro_torch.kernels import ops as tops
from repro_torch.kernels.block_agg import (
    BLOCK_ROWS,
    block_partials,
    block_sums,
    boundary_block_sums,
)
from repro_torch.kernels.slab_locate import scan_agg_locate

CPU = torch.device("cpu")
LAYOUTS = [("k0", "k1", "k2"), ("k1", "k2", "k0"), ("k2", "k0", "k1")]
RTOL, ATOL = 1e-5, 1e-3


def random_queries(pkg, seed, n, *, domain, aggs=("sum", "count"), value_col="metric"):
    """Per key column an equality, a range or no filter (the reference's
    generator), in ``pkg``'s query types."""
    rng = np.random.default_rng(seed)
    qs = []
    for _ in range(n):
        f = {}
        for c in ("k0", "k1", "k2"):
            r = rng.random()
            if r < 0.35:
                f[c] = pkg.Eq(int(rng.integers(0, domain)))
            elif r < 0.65:
                lo = int(rng.integers(0, domain - 1))
                f[c] = pkg.Range(lo, int(rng.integers(lo + 1, domain + 1)))
        qs.append(pkg.Query(agg=str(rng.choice(list(aggs))), filters=f, value_col=value_col))
    return qs


def assert_bit_identical(view_results, fused_results, queries):
    for q, a, b in zip(queries, view_results, fused_results):
        assert a.value == b.value, q
        assert (a.rows_matched, a.rows_scanned) == (b.rows_matched, b.rows_scanned), q
        if a.selected is not None or b.selected is not None:
            np.testing.assert_array_equal(a.selected, b.selected)


def assert_close_to_reference(ref_results, port_results):
    for a, b in zip(ref_results, port_results):
        assert (a.rows_matched, a.rows_scanned) == (b.rows_matched, b.rows_scanned)
        np.testing.assert_allclose(a.value, b.value, rtol=RTOL, atol=ATOL)
        if a.selected is None:
            assert b.selected is None
        else:
            np.testing.assert_array_equal(a.selected, b.selected)


def _np_tree_partials(x):
    """The sum contract's plain in-block order, written out in numpy:
    pad to whole 8192-row blocks with +0.0, then halve each block with
    elementwise float32 adds."""
    r, n = x.shape
    nb = -(-n // BLOCK_ROWS)
    x = np.concatenate([x, np.zeros((r, nb * BLOCK_ROWS - n), np.float32)], axis=1)
    x = x.reshape(r, nb, BLOCK_ROWS)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


# -- the kernels' plain versions ------------------------------------------------------


class TestBlockSumsKernel:
    @pytest.mark.parametrize("shape", [(1, 100), (3, 8192), (4, 20_000)])
    def test_matches_reference(self, shape):
        rng = np.random.default_rng(shape[1])
        vals = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(RK.block_sums(vals, block_n=BLOCK_ROWS))
        got = block_sums(
            torch.from_numpy(vals), n_rows=shape[1], block_n=BLOCK_ROWS, n_vals=shape[0], n_key_lanes=3
        ).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    def test_boundary_matches_interior_on_full_window(self):
        # a boundary rescan whose window covers the whole block equals the
        # stored partial bit for bit: the serve fold's interior/boundary
        # split relies on it
        n = 3 * BLOCK_ROWS
        vals = torch.from_numpy(np.random.default_rng(1).standard_normal((2, n)).astype(np.float32))
        full = block_sums(vals, n_rows=n, block_n=BLOCK_ROWS, n_vals=2, n_key_lanes=2).numpy()
        got = boundary_block_sums(
            vals, [1, 0, 1], [0, 1, 2], [[0]] * 3, [[n]] * 3,
            n_rows=n, block_n=BLOCK_ROWS, n_vals=2, n_key_lanes=2,
        ).numpy()
        np.testing.assert_array_equal(got, np.array([full[1, 0], full[0, 1], full[1, 2]], np.float32))

    def test_boundary_matches_reference(self):
        rng = np.random.default_rng(2)
        n = 3 * BLOCK_ROWS
        vals = rng.standard_normal((3, n)).astype(np.float32)
        p = 12
        sel = rng.integers(0, 3, p)
        blocks = rng.integers(0, 3, p)
        lo = np.sort(rng.integers(0, n + 1, (p, 3)), axis=1)
        hi = np.minimum(lo + rng.integers(0, 9000, (p, 3)), n)
        hi[:, 1] = lo[:, 1]  # an empty window slot
        want = np.asarray(RK.boundary_block_sums(vals, sel, blocks, lo, hi, block_n=BLOCK_ROWS))
        got = boundary_block_sums(
            torch.from_numpy(vals), sel, blocks, lo, hi, n_rows=n, block_n=BLOCK_ROWS, n_vals=3,
            n_key_lanes=3,
        ).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    def test_block_partials_ignore_the_shape_around_a_block(self):
        x = np.random.default_rng(3).standard_normal((5, 3 * BLOCK_ROWS)).astype(np.float32)
        whole = block_partials(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(whole, _np_tree_partials(x))
        for r in range(5):
            one = block_partials(torch.from_numpy(x[r : r + 1, BLOCK_ROWS : 2 * BLOCK_ROWS].copy()))
            assert one.numpy()[0, 0] == whole[r, 1]

    def test_folds_only_live_rows(self):
        """Columns past ``n_rows`` (rows a later append wrote in place into
        shared capacity) are not folded, by the block sums or the rescan."""
        rng = np.random.default_rng(4)
        n_rows = BLOCK_ROWS + 1000
        vals = rng.standard_normal((2, 2 * BLOCK_ROWS)).astype(np.float32)
        clean = vals.copy()
        clean[:, n_rows:] = 0.0
        args = dict(block_n=BLOCK_ROWS, n_vals=2, n_key_lanes=3)
        got = block_sums(torch.from_numpy(vals), n_rows=n_rows, **args).numpy()
        want = block_sums(torch.from_numpy(clean), n_rows=2 * BLOCK_ROWS, **args).numpy()
        np.testing.assert_array_equal(got, want)
        tail = block_sums(torch.from_numpy(vals), n_rows=n_rows, first_block=1, **args).numpy()
        np.testing.assert_array_equal(tail, want[:, 1:])
        win = ([[0]], [[2 * BLOCK_ROWS]])
        b = boundary_block_sums(torch.from_numpy(vals), [1], [1], *win, n_rows=n_rows, **args)
        assert b.numpy()[0] == want[1, 1]

    def test_plain_fused_sum_is_a_block_order_fold(self):
        """The fused scan's plain version sums each query as float32 block
        partials folded strictly sequentially in ascending block order: a
        numpy fold written out by hand gives the same bits."""
        kc, vc, schema = generate_simulation(20_000, 3, seed=5)
        t = T.SortedTable.from_columns(kc, vc, LAYOUTS[0], schema).place_on_device(CPU)
        st = t._device
        qs = random_queries(T, 6, 30, domain=27, aggs=("sum",))
        d = tops.device_query_operands(t, qs)
        got = scan_agg_locate(
            st["keys"], st["values_tile"], d["res_lo"], d["res_hi"], d["slab_lo"], d["slab_hi"],
            d["limits"], d["sel"], col_parts=st["col_parts"], n_vals=st["n_value_rows"],
        )[0].numpy()
        vals = st["values_tile"][0].numpy()
        for i, q in enumerate(qs):
            mask = np.ones(len(t), bool)
            for col in t.layout:
                lo, hi = q.filter_bounds(t.schema, col)
                mask &= (t.key_cols[col] >= lo) & (t.key_cols[col] < hi)
            x = np.where(np.concatenate([mask, np.zeros(vals.size - len(t), bool)]), vals, np.float32(0))
            parts = _np_tree_partials(x[None, :])[0]
            want = np.float32(0)
            for p in parts:  # sequential float32 fold, block 0 first
                want = np.float32(want + p)
            assert got[i] == want, q

    def test_wrappers_check_their_operands_and_count_no_cpu_launch(self):
        vals = torch.zeros((8, BLOCK_ROWS))
        before = {name: fn.launches for name, fn in TK.KERNELS.items()}
        with pytest.raises(ValueError, match="block_n"):
            block_sums(vals, n_rows=10, block_n=4096, n_vals=2, n_key_lanes=1)
        with pytest.raises(ValueError, match="n_vals"):
            block_sums(vals, n_rows=10, block_n=BLOCK_ROWS, n_vals=9, n_key_lanes=1)
        with pytest.raises(ValueError, match="float32"):
            block_sums(vals.double(), n_rows=10, block_n=BLOCK_ROWS, n_vals=2, n_key_lanes=1)
        with pytest.raises(ValueError, match="selector"):
            boundary_block_sums(
                vals, [3], [0], [[0]], [[5]], n_rows=10, block_n=BLOCK_ROWS, n_vals=2, n_key_lanes=1
            )
        with pytest.raises(ValueError, match="block lies"):
            boundary_block_sums(
                vals, [0], [1], [[0]], [[5]], n_rows=10, block_n=BLOCK_ROWS, n_vals=2, n_key_lanes=1
            )
        block_sums(vals, n_rows=10, block_n=BLOCK_ROWS, n_vals=2, n_key_lanes=1)
        assert {name: fn.launches for name, fn in TK.KERNELS.items()} == before


# -- eligibility walk -------------------------------------------------------------------


class TestEligibility:
    LAYOUT = ("a", "b", "c")

    def cases(self, pkg):
        E, Rg, Q = pkg.Eq, pkg.Range, pkg.Query
        return [
            (Q(agg="sum", filters={"a": E(1)}, value_col="v"), True),
            (Q(agg="count", filters={}), True),
            (Q(agg="sum", filters={"a": E(1), "b": Rg(0, 5)}, value_col="v"), True),
            (Q(agg="sum", filters={"a": Rg(0, 5)}, value_col="v"), True),
            # a filter after the prefix opens needs the residual scan
            (Q(agg="sum", filters={"b": E(1)}, value_col="v"), False),
            (Q(agg="sum", filters={"a": Rg(0, 5), "b": E(1)}, value_col="v"), False),
            (Q(agg="sum", filters={"a": E(1), "c": E(2)}, value_col="v"), False),
            # selects never route through views
            (Q(agg="select", filters={"a": E(1)}), False),
        ]

    def test_walk(self):
        for q, want in self.cases(T):
            assert tviews.query_view_eligible(q, self.LAYOUT) is want, q

    def test_matrix_matches_scalar_and_reference(self):
        qs = [q for q, _ in self.cases(T)]
        layouts = [self.LAYOUT, ("c", "b", "a")]
        m = tviews.view_eligible_matrix(layouts, qs)
        for k, lay in enumerate(layouts):
            for j, q in enumerate(qs):
                assert m[k, j] == tviews.query_view_eligible(q, lay)
        np.testing.assert_array_equal(m, rviews.view_eligible_matrix(layouts, [q for q, _ in self.cases(R)]))
        aggs = ("sum", "count", "select")
        tq = random_queries(T, 7, 60, domain=8, aggs=aggs)
        rq = random_queries(R, 7, 60, domain=8, aggs=aggs)
        np.testing.assert_array_equal(
            tviews.view_eligible_matrix(LAYOUTS, tq), rviews.view_eligible_matrix(LAYOUTS, rq)
        )


# -- table-level bit identity -------------------------------------------------------------


@pytest.fixture(scope="module")
def tables():
    """(port views table, port fused twin, reference views table) over the
    same 20k-row dataset."""
    kc, vc, schema = generate_simulation(20_000, 3, seed=2)
    tv = T.SortedTable.from_columns(kc, vc, LAYOUTS[0], schema).place_on_device(CPU).build_views()
    tf = T.SortedTable.from_columns(kc, vc, LAYOUTS[0], schema).place_on_device(CPU)
    rkc, rvc, rschema = r_generate_simulation(20_000, 3, seed=2)
    rt = R.SortedTable.from_columns(rkc, rvc, LAYOUTS[0], rschema)
    rt.place_on_device()
    rt.build_views()
    return tv, tf, rt


def _write(rng, m, domain=27):
    kw = {c: rng.integers(0, domain, m).astype(np.int64) for c in ("k0", "k1", "k2")}
    return kw, {"metric": rng.standard_normal(m)}


class TestTableBitIdentity:
    def queries(self, pkg=T, seed=5, n=40):
        return random_queries(pkg, seed, n, domain=27)

    def test_fresh_build(self, tables):
        tv, tf, rt = tables
        qs = self.queries()
        rv = tv.execute_many(qs)
        assert_bit_identical(rv, tf.execute_many(qs), qs)
        assert_close_to_reference(rt.execute_many(self.queries(R)), rv)
        np.testing.assert_allclose(
            tv._device["views"]["block_sums"], np.asarray(rt._device["views"]["block_sums"]),
            rtol=RTOL, atol=ATOL,
        )

    def test_view_actually_serves(self, tables):
        tv, _, rt = tables
        elig = [q for q in self.queries() if tviews.query_view_eligible(q, tv.layout)]
        relig = [q for q in self.queries(R) if rviews.query_view_eligible(q, rt.layout)]
        assert elig and len(elig) == len(relig)
        stats, rstats = {}, {}
        tv.execute_many(elig, view_stats=stats)
        rt.execute_many(relig, view_stats=rstats)
        assert stats == rstats and stats["hits"] == len(elig)

    def test_drip_and_compaction_stay_identical(self, tables):
        tv, tf, rt = (copy.deepcopy(t) for t in tables)
        rng = np.random.default_rng(9)
        qs, rqs = self.queries(seed=11), self.queries(R, seed=11)
        for step in range(3):
            kw, vw = _write(rng, int(rng.integers(500, 4000)))
            tv = tv.merge_run(t_sort_run(kw, vw, tv.layout, tv.schema))
            tf = tf.merge_run(t_sort_run(kw, vw, tf.layout, tf.schema))
            rt = rt.merge_run(r_sort_run(kw, vw, rt.layout, rt.schema))
            assert tviews.verify_views(tv), f"step {step}: stale view after merge"
            stats, rstats = {}, {}
            rv = tv.execute_many(qs, view_stats=stats)
            assert_bit_identical(rv, tf.execute_many(qs), qs)
            assert_close_to_reference(rt.execute_many(rqs, view_stats=rstats), rv)
            assert stats == rstats
        assert tv._device["n_runs"] == 4
        for t in (tv, tf, rt):
            t.compact_runs()
        assert tviews.verify_views(tv), "stale view after compaction"
        rv = tv.execute_many(qs)
        assert_bit_identical(rv, tf.execute_many(qs), qs)
        assert_close_to_reference(rt.execute_many(rqs), rv)

    def test_older_table_after_a_second_append(self, tables):
        """The first append writes into the capacity padding the base
        table's tensors share, the second into the same tensors again: the
        base and the middle table still verify and still serve their own
        rows bit-identically to their fused scans; a second append onto the
        base (which copies first) does too."""
        tv, tf = (copy.deepcopy(t) for t in tables[:2])
        rng = np.random.default_rng(12)
        qs = self.queries(seed=13)
        chain_v, chain_f = [tv], [tf]
        for m in (1500, 2500):
            kw, vw = _write(rng, m)
            chain_v.append(chain_v[-1].merge_run(t_sort_run(kw, vw, tv.layout, tv.schema)))
            chain_f.append(chain_f[-1].merge_run(t_sort_run(kw, vw, tf.layout, tf.schema)))
        assert chain_v[2]._device["values_tile"].data_ptr() == tv._device["values_tile"].data_ptr()
        kw, vw = _write(rng, 700)
        chain_v.append(tv.merge_run(t_sort_run(kw, vw, tv.layout, tv.schema)))
        chain_f.append(tf.merge_run(t_sort_run(kw, vw, tf.layout, tf.schema)))
        for a, b in zip(chain_v, chain_f):
            assert tviews.verify_views(a)
            assert_bit_identical(a.execute_many(qs), b.execute_many(qs), qs)

    def test_serve_matches_execute_per_query(self, tables):
        tv, _, _ = tables
        elig = [q for q in self.queries(seed=13) if tviews.query_view_eligible(q, tv.layout)]
        for q, r in zip(elig, tviews.serve_view_many(tv, elig)):
            s = tv.execute(q)
            assert r.value == s.value and r.rows_matched == s.rows_matched

    def test_verify_detects_corruption(self, tables):
        tv = copy.deepcopy(tables[0])
        assert tviews.verify_views(tv)
        tv._device["views"]["block_sums"][0, 0] += 1.0
        assert not tviews.verify_views(tv)
        tv.build_views()
        assert tviews.verify_views(tv)

    def test_build_views_requires_device(self):
        kc, vc, schema = generate_simulation(1000, 2, seed=0)
        t = T.SortedTable.from_columns(kc, vc, ("k0", "k1"), schema)
        with pytest.raises(ValueError, match="device-resident"):
            t.build_views()

    def test_reference_view_state_carries_over(self, tables):
        """``state_from_numpy`` brings a reference view across: the port
        serves the reference's stored partials with the reference's
        interior/boundary split (equal counts, rows and boundary rows)."""
        _, _, rt = tables
        state = {
            **rt._device, "keys": np.asarray(rt._device["keys"]),
            "values_tile": np.asarray(rt._device["values_tile"]),
        }
        port = T.SortedTable(rt.layout, T.KeySchema(dict(rt.schema.bits)), rt.key_cols, rt.value_cols, rt.packed)
        port._device = tops.state_from_numpy(state, CPU)
        np.testing.assert_array_equal(
            port._device["views"]["block_sums"], np.asarray(rt._device["views"]["block_sums"])
        )
        qs, rqs = self.queries(seed=17), self.queries(R, seed=17)
        stats, rstats = {}, {}
        ours = tviews.serve_view_many(port, [q for q in qs if port._view_eligible(q)], view_stats=stats)
        theirs = rviews.serve_view_many(rt, [q for q in rqs if rt._view_eligible(q)], view_stats=rstats)
        assert stats == rstats
        assert_close_to_reference(theirs, ours)

    def test_block_plan_equals_the_reference_loop(self):
        """The vectorized plan classifies blocks exactly as the reference's
        per-block coverage loop (``views.py:serve_view_many``)."""
        rng = np.random.default_rng(21)
        bn = BLOCK_ROWS
        for _ in range(200):
            n_rows = int(rng.integers(1, 6 * bn))
            cuts = np.sort(rng.integers(0, n_rows + 1, int(rng.integers(1, 5)) * 2))
            windows = [(int(a), int(b)) for a, b in cuts.reshape(-1, 2) if b > a]
            cov = {}
            for a, b in windows:
                for blk in range(a // bn, (b - 1) // bn + 1):
                    cov[blk] = cov.get(blk, 0) + min(b, (blk + 1) * bn) - max(a, blk * bn)
            want = [(blk, cov[blk] == min((blk + 1) * bn, n_rows) - blk * bn) for blk in sorted(cov)]
            blocks, interior = tviews._block_plan(windows, bn, n_rows)
            assert list(zip(blocks.tolist(), interior.tolist())) == want


# -- engine parity ---------------------------------------------------------------------


def _build_engines(views_port=True):
    kc, vc, schema = generate_simulation(20_000, 3, seed=4)
    rkc, rvc, rschema = r_generate_simulation(20_000, 3, seed=4)
    kw = dict(replication_factor=3, layouts=LAYOUTS, device_resident=True, memtable_rows=0)
    ref = R.HREngine(n_nodes=5)
    ref.create_column_family("cf", rkc, rvc, schema=rschema, views=True, **kw)
    ev = T.HREngine(n_nodes=5, device="cpu")
    ev.create_column_family("cf", kc, vc, schema=schema, views=True, **kw)
    ef = T.HREngine(n_nodes=5, device="cpu")
    ef.create_column_family("cf", kc, vc, schema=schema, views=False, **kw)
    return ref, ev, ef


@pytest.fixture(scope="module")
def engines():
    return _build_engines()


VIEW_KEYS = ("view_hits", "view_boundary_rows", "view_rebuilds")


def fused_on_the_same_replicas(eng, queries, reports):
    """The fused scan's answers (``table_execute_device_many``) for each
    query on the replica table that served it."""
    cf = eng.column_families["cf"]
    handles = {r.replica_id: r for r in cf.replicas}
    groups = {}
    for i, rep in enumerate(reports):
        groups.setdefault(rep.replica_id, []).append(i)
    out = [None] * len(queries)
    for rid, idx in groups.items():
        table = eng._table(cf, handles[rid])
        for i, r in zip(idx, tops.table_execute_device_many(table, [queries[i] for i in idx])):
            out[i] = r
    return out


def assert_engine_parity(ref, ev, ef, tq, rq, *, tag=""):
    """Port views == the port's fused scan on the same replica, bit for
    bit (and == the fused engine's answer wherever both engines picked
    the same replica); port views against the reference views engine:
    same replica per query, equal counts and rows, sums within
    tolerance."""
    rv = ev.read_many("cf", tq)
    rf = ef.read_many("cf", tq)
    rr = ref.read_many("cf", rq)
    assert_bit_identical([a for a, _ in rv], fused_on_the_same_replicas(ev, tq, [p for _, p in rv]), tq)
    same = [i for i, ((_, pa), (_, pb)) in enumerate(zip(rv, rf)) if pa.replica_id == pb.replica_id]
    assert_bit_identical([rv[i][0] for i in same], [rf[i][0] for i in same], [tq[i] for i in same])
    for (a, pa), (b, pb) in zip(rr, rv):
        assert pa.replica_id == pb.replica_id, tag
        assert pa.estimated_cost == pytest.approx(pb.estimated_cost, rel=1e-12), tag
    assert_close_to_reference([a for a, _ in rr], [b for b, _ in rv])


class TestEngineParity:
    def queries(self, pkg=T, seed=21, n=40, aggs=("sum", "count", "select")):
        return random_queries(pkg, seed, n, domain=27, aggs=aggs)

    def test_read_many_parity_and_hits(self, engines):
        ref, ev, ef = (copy.deepcopy(e) for e in engines)
        assert_engine_parity(ref, ev, ef, self.queries(), self.queries(R), tag="fresh")
        assert ev.stats["view_hits"] > 0 and ef.stats["view_hits"] == 0
        assert {k: ev.stats[k] for k in VIEW_KEYS} == {k: ref.stats[k] for k in VIEW_KEYS}

    def test_scalar_read_parity(self, engines):
        ref, ev, _ = (copy.deepcopy(e) for e in engines)
        for tq, rq in zip(self.queries(seed=23, n=12), self.queries(R, seed=23, n=12)):
            (a, pa), (c, pc) = ev.read("cf", tq), ref.read("cf", rq)
            (b,) = fused_on_the_same_replicas(ev, [tq], [pa])
            assert a.value == b.value and a.rows_matched == b.rows_matched
            assert pa.replica_id == pc.replica_id
            np.testing.assert_allclose(a.value, c.value, rtol=RTOL, atol=ATOL)
        assert {k: ev.stats[k] for k in VIEW_KEYS} == {k: ref.stats[k] for k in VIEW_KEYS}

    def test_view_routing_caps_estimated_cost(self, engines):
        ref, ev, ef = (copy.deepcopy(e) for e in engines)
        # an unfiltered sum is view-eligible on every layout: the views
        # engine's planner sees the capped (cheap) estimate
        q = T.Query(agg="sum", filters={}, value_col="metric")
        _, rep_v = ev.read("cf", q)
        _, rep_f = ef.read("cf", q)
        _, rep_r = ref.read("cf", R.Query(agg="sum", filters={}, value_col="metric"))
        assert rep_v.estimated_cost < rep_f.estimated_cost
        fn = ev.column_families["cf"].cost_model.cost_fn(3)
        assert rep_v.estimated_cost == fn(min(rep_v.estimated_rows, float(T.VIEW_ROWS_CAP)))
        assert rep_v.estimated_cost == pytest.approx(rep_r.estimated_cost, rel=1e-12)

    def test_write_flush_compaction_parity(self, engines):
        """Write-through writes until the compaction policy folds the run
        stack: views extended at each flush and rebuilt at compaction,
        answers and counters in parity throughout."""
        ref, ev, ef = (copy.deepcopy(e) for e in engines)
        rng = np.random.default_rng(31)
        tq, rq = self.queries(seed=33), self.queries(R, seed=33)
        for step in range(4):
            kw, vw = _write(rng, int(rng.integers(2800, 4000)))
            for e in (ref, ev, ef):
                e.write("cf", kw, vw)
            assert_engine_parity(ref, ev, ef, tq, rq, tag=f"write {step}")
        assert ev.stats["compactions"] == ref.stats["compactions"] > 0
        assert {k: ev.stats[k] for k in VIEW_KEYS} == {k: ref.stats[k] for k in VIEW_KEYS}
        assert ev.stats["view_rebuilds"] == 3
        for node in ev.nodes:
            for t in node.tables.values():
                assert t.has_views and tviews.verify_views(t)

    def test_stats_expose_view_counters(self, engines):
        _, ev, _ = engines
        for key in VIEW_KEYS:
            assert key in ev.stats and key in ev.metrics.catalog()
        assert set(VIEW_KEYS) <= set(T.engine.ENGINE_COUNTERS)

    def test_views_require_device_resident(self):
        kc, vc, schema = generate_simulation(1000, 2, seed=0)
        e = T.HREngine(n_nodes=2, device="cpu")
        with pytest.raises(ValueError, match="device_resident"):
            e.create_column_family("cf", kc, vc, replication_factor=1, layouts=[("k0", "k1")], schema=schema, views=True)

    def test_partitioned_views_are_not_in_this_slice(self):
        """Named for the time the migration of a views family was outside
        the port. A partitioned views column family splits and keeps its
        views:
        the two rebuilt vnodes get views built over their rows, the kept
        vnode keeps its view state (the same objects), and every
        view-served answer equals the fused scan on its table bit for
        bit."""
        kc, vc, schema = generate_simulation(1000, 2, seed=0)
        e = T.HREngine(n_nodes=2, device="cpu")
        cf = e.create_column_family(
            "cf", kc, vc, replication_factor=1, layouts=[("k0", "k1")], schema=schema,
            device_resident=True, views=True, partitions=2,
        )
        assert all(e._table(cf, r).has_views for r in cf.replicas)
        kept = cf.partitions[1]
        kept_views = e._table(cf, kept.replicas[0])._device["views"]
        e.split_partition("cf", 0)
        assert cf.ring.n_partitions == 3 and cf.partitions[2] is kept
        assert e._table(cf, kept.replicas[0])._device["views"] is kept_views
        assert e.stats["view_rebuilds"] == 2
        qs = random_queries(T, 5, 20, domain=schema.max_value("k0") + 1)
        for r in cf.replicas:
            t = e._table(cf, r)
            assert t.has_views and tviews.verify_views(t) and t._device["keys"].device == CPU
            elig = [q for q in qs if t._view_eligible(q)]
            assert_bit_identical(t.execute_many(elig), tops.table_execute_device_many(t, elig), elig)


class TestSelectOnlyFastPath:
    def test_all_select_batch_skips_eligibility_arrays(self, engines, monkeypatch):
        _, ev, _ = engines
        ev = copy.deepcopy(ev)
        import repro_torch.core.engine as engine_mod

        def boom(*a, **k):  # pragma: no cover - failure path
            raise AssertionError("select-only batch walked the view planning arrays")

        monkeypatch.setattr(engine_mod, "view_eligible_matrix", boom)
        qs = [T.Query(agg="select", filters={"k0": T.Eq(i % 16)}) for i in range(8)]
        res = ev.read_many("cf", qs)
        assert len(res) == 8 and all(r.selected is not None for r, _ in res)

    def test_mixed_batch_still_routes_views(self, engines):
        ref, ev, ef = (copy.deepcopy(e) for e in engines)
        tq = [
            T.Query(agg="select", filters={"k0": T.Eq(3)}),
            T.Query(agg="sum", filters={"k0": T.Range(0, 13)}, value_col="metric"),
        ]
        rq = [
            R.Query(agg="select", filters={"k0": R.Eq(3)}),
            R.Query(agg="sum", filters={"k0": R.Range(0, 13)}, value_col="metric"),
        ]
        assert_engine_parity(ref, ev, ef, tq, rq, tag="mixed")
        assert ev.stats["view_hits"] >= 1


# -- interleaving at partitions=1: write, flush and read --------------------------------


def _interleaving(seed, ops):
    kc, vc, schema = generate_simulation(12_000, 3, seed=seed)
    rkc, rvc, rschema = r_generate_simulation(12_000, 3, seed=seed)
    kw = dict(replication_factor=3, layouts=LAYOUTS, device_resident=True, memtable_rows=400)
    ref = R.HREngine(n_nodes=5)
    ref.create_column_family("cf", rkc, rvc, schema=rschema, views=True, **kw)
    ev, ef = T.HREngine(n_nodes=5, device="cpu"), T.HREngine(n_nodes=5, device="cpu")
    ev.create_column_family("cf", kc, vc, schema=schema, views=True, **kw)
    ef.create_column_family("cf", kc, vc, schema=schema, views=False, **kw)
    dom = schema.max_value("k0") + 1
    rng = np.random.default_rng(seed + 17)
    tq = random_queries(T, seed + 3, 12, domain=dom)
    rq = random_queries(R, seed + 3, 12, domain=dom)
    for step, op in enumerate(ops):
        if op == "write":
            w = _write(rng, int(rng.integers(100, 900)), domain=dom)
            for e in (ref, ev, ef):
                e.write("cf", *w)
        elif op == "flush":
            for e in (ref, ev, ef):
                e.flush_memtables("cf")
        assert_engine_parity(ref, ev, ef, tq, rq, tag=f"step {step} ({op})")
    assert {k: ev.stats[k] for k in VIEW_KEYS} == {k: ref.stats[k] for k in VIEW_KEYS}
    for node in ev.nodes:
        for t in node.tables.values():
            assert t.has_views and tviews.verify_views(t), "derived state diverged"


OPS = ("write", "flush", "read")


class TestInterleavingDeterministic:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_random_interleavings(self, seed):
        rng = np.random.default_rng(100 + seed)
        _interleaving(seed, [str(rng.choice(OPS)) for _ in range(6)])

    def test_adversarial_sequence(self):
        _interleaving(7, ["write", "write", "flush", "read", "write", "write", "flush"])
