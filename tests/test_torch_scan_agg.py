"""Parity of the port's row-slab read path with the JAX reference: slab
location (``slab_locate``), the rows-outer and queries-outer scans
(``scan_agg``), their glue in ``repro_torch.kernels.ops``, the routing of
``SortedTable.slab_many`` and the port's ``bench.batched_read``.

The same numpy inputs go through the reference (its Pallas kernels in
interpret mode, and its jnp oracles in ``repro.kernels.ref``) and through
the port's wrappers on CPU tensors, which run their plain PyTorch
versions. Slabs, ranks and counts must be equal; float32 sums agree within
rtol 1e-5 / atol 1e-3 (the parity contract: reduction orders differ).
Every table pins an explicit ``KeySchema``. The CUDA kernels themselves
are held against these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as R
import repro.kernels as RK
import repro_torch.core as T
import repro_torch.kernels as TK
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.scan_agg import scan_agg_batched_pallas, scan_agg_batched_qgrid_pallas
from repro.kernels.slab_locate import slab_locate_batched
from repro_torch.bench import batched_read
from repro_torch.kernels import ops as tops
from repro_torch.kernels.scan_agg import (
    scan_agg_qgrid,
    scan_agg_qgrid_plain,
    scan_agg_rowstream,
    scan_agg_rowstream_plain,
)
from repro_torch.kernels.slab_locate import slab_locate, slab_locate_plain
from repro_torch.core.storage.memtable import sort_run as t_sort_run
from repro.core.storage.memtable import sort_run as r_sort_run

RTOL, ATOL = 1e-5, 1e-3
CPU = torch.device("cpu")

# narrow keys, and one 31-60-bit column that takes a lane pair
SCHEMAS = {
    "narrow": ({"a": 7, "b": 9, "c": 5}, ("b", "a", "c")),
    "wide": ({"a": 6, "w": 45, "c": 5}, ("a", "w", "c")),
}


def _columns(bits, n, seed):
    rng = np.random.default_rng(seed)
    kc = {c: rng.integers(0, 1 << b, n, dtype=np.int64) for c, b in bits.items()}
    vc = {"v": rng.uniform(-10.0, 100.0, n), "u": rng.integers(0, 7, n).astype(np.float64)}
    return kc, vc


def _tables(schema, n, seed, resident=True):
    bits, layout = SCHEMAS[schema]
    kc, vc = _columns(bits, n, seed)
    ref = R.SortedTable.from_columns(kc, vc, layout, R.KeySchema(dict(bits)))
    port = T.SortedTable.from_columns(kc, vc, layout, T.KeySchema(dict(bits)))
    if resident:
        ref.place_on_device()
        port.place_on_device(CPU)
    return ref, port


def _specs(bits, n_q, seed, aggs=("sum", "count")):
    """Filter specs: per column an equality, a range, an empty range or no
    filter, cycling through ``aggs``."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n_q):
        f = {}
        for c, b in bits.items():
            top = 1 << b
            kind = int(rng.integers(0, 4))
            if kind == 0:
                f[c] = ("eq", int(rng.integers(0, top)))
            elif kind == 1:
                lo = int(rng.integers(0, top))
                f[c] = ("range", lo, int(rng.integers(lo, top + 1)))
            elif kind == 2 and i % 5 == 3:
                lo = int(rng.integers(0, top))
                f[c] = ("range", lo, lo)  # empty
        agg = aggs[i % len(aggs)]
        specs.append((f, agg, ("v", "u")[i % 2] if agg == "sum" else None))
    return specs


def _queries(pkg, specs):
    out = []
    for f, agg, vcol in specs:
        filters = {
            c: pkg.Eq(s[1]) if s[0] == "eq" else pkg.Range(s[1], s[2]) for c, s in f.items()
        }
        out.append(pkg.Query(filters=filters, agg=agg, value_col=vcol))
    return out


def _t(a, dtype=torch.int32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _assert_pairs_close(ref_out, port_out):
    assert len(ref_out) == len(port_out)
    for (rv, rc), (pv, pc) in zip(ref_out, port_out):
        assert rc == pc
        np.testing.assert_allclose(pv, rv, rtol=RTOL, atol=ATOL)


# -- slab_locate ------------------------------------------------------------------------


@pytest.mark.parametrize("schema", ["narrow", "wide"])
def test_slab_locate_plain_matches_reference_kernel_and_oracle(schema):
    """The port's slab operands equal the reference's; on them the plain
    rank form equals the reference's jnp oracle, its Pallas kernel in
    interpret mode, and the host searchsorted."""
    ref, port = _tables(schema, 3000, 1)
    specs = _specs(SCHEMAS[schema][0], 40, 2)
    rq, tq = _queries(R, specs), _queries(T, specs)
    st = port._device
    cp, n = st["col_parts"], st["n_rows"]
    r_ops = rops._device_query_bounds(ref, rq, cp, n)
    t_ops = tops._device_query_bounds(port, tq, cp, n)
    for a, b in zip(r_ops, t_ops):
        np.testing.assert_array_equal(a, b)
    _, _, slab_lo, slab_hi, limits = t_ops
    assert (limits[:, 1] == 0).any()  # empty queries are in the batch
    keys = np.asarray(ref._device["keys"])
    lanes = sum(cp)
    got = slab_locate_plain(_t(keys), _t(slab_lo), _t(slab_hi), _t(limits)).numpy()
    oracle = np.asarray(rref.slab_locate_batched_ref(keys, slab_lo, slab_hi, limits.astype(np.int32), n_lanes=lanes))
    pallas = np.asarray(
        slab_locate_batched(keys, slab_lo, slab_hi, limits.astype(np.int32), n_lanes=lanes, block_n=1024)
    )
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, pallas)
    host = T.SortedTable(port.layout, port.schema, port.key_cols, port.value_cols, port.packed)
    np.testing.assert_array_equal(got, host.slab_many(tq))
    # the wrapper on CPU tensors is the plain version
    np.testing.assert_array_equal(
        slab_locate(_t(keys), _t(slab_lo), _t(slab_hi), _t(limits)).numpy(), got
    )


def test_slab_locate_windows_inside_the_run():
    """Windows that start and stop inside the run: ranks count only window
    rows, as the reference's rank form does."""
    ref, _ = _tables("narrow", 2000, 3)
    keys = np.asarray(ref._device["keys"])
    rng = np.random.default_rng(4)
    q = 12
    pick = rng.integers(0, 2000, (q, 2))
    slab_lo = keys[:3, pick[:, 0]].T.copy()
    slab_hi = keys[:3, pick[:, 1]].T.copy()
    limits = np.sort(rng.integers(0, 2001, (q, 2)), axis=1).astype(np.int32)
    got = slab_locate(_t(keys), _t(slab_lo), _t(slab_hi), _t(limits)).numpy()
    np.testing.assert_array_equal(got, np.asarray(rref.slab_locate_batched_ref(keys, slab_lo, slab_hi, limits, n_lanes=3)))


@settings(max_examples=10, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 600), bits_a=st.sampled_from([3, 8, 31, 40, 60]))
def test_property_slab_locate_matches_searchsorted(seed, n, bits_a):
    """Random schemas (narrow and two-lane wide columns), edge and empty
    bounds: the port's device slab location equals the host searchsorted."""
    rng = np.random.default_rng(seed)
    schema = T.KeySchema({"a": bits_a, "b": 2})
    kc = {c: rng.integers(0, schema.max_value(c) + 1, n).astype(np.int64) for c in ("a", "b")}
    t = T.SortedTable.from_columns(kc, {"m": rng.uniform(0, 1, n)}, ("a", "b"), schema)
    host = T.SortedTable(t.layout, t.schema, t.key_cols, t.value_cols, t.packed)
    t.place_on_device(CPU)
    top = schema.max_value("a")
    qs = [T.Query(filters={"a": T.Eq(int(v))}) for v in rng.integers(0, top + 1, 4)]
    qs += [
        T.Query(filters={"a": T.Range(int(lo), int(lo) + 5), "b": T.Eq(1)})
        for lo in rng.integers(0, max(top - 5, 1), 3)
    ]
    qs += [
        T.Query(filters={"a": T.Eq(0)}),
        T.Query(filters={"a": T.Eq(top)}),
        T.Query(filters={"b": T.Range(1, 1)}),
        T.Query(filters={}),
    ]
    np.testing.assert_array_equal(t.slab_many(qs), host.slab_many(qs))


# -- the two scans ----------------------------------------------------------------------


def _scan_inputs(rng, n, q, col_parts, n_vals):
    lanes, lo, hi = [], [], []
    for parts in col_parts:
        dom = 1 << (4 if parts == 1 else 33)
        col = rng.integers(0, dom, n)
        b_lo = rng.integers(0, dom, q)
        b_hi = np.where(rng.random(q) < 0.1, b_lo, np.minimum(b_lo + rng.integers(1, dom, q), dom))  # some empty
        if parts == 1:
            lanes.append(col.astype(np.int32))
            lo.append(b_lo.astype(np.int32))
            hi.append(b_hi.astype(np.int32))
        else:
            for dst, v in ((lanes, col), (lo, b_lo), (hi, b_hi)):
                dst.append((v >> 30).astype(np.int32))
                dst.append((v & ((1 << 30) - 1)).astype(np.int32))
    keys = np.stack(lanes)
    vals = rng.uniform(-1, 1, (n_vals, n)).astype(np.float32)
    slabs = np.sort(rng.integers(0, n + 1, (q, 2)), axis=1).astype(np.int32)
    slabs[::7] = [n // 2, n // 2]  # empty slabs
    sel = rng.integers(0, n_vals, q).astype(np.int32)
    return keys, vals, np.stack(lo, axis=1), np.stack(hi, axis=1), slabs, sel


@pytest.mark.parametrize("col_parts", [(1, 1, 1), (1, 2, 1), (2,)], ids=["narrow", "wide", "one-pair"])
def test_rowstream_plain_matches_reference_kernel_and_oracle(col_parts):
    rng = np.random.default_rng(len(col_parts))
    keys, vals, lo, hi, slabs, sel = _scan_inputs(rng, 4000, 30, col_parts, 3)
    got = scan_agg_rowstream(
        _t(keys), _t(vals, torch.float32), _t(lo), _t(hi), _t(slabs), _t(sel), col_parts=col_parts
    ).numpy()
    assert got.dtype == np.float32 and got.shape == (30, 2)
    pallas = np.asarray(
        scan_agg_batched_pallas(keys, vals, lo, hi, slabs, sel, col_parts=col_parts, block_n=512)
    )
    oracle = np.asarray(rref.scan_agg_batched_ref(keys, vals, lo, hi, slabs, value_sel=sel, col_parts=col_parts))
    for want in (pallas, oracle):
        np.testing.assert_array_equal(got[:, 1], want[:, 1])
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL, atol=ATOL)
    assert got[:, 1].sum() > 0


def test_rowstream_selector_outside_the_live_rows_sums_nothing():
    """A selector outside [0, n_vals) sums nothing but counts its rows, as
    the reference's kernel does."""
    rng = np.random.default_rng(5)
    keys, vals, lo, hi, slabs, _ = _scan_inputs(rng, 1500, 9, (1, 1), 3)
    sel = np.array([0, 1, 2, 3, -1, 5, 0, 2, 4], np.int32)
    got = scan_agg_rowstream(
        _t(keys), _t(vals, torch.float32), _t(lo), _t(hi), _t(slabs), _t(sel), col_parts=(1, 1), n_vals=3
    ).numpy()
    want = np.asarray(scan_agg_batched_pallas(keys, vals, lo, hi, slabs, sel, col_parts=(1, 1), n_vals=3, block_n=256))
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL, atol=ATOL)
    assert (got[[3, 4, 5, 8], 0] == 0).all()


def test_qgrid_plain_matches_reference_kernel_and_rowstream():
    rng = np.random.default_rng(6)
    keys, vals, lo, hi, slabs, _ = _scan_inputs(rng, 3000, 12, (1, 1, 1, 1), 1)
    got = scan_agg_qgrid(_t(keys), _t(vals[0], torch.float32), _t(lo), _t(hi), _t(slabs)).numpy()
    pallas = np.asarray(scan_agg_batched_qgrid_pallas(keys, vals[0], lo, hi, slabs, block_n=512))
    np.testing.assert_array_equal(got[:, 1], pallas[:, 1])
    np.testing.assert_allclose(got[:, 0], pallas[:, 0], rtol=RTOL, atol=ATOL)
    rows = scan_agg_rowstream_plain(
        _t(keys), _t(vals, torch.float32), _t(lo), _t(hi), _t(slabs), torch.zeros(12, dtype=torch.int32),
        col_parts=(1, 1, 1, 1),
    ).numpy()
    np.testing.assert_array_equal(got[:, 1], rows[:, 1])
    np.testing.assert_allclose(got[:, 0], rows[:, 0], rtol=RTOL, atol=ATOL)
    # padded key lanes beyond the bounds' K are not compared
    padded = np.concatenate([keys, np.full((4, 3000), 99, np.int32)])
    np.testing.assert_array_equal(
        scan_agg_qgrid_plain(_t(padded), _t(vals[0], torch.float32), _t(lo), _t(hi), _t(slabs)).numpy(), got
    )


@settings(max_examples=10, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), q=st.integers(1, 20), n=st.integers(0, 500), n_vals=st.integers(1, 4),
       col_parts=st.lists(st.sampled_from([1, 2]), min_size=1, max_size=4))
def test_property_rowstream_matches_oracle(seed, q, n, n_vals, col_parts):
    rng = np.random.default_rng(seed)
    col_parts = tuple(col_parts)
    keys, vals, lo, hi, slabs, sel = _scan_inputs(rng, n, q, col_parts, n_vals)
    got = scan_agg_rowstream(
        _t(keys), _t(vals, torch.float32), _t(lo), _t(hi), _t(slabs), _t(sel), col_parts=col_parts
    ).numpy()
    want = np.asarray(rref.scan_agg_batched_ref(keys, vals, lo, hi, slabs, value_sel=sel, col_parts=col_parts))
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL, atol=ATOL)


def test_scan_agg_and_batched_match_reference():
    """``ops.scan_agg`` (Q = 1) and ``ops.scan_agg_batched`` on CPU
    tensors: equal to the reference's on both grids."""
    rng = np.random.default_rng(7)
    keys, vals, lo, hi, slabs, sel = _scan_inputs(rng, 2500, 8, (1, 1, 1), 2)
    tk, tv, tlo, thi, tsl = _t(keys), _t(vals, torch.float32), _t(lo), _t(hi), _t(slabs)
    for grid in ("rows_outer", "queries_outer"):
        got = tops.scan_agg_batched(tk, tv[0], tlo, thi, tsl, grid=grid).numpy()
        want = np.asarray(RK.scan_agg_batched(keys, vals[0], lo, hi, slabs, grid=grid, block_n=512))
        np.testing.assert_array_equal(got[:, 1], want[:, 1])
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL, atol=ATOL)
    got = tops.scan_agg_batched(tk, tv, tlo, thi, tsl, _t(sel)).numpy()
    want = np.asarray(RK.scan_agg_batched(keys, vals, lo, hi, slabs, sel, block_n=512))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for j in range(3):
        one = tops.scan_agg(tk, tv[0], tlo[j], thi[j], tsl[j])
        assert one.shape == (2,) and one.dtype == torch.float32
        np.testing.assert_allclose(
            one.numpy(), np.asarray(RK.scan_agg(keys, vals[0], lo[j], hi[j], slabs[j], block_n=512)),
            rtol=RTOL, atol=ATOL,
        )


# -- the table path ---------------------------------------------------------------------


# the queries-outer grid takes narrow keys only (a wide batch raises, below)
@pytest.mark.parametrize(
    "schema,grid",
    [("narrow", "rows_outer"), ("wide", "rows_outer"), ("narrow", "queries_outer")],
)
@pytest.mark.parametrize("located", ["host_slabs", "device_slabs"])
def test_table_scan_device_many_matches_reference(schema, located, grid):
    """The port's table scan against the reference's, over slabs the
    host located or (``slabs=None``) the table's device slab location."""
    ref, port = _tables(schema, 4000, 8)
    aggs = ("sum", "count") if grid == "rows_outer" else ("count",)
    specs = _specs(SCHEMAS[schema][0], 24, 9, aggs)
    rq, tq = _queries(R, specs), _queries(T, specs)
    kw = {"grid": grid}
    if located == "host_slabs":
        host = R.SortedTable(ref.layout, ref.schema, ref.key_cols, ref.value_cols, ref.packed)
        kw["slabs"] = host.slab_many(rq)
    _assert_pairs_close(RK.table_scan_device_many(ref, rq, **kw), tops.table_scan_device_many(port, tq, **kw))
    _assert_pairs_close(
        [RK.table_scan_device(ref, q) for q in rq[:4]], [tops.table_scan_device(port, q) for q in tq[:4]]
    )


def test_table_scan_needs_a_resident_table():
    """The port scans resident tensors only: a host table is refused, and
    its answers stay with the host engine."""
    _, port = _tables("narrow", 3000, 10, resident=False)
    qs = _queries(T, _specs(SCHEMAS["narrow"][0], 16, 11))
    with pytest.raises(ValueError, match="device-resident"):
        tops.table_scan_device_many(port, qs)
    with pytest.raises(ValueError, match="device-resident"):
        tops.table_scan_device(port, qs[0])
    assert port._device is None


def test_table_scan_after_compaction_matches_reference():
    """Appends then an on-device compaction: one sorted run again, so the
    device slab location and the scans serve it, equal to the reference."""
    ref, port = _tables("wide", 3000, 12)
    bits = SCHEMAS["wide"][0]
    for step in range(2):
        wk, wv = _columns(bits, 400, 13 + step)
        ref = ref.merge_run(r_sort_run(wk, wv, ref.layout, ref.schema))
        port = port.merge_run(t_sort_run(wk, wv, port.layout, port.schema))
    ref.compact_runs()
    port.compact_runs()
    specs = _specs(bits, 20, 15)
    rq, tq = _queries(R, specs), _queries(T, specs)
    np.testing.assert_array_equal(ref.slab_many(rq), port.slab_many(tq))
    _assert_pairs_close(RK.table_scan_device_many(ref, rq), tops.table_scan_device_many(port, tq))


def test_slab_many_routes_single_runs_to_the_kernel(monkeypatch):
    """Single-run resident tables take the device slab location; host
    tables and appended run stacks keep the host searchsorted; all equal
    the reference's slabs."""
    ref, port = _tables("narrow", 3000, 16)
    _, host = _tables("narrow", 3000, 16, resident=False)
    specs = _specs(SCHEMAS["narrow"][0], 20, 17, ("sum", "count", "select"))
    rq, tq = _queries(R, specs), _queries(T, specs)
    calls = {"n": 0}
    real = tops.table_slab_locate_many

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(tops, "table_slab_locate_many", counting)
    want = ref.slab_many(rq)
    np.testing.assert_array_equal(port.slab_many(tq), want)
    assert calls["n"] == 1
    np.testing.assert_array_equal(host.slab_many(tq), want)
    assert port.slab_many([]).shape == (0, 2) and calls["n"] == 1
    assert calls["n"] == 1  # host tables keep the numpy path
    wk, wv = _columns(SCHEMAS["narrow"][0], 300, 18)
    ref2 = ref.merge_run(r_sort_run(wk, wv, ref.layout, ref.schema))
    port2 = port.merge_run(t_sort_run(wk, wv, port.layout, port.schema))
    assert port2._device["n_runs"] == 2
    np.testing.assert_array_equal(port2.slab_many(tq), ref2.slab_many(rq))
    assert calls["n"] == 1  # appended runs keep the numpy path


def test_unknown_aggregation_reaches_slab_many_and_raises_like_reference():
    """On a resident table an unknown aggregation takes the host scan after
    the device slab location, which raises there as in the reference."""
    ref, port = _tables("narrow", 1000, 19)
    with pytest.raises(ValueError, match="unknown agg"):
        ref.execute_many([R.Query(filters={}, agg="median")])
    with pytest.raises(ValueError, match="unknown agg"):
        port.execute_many([T.Query(filters={}, agg="median")])


# -- where the reference raises, the port raises ----------------------------------------


def _both_raise(ref_call, port_call, match):
    with pytest.raises(ValueError, match=match):
        ref_call()
    with pytest.raises(ValueError, match=match):
        port_call()


def test_appended_runs_are_refused():
    ref, port = _tables("narrow", 1000, 20)
    wk, wv = _columns(SCHEMAS["narrow"][0], 50, 21)
    ref = ref.merge_run(r_sort_run(wk, wv, ref.layout, ref.schema))
    port = port.merge_run(t_sort_run(wk, wv, port.layout, port.schema))
    specs = _specs(SCHEMAS["narrow"][0], 4, 22)
    rq, tq = _queries(R, specs), _queries(T, specs)
    _both_raise(lambda: RK.table_scan_device_many(ref, rq), lambda: tops.table_scan_device_many(port, tq), "single sorted run")
    _both_raise(lambda: RK.table_slab_locate_many(ref, rq), lambda: tops.table_slab_locate_many(port, tq), "single sorted run")


def test_slab_locate_needs_a_resident_table():
    ref, port = _tables("narrow", 500, 23, resident=False)
    q = [R.Query(filters={})], [T.Query(filters={})]
    _both_raise(lambda: RK.table_slab_locate_many(ref, q[0]), lambda: tops.table_slab_locate_many(port, q[1]), "device-resident")


@pytest.mark.parametrize("case", ["mixed", "wide", "unknown_grid", "select", "sum_without_column"])
def test_table_scan_raises_like_reference(case):
    schema = "wide" if case == "wide" else "narrow"
    ref, port = _tables(schema, 1000, 24)
    pkgs = {}
    for name, pkg in (("ref", R), ("port", T)):
        qs = [pkg.Query(filters={}, agg="count"), pkg.Query(filters={}, agg="count")]
        kw = {"grid": "queries_outer"}
        if case == "mixed":
            qs[0] = pkg.Query(filters={}, agg="sum", value_col="v")
        elif case == "unknown_grid":
            kw = {"grid": "diagonal"}
        elif case == "select":
            qs[1] = pkg.Query(filters={}, agg="select")
        elif case == "sum_without_column":
            qs[1] = pkg.Query(filters={}, agg="sum")
        pkgs[name] = (qs, kw)
    match = {"mixed": "uniform-agg", "wide": "narrow-key", "unknown_grid": "unknown grid",
             "select": "sum/count", "sum_without_column": "value_col"}[case]
    _both_raise(
        lambda: RK.table_scan_device_many(ref, pkgs["ref"][0], **pkgs["ref"][1]),
        lambda: tops.table_scan_device_many(port, pkgs["port"][0], **pkgs["port"][1]),
        match,
    )


@pytest.mark.parametrize("case", ["tile", "selector", "wide", "unknown_grid"])
def test_scan_agg_batched_raises_like_reference(case):
    keys = np.zeros((2, 64), np.int32)
    vals = np.zeros(64, np.float32)
    b = np.zeros((3, 2), np.int32)
    slabs = np.zeros((3, 2), np.int32)
    args, kw = (keys, vals, b, b, slabs), {"grid": "queries_outer"}
    if case == "tile":
        args = (keys, np.zeros((2, 64), np.float32), b, b, slabs)
    elif case == "selector":
        kw["value_sel"] = np.zeros(3, np.int32)
    elif case == "wide":
        kw["col_parts"] = (2,)
    else:
        kw = {"grid": "diagonal"}
    targs = tuple(torch.from_numpy(a) for a in args)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    match = {"tile": "single value row", "selector": "neither", "wide": "neither", "unknown_grid": "unknown grid"}[case]
    _both_raise(lambda: RK.scan_agg_batched(*args, **kw), lambda: tops.scan_agg_batched(*targs, **tkw), match)


def test_float32_count_guard(monkeypatch):
    """The row-slab scans' float32 count lane is exact to 2**24 rows; a
    larger table is refused, as by the reference (the constant lowered
    rather than 16 M rows built)."""
    ref, port = _tables("narrow", 600, 25)
    assert tops.FLOAT32_EXACT_ROWS == rops.FLOAT32_EXACT_ROWS == 1 << 24
    monkeypatch.setattr(rops, "FLOAT32_EXACT_ROWS", 512)
    monkeypatch.setattr(tops, "FLOAT32_EXACT_ROWS", 512)
    _both_raise(
        lambda: RK.table_scan_device_many(ref, [R.Query(filters={}, agg="count")]),
        lambda: tops.table_scan_device_many(port, [T.Query(filters={}, agg="count")]),
        "exact only to 512",
    )
    # the fused path has no such cap
    assert port.execute_many([T.Query(filters={}, agg="count")])[0].value == 600.0


def test_wrappers_check_operands_and_count_no_cpu_launch():
    keys = torch.zeros((4, 100), dtype=torch.int32)
    vals = torch.zeros((2, 100))
    b = torch.zeros((3, 2), dtype=torch.int32)
    sel = torch.zeros(3, dtype=torch.int32)
    before = {name: fn.launches for name, fn in TK.KERNELS.items()}
    wide = torch.zeros((3, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        slab_locate(keys, wide, wide, b)  # 5 bound lanes, 4 key lanes
    with pytest.raises(ValueError):
        slab_locate(keys.long(), b, b, b)
    with pytest.raises(ValueError):
        scan_agg_rowstream(keys, vals, b, b, b, sel, col_parts=(1, 2))
    with pytest.raises(ValueError):
        scan_agg_rowstream(keys, vals, b, b, b, sel, col_parts=(1, 1), n_vals=3)
    with pytest.raises(ValueError):
        scan_agg_qgrid(keys, vals, b, b, b)
    slab_locate(keys, b, b, b)
    scan_agg_rowstream(keys, vals, b, b, b, sel, col_parts=(1, 1))
    scan_agg_qgrid(keys, vals[0], b, b, b)
    assert {name: fn.launches for name, fn in TK.KERNELS.items()} == before
    for name in ("slab_locate", "scan_agg_rowstream", "scan_agg_qgrid"):
        assert name in TK.KERNELS


# -- the batched-read benchmark ---------------------------------------------------------


def test_batched_read_bench_runs_on_the_cpu():
    """Every engine once against the numpy engine (inside run_device), then
    timed: a positive rate per engine and batch size."""
    out = batched_read.run_device(n_rows=4000, batch_sizes=(8, 32), repeats=1, device=CPU)
    assert out["device"] == "cpu" and out["n_rows"] == 4000
    assert set(out["batches"]) == {8, 32}
    for res in out["batches"].values():
        for name in batched_read.ENGINES:
            assert res[f"{name}_qps"] > 0
