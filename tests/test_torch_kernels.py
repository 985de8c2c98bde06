"""Parity of the port's device layer (``repro_torch.kernels``) with the
JAX reference (``repro.kernels``).

The same numpy inputs go through the reference function (Pallas kernels
in interpret mode, as the reference's own tests run them on the CPU) and
through the port's wrapper on CPU tensors, which runs its plain PyTorch
version. Resident states, ``run_starts``, ``row_map``, counts, indices,
merge permutations and histograms must be equal; float32 sums agree
within rtol 1e-5 / atol 1e-3 (the reference's own device-vs-numpy
tolerance). Every schema is pinned by an explicit ``KeySchema``.

``tests/test_torch_cuda.py`` holds the CUDA kernels against these plain
versions on the card.
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro.kernels as RK
import repro_torch.core as T
import repro_torch.kernels as TK
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ecdf_hist import ecdf_hist
from repro_torch.kernels.merge_runs import merge_run_positions
from repro_torch.kernels.slab_locate import scan_agg_locate, select_compact
from repro_torch.core.storage.memtable import sort_run as t_sort_run
from repro.core.storage.memtable import sort_run as r_sort_run

CPU = torch.device("cpu")

# (name, bits, layout): narrow keys, one 31-60-bit wide column, and the
# same wide schema used for the empty table
SCHEMAS = {
    "narrow": ({"a": 7, "b": 9, "c": 5}, ("b", "a", "c")),
    "wide": ({"a": 6, "w": 45, "c": 5}, ("a", "w", "c")),
}


def _columns(bits, n, seed):
    rng = np.random.default_rng(seed)
    kc = {c: rng.integers(0, 1 << b, n, dtype=np.int64) for c, b in bits.items()}
    vc = {"v": rng.uniform(-10.0, 100.0, n), "u": rng.integers(0, 7, n).astype(np.float64)}
    return kc, vc


def _tables(bits, layout, kc, vc):
    ref = R.SortedTable.from_columns(kc, vc, layout, R.KeySchema(dict(bits)))
    port = T.SortedTable.from_columns(kc, vc, layout, T.KeySchema(dict(bits)))
    return ref, port


def _query_specs(bits, n_q, seed):
    """Random filter specs: per column an equality, a range, an empty
    range or no filter; one aggregation each of sum/count/select."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n_q):
        filters = {}
        for c, b in bits.items():
            top = 1 << b
            kind = rng.integers(0, 4)
            if kind == 0:
                filters[c] = ("eq", int(rng.integers(0, top)))
            elif kind == 1:
                lo = int(rng.integers(0, top))
                filters[c] = ("range", lo, int(rng.integers(lo, top + 1)))
            elif kind == 2 and i % 7 == 3:
                lo = int(rng.integers(0, top))
                filters[c] = ("range", lo, lo)  # empty range
        agg = ("sum", "count", "select")[i % 3]
        specs.append((filters, agg, ("v", "u")[i % 2] if agg == "sum" else None))
    return specs


def _queries(pkg, specs):
    out = []
    for filters, agg, vcol in specs:
        f = {
            c: pkg.Eq(s[1]) if s[0] == "eq" else pkg.Range(s[1], s[2])
            for c, s in filters.items()
        }
        out.append(pkg.Query(filters=f, agg=agg, value_col=vcol))
    return out


def _np_state(state):
    return {**state, "keys": np.asarray(state["keys"]), "values_tile": np.asarray(state["values_tile"])}


def _assert_states_equal(ref_state, port_state):
    np.testing.assert_array_equal(np.asarray(ref_state["keys"]), port_state["keys"].numpy())
    np.testing.assert_array_equal(
        np.asarray(ref_state["values_tile"]), port_state["values_tile"].numpy()
    )
    for k in ("col_parts", "value_rows", "ones_row", "n_value_rows", "n_rows", "n_runs"):
        assert ref_state[k] == port_state[k], k
    assert tuple(ref_state["run_starts"]) == tuple(port_state["run_starts"])
    if ref_state["row_map"] is None:
        assert port_state["row_map"] is None
    else:
        np.testing.assert_array_equal(ref_state["row_map"], port_state["row_map"])


# -- resident state ------------------------------------------------------------


@pytest.mark.parametrize(
    "schema,n", [("narrow", 5000), ("wide", 9000), ("wide", 0)], ids=["narrow", "wide", "empty"]
)
def test_build_device_state_matches_reference(schema, n):
    bits, layout = SCHEMAS[schema]
    kc, vc = _columns(bits, n, seed=3)
    ref, port = _tables(bits, layout, kc, vc)
    _assert_states_equal(rops.build_device_state(ref), tops.build_device_state(port, device=CPU))


@pytest.mark.parametrize("schema", ["narrow", "wide"])
def test_append_and_merge_runs_match_reference(schema):
    """Write drips through ``merge_run`` on resident tables: the appended
    states (capacity growth across a block boundary included), then the
    on-device merge of the run stack, equal the reference's."""
    bits, layout = SCHEMAS[schema]
    kc, vc = _columns(bits, 7000, seed=4)
    ref, port = _tables(bits, layout, kc, vc)
    ref.place_on_device()
    port.place_on_device(CPU)
    for step, m in enumerate((900, 1, 700, 1500)):
        wk, wv = _columns(bits, m, seed=10 + step)
        # duplicate some existing keys so the tie rule is exercised
        for c in wk:
            wk[c][: m // 3] = kc[c][: m // 3]
        ref = ref.merge_run(r_sort_run(wk, wv, ref.layout, ref.schema))
        port = port.merge_run(t_sort_run(wk, wv, port.layout, port.schema))
        _assert_states_equal(ref._device, port._device)
        np.testing.assert_array_equal(ref.packed, port.packed)
    assert port._device["n_runs"] == 5
    _assert_states_equal(
        rops.merge_device_runs(ref._device), tops.merge_device_runs(port._device)
    )
    # compaction makes device order the host order: a fresh build agrees
    port.compact_runs()
    _assert_states_equal(rops.build_device_state(ref), port._device)


def test_append_onto_empty_base_is_the_base_run():
    bits, layout = SCHEMAS["wide"]
    ref, port = _tables(bits, layout, *_columns(bits, 0, seed=0))
    ref.place_on_device()
    port.place_on_device(CPU)
    wk, wv = _columns(bits, 300, seed=1)
    ref = ref.merge_run(r_sort_run(wk, wv, ref.layout, ref.schema))
    port = port.merge_run(t_sort_run(wk, wv, port.layout, port.schema))
    _assert_states_equal(ref._device, port._device)
    assert port._device["n_runs"] == 1 and port._device["row_map"] is None


def test_state_from_numpy_round_trips_reference_state():
    bits, layout = SCHEMAS["wide"]
    ref, _ = _tables(bits, layout, *_columns(bits, 3000, seed=5))
    ref.place_on_device()
    _assert_states_equal(ref._device, tops.state_from_numpy(_np_state(ref._device), CPU))


# -- fused locate+scan and select compaction -------------------------------------


def _bound_operands(ref_table, port_table, specs):
    """The kernels' operands from both implementations' host prep; they
    must agree before the kernels are compared."""
    rq, tq = _queries(R, specs), _queries(T, specs)
    state = ref_table._device
    r_ops = rops._device_query_bounds(ref_table, rq, state["col_parts"], state["n_rows"])
    t_ops = tops._device_query_bounds(port_table, tq, state["col_parts"], state["n_rows"])
    for a, b in zip(r_ops, t_ops):
        np.testing.assert_array_equal(a, b)
    sel = np.array(
        [state["value_rows"][q.value_col] if q.agg == "sum" else state["ones_row"] for q in rq],
        np.int32,
    )
    return r_ops, sel


@pytest.mark.parametrize("schema", ["narrow", "wide"])
def test_scan_agg_locate_matches_reference(schema):
    bits, layout = SCHEMAS[schema]
    ref, port = _tables(bits, layout, *_columns(bits, 12000, seed=6))
    ref.place_on_device()
    specs = _query_specs(bits, 30, seed=7)
    (res_lo, res_hi, slab_lo, slab_hi, limits), sel = _bound_operands(ref, port, specs)
    st = ref._device
    r_sum, r_m, r_c = RK.scan_agg_locate_batched(
        st["keys"], st["values_tile"], res_lo, res_hi, slab_lo, slab_hi, limits, sel,
        col_parts=st["col_parts"], n_vals=st["n_value_rows"], block_n=tops.DEVICE_BLOCK_N,
    )
    pst = tops.state_from_numpy(_np_state(st), CPU)
    t32 = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in (res_lo, res_hi, slab_lo, slab_hi, limits, sel)]
    t_sum, t_m, t_c = scan_agg_locate(
        pst["keys"], pst["values_tile"], *t32, col_parts=st["col_parts"],
        n_vals=st["n_value_rows"],
    )
    np.testing.assert_array_equal(np.asarray(r_m), t_m.numpy())
    np.testing.assert_array_equal(np.asarray(r_c), t_c.numpy())
    np.testing.assert_allclose(np.asarray(r_sum), t_sum.numpy(), rtol=1e-5, atol=1e-3)
    # the empty-query encoding produces zeros
    empty = limits[:, 1] == 0
    assert empty.any()
    assert not t_sum.numpy()[empty].any() and not t_m.numpy()[empty].any()
    assert not t_c.numpy()[empty].any()


@pytest.mark.parametrize("schema", ["narrow", "wide"])
def test_select_compact_matches_reference(schema):
    bits, layout = SCHEMAS[schema]
    ref, port = _tables(bits, layout, *_columns(bits, 12000, seed=8))
    ref.place_on_device()
    specs = [s for s in _query_specs(bits, 60, seed=9)]
    (res_lo, res_hi, _, _, limits), _ = _bound_operands(ref, port, specs)
    st = ref._device
    matched = np.asarray(
        rref.scan_agg_locate_batched_ref(
            st["keys"], st["values_tile"], res_lo, res_hi, res_lo, res_hi, limits,
            np.zeros(len(specs), np.int32), col_parts=st["col_parts"],
        )[1],
        np.int64,
    )
    assert matched.max() > 0 and (matched == 0).any()
    width = 128
    while width < matched.max():
        width *= 2
    r_idx = np.asarray(
        RK.select_compact_batched(
            st["keys"], res_lo, res_hi, limits, col_parts=st["col_parts"],
            out_width=width, block_n=tops.DEVICE_BLOCK_N,
        )
    )
    pst = tops.state_from_numpy(_np_state(st), CPU)
    t32 = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in (res_lo, res_hi, limits)]
    flat = select_compact(pst["keys"], *t32, matched, col_parts=st["col_parts"]).numpy()
    assert flat.shape == (matched.sum(),)
    off = np.concatenate([[0], np.cumsum(matched)])
    for j in range(len(specs)):
        np.testing.assert_array_equal(r_idx[j, : matched[j]], flat[off[j] : off[j + 1]])


def test_table_execute_device_many_matches_reference_after_appends():
    """The whole device read on an appended run stack (selects through
    ``row_map``): every ScanResult field against the reference's."""
    bits, layout = SCHEMAS["wide"]
    kc, vc = _columns(bits, 9000, seed=11)
    ref, port = _tables(bits, layout, kc, vc)
    ref.place_on_device()
    port.place_on_device(CPU)
    for step in range(2):
        wk, wv = _columns(bits, 800, seed=20 + step)
        ref = ref.merge_run(r_sort_run(wk, wv, ref.layout, ref.schema))
        port = port.merge_run(t_sort_run(wk, wv, port.layout, port.schema))
    specs = _query_specs(bits, 30, seed=12)
    r_out = rops.table_execute_device_many(ref, _queries(R, specs))
    t_out = tops.table_execute_device_many(port, _queries(T, specs))
    for a, b in zip(r_out, t_out):
        assert (a.rows_scanned, a.rows_matched) == (b.rows_scanned, b.rows_matched)
        np.testing.assert_allclose(a.value, b.value, rtol=1e-5, atol=1e-3)
        if a.selected is None:
            assert b.selected is None
        else:
            np.testing.assert_array_equal(a.selected, b.selected)


# -- merge ranks and histogram -------------------------------------------------------


@pytest.mark.parametrize("n_runs,seed", [(2, 0), (4, 1), (9, 2)])
def test_merge_run_positions_matches_reference_oracle(n_runs, seed):
    """Random sorted runs with many duplicate keys across runs: the
    permutation equals ``merge_run_positions_ref``."""
    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(1, 400)) for _ in range(n_runs)]
    lens[0] = 2000
    lanes = []
    for m in lens:
        k = np.stack([rng.integers(0, 6, m), rng.integers(0, 1 << 29, m) % 50])
        order = np.lexsort(k[::-1])
        lanes.append(k[:, order])
    keys = np.zeros((8, -(-sum(lens) // 8192) * 8192), np.int32)
    keys[:2, : sum(lens)] = np.concatenate(lanes, axis=1)
    starts = tuple(int(s) for s in np.cumsum([0] + lens[:-1]))
    n = sum(lens)
    want = rref.merge_run_positions_ref(keys, starts, n, n_lanes=2)
    np.testing.assert_array_equal(
        np.asarray(RK.merge_run_positions(keys, starts, n, n_lanes=2, block_n=2048)), want
    )
    got = merge_run_positions(torch.from_numpy(keys), starts, n, n_lanes=2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "n,n_bins,bin_width", [(0, 16, 1), (5000, 4096, 3), (20000, 100, 7)]
)
def test_ecdf_hist_matches_bincount(n, n_bins, bin_width):
    rng = np.random.default_rng(n)
    col = rng.integers(0, n_bins * bin_width + 50, n).astype(np.int32)
    col[::17] = -1  # padding is ignored
    valid = col[col >= 0] // bin_width
    want = np.bincount(valid[valid < n_bins], minlength=n_bins).astype(np.float32)
    got = ecdf_hist(torch.from_numpy(col), n_bins=n_bins, bin_width=bin_width)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(RK.ecdf_hist(col, n_bins=n_bins, bin_width=bin_width)), want
    )


def test_wrappers_check_their_operands():
    keys = torch.zeros((8, 8192), dtype=torch.int32)
    vals = torch.zeros((8, 8192), dtype=torch.float32)
    b = torch.zeros((2, 3), dtype=torch.int32)
    lim = torch.zeros((2, 2), dtype=torch.int32)
    sel = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        scan_agg_locate(keys.float(), vals, b, b, b, b, lim, sel, col_parts=(1, 1, 1))
    with pytest.raises(ValueError):
        scan_agg_locate(keys, vals, b, b, b, b, lim, sel, col_parts=(1, 2, 1))
    with pytest.raises(ValueError):
        scan_agg_locate(keys, vals, b.t(), b, b, b, lim, sel, col_parts=(1, 1))
    with pytest.raises(ValueError):
        select_compact(keys, b, b, lim, np.zeros(3), col_parts=(1, 1, 1))
    with pytest.raises(ValueError):
        ecdf_hist(torch.zeros(4, dtype=torch.int64), n_bins=4, bin_width=1)
    with pytest.raises(ValueError):
        merge_run_positions(keys, (0, 9000), 8192, n_lanes=1)


def test_counters_count_only_kernel_launches():
    """CPU tensors take the plain versions: no wrapper counts a launch."""
    before = {name: fn.launches for name, fn in TK.KERNELS.items()}
    ecdf_hist(torch.arange(10, dtype=torch.int32), n_bins=4, bin_width=3)
    merge_run_positions(torch.zeros((8, 8192), dtype=torch.int32), (0, 10), 20, n_lanes=1)
    assert {name: fn.launches for name, fn in TK.KERNELS.items()} == before
