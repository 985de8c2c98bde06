"""The row-slab scans' work decomposition, written out in PyTorch beside
the kernels (``repro_torch.kernels.scan_agg``), held to the JAX
reference's kernels and to the plain versions.

Rows outer: the (tile, query) pairs a CTA evaluates
(``rowstream_live_list``), each pair's partial in the card's order
(``unit_partials_emulated``), query-major partials folded in ascending
tile order (``slab_fold_emulated``). Queries outer: per-query block
counts and their scan (``qgrid_block_offsets``), the pair index to
(query, block) map of the persistent CTAs (``qgrid_pair_units``), the
partials and the fold. The edge cases (``bench.row_slab.edge_cases``):
empty slabs, slabs that start or end inside a 2048-row unit, slabs at
the table's end with ``n`` not a multiple of the unit, one query, more
queries than a rowstream chunk, wide lane pairs, selectors outside
``[0, n_vals)``, tiles no slab meets, slabs of 70 units (a fold of
more than two rounds of 32 partials). The reference runs its Pallas
kernels in interpret mode; counts must be equal, sums within rtol 1e-5 /
atol 1e-3 (the reduction orders differ). ``tests/test_torch_cuda.py``
holds the CUDA kernels to these emulations bit for bit on the card.
"""

import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.kernels as RK
from repro.kernels import ref as rref
from repro.kernels.scan_agg import scan_agg_batched_pallas, scan_agg_batched_qgrid_pallas
from repro_torch.bench.row_slab import EDGE_CASES, _operands, edge_cases
from repro_torch.kernels import ops as tops
from repro_torch.kernels.scan_agg import (
    UNIT_ROWS,
    qgrid_block_offsets,
    qgrid_pair_units,
    rowstream_live_list,
    scan_agg_qgrid,
    scan_agg_qgrid_emulated,
    scan_agg_qgrid_plain,
    scan_agg_rowstream,
    scan_agg_rowstream_emulated,
    scan_agg_rowstream_plain,
    slab_fold_emulated,
    slab_units,
    unit_partials_emulated,
)

RTOL, ATOL = 1e-5, 1e-3
NARROW = tuple(n for n in EDGE_CASES if n != "wide")


@functools.lru_cache(maxsize=None)
def _cases():
    return edge_cases()


def _t(a, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _tensors(c):
    return (
        _t(c["keys"]), _t(c["values"], torch.float32), _t(c["lo"]), _t(c["hi"]), _t(c["slabs"]), _t(c["sel"]),
    )


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=RTOL, atol=ATOL)


def _oracle(c):
    """The reference's jnp oracle on a case, and which queries' sums it
    defines (it takes no ``n_vals``: a selector outside the live value
    rows is compared on its count only)."""
    nv = c["n_vals"]
    out = np.asarray(rref.scan_agg_batched_ref(
        c["keys"], c["values"][:nv], c["lo"], c["hi"], c["slabs"], value_sel=np.clip(c["sel"], 0, nv - 1),
        col_parts=c["col_parts"],
    ))
    return out, (c["sel"] >= 0) & (c["sel"] < nv)


def _close_oracle(got, c):
    want, sums = _oracle(c)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[sums, 0], want[sums, 0], rtol=RTOL, atol=ATOL)


def _live_brute(slabs, n):
    """(tile, query) pairs whose slab, clipped to the table, meets the
    tile: tile by tile, queries ascending."""
    pairs = []
    for t in range(-(-n // UNIT_ROWS)):
        lo, hi = t * UNIT_ROWS, min((t + 1) * UNIT_ROWS, n)
        for q, (a, b) in enumerate(slabs):
            if max(int(a), lo, 0) < min(int(b), hi, n):
                pairs.append((t, q))
    return np.array(pairs, np.int64).reshape(-1, 2)


# -- rows outer -------------------------------------------------------------------------


@pytest.mark.parametrize("name", EDGE_CASES)
def test_rowstream_decomposition_matches_reference_and_plain(name):
    """The emulated kernel (live pairs, partials, fold) against the
    reference's Pallas kernel, its jnp oracle and the plain version; the
    wrapper on CPU tensors is the plain version."""
    c = _cases()[name]
    keys, vals, lo, hi, slabs, sel = _tensors(c)
    cp, nv = c["col_parts"], c["n_vals"]
    emu = scan_agg_rowstream_emulated(keys, vals, lo, hi, slabs, sel, col_parts=cp, n_vals=nv).numpy()
    plain = scan_agg_rowstream_plain(keys, vals[:nv], lo, hi, slabs, sel, col_parts=cp)
    np.testing.assert_array_equal(
        scan_agg_rowstream(keys, vals, lo, hi, slabs, sel, col_parts=cp, n_vals=nv, ones_row=c["ones_row"]).numpy(),
        plain.numpy(),
    )
    args = (c["keys"], c["values"], c["lo"], c["hi"], c["slabs"], c["sel"])
    pallas = scan_agg_batched_pallas(*args, col_parts=cp, n_vals=nv, block_n=UNIT_ROWS)
    for want in (plain.numpy(), pallas):
        _close(emu, want)
    _close_oracle(emu, c)
    assert emu.dtype == np.float32 and emu.shape == (len(c["sel"]), 2)
    if name not in ("empty_slabs",):
        assert emu[:, 1].sum() > 0


@pytest.mark.parametrize("name", EDGE_CASES)
def test_rowstream_live_list_is_every_pair_a_slab_meets(name):
    """A CTA lists exactly the queries whose slab (clipped to the table)
    meets its tile, ascending; a tile with none is absent."""
    c = _cases()[name]
    n = c["keys"].shape[1]
    got = rowstream_live_list(_t(c["slabs"]), n).numpy()
    np.testing.assert_array_equal(got, _live_brute(c["slabs"], n))
    b0, b1 = slab_units(_t(c["slabs"]), n)
    assert len(got) == int((b1 - b0).sum())
    tiles = set(got[:, 0].tolist())
    if name == "empty_slabs":
        assert not tiles
    if name == "dead_tiles":
        assert tiles == {0, 1, 4}
    if name == "table_end":  # the last, partial tile is served
        assert -(-n // UNIT_ROWS) - 1 in tiles and n % UNIT_ROWS


def test_rowstream_selectors_outside_the_value_rows_sum_nothing():
    """A selector at or past ``n_vals`` or negative sums nothing, though
    the value tile holds a row there, and still counts."""
    c = _cases()["selectors"]
    keys, vals, lo, hi, slabs, sel = _tensors(c)
    emu = scan_agg_rowstream_emulated(keys, vals, lo, hi, slabs, sel, col_parts=c["col_parts"], n_vals=c["n_vals"])
    out = (c["sel"] < 0) | (c["sel"] >= c["n_vals"])
    assert out.any() and (emu[torch.from_numpy(out), 0] == 0).all()
    assert emu[torch.from_numpy(out), 1].sum() > 0
    # the count row's sums are its counts, exactly
    ones = torch.from_numpy(c["sel"] == c["ones_row"])
    assert ones.any() and torch.equal(emu[ones, 0], emu[ones, 1])


# -- queries outer ----------------------------------------------------------------------


def _probe_walk(offs, n_q, grid):
    """The persistent CTAs' map, step by step: CTA g takes pair indices g,
    g + grid, ... and advances its query by probing 32 offsets at a time
    from the query of its previous pair."""
    total = int(offs[n_q])
    got = {}
    for g in range(grid):
        q = 0
        for p in range(g, total, grid):
            while True:
                past = [i <= n_q and int(offs[i]) <= p for i in range(q + 1, q + 33)]
                q += sum(past)
                if not all(past):
                    break
            got[p] = q
    return np.array([got[p] for p in range(total)], np.int64)


@pytest.mark.parametrize("name", NARROW)
def test_qgrid_block_counts_scan_and_pair_map(name):
    """Per query the blocks its slab meets, their exclusive scan, and each
    pair index mapped to (query, block) as the persistent CTAs map it:
    every block a slab meets is one pair, query-major, blocks ascending."""
    c = _cases()[name]
    n = c["keys"].shape[1]
    slabs = _t(c["slabs"])
    counts, offs = qgrid_block_offsets(slabs, n)
    live = _live_brute(c["slabs"], n)
    want_counts = np.bincount(live[:, 1], minlength=len(c["slabs"])) if len(live) else np.zeros(len(c["slabs"]))
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(offs.numpy(), np.concatenate([[0], np.cumsum(want_counts)]))
    pairs = qgrid_pair_units(offs, slabs, n).numpy()
    want = live[np.lexsort((live[:, 0], live[:, 1]))][:, ::-1]  # (query, block), query-major
    np.testing.assert_array_equal(pairs, want)
    for grid in (1, 3, 7):
        np.testing.assert_array_equal(_probe_walk(offs.numpy(), len(c["slabs"]), grid), pairs[:, 0])


@pytest.mark.parametrize("name", NARROW)
def test_qgrid_decomposition_matches_reference_and_plain(name):
    """The emulated kernel (block offsets, pair map, partials, fold) on one
    value row against the reference's Pallas kernel, the plain version
    and the rows-outer counts; the wrapper on CPU tensors is plain."""
    c = _cases()[name]
    keys, vals, lo, hi, slabs, sel = _tensors(c)
    emu = scan_agg_qgrid_emulated(keys, vals[0], lo, hi, slabs).numpy()
    plain = scan_agg_qgrid_plain(keys, vals[0], lo, hi, slabs).numpy()
    np.testing.assert_array_equal(scan_agg_qgrid(keys, vals[0], lo, hi, slabs).numpy(), plain)
    pallas = scan_agg_batched_qgrid_pallas(c["keys"], c["values"][0], c["lo"], c["hi"], c["slabs"], block_n=UNIT_ROWS)
    for want in (plain, pallas):
        _close(emu, want)
    rows = scan_agg_rowstream_emulated(
        keys, vals, lo, hi, slabs, torch.zeros_like(sel), col_parts=c["col_parts"], n_vals=c["n_vals"]
    ).numpy()
    np.testing.assert_array_equal(emu[:, 1], rows[:, 1])


# -- partials and fold ------------------------------------------------------------------


def test_partials_and_fold_order():
    """A pair's partial adds its thread sums by butterfly and warp slots;
    the fold adds a query's partials lane by lane (lane j: the range's
    partials j, j + 32, ... ascending from +0.0), then by butterfly,
    reading only the units its slab meets (the rest are NaN here)."""
    c = _cases()["long_slabs"]
    keys, vals, lo, hi, slabs, sel = _tensors(c)
    n = keys.shape[1]
    pairs = rowstream_live_list(slabs, n)[:, [1, 0]]
    part_s, part_c = unit_partials_emulated(
        keys, vals[: c["n_vals"]], lo, hi, slabs, sel, pairs, col_parts=c["col_parts"], n=n
    )
    n_units = -(-n // UNIT_ROWS)
    grid_s = torch.full((len(sel), n_units), float("nan"))
    grid_c = torch.full((len(sel), n_units), -1, dtype=torch.int32)
    grid_s[pairs[:, 0], pairs[:, 1]] = part_s
    grid_c[pairs[:, 0], pairs[:, 1]] = part_c
    out = slab_fold_emulated(grid_s, grid_c, slabs, n)
    assert torch.isfinite(out).all()
    b0, b1 = slab_units(slabs, n)
    assert int((b1 - b0).max()) > 64
    for q in range(len(sel)):
        lanes = np.zeros(32, np.float32)
        for b in range(int(b0[q]), int(b1[q])):
            j = (b - int(b0[q])) % 32
            lanes[j] = np.float32(lanes[j] + np.float32(grid_s[q, b]))
        for o in (16, 8, 4, 2, 1):
            lanes = (lanes + lanes[np.arange(32) ^ o]).astype(np.float32)
        assert out[q, 0].item() == lanes[0]
        assert out[q, 1].item() == int(grid_c[q, int(b0[q]) : int(b1[q])].sum())
    _close(out.numpy(), scan_agg_rowstream_plain(keys, vals[: c["n_vals"]], lo, hi, slabs, sel, col_parts=c["col_parts"]))


def test_one_query_launch_matches_reference():
    """``ops.scan_agg`` (the Q = 1 launch of the rows-outer scan) on the
    one-query case, against the reference's and the emulated kernel."""
    c = _cases()["one_query"]
    keys, vals, lo, hi, slabs, _ = _tensors(c)
    got = tops.scan_agg(keys, vals[0], lo[0], hi[0], slabs[0]).numpy()
    want = np.asarray(RK.scan_agg(c["keys"], c["values"][0], c["lo"][0], c["hi"][0], c["slabs"][0], block_n=UNIT_ROWS))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    emu = scan_agg_rowstream_emulated(keys, vals[:1], lo, hi, slabs, torch.zeros(1, dtype=torch.int32), col_parts=(1, 1, 1))
    _close(emu.numpy(), got[None, :])


@settings(max_examples=10, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(0, 3 * UNIT_ROWS + 300), q=st.integers(1, 40),
       col_parts=st.lists(st.sampled_from([1, 2]), min_size=1, max_size=3))
def test_property_emulated_scans_match_oracle(seed, n, q, col_parts):
    """Random tables (any ``n``, wide and narrow columns) and slabs: the
    emulated rows-outer kernel equals the reference's oracle, and on
    narrow keys the emulated queries-outer kernel equals its plain
    version."""
    rng = np.random.default_rng(seed)
    c = _operands(rng, n, q, col_parts=tuple(col_parts))
    keys, vals, lo, hi, slabs, sel = _tensors(c)
    cp, nv = c["col_parts"], c["n_vals"]
    emu = scan_agg_rowstream_emulated(keys, vals, lo, hi, slabs, sel, col_parts=cp, n_vals=nv).numpy()
    _close_oracle(emu, c)
    if set(cp) == {1}:
        _close(scan_agg_qgrid_emulated(keys, vals[0], lo, hi, slabs).numpy(),
               scan_agg_qgrid_plain(keys, vals[0], lo, hi, slabs).numpy())
