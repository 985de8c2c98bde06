"""The write path's two kernels, written out on the CPU: the pairwise merge
ranks and the batched ECDF histogram.

``merge_runs.pairwise_positions_emulated`` is the merge-rank kernel's
scheme in PyTorch (the smaller run of each pair binary-searches the
larger, a difference array over the searched run, one scan); it must equal
the port's plain version (``merge_run_positions_plain``, stable sorts) and
the reference's oracle (``ref.merge_run_positions_ref``, one lexsort)
exactly, on run stacks built to reach every branch of the scheme.
``ecdf_hist_many`` (plain on CPU tensors) must equal per-column
``ecdf_hist`` and ``np.bincount`` exactly, and ``TableStats.merge_rows``
with a CPU device, which sends the columns the kernel takes through one
``ecdf_hist_many`` call, must leave the reference's counts. Inputs come
from fixed numpy seeds; schemas are explicit ``KeySchema``s.
"""

import importlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as R
import repro.kernels as RK
import repro_torch.core as T
from repro.kernels import ref as rref
from repro_torch.kernels.ecdf_hist import ecdf_hist, ecdf_hist_many, ecdf_hist_many_plain
from repro_torch.kernels.merge_runs import (
    merge_run_positions,
    merge_run_positions_plain,
    pairwise_positions_emulated,
)

CPU = torch.device("cpu")
# the module (the package's ``ecdf_hist`` attribute is the wrapper)
hist_mod = importlib.import_module("repro_torch.kernels.ecdf_hist")


# -- merge ranks -------------------------------------------------------------------


def _sorted_run(rng, m, domains):
    """int32[len(domains), m]: random key tuples sorted lexicographically."""
    k = np.stack([rng.integers(0, d, m) for d in domains]) if m else np.zeros((len(domains), 0), np.int64)
    return k[:, np.lexsort(k[::-1])] if m else k


def _stack(runs, pad_lanes=8):
    """Key lanes of a run stack (device order, padded as resident lanes
    are), its run starts and its row count."""
    lens = [r.shape[1] for r in runs]
    n = sum(lens)
    keys = np.zeros((max(pad_lanes, runs[0].shape[0]), max(n, 1)), np.int32)
    keys[: runs[0].shape[0], :n] = np.concatenate(runs, axis=1)
    return keys, tuple(int(s) for s in np.cumsum([0] + lens[:-1])), n


def _all_agree(keys, starts, n, n_lanes):
    want = rref.merge_run_positions_ref(keys, starts, n, n_lanes=n_lanes)
    t = torch.from_numpy(keys)
    np.testing.assert_array_equal(merge_run_positions_plain(t, starts, n, n_lanes=n_lanes).numpy(), want)
    np.testing.assert_array_equal(pairwise_positions_emulated(t, starts, n, n_lanes=n_lanes).numpy(), want)
    np.testing.assert_array_equal(merge_run_positions(t, starts, n, n_lanes=n_lanes).numpy(), want)
    assert np.array_equal(np.sort(want), np.arange(n))


@pytest.mark.parametrize("n_runs,seed", [(1, 0), (2, 1), (9, 2), (64, 3)])
def test_pairwise_ranks_on_run_stacks(n_runs, seed):
    """A base and appended runs of random sizes; small key domains, so
    keys repeat inside runs and across them."""
    rng = np.random.default_rng(seed)
    lens = [1500] + [int(rng.integers(1, 120)) for _ in range(n_runs - 1)]
    runs = [_sorted_run(rng, m, (5, 7, 40)) for m in lens]
    _all_agree(*_stack(runs), n_lanes=3)


def test_pairwise_ranks_on_runs_of_equal_size():
    """Equal sizes: ties in size go by run index, so each pair is
    searched once, from the lower index."""
    rng = np.random.default_rng(4)
    runs = [_sorted_run(rng, 200, (6, 30)) for _ in range(7)]
    _all_agree(*_stack(runs), n_lanes=2)


def test_pairwise_ranks_with_empty_appended_runs():
    rng = np.random.default_rng(5)
    lens = [800, 0, 50, 0, 0, 30, 0]
    runs = [_sorted_run(rng, m, (9, 11)) for m in lens]
    _all_agree(*_stack(runs), n_lanes=2)


def test_pairwise_ranks_with_a_base_smaller_than_an_appended_run():
    """The largest run, the one nothing searches from, is appended, not
    the base."""
    rng = np.random.default_rng(6)
    lens = [40, 900, 25, 300]
    runs = [_sorted_run(rng, m, (4, 50)) for m in lens]
    _all_agree(*_stack(runs), n_lanes=2)


@pytest.mark.parametrize("n_runs,seed", [(9, 7), (3, 8)])
def test_stable_argsort_of_packed_keys_newest_first_is_the_merge(n_runs, seed):
    """The library call the benchmark times beside the kernel: one stable
    ``torch.argsort`` of the key tuples packed into an int64, rows taken
    newest run first, then the scatter that inverts it, gives the merge
    ranks; lanes too wide to pack give no library call."""
    from repro_torch.bench.write_kernels import packed_newest_first

    rng = np.random.default_rng(seed)
    lens = [2000] + [int(rng.integers(1, 150)) for _ in range(n_runs - 1)]
    keys, starts, n = _stack([_sorted_run(rng, m, (5, 3000, 40)) for m in lens])
    t = torch.from_numpy(keys)
    packed, rows = packed_newest_first(t, starts, n, 3)
    pos = torch.empty(n, dtype=torch.int64)
    pos[rows[torch.argsort(packed, stable=True)]] = torch.arange(n)
    np.testing.assert_array_equal(pos.numpy(), rref.merge_run_positions_ref(keys, starts, n, n_lanes=3))
    wide = t.clone()
    wide[:3, :n] = (1 << 30) - 1
    assert packed_newest_first(wide, starts, n, 3)[0] is None


def test_pairwise_ranks_when_every_key_is_equal():
    """Every row of every run holds the same key tuple: the order is run
    descending, then position, and every insertion point is a run's
    start (later searcher, earlier run) or end (earlier searcher)."""
    lens = [700, 60, 60, 5, 90]
    runs = [np.full((3, m), 7, np.int64) for m in lens]
    _all_agree(*_stack(runs), n_lanes=3)


def test_pairwise_ranks_on_60_bit_lane_pairs():
    """A 60-bit column as its (v >> 30, v & (2^30 - 1)) lane pair, whose
    lexicographic order is the numeric one, beside a narrow column; the
    low lanes repeat high values with different low bits."""
    rng = np.random.default_rng(7)
    runs = []
    for m in (1200, 80, 33, 150):
        wide = rng.integers(0, 1 << 60, m, dtype=np.int64)
        wide[: m // 3] = (wide[: m // 3] >> 30 << 30) | rng.integers(0, 4, m // 3)
        wide[m // 3 : m // 2] = wide[: m // 2 - m // 3]  # duplicates
        lanes = np.stack([wide >> 30, wide & ((1 << 30) - 1), rng.integers(0, 3, m)])
        runs.append(lanes[:, np.lexsort(lanes[::-1])])
    _all_agree(*_stack(runs), n_lanes=3)


def test_pairwise_ranks_with_insertion_points_at_a_runs_end():
    """Appended keys above every base key fall at the base's end (a drop
    that counts for no row); an earlier run's keys above every later key
    fall at the later run's end."""
    rng = np.random.default_rng(8)
    base = _sorted_run(rng, 600, (10, 10))
    high = _sorted_run(rng, 70, (10, 10)) + np.array([[20], [0]])
    low = _sorted_run(rng, 50, (10, 10))
    _all_agree(*_stack([base, high, low, high[:, :20]]), n_lanes=2)


@settings(derandomize=True, database=None, max_examples=40, deadline=None)
@given(
    lens=st.lists(st.integers(0, 60), min_size=1, max_size=10),
    domains=st.lists(st.integers(1, 6), min_size=1, max_size=3),
    seed=st.integers(0, 2**16),
)
def test_property_pairwise_ranks_equal_the_lexsort_oracle(lens, domains, seed):
    rng = np.random.default_rng(seed)
    runs = [_sorted_run(rng, m, domains) for m in lens]
    keys, starts, n = _stack(runs)
    if n == 0:
        return
    _all_agree(keys, starts, n, n_lanes=len(domains))


# -- the batched histogram -------------------------------------------------------------


def _hist_cols(n, specs, seed):
    """int32[C, n]: per (n_bins, bin_width) a column over bins and past
    the last one, with negative rows (the reference's -1 padding and
    other negatives)."""
    rng = np.random.default_rng(seed)
    cols = np.stack([rng.integers(-5, nb * bw + 3 * bw, n) for nb, bw in specs]).astype(np.int32)
    if n:
        cols[:, ::13] = -1
    return cols


def _bincount(col, nb, bw):
    valid = col[col >= 0] // bw
    return np.bincount(valid[valid < nb], minlength=nb).astype(np.float32)


@pytest.mark.parametrize(
    "n,specs",
    [
        (5000, [(4096, 3), (16, 1), (100, 7)]),
        (20000, [(4096, 256), (2406, 1), (4096, 2)]),
        (0, [(8, 2), (4096, 1)]),
        (1, [(1, 1)]),
        (777, [(3, 5)] * 5),
    ],
)
def test_ecdf_hist_many_equals_per_column_and_bincount(n, specs):
    cols = _hist_cols(n, specs, n + len(specs))
    n_bins, widths = [s[0] for s in specs], [s[1] for s in specs]
    got = ecdf_hist_many(torch.from_numpy(cols), n_bins=n_bins, bin_widths=widths)
    assert got.dtype == torch.float32 and got.shape == (sum(n_bins),)
    parts = np.split(got.numpy(), np.cumsum(n_bins)[:-1])
    for i, (nb, bw) in enumerate(specs):
        want = _bincount(cols[i], nb, bw)
        np.testing.assert_array_equal(parts[i], want)
        col = torch.from_numpy(np.ascontiguousarray(cols[i]))
        np.testing.assert_array_equal(ecdf_hist(col, n_bins=nb, bin_width=bw).numpy(), want)
    np.testing.assert_array_equal(
        ecdf_hist_many_plain(torch.from_numpy(cols), n_bins=n_bins, bin_widths=widths).numpy(), got.numpy()
    )


def test_ecdf_hist_many_matches_the_reference_kernel():
    """Two columns with their own bins, through the reference's Pallas
    kernel (interpret mode) one column at a time."""
    specs = [(64, 3), (200, 1)]
    cols = _hist_cols(3000, specs, 11)
    got = ecdf_hist_many(torch.from_numpy(cols), n_bins=[64, 200], bin_widths=[3, 1]).numpy()
    want = np.concatenate([np.asarray(RK.ecdf_hist(cols[i], n_bins=nb, bin_width=bw)) for i, (nb, bw) in enumerate(specs)])
    np.testing.assert_array_equal(got, want)


def test_ecdf_hist_many_checks_its_operands():
    cols = torch.zeros((2, 10), dtype=torch.int32)
    with pytest.raises(ValueError):
        ecdf_hist_many(cols.long(), n_bins=[4, 4], bin_widths=[1, 1])
    with pytest.raises(ValueError):
        ecdf_hist_many(cols[0], n_bins=[4], bin_widths=[1])
    with pytest.raises(ValueError):
        ecdf_hist_many(cols, n_bins=[4], bin_widths=[1, 1])
    with pytest.raises(ValueError):
        ecdf_hist_many(cols, n_bins=[4, 0], bin_widths=[1, 1])
    with pytest.raises(ValueError):
        ecdf_hist_many(cols.t(), n_bins=[4] * 10, bin_widths=[1] * 10)


# -- the statistics refresh --------------------------------------------------------------


# an exact 5-bit column, a 13-bit one in 4096 bins of 2, a 20-bit one in
# bins of 256, and a 40-bit one past the kernel's int32 lanes (numpy path)
STATS_BITS = {"e": 5, "c": 13, "k": 20, "w": 40}


def _drip(seed, n_writes=4, rows=700):
    rng = np.random.default_rng(seed)
    return [
        {c: rng.integers(0, 1 << b, rows, dtype=np.int64) for c, b in STATS_BITS.items()}
        for _ in range(n_writes)
    ]


def test_merge_rows_on_a_cpu_device_equals_the_reference(monkeypatch):
    """The same CREATE columns and write drip through the reference's
    ``TableStats`` (numpy, and its device path) and the port's with a CPU
    device: equal counts, totals and row counts; the port sends the three
    columns the kernel takes through one ``ecdf_hist_many`` call a write."""
    rng = np.random.default_rng(20)
    base = {c: rng.integers(0, 1 << b, 3000, dtype=np.int64) for c, b in STATS_BITS.items()}
    ref = R.TableStats.from_columns(base, R.KeySchema(dict(STATS_BITS)))
    ref_dev = R.TableStats.from_columns(base, R.KeySchema(dict(STATS_BITS)))
    port = T.TableStats.from_columns(base, T.KeySchema(dict(STATS_BITS)))
    calls = []
    real = hist_mod.ecdf_hist_many

    def spy(cols, **kw):
        calls.append(tuple(cols.shape))
        return real(cols, **kw)

    monkeypatch.setattr(hist_mod, "ecdf_hist_many", spy)
    for w in _drip(21):
        ref.merge_rows(w)
        ref_dev.merge_rows(w, device=True)
        port.merge_rows(w, device=CPU)
    assert calls == [(3, 700)] * 4
    assert port.n_rows == ref.n_rows == ref_dev.n_rows == 3000 + 4 * 700
    for c in STATS_BITS:
        np.testing.assert_array_equal(port.columns[c].counts, ref.columns[c].counts)
        np.testing.assert_array_equal(port.columns[c].counts, ref_dev.columns[c].counts)
        assert port.columns[c].total == ref.columns[c].total
        assert port.columns[c].cdf(17.5) == ref.columns[c].cdf(17.5)


def test_merge_rows_without_a_device_takes_numpy(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("no device was given")

    monkeypatch.setattr(hist_mod, "ecdf_hist_many", refuse)
    stats = T.TableStats.from_columns(_drip(22, 1)[0], T.KeySchema(dict(STATS_BITS)))
    want = {c: cs.counts.copy() for c, cs in stats.columns.items()}
    w = _drip(23, 1)[0]
    stats.merge_rows(w)
    for c, b in STATS_BITS.items():
        cs = stats.columns[c]
        np.testing.assert_array_equal(cs.counts - want[c], np.bincount(w[c] // cs.bin_width, minlength=cs.n_bins))


def test_merge_values_on_a_cpu_device_equals_numpy():
    schema = T.KeySchema(dict(STATS_BITS))
    w = _drip(24, 1)[0]
    for c in ("e", "c", "k"):
        a = T.TableStats.from_columns({c: w[c]}, schema).columns[c]
        b = T.TableStats.from_columns({c: w[c]}, schema).columns[c]
        a.merge_values(w[c][::-1], device=CPU)
        b.merge_values(w[c][::-1])
        np.testing.assert_array_equal(a.counts, b.counts)
        assert a.total == b.total


def test_merge_bound_counts_the_functions_bytes_not_the_designs():
    """The merge's bound counts what the function needs: every row's int64
    position written and the searching rows' key lanes read (the largest
    run's keys only through the probes, counted as operations); the
    kernel's own traffic (difference array, partial positions) is a
    separate figure, never below the bound's bytes."""
    from repro_torch.bench import write_kernels as W

    lens = [7_500_000] + [20_000] * 8
    n, n_search = sum(lens), 160_000
    got_bytes, ops = W.merge_work(lens, 3)
    assert got_bytes == 8 * n + 4 * 3 * n_search
    # each appended run searches the base (24 steps) and the runs of higher
    # index among the seven other 20,000-row runs (16 steps each)
    assert ops == 20_000 * sum(24 + 16 * (7 - i) for i in range(8)) * 5
    assert W.merge_design_bytes(lens, 3) == 16 * n + (4 * 3 + 16) * n_search
    # ties in size: the higher index is the larger, so run 3 searches nothing
    assert W._searches([5, 5, 0, 9]) == (10, 5 * 4 + 5 * 5 + 5 * 5)
    assert W._searches([4, 4]) == (4, 4 * 3)


def test_write_kernels_bench_needs_a_card(monkeypatch):
    """The write kernels' benchmark measures device time only: without a
    CUDA device it raises instead of timing the plain versions."""
    from repro_torch.bench import write_kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        write_kernels.run(n_rows=10_000)
