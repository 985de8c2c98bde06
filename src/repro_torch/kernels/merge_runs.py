"""Merge ranks: the k-way merge permutation of a resident run stack.

After memtable flushes a device-resident replica holds a stack of sorted
runs (base + appended) in its resident arrays; compaction collapses them
into one sorted run on the device. :func:`merge_run_positions` gives every
device row its merged position: ascending by key tuple, a later run's row
before equal rows of earlier runs, arrival order within a run — the host
``SortedTable.merge_run`` order, so the compacted device order equals the
host row order. CUDA tensors run ``csrc/merge_rank.cu``: only the smaller
run of each pair of runs searches the larger, each search adds to its own
row's position and drops a +1 into a difference array over the searched
run, and one scan of that array gives every row the rest. CPU tensors run
:func:`merge_run_positions_plain` (stable sorts, the reference oracle's
lexsort). :func:`pairwise_positions_emulated` writes the kernel's scheme
out in PyTorch for the tests.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["merge_run_positions", "merge_run_positions_plain", "pairwise_positions_emulated"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIG = {
    "merge_rank_launch": [_P, _I64, _I, ctypes.POINTER(ctypes.c_int64), _I, _I64, _P, _I64, _P, _P]
}
_MAX_LANES = 16
_MAX_RUNS = 64
_TILE_ROWS = 4096  # rows one CTA of the scan takes (csrc/merge_rank.cu kTileRows)


def _scratch_words(n_rows: int) -> int:
    """int32 words of the kernel's scratch (csrc/merge_rank.cu
    scratch_words): the difference array in whole scan tiles, the per-run
    totals, the tile ticket and a pad word, a 64-bit status word a tile."""
    tiles = -(-n_rows // _TILE_ROWS)
    return tiles * (_TILE_ROWS + 2) + _MAX_RUNS + 2


def merge_run_positions_plain(keys, run_starts, n_rows: int, *, n_lanes: int):
    """Plain PyTorch version: sort the rows by (lane 0, …, lane n−1, run
    index descending, position) with chained stable sorts and invert the
    order. Returns int64[n_rows] on the keys' device."""
    device = keys.device
    starts = torch.tensor(tuple(run_starts) + (n_rows,), dtype=torch.int64, device=device)
    rows = torch.arange(n_rows, dtype=torch.int64, device=device)
    run_id = torch.searchsorted(starts, rows, right=True) - 1
    # device order is (run ascending, position ascending): one stable sort
    # by descending run gives (run descending, position), then lanes from
    # the least significant to the most
    order = torch.sort(-run_id, stable=True).indices
    for lane in reversed(range(n_lanes)):
        k = keys[lane, :n_rows][order]
        order = order[torch.sort(k, stable=True).indices]
    pos = torch.empty(n_rows, dtype=torch.int64, device=device)
    pos[order] = rows
    return pos


def _below(keys, rows, probes, n_lanes: int, at_or_below: bool):
    """Per probe, whether key(rows[i]) < probes[:, i] lexicographically
    (``<=`` with ``at_or_below``): the kernel's compare, from the last lane
    up."""
    lt = torch.full(rows.shape, at_or_below, dtype=torch.bool, device=keys.device)
    for lane in reversed(range(n_lanes)):
        x = keys[lane, rows]
        lt = (x < probes[lane]) | ((x == probes[lane]) & lt)
    return lt


def pairwise_positions_emulated(keys, run_starts, n_rows: int, *, n_lanes: int):
    """The kernel's scheme written out in PyTorch, for the tests: for each
    pair of runs the smaller (ties to the lower index) binary-searches the
    larger in the kernel's branch-free steps — the lower bound of a row of
    a later run in an earlier run, the upper bound of a row of an earlier
    run in a later one — adds the count to its own rows' positions and drops
    a +1 at each insertion point inside the searched run (one at the run's
    end counts for no row); a cumulative sum of those drops, less the drops
    into earlier runs, gives every row the rest. Returns int64[n_rows]."""
    device = keys.device
    starts = tuple(int(s) for s in run_starts) + (n_rows,)
    n_runs = len(starts) - 1
    lens = [starts[t + 1] - starts[t] for t in range(n_runs)]
    rows = torch.arange(n_rows, dtype=torch.int64, device=device)
    run_id = torch.searchsorted(torch.tensor(starts, device=device), rows, right=True) - 1
    pos = rows - torch.tensor(starts, device=device)[run_id]  # local position
    diff = torch.zeros(n_rows + 1, dtype=torch.int64, device=device)
    for s in range(n_runs):
        f = torch.arange(starts[s], starts[s + 1], dtype=torch.int64, device=device)
        probes = keys[:n_lanes, f]
        for t in range(n_runs):
            if t == s or not (lens[t], t) > (lens[s], s) or lens[t] == 0:
                continue
            b = torch.full_like(f, starts[t])
            n = lens[t]
            while n > 1:
                half = n >> 1
                b = torch.where(_below(keys, b + half, probes, n_lanes, t > s), b + half, b)
                n -= half
            idx = b + _below(keys, b, probes, n_lanes, t > s).long()
            pos[f] += idx - starts[t]
            inside = idx < starts[t + 1]
            diff.index_add_(0, idx[inside], torch.ones_like(idx[inside]))
    received = torch.cumsum(diff[:n_rows], 0)
    before = torch.cat([torch.zeros(1, dtype=torch.int64, device=device), received])
    return pos + received - before[torch.tensor(starts[:-1], device=device)][run_id]


def merge_run_positions(
    keys: torch.Tensor,  # int32[K_pad, N_pad] resident key lanes, device order
    run_starts,  # run start offsets (run 0 = base at 0), host ints
    n_rows: int,
    *,
    n_lanes: int,
) -> torch.Tensor:
    """int64[n_rows] merged position of every device row (each run must be
    sorted by its key tuple, as flushed runs and the base are)."""
    device = keys.device
    if keys.dtype != torch.int32 or keys.dim() != 2 or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous 2-D int32 tensor")
    if not 0 < n_lanes <= keys.shape[0]:
        raise ValueError(f"n_lanes {n_lanes} out of range for {keys.shape[0]} key lanes")
    starts = tuple(int(s) for s in run_starts)
    if not starts or starts[0] != 0 or n_rows > keys.shape[1]:
        raise ValueError(f"bad run stack {starts} for {n_rows} rows")
    if any(b < a for a, b in zip(starts, starts[1:] + (n_rows,))):
        raise ValueError(f"run starts {starts} must ascend to {n_rows}")
    if len(starts) <= 1:
        return torch.arange(n_rows, dtype=torch.int64, device=device)
    if device.type == "cpu":
        return merge_run_positions_plain(keys, starts, n_rows, n_lanes=n_lanes)
    if device.type != "cuda":
        raise ValueError(f"merge_run_positions runs on cuda or cpu tensors, got {device}")
    if n_lanes > _MAX_LANES or len(starts) > _MAX_RUNS:
        raise ValueError(
            f"kernel supports <= {_MAX_LANES} lanes and <= {_MAX_RUNS} runs, "
            f"got {n_lanes} and {len(starts)}"
        )
    if n_rows >= 1 << 31:
        raise ValueError(f"the kernel ranks fewer than 2**31 rows, got {n_rows}")
    words = _scratch_words(n_rows)
    scratch = torch.empty(words, dtype=torch.int32, device=device)
    out = torch.empty(n_rows, dtype=torch.int64, device=device)
    lib = _build.load("merge_rank", _SIG)
    code = lib.merge_rank_launch(
        keys.data_ptr(), keys.shape[1], n_lanes, (ctypes.c_int64 * len(starts))(*starts),
        len(starts), n_rows, scratch.data_ptr(), words, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(code, "merge_rank_launch")
    _build.count_launch(merge_run_positions)
    return out


merge_run_positions.launches = 0
