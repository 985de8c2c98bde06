"""Merge ranks: the k-way merge permutation of a resident run stack.

After memtable flushes a device-resident replica holds a stack of sorted
runs (base + appended) in its resident arrays; compaction collapses them
into one sorted run on the device. :func:`merge_run_positions` gives every
device row its merged position: ascending by key tuple, a later run's row
before equal rows of earlier runs, arrival order within a run — the host
``SortedTable.merge_run`` order, so the compacted device order equals the
host row order. CUDA tensors run ``csrc/merge_rank.cu`` (one binary
search per row and other run); CPU tensors run
:func:`merge_run_positions_plain` (stable sorts, the reference oracle's
lexsort).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["merge_run_positions", "merge_run_positions_plain"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIG = {"merge_rank_launch": [_P, _I64, _I, _P, _I, _I64, _P, _P]}
_MAX_LANES = 16
_MAX_RUNS = 64


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
    starts_t = torch.tensor(starts + (n_rows,), dtype=torch.int64, device=device)
    out = torch.empty(n_rows, dtype=torch.int64, device=device)
    lib = _build.load("merge_rank", _SIG)
    code = lib.merge_rank_launch(
        keys.data_ptr(), keys.shape[1], n_lanes, starts_t.data_ptr(),
        len(starts), n_rows, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(code, "merge_rank_launch")
    merge_run_positions.launches += 1
    return out


merge_run_positions.launches = 0
