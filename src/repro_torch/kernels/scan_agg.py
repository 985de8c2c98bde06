"""Scans over host-located row slabs: the row-slab read path's kernels.

Per query, over the rows ``[slab_lo, slab_hi)`` of its slab: the float32
sum of the selected value row over the rows that pass the residual
predicate (per logical column, value in ``[lo, hi)``; wide columns as
lexicographic lane pairs), and the count of those rows. Output float32
``[Q, 2]`` = (sum, count), as the reference's
(``repro/kernels/scan_agg.py``); counts are exact to 2**24, the
reference's own float32 cap, which ``ops.table_scan_device_many`` guards.

``scan_agg_rowstream`` — rows outer: the columns stream once per batch,
every query is served from each staged tile. Mixed value rows through a
per-query selector, wide columns. CUDA tensors run ``csrc/scan_agg.cu``
(``rowstream_launch``); CPU tensors run :func:`scan_agg_rowstream_plain`.

``scan_agg_qgrid`` — queries outer: one pass over every row per query, so
key traffic scales with Q. One value row and narrow columns only; kept as
the benchmark baseline. CUDA tensors run ``csrc/scan_agg.cu``
(``qgrid_launch``); CPU tensors run :func:`scan_agg_qgrid_plain`.

Both kernels fold per-(query, tile) partials in ascending row order in a
second launch: deterministic, no float atomics. They agree with the plain
versions within float32 tolerance (the reduction orders differ).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .slab_locate import _PLAIN_Q_CHUNK, _check, _col_parts, _residual_mask, _wide_mask

__all__ = [
    "scan_agg_qgrid",
    "scan_agg_qgrid_plain",
    "scan_agg_rowstream",
    "scan_agg_rowstream_plain",
]

_P, _I, _I64, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
_SIG = {
    "rowstream_tile_rows": [_I, _I],
    "rowstream_launch": [
        _P, _I64, _I64, _I, _I, _U32, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P,
    ],
    "qgrid_block_rows": [],
    "qgrid_launch": [_P, _I64, _I64, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
}


def _slab_mask(slabs, n):
    ridx = torch.arange(n, dtype=torch.int32, device=slabs.device)[None, :]
    return (ridx >= slabs[:, 0:1]) & (ridx < slabs[:, 1:2])


def scan_agg_rowstream_plain(keys, values, col_lo, col_hi, slabs, value_sel, *, col_parts):
    """Plain PyTorch version of :func:`scan_agg_rowstream` (the
    reference's ``scan_agg_batched_ref``): whole-array masks per chunk of
    queries. ``values`` holds the live value rows only."""
    col_parts = _col_parts(col_parts, col_lo.shape[1])
    n = keys.shape[1]
    q = col_lo.shape[0]
    n_vals = values.shape[0]
    out = torch.zeros((q, 2), dtype=torch.float32, device=keys.device)
    zero = torch.zeros((), dtype=torch.float32, device=keys.device)
    for s in range(0, q, _PLAIN_Q_CHUNK):
        e = min(q, s + _PLAIN_Q_CHUNK)
        match = _residual_mask(keys, col_lo[s:e], col_hi[s:e], col_parts, _slab_mask(slabs[s:e], n))
        sel = value_sel[s:e].long()
        in_range = (sel >= 0) & (sel < n_vals)
        vq = values[sel.clamp(0, n_vals - 1)]
        out[s:e, 0] = torch.where(match & in_range[:, None], vq, zero).sum(dim=1)
        out[s:e, 1] = match.sum(dim=1, dtype=torch.int32).float()
    return out


def scan_agg_rowstream(
    keys: torch.Tensor,  # int32[K_pad, N] key lanes
    values: torch.Tensor,  # float32[V_pad, N] value tile
    col_lo: torch.Tensor,  # int32[Q, K_ex] residual bounds, inclusive
    col_hi: torch.Tensor,  # int32[Q, K_ex] residual bounds, EXCLUSIVE
    slabs: torch.Tensor,  # int32[Q, 2] row slabs [lo, hi)
    value_sel: torch.Tensor,  # int32[Q] value-row selector
    *,
    col_parts,
    n_vals: int | None = None,
) -> torch.Tensor:
    """float32 ``[Q, 2]``: per query, (masked sum of its value row, count)
    over its slab. ``n_vals`` limits the value rows the kernel stages (the
    resident tile's live rows; default all); a selector outside
    ``[0, n_vals)`` sums nothing but still counts."""
    device = keys.device
    _check("keys", keys, torch.int32, 2, device)
    _check("values", values, torch.float32, 2, device)
    for name, t in (("col_lo", col_lo), ("col_hi", col_hi), ("slabs", slabs)):
        _check(name, t, torch.int32, 2, device)
    _check("value_sel", value_sel, torch.int32, 1, device)
    q, k_ex = col_lo.shape
    col_parts = _col_parts(col_parts, k_ex)
    if values.shape[1] != keys.shape[1]:
        raise ValueError(f"values carry {values.shape[1]} rows, keys {keys.shape[1]}")
    if k_ex > keys.shape[0]:
        raise ValueError(f"bounds cover {k_ex} lanes but keys carry {keys.shape[0]}")
    if col_hi.shape != (q, k_ex) or slabs.shape != (q, 2) or value_sel.shape != (q,):
        raise ValueError("col_hi must be [Q, K_ex], slabs [Q, 2] and value_sel [Q]")
    n_vals = values.shape[0] if n_vals is None else int(n_vals)
    if not 0 < n_vals <= values.shape[0]:
        raise ValueError(f"n_vals {n_vals} out of range for {values.shape[0]} rows")
    if device.type == "cpu":
        return scan_agg_rowstream_plain(
            keys, values[:n_vals], col_lo, col_hi, slabs, value_sel, col_parts=col_parts
        )
    if device.type != "cuda":
        raise ValueError(f"scan_agg_rowstream runs on cuda or cpu tensors, got {device}")
    out = torch.empty((q, 2), dtype=torch.float32, device=device)
    if q == 0:
        return out
    n = keys.shape[1]
    lib = _build.load("scan_agg", _SIG)
    tile = int(lib.rowstream_tile_rows(k_ex, n_vals))
    if tile == 0:
        raise ValueError(f"{k_ex} key lanes and {n_vals} value rows do not fit one staging tile")
    n_tiles = -(-n // tile)
    part_s = torch.empty((n_tiles, q), dtype=torch.float32, device=device)
    part_c = torch.empty((n_tiles, q), dtype=torch.int32, device=device)
    code = lib.rowstream_launch(
        keys.data_ptr(), n, n, k_ex, len(col_parts), _wide_mask(col_parts),
        values.data_ptr(), n_vals, col_lo.data_ptr(), col_hi.data_ptr(), slabs.data_ptr(),
        value_sel.data_ptr(), q, part_s.data_ptr(), part_c.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(code, "rowstream_launch")
    scan_agg_rowstream.launches += 1
    return out


scan_agg_rowstream.launches = 0


def scan_agg_qgrid_plain(keys, values, col_lo, col_hi, slabs):
    """Plain PyTorch version of :func:`scan_agg_qgrid`: whole-array masks
    per chunk of queries, one value row."""
    k = col_lo.shape[1]
    q = col_lo.shape[0]
    n = keys.shape[1]
    out = torch.zeros((q, 2), dtype=torch.float32, device=keys.device)
    zero = torch.zeros((), dtype=torch.float32, device=keys.device)
    for s in range(0, q, _PLAIN_Q_CHUNK):
        e = min(q, s + _PLAIN_Q_CHUNK)
        match = _residual_mask(keys, col_lo[s:e], col_hi[s:e], (1,) * k, _slab_mask(slabs[s:e], n))
        out[s:e, 0] = torch.where(match, values[None, :], zero).sum(dim=1)
        out[s:e, 1] = match.sum(dim=1, dtype=torch.int32).float()
    return out


def scan_agg_qgrid(
    keys: torch.Tensor,  # int32[K_pad, N] key lanes, narrow columns
    values: torch.Tensor,  # float32[N] one value row
    col_lo: torch.Tensor,  # int32[Q, K] residual bounds, inclusive
    col_hi: torch.Tensor,  # int32[Q, K] residual bounds, EXCLUSIVE
    slabs: torch.Tensor,  # int32[Q, 2] row slabs [lo, hi)
) -> torch.Tensor:
    """float32 ``[Q, 2]``: per query, (masked sum of ``values``, count)
    over its slab, with every one of the first ``K`` key lanes compared as
    its own narrow column."""
    device = keys.device
    _check("keys", keys, torch.int32, 2, device)
    _check("values", values, torch.float32, 1, device)
    for name, t in (("col_lo", col_lo), ("col_hi", col_hi), ("slabs", slabs)):
        _check(name, t, torch.int32, 2, device)
    q, k = col_lo.shape
    if values.shape[0] != keys.shape[1]:
        raise ValueError(f"values carry {values.shape[0]} rows, keys {keys.shape[1]}")
    if not 0 < k <= keys.shape[0]:
        raise ValueError(f"bounds cover {k} lanes but keys carry {keys.shape[0]}")
    if col_hi.shape != (q, k) or slabs.shape != (q, 2):
        raise ValueError("col_hi must be [Q, K] and slabs [Q, 2]")
    if device.type == "cpu":
        return scan_agg_qgrid_plain(keys, values, col_lo, col_hi, slabs)
    if device.type != "cuda":
        raise ValueError(f"scan_agg_qgrid runs on cuda or cpu tensors, got {device}")
    out = torch.empty((q, 2), dtype=torch.float32, device=device)
    if q == 0:
        return out
    n = keys.shape[1]
    lib = _build.load("scan_agg", _SIG)
    n_blocks = -(-n // int(lib.qgrid_block_rows()))
    part_s = torch.empty((q, n_blocks), dtype=torch.float32, device=device)
    part_c = torch.empty((q, n_blocks), dtype=torch.int32, device=device)
    code = lib.qgrid_launch(
        keys.data_ptr(), n, n, k, values.data_ptr(), col_lo.data_ptr(), col_hi.data_ptr(),
        slabs.data_ptr(), q, n_blocks, part_s.data_ptr(), part_c.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(code, "qgrid_launch")
    scan_agg_qgrid.launches += 1
    return out


scan_agg_qgrid.launches = 0
