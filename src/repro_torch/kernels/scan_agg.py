"""Scans over located row slabs: the row-slab read path's kernels.

Per query, over the rows ``[slab_lo, slab_hi)`` of its slab: the float32
sum of the selected value row over the rows that pass the residual
predicate (per logical column, value in ``[lo, hi)``; wide columns as
lexicographic lane pairs), and the count of those rows. Output float32
``[Q, 2]`` = (sum, count), as the reference's
(``repro/kernels/scan_agg.py``); counts are exact to 2**24, the
reference's own float32 cap, which ``ops.table_scan_device_many`` guards.

``scan_agg_rowstream`` — rows outer: one CTA per 2048-row tile holds its
rows' key lanes in registers and serves the queries whose slab meets the
tile. Mixed value rows through a per-query selector, wide columns. CUDA
tensors run ``csrc/scan_agg.cu`` (``rowstream_launch``); CPU tensors run
:func:`scan_agg_rowstream_plain`.

``scan_agg_qgrid`` — queries outer: every query reads its own slab's rows,
2048-row block by block, so key traffic grows with the queries. One value
row and narrow columns only; kept as the benchmark baseline. CUDA tensors
run ``csrc/scan_agg.cu`` (``qgrid_launch``); CPU tensors run
:func:`scan_agg_qgrid_plain`.

Both kernels write one partial per (query, unit) pair their slab meets,
query-major ``[Q, n_units]``, and fold each query's partials in ascending
unit order in a second launch: deterministic, no float atomics. The
functions below the wrappers write the kernels' work decomposition out in
PyTorch, in the card's float order: which (tile, query) pairs rowstream
visits (:func:`rowstream_live_list`), the qgrid pairs and how a pair finds
its query (:func:`qgrid_block_offsets`, :func:`qgrid_pair_units`), the
partials of a pair (:func:`unit_partials_emulated`) and the fold
(:func:`slab_fold_emulated`). They agree with the plain versions within
float32 tolerance (the reduction orders differ), and with the kernels on
the card bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .slab_locate import _PLAIN_Q_CHUNK, _check, _col_parts, _residual_mask, _wide_mask

__all__ = [
    "UNIT_ROWS",
    "qgrid_block_offsets",
    "qgrid_pair_units",
    "scan_agg_qgrid",
    "scan_agg_qgrid_emulated",
    "scan_agg_qgrid_plain",
    "scan_agg_rowstream",
    "scan_agg_rowstream_emulated",
    "scan_agg_rowstream_plain",
    "rowstream_live_list",
    "slab_fold_emulated",
    "slab_units",
    "unit_partials_emulated",
]

#: Rows of one rowstream tile and one qgrid block (``csrc/scan_agg.cu``
#: ``kUnitRows``, which checks the partials' ``[Q, ceil(n / UNIT_ROWS)]``).
UNIT_ROWS = 2048
_THREADS = 256

_P, _I, _I64, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
_SIG = {
    "rowstream_launch": [
        _P, _I64, _I64, _I, _I, _U32, _P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
    ],
    "qgrid_launch": [_P, _I64, _I64, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P],
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
    ones_row: int | None = None,
) -> torch.Tensor:
    """float32 ``[Q, 2]``: per query, (masked sum of its value row, count)
    over its slab. ``n_vals`` limits the value rows a selector may take
    (the resident tile's live rows; default all); a selector outside
    ``[0, n_vals)`` sums nothing but still counts. ``ones_row`` names a
    value row that holds 1.0 at every row the slabs cover (the resident
    tile's count row), if any: the kernel reads no value for a query that
    selects it, since its sum is its count."""
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
    n_units = -(-n // UNIT_ROWS)
    part_s = torch.empty((q, n_units), dtype=torch.float32, device=device)
    part_c = torch.empty((q, n_units), dtype=torch.int32, device=device)
    code = lib.rowstream_launch(
        keys.data_ptr(), n, n, k_ex, len(col_parts), _wide_mask(col_parts),
        values.data_ptr(), n_vals, -1 if ones_row is None else int(ones_row), col_lo.data_ptr(),
        col_hi.data_ptr(), slabs.data_ptr(),
        value_sel.data_ptr(), q, n_units, part_s.data_ptr(), part_c.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(code, "rowstream_launch")
    _build.count_launch(scan_agg_rowstream)
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
    n_units = -(-n // UNIT_ROWS)
    offs = torch.empty(q + 1, dtype=torch.int32, device=device)
    part_s = torch.empty((q, n_units), dtype=torch.float32, device=device)
    part_c = torch.empty((q, n_units), dtype=torch.int32, device=device)
    code = lib.qgrid_launch(
        keys.data_ptr(), n, n, k, values.data_ptr(), col_lo.data_ptr(), col_hi.data_ptr(),
        slabs.data_ptr(), q, n_units, offs.data_ptr(), part_s.data_ptr(), part_c.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(code, "qgrid_launch")
    _build.count_launch(scan_agg_qgrid)
    return out


scan_agg_qgrid.launches = 0


# -- the kernels' work decomposition, written out ---------------------------------------


def slab_units(slabs, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 ``[Q]`` each: the first unit and one past the last unit that
    each query's slab meets, after clipping it to ``[0, n)``; ``(0, 0)``
    for an empty slab. Partials exist for these units only, and the fold
    reads them in this range, ascending."""
    s = slabs.long()
    s0, s1 = s[:, 0].clamp(min=0), s[:, 1].clamp(max=n)
    live = s0 < s1
    zero = torch.zeros_like(s0)
    return torch.where(live, s0 // UNIT_ROWS, zero), torch.where(live, (s1 - 1) // UNIT_ROWS + 1, zero)


def rowstream_live_list(slabs, n: int) -> torch.Tensor:
    """int64 ``[P, 2]``: the (tile, query) pairs rowstream evaluates, in
    the order it visits them: tile by tile, each tile's queries ascending
    (the CTA tests a chunk of queries a thread each and lists the live ones
    by ballot and prefix count). A query is live on a tile if its slab,
    clipped to ``[0, n)``, meets it; a tile with none exits unread."""
    b0, b1 = slab_units(slabs, n)
    tiles = torch.arange(-(-n // UNIT_ROWS), device=slabs.device)[:, None]
    return torch.nonzero((tiles >= b0[None, :]) & (tiles < b1[None, :]))


def qgrid_block_offsets(slabs, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The device pass before qgrid's partials: per query the number of
    blocks its slab meets (int32 ``[Q]``), and their exclusive scan
    (int32 ``[Q + 1]``: query q's first pair, then the total)."""
    b0, b1 = slab_units(slabs, n)
    counts = (b1 - b0).to(torch.int32)
    offs = torch.zeros(counts.numel() + 1, dtype=torch.int64, device=slabs.device)
    offs[1:] = torch.cumsum(counts.long(), 0)
    return counts, offs.to(torch.int32)


def qgrid_pair_units(offs, slabs, n: int) -> torch.Tensor:
    """int64 ``[P, 2]``: (query, block) of each pair index ``0 .. offs[-1]
    - 1``, as a persistent CTA maps it: the query is the last whose first
    pair is at or below the index (the CTA probes the scan 32 entries a
    step, from the query of its previous pair), the block is the query's
    first block plus the index's distance from its first pair."""
    offs = offs.long()
    pairs = torch.arange(int(offs[-1]), device=offs.device)
    q = torch.searchsorted(offs[1:], pairs, right=True)
    b0, _ = slab_units(slabs, n)
    return torch.stack([q, b0[q] + pairs - offs[q]], dim=1)


def _row_offsets(device) -> torch.Tensor:
    """int64 ``[256, 8]``: the unit rows thread t owns, its k-th (ascending)
    at ``[t, k]``: 4t .. 4t + 3, then 1024 + 4t .. 1024 + 4t + 3."""
    t = torch.arange(_THREADS, device=device)[:, None]
    k = torch.arange(UNIT_ROWS // _THREADS, device=device)[None, :]
    return (k >> 2) * (UNIT_ROWS // 2) + 4 * t + (k & 3)


def unit_partials_emulated(keys, values, col_lo, col_hi, slabs, sel, pairs, *, col_parts, n: int):
    """float32 and int32 ``[P]``: the partial sum and count of each
    (query, unit) pair (``pairs`` int64 ``[P, 2]``) in the card's order.
    Thread t sums the values of its taken rows (:func:`_row_offsets`)
    ascending from +0.0, a butterfly (``x + shfl_xor(x, o)``, o = 16, 8,
    4, 2, 1) reduces each warp, and the eight warp slots add in warp
    order from +0.0. ``values`` holds the value rows; a selector outside
    them sums nothing. Rows at or past ``n`` and outside the query's slab
    are not taken."""
    q, u = pairs[:, 0], pairs[:, 1]
    rows = u[:, None, None] * UNIT_ROWS + _row_offsets(keys.device)[None]  # [P, 256, 8]
    s = slabs.long()[q]
    taken = (rows >= s[:, 0, None, None]) & (rows < s[:, 1, None, None]) & (rows < n)
    flat = rows.reshape(len(q), UNIT_ROWS).clamp(max=max(n - 1, 0))
    kp = keys[: col_lo.shape[1]][:, flat]  # [K, P, 2048]
    # each pair's bounds [P, 1] broadcast against its own rows [1, P, 2048]
    taken = _residual_mask(kp, col_lo[q], col_hi[q], col_parts, taken.view(len(q), UNIT_ROWS))[0].view_as(rows)
    sv = sel.long()[q]
    has_v = (sv >= 0) & (sv < values.shape[0])
    v = values[sv.clamp(0, values.shape[0] - 1)[:, None], flat].view_as(rows)
    zero = torch.zeros((), dtype=torch.float32, device=keys.device)
    v = torch.where(taken & has_v[:, None, None], v, zero)
    t_sum = torch.zeros(rows.shape[:2], dtype=torch.float32, device=keys.device)
    for k in range(rows.shape[2]):
        t_sum = t_sum + v[:, :, k]
    w = t_sum.view(len(q), _THREADS // 32, 32)
    lane = torch.arange(32, device=keys.device)
    for o in (16, 8, 4, 2, 1):
        w = w + w[:, :, lane ^ o]
    part = torch.zeros(len(q), dtype=torch.float32, device=keys.device)
    for warp in range(w.shape[1]):
        part = part + w[:, warp, 0]
    return part, taken.sum(dim=(1, 2), dtype=torch.int32)


def slab_fold_emulated(part_s, part_c, slabs, n: int) -> torch.Tensor:
    """float32 ``[Q, 2]``: each query's partials (``[Q, n_units]``) of the
    units its slab meets, folded as ``slab_fold`` does: lane j of a warp
    adds the range's partials j, j + 32, ... in ascending order from +0.0,
    then the butterfly adds the 32 lanes. The count lane is the int32
    count as float32."""
    b0, b1 = slab_units(slabs, n)
    q = part_s.shape[0]
    width = int((b1 - b0).max()) if q else 0
    rounds = -(-width // 32)
    idx = b0[:, None] + torch.arange(32 * rounds, device=part_s.device)[None, :]  # [Q, 32 * rounds]
    inside = idx < b1[:, None]
    safe = idx.clamp(max=max(part_s.shape[1] - 1, 0))
    zero = torch.zeros((), dtype=torch.float32, device=part_s.device)
    p = torch.where(inside, part_s.gather(1, safe) if rounds else safe.float(), zero).view(q, rounds, 32)
    lanes = torch.zeros((q, 32), dtype=torch.float32, device=part_s.device)
    for r in range(rounds):
        lanes = lanes + p[:, r]
    lane = torch.arange(32, device=part_s.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, lane ^ o]
    counts = torch.where(inside, part_c.gather(1, safe) if rounds else safe.int(), 0).sum(dim=1, dtype=torch.int32)
    return torch.stack([lanes[:, 0], counts.float()], dim=1)


def _fold_pairs(parts, pairs, q: int, n_units: int, slabs, n: int) -> torch.Tensor:
    s, c = parts
    part_s = torch.full((q, n_units), float("nan"), dtype=torch.float32, device=s.device)
    part_c = torch.full((q, n_units), -1, dtype=torch.int32, device=s.device)
    part_s[pairs[:, 0], pairs[:, 1]] = s
    part_c[pairs[:, 0], pairs[:, 1]] = c
    return slab_fold_emulated(part_s, part_c, slabs, n)


def scan_agg_rowstream_emulated(keys, values, col_lo, col_hi, slabs, value_sel, *, col_parts, n_vals=None):
    """:func:`scan_agg_rowstream` as the kernel computes it: the partials
    of the pairs :func:`rowstream_live_list` gives, written query-major
    (a unit no pair wrote is NaN, so a fold that read one would show it),
    then folded. Equal to the kernel on the card bit for bit."""
    col_parts = _col_parts(col_parts, col_lo.shape[1])
    n = keys.shape[1]
    values = values[: values.shape[0] if n_vals is None else int(n_vals)]
    pairs = rowstream_live_list(slabs, n)[:, [1, 0]]  # (query, tile)
    parts = unit_partials_emulated(
        keys, values, col_lo, col_hi, slabs, value_sel, pairs, col_parts=col_parts, n=n
    )
    return _fold_pairs(parts, pairs, col_lo.shape[0], -(-n // UNIT_ROWS), slabs, n)


def scan_agg_qgrid_emulated(keys, values, col_lo, col_hi, slabs):
    """:func:`scan_agg_qgrid` as the kernel computes it: the block counts
    and their scan, every pair index mapped to its (query, block), the
    pairs' partials, then the fold. Equal to the kernel on the card bit
    for bit."""
    n = keys.shape[1]
    q, k = col_lo.shape
    _, offs = qgrid_block_offsets(slabs, n)
    pairs = qgrid_pair_units(offs, slabs, n)
    sel = torch.zeros(q, dtype=torch.int32, device=keys.device)
    parts = unit_partials_emulated(
        keys, values[None, :], col_lo, col_hi, slabs, sel, pairs, col_parts=(1,) * k, n=n
    )
    return _fold_pairs(parts, pairs, q, -(-n // UNIT_ROWS), slabs, n)
