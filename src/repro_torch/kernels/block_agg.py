"""Per-block partial sums: the device half of the materialized per-slab
views (``repro_torch.core.storage.views``).

``block_sums`` folds the live value rows of a resident value tile into one
float32 partial per 8192-row block, in the table's own row order.
``boundary_block_sums`` sums one value row over the rows of one block that
lie inside any of a (selector, block) pair's row windows: the rescan of a
block a view query covers only in part. CUDA tensors run
``csrc/block_sums.cu``; CPU tensors run the plain versions.

Bit-identity contract. A view-served sum is a strictly sequential float32
fold, in ascending block order, of stored partials (blocks the query
covers whole) and boundary partials; the fused scan's sum is the same fold
over its own block partials (``slab_locate.scan_agg_locate``). The two are
equal bit for bit because every block partial of one implementation is
reduced the same way:

* on the card, ``csrc/predicates.cuh`` defines the in-block order once
  (tiles of ``scan_tile(n_key_lanes, n_vals)`` rows, threads, warp
  butterfly, warp slots), and the fused scan and both view kernels call
  it; the wrappers therefore take the table's key lanes and live value
  rows, which set the tile. :func:`block_partials_card_order` writes that
  order out in PyTorch, so a test on the card can hold a kernel to it;
* on the CPU, :func:`block_partials` is the one in-block reduction of the
  plain fused scan and of both plain view versions.

Blocks a query does not touch add exactly 0.0 to the fused fold, the
float32 identity, so the view skips them. The one tolerated difference is
the sign of a zero: IEEE ``==`` treats -0.0 and +0.0 as equal.

Only rows ``< n_rows`` are folded: an older state's capacity padding may
hold rows a later append wrote in place (``ops.device_state_append``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = [
    "BLOCK_ROWS",
    "block_partials",
    "block_partials_card_order",
    "block_sums",
    "block_sums_plain",
    "boundary_block_sums",
    "boundary_block_sums_plain",
    "scan_tile",
    "scan_tile_plain",
]

#: Rows per block of the sum contract (``ops.DEVICE_BLOCK_N``).
BLOCK_ROWS = 8192

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIG = {
    "scan_tile_rows": [_I, _I],
    "block_sums_launch": [_P, _I64, _I64, _I, _I, _I, _I, _P, _P],
    "boundary_sums_launch": [_P, _I64, _I64, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P],
}


def block_partials(x: torch.Tensor) -> torch.Tensor:
    """float32 ``[R, ceil(N / 8192)]`` block partials of ``x`` ``[R, N]``:
    the plain versions' one in-block reduction. A fixed pairwise tree of
    elementwise adds (row ``i`` + row ``i + h`` for h = 4096, 2048, ..., 1)
    whose bits depend on the block's values alone, not on the shape
    around them. A ragged last block is padded with +0.0."""
    r, n = x.shape
    nb = -(-n // BLOCK_ROWS)
    if n != nb * BLOCK_ROWS:
        x = torch.nn.functional.pad(x, (0, nb * BLOCK_ROWS - n))
    x = x.reshape(r, nb, BLOCK_ROWS)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _check_tile(values: torch.Tensor, n_rows: int, block_n: int, n_vals: int, n_key_lanes: int):
    if values.dtype != torch.float32 or values.dim() != 2 or not values.is_contiguous():
        raise ValueError("values must be a contiguous 2-D float32 tensor")
    if block_n != BLOCK_ROWS:
        raise ValueError(f"block_n must be {BLOCK_ROWS} (the sum contract's block), got {block_n}")
    if not 0 < n_vals <= values.shape[0]:
        raise ValueError(f"n_vals {n_vals} out of range for {values.shape[0]} value rows")
    if not 0 <= n_rows <= values.shape[1]:
        raise ValueError(f"n_rows {n_rows} out of range for {values.shape[1]} columns")
    if n_key_lanes < 1:
        raise ValueError(f"n_key_lanes must be >= 1, got {n_key_lanes}")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"block_agg kernels run on cuda or cpu tensors, got {values.device}")


def scan_tile(n_key_lanes: int, n_vals: int) -> int:
    """Rows of the fused scan's staging tile on the card for a table of
    ``n_key_lanes`` key lanes and ``n_vals`` live value rows: the tile the
    contract's in-block order walks (``csrc/predicates.cuh``), as the
    built library computes it."""
    lib = _build.load("block_sums", _SIG)
    return int(lib.scan_tile_rows(int(n_key_lanes), int(n_vals)))


def scan_tile_plain(n_key_lanes: int, n_vals: int) -> int:
    """Plain version of :func:`scan_tile`, the frozen formula of
    ``csrc/predicates.cuh`` written out: the largest power of two in
    [256, 2048] with ``128 * (4 * n_key_lanes + 27) * 4 + tile *
    (n_key_lanes + n_vals) * 4 <= 200 KiB``, else 0."""
    fixed = 128 * (4 * n_key_lanes + 27) * 4
    tile = 2048
    while tile >= 256:
        if fixed + tile * (n_key_lanes + n_vals) * 4 <= 200 * 1024:
            return tile
        tile //= 2
    return 0


def block_partials_card_order(values_row: torch.Tensor, n_rows: int, tile: int) -> torch.Tensor:
    """float32 ``[ceil(N / 8192)]``: the partial of ``values_row`` ``[N]``
    over each 8192-row block, rows ``< n_rows`` only, reduced as the card's
    kernels reduce it (``csrc/predicates.cuh``, steps 1-4) and written out
    in float32 PyTorch: per tile of ``tile`` rows, thread ``t`` of 256 adds
    rows ``t, t + 256, ...`` in ascending order from +0.0; a xor butterfly
    over each warp's 32 lanes; lane 0's result added into the warp's slot;
    the 8 slots folded in warp order. A row outside ``[0, n_rows)`` adds
    +0.0, which leaves every bit as skipping it does. Held bit for bit
    against ``block_sums`` on the card."""
    n = values_row.shape[0]
    nb = -(-n // BLOCK_ROWS)
    x = values_row[: min(int(n_rows), n)].to(torch.float32)
    x = torch.nn.functional.pad(x, (0, nb * BLOCK_ROWS - x.shape[0]))
    rpt = tile // 256
    x = x.view(nb, BLOCK_ROWS // tile, rpt, 8, 32)  # block, tile, k, warp, lane
    s = torch.zeros_like(x[:, :, 0])
    for k in range(rpt):
        s = s + x[:, :, k]
    lane = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        s = s + s[..., lane ^ o]
    slot = torch.zeros_like(s[:, 0, :, 0])
    for t in range(BLOCK_ROWS // tile):
        slot = slot + s[:, t, :, 0]
    out = torch.zeros_like(slot[:, 0])
    for w in range(8):
        out = out + slot[:, w]
    return out


def block_sums_plain(values, *, n_rows: int, first_block: int = 0, n_vals: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`block_sums`."""
    n_blocks = -(-values.shape[1] // BLOCK_ROWS)
    lo = first_block * BLOCK_ROWS
    x = values[:n_vals, lo : n_blocks * BLOCK_ROWS]
    cols = torch.arange(lo, lo + x.shape[1], device=values.device)
    x = torch.where(cols[None, :] < n_rows, x, torch.zeros((), dtype=x.dtype, device=x.device))
    return block_partials(x)


def block_sums(
    values: torch.Tensor,  # float32[V_pad, N] resident value tile
    *,
    n_rows: int,
    block_n: int,
    first_block: int = 0,
    n_vals: int,
    n_key_lanes: int,
) -> torch.Tensor:
    """float32 ``[n_vals, ceil(N / block_n) - first_block]``: the partial of
    each live value row over each block from ``first_block`` on, folding
    rows ``< n_rows`` only. ``n_key_lanes`` and ``n_vals`` are the table's
    key lanes and live value rows, which fix the card's in-block order."""
    n_rows, first_block, n_vals = int(n_rows), int(first_block), int(n_vals)
    _check_tile(values, n_rows, block_n, n_vals, n_key_lanes)
    n_blocks = -(-values.shape[1] // BLOCK_ROWS)
    if not 0 <= first_block <= n_blocks:
        raise ValueError(f"first_block {first_block} out of range for {n_blocks} blocks")
    if values.device.type == "cpu":
        return block_sums_plain(values, n_rows=n_rows, first_block=first_block, n_vals=n_vals)
    out = torch.empty((n_vals, n_blocks - first_block), dtype=torch.float32, device=values.device)
    if out.numel() == 0:
        return out
    lib = _build.load("block_sums", _SIG)
    code = lib.block_sums_launch(
        values.data_ptr(), values.shape[1], n_rows, n_vals, int(n_key_lanes), first_block,
        n_blocks, out.data_ptr(), torch.cuda.current_stream(values.device).cuda_stream,
    )
    _build.check(code, "block_sums_launch")
    _build.count_launch(block_sums)
    return out


block_sums.launches = 0


def _pair_operands(values, sel, blocks, win_lo, win_hi, n_vals):
    """Host checks of the pairs, then int32 arrays: sel, blocks ``[P]``,
    windows ``[P, W]``."""
    sel = np.asarray(sel, np.int64).reshape(-1)
    blocks = np.asarray(blocks, np.int64).reshape(-1)
    win_lo = np.asarray(win_lo, np.int64)
    win_hi = np.asarray(win_hi, np.int64)
    p = sel.shape[0]
    if blocks.shape != (p,) or win_lo.ndim != 2 or win_lo.shape[0] != p or win_hi.shape != win_lo.shape:
        raise ValueError("sel and blocks must be [P], win_lo and win_hi one [P, W] shape")
    n_blocks = -(-values.shape[1] // BLOCK_ROWS)
    if p and (sel.min() < 0 or sel.max() >= n_vals):
        raise ValueError(f"a selector lies outside the {n_vals} live value rows")
    if p and (blocks.min() < 0 or blocks.max() >= n_blocks):
        raise ValueError(f"a block lies outside the tile's {n_blocks} blocks")
    for a in (win_lo, win_hi):
        if a.size and (a.min() < 0 or a.max() > values.shape[1]):
            raise ValueError("a window lies outside the tile's rows")
    return [a.astype(np.int32) for a in (sel, blocks, win_lo, win_hi)]


def boundary_block_sums_plain(values, sel, blocks, win_lo, win_hi, *, n_rows: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`boundary_block_sums`; the pair
    operands are int tensors on ``values``' device."""
    dev = values.device
    rows = blocks.long()[:, None] * BLOCK_ROWS + torch.arange(BLOCK_ROWS, device=dev)[None, :]
    inw = (
        (rows[:, None, :] >= win_lo.long()[:, :, None]) & (rows[:, None, :] < win_hi.long()[:, :, None])
    ).any(dim=1) & (rows < n_rows)
    vals = values[sel.long()[:, None], rows.clamp(max=values.shape[1] - 1)]
    x = torch.where(inw, vals, torch.zeros((), dtype=vals.dtype, device=dev))
    return block_partials(x)[:, 0]


def boundary_block_sums(
    values: torch.Tensor,  # float32[V_pad, N] resident value tile
    sel,  # int[P] value-row selector per (query, block) pair (host)
    blocks,  # int[P] block index per pair (host)
    win_lo,  # int[P, W] window starts, global row index, inclusive (host)
    win_hi,  # int[P, W] window stops, exclusive; lo >= hi is empty (host)
    *,
    n_rows: int,
    block_n: int,
    n_vals: int,
    n_key_lanes: int,
) -> torch.Tensor:
    """float32 ``[P]`` on ``values``' device: pair ``p`` gets the sum of
    value row ``sel[p]`` over the rows ``< n_rows`` of block ``blocks[p]``
    that lie inside any ``[win_lo[p, w], win_hi[p, w])``, reduced like the
    fused scan's block partial of a query whose slab is those windows.
    The pair operands are host arrays, checked on the host and uploaded
    in one copy."""
    n_rows, n_vals = int(n_rows), int(n_vals)
    _check_tile(values, n_rows, block_n, n_vals, n_key_lanes)
    sel, blocks, win_lo, win_hi = _pair_operands(values, sel, blocks, win_lo, win_hi, n_vals)
    p, w = win_lo.shape
    dev = values.device
    if p == 0:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    flat = np.concatenate([sel, blocks, win_lo.ravel(), win_hi.ravel()])
    t = torch.from_numpy(flat).to(dev)
    t_sel, t_blocks = t[:p], t[p : 2 * p]
    t_lo, t_hi = t[2 * p : 2 * p + p * w].view(p, w), t[2 * p + p * w :].view(p, w)
    if dev.type == "cpu":
        return boundary_block_sums_plain(values, t_sel, t_blocks, t_lo, t_hi, n_rows=n_rows)
    out = torch.empty(p, dtype=torch.float32, device=dev)
    if w == 0:
        return out.zero_()
    lib = _build.load("block_sums", _SIG)
    code = lib.boundary_sums_launch(
        values.data_ptr(), values.shape[1], n_rows, n_vals, int(n_key_lanes),
        t_sel.data_ptr(), t_blocks.data_ptr(), t_lo.data_ptr(), t_hi.data_ptr(), p, w,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(code, "boundary_sums_launch")
    _build.count_launch(boundary_block_sums)
    return out


boundary_block_sums.launches = 0
