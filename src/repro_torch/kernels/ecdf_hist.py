"""Histogram kernel for the Cost Evaluator's ECDF refresh.

:func:`ecdf_hist` returns float32 bin counts of ``col // bin_width`` over
``n_bins`` bins, ignoring negative values (the reference's −1 padding) and
values past the last bin; :func:`ecdf_hist_many` does the same for every
row of an int32 ``[C, N]`` tensor, each with its own bins, in one launch
(a write batch's key columns). CUDA tensors run ``csrc/ecdf_hist.cu``
(shared-memory int32 histograms, exact at any size; one CTA a column up
to :data:`SINGLE_CTA_ROWS` rows, several above, merged in the launch);
CPU tensors run :func:`ecdf_hist_plain` (a one-hot compare-and-sum, the
reference oracle's form). Both wrappers count their launches in
``ecdf_hist.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build

__all__ = [
    "MAX_BINS",
    "MAX_COLS",
    "SINGLE_CTA_ROWS",
    "ecdf_hist",
    "ecdf_hist_many",
    "ecdf_hist_many_plain",
    "ecdf_hist_plain",
    "empty_launch",
]

#: Bins one CTA's shared-memory histogram holds.
MAX_BINS = 4096
#: Columns one launch holds (more go in launches of this many).
MAX_COLS = 64
#: Rows a column up to which one CTA counts it; above, one CTA per
#: ``_ROWS_PER_CTA`` rows, at most ``_MAX_CTAS`` in all (two 1024-thread
#: CTAs fit an SM; the H100 has 132 SMs).
SINGLE_CTA_ROWS = 32_768
_ROWS_PER_CTA = 16_384
_MAX_CTAS = 264

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_I32S = ctypes.POINTER(ctypes.c_int32)
_SIG = {
    "ecdf_hist_launch": [_P, _I64, _I, _I32S, _I32S, _I, _P, _P, _P],
    "ecdf_empty_launch": [_I, _P],
}
_PLAIN_ROWS = 4096
# one zeroed int32 scratch (MAX_COLS histograms and tickets) per device and
# stream for the multi-CTA path, which leaves it zeroed after each launch
_scratch: dict[tuple[int, int], torch.Tensor] = {}


def ecdf_hist_plain(col: torch.Tensor, *, n_bins: int, bin_width: int) -> torch.Tensor:
    """Plain PyTorch version: one-hot compare of the bin ids against every
    bin, summed over rows, in chunks of rows."""
    out = torch.zeros(n_bins, dtype=torch.float32, device=col.device)
    bins_ids = torch.arange(n_bins, dtype=torch.int32, device=col.device)
    for s in range(0, col.shape[0], _PLAIN_ROWS):
        c = col[s : s + _PLAIN_ROWS]
        bins = torch.div(c, bin_width, rounding_mode="floor")
        bins = torch.where(c < 0, torch.full_like(bins, -1), bins)
        out += (bins[:, None] == bins_ids[None, :]).sum(dim=0, dtype=torch.float32)
    return out


def ecdf_hist_many_plain(
    cols: torch.Tensor, *, n_bins: Sequence[int], bin_widths: Sequence[int]
) -> torch.Tensor:
    """Plain PyTorch version of :func:`ecdf_hist_many`: each row's
    :func:`ecdf_hist_plain`, concatenated."""
    parts = [
        ecdf_hist_plain(cols[i], n_bins=int(nb), bin_width=int(bw))
        for i, (nb, bw) in enumerate(zip(n_bins, bin_widths))
    ]
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.float32, device=cols.device)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(cols: torch.Tensor, n_bins: list[int], widths: list[int], out: torch.Tensor) -> None:
    n_cols, n = cols.shape
    ctas = 1 if n <= SINGLE_CTA_ROWS else max(1, min(-(-n // _ROWS_PER_CTA), _MAX_CTAS // n_cols))
    stream = _stream(cols.device)
    scratch = 0
    if ctas > 1:
        key = (cols.device.index, stream)
        with _build.wrapper_lock:
            if key not in _scratch:
                _scratch[key] = torch.zeros(MAX_COLS * MAX_BINS + MAX_COLS, dtype=torch.int32, device=cols.device)
            scratch = _scratch[key].data_ptr()
    lib = _build.load("ecdf_hist", _SIG)
    code = lib.ecdf_hist_launch(
        cols.data_ptr(), n, n_cols, (ctypes.c_int32 * n_cols)(*n_bins),
        (ctypes.c_int32 * n_cols)(*widths), ctas, scratch, out.data_ptr(), stream,
    )
    _build.check(code, "ecdf_hist_launch")
    _build.count_launch(ecdf_hist)


def ecdf_hist_many(
    cols: torch.Tensor, *, n_bins: Sequence[int], bin_widths: Sequence[int]
) -> torch.Tensor:
    """float32[sum(n_bins)]: for each row ``c`` of ``cols`` (int32[C, N]),
    the counts of ``cols[c] // bin_widths[c]`` over ``n_bins[c]`` bins,
    concatenated in row order; one kernel launch per :data:`MAX_COLS`
    rows on a CUDA tensor."""
    if cols.dtype != torch.int32 or cols.dim() != 2 or not cols.is_contiguous():
        raise ValueError("cols must be a contiguous 2-D int32 tensor")
    n_bins, widths = [int(b) for b in n_bins], [int(w) for w in bin_widths]
    if len(n_bins) != cols.shape[0] or len(widths) != cols.shape[0]:
        raise ValueError(f"need one n_bins and bin_width per row, got {len(n_bins)}, {len(widths)} for {cols.shape[0]}")
    if any(b < 1 for b in n_bins) or any(w < 1 for w in widths):
        raise ValueError(f"need n_bins >= 1 and bin_width >= 1, got {n_bins}, {widths}")
    device = cols.device
    if device.type == "cpu":
        return ecdf_hist_many_plain(cols, n_bins=n_bins, bin_widths=widths)
    if device.type != "cuda":
        raise ValueError(f"ecdf_hist runs on cuda or cpu tensors, got {device}")
    if max(n_bins, default=0) > MAX_BINS:
        raise ValueError(f"the kernel holds at most {MAX_BINS} bins, got {max(n_bins)}")
    out = torch.empty(sum(n_bins), dtype=torch.float32, device=device)
    if cols.shape[0] <= MAX_COLS:
        _launch(cols, n_bins, widths, out)
        return out
    at = 0
    for s in range(0, cols.shape[0], MAX_COLS):
        nb, bw = n_bins[s : s + MAX_COLS], widths[s : s + MAX_COLS]
        _launch(cols[s : s + MAX_COLS], nb, bw, out[at : at + sum(nb)])
        at += sum(nb)
    return out


def ecdf_hist(col: torch.Tensor, *, n_bins: int, bin_width: int) -> torch.Tensor:
    """float32[n_bins] counts of ``col // bin_width`` (``col`` int32[N]):
    :func:`ecdf_hist_many` of one row."""
    if col.dtype != torch.int32 or col.dim() != 1 or not col.is_contiguous():
        raise ValueError("col must be a contiguous 1-D int32 tensor")
    return ecdf_hist_many(col.view(1, col.shape[0]), n_bins=[n_bins], bin_widths=[bin_width])


def empty_launch(cols: torch.Tensor) -> None:
    """Launch an empty kernel on the grid :func:`ecdf_hist_many` gives
    ``cols`` at a write batch's size (one 1024-thread CTA a row): the
    launch floor ``chip_smoke.py`` reports beside the kernel. Not counted."""
    if cols.device.type != "cuda":
        raise ValueError(f"empty_launch needs a cuda tensor, got {cols.device}")
    lib = _build.load("ecdf_hist", _SIG)
    n_cols = cols.shape[0] if cols.dim() == 2 else 1
    _build.check(lib.ecdf_empty_launch(n_cols, _stream(cols.device)), "ecdf_empty_launch")


ecdf_hist.launches = 0
