"""Histogram kernel for the Cost Evaluator's ECDF refresh.

:func:`ecdf_hist` returns float32 bin counts of ``col // bin_width`` over
``n_bins`` bins, ignoring negative values (the reference's −1 padding) and
values past the last bin. CUDA tensors run ``csrc/ecdf_hist.cu`` (shared-
memory int32 histograms, exact at any size); CPU tensors run
:func:`ecdf_hist_plain` (a one-hot compare-and-sum, the reference
oracle's form).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["MAX_BINS", "ecdf_hist", "ecdf_hist_plain"]

#: Bins one CTA's shared-memory histogram holds.
MAX_BINS = 4096

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIG = {"ecdf_hist_launch": [_P, _I64, _I, _I, _P, _P, _P]}
_PLAIN_ROWS = 4096


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


def ecdf_hist(col: torch.Tensor, *, n_bins: int, bin_width: int) -> torch.Tensor:
    """float32[n_bins] counts of ``col // bin_width`` (``col`` int32[N])."""
    if col.dtype != torch.int32 or col.dim() != 1 or not col.is_contiguous():
        raise ValueError("col must be a contiguous 1-D int32 tensor")
    if n_bins < 1 or bin_width < 1:
        raise ValueError(f"need n_bins >= 1 and bin_width >= 1, got {n_bins}, {bin_width}")
    device = col.device
    if device.type == "cpu":
        return ecdf_hist_plain(col, n_bins=n_bins, bin_width=bin_width)
    if device.type != "cuda":
        raise ValueError(f"ecdf_hist runs on cuda or cpu tensors, got {device}")
    if n_bins > MAX_BINS:
        raise ValueError(f"the kernel holds at most {MAX_BINS} bins, got {n_bins}")
    acc = torch.empty(n_bins, dtype=torch.int32, device=device)
    out = torch.empty(n_bins, dtype=torch.float32, device=device)
    lib = _build.load("ecdf_hist", _SIG)
    code = lib.ecdf_hist_launch(
        col.data_ptr(), col.shape[0], n_bins, bin_width, acc.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(code, "ecdf_hist_launch")
    ecdf_hist.launches += 1
    return out


ecdf_hist.launches = 0
