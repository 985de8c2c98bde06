"""Device read-path kernels: the fused locate+scan, select compaction and
slab location.

``scan_agg_locate`` — per query, one pass over the resident key lanes and
value tile gives the float32 sum of the selected value row over rows
passing the residual predicate, the int32 matched count, and the int32
count of rows whose key tuple lies inside the query's slab (the rows a
sorted scan would stream, ``rows_scanned``). CUDA tensors run
``csrc/scan_locate.cu``; CPU tensors run :func:`scan_agg_locate_plain`.
The kernel evaluates only the (query, tile) pairs its skip rule leaves
live; :func:`live_tile_pairs` is that rule in plain PyTorch, for
measurement and tests.

``select_compact`` — per query, the ascending row indices that pass the
residual predicate inside its window, as one flat int32 array sized by the
fused scan's match counts. CUDA tensors run ``csrc/select_compact.cu``;
CPU tensors run :func:`select_compact_plain`. The kernel counts matches
only on the (query, segment) pairs its skip rule leaves live;
:func:`select_live_pairs` is that rule in plain PyTorch.

``slab_locate`` — per query, the two searchsorted ranks of its slab keys
inside its row window of a sorted run: the rows below ``slab_lo`` and the
rows at or below ``slab_hi``. CUDA tensors run ``csrc/slab_rank.cu``, a
warp-wide k-ary search whose steps :func:`kary_ranks_emulated` writes
out; CPU tensors run :func:`slab_locate_plain`.

All take the reference's operand layout (``repro/kernels/slab_locate.py``):
key lanes int32 ``[K_pad, N]``, value tile float32 ``[V_pad, N]``, per-query
lane bounds int32 ``[Q, K_ex]`` with ``K_ex = sum(col_parts)`` (residual
``hi`` exclusive, slab ``hi`` inclusive), row windows int32 ``[Q, 2]`` and a
value-row selector int32 ``[Q]``. A query with a ``(0, 0)`` window
contributes nothing. The float sums follow the sum contract of
``block_agg``: per query, one float32 partial per 8192-row block, folded
strictly sequentially in ascending block order; on the card the partials
come from the in-block order of ``csrc/predicates.cuh``, on the CPU from
``block_agg.block_partials``. Both are deterministic, and the view
kernels reduce a block the same way.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .block_agg import BLOCK_ROWS, block_partials

__all__ = [
    "BLOCK_ROWS",
    "KARY_PROBES",
    "SCAN_QUERY_CHUNK",
    "SELECT_SEG_ROWS",
    "fold_blocks",
    "kary_ranks_emulated",
    "kary_rounds",
    "live_tile_pairs",
    "scan_agg_locate",
    "scan_agg_locate_plain",
    "select_compact",
    "select_compact_plain",
    "select_live_pairs",
    "slab_locate",
    "slab_locate_plain",
]


#: Queries one CTA of the fused scan holds (``kQueryChunk`` in
#: ``csrc/predicates.cuh``): the skip rule's window hull is per chunk.
SCAN_QUERY_CHUNK = 128

_P, _I, _I64, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
_SCAN_SIG = {
    "scan_locate_launch": [
        _P, _I64, _I, _I, _U32, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
        _P, _P, _P, _P, _P, _P, _P,
    ]
}
_SELECT_SIG = {
    "select_compact_launch": [
        _P, _I64, _I, _I, _U32, _P, _P, _P, _I, _P, _I, _P, _P, _I64, _P, _P, _P,
    ]
}
#: Bytes of one entry of the select compaction's pair list (``Pair``).
_PAIR_BYTES = 24
_RANK_SIG = {
    "slab_rank_launch": [_P, _I64, _I, _P, _P, _P, _I, _P, _P],
    # the latency yardstick beside it (bench.select_slab.load_latency_ns)
    "load_chase_launch": [_P, _I64, _P, _P],
}


def _raw_stream(device) -> int:
    """The current CUDA stream of ``device`` as a pointer, without the
    ``torch.cuda.Stream`` object ``current_stream`` builds: a wrapper's
    host time is most of a short kernel's wall."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _col_parts(col_parts, n_lanes_bound: int) -> tuple[int, ...]:
    col_parts = tuple(int(p) for p in col_parts)
    if sum(col_parts) != n_lanes_bound or not all(p in (1, 2) for p in col_parts):
        raise ValueError(
            f"col_parts {col_parts} does not tile {n_lanes_bound} bound lanes"
        )
    if len(col_parts) > 32:
        raise ValueError(f"{len(col_parts)} key columns: at most 32 are supported")
    return col_parts


def _wide_mask(col_parts: tuple[int, ...]) -> int:
    return sum(1 << c for c, p in enumerate(col_parts) if p == 2)


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D {dtype}, got {t.dim()}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, keys on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _lex_masks(keys, lo, hi, n_lanes):
    """(Q, N) ``key >= lo`` and ``key <= hi`` masks, tuple-lexicographic
    over the first ``n_lanes`` lanes (MSB lane first)."""
    ge = le = None
    for lane in reversed(range(n_lanes)):
        k = keys[lane][None, :]
        bl = lo[:, lane : lane + 1]
        bh = hi[:, lane : lane + 1]
        ge = (k >= bl) if ge is None else (k > bl) | ((k == bl) & ge)
        le = (k <= bh) if le is None else (k < bh) | ((k == bh) & le)
    return ge, le


def _residual_mask(keys, lo, hi, col_parts, base):
    """(Q, N) residual predicate ANDed onto ``base``: per logical column,
    value in [lo, hi), wide columns compared over their lane pair."""
    ok = base
    lane = 0
    for parts in col_parts:
        k = keys[lane][None, :]
        if parts == 1:
            ok = ok & (k >= lo[:, lane : lane + 1]) & (k < hi[:, lane : lane + 1])
        else:
            kl = keys[lane + 1][None, :]
            bh, bl = lo[:, lane : lane + 1], lo[:, lane + 1 : lane + 2]
            ok = ok & ((k > bh) | ((k == bh) & (kl >= bl)))
            bh, bl = hi[:, lane : lane + 1], hi[:, lane + 1 : lane + 2]
            ok = ok & ((k < bh) | ((k == bh) & (kl < bl)))
        lane += parts
    return ok


def _window(limits, n):
    ridx = torch.arange(n, dtype=torch.int32, device=limits.device)[None, :]
    return (ridx >= limits[:, 0:1]) & (ridx < limits[:, 1:2])


# plain versions evaluate (chunk, N) masks; the chunk bounds their memory
_PLAIN_Q_CHUNK = 16


def fold_blocks(parts: torch.Tensor) -> torch.Tensor:
    """float32 ``[Q]``: each row of the ``[Q, n_blocks]`` block partials
    folded strictly sequentially in ascending block order, starting from
    0.0 (the fused scan's second pass; ``torch.sum`` and ``torch.cumsum``
    promise no such order)."""
    acc = torch.zeros(parts.shape[0], dtype=torch.float32, device=parts.device)
    for b in range(parts.shape[1]):
        acc = acc + parts[:, b]
    return acc


def scan_agg_locate_plain(
    keys, values, res_lo, res_hi, slab_lo, slab_hi, limits, value_sel, *, col_parts
):
    """Plain PyTorch version of :func:`scan_agg_locate`: whole-array masks
    per chunk of queries; sums as block partials (``block_partials``)
    folded in ascending block order. Returns ``(sums f32[Q], matched
    i32[Q], slab_rows i32[Q])``."""
    col_parts = _col_parts(col_parts, res_lo.shape[1])
    n_lanes = sum(col_parts)
    n = keys.shape[1]
    q = res_lo.shape[0]
    parts = torch.zeros((q, -(-n // BLOCK_ROWS)), dtype=torch.float32, device=keys.device)
    matched = torch.zeros(q, dtype=torch.int32, device=keys.device)
    slab_rows = torch.zeros(q, dtype=torch.int32, device=keys.device)
    n_vals = values.shape[0]
    for s in range(0, q, _PLAIN_Q_CHUNK):
        e = min(q, s + _PLAIN_Q_CHUNK)
        valid = _window(limits[s:e], n)
        ge, le = _lex_masks(keys, slab_lo[s:e], slab_hi[s:e], n_lanes)
        match = _residual_mask(keys, res_lo[s:e], res_hi[s:e], col_parts, valid)
        sel = value_sel[s:e].long()
        in_range = (sel >= 0) & (sel < n_vals)
        vq = values[sel.clamp(0, n_vals - 1)]
        vq = torch.where(match & in_range[:, None], vq, torch.zeros((), dtype=vq.dtype, device=vq.device))
        parts[s:e] = block_partials(vq)
        matched[s:e] = match.sum(dim=1, dtype=torch.int32)
        slab_rows[s:e] = (valid & ge & le).sum(dim=1, dtype=torch.int32)
    return fold_blocks(parts), matched, slab_rows


_I64_MAX, _I64_MIN = torch.iinfo(torch.int64).max, torch.iinfo(torch.int64).min


def _col_values(lanes, col_parts):
    """Each logical column as one int64 whose order is the column's: a
    wide column's (hi, lo) lane pair maps to ``hi * 2**32 + lo + 2**31``
    (``col_value`` in ``csrc/scan_locate.cu``). ``lanes`` is ``[K_ex, ...]``
    int64; returns one tensor per column."""
    out, lane = [], 0
    for parts in col_parts:
        v = lanes[lane]
        if parts == 2:
            v = v * (1 << 32) + lanes[lane + 1] + (1 << 31)
        out.append(v)
        lane += parts
    return out


def _hull_chunks(keys, res_lo, res_hi, limits, col_parts, rows: int, n_rows: int):
    """The residual half both skip rules share. Cuts the key lanes into
    units of ``rows`` rows and yields, per chunk of ``SCAN_QUERY_CHUNK``
    queries with a nonempty window, ``(s, e, k, taken, meets, res)``: the
    chunk's queries ``[s, e)``; the padded lanes, int64 ``[K_ex, units,
    rows]``; the rows inside the hull of the chunk's nonempty windows and
    below ``n_rows``, bool ``[units, rows]``; per (query, unit), whether
    the query's window meets the unit and the unit holds such a row; and
    whether every logical column's range over those rows meets the
    query's ``[res_lo, res_hi)``."""
    n_lanes = sum(col_parts)
    n = keys.shape[1]
    n_units = -(-n // rows)
    k = torch.nn.functional.pad(keys[:n_lanes].long(), (0, n_units * rows - n)).view(n_lanes, n_units, rows)
    row = torch.arange(n_units * rows, device=keys.device).view(n_units, rows)
    starts = row[:, 0]
    cols = _col_values(k, col_parts)
    lim = limits.long()
    for s in range(0, res_lo.shape[0], SCAN_QUERY_CHUNK):
        e = min(res_lo.shape[0], s + SCAN_QUERY_CHUNK)
        lo, hi = lim[s:e, 0], lim[s:e, 1]
        full = lo < hi
        if not bool(full.any()):
            continue
        taken = (row >= int(lo[full].min())) & (row < min(int(hi[full].max()), n_rows, n))
        meets = taken.any(dim=1)[None, :] & full[:, None]
        meets &= (lo[:, None] < starts[None, :] + rows) & (hi[:, None] > starts[None, :])
        res = torch.ones_like(meets)
        r_lo = _col_values(res_lo[s:e].long().T, col_parts)
        r_hi = _col_values(res_hi[s:e].long().T, col_parts)
        for v, b_lo, b_hi in zip(cols, r_lo, r_hi):
            c_min = torch.where(taken, v, _I64_MAX).amin(dim=1)[None, :]
            c_max = torch.where(taken, v, _I64_MIN).amax(dim=1)[None, :]
            res &= (c_min < b_hi[:, None]) & (c_max >= b_lo[:, None])
        yield s, e, k, taken, meets, res


def live_tile_pairs(
    keys, res_lo, res_hi, slab_lo, slab_hi, limits, *, col_parts, n_rows: int, tile: int
) -> torch.Tensor:
    """bool ``[Q, ceil(N / tile)]``: the (query, tile) pairs the fused
    scan's kernel evaluates, by its skip rule. Per chunk of
    ``SCAN_QUERY_CHUNK`` queries the kernel takes, of each tile of
    ``tile`` rows, the rows inside the hull of the chunk's nonempty
    windows (here also below ``n_rows``; the kernel stops at the tensor's
    end) and reduces them to the lexicographic minimum and maximum key
    tuple and each logical column's minimum and maximum. Query ``q`` is
    live on the tile if its window meets the tile, the tile holds such a
    row, and either the tuple range meets ``[slab_lo, slab_hi]`` or every
    column's range meets ``[res_lo, res_hi)``. A row a query counts (in
    its slab or matched) lies in a live pair, so skipping the rest changes
    no count and no bit of a sum. Plain PyTorch on any device; it serves
    measurement and tests, not the read path."""
    col_parts = _col_parts(col_parts, res_lo.shape[1])
    n_lanes = sum(col_parts)
    live = torch.zeros((res_lo.shape[0], -(-keys.shape[1] // tile)), dtype=torch.bool, device=keys.device)
    for s, e, k, taken, meets, res in _hull_chunks(keys, res_lo, res_hi, limits, col_parts, tile, n_rows):
        tmin, tmax = [], []
        at_min, at_max = taken, taken
        for lane in range(n_lanes):
            x = k[lane]
            mn = torch.where(at_min, x, _I64_MAX).amin(dim=1)
            mx = torch.where(at_max, x, _I64_MIN).amax(dim=1)
            at_min = at_min & (x == mn[:, None])
            at_max = at_max & (x == mx[:, None])
            tmin.append(mn)
            tmax.append(mx)
        le = ge = None  # tuple min <= slab_hi, tuple max >= slab_lo
        for lane in reversed(range(n_lanes)):
            a, b = tmin[lane][None, :], slab_hi[s:e, lane : lane + 1].long()
            le = (a <= b) if le is None else (a < b) | ((a == b) & le)
            a, b = tmax[lane][None, :], slab_lo[s:e, lane : lane + 1].long()
            ge = (a >= b) if ge is None else (a > b) | ((a == b) & ge)
        live[s:e] = meets & ((le & ge) | res)
    return live


#: Rows of one segment of the select compaction's skip rule
#: (``kSegRows`` in ``csrc/select_compact.cu``): a warp's unit.
SELECT_SEG_ROWS = 256


def select_live_pairs(keys, res_lo, res_hi, limits, *, col_parts, rows: int = SELECT_SEG_ROWS) -> torch.Tensor:
    """bool ``[Q, ceil(N / rows)]``: the (query, segment) pairs the select
    compaction's counting pass evaluates, by its skip rule (the residual
    half of :func:`live_tile_pairs`), with segments of ``rows`` rows. Per
    chunk of ``SCAN_QUERY_CHUNK`` queries the kernel takes, of each
    segment, the rows inside the hull of the chunk's nonempty windows and
    reduces each logical column to its minimum and maximum; query ``q`` is
    live on the segment if its window meets the segment, the segment
    holds such a row, and every column's range meets ``[res_lo, res_hi)``.
    A row a select matches lies in a live pair at any ``rows`` (a wider
    segment's ranges are wider), so the kernel's skipping changes no
    index. Plain PyTorch on any device, for measurement and tests."""
    col_parts = _col_parts(col_parts, res_lo.shape[1])
    n = keys.shape[1]
    live = torch.zeros((res_lo.shape[0], -(-n // rows)), dtype=torch.bool, device=keys.device)
    for s, e, _, _, meets, res in _hull_chunks(keys, res_lo, res_hi, limits, col_parts, rows, n):
        live[s:e] = meets & res
    return live


def scan_agg_locate(
    keys: torch.Tensor,  # int32[K_pad, N] key lanes
    values: torch.Tensor,  # float32[V_pad, N] value tile
    res_lo: torch.Tensor,  # int32[Q, K_ex] residual bounds, inclusive
    res_hi: torch.Tensor,  # int32[Q, K_ex] residual bounds, EXCLUSIVE
    slab_lo: torch.Tensor,  # int32[Q, K_ex] slab key, inclusive
    slab_hi: torch.Tensor,  # int32[Q, K_ex] slab key, INCLUSIVE
    limits: torch.Tensor,  # int32[Q, 2] row window
    value_sel: torch.Tensor,  # int32[Q] value-row selector
    *,
    col_parts,
    n_vals: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused locate+scan: ``(sum f32[Q], matched i32[Q], slab_rows
    i32[Q])``. ``n_vals`` limits the value rows the kernel stages (the
    resident tile's live rows; default all); a selector outside
    ``[0, n_vals)`` sums nothing."""
    device = keys.device
    _check("keys", keys, torch.int32, 2, device)
    _check("values", values, torch.float32, 2, device)
    for name, t in (("res_lo", res_lo), ("res_hi", res_hi), ("slab_lo", slab_lo),
                    ("slab_hi", slab_hi), ("limits", limits)):
        _check(name, t, torch.int32, 2, device)
    _check("value_sel", value_sel, torch.int32, 1, device)
    q, k_ex = res_lo.shape
    col_parts = _col_parts(col_parts, k_ex)
    if values.shape[1] != keys.shape[1]:
        raise ValueError(f"values carry {values.shape[1]} rows, keys {keys.shape[1]}")
    if k_ex > keys.shape[0]:
        raise ValueError(f"bounds cover {k_ex} lanes but keys carry {keys.shape[0]}")
    if any(t.shape != (q, k_ex) for t in (res_hi, slab_lo, slab_hi)):
        raise ValueError("bound arrays must share one [Q, K_ex] shape")
    if limits.shape != (q, 2) or value_sel.shape != (q,):
        raise ValueError("limits must be [Q, 2] and value_sel [Q]")
    n_vals = values.shape[0] if n_vals is None else int(n_vals)
    if not 0 < n_vals <= values.shape[0]:
        raise ValueError(f"n_vals {n_vals} out of range for {values.shape[0]} rows")
    if device.type == "cpu":
        return scan_agg_locate_plain(
            keys, values[:n_vals], res_lo, res_hi, slab_lo, slab_hi, limits,
            value_sel, col_parts=col_parts,
        )
    if device.type != "cuda":
        raise ValueError(f"scan_agg_locate runs on cuda or cpu tensors, got {device}")
    n_pad = keys.shape[1]
    n_blocks = -(-n_pad // BLOCK_ROWS)
    out_s = torch.empty(q, dtype=torch.float32, device=device)
    out_m = torch.empty(q, dtype=torch.int32, device=device)
    out_c = torch.empty(q, dtype=torch.int32, device=device)
    if q == 0 or n_blocks == 0:
        return out_s.zero_(), out_m.zero_(), out_c.zero_()
    part_s = torch.empty((q, n_blocks), dtype=torch.float32, device=device)
    part_m = torch.empty((q, n_blocks), dtype=torch.int32, device=device)
    part_c = torch.empty((q, n_blocks), dtype=torch.int32, device=device)
    lib = _build.load("scan_locate", _SCAN_SIG)
    code = lib.scan_locate_launch(
        keys.data_ptr(), n_pad, k_ex, len(col_parts), _wide_mask(col_parts),
        values.data_ptr(), n_vals, res_lo.data_ptr(), res_hi.data_ptr(),
        slab_lo.data_ptr(), slab_hi.data_ptr(), limits.data_ptr(),
        value_sel.data_ptr(), q, n_blocks, part_s.data_ptr(), part_m.data_ptr(),
        part_c.data_ptr(), out_s.data_ptr(), out_m.data_ptr(), out_c.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(code, "scan_locate_launch")
    _build.count_launch(scan_agg_locate)
    return out_s, out_m, out_c


scan_agg_locate.launches = 0


def select_compact_plain(keys, res_lo, res_hi, limits, counts, *, col_parts):
    """Plain PyTorch version of :func:`select_compact`: per query, the
    nonzero indices of its whole-array match mask."""
    col_parts = _col_parts(col_parts, res_lo.shape[1])
    counts = np.asarray(counts, np.int64)
    n = keys.shape[1]
    q = res_lo.shape[0]
    chunks = []
    for s in range(0, q, _PLAIN_Q_CHUNK):
        e = min(q, s + _PLAIN_Q_CHUNK)
        match = _residual_mask(keys, res_lo[s:e], res_hi[s:e], col_parts, _window(limits[s:e], n))
        for j in range(e - s):
            rows = torch.nonzero(match[j]).flatten().to(torch.int32)
            if rows.numel() != counts[s + j]:
                raise ValueError(
                    f"query {s + j}: {rows.numel()} matches, counts say {counts[s + j]}"
                )
            chunks.append(rows)
    if not chunks:
        return torch.empty(0, dtype=torch.int32, device=keys.device)
    return torch.cat(chunks)


def select_compact(
    keys: torch.Tensor,  # int32[K_pad, N] key lanes
    res_lo: torch.Tensor,  # int32[Q, K_ex] residual bounds, inclusive
    res_hi: torch.Tensor,  # int32[Q, K_ex] residual bounds, EXCLUSIVE
    limits: torch.Tensor,  # int32[Q, 2] row window
    counts,  # int64[Q] on the host: each query's match count
    *,
    col_parts,
) -> torch.Tensor:
    """int32[sum(counts)]: query ``j``'s ascending matched row indices at
    ``[offsets[j], offsets[j + 1])``, ``offsets`` the exclusive prefix sum
    of ``counts`` (the fused scan's ``matched``). The counts size the
    output on the host; the kernel never writes past a query's slice."""
    device = keys.device
    _check("keys", keys, torch.int32, 2, device)
    for name, t in (("res_lo", res_lo), ("res_hi", res_hi), ("limits", limits)):
        _check(name, t, torch.int32, 2, device)
    q, k_ex = res_lo.shape
    col_parts = _col_parts(col_parts, k_ex)
    counts = np.asarray(counts, np.int64)
    if res_hi.shape != (q, k_ex) or limits.shape != (q, 2) or counts.shape != (q,):
        raise ValueError("res_hi must be [Q, K_ex], limits [Q, 2], counts [Q]")
    if k_ex > keys.shape[0]:
        raise ValueError(f"bounds cover {k_ex} lanes but keys carry {keys.shape[0]}")
    if device.type == "cpu":
        return select_compact_plain(
            keys, res_lo, res_hi, limits, counts, col_parts=col_parts
        )
    if device.type != "cuda":
        raise ValueError(f"select_compact runs on cuda or cpu tensors, got {device}")
    offsets = np.zeros(q + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    out = torch.empty(int(offsets[-1]), dtype=torch.int32, device=device)
    n_pad = keys.shape[1]
    n_blocks = -(-n_pad // BLOCK_ROWS)
    if q == 0 or n_blocks == 0 or out.numel() == 0:
        return out
    # pinned, so that the upload waits for nothing queued on the stream
    offsets_t = torch.from_numpy(offsets).pin_memory().to(device, non_blocking=True)
    # one scratch buffer: the pair list (a pair holds a match and is one of
    # the Q * n_blocks (query, block) pairs, so either total bounds it), the
    # block counts int32 [Q, n_blocks], the list's length
    cap = min(out.numel(), q * n_blocks)
    count_words = -(-q * n_blocks // 2)
    scratch = torch.empty(cap * _PAIR_BYTES // 8 + count_words + 1, dtype=torch.int64, device=device)
    pairs = scratch.data_ptr()
    counts_p = pairs + cap * _PAIR_BYTES
    lib = _build.load("select_compact", _SELECT_SIG)
    code = lib.select_compact_launch(
        keys.data_ptr(), n_pad, k_ex, len(col_parts), _wide_mask(col_parts),
        res_lo.data_ptr(), res_hi.data_ptr(), limits.data_ptr(), q,
        offsets_t.data_ptr(), n_blocks, counts_p, pairs, cap, counts_p + 8 * count_words,
        out.data_ptr(), _raw_stream(device),
    )
    _build.check(code, "select_compact_launch")
    _build.count_launch(select_compact)
    return out


select_compact.launches = 0


def slab_locate_plain(keys, slab_lo, slab_hi, limits):
    """Plain PyTorch version of :func:`slab_locate`: the reference's rank
    form, masked lexicographic counts over the whole window, per chunk of
    queries."""
    n = keys.shape[1]
    q, k_ex = slab_lo.shape
    out = torch.zeros((q, 2), dtype=torch.int32, device=keys.device)
    for s in range(0, q, _PLAIN_Q_CHUNK):
        e = min(q, s + _PLAIN_Q_CHUNK)
        valid = _window(limits[s:e], n)
        ge, le = _lex_masks(keys, slab_lo[s:e], slab_hi[s:e], k_ex)
        out[s:e, 0] = (valid & ~ge).sum(dim=1, dtype=torch.int32)
        out[s:e, 1] = (valid & le).sum(dim=1, dtype=torch.int32)
    return out


#: Rows one round of the slab location kernel probes: one per lane of
#: its warp (``csrc/slab_rank.cu``).
KARY_PROBES = 32


def kary_rounds(n: int) -> int:
    """Dependent probe rounds of the k-ary search in a window of ``n``
    rows, at most: while more than ``KARY_PROBES`` rows are left, a round
    probes ``KARY_PROBES`` evenly spaced rows and keeps one of the
    ``KARY_PROBES + 1`` parts between them (at most ``n // 33`` rows);
    a last round reads the rows left."""
    rounds = 0
    while n > KARY_PROBES:
        n //= KARY_PROBES + 1
        rounds += 1
    return rounds + (n > 0)


def kary_ranks_emulated(keys, slab_lo, slab_hi, limits) -> torch.Tensor:
    """int32 ``[Q, 2]``: the slab location kernel's k-ary search written
    out step by step in numpy, probe positions and interval updates as
    the kernel computes them, for tests. Inside a sorted window it equals
    :func:`slab_locate_plain` (the rank form) and ``searchsorted``."""
    k = keys.cpu().numpy().astype(np.int64)
    n_pad = k.shape[1]
    lim = limits.cpu().numpy().astype(np.int64)
    bounds = (slab_lo.cpu().numpy().astype(np.int64), slab_hi.cpu().numpy().astype(np.int64))
    n_lanes = bounds[0].shape[1]
    out = np.zeros((lim.shape[0], 2), np.int32)

    def below(rows, b, side):
        # branch-free lexicographic compare from the last lane up: side 0
        # key < b, side 1 key <= b
        lt = np.full(rows.shape, side == 1)
        for lane in reversed(range(n_lanes)):
            x = k[lane, rows]
            lt = (x < b[lane]) | ((x == b[lane]) & lt)
        return lt

    i = np.arange(KARY_PROBES, dtype=np.int64)
    for q in range(lim.shape[0]):
        start = max(lim[q, 0], 0)
        stop = max(min(lim[q, 1], n_pad), start)
        for side in (0, 1):
            b = bounds[side][q]
            lo, hi = start, stop
            while hi - lo > KARY_PROBES:
                p = lo + (i + 1) * (hi - lo) // (KARY_PROBES + 1)
                j = int(below(p, b, side).sum())
                if j > 0:
                    lo = int(p[j - 1]) + 1
                if j < KARY_PROBES:
                    hi = int(p[j])
            p = lo + i[: hi - lo]
            out[q, side] = lo + int(below(p, b, side).sum()) - start
    return torch.from_numpy(out).to(keys.device)


def slab_locate(
    keys: torch.Tensor,  # int32[K_pad, N] key lanes, one sorted run
    slab_lo: torch.Tensor,  # int32[Q, K_ex] lower slab key, inclusive
    slab_hi: torch.Tensor,  # int32[Q, K_ex] upper slab key, INCLUSIVE
    limits: torch.Tensor,  # int32[Q, 2] row window
) -> torch.Tensor:
    """int32 ``[Q, 2]``: per query, the window rows whose key tuple (the
    first ``K_ex`` lanes) lies lexicographically below ``slab_lo`` and at
    or below ``slab_hi``. Inside a sorted window these are
    ``searchsorted`` left and right, less the window's start. An empty
    query (``slab_hi`` lanes of -1, or a ``(0, 0)`` window) gives
    ``(0, 0)``."""
    device = keys.device
    _check("keys", keys, torch.int32, 2, device)
    for name, t in (("slab_lo", slab_lo), ("slab_hi", slab_hi), ("limits", limits)):
        _check(name, t, torch.int32, 2, device)
    q, k_ex = slab_lo.shape
    if not 0 < k_ex <= keys.shape[0]:
        raise ValueError(f"bounds cover {k_ex} lanes but keys carry {keys.shape[0]}")
    if slab_hi.shape != (q, k_ex) or limits.shape != (q, 2):
        raise ValueError("slab_hi must be [Q, K_ex] and limits [Q, 2]")
    if device.type == "cpu":
        return slab_locate_plain(keys, slab_lo, slab_hi, limits)
    if device.type != "cuda":
        raise ValueError(f"slab_locate runs on cuda or cpu tensors, got {device}")
    out = torch.empty((q, 2), dtype=torch.int32, device=device)
    if q == 0:
        return out
    lib = _build.load("slab_rank", _RANK_SIG)
    code = lib.slab_rank_launch(
        keys.data_ptr(), keys.shape[1], k_ex, slab_lo.data_ptr(), slab_hi.data_ptr(),
        limits.data_ptr(), q, out.data_ptr(), _raw_stream(device),
    )
    _build.check(code, "slab_rank_launch")
    _build.count_launch(slab_locate)
    return out


slab_locate.launches = 0
