"""Host and device glue of the device read and write paths.

``build_device_state`` materializes a table's resident tensors, in the
reference's exact layout (``repro/kernels/ops.py``): int32 key lanes
``[K_pad, N_pad]`` (30-bit lanes; columns of 31–60 bits as a ``(v >> 30,
v & mask)`` lane pair), a float32 value tile ``[V_pad, N_pad]`` with one
row per value column plus a ones row, and ``N_pad`` a multiple of
``DEVICE_BLOCK_N``. ``device_state_append`` extends it with a merged write
run, ``merge_device_runs`` collapses the run stack on the device (merge
ranks + one scatter per tensor), and ``table_execute_device_many`` serves
a sum/count/select batch from it: one fused locate+scan launch, plus one
select-compaction launch when the batch has selects with matches.
``state_from_numpy`` turns a reference state (arrays as numpy) into the
port's, so both implementations can be fed identical resident arrays.

The row-slab read path: ``table_slab_locate_many`` gives a single-run
resident table's row slabs from the k-ary search kernel (the device half
of ``SortedTable.slab_many``), and ``table_scan_device_many`` scans a
batch over such slabs with the rows-outer or the queries-outer kernel
(``scan_agg``), its counts in a float32 lane exact to 2**24 rows as the
reference's; ``scan_agg``/``scan_agg_batched`` are the same scans on bare
tensors. The fused path above supersedes them; they stay as the benchmark
baselines of ``repro_torch.bench.batched_read``.
"""

from __future__ import annotations

import numpy as np
import torch

from .merge_runs import merge_run_positions
from .scan_agg import scan_agg_qgrid, scan_agg_rowstream
from .slab_locate import scan_agg_locate, select_compact, slab_locate

__all__ = [
    "DEVICE_BLOCK_N",
    "FLOAT32_EXACT_ROWS",
    "MAX_DEVICE_COL_BITS",
    "MAX_DEVICE_ROWS",
    "WIDE_LANE_BITS",
    "build_device_state",
    "device_key_plan",
    "device_query_operands",
    "device_state_append",
    "merge_device_runs",
    "scan_agg",
    "scan_agg_batched",
    "state_from_numpy",
    "table_execute_device_many",
    "table_scan_device",
    "table_scan_device_many",
    "table_slab_locate_many",
]

# A key lane is an int32; columns wider than this many bits are split
# into (hi, lo) lane pairs compared lexicographically.
WIDE_LANE_BITS = 30
MAX_DEVICE_COL_BITS = 2 * WIDE_LANE_BITS
_LANE_MASK = (1 << WIDE_LANE_BITS) - 1

# Row-axis padding granularity of the resident tensors and the unit of the
# kernels' float-sum order (8192-row block partials).
DEVICE_BLOCK_N = 8192

# The kernels count matches in int32 and address rows with int32 indices.
MAX_DEVICE_ROWS = (1 << 31) - DEVICE_BLOCK_N

# The row-slab scans return their counts in a float32 lane, as the
# reference's do: exact only to 2**24 rows. table_scan_device_many guards
# it; the fused path counts in int32 and has no such cap.
FLOAT32_EXACT_ROWS = 1 << 24


def device_key_plan(table) -> tuple[int, ...]:
    """Lane count (1 or 2) per layout column for the device path. Raises
    a ``ValueError`` naming the column that exceeds the two-lane budget
    (> 60 bits) — wider schemas are served by the numpy engine."""
    parts = []
    for c in table.layout:
        bits = table.schema.bits[c]
        if bits <= WIDE_LANE_BITS:
            parts.append(1)
        elif bits <= MAX_DEVICE_COL_BITS:
            parts.append(2)
        else:
            raise ValueError(
                f"device scan path: key column {c!r} needs {bits} bits, more "
                f"than the {MAX_DEVICE_COL_BITS}-bit two-lane budget "
                f"(2 × {WIDE_LANE_BITS}-bit int32 lanes); use "
                "SortedTable.execute/execute_many (numpy) for this schema"
            )
    return tuple(parts)


def _expand_key_cols(key_cols, layout, col_parts: tuple[int, ...], n: int) -> np.ndarray:
    """int32[K_ex, n] key lanes in layout order: narrow columns as one
    lane, wide columns as (value >> 30, value & mask) pairs whose
    lexicographic order equals the numeric order."""
    rows: list[np.ndarray] = []
    for c, parts in zip(layout, col_parts):
        v = np.asarray(key_cols[c], np.int64)
        if parts == 1:
            rows.append(v.astype(np.int32))
        else:
            rows.append((v >> WIDE_LANE_BITS).astype(np.int32))
            rows.append((v & _LANE_MASK).astype(np.int32))
    return np.stack(rows) if rows else np.zeros((0, n), np.int32)


def _expand_bounds(bounds: np.ndarray, col_parts: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """Split int64[Q, K, 2] per-column bounds into int32[Q, K_ex] lane
    bounds. An exclusive upper bound splits the same way — comparing the
    lane pair lexicographically against (hi >> 30, hi & mask) is exactly
    ``value < hi``."""
    los: list[np.ndarray] = []
    his: list[np.ndarray] = []
    for j, parts in enumerate(col_parts):
        lo, hi = bounds[:, j, 0], bounds[:, j, 1]
        if parts == 1:
            los.append(lo.astype(np.int32))
            his.append(hi.astype(np.int32))
        else:
            los.append((lo >> WIDE_LANE_BITS).astype(np.int32))
            los.append((lo & _LANE_MASK).astype(np.int32))
            his.append((hi >> WIDE_LANE_BITS).astype(np.int32))
            his.append((hi & _LANE_MASK).astype(np.int32))
    return np.stack(los, axis=1), np.stack(his, axis=1)


def _check_device_rows(n: int) -> None:
    if n >= MAX_DEVICE_ROWS:
        raise ValueError(
            f"device scan path: {n} rows exceeds the int32 row-index/"
            f"count budget ({MAX_DEVICE_ROWS}); use the numpy engine "
            "for tables this large"
        )


def _capacity(n: int) -> int:
    return -(-max(n, 1) // DEVICE_BLOCK_N) * DEVICE_BLOCK_N


def build_device_state(table, value_cols=None, *, device) -> dict:
    """Materialize a table's resident tensors on ``device``: expanded
    int32 key lanes and a float32 value tile (one row per value column + a
    ones row for counts), padded to 8 lanes/rows and to a whole number of
    8192-row blocks. A fresh build holds one sorted run (``n_runs == 1``,
    device row order == host row order, ``row_map is None``)."""
    col_parts = device_key_plan(table)
    n = len(table)
    _check_device_rows(n)
    n_pad = _capacity(n)
    keys = _expand_key_cols(table.key_cols, table.layout, col_parts, n)
    k_ex = keys.shape[0]
    k_pad = max(8, -(-k_ex // 8) * 8)
    keys_p = np.zeros((k_pad, n_pad), np.int32)
    keys_p[:k_ex, :n] = keys
    if value_cols is None:
        vnames = list(table.value_cols)
    else:
        wanted = set(value_cols)
        vnames = [c for c in table.value_cols if c in wanted]
    n_value_rows = len(vnames) + 1  # + ones row
    v_pad = max(8, -(-n_value_rows // 8) * 8)
    tile = np.zeros((v_pad, n_pad), np.float32)
    for i, c in enumerate(vnames):
        tile[i, :n] = np.asarray(table.value_cols[c], np.float32)
    tile[len(vnames), :n] = 1.0  # padded rows stay 0 and are window-masked
    return {
        "device": torch.device(device),
        "col_parts": col_parts,
        "keys": torch.from_numpy(keys_p).to(device),
        "values_tile": torch.from_numpy(tile).to(device),
        "value_rows": {c: i for i, c in enumerate(vnames)},
        "ones_row": len(vnames),
        "n_value_rows": n_value_rows,
        "n_rows": n,
        "n_runs": 1,
        # start offset of each resident run (run 0 = the sorted base)
        "run_starts": (0,),
        # device row -> host row translation for "select"; None == identity
        "row_map": None,
        # rows written into the tensors' shared storage (see append)
        "_written": [n],
    }


def state_from_numpy(state: dict, device) -> dict:
    """The port's state from a reference device state whose ``keys`` and
    ``values_tile`` were converted to numpy: the same resident arrays as
    tensors on ``device`` (host bookkeeping copied as is, a view's arrays
    as numpy copies)."""
    new = {k: v for k, v in state.items() if k not in ("keys", "values_tile", "views")}
    new["device"] = torch.device(device)
    # copies: appends write into the port's tensors in place, and a CPU
    # tensor made with from_numpy would share the reference's buffer
    new["keys"] = torch.tensor(np.asarray(state["keys"], np.int32), device=device)
    new["values_tile"] = torch.tensor(
        np.asarray(state["values_tile"], np.float32), device=device
    )
    new["col_parts"] = tuple(state["col_parts"])
    new["run_starts"] = tuple(state.get("run_starts", (0,)))
    new["n_runs"] = state.get("n_runs", 1)
    if state.get("row_map") is not None:
        new["row_map"] = np.asarray(state["row_map"], np.int64)
    new["_written"] = [state["n_rows"]]
    if "views" in state:
        vs = state["views"]
        new["views"] = {
            "block_sums": np.array(vs["block_sums"], np.float32),
            "block_n": int(vs["block_n"]),
            "n_rows": int(vs["n_rows"]),
            "run_packed": [np.array(p, np.int64) for p in vs["run_packed"]],
        }
    return new


def device_state_append(state, table, run_key_cols, run_value_cols, positions) -> dict:
    """Extend a resident state with a merged write run (LSM append): the
    run's rows land right after the existing rows, and ``row_map``
    translates device row order back to host (merged) row order for
    "select". ``table`` is the *merged* table (for layout/schema),
    ``run_key_cols``/``run_value_cols`` the run sorted in the table's
    layout, ``positions`` its ``np.searchsorted`` merge positions into the
    previous packed column. Returns a new state dict.

    Where the reference writes the run with ``dynamic_update_slice`` into
    a fresh array, this writes it in place into the tensors' padding
    (slice assignment) when it fits and this state is the latest writer
    of that storage; the input state stays valid, since its reads never
    pass its own ``n_rows``. Otherwise — the run outgrows the capacity, or
    an older state is appended to a second time — the rows are copied
    into new tensors of the reference's capacity first."""
    col_parts = state["col_parts"]
    positions = np.asarray(positions, np.int64)
    m = int(positions.shape[0])
    if m == 0:
        # an empty run must not cost a run (it would push the table off
        # the single-run order for no rows at all)
        return dict(state)
    n_old = state["n_rows"]
    n_new = n_old + m
    _check_device_rows(n_new)
    keys = state["keys"]
    tile = state["values_tile"]
    cap = keys.shape[1]
    written = state["_written"]
    if n_new > cap or written[0] != n_old:
        new_cap = max(cap, _capacity(n_new))
        grown_keys = torch.zeros((keys.shape[0], new_cap), dtype=keys.dtype, device=keys.device)
        grown_tile = torch.zeros((tile.shape[0], new_cap), dtype=tile.dtype, device=tile.device)
        grown_keys[:, :n_old] = keys[:, :n_old]
        grown_tile[:, :n_old] = tile[:, :n_old]
        keys, tile = grown_keys, grown_tile
        written = [n_old]
    run_lanes = _expand_key_cols(run_key_cols, table.layout, col_parts, m)
    k_block = np.zeros((keys.shape[0], m), np.int32)
    k_block[: run_lanes.shape[0]] = run_lanes
    v_block = np.zeros((tile.shape[0], m), np.float32)
    for c, i in state["value_rows"].items():
        v_block[i] = np.asarray(run_value_cols[c], np.float32)
    v_block[state["ones_row"]] = 1.0
    keys[:, n_old:n_new] = torch.from_numpy(k_block).to(keys.device)
    tile[:, n_old:n_new] = torch.from_numpy(v_block).to(tile.device)
    written[0] = n_new
    new = dict(state)
    new.update(keys=keys, values_tile=tile, n_rows=n_new, _written=written)
    if n_old == 0:
        # appending to an empty base: the sorted run IS the base run
        new.update(n_runs=1, run_starts=(0,), row_map=None)
        return new
    # host index of old row i after the merge: i + |{j : positions[j] <= i}|;
    # run row j (sorted order) lands at positions[j] + j (np.insert layout)
    old_to_merged = np.arange(n_old, dtype=np.int64) + np.searchsorted(
        positions, np.arange(n_old, dtype=np.int64), side="right"
    )
    rm = state["row_map"]
    base = old_to_merged if rm is None else old_to_merged[rm]
    row_map = np.concatenate([base, positions + np.arange(m, dtype=np.int64)])
    new.update(
        n_runs=state.get("n_runs", 1) + 1,
        run_starts=tuple(state.get("run_starts", (0,))) + (n_old,),
        row_map=row_map,
    )
    return new


def merge_device_runs(state) -> dict:
    """Collapse a state's appended runs into one sorted run on the device:
    the merge-rank kernel gives every row its merged position and one
    ``index_copy_`` per resident tensor reorders keys and value tile (the
    reference's ``.at[:, pos].set`` scatter). The tie rule equals the host
    ``merge_run`` order, so afterwards device row order == host row order:
    ``row_map`` collapses to ``None`` and ``n_runs`` to 1. Returns a new
    state dict; the input state is untouched."""
    if state.get("n_runs", 1) <= 1:
        return dict(state)
    n = state["n_rows"]
    pos = merge_run_positions(
        state["keys"], state["run_starts"], n, n_lanes=sum(state["col_parts"])
    )
    keys = state["keys"]
    tile = state["values_tile"]
    merged_keys = torch.zeros_like(keys).index_copy_(1, pos, keys[:, :n])
    merged_tile = torch.zeros_like(tile).index_copy_(1, pos, tile[:, :n])
    new = dict(state)
    new.update(
        keys=merged_keys,
        values_tile=merged_tile,
        n_runs=1,
        run_starts=(0,),
        row_map=None,
        _written=[n],
    )
    return new


def _device_query_bounds(table, queries, col_parts, n_rows):
    """Host-side O(Q·K) operand prep for the read kernels: the residual
    per-lane bounds (exclusive hi), the slab key lane bounds (inclusive
    hi) and the per-query [start, stop) row windows. Empty queries are
    encoded as an impossible slab key (hi lanes = −1) and a (0, 0) window.
    Raises exactly where the host slab walk raises."""
    from ..core.table import _slab_col_bounds

    names = list(table.layout)
    los, his, nonempty = _slab_col_bounds(queries, names, table.schema)
    slab_lo, slab_hi = _expand_bounds(np.stack([los, his], axis=2), col_parts)
    slab_lo[~nonempty] = 0
    slab_hi[~nonempty] = -1
    bounds = np.array(
        [[q.filter_bounds(table.schema, c) for c in names] for q in queries],
        np.int64,
    )  # (Q, K, 2) — lo inclusive, hi exclusive
    res_lo, res_hi = _expand_bounds(bounds, col_parts)
    limits = np.zeros((len(queries), 2), np.int64)
    limits[:, 1] = np.where(nonempty, n_rows, 0)
    return res_lo, res_hi, slab_lo, slab_hi, limits


def device_query_operands(table, queries) -> dict:
    """The read kernels' operands for a query batch on a resident table,
    as int32 tensors on its device (one host→device copy for all):
    ``res_lo``/``res_hi``/``slab_lo``/``slab_hi`` ``[Q, K_ex]``, ``limits``
    ``[Q, 2]`` and the value-row selector ``sel`` ``[Q]`` (the ones row
    for counts and selects)."""
    state = table._device
    value_rows: dict[str, int] = state["value_rows"]
    for q in queries:
        if q.agg not in ("sum", "count", "select"):
            raise ValueError(
                f"device path supports sum/count/select aggs, got {q.agg!r}"
            )
        if q.agg == "sum":
            if q.value_col is None:
                raise ValueError("sum aggregation requires value_col")
            if q.value_col not in value_rows:
                raise KeyError(q.value_col)
    bounds = _device_query_bounds(table, queries, state["col_parts"], state["n_rows"])
    sel = np.array(
        [value_rows[q.value_col] if q.agg == "sum" else state["ones_row"] for q in queries],
        np.int32,
    )
    names = ("res_lo", "res_hi", "slab_lo", "slab_hi", "limits", "sel")
    return dict(zip(names, _upload_int32([*bounds, sel], state["device"])))


def _upload_int32(arrays, device) -> list:
    """The host arrays as int32 tensors on ``device``, in one copy."""
    flat = np.concatenate([np.ascontiguousarray(a, np.int32).ravel() for a in arrays])
    t = torch.from_numpy(flat).to(device)
    out, off = [], 0
    for a in arrays:
        out.append(t[off : off + a.size].view(a.shape))
        off += a.size
    return out


def table_execute_device_many(table, queries, *, trace=None) -> list:
    """Serve a sum/count/select batch from a table's resident tensors: one
    fused locate+scan launch computes every query's aggregate, matched
    count and slab row count (``rows_scanned``), and — only when the batch
    contains selects with matches — one compaction launch emits the
    matched row indices, sized by the first launch's counts. Returns
    ``list[ScanResult]`` in batch order: counts, rows and indices equal to
    the numpy engine's, sums to float32 accumulation. On appended run
    stacks ``row_map`` translates select indices to host row order.

    ``trace`` (an open span, or None) wraps each launch wall, result fetch
    included, as ``kernel.scan_launch`` / ``kernel.select_compact``."""
    from ..core.table import ScanResult

    queries = list(queries)
    if not queries:
        return []
    state = getattr(table, "_device", None)
    if state is None:
        raise ValueError("table_execute_device_many needs a device-resident table")
    col_parts = state["col_parts"]
    d = device_query_operands(table, queries)
    ks = (
        trace.child(
            "kernel.scan_launch", queries=len(queries), n_rows=int(state["n_rows"]),
            fused=True,
        )
        if trace is not None
        else None
    )
    sums, matched, slab_rows = scan_agg_locate(
        state["keys"], state["values_tile"], d["res_lo"], d["res_hi"], d["slab_lo"],
        d["slab_hi"], d["limits"], d["sel"], col_parts=col_parts,
        n_vals=state["n_value_rows"],
    )
    sums = sums.cpu().numpy()
    matched = matched.cpu().numpy().astype(np.int64)
    slab_rows = slab_rows.cpu().numpy().astype(np.int64)
    if ks is not None:
        ks.end()

    selected: dict[int, np.ndarray] = {}
    sel_idx = [i for i, q in enumerate(queries) if q.agg == "select"]
    for i in sel_idx:
        if matched[i] == 0:
            selected[i] = np.empty(0, np.int64)
    sel_idx = [i for i in sel_idx if matched[i] > 0]
    if sel_idx:
        kc = (
            trace.child("kernel.select_compact", queries=len(sel_idx))
            if trace is not None
            else None
        )
        idx = torch.tensor(sel_idx, dtype=torch.int64, device=state["device"])
        flat = select_compact(
            state["keys"], d["res_lo"][idx], d["res_hi"][idx], d["limits"][idx],
            matched[sel_idx], col_parts=col_parts,
        ).cpu().numpy().astype(np.int64)
        rm = state["row_map"]
        off = 0
        for i in sel_idx:
            rows = flat[off : off + int(matched[i])]
            off += int(matched[i])
            if rm is not None:
                # appended runs: device row order -> host (merged) order;
                # numpy emits ascending indices
                rows = np.sort(rm[rows])
            selected[i] = rows
        if kc is not None:
            kc.end()

    out = []
    for i, q in enumerate(queries):
        value = float(sums[i]) if q.agg == "sum" else float(matched[i])
        out.append(ScanResult(value, int(slab_rows[i]), int(matched[i]), selected.get(i)))
    return out


# -- the row-slab read path ------------------------------------------------------


def scan_agg(keys, values, col_lo, col_hi, slab) -> torch.Tensor:
    """float32 ``[2]`` = (masked sum of ``values``, count) over the row
    slab ``[slab[0], slab[1])`` with per-column residual bounds ``[lo,
    hi)``: the Q = 1 launch of the rows-outer scan, on ``keys``' device."""
    sel = torch.zeros(1, dtype=torch.int32, device=keys.device)
    out = scan_agg_rowstream(
        keys, values.reshape(1, -1), col_lo.reshape(1, -1), col_hi.reshape(1, -1),
        slab.reshape(1, 2), sel, col_parts=(1,) * col_lo.numel(),
    )
    return out[0]


def scan_agg_batched(
    keys, values, col_lo, col_hi, slabs, value_sel=None, *, col_parts=None,
    grid: str = "rows_outer",
) -> torch.Tensor:
    """float32 ``[Q, 2]``: per query, (masked sum, count) over its slab,
    for a batch sharing one replica's columns, on ``keys``' device.

    ``grid="rows_outer"`` (default) is :func:`scan_agg_rowstream`:
    ``values`` may be a ``[V, N]`` tile with ``value_sel`` routing each
    query to its row, and ``col_parts`` marks wide (two-lane) columns.
    ``grid="queries_outer"`` is :func:`scan_agg_qgrid`, the benchmark
    baseline: one value row and narrow columns only."""
    if grid == "queries_outer":
        if values.dim() != 1:
            raise ValueError("queries_outer grid supports a single value row")
        if value_sel is not None or (col_parts and any(p != 1 for p in col_parts)):
            raise ValueError(
                "queries_outer grid supports neither value selectors nor wide columns"
            )
        return scan_agg_qgrid(keys, values, col_lo, col_hi, slabs)
    if grid != "rows_outer":
        raise ValueError(f"unknown grid {grid!r}")
    if values.dim() == 1:
        values = values[None, :]
    q, k_ex = col_lo.shape
    if value_sel is None:
        value_sel = torch.zeros(q, dtype=torch.int32, device=keys.device)
    if col_parts is None:
        col_parts = (1,) * k_ex
    return scan_agg_rowstream(keys, values, col_lo, col_hi, slabs, value_sel, col_parts=col_parts)


def table_scan_device(table, query) -> tuple[float, float]:
    """``table_scan_device_many`` of one sum or count query: ``(value,
    count)``."""
    (out,) = table_scan_device_many(table, [query])
    return out


def table_scan_device_many(
    table, queries, *, slabs=None, grid: str = "rows_outer"
) -> list[tuple[float, float]]:
    """Sum and count queries against one replica over row slabs, in one
    launch: ``[(value, count)]`` in batch order.

    The table must be device-resident and hold a single sorted run, since
    the slabs index the sorted order. ``slabs`` takes ``slab_many`` output a caller already has; without
    it, ``table.slab_many`` locates them (the k-ary search kernel on a
    resident table). ``grid="rows_outer"`` serves any mix of sums over
    value columns and counts through a per-query value-row selector;
    ``grid="queries_outer"`` (the baseline) takes uniform-aggregation,
    narrow-key batches only."""
    queries = list(queries)
    if not queries:
        return []
    if table.n_rows > FLOAT32_EXACT_ROWS:
        raise ValueError(
            f"table has {table.n_rows} rows but the float32 count lane of "
            f"table_scan_device_many is exact only to {FLOAT32_EXACT_ROWS} "
            "matches; use table_execute_device_many (int32 counts)"
        )
    for q in queries:
        if q.agg not in ("sum", "count"):
            raise ValueError(f"device path supports sum/count aggs, got {q.agg!r}")
        if q.agg == "sum" and q.value_col is None:
            raise ValueError("sum aggregation requires value_col")
    state = getattr(table, "_device", None)
    if state is None:
        raise ValueError("table_scan_device_many needs a device-resident table")
    if state.get("n_runs", 1) > 1:
        raise ValueError(
            "device state holds appended write runs (device row order is "
            "not sorted); row-slab scans need a single sorted run — use "
            "table_execute_device_many or compact_runs()"
        )
    col_parts = state["col_parts"]
    if slabs is None:
        slabs = table.slab_many(queries)
    value_rows: dict[str, int] = state["value_rows"]
    sel = np.array(
        [value_rows[q.value_col] if q.agg == "sum" else state["ones_row"] for q in queries],
        np.int32,
    )
    bounds = np.array(
        [[q.filter_bounds(table.schema, c) for c in table.layout] for q in queries],
        np.int64,
    )  # (Q, K, 2) — lo inclusive, hi exclusive
    lo, hi = _expand_bounds(bounds, col_parts)
    slabs32 = np.asarray(slabs, np.int64).astype(np.int32)
    if grid == "queries_outer":
        if len(set(sel)) > 1 or any(p != 1 for p in col_parts):
            raise ValueError("queries_outer grid requires a uniform-agg, narrow-key batch")
    elif grid != "rows_outer":
        raise ValueError(f"unknown grid {grid!r}")
    t_lo, t_hi, t_slabs, t_sel = _upload_int32([lo, hi, slabs32, sel], state["device"])
    if grid == "queries_outer":
        out = scan_agg_qgrid(state["keys"], state["values_tile"][int(sel[0])], t_lo, t_hi, t_slabs)
    else:
        out = scan_agg_rowstream(
            state["keys"], state["values_tile"], t_lo, t_hi, t_slabs, t_sel,
            col_parts=col_parts, n_vals=state["n_value_rows"],
        )
    out = out.cpu().numpy()
    return [
        (float(s) if q.agg == "sum" else float(c), float(c))
        for q, (s, c) in zip(queries, out)
    ]


def table_slab_locate_many(table, queries) -> np.ndarray:
    """Device-side ``SortedTable.slab_many``: int64 ``[Q, 2]`` row slabs
    from the k-ary search kernel (:func:`slab_locate`) over the resident
    key lanes. The resident tensors must hold a single sorted run: with
    appended runs the device row order is not the table's."""
    queries = list(queries)
    state = getattr(table, "_device", None)
    if state is None:
        raise ValueError("table_slab_locate_many needs a device-resident table")
    if state.get("n_runs", 1) > 1:
        raise ValueError(
            "device state holds appended write runs; slab ranks need a "
            "single sorted run — use compact_runs()"
        )
    col_parts = state["col_parts"]
    _, _, slab_lo, slab_hi, limits = _device_query_bounds(
        table, queries, col_parts, state["n_rows"]
    )
    t_lo, t_hi, t_lim = _upload_int32([slab_lo, slab_hi, limits], state["device"])
    out = slab_locate(state["keys"], t_lo, t_hi, t_lim)
    return out.cpu().numpy().astype(np.int64)
