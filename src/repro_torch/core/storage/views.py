"""Materialized per-slab aggregate views — O(blocks touched) reads.

Each device-resident replica can carry a *view*: per-block partial sums
of its resident value tile (one float32 partial per ``DEVICE_BLOCK_N``
row block per value row, in the replica's own sort order —
``repro_torch.kernels.block_agg``). A view-eligible range aggregate is
then answered as

    interior blocks   → stored partials (one lookup each)
    boundary blocks   → one masked rescan per window edge
    accumulation      → sequential float32 fold in ascending block
                        order (``np.cumsum``)

instead of the fused O(N) device stream. The Cost Evaluator ranks a view
hit with a capped row estimate (``VIEW_ROWS_CAP``).

**Eligibility** (:func:`query_view_eligible`): sum/count aggregates
whose filters the slab walk consumes on this replica's layout — an
equality prefix plus at most one range, nothing filtered after the
prefix opens. For those queries residual matching equals slab membership
equals a row-index window per sorted run, so the answer is a pure
function of the windows and the stored partials. "select" and
residual-filtered queries keep the fused path.

**Maintenance** follows the table's storage moves:

* flush — ``SortedTable.merge_run`` extends the partials O(run)
  (:func:`extend_views_state`: only blocks at or after the append point
  are refolded) and appends the run's packed keys to the per-run window
  index;
* compaction — ``compact_runs`` permutes the resident tensors into one
  sorted run, so the view is rebuilt whole (:func:`build_views_state`);
  views are *derived* state, and :func:`verify_views` checks them against
  a fresh fold of the resident tensors.

The view state lives inside the table's ``_device`` dict under
``"views"``, in the reference's shape::

    {"block_sums": np.float32[V_pad, n_blocks],   # stored partials
     "block_n": int,                              # DEVICE_BLOCK_N
     "n_rows": int,                               # rows covered
     "run_packed": [np.int64[...], ...]}          # per-run sorted keys

``run_packed`` mirrors the device run stack (``run_starts``): slab
windows per run come from two host ``searchsorted`` calls on each run's
sorted packed keys — O(R log n) per query, R = resident runs.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "VIEW_AGGS",
    "VIEW_ROWS_CAP",
    "query_view_eligible",
    "view_eligible_matrix",
    "build_views_state",
    "extend_views_state",
    "verify_views",
    "plan_view_batch",
    "serve_view_many",
]

VIEW_AGGS = ("sum", "count")

# Planning-time row estimate for a view hit: at most two boundary blocks
# are rescanned per (query, run). The Cost Evaluator feeds min(estimated
# rows, cap) through the same Eq 1-2 cost polynomial, so a view-serving
# replica outranks a full scan exactly when the scan would stream more
# than the cap. Shared by the scalar and batched cost paths.
VIEW_ROWS_CAP = 2 * 8192  # 2 * kernels.ops.DEVICE_BLOCK_N


def query_view_eligible(query, layout) -> bool:
    """True when ``query`` is answerable from ``layout``'s view alone: a
    sum/count whose filters form an equality prefix plus at most one
    range in this layout — the slab walk consumes every filter, no
    residual predicate remains, and matched rows == slab rows == the
    row-index window. Filters *after* the prefix opens keep the query on
    the fused path (value-column residency is the caller's check)."""
    if query.agg not in VIEW_AGGS:
        return False
    open_range = False
    for col in layout:
        f = query.filters.get(col)
        if open_range:
            if f is not None:
                return False
        elif f is None or not f.is_equality:
            open_range = True
    return True


def view_eligible_matrix(layouts, queries) -> np.ndarray:
    """bool[R, Q] view eligibility per (replica layout, query) — the
    batched planning twin of :func:`query_view_eligible` (same walk per
    cell, so scalar and batched routing agree). Callers skip select-only
    batches before calling this."""
    out = np.zeros((len(layouts), len(queries)), dtype=bool)
    for k, layout in enumerate(layouts):
        for j, q in enumerate(queries):
            out[k, j] = query_view_eligible(q, layout)
    return out


def _table_block_sums(state, first_block: int = 0) -> np.ndarray:
    """float32 ``[V_pad, n_blocks - first_block]`` partials of the state's
    live value rows over its live rows (pad rows stay 0.0)."""
    from ...kernels.block_agg import block_sums
    from ...kernels.ops import DEVICE_BLOCK_N

    tile = state["values_tile"]
    n_vals = int(state["n_value_rows"])
    part = block_sums(
        tile, n_rows=int(state["n_rows"]), block_n=DEVICE_BLOCK_N,
        first_block=first_block, n_vals=n_vals, n_key_lanes=sum(state["col_parts"]),
    )
    out = np.zeros((tile.shape[0], part.shape[1]), np.float32)
    out[:n_vals] = part.cpu().numpy()
    return out


def build_views_state(state, packed) -> dict:
    """Fresh view over a device state: fold the value tile into per-block
    partials and index each resident run's packed keys. ``packed`` is the
    table's host (merged) order; on a run stack (a scrub heal between
    compactions) run ``r``'s keys are the host keys of its device rows
    ``row_map[run_starts[r]:run_starts[r + 1]]``, each run sorted on its
    own. (The reference indexes the merged keys as one run, which is right
    only for a single run: CREATE, recovery, post-compaction.)"""
    from ...kernels.ops import DEVICE_BLOCK_N

    n = int(state["n_rows"])
    packed = np.asarray(packed, np.int64)[:n]
    row_map = state.get("row_map")
    if row_map is None:
        runs = [packed.copy()]
    else:
        bounds = list(state["run_starts"]) + [n]
        runs = [packed[row_map[a:b]] for a, b in zip(bounds[:-1], bounds[1:])]
    return {
        "block_sums": _table_block_sums(state),
        "block_n": DEVICE_BLOCK_N,
        "n_rows": n,
        "run_packed": runs,
    }


def extend_views_state(views, state, run_packed, n_old: int) -> dict:
    """O(run) view extension for a flush append: the run's rows landed at
    ``[n_old, n_rows)`` of the resident tensors, so only blocks from
    ``n_old // block_n`` on changed — refold those (``first_block``, no
    copy of the tile), keep the earlier partials, and append the run's
    sorted packed keys as a new window index. Returns a fresh dict (the
    pre-merge table keeps its view)."""
    from ...kernels.ops import DEVICE_BLOCK_N

    bn = int(views["block_n"])
    if n_old <= 0:
        # appending to an empty base collapses to a fresh single-run
        # build (device_state_append keeps it single-run too)
        return build_views_state(state, run_packed)
    b0 = n_old // bn
    tail = _table_block_sums(state, first_block=b0)
    return {
        "block_sums": np.concatenate([views["block_sums"][:, :b0], tail], axis=1),
        "block_n": DEVICE_BLOCK_N,
        "n_rows": int(state["n_rows"]),
        "run_packed": list(views["run_packed"]) + [np.asarray(run_packed, np.int64).copy()],
    }


def verify_views(table) -> bool:
    """True when the table's stored view partials still equal a fresh fold
    of the resident tensors (views are derived state — the tensors are
    ground truth). Missing or shape-drifted view state also fails."""
    state = getattr(table, "_device", None)
    if state is None or "views" not in state:
        return False
    vs = state["views"]
    if int(vs["n_rows"]) != int(state["n_rows"]):
        return False
    if sum(p.shape[0] for p in vs["run_packed"]) != int(state["n_rows"]):
        return False
    fresh = _table_block_sums(state)
    stored = np.asarray(vs["block_sums"])
    return stored.shape == fresh.shape and bool(np.array_equal(stored, fresh))


def _run_windows(vs, bounds) -> tuple[np.ndarray, np.ndarray]:
    """Global row-index windows int64[Q, R] (lo inclusive, hi exclusive)
    of each query's slab in each resident run: two vectorized
    searchsorteds per run over its sorted packed keys (``bounds`` comes
    from ``slab_bounds_many`` — hi inclusive, so ``side="right"`` matches
    the fused kernel's ``<=`` rank)."""
    n_q = bounds.shape[0]
    runs = vs["run_packed"]
    wlo = np.empty((n_q, len(runs)), np.int64)
    whi = np.empty((n_q, len(runs)), np.int64)
    start = 0
    for r, p in enumerate(runs):
        wlo[:, r] = start + np.searchsorted(p, bounds[:, 0], side="left")
        whi[:, r] = start + np.searchsorted(p, bounds[:, 1], side="right")
        start += int(p.shape[0])
    return wlo, whi


def _block_plan(windows, bn: int, n_rows: int):
    """Touched blocks of one query's disjoint row windows, ascending, as
    ``(blocks int64[B], interior bool[B])``: a block is interior when the
    windows cover every live row of it. A window's inner blocks are
    covered whole by that window alone; only its two edge blocks can be
    shared with another window, so coverage is summed over edges only."""
    inner: list[np.ndarray] = []
    edge_cov: dict[int, int] = {}
    for a, b in windows:
        fa, fb = a // bn, (b - 1) // bn
        for blk in {fa, fb}:
            edge_cov[blk] = edge_cov.get(blk, 0) + min(b, (blk + 1) * bn) - max(a, blk * bn)
        if fb - fa > 1:
            inner.append(np.arange(fa + 1, fb, dtype=np.int64))
    edges = np.array(sorted(edge_cov), np.int64)
    real = np.minimum((edges + 1) * bn, n_rows) - edges * bn
    cov = np.array([edge_cov[int(e)] for e in edges], np.int64)
    blocks = np.concatenate(inner + [edges]) if inner else edges
    interior = np.concatenate([np.ones(sum(len(i) for i in inner), bool), cov == real])
    order = np.argsort(blocks, kind="stable")
    return blocks[order], interior[order]


def plan_view_batch(table, queries) -> dict:
    """The host plan of :func:`serve_view_many` for a batch of
    view-eligible queries on ``table``: ``matched`` int64[Q] (per query,
    the rows of its run windows), ``plans`` (per sum query ``i``: its
    touched blocks ascending, whether each is interior, and for the rest
    the index of its boundary pair), the boundary pairs' operands
    ``pair_sel``/``pair_block`` int64[P] and ``pair_lo``/``pair_hi``
    int64[P, R] (the query's run windows, empty slots ``lo == hi``), and
    ``boundary_rows`` (live rows of the boundary blocks)."""
    from ..table import slab_bounds_many

    state = table._device
    vs = state["views"]
    bn = int(vs["block_n"])
    n_rows = int(state["n_rows"])
    bounds = slab_bounds_many(queries, table.layout, table.schema)
    wlo, whi = _run_windows(vs, bounds)
    lens = np.maximum(whi - wlo, 0)
    value_rows = state["value_rows"]
    plans: dict[int, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    pair_sel: list[np.ndarray] = []
    pair_block: list[np.ndarray] = []
    pair_q: list[np.ndarray] = []
    boundary_rows = 0
    n_pairs = 0
    for i, q in enumerate(queries):
        if q.agg != "sum":
            continue
        windows = [(int(wlo[i, r]), int(whi[i, r])) for r in range(lens.shape[1]) if lens[i, r] > 0]
        blocks, interior = _block_plan(windows, bn, n_rows)
        edge = blocks[~interior]
        pair_idx = np.full(blocks.shape, -1, np.int64)
        pair_idx[~interior] = n_pairs + np.arange(edge.shape[0])
        n_pairs += edge.shape[0]
        pair_sel.append(np.full(edge.shape, value_rows[q.value_col], np.int64))
        pair_block.append(edge)
        pair_q.append(np.full(edge.shape, i, np.int64))
        boundary_rows += int((np.minimum((edge + 1) * bn, n_rows) - edge * bn).sum())
        plans[i] = (blocks, interior, pair_idx)
    pq = np.concatenate(pair_q) if pair_q else np.zeros(0, np.int64)
    pair_lo = wlo[pq]
    return {
        "matched": lens.sum(axis=1),
        "plans": plans,
        "pair_sel": np.concatenate(pair_sel) if pair_sel else np.zeros(0, np.int64),
        "pair_block": np.concatenate(pair_block) if pair_block else np.zeros(0, np.int64),
        "pair_lo": pair_lo,
        "pair_hi": np.maximum(whi[pq], pair_lo),
        "boundary_rows": boundary_rows,
    }


def serve_view_many(table, queries, *, trace=None, view_stats=None) -> list:
    """Answer a batch of view-eligible queries from the table's view: per
    query, locate its per-run row windows (host searchsorted), classify
    touched blocks as interior (every live row covered → the stored
    partial) or boundary (one masked rescan, all of the batch's in one
    ``boundary_block_sums`` launch), and fold the partials sequentially in
    float32, ascending block order — bits equal to the fused scan's (see
    ``kernels.block_agg``).

    ``trace`` records one ``view.serve`` span; ``view_stats`` (a dict, or
    None) accumulates ``hits`` (queries answered) and ``boundary_rows``
    (live rows of the rescanned blocks — the residual scan a view hit
    still pays)."""
    from ...kernels.block_agg import boundary_block_sums
    from ..table import ScanResult

    state = table._device
    queries = list(queries)
    sp = trace.child("view.serve", queries=len(queries)) if trace is not None else None
    plan = plan_view_batch(table, queries)
    n_pairs = int(plan["pair_sel"].shape[0])
    bvals = np.empty(0, np.float32)
    if n_pairs:
        bvals = (
            boundary_block_sums(
                state["values_tile"], plan["pair_sel"], plan["pair_block"], plan["pair_lo"],
                plan["pair_hi"], n_rows=int(state["n_rows"]), block_n=int(state["views"]["block_n"]),
                n_vals=state["n_value_rows"], n_key_lanes=sum(state["col_parts"]),
            )
            .cpu()
            .numpy()
        )

    block_sums = state["views"]["block_sums"]
    value_rows = state["value_rows"]
    out: list = []
    for i, q in enumerate(queries):
        m = int(plan["matched"][i])
        if q.agg == "count":
            out.append(ScanResult(float(m), m, m))
            continue
        blocks, interior, pair_idx = plan["plans"][i]
        if not blocks.size:
            out.append(ScanResult(0.0, m, m))
            continue
        parts = block_sums[value_rows[q.value_col], blocks].astype(np.float32)
        parts[~interior] = bvals[pair_idx[~interior]]
        # np.cumsum is a strictly sequential fold (unlike np.sum's pairwise
        # tree) — the fused scan's block-order accumulation
        acc = np.cumsum(parts, dtype=np.float32)[-1]
        out.append(ScanResult(float(acc), m, m))

    boundary_rows = plan["boundary_rows"]
    if view_stats is not None:
        view_stats["hits"] = view_stats.get("hits", 0) + len(queries)
        view_stats["boundary_rows"] = view_stats.get("boundary_rows", 0) + boundary_rows
    if sp is not None:
        sp.end(boundary_rows=boundary_rows, boundary_blocks=n_pairs)
    return out
