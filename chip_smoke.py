#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives
the port's two read paths at TPC-H scale factor 5 (7.5 M ``orders`` rows,
replication factor 3): CREATE a device-resident HR column family, serve
``read_many`` and ``read`` batches, write through commit log, memtable,
flush and append, and compact the run stack on the device; then the same
on a second column family with materialized per-slab views, whose
eligible sums and counts are served from per-block partials. It holds
every kernel of both paths against its plain PyTorch version on the same
CUDA tensors, at the paths' shapes, and times both.

Phases, each asserting (a failure exits non-zero and prints no result):
  1. setup      card name and power limit, kernel build
  2. kernels    the compaction's merge-rank kernel on the 9-run stack the
                write phase folds (vs plain and the host merge order) and
                on a stack of that shape whose appended keys all equal
                keys of other runs (vs plain); the histogram kernel on a
                write batch's three key columns, one by one and in the one
                batched launch the statistics refresh makes, vs plain and
                np.bincount (repro_torch.bench.write_kernels); times by
                CUDA events and under torch.profiler, bounds,
                torch.bincount in turns, an empty launch of the same grid
  3. create     HREngine(n_nodes=6), HR layouts from HRCA over Q1/Q2
  4. reads      4 read_many batches of 256 (1/2 sums, 1/4 counts, 1/4
                selects), one repeated batch (result-cache hits), a batch
                of wide queries and 16 scalar reads; 64 + 8 answers held
                against a brute-force numpy pass over the generated rows;
                select_compact on the replica groups of the first batch
                vs its plain version (single runs)
  5. row_slab   the row-slab read path on the three replicas while each
                holds one sorted run, its launch counts from 0: per replica,
                a fresh batch of 256 (128 sums, 128 counts) located by
                slab_many (the k-ary search kernel, equal to the host
                searchsorted), scanned by table_scan_device_many on both
                grids (queries outer on the 128 sums) and with slabs=None,
                and one Q = 1 table_scan_device; every answer against the
                brute-force oracle. Then each of the three kernels against
                its plain version on the same CUDA tensors (slabs equal,
                counts equal, sums within rtol 1e-5 / atol 1e-3), timed
                beside its bound and, for slab_locate, torch.searchsorted
                on the packed key, the two timed in turns (kernel,
                library, library, kernel) by CUDA events and under
                torch.profiler (bench.select_slab.slab_locate_turns); the
                k-ary search's dependent rounds, one dependent load's
                latency (bench.select_slab.load_latency_ns) and the
                latency bound they give go into the row_slab line
  6. batched_read  repro_torch.bench.batched_read.run_device on one
                replica of the SF 5 rows, batch sizes 16, 64 and 256: the
                numpy, qgrid, rowgrid, rowgrid-over-device-slabs and fused
                engines, cross-checked, then timed in queries per second
  7. writes     8 write-through writes of 20,000 rows (the 8th trips the
                compaction policy's max_runs), resident state vs a fresh
                build, 2 more writes, reads checked again over all rows;
                the main path's launches: merge_run_positions 3 (one
                compaction a replica), ecdf_hist 10 (one a write);
                on the appended run stacks slab_many launches nothing and
                table_scan_device_many raises
  8. groups     one fresh read_many batch of 256; then the fused scan and
                the select compaction on each replica group that batch
                formed (the launches read_many makes), each vs its plain
                version: counts and indices equal, sums within rtol 1e-5 /
                atol 1e-3; per-group times and bounds, summed per batch
                (the fused scan's bound counts the (query, tile) pairs its
                skip rule leaves live, live_tile_pairs; their share per
                group goes into the read_layer line); the select
                compaction's three passes timed apart under torch.profiler
                (bench.select_slab.select_group), its bound counted from
                the (query, segment) pairs its skip rule leaves live
                (select_live_pairs); those pairs and the (query, block)
                pairs holding a match go into the read_layer line
  9. views      CREATE "orders_v" on the same rows with views=True (same
                layouts, every view verified), the same 4 batches, the
                wide batch and scalar reads (most sums and counts served
                by the views), the same 10 writes (the compaction rebuilds
                every view, the 2 writes after it leave runs, so view reads
                rescan boundary blocks across several run windows); every
                answer against the brute-force oracle and every
                view-served answer against the fused kernel on the same
                replica table, bit for bit, before the writes, after the
                compaction and after the last write; select_compact vs its
                plain version on the replica groups of the first batch and
                of the batch after the writes (run stacks)
  10. view_kernels  block_sums on a full SF 5 tile (whole and a flush's
                tail) and boundary_block_sums on the pairs one fresh batch
                forms, each vs its plain version; block_sums also bit for
                bit vs the contract's in-block order written out in
                PyTorch (block_partials_card_order); times, bounds, the
                library yardstick; then the bit identity of view and fused
                scan, and of block_sums and the card order, on a table
                whose schema shrinks the staging tile
  11. breakdown  one fresh batch on each column family: the engine's spans
                on the host clock, and a second under torch.profiler (the
                fused scan's scan_partials and scan_fold apart)
Every kernel wrapper's launch count is set to 0 just before phase 3 and
read after phase 7, just before phase 5 and after it, just before phase 6
and after it, and just before phase 9 and after it; phases 5 and 6 count
apart and their counts are restored after them, so the main path's counts
hold phases 3, 4 and 7. Each kernel must have launched on its path (the
row-slab kernels on phase 5's, the view kernels on phase 9's); the row-slab
line reports phase 6's launches beside phase 5's.
The oracle is a brute-force pass over every generated row on the card
(plain PyTorch masks and float64 sums); checks that launch kernels
(verify_views, the fused comparisons, the select checks) leave the
launch counts untouched. The read_layer line's select_checks hold the
select checks of both column families before and after the writes.

The standard output ends with the kernels line, the per-phase wall times
and per-layer numbers, the views line, the write-kernels line (phase 2's
measurements in full), the row-slab line, the batched-read line, the
card's name and power limit, and ``{"ok": true, "device": ...}``.

Run from the root of a checkout: ``python3 chip_smoke.py``
(``--sf`` and ``--seed`` change the scale factor and the data seed).
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

RTOL, ATOL = 1e-5, 1e-3
BATCH = 256
WRITE_ROWS = 20_000

# kernel name -> (source in the repo, the TPU kernel it replaces)
KERNEL_INFO = {
    "scan_agg_locate": (
        "src/repro_torch/csrc/scan_locate.cu",
        "src/repro/kernels/slab_locate.py:255",
    ),
    "select_compact": (
        "src/repro_torch/csrc/select_compact.cu",
        "src/repro/kernels/slab_locate.py:449",
    ),
    "merge_run_positions": (
        "src/repro_torch/csrc/merge_rank.cu",
        "src/repro/kernels/merge_runs.py:55",
    ),
    "ecdf_hist": (
        "src/repro_torch/csrc/ecdf_hist.cu",
        "src/repro/kernels/ecdf_hist.py:26",
    ),
    "block_sums": (
        "src/repro_torch/csrc/block_sums.cu",
        "src/repro/kernels/block_agg.py:52",
    ),
    "boundary_block_sums": (
        "src/repro_torch/csrc/block_sums.cu",
        "src/repro/kernels/block_agg.py:104",
    ),
    "slab_locate": (
        "src/repro_torch/csrc/slab_rank.cu",
        "src/repro/kernels/slab_locate.py:155",
    ),
    "scan_agg_rowstream": (
        "src/repro_torch/csrc/scan_agg.cu",
        "src/repro/kernels/scan_agg.py:85",
    ),
    "scan_agg_qgrid": (
        "src/repro_torch/csrc/scan_agg.cu",
        "src/repro/kernels/scan_agg.py:279",
    ),
}
# the kernels each path must launch
ORDERS_KERNELS = ("scan_agg_locate", "select_compact", "merge_run_positions", "ecdf_hist")
VIEW_KERNELS = ("block_sums", "boundary_block_sums")
ROW_SLAB_KERNELS = ("slab_locate", "scan_agg_rowstream", "scan_agg_qgrid")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    from repro_torch.bench.fused_scan import card_line

    return card_line()


class Phases:
    """Wall time of each phase, between CUDA events on the current stream
    (the phase's device work included: each phase ends synchronized)."""

    def __init__(self):
        self.ms: dict[str, float] = {}

    def run(self, name: str, fn, *args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        end.synchronize()
        self.ms[name] = start.elapsed_time(end)
        print(f"phase {name}: ok, {self.ms[name]:.1f} ms", flush=True)
        return out


def time_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` between CUDA events over ``reps`` calls after one
    warm-up (``bench.fused_scan.events_ms``)."""
    from repro_torch.bench.fused_scan import events_ms

    return events_ms(fn, reps)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """The least time for the work, and what sets it
    (``bench.fused_scan.bound_ms``: one H100 SXM's published peaks)."""
    from repro_torch.bench.fused_scan import bound_ms

    return bound_ms(bytes_moved, ops)


# -- workload -----------------------------------------------------------------


def read_batches(n_rows: int, seed: int):
    """4 batches of 256 drawn from the paper's Q1/Q2 templates: per batch
    128 sums, then 64 counts and 64 selects with the same filters."""
    import repro_torch.core as T
    import repro_torch.core.tpch  # noqa: F401  (T.tpch)

    wl = T.tpch.q1_q2_workload(n_instances=4 * BATCH, seed=seed + 2, n_rows=n_rows)
    batches = []
    for b in range(4):
        qs = wl.queries[b * BATCH : (b + 1) * BATCH]
        batch = list(qs[: BATCH // 2])
        batch += [T.Query(filters=q.filters, agg="count") for q in qs[BATCH // 2 : 3 * BATCH // 4]]
        batch += [T.Query(filters=q.filters, agg="select") for q in qs[3 * BATCH // 4 :]]
        batches.append(batch)
    return batches


def wide_batch():
    """Queries that match thousands of rows spread over the table."""
    import repro_torch.core as T

    R, E = T.Range, T.Eq
    return [
        T.Query(filters={"custkey": R(0, 200)}, agg="select"),
        T.Query(filters={"clerk": E(7)}, agg="select"),
        T.Query(filters={"orderdate": R(100, 101)}, agg="select"),
        T.Query(filters={"clerk": R(5, 6), "orderdate": R(0, 1200)}, agg="select"),
        T.Query(filters={"custkey": R(1000, 90_000)}, agg="sum", value_col="totalprice"),
        T.Query(filters={"clerk": R(0, 40)}, agg="count"),
        T.Query(filters={"orderdate": R(2000, 2406)}, agg="sum", value_col="shippriority"),
        T.Query(filters={"custkey": R(5, 5)}, agg="sum", value_col="totalprice"),  # empty
    ]


# -- brute-force oracle -------------------------------------------------------------


class Oracle:
    """Every row a column family holds, as columns on the card: key
    columns int64, value columns float32 (as stored) widened to float64
    for the sums."""

    def __init__(self, key_cols, value_cols, dev):
        self.keys = {c: torch.from_numpy(np.ascontiguousarray(v, np.int64)).to(dev) for c, v in key_cols.items()}
        self.vals = {
            c: torch.from_numpy(np.asarray(v).astype(np.float32).astype(np.float64)).to(dev)
            for c, v in value_cols.items()
        }

    def answer(self, q, schema) -> tuple[int, float]:
        mask = None
        for col, f in q.filters.items():
            lo, hi = f.bounds(schema, col)
            v = self.keys[col]
            m = (v >= lo) & (v < hi)
            mask = m if mask is None else mask & m
        if mask is None:
            mask = torch.ones_like(next(iter(self.keys.values())), dtype=torch.bool)
        n_match = int(mask.sum())
        total = float(self.vals[q.value_col][mask].sum()) if q.agg == "sum" else 0.0
        return n_match, total


def check_answers(eng, cf_name, pairs, oracle, label):
    """Each (query, (ScanResult, ReadReport)) against the oracle over every
    row the column family holds: counts and rows_matched exact, sums within
    tolerance, rows_scanned equal to the serving replica's host slab and
    select indices equal to its host scan."""
    cf = eng.column_families[cf_name]
    handles = {r.replica_id: r for r in cf.replicas}
    for i, (q, (res, rep)) in enumerate(pairs):
        n_match, want = oracle.answer(q, cf.schema)
        what = f"{label} query {i} ({q.agg}, {q.filters})"
        check(res.rows_matched == n_match, f"{what}: rows_matched {res.rows_matched} != {n_match}")
        table = eng._table(cf, handles[rep.replica_id])
        lo, hi = table.slab(q)
        check(res.rows_scanned == hi - lo, f"{what}: rows_scanned {res.rows_scanned} != {hi - lo}")
        if q.agg == "count":
            check(res.value == n_match, f"{what}: count {res.value} != {n_match}")
        elif q.agg == "sum":
            check(
                math.isclose(res.value, want, rel_tol=RTOL, abs_tol=ATOL),
                f"{what}: sum {res.value} != {want}",
            )
        else:
            host = table._scan_slab(q, lo, hi).selected
            check(
                res.selected is not None and np.array_equal(res.selected, host),
                f"{what}: select indices differ from the host scan",
            )


def uncounted(fn, *args):
    """``fn(*args)`` with every kernel's launch count restored afterwards:
    launches a check makes are not the main path's."""
    import repro_torch.kernels as K

    saved = {name: k.launches for name, k in K.KERNELS.items()}
    try:
        return fn(*args)
    finally:
        for name, k in K.KERNELS.items():
            k.launches = saved[name]


def own_counts(fn, *args):
    """``fn(*args)`` with every kernel's launch count from 0, the counts
    before restored afterwards: a path whose launches are not the main
    path's. Returns the result and the launches ``fn`` made."""
    import repro_torch.kernels as K

    saved = {name: k.launches for name, k in K.KERNELS.items()}
    for k in K.KERNELS.values():
        k.launches = 0
    try:
        out = fn(*args)
        return out, {name: k.launches for name, k in K.KERNELS.items()}
    finally:
        for name, k in K.KERNELS.items():
            k.launches = saved[name]


def check_view_bits(eng, cf_name, pairs, label) -> int:
    """Every view-served answer (a sum or count eligible for the view of
    the replica that answered it) against the fused kernel on that replica
    table: value equal under float ``==``, every other ScanResult field
    equal. Returns how many answers the views served."""
    from repro_torch.kernels import ops

    cf = eng.column_families[cf_name]
    handles = {r.replica_id: r for r in cf.replicas}
    groups: dict[int, list] = {}
    for q, (res, rep) in pairs:
        if eng._table(cf, handles[rep.replica_id])._view_eligible(q):
            groups.setdefault(rep.replica_id, []).append((q, res))
    for rid, items in groups.items():
        fused = ops.table_execute_device_many(eng._table(cf, handles[rid]), [q for q, _ in items])
        for (q, a), b in zip(items, fused):
            check(
                (a.value, a.rows_scanned, a.rows_matched, a.selected) == (b.value, b.rows_scanned, b.rows_matched, b.selected),
                f"{label}: view answer {a} != fused {b} for {q.filters}",
            )
    return sum(len(v) for v in groups.values())


# -- phase 2: kernels against their plain versions ---------------------------------------


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def kernel_phase(key_cols, value_cols, writes, dev):
    """The write path's kernels on the main path's shapes
    (``repro_torch.bench.write_kernels``): the 9-run stack that compaction
    folds after the 8th write (SF-scale base plus eight appended runs),
    against plain and the host merge order, and a stack of the same shape
    whose appended keys all equal keys of other runs, against plain; a
    write batch's three key columns through ``ecdf_hist`` one by one and
    through the batched call the statistics refresh makes, against plain
    and ``np.bincount``, beside ``torch.bincount`` in turns and an empty
    launch of the same grid. Returns the kernels line's rows and the
    ``write_kernels`` line."""
    import repro_torch.core as T
    from repro_torch.bench import write_kernels as W
    from repro_torch.core.tpch import orders_schema

    table = W.run_stack(key_cols, value_cols, writes[:8], dev)
    st = table._device
    starts, n_rows = st["run_starts"], st["n_rows"]
    check(len(starts) == 9, f"merge: expected 9 runs, got {len(starts)}")
    k_ex = sum(st["col_parts"])
    detail = {}
    try:
        merge = W.merge_case(st["keys"], starts, n_rows, k_ex, row_map=st["row_map"])
        dup_keys, dup_starts, dup_n = W.dup_stack(st["keys"], starts[1], k_ex, run_rows=n_rows - starts[-1])
        del table, st
        detail["merge_dup"] = W.merge_case(dup_keys, dup_starts, dup_n, k_ex)
        del dup_keys
        stats = T.TableStats.from_columns({c: v[:1] for c, v in key_cols.items()}, orders_schema())
        hist = W.hist_case(writes[0][0], stats, dev)
    except AssertionError as e:
        fail(str(e))
    detail["merge"] = merge
    detail["hist"] = hist
    b, by = bound(*W.merge_work(merge["run_rows"], k_ex))
    # the design's own traffic, beside the function's least (the bound)
    design = W.merge_design_bytes(merge["run_rows"], k_ex)
    merge.update(bound_ms=b, design_bytes=design, design_bytes_ms=bound(design, 0)[0])
    rows = {
        "merge_run_positions": dict(
            max_abs_err=merge["max_abs_err"], ms=merge["ms"], device_ms=merge["device_ms"],
            plain_ms=merge["plain_ms"], bound_ms=b, bound_by=by, library_ms=None,
            per=f"one compaction of {len(starts)} runs, {n_rows} rows",
        ),
    }
    batched = hist["batched"]
    n_cols, n = len(hist["columns"]), hist["rows"]
    b, by = bound(4 * n_cols * n + 4 * sum(hist["n_bins"]), 3 * n_cols * n)
    rows["ecdf_hist"] = dict(
        max_abs_err=batched["max_abs_err"], ms=batched["ms"], device_ms=batched["device_ms"],
        plain_ms=batched["plain_ms"], bound_ms=b, bound_by=by, library_ms=batched["library_ms"],
        empty_launch_ms=hist["empty_launch"]["ms"], empty_launch_device_ms=hist["empty_launch"]["device_ms"],
        per=f"one write batch: {n_cols} columns of {n} rows, one launch",
    )
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows, detail


def group_phase(eng, cf_name, batch, dev) -> tuple[dict, dict]:
    """One fresh ``read_many`` batch, timed on the host clock; then the
    read kernels on each replica group that batch formed (queries grouped
    by the replica that answered them, as ``read_many`` launches them),
    each held against its plain version and timed on CUDA events. The
    kernels' ``ms``, ``plain_ms`` and ``bound_ms`` are sums over the
    batch's groups; the per-group numbers ride along. Also returns the
    read layer's numbers for the batch: its wall, the kernels' share and
    the operand bytes uploaded."""
    from repro_torch.bench.fused_scan import device_ms
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_agg import scan_tile
    from repro_torch.kernels.slab_locate import scan_agg_locate, scan_agg_locate_plain

    cf = eng.column_families[cf_name]
    handles = {r.replica_id: r for r in cf.replicas}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.read_many(cf_name, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    groups: dict[int, list] = {}
    for q, (_, rep) in zip(batch, out):
        groups.setdefault(rep.replica_id, []).append(q)

    scan_rows, sel_rows, live_rows = [], [], {}
    upload_bytes = 0
    cross_ops = cross_bytes = 0.0
    for rid, qs in groups.items():
        table = eng._table(cf, handles[rid])
        st = table._device
        cp, n, n_vals = st["col_parts"], st["n_rows"], st["n_value_rows"]
        k_ex = sum(cp)
        d = ops.device_query_operands(table, qs)
        upload_bytes += sum(t.numel() * t.element_size() for t in d.values())
        args = (d["res_lo"], d["res_hi"], d["slab_lo"], d["slab_hi"], d["limits"], d["sel"])

        def scan(args=args):
            return scan_agg_locate(st["keys"], st["values_tile"], *args, col_parts=cp, n_vals=n_vals)

        def scan_plain():
            return scan_agg_locate_plain(st["keys"], st["values_tile"][:n_vals], *args, col_parts=cp)

        ks, kp = scan(), scan_plain()
        what = f"scan_agg_locate (replica {rid}, {len(qs)} queries)"
        check(torch.equal(ks[1], kp[1]) and torch.equal(ks[2], kp[2]), f"{what}: counts differ from plain")
        check(bool(torch.allclose(ks[0], kp[0], rtol=RTOL, atol=ATOL)), f"{what}: sums differ from plain")
        check(all(torch.equal(a, b) for a, b in zip(ks, scan())), f"{what}: not deterministic")
        q = len(qs)
        work, live = fused_scan_work(st, d, scan_tile(k_ex, n_vals))
        live_rows[str(rid)] = live
        # every (row, query) pair of the windows, as the scan evaluated
        # them before it skipped pairs
        pairs = int((d["limits"][:, 1] - d["limits"][:, 0]).sum())
        cross_bytes += 4 * n * (k_ex + n_vals) + q * (16 * k_ex + 12) + 12 * q
        cross_ops += pairs * (3 + 4 * k_ex)
        one = tuple(a[:1] for a in args)
        scan_rows.append(dict(
            replica=rid, queries=q, max_abs_err=max_abs_diff(ks[0], kp[0]), ms=time_ms(scan, 10),
            device_ms=device_ms(scan, 10, ("scan_partials", "scan_fold")),
            fold_device_ms=device_ms(scan, 10, ("scan_fold",)),
            plain_ms=time_ms(scan_plain, 2), bound_ms=bound(*work)[0], work=work,
            q1_ms=time_ms(lambda: scan(one), 10),
        ))

        # select compaction on the group's selects with matches
        row = select_group(st, d, [qq.agg for qq in qs], ks[1])
        if row is not None:
            sel_rows.append(dict(replica=rid, **row))
    check(len(sel_rows) > 0, "select_compact: no group of the batch had selects with matches")

    def summed(rows):
        """The batch's launches together: times summed, and the bound of
        their bytes and operations summed."""
        b, by = bound(sum(r["work"][0] for r in rows), sum(r["work"][1] for r in rows))
        out = dict(
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows), bound_ms=b, bound_by=by, library_ms=None,
            per=f"read_many batch of {len(batch)} ({len(rows)} launches)",
            groups=[{k: v for k, v in r.items() if k not in ("work", "live")} for r in rows],
        )
        for key in ("device_ms", "fold_device_ms"):
            if all(key in r for r in rows):
                out[key] = sum(r[key] for r in rows)
        if all("pass_device_ms" in r for r in rows):
            out["pass_device_ms"] = {p: sum(r["pass_device_ms"][p] for r in rows) for p in rows[0]["pass_device_ms"]}
        return out

    report = {"scan_agg_locate": summed(scan_rows), "select_compact": summed(sel_rows)}
    kernel_ms = report["scan_agg_locate"]["ms"] + report["select_compact"]["ms"]
    layer = {
        "read_many_wall_ms": wall_ms, "read_kernels_ms": kernel_ms,
        "read_host_ms": wall_ms - kernel_ms, "operand_upload_bytes": upload_bytes,
        "groups": {str(rid): len(qs) for rid, qs in groups.items()},
        "scan_live_tile_pairs": live_rows,
        "select_groups": [_select_check_row(r["replica"], r) for r in sel_rows],
        "scan_cross_product_bound_ms": bound(cross_bytes, cross_ops)[0],
    }
    torch.cuda.synchronize()
    return report, layer


def select_group(st, d, aggs, matched) -> dict | None:
    """``bench.select_slab.select_group`` on one replica group's selects
    with matches (the launch ``read_many`` makes after the fused scan, whose
    ``matched`` counts size it): held equal to its plain version, timed by
    CUDA events and under ``torch.profiler`` (its three passes apart), with
    its bound counted from the pairs its skip rule leaves live. The
    measured numbers and ``bound_ms`` come back as they go into the
    kernels line; ``work`` and ``live`` (the live pairs, for the read
    layer's line) ride along. None if the group has no select with a
    match."""
    from repro_torch.bench.select_slab import select_group as measure

    try:
        row = measure(st, d, aggs, matched)
    except AssertionError as e:
        fail(str(e))
    if row is not None:
        row["bound_ms"] = bound(*row["work"])[0]
    return row


def select_check(eng, cf_name, batch, out, dev) -> list:
    """``select_group`` on every replica group of an answered ``read_many``
    batch (``out``: its answers, whose reports say which replica served
    each query), its launches left out of the path's counts."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.slab_locate import scan_agg_locate

    cf = eng.column_families[cf_name]
    handles = {r.replica_id: r for r in cf.replicas}
    groups: dict[int, list] = {}
    for q, (_, rep) in zip(batch, out):
        groups.setdefault(rep.replica_id, []).append(q)
    rows = []
    for rid, qs in sorted(groups.items()):
        st = eng._table(cf, handles[rid])._device
        d = ops.device_query_operands(eng._table(cf, handles[rid]), qs)
        _, matched, _ = uncounted(lambda: scan_agg_locate(
            st["keys"], st["values_tile"], d["res_lo"], d["res_hi"], d["slab_lo"], d["slab_hi"], d["limits"],
            d["sel"], col_parts=st["col_parts"], n_vals=st["n_value_rows"],
        ))
        row = uncounted(select_group, st, d, [q.agg for q in qs], matched)
        if row is not None:
            rows.append(_select_check_row(rid, row))
    check(len(rows) > 0, f"{cf_name}: no group of the batch had selects with matches")
    return rows


def _select_check_row(rid, row) -> dict:
    """One group's select check as the read layer's line holds it: the
    measured numbers, the bound and the live pairs, without ``work``."""
    return dict(replica=rid, **{k: v for k, v in row.items() if k not in ("replica", "work", "live")}, **row["live"])


def fused_scan_work(st, d, tile) -> tuple[tuple[float, float], dict]:
    """Bytes and operations the fused scan needs on a group's operands,
    counted from the (query, tile) pairs its skip rule leaves live
    (``live_tile_pairs``): the key lanes of the table's rows once, the
    value row of each (tile, value row) some live pair takes once, the
    operands and the outputs once; the predicate for every row of a live
    pair inside its query's window. Also the live share."""
    from repro_torch.kernels.slab_locate import live_tile_pairs

    n, k_ex = st["n_rows"], sum(st["col_parts"])
    live = live_tile_pairs(
        st["keys"], d["res_lo"], d["res_hi"], d["slab_lo"], d["slab_hi"], d["limits"],
        col_parts=st["col_parts"], n_rows=n, tile=tile,
    )
    q, n_tiles = live.shape[0], -(-n // tile)
    start = torch.arange(live.shape[1], device=live.device, dtype=torch.int64) * tile
    lim = d["limits"].long()
    inside = (torch.minimum(start + tile, lim[:, 1:2].clamp(max=n)) - torch.maximum(start, lim[:, 0:1])).clamp(min=0)
    pair_rows = int((inside * live).sum())
    tile_rows = (torch.minimum(start + tile, torch.full_like(start, n)) - start).clamp(min=0)
    value_bytes = sum(
        4 * int(tile_rows[live[d["sel"] == v].any(dim=0)].sum()) for v in torch.unique(d["sel"]).tolist()
    )
    work = (4 * n * k_ex + value_bytes + q * (16 * k_ex + 12) + 12 * q, pair_rows * (3 + 4 * k_ex))
    share = dict(
        queries=q, tiles=n_tiles, tile=tile, live_pairs=int(live.sum()),
        live_share=int(live.sum()) / (q * n_tiles), live_rows=pair_rows,
    )
    return work, share


def row_slab_batch(batch):
    """The fresh batch with its selects turned into counts: the row-slab
    scans serve sums and counts only."""
    import repro_torch.core as T

    return [q if q.agg != "select" else T.Query(filters=q.filters, agg="count") for q in batch]


def host_slabs(table, batch) -> np.ndarray:
    """The host searchsorted's slabs: ``slab_many`` of a host twin."""
    import repro_torch.core as T

    return T.SortedTable(table.layout, table.schema, table.key_cols, table.value_cols, table.packed).slab_many(batch)


def row_slab_phase(eng, cf_name, batch, oracle, dev) -> dict:
    """The row-slab read path on every replica of ``cf_name`` while each
    holds one sorted run: ``slab_many`` on the device against the host
    searchsorted, ``table_scan_device_many`` on both grids and with
    ``slabs=None``, and one ``table_scan_device``, every answer against the
    oracle. Returns the phase's walls."""
    from repro_torch.kernels import ops

    cf = eng.column_families[cf_name]
    sum_idx = [i for i, q in enumerate(batch) if q.agg == "sum"]
    sums = [batch[i] for i in sum_idx]
    walls = []
    for r in cf.replicas:
        table = eng._table(cf, r)
        check(table._device["n_runs"] == 1, f"replica {r.replica_id} holds more than one run")
        what = f"row_slab (replica {r.replica_id})"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slabs = table.slab_many(batch)
        t1 = time.perf_counter()
        rows = ops.table_scan_device_many(table, batch, slabs=slabs)
        t2 = time.perf_counter()
        qrows = ops.table_scan_device_many(table, sums, slabs=slabs[sum_idx], grid="queries_outer")
        t3 = time.perf_counter()
        located = ops.table_scan_device_many(table, batch)
        t4 = time.perf_counter()
        one = ops.table_scan_device(table, batch[0])
        walls.append(dict(
            replica=r.replica_id, slab_many_ms=(t1 - t0) * 1e3, rows_outer_ms=(t2 - t1) * 1e3,
            queries_outer_ms=(t3 - t2) * 1e3, rows_outer_device_slabs_ms=(t4 - t3) * 1e3,
        ))
        check(np.array_equal(slabs, host_slabs(table, batch)), f"{what}: slab_many differs from the host searchsorted")
        check(located == rows, f"{what}: slabs=None answers differ from the located slabs'")
        check(one == rows[0], f"{what}: table_scan_device differs from the batch")
        for i, (q, (value, count)) in enumerate(zip(batch, rows)):
            n_match, want = oracle.answer(q, cf.schema)
            check(count == n_match, f"{what} query {i}: count {count} != {n_match}")
            if q.agg == "sum":
                check(math.isclose(value, want, rel_tol=RTOL, abs_tol=ATOL), f"{what} query {i}: sum {value} != {want}")
            else:
                check(value == n_match, f"{what} query {i}: count value {value} != {n_match}")
        check([c for _, c in qrows] == [rows[i][1] for i in sum_idx], f"{what}: queries-outer counts differ")
        for (a, _), i in zip(qrows, sum_idx):
            check(math.isclose(a, rows[i][0], rel_tol=RTOL, abs_tol=ATOL), f"{what}: queries-outer sum {a} != {rows[i][0]}")
    torch.cuda.synchronize()
    return dict(queries=len(batch), sums=len(sums), answers_checked=len(batch) * len(walls), walls=walls)


def union_rows(slabs: np.ndarray) -> int:
    """Rows covered by the union of the ``[lo, hi)`` slabs."""
    total, end = 0, -1
    for lo, hi in sorted((int(a), int(b)) for a, b in slabs if b > a):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def slab_scan_work(slabs, sel, lanes) -> tuple[float, float]:
    """Bytes and operations a row-slab scan needs on these inputs: the key
    lanes of every row some slab covers, each value row over the rows its
    queries' slabs cover, the operands and the output once; the predicate
    and the sum for every (query, row) pair inside a slab."""
    q = len(sel)
    key_bytes = 4 * lanes * union_rows(slabs)
    val_bytes = sum(4 * union_rows(slabs[sel == v]) for v in np.unique(sel))
    pairs = float(np.clip(slabs[:, 1] - slabs[:, 0], 0, None).sum())
    return key_bytes + val_bytes + q * (8 * lanes + 12) + 8 * q, pairs * (2 * lanes + 4)


def row_slab_kernel_phase(eng, cf_name, batch, dev) -> tuple[dict, list, dict]:
    """The three row-slab kernels on each replica's launches of the
    row_slab phase, against their plain versions on the same CUDA tensors,
    timed beside their bounds (sums over the three replicas' launches) and,
    for slab_locate, ``torch.searchsorted`` on the packed key
    (``bench.select_slab.slab_locate_turns``). Returns the kernels' rows;
    per replica, the key bytes the queries-outer grid reads by design; and
    slab_locate's dependent rounds per replica, the latency of one
    dependent load (``bench.select_slab.load_latency_ns``) and the latency
    bound they give."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.scan_agg import (
        scan_agg_qgrid, scan_agg_qgrid_plain, scan_agg_rowstream, scan_agg_rowstream_plain,
    )
    from repro_torch.bench.select_slab import LATENCY_BUFFERS, load_latency_ns, slab_locate_turns

    cf = eng.column_families[cf_name]
    sum_idx = [i for i, q in enumerate(batch) if q.agg == "sum"]
    rows = {name: [] for name in ROW_SLAB_KERNELS}
    by_design = []  # the queries-outer grid's key traffic, re-read per query
    rounds = []  # slab_locate's dependent rounds, and a binary search's
    for r in cf.replicas:
        table = eng._table(cf, r)
        st = table._device
        cp, n_vals, lanes = st["col_parts"], st["n_value_rows"], sum(st["col_parts"])
        keys, tile = st["keys"], st["values_tile"]
        d = ops.device_query_operands(table, batch)
        what = f"replica {r.replica_id}"

        # slab_locate, and torch.searchsorted on the packed key as yardstick
        try:
            loc, got = uncounted(slab_locate_turns, table, batch)
        except AssertionError as e:
            fail(f"{e} ({what})")
        host = host_slabs(table, batch)
        check(np.array_equal(got.cpu().numpy(), host), f"slab_locate ({what}): ranks differ from the host searchsorted")
        rounds.append(dict(replica=r.replica_id, **loc.pop("rounds")))
        rows["slab_locate"].append(dict(replica=r.replica_id, bound_ms=bound(*loc["work"])[0], **loc))

        # rows outer, on the located slabs
        slabs = got
        s_args = (keys, tile, d["res_lo"], d["res_hi"], slabs, d["sel"])

        def rs(a=s_args, cp=cp, n_vals=n_vals):
            return scan_agg_rowstream(*a, col_parts=cp, n_vals=n_vals)

        def rs_plain(a=s_args, cp=cp, n_vals=n_vals):
            return scan_agg_rowstream_plain(a[0], a[1][:n_vals], *a[2:], col_parts=cp)

        ks, kp = uncounted(rs), rs_plain()
        check(torch.equal(ks[:, 1], kp[:, 1]), f"scan_agg_rowstream ({what}): counts differ from plain")
        check(bool(torch.allclose(ks[:, 0], kp[:, 0], rtol=RTOL, atol=ATOL)), f"scan_agg_rowstream ({what}): sums differ from plain")
        check(torch.equal(ks, uncounted(rs)), f"scan_agg_rowstream ({what}): not deterministic")
        sel_np = d["sel"].cpu().numpy()
        work = slab_scan_work(host, sel_np, lanes)
        rows["scan_agg_rowstream"].append(dict(
            replica=r.replica_id, queries=len(batch), max_abs_err=max_abs_diff(ks[:, 0], kp[:, 0]),
            ms=uncounted(time_ms, rs, 10), plain_ms=time_ms(rs_plain, 2), bound_ms=bound(*work)[0],
            library_ms=None, work=work,
        ))

        # queries outer, on the batch's sums (one value row)
        idx = torch.tensor(sum_idx, device=dev)
        row = tile[int(sel_np[sum_idx[0]])]
        g_args = (keys, row, d["res_lo"][idx].contiguous(), d["res_hi"][idx].contiguous(), slabs[idx].contiguous())

        def qg(a=g_args):
            return scan_agg_qgrid(*a)

        def qg_plain(a=g_args):
            return scan_agg_qgrid_plain(*a)

        kq, kqp = uncounted(qg), qg_plain()
        check(torch.equal(kq[:, 1], kqp[:, 1]), f"scan_agg_qgrid ({what}): counts differ from plain")
        check(bool(torch.allclose(kq[:, 0], kqp[:, 0], rtol=RTOL, atol=ATOL)), f"scan_agg_qgrid ({what}): sums differ from plain")
        check(torch.equal(kq[:, 1], ks[idx, 1]), f"scan_agg_qgrid ({what}): counts differ from rows outer")
        work = slab_scan_work(host[sum_idx], sel_np[sum_idx], lanes)
        design = len(sum_idx) * keys.shape[1] * (lanes + 1) * 4
        by_design.append(dict(replica=r.replica_id, bytes=design, bytes_ms=bound(design, 0)[0]))
        rows["scan_agg_qgrid"].append(dict(
            replica=r.replica_id, queries=len(sum_idx), max_abs_err=max_abs_diff(kq[:, 0], kqp[:, 0]),
            ms=uncounted(time_ms, qg, 3), plain_ms=time_ms(qg_plain, 2), bound_ms=bound(*work)[0],
            library_ms=None, work=work,
        ))

    report = {}
    for name, per in rows.items():
        b, by = bound(sum(x["work"][0] for x in per), sum(x["work"][1] for x in per))
        lib = [x["library_ms"] for x in per]
        report[name] = dict(
            max_abs_err=max(x["max_abs_err"] for x in per), ms=sum(x["ms"] for x in per),
            plain_ms=sum(x["plain_ms"] for x in per), bound_ms=b, bound_by=by,
            library_ms=None if None in lib else sum(lib),
            **{k: sum(x[k] for x in per) for k in ("device_ms", "library_device_ms") if k in per[0]},
            per=f"batch of {per[0]['queries']} on each of {len(per)} replicas ({len(per)} launches)",
            groups=[{k: v for k, v in x.items() if k != "work"} for x in per],
        )
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # slab_locate's latency bound: its dependent rounds times one dependent
    # load's latency, from device memory and from L2
    latency = {name: load_latency_ns(dev, n_bytes) for name, n_bytes in LATENCY_BUFFERS.items()}
    torch.cuda.empty_cache()
    most = max(x["kary"] for x in rounds)
    slab = dict(
        rounds=rounds, load_latency_ns=latency,
        latency_bound_ms={name: most * ns * 1e-6 for name, ns in latency.items()},
    )
    return report, by_design, slab


def views_phase(base_eng, key_cols, value_cols, writes, batches, oracles, dev) -> dict:
    """The views path, its launch counts set to 0 first: CREATE "orders_v"
    with views on the same rows, the orders reads, the 10 writes. Returns
    the path's numbers and its engine."""
    import repro_torch.core as T
    import repro_torch.kernels as K
    from repro_torch.core.storage.views import verify_views

    for fn in K.KERNELS.values():
        fn.launches = 0
    n_rows = len(key_cols["custkey"])
    eng = T.HREngine(n_nodes=6, device=dev)
    t = time.perf_counter()
    eng.create_column_family(
        "orders_v", key_cols, value_cols, replication_factor=3, mechanism="HR",
        workload=T.tpch.q1_q2_workload(n_rows=n_rows), schema=T.tpch.orders_schema(),
        device_resident=True, views=True,
    )
    torch.cuda.synchronize()
    create_ms = (time.perf_counter() - t) * 1e3
    check(eng.layouts("orders_v") == base_eng.layouts("orders"), "orders_v layouts differ from orders'")
    cf = eng.column_families["orders_v"]

    def verify_all(label):
        for r in cf.replicas:
            table = eng._table(cf, r)
            check(table.has_views and uncounted(verify_views, table), f"{label}: replica {r.replica_id} view stale")

    def checked(pairs, oracle, label) -> int:
        uncounted(check_answers, eng, "orders_v", pairs, oracle, label)
        return uncounted(check_view_bits, eng, "orders_v", pairs, label)

    verify_all("create")
    bl = K.KERNELS["boundary_block_sums"]
    per_batch, served = [], 0
    for b, batch in enumerate(batches):
        before = (eng.stats["view_hits"], eng.stats["view_boundary_rows"], bl.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = eng.read_many("orders_v", batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        hits = eng.stats["view_hits"] - before[0]
        n_agg = sum(q.agg in ("sum", "count") for q in batch)
        check(hits * 2 > n_agg, f"batch {b}: only {hits} of {n_agg} sums and counts were view hits")
        per_batch.append(dict(
            wall_ms=wall, queries=len(batch), view_hits=hits,
            view_boundary_rows=eng.stats["view_boundary_rows"] - before[1],
            boundary_launches=bl.launches - before[2],
        ))
        served += checked(list(zip(batch, out)), oracles[0], f"views batch {b}")
        if b == 0:
            selects = {"orders_v_before_writes": select_check(eng, "orders_v", batch, out, dev)}
    wide = wide_batch()
    served += checked(list(zip(wide, eng.read_many("orders_v", wide))), oracles[0], "views wide")
    scalar = batches[1][::16]
    served += checked([(q, eng.read("orders_v", q)) for q in scalar], oracles[0], "views scalar")
    check(served > 0, "no answer was served by a view")

    write_ms = []
    for i, (wk, wv) in enumerate(writes):
        t = time.perf_counter()
        eng.write("orders_v", wk, wv)
        torch.cuda.synchronize()
        write_ms.append((time.perf_counter() - t) * 1e3)
        if i == 7:
            check(eng.stats["compactions"] >= 3, "the 8th write did not compact orders_v")
            check(eng.stats["view_rebuilds"] >= 3, f"view_rebuilds {eng.stats['view_rebuilds']} < 3")
            verify_all("after the compaction")
            out = eng.read_many("orders_v", batches[3])
            served_c = checked(list(zip(batches[3], out)), oracles[1], "views after the compaction")
            check(served_c > 0, "no view hit after the compaction")
    check(all(eng._table(cf, r)._device["n_runs"] == 3 for r in cf.replicas), "orders_v holds no appended runs")
    verify_all("after the last write")
    launches_before = bl.launches
    out = eng.read_many("orders_v", batches[2])
    check(bl.launches > launches_before, "no boundary rescan after the writes")
    served_w = checked(list(zip(batches[2], out)), oracles[2], "views after the writes")
    selects["orders_v_after_writes"] = select_check(eng, "orders_v", batches[2], out, dev)
    served_w += checked(list(zip(wide, eng.read_many("orders_v", wide))), oracles[2], "views wide after the writes")
    check(served_w > 0, "no view hit after the writes")

    launches = {name: fn.launches for name, fn in K.KERNELS.items()}
    for name in VIEW_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the views path")
    stats = eng.stats
    return eng, dict(
        create_ms=create_ms, batches=per_batch, write_ms=write_ms, launches=launches,
        view_hits=stats["view_hits"], view_boundary_rows=stats["view_boundary_rows"],
        view_rebuilds=stats["view_rebuilds"], compactions=stats["compactions"],
        result_cache_hits=stats["result_cache_hits"], select_checks=selects,
    )


def view_kernel_phase(eng, fresh_batch, dev) -> dict:
    """The view kernels at the views path's shapes, each vs its plain
    version: block_sums over a replica's whole SF 5 tile and over the tail
    a 20,000-row flush refolds; boundary_block_sums on the pairs each
    replica group of one fresh batch forms (timed per launch, summed per
    batch). Then the bit identity of view and fused scan on a table whose
    schema shrinks the fused scan's staging tile."""
    import repro_torch.core as T
    from repro_torch.bench.fused_scan import device_ms
    from repro_torch.core.storage.memtable import sort_run
    from repro_torch.core.storage.views import plan_view_batch, verify_views
    from repro_torch.kernels import ops
    from repro_torch.kernels.block_agg import (
        block_partials_card_order, block_sums, block_sums_plain, boundary_block_sums,
        boundary_block_sums_plain, scan_tile, scan_tile_plain,
    )

    cf = eng.column_families["orders_v"]
    handles = {r.replica_id: r for r in cf.replicas}
    st = eng._table(cf, cf.replicas[0])._device
    tile, n, nv, k_ex = st["values_tile"], st["n_rows"], st["n_value_rows"], sum(st["col_parts"])
    nb = -(-tile.shape[1] // 8192)
    args = dict(n_rows=n, block_n=8192, n_vals=nv, n_key_lanes=k_ex)
    report = {}

    def full():
        return block_sums(tile, **args)

    def full_plain():
        return block_sums_plain(tile, n_rows=n, n_vals=nv)

    def full_library():
        return tile[:nv].view(nv, nb, 8192).sum(dim=2)

    got, want = full(), full_plain()
    check(bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL)), "block_sums: differs from plain")
    check(torch.equal(got, full()), "block_sums: not deterministic")
    first = (n - WRITE_ROWS) // 8192

    def tail():
        return block_sums(tile, first_block=first, **args)

    # the contract's in-block order, written out in PyTorch: bit for bit
    rows = scan_tile(k_ex, nv)
    check(rows == scan_tile_plain(k_ex, nv), f"scan_tile {rows} != the frozen formula's {scan_tile_plain(k_ex, nv)}")
    tail_got = tail()
    for v in range(nv):
        order = block_partials_card_order(tile[v], n, rows)
        check(torch.equal(got[v], order), f"block_sums: value row {v} differs from the card order")
        check(torch.equal(tail_got[v], order[first:]), f"block_sums tail: value row {v} differs from the card order")

    b_full = bound(4 * nv * n + 4 * nv * nb, nv * n)
    b_tail = bound(4 * nv * (n - first * 8192) + 4 * nv * (nb - first), nv * (n - first * 8192))
    report["block_sums"] = dict(
        max_abs_err=max_abs_diff(got, want), ms=time_ms(full, 20), device_ms=device_ms(full, 20, ("block_sums",)),
        plain_ms=time_ms(full_plain, 3), bound_ms=b_full[0], bound_by=b_full[1],
        library_ms=time_ms(full_library, 20), per=f"full build, {n} rows x {nv} value rows ({nb} blocks)",
        tail=dict(
            blocks=nb - first, ms=time_ms(tail, 50), device_ms=device_ms(tail, 50, ("block_sums",)),
            bound_ms=b_tail[0], bound_by=b_tail[1],
        ),
        scan_tile=rows, card_order_blocks=nv * nb,
    )

    # boundary pairs of one fresh batch, per replica group
    torch.cuda.synchronize()
    out = eng.read_many("orders_v", fresh_batch)
    groups: dict[int, list] = {}
    for q, (_, rep) in zip(fresh_batch, out):
        table = eng._table(cf, handles[rep.replica_id])
        if table._view_eligible(q):
            groups.setdefault(rep.replica_id, []).append(q)
    rows = []
    for rid, qs in groups.items():
        table = eng._table(cf, handles[rid])
        s2 = table._device
        plan = plan_view_batch(table, qs)
        p = int(plan["pair_sel"].shape[0])
        if p == 0:
            continue
        ops_args = (plan["pair_sel"], plan["pair_block"], plan["pair_lo"], plan["pair_hi"])
        bargs = dict(n_rows=s2["n_rows"], block_n=8192, n_vals=s2["n_value_rows"], n_key_lanes=sum(s2["col_parts"]))
        t_ops = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev) for a in ops_args]

        def bnd(s2=s2, ops_args=ops_args, bargs=bargs):
            return boundary_block_sums(s2["values_tile"], *ops_args, **bargs)

        def bnd_plain(s2=s2, t_ops=t_ops):
            return boundary_block_sums_plain(s2["values_tile"], *t_ops, n_rows=s2["n_rows"])

        kb, kp = bnd(), bnd_plain()
        check(bool(torch.allclose(kb, kp, rtol=RTOL, atol=ATOL)), f"boundary_block_sums (replica {rid}): differs from plain")
        check(torch.equal(kb, bnd()), "boundary_block_sums: not deterministic")
        # rows the rescans read: each pair's in-window live rows of its block
        b0 = plan["pair_block"][:, None] * 8192
        b1 = np.minimum(b0 + 8192, s2["n_rows"])
        read = np.maximum(np.minimum(plan["pair_hi"], b1) - np.maximum(plan["pair_lo"], b0), 0).sum()
        w = plan["pair_lo"].shape[1]
        work = (4 * int(read) + p * (8 + 8 * w) + 4 * p, int(read) * (1 + 2 * w))
        rows.append(dict(
            replica=rid, pairs=p, windows=w, rows_read=int(read), max_abs_err=max_abs_diff(kb, kp),
            ms=time_ms(bnd, 20), device_ms=device_ms(bnd, 20, ("boundary_sums",)), plain_ms=time_ms(bnd_plain, 3),
            bound_ms=bound(*work)[0], work=work,
        ))
    check(len(rows) > 0, "boundary_block_sums: the fresh batch formed no boundary pairs")
    b, by = bound(sum(r["work"][0] for r in rows), sum(r["work"][1] for r in rows))
    report["boundary_block_sums"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in rows), ms=sum(r["ms"] for r in rows),
        device_ms=sum(r["device_ms"] for r in rows),
        plain_ms=sum(r["plain_ms"] for r in rows), bound_ms=b, bound_by=by, library_ms=None,
        per=f"read_many batch of {len(fresh_batch)} ({len(rows)} launches)",
        groups=[{k: v for k, v in r.items() if k != "work"} for r in rows],
    )

    # a schema whose staging tile is 1024 rows: eight key lanes and fifteen
    # value columns plus the ones row (24 staged words a row)
    rng = np.random.default_rng(7)
    bits = {f"k{i}": 7 for i in range(8)}
    layout = tuple(bits)
    n_small, n_vcols = 300_000, 15

    def cols(m):
        kc = {c: rng.integers(0, 64, m, dtype=np.int64) for c in bits}
        return kc, {f"v{i}": rng.uniform(-10.0, 100.0, m) for i in range(n_vcols)}

    small = T.SortedTable.from_columns(*cols(n_small), layout, T.KeySchema(dict(bits)))
    small.place_on_device(dev).build_views()
    s3 = small._device
    small_tile = scan_tile(sum(s3["col_parts"]), s3["n_value_rows"])
    check(small_tile < 2048, f"the wide schema's staging tile is {small_tile}, not below 2048")
    small_sums = block_sums(
        s3["values_tile"], n_rows=n_small, block_n=8192, n_vals=s3["n_value_rows"], n_key_lanes=sum(s3["col_parts"]),
    )
    for v in range(s3["n_value_rows"]):
        order = block_partials_card_order(s3["values_tile"][v], n_small, small_tile)
        check(torch.equal(small_sums[v], order), f"small-tile block_sums: value row {v} differs from the card order")
    qs = []
    for i in range(256):
        depth = int(rng.integers(0, 4))
        f = {c: T.Eq(int(rng.integers(0, 64))) for c in layout[:depth]}
        lo = int(rng.integers(0, 64))
        f[layout[depth]] = T.Range(lo, int(rng.integers(lo, 65)))
        qs.append(T.Query(filters=f, agg="sum" if i % 4 else "count", value_col=f"v{i % n_vcols}"))
    compared = 0
    for step in range(3):
        check(verify_views(small), f"small-tile table, step {step}: view stale")
        served = small.execute_many(qs)
        fused = ops.table_execute_device_many(small, qs)
        for q, a, c in zip(qs, served, fused):
            check(
                (a.value, a.rows_scanned, a.rows_matched) == (c.value, c.rows_scanned, c.rows_matched),
                f"small-tile table, step {step}: view {a} != fused {c} for {q.filters}",
            )
        compared += len(qs)
        small = small.merge_run(sort_run(*cols(40_000), layout, small.schema))
    report["small_tile"] = dict(
        rows=n_small, key_lanes=sum(s3["col_parts"]), value_rows=s3["n_value_rows"], scan_tile=small_tile,
        answers_compared=compared, card_order_blocks=int(small_sums.numel()),
    )
    torch.cuda.synchronize()
    return report


class StageClock:
    """A sink for the engine's ``trace=`` spans: host-clock wall per span
    name, summed over the batch. The read path's spans end after their
    results reach the host, so each holds the device work it waited for."""

    def __init__(self):
        self.ms: dict[str, float] = {}

    def child(self, name: str, **_) -> "_Span":
        return _Span(self, name)


class _Span:
    def __init__(self, clock: StageClock, name: str):
        self.clock, self.name, self.t0 = clock, name, time.perf_counter()

    def child(self, name: str, **_) -> "_Span":
        return _Span(self.clock, name)

    def end(self, **_) -> None:
        ms = (time.perf_counter() - self.t0) * 1e3
        self.clock.ms[self.name] = self.clock.ms.get(self.name, 0.0) + ms


def breakdown_phase(targets, n_rows: int, seed: int) -> dict:
    """Where the time of a fresh ``read_many`` batch of 256 goes on each
    column family: the engine's spans on the host clock for one batch, and
    the device's busy time and kernels under ``torch.profiler`` for a
    second one (the profiler's own host cost makes its wall, and the idle
    share it gives, an upper bound)."""
    clocked, profiled = read_batches(n_rows, seed)[:2]
    out = {}
    for label, (eng, cf_name) in targets.items():
        clock = StageClock()
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.read_many(cf_name, clocked, trace=clock)
        torch.cuda.synchronize()
        out[label] = {
            "wall_ms": (time.perf_counter() - t) * 1e3,
            "spans_ms": clock.ms,
            "profile": profile_batch(eng, cf_name, profiled),
        }
    return out


def profile_batch(eng, cf_name, batch) -> dict:
    """One ``read_many`` batch under ``torch.profiler``: its host wall, the
    union of the device's kernel and copy intervals (busy time), the
    device time of each kernel by name, and the fused scan's two kernels
    (``scan_partials``, ``scan_fold``) apart. The profiler's own host cost
    inflates the wall, so the idle share it gives is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.read_many(cf_name, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (end - start) / 1e3
    busy_us, last = 0.0, -math.inf
    for start, end in sorted(spans):
        if end > last:
            busy_us += end - max(start, last)
            last = end
    fused = {k: sum(ms for name, ms in by_name.items() if k in name) for k in ("scan_partials", "scan_fold")}
    return {
        "queries": len(batch), "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": (1.0 - busy_us / 1e3 / wall_ms) if spans else None,
        "fused_scan_ms": fused,
        "device_ms_by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12]),
    }


# -- main path -----------------------------------------------------------------------


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=5.0, help="TPC-H scale factor (1.5 M rows each)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated data")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run on an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"run from the root of a checkout: {ROOT / 'src' / 'repro_torch'} is missing")
    sys.path.insert(0, str(ROOT / "src"))
    run(args, torch.device("cuda"))


def run(args, dev) -> None:
    """The phases on ``dev``, after ``main`` has put ``src`` on the path."""
    import repro_torch.core as T
    import repro_torch.core.tpch  # noqa: F401  (T.tpch)
    import repro_torch.kernels as K
    from repro_torch.kernels import _build, ops

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    phases = Phases()

    # 1. setup: build every kernel, one nvcc per source in parallel
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.1f} s", flush=True)

    key_cols, value_cols = T.tpch.generate_orders(args.sf, seed=args.seed)
    n_rows = len(key_cols["custkey"])
    wk_all, wv_all = T.tpch.generate_orders(1.0, seed=args.seed + 1, rows_per_sf=10 * WRITE_ROWS)
    writes = [
        (
            {c: v[i * WRITE_ROWS : (i + 1) * WRITE_ROWS] for c, v in wk_all.items()},
            {c: v[i * WRITE_ROWS : (i + 1) * WRITE_ROWS] for c, v in wv_all.items()},
        )
        for i in range(10)
    ]
    batches = read_batches(n_rows, args.seed)
    print(f"data: {n_rows} orders rows (SF {args.sf}), 10 writes of {WRITE_ROWS} rows", flush=True)
    # the oracle's rows: the CREATE rows, then after 8 and after 10 writes
    oracles = [
        Oracle(
            {c: np.concatenate([key_cols[c]] + [w[0][c] for w in writes[:k]]) for c in key_cols},
            {c: np.concatenate([value_cols[c]] + [w[1][c] for w in writes[:k]]) for c in value_cols},
            dev,
        )
        for k in (0, 8, 10)
    ]

    # 2. kernels against their plain versions
    report, write_kernels = phases.run("kernels", kernel_phase, key_cols, value_cols, writes, dev)

    # -- the main path: every launch count starts at 0 here ----------------------
    for fn in K.KERNELS.values():
        fn.launches = 0

    # 3. CREATE
    def create():
        eng = T.HREngine(n_nodes=6, device=dev)
        eng.create_column_family(
            "orders", key_cols, value_cols, replication_factor=3, mechanism="HR",
            workload=T.tpch.q1_q2_workload(n_rows=n_rows), schema=T.tpch.orders_schema(),
            device_resident=True,
        )
        for r in eng.column_families["orders"].replicas:
            st = eng._table(eng.column_families["orders"], r)._device
            check(st is not None and st["keys"].device.type == dev.type, f"replica {r.replica_id} is not resident")
        return eng

    eng = phases.run("create", create)
    print(f"layouts: {eng.layouts('orders')}", flush=True)

    # 4. reads
    batch_ms, write_ms = [], []
    select_checks = {}  # select_compact vs plain on the replica groups, per state

    def reads():
        outs = []
        for batch in batches:
            t = time.perf_counter()
            outs.append(eng.read_many("orders", batch))
            batch_ms.append((time.perf_counter() - t) * 1e3)
        hits = eng.stats["result_cache_hits"]
        again = eng.read_many("orders", batches[0])
        check(eng.stats["result_cache_hits"] > hits, "the repeated batch did not hit the result cache")
        for (a, _), (b, _) in zip(outs[0], again):
            check((a.value, a.rows_matched) == (b.value, b.rows_matched), "a cache hit differs")
        wide = wide_batch()
        wide_out = eng.read_many("orders", wide)
        scalar = [eng.read("orders", qq) for qq in batches[1][::16]]
        for qq, got, want in zip(batches[1][::16], scalar, outs[1][::16]):
            check(got[1].replica_id == want[1].replica_id, "read routes differently from read_many")
            check(got[0].rows_matched == want[0].rows_matched, f"read != read_many for {qq.filters}")
        for b, (batch, out) in enumerate(zip(batches, outs)):
            check_answers(eng, "orders", list(zip(batch, out)), oracles[0], f"batch {b} before writes")
        check_answers(eng, "orders", list(zip(wide, wide_out)), oracles[0], "wide")
        select_checks["orders_before_writes"] = select_check(eng, "orders", batches[0], outs[0], dev)

    phases.run("reads", reads)
    print(f"read_many batch ms (host clock): {[round(x, 3) for x in batch_ms]}", flush=True)

    # 5. the row-slab read path while every replica holds one sorted run
    slab_batch = row_slab_batch(read_batches(n_rows, args.seed + 4)[0])

    def row_slab():
        info, launches = own_counts(row_slab_phase, eng, "orders", slab_batch, oracles[0], dev)
        for name in ROW_SLAB_KERNELS:
            check(launches[name] > 0, f"kernel {name} was not launched on the row-slab path")
        info["launches"] = launches
        rows, info["qgrid_key_bytes_by_design"], info["slab_locate"] = row_slab_kernel_phase(
            eng, "orders", slab_batch, dev
        )
        report.update(rows)
        return info

    row_slab_info = phases.run("row_slab", row_slab)

    # 6. the port's batched-read benchmark on one SF-scale replica, its
    # launches (a table of its own) counted apart from the main path's
    from repro_torch.bench.batched_read import run_device

    trajectory, bench_launches = phases.run(
        "batched_read", own_counts, lambda: run_device(
            n_rows=n_rows, batch_sizes=(16, 64, 256), seed=args.seed, repeats=3, numpy_repeats=1, device=dev,
        )
    )
    row_slab_info["batched_read_launches"] = {name: n for name, n in bench_launches.items() if n}

    # 7. writes, device compaction, reads over every row
    def timed_write(wk, wv):
        t = time.perf_counter()
        eng.write("orders", wk, wv)
        torch.cuda.synchronize()
        write_ms.append((time.perf_counter() - t) * 1e3)

    def writes_phase():
        cf = eng.column_families["orders"]
        for wk, wv in writes[:8]:
            timed_write(wk, wv)
        check(eng.stats["compactions"] > 0, "the 8th write did not compact")
        check(K.KERNELS["merge_run_positions"].launches > 0, "compaction did not launch the merge kernel")
        for r in cf.replicas:
            table = eng._table(cf, r)
            st = table._device
            check(st["n_runs"] == 1 and st["row_map"] is None, f"replica {r.replica_id} still holds runs")
            fresh = ops.build_device_state(table, device=dev)
            check(torch.equal(st["keys"], fresh["keys"]), f"replica {r.replica_id}: keys differ from a fresh build")
            check(
                torch.equal(st["values_tile"], fresh["values_tile"]),
                f"replica {r.replica_id}: value tile differs from a fresh build",
            )
            del fresh
        for wk, wv in writes[8:]:
            timed_write(wk, wv)
        check(
            all(eng._table(cf, r)._device["n_runs"] == 3 for r in cf.replicas),
            "the last two writes did not leave appended runs",
        )
        out = eng.read_many("orders", batches[2])
        check_answers(eng, "orders", list(zip(batches[2], out)), oracles[2], "after writes")
        wide = wide_batch()
        check_answers(eng, "orders", list(zip(wide, eng.read_many("orders", wide))), oracles[2], "wide after writes")
        check(cf.stats.n_rows == n_rows + len(writes) * WRITE_ROWS, "statistics missed rows")
        # appended run stacks: slab_many takes the host path, the scans refuse
        for r in cf.replicas:
            table = eng._table(cf, r)
            before = {name: fn.launches for name, fn in K.KERNELS.items()}
            check(np.array_equal(table.slab_many(slab_batch), host_slabs(table, slab_batch)), "slab_many after writes")
            check({name: fn.launches for name, fn in K.KERNELS.items()} == before, "slab_many launched on a run stack")
            try:
                ops.table_scan_device_many(table, slab_batch)
            except ValueError as e:
                check("single sorted run" in str(e), f"table_scan_device_many on a run stack: {e}")
            else:
                fail(f"table_scan_device_many served replica {r.replica_id}'s run stack")

    phases.run("writes", writes_phase)

    launches = {name: fn.launches for name, fn in K.KERNELS.items()}
    for name in ORDERS_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")
    # one compaction a replica; one histogram launch a write for all key columns
    check(launches["merge_run_positions"] == 3, f"merge_run_positions launched {launches['merge_run_positions']} times, not 3")
    check(launches["ecdf_hist"] == len(writes), f"ecdf_hist launched {launches['ecdf_hist']} times, not {len(writes)}")
    for name in ROW_SLAB_KERNELS:
        launches[name] = row_slab_info["launches"][name]
    stats = eng.stats
    write_layer = {
        "replica_flushes": stats["memtable_flushes"], "compactions": stats["compactions"],
        "flush_wall_ms_per_replica_flush": stats["flush_wall_seconds"] * 1e3 / stats["memtable_flushes"],
    }

    # 8. the read kernels on the replica groups of one fresh batch
    fresh = read_batches(n_rows, args.seed + 3)[0]
    group_report, read_layer = phases.run("groups", group_phase, eng, "orders", fresh, dev)
    report.update(group_report)
    select_checks["orders_after_writes"] = read_layer.pop("select_groups")

    # 9. the views path: its own launch counts, from 0
    veng, views = phases.run(
        "views", views_phase, eng, key_cols, value_cols, writes, batches, oracles, dev
    )
    for name in VIEW_KERNELS:
        launches[name] = views["launches"][name]
    select_checks.update(views.pop("select_checks"))
    read_layer["select_checks"] = select_checks
    oracles.clear()

    # 10. the view kernels against their plain versions
    report.update(phases.run("view_kernels", view_kernel_phase, veng, read_batches(n_rows, args.seed + 3)[0], dev))

    # 11. where a fresh batch's time goes, on both column families
    where = phases.run(
        "breakdown", breakdown_phase, {"orders": (eng, "orders"), "orders_v": (veng, "orders_v")},
        n_rows, args.seed + 5,
    )

    # 12. report
    small_tile = report.pop("small_tile")
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        kernels.append(
            dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=launches[name], ok=True, **report[name])
        )
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"phases_ms": phases.ms, "build_s": build_s, "card": card,
                      "read_many_batch_ms": batch_ms, "write_ms": write_ms, "rows": n_rows,
                      "read_layer": read_layer, "write_layer": write_layer}))
    print(json.dumps({"views": dict(
        card=card, orders_batch_ms=batch_ms,
        orders_v_batch_ms=[b["wall_ms"] for b in views["batches"]], **views,
        small_tile=small_tile, where_time=where,
    )}))
    print(json.dumps({"write_kernels": dict(card=card, **write_kernels)}))
    print(json.dumps({"row_slab": dict(card=card, **row_slab_info)}))
    print(json.dumps({"batched_read": dict(card=card, **trajectory)}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
