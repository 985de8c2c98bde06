#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` and drives
the port's main path at TPC-H scale factor 5 (7.5 M ``orders`` rows,
replication factor 3): CREATE a device-resident HR column family, serve
``read_many`` and ``read`` batches, write through commit log, memtable,
flush and append, and compact the run stack on the device. Before that it
holds every kernel of the path against its plain PyTorch version on the
same CUDA tensors, at the path's shapes, and times both.

Phases, each asserting (a failure exits non-zero and prints no result):
  1. setup      card name and power limit, kernel build
  2. kernels    the compaction's merge-rank kernel on the 9-run stack the
                write phase folds, and the histogram kernel on a write's
                column, each vs its plain version (permutation and
                histogram equal); times, bounds, the library yardstick
  3. create     HREngine(n_nodes=6), HR layouts from HRCA over Q1/Q2
  4. reads      4 read_many batches of 256 (1/2 sums, 1/4 counts, 1/4
                selects), one repeated batch (result-cache hits), a batch
                of wide queries and 16 scalar reads; 64 + 8 answers held
                against a brute-force numpy pass over the generated rows
  5. writes     8 write-through writes of 20,000 rows (the 8th trips the
                compaction policy's max_runs), resident state vs a fresh
                build, 2 more writes, reads checked again over all rows
  6. groups     one fresh read_many batch of 256; then the fused scan and
                the select compaction on each replica group that batch
                formed (the launches read_many makes), each vs its plain
                version: counts and indices equal, sums within rtol 1e-5 /
                atol 1e-3; per-group times and bounds, summed per batch
Every kernel wrapper's launch count is set to 0 just before phase 3 and
read after phase 5; each kernel must have launched on the main path.

The standard output ends with the kernels line, the per-phase wall times
and per-layer numbers, the card's name and power limit, and
``{"ok": true, "device": ...}``.

Run from the root of a checkout: ``python3 chip_smoke.py``
(``--sf`` and ``--seed`` change the scale factor and the data seed).
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bandwidth,
# and the float32 rate outside the tensor cores, used here as the peak for
# the kernels' scalar integer compares (int32 compares run no faster).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

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
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


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
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def check_answers(eng, cf_name, pairs, key_cols, value_cols, label):
    """Each (query, (ScanResult, ReadReport)) against numpy over every row
    the column family holds: counts and rows_matched exact, sums within
    tolerance, rows_scanned equal to the serving replica's host slab and
    select indices equal to its host scan."""
    cf = eng.column_families[cf_name]
    handles = {r.replica_id: r for r in cf.replicas}
    for i, (q, (res, rep)) in enumerate(pairs):
        mask = np.ones(len(key_cols["custkey"]), bool)
        for col, f in q.filters.items():
            lo, hi = f.bounds(cf.schema, col)
            v = key_cols[col]
            mask &= (v >= lo) & (v < hi)
        n_match = int(mask.sum())
        what = f"{label} query {i} ({q.agg}, {q.filters})"
        check(res.rows_matched == n_match, f"{what}: rows_matched {res.rows_matched} != {n_match}")
        table = eng._table(cf, handles[rep.replica_id])
        lo, hi = table.slab(q)
        check(res.rows_scanned == hi - lo, f"{what}: rows_scanned {res.rows_scanned} != {hi - lo}")
        if q.agg == "count":
            check(res.value == n_match, f"{what}: count {res.value} != {n_match}")
        elif q.agg == "sum":
            want = float(value_cols[q.value_col][mask].astype(np.float32).astype(np.float64).sum())
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


# -- phase 2: kernels against their plain versions ---------------------------------------


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def kernel_phase(key_cols, value_cols, writes, dev):
    """The write path's kernels on the main path's shapes: the 9-run stack
    that compaction folds after the 8th write (SF-scale base plus eight
    appended runs), and a write batch's column for the statistics
    refresh."""
    import repro_torch.core as T
    import repro_torch.core.tpch  # noqa: F401  (T.tpch)
    from repro_torch.kernels.ecdf_hist import ecdf_hist, ecdf_hist_plain
    from repro_torch.kernels.merge_runs import merge_run_positions, merge_run_positions_plain

    schema = T.tpch.orders_schema()
    table = T.SortedTable.from_columns(key_cols, value_cols, ("clerk", "orderdate", "custkey"), schema)
    table.place_on_device(dev)
    k_ex = sum(table._device["col_parts"])
    report = {}

    # merge ranks of the run stack after the main path's 8 writes
    for wk, wv in writes[:8]:
        table = table.merge_run(T.storage.sort_run(wk, wv, table.layout, schema))
    st = table._device
    starts, n_rows = st["run_starts"], st["n_rows"]
    check(len(starts) == 9, f"merge: expected 9 runs, got {len(starts)}")

    def merge():
        return merge_run_positions(st["keys"], starts, n_rows, n_lanes=k_ex)

    def merge_plain():
        return merge_run_positions_plain(st["keys"], starts, n_rows, n_lanes=k_ex)

    pm, pp = merge(), merge_plain()
    check(torch.equal(pm, pp), "merge_run_positions: permutation differs from plain")
    check(np.array_equal(pm.cpu().numpy(), st["row_map"]), "merge_run_positions: differs from the host merge order")
    lens = np.diff(np.asarray(starts + (n_rows,), np.int64))
    steps = np.ceil(np.log2(lens + 1.0))
    search_steps = float(sum(lens[r] * (steps.sum() - steps[r]) for r in range(len(lens))))
    b, by = bound(4 * n_rows * k_ex + 8 * n_rows + 8 * len(lens), search_steps * (k_ex + 2))
    report["merge_run_positions"] = dict(
        max_abs_err=max_abs_diff(pm, pp), ms=time_ms(merge, 10), plain_ms=time_ms(merge_plain, 3),
        bound_ms=b, bound_by=by, library_ms=None,
    )
    del table, st

    # histogram of a write batch's custkey column, binned as the
    # column family's statistics bin it
    cs = T.TableStats.from_columns({"custkey": key_cols["custkey"][:1]}, schema).columns["custkey"]
    col = torch.from_numpy(writes[0][0]["custkey"].astype(np.int32)).to(dev)
    nb, bw = cs.n_bins, cs.bin_width

    def hist():
        return ecdf_hist(col, n_bins=nb, bin_width=bw)

    def hist_plain():
        return ecdf_hist_plain(col, n_bins=nb, bin_width=bw)

    def hist_library():
        return torch.bincount(torch.div(col, bw, rounding_mode="floor"), minlength=nb)

    hk, hp = hist(), hist_plain()
    check(torch.equal(hk, hp), "ecdf_hist: counts differ from plain")
    want = np.bincount(writes[0][0]["custkey"] // bw, minlength=nb).astype(np.float32)
    check(np.array_equal(hk.cpu().numpy(), want), "ecdf_hist: counts differ from np.bincount")
    b, by = bound(4 * col.numel() + 4 * nb, 3 * col.numel())
    report["ecdf_hist"] = dict(
        max_abs_err=max_abs_diff(hk, hp), ms=time_ms(hist, 50),
        plain_ms=time_ms(hist_plain, 10), bound_ms=b, bound_by=by,
        library_ms=time_ms(hist_library, 50),
    )
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return report


def group_phase(eng, cf_name, batch, dev) -> tuple[dict, dict]:
    """One fresh ``read_many`` batch, timed on the host clock; then the
    read kernels on each replica group that batch formed (queries grouped
    by the replica that answered them, as ``read_many`` launches them),
    each held against its plain version and timed on CUDA events. The
    kernels' ``ms``, ``plain_ms`` and ``bound_ms`` are sums over the
    batch's groups; the per-group numbers ride along. Also returns the
    read layer's numbers for the batch: its wall, the kernels' share and
    the operand bytes uploaded."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.slab_locate import (
        scan_agg_locate, scan_agg_locate_plain, select_compact, select_compact_plain,
    )

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

    scan_rows, sel_rows = [], []
    upload_bytes = 0
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
        pairs = int((d["limits"][:, 1] - d["limits"][:, 0]).sum())
        work = (4 * n * (k_ex + n_vals) + q * (16 * k_ex + 12) + 12 * q, pairs * (3 + 4 * k_ex))
        one = tuple(a[:1] for a in args)
        scan_rows.append(dict(
            replica=rid, queries=q, max_abs_err=max_abs_diff(ks[0], kp[0]), ms=time_ms(scan, 10),
            plain_ms=time_ms(scan_plain, 2), bound_ms=bound(*work)[0], work=work,
            q1_ms=time_ms(lambda: scan(one), 10),
        ))

        # select compaction on the group's selects with matches
        matched = ks[1].cpu().numpy().astype(np.int64)
        sel_idx = [i for i, qq in enumerate(qs) if qq.agg == "select" and matched[i] > 0]
        if not sel_idx:
            continue
        idx = torch.tensor(sel_idx, device=dev)
        s_args = (d["res_lo"][idx], d["res_hi"][idx], d["limits"][idx])
        counts = matched[sel_idx]

        def sel():
            return select_compact(st["keys"], *s_args, counts, col_parts=cp)

        def sel_plain():
            return select_compact_plain(st["keys"], *s_args, counts, col_parts=cp)

        fs, fp = sel(), sel_plain()
        check(torch.equal(fs, fp), f"select_compact (replica {rid}): indices differ from plain")
        work = (
            4 * n * k_ex + len(sel_idx) * (8 * k_ex + 8) + 4 * int(counts.sum()),
            len(sel_idx) * n * (3 + 2 * k_ex),
        )
        sel_rows.append(dict(
            replica=rid, queries=len(sel_idx), max_abs_err=max_abs_diff(fs, fp), ms=time_ms(sel, 10),
            plain_ms=time_ms(sel_plain, 2), bound_ms=bound(*work)[0], work=work,
        ))
    check(len(sel_rows) > 0, "select_compact: no group of the batch had selects with matches")

    def summed(rows):
        """The batch's launches together: times summed, and the bound of
        their bytes and operations summed."""
        b, by = bound(sum(r["work"][0] for r in rows), sum(r["work"][1] for r in rows))
        return dict(
            max_abs_err=max(r["max_abs_err"] for r in rows), ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows), bound_ms=b, bound_by=by, library_ms=None,
            per=f"read_many batch of {len(batch)} ({len(rows)} launches)",
            groups=[{k: v for k, v in r.items() if k != "work"} for r in rows],
        )

    report = {"scan_agg_locate": summed(scan_rows), "select_compact": summed(sel_rows)}
    kernel_ms = report["scan_agg_locate"]["ms"] + report["select_compact"]["ms"]
    layer = {
        "read_many_wall_ms": wall_ms, "read_kernels_ms": kernel_ms,
        "read_host_ms": wall_ms - kernel_ms, "operand_upload_bytes": upload_bytes,
        "groups": {str(rid): len(qs) for rid, qs in groups.items()},
    }
    torch.cuda.synchronize()
    return report, layer


def profile_batch(eng, cf_name, batch) -> dict:
    """One ``read_many`` batch under ``torch.profiler``: its host wall, the
    union of the device's kernel and copy intervals (busy time), and the
    device time of each kernel by name. The profiler's own host cost
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
    return {
        "queries": len(batch), "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": (1.0 - busy_us / 1e3 / wall_ms) if spans else None,
        "device_ms_by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12]),
    }


# -- main path -----------------------------------------------------------------------


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=5.0, help="TPC-H scale factor (1.5 M rows each)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated data")
    ap.add_argument(
        "--profile", action="store_true",
        help="after the reads, trace one fresh read_many batch with torch.profiler "
        "and print the device's busy time and its kernels' times",
    )
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

    # 2. kernels against their plain versions
    report = phases.run("kernels", kernel_phase, key_cols, value_cols, writes, dev)

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
        check_answers(eng, "orders", list(zip(batches[0][::4], outs[0][::4])), key_cols, value_cols, "before writes")
        check_answers(eng, "orders", list(zip(wide, wide_out)), key_cols, value_cols, "wide")

    phases.run("reads", reads)
    print(f"read_many batch ms (host clock): {[round(x, 3) for x in batch_ms]}", flush=True)
    if args.profile:
        fresh = read_batches(n_rows, args.seed + 1)[0]
        print(json.dumps({"profile": profile_batch(eng, "orders", fresh)}), flush=True)

    # 5. writes, device compaction, reads over every row
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
        all_k = {c: np.concatenate([key_cols[c]] + [w[0][c] for w in writes]) for c in key_cols}
        all_v = {c: np.concatenate([value_cols[c]] + [w[1][c] for w in writes]) for c in value_cols}
        out = eng.read_many("orders", batches[2])
        check_answers(eng, "orders", list(zip(batches[2][::4], out[::4])), all_k, all_v, "after writes")
        wide = wide_batch()
        check_answers(eng, "orders", list(zip(wide, eng.read_many("orders", wide))), all_k, all_v, "wide after writes")
        check(cf.stats.n_rows == len(all_k["custkey"]), "statistics missed rows")

    phases.run("writes", writes_phase)

    launches = {name: fn.launches for name, fn in K.KERNELS.items()}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    stats = eng.stats
    write_layer = {
        "replica_flushes": stats["memtable_flushes"], "compactions": stats["compactions"],
        "flush_wall_ms_per_replica_flush": stats["flush_wall_seconds"] * 1e3 / stats["memtable_flushes"],
    }

    # 6. the read kernels on the replica groups of one fresh batch
    fresh = read_batches(n_rows, args.seed + 3)[0]
    group_report, read_layer = phases.run("groups", group_phase, eng, "orders", fresh, dev)
    report.update(group_report)

    # 7. report
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
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
