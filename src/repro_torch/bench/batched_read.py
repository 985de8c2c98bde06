"""Batched read throughput of one replica's storage engines: the port's
counterpart of ``run_device`` in ``benchmarks/batched_read.py``.

One TPC-H ``orders`` replica (layout custkey, orderdate, clerk) answers the
same batch of Q1/Q2 sums through five engines, per batch size:

* ``numpy``   — ``SortedTable.execute_many`` on a host twin (the reference
  engine: host ``searchsorted`` and a residual scan per query);
* ``qgrid``   — ``table_scan_device_many(grid="queries_outer")`` over host
  slabs: queries outer, every row read once per query;
* ``rowgrid`` — ``table_scan_device_many(grid="rows_outer")`` over host
  slabs: rows outer, the columns stream once per batch;
* ``rowgrid_device_slabs`` — the same scan with ``slabs=None``: the
  resident table locates its slabs with the k-ary search kernel
  (``slab_many`` → ``slab_locate``);
* ``fused``   — ``table_execute_device_many``: one fused locate+scan.

Every engine's answers are held against the numpy engine's before any
timing: counts and slab rows equal, sums within rtol 1e-5 / atol 1e-3.
Each engine is then timed call by call, wall time between CUDA events on
the card (each call ends with its answers on the host), or on the host
clock for the CPU; the result is the median in queries per second.

Run on the card from the root of a checkout:
``PYTHONPATH=src python -m repro_torch.bench.batched_read --rows 7500000``;
it prints one JSON line. It writes no file.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core import Query, SortedTable
from ..core.tpch import generate_orders, orders_schema, q1_q2_workload
from ..kernels.ops import table_execute_device_many, table_scan_device_many

__all__ = ["ENGINES", "run_device"]

ENGINES = ("numpy", "qgrid", "rowgrid", "rowgrid_device_slabs", "fused")
RTOL, ATOL = 1e-5, 1e-3


def _seconds(fn, device: torch.device) -> float:
    """Wall seconds of one call: between CUDA events on the card (the call
    returns its answers on the host, so the device work is inside), on
    the host clock on the CPU."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _check_against(name, ref, got) -> None:
    """``got`` ([(value, count)] or ScanResults) against the numpy
    engine's ScanResults."""
    for i, (r, g) in enumerate(zip(ref, got)):
        value, count = (g.value, g.rows_matched) if hasattr(g, "rows_matched") else g
        if count != r.rows_matched or not np.isclose(value, r.value, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{name} query {i}: ({value}, {count}) != ({r.value}, {r.rows_matched})")
        if hasattr(g, "rows_scanned") and g.rows_scanned != r.rows_scanned:
            raise AssertionError(f"{name} query {i}: rows_scanned {g.rows_scanned} != {r.rows_scanned}")


def run_device(
    n_rows: int = 120_000,
    batch_sizes=(16, 64, 256),
    seed: int = 0,
    repeats: int = 3,
    numpy_repeats: int | None = None,
    device=None,
) -> dict:
    """The five engines on one replica of ``n_rows`` orders rows, resident
    on ``device`` (default ``cuda``). Returns ``{"device", "n_rows",
    "repeats", "batches": {batch_size: {<engine>_qps, ...,
    rowgrid_over_qgrid, rowgrid_over_numpy, fused_over_rowgrid}}}``.
    ``numpy_repeats`` caps the host engine's repeats (default
    ``repeats``)."""
    device = torch.device("cuda" if device is None else device)
    kc, vc = generate_orders(1.0, seed=seed, rows_per_sf=n_rows)
    wl = q1_q2_workload(max(batch_sizes), seed=seed + 1, n_rows=n_rows)
    queries_all = [Query(filters=q.filters, agg="sum", value_col="totalprice") for q in wl.queries]
    dev = SortedTable.from_columns(
        kc, vc, ("custkey", "orderdate", "clerk"), orders_schema()
    ).place_on_device(device)
    # the host twin shares the column arrays and has no resident tensors
    host = SortedTable(dev.layout, dev.schema, dev.key_cols, dev.value_cols, dev.packed)

    batches: dict = {}
    for bs in batch_sizes:
        queries = queries_all[:bs]
        engines = {
            "numpy": lambda: host.execute_many(queries),
            "qgrid": lambda: table_scan_device_many(
                dev, queries, slabs=host.slab_many(queries), grid="queries_outer"
            ),
            "rowgrid": lambda: table_scan_device_many(
                dev, queries, slabs=host.slab_many(queries), grid="rows_outer"
            ),
            "rowgrid_device_slabs": lambda: table_scan_device_many(dev, queries, grid="rows_outer"),
            "fused": lambda: table_execute_device_many(dev, queries),
        }
        # every engine once (its warm-up) against the numpy engine
        ref = engines["numpy"]()
        for name in ENGINES[1:]:
            _check_against(name, ref, engines[name]())
        res = {}
        for name in ENGINES:
            n = numpy_repeats if name == "numpy" and numpy_repeats is not None else repeats
            res[f"{name}_qps"] = bs / float(np.median([_seconds(engines[name], device) for _ in range(n)]))
        res["rowgrid_over_qgrid"] = res["rowgrid_qps"] / res["qgrid_qps"]
        res["rowgrid_over_numpy"] = res["rowgrid_qps"] / res["numpy_qps"]
        res["fused_over_rowgrid"] = res["fused_qps"] / res["rowgrid_qps"]
        batches[bs] = res
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"device": name, "n_rows": n_rows, "repeats": repeats, "batches": batches}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=120_000, help="orders rows of the replica")
    ap.add_argument("--batch-sizes", type=int, nargs="+", default=[16, 64, 256])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions")
    out = run_device(
        n_rows=args.rows, batch_sizes=tuple(args.batch_sizes), seed=args.seed,
        repeats=args.repeats, device=args.device,
    )
    print(json.dumps({"batched_read": out}))


if __name__ == "__main__":
    main()
