"""Device time of the fused locate+scan and of the view block sums on an
NVIDIA GPU, at TPC-H ``orders`` scale, on the resident states the read
path meets.

The fused scan (``kernels.slab_locate.scan_agg_locate``) is timed on three
states, each with the share of (query, tile) pairs its skip rule leaves
live (``live_tile_pairs``):

* ``single_run``  — a clerk-led replica (clerk, orderdate, custkey) holding
  one sorted run, and 128 Q1/Q2 queries with an equality on clerk: the
  queries the planner routes to that layout, whose slabs are short;
* ``run_stack``   — the same replica after two appended 20,000-row writes,
  the main path's state between compactions: the tiles that straddle two
  runs span nearly every key and are live for nearly every query;
* ``long_slabs``  — a custkey-led replica (custkey, orderdate, clerk) and
  256 Q1/Q2 queries unrouted, as ``bench.batched_read``'s fused engine
  sends them: every Q1's slab there is the whole table.

Each is timed three ways, as the device time of the kernel's launches
under ``torch.profiler`` per call: back to back (``hot``), after a write
that evicts the 50 MB L2 cache (``cold_l2``), and after a 5 ms idle gap
(``idle``, as a read path with host work between launches meets the
card). ``floor`` is the same launch with operands no pair is live for
(whole windows, an empty slab and residual box): the tile staging, range
reduction and tests alone. ``wrapper_host_ms`` is the host time of one
wrapper call. ``block_sums`` builds one replica's views (all live value
rows, every block) beside ``torch.sum`` over the same blocks, hot and
cold.

Run on the card from the root of a checkout:
``PYTHONPATH=src python -m repro_torch.bench.fused_scan``; it prints one
JSON line and writes no file. Without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..core import Eq, SortedTable
from ..core.storage.memtable import sort_run
from ..core.tpch import ROWS_PER_SF, generate_orders, orders_schema, q1_q2_workload
from ..kernels.block_agg import BLOCK_ROWS, block_sums, scan_tile
from ..kernels.ops import device_query_operands
from ..kernels.slab_locate import live_tile_pairs, scan_agg_locate

__all__ = ["device_ms", "run"]

WRITE_ROWS = 20_000
_FLUSH_BYTES = 160 << 20  # a write this large evicts the L2 cache


def device_ms(fn, reps: int, names: tuple[str, ...], between=None) -> float:
    """Mean device time per call of ``fn``, which launches one kernel of
    each of ``names`` (substrings of kernel names): the sum over the names
    of the mean duration of that kernel's launches under
    ``torch.profiler``, over ``reps`` calls after one warm-up;
    ``between()`` runs before each. Unlike CUDA events around the calls
    it leaves out the host's time between launches, which exceeds a short
    kernel's own. It averages the launches the profiler recorded: in a
    process that has run many profiler sessions, a session may miss some
    of its launches, and dividing by ``reps`` would then undercount.
    Raises if a name recorded none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    durations = {n: [] for n in names}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for n in names:
            if n in ev.name:
                durations[n].append(ev.time_range.end - ev.time_range.start)
    for n, d in durations.items():
        if not d:
            raise RuntimeError(f"the profiler recorded no launch of a kernel named like {n!r}")
    return sum(sum(d) / len(d) for d in durations.values()) / 1e3


def _timings(fn, names, flush) -> dict:
    def idle():
        torch.cuda.synchronize()
        time.sleep(0.005)

    return dict(
        hot=device_ms(fn, 20, names), cold_l2=device_ms(fn, 10, names, flush),
        idle=device_ms(fn, 10, names, idle),
    )


def _scan_state(table, queries, flush) -> dict:
    st = table._device
    cp, n_vals = st["col_parts"], st["n_value_rows"]
    d = device_query_operands(table, queries)
    args = (d["res_lo"], d["res_hi"], d["slab_lo"], d["slab_hi"], d["limits"], d["sel"])
    tile = scan_tile(sum(cp), n_vals)
    live = live_tile_pairs(st["keys"], *args[:5], col_parts=cp, n_rows=st["n_rows"], tile=tile)
    n_tiles = -(-st["n_rows"] // tile)

    def scan(a=args):
        return scan_agg_locate(st["keys"], st["values_tile"], *a, col_parts=cp, n_vals=n_vals)

    # no pair live: whole windows, bounds no key meets (lo at int32's top,
    # hi at its bottom)
    top = torch.full_like(d["res_lo"], torch.iinfo(torch.int32).max)
    bottom = torch.full_like(d["res_lo"], torch.iinfo(torch.int32).min)
    whole = torch.zeros_like(d["limits"])
    whole[:, 1] = st["n_rows"]
    none = (top, bottom, top, bottom, whole, d["sel"])
    names = ("scan_partials", "scan_fold")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        scan()
    host_ms = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize()
    return dict(
        rows=st["n_rows"], runs=st["n_runs"], queries=len(queries), tile=tile,
        live_pairs=int(live.sum()), live_share=int(live.sum()) / (len(queries) * n_tiles),
        ms=_timings(scan, names, flush), fold_hot_ms=device_ms(scan, 20, ("scan_fold",)),
        floor_ms=_timings(lambda: scan(none), names, flush), wrapper_host_ms=host_ms,
    )


def run(*, n_rows: int = 7_500_000, seed: int = 0) -> dict:
    """The measurements at ``n_rows`` rows of ``orders`` on the current CUDA
    device; the card's name rides along."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench.fused_scan measures on an NVIDIA GPU; no CUDA device found")
    dev = torch.device("cuda")
    buf = torch.empty(_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def flush():
        buf.fill_(1.0)

    kc, vc = generate_orders(n_rows / ROWS_PER_SF, seed=seed)
    schema = orders_schema()
    wl = q1_q2_workload(n_instances=512, seed=seed + 2, n_rows=len(kc["custkey"]))
    out = {"device": torch.cuda.get_device_name(0), "rows": len(kc["custkey"])}

    layout = ("clerk", "orderdate", "custkey")
    table = SortedTable.from_columns(kc, vc, layout, schema).place_on_device(dev)
    routed = [q for q in wl.queries if isinstance(q.filters.get("clerk"), Eq)][:128]
    out["single_run"] = _scan_state(table, routed, flush)

    st = table._device
    tile, n, nv, lanes = st["values_tile"], st["n_rows"], st["n_value_rows"], sum(st["col_parts"])
    nb = -(-tile.shape[1] // BLOCK_ROWS)

    def views():
        return block_sums(tile, n_rows=n, block_n=BLOCK_ROWS, n_vals=nv, n_key_lanes=lanes)

    def library():
        return tile[:nv].view(nv, nb, BLOCK_ROWS).sum(dim=2)

    out["block_sums"] = dict(
        rows=n, value_rows=nv,
        ms=dict(hot=device_ms(views, 20, ("block_sums",)), cold_l2=device_ms(views, 10, ("block_sums",), flush)),
        torch_sum_ms=dict(
            hot=device_ms(library, 20, ("reduce_kernel",)),
            cold_l2=device_ms(library, 10, ("reduce_kernel",), flush),
        ),
    )

    # the writes chip_smoke.py makes: 20,000-row slices of 200,000 rows
    wk, wv = generate_orders(1.0, seed=seed + 1, rows_per_sf=10 * WRITE_ROWS)
    for i in range(2):
        sl = slice(i * WRITE_ROWS, (i + 1) * WRITE_ROWS)
        table = table.merge_run(
            sort_run({c: v[sl] for c, v in wk.items()}, {c: v[sl] for c, v in wv.items()}, layout, schema)
        )
    out["run_stack"] = _scan_state(table, routed, flush)
    del table, st, tile
    torch.cuda.empty_cache()

    table = SortedTable.from_columns(kc, vc, ("custkey", "orderdate", "clerk"), schema).place_on_device(dev)
    out["long_slabs"] = _scan_state(table, list(wl.queries[:256]), flush)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=7_500_000, help="orders rows (TPC-H SF 5: 7,500,000)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated data")
    args = ap.parse_args(argv)
    print(json.dumps(run(n_rows=args.rows, seed=args.seed)))


if __name__ == "__main__":
    main()
