"""Device time of the select compaction, pass by pass, and of the slab
location kernel beside ``torch.searchsorted``, on an NVIDIA GPU at TPC-H
``orders`` scale. ``chip_smoke.py`` takes its select and slab-location
measurements from the functions here.

An RF 3 ``orders`` column family in the HR layouts ``chip_smoke.py``'s
CREATE chooses, (clerk, orderdate, custkey), (custkey, orderdate, clerk)
and (custkey, clerk, orderdate), is created device-resident on the card
and serves fresh ``read_many`` batches of 256 (128 Q1/Q2 sums, 64 counts
and 64 selects with the same filters):

* ``select`` (:func:`select_group`): on each replica group a batch forms,
  ``select_compact`` on the group's selects with matches (the launch
  ``read_many`` makes), held equal to ``select_compact_plain`` and timed
  by CUDA events (``ms``) and under ``torch.profiler`` (``device_ms``, and
  each of the kernel's three passes, ``select_counts``, ``select_scan``
  and ``select_scatter``, apart). Beside it: the (query, 256-row segment)
  pairs the counting pass's skip rule leaves live (``select_live_pairs``),
  the (query, 8192-row block) pairs that hold a match, and the bound
  counted from them (:func:`select_work`). Once on the single-run
  replicas after CREATE (``single_run``), once after two 20,000-row
  writes have left each replica a stack of three runs (``run_stack``, the
  state the main path serves between compactions).
* ``slab_locate`` (:func:`slab_locate_turns`): on each single-run
  replica, the slabs of a fresh batch of 256 (its selects turned into
  counts, as ``chip_smoke.py``'s row-slab phase sends them), held equal to
  ``slab_locate_plain`` and to ``torch.searchsorted`` on the packed key,
  and the two timed in turns (kernel, library, library, kernel) by CUDA
  events and under ``torch.profiler``; with each search's dependent probe
  rounds.
* ``load_latency_ns`` (:func:`load_latency_ns`): the device time of one
  dependent load, from device memory and from L2, the unit of the slab
  location's latency bound.

Run on the card from the root of a checkout:
``PYTHONPATH=src python -m repro_torch.bench.select_slab``; it prints one
JSON line, with the card's name and power limit, and writes no file.
Without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from ..core import HREngine, Query
from ..core.table import slab_bounds_many
from ..core.tpch import ROWS_PER_SF, generate_orders, orders_schema, q1_q2_workload
from ..kernels import _build
from ..kernels.block_agg import BLOCK_ROWS
from ..kernels.ops import device_query_operands
from ..kernels.slab_locate import (
    _RANK_SIG,
    SELECT_SEG_ROWS,
    _raw_stream,
    kary_rounds,
    scan_agg_locate,
    select_compact,
    select_compact_plain,
    select_live_pairs,
    slab_locate,
    slab_locate_plain,
)
from .fused_scan import bound_ms, card_line, device_ms, events_ms

__all__ = [
    "LATENCY_BUFFERS",
    "LAYOUTS",
    "SELECT_PASSES",
    "load_latency_ns",
    "run",
    "select_group",
    "select_work",
    "slab_locate_turns",
]

LAYOUTS = (("clerk", "orderdate", "custkey"), ("custkey", "orderdate", "clerk"), ("custkey", "clerk", "orderdate"))
SELECT_PASSES = ("select_counts", "select_scan", "select_scatter")
#: Buffers of the load-latency chase: one far larger than the 50 MB L2, one
#: that fits it.
LATENCY_BUFFERS = {"device_memory": 512 << 20, "l2": 4 << 20}
WRITE_ROWS = 20_000
BATCH = 256


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def select_work(keys, res_lo, res_hi, limits, counts, *, col_parts, n_rows: int) -> tuple[tuple[float, float], dict]:
    """Bytes and operations the select compaction needs on these operands,
    counted from the pairs its skip rule leaves live: the key lanes of the
    table's rows once, the operands, the offsets and the indices once; the
    residual predicate (two compares a lane) for every row of a live
    (query, segment) pair inside its window. Also the live pairs: (query,
    segment) pairs live by the rule, and (query, block) pairs holding a
    match (the pairs the scatter visits)."""
    k_ex = sum(col_parts)
    q = res_lo.shape[0]
    live = select_live_pairs(keys, res_lo, res_hi, limits, col_parts=col_parts)
    start = torch.arange(live.shape[1], device=live.device, dtype=torch.int64) * SELECT_SEG_ROWS
    lim = limits.long()
    inside = (torch.minimum(start + SELECT_SEG_ROWS, lim[:, 1:2].clamp(max=n_rows)) - torch.maximum(start, lim[:, 0:1])).clamp(min=0)
    live_rows = int((inside * live).sum())
    rows = select_compact_plain(keys, res_lo, res_hi, limits, counts, col_parts=col_parts).long()
    owner = torch.repeat_interleave(torch.arange(q, device=rows.device), torch.as_tensor(counts, device=rows.device))
    block_pairs = int(torch.unique(owner * (1 << 20) + rows // BLOCK_ROWS).numel())
    n_seg = -(-n_rows // SELECT_SEG_ROWS)
    work = (4 * n_rows * k_ex + q * (8 * k_ex + 8) + 8 * (q + 1) + 4 * int(np.sum(counts)), live_rows * 2 * k_ex)
    share = dict(
        segments=n_seg, live_pairs=int(live.sum()), live_share=int(live.sum()) / (q * n_seg),
        live_rows=live_rows, match_block_pairs=block_pairs, matches=int(np.sum(counts)),
    )
    return work, share


def select_group(st, d, aggs, matched, *, reps: int = 10) -> dict | None:
    """``select_compact`` on one replica group's selects with matches (the
    launch ``read_many`` makes after the fused scan, whose ``matched``
    counts size it), on the device state ``st`` and the group's operands
    ``d``; raises ``AssertionError`` if it differs from its plain version.
    Returns the measured numbers: ``ms`` (CUDA events), ``device_ms`` and
    ``pass_device_ms`` (``torch.profiler``, the three passes together and
    apart), ``plain_ms`` and ``max_abs_err``; beside them, under ``work``,
    the bytes and operations of the bound, and under ``live``, the pairs
    :func:`select_work` counts. None if no select of the group has a
    match."""
    matched = matched.cpu().numpy().astype(np.int64)
    sel_idx = [i for i, agg in enumerate(aggs) if agg == "select" and matched[i] > 0]
    if not sel_idx:
        return None
    cp = st["col_parts"]
    idx = torch.tensor(sel_idx, device=st["keys"].device)
    args = (st["keys"], d["res_lo"][idx], d["res_hi"][idx], d["limits"][idx], matched[sel_idx])

    def sel():
        return select_compact(*args, col_parts=cp)

    def sel_plain():
        return select_compact_plain(*args, col_parts=cp)

    got, want = sel(), sel_plain()
    if not torch.equal(got, want):
        raise AssertionError(f"select_compact ({len(sel_idx)} selects): indices differ from plain")
    work, live = select_work(*args, col_parts=cp, n_rows=st["n_rows"])
    return dict(
        runs=st["n_runs"], queries=len(sel_idx), max_abs_err=_max_abs_err(got, want), ms=events_ms(sel, reps),
        device_ms=device_ms(sel, reps, SELECT_PASSES),
        pass_device_ms={p: device_ms(sel, reps, (p,)) for p in SELECT_PASSES},
        plain_ms=events_ms(sel_plain, 2), work=work, live=live,
    )


def slab_locate_turns(table, batch, *, reps: int = 20) -> tuple[dict, torch.Tensor]:
    """``slab_locate`` on a resident single-run replica table's slabs of
    ``batch``; raises ``AssertionError`` if its ranks differ from
    ``slab_locate_plain`` or from ``torch.searchsorted`` on the packed key.
    The kernel and ``torch.searchsorted`` are timed in turns (kernel,
    library, library, kernel) by CUDA events (``ms``, ``library_ms``,
    ``turns_ms``) and under ``torch.profiler`` (``device_ms``,
    ``library_device_ms``, ``device_turns_ms``); also ``plain_ms`` and
    ``max_abs_err``. Beside the measured numbers: under ``work``, a binary
    search's probes of every key lane on both sides (the bound's bytes and
    operations), and under ``rounds``, the most dependent rounds a query's
    window takes, of the k-ary search and of a binary search. Returns that
    and the ranks."""
    st = table._device
    d = device_query_operands(table, batch)
    args = (st["keys"], d["slab_lo"], d["slab_hi"], d["limits"])
    dev = st["keys"].device
    packed = torch.from_numpy(table.packed).to(dev)
    bnd = slab_bounds_many(batch, table.layout, table.schema)
    bnd[:, 1] += 1  # inclusive hi: side="right" of hi is side="left" of hi + 1
    bnd_t = torch.from_numpy(bnd).to(dev)

    def kernel():
        return slab_locate(*args)

    def plain():
        return slab_locate_plain(*args)

    def library():
        return torch.searchsorted(packed, bnd_t)

    got, want = kernel(), plain()
    what = f"slab_locate (replica table {table.layout})"
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: ranks differ from plain")
    if not torch.equal(got.long(), library()):
        raise AssertionError(f"{what}: ranks differ from torch.searchsorted")
    turns = [events_ms(kernel, reps), events_ms(library, reps), events_ms(library, reps), events_ms(kernel, reps)]
    dev_turns = [
        device_ms(kernel, reps, ("slab_rank",)), device_ms(library, reps, ("searchsorted",)),
        device_ms(library, reps, ("searchsorted",)), device_ms(kernel, reps, ("slab_rank",)),
    ]
    win = (d["limits"][:, 1] - d["limits"][:, 0]).cpu().numpy()
    lanes = d["slab_lo"].shape[1]
    probes = float(2 * np.ceil(np.log2(win.astype(np.float64) + 1)).sum())
    q = len(batch)
    row = dict(
        queries=q, max_abs_err=_max_abs_err(got, want),
        ms=(turns[0] + turns[3]) / 2, library_ms=(turns[1] + turns[2]) / 2, turns_ms=turns,
        device_ms=(dev_turns[0] + dev_turns[3]) / 2, library_device_ms=(dev_turns[1] + dev_turns[2]) / 2,
        device_turns_ms=dev_turns, plain_ms=events_ms(plain, 2),
        work=(4 * lanes * probes + q * (8 * lanes + 8) + 8 * q, 2 * lanes * probes),
        rounds=dict(
            kary=max(kary_rounds(int(w)) for w in win),
            binary=max(math.ceil(math.log2(int(w) + 1)) for w in win),
        ),
    )
    return row, got


def load_latency_ns(dev, n_bytes: int, *, steps: int = 1 << 14, seed: int = 0) -> float:
    """Device time of one dependent load on ``dev``, in ns: one thread
    follows a random cycle through an int32 buffer of ``n_bytes``
    (``load_chase`` in ``csrc/slab_rank.cu``), ``steps`` loads a launch,
    each launch resuming where the last stopped; the launch's device time
    under ``torch.profiler`` over ``steps``."""
    n = n_bytes // 4
    g = torch.Generator(device=dev).manual_seed(seed)
    perm = torch.randperm(n, device=dev, generator=g)
    nxt = torch.empty(n, dtype=torch.int32, device=dev)
    nxt[perm] = torch.roll(perm, -1).to(torch.int32)
    del perm
    at = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = _raw_stream(at.device)  # the tensor's device has an index
    lib = _build.load("slab_rank", _RANK_SIG)

    def chase():
        _build.check(lib.load_chase_launch(nxt.data_ptr(), steps, at.data_ptr(), stream), "load_chase_launch")

    return device_ms(chase, 3, ("load_chase",)) * 1e6 / steps


def _fresh_batch(n_rows: int, seed: int) -> list:
    wl = q1_q2_workload(n_instances=BATCH, seed=seed, n_rows=n_rows)
    qs = wl.queries
    return (
        list(qs[: BATCH // 2])
        + [Query(filters=q.filters, agg="count") for q in qs[BATCH // 2 : 3 * BATCH // 4]]
        + [Query(filters=q.filters, agg="select") for q in qs[3 * BATCH // 4 :]]
    )


def _select_groups(eng, batch) -> list[dict]:
    cf = eng.column_families["orders"]
    handles = {r.replica_id: r for r in cf.replicas}
    groups: dict[int, list] = {}
    for q, (_, rep) in zip(batch, eng.read_many("orders", batch)):
        groups.setdefault(rep.replica_id, []).append(q)
    out = []
    for rid, qs in sorted(groups.items()):
        table = eng._table(cf, handles[rid])
        st = table._device
        d = device_query_operands(table, qs)
        _, matched, _ = scan_agg_locate(
            st["keys"], st["values_tile"], d["res_lo"], d["res_hi"], d["slab_lo"], d["slab_hi"],
            d["limits"], d["sel"], col_parts=st["col_parts"], n_vals=st["n_value_rows"],
        )
        row = select_group(st, d, [q.agg for q in qs], matched, reps=20)
        if row is not None:
            work, live = row.pop("work"), row.pop("live")
            b, by = bound_ms(*work)
            out.append(dict(replica=rid, rows=st["n_rows"], **live, **row, bound_ms=b, bound_by=by))
    return out


def run(*, n_rows: int = 7_500_000, seed: int = 0) -> dict:
    """The measurements at ``n_rows`` rows of ``orders`` on the current CUDA
    device; the card's name and power limit ride along."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench.select_slab measures on an NVIDIA GPU; no CUDA device found")
    dev = torch.device("cuda")
    kc, vc = generate_orders(n_rows / ROWS_PER_SF, seed=seed)
    n = len(kc["custkey"])
    eng = HREngine(n_nodes=6, device=dev)
    eng.create_column_family(
        "orders", kc, vc, replication_factor=3, layouts=LAYOUTS, schema=orders_schema(), device_resident=True,
    )
    out = {"card": card_line(), "device": torch.cuda.get_device_name(0), "rows": n}
    out["select"] = {"single_run": _select_groups(eng, _fresh_batch(n, seed + 3))}
    slab_batch = [q if q.agg != "select" else Query(filters=q.filters, agg="count") for q in _fresh_batch(n, seed + 4)]
    cf = eng.column_families["orders"]
    out["slab_locate"] = []
    for r in cf.replicas:
        row, _ = slab_locate_turns(eng._table(cf, r), slab_batch)
        row.pop("work")
        out["slab_locate"].append(dict(replica=r.replica_id, layout=list(eng._table(cf, r).layout), **row))
    out["load_latency_ns"] = {name: load_latency_ns(dev, nb) for name, nb in LATENCY_BUFFERS.items()}
    wk, wv = generate_orders(1.0, seed=seed + 1, rows_per_sf=2 * WRITE_ROWS)
    for i in range(2):
        sl = slice(i * WRITE_ROWS, (i + 1) * WRITE_ROWS)
        eng.write("orders", {c: v[sl] for c, v in wk.items()}, {c: v[sl] for c, v in wv.items()})
    out["select"]["run_stack"] = _select_groups(eng, _fresh_batch(n, seed + 5))
    for state in out["select"].values():
        if not state:
            raise AssertionError("no replica group of the batch had selects with matches")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=7_500_000, help="orders rows (TPC-H SF 5: 7,500,000)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated data")
    args = ap.parse_args(argv)
    print(json.dumps(run(n_rows=args.rows, seed=args.seed)))


if __name__ == "__main__":
    main()
