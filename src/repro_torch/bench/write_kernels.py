"""Device time of the write path's two kernels on an NVIDIA GPU, at the
shapes the TPC-H ``orders`` write drip gives them. ``chip_smoke.py``
takes its merge-rank and histogram measurements from the functions here.

* ``merge`` (:func:`merge_case`): ``merge_run_positions`` on the run stack
  that compaction folds after the 8th write of 20,000 rows (an SF-scale
  base in layout (clerk, orderdate, custkey) plus eight appended runs,
  :func:`run_stack`), held equal to ``merge_run_positions_plain`` and to
  the host merge order (``row_map``); and on a stack of the same shape
  whose appended runs copy key tuples of the base and of each other
  (``dup_stack``: every appended key equals keys of other runs).
* ``hist`` (:func:`hist_case`): ``ecdf_hist`` on each of the three key
  columns of one write batch, binned as the column family's statistics
  bin them, held equal to ``ecdf_hist_plain`` and to ``np.bincount``;
  ``ecdf_hist_many`` on the three at once; beside them
  ``torch.bincount`` in turns (kernel, library, library, kernel), and an
  empty kernel launched the same way (``empty_launch``), the floor a
  launch of this size cannot go under; the batched call in turns with
  ``torch.bincount`` on each of the three columns.

Each call is timed by CUDA events over many calls (``ms``: the device's
time with the host's gaps between launches) and under ``torch.profiler``
(``device_ms``: every kernel and memset the call puts on the card, from
``bench.fused_scan.device_ms`` with no kernel names).

Run on the card from the root of a checkout:
``PYTHONPATH=src python -m repro_torch.bench.write_kernels``; it prints
one JSON line, with the card's name and power limit, and writes no file.
Without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from ..core import SortedTable, TableStats
from ..core.storage.memtable import sort_run
from ..core.tpch import ROWS_PER_SF, generate_orders, orders_schema
from ..kernels.ecdf_hist import ecdf_hist, ecdf_hist_many, ecdf_hist_many_plain, ecdf_hist_plain, empty_launch
from ..kernels.merge_runs import merge_run_positions, merge_run_positions_plain
from .fused_scan import card_line, device_ms, events_ms

__all__ = [
    "LAYOUT",
    "WRITE_ROWS",
    "dup_stack",
    "hist_case",
    "merge_case",
    "merge_design_bytes",
    "merge_work",
    "run",
    "run_stack",
    "write_batches",
]

WRITE_ROWS = 20_000
LAYOUT = ("clerk", "orderdate", "custkey")


def write_batches(seed: int, n: int = 10) -> list:
    """``n`` write batches of ``WRITE_ROWS`` rows, (key columns, value
    columns) each: the 20,000-row slices of 200,000 generated rows that
    ``chip_smoke.py`` writes."""
    wk, wv = generate_orders(1.0, seed=seed, rows_per_sf=10 * WRITE_ROWS)
    sl = [slice(i * WRITE_ROWS, (i + 1) * WRITE_ROWS) for i in range(n)]
    return [({c: v[s] for c, v in wk.items()}, {c: v[s] for c, v in wv.items()}) for s in sl]


def run_stack(key_cols, value_cols, writes, dev) -> SortedTable:
    """The resident table compaction folds after ``len(writes)`` writes:
    the rows in ``LAYOUT`` on ``dev``, one appended run per write."""
    schema = orders_schema()
    table = SortedTable.from_columns(key_cols, value_cols, LAYOUT, schema).place_on_device(dev)
    for wk, wv in writes:
        table = table.merge_run(sort_run(wk, wv, table.layout, schema))
    return table


def dup_stack(keys: torch.Tensor, n_base: int, n_lanes: int, *, run_rows: int, n_runs: int = 8,
              pool: int = 4096, seed: int = 0):
    """A run stack of the same shape as :func:`run_stack`'s whose appended
    runs hold only key tuples of the base: the first ``n_base`` rows of
    ``keys`` (sorted) and ``n_runs`` runs of ``run_rows`` rows, each a
    sorted draw with replacement from the same ``pool`` base rows, so
    every appended key equals keys of the base and of the other runs.
    Returns (keys int32[n_lanes, n_rows], run starts, n_rows)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    picks = torch.randperm(n_base, generator=g)[:pool]
    runs = [keys[:n_lanes, :n_base]]
    for _ in range(n_runs):
        idx = picks[torch.randint(0, picks.numel(), (run_rows,), generator=g)]
        runs.append(keys[:n_lanes, torch.sort(idx).values.to(keys.device)])
    starts = (0,) + tuple(n_base + i * run_rows for i in range(n_runs))
    return torch.cat(runs, dim=1).contiguous(), starts, n_base + n_runs * run_rows


def merge_case(keys, starts, n_rows: int, n_lanes: int, *, row_map=None, reps: int = 10) -> dict:
    """``merge_run_positions`` on one stack; raises ``AssertionError`` if
    it differs from plain or from ``row_map`` (when given). Times by
    events and under the profiler, the plain version's by events."""

    def kernel():
        return merge_run_positions(keys, starts, n_rows, n_lanes=n_lanes)

    def plain():
        return merge_run_positions_plain(keys, starts, n_rows, n_lanes=n_lanes)

    got, want = kernel(), plain()
    if not torch.equal(got, want):
        raise AssertionError("merge_run_positions: permutation differs from plain")
    if row_map is not None and not np.array_equal(got.cpu().numpy(), row_map):
        raise AssertionError("merge_run_positions: differs from the host merge order")
    lens = np.diff(np.asarray(tuple(starts) + (n_rows,), np.int64))
    parts = device_ms(kernel, reps, parts=True)
    return dict(
        rows=n_rows, runs=len(starts), run_rows=lens.tolist(), lanes=n_lanes,
        max_abs_err=float((got - want).abs().max()) if n_rows else 0.0,
        ms=events_ms(kernel, reps), device_ms=sum(parts.values()), device_parts_ms=parts,
        plain_ms=events_ms(plain, 2),
    )


def _turns(kernel, library, reps: int) -> dict:
    """``kernel`` and ``library`` in turns (kernel, library, library,
    kernel), by events and on the device; each figure the mean of its
    two turns."""
    turns = [events_ms(kernel, reps), events_ms(library, reps), events_ms(library, reps), events_ms(kernel, reps)]
    dev_turns = [device_ms(kernel, reps), device_ms(library, reps), device_ms(library, reps), device_ms(kernel, reps)]
    return dict(
        ms=(turns[0] + turns[3]) / 2, library_ms=(turns[1] + turns[2]) / 2, turns_ms=turns,
        device_ms=(dev_turns[0] + dev_turns[3]) / 2,
        library_device_ms=(dev_turns[1] + dev_turns[2]) / 2, device_turns_ms=dev_turns,
    )


def hist_case(cols: dict, stats: TableStats, dev, *, reps: int = 50) -> dict:
    """The histogram of each of ``cols`` (int arrays of one write batch),
    binned as ``stats`` bins them: ``ecdf_hist`` per column and
    ``ecdf_hist_many`` on all at once, each equal to plain and to
    ``np.bincount`` (else ``AssertionError``); events and device times,
    ``torch.bincount`` in turns, and the empty launch."""
    names = list(cols)
    bins = [stats.columns[c].n_bins for c in names]
    widths = [stats.columns[c].bin_width for c in names]
    host = np.stack([np.asarray(cols[c], np.int32) for c in names])
    t = torch.from_numpy(host).to(dev)
    out: dict = {"columns": names, "rows": int(host.shape[1]), "n_bins": bins, "bin_widths": widths}
    per = {}
    for i, c in enumerate(names):
        col, nb, bw = t[i], bins[i], widths[i]

        def kernel(col=col, nb=nb, bw=bw):
            return ecdf_hist(col, n_bins=nb, bin_width=bw)

        def plain(col=col, nb=nb, bw=bw):
            return ecdf_hist_plain(col, n_bins=nb, bin_width=bw)

        def library(col=col, nb=nb, bw=bw):
            return torch.bincount(torch.div(col, bw, rounding_mode="floor"), minlength=nb)

        got = kernel()
        if not torch.equal(got, plain()):
            raise AssertionError(f"ecdf_hist ({c}): counts differ from plain")
        want = np.bincount(host[i] // bw, minlength=nb).astype(np.float32)
        if not np.array_equal(got.cpu().numpy(), want):
            raise AssertionError(f"ecdf_hist ({c}): counts differ from np.bincount")
        per[c] = dict(
            _turns(kernel, library, reps), plain_ms=events_ms(plain, 5),
            max_abs_err=float((got - plain()).abs().max()),
        )
    out["per_column"] = per

    def batched():
        return ecdf_hist_many(t, n_bins=bins, bin_widths=widths)

    def batched_plain():
        return ecdf_hist_many_plain(t, n_bins=bins, bin_widths=widths)

    def library():
        return [
            torch.bincount(torch.div(t[i], widths[i], rounding_mode="floor"), minlength=bins[i])
            for i in range(len(names))
        ]

    got = batched()
    if not torch.equal(got, batched_plain()):
        raise AssertionError("ecdf_hist_many: counts differ from plain")
    want = np.concatenate(
        [np.bincount(host[i] // widths[i], minlength=bins[i]) for i in range(len(names))]
    ).astype(np.float32)
    if not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError("ecdf_hist_many: counts differ from np.bincount")
    out["batched"] = dict(
        _turns(batched, library, reps), plain_ms=events_ms(batched_plain, 5),
        max_abs_err=float((got - batched_plain()).abs().max()),
    )

    def nothing():
        empty_launch(t)

    out["empty_launch"] = dict(ms=events_ms(nothing, reps), device_ms=device_ms(nothing, reps))
    return out


def _searches(run_lens) -> tuple[int, float]:
    """The rows that search (all but the largest run's, ties in size to
    the higher index) and the binary-search steps of the searches of the
    smaller-searches-larger scheme (``ceil(log2 m) + 1`` a search of an
    ``m``-row run)."""
    lens = [int(m) for m in run_lens]
    big = max(range(len(lens)), key=lambda t: (lens[t], t)) if lens else 0
    probes = 0.0
    for s, ms in enumerate(lens):
        for t, mt in enumerate(lens):
            if t != s and mt > 0 and (mt, t) > (ms, s):
                probes += ms * (math.ceil(math.log2(mt)) + 1)
    return sum(lens) - (lens[big] if lens else 0), probes


def merge_work(run_lens, n_lanes: int) -> tuple[float, float]:
    """Bytes and operations the bound of a merge over runs of
    ``run_lens`` rows counts: what the function needs, whatever the
    design. Bytes: the int64 position of every row, written once, and the
    key lanes of the rows that search, read once (the largest run's
    positions follow from where the others fall in it, so its keys are
    read only by the searches' probes). Operations: every probe of the
    searches, ``n_lanes`` lane compares and a step (``n_lanes + 2``)."""
    n_search, probes = _searches(run_lens)
    return float(8 * sum(int(m) for m in run_lens) + 4 * n_lanes * n_search), probes * (n_lanes + 2)


def merge_design_bytes(run_lens, n_lanes: int) -> float:
    """Bytes ``csrc/merge_rank.cu`` itself moves over runs of
    ``run_lens`` rows, beyond the probes: a row's difference-array word
    zeroed and read by the scan and its int64 position written (16 B),
    and for a searching row also its key lanes and its partial position
    zeroed and read back (``4 * n_lanes + 16`` B)."""
    n_search, _ = _searches(run_lens)
    return float(16 * sum(int(m) for m in run_lens) + (4 * n_lanes + 16) * n_search)


def run(*, n_rows: int = 5 * ROWS_PER_SF, seed: int = 0) -> dict:
    """The measurements at ``n_rows`` base rows of ``orders`` on the
    current CUDA device; the card's name and power limit ride along."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench.write_kernels measures on an NVIDIA GPU; no CUDA device found")
    dev = torch.device("cuda")
    kc, vc = generate_orders(n_rows / ROWS_PER_SF, seed=seed)
    writes = write_batches(seed + 1)
    out = {"card": card_line(), "rows": len(kc["custkey"])}
    table = run_stack(kc, vc, writes[:8], dev)
    st = table._device
    lanes = sum(st["col_parts"])
    out["merge"] = merge_case(st["keys"], st["run_starts"], st["n_rows"], lanes, row_map=st["row_map"])
    keys, starts, n = dup_stack(
        st["keys"], st["run_starts"][1], lanes, run_rows=st["n_rows"] - st["run_starts"][-1], seed=seed
    )
    del table, st
    out["merge_dup"] = merge_case(keys, starts, n, lanes)
    del keys
    torch.cuda.empty_cache()
    stats = TableStats.from_columns({c: v[:1] for c, v in kc.items()}, orders_schema())
    out["hist"] = hist_case(writes[0][0], stats, dev)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=5 * ROWS_PER_SF, help="orders base rows (TPC-H SF 5: 7,500,000)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated data")
    args = ap.parse_args(argv)
    print(json.dumps(run(n_rows=args.rows, seed=args.seed)))


if __name__ == "__main__":
    main()
