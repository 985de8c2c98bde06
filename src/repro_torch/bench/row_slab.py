"""Device time of the two row-slab scans on an NVIDIA GPU, at the shapes
``chip_smoke.py``'s ``row_slab`` phase gives them. ``chip_smoke.py``
takes its row-slab scan measurements from the functions here.

The rows are TPC-H ``orders`` (SF 5 by default), held resident in the
three HR layouts of the column family (:data:`LAYOUTS`), each one sorted
run. The batch is ``chip_smoke.py``'s row-slab batch (:func:`row_slab_batch`:
256 Q1/Q2 queries, 128 sums and 128 counts); its slabs come from the k-ary
search kernel (``slab_locate``) and are held equal to the host
searchsorted. Per replica:

* ``rowstream`` (:func:`rowstream_case`): ``scan_agg_rowstream`` on the
  batch, held to its plain version; by events (``ms``) and under
  ``torch.profiler`` (``device_ms``, and each device pass apart in
  ``device_parts_ms``); ``floor``, the same launch with every slab empty;
  ``one``, the launch of the batch's first query alone (Q = 1, as
  ``ops.scan_agg`` and ``table_scan_device`` launch it); on a replica
  whose batch holds whole-table slabs, ``long`` and ``short``, the launch
  on those queries alone and on the rest.
* ``qgrid`` (:func:`qgrid_case`): ``scan_agg_qgrid`` on the batch's sums
  (one value row, as ``table_scan_device_many`` sends them), the same.
* ``fused``: the fused locate+scan (``scan_agg_locate``) on the
  same batch, the read path's own kernel, for comparison.

Beside the times: the (query, row) pairs inside the slabs, the bound
(``bound_ms``: bytes at 3.35 TB/s or operations at the float32 peak, as
every kernel row of ``chip_smoke.py``), the same operations over the
card's int32 rate (``int_bound_ms``), and the bytes the queries-outer
design reads (``design_bytes``: each query's slab rows, key lanes and value).

Run on the card from the root of a checkout:
``PYTHONPATH=src python -m repro_torch.bench.row_slab``; it prints one
JSON line, with the card's name and power limit, and writes no file.
Without a CUDA device it raises.
"""

from __future__ import annotations

import argparse
import json
import re

import numpy as np
import torch

from ..core import Query, SortedTable
from ..core.tpch import ROWS_PER_SF, generate_orders, orders_schema, q1_q2_workload
from ..kernels.ops import device_query_operands
from ..kernels.scan_agg import (
    UNIT_ROWS,
    scan_agg_qgrid,
    scan_agg_qgrid_emulated,
    scan_agg_qgrid_plain,
    scan_agg_rowstream,
    scan_agg_rowstream_emulated,
    scan_agg_rowstream_plain,
)
from ..kernels.slab_locate import scan_agg_locate, slab_locate
from .fused_scan import bound_ms, card_line, device_ms, events_ms

__all__ = [
    "BATCH",
    "LAYOUTS",
    "EDGE_CASES",
    "edge_cases",
    "edge_check",
    "PEAK_INT32_OPS_PER_S",
    "int_bound_ms",
    "qgrid_case",
    "qgrid_design_bytes",
    "row_slab_batch",
    "rowstream_case",
    "run",
    "slab_scan_work",
    "union_rows",
]

LAYOUTS = (("clerk", "orderdate", "custkey"), ("custkey", "orderdate", "clerk"), ("custkey", "clerk", "orderdate"))
BATCH = 256
RTOL, ATOL = 1e-5, 1e-3

#: One H100 SXM's int32 rate outside the tensor cores: 132 SMs x 64 int32
#: lanes x 1.98 GHz boost clock (NVIDIA's data sheet and the Hopper
#: architecture white paper).
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9


def int_bound_ms(ops: float) -> float:
    """The operations over the card's int32 rate, in ms."""
    return ops / PEAK_INT32_OPS_PER_S * 1e3


def row_slab_batch(n_rows: int, seed: int) -> list:
    """``chip_smoke.py``'s row-slab batch for data seed ``seed - 4``: the
    first 256 of the paper's Q1/Q2 instances drawn with seed ``seed + 2``,
    128 sums, then 128 counts with the next queries' filters."""
    wl = q1_q2_workload(n_instances=4 * BATCH, seed=seed + 2, n_rows=n_rows)
    qs = wl.queries[:BATCH]
    return list(qs[: BATCH // 2]) + [Query(filters=q.filters, agg="count") for q in qs[BATCH // 2 :]]


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


def qgrid_design_bytes(slabs, lanes: int) -> float:
    """Bytes the queries-outer design reads: every query its own slab's
    rows, ``lanes`` key lanes and one value each."""
    return float(np.clip(slabs[:, 1] - slabs[:, 0], 0, None).sum()) * (lanes + 1) * 4


def _operands(rng, n: int, q: int, col_parts=(1, 1, 1), n_vals: int = 3, slabs=None) -> dict:
    """Random scan operands over ``n`` rows: narrow key lanes over 16
    values (so residual boxes take some rows of every tile), wide columns
    over 2**33 as lane pairs, bounds with some boxes empty, ``n_vals + 1``
    value rows (one a selector may not take), slabs drawn in ``[-5, n +
    5]`` unless given."""
    lanes, lo, hi = [], [], []
    for parts in col_parts:
        dom = 1 << (4 if parts == 1 else 33)
        col = rng.integers(0, dom, n)
        b_lo = rng.integers(0, dom, q)
        b_hi = np.where(rng.random(q) < 0.1, b_lo, np.minimum(b_lo + rng.integers(1, dom, q), dom))
        if parts == 1:
            lanes.append(col)
            lo.append(b_lo)
            hi.append(b_hi)
        else:
            for dst, v in ((lanes, col), (lo, b_lo), (hi, b_hi)):
                dst.append(v >> 30)
                dst.append(v & ((1 << 30) - 1))
    if slabs is None:
        slabs = np.sort(rng.integers(-5, n + 6, (q, 2)), axis=1)
    return dict(
        keys=np.stack(lanes).astype(np.int32).reshape(len(lanes), n),
        values=rng.uniform(-1, 1, (n_vals + 1, n)).astype(np.float32),
        lo=np.stack(lo, axis=1).astype(np.int32), hi=np.stack(hi, axis=1).astype(np.int32),
        slabs=np.asarray(slabs, np.int64).astype(np.int32).reshape(q, 2),
        sel=rng.integers(0, n_vals, q).astype(np.int32), col_parts=tuple(col_parts), n_vals=n_vals,
        ones_row=None,
    )


EDGE_CASES = (
    "empty_slabs", "mid_unit", "table_end", "one_query", "many_queries", "wide", "selectors", "dead_tiles",
    "long_slabs",
)


def edge_cases(seed: int = 0) -> dict[str, dict]:
    """Small scan inputs, each at an edge of the kernels' decomposition
    into 2048-row units (``scan_agg.UNIT_ROWS``), by name: numpy
    ``keys`` ``[K, n]``, ``values`` ``[n_vals + 1, n]``, ``lo``/``hi``
    ``[Q, K]``, ``slabs`` ``[Q, 2]``, ``sel`` ``[Q]``, ``col_parts``,
    ``n_vals`` and ``ones_row`` (a value row of ones, or None). The
    queries-outer scan takes the narrow ones."""
    u = UNIT_ROWS
    rng = np.random.default_rng(seed)
    cases = {}
    n = 2 * u + 300  # every slab empty: a point, reversed, past either end
    cases["empty_slabs"] = _operands(rng, n, 12, slabs=[[u, u], [700, 690], [n + 5, n + 10], [-10, -1]] * 3)
    n = 3 * u + 100  # starts and ends on either side of unit edges
    cut = [[1, u - 1], [u - 1, u + 1], [u, 2 * u], [700, 3 * u + 50], [u + 1, 3 * u], [2 * u - 1, 2 * u]]
    cases["mid_unit"] = _operands(rng, n, 30, slabs=cut * 5)
    n = 4 * u + 517  # the table's last, partial unit
    end = [[n - 10, n], [n - 600, n + 50], [0, n], [n - 1, n + 1000], [3 * u + 5, n], [4 * u, n]]
    cases["table_end"] = _operands(rng, n, 24, slabs=end * 4)
    cases["table_end"]["sel"][::5] = -1  # no value row, and no count row either
    one = _operands(rng, 3 * u + 11, 1, slabs=[[123, 3 * u - 66]])
    one["lo"][:], one["hi"][:] = [0, 3, 0], [16, 11, 16]  # takes about half its slab
    cases["one_query"] = one
    cases["many_queries"] = _operands(rng, 3 * u + 250, 300)  # above a rowstream chunk of 256
    cases["wide"] = _operands(rng, 3 * u + 99, 40, col_parts=(1, 2, 1))
    sel_case = _operands(rng, 2 * u + 7, 20, n_vals=2)  # selectors outside [0, n_vals)
    sel_case["sel"] = np.array([0, 1, -1, 2, 5, -7] * 3 + [1, 2], np.int32)
    sel_case["values"][1] = 1.0  # a count row: its sums are counts, read from no value
    sel_case["ones_row"] = 1
    cases["selectors"] = sel_case
    n = 5 * u  # tiles 2 and 3 meet no slab
    cases["dead_tiles"] = _operands(rng, n, 16, slabs=[[3, u + 900], [u, 2 * u], [4 * u + 1, n], [10, 20]] * 4)
    n = 70 * u + 5  # folds of more than 64 partials, as the whole table's
    long = [[0, n], [-5, n + 5], [u + 3, 69 * u], [7, 33 * u], [0, 1], [n - 1, n]]
    cases["long_slabs"] = _operands(rng, n, 6, slabs=long)
    assert tuple(cases) == EDGE_CASES
    return cases


def edge_check(dev, names=None) -> dict:
    """Both kernels on the :func:`edge_cases` inputs ``names`` (default
    all) on the CUDA device
    ``dev``: counts equal to the plain versions' and sums within rtol 1e-5
    / atol 1e-3, results equal run to run, and both equal bit for bit to
    their decomposition written out in PyTorch (``scan_agg_*_emulated``,
    on the CPU); raises ``AssertionError`` otherwise. Returns, per case,
    the queries and the largest sum difference from plain."""
    if dev.type != "cuda":
        raise ValueError("edge_check holds the CUDA kernels to their emulations; it needs a CUDA device")
    out = {}
    for name, c in edge_cases().items():
        if names is not None and name not in names:
            continue
        cpu = {k: torch.from_numpy(v) for k, v in c.items() if isinstance(v, np.ndarray)}
        t = {k: v.to(dev) for k, v in cpu.items()}
        cp, nv, ones = c["col_parts"], c["n_vals"], c["ones_row"]
        args = (t["keys"], t["values"], t["lo"], t["hi"], t["slabs"], t["sel"])
        got = scan_agg_rowstream(*args, col_parts=cp, n_vals=nv, ones_row=ones)
        want = scan_agg_rowstream_plain(*args[:1], t["values"][:nv], *args[2:], col_parts=cp)
        _check(f"scan_agg_rowstream ({name})", got, want)
        if not torch.equal(got, scan_agg_rowstream(*args, col_parts=cp, n_vals=nv, ones_row=ones)):
            raise AssertionError(f"scan_agg_rowstream ({name}): not deterministic")
        emu = scan_agg_rowstream_emulated(
            cpu["keys"], cpu["values"], cpu["lo"], cpu["hi"], cpu["slabs"], cpu["sel"], col_parts=cp, n_vals=nv
        )
        if not torch.equal(got.cpu(), emu):
            raise AssertionError(f"scan_agg_rowstream ({name}): differs from its emulation")
        row = {"queries": int(c["sel"].size), "rowstream_max_abs_err": _max_abs_err(got[:, 0], want[:, 0])}
        if set(cp) == {1}:
            g_args = (t["keys"], t["values"][0], t["lo"], t["hi"], t["slabs"])
            got = scan_agg_qgrid(*g_args)
            want = scan_agg_qgrid_plain(*g_args)
            _check(f"scan_agg_qgrid ({name})", got, want)
            if not torch.equal(got, scan_agg_qgrid(*g_args)):
                raise AssertionError(f"scan_agg_qgrid ({name}): not deterministic")
            emu = scan_agg_qgrid_emulated(cpu["keys"], cpu["values"][0], cpu["lo"], cpu["hi"], cpu["slabs"])
            if not torch.equal(got.cpu(), emu):
                raise AssertionError(f"scan_agg_qgrid ({name}): differs from its emulation")
            row["qgrid_max_abs_err"] = _max_abs_err(got[:, 0], want[:, 0])
        out[name] = row
    return out


def _short(name: str) -> str:
    """A device op's name without namespace, template arguments or
    signature (``rowstream_partials``, ``Memset``)."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    m = re.match(r"[\w:]+", name)
    return m.group(0).split("::")[-1] if m else name


def _parts(fn, reps: int) -> dict:
    """Device ms of ``fn`` under the profiler, each pass apart by short
    name, and their sum."""
    parts: dict[str, float] = {}
    for name, ms in device_ms(fn, reps, parts=True).items():
        parts[_short(name)] = parts.get(_short(name), 0.0) + ms
    return dict(device_ms=sum(parts.values()), device_parts_ms=parts)


def _timed(fn, reps: int) -> dict:
    return dict(ms=events_ms(fn, reps), **_parts(fn, reps))


def _max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _check(what, got, want) -> None:
    if not torch.equal(got[:, 1], want[:, 1]):
        raise AssertionError(f"{what}: counts differ from plain")
    if not bool(torch.allclose(got[:, 0], want[:, 0], rtol=RTOL, atol=ATOL)):
        raise AssertionError(f"{what}: sums differ from plain")


def rowstream_case(st, d, slabs, *, reps: int = 10, subsets: dict | None = None) -> dict:
    """``scan_agg_rowstream`` on a resident state ``st``, the batch's
    operands ``d`` and its device slabs; raises ``AssertionError`` if it
    differs from plain or from itself run to run. Events and device
    times, the floor with every slab empty, and the launch on each of
    ``subsets`` (name: query indices) alone."""
    cp, n_vals = st["col_parts"], st["n_value_rows"]

    def launch(a=(d["res_lo"], d["res_hi"], slabs, d["sel"])):
        return scan_agg_rowstream(
            st["keys"], st["values_tile"], *a, col_parts=cp, n_vals=n_vals, ones_row=st["ones_row"]
        )

    got = launch()
    want = scan_agg_rowstream_plain(
        st["keys"], st["values_tile"][:n_vals], d["res_lo"], d["res_hi"], slabs, d["sel"], col_parts=cp
    )
    _check("scan_agg_rowstream", got, want)
    if not torch.equal(got, launch()):
        raise AssertionError("scan_agg_rowstream: not deterministic")
    empty = (d["res_lo"], d["res_hi"], torch.zeros_like(slabs), d["sel"])
    out = dict(queries=int(slabs.shape[0]), max_abs_err=_max_abs_err(got[:, 0], want[:, 0]), **_timed(launch, reps))
    out["floor"] = _timed(lambda: launch(empty), reps)
    for name, idx in (subsets or {}).items():
        t = torch.as_tensor(idx, device=slabs.device)
        a = tuple(x[t].contiguous() for x in (d["res_lo"], d["res_hi"], slabs, d["sel"]))
        out[name] = dict(queries=len(idx), **_timed(lambda a=a: launch(a), reps))
    return out, got


def qgrid_case(st, d, slabs, sum_idx, *, reps: int = 5) -> dict:
    """``scan_agg_qgrid`` on the batch's sums ``sum_idx`` over one value
    row (the first sum's); raises ``AssertionError`` if it differs from
    plain or from itself run to run. Events and device times, the floor
    with every slab empty."""
    idx = torch.as_tensor(sum_idx, device=slabs.device)
    row = st["values_tile"][int(d["sel"][sum_idx[0]])]
    lo, hi, s = (x[idx].contiguous() for x in (d["res_lo"], d["res_hi"], slabs))

    def launch(s=s):
        return scan_agg_qgrid(st["keys"], row, lo, hi, s)

    got, want = launch(), scan_agg_qgrid_plain(st["keys"], row, lo, hi, s)
    _check("scan_agg_qgrid", got, want)
    if not torch.equal(got, launch()):
        raise AssertionError("scan_agg_qgrid: not deterministic")
    out = dict(queries=len(sum_idx), max_abs_err=_max_abs_err(got[:, 0], want[:, 0]), **_timed(launch, reps))
    empty = torch.zeros_like(s)
    out["floor"] = _timed(lambda: launch(empty), reps)
    return out, got


def replica_case(table, batch, *, reps: int = 10) -> dict:
    """Both scans on one resident single-run replica ``table``, and the
    fused scan on the same batch beside them."""
    st = table._device
    cp, lanes, n = st["col_parts"], sum(st["col_parts"]), st["n_rows"]
    d = device_query_operands(table, batch)
    slabs = slab_locate(st["keys"], d["slab_lo"], d["slab_hi"], d["limits"])
    host = SortedTable(table.layout, table.schema, table.key_cols, table.value_cols, table.packed).slab_many(batch)
    if not np.array_equal(slabs.cpu().numpy(), host):
        raise AssertionError(f"slab_locate ({table.layout}): slabs differ from the host searchsorted")
    sel = d["sel"].cpu().numpy()
    rows = np.clip(host[:, 1] - host[:, 0], 0, None)
    whole = [i for i in range(len(batch)) if rows[i] == n]
    subsets = {"one": [0]}  # the Q = 1 launch (ops.scan_agg, table_scan_device)
    if whole:
        subsets.update(long=whole, short=[i for i in range(len(batch)) if rows[i] != n])
    sum_idx = [i for i, q in enumerate(batch) if q.agg == "sum"]
    out = dict(layout=list(table.layout), rows=n, lanes=lanes, pairs=int(rows.sum()), whole_table_queries=len(whole))
    out["rowstream"], rs = rowstream_case(st, d, slabs, reps=reps, subsets=subsets)
    work = slab_scan_work(host, sel, lanes)
    out["rowstream"].update(bound_ms=bound_ms(*work)[0], int_bound_ms=int_bound_ms(work[1]), work=work)
    out["qgrid"], qg = qgrid_case(st, d, slabs, sum_idx, reps=max(3, reps // 2))
    if not torch.equal(qg[:, 1], rs[sum_idx, 1]):
        raise AssertionError("scan_agg_qgrid: counts differ from scan_agg_rowstream")
    work = slab_scan_work(host[sum_idx], sel[sum_idx], lanes)
    design = qgrid_design_bytes(host[sum_idx], lanes)
    out["qgrid"].update(
        bound_ms=bound_ms(*work)[0], int_bound_ms=int_bound_ms(work[1]), work=work,
        design_bytes=design, design_bytes_ms=bound_ms(design, 0)[0],
    )

    def fused():
        return scan_agg_locate(
            st["keys"], st["values_tile"], d["res_lo"], d["res_hi"], d["slab_lo"], d["slab_hi"], d["limits"],
            d["sel"], col_parts=cp, n_vals=st["n_value_rows"],
        )

    out["fused"] = _parts(fused, reps)
    return out


def run(*, n_rows: int = 5 * ROWS_PER_SF, seed: int = 0, reps: int = 10) -> dict:
    """The measurements at ``n_rows`` rows of ``orders`` on the current
    CUDA device, replica by replica; the card's name and power limit ride
    along."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench.row_slab measures on an NVIDIA GPU; no CUDA device found")
    dev = torch.device("cuda")
    kc, vc = generate_orders(n_rows / ROWS_PER_SF, seed=seed)
    n = len(kc["custkey"])
    batch = row_slab_batch(n, seed + 4)
    out = {"card": card_line(), "rows": n, "queries": len(batch), "replicas": []}
    for layout in LAYOUTS:
        table = SortedTable.from_columns(kc, vc, layout, orders_schema()).place_on_device(dev)
        out["replicas"].append(replica_case(table, batch, reps=reps))
        del table
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=5 * ROWS_PER_SF, help="orders rows (TPC-H SF 5: 7,500,000)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the generated data")
    ap.add_argument("--reps", type=int, default=10, help="calls timed per measurement")
    args = ap.parse_args(argv)
    print(json.dumps(run(n_rows=args.rows, seed=args.seed, reps=args.reps)))


if __name__ == "__main__":
    main()
