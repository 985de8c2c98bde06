"""The select compaction's skip rule and the slab location's k-ary search,
on the CPU.

``select_live_pairs`` is the plain model of the rule by which the select
compaction's counting pass (``csrc/select_compact.cu``) leaves out
(query, segment) pairs: every row ``select_compact_plain`` returns must
lie in a live pair, at the kernel's 256-row segments and at 8192-row
blocks, for any operands (random residual boxes, wide 60-bit lane pairs,
empty queries, run stacks, ragged ends, an older state whose capacity
padding holds newer rows). On the engine's own Q1/Q2 selects the live
share must be small: that is where the kernel's time goes.

``kary_ranks_emulated`` writes the slab location kernel's k-ary search
(``csrc/slab_rank.cu``) out step by step; inside sorted windows it must
equal the rank form (``slab_locate_plain``) and ``np.searchsorted`` on
the packed key, on windows of 0, 1, 32, 33 and 1089 rows, duplicate keys,
bounds below and above every key, 60-bit lane pairs and empty queries.

Every case also holds the port against the reference (its Pallas kernels
in interpret mode, or their oracles in ``repro/kernels/ref.py``) on the
same numpy inputs; schemas are explicit. ``tests/test_torch_cuda.py``
holds the built kernels against the plain versions on the card.
"""

import numpy as np
import pytest
import torch

import repro.core as R
from repro.kernels import ref as rref
from repro.kernels.slab_locate import select_compact_batched, slab_locate_batched

import repro_torch.core as T
from repro_torch.core.storage.memtable import sort_run
from repro_torch.core.tpch import generate_orders, orders_schema, q1_q2_workload
from repro_torch.kernels import ops
from repro_torch.kernels.block_agg import BLOCK_ROWS
from repro_torch.kernels.slab_locate import (
    SCAN_QUERY_CHUNK,
    SELECT_SEG_ROWS,
    _residual_mask,
    _window,
    kary_ranks_emulated,
    kary_rounds,
    select_compact,
    select_compact_plain,
    select_live_pairs,
    slab_locate,
    slab_locate_plain,
)

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


# -- slab location: the k-ary search ---------------------------------------------

# layout -> bits (first column most significant); "wide" has a 60-bit column
SLAB_SCHEMAS = {
    "narrow": {"a": 7, "b": 9, "c": 5},
    "wide": {"w": 60, "c": 2},
    "one_lane": {"a": 12},
}
WINDOWS = (0, 1, 32, 33, 1089)


def _sorted_case(bits, n, seed, domain):
    """A sorted run of ``n`` rows under the explicit schema ``bits``, each
    column drawn from ``[0, domain)`` (a small domain gives duplicate
    keys): its lanes, its packed key and its column values."""
    rng = np.random.default_rng(seed)
    layout = tuple(bits)
    schema = T.KeySchema(dict(bits))
    cols = {c: rng.integers(0, min(1 << b, domain), n, dtype=np.int64) for c, b in bits.items()}
    packed = T.pack_columns(cols, layout, schema)
    order = np.argsort(packed, kind="stable")
    cols = {c: v[order] for c, v in cols.items()}
    packed = packed[order]
    col_parts = tuple(2 if b > 30 else 1 for b in bits.values())
    lanes = ops._expand_key_cols(cols, layout, col_parts, n)
    return layout, schema, cols, packed, lanes, col_parts


def _slab_operands(bits, n, seed, domain):
    """Queries over windows of every size in WINDOWS at random offsets:
    bounds at existing keys, random, below every key and above every
    key; the last query is empty (slab_hi lanes of -1, a (0, 0) window).
    Returns the lanes, the int32 operands and the expected ranks from
    ``np.searchsorted`` on the packed key of each window."""
    layout, schema, cols, packed, lanes, col_parts = _sorted_case(bits, n, seed, domain)
    rng = np.random.default_rng(seed + 100)
    tops = {c: min(1 << b, domain) for c, b in bits.items()}
    lo_rows, hi_rows, limits, want = [], [], [], []

    def tup(kind):
        if kind == "row":
            r = int(rng.integers(0, n))
            return [int(cols[c][r]) for c in layout]
        if kind == "random":
            return [int(rng.integers(0, tops[c])) for c in layout]
        if kind == "below":
            return [0] * len(layout)
        return [schema.max_value(c) for c in layout]  # above

    for w in WINDOWS:
        for kinds in (("row", "row"), ("random", "random"), ("below", "below"), ("above", "above"),
                      ("below", "above"), ("row", "above")):
            s = int(rng.integers(0, n - w + 1))
            a, b = tup(kinds[0]), tup(kinds[1])
            pa, pb = T.pack_tuple(a, layout, schema), T.pack_tuple(b, layout, schema)
            if pa > pb:
                a, b, pa, pb = b, a, pb, pa
            lo_rows.append(a)
            hi_rows.append(b)
            limits.append((s, s + w))
            win = packed[s : s + w]
            want.append((np.searchsorted(win, pa, "left"), np.searchsorted(win, pb, "right")))
    expand = lambda rows: ops._expand_key_cols(  # noqa: E731
        {c: np.array([r[i] for r in rows], np.int64) for i, c in enumerate(layout)}, layout, col_parts, len(rows)
    ).T
    slab_lo, slab_hi = expand(lo_rows), expand(hi_rows)
    # the empty query: no key lies at or below -1 lanes
    slab_lo = np.concatenate([slab_lo, np.zeros((1, slab_lo.shape[1]), np.int32)])
    slab_hi = np.concatenate([slab_hi, np.full((1, slab_hi.shape[1]), -1, np.int32)])
    limits.append((0, 0))
    want.append((0, 0))
    return lanes, slab_lo, slab_hi, np.array(limits, np.int32), np.array(want, np.int32)


@pytest.mark.parametrize("domain", [4, 1 << 20])
@pytest.mark.parametrize("schema", list(SLAB_SCHEMAS))
def test_kary_search_equals_rank_form_and_searchsorted(schema, domain):
    lanes, slab_lo, slab_hi, limits, want = _slab_operands(SLAB_SCHEMAS[schema], 1500, 3, domain)
    args = (_t(lanes), _t(slab_lo), _t(slab_hi), _t(limits))
    got = kary_ranks_emulated(*args)
    assert got.dtype == torch.int32 and got.shape == (len(limits), 2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, slab_locate_plain(*args))
    assert torch.equal(slab_locate(*args), got)  # the wrapper on CPU tensors: the plain version
    oracle = rref.slab_locate_batched_ref(lanes, slab_lo, slab_hi, limits, n_lanes=lanes.shape[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))


def test_kary_search_equals_the_reference_kernel():
    """The reference's slab_locate_kernel in interpret mode, on the same
    operands (60-bit lane pairs, duplicates, every window size)."""
    lanes, slab_lo, slab_hi, limits, want = _slab_operands(SLAB_SCHEMAS["wide"], 1200, 5, 8)
    ref = slab_locate_batched(lanes, slab_lo, slab_hi, limits, n_lanes=lanes.shape[0], block_n=1024)
    got = kary_ranks_emulated(_t(lanes), _t(slab_lo), _t(slab_hi), _t(limits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), want)


def test_kary_search_on_a_table_matches_the_reference_table():
    """Device operands of a resident single-run table (explicit schema)
    give the reference host table's slabs."""
    rng = np.random.default_rng(9)
    bits = {"a": 6, "w": 40, "c": 9}
    layout = ("a", "w", "c")
    kc = {c: rng.integers(0, 1 << b, 5000, dtype=np.int64) for c, b in bits.items()}
    kc["a"] //= 16  # duplicates on the leading column
    vc = {"v": rng.uniform(0, 1, 5000)}
    port = T.SortedTable.from_columns(kc, vc, layout, T.KeySchema(dict(bits))).place_on_device(CPU)
    ref = R.SortedTable.from_columns(kc, vc, layout, R.KeySchema(dict(bits)))
    qs = []
    for i in range(60):
        f = {"a": T.Eq(int(rng.integers(0, 4)))}
        if i % 3:
            lo = int(rng.integers(0, 1 << 40))
            f["w"] = T.Range(lo, min(lo + int(rng.integers(0, 1 << 39)), (1 << 40) - 1))
        if i % 7 == 0:
            f["c"] = T.Range(5, 5)  # empty
        qs.append(T.Query(filters=f, agg="count"))
    st = port._device
    _, _, slab_lo, slab_hi, limits = ops._device_query_bounds(port, qs, st["col_parts"], st["n_rows"])
    got = kary_ranks_emulated(st["keys"], _t(slab_lo), _t(slab_hi), _t(limits)).numpy()
    r_qs = [R.Query(filters={c: (R.Eq(f.value) if isinstance(f, T.Eq) else R.Range(f.start, f.end))
                             for c, f in q.filters.items()}, agg="count") for q in qs]
    want = ref.slab_many(r_qs)
    np.testing.assert_array_equal(got, want)


def test_kary_rounds():
    assert [kary_rounds(n) for n in (0, 1, 32, 33, 1088, 1089, 35_936)] == [0, 1, 1, 2, 2, 3, 3]
    assert kary_rounds(7_500_000) == 5  # TPC-H SF 5 orders
    assert kary_rounds(2**31 - 8192) == 7


# -- select compaction: the skip rule ------------------------------------------------


def _split_wide(v):
    return [v >> 30, v & ((1 << 30) - 1)]


def _raw_case(col_bits, n, n_q, seed, *, empty_every=0):
    """Random key lanes and random residual boxes (independent of the
    rows), windows random or whole; every ``empty_every``-th query has a
    (0, 0) window."""
    rng = np.random.default_rng(seed)
    col_parts = tuple(2 if b > 30 else 1 for b in col_bits)

    def lanes(vals):
        out = []
        for v, b in zip(vals, col_bits):
            out += _split_wide(v) if b > 30 else [v]
        return np.stack(out)

    keys = lanes([rng.integers(0, 1 << b, n, dtype=np.int64) for b in col_bits])
    a = [rng.integers(0, 1 << b, n_q, dtype=np.int64) for b in col_bits]
    w = [rng.integers(0, 1 << max(b - 2, 1), n_q, dtype=np.int64) for b in col_bits]
    res_lo = lanes(a).T
    res_hi = lanes([np.minimum(x + y + 1, (1 << b)) for x, y, b in zip(a, w, col_bits)]).T
    limits = np.sort(rng.integers(0, n + 1, (n_q, 2)), axis=1)
    limits[rng.random(n_q) < 0.5] = (0, n)
    if empty_every:
        limits[np.arange(n_q) % empty_every == 0] = 0
    return dict(keys=keys, res_lo=res_lo, res_hi=res_hi, limits=limits, col_parts=col_parts, n_rows=n)


def _table_case(kind, seed):
    """Select operands (``device_query_operands``) on a resident CPU
    table: an appended run stack, or an older state whose capacity
    padding a later append filled in place."""
    rng = np.random.default_rng(seed)
    bits = {"a": 5, "w": 40, "c": 9}
    layout = ("a", "w", "c")

    def cols(m):
        kc = {c: rng.integers(0, 1 << b, m, dtype=np.int64) for c, b in bits.items()}
        return kc, {"v": rng.uniform(-10.0, 100.0, m)}

    table = T.SortedTable.from_columns(*cols(9000), layout, T.KeySchema(dict(bits))).place_on_device(CPU)
    older = table
    for m in (1500, 700):
        table = table.merge_run(sort_run(*cols(m), layout, table.schema))
    target = table if kind == "run_stack" else older
    st = target._device
    if kind == "run_stack":
        assert st["n_runs"] == 3
    else:
        assert st["keys"].shape[1] > st["n_rows"]
        assert bool((st["keys"][:, st["n_rows"] : table._device["n_rows"]] != 0).any())
    qs = []
    for i in range(90):
        f = {}
        for c, b in bits.items():
            lo = int(rng.integers(0, 1 << b))
            pick = rng.integers(0, 3)
            if pick == 0:
                f[c] = T.Eq(lo)
            elif pick == 1:
                f[c] = T.Range(lo, int(rng.integers(lo, (1 << b) + 1)))
        qs.append(T.Query(filters=f, agg="select"))
    d = ops.device_query_operands(target, qs)
    return dict(
        keys=st["keys"].numpy(), res_lo=d["res_lo"].numpy(), res_hi=d["res_hi"].numpy(),
        limits=d["limits"].numpy(), col_parts=st["col_parts"], n_rows=st["n_rows"],
    )


SELECT_CASES = {
    "random_bounds": lambda: _raw_case((7, 9, 5), 6000, 150, 1),
    "wide_60_bit": lambda: _raw_case((6, 60, 5), 6000, 150, 2),
    "empty_queries": lambda: _raw_case((8, 45), 5000, 140, 3, empty_every=3),
    "ragged_end": lambda: _raw_case((10, 12), 2 * BLOCK_ROWS + 777, 150, 4),
    "run_stack": lambda: _table_case("run_stack", 5),
    "older_state_padding": lambda: _table_case("older", 6),
}


def _select(case):
    """The plain select on the case (counts from its own match mask) and
    the match mask."""
    keys, lo, hi, lim = (_t(case[k]) for k in ("keys", "res_lo", "res_hi", "limits"))
    match = _residual_mask(keys, lo, hi, case["col_parts"], _window(lim, keys.shape[1]))
    counts = match.sum(dim=1).numpy()
    rows = select_compact(keys, lo, hi, lim, counts, col_parts=case["col_parts"])
    assert torch.equal(rows, select_compact_plain(keys, lo, hi, lim, counts, col_parts=case["col_parts"]))
    return rows, counts, match


@pytest.mark.parametrize("rows", [SELECT_SEG_ROWS, BLOCK_ROWS])
@pytest.mark.parametrize("name", list(SELECT_CASES))
def test_every_selected_row_lies_in_a_live_pair(name, rows):
    case = SELECT_CASES[name]()
    got, counts, _ = _select(case)
    assert counts.sum() > 0 and got.numel() == counts.sum()
    live = select_live_pairs(
        _t(case["keys"]), _t(case["res_lo"]), _t(case["res_hi"]), _t(case["limits"]),
        col_parts=case["col_parts"], rows=rows,
    )
    n = case["keys"].shape[1]
    assert live.shape == (len(counts), -(-n // rows)) and live.dtype == torch.bool
    owner = torch.repeat_interleave(torch.arange(len(counts)), torch.from_numpy(counts))
    assert bool(live[owner, got.long() // rows].all()), "a selected row lies in a skipped pair"
    if rows == SELECT_SEG_ROWS:
        assert bool((~live).any())  # the rule skips something
    limits = case["limits"]
    assert not bool(live[torch.from_numpy(limits[:, 0] >= limits[:, 1])].any())


@pytest.mark.parametrize("name", list(SELECT_CASES))
def test_select_compact_matches_the_reference_oracle(name):
    case = SELECT_CASES[name]()
    got, counts, _ = _select(case)
    width = 128
    while width < counts.max():
        width *= 2
    ref = np.asarray(rref.select_compact_batched_ref(
        case["keys"], case["res_lo"], case["res_hi"], case["limits"], col_parts=case["col_parts"], out_width=width,
    ))
    off = np.concatenate([[0], np.cumsum(counts)])
    for j in range(len(counts)):
        np.testing.assert_array_equal(got[off[j] : off[j + 1]].numpy(), ref[j, : counts[j]])


def test_select_compact_matches_the_reference_kernel():
    """The reference's select_compact_kernel in interpret mode, on a run
    stack's operands."""
    case = SELECT_CASES["run_stack"]()
    got, counts, _ = _select(case)
    width = 128
    while width < counts.max():
        width *= 2
    ref = np.asarray(select_compact_batched(
        case["keys"], case["res_lo"], case["res_hi"], case["limits"], col_parts=case["col_parts"],
        out_width=width, block_n=ops.DEVICE_BLOCK_N,
    ))
    off = np.concatenate([[0], np.cumsum(counts)])
    for j in range(len(counts)):
        np.testing.assert_array_equal(got[off[j] : off[j + 1]].numpy(), ref[j, : counts[j]])


def test_the_window_hull_is_per_query_chunk():
    """Queries of one chunk whose windows stop early take no range from
    segments past their hull; a later chunk with whole windows reaches
    them."""
    case = _raw_case((7, 9), 4 * SELECT_SEG_ROWS, 2 * SCAN_QUERY_CHUNK, 8)
    lim = case["limits"]
    lim[:SCAN_QUERY_CHUNK] = (0, SELECT_SEG_ROWS)
    lim[SCAN_QUERY_CHUNK:] = (0, 4 * SELECT_SEG_ROWS)
    lo, hi = case["res_lo"], case["res_hi"]
    lo[:], hi[:] = 0, 1 << 9  # every row matches
    live = select_live_pairs(_t(case["keys"]), _t(lo), _t(hi), _t(lim), col_parts=case["col_parts"])
    assert not bool(live[:SCAN_QUERY_CHUNK, 1:].any())
    assert bool(live[SCAN_QUERY_CHUNK:].all())


@pytest.fixture(scope="module")
def orders_select_groups():
    """A TPC-H-like orders table (600,000 rows) in the HR layouts on the
    CPU engine, and 256 Q1/Q2 selects grouped by the replica that served
    each, with their operands (explicit schema)."""
    kc, vc = generate_orders(0.4, seed=21)
    n = len(kc["custkey"])
    eng = T.HREngine(n_nodes=6, device=CPU)
    eng.create_column_family(
        "o", kc, vc, replication_factor=3,
        layouts=[("clerk", "orderdate", "custkey"), ("custkey", "orderdate", "clerk"),
                 ("custkey", "clerk", "orderdate")],
        schema=orders_schema(), device_resident=True,
    )
    wl = q1_q2_workload(n_instances=256, n_rows=n, seed=22)
    qs = [T.Query(filters=q.filters, agg="select") for q in wl.queries]
    cf = eng.column_families["o"]
    groups: dict[int, list] = {}
    for q, (_, rep) in zip(qs, eng.read_many("o", qs)):
        groups.setdefault(rep.replica_id, []).append(q)
    return [(eng._table(cf, cf.replicas[rid]), g) for rid, g in groups.items()]


def test_live_share_is_small_on_engine_selects(orders_select_groups):
    total = live_n = 0
    for table, qs in orders_select_groups:
        st = table._device
        d = ops.device_query_operands(table, qs)
        live = select_live_pairs(st["keys"], d["res_lo"], d["res_hi"], d["limits"], col_parts=st["col_parts"])
        n_seg = -(-st["n_rows"] // SELECT_SEG_ROWS)
        assert not bool(live[:, n_seg:].any())  # capacity padding
        total += len(qs) * n_seg
        live_n += int(live.sum())
        # every select with a match is live somewhere
        match = _residual_mask(st["keys"], d["res_lo"], d["res_hi"], st["col_parts"],
                               _window(d["limits"], st["keys"].shape[1]))
        assert bool(live[match.any(dim=1)].any(dim=1).all())
        # the first selects' indices against the reference's oracle
        k = min(16, len(qs))
        counts = match[:k].sum(dim=1).numpy()
        got = select_compact(st["keys"], d["res_lo"][:k], d["res_hi"][:k], d["limits"][:k], counts,
                             col_parts=st["col_parts"]).numpy()
        ref = np.asarray(rref.select_compact_batched_ref(
            st["keys"].numpy(), d["res_lo"][:k].numpy(), d["res_hi"][:k].numpy(), d["limits"][:k].numpy(),
            col_parts=st["col_parts"], out_width=max(128, int(counts.max())),
        ))
        off = np.concatenate([[0], np.cumsum(counts)])
        for j in range(k):
            np.testing.assert_array_equal(got[off[j] : off[j + 1]], ref[j, : counts[j]])
    assert live_n / total < 0.01, f"live share {live_n / total:.5f}"
