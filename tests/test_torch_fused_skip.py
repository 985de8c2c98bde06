"""The fused scan's skip rule and the card's in-block order, on the CPU.

``live_tile_pairs`` is the plain model of the rule by which the fused
scan's kernel (``csrc/scan_locate.cu``) leaves out (query, tile) pairs:
every row the plain fused scan counts, in a query's slab or matched by
its residual predicate, must lie in a live pair, for any operands (random
independent residual and slab bounds, wide 60-bit lane pairs, empty
queries, run stacks, ragged ends, an older state whose capacity padding
holds newer rows). On the engine's own operands (a TPC-H-like table in
the HR layouts) the live share must be small: that is where the kernel's
time goes.

``block_partials_card_order`` writes the card's in-block order
(``csrc/predicates.cuh``) out in PyTorch; here it is held against the
same order written out scalar by scalar in numpy float32, and against the
plain versions within the float tolerance. ``scan_tile_plain`` is the
frozen tile formula; ``tests/test_torch_cuda.py`` holds both against the
built kernels on the card.
"""

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core.storage.memtable import sort_run
from repro_torch.core.tpch import generate_orders, orders_schema, q1_q2_workload
from repro_torch.kernels import ops
from repro_torch.kernels.block_agg import (
    BLOCK_ROWS,
    block_partials,
    block_partials_card_order,
    scan_tile_plain,
)
from repro_torch.kernels.slab_locate import (
    SCAN_QUERY_CHUNK,
    _lex_masks,
    _residual_mask,
    _window,
    live_tile_pairs,
    scan_agg_locate_plain,
)

CPU = torch.device("cpu")


def _split_wide(v):
    """A 31-60-bit column as its (v >> 30, v & (2**30 - 1)) lane pair."""
    return [v >> 30, v & ((1 << 30) - 1)]


def _raw_case(col_bits, n, n_q, seed, *, empty_every=0):
    """Key lanes of random columns (``col_bits`` per logical column) and
    random operands whose residual and slab bounds are drawn apart: the
    residual box need not lie inside the slab. Every ``empty_every``-th
    query is empty (slab_hi lanes of -1, a (0, 0) window)."""
    rng = np.random.default_rng(seed)
    col_parts = tuple(2 if b > 30 else 1 for b in col_bits)

    def lanes(vals):
        out = []
        for v, b in zip(vals, col_bits):
            out += _split_wide(v) if b > 30 else [v]
        return np.stack(out)

    cols = [rng.integers(0, 1 << b, n, dtype=np.int64) for b in col_bits]
    keys = lanes(cols)

    def draw(shape):
        return [rng.integers(0, 1 << b, shape, dtype=np.int64) for b in col_bits]

    a, b = draw(n_q), draw(n_q)
    res_lo = lanes([np.minimum(x, y) for x, y in zip(a, b)]).T
    res_hi = lanes([np.maximum(x, y) + 1 for x, y in zip(a, b)]).T
    # slab keys: a random row's tuple widened, or two random tuples in order
    pick = rng.integers(0, n, n_q)
    slab_lo = keys[:, pick].T.copy()
    slab_hi = slab_lo.copy()
    slab_hi[:, -1] += rng.integers(0, 1 << min(col_bits[-1], 20), n_q)
    far = rng.random(n_q) < 0.3
    c, d = lanes(draw(n_q)).T, lanes(draw(n_q)).T
    swap = np.array([tuple(x) > tuple(y) for x, y in zip(c, d)])
    c[swap], d[swap] = d[swap].copy(), c[swap].copy()
    slab_lo[far], slab_hi[far] = c[far], d[far]
    limits = np.sort(rng.integers(0, n + 1, (n_q, 2)), axis=1)
    full = rng.random(n_q) < 0.5
    limits[full] = (0, n)
    if empty_every:
        e = np.arange(n_q) % empty_every == 0
        slab_lo[e], slab_hi[e], limits[e] = 0, -1, 0
    sel = rng.integers(-1, 3, n_q)
    t = [torch.from_numpy(np.ascontiguousarray(x, np.int32)) for x in (keys, res_lo, res_hi, slab_lo, slab_hi, limits, sel)]
    values = torch.from_numpy(rng.uniform(-5, 5, (2, n)).astype(np.float32))
    return dict(keys=t[0], values=values, ops=tuple(t[1:6]), sel=t[6], col_parts=col_parts, n_rows=n)


def _table_case(kind, seed):
    """Operands of ``ops.device_query_operands`` on a resident CPU table:
    an appended run stack, or an older state whose padding a later append
    filled in place."""
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
    else:  # the older state's padding holds the newer rows
        assert st["keys"].shape[1] > st["n_rows"]
        assert torch.equal(st["keys"][:, st["n_rows"] : table._device["n_rows"]],
                           table._device["keys"][:, st["n_rows"] : table._device["n_rows"]])
    qs = []
    for i in range(90):
        f = {}
        for c, b in bits.items():
            kind_c = rng.integers(0, 4)
            lo = int(rng.integers(0, 1 << b))
            if kind_c == 0:
                f[c] = T.Eq(lo)
            elif kind_c == 1:
                f[c] = T.Range(lo, int(rng.integers(lo, (1 << b) + 1)))
            elif kind_c == 2 and i % 9 == 4:
                f[c] = T.Range(lo, lo)
        qs.append(T.Query(filters=f, agg="sum" if i % 2 else "count", value_col="v"))
    d = ops.device_query_operands(target, qs)
    return dict(
        keys=st["keys"], values=st["values_tile"][: st["n_value_rows"]],
        ops=(d["res_lo"], d["res_hi"], d["slab_lo"], d["slab_hi"], d["limits"]), sel=d["sel"],
        col_parts=st["col_parts"], n_rows=st["n_rows"],
    )


CASES = {
    "random_bounds": lambda: _raw_case((7, 9, 5), 6000, 150, 1),
    "wide_60_bit": lambda: _raw_case((6, 60, 5), 6000, 150, 2),
    "empty_queries": lambda: _raw_case((8, 45), 5000, 140, 3, empty_every=3),
    "ragged_end": lambda: _raw_case((10, 12), 3 * 2048 + 777, 150, 4),
    "run_stack": lambda: _table_case("run_stack", 5),
    "older_state_padding": lambda: _table_case("older", 6),
}


def _counted_tiles(case, tile):
    """bool [Q, n_tiles]: the tiles holding a row the plain fused scan
    counts for the query (in its slab, or matched), with the masks the
    plain version builds; and those masks' counts."""
    keys = case["keys"]
    res_lo, res_hi, slab_lo, slab_hi, limits = case["ops"]
    n = keys.shape[1]
    lanes = sum(case["col_parts"])
    valid = _window(limits, n)
    ge, le = _lex_masks(keys, slab_lo, slab_hi, lanes)
    in_slab = valid & ge & le
    matched = _residual_mask(keys, res_lo, res_hi, case["col_parts"], valid)
    n_tiles = -(-n // tile)
    counted = torch.nn.functional.pad(in_slab | matched, (0, n_tiles * tile - n))
    counted = counted.view(len(limits), n_tiles, tile).any(dim=2)
    return counted, matched.sum(dim=1, dtype=torch.int32), in_slab.sum(dim=1, dtype=torch.int32)


@pytest.mark.parametrize("tile", [256, 2048])
@pytest.mark.parametrize("name", list(CASES))
def test_every_counted_row_lies_in_a_live_pair(name, tile):
    case = CASES[name]()
    counted, m, c = _counted_tiles(case, tile)
    _, matched, slab_rows = scan_agg_locate_plain(
        case["keys"], case["values"], *case["ops"], case["sel"], col_parts=case["col_parts"]
    )
    assert torch.equal(m, matched) and torch.equal(c, slab_rows)
    assert int(slab_rows.sum() + matched.sum()) > 0
    live = live_tile_pairs(
        case["keys"], *case["ops"], col_parts=case["col_parts"], n_rows=case["n_rows"], tile=tile
    )
    assert live.shape == counted.shape and live.dtype == torch.bool
    assert not bool((counted & ~live).any()), "a counted row lies in a skipped pair"
    assert bool((live & ~counted).any()) or name == "empty_queries"  # the rule is not exact
    # a query whose window is empty is live nowhere
    limits = case["ops"][4]
    empty = limits[:, 0] >= limits[:, 1]
    assert not bool(live[empty].any())


def test_equality_queries_are_live_only_where_their_leading_key_is():
    """On one sorted run, an all-equality query (the engine's operands:
    its slab is one key tuple and its residual box that tuple) is live on
    every tile holding the tuple, and only on tiles whose leading column
    spans its value: both halves of the rule need that."""
    rng = np.random.default_rng(7)
    bits = {"a": 6, "b": 9}
    kc = {c: rng.integers(0, 1 << b, 20_000, dtype=np.int64) for c, b in bits.items()}
    table = T.SortedTable.from_columns(kc, {"v": rng.uniform(0, 1, 20_000)}, ("a", "b"), T.KeySchema(bits))
    table.place_on_device(CPU)
    st = table._device
    pick = rng.integers(0, 20_000, 40)
    qs = [T.Query(filters={"a": T.Eq(int(kc["a"][i])), "b": T.Eq(int(kc["b"][i]))}, agg="count") for i in pick]
    d = ops.device_query_operands(table, qs)
    tile = 256
    live = live_tile_pairs(
        st["keys"], d["res_lo"], d["res_hi"], d["slab_lo"], d["slab_hi"], d["limits"],
        col_parts=st["col_parts"], n_rows=st["n_rows"], tile=tile,
    )
    n_tiles = -(-st["n_rows"] // tile)
    keys = torch.nn.functional.pad(st["keys"][:2, : st["n_rows"]].long(), (0, n_tiles * tile - st["n_rows"]))
    lead = keys[0].view(n_tiles, tile)
    lead_min = torch.where(torch.arange(n_tiles * tile).view(n_tiles, tile) < st["n_rows"], lead, 1 << 40).amin(dim=1)
    lead_max = lead.amax(dim=1)
    assert live.shape == (len(qs), -(-st["keys"].shape[1] // tile))
    assert not bool(live[:, n_tiles:].any())  # capacity padding
    live = live[:, :n_tiles]
    for j, q in enumerate(qs):
        a, b = q.filters["a"].value, q.filters["b"].value
        rows = torch.nonzero((keys[0] == a) & (keys[1] == b)).flatten()
        assert bool(live[j][rows // tile].all())
        spans = (lead_min <= a) & (lead_max >= a)
        assert not bool((live[j] & ~spans).any())
        assert int(live[j].sum()) <= 3


def test_the_window_hull_is_per_query_chunk():
    """Queries of one chunk whose windows all stop early take no range
    from rows past their hull: the tiles there are live for none of them,
    while a later chunk with whole-table windows reaches them."""
    case = _raw_case((7, 9), 4 * 2048, 2 * SCAN_QUERY_CHUNK, 8)
    limits = case["ops"][4]
    limits[:SCAN_QUERY_CHUNK] = torch.tensor([0, 2048], dtype=torch.int32)
    limits[SCAN_QUERY_CHUNK:] = torch.tensor([0, 4 * 2048], dtype=torch.int32)
    live = live_tile_pairs(case["keys"], *case["ops"], col_parts=case["col_parts"], n_rows=4 * 2048, tile=2048)
    assert not bool(live[:SCAN_QUERY_CHUNK, 1:].any())
    assert bool(live[SCAN_QUERY_CHUNK:, 1:].any())


@pytest.fixture(scope="module")
def orders_groups():
    """A TPC-H-like orders table (600,000 rows) in the HR layouts on the
    CPU engine, and one Q1/Q2 batch of 256 grouped by the replica that
    served each query, with its operands."""
    kc, vc = generate_orders(0.4, seed=11)
    n = len(kc["custkey"])
    eng = T.HREngine(n_nodes=6, device=CPU)
    eng.create_column_family(
        "o", kc, vc, replication_factor=3,
        layouts=[("clerk", "orderdate", "custkey"), ("custkey", "orderdate", "clerk"),
                 ("custkey", "clerk", "orderdate")],
        schema=orders_schema(), device_resident=True,
    )
    wl = q1_q2_workload(n_instances=256, n_rows=n, seed=12)
    qs = list(wl.queries[:128]) + [T.Query(filters=q.filters, agg="count") for q in wl.queries[128:]]
    cf = eng.column_families["o"]
    groups: dict[int, list] = {}
    for q, (_, rep) in zip(qs, eng.read_many("o", qs)):
        groups.setdefault(rep.replica_id, []).append(q)
    return [(eng._table(cf, cf.replicas[rid]), g) for rid, g in groups.items()]


def test_live_share_is_small_on_engine_operands(orders_groups):
    total = live_n = 0
    for table, qs in orders_groups:
        st = table._device
        d = ops.device_query_operands(table, qs)
        tile = scan_tile_plain(sum(st["col_parts"]), st["n_value_rows"])
        assert tile == 2048
        live = live_tile_pairs(
            st["keys"], d["res_lo"], d["res_hi"], d["slab_lo"], d["slab_hi"], d["limits"],
            col_parts=st["col_parts"], n_rows=st["n_rows"], tile=tile,
        )
        assert live.shape == (len(qs), -(-st["keys"].shape[1] // tile))
        total += len(qs) * -(-st["n_rows"] // tile)
        live_n += int(live.sum())
        # every query the engine routes meets at least one tile
        assert bool(live.any(dim=1).all())
    assert live_n / total < 0.01, f"live share {live_n / total:.4f}"


def _card_order_scalar(x, n_rows, tile):
    """The card's in-block order, one float32 add at a time in numpy."""
    f = np.float32
    nb = -(-len(x) // BLOCK_ROWS)
    out = []
    for b in range(nb):
        slots = [f(0.0)] * 8
        for t0 in range(0, BLOCK_ROWS, tile):
            sums = []
            for t in range(256):
                s = f(0.0)
                for k in range(tile // 256):
                    r = b * BLOCK_ROWS + t0 + k * 256 + t
                    if r < min(n_rows, len(x)):
                        s = f(s + x[r])
                sums.append(s)
            for w in range(8):
                v = sums[32 * w : 32 * w + 32]
                for o in (16, 8, 4, 2, 1):
                    v = [f(v[i] + v[i ^ o]) for i in range(32)]
                slots[w] = f(slots[w] + v[0])
        p = f(0.0)
        for w in range(8):
            p = f(p + slots[w])
        out.append(p)
    return np.array(out, np.float32)


@pytest.mark.parametrize("tile", [256, 1024, 2048])
def test_card_order_emulation_matches_a_scalar_walk(tile):
    rng = np.random.default_rng(tile)
    x = (rng.standard_normal(2 * BLOCK_ROWS + 3000) * 1e3).astype(np.float32)
    x[::7] = 0.0
    n_rows = 2 * BLOCK_ROWS + 2500  # a ragged last block, padding beyond n_rows
    got = block_partials_card_order(torch.from_numpy(x), n_rows, tile).numpy()
    want = _card_order_scalar(x, n_rows, tile)
    assert got.dtype == np.float32 and got.shape == (3,)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    near = block_partials(torch.from_numpy(np.where(np.arange(len(x)) < n_rows, x, 0)[None, :]))[0]
    np.testing.assert_allclose(got, near.numpy(), rtol=1e-5, atol=1e-2)


def test_scan_tile_plain_is_the_frozen_formula():
    assert scan_tile_plain(3, 3) == 2048  # TPC-H orders: 3 key lanes, 2 values + ones
    assert scan_tile_plain(8, 16) == 1024
    assert scan_tile_plain(40, 10) == 512
    assert scan_tile_plain(61, 1) == 256
    assert scan_tile_plain(62, 1) == 0
    for lanes in range(1, 64):
        for n_vals in (1, 3, 9, 40):
            t = scan_tile_plain(lanes, n_vals)
            assert t in (0, 256, 512, 1024, 2048)
            if t:
                assert 128 * (4 * lanes + 27) * 4 + t * (lanes + n_vals) * 4 <= 200 * 1024


def test_fused_scan_bench_needs_a_card(monkeypatch):
    """The benchmark of the fused scan measures device time only: without
    a CUDA device it raises instead of timing the plain versions."""
    from repro_torch.bench import fused_scan

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused_scan.run(n_rows=10_000)
