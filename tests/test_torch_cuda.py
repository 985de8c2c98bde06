"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the reference package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Counts, indices, permutations and histograms must equal the plain
versions' on the same CUDA tensors; float32 sums agree within rtol 1e-5 /
atol 1e-3 (the kernels reduce a block in another order than the plain
versions). On the card, view-served sums equal the fused scan's bit for
bit, on schemas whose staging tile differs, and ``block_sums`` equals the
contract's in-block order written out in PyTorch bit for bit. The LM
serving path (plain PyTorch, no kernel of its own) must give the CPU's
float32 logits within 1e-4 and caches within 1e-5 on the card, and its
decode must agree with a teacher-forced prefill within the reference's
5e-3. Its training path must give the CPU's float32 loss within 1e-5 and
gradients within 1e-5 of their largest magnitude, the same expert
choices, and the bfloat16 expert products' gradients within a bfloat16
rounding; a checkpoint written on the card restores on the CPU bit for
bit.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as T
import repro_torch.kernels as K
from repro_torch.bench.row_slab import EDGE_CASES, edge_check
from repro_torch.core.storage.memtable import sort_run
from repro_torch.core.tpch import generate_orders, orders_schema
from repro_torch.core.storage.views import query_view_eligible, verify_views
from repro_torch.kernels import ops
from repro_torch.kernels.block_agg import (
    block_partials_card_order,
    block_sums,
    block_sums_plain,
    boundary_block_sums,
    boundary_block_sums_plain,
    scan_tile,
    scan_tile_plain,
)
from repro_torch.kernels.ecdf_hist import (
    SINGLE_CTA_ROWS,
    ecdf_hist,
    ecdf_hist_many,
    ecdf_hist_many_plain,
    ecdf_hist_plain,
)
from repro_torch.kernels.merge_runs import merge_run_positions, merge_run_positions_plain
from repro_torch.kernels.scan_agg import (
    scan_agg_qgrid,
    scan_agg_qgrid_plain,
    scan_agg_rowstream,
    scan_agg_rowstream_plain,
)
from repro_torch.kernels.slab_locate import (
    scan_agg_locate,
    scan_agg_locate_plain,
    select_compact,
    select_compact_plain,
    slab_locate,
    slab_locate_plain,
)

SCHEMAS = {
    "narrow": ({"a": 7, "b": 9, "c": 5}, ("b", "a", "c")),
    "wide": ({"a": 6, "w": 45, "c": 5}, ("a", "w", "c")),
}
# eight key lanes and fifteen value columns plus the ones row: 24 staged
# words a row, so the fused scan's staging tile (and with it the in-block
# order) is 1024 rows
TILE_1024 = ({f"k{i}": 7 for i in range(8)}, tuple(f"k{i}" for i in range(8)), 15)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _table(schema, n, seed, device):
    bits, layout = SCHEMAS[schema]
    rng = np.random.default_rng(seed)
    kc = {c: rng.integers(0, 1 << b, n, dtype=np.int64) for c, b in bits.items()}
    vc = {"v": rng.uniform(-10.0, 100.0, n), "u": rng.integers(0, 7, n).astype(np.float64)}
    t = T.SortedTable.from_columns(kc, vc, layout, T.KeySchema(dict(bits)))
    return t.place_on_device(device), kc


def _queries(bits, n_q, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_q):
        f = {}
        for c, b in bits.items():
            top = 1 << b
            kind = rng.integers(0, 4)
            if kind == 0:
                f[c] = T.Eq(int(rng.integers(0, top)))
            elif kind == 1:
                lo = int(rng.integers(0, top))
                f[c] = T.Range(lo, int(rng.integers(lo, top + 1)))
            elif kind == 2 and i % 7 == 3:
                lo = int(rng.integers(0, top))
                f[c] = T.Range(lo, lo)
        agg = ("sum", "count", "select")[i % 3]
        out.append(T.Query(filters=f, agg=agg, value_col=("v", "u")[i % 2] if agg == "sum" else None))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("schema", ["narrow", "wide"])
def test_scan_and_select_match_plain(cuda_device, schema):
    table, _ = _table(schema, 40_000, 13, cuda_device)
    st = table._device
    d = ops.device_query_operands(table, _queries(SCHEMAS[schema][0], 300, 14))
    args = (d["res_lo"], d["res_hi"], d["slab_lo"], d["slab_hi"], d["limits"], d["sel"])
    n_vals, cp = st["n_value_rows"], st["col_parts"]
    launches = K.KERNELS["scan_agg_locate"].launches
    got = scan_agg_locate(st["keys"], st["values_tile"], *args, col_parts=cp, n_vals=n_vals)
    assert K.KERNELS["scan_agg_locate"].launches == launches + 1
    want = scan_agg_locate_plain(st["keys"], st["values_tile"][:n_vals], *args, col_parts=cp)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)
    again = scan_agg_locate(st["keys"], st["values_tile"], *args, col_parts=cp, n_vals=n_vals)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # deterministic sums
    matched = got[1].cpu().numpy()
    s_args = (d["res_lo"], d["res_hi"], d["limits"])
    assert torch.equal(
        select_compact(st["keys"], *s_args, matched, col_parts=cp),
        select_compact_plain(st["keys"], *s_args, matched, col_parts=cp),
    )
    # arbitrary row windows, starting and ending inside blocks and tiles
    rng = np.random.default_rng(17)
    lim = np.sort(rng.integers(0, st["n_rows"] + 1, (len(matched), 2)), axis=1).astype(np.int32)
    lim_t = torch.from_numpy(lim).to(cuda_device)
    args = args[:4] + (lim_t, d["sel"])
    got = scan_agg_locate(st["keys"], st["values_tile"], *args, col_parts=cp, n_vals=n_vals)
    want = scan_agg_locate_plain(st["keys"], st["values_tile"][:n_vals], *args, col_parts=cp)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)
    matched = got[1].cpu().numpy()
    s_args = (d["res_lo"], d["res_hi"], lim_t)
    assert torch.equal(
        select_compact(st["keys"], *s_args, matched, col_parts=cp),
        select_compact_plain(st["keys"], *s_args, matched, col_parts=cp),
    )


@pytest.mark.cuda
def test_merge_and_hist_match_plain(cuda_device):
    table, kc = _table("wide", 30_000, 15, cuda_device)
    bits, _ = SCHEMAS["wide"]
    rng = np.random.default_rng(16)
    for step in range(3):
        wk = {c: rng.integers(0, 1 << b, 2000, dtype=np.int64) for c, b in bits.items()}
        wk["a"][:500] = kc["a"][:500]
        wv = {"v": rng.uniform(0, 1, 2000), "u": rng.uniform(0, 1, 2000)}
        table = table.merge_run(sort_run(wk, wv, table.layout, table.schema))
    st = table._device
    lanes = sum(st["col_parts"])
    got = merge_run_positions(st["keys"], st["run_starts"], st["n_rows"], n_lanes=lanes)
    want = merge_run_positions_plain(st["keys"], st["run_starts"], st["n_rows"], n_lanes=lanes)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(), st["row_map"])
    col = torch.from_numpy(kc["w"].astype(np.int64) % 5000 - 3).to(torch.int32).to(cuda_device)
    for n_bins, width in ((64, 1), (4096, 3)):
        assert torch.equal(
            ecdf_hist(col, n_bins=n_bins, bin_width=width),
            ecdf_hist_plain(col, n_bins=n_bins, bin_width=width),
        )


def _sorted_lanes_on(device, n, domains, seed, offset=0):
    """int32[len(domains), n] on ``device``: random key tuples (lane l
    uniform over [offset, offset + domains[l])) sorted lexicographically
    by chained stable sorts."""
    g = torch.Generator(device=device).manual_seed(seed)
    k = torch.stack([torch.randint(offset, offset + d, (n,), device=device, generator=g) for d in domains])
    order = torch.arange(n, device=device)
    for lane in reversed(range(len(domains))):
        order = order[torch.sort(k[lane, order], stable=True).indices]
    return k[:, order].to(torch.int32)


# run stacks at SF-5-like base sizes: (run lengths, per-run key domains
# and offset); every case holds keys equal across runs
LANES16 = (3, 4, 2, 5, 3, 2, 4, 3, 2, 3, 5, 2, 3, 4, 2, 7)


def _merge_case(name, device):
    rng = np.random.default_rng(30)
    if name == "64_runs_16_lanes":
        lens = [2_000_000] + [int(rng.integers(1, 40_000)) for _ in range(63)]
        runs = [_sorted_lanes_on(device, m, LANES16, i) for i, m in enumerate(lens)]
    elif name == "equal_keys":
        # eight distinct tuples: every insertion point is one of a few rows
        lens = [2_000_000] + [20_000] * 8
        runs = [_sorted_lanes_on(device, m, (2, 2, 2), i) for i, m in enumerate(lens)]
    elif name == "empty_runs_and_a_larger_appended_run":
        lens = [300_000, 0, 2_100_000, 0, 5_000, 2_100_000, 0]
        runs = [_sorted_lanes_on(device, m, (50, 60, 70), i) for i, m in enumerate(lens)]
    elif name == "insertion_at_runs_ends":
        # appended keys above every base key; an earlier run above a later one
        lens = [2_000_000, 20_000, 20_000, 7_000]
        offsets = [0, 1000, 0, 500]
        runs = [_sorted_lanes_on(device, m, (100, 100), i, off) for i, (m, off) in enumerate(zip(lens, offsets))]
    elif name == "60_bit_pairs":
        lens = [2_000_000] + [20_000] * 8
        runs = []
        for i, m in enumerate(lens):
            hi = _sorted_lanes_on(device, m, (1 << 20, 1 << 30, 4), i)  # (high bits, low bits, narrow)
            runs.append(hi)
    else:
        raise KeyError(name)
    keys = torch.cat(runs, dim=1).contiguous()
    starts = tuple(int(s) for s in np.cumsum([0] + lens[:-1]))
    return keys, starts, sum(lens), keys.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case",
    ["64_runs_16_lanes", "equal_keys", "empty_runs_and_a_larger_appended_run", "insertion_at_runs_ends", "60_bit_pairs"],
)
def test_merge_ranks_match_plain_at_sf5_sizes(cuda_device, case):
    keys, starts, n, lanes = _merge_case(case, cuda_device)
    launches = K.KERNELS["merge_run_positions"].launches
    got = merge_run_positions(keys, starts, n, n_lanes=lanes)
    assert K.KERNELS["merge_run_positions"].launches == launches + 1
    want = merge_run_positions_plain(keys, starts, n, n_lanes=lanes)
    assert torch.equal(got, want)
    assert torch.equal(merge_run_positions(keys, starts, n, n_lanes=lanes), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20_000, SINGLE_CTA_ROWS, SINGLE_CTA_ROWS + 5, 1_000_003])
def test_ecdf_hist_many_matches_plain_on_both_paths(cuda_device, n):
    """One CTA a column up to SINGLE_CTA_ROWS rows, several above (merged
    in the launch, scratch left zeroed: a second call gives the same);
    4096 bins, a width per column, negatives and rows past the last bin."""
    specs = [(4096, 256), (2406, 1), (4096, 2), (17, 3)]
    rng = np.random.default_rng(n)
    cols = np.stack([rng.integers(-9, nb * bw + 5 * bw, n) for nb, bw in specs]).astype(np.int32)
    cols[:, ::11] = -1
    t = torch.from_numpy(cols).to(cuda_device)
    n_bins, widths = [s[0] for s in specs], [s[1] for s in specs]
    launches = K.KERNELS["ecdf_hist"].launches
    got = ecdf_hist_many(t, n_bins=n_bins, bin_widths=widths)
    assert K.KERNELS["ecdf_hist"].launches == launches + 1
    assert torch.equal(got, ecdf_hist_many_plain(t, n_bins=n_bins, bin_widths=widths))
    assert torch.equal(ecdf_hist_many(t, n_bins=n_bins, bin_widths=widths), got)
    at = 0
    for i, (nb, bw) in enumerate(specs):
        one = ecdf_hist(t[i].contiguous(), n_bins=nb, bin_width=bw)
        assert torch.equal(one, got[at : at + nb])
        valid = cols[i][cols[i] >= 0] // bw
        want = np.bincount(valid[valid < nb], minlength=nb).astype(np.float32)
        np.testing.assert_array_equal(one.cpu().numpy(), want)
        at += nb


@pytest.mark.cuda
def test_ecdf_hist_many_splits_more_columns_than_a_launch_holds(cuda_device):
    rng = np.random.default_rng(40)
    cols = torch.from_numpy(rng.integers(-2, 300, (70, 5000)).astype(np.int32)).to(cuda_device)
    n_bins, widths = [64 + i for i in range(70)], [1 + i % 5 for i in range(70)]
    launches = K.KERNELS["ecdf_hist"].launches
    got = ecdf_hist_many(cols, n_bins=n_bins, bin_widths=widths)
    assert K.KERNELS["ecdf_hist"].launches == launches + 2
    assert torch.equal(got, ecdf_hist_many_plain(cols, n_bins=n_bins, bin_widths=widths))


@pytest.mark.cuda
def test_engine_on_the_card_matches_the_cpu_engine(cuda_device):
    """The same column family, reads and write drip (with a compaction)
    on the card and on the CPU: equal answers and resident states."""
    kc, vc = generate_orders(0.02, seed=3)
    engines = {}
    for dev in (cuda_device, torch.device("cpu")):
        eng = T.HREngine(n_nodes=6, device=dev)
        eng.create_column_family(
            "o", kc, vc, replication_factor=3,
            layouts=[("clerk", "orderdate", "custkey"), ("custkey", "orderdate", "clerk"),
                     ("orderdate", "clerk", "custkey")],
            schema=orders_schema(), device_resident=True,
        )
        engines[dev.type] = eng
    wl = T.tpch.q1_q2_workload(n_instances=96, n_rows=len(kc["custkey"]), seed=4)
    qs = list(wl.queries[:48]) + [T.Query(filters=q.filters, agg="select") for q in wl.queries[48:]]
    qs.append(T.Query(filters={"custkey": T.Range(0, 300)}, agg="select"))
    kw, vw = generate_orders(0.002, seed=5)
    for step in range(10):
        for eng in engines.values():
            sl = slice(step * 300, (step + 1) * 300)
            eng.write("o", {c: v[sl] for c, v in kw.items()}, {c: v[sl] for c, v in vw.items()})
        if step in (0, 9):
            a, b = (engines[k].read_many("o", qs) for k in ("cuda", "cpu"))
            for (ra, pa), (rb, pb) in zip(a, b):
                assert pa.replica_id == pb.replica_id
                assert (ra.rows_scanned, ra.rows_matched) == (rb.rows_scanned, rb.rows_matched)
                np.testing.assert_allclose(ra.value, rb.value, rtol=1e-5, atol=1e-3)
                if ra.selected is not None:
                    np.testing.assert_array_equal(ra.selected, rb.selected)
    assert engines["cuda"].stats["compactions"] == engines["cpu"].stats["compactions"] > 0
    for r in engines["cuda"].column_families["o"].replicas:
        ta = engines["cuda"]._table(engines["cuda"].column_families["o"], r)
        tb = engines["cpu"]._table(engines["cpu"].column_families["o"], r)
        assert torch.equal(ta._device["keys"].cpu(), tb._device["keys"])
        assert torch.equal(ta._device["values_tile"].cpu(), tb._device["values_tile"])


def _view_table(kind, n, seed, device):
    """A resident table with a view: the narrow or wide schema with two
    value columns, or TILE_1024's."""
    if kind == "tile1024":
        bits, layout, n_vals = TILE_1024
    else:
        (bits, layout), n_vals = SCHEMAS[kind], 2
    rng = np.random.default_rng(seed)
    kc = {c: rng.integers(0, 1 << min(b, 6), n, dtype=np.int64) for c, b in bits.items()}
    vc = {f"v{i}": rng.uniform(-10.0, 100.0, n) for i in range(n_vals)}
    t = T.SortedTable.from_columns(kc, vc, layout, T.KeySchema(dict(bits)))
    return t.place_on_device(device).build_views(), bits, n_vals


def _view_queries(layout, bits, n_vals, n_q, seed):
    """View-eligible sums and counts on ``layout``: an equality prefix and
    at most one range, inside the columns' generated domains."""
    rng = np.random.default_rng(seed)
    top = {c: 1 << min(b, 6) for c, b in bits.items()}
    out = []
    for i in range(n_q):
        depth = int(rng.integers(0, min(len(layout), 4) + 1))
        f = {c: T.Eq(int(rng.integers(0, top[c]))) for c in layout[:depth]}
        if depth < len(layout) and rng.random() < 0.8:
            c = layout[depth]
            lo = int(rng.integers(0, top[c]))
            f[c] = T.Range(lo, int(rng.integers(lo, top[c] + 1)))
        agg = "count" if i % 4 == 3 else "sum"
        out.append(T.Query(filters=f, agg=agg, value_col=f"v{i % n_vals}" if agg == "sum" else None))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["narrow", "wide", "tile1024"])
def test_view_kernels_match_plain_and_the_fused_scan(cuda_device, kind):
    """block_sums and boundary_block_sums against their plain versions on
    the card, and every view-served answer equal to the fused kernel's on
    the same table bit for bit: fresh, after two appends and after a
    compaction."""
    table, bits, n_vals = _view_table(kind, 60_000, 21, cuda_device)
    st = table._device
    k_ex, nv = sum(st["col_parts"]), st["n_value_rows"]
    tile = scan_tile(k_ex, nv)
    assert tile == (1024 if kind == "tile1024" else 2048)
    args = dict(n_rows=st["n_rows"], block_n=8192, n_vals=nv)
    got = block_sums(st["values_tile"], n_key_lanes=k_ex, **args)
    want = block_sums_plain(st["values_tile"], n_rows=st["n_rows"], n_vals=nv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    qs = _view_queries(table.layout, bits, n_vals, 120, 22)
    assert all(query_view_eligible(q, table.layout) for q in qs)
    rng = np.random.default_rng(23)
    for step in range(4):
        stats = {}
        served = table.execute_many(qs, view_stats=stats)
        assert stats["hits"] == len(qs)
        fused = ops.table_execute_device_many(table, qs)
        for q, a, b in zip(qs, served, fused):
            assert a.value == b.value, (kind, step, q)
            assert (a.rows_matched, a.rows_scanned) == (b.rows_matched, b.rows_scanned)
        assert verify_views(table)
        if step == 2:
            table.compact_runs()
            assert st is not table._device and table._device["n_runs"] == 1
            continue
        wk = {c: rng.integers(0, 1 << min(b, 6), 5000, dtype=np.int64) for c, b in bits.items()}
        wv = {f"v{i}": rng.uniform(-10.0, 100.0, 5000) for i in range(n_vals)}
        table = table.merge_run(sort_run(wk, wv, table.layout, table.schema))
    # boundary rescans of pairs spanning the run windows, against plain
    st = table._device
    args = dict(n_rows=st["n_rows"], block_n=8192, n_vals=nv)
    p = 64
    blocks = rng.integers(0, -(-st["n_rows"] // 8192), p)
    lo = np.sort(rng.integers(0, st["n_rows"] + 1, (p, 3)), axis=1)
    hi = np.minimum(lo + rng.integers(0, 20_000, (p, 3)), st["n_rows"])
    sel = rng.integers(0, nv, p)
    got = boundary_block_sums(st["values_tile"], sel, blocks, lo, hi, n_key_lanes=k_ex, **args)
    t = [torch.from_numpy(np.asarray(a, np.int32)).to(cuda_device) for a in (sel, blocks, lo, hi)]
    want = boundary_block_sums_plain(st["values_tile"], *t, n_rows=st["n_rows"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    assert torch.equal(got, boundary_block_sums(st["values_tile"], sel, blocks, lo, hi, n_key_lanes=k_ex, **args))


@pytest.mark.cuda
def test_views_engine_on_the_card_matches_the_fused_engine(cuda_device):
    """A views column family and a plain one on the card, through writes
    and a compaction: every view-served answer equal to the fused kernel's
    on the replica that served it, the sums bit for bit; counts equal to
    the plain column family's."""
    kc, vc = generate_orders(0.02, seed=6)
    layouts = [("clerk", "orderdate", "custkey"), ("custkey", "orderdate", "clerk"),
               ("orderdate", "clerk", "custkey")]
    engines = {}
    for views in (True, False):
        eng = T.HREngine(n_nodes=6, device=cuda_device)
        eng.create_column_family(
            "o", kc, vc, replication_factor=3, layouts=layouts, schema=orders_schema(),
            device_resident=True, views=views,
        )
        engines[views] = eng
    wl = T.tpch.q1_q2_workload(n_instances=96, n_rows=len(kc["custkey"]), seed=7)
    qs = list(wl.queries[:64]) + [T.Query(filters=q.filters, agg="count") for q in wl.queries[64:]]
    kw, vw = generate_orders(0.004, seed=8)
    for step in range(10):
        sl = slice(step * 600, (step + 1) * 600)
        for eng in engines.values():
            eng.write("o", {c: v[sl] for c, v in kw.items()}, {c: v[sl] for c, v in vw.items()})
        if step in (0, 7, 9):
            ev = engines[True]
            cf = ev.column_families["o"]
            a, b = (engines[v].read_many("o", qs) for v in (True, False))
            for q, (ra, pa), (rb, _) in zip(qs, a, b):
                assert ra.rows_matched == rb.rows_matched
                table = ev._table(cf, cf.replicas[pa.replica_id])
                (fused,) = ops.table_execute_device_many(table, [q])
                assert (ra.value, ra.rows_matched, ra.rows_scanned) == (
                    fused.value, fused.rows_matched, fused.rows_scanned
                )
    ev = engines[True]
    assert ev.stats["view_hits"] > 0 and ev.stats["view_rebuilds"] >= 3
    for r in ev.column_families["o"].replicas:
        assert verify_views(ev._table(ev.column_families["o"], r))


# -- partitioned column families --------------------------------------------------------


@pytest.mark.cuda
def test_token_histogram_on_the_card_equals_bincount(cuda_device):
    """``TokenHistogram.add_tokens`` on the card at 4096 bins (the 45-bit
    ``orders`` key space): one ``ecdf_hist`` launch a call below 2**24
    tokens, counts equal to ``np.bincount`` exactly; a call above 2**24
    tokens takes the host path and launches nothing."""
    schema = orders_schema()
    hist = T.TokenHistogram.build(schema.total_bits(tuple(schema.bits)))
    assert hist.n_bins == 4096
    rng = np.random.default_rng(31)
    space = 1 << hist.total_bits
    batches = [
        rng.integers(0, space, 1),
        rng.integers(0, space, 20_000),
        np.minimum(rng.zipf(1.2, 7_500_000), space) - 1,
        rng.integers(0, space, (1 << 24) + 1),
    ]
    hl = K.KERNELS["ecdf_hist"]
    for i, toks in enumerate(batches):
        before = hl.launches
        hist.add_tokens(toks, device=cuda_device)
        assert hl.launches == before + (1 if toks.size < (1 << 24) else 0)
        want = np.bincount(np.concatenate(batches[: i + 1]) >> hist.shift, minlength=hist.n_bins)
        np.testing.assert_array_equal(hist.counts, want)


@pytest.mark.cuda
def test_partitioned_family_on_the_card_matches_the_cpu(cuda_device):
    """A P = 3 device-resident column family (token-quantile boundaries)
    on the card and on the CPU, through reads, a write drip that compacts
    and reads again: the same replica for every query, equal answers and
    selects, equal token histograms and per-partition statistics."""
    kc, vc = generate_orders(0.02, seed=33)
    layouts = [("clerk", "orderdate", "custkey"), ("custkey", "orderdate", "clerk"),
               ("orderdate", "clerk", "custkey")]
    engines = {}
    for dev in (cuda_device, torch.device("cpu")):
        eng = T.HREngine(n_nodes=6, device=dev)
        eng.create_column_family(
            "o", kc, vc, replication_factor=3, layouts=layouts, schema=orders_schema(),
            device_resident=True, partitions=3, partition_balance="tokens",
        )
        engines[dev.type] = eng
    wl = T.tpch.q1_q2_workload(n_instances=96, n_rows=len(kc["custkey"]), seed=34)
    qs = list(wl.queries[:48]) + [T.Query(filters=q.filters, agg="select") for q in wl.queries[48:]]
    qs.append(T.Query(filters={"custkey": T.Range(0, 300)}, agg="select"))
    kw, vw = generate_orders(0.002, seed=35)
    for step in range(10):
        for eng in engines.values():
            sl = slice(step * 300, (step + 1) * 300)
            eng.write("o", {c: v[sl] for c, v in kw.items()}, {c: v[sl] for c, v in vw.items()})
        if step in (0, 9):
            a, b = (engines[k].read_many("o", qs) for k in ("cuda", "cpu"))
            for (ra, pa), (rb, pb) in zip(a, b):
                assert (pa.replica_id, pa.node_id) == (pb.replica_id, pb.node_id)
                assert (ra.rows_scanned, ra.rows_matched) == (rb.rows_scanned, rb.rows_matched)
                np.testing.assert_allclose(ra.value, rb.value, rtol=1e-5, atol=1e-3)
                if ra.selected is not None:
                    np.testing.assert_array_equal(ra.selected, rb.selected)
    ca, cb = engines["cuda"].column_families["o"], engines["cpu"].column_families["o"]
    assert engines["cuda"].stats["compactions"] == engines["cpu"].stats["compactions"] > 0
    np.testing.assert_array_equal(ca.token_hist.counts, cb.token_hist.counts)
    for pa, pb in zip(ca.partitions, cb.partitions):
        for c in pa.stats.columns:
            np.testing.assert_array_equal(pa.stats.columns[c].counts, pb.stats.columns[c].counts)


# -- the row-slab read path ------------------------------------------------------------


def _slab_operands(table, qs, device):
    """Slab keys and windows (``ops._device_query_bounds``), residual
    bounds, host slabs and the value-row selector, as int32 tensors."""
    st = table._device
    res_lo, res_hi, slab_lo, slab_hi, limits = ops._device_query_bounds(
        table, qs, st["col_parts"], st["n_rows"]
    )
    host = T.SortedTable(table.layout, table.schema, table.key_cols, table.value_cols, table.packed)
    slabs = host.slab_many(qs)
    sel = [st["value_rows"][q.value_col] if q.agg == "sum" else st["ones_row"] for q in qs]
    arrays = (res_lo, res_hi, slab_lo, slab_hi, limits, slabs, np.asarray(sel))
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("schema", ["narrow", "wide"])
def test_slab_locate_and_rowstream_match_plain(cuda_device, schema):
    table, _ = _table(schema, 40_000, 21, cuda_device)
    st = table._device
    qs = [q for q in _queries(SCHEMAS[schema][0], 300, 22) if q.agg != "select"]
    res_lo, res_hi, slab_lo, slab_hi, limits, slabs, sel = _slab_operands(table, qs, cuda_device)
    cp, n_vals = st["col_parts"], st["n_value_rows"]
    launches = K.KERNELS["slab_locate"].launches
    got = slab_locate(st["keys"], slab_lo, slab_hi, limits)
    assert K.KERNELS["slab_locate"].launches == launches + 1
    assert torch.equal(got, slab_locate_plain(st["keys"], slab_lo, slab_hi, limits))
    assert torch.equal(got.long(), slabs.long())  # == the host searchsorted
    launches = K.KERNELS["scan_agg_rowstream"].launches
    out = scan_agg_rowstream(st["keys"], st["values_tile"], res_lo, res_hi, slabs, sel, col_parts=cp, n_vals=n_vals)
    assert K.KERNELS["scan_agg_rowstream"].launches == launches + 1
    want = scan_agg_rowstream_plain(st["keys"], st["values_tile"][:n_vals], res_lo, res_hi, slabs, sel, col_parts=cp)
    assert torch.equal(out[:, 1], want[:, 1])
    torch.testing.assert_close(out[:, 0], want[:, 0], rtol=1e-5, atol=1e-3)
    again = scan_agg_rowstream(st["keys"], st["values_tile"], res_lo, res_hi, slabs, sel, col_parts=cp, n_vals=n_vals)
    assert torch.equal(out, again)  # deterministic sums
    # arbitrary slabs and selectors, some outside the live value rows
    rng = np.random.default_rng(23)
    rnd = np.sort(rng.integers(0, st["n_rows"] + 1, (len(qs), 2)), axis=1).astype(np.int32)
    rnd_t = torch.from_numpy(rnd).to(cuda_device)
    sel2 = torch.from_numpy(rng.integers(-1, n_vals + 1, len(qs)).astype(np.int32)).to(cuda_device)
    out = scan_agg_rowstream(st["keys"], st["values_tile"], res_lo, res_hi, rnd_t, sel2, col_parts=cp, n_vals=n_vals)
    want = scan_agg_rowstream_plain(st["keys"], st["values_tile"][:n_vals], res_lo, res_hi, rnd_t, sel2, col_parts=cp)
    assert torch.equal(out[:, 1], want[:, 1])
    torch.testing.assert_close(out[:, 0], want[:, 0], rtol=1e-5, atol=1e-3)
    # windows inside the table: ranks within [start, stop) of the sorted run
    got = slab_locate(st["keys"], slab_lo, slab_hi, rnd_t)
    assert torch.equal(got, slab_locate_plain(st["keys"], slab_lo, slab_hi, rnd_t))


@pytest.mark.cuda
def test_qgrid_matches_plain(cuda_device):
    table, _ = _table("narrow", 40_000, 24, cuda_device)
    st = table._device
    qs = [q for q in _queries(SCHEMAS["narrow"][0], 200, 25) if q.agg == "count"]
    res_lo, res_hi, _, _, _, slabs, _ = _slab_operands(table, qs, cuda_device)
    row = st["values_tile"][0]
    launches = K.KERNELS["scan_agg_qgrid"].launches
    got = scan_agg_qgrid(st["keys"], row, res_lo, res_hi, slabs)
    assert K.KERNELS["scan_agg_qgrid"].launches == launches + 1
    want = scan_agg_qgrid_plain(st["keys"], row, res_lo, res_hi, slabs)
    assert torch.equal(got[:, 1], want[:, 1])
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=1e-5, atol=1e-3)
    assert torch.equal(got, scan_agg_qgrid(st["keys"], row, res_lo, res_hi, slabs))


@pytest.mark.cuda
def test_row_slab_path_on_the_card_matches_the_cpu(cuda_device):
    """slab_many and table_scan_device_many on a resident table: the card
    and a CPU twin give equal slabs and counts and close sums; after an
    append slab_many launches nothing and the scans raise."""
    bits, layout = SCHEMAS["wide"]
    tables = {d: _table("wide", 30_000, 26, d)[0] for d in ("cuda", "cpu")}
    qs = [q for q in _queries(bits, 120, 27) if q.agg != "select"]
    assert np.array_equal(tables["cuda"].slab_many(qs), tables["cpu"].slab_many(qs))
    got = ops.table_scan_device_many(tables["cuda"], qs)
    want = ops.table_scan_device_many(tables["cpu"], qs)
    for (a, c), (b, d) in zip(got, want):
        assert c == d
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-3)
    counts = [q for q in qs if q.agg == "count"]
    got = ops.table_scan_device_many(tables["cuda"], counts[:5], slabs=tables["cpu"].slab_many(counts[:5]))
    assert [c for _, c in got] == [c for _, c in ops.table_scan_device_many(tables["cpu"], counts[:5])]
    rng = np.random.default_rng(28)
    wk = {c: rng.integers(0, 1 << b, 500, dtype=np.int64) for c, b in bits.items()}
    wv = {"v": rng.uniform(0, 1, 500), "u": rng.uniform(0, 1, 500)}
    t = tables["cuda"].merge_run(sort_run(wk, wv, layout, tables["cuda"].schema))
    before = {name: fn.launches for name, fn in K.KERNELS.items()}
    host = T.SortedTable(t.layout, t.schema, t.key_cols, t.value_cols, t.packed)
    assert np.array_equal(t.slab_many(qs), host.slab_many(qs))
    assert {name: fn.launches for name, fn in K.KERNELS.items()} == before
    with pytest.raises(ValueError, match="single sorted run"):
        ops.table_scan_device_many(t, qs)



@pytest.mark.cuda
@pytest.mark.parametrize("name", EDGE_CASES)
def test_row_slab_kernels_equal_their_emulation_on_edge_cases(cuda_device, name):
    """Both row-slab kernels on an edge case of their decomposition
    (``bench.row_slab.edge_cases``: empty slabs, slabs inside a unit, at
    the table's end, one query, more than a chunk, wide pairs, selectors
    outside the value rows, tiles no slab meets): counts equal to plain,
    sums within tolerance, run to run identical, and bit for bit equal to
    the decomposition written out in PyTorch (``scan_agg_*_emulated``)."""
    before = (K.KERNELS["scan_agg_rowstream"].launches, K.KERNELS["scan_agg_qgrid"].launches)
    out = edge_check(cuda_device, names=(name,))
    assert set(out) == {name}
    assert K.KERNELS["scan_agg_rowstream"].launches == before[0] + 2
    assert K.KERNELS["scan_agg_qgrid"].launches == before[1] + (0 if name == "wide" else 2)

# -- the redesigned fused scan and view block sums ----------------------------------------


def _scan_operands(col_bits, n, n_q, seed, device):
    """Key lanes of random columns (``col_bits`` per logical column; a
    column over 30 bits is a lane pair) and random operands whose residual
    box and slab are drawn apart, so the box mostly lies outside the slab;
    every fifth query empty; windows whole, random or empty; selectors
    partly outside the value rows."""
    rng = np.random.default_rng(seed)
    col_parts = tuple(2 if b > 30 else 1 for b in col_bits)

    def lanes(vals):
        out = []
        for v, b in zip(vals, col_bits):
            out += [v >> 30, v & ((1 << 30) - 1)] if b > 30 else [v]
        return np.stack(out)

    def draw(m):
        return [rng.integers(0, 1 << b, m, dtype=np.int64) for b in col_bits]

    cols = draw(n)
    keys = lanes(cols)
    pick = rng.integers(0, n, n_q)
    a, b = draw(n_q), draw(n_q)
    # a third of the boxes are widened to hold the picked row, which is in
    # the slab below, so every lane count has matches
    hold = rng.random(n_q) < 1 / 3
    a = [np.where(hold, np.minimum(x, y), x) for x, y in zip(a, (col[pick] for col in cols))]
    b = [np.where(hold, np.maximum(x, y), x) for x, y in zip(b, (col[pick] for col in cols))]
    res_lo = lanes([np.minimum(x, y) for x, y in zip(a, b)]).T
    res_hi = lanes([np.maximum(x, y) + 1 for x, y in zip(a, b)]).T
    slab_lo = keys[:, pick].T.copy()
    slab_hi = slab_lo.copy()
    slab_hi[:, -1] += rng.integers(0, 64, n_q)
    c, d = lanes(draw(n_q)).T, lanes(draw(n_q)).T
    swap = np.array([tuple(x) > tuple(y) for x, y in zip(c, d)])
    c[swap], d[swap] = d[swap].copy(), c[swap].copy()
    far = rng.random(n_q) < 0.3
    slab_lo[far], slab_hi[far] = c[far], d[far]
    limits = np.sort(rng.integers(0, n + 1, (n_q, 2)), axis=1)
    limits[rng.random(n_q) < 0.5] = (0, n)
    empty = np.arange(n_q) % 5 == 0
    slab_lo[empty], slab_hi[empty], limits[empty] = 0, -1, 0
    sel = rng.integers(-1, 4, n_q)
    arrays = (keys, res_lo, res_hi, slab_lo, slab_hi, limits, sel)
    t = [torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device) for x in arrays]
    values = torch.from_numpy(rng.uniform(-5, 5, (3, n)).astype(np.float32)).to(device)
    return t[0], values, tuple(t[1:6]), t[6], col_parts


def _fused_matches_plain(keys, values, args, sel, col_parts, n_vals):
    got = scan_agg_locate(keys, values, *args, sel, col_parts=col_parts, n_vals=n_vals)
    want = scan_agg_locate_plain(keys, values[:n_vals], *args, sel, col_parts=col_parts)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-3)
    again = scan_agg_locate(keys, values, *args, sel, col_parts=col_parts, n_vals=n_vals)
    assert all(torch.equal(x, y) for x, y in zip(got, again))  # deterministic sums
    assert int(got[1].sum()) > 0 and int(got[2].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "col_bits, n",
    [
        ((9,), 6001),  # one lane; rows not a multiple of 4: 4-byte staging
        ((7, 9, 5), 3 * 8192 + 801),  # TPC-H's three lanes, a ragged last block
        ((6, 45, 5), 20_000),  # a wide column: four lanes
        ((60, 60, 60, 12, 3), 9000),  # eight lanes, three 60-bit pairs
        ((40, 40, 40, 40, 7), 7000),  # nine lanes: the generic instantiation
        ((40,) * 30, 3000),  # sixty lanes: generic, one staging buffer
    ],
)
def test_fused_scan_matches_plain_on_independent_bounds(cuda_device, col_bits, n):
    """The fused kernel against its plain version on operands whose
    residual box lies outside the slab as often as not, with wide lane
    pairs, empty queries, random windows and stray selectors, over the
    compile-time lane counts and the generic one."""
    keys, values, args, sel, cp = _scan_operands(col_bits, n, 300, 31 + n, cuda_device)
    launches = K.KERNELS["scan_agg_locate"].launches
    _fused_matches_plain(keys, values, args, sel, cp, 3)
    assert K.KERNELS["scan_agg_locate"].launches == launches + 2
    # only two of the three value rows live: a selector of 2 sums nothing
    _fused_matches_plain(keys, values, args, sel, cp, 2)


@pytest.mark.cuda
def test_fused_scan_matches_plain_on_a_run_stack(cuda_device):
    """A resident table with two appended runs (and the older state whose
    padding the appends filled): the engine's operands and random windows,
    the kernel against its plain version on the same tensors."""
    table, kc = _table("wide", 30_000, 33, cuda_device)
    older = table
    bits, layout = SCHEMAS["wide"]
    rng = np.random.default_rng(34)
    for m in (4000, 2500):
        wk = {c: rng.integers(0, 1 << b, m, dtype=np.int64) for c, b in bits.items()}
        wk["a"][: m // 3] = kc["a"][: m // 3]
        wv = {"v": rng.uniform(-10, 100, m), "u": rng.uniform(0, 7, m)}
        table = table.merge_run(sort_run(wk, wv, layout, table.schema))
    assert table._device["n_runs"] == 3
    qs = [q for q in _queries(bits, 300, 35) if q.agg != "select"]
    for t in (table, older):
        st = t._device
        d = ops.device_query_operands(t, qs)
        args = (d["res_lo"], d["res_hi"], d["slab_lo"], d["slab_hi"], d["limits"])
        _fused_matches_plain(st["keys"], st["values_tile"], args, d["sel"], st["col_parts"], st["n_value_rows"])
        lim = np.sort(rng.integers(0, st["n_rows"] + 1, (len(qs), 2)), axis=1).astype(np.int32)
        args = args[:4] + (torch.from_numpy(lim).to(cuda_device),)
        _fused_matches_plain(st["keys"], st["values_tile"], args, d["sel"], st["col_parts"], st["n_value_rows"])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["narrow", "wide", "tile1024"])
def test_block_sums_equal_the_card_order_bit_for_bit(cuda_device, kind):
    """block_sums against the contract's in-block order written out in
    PyTorch (block_partials_card_order), bit for bit, on a fresh view and
    after an append (an older state's padding then holds newer rows), for
    whole builds and a flush's tail."""
    table, bits, n_vals = _view_table(kind, 50_000, 36, cuda_device)
    rng = np.random.default_rng(37)
    wk = {c: rng.integers(0, 1 << min(b, 6), 9000, dtype=np.int64) for c, b in bits.items()}
    wv = {f"v{i}": rng.uniform(-10.0, 100.0, 9000) for i in range(n_vals)}
    newer = table.merge_run(sort_run(wk, wv, table.layout, table.schema))
    for t in (table, newer):
        st = t._device
        k_ex, nv, n = sum(st["col_parts"]), st["n_value_rows"], st["n_rows"]
        tile = scan_tile(k_ex, nv)
        got = block_sums(st["values_tile"], n_rows=n, block_n=8192, n_vals=nv, n_key_lanes=k_ex)
        tail = block_sums(st["values_tile"], n_rows=n, block_n=8192, first_block=3, n_vals=nv, n_key_lanes=k_ex)
        for v in range(nv):
            want = block_partials_card_order(st["values_tile"][v], n, tile)
            assert torch.equal(got[v], want), (kind, v)
            assert torch.equal(tail[v], want[3:]), (kind, v)


@pytest.mark.cuda
def test_scan_tile_keeps_the_frozen_formula(cuda_device):
    """The built library's staging tile equals the frozen formula for every
    lane count and a spread of value-row counts: the in-block order, and
    every stored view partial with it, has not moved."""
    for lanes in range(1, 66):
        for n_vals in (1, 2, 3, 4, 9, 16, 40, 100):
            assert scan_tile(lanes, n_vals) == scan_tile_plain(lanes, n_vals), (lanes, n_vals)


@pytest.mark.cuda
def test_fused_scan_matches_plain_on_a_tpch_run_stack(cuda_device):
    """The main path's shape at a small scale: a clerk-led orders table with
    two appended runs and the Q1/Q2 batch it serves. The tiles straddling
    two runs are live for nearly every query, so the kernel refines them
    by segment; counts equal the plain version's, sums within tolerance."""
    kc, vc = generate_orders(0.2, seed=40)
    layout = ("clerk", "orderdate", "custkey")
    table = T.SortedTable.from_columns(kc, vc, layout, orders_schema()).place_on_device(cuda_device)
    kw, vw = generate_orders(0.02, seed=41)
    for i in range(2):
        sl = slice(i * 15_000, (i + 1) * 15_000)
        table = table.merge_run(sort_run({c: v[sl] for c, v in kw.items()}, {c: v[sl] for c, v in vw.items()}, layout, table.schema))
    st = table._device
    assert st["n_runs"] == 3
    wl = T.tpch.q1_q2_workload(n_instances=400, n_rows=len(kc["custkey"]), seed=42)
    qs = [q for q in wl.queries if isinstance(q.filters.get("clerk"), T.Eq)][:256]
    d = ops.device_query_operands(table, qs)
    args = (d["res_lo"], d["res_hi"], d["slab_lo"], d["slab_hi"], d["limits"])
    _fused_matches_plain(st["keys"], st["values_tile"], args, d["sel"], st["col_parts"], st["n_value_rows"])


def _select_case(col_parts, n, n_q, seed, device):
    """Random key lanes (narrow columns of 6 bits, wide of 40) and select
    operands: each query restricts two random columns to a quarter of
    their domain and leaves the rest whole; query 0 takes every row (its
    matches span every block), query 1 none (an empty box), and every
    tenth query a random window inside the table. Counts from the plain
    match mask."""
    rng = np.random.default_rng(seed)
    bits = [40 if p == 2 else 6 for p in col_parts]

    def lanes(vals):
        out = []
        for v, p in zip(vals, col_parts):
            out += [v >> 30, v & ((1 << 30) - 1)] if p == 2 else [v]
        return np.stack(out)

    keys = lanes([rng.integers(0, 1 << b, n, dtype=np.int64) for b in bits])
    lo = np.zeros((len(bits), n_q), np.int64)
    hi = np.array([[1 << b] * n_q for b in bits], np.int64)
    for q in range(2, n_q):
        for c in rng.choice(len(bits), size=min(2, len(bits)), replace=False):
            lo[c, q] = rng.integers(0, 1 << bits[c])
            hi[c, q] = lo[c, q] + (1 << bits[c]) // 4
    hi[:, 1] = lo[:, 1]
    limits = np.tile(np.array([0, n], np.int64), (n_q, 1))
    limits[10::10] = np.sort(rng.integers(0, n + 1, (len(limits[10::10]), 2)), axis=1)
    t = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device) for a in (keys, lanes(lo).T, lanes(hi).T, limits)]
    return t, tuple(col_parts)


def _select_matches_plain(keys, res_lo, res_hi, limits, col_parts):
    from repro_torch.kernels.slab_locate import _residual_mask, _window

    counts = _residual_mask(keys, res_lo, res_hi, col_parts, _window(limits, keys.shape[1])).sum(dim=1).cpu().numpy()
    launches = K.KERNELS["select_compact"].launches
    got = select_compact(keys, res_lo, res_hi, limits, counts, col_parts=col_parts)
    assert K.KERNELS["select_compact"].launches == launches + 1
    want = select_compact_plain(keys, res_lo, res_hi, limits, counts, col_parts=col_parts)
    assert got.shape == (int(counts.sum()),)
    assert torch.equal(got, want)
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize(
    "col_parts", [(1,), (1, 1, 1), (1,) * 8, (2, 2, 2, 1, 1, 1), (2,) * 30], ids=["1", "3", "8", "9", "60"]
)
def test_select_compact_matches_plain_at_every_lane_count(cuda_device, col_parts):
    """More than 128 selects (three query chunks), a ragged last block,
    a select matching every row and one matching none."""
    (keys, res_lo, res_hi, limits), cp = _select_case(col_parts, 5 * 8192 + 1234, 300, sum(col_parts), cuda_device)
    counts = _select_matches_plain(keys, res_lo, res_hi, limits, cp)
    assert counts[0] == keys.shape[1] and counts[1] == 0


@pytest.mark.cuda
def test_select_compact_matches_plain_on_a_tpch_run_stack(cuda_device):
    """The main path's selects on a clerk-led orders table with two
    appended runs, and the same table's older state, whose capacity
    padding holds the newer rows."""
    kc, vc = generate_orders(0.2, seed=50)
    layout = ("clerk", "orderdate", "custkey")
    table = T.SortedTable.from_columns(kc, vc, layout, orders_schema()).place_on_device(cuda_device)
    older = table
    kw, vw = generate_orders(0.02, seed=51)
    for i in range(2):
        sl = slice(i * 15_000, (i + 1) * 15_000)
        table = table.merge_run(sort_run({c: v[sl] for c, v in kw.items()}, {c: v[sl] for c, v in vw.items()}, layout, table.schema))
    assert table._device["n_runs"] == 3
    wl = T.tpch.q1_q2_workload(n_instances=300, n_rows=len(kc["custkey"]), seed=52)
    qs = [T.Query(filters=q.filters, agg="select") for q in wl.queries]
    for t in (table, older):
        st = t._device
        d = ops.device_query_operands(t, qs)
        counts = _select_matches_plain(st["keys"], d["res_lo"], d["res_hi"], d["limits"], st["col_parts"])
        assert counts.sum() > 0


def _sorted_lanes(bits, n, seed, domain, device):
    """A sorted run of ``n`` rows (columns of ``bits``, first most
    significant, drawn from ``[0, domain)``) as key lanes on ``device``,
    its packed int64 key, and the packing."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, min(1 << b, domain), n, dtype=np.int64) for b in bits]
    shifts = [sum(bits[i + 1 :]) for i in range(len(bits))]
    packed = np.sort(sum(c << s for c, s in zip(cols, shifts)))
    cols = [(packed >> s) & ((1 << b) - 1) for b, s in zip(bits, shifts)]
    lanes = []
    for c, b in zip(cols, bits):
        lanes += [c >> 30, c & ((1 << 30) - 1)] if b > 30 else [c]
    return torch.from_numpy(np.stack(lanes).astype(np.int32)).to(device), packed, shifts


@pytest.mark.cuda
@pytest.mark.parametrize("bits,domain", [((20, 12, 13), 1 << 20), ((60, 2), 1 << 60), ((12,), 64)],
                         ids=["orders_lanes", "wide_60_bit", "duplicates"])
def test_slab_locate_matches_plain_and_searchsorted_at_sf5(cuda_device, bits, domain):
    """7.5 M rows (TPC-H SF 5): windows of 0, 1, 32, 33, 1089 rows and the
    whole run, bounds at existing keys, random, below and above every
    key, and an empty query; the kernel equals the rank form, the k-ary
    emulation and torch.searchsorted on the packed key."""
    from repro_torch.kernels.slab_locate import kary_ranks_emulated

    n = 7_500_000
    keys, packed, shifts = _sorted_lanes(bits, n, 60, domain, cuda_device)
    rng = np.random.default_rng(61)
    top = sum(((1 << b) - 1) << s for b, s in zip(bits, shifts))
    lo_keys, hi_keys, limits = [], [], []
    for w in (0, 1, 32, 33, 1089, n):
        for kind in ("row", "random", "below", "above", "span"):
            s = int(rng.integers(0, n - w + 1))
            a, b = {
                "row": (packed[int(rng.integers(0, n))],) * 2,
                "random": tuple(sorted(int(x) for x in rng.integers(0, top, 2))),
                "below": (0, 0),
                "above": (top, top),
                "span": (0, top),
            }[kind]
            lo_keys.append(int(a))
            hi_keys.append(int(b))
            limits.append((s, s + w))

    def lanes(vals):
        out = []
        for b, s in zip(bits, shifts):
            c = (np.array(vals, np.int64) >> s) & ((1 << b) - 1)
            out += [c >> 30, c & ((1 << 30) - 1)] if b > 30 else [c]
        return np.stack(out, axis=1)

    slab_lo = np.concatenate([lanes(lo_keys), np.zeros((1, keys.shape[0]), np.int64)])
    slab_hi = np.concatenate([lanes(hi_keys), np.full((1, keys.shape[0]), -1, np.int64)])
    limits.append((0, 0))
    t = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(cuda_device) for a in (slab_lo, slab_hi, np.array(limits))]
    launches = K.KERNELS["slab_locate"].launches
    got = slab_locate(keys, *t)
    assert K.KERNELS["slab_locate"].launches == launches + 1
    assert torch.equal(got, slab_locate_plain(keys, *t))
    assert torch.equal(got.cpu(), kary_ranks_emulated(keys, *t).cpu())
    packed_t = torch.from_numpy(packed).to(cuda_device)
    for i, (s, e) in enumerate(limits[:-1]):
        win = packed_t[s:e]
        want = (torch.searchsorted(win, torch.tensor(lo_keys[i], device=cuda_device), side="left"),
                torch.searchsorted(win, torch.tensor(hi_keys[i], device=cuda_device), side="right"))
        assert (int(got[i, 0]), int(got[i, 1])) == (int(want[0]), int(want[1])), (i, s, e)
    assert got[-1].tolist() == [0, 0]


# -- the availability layer on resident replicas ---------------------------------------


def _avail_engine(device, *, views, seed=40, n=40_000):
    """An engine on ``device`` with one resident column family "cf" of
    ``n`` TPC-H orders rows (RF 3, three layouts), and its rows."""
    kc, vc = generate_orders(n / 1.5e6, seed=seed)
    eng = T.HREngine(n_nodes=5, device=device, result_cache=False)
    eng.create_column_family(
        "cf", kc, vc, replication_factor=3, schema=orders_schema(), device_resident=True, views=views,
        layouts=[("custkey", "orderdate", "clerk"), ("clerk", "orderdate", "custkey"), ("orderdate", "custkey", "clerk")],
    )
    return eng, kc, vc


@pytest.mark.cuda
def test_read_repair_of_a_flipped_resident_value(cuda_device):
    """A flipped exponent bit in one replica's resident value tile: the
    checksum (host columns) does not see it, an ALL read of that row's
    key finds the digests disagree, repairs the replica from the log on
    the card and answers like a CPU twin."""
    eng, kc, vc = _avail_engine(cuda_device, views=False)
    twin, _, _ = _avail_engine("cpu", views=False)
    cf = eng.column_families["cf"]
    t = eng._table(cf, cf.replicas[1])
    for row in range(0, len(t), 997):
        filters = {c: T.Eq(int(t.key_cols[c][row])) for c in cf.key_names}
        if twin.read("cf", T.Query(filters, "count"))[0].rows_matched == 1:
            break
    bits = t._device["values_tile"][t._device["value_rows"]["totalprice"]].view(torch.int32)
    bits[row] ^= 1 << 30
    assert eng.scrub_column_family("cf", repair=False)["corrupt"] == []
    q = T.Query(filters, "sum", "totalprice")
    (got, _), = eng.read_many("cf", [q], consistency="ALL")
    (want, _), = twin.read_many("cf", [q])
    assert got.value == want.value and got.rows_matched == want.rows_matched == 1
    assert eng.stats["digest_mismatches"] == 1 and eng.stats["read_repairs"] == 1
    fresh = ops.build_device_state(eng._table(cf, cf.replicas[1]), device=cuda_device)
    assert torch.equal(eng._table(cf, cf.replicas[1])._device["values_tile"], fresh["values_tile"])


@pytest.mark.cuda
def test_scrub_heals_views_on_the_card(cuda_device):
    """A corrupted view partial and a deleted view, after writes left run
    stacks: scrub reports and rebuilds both on the card, and view-served
    sums then equal the fused scan on the same table bit for bit."""
    eng, _, _ = _avail_engine(cuda_device, views=True)
    wk, wv = generate_orders(2_000 / 1.5e6, seed=41)
    eng.write("cf", wk, wv)
    cf = eng.column_families["cf"]
    tables = [eng._table(cf, r) for r in cf.replicas]
    tables[0]._device["views"]["block_sums"][0, 1] = 2 * tables[0]._device["views"]["block_sums"][0, 1] + 1
    del tables[1]._device["views"]
    launches = K.KERNELS["block_sums"].launches
    report = eng.scrub_column_family("cf")
    assert report["corrupt"] == [0, 1] and report["repaired"] == 2
    assert K.KERNELS["block_sums"].launches > launches
    assert all(verify_views(t) for t in tables)
    qs = [T.Query({"custkey": T.Range(lo, lo + 5000)}, "sum", "totalprice") for lo in range(0, 60_000, 7000)]
    qs += [T.Query({"clerk": T.Range(lo, lo + 3)}, "count") for lo in range(0, 900, 90)]
    for t in tables:
        eligible = [q for q in qs if t._view_eligible(q)]
        for a, b in zip(t.execute_many(eligible), ops.table_execute_device_many(t, eligible)):
            assert (a.value, a.rows_matched, a.rows_scanned) == (b.value, b.rows_matched, b.rows_scanned)


@pytest.mark.cuda
def test_recovered_replica_equals_a_fresh_build(cuda_device):
    """A node loss, then recovery from the log and from a survivor: the
    rebuilt replica's key lanes and value tile on the card are array-equal
    to a fresh build of the same rows in its layout, its view is rebuilt,
    and a hinted outage heals by replaying exactly the missed rows."""
    eng, kc, vc = _avail_engine(cuda_device, views=True)
    cf = eng.column_families["cf"]
    r = cf.replicas[2]
    for source in ("log", "survivor"):
        peer = next(p for p in cf.replicas if p.node_id != r.node_id)
        rows = (kc, vc) if source == "log" else (eng._table(cf, peer).key_cols, eng._table(cf, peer).value_cols)
        eng.fail_node(r.node_id)
        eng.recover_node(r.node_id, source=source)
        t = eng._table(cf, r)
        fresh = ops.build_device_state(T.SortedTable.from_columns(*rows, r.layout, cf.schema), device=cuda_device)
        assert t._device["keys"].is_cuda
        assert torch.equal(t._device["keys"], fresh["keys"]) and torch.equal(t._device["values_tile"], fresh["values_tile"])
        assert verify_views(t)
    wk, wv = generate_orders(3_000 / 1.5e6, seed=42)
    eng.fail_node(r.node_id, transient=True)
    eng.write("cf", wk, wv)
    eng.node_up(r.node_id)
    assert eng.stats["hint_rows_replayed"] == len(wk["custkey"])
    assert len({eng._table(cf, p).dataset_fingerprint() for p in cf.replicas}) == 1


# -- ring migration, parallel flushes --------------------------------------------------


def _views_family(device, *, partitions=2, seed=50, n=40_000, **engine_kw):
    """A resident views column family "cf" of ``n`` TPC-H orders rows at
    ``partitions`` token-quantile partitions, RF 3, on ``device``."""
    kc, vc = generate_orders(n / 1.5e6, seed=seed)
    eng = T.HREngine(n_nodes=5, device=device, **engine_kw)
    eng.create_column_family(
        "cf", kc, vc, replication_factor=3, schema=orders_schema(), device_resident=True, views=True,
        layouts=[("custkey", "orderdate", "clerk"), ("clerk", "orderdate", "custkey"), ("orderdate", "custkey", "clerk")],
        partitions=partitions, partition_balance="tokens",
    )
    return eng, kc, vc


def _migration_queries():
    qs = [T.Query({"custkey": T.Range(lo, lo + 4000)}, "sum", "totalprice") for lo in range(0, 60_000, 6000)]
    qs += [T.Query({"clerk": T.Range(lo, lo + 3)}, "count") for lo in range(0, 900, 150)]
    qs += [T.Query({"orderdate": T.Eq(d)}, "select") for d in (5, 700, 2400)]
    return qs


@pytest.mark.cuda
def test_migration_of_a_views_family_on_the_card_matches_the_cpu(cuda_device):
    """A split and a rebalance of a resident views family on the card: the
    same ring, rows moved and answers as on the CPU (sums within rtol 1e-5
    / atol 1e-3), the rebuilt tables on the card with their views built by
    the ``block_sums`` kernel, and every replica's view-served answers
    equal to the fused kernel on that table bit for bit."""
    eng, _, _ = _views_family(cuda_device)
    twin, _, _ = _views_family("cpu")
    qs = _migration_queries()
    for step in ("split", "rebalance"):
        launches = K.KERNELS["block_sums"].launches
        if step == "split":
            assert eng.split_partition("cf", 0) == twin.split_partition("cf", 0)
        else:
            assert eng.rebalance("cf", partitions=3) == twin.rebalance("cf", partitions=3)
        cf, tcf = eng.column_families["cf"], twin.column_families["cf"]
        assert cf.ring.starts == tcf.ring.starts
        assert eng.stats["rebalance_rows_moved"] == twin.stats["rebalance_rows_moved"]
        assert K.KERNELS["block_sums"].launches > launches
        for a, b in zip(eng.read_many("cf", qs), twin.read_many("cf", qs)):
            assert a[1].replica_id == b[1].replica_id
            assert (a[0].rows_matched, a[0].rows_scanned) == (b[0].rows_matched, b[0].rows_scanned)
            np.testing.assert_allclose(a[0].value, b[0].value, rtol=1e-5, atol=1e-3)
            if a[0].selected is not None:
                np.testing.assert_array_equal(a[0].selected, b[0].selected)
        for r in cf.replicas:
            t = eng._table(cf, r)
            assert t._device["keys"].is_cuda and verify_views(t)
            eligible = [q for q in qs if t._view_eligible(q)]
            for a, b in zip(t.execute_many(eligible), ops.table_execute_device_many(t, eligible)):
                assert (a.value, a.rows_matched, a.rows_scanned) == (b.value, b.rows_matched, b.rows_scanned)


@pytest.mark.cuda
def test_parallel_flush_on_the_card_equals_a_serial_one(cuda_device):
    """Group-commit writes flushed on the pool leave every replica's key
    lanes, value tile, row map and view partials on the card array-equal
    to a serial flush of the same rows."""
    par, _, _ = _views_family(cuda_device, partitions=1, memtable_rows=3_000)
    ser, _, _ = _views_family(cuda_device, partitions=1, memtable_rows=3_000)
    wk, wv = generate_orders(10_000 / 1.5e6, seed=51)
    for i in range(5):
        part_k = {c: v[i * 2000:(i + 1) * 2000] for c, v in wk.items()}
        part_v = {c: v[i * 2000:(i + 1) * 2000] for c, v in wv.items()}
        par.write("cf", part_k, part_v, parallel=True)
        ser.write("cf", part_k, part_v, parallel=False)
    par.flush_memtables("cf", parallel=True)
    ser.flush_memtables("cf")
    assert par._pool is not None and par.stats["memtable_flushes"] == ser.stats["memtable_flushes"]
    pcf, scf = par.column_families["cf"], ser.column_families["cf"]
    for rp, rs in zip(pcf.replicas, scf.replicas):
        a, b = par._table(pcf, rp)._device, ser._table(scf, rs)._device
        n = a["n_rows"]
        assert n == b["n_rows"] and a["run_starts"] == b["run_starts"]
        assert torch.equal(a["keys"][:, :n], b["keys"][:, :n])
        assert torch.equal(a["values_tile"][:, :n], b["values_tile"][:, :n])
        assert (a["row_map"] is None) == (b["row_map"] is None)
        if a["row_map"] is not None:
            np.testing.assert_array_equal(a["row_map"], b["row_map"])
        np.testing.assert_array_equal(a["views"]["block_sums"], b["views"]["block_sums"])


@pytest.mark.cuda
def test_rebalance_releases_the_retired_tables(cuda_device):
    """A rebalance that moves every row (P = 2 to P = 3) frees the retired
    tables' tensors: the allocation ends within a few blocks of where it
    began, while its peak held old and new tables together."""
    eng, _, _ = _views_family(cuda_device, n=200_000, result_cache=False)
    eng.read_many("cf", _migration_queries())
    cf = eng.column_families["cf"]
    resident = sum(
        eng._table(cf, r)._device["keys"].nbytes + eng._table(cf, r)._device["values_tile"].nbytes
        for r in cf.replicas
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    info = eng.rebalance("cf", partitions=3)
    torch.cuda.synchronize()
    after, peak = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
    assert info["rows_moved"] == 200_000
    # each of the 9 new tables may round up to one more 8192-row block of
    # 8 key lanes and 8 value rows
    assert after - before <= 9 * 8192 * 64
    assert peak - before >= resident // 2


# -- the serving front door on the card ------------------------------------------------


@pytest.mark.cuda
def test_traced_frontdoor_on_the_card_answers_like_a_host_twin(cuda_device):
    """A traced ``FrontDoor`` over a resident family: every request answered,
    every launched group's tree reaching ``kernel.scan_launch``, each answer
    equal to a direct read of a host-table twin (counts exact, sums within
    rtol 1e-5 / atol 1e-3)."""
    from repro_torch.core.tpch import q1_q2_workload
    from repro_torch.obs import Tracer
    from repro_torch.serving import FrontDoor, Request

    eng, kc, vc = _avail_engine(cuda_device, views=False)
    twin = T.HREngine(n_nodes=5, device=cuda_device, result_cache=False)
    cf = eng.column_families["cf"]
    twin.create_column_family(
        "cf", kc, vc, replication_factor=3, schema=orders_schema(), layouts=[r.layout for r in cf.replicas],
    )
    qs = q1_q2_workload(n_instances=48, seed=3, n_rows=len(kc["custkey"])).queries
    qs = qs[:24] + [T.Query(q.filters, "count") for q in qs[24:36]] + [T.Query(q.filters, "select") for q in qs[36:]]
    reqs = [Request("cf", q, arrival_s=i * 1e-4, consistency="QUORUM" if i % 3 == 0 and q.agg != "sum" else "ONE")
            for i, q in enumerate(qs)]
    tracer = Tracer()
    fd = FrontDoor(eng, max_batch=8, max_wait=1e-3, tracer=tracer)
    before = K.scan_agg_locate.launches
    resps = fd.serve(reqs)
    assert all(r.ok for r in resps) and fd.stats["served_ok"] == len(reqs)
    assert K.scan_agg_locate.launches > before
    groups = [
        h for root in tracer.roots
        for h in ([root] if root.name == "frontdoor.batch" else root.find_all("frontdoor.service"))
        if h.find("engine.read_many") is not None
    ]
    assert groups and all(h.find("kernel.scan_launch") is not None for h in groups)
    for q, r in zip(qs, resps):
        want, _ = twin.read("cf", q)
        assert r.result.rows_matched == want.rows_matched
        if q.agg == "sum":
            assert r.result.value == pytest.approx(want.value, rel=1e-5, abs=1e-3)
        else:
            assert r.result.value == want.value


LM_ARCHS = ("starcoder2-3b", "yi-34b", "chatglm3-6b", "minitron-8b", "musicgen-medium", "paligemma-3b",
            "qwen2-moe-a2.7b", "deepseek-v3-671b", "mamba2-780m", "hymba-1.5b")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_serving_on_the_card_matches_the_cpu(cuda_device, arch):
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import decode_forward_error, device_agreement
    from repro_torch.models.lm import init_lm

    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    cpu_model = init_lm(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    card_model = copy.deepcopy(cpu_model).to(cuda_device)
    rng = np.random.default_rng(0)
    if cfg.input_mode == "tokens":
        batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 17)))}
    else:
        batch = {"embeds": torch.as_tensor(rng.normal(0, 1, (2, 17, cfg.d_model)).astype(np.float32))}
    diff = device_agreement(cpu_model, card_model, batch, q_chunk=4, kv_chunk=8)
    assert diff["prefill_logits"] <= 1e-4 and diff["decode_logits"] <= 1e-4 and diff["cache"] <= 1e-5, diff
    assert diff.get("state", 0.0) <= 1e-5, diff  # the SSD's float32 state, relative to its largest magnitude
    assert diff.get("expert_choices_differ", 0) == 0, diff
    if cfg.is_moe:  # decode's B tokens would overflow the experts at the config's capacity
        cfg = dataclasses.replace(cfg, capacity_factor=64.0)
        card_model = init_lm(cfg, generator=torch.Generator().manual_seed(3), device="cpu").to(cuda_device)
    on_card = {k: v.to(cuda_device) for k, v in batch.items()}
    assert decode_forward_error(card_model, on_card, device=cuda_device, q_chunk=4, kv_chunk=4) < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_step_on_the_card_matches_the_cpu(cuda_device, arch):
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import train_agreement
    from repro_torch.models.lm import init_lm
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.steps import TrainSettings

    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    cpu_model = init_lm(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(0)
    if cfg.input_mode == "tokens":
        batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)))}
    else:
        batch = {"embeds": torch.as_tensor(rng.normal(0, 1, (2, 16, cfg.d_model)).astype(np.float32))}
    shape = (2, 16, cfg.n_codebooks) if cfg.n_codebooks > 1 else (2, 16)
    batch["labels"] = torch.as_tensor(rng.integers(0, cfg.vocab_size, shape))
    settings = TrainSettings(remat="dots", q_chunk=8, kv_chunk=8, opt=OptConfig(lr=1e-2, warmup_steps=1))
    diff = train_agreement(cpu_model, copy.deepcopy(cpu_model).to(cuda_device), batch, settings)
    assert diff["loss"] <= 1e-5 and diff["grad_rel"] <= 1e-5 and diff["step_loss"] <= 1e-5, diff
    assert diff["step_grad_norm_rel"] <= 1e-5, diff
    assert diff.get("expert_choices_differ", 0) == 0, diff
    # the CPU step tests' rule: 1e-5 where both gradients exceed 1e-5 of the
    # largest; elsewhere Adam's first update, the rate times a sign, may flip
    assert diff["params"] <= 1e-5, diff
    assert diff["params_noise"] <= 2 * 1e-2 * (1 + 1e-6), diff


@pytest.mark.cuda
def test_expert_products_backward_on_the_card_matches_the_cpu(cuda_device):
    from repro_torch.models.moe import expert_matmul

    g = torch.Generator().manual_seed(0)
    x, w, r = (torch.randn(shape, generator=g) for shape in ((4, 24, 64), (4, 64, 96), (4, 24, 96)))
    outs = []
    for dev in (torch.device("cpu"), cuda_device):
        xd, wd = (t.to(dev, torch.bfloat16).requires_grad_() for t in (x, w))
        y = expert_matmul(xd, wd)
        assert y.dtype == torch.float32
        (y * r.to(dev)).sum().backward()
        outs.append([t.detach().float().cpu() for t in (y, xd.grad, wd.grad)])
    (y_cpu, gx_cpu, gw_cpu), (y_card, gx_card, gw_card) = outs
    assert torch.allclose(y_card, y_cpu, rtol=1e-5, atol=1e-5)
    for a, b in ((gx_card, gx_cpu), (gw_card, gw_cpu)):  # float32 products rounded once to bfloat16
        assert ((a - b).abs() <= 2.0**-7 * b.abs() + 1e-6).all()


@pytest.mark.cuda
def test_a_checkpoint_written_on_the_card_restores_on_the_cpu(cuda_device, tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager, flatten, restore_checkpoint, train_tree
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import TrainLoopConfig, run_training
    from repro_torch.models.convert import param_leaves
    from repro_torch.models.lm import init_lm
    from repro_torch.training.optimizer import init_opt

    cfg = dataclasses.replace(get_smoke("deepseek-v3-671b"), n_layers=2)
    loop = TrainLoopConfig(steps=4, batch_size=2, seq_len=16, ckpt_dir=str(tmp_path), ckpt_every=4, log_every=100)
    out = run_training(cfg, loop, device=cuda_device)
    assert out["steps_run"] == 4 and all(np.isfinite(out["losses"]))
    step, flat = restore_checkpoint(str(tmp_path))
    assert step == 4 and flat["params/embed"].dtype == np.uint16  # bfloat16, as its bits
    for dev in (torch.device("cpu"), cuda_device):
        model = init_lm(cfg, generator=torch.Generator(dev).manual_seed(9), device=dev)
        opt_state = init_opt(param_leaves(model), loop.opt)
        assert CheckpointManager(str(tmp_path)).restore_latest(model, opt_state) == 4
        got = flatten(train_tree(model, opt_state))
        assert sorted(got) == sorted(flat)
        for path, want in flat.items():
            assert got[path].dtype == want.dtype and np.array_equal(got[path], want), (dev, path)


@pytest.fixture
def nccl_ctx(cuda_device, tmp_path):
    """A one-rank ("data", "model") = (1, 1) mesh over NCCL, destroyed after."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import init_local_group
    from repro_torch.parallel.sharding import make_ctx

    init_local_group(0, 1, str(tmp_path / "store"), "nccl")
    try:
        yield make_ctx(init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model")))
    finally:
        dist.destroy_process_group()


MESH_ARCHS = ("starcoder2-3b", "qwen2-moe-a2.7b", "deepseek-v3-671b", "hymba-1.5b", "mamba2-780m")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_train_step_on_the_card_matches_one_device(nccl_ctx, arch):
    """A SMOKE train step on the (1, 1) NCCL mesh against the same step
    without a mesh, both on the card, at the CPU step tests' bounds."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import train_agreement
    from repro_torch.models.lm import init_lm
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.steps import TrainSettings

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32", capacity_factor=64.0)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 17)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    settings = TrainSettings(remat="dots", q_chunk=8, kv_chunk=8, opt=OptConfig(lr=1e-2, warmup_steps=1))
    model = init_lm(cfg, generator=torch.Generator(dev).manual_seed(3), device=dev)
    diff = train_agreement(model, copy.deepcopy(model), batch, settings, ctx=nccl_ctx)
    assert diff["loss"] <= 1e-5 and diff["grad_rel"] <= 1e-5 and diff["step_grad_norm_rel"] <= 1e-5, diff
    assert diff.get("expert_choices_differ", 0) == 0, diff
    assert diff["params"] <= 1e-5 and diff["params_noise"] <= 2 * 1e-2 * (1 + 1e-6), diff


@pytest.mark.cuda
@pytest.mark.parametrize("serve_sharding", ["fsdp", "tp"])
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_decode_on_the_card_matches_one_device(nccl_ctx, arch, serve_sharding):
    """A SMOKE ``serve_batch`` on the (1, 1) NCCL mesh against the same run
    without a mesh: equal tokens, final logits within 1e-4 (float32)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models.lm import init_lm

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32", capacity_factor=64.0)
    outs = []
    for ctx in (None, nccl_ctx):
        model = init_lm(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
        outs.append(serve_batch(cfg, batch_size=2, prompt_len=12, gen_tokens=4, device=dev, model=model, ctx=ctx,
                                serve_sharding=serve_sharding))
    assert np.array_equal(outs[0]["tokens"], outs[1]["tokens"])
    assert float((outs[0]["logits"] - outs[1]["logits"]).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_mesh_across_four_cards(tmp_path):
    """The multi-rank CPU cases of ``tests/test_torch_distributed.py`` and
    ``tests/test_torch_distributed_train.py`` on a (2, 2) ("data",
    "model") NCCL mesh of four cards, one rank a card, at their bounds:
    the sequence-sharded decode of starcoder2-3b, deepseek-v3 and hymba
    against one card, qwen2-moe's inference placement against its
    training placement, ``fsdp_all`` against ``fsdp``, the train step
    against one card (AdamW and Adafactor), and checkpoints restored
    across tensor-parallel degrees. Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    import test_torch_distributed as D
    import test_torch_distributed_train as DT

    cases = {"sharded_decode": D.SHARDED_DECODE, "serve_ep": D.SERVE_EP, "fsdp_all": DT.FSDP_ALL}
    cases.update({DT._agree(a[0], a[1]): DT.AGREE % (a[0], a[2], a[2], a[1], DT.LR) for a in DT.AGREEMENT})
    cases["restore"] = DT.RESTORE % (DT.LR, str(tmp_path), str(tmp_path))
    got = D.run_cases(cases, D.DECODE + DT.SETUP, shape=(2, 2), backend="nccl")
    print("four cards:", got)
    D.test_sharded_decode_matches_one_device(got)
    D.test_serve_ep_matches_fsdp_placement(got)
    DT.test_fsdp_all_train_step_matches_fsdp(got)
    for arch, opt, layers in DT.AGREEMENT:
        DT.test_mesh_train_step_matches_one_device(got, arch, opt, layers)
    DT.test_restore_to_different_tp(got)
