"""Hypothesis property tests for the core + kernels.

Collected into one module behind ``pytest.importorskip`` so the suite
collects (and the unit tests in the sibling modules run) even when
hypothesis is not installed — the seed image ships without it.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")

import jax.numpy as jnp
from hypothesis import example, given, settings, strategies as st

from repro.core import CostModel, Eq, KeySchema, Query, Range, SortedTable
from repro.core.ecdf import TableStats
from repro.core.tpch import generate_simulation
from repro.kernels import (
    scan_agg,
    scan_agg_batched,
    scan_agg_batched_ref,
    scan_agg_ref,
    table_execute_device_many,
    table_slab_locate_many,
)

from conftest import brute_force


@settings(max_examples=30, deadline=None)
@given(
    data=st.data(),
    n=st.integers(10, 300),
    dom=st.integers(2, 20),
)
def test_property_scan_count_matches_bruteforce(data, n, dom):
    """Property: for any dataset/layout/query, slab-scan == brute force."""
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
    cols = ("x", "y")
    kc = {c: rng.integers(0, dom, n).astype(np.int64) for c in cols}
    vc = {"m": rng.uniform(0, 1, n)}
    layout = data.draw(st.permutations(cols))
    t = SortedTable.from_columns(kc, vc, tuple(layout))
    f = {}
    for c in cols:
        kind = data.draw(st.sampled_from(["eq", "range", "none"]))
        if kind == "eq":
            f[c] = Eq(data.draw(st.integers(0, dom - 1)))
        elif kind == "range":
            lo = data.draw(st.integers(0, dom - 1))
            hi = data.draw(st.integers(lo + 1, dom))
            f[c] = Range(lo, hi)
    q = Query(filters=f, agg="count")
    res = t.execute(q)
    assert res.value == brute_force(t, q).sum()
    assert res.rows_scanned >= res.rows_matched


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_property_min_cost_leq_every_replica(seed):
    """Eq (3): Cost_min(q) ≤ Cost(r, q) for every replica r."""
    rng = np.random.default_rng(seed)
    kc, vc, schema = generate_simulation(3000, 3, seed=seed % 17)
    stats = TableStats.from_columns(kc, schema)
    model = CostModel(stats=stats)
    layouts = [("k0", "k1", "k2"), ("k2", "k1", "k0")]
    q = Query(filters={"k0": Eq(int(rng.integers(0, 8))), "k2": Range(0, 5)})
    mc, _ = model.min_cost(layouts, q)
    assert all(mc <= model.query_cost(a, q) + 1e-12 for a in layouts)


@settings(max_examples=20, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    k=st.integers(1, 6),
    n=st.integers(1, 700),
)
def test_property_scan_agg_matches_ref(seed, k, n):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 20, (k, n)).astype(np.int32)
    vals = rng.uniform(-1, 1, n).astype(np.float32)
    lo = rng.integers(0, 10, k).astype(np.int32)
    hi = (lo + rng.integers(0, 12, k)).astype(np.int32)
    slab = np.sort(rng.integers(0, n + 1, 2)).astype(np.int32)
    got = np.asarray(scan_agg(keys, vals, lo, hi, slab, block_n=128))
    want = np.asarray(
        scan_agg_ref(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(lo),
                     jnp.asarray(hi), jnp.asarray(slab))
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.kernel
@settings(max_examples=15, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    k=st.integers(1, 5),
    q=st.integers(1, 9),
    n=st.integers(1, 600),
)
def test_property_scan_agg_batched_matches_ref(seed, k, q, n):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 20, (k, n)).astype(np.int32)
    vals = rng.uniform(-1, 1, n).astype(np.float32)
    lo = rng.integers(0, 10, (q, k)).astype(np.int32)
    hi = (lo + rng.integers(0, 12, (q, k))).astype(np.int32)
    slabs = np.sort(rng.integers(0, n + 1, (q, 2)), axis=1).astype(np.int32)
    got = np.asarray(scan_agg_batched(keys, vals, lo, hi, slabs, block_n=128))
    want = np.asarray(
        scan_agg_batched_ref(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(lo),
                             jnp.asarray(hi), jnp.asarray(slabs))
    )
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.kernel
@settings(max_examples=15, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    q=st.integers(1, 24),
    n=st.integers(0, 500),
    n_vals=st.integers(1, 4),
    data=st.data(),
)
def test_property_rowstream_kernel_matches_ref(seed, q, n, n_vals, data):
    """Revisited-accumulator (row-streaming) kernel vs the jnp oracle:
    random schemas (narrow and two-lane wide columns), batch sizes,
    empty ranges/slabs, and mixed value-row selectors (mixed agg kinds),
    elementwise."""
    from repro.kernels.scan_agg import WIDE_LANE_BITS, scan_agg_batched_pallas

    rng = np.random.default_rng(seed)
    col_parts = tuple(data.draw(st.lists(st.sampled_from([1, 2]), min_size=1, max_size=4)))
    k_ex = sum(col_parts)
    keys_rows, lo_rows, hi_rows = [], [], []
    for parts in col_parts:
        bits = 8 if parts == 1 else WIDE_LANE_BITS + 8
        dom = 1 << bits
        col = rng.integers(0, dom, n).astype(np.int64)
        # bound draws include empty ranges (hi <= lo) and the full domain
        b_lo = rng.integers(0, dom, q)
        b_hi = np.where(rng.random(q) < 0.25, b_lo, rng.integers(0, dom + 1, q))
        if parts == 1:
            keys_rows.append(col.astype(np.int32))
            lo_rows.append(b_lo.astype(np.int32))
            hi_rows.append(b_hi.astype(np.int32))
        else:
            mask = (1 << WIDE_LANE_BITS) - 1
            keys_rows += [(col >> WIDE_LANE_BITS).astype(np.int32),
                          (col & mask).astype(np.int32)]
            lo_rows += [(b_lo >> WIDE_LANE_BITS).astype(np.int32),
                        (b_lo & mask).astype(np.int32)]
            hi_rows += [(b_hi >> WIDE_LANE_BITS).astype(np.int32),
                        (b_hi & mask).astype(np.int32)]
    keys = np.stack(keys_rows).reshape(k_ex, n)
    lo = np.stack(lo_rows, axis=1)
    hi = np.stack(hi_rows, axis=1)
    vals = rng.uniform(-1, 1, (n_vals, n)).astype(np.float32)
    sel = rng.integers(0, n_vals, q).astype(np.int32)
    slabs = np.sort(rng.integers(0, n + 1, (q, 2)), axis=1).astype(np.int32)
    slabs[rng.random(q) < 0.2, 1] = 0  # force some empty slabs

    got = np.asarray(
        scan_agg_batched_pallas(keys, vals, lo, hi, slabs, sel,
                                col_parts=col_parts, block_n=128)
    )
    want = np.asarray(
        scan_agg_batched_ref(jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(lo),
                             jnp.asarray(hi), jnp.asarray(slabs), jnp.asarray(sel),
                             col_parts=col_parts)
    )
    assert got.shape == (q, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.kernel
@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 400))
@example(seed=0, n=1)
@example(seed=0, n=2)
def test_property_device_table_matches_numpy_engine(seed, n):
    """End-to-end property: a device-resident table answers mixed
    sum/count batches (including empty ranges) identically to the numpy
    engine — counts exact, sums to float32 tolerance. The schema is
    pinned to cover every key and bound drawn (0..14), whatever n."""
    rng = np.random.default_rng(seed)
    kc = {"x": rng.integers(0, 12, n), "y": rng.integers(0, 12, n)}
    vc = {"m": rng.uniform(0, 1, n), "w": rng.uniform(-3, 3, n)}
    schema = KeySchema(bits={"x": 4, "y": 4})
    dev = SortedTable.from_columns(kc, vc, ("x", "y"), schema).place_on_device()
    host = SortedTable.from_columns(kc, vc, ("x", "y"), schema)
    qs = []
    for _ in range(8):
        f = {}
        if rng.random() < 0.8:
            f["x"] = Eq(int(rng.integers(0, 12)))
        if rng.random() < 0.8:
            lo = int(rng.integers(0, 12))
            f["y"] = Range(lo, lo + int(rng.integers(0, 4)))  # may be empty
        agg = "count" if rng.random() < 0.5 else "sum"
        qs.append(Query(filters=f, agg=agg,
                        value_col=("m" if rng.random() < 0.5 else "w") if agg == "sum" else None))
    for q, rd in zip(qs, dev.execute_many(qs)):
        rh = host.execute(q)
        assert rd.rows_scanned == rh.rows_scanned
        assert rd.rows_matched == rh.rows_matched
        np.testing.assert_allclose(rd.value, rh.value, rtol=1e-5, atol=1e-5)


@pytest.mark.kernel
def test_eq_outside_the_schema_raises_on_host_and_device():
    """A value outside the table's key schema is refused by design, by
    ``execute`` on a host table and by ``execute_many`` on a resident
    one (the draws the two properties above once made from tiny tables
    with inferred schemas)."""
    kc = {"x": np.array([1]), "y": np.array([2])}
    vc = {"m": np.array([0.5])}
    host = SortedTable.from_columns(kc, vc, ("x", "y"))
    assert host.schema.max_value("x") < 9
    q = Query(filters={"x": Eq(9)}, agg="count")
    with pytest.raises(ValueError, match="out of range"):
        host.execute(q)
    dev = SortedTable.from_columns(kc, vc, ("x", "y")).place_on_device()
    with pytest.raises(ValueError, match="out of range"):
        dev.execute_many([q])


def _random_queries(rng, schema, cols, k, *, aggs=("count",), value_col=None):
    qs = []
    for _ in range(k):
        f = {}
        for c in cols:
            u = rng.random()
            dom = schema.max_value(c) + 1
            if u < 0.3:
                continue
            if u < 0.6:
                f[c] = Eq(int(rng.integers(0, dom)))
            else:
                lo = int(rng.integers(0, dom))
                f[c] = Range(lo, min(dom, lo + int(rng.integers(0, dom // 2 + 2))))
        agg = aggs[int(rng.integers(0, len(aggs)))]
        qs.append(Query(filters=f, agg=agg,
                        value_col=value_col if agg == "sum" else None))
    return qs


@pytest.mark.kernel
@settings(max_examples=15, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    n=st.integers(1, 600),
    bits_a=st.sampled_from([3, 8, 31, 40, 60]),
    bits_b=st.integers(1, 3),
)
def test_property_slab_locate_matches_searchsorted(seed, n, bits_a, bits_b):
    """Property: the device binary-search kernel == the numpy
    searchsorted oracle, over random schemas (narrow and two-lane wide
    columns), empty ranges, and bounds at the table edges."""
    from repro.core import KeySchema
    from repro.core.table import slab_bounds_many

    rng = np.random.default_rng(seed)
    schema = KeySchema({"a": bits_a, "b": bits_b})
    kc = {
        c: rng.integers(0, schema.max_value(c) + 1, n).astype(np.int64)
        for c in ("a", "b")
    }
    vc = {"m": rng.uniform(0, 1, n)}
    t = SortedTable.from_columns(kc, vc, ("a", "b"), schema)
    qs = _random_queries(rng, schema, ("a", "b"), 10)
    # force edge-of-table and degenerate bounds into every run
    qs += [
        Query(filters={"a": Eq(0)}),
        Query(filters={"a": Eq(schema.max_value("a"))}),
        Query(filters={"b": Range(1, 1)}),
        Query(filters={}),
    ]
    bounds = slab_bounds_many(qs, t.layout, t.schema)
    lo = np.searchsorted(t.packed, bounds[:, 0], side="left")
    hi = np.searchsorted(t.packed, bounds[:, 1], side="right")
    want = np.stack([lo, hi], axis=1).astype(np.int64)
    got = table_slab_locate_many(t.place_on_device(), qs)
    np.testing.assert_array_equal(got, want)


@pytest.mark.kernel
@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 500))
def test_property_select_compaction_matches_numpy_indices(seed, n):
    """Property: device "select" emits exactly the numpy engine's row
    indices (same values, same ascending order), mixed into sum/count
    batches, including after incremental device appends."""
    from repro.core import KeySchema

    rng = np.random.default_rng(seed)
    # explicit schema: the appended run may exceed the seed data's max
    schema = KeySchema({"x": 4, "y": 4})
    kc = {"x": rng.integers(0, 10, n), "y": rng.integers(0, 10, n)}
    vc = {"m": rng.uniform(0, 1, n)}
    dev = SortedTable.from_columns(kc, vc, ("x", "y"), schema).place_on_device()
    host = SortedTable.from_columns(kc, vc, ("x", "y"), schema)
    if rng.random() < 0.5:  # half the runs read after an appended write
        m = int(rng.integers(1, 50))
        kc2 = {"x": rng.integers(0, 10, m), "y": rng.integers(0, 10, m)}
        vc2 = {"m": rng.uniform(0, 1, m)}
        dev = dev.merge_insert(kc2, vc2)
        host = host.merge_insert(kc2, vc2)
        assert dev._device["n_runs"] == 2
    qs = _random_queries(
        rng, dev.schema, ("x", "y"), 8, aggs=("select", "sum", "count"),
        value_col="m",
    )
    for q, rd in zip(qs, table_execute_device_many(dev, qs)):
        rh = host.execute(q)
        assert rd.rows_scanned == rh.rows_scanned
        assert rd.rows_matched == rh.rows_matched
        np.testing.assert_allclose(rd.value, rh.value, rtol=1e-5, atol=1e-5)
        if q.agg == "select":
            np.testing.assert_array_equal(rd.selected, rh.selected)


@settings(max_examples=25, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    n_writes=st.integers(0, 6),
    byte_level=st.booleans(),
    data=st.data(),
)
def test_property_truncated_commitlog_replays_consistent_prefix(
    seed, n_writes, byte_level, data
):
    """Crash-recovery property: truncating the commit log at an
    arbitrary record (or an arbitrary BYTE of its serialized form) and
    replaying yields a prefix-consistent table — exactly the table built
    from the surviving whole records, identical across all heterogeneous
    layouts of the column family."""
    from repro.core import CommitLog, KeySchema

    rng = np.random.default_rng(seed)
    schema = KeySchema({"x": 5, "y": 5})
    layouts = (("x", "y"), ("y", "x"))
    log = CommitLog(key_names=("x", "y"), value_names=("m",))
    batches = []
    for _ in range(1 + n_writes):  # record 0 plays the CREATE-time base
        m = int(rng.integers(1, 60))
        kc = {"x": rng.integers(0, 32, m), "y": rng.integers(0, 32, m)}
        vc = {"m": rng.uniform(0, 1, m)}
        log.append(kc, vc)
        batches.append((kc, vc))

    if byte_level:
        blob = log.to_bytes()
        cut = data.draw(st.integers(0, len(blob)))
        survived = CommitLog.from_bytes(blob[:cut])
        # torn-tail framing: what survives is some whole-record prefix
        assert 0 <= len(survived) <= len(log)
    else:
        keep = data.draw(st.integers(0, len(log)))
        survived = CommitLog.from_bytes(log.to_bytes())
        survived.truncate(keep)
        assert len(survived) == keep

    kcr, vcr = survived.replay_columns()
    k = len(survived)
    if k == 0:
        # a fully-torn log knows no columns; nothing to rebuild
        assert survived.n_rows == 0
        assert all(v.size == 0 for v in kcr.values())
        return
    prefix_k = {c: np.concatenate([b[0][c] for b in batches[:k]]) for c in ("x", "y")}
    prefix_v = {"m": np.concatenate([b[1]["m"] for b in batches[:k]])}
    fps = set()
    for layout in layouts:
        replayed = SortedTable.from_columns(kcr, vcr, layout, schema)
        expected = SortedTable.from_columns(prefix_k, prefix_v, layout, schema)
        np.testing.assert_array_equal(replayed.packed, expected.packed)
        for c in ("x", "y"):
            np.testing.assert_array_equal(replayed.key_cols[c], expected.key_cols[c])
        np.testing.assert_array_equal(
            np.asarray(replayed.value_cols["m"]), np.asarray(expected.value_cols["m"])
        )
        fps.add(replayed.dataset_fingerprint())
    assert len(fps) == 1  # every heterogeneous layout holds the same prefix


@pytest.mark.kernel
@settings(max_examples=12, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    n=st.integers(1, 400),
    n_runs=st.integers(1, 4),
)
@example(seed=0, n=1, n_runs=4)
def test_property_merge_kernel_matches_lexsort_oracle(seed, n, n_runs):
    """Property: the k-way merge-path kernel's permutation equals the
    lexsort oracle AND the incrementally maintained row_map for any run
    stack, and compaction preserves every query result."""
    from repro.kernels import merge_run_positions, merge_run_positions_ref

    rng = np.random.default_rng(seed)
    kc = {"x": rng.integers(0, 6, n), "y": rng.integers(0, 6, n)}
    vc = {"m": rng.uniform(0, 1, n)}
    schema = KeySchema(bits={"x": 3, "y": 3})  # covers every value drawn (0..5)
    t = SortedTable.from_columns(kc, vc, ("x", "y"), schema).place_on_device()
    for _ in range(n_runs - 1):
        m = int(rng.integers(1, 80))
        t = t.merge_insert(
            {"x": rng.integers(0, 6, m), "y": rng.integers(0, 6, m)},
            {"m": rng.uniform(0, 1, m)},
        )
    st_dev = t._device
    n_lanes = sum(st_dev["col_parts"])
    got = merge_run_positions(
        st_dev["keys"], st_dev["run_starts"], st_dev["n_rows"],
        n_lanes=n_lanes, block_n=256,
    )
    want = merge_run_positions_ref(
        st_dev["keys"], st_dev["run_starts"], st_dev["n_rows"], n_lanes=n_lanes
    )
    np.testing.assert_array_equal(got, want)
    if st_dev["row_map"] is not None:
        np.testing.assert_array_equal(got, st_dev["row_map"])
    q = Query(filters={"x": Eq(int(rng.integers(0, 6)))}, agg="select")
    before = t.execute(q)
    t.compact_runs()
    assert t._device["n_runs"] == 1
    after = t.execute(q)
    assert after.rows_matched == before.rows_matched
    np.testing.assert_array_equal(after.selected, before.selected)


@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_property_result_cache_byte_accounting(data):
    """Property (PR 5 satellite): over ANY sequence of cache stores —
    including overwrites of live keys and stores that trigger FIFO or
    byte-budget evictions — interleaved with invalidations, the
    per-replica ``_cache_sel_bytes`` counter equals the true sum of
    retained selected-array bytes: it never drifts negative and never
    leaks an entry once ``_invalidate_result_cache`` drops its map."""
    from repro.core import HREngine
    from repro.core.table import ScanResult

    rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
    kc, vc, schema = generate_simulation(300, 3, seed=1)
    eng = HREngine(n_nodes=2, result_cache_max_entries=data.draw(st.integers(1, 4)))
    eng.create_column_family(
        "cf", kc, vc, replication_factor=2,
        layouts=[("k0", "k1", "k2"), ("k1", "k2", "k0")], schema=schema,
    )
    # tiny instance-level budgets so every eviction path is reachable
    eng._CACHE_MAX_SELECT_BYTES = data.draw(st.sampled_from([64, 256]))
    eng._CACHE_MAX_MAP_BYTES = data.draw(st.sampled_from([128, 512]))
    map_keys = [("cf", 0), ("cf", 1)]
    for _ in range(data.draw(st.integers(10, 60))):
        mk = map_keys[int(rng.integers(0, 2))]
        if rng.random() < 0.85:
            key = ("select", None, (("k0", int(rng.integers(0, 4))),))
            n_sel = int(rng.integers(0, 48))
            sel = np.arange(n_sel, dtype=np.int64) if rng.random() < 0.8 else None
            eng._cache_store(
                mk,
                eng._result_cache.setdefault(mk, {}),
                key,
                ScanResult(float(n_sel), n_sel, n_sel, selected=sel),
            )
        else:
            eng._invalidate_result_cache("cf", replica_id=mk[1])
        for check_mk in map_keys:
            cache = eng._result_cache.get(check_mk, {})
            actual = sum(
                r.selected.nbytes for r in cache.values() if r.selected is not None
            )
            recorded = eng._cache_sel_bytes.get(check_mk, 0)
            assert recorded == actual
            assert recorded >= 0
            assert len(cache) <= eng._cache_max
            assert actual <= eng._CACHE_MAX_MAP_BYTES
        assert set(eng._cache_sel_bytes) <= set(eng._result_cache)
    eng._invalidate_result_cache("cf")
    assert eng._result_cache == {} and eng._cache_sel_bytes == {}


@settings(max_examples=15, deadline=None)
@given(
    data=st.data(),
    n=st.integers(50, 500),
    n_partitions=st.integers(2, 5),
)
def test_property_partitioned_read_matches_p1_oracle(data, n, n_partitions):
    """Property (PR 5 tentpole): for any dataset and query mix,
    ``read_many`` on a P-partition column family returns the same
    aggregates, matched counts and selected *rows* as the P = 1 oracle
    — queries spanning several partitions and queries pinned to one."""
    from repro.core import HREngine, KeySchema

    rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
    dom = data.draw(st.integers(4, 16))
    cols = ("x", "y")
    kc = {c: rng.integers(0, dom, n).astype(np.int64) for c in cols}
    vc = {"m": rng.uniform(0, 1, n)}
    schema = KeySchema({c: max(1, int(dom - 1).bit_length()) for c in cols})
    layouts = [("x", "y"), ("y", "x")]
    engines = []
    for partitions in (1, n_partitions):
        eng = HREngine(n_nodes=4)
        eng.create_column_family(
            "cf", kc, vc, replication_factor=1, layouts=layouts[:1], schema=schema,
            partitions=partitions,
        )
        engines.append(eng)
    e1, ep = engines
    qs = []
    for _ in range(8):
        f = {}
        for c in cols:
            kind = data.draw(st.sampled_from(["eq", "range", "none"]))
            if kind == "eq":
                f[c] = Eq(data.draw(st.integers(0, dom - 1)))
            elif kind == "range":
                lo = data.draw(st.integers(0, dom - 1))
                f[c] = Range(lo, data.draw(st.integers(lo, dom)))
        agg = data.draw(st.sampled_from(["count", "sum", "select"]))
        qs.append(Query(filters=f, agg=agg, value_col="m" if agg == "sum" else None))

    def rows_of(eng, selected):
        cf = eng.column_families["cf"]
        offsets = eng._partition_row_offsets(cf)
        pids = np.searchsorted(offsets, selected, side="right") - 1
        out = []
        for pid, g in zip(pids, selected):
            t = eng._table(cf, cf.partitions[int(pid)].replicas[0])
            li = int(g - offsets[int(pid)])
            out.append(
                tuple(int(t.key_cols[c][li]) for c in cols)
                + (float(np.asarray(t.value_cols["m"])[li]),)
            )
        return sorted(out)

    for q, (a, _), (b, _) in zip(qs, e1.read_many("cf", qs), ep.read_many("cf", qs)):
        assert b.rows_matched == a.rows_matched
        if q.agg == "sum":
            np.testing.assert_allclose(b.value, a.value, rtol=1e-9)
        else:
            assert b.value == a.value
        if q.agg == "select":
            assert rows_of(ep, b.selected) == rows_of(e1, a.selected)
