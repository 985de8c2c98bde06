"""Parity of the port's ``SortedTable`` (``repro_torch.core.table``) with
the reference's (``repro.core.table``), on host tables and on tables
resident on the CPU device (the kernels' plain versions).

Both tables are built from the same numpy columns with the same pinned
``KeySchema``: sorted columns, slabs, digests and every ``ScanResult``
field must be equal (sums within rtol 1e-5 / atol 1e-3), before and after
a write drip and an on-device compaction.
"""

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.storage.memtable import sort_run as r_sort_run
from repro_torch.core.storage.memtable import sort_run as t_sort_run

BITS = {"k0": 8, "k1": 10, "k2": 40}  # k2 is a 31-60-bit two-lane column
LAYOUTS = [("k0", "k1", "k2"), ("k2", "k0", "k1"), ("k1", "k2", "k0")]


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    kc = {
        "k0": rng.integers(0, 1 << 8, n, dtype=np.int64),
        "k1": rng.integers(0, 1 << 10, n, dtype=np.int64),
        "k2": rng.integers(0, 1 << 40, n, dtype=np.int64) >> rng.integers(0, 30, n),
    }
    return kc, {"m": rng.uniform(0.0, 1.0, n), "p": rng.uniform(-5.0, 5.0, n)}


def _specs(n_q, seed):
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(n_q):
        f = {}
        if rng.random() < 0.7:
            f["k0"] = ("eq", int(rng.integers(0, 256)))
        lo = int(rng.integers(0, 1024))
        f["k1"] = ("range", lo, lo if i % 9 == 4 else int(rng.integers(lo, 1025)))
        if rng.random() < 0.5:
            lo2 = int(rng.integers(0, 1 << 39))
            f["k2"] = ("range", lo2, lo2 + int(rng.integers(0, 1 << 39)))
        agg = ("sum", "count", "select")[i % 3]
        specs.append((f, agg, ("m", "p")[i % 2] if agg == "sum" else None))
    return specs


def _queries(pkg, specs):
    return [
        pkg.Query(
            filters={c: pkg.Eq(s[1]) if s[0] == "eq" else pkg.Range(s[1], s[2]) for c, s in f.items()},
            agg=agg,
            value_col=v,
        )
        for f, agg, v in specs
    ]


def _assert_results_equal(ref_results, port_results):
    assert len(ref_results) == len(port_results)
    for a, b in zip(ref_results, port_results):
        assert a.rows_scanned == b.rows_scanned
        assert a.rows_matched == b.rows_matched
        np.testing.assert_allclose(a.value, b.value, rtol=1e-5, atol=1e-3)
        if a.selected is None:
            assert b.selected is None
        else:
            np.testing.assert_array_equal(a.selected, b.selected)


def _pair(layout, n=12000, seed=0, resident=False):
    kc, vc = _columns(n, seed)
    ref = R.SortedTable.from_columns(kc, vc, layout, R.KeySchema(dict(BITS)))
    port = T.SortedTable.from_columns(kc, vc, layout, T.KeySchema(dict(BITS)))
    if resident:
        ref.place_on_device()
        port.place_on_device(torch.device("cpu"))
    return ref, port


@pytest.mark.parametrize("layout", LAYOUTS)
def test_from_columns_slabs_and_digest_match_reference(layout):
    ref, port = _pair(layout)
    np.testing.assert_array_equal(ref.packed, port.packed)
    for c in BITS:
        np.testing.assert_array_equal(ref.key_cols[c], port.key_cols[c])
    for c in ("m", "p"):
        np.testing.assert_array_equal(ref.value_cols[c], port.value_cols[c])
    assert ref.content_digest() == port.content_digest()
    assert port.seal_checksum().verify_checksum()
    rq, tq = _queries(R, _specs(40, 1)), _queries(T, _specs(40, 1))
    np.testing.assert_array_equal(ref.slab_many(rq), port.slab_many(tq))
    assert [ref.slab(q) for q in rq] == [port.slab(q) for q in tq]


@pytest.mark.parametrize("resident", [False, True], ids=["host", "device"])
def test_execute_many_matches_reference(resident):
    ref, port = _pair(LAYOUTS[1], seed=2, resident=resident)
    specs = _specs(30, 3)
    _assert_results_equal(ref.execute_many(_queries(R, specs)), port.execute_many(_queries(T, specs)))


def test_device_execute_equals_execute_many_and_numpy():
    """A resident table's scalar ``execute`` is the Q = 1 launch: equal to
    the batch, and to the numpy engine of a host twin."""
    _, port = _pair(LAYOUTS[0], seed=4, resident=True)
    _, host = _pair(LAYOUTS[0], seed=4)
    tq = _queries(T, _specs(21, 5))
    batch = port.execute_many(tq)
    scalar = [port.execute(q) for q in tq]
    for a, b in zip(batch, scalar):
        assert (a.value, a.rows_scanned, a.rows_matched) == (b.value, b.rows_scanned, b.rows_matched)
        assert (a.selected is None) == (b.selected is None)
        if a.selected is not None:
            np.testing.assert_array_equal(a.selected, b.selected)
    _assert_results_equal(host.execute_many(tq), batch)


def test_write_drip_and_compaction_match_reference():
    """Runs appended to resident tables (selects then go through
    ``row_map``), then one on-device compaction: results and resident
    states equal the reference's at every step."""
    ref, port = _pair(LAYOUTS[2], seed=6, resident=True)
    specs = _specs(24, 7)
    for step in range(3):
        wk, wv = _columns(700 + 300 * step, 40 + step)
        ref = ref.merge_run(r_sort_run(wk, wv, ref.layout, ref.schema))
        port = port.merge_run(t_sort_run(wk, wv, port.layout, port.schema))
        _assert_results_equal(ref.execute_many(_queries(R, specs)), port.execute_many(_queries(T, specs)))
    assert port._device["n_runs"] == 4
    ref.compact_runs()
    port.compact_runs()
    assert port._device["n_runs"] == 1 and port._device["row_map"] is None
    np.testing.assert_array_equal(np.asarray(ref._device["keys"]), port._device["keys"].numpy())
    np.testing.assert_array_equal(
        np.asarray(ref._device["values_tile"]), port._device["values_tile"].numpy()
    )
    _assert_results_equal(ref.execute_many(_queries(R, specs)), port.execute_many(_queries(T, specs)))


def test_merge_insert_matches_reference_host_merge():
    ref, port = _pair(LAYOUTS[0], n=3000, seed=8)
    wk, wv = _columns(500, 9)
    wk["k0"][:100] = ref.key_cols["k0"][:100]
    r2, t2 = ref.merge_insert(wk, wv), port.merge_insert(wk, wv)
    np.testing.assert_array_equal(r2.packed, t2.packed)
    for c in BITS:
        np.testing.assert_array_equal(r2.key_cols[c], t2.key_cols[c])
    np.testing.assert_array_equal(r2.value_cols["m"], t2.value_cols["m"])


def test_place_on_device_rejects_keys_over_two_lanes():
    kc = {"a": np.arange(10, dtype=np.int64), "b": np.arange(10, dtype=np.int64) % 4}
    t = T.SortedTable.from_columns(kc, {"v": np.ones(10)}, ("a", "b"), T.KeySchema({"a": 61, "b": 2}))
    with pytest.raises(ValueError, match="'a' needs 61 bits"):
        t.place_on_device(torch.device("cpu"))
