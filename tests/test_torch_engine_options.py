"""The rest of the port's engine options against the reference's, on the
CPU: parallel flushes (``write(parallel=, flush=)``,
``flush_memtables(parallel=)``, with and without flush faults), the
result cache's entry bound (``_CACHE_MAX_ENTRIES``, the reference's
``result_cache_max_entries``), read deadlines (``deadline_s``,
``DeadlineExceeded``); and the check that keeps the port's engine
complete: every parameter of the reference's constructor and public
methods exists on the port's with the same default, apart from the few
the port fixes on purpose (``NOT_PORTED``).

Mirrors ``tests/test_storage.py::test_parallel_flush_shares_executor_and_survives_deepcopy``,
``tests/test_device_path.py``'s ``result_cache_max_entries`` tests and
``tests/test_availability.py::TestDeadlineBudgets``. Both engines get the
same numpy inputs and an explicit ``KeySchema``; counts, selects and
cache counters must be equal, sums within rtol 1e-5 / atol 1e-3.
"""

import copy
import inspect
import threading

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.table import ScanResult as RScanResult
from repro.core.tpch import generate_simulation
from repro_torch.core.table import ScanResult as TScanResult

LAYOUTS = [("k0", "k1", "k2"), ("k1", "k2", "k0"), ("k2", "k0", "k1")]
RTOL, ATOL = 1e-5, 1e-3
CACHE_KEYS = ("result_cache_hits", "result_cache_misses", "result_cache_entries", "result_cache_select_bytes")


def _engines(kc, vc, schema, *, rf=3, n_nodes=4, partitions=1, cf_kw=None, ref_kw=None, **engine_kw):
    """The reference's engine and the port's, each with one column family
    "cf" over the same rows; ``ref_kw`` goes to the reference's
    constructor only."""
    out = []
    for pkg in (R, T):
        own = {"device": "cpu"} if pkg is T else dict(ref_kw or {})
        eng = pkg.HREngine(n_nodes=n_nodes, **own, **engine_kw)
        eng.create_column_family(
            "cf", kc, vc, replication_factor=rf, layouts=LAYOUTS[:rf],
            schema=pkg.KeySchema(dict(schema.bits)), partitions=partitions, **(cf_kw or {}),
        )
        out.append(eng)
    return out


def _batch(rng, schema, n):
    kc = {c: rng.integers(0, schema.max_value(c) + 1, n).astype(np.int64) for c in ("k0", "k1", "k2")}
    return kc, {"metric": rng.uniform(0, 1, n)}


def _assert_reads_equal(ref_out, port_out):
    for (ra, pa), (rb, pb) in zip(ref_out, port_out):
        assert (pa.replica_id, pa.node_id) == (pb.replica_id, pb.node_id)
        assert (ra.rows_scanned, ra.rows_matched) == (rb.rows_scanned, rb.rows_matched)
        np.testing.assert_allclose(ra.value, rb.value, rtol=RTOL, atol=ATOL)
        if ra.selected is None:
            assert rb.selected is None
        else:
            np.testing.assert_array_equal(ra.selected, rb.selected)


def _queries(pkg, seed, domain, n=24):
    rng = np.random.default_rng(seed)
    qs = []
    for i in range(n):
        agg = ("count", "sum", "select")[i % 3]
        lo = int(rng.integers(0, domain - 1))
        f = {"k0": pkg.Range(lo, min(domain, lo + int(rng.integers(1, 8))))}
        if rng.random() < 0.5:
            f["k1"] = pkg.Eq(int(rng.integers(0, domain)))
        qs.append(pkg.Query(filters=f, agg=agg, value_col="metric" if agg == "sum" else None))
    return qs


# -- parallel flushes --------------------------------------------------------------------


def test_parallel_flush_shares_executor_and_survives_deepcopy():
    """The pool is created on the first parallel flush, reused by the next,
    dropped (not copied) by a deepcopy and recreated by the copy; every
    replica ends with the same rows, equal to the reference's tables."""
    rng = np.random.default_rng(13)
    kc, vc, schema = generate_simulation(2_000, 3, seed=13)
    ref, eng = _engines(kc, vc, schema, memtable_rows=1 << 30)
    batches = [_batch(rng, schema, 50) for _ in range(3)]
    for e in (ref, eng):
        e.write("cf", *batches[0])
        e.flush_memtables("cf")
    assert eng._pool is None  # serial by default
    for e in (ref, eng):
        e.write("cf", *batches[1])
        e.flush_memtables("cf", parallel=True)
    assert eng._pool is not None
    pool = eng._pool
    for e in (ref, eng):
        e.write("cf", *batches[2])
        e.flush_memtables("cf", parallel=True)
    assert eng._pool is pool
    twin, rtwin = copy.deepcopy(eng), copy.deepcopy(ref)
    assert twin._pool is None
    for e in (rtwin, twin):
        e.write("cf", *batches[0], parallel=True, flush=True)
    assert twin._pool is not None and twin._pool is not pool
    cf, rcf = twin.column_families["cf"], rtwin.column_families["cf"]
    assert len({twin._table(cf, r).dataset_fingerprint() for r in cf.replicas}) == 1
    for ra, rb in zip(rcf.replicas, cf.replicas):
        np.testing.assert_array_equal(rtwin._table(rcf, ra).packed, twin._table(cf, rb).packed)
    assert twin.stats["memtable_flushes"] == rtwin.stats["memtable_flushes"] == 12


class _CountingDetector:
    """A failure detector that only counts what it is told."""

    def __init__(self):
        self.failures: dict[int, int] = {}

    def record(self, node_id, wall_s):
        pass

    def record_failure(self, node_id):
        self.failures[node_id] = self.failures.get(node_id, 0) + 1

    def cost_factor(self, node_id):
        return 1.0


@pytest.mark.parametrize("parallel", [False, True])
def test_flush_faults_on_two_nodes_count_exactly(parallel):
    """P = 4, RF 3 on three nodes: each node holds several of the twelve
    replicas, which a parallel flush merges on pool threads at once. Fault
    budgets of 2 and 3 on the two fullest nodes are each spent exactly
    (one fault a replica that tried), the counter and the detector see
    every fault, nothing installs while a flush raises, and once the
    budgets are spent the flush lands every staged row in every replica."""
    rng = np.random.default_rng(21)
    kc, vc, schema = generate_simulation(2_000, 3, seed=21)
    det = _CountingDetector()
    eng = T.HREngine(n_nodes=3, device="cpu", memtable_rows=1 << 30, failure_detector=det)
    cf = eng.create_column_family(
        "cf", kc, vc, replication_factor=3, layouts=LAYOUTS, schema=T.KeySchema(dict(schema.bits)), partitions=4,
    )
    held = {n: sum(r.node_id == n for r in cf.replicas) for n in range(3)}
    a, b = sorted(held, key=lambda n: -held[n])[:2]
    assert held[a] >= 2 and held[b] >= 2
    eng.write("cf", *_batch(rng, schema, 400))
    staged = eng.stats["staged_rows"]
    before = {r.replica_id: eng._table(cf, r) for r in cf.replicas}
    eng.nodes[a].flush_fault_budget = 2
    eng.nodes[b].flush_fault_budget = 3
    raised = 0
    while True:
        try:
            eng.flush_memtables("cf", parallel=parallel)
        except T.TransientFlushError:
            raised += 1
            assert eng.stats["staged_rows"] == staged
            assert all(eng._table(cf, r) is before[r.replica_id] for r in cf.replicas)
            continue
        break
    assert eng.nodes[a].flush_fault_budget == eng.nodes[b].flush_fault_budget == 0
    assert eng.stats["flush_faults"] == 5 and det.failures == {a: 2, b: 3}
    # serially the first fault ends an attempt; in parallel every replica
    # tries, so one attempt spends up to a node's replica count of faults
    assert raised == (5 if not parallel else max(-(-2 // held[a]), -(-3 // held[b])))
    assert eng.stats["staged_rows"] == 0 and eng.stats["memtable_flushes"] == 12
    total = sum(eng._table(cf, r).n_rows for r in cf.replicas)
    assert total == 3 * (2_000 + 400)


def _device_state(table) -> dict:
    st = table._device
    return {
        "keys": st["keys"][:, : st["n_rows"]].numpy(),
        "values_tile": st["values_tile"][:, : st["n_rows"]].numpy(),
        "row_map": None if st["row_map"] is None else np.asarray(st["row_map"]),
        "run_starts": list(st["run_starts"]),
        "views": None if "views" not in st else np.asarray(st["views"]["block_sums"]),
    }


@pytest.mark.parametrize("views", [False, True])
def test_parallel_flush_equals_serial_on_a_resident_family(views, monkeypatch):
    """Group-commit writes flushed on the pool (``write(parallel=True)``,
    ``flush_memtables(parallel=True)``) leave every replica's device key
    lanes, value tile, ``row_map``, run starts and view partials
    array-equal to a serial flush of the same rows and to the reference's
    resident state; the merges ran on more than one thread."""
    rng = np.random.default_rng(14)
    kc, vc, schema = generate_simulation(3_000, 3, seed=14)
    cf_kw = {"device_resident": True, "views": views}
    ref, par = _engines(kc, vc, schema, memtable_rows=500, cf_kw=cf_kw)
    _, ser = _engines(kc, vc, schema, memtable_rows=500, cf_kw=cf_kw)
    threads = set()
    real = T.SortedTable.merge_run

    def spy(self, run, **kw):
        threads.add(threading.get_ident())
        return real(self, run, **kw)

    monkeypatch.setattr(T.SortedTable, "merge_run", spy)
    for step in range(5):
        b = _batch(rng, schema, 300)
        ref.write("cf", *b)
        par.write("cf", *b, parallel=True)
        ser.write("cf", *b, parallel=False)
    for e in (ref, ser):
        e.flush_memtables("cf")
    par.flush_memtables("cf", parallel=True)
    assert len(threads) > 1
    assert par.stats["memtable_flushes"] == ser.stats["memtable_flushes"] == ref.stats["memtable_flushes"]
    assert par.stats["compactions"] == ser.stats["compactions"] == ref.stats["compactions"]
    rcf, pcf, scf = (e.column_families["cf"] for e in (ref, par, ser))
    for ra, rp, rs in zip(rcf.replicas, pcf.replicas, scf.replicas):
        a, b = _device_state(par._table(pcf, rp)), _device_state(ser._table(scf, rs))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        rt = ref._table(rcf, ra)._device
        np.testing.assert_array_equal(np.asarray(rt["keys"])[:, : rt["n_rows"]], a["keys"])
        np.testing.assert_array_equal(np.asarray(rt["values_tile"])[:, : rt["n_rows"]], a["values_tile"])
        assert list(rt["run_starts"]) == a["run_starts"]
        if a["row_map"] is not None:
            np.testing.assert_array_equal(rt["row_map"], a["row_map"])
        assert par._table(pcf, rp).stored_digest == ref._table(rcf, ra).stored_digest
    domain = schema.max_value("k0") + 1
    _assert_reads_equal(ref.read_many("cf", _queries(R, 3, domain)), par.read_many("cf", _queries(T, 3, domain)))


def test_write_flush_option_forces_and_defers():
    rng = np.random.default_rng(15)
    kc, vc, schema = generate_simulation(1_500, 3, seed=15)
    ref, eng = _engines(kc, vc, schema, rf=2)
    b = _batch(rng, schema, 120)
    for e in (ref, eng):
        e.write("cf", *b, flush=False)
    assert eng.stats["staged_rows"] == ref.stats["staged_rows"] == 240
    for e in (ref, eng):
        e.write("cf", *b, flush=True)
    assert eng.stats["staged_rows"] == ref.stats["staged_rows"] == 0
    assert eng.stats["memtable_flushes"] == ref.stats["memtable_flushes"] == 2


# -- the result cache's entry bound ----------------------------------------------------


class TestResultCacheMaxEntries:
    """The reference's ``result_cache_max_entries`` tests; the port's bound
    is the class constant ``_CACHE_MAX_ENTRIES``, set to the same value."""

    def _pair(self, monkeypatch=None, n=8_000, rf=1, max_entries=None):
        kc, vc, schema = generate_simulation(n, 3, seed=3)
        if max_entries is None:
            return _engines(kc, vc, schema, rf=rf)
        monkeypatch.setattr(T.HREngine, "_CACHE_MAX_ENTRIES", max_entries)
        return _engines(kc, vc, schema, rf=rf, ref_kw={"result_cache_max_entries": max_entries})

    def _stats(self, eng):
        return {k: eng.stats[k] for k in CACHE_KEYS}

    def test_cache_bounded_fifo(self, monkeypatch):
        engines = self._pair(monkeypatch, max_entries=8)
        for eng, pkg in zip(engines, (R, T)):
            for v in range(12):
                eng.read("cf", pkg.Query(filters={"k0": pkg.Eq(v)}, agg="count"))
            assert eng.stats["result_cache_entries"] <= 8
            eng.read("cf", pkg.Query(filters={"k0": pkg.Eq(11)}, agg="count"))  # resident
            assert eng.stats["result_cache_hits"] == 1
            eng.read("cf", pkg.Query(filters={"k0": pkg.Eq(0)}, agg="count"))  # evicted
            assert eng.stats["result_cache_misses"] == 13
        assert self._stats(engines[0]) == self._stats(engines[1])

    def test_read_many_hit_survives_eviction_by_miss_store(self, monkeypatch):
        engines = self._pair(monkeypatch, max_entries=1)
        for eng, pkg in zip(engines, (R, T)):
            qa = pkg.Query(filters={"k0": pkg.Eq(1)}, agg="count")
            qb = pkg.Query(filters={"k0": pkg.Eq(2)}, agg="count")
            ra, _ = eng.read("cf", qa)
            res = eng.read_many("cf", [qa, qb])  # qa hits, qb's store evicts it
            assert res[0][0].value == ra.value
            assert eng.stats["result_cache_hits"] == 1
        assert self._stats(engines[0]) == self._stats(engines[1])

    def test_bound_is_the_references_default(self):
        default = inspect.signature(R.HREngine).parameters["result_cache_max_entries"].default
        assert T.HREngine._CACHE_MAX_ENTRIES == default == R.HREngine(n_nodes=2)._cache_max

    def test_cache_select_byte_budget(self, monkeypatch):
        engines = self._pair()
        for eng, pkg in zip(engines, (R, T)):
            monkeypatch.setattr(type(eng), "_CACHE_MAX_SELECT_BYTES", 1 << 30)
            monkeypatch.setattr(type(eng), "_CACHE_MAX_MAP_BYTES", 1 << 14)
            for v in range(6):
                eng.read("cf", pkg.Query(filters={"k0": pkg.Eq(v)}, agg="select"))
            assert 0 < eng.stats["result_cache_select_bytes"] <= (1 << 14)
            monkeypatch.setattr(type(eng), "_CACHE_MAX_SELECT_BYTES", 8)
            entries = eng.stats["result_cache_entries"]
            r, _ = eng.read("cf", pkg.Query(filters={}, agg="select"))
            assert r.rows_matched == 8_000
            assert eng.stats["result_cache_entries"] == entries
        assert self._stats(engines[0]) == self._stats(engines[1])

    def test_select_byte_accounting_never_drifts(self, monkeypatch):
        """Any sequence of store, overwrite, evict and invalidate keeps
        each map's recorded select bytes equal to the true retained sum,
        within the entry bound, identically in both engines."""
        engines = self._pair(monkeypatch, n=2_000, rf=2, max_entries=3)
        for eng in engines:
            monkeypatch.setattr(type(eng), "_CACHE_MAX_SELECT_BYTES", 256)
            monkeypatch.setattr(type(eng), "_CACHE_MAX_MAP_BYTES", 512)
        map_keys = [("cf", 0), ("cf", 1)]
        r = np.random.default_rng(7)
        stored = 0
        for _ in range(400):
            mk = map_keys[int(r.integers(0, 2))]
            if r.random() < 0.85:
                key = ("select", None, (("k0", int(r.integers(0, 5))),))
                n_sel = int(r.integers(0, 40))
                sel = np.arange(n_sel, dtype=np.int64) if r.random() < 0.8 else None
                for eng, cls in zip(engines, (RScanResult, TScanResult)):
                    res = cls(float(n_sel), n_sel, n_sel, selected=None if sel is None else sel.copy())
                    eng._cache_store(mk, eng._result_cache.setdefault(mk, {}), key, res)
                stored += 1
            else:
                for eng in engines:
                    eng._invalidate_result_cache("cf", replica_id=mk[1])
            for eng in engines:
                for k in map_keys:
                    cache = eng._result_cache.get(k, {})
                    actual = sum(x.selected.nbytes for x in cache.values() if x.selected is not None)
                    assert eng._cache_sel_bytes.get(k, 0) == actual <= 512
                    assert len(cache) <= 3
                assert set(eng._cache_sel_bytes) <= set(eng._result_cache)
            assert {k: list(v) for k, v in engines[0]._result_cache.items()} == {
                k: list(v) for k, v in engines[1]._result_cache.items()
            }
        assert stored > 300
        for eng in engines:
            eng._invalidate_result_cache("cf")
            assert eng._result_cache == {} and eng._cache_sel_bytes == {}


# -- read deadlines --------------------------------------------------------------------


class TestDeadlineBudgets:
    def test_spent_budget_raises_typed_error(self):
        kc, vc, schema = generate_simulation(1_000, 3, seed=7)
        for eng, pkg in zip(_engines(kc, vc, schema, n_nodes=6), (R, T)):
            q = pkg.Query({"k0": pkg.Eq(int(kc["k0"][0]))})
            for call in (
                lambda: eng.read("cf", q, deadline_s=0.0),
                lambda: eng.read_many("cf", [q], deadline_s=0.0),
                lambda: eng.read("cf", q, consistency="QUORUM", deadline_s=0.0),
                lambda: eng.read_many("cf", [q], consistency="ALL", deadline_s=-1.0),
            ):
                with pytest.raises(pkg.DeadlineExceeded if pkg is T else R.DeadlineExceeded):
                    call()
            assert eng.stats["deadline_exceeded"] == 4
            assert eng.stats["result_cache_misses"] == 0  # shed before any scan

    def test_deadline_is_not_a_transient_fault(self):
        assert not issubclass(T.DeadlineExceeded, T.TransientFault)
        assert issubclass(T.DeadlineExceeded, RuntimeError)
        assert T.DeadlineExceeded(0.002).budget_s == 0.002

    def test_generous_budget_answers_normally(self):
        kc, vc, schema = generate_simulation(1_000, 3, seed=7)
        ref, eng = _engines(kc, vc, schema, n_nodes=6, partitions=2)
        for e, pkg in ((ref, R), (eng, T)):
            q = pkg.Query({"k0": pkg.Eq(int(kc["k0"][0]))})
            plain, _ = e.read("cf", q)
            res, _ = e.read("cf", q, deadline_s=60.0)
            assert res.value == plain.value
            many = e.read_many("cf", [q] * 3, consistency="QUORUM", deadline_s=60.0)
            assert [r.value for r, _ in many] == [plain.value] * 3
        assert eng.stats["deadline_exceeded"] == ref.stats["deadline_exceeded"] == 0

    @pytest.mark.parametrize("partitions", [1, 2])
    def test_budget_spent_mid_batch_sheds_and_skips_hedges(self, partitions, monkeypatch):
        """A budget that runs out after the first replica group: the next
        group's check raises (no failover swallows it), and a hedge never
        runs once the budget is gone. The clock is a counter, so the test
        does not depend on the host's speed."""
        import repro_torch.core.engine as engine_mod

        kc, vc, schema = generate_simulation(2_000, 3, seed=8)
        _, eng = _engines(kc, vc, schema, n_nodes=6, partitions=partitions)
        qs = _queries(T, 9, schema.max_value("k0") + 1, n=12)
        ticks = iter(range(10**6))
        monkeypatch.setattr(engine_mod.time, "perf_counter", lambda: float(next(ticks)))
        groups = []
        real = eng._execute_group
        monkeypatch.setattr(eng, "_execute_group", lambda *a, **k: groups.append(a[1]) or real(*a, **k))
        # clock reads before the first group: the cutoff, the call's own
        # check, (the first partition's,) the first group's
        with pytest.raises(T.DeadlineExceeded):
            eng.read_many("cf", qs, deadline_s=3.0 + (partitions > 1))
        assert eng.stats["deadline_exceeded"] == 1 and eng.stats["read_retries"] == 0
        assert len(groups) == 1
        slow = eng.column_families["cf"].replicas[0].node_id
        eng.nodes[slow].slowdown = 1e4
        groups.clear()
        out = eng.read_many("cf", qs, hedge=True, deadline_s=1e9)
        assert any(rep.hedged for _, rep in out)
        eng._invalidate_result_cache("cf")
        monkeypatch.setattr(engine_mod, "_deadline_spent", lambda deadline_at: deadline_at is not None)
        out = eng.read_many("cf", qs, hedge=True, deadline_s=1e9)
        assert not any(rep.hedged for _, rep in out)


# -- completeness ----------------------------------------------------------------------


def _public_methods(cls):
    return {
        name: fn for name, fn in inspect.getmembers(cls, inspect.isfunction)
        if not name.startswith("_") or name == "__init__"
    }


#: Parameters of the reference's engine that the port fixes on purpose,
#: each to the reference's default, until a caller of the port needs a
#: second value: ``parallel`` is per call only, and so defaults to False.
NOT_PORTED = {
    "__init__": {
        "result_cache_max_entries": "HREngine._CACHE_MAX_ENTRIES = 4096",
        "parallel_writes": "write(parallel=) and flush_memtables(parallel=) per call",
        "compaction": "CompactionPolicy()",
        "checksums": "always on",
        "metrics": "a registry of the engine's own",
    },
    "create_column_family": {
        "cost_fns": "the cost model's default cost functions",
        "compaction": "the engine's CompactionPolicy()",
    },
}
PARALLEL_PER_CALL = {"write", "flush_memtables"}


def test_engine_signatures_match_the_reference():
    """For the constructor and every public method of
    ``repro.core.HREngine``, every parameter exists on
    ``repro_torch.HREngine`` with the same kind and default, apart from
    the ones ``NOT_PORTED`` names (which must be absent, not half there)
    and ``parallel``, which defaults to False; the port's only extra
    parameter is ``device=``. Every public property of the reference's
    exists on the port's."""
    ref_methods, port_methods = _public_methods(R.HREngine), _public_methods(T.HREngine)
    missing = sorted(set(ref_methods) - set(port_methods))
    assert not missing, f"methods missing from the port: {missing}"
    for name, fn in ref_methods.items():
        want = inspect.signature(fn).parameters
        got = inspect.signature(port_methods[name]).parameters
        fixed = NOT_PORTED.get(name, {})
        assert set(fixed) <= set(want), f"{name}: NOT_PORTED names {sorted(set(fixed) - set(want))}"
        for p in want.values():
            if p.name in fixed:
                assert p.name not in got, f"{name}: {p.name} is both ported and listed as fixed"
                continue
            assert p.name in got, f"{name}: parameter {p.name} missing"
            q = got[p.name]
            assert q.kind == p.kind, f"{name}({p.name}): {q.kind} != {p.kind}"
            default = False if (name, p.name) in {(m, "parallel") for m in PARALLEL_PER_CALL} else p.default
            assert q.default == default, f"{name}({p.name}): default {q.default!r} != {default!r}"
        extra = set(got) - set(want)
        assert extra <= ({"device"} if name == "__init__" else set()), f"{name}: extra {sorted(extra)}"
    props = {n for n, v in inspect.getmembers(R.HREngine) if isinstance(v, property) and not n.startswith("_")}
    assert props <= {n for n, v in inspect.getmembers(T.HREngine) if isinstance(v, property)}
    assert set(R.engine.ENGINE_COUNTERS) == set(T.engine.ENGINE_COUNTERS)
    assert torch.device(T.HREngine(device="cpu").device).type == "cpu"


def test_launch_counts_are_exact_under_threads():
    """A parallel flush can launch kernels from pool threads; each
    wrapper's count still rises by exactly one a launch."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    def wrapper():
        pass

    wrapper.launches = 0

    def launch_many(_):
        for _ in range(20_000):
            _build.count_launch(wrapper)

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(launch_many, range(8)))
    assert wrapper.launches == 160_000
