"""End-to-end parity of the port's engine (``repro_torch.core.HREngine``,
on ``device="cpu"``) with the reference engine (``repro.core.HREngine``):
the same HRCA layouts and replica placement, the same replica chosen for
every query, equal ``ScanResult`` fields before and after a write drip
that triggers an on-device compaction, ``read`` == ``read_many``, the
result cache's hits, bound and invalidation, and the write options and
layouts the slice keeps (group commit, commit-log checkpoints, checksummed
flushes, TR layouts), and ring migration, parallel writes, the drift
trigger and read deadlines answering like the reference's. Also the port's
boundaries: it imports neither JAX nor ``repro`` and it does not fall back
to the CPU when CUDA is missing.
"""

import ast
import copy
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.tpch import generate_orders, orders_schema, q1_q2_workload

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _queries(pkg, wl):
    """The paper's Q1/Q2 sums, then counts and selects with the same
    filters, plus a wide select and a count of one clerk."""
    qs = [pkg.Query(filters=q.filters, agg="sum", value_col=q.value_col) for q in wl.queries[:16]]
    qs += [pkg.Query(filters=q.filters, agg="count") for q in wl.queries[16:24]]
    qs += [pkg.Query(filters=q.filters, agg="select") for q in wl.queries[24:32]]
    qs += [
        pkg.Query(filters={"custkey": pkg.Range(0, 200)}, agg="select"),
        pkg.Query(filters={"clerk": pkg.Range(5, 6)}, agg="count"),
        pkg.Query(filters={"orderdate": pkg.Range(9, 9)}, agg="sum", value_col="totalprice"),
    ]
    return qs


def _port_workload(wl):
    return T.Workload([T.Query(filters=q.filters, agg=q.agg, value_col=q.value_col) for q in wl.queries])


@pytest.fixture(scope="module")
def engines():
    kc, vc = generate_orders(0.01, seed=0)  # 15,000 rows
    n = len(kc["custkey"])
    wl = q1_q2_workload(n_instances=40, n_rows=n)
    ref = R.HREngine(n_nodes=6)
    ref.create_column_family(
        "o", kc, vc, replication_factor=3, mechanism="HR", workload=wl,
        schema=orders_schema(), device_resident=True,
    )
    port = T.HREngine(n_nodes=6, device="cpu")
    port.create_column_family(
        "o", kc, vc, replication_factor=3, mechanism="HR", workload=_port_workload(wl),
        schema=T.KeySchema(dict(orders_schema().bits)), device_resident=True,
    )
    return ref, port, wl


def _assert_reads_equal(ref_out, port_out):
    assert len(ref_out) == len(port_out)
    for (ra, pa), (rb, pb) in zip(ref_out, port_out):
        assert (pa.replica_id, pa.node_id) == (pb.replica_id, pb.node_id)
        assert pa.estimated_rows == pytest.approx(pb.estimated_rows, rel=1e-12)
        assert (ra.rows_scanned, ra.rows_matched) == (rb.rows_scanned, rb.rows_matched)
        np.testing.assert_allclose(ra.value, rb.value, rtol=1e-5, atol=1e-3)
        if ra.selected is None:
            assert rb.selected is None
        else:
            np.testing.assert_array_equal(ra.selected, rb.selected)


def test_same_layouts_placement_and_resident_state(engines):
    ref, port, _ = engines
    assert ref.layouts("o") == port.layouts("o")
    rcf, pcf = ref.column_families["o"], port.column_families["o"]
    assert [r.node_id for r in rcf.replicas] == [r.node_id for r in pcf.replicas]
    for ra, rb in zip(rcf.replicas, pcf.replicas):
        ta, tb = ref._table(rcf, ra), port._table(pcf, rb)
        assert tb.device_resident and tb._device["keys"].device == CPU
        np.testing.assert_array_equal(np.asarray(ta._device["keys"]), tb._device["keys"].numpy())
        assert ta.stored_digest == tb.stored_digest


def test_read_many_matches_reference(engines):
    ref, port, wl = engines
    ref, port = copy.deepcopy(ref), copy.deepcopy(port)
    _assert_reads_equal(ref.read_many("o", _queries(R, wl)), port.read_many("o", _queries(T, wl)))


def test_read_equals_read_many(engines):
    """Scalar reads route and answer exactly like the batch (the scalar
    path is the Q = 1 launch), and like the reference's scalar reads."""
    ref, port, wl = engines
    a, b, r = copy.deepcopy(port), copy.deepcopy(port), copy.deepcopy(ref)
    tq = _queries(T, wl)
    seq = [a.read("o", q) for q in tq]
    bat = b.read_many("o", tq)
    for (rs, ps), (rb, pb) in zip(seq, bat):
        assert ps.replica_id == pb.replica_id
        assert (rs.value, rs.rows_scanned, rs.rows_matched) == (rb.value, rb.rows_scanned, rb.rows_matched)
    _assert_reads_equal([r.read("o", q) for q in _queries(R, wl)], seq)


def test_write_drip_with_compaction_matches_reference(engines):
    """Ten write-through writes: the ninth run stack trips ``max_runs``
    and the replicas compact on the device; reads and resident states
    stay equal to the reference's throughout."""
    ref, port, wl = engines
    ref, port = copy.deepcopy(ref), copy.deepcopy(port)
    kw, vw = generate_orders(0.001, seed=5)
    for i in range(10):
        s = slice(i * 150, (i + 1) * 150)
        part_k = {c: v[s] for c, v in kw.items()}
        part_v = {c: v[s] for c, v in vw.items()}
        ref.write("o", part_k, part_v)
        port.write("o", part_k, part_v)
        if i in (3, 9):
            _assert_reads_equal(ref.read_many("o", _queries(R, wl)), port.read_many("o", _queries(T, wl)))
    assert port.stats["compactions"] == ref.stats["compactions"] > 0
    assert port.stats["memtable_flushes"] == ref.stats["memtable_flushes"] == 30
    rcf, pcf = ref.column_families["o"], port.column_families["o"]
    for ra, rb in zip(rcf.replicas, pcf.replicas):
        ta, tb = ref._table(rcf, ra), port._table(pcf, rb)
        for key in ("keys", "values_tile"):
            np.testing.assert_array_equal(np.asarray(ta._device[key]), tb._device[key].numpy())
        assert ta._device["run_starts"] == tb._device["run_starts"]
        np.testing.assert_array_equal(ta._device["row_map"], tb._device["row_map"])
        assert ta.stored_digest == tb.stored_digest == tb.content_digest()
    np.testing.assert_array_equal(rcf.stats.columns["custkey"].counts, pcf.stats.columns["custkey"].counts)


def test_result_cache_hits_and_invalidation(engines):
    _, port, wl = engines
    port = copy.deepcopy(port)
    port.reset_stats()
    tq = _queries(T, wl)
    first = port.read_many("o", tq)
    assert port.stats["result_cache_hits"] == 0
    assert port.stats["result_cache_misses"] == len(tq)
    # the round-robin tie-break may send a repeated query to another
    # replica, whose cache is still cold: hits are the routed-back share
    again = port.read_many("o", tq)
    hits = port.stats["result_cache_hits"]
    assert 0 < hits and hits + port.stats["result_cache_misses"] == 2 * len(tq)
    for (a, ra), (b, rb) in zip(first, again):
        if ra.replica_id == rb.replica_id:
            assert a is b  # a hit hands out the cached object
    cached = [r for c in port._result_cache.values() for r in c.values()]
    assert any(r.selected is not None and r.selected.size for r in cached)
    assert all(not r.selected.flags.writeable for r in cached if r.selected is not None)
    kw, vw = generate_orders(0.0005, seed=9)
    port.write("o", kw, vw)
    assert port.stats["result_cache_entries"] == 0
    port.read_many("o", tq)
    assert port.stats["result_cache_hits"] == hits  # every entry was invalidated


def test_host_column_family_matches_device_column_family(engines):
    """A ``device_resident=False`` column family answers from numpy; its
    results equal the resident family's."""
    _, port, wl = engines
    kc, vc = generate_orders(0.01, seed=0)
    host = T.HREngine(n_nodes=6, device="cpu")
    host.create_column_family(
        "o", kc, vc, replication_factor=3, layouts=port.layouts("o"),
        schema=T.KeySchema(dict(orders_schema().bits)),
    )
    assert not any(t.device_resident for n in host.nodes for t in n.tables.values())
    tq = _queries(T, wl)
    _assert_reads_equal(copy.deepcopy(port).read_many("o", tq), host.read_many("o", tq))


def test_result_cache_evicts_fifo_past_its_entry_bound(engines, monkeypatch):
    """Each replica's map keeps at most ``_CACHE_MAX_ENTRIES`` entries,
    evicting the oldest first; evicted queries miss and are answered
    again, equal to their first answers."""
    _, port, wl = engines
    port = copy.deepcopy(port)
    monkeypatch.setattr(T.HREngine, "_CACHE_MAX_ENTRIES", 4)
    tq = _queries(T, wl)
    first = port.read_many("o", tq)
    assert all(len(c) <= 4 for c in port._result_cache.values())
    assert port.stats["result_cache_entries"] <= 4 * len(port._result_cache)
    port.reset_stats()
    again = [port.read("o", q) for q in tq]
    assert port.stats["result_cache_misses"] > 0
    for (a, _), (b, _) in zip(first, again):
        assert (a.value, a.rows_scanned, a.rows_matched) == (b.value, b.rows_scanned, b.rows_matched)


def _engine_pair(**engine_kwargs):
    """A small resident column family on both engines, explicit layouts."""
    kc, vc = generate_orders(0.005, seed=2)
    layouts = [("clerk", "orderdate", "custkey"), ("custkey", "orderdate", "clerk"), ("orderdate", "clerk", "custkey")]
    ref = R.HREngine(n_nodes=5, **engine_kwargs)
    port = T.HREngine(n_nodes=5, device="cpu", **engine_kwargs)
    ref.create_column_family("o", kc, vc, layouts=layouts, schema=orders_schema(), device_resident=True)
    port.create_column_family(
        "o", kc, vc, layouts=layouts, schema=T.KeySchema(dict(orders_schema().bits)), device_resident=True,
    )
    wl = q1_q2_workload(n_instances=40, n_rows=len(kc["custkey"]), seed=6)
    return ref, port, wl


_STAT_KEYS = (
    "memtable_flushes", "compactions", "commitlog_auto_checkpoints", "commitlog_records",
    "commitlog_rows", "staged_rows",
)


def test_group_commit_staging_and_auto_checkpoint_match_reference():
    """``memtable_rows`` staging: writes stage until the threshold, a read
    flushes the replica it touches first (never a stale answer), and the
    commit log checkpoints itself once drained past its record budget."""
    ref, port, wl = _engine_pair(memtable_rows=500, commitlog_checkpoint_records=4)
    kw, vw = generate_orders(0.002, seed=7)
    for i in range(10):
        sl = slice(i * 300, (i + 1) * 300)
        for eng in (ref, port):
            eng.write("o", {c: v[sl] for c, v in kw.items()}, {c: v[sl] for c, v in vw.items()})
        assert {k: port.stats[k] for k in _STAT_KEYS} == {k: ref.stats[k] for k in _STAT_KEYS}
        if i % 3 == 1:
            _assert_reads_equal(ref.read_many("o", _queries(R, wl)), port.read_many("o", _queries(T, wl)))
    assert port.stats["commitlog_auto_checkpoints"] > 0
    for eng in (ref, port):
        eng.flush_memtables("o")
    assert port.stats["staged_rows"] == ref.stats["staged_rows"] == 0
    assert port.checkpoint_commitlog("o") == ref.checkpoint_commitlog("o")
    _assert_reads_equal(ref.read_many("o", _queries(R, wl)), port.read_many("o", _queries(T, wl)))


def test_corrupt_run_is_refused_and_loses_no_rows():
    """A run that fails its checksum is refused before it merges, its
    rows stay staged, and the column family keeps answering like the
    reference's over the rows that did merge."""
    ref, port, wl = _engine_pair(memtable_rows=10_000)
    kw, vw = generate_orders(0.0004, seed=8)
    for eng in (ref, port):
        eng.write("o", kw, vw)
        eng.flush_memtables("o")
    assert {k: port.stats[k] for k in _STAT_KEYS} == {k: ref.stats[k] for k in _STAT_KEYS}
    port.write("o", kw, vw)
    mt = port.column_families["o"].memtables[0]
    run = mt.peek_run()
    run.value_cols["totalprice"][0] += 1.0  # the run no longer matches its crc
    mt.peek_run = lambda: run
    with pytest.raises(T.CorruptRunError):
        port.flush_memtables("o")
    assert port.stats["corrupt_runs"] == 1 and mt.n_staged == len(kw["custkey"])
    cf = port.column_families["o"]
    table = port._table(cf, cf.replicas[0])
    assert table.stored_digest == table.content_digest()


def test_tr_layouts_match_reference():
    """TR: the single best expert layout on every replica, the same as
    the reference's, and reads equal to the reference's."""
    ref, port, wl = _engine_pair()
    kc, vc = generate_orders(0.003, seed=9)
    ref.create_column_family("tr", kc, vc, mechanism="TR", workload=wl, schema=orders_schema())
    port.create_column_family(
        "tr", kc, vc, mechanism="TR", workload=_port_workload(wl),
        schema=T.KeySchema(dict(orders_schema().bits)),
    )
    assert ref.layouts("tr") == port.layouts("tr") and len(set(port.layouts("tr"))) == 1
    _assert_reads_equal(ref.read_many("tr", _queries(R, wl)), port.read_many("tr", _queries(T, wl)))


def test_features_outside_the_slice_raise(engines):
    """Named for the time these features were outside the port; it now
    holds that ring migration (split, merge, rebalance), parallel writes,
    the drift trigger and read deadlines answer like the reference's on
    the same families (ring starts, rows moved, reads); nothing raises
    ``NotImplementedError``. The availability layer (consistency levels,
    hedges, node failure, recovery, scrub) answers too."""
    ref, port, wl = engines
    kc, vc = generate_orders(0.001, seed=1)
    pair = {}
    for pkg in (R, T):
        eng = pkg.HREngine(n_nodes=3, **({"device": "cpu"} if pkg is T else {}))
        for name, kwargs in (("pv", {"views": True, "device_resident": True}), ("p", {})):
            eng.create_column_family(
                name, kc, vc, replication_factor=2, mechanism="TR",
                schema=pkg.KeySchema(dict(orders_schema().bits)), partitions=2, **kwargs,
            )
        pair[pkg] = eng
    eng = pair[T]
    for name in ("pv", "p"):
        assert pair[R].split_partition(name, 0) == eng.split_partition(name, 0)
        pair[R].merge_partitions(name, 1)
        eng.merge_partitions(name, 1)
        assert pair[R].rebalance(name, partitions=3) == eng.rebalance(name, partitions=3)
        assert pair[R].column_families[name].ring.starts == eng.column_families[name].ring.starts
        _assert_reads_equal(pair[R].read_many(name, _queries(R, wl)), eng.read_many(name, _queries(T, wl)))
    assert eng.stats["rebalance_rows_moved"] == pair[R].stats["rebalance_rows_moved"] > 0
    # parallel flushes and the drift trigger: every written row lands in
    # one partition, which trips a rebalance at 1.5x the mean
    wk, wv = generate_orders(0.0004, seed=3)
    wk["custkey"] = np.minimum(wk["custkey"], 50)
    drift = {}
    for pkg in (R, T):
        e = pkg.HREngine(n_nodes=3, rebalance_imbalance=1.5, **({"device": "cpu"} if pkg is T else {}))
        e.create_column_family(
            "d", kc, vc, replication_factor=2, mechanism="TR", schema=pkg.KeySchema(dict(orders_schema().bits)),
            partitions=2, partition_balance="tokens",
        )
        for _ in range(3):
            e.write("d", wk, wv, parallel=True)
        drift[pkg] = e
    assert drift[T].stats["rebalance_rows_moved"] == drift[R].stats["rebalance_rows_moved"] > 0
    assert drift[T].column_families["d"].ring.starts == drift[R].column_families["d"].ring.starts
    _assert_reads_equal(drift[R].read_many("d", _queries(R, wl)), drift[T].read_many("d", _queries(T, wl)))
    # read deadlines: a spent budget is refused, a generous one answers
    q, rq = _queries(T, wl)[0], _queries(R, wl)[0]
    with pytest.raises(T.DeadlineExceeded):
        port.read("o", q, deadline_s=0.0)
    with pytest.raises(T.DeadlineExceeded):
        port.read_many("o", [q], deadline_s=0.0)
    assert port.stats["deadline_exceeded"] >= 2
    _assert_reads_equal([ref.read("o", rq)], [port.read("o", q, deadline_s=60.0)])
    assert copy.deepcopy(ref).rebalance("o") == copy.deepcopy(port).rebalance("o")
    want = port.read_many("o", [q])[0][0]
    for kwargs in ({"consistency": "QUORUM"}, {"consistency": "ALL"}, {"hedge": True}):
        assert port.read("o", q, **kwargs)[0].rows_matched == want.rows_matched
        assert port.read_many("o", [q], **kwargs)[0][0].rows_matched == want.rows_matched
    report = eng.scrub_column_family("p")
    assert report == {"replicas_checked": 6, "corrupt": [], "repaired": 0}
    victim = eng.column_families["p"].replicas[0].node_id
    eng.fail_node(victim)
    assert eng.recover_node(victim) > 0.0
    eng.fail_node(victim, transient=True)
    assert eng.node_up(victim) >= 0.0 and eng.stats["hints_open"] == 0


def test_engine_without_cuda_raises(monkeypatch):
    """The default device is CUDA; with none, the engine refuses to start
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.HREngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.HREngine(device="cuda")
    assert T.HREngine(device="cpu").device == CPU


# -- what the port imports ------------------------------------------------------------


def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax_and_no_reference(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "ml_dtypes", "repro"), f"{path.name} imports {name}"


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys, runpy\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels, repro_torch.obs\n"
        "import repro_torch.core.storage, repro_torch.kernels._build\n"
        "import repro_torch.serving, repro_torch.serving.frontdoor, repro_torch.ft\n"
        "import repro_torch.ft.chaos, repro_torch.obs.export, repro_torch.obs.__main__\n"
        "import repro_torch.launch.serve, repro_torch.models.lm, repro_torch.serving.steps\n"
        "import repro_torch.models.convert, repro_torch.configs, repro_torch.parallel.padding\n"
        "import repro_torch.models.moe, repro_torch.models.ssm\n"
        "import repro_torch.training.optimizer, repro_torch.training.steps\n"
        "import repro_torch.data.corpus, repro_torch.data.pipeline\n"
        "import repro_torch.checkpoint.manager, repro_torch.checkpoint.layouts, repro_torch.launch.train\n"
        "import repro_torch.parallel.sharding, repro_torch.launch.mesh, repro_torch.ft.elastic\n"
        "import repro_torch.launch.input_specs\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke_import')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ml_dtypes', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# -- chip_smoke.py refuses to run without the card or the repo -------------------------


def _run_smoke(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True, text=True, timeout=120,
    )


def test_chip_smoke_fails_without_cuda():
    out = _run_smoke(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
