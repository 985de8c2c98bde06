"""Observability of the port (``repro_torch.obs``: metrics, span trees,
exports, the report CLI) on the port's engine and front door
(``device="cpu"``), against the reference (``repro.obs``, ``repro.core``).

Mirrors ``tests/test_obs.py`` (counter coverage, span-tree integrity, the
traced front-door acceptance, exports, byte-identical chaos traces, the
view stages) on the port, and adds the comparisons with the reference:

* span trees of ``read``, ``read_many`` and ``write``, traced on both
  engines with ``scan_timer=TickClock()`` and a ``TickClock`` tracer, are
  equal as exported dicts: names, nesting, span ids and every attribute.
  Only times are left out of the comparison; under those clocks they come
  out equal too, and the host-table cases compare the JSON-lines bytes.
  On device-resident families (the reference's kernels in Pallas
  interpret mode, the port's plain versions) no kernel-level attribute
  differs by design: ``kernel.scan_launch`` carries ``fused``, ``n_rows``
  and ``queries`` on both, ``kernel.select_compact`` ``queries``. On the
  two-partition resident family QUORUM reads use counts and selects
  only: a float32 sum's digest depends on each backend's reduction order
  (ROADMAP Queue 3), and the repairs a mismatch causes change the tree;
* a traced chaos run of the port exports the same JSON-lines bytes as the
  reference's, and the same bytes on a second run.
"""

import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import repro.core as R
import repro.obs as RO
import repro_torch.core as T
import repro_torch.obs as PO
from repro.core.tpch import generate_simulation
from repro.ft.chaos import ChaosHarness as RefChaosHarness
from repro_torch.core.engine import (
    ENGINE_COUNTERS,
    FAULT_COUNTERS,
    REPAIR_COUNTERS,
    VIEW_COUNTERS,
)
from repro_torch.ft.chaos import ChaosHarness
from repro_torch.obs import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    SlowQueryLog,
    TickClock,
    Tracer,
    dump_jsonl,
    format_tree,
    load_jsonl,
    render_report,
    span_to_line,
    stage_totals,
    walk,
)
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.serving.frontdoor import (
    FRONTDOOR_COUNTERS,
    REFUSAL_COUNTERS,
    RUNG_COUNTERS,
    FrontDoor,
    Request,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAYOUTS = [("k0", "k1", "k2"), ("k1", "k2", "k0"), ("k2", "k0", "k1")]
_CF = "cf"


def _engine(n_rows=512, *, pkg=T, device_resident=False, partitions=1, views=False, **kw):
    kc, vc, schema = generate_simulation(n_rows, 3, seed=0)
    kw.setdefault("result_cache", False)
    if pkg is T:
        kw.setdefault("device", "cpu")
    eng = pkg.HREngine(n_nodes=6, **kw)
    eng.create_column_family(
        _CF, kc, vc, replication_factor=3, layouts=LAYOUTS, schema=pkg.KeySchema(dict(schema.bits)),
        partitions=partitions, device_resident=device_resident, views=views,
    )
    return eng, schema


# -- metrics primitives ---------------------------------------------------------------


class TestMetrics:
    def test_counter_gauge_histogram(self):
        c = Counter("c")
        c.inc()
        c.inc(2.5)
        assert c.value == 3.5
        c.reset()
        assert c.value == 0.0
        g = Gauge("g")
        g.set(4.0)
        g.max(2.0)
        g.max(9.0)
        assert g.value == 9.0
        h = Histogram("h")
        data = np.random.default_rng(0).uniform(1e-4, 1e-1, 2000)
        for v in data:
            h.observe(float(v))
        snap = h.snapshot()
        assert snap["count"] == 2000
        for q, name in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            true = float(np.quantile(data, q))
            assert true <= snap[name] <= min(true * 1.15, snap["max"])

    def test_registry_matches_the_reference(self):
        port, ref = MetricsRegistry(), RO.MetricsRegistry()
        for reg in (port, ref):
            reg.counter("a").inc(2)
            reg.gauge("g").max(3.0)
            reg.histogram("lat").observe(0.5)
        assert port.as_dict() == ref.as_dict()
        assert port.catalog() == ref.catalog()
        with pytest.raises(TypeError):
            port.gauge("a")
        port.reset()
        assert port.value("a") == 0.0


# -- counter coverage audits -----------------------------------------------------------


class TestCounterCoverage:
    def test_inventories_equal_the_reference(self):
        import repro.core.engine as RE

        assert set(ENGINE_COUNTERS) == set(RE.ENGINE_COUNTERS)
        assert FAULT_COUNTERS == RE.FAULT_COUNTERS
        assert REPAIR_COUNTERS == RE.REPAIR_COUNTERS
        assert VIEW_COUNTERS == RE.VIEW_COUNTERS
        assert T.CONSISTENCY_LEVELS == R.CONSISTENCY_LEVELS
        for name in ("FAULT_COUNTERS", "REPAIR_COUNTERS", "VIEW_COUNTERS"):
            assert name in T.engine.__all__

    def test_engine_inventories_resolve_in_registry(self):
        eng, _ = _engine(64)
        cat = set(eng.metrics.catalog())
        for name in ENGINE_COUNTERS:
            assert name in cat, f"ENGINE_COUNTERS[{name!r}] not registered"
        for exc_name, counter in FAULT_COUNTERS.items():
            assert counter in cat and counter in ENGINE_COUNTERS, exc_name
            assert hasattr(T, exc_name)
        for counter in (*REPAIR_COUNTERS, *VIEW_COUNTERS):
            assert counter in cat and counter in ENGINE_COUNTERS
        stats = eng.stats
        for name in ENGINE_COUNTERS:
            assert name in stats

    def test_frontdoor_inventories_resolve_in_registry(self):
        from repro.serving import frontdoor as RF

        eng, _ = _engine(64)
        fd = FrontDoor(eng)
        cat = set(fd.metrics.catalog())
        for name in FRONTDOOR_COUNTERS:
            assert name in cat
        for counter in (*REFUSAL_COUNTERS.values(), *RUNG_COUNTERS.values()):
            assert counter in cat and counter in FRONTDOOR_COUNTERS
        assert set(fd.stats) == set(FRONTDOOR_COUNTERS) | {"max_queue_depth"}
        assert (FRONTDOOR_COUNTERS, REFUSAL_COUNTERS, RUNG_COUNTERS) == (
            RF.FRONTDOOR_COUNTERS, RF.REFUSAL_COUNTERS, RF.RUNG_COUNTERS,
        )

    def test_deadline_exceeded_increments_counter(self):
        eng, _ = _engine(256)
        before = eng.stats[FAULT_COUNTERS["DeadlineExceeded"]]
        with pytest.raises(T.DeadlineExceeded):
            eng.read_many(_CF, [T.Query({"k0": T.Eq(1)})], deadline_s=0.0)
        assert eng.stats["deadline_exceeded"] == before + 1

    def test_read_fault_increments_counter(self):
        eng, _ = _engine(256)
        for node in eng.nodes:
            node.read_fault_budget = 1
        with pytest.raises(RuntimeError, match="no live replica answered"):
            eng.read(_CF, T.Query({"k0": T.Eq(1)}))
        assert eng.stats[FAULT_COUNTERS["TransientReadError"]] == 3
        assert eng.stats["read_retries"] == 3

    def test_flush_fault_increments_counter(self):
        eng, _ = _engine(256)
        for node in eng.nodes:
            node.flush_fault_budget = 99
        kc = {c: np.array([1], np.int64) for c in ("k0", "k1", "k2")}
        with pytest.raises(T.TransientFault):
            eng.write(_CF, kc, {"metric": np.array([0.5])})
        assert eng.stats[FAULT_COUNTERS["TransientFlushError"]] >= 1

    def test_repair_and_view_counters_move_on_their_paths(self):
        eng, _ = _engine(512, device_resident=True, views=True)
        cf = eng.column_families[_CF]
        before = eng.stats
        # a transient outage and a write: node_up replays the hinted tail
        victim = cf.replicas[0].node_id
        eng.fail_node(victim, transient=True)
        kc = {c: np.arange(4, dtype=np.int64) for c in ("k0", "k1", "k2")}
        eng.write(_CF, kc, {"metric": np.ones(4)})
        eng.node_up(victim)
        # a flipped host value: scrub finds it and rebuilds the view
        arr = eng._table(cf, cf.replicas[1]).value_cols["metric"]
        arr.view(np.int64)[0] ^= np.int64(1) << np.int64(62)
        eng.scrub_column_family(_CF)
        eng.read_many(_CF, [T.Query({}, agg="sum", value_col="metric")])
        after = eng.stats
        moved = {k: after[k] - before[k] for k in ("hint_replays", "scrub_repairs", "view_hits", "view_rebuilds")}
        assert all(v > 0 for v in moved.values()), moved

    def test_frontdoor_refusals_increment_their_counters(self):
        eng, _ = _engine(256)
        fd = FrontDoor(eng, max_batch=4, max_queue=4, shed_fill=1.0)
        fd.serve([Request(_CF, T.Query({"k0": T.Eq(i % 4)})) for i in range(7)])
        assert fd.stats[REFUSAL_COUNTERS["queue"]] == 3
        fd = FrontDoor(eng, rate=10.0, burst=2.0)
        fd.serve([Request(_CF, T.Query({"k0": T.Eq(0)})) for _ in range(3)])
        assert fd.stats[REFUSAL_COUNTERS["rate"]] == 1
        fd = FrontDoor(eng, max_wait=1e-3)
        resps = fd.serve([Request(_CF, T.Query({"k0": T.Eq(0)}), deadline_s=0.0)])
        assert resps[0].status == "deadline"
        assert fd.stats[REFUSAL_COUNTERS["deadline"]] == 1

    def test_reset_stats_on_engine_and_frontdoor(self):
        eng, _ = _engine(256, result_cache=True)
        eng.read(_CF, T.Query({"k0": T.Eq(1)}))
        assert eng.stats["result_cache_misses"] > 0
        eng.reset_stats()
        assert eng.stats["result_cache_misses"] == 0
        fd = FrontDoor(eng)
        fd.serve([Request(_CF, T.Query({"k0": T.Eq(1)}))])
        assert fd.stats["submitted"] == 1 and fd.stats["max_queue_depth"] == 1
        fd.reset_stats()
        assert fd.stats["submitted"] == 0 and fd.stats["max_queue_depth"] == 0


# -- span trees --------------------------------------------------------------------------


def _assert_tree_integrity(tracer):
    """Parent links, unique ids, no orphans."""
    seen = []
    for root in tracer.roots:
        assert root.parent_id is None
        for s in walk(root):
            seen.append(s.span_id)
            for c in s.children:
                assert c.parent_id == s.span_id
                assert c.t_start >= s.t_start
    assert len(seen) == len(set(seen)), "span ids must be unique"
    assert len(seen) == tracer.spans_started, "orphaned spans exist"


class TestSpanTrees:
    def test_traced_read_many_integrity_and_monotone_ticks(self):
        eng, _ = _engine(512, partitions=4)
        tracer = Tracer(clock=TickClock())
        root = tracer.root("test.root")
        eng.read_many(_CF, [T.Query({"k0": T.Eq(i)}) for i in range(6)], consistency=T.QUORUM, trace=root)
        root.end()
        _assert_tree_integrity(tracer)
        for s in walk(root):
            assert s.t_end is not None and s.t_end >= s.t_start, s.name
        assert {"engine.read_many", "engine.scatter", "engine.partition",
                "engine.group_scan", "engine.gather"} <= {s.name for s in walk(root)}

    def test_traced_write_path_reaches_flush(self):
        eng, _ = _engine(256)
        tracer = Tracer(clock=TickClock())
        root = tracer.root("test.root")
        kc = {c: np.arange(4, dtype=np.int64) for c in ("k0", "k1", "k2")}
        eng.write(_CF, kc, {"metric": np.ones(4)}, trace=root)
        root.end()
        _assert_tree_integrity(tracer)
        assert {"engine.write", "engine.log_append", "engine.memtable_stage",
                "engine.flush", "engine.flush_merge"} <= {s.name for s in walk(root)}

    def test_error_spans_carry_error_attr(self):
        eng, _ = _engine(256)
        for node in eng.nodes:
            node.read_fault_budget = 1
        tracer = Tracer(clock=TickClock())
        root = tracer.root("test.root")
        with pytest.raises(RuntimeError):
            eng.read_many(_CF, [T.Query({"k0": T.Eq(1)})], trace=root)
        root.end()
        rm = root.find("engine.read_many")
        assert rm is not None and rm.t_end is not None
        assert "TransientReadError" in [s.attrs.get("error") for s in root.find_all("engine.group_scan")]


# -- span trees against the reference ---------------------------------------------------


def _trace_ops(pkg, obs, *, device_resident=False, partitions=1, views=False, exact_quorum=False):
    """Trace scalar reads, ``read_many`` at ONE and QUORUM, a write and a
    read after it, each under its own root; returns the exported dicts."""
    kw = {"scan_timer": obs.TickClock()}
    eng, schema = _engine(
        512, pkg=pkg, device_resident=device_resident, partitions=partitions, views=views, **kw
    )
    tracer = obs.Tracer(clock=obs.TickClock())
    qs = [pkg.Query({"k0": pkg.Eq(i)}) for i in range(4)] + [
        pkg.Query({"k1": pkg.Range(1, 5)}, agg="sum", value_col="metric"),
        pkg.Query({"k2": pkg.Eq(2)}, agg="select"),
        pkg.Query({}, agg="sum", value_col="metric"),
        pkg.Query({"k0": pkg.Range(0, 2)}, agg="count"),
    ]
    quorum = [q for q in qs if q.agg != "sum"] if exact_quorum else qs
    rng = np.random.default_rng(1)
    wk = {c: rng.integers(0, schema.max_value(c) + 1, 40).astype(np.int64) for c in ("k0", "k1", "k2")}
    wv = {"metric": rng.uniform(0, 1, 40)}
    for op in (
        lambda r: (eng.read(_CF, qs[0], trace=r), eng.read(_CF, quorum[1], consistency="QUORUM", trace=r)),
        lambda r: eng.read_many(_CF, qs, trace=r),
        lambda r: eng.read_many(_CF, quorum, consistency="QUORUM", trace=r),
        lambda r: eng.write(_CF, wk, wv, trace=r),
        lambda r: eng.read_many(_CF, qs, trace=r),
    ):
        root = tracer.root("test.root")
        op(root)
        root.end()
    return [s.to_dict() for s in tracer.roots], tracer


def _untimed(d):
    return {
        "name": d["name"], "span_id": d["span_id"], "parent_id": d["parent_id"], "attrs": d["attrs"],
        "children": [_untimed(c) for c in d["children"]],
    }


@pytest.mark.parametrize(
    "case",
    [
        dict(),
        dict(partitions=4),
        dict(device_resident=True),
        dict(device_resident=True, views=True),
        dict(device_resident=True, partitions=2, exact_quorum=True),
    ],
    ids=["host", "host-P4", "device", "device-views", "device-P2"],
)
def test_span_trees_equal_the_reference(case):
    ref, _ = _trace_ops(R, RO, **case)
    port, tracer = _trace_ops(T, PO, **case)
    _assert_tree_integrity(tracer)
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert _untimed(b) == _untimed(a), f"root {i}"
    names = {s["name"] for root in port for s in _walk_dicts(root)}
    assert {"engine.read_many", "engine.group_scan", "engine.write", "engine.flush"} <= names
    # a scalar read on a partitioned family goes through the scatter path
    assert ("engine.read" in names) == (case.get("partitions", 1) == 1)
    if case.get("device_resident"):
        assert "kernel.scan_launch" in names and "kernel.select_compact" in names
        assert "engine.host_scan" not in names
    else:
        assert "engine.host_scan" in names and "kernel.scan_launch" not in names
    if case.get("views"):
        assert {"view.serve", "view.build"} <= names
    if not case.get("device_resident"):
        # host tables sum in float64 on both sides: the clocks tick alike too
        assert [_line(d) for d in port] == [_line(d) for d in ref]


def _line(d):
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


def _walk_dicts(d):
    yield d
    for c in d["children"]:
        yield from _walk_dicts(c)


def test_every_documented_stage_name_is_emitted_by_the_port():
    """The span taxonomy of ``obs/trace.py``'s docstring (the reference's,
    copied) names only stages the port's engine or front door opens."""
    import repro_torch

    doc = PO.trace.__doc__
    names = {line.split("``")[1] for line in doc.splitlines() if line.startswith(".. ``")}
    assert len(names) == 29
    src = "\n".join(p.read_text() for p in pathlib.Path(repro_torch.__file__).parent.rglob("*.py")
                    if p.name != "trace.py")
    missing = sorted(n for n in names if f'"{n}"' not in src)
    assert missing == []
    assert names == {line.split("``")[1] for line in RO.trace.__doc__.splitlines() if line.startswith(".. ``")}


@pytest.mark.parametrize(
    "module",
    ["obs", "obs.trace", "obs.export", "obs.metrics", "serving.admission", "serving.frontdoor",
     "ft.chaos", "ft.failures", "ft.straggler", "ft.detector"],
)
def test_public_names_equal_the_reference(module):
    import importlib

    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    assert sorted(port.__all__) == sorted(ref.__all__)
    assert all(hasattr(port, name) for name in port.__all__)


# -- acceptance: one tree, kernel depth, walls sum to latency ----------------------------


class TestFrontDoorAcceptance:
    def test_single_quorum_request_one_tree_to_kernel_depth(self):
        eng, _ = _engine(256, device_resident=True)
        fd = FrontDoor(eng, max_batch=4, max_wait=1e-4, tracer=Tracer())
        resps = fd.serve([Request(_CF, T.Query({"k0": T.Eq(3)}), consistency=T.QUORUM)])
        assert resps[0].ok
        roots = fd.tracer.roots
        assert [r.name for r in roots] == ["frontdoor.request"]
        root = roots[0]
        names = [s.name for s in walk(root)]
        assert {"kernel.scan_launch", "engine.read_many", "engine.digest"} <= set(names)
        q, s = root.find("frontdoor.queue"), root.find("frontdoor.service")
        assert q.wall + s.wall == pytest.approx(resps[0].latency_s, rel=1e-9)
        assert root.wall == pytest.approx(resps[0].latency_s, rel=1e-9)
        assert root.attrs["status"] == "ok"
        entries = fd.slow_log.entries()
        assert len(entries) == 1 and entries[0][1] is root

    def test_multi_request_batch_links_members_to_batch_root(self):
        eng, _ = _engine(512)
        fd = FrontDoor(eng, max_batch=4, max_wait=1e-3, tracer=Tracer())
        reqs = [Request(_CF, T.Query({"k0": T.Eq(i)}), arrival_s=i * 1e-5) for i in range(3)]
        resps = fd.serve(reqs)
        assert all(r.ok for r in resps)
        roots = fd.tracer.roots
        batch_roots = [r for r in roots if r.name == "frontdoor.batch"]
        req_roots = [r for r in roots if r.name == "frontdoor.request"]
        assert len(batch_roots) == 1 and len(req_roots) == 3
        for r in req_roots:
            assert r.find("frontdoor.service").attrs["batch"] == batch_roots[0].span_id
        assert batch_roots[0].find("engine.read_many") is not None
        _assert_tree_integrity(fd.tracer)


# -- exports ---------------------------------------------------------------------------


def _tree():
    tr = Tracer(clock=TickClock())
    root = tr.root("a")
    root.child("b", k=1).end()
    root.end()
    return root


class TestExport:
    def test_slow_query_log_keeps_k_slowest(self):
        log = SlowQueryLog(2)
        for lat in (0.3, 0.1, 0.5, 0.2):
            log.offer(_tree(), latency=lat)
        assert [lat for lat, _ in log.entries()] == [0.5, 0.3]
        with pytest.raises(ValueError):
            SlowQueryLog(0)

    def test_jsonl_round_trip_and_determinism(self):
        root = _tree()
        assert span_to_line(root, latency=1.5) == span_to_line(root, latency=1.5)
        buf = io.StringIO()
        assert dump_jsonl([(1.5, root), root], buf) == 2
        docs = load_jsonl(io.StringIO(buf.getvalue()))
        assert docs[0]["latency"] == 1.5 and docs[0]["tree"]["name"] == "a"
        assert docs[1]["name"] == "a"

    def test_load_jsonl_rejects_malformed(self):
        with pytest.raises(ValueError, match="line 1"):
            load_jsonl(io.StringIO("{not json\n"))
        with pytest.raises(ValueError):
            load_jsonl(io.StringIO('{"no_name": 1}\n'))

    def test_exports_equal_the_reference(self):
        """The same span tree built by both tracers exports the same line,
        totals, tree rendering and report."""
        trees = []
        for obs in (RO, PO):
            tr = obs.Tracer(clock=obs.TickClock())
            root = tr.root("a", idx=0)
            b = root.child("b", k=1)
            b.child("c").end()
            b.end(status="ok")
            root.end()
            trees.append((obs, root))
        (ro, ra), (po, pa) = trees
        assert po.span_to_line(pa, 2.0) == ro.span_to_line(ra, 2.0)
        assert po.stage_totals([pa]) == ro.stage_totals([ra])
        assert po.format_tree(pa, unit="ticks") == ro.format_tree(ra, unit="ticks")
        docs = load_jsonl(io.StringIO(po.span_to_line(pa, 2.0) + "\n"))
        assert render_report(docs, unit="ticks") == ro.render_report(docs, unit="ticks")

    def test_stage_totals_and_format_tree(self):
        root = _tree()
        assert stage_totals([root])["a"]["count"] == 1
        assert "a" in format_tree(root, unit="ticks")

    def test_report_cli_in_process(self, tmp_path):
        out = tmp_path / "t.jsonl"
        dump_jsonl([_tree()], str(out))
        assert obs_main([str(out), "--unit", "ticks"]) == 0
        empty = tmp_path / "empty.jsonl"
        empty.write_text("")
        assert obs_main([str(empty)]) == 1
        bad = tmp_path / "bad.jsonl"
        bad.write_text("{nope\n")
        assert obs_main([str(bad)]) == 1


def _python_m(module, *args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run(
        [sys.executable, "-m", module, *args], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )


def test_report_cli_as_a_module(tmp_path):
    """``python -m repro_torch.obs``: 0 and a report on a good dump, 1 on a
    malformed or an empty one."""
    good = tmp_path / "good.jsonl"
    dump_jsonl([(3.0, _tree())], str(good))
    out = _python_m("repro_torch.obs", str(good), "--unit", "ticks")
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("trace report: 1 span trees") and "slowest 1 trees" in out.stdout
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"name": "a", "span_id": 0}\n{broken\n')
    out = _python_m("repro_torch.obs", str(bad))
    assert out.returncode == 1 and "line 2" in out.stderr
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    assert _python_m("repro_torch.obs", str(empty)).returncode == 1


# -- determinism: byte-identical chaos traces ----------------------------------------------


def _chaos_trace(harness_cls, obs, **kw):
    tracer = obs.Tracer(clock=obs.TickClock())
    report = harness_cls(
        seed=3, n_steps=8, n_rows=400, write_rows=40, n_probes=3, probe_every=3, memtable_rows=120,
        tracer=tracer, **kw,
    ).run()
    assert report.ok, report.failures
    buf = io.StringIO()
    obs.dump_jsonl(tracer.roots, buf)
    return buf.getvalue()


def test_chaos_trace_is_byte_stable_and_equals_the_reference():
    a = _chaos_trace(ChaosHarness, PO, device="cpu")
    b = _chaos_trace(ChaosHarness, PO, device="cpu")
    assert a, "traced chaos run exported no span trees"
    assert a == b, "same seeded schedule must export identical traces"
    assert a == _chaos_trace(RefChaosHarness, RO)
    docs = load_jsonl(io.StringIO(a))
    assert {d["name"] for d in docs} == {"chaos.probe"}


# -- materialized views: span stages + counters ------------------------------------------


class TestViewObservability:
    def test_view_serve_span_and_counters(self):
        eng, _ = _engine(512, device_resident=True, views=True)
        tracer = Tracer(clock=TickClock())
        root = tracer.root("test.root")
        eng.read_many(_CF, [T.Query({}, agg="sum", value_col="metric")], trace=root)
        root.end()
        _assert_tree_integrity(tracer)
        sv = root.find("view.serve")
        assert sv is not None and sv.t_end is not None
        assert sv.attrs["queries"] == 1 and "boundary_rows" in sv.attrs
        assert eng.stats["view_hits"] == 1
        assert eng.stats["view_boundary_rows"] == sv.attrs["boundary_rows"]

    def test_view_build_span_on_flush(self):
        eng, _ = _engine(512, device_resident=True, views=True)
        tracer = Tracer(clock=TickClock())
        root = tracer.root("test.root")
        kc = {c: np.arange(6, dtype=np.int64) for c in ("k0", "k1", "k2")}
        eng.write(_CF, kc, {"metric": np.ones(6)}, trace=root)
        root.end()
        builds = root.find_all("view.build")
        assert builds and all(s.attrs.get("incremental") is True and s.attrs["rows"] == 6 for s in builds)
        assert eng.stats["view_rebuilds"] == 0

    def test_non_view_engine_emits_no_view_stages(self):
        eng, _ = _engine(512, device_resident=True)
        tracer = Tracer(clock=TickClock())
        root = tracer.root("test.root")
        eng.read_many(_CF, [T.Query({}, agg="sum", value_col="metric")], trace=root)
        root.end()
        assert root.find("view.serve") is None
        assert eng.stats["view_hits"] == 0
