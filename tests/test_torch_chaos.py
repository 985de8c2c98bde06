"""The port's chaos harnesses (``repro_torch.ft.chaos``) on
``device="cpu"``, against the reference's (``repro.ft.chaos``).

Mirrors ``tests/test_chaos.py``: seeded schedules, the oracle property
(after heal the victim's replicas are row-identical, every partition's
fingerprint equals the oracle's, and a QUORUM probe battery returns the
oracle's answers), the overload harness's shed-or-exact property. The
port's oracle is the port's own fault-free engine; the reference appears
only here, as the yardstick:

* the schedules are equal event for event;
* ``ChaosHarness`` on host tables, seeds 0-3, reports what the
  reference's reports, field for field: ``ok``, ``failures``, ``n_events``
  and every ``stats`` key but ``flush_wall_seconds``, a measured wall;
* ``OverloadHarness``'s counters depend on measured walls, so only its
  arrival stream (times, priorities, levels, deadlines, queries) is
  compared, and its acceptance property held.

The ``--views`` schedule runs on the port alone (device-resident families
with views on the plain versions of the kernels); the CLI runs in a
subprocess.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
import repro_torch.obs as PO
from repro.core.tpch import generate_simulation
from repro.ft import chaos as RC
from repro.ft import failures as RFail
from repro.ft import straggler as RStrag
from repro.obs import TickClock as RefTickClock
from repro_torch.ft.failures import FailureInjector, FailurePlan
from repro_torch.ft.straggler import clear_slowdowns, inject_slowdown, measure_tail
from repro_torch.ft.chaos import (
    KINDS,
    ChaosHarness,
    ChaosReport,
    ChaosSchedule,
    OverloadHarness,
)

pytestmark = pytest.mark.chaos

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


class TestSchedule:
    def test_same_seed_same_schedule(self):
        a = ChaosSchedule.generate(7, n_steps=40)
        assert a == ChaosSchedule.generate(7, n_steps=40)
        assert ChaosSchedule.generate(8, n_steps=40) != a

    def test_events_well_formed(self):
        sched = ChaosSchedule.generate(3, n_steps=60, n_nodes=6, n_partitions=4, rate=0.6)
        assert sched.events
        for ev in sched.events:
            assert ev.kind in KINDS and 0 <= ev.step < 60
            if ev.kind in ("crash", "slow_node"):
                assert 0 <= ev.node_id < 6 and ev.duration > 0

    def test_at_most_one_node_down(self):
        for seed in range(10):
            sched = ChaosSchedule.generate(seed, n_steps=50, rate=0.8)
            spans = [(ev.step, ev.step + ev.duration) for ev in sched.events if ev.kind == "crash"]
            for i, (s0, e0) in enumerate(spans):
                for s1, e1 in spans[i + 1:]:
                    assert e0 < s1 or e1 < s0

    @pytest.mark.parametrize("seed", range(6))
    def test_schedule_equals_the_reference(self, seed):
        kw = dict(n_steps=40, n_nodes=6, n_partitions=4, rate=0.5)
        port, ref = ChaosSchedule.generate(seed, **kw), RC.ChaosSchedule.generate(seed, **kw)
        assert port.events and KINDS == RC.KINDS
        assert dataclasses.astuple(port) == dataclasses.astuple(ref)


def _comparable(report):
    d = dataclasses.asdict(report)
    d["stats"] = {k: v for k, v in d["stats"].items() if k != "flush_wall_seconds"}
    return d


class TestOracleProperty:
    @pytest.mark.parametrize("seed", range(4))
    def test_report_equals_the_reference(self, seed):
        port = ChaosHarness(seed, n_steps=20, n_rows=2_000, device=CPU)
        ref = RC.ChaosHarness(seed, n_steps=20, n_rows=2_000)
        assert dataclasses.astuple(port.schedule) == dataclasses.astuple(ref.schedule)
        p, r = port.run(), ref.run()
        assert p.ok, p.failures
        assert _comparable(p) == _comparable(r)
        # the oracle is a port engine on the harness's device
        assert type(port.oracle) is type(port.victim) and port.oracle.device.type == CPU

    def test_faults_actually_exercised(self):
        totals: dict[str, int] = {}
        for seed in range(3):
            report = ChaosHarness(seed, n_steps=20, n_rows=2_000, device=CPU).run()
            assert report.ok, report.failures
            for k, v in report.stats.items():
                if isinstance(v, int):
                    totals[k] = totals.get(k, 0) + v
        assert totals["hints_queued"] > 0 and totals["hint_replays"] > 0 and totals["scrub_checks"] > 0

    def test_report_is_reproducible(self):
        r1 = ChaosHarness(11, n_steps=15, n_rows=1_500, device=CPU).run()
        r2 = ChaosHarness(11, n_steps=15, n_rows=1_500, device=CPU).run()
        assert r1.ok and r2.ok and r1.n_events == r2.n_events
        assert _comparable(r1) == _comparable(r2)

    def test_a_broken_oracle_property_is_reported(self):
        """The harness is not vacuous: a victim replica silently missing
        rows after heal is reported as a fingerprint failure."""
        h = ChaosHarness(0, n_steps=6, n_rows=600, device=CPU)
        inner = h.victim.scrub_column_family

        def scrub_then_drop(cf_name, **kw):
            out = inner(cf_name, **kw)
            cf = h.victim.column_families[cf_name]
            r = cf.partitions[0].replicas[0]
            t = h.victim._table(cf, r)
            node = h.victim.nodes[r.node_id]
            node.tables[(cf_name, r.replica_id)] = type(t).from_columns(
                {c: v[1:] for c, v in t.key_cols.items()}, {c: v[1:] for c, v in t.value_cols.items()},
                t.layout, t.schema,
            )
            return out

        h.victim.scrub_column_family = scrub_then_drop
        report = h.run()
        assert not report.ok
        assert any("replicas disagree" in f for f in report.failures)


def test_views_schedule_holds_the_oracle_property():
    """``--views``: both engines device-resident with views; the heal
    audits every view against a fresh fold, an eligible count routes
    through the views, and the QUORUM count probes return the oracle's
    answers."""
    report = ChaosHarness(0, n_steps=14, views=True, device=CPU).run()
    assert report.ok, report.failures
    assert isinstance(report, ChaosReport)
    assert report.stats["view_hits"] > 0 and report.stats["view_rebuilds"] > 0


class TestOverload:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_shed_or_exact_under_overload(self, seed):
        report = OverloadHarness(seed, device=CPU).run()
        assert report.ok, report.failures
        s = report.stats
        refusals = (
            s["rejected_queue_full"] + s["rejected_throttle"] + s["rejected_bulkhead"]
            + s["shed_overload"] + s["shed_deadline"]
        )
        assert refusals > 0 and s["served_ok"] > 0

    def test_overload_exercises_the_ladder(self):
        report = OverloadHarness(0, device=CPU).run()
        assert report.ok, report.failures
        assert report.stats["hedged_batches"] > 0
        assert report.stats["consistency_degraded"] > 0

    @pytest.mark.parametrize("seed", [0, 5])
    def test_arrival_stream_equals_the_reference(self, seed):
        a, b = OverloadHarness(seed, device=CPU), OverloadHarness(seed, device=CPU)
        ref = RC.OverloadHarness(seed)

        def stream(h):
            return [
                (r.cf_name, r.arrival_s, r.deadline_s, r.priority, r.consistency, r.query.agg, r.query.value_col,
                 sorted((c, type(f).__name__, dataclasses.astuple(f)) for c, f in r.query.filters.items()))
                for r in h.requests
            ]

        assert stream(a) == stream(b) == stream(ref)
        assert [t for t, _ in a.timeline] == [t for t, _ in ref.timeline]


LAYOUTS = [("k0", "k1", "k2"), ("k1", "k2", "k0"), ("k2", "k0", "k1")]


def _pair(n_rows=1_000, seed=5, *, ticks=False, **kw):
    """The reference's engine and the port's, each with column family "cf"
    (with ``ticks``, each on its own package's ``TickClock`` scan timer)."""
    kc, vc, schema = generate_simulation(n_rows, 3, seed=seed)
    out = []
    for pkg, clock, extra in ((R, RefTickClock, {}), (T, PO.TickClock, {"device": CPU})):
        if ticks:
            extra["scan_timer"] = clock()
        eng = pkg.HREngine(n_nodes=6, **extra, **kw)
        eng.create_column_family(
            "cf", kc, vc, replication_factor=3, layouts=LAYOUTS, schema=pkg.KeySchema(dict(schema.bits)),
        )
        out.append(eng)
    return out


class TestFailureInjector:
    def test_duplicate_step_entries_both_fire(self):
        _, eng = _pair()
        inj = FailureInjector(FailurePlan(fail_at_steps=(5, 5), nodes=(0, 1)), eng)
        assert inj.maybe_fail(5)
        assert {e["node"] for e in inj.log} == {0, 1}
        assert all(n.alive for n in eng.nodes)
        assert not inj.maybe_fail(5)

    def test_open_outage_heals_at_duration_like_the_reference(self):
        ref, port = _pair()
        logs = []
        for eng, plan_cls, inj_cls in ((ref, RFail.FailurePlan, RFail.FailureInjector),
                                       (port, FailurePlan, FailureInjector)):
            inj = inj_cls(plan_cls(fail_at_steps=(3, 6), nodes=(0, 2), durations=(2, 0), transient=True), eng)
            states = []
            for step in range(9):
                inj.tick(step)
                states.append(([n.alive for n in eng.nodes], inj.open_outages))
            logs.append((states, [{k: v for k, v in e.items() if k != "recovery_s"} for e in inj.log],
                         eng.stats["hint_replays"]))
        assert logs[1] == logs[0]
        assert logs[1][0][3] == ([False] + [True] * 5, [{"node": 0, "recover_step": 5}])
        assert all(logs[1][0][-1][0])

    def test_legacy_plan_shape_unchanged(self):
        inj = FailureInjector(FailurePlan(fail_at_steps=(12,), nodes=(0,)), None)
        assert inj.maybe_fail(12)
        assert inj.log[0]["step"] == 12 and inj.log[0]["node"] == 0
        assert not inj.maybe_recover(13)


def test_straggler_tail_equals_the_reference():
    """``measure_tail`` with and without hedging around a slowed node, both
    engines on a tick scan timer: the same walls, so the same tails and
    hedged fractions."""
    ref, port = _pair(2_000, seed=6, ticks=True, result_cache=False)
    victim = port.column_families["cf"].replicas[0].node_id
    wl_ref = R.random_workload(np.random.default_rng(1), ref.column_families["cf"].schema, ["k0", "k1", "k2"], 24)
    wl_port = T.random_workload(np.random.default_rng(1), port.column_families["cf"].schema, ["k0", "k1", "k2"], 24)
    RStrag.inject_slowdown(ref, victim, 1e4)
    inject_slowdown(port, victim, 1e4)
    for hedge in (False, True):
        want = RStrag.measure_tail(ref, "cf", wl_ref, hedge=hedge, repeats=2)
        got = measure_tail(port, "cf", wl_port, hedge=hedge, repeats=2)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.hedged_fraction > 0
    clear_slowdowns(port)
    assert all(n.slowdown == 1.0 for n in port.nodes)


def test_harnesses_refuse_to_run_without_a_device_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChaosHarness(0, n_steps=2, n_rows=100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OverloadHarness(0, n_requests=8, n_rows=100)


def _python_m(module, *args):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run(
        [sys.executable, "-m", module, *args], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )


def test_chaos_cli(tmp_path):
    """``python -m repro_torch.ft.chaos``: 0 on a good run whose trace the
    report CLI renders; non-zero when the trace cannot be written."""
    trace = tmp_path / "chaos.jsonl"
    out = _python_m("repro_torch.ft.chaos", "--device", "cpu", "--seeds", "2", "--steps", "8", "--trace", str(trace))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "seed 0: OK" in out.stdout and "seed 1: OK" in out.stdout
    assert "trace: wrote" in out.stdout
    rep = _python_m("repro_torch.obs", str(trace), "--unit", "ticks")
    assert rep.returncode == 0 and "chaos.probe" in rep.stdout
    over = _python_m("repro_torch.ft.chaos", "--device", "cpu", "--overload", "--seeds", "1")
    assert over.returncode == 0 and "overload seed 0: OK" in over.stdout, over.stdout + over.stderr
    bad = _python_m(
        "repro_torch.ft.chaos", "--device", "cpu", "--seeds", "1", "--steps", "4",
        "--trace", str(tmp_path / "missing" / "t.jsonl"),
    )
    assert bad.returncode != 0
    if not torch.cuda.is_available():
        nocard = _python_m("repro_torch.ft.chaos", "--seeds", "1", "--steps", "4")
        assert nocard.returncode != 0 and "no CUDA device" in nocard.stderr
