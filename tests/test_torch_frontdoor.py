"""The port's serving front door (``repro_torch.serving``: continuous
batching, admission control, deadlines, the degradation ladder) over the
port's engine on ``device="cpu"``, against the reference's
(``repro.serving``) over the reference engine.

Mirrors ``tests/test_frontdoor.py`` on the port, and adds the parity
cases: one seeded request stream (Poisson arrivals with a burst window,
priorities, deadlines, 30 % QUORUM) goes to both front doors, each over
its own package's engine whose scan timer is its package's ``TickClock``
with each tick worth 1e6 virtual seconds, and the stream in the same
unit. A batch's virtual service time, the larger of its measured wall and
the walls the engine reports, is then the tick-counted walls whatever the
machine's load, so the timeline depends on the stream alone, and every admission,
batching, ladder and shedding decision must come out the same: each
request's status, latency and queue wait, the counters, and the answers
(counts exact, sums within rtol 1e-5 / atol 1e-3). On a device-resident
family, QUORUM requests are counts and selects: a float32 sum's digest
depends on each backend's reduction order (ROADMAP Queue 3).
"""

import collections
import io

import numpy as np
import pytest

import repro.core as R
import repro.obs as RO
import repro_torch.core as T
import repro_torch.obs as PO
from repro.core.tpch import generate_simulation
from repro.serving import frontdoor as RF
from repro_torch.ft.detector import LatencyEWMA
from repro_torch.serving import Bulkhead, FrontDoor, Request, RetryAfter, TokenBucket
from repro_torch.serving import frontdoor as TF

LAYOUTS = [("k0", "k1", "k2"), ("k1", "k2", "k0"), ("k2", "k0", "k1")]
RTOL, ATOL = 1e-5, 1e-3


def _engine(kc, vc, schema, *, partitions=1, rf=3, n_nodes=6, pkg=T, **kw):
    kw.setdefault("result_cache", False)
    if pkg is T:
        kw.setdefault("device", "cpu")
    eng = pkg.HREngine(n_nodes=n_nodes, **kw)
    eng.create_column_family(
        "cf", kc, vc, replication_factor=rf, layouts=LAYOUTS[:rf],
        schema=pkg.KeySchema(dict(schema.bits)), partitions=partitions,
    )
    return eng


def _requests(rng, schema, n, *, spacing=0.0, **kw):
    hi = schema.max_value("k0") + 1
    return [
        Request("cf", T.Query({"k0": T.Eq(int(rng.integers(0, hi)))}), arrival_s=i * spacing, **kw)
        for i in range(n)
    ]


def _accounted(fd, resps):
    """Every submitted request reached exactly one terminal state."""
    by = {s: sum(1 for r in resps if r.status == s) for s in ("ok", "rejected", "shed", "deadline")}
    s = fd.stats
    assert by["ok"] == s["served_ok"]
    assert by["rejected"] == s["rejected_throttle"] + s["rejected_bulkhead"] + s["rejected_queue_full"]
    assert by["shed"] == s["shed_overload"]
    assert by["deadline"] == s["shed_deadline"]
    assert sum(by.values()) == len(resps) == s["submitted"]


class TestAdmissionPrimitives:
    def test_token_bucket_burst_then_rate(self):
        tb = TokenBucket(rate=10.0, burst=3.0)
        for _ in range(3):
            tb.admit(0.0)
        with pytest.raises(RetryAfter) as e:
            tb.admit(0.0)
        assert e.value.retry_after_s == pytest.approx(0.1) and e.value.kind == "rate"
        tb.admit(0.1)
        with pytest.raises(RetryAfter):
            tb.admit(0.1)

    def test_token_bucket_clock_never_runs_backwards(self):
        tb = TokenBucket(rate=1.0, burst=1.0)
        tb.admit(10.0)
        with pytest.raises(RetryAfter):
            tb.admit(0.0)

    def test_bulkhead_isolates_compartments(self):
        bh = Bulkhead(2, retry_after_s=0.5)
        bh.acquire("hot")
        bh.acquire("hot")
        with pytest.raises(RetryAfter) as e:
            bh.acquire("hot")
        assert e.value.kind == "bulkhead"
        bh.acquire("cold")
        bh.release("hot")
        bh.acquire("hot")
        assert bh.inflight("hot") == 2
        with pytest.raises(RuntimeError):
            bh.release("absent")

    def test_latency_ewma_tracks_mean_and_spread(self):
        ew = LatencyEWMA(alpha=0.5)
        assert ew.mean() == 0.0 and ew.count == 0
        for x in (1.0, 1.0, 1.0):
            ew.record(x)
        assert ew.mean() == pytest.approx(1.0)
        ew.record(3.0)
        assert 1.0 < ew.mean() < 3.0 and ew.deviation() > 0.0

    def test_constructor_validation(self):
        with pytest.raises(ValueError):
            TokenBucket(rate=0.0, burst=1.0)
        with pytest.raises(ValueError):
            Bulkhead(0, retry_after_s=1.0)
        with pytest.raises(ValueError):
            Request("cf", T.Query({}), consistency="MOST")
        with pytest.raises(ValueError):
            Request("cf", T.Query({}), arrival_s=-1.0)
        eng = object.__new__(T.HREngine)
        with pytest.raises(ValueError):
            FrontDoor(eng, max_batch=0)
        with pytest.raises(ValueError):
            FrontDoor(eng, max_batch=8, max_queue=4)
        with pytest.raises(ValueError):
            FrontDoor(eng, shed_fill=0.0)
        with pytest.raises(ValueError):
            FrontDoor(eng, max_wait=0.0)


class TestContinuousBatching:
    def test_ok_answers_match_direct_engine(self, rng):
        kc, vc, schema = generate_simulation(3_000, 3, seed=0)
        eng = _engine(kc, vc, schema, partitions=4)
        fd = FrontDoor(eng, max_batch=8, max_wait=1e-3, max_queue=64)
        reqs = _requests(rng, schema, 30, spacing=2e-4)
        resps = fd.serve(reqs)
        assert all(r.ok for r in resps)
        for req, r in zip(reqs, resps):
            assert r.result.value == eng.read("cf", req.query)[0].value
        _accounted(fd, resps)

    def test_batch_launches_when_full(self, rng):
        kc, vc, schema = generate_simulation(1_000, 3, seed=0)
        fd = FrontDoor(_engine(kc, vc, schema), max_batch=4, max_wait=10.0, max_queue=64)
        resps = fd.serve(_requests(rng, schema, 12))
        assert all(r.ok for r in resps)
        assert fd.stats["batches"] == 3
        assert all(r.queue_wait_s < 10.0 for r in resps)

    def test_batch_launches_on_max_wait_timer(self, rng):
        kc, vc, schema = generate_simulation(1_000, 3, seed=0)
        fd = FrontDoor(_engine(kc, vc, schema), max_batch=64, max_wait=5e-3, max_queue=64)
        resps = fd.serve(_requests(rng, schema, 3))
        assert all(r.ok for r in resps)
        assert fd.stats["batches"] == 1
        assert all(r.queue_wait_s == pytest.approx(5e-3) for r in resps)

    def test_inflight_arrivals_join_next_batch(self, rng):
        kc, vc, schema = generate_simulation(2_000, 3, seed=0)
        fd = FrontDoor(_engine(kc, vc, schema), max_batch=4, max_wait=1e-4, max_queue=64)
        reqs = _requests(rng, schema, 4) + _requests(rng, schema, 4, spacing=1e-6)
        resps = fd.serve(reqs)
        assert all(r.ok for r in resps)
        assert 2 <= fd.stats["batches"] <= 3
        _accounted(fd, resps)

    def test_empty_input(self, rng):
        kc, vc, schema = generate_simulation(500, 3, seed=0)
        assert FrontDoor(_engine(kc, vc, schema)).serve([]) == []


class TestAdmissionGuards:
    def test_queue_bound_rejects_with_backpressure(self, rng):
        kc, vc, schema = generate_simulation(1_000, 3, seed=0)
        fd = FrontDoor(_engine(kc, vc, schema), max_batch=4, max_wait=10.0, max_queue=8)
        resps = fd.serve(_requests(rng, schema, 20))
        assert fd.stats["rejected_queue_full"] > 0
        assert fd.stats["max_queue_depth"] <= 8
        assert all(r.retry_after_s > 0.0 for r in resps if r.status == "rejected")
        _accounted(fd, resps)

    def test_token_bucket_throttles_offered_rate(self, rng):
        kc, vc, schema = generate_simulation(1_000, 3, seed=0)
        fd = FrontDoor(_engine(kc, vc, schema), max_batch=4, max_wait=1e-3, max_queue=64, rate=100.0, burst=2.0)
        resps = fd.serve(_requests(rng, schema, 10, spacing=1e-4))
        assert fd.stats["rejected_throttle"] == 10 - fd.stats["admitted"]
        assert fd.stats["rejected_throttle"] >= 6
        _accounted(fd, resps)

    def test_bulkhead_keeps_hot_cf_from_starving_cold(self, rng):
        kc, vc, schema = generate_simulation(2_000, 3, seed=0)
        eng = _engine(kc, vc, schema)
        kc2, vc2, schema2 = generate_simulation(1_000, 3, seed=1)
        eng.create_column_family(
            "cold", kc2, vc2, replication_factor=3, layouts=LAYOUTS,
            schema=T.KeySchema(dict(schema2.bits)), partitions=1,
        )
        fd = FrontDoor(eng, max_batch=32, max_wait=10.0, max_queue=64, bulkhead_inflight=3)
        hot = _requests(rng, schema, 10)
        cold = [Request("cold", T.Query({"k0": T.Eq(int(rng.integers(0, 4)))})) for _ in range(3)]
        resps = fd.serve(hot + cold)
        assert fd.stats["rejected_bulkhead"] == 10 - 3
        assert all(r.ok for r in resps[10:])
        _accounted(fd, resps)

    def test_bulkhead_compartments_by_pinned_partition(self, rng):
        kc, vc, schema = generate_simulation(2_000, 3, seed=0)
        eng = _engine(kc, vc, schema, partitions=4)
        fd = FrontDoor(eng, bulkhead_inflight=4)
        comps = {fd._compartment(r) for r in _requests(rng, schema, 16)}
        # leading-key equalities pin one partition each; the whole range fans out
        assert all(c[0] == "cf" and c[1] >= 0 for c in comps) and len(comps) > 1
        assert fd._compartment(Request("cf", T.Query({}))) == ("cf", -1)


class TestDegradationLadder:
    def test_priority_shed_drops_lowest_first(self, rng):
        kc, vc, schema = generate_simulation(1_000, 3, seed=0)
        fd = FrontDoor(_engine(kc, vc, schema), max_batch=4, max_wait=10.0, max_queue=16, shed_fill=0.5)
        reqs = _requests(rng, schema, 8, priority=1) + _requests(rng, schema, 8, priority=0)
        resps = fd.serve(reqs)
        assert fd.stats["shed_overload"] > 0
        assert all(r.ok for r in resps[:8])
        assert all(r.status == "shed" for r in resps if not r.ok)
        _accounted(fd, resps)

    def test_degrades_quorum_to_one_under_pressure_and_recovers(self, rng):
        kc, vc, schema = generate_simulation(2_000, 3, seed=0)
        fd = FrontDoor(
            _engine(kc, vc, schema), max_batch=4, max_wait=1e-6, max_queue=256, degrade_wait_factor=1.0,
        )
        burst = _requests(rng, schema, 24, consistency=T.QUORUM)
        late = Request("cf", _requests(rng, schema, 1)[0].query, arrival_s=1e9, consistency=T.QUORUM)
        resps = fd.serve(burst + [late])
        s = fd.stats
        assert s["consistency_degraded"] > 0 and s["degraded_batches"] > 0
        assert s["degrade_recoveries"] >= 1
        degraded = [r for r in resps[:-1] if r.degraded]
        assert degraded and all(r.consistency_used == T.ONE and r.ok for r in degraded)
        assert resps[-1].ok and not resps[-1].degraded and resps[-1].consistency_used == T.QUORUM
        _accounted(fd, resps)

    def test_hedges_fire_from_queue_wait_ewma(self, rng):
        kc, vc, schema = generate_simulation(2_000, 3, seed=0)
        fd = FrontDoor(
            _engine(kc, vc, schema), max_batch=4, max_wait=1e-6, max_queue=256,
            hedge_wait_factor=1.0, ewma_warmup=4,
        )
        resps = fd.serve(_requests(rng, schema, 32))
        assert fd.stats["hedged_batches"] > 0
        assert all(r.ok for r in resps)
        _accounted(fd, resps)

    def test_spent_deadline_sheds_explicitly(self, rng):
        kc, vc, schema = generate_simulation(1_000, 3, seed=0)
        fd = FrontDoor(_engine(kc, vc, schema), max_batch=8, max_wait=1e-3, max_queue=64)
        reqs = _requests(rng, schema, 4, deadline_s=1e-12) + _requests(rng, schema, 4, deadline_s=1e3)
        resps = fd.serve(reqs)
        assert all(r.status == "deadline" and "deadline" in r.error for r in resps[:4])
        assert all(r.ok for r in resps[4:])
        assert fd.stats["shed_deadline"] == 4
        _accounted(fd, resps)

    def test_timeline_callbacks_fire_in_virtual_time(self, rng):
        kc, vc, schema = generate_simulation(1_000, 3, seed=0)
        fd = FrontDoor(_engine(kc, vc, schema), max_batch=2, max_wait=1e-3, max_queue=64)
        fired: list[float] = []
        resps = fd.serve(
            _requests(rng, schema, 4, spacing=1.0),
            timeline=[(2.5, lambda: fired.append(2.5)), (0.5, lambda: fired.append(0.5))],
        )
        assert fired == [0.5, 2.5]
        assert all(r.ok for r in resps)


# -- the same stream through both front doors ----------------------------------------------


TICK = 1e6  # virtual seconds a scan-timer tick is worth


class _Ticks:
    """A package's ``TickClock``, each tick worth ``TICK``."""

    def __init__(self, clock):
        self.clock = clock

    def __call__(self) -> float:
        return self.clock() * TICK


def _stream(pkg, request_cls, schema, n, seed, *, quorum_sums=True):
    """Seeded Poisson arrivals (mean gap 1 tick, a tenth of it in the
    middle third), mixed sums, counts and selects, three priorities,
    deadlines of 6, 40 and 1e9 ticks, 30 % at QUORUM."""
    rng = np.random.default_rng(seed)
    doms = {c: schema.max_value(c) + 1 for c in ("k0", "k1", "k2")}
    t, out = 0.0, []
    for i in range(n):
        t += TICK * float(rng.exponential(0.1 if n // 3 <= i < 2 * n // 3 else 1.0))
        agg = ("sum", "count", "select")[int(rng.integers(3))]
        if rng.random() < 0.5:
            f = {"k0": pkg.Eq(int(rng.integers(doms["k0"])))}
        else:
            lo = int(rng.integers(doms["k1"] - 1))
            f = {"k1": pkg.Range(lo, lo + 2)}
        deadline = TICK * float(rng.choice([6.0, 40.0, 1e9]))
        priority = int(rng.integers(3))
        quorum = rng.random() < 0.3 and (quorum_sums or agg != "sum")
        out.append(request_cls(
            "cf", pkg.Query(filters=f, agg=agg, value_col="metric" if agg == "sum" else None),
            arrival_s=t, deadline_s=deadline, priority=priority, consistency="QUORUM" if quorum else "ONE",
        ))
    return out


def _serve_both(*, partitions, device_resident=False, n=200, **fd_kw):
    kc, vc, schema = generate_simulation(2_000, 3, seed=0)
    out = []
    for pkg, obs, fd_mod, extra in ((R, RO, RF, {}), (T, PO, TF, {"device": "cpu"})):
        eng = pkg.HREngine(n_nodes=6, result_cache=False, scan_timer=_Ticks(obs.TickClock()), **extra)
        eng.create_column_family(
            "cf", kc, vc, replication_factor=3, layouts=LAYOUTS, schema=pkg.KeySchema(dict(schema.bits)),
            partitions=partitions, device_resident=device_resident,
        )
        fd = fd_mod.FrontDoor(eng, tracer=obs.Tracer(clock=obs.TickClock()), **fd_kw)
        reqs = _stream(pkg, fd_mod.Request, schema, n, 5, quorum_sums=not device_resident)
        out.append((fd, fd.serve(reqs), obs))
    return out


@pytest.mark.parametrize(
    "case",
    [dict(partitions=4), dict(partitions=1), dict(partitions=1, device_resident=True)],
    ids=["host-P4", "host-P1", "device-P1"],
)
def test_same_stream_same_decisions_as_the_reference(case):
    kw = dict(max_batch=8, max_wait=2 * TICK, max_queue=32, rate=4 / TICK, burst=16.0, bulkhead_inflight=16)
    (rfd, rresp, ro), (pfd, presp, po) = _serve_both(**case, **kw)
    statuses = [r.status for r in presp]
    assert statuses == [r.status for r in rresp]
    # the stream is not vacuous: answers and at least two kinds of refusal
    seen = collections.Counter(statuses)
    assert seen["ok"] > 0 and sum(seen[k] > 0 for k in ("rejected", "shed", "deadline")) >= 2, seen
    assert pfd.stats == rfd.stats
    assert pfd.stats["hedged_batches"] > 0 and pfd.stats["consistency_degraded"] > 0
    _accounted(pfd, presp)
    for i, (a, b) in enumerate(zip(rresp, presp)):
        assert (b.latency_s, b.queue_wait_s, b.degraded, b.consistency_used, b.retry_after_s) == (
            a.latency_s, a.queue_wait_s, a.degraded, a.consistency_used, a.retry_after_s,
        ), i
        assert (a.error is None) == (b.error is None)
        if a.ok:
            assert b.result.rows_matched == a.result.rows_matched
            assert b.result.value == pytest.approx(a.result.value, rel=RTOL, abs=ATOL)
            if a.result.selected is not None:
                np.testing.assert_array_equal(b.result.selected, a.result.selected)
            assert (b.report.replica_id, b.report.node_id) == (a.report.replica_id, a.report.node_id)
    # the slow-query logs keep the same requests, and their trees export alike
    assert [(lat, s.attrs["idx"]) for lat, s in pfd.slow_log.entries()] == [
        (lat, s.attrs["idx"]) for lat, s in rfd.slow_log.entries()
    ]
    if not case.get("device_resident"):
        ba, bb = io.StringIO(), io.StringIO()
        ro.dump_jsonl(rfd.tracer.roots, ba)
        po.dump_jsonl(pfd.tracer.roots, bb)
        assert bb.getvalue() == ba.getvalue()


def test_frontdoor_refuses_to_run_without_a_device_unless_told(monkeypatch):
    """The front door takes an engine; the engine refuses CUDA when there
    is none, so nothing falls back to the CPU unasked."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FrontDoor(T.HREngine())
    assert FrontDoor(T.HREngine(device="cpu")).engine.device.type == "cpu"
