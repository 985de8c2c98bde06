"""Deterministic chaos harness for the availability layer.

Jepsen-style fault scheduling scaled to the in-process cluster: a
seeded :class:`ChaosSchedule` draws a sequence of fault events —
transient node crashes, torn commit-log tails, bit-flip run corruption,
straggler slowdowns, aborted flushes — and :class:`ChaosHarness` applies
them to a *victim* engine while feeding the identical write/query
stream to a fault-free *oracle* engine. Between faults the harness
keeps reading at ``QUORUM`` so digest comparison, read repair,
failover retry and the accrual failure detector all run under fire.

The acceptance property (the whole point): **for any seeded fault
schedule, after the heal phase — hinted-handoff ``node_up`` for every
crashed node, a drain of aborted flushes, one ``scrub_column_family``
sweep — the victim's replicas are mutually row-identical and every
partition's dataset fingerprint equals the oracle's, and a full QUORUM
probe battery returns the oracle's answers.** Everything is
deterministic: same seed → same schedule → same repairs → same report.

``python -m repro_torch.ft.chaos --seeds 3 --steps 25`` runs the property
over several seeds; a nonzero exit code means a seed
violated it.

:class:`OverloadHarness` (``--overload``) is the serving-layer sibling:
instead of storage faults it drives a seeded Poisson arrival stream —
with burst windows (arrival rate × ~10) and slow-drain windows (node
slowdowns injected mid-run through the front door's virtual timeline) —
through a :class:`~repro_torch.serving.frontdoor.FrontDoor` over the victim.
Its acceptance property: **every request either answers identically to
the no-fault oracle or is *explicitly* refused** (rejected / shed /
deadline, each typed and counted in ``frontdoor.stats``), the
accounting balances, the queue never exceeds its bound, and the
overload is non-vacuous (at least one refusal actually happened) — no
silent slow requests, no unbounded queue growth. Unlike the storage
harness, its *counters* are not byte-stable across runs: the front
door's virtual clock consumes measured engine walls, so the split
between refusal kinds shifts with machine speed. The arrival stream
and the acceptance property are what a seed pins down.

Both harnesses double as the observability acceptance gate: each
``run()`` asserts that every typed refusal, degradation-rung
transition, and repair path is visible in the owning
:class:`~repro_torch.obs.metrics.MetricsRegistry` (the response-status
accounting must equal the counters, and the audit inventories —
``REFUSAL_COUNTERS`` / ``RUNG_COUNTERS`` on the front door,
``FAULT_COUNTERS`` / ``REPAIR_COUNTERS`` on the engine — must all
resolve in the registry catalog). Pass ``tracer=`` to record span
trees: the storage harness roots one ``chaos.probe`` tree per victim
QUORUM probe (with a :class:`~repro_torch.obs.trace.TickClock` tracer the
JSON-lines dump is byte-identical across runs of the same seed), and
the overload harness hands the tracer to its front door, whose
slow-query log keeps the K slowest request trees.
``--trace OUT.jsonl`` on the CLI dumps and re-validates the trace.

Victim and oracle are both port engines on the harness's ``device``
(CUDA unless the caller names another; ``device="cpu"`` runs the plain
PyTorch versions of the kernels). The oracle is the port's own
fault-free engine, and probes agree with it within a relative 1e-6, as
in the reference. Every probe the harness makes is a count. With
``views=True`` the float32 row order can make QUORUM digests disagree
between replicas now and then; those mismatches and their repairs are
the engine's and stay in ``stats``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import (
    CommitLog,
    HREngine,
    KeySchema,
    QUORUM,
    TransientFault,
    random_workload,
)
from repro_torch.core.engine import FAULT_COUNTERS, REPAIR_COUNTERS, VIEW_COUNTERS
from repro_torch.ft.detector import FailureDetector
from repro_torch.ft.straggler import clear_slowdowns, inject_slowdown
from repro_torch.obs import TickClock, Tracer, dump_jsonl, load_jsonl

__all__ = [
    "ChaosEvent",
    "ChaosSchedule",
    "ChaosHarness",
    "ChaosReport",
    "OverloadHarness",
    "OverloadReport",
    "KINDS",
]

KINDS = ("crash", "torn_tail", "corrupt_run", "slow_node", "flush_abort")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault. Fields are kind-specific: ``node_id`` for
    crash/slow_node/flush_abort, ``partition_id`` for torn_tail /
    corrupt_run, ``magnitude`` the slowdown factor or the corruption
    placement salt, ``duration`` the outage/slowdown length in steps."""

    step: int
    kind: str
    node_id: int = -1
    partition_id: int = -1
    magnitude: float = 0.0
    duration: int = 0


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """Seed-deterministic event sequence over a fixed step horizon."""

    seed: int
    n_steps: int
    n_nodes: int
    n_partitions: int
    events: tuple[ChaosEvent, ...]

    @classmethod
    def generate(
        cls,
        seed: int,
        *,
        n_steps: int = 30,
        n_nodes: int = 6,
        n_partitions: int = 4,
        rate: float = 0.35,
    ) -> "ChaosSchedule":
        """Draw one fault at each step with probability ``rate``. Crash
        outages are kept non-overlapping (at most one node down at a
        time) so an RF=3 partition always retains a read quorum — the
        regime hinted handoff is designed for; overlapping outages are
        ``recover_node``'s territory, tested separately."""
        rng = np.random.default_rng(seed)
        events: list[ChaosEvent] = []
        down: list[tuple[int, int]] = []  # inclusive crash intervals
        for step in range(n_steps):
            if rng.random() >= rate:
                continue
            kind = KINDS[int(rng.integers(len(KINDS)))]
            if kind == "crash":
                dur = int(rng.integers(1, 4))
                if any(not (step + dur < s or e < step) for s, e in down):
                    continue  # would overlap an open outage
                down.append((step, step + dur))
                events.append(
                    ChaosEvent(
                        step,
                        "crash",
                        node_id=int(rng.integers(n_nodes)),
                        duration=dur,
                    )
                )
            elif kind == "torn_tail":
                events.append(
                    ChaosEvent(
                        step,
                        "torn_tail",
                        partition_id=int(rng.integers(n_partitions)),
                    )
                )
            elif kind == "corrupt_run":
                events.append(
                    ChaosEvent(
                        step,
                        "corrupt_run",
                        partition_id=int(rng.integers(n_partitions)),
                        magnitude=float(rng.random()),
                    )
                )
            elif kind == "slow_node":
                events.append(
                    ChaosEvent(
                        step,
                        "slow_node",
                        node_id=int(rng.integers(n_nodes)),
                        magnitude=float(rng.uniform(20.0, 200.0)),
                        duration=int(rng.integers(2, 6)),
                    )
                )
            else:
                events.append(
                    ChaosEvent(
                        step,
                        "flush_abort",
                        node_id=int(rng.integers(n_nodes)),
                    )
                )
        return cls(
            seed=int(seed),
            n_steps=int(n_steps),
            n_nodes=int(n_nodes),
            n_partitions=int(n_partitions),
            events=tuple(events),
        )


@dataclasses.dataclass
class ChaosReport:
    seed: int
    ok: bool
    failures: list[str]
    n_events: int
    stats: dict


_CF = "chaos"
_REL_TOL = 1e-6  # replica layouts sum in different orders


class ChaosHarness:
    """Victim-vs-oracle chaos run (see module docstring)."""

    def __init__(
        self,
        seed: int,
        *,
        n_steps: int = 30,
        n_nodes: int = 6,
        n_partitions: int = 4,
        rate: float = 0.35,
        n_rows: int = 3000,
        write_rows: int = 120,
        n_probes: int = 8,
        probe_every: int = 5,
        memtable_rows: int = 200,
        views: bool = False,
        tracer: Tracer | None = None,
        device=None,
    ) -> None:
        self.tracer = tracer
        self.views = bool(views)
        self.schedule = ChaosSchedule.generate(
            seed,
            n_steps=n_steps,
            n_nodes=n_nodes,
            n_partitions=n_partitions,
            rate=rate,
        )
        self.write_rows = write_rows
        self.probe_every = probe_every
        rng = np.random.default_rng(seed + 1_000_003)  # data stream seed

        bits = {"k0": 12, "k1": 10, "k2": 8}
        self._dom = {c: 2**b for c, b in bits.items()}
        kc = {
            c: rng.integers(0, d, n_rows).astype(np.int64)
            for c, d in self._dom.items()
        }
        vc = {"metric": rng.uniform(0.0, 1.0, n_rows)}
        schema = KeySchema(bits=bits)
        self.probes = random_workload(
            rng, schema, list(kc), n_probes, value_col="metric"
        ).queries
        self._rng = rng

        cf_kwargs = dict(
            replication_factor=3,
            mechanism="HR",
            workload=random_workload(
                np.random.default_rng(0), schema, list(kc), 16, value_col="metric"
            ),
            schema=schema,
            hrca_kwargs={"k_max": 200, "seed": 0},
            partitions=n_partitions,
            memtable_rows=memtable_rows,
        )
        if self.views:
            # materialized-view chaos: BOTH engines go device-resident
            # with views so the oracle property stays exact — the view
            # serve path is bit-identical to the fused full scan, and
            # the heal phase additionally audits the derived partials
            cf_kwargs.update(device_resident=True, views=True)
        # deterministic scan walls: the detector's routing penalties —
        # and therefore which replica answers each probe — must be a
        # pure function of the schedule, or the same-seed traced runs
        # could not export byte-identical span trees
        self.victim = HREngine(
            n_nodes=n_nodes, failure_detector=FailureDetector(),
            scan_timer=TickClock(), device=device,
        )
        self.oracle = HREngine(n_nodes=n_nodes, device=device)
        self.victim.create_column_family(_CF, kc, vc, **cf_kwargs)
        self.oracle.create_column_family(_CF, kc, vc, **cf_kwargs)

        self._pending_up: dict[int, int] = {}  # node -> step to bring up
        self._slow_until: dict[int, int] = {}

    # -- event application --------------------------------------------------

    def _apply(self, ev: ChaosEvent) -> None:
        eng = self.victim
        cf = eng.column_families[_CF]
        if ev.kind == "crash":
            eng.fail_node(ev.node_id, transient=True)
            self._pending_up[ev.node_id] = ev.step + ev.duration
        elif ev.kind == "torn_tail":
            # reserialize the partition log with a torn frame appended:
            # the byte codec must drop exactly the torn tail
            part = cf.partitions[ev.partition_id]
            tear = CommitLog()
            tear.append({"k": np.array([0], np.int64)}, {})
            blob = part.commitlog.to_bytes() + tear.to_bytes()[:-3]
            restored = CommitLog.from_bytes(blob)
            if len(restored) != len(part.commitlog):
                raise AssertionError("torn tail ate a committed record")
            part.commitlog = restored
        elif ev.kind == "corrupt_run":
            part = cf.partitions[ev.partition_id]
            salt = int(ev.magnitude * 1e9)
            cands = [
                r
                for r in part.replicas
                if eng.nodes[r.node_id].alive
                and (cf.name, r.replica_id) in eng.nodes[r.node_id].tables
            ]
            if not cands:
                return
            r = cands[salt % len(cands)]
            arr = eng._table(cf, r).value_cols["metric"]
            if arr.size == 0 or arr.dtype != np.float64:
                return
            # one exponent-bit flip: silent on-disk corruption the
            # checksum (scrub) and value digests (QUORUM) must catch
            arr.view(np.int64)[salt % arr.size] ^= np.int64(1) << np.int64(62)
        elif ev.kind == "slow_node":
            inject_slowdown(eng, ev.node_id, ev.magnitude)
            self._slow_until[ev.node_id] = ev.step + ev.duration
        elif ev.kind == "flush_abort":
            eng.nodes[ev.node_id].flush_fault_budget += 1
        else:  # pragma: no cover - schedule only emits known kinds
            raise ValueError(f"unknown chaos kind {ev.kind!r}")

    def _write_batch(self) -> None:
        n = self.write_rows
        kc = {
            c: self._rng.integers(0, d, n).astype(np.int64)
            for c, d in self._dom.items()
        }
        vc = {"metric": self._rng.uniform(0.0, 1.0, n)}
        self.oracle.write(_CF, kc, vc)
        try:
            self.victim.write(_CF, kc, vc)
        except TransientFault:
            # an aborted flush: the rows are already committed to the
            # log and staged — a later flush (or the heal drain) lands
            # them
            pass

    def _probe(self, failures: list[str], tag: str) -> None:
        for qi, q in enumerate(self.probes):
            want, _ = self.oracle.read(_CF, q)
            root = None
            if self.tracer is not None:
                # one span tree per victim probe; with a TickClock
                # tracer these are byte-identical across runs of the
                # same seed (the dump is the determinism fixture)
                root = self.tracer.root("chaos.probe", tag=tag, probe=qi)
            try:
                got, _ = self.victim.read(
                    _CF, q, consistency=QUORUM, trace=root
                )
            except (TransientFault, RuntimeError) as exc:
                if root is not None:
                    root.end(error=type(exc).__name__)
                failures.append(f"{tag} probe {qi}: raised {exc!r}")
                continue
            finally:
                if root is not None and root.t_end is None:
                    root.end()
            if got.rows_matched != want.rows_matched:
                failures.append(
                    f"{tag} probe {qi}: rows {got.rows_matched} != "
                    f"{want.rows_matched}"
                )
            tol = _REL_TOL * max(1.0, abs(want.value))
            if abs(got.value - want.value) > tol:
                failures.append(
                    f"{tag} probe {qi}: value {got.value!r} != {want.value!r}"
                )

    # -- the run -------------------------------------------------------------

    def run(self) -> ChaosReport:
        sched = self.schedule
        by_step: dict[int, list[ChaosEvent]] = {}
        for ev in sched.events:
            by_step.setdefault(ev.step, []).append(ev)
        failures: list[str] = []

        for step in range(sched.n_steps):
            # due recoveries first: a node can return the same step
            # another event lands
            for nid, up_at in list(self._pending_up.items()):
                if step >= up_at:
                    self.victim.node_up(nid)
                    del self._pending_up[nid]
            for nid, until in list(self._slow_until.items()):
                if step >= until:
                    self.victim.nodes[nid].slowdown = 1.0
                    del self._slow_until[nid]
            for ev in by_step.get(step, ()):
                self._apply(ev)
            self._write_batch()
            if step and step % self.probe_every == 0:
                self._probe(failures, f"step {step}")

        # heal phase: hinted handoff for every open outage, straggler
        # flags cleared, aborted flushes drained, one scrub sweep
        for nid in range(sched.n_nodes):
            self.victim.node_up(nid)
        clear_slowdowns(self.victim)
        for node in self.victim.nodes:  # chaos window closed
            node.flush_fault_budget = 0
            node.read_fault_budget = 0
        self.victim.flush_memtables(_CF)
        self.oracle.flush_memtables(_CF)
        self.victim.scrub_column_family(_CF)

        # the oracle property
        cf_v = self.victim.column_families[_CF]
        cf_o = self.oracle.column_families[_CF]
        for part_v, part_o in zip(cf_v.partitions, cf_o.partitions):
            if (part_v.token_lo, part_v.token_hi) != (
                part_o.token_lo,
                part_o.token_hi,
            ):
                failures.append(
                    f"partition {part_v.partition_id}: ring diverged"
                )
                continue
            fps = {
                self.victim._table(cf_v, r).dataset_fingerprint()
                for r in part_v.replicas
            }
            if len(fps) != 1:
                failures.append(
                    f"partition {part_v.partition_id}: replicas disagree "
                    f"({len(fps)} distinct fingerprints)"
                )
                continue
            want_fp = self.oracle._table(
                cf_o, part_o.replicas[0]
            ).dataset_fingerprint()
            if fps != {want_fp}:
                failures.append(
                    f"partition {part_v.partition_id}: fingerprint != oracle"
                )
        self._probe(failures, "final")

        if self.views:
            # derived-state audit: after heal every live replica's
            # per-block partials must re-derive exactly from its
            # resident arrays, an always-eligible probe must route
            # through the view path (counted), and its answer must
            # still match the oracle bit-for-bit
            from repro_torch.core.storage.views import verify_views
            from repro_torch.core.workload import Query

            for part in cf_v.partitions:
                for r in part.replicas:
                    node = self.victim.nodes[r.node_id]
                    t = node.tables.get((_CF, r.replica_id))
                    if t is None or not node.alive:
                        continue
                    if not t.has_views or not verify_views(t):
                        failures.append(
                            f"replica {r.replica_id}: views diverged from "
                            "resident arrays after heal"
                        )
            hits0 = int(self.victim.stats["view_hits"])
            probe = Query(agg="count", filters={})
            want, _ = self.oracle.read(_CF, probe)
            got, _ = self.victim.read(_CF, probe)
            if got.value != want.value:
                failures.append(
                    f"view probe: count {got.value!r} != {want.value!r}"
                )
            if int(self.victim.stats["view_hits"]) <= hits0:
                failures.append(
                    "view probe: eligible count did not route through views"
                )
            # counter-balance: the heal phase rebuilt at least every
            # scrub-healed or log-rebuilt replica's views, and the
            # boundary-row counter only moves with hits
            st = self.victim.stats
            if st["view_boundary_rows"] and not st["view_hits"]:
                failures.append("view_boundary_rows moved without view_hits")

        # observability audit: every repair path and typed engine fault
        # the harness can provoke must resolve to a registry counter
        cat = set(self.victim.metrics.catalog())
        missing = [
            n
            for n in (*REPAIR_COUNTERS, *FAULT_COUNTERS.values(), *VIEW_COUNTERS)
            if n not in cat
        ]
        if missing:
            failures.append(
                f"registry catalog missing repair/fault counters: {missing}"
            )

        return ChaosReport(
            seed=sched.seed,
            ok=not failures,
            failures=failures,
            n_events=len(sched.events),
            stats=self.victim.stats,
        )


@dataclasses.dataclass
class OverloadReport:
    seed: int
    ok: bool
    failures: list[str]
    n_requests: int
    stats: dict


class OverloadHarness:
    """Front-door overload chaos: Poisson arrivals with burst and
    slow-drain windows, checked shed-or-exact against a no-fault oracle
    (see module docstring).

    Only *slowdown* faults are injected — never corruption: under queue
    pressure the front door degrades QUORUM to ONE, and a degraded read
    of a corrupted replica could legitimately diverge from the oracle.
    Overload correctness (every answer exact or explicitly refused) and
    corruption repair (:class:`ChaosHarness`) are separate properties.
    """

    def __init__(
        self,
        seed: int,
        *,
        n_requests: int = 400,
        n_rows: int = 3000,
        n_nodes: int = 6,
        n_partitions: int = 4,
        base_interarrival_s: float = 200e-6,
        burst_factor: float = 10.0,
        slowdown: float = 50.0,
        deadline_s: float = 50e-3,
        quorum_frac: float = 0.3,
        tracer: Tracer | None = None,
        device=None,
    ) -> None:
        from repro_torch.serving.frontdoor import FrontDoor, Request

        self.seed = int(seed)
        rng = np.random.default_rng(seed + 7_000_037)
        bits = {"k0": 12, "k1": 10, "k2": 8}
        dom = {c: 2**b for c, b in bits.items()}
        kc = {
            c: rng.integers(0, d, n_rows).astype(np.int64)
            for c, d in dom.items()
        }
        vc = {"metric": rng.uniform(0.0, 1.0, n_rows)}
        schema = KeySchema(bits=bits)
        cf_kwargs = dict(
            replication_factor=3,
            mechanism="HR",
            workload=random_workload(
                np.random.default_rng(0), schema, list(kc), 16, value_col="metric"
            ),
            schema=schema,
            hrca_kwargs={"k_max": 200, "seed": 0},
            partitions=n_partitions,
        )
        self.victim = HREngine(
            n_nodes=n_nodes,
            failure_detector=FailureDetector(),
            result_cache=False,
            device=device,
        )
        self.oracle = HREngine(n_nodes=n_nodes, result_cache=False, device=device)
        self.victim.create_column_family(_CF, kc, vc, **cf_kwargs)
        self.oracle.create_column_family(_CF, kc, vc, **cf_kwargs)

        queries = random_workload(
            rng, schema, list(kc), n_requests, value_col="metric"
        ).queries

        # Poisson arrivals; the middle third of the run is a burst
        # window (rate × burst_factor). Gaps are seeded draws, so the
        # whole stream replays bit-identically per seed.
        t = 0.0
        arrivals: list[float] = []
        burst_lo, burst_hi = n_requests // 3, 2 * n_requests // 3
        for i in range(n_requests):
            mean = base_interarrival_s / (
                burst_factor if burst_lo <= i < burst_hi else 1.0
            )
            t += float(rng.exponential(mean))
            arrivals.append(t)

        self.requests = [
            Request(
                _CF,
                q,
                arrival_s=arrivals[i],
                deadline_s=deadline_s,
                priority=int(rng.integers(0, 3)),
                consistency=QUORUM if rng.random() < quorum_frac else "ONE",
            )
            for i, q in enumerate(queries)
        ]
        # slow-drain window: while the burst is still queued, straggle
        # half the nodes; cleared later so the tail of the run recovers
        slow_at = arrivals[burst_lo]
        clear_at = arrivals[min(burst_hi + n_requests // 6, n_requests - 1)]
        slow_nodes = list(range(0, n_nodes, 2))
        self.timeline = [
            (
                slow_at,
                lambda: [
                    inject_slowdown(self.victim, n, slowdown) for n in slow_nodes
                ],
            ),
            (clear_at, lambda: clear_slowdowns(self.victim)),
        ]
        self.frontdoor = FrontDoor(
            self.victim,
            max_batch=16,
            max_wait=base_interarrival_s * 4,
            max_queue=96,
            bulkhead_inflight=64,
            tracer=tracer,
        )

    def run(self) -> OverloadReport:
        failures: list[str] = []
        responses = self.frontdoor.serve(self.requests, timeline=self.timeline)
        stats = self.frontdoor.stats
        refused = 0
        for i, (req, resp) in enumerate(zip(self.requests, responses)):
            if resp is None:
                failures.append(f"request {i}: no response at all")
                continue
            if resp.ok:
                want, _ = self.oracle.read(_CF, req.query)
                tol = _REL_TOL * max(1.0, abs(want.value))
                if (
                    resp.result.rows_matched != want.rows_matched
                    or abs(resp.result.value - want.value) > tol
                ):
                    failures.append(
                        f"request {i}: served {resp.result.value!r} != "
                        f"oracle {want.value!r}"
                    )
                if (
                    req.deadline_s is not None
                    and resp.latency_s > req.deadline_s
                ):
                    failures.append(
                        f"request {i}: silently slow ok answer "
                        f"({resp.latency_s * 1e3:.1f} ms > budget)"
                    )
            else:
                refused += 1
                if resp.status not in ("rejected", "shed", "deadline"):
                    failures.append(
                        f"request {i}: unknown terminal status {resp.status!r}"
                    )
                if not resp.error:
                    failures.append(f"request {i}: untyped refusal")
        answered = sum(1 for r in responses if r is not None and r.ok)
        if answered + refused != len(self.requests):
            failures.append(
                f"accounting leak: {answered} ok + {refused} refused != "
                f"{len(self.requests)} submitted"
            )
        # observability audit: the response-status accounting must be
        # mirrored exactly in the registry counters — a refusal or rung
        # transition the counters cannot see is a silent path
        from repro_torch.serving.frontdoor import REFUSAL_COUNTERS, RUNG_COUNTERS

        by = {
            s: sum(1 for r in responses if r is not None and r.status == s)
            for s in ("ok", "rejected", "shed", "deadline")
        }
        mirror = (
            ("ok responses", by["ok"], stats["served_ok"]),
            (
                "rejected responses",
                by["rejected"],
                stats["rejected_throttle"]
                + stats["rejected_bulkhead"]
                + stats["rejected_queue_full"],
            ),
            ("shed responses", by["shed"], stats["shed_overload"]),
            ("deadline responses", by["deadline"], stats["shed_deadline"]),
            (
                "degraded responses",
                sum(1 for r in responses if r is not None and r.degraded),
                stats["consistency_degraded"],
            ),
        )
        for what, seen, counted in mirror:
            if seen != counted:
                failures.append(
                    f"counter mirror broken: {seen} {what} but the "
                    f"registry counted {counted}"
                )
        cat = set(self.frontdoor.metrics.catalog())
        missing = sorted(
            (set(REFUSAL_COUNTERS.values()) | set(RUNG_COUNTERS.values())) - cat
        )
        if missing:
            failures.append(
                f"registry catalog missing refusal/rung counters: {missing}"
            )
        if stats["max_queue_depth"] > self.frontdoor.max_queue:
            failures.append(
                f"queue grew past its bound "
                f"({stats['max_queue_depth']} > {self.frontdoor.max_queue})"
            )
        if refused == 0:
            failures.append(
                "vacuous run: the overload never forced a single refusal"
            )
        return OverloadReport(
            seed=self.seed,
            ok=not failures,
            failures=failures,
            n_requests=len(self.requests),
            stats=stats,
        )


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3, help="run seeds 0..N-1")
    ap.add_argument("--seed", type=int, default=None, help="run one seed")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--rate", type=float, default=0.35)
    ap.add_argument(
        "--overload",
        action="store_true",
        help="front-door overload scenario (shed-or-exact property) "
        "instead of the storage-fault schedule",
    )
    ap.add_argument(
        "--views",
        action="store_true",
        help="run the storage-fault schedule on device-resident column "
        "families with materialized aggregate views: every view-routed "
        "answer must stay bit-identical to the no-fault oracle and the "
        "view partials must verify after heal",
    )
    ap.add_argument(
        "--trace",
        metavar="OUT.jsonl",
        default=None,
        help="record span trees and dump them as JSON-lines (storage "
        "mode: one TickClock tree per QUORUM probe, byte-identical per "
        "seed; overload mode: the front door's slowest request trees); "
        "the dump is re-validated and an empty or malformed trace "
        "fails the run",
    )
    ap.add_argument(
        "--device",
        default=None,
        help="torch device of both engines (default: cuda; cpu runs the "
        "plain versions of the kernels)",
    )
    args = ap.parse_args(argv)

    seeds = [args.seed] if args.seed is not None else list(range(args.seeds))
    bad = 0
    traced: list = []  # (latency, Span) pairs or bare Spans, all seeds

    def _dump_trace() -> int:
        """Write + re-validate the trace dump; nonzero on a bad dump."""
        if args.trace is None:
            return 0
        n = dump_jsonl(traced, args.trace)
        try:
            docs = load_jsonl(args.trace)
        except ValueError as e:
            print(f"trace: INVALID dump: {e}")
            return 1
        if not docs:
            print(f"trace: EMPTY dump at {args.trace} — no span trees recorded")
            return 1
        print(f"trace: wrote {n} span trees to {args.trace}")
        return 0

    if args.overload:
        for seed in seeds:
            tracer = Tracer() if args.trace is not None else None
            harness = OverloadHarness(seed, tracer=tracer, device=args.device)
            report = harness.run()
            if tracer is not None:
                traced.extend(harness.frontdoor.slow_log.entries())
            s = report.stats
            counters = ", ".join(
                f"{k}={int(s[k])}"
                for k in (
                    "served_ok",
                    "rejected_queue_full",
                    "rejected_bulkhead",
                    "shed_overload",
                    "shed_deadline",
                    "consistency_degraded",
                    "hedged_batches",
                    "batches",
                )
            )
            print(
                f"overload seed {seed}: {'OK' if report.ok else 'FAIL'} "
                f"({report.n_requests} requests; {counters})"
            )
            for f in report.failures:
                print(f"  - {f}")
            bad += not report.ok
        bad += _dump_trace()
        return 1 if bad else 0
    for seed in seeds:
        # a fresh TickClock tracer per seed: span ids and timestamps
        # restart, so the per-seed dump is byte-stable across runs
        tracer = Tracer(clock=TickClock()) if args.trace is not None else None
        harness = ChaosHarness(
            seed, n_steps=args.steps, rate=args.rate, tracer=tracer,
            views=args.views, device=args.device,
        )
        report = harness.run()
        if tracer is not None:
            traced.extend(tracer.roots)
        keys = (
            "hints_queued",
            "hint_replays",
            "hint_fallbacks",
            "digest_mismatches",
            "read_repairs",
            "read_retries",
            "scrub_repairs",
        )
        if args.views:
            keys += ("view_hits", "view_rebuilds")
        counters = ", ".join(f"{k}={report.stats[k]}" for k in keys)
        print(
            f"seed {seed}: {'OK' if report.ok else 'FAIL'} "
            f"({report.n_events} events; {counters})"
        )
        for f in report.failures:
            print(f"  - {f}")
        bad += not report.ok
    bad += _dump_trace()
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
