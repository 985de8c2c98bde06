"""Overload-safe serving front door: continuous batching with admission
control, deadlines, and graceful degradation.

Everything below :meth:`HREngine.read_many` is batched and
fault-tolerant, but callers hand it pre-built query lists. This module
is the missing serving layer: single queries arrive with per-request
deadlines and priorities, the front door coalesces them into dynamic
``read_many`` batches (continuous batching — a batch launches when
``max_batch`` fills or ``max_wait`` expires, and requests arriving
while a batch is in flight join the *next* batch), and a stack of
overload guards keeps the engine answerable when offered load exceeds
capacity.

The degradation ladder
======================

Pressure is measured in queue-wait units of ``max_wait`` (the knob the
operator already reasons in). Each rung engages at a higher threshold
and disengages automatically when the queue drains — recovery needs no
operator action:

1. **Hedge** (``queue-wait EWMA > hedge_wait_factor × max_wait``,
   default 1.5×): batches launch with hedged reads so one straggler
   node stops stretching every batch. Observed queue latency — the
   :class:`~repro_torch.ft.detector.LatencyEWMA` feed — drives this, not a
   static per-call ``hedge_ratio``.
2. **Degrade** (``oldest queued wait > degrade_wait_factor ×
   max_wait``, default 4×): QUORUM/ALL requests in the batch are
   served at ONE, each counted in ``stats["consistency_degraded"]``
   and flagged ``degraded=True`` on its response. Latency is bought
   with consistency, openly (Zhu et al.; McKenzie et al. — the
   consistency level as a latency dial).
3. **Shed** (``queue depth > shed_fill × max_queue``, default 0.9×):
   the lowest-priority, youngest requests are dropped with an explicit
   ``shed`` response until the backlog is back at the threshold.
   Priority decides who pays for overload; nobody waits unboundedly.
4. **Deadline** (always on): a request whose budget is already spent
   at launch is shed before wasting engine work; the remaining batch
   budget is threaded into the engine (``deadline_s``), where required
   work raises :class:`~repro_torch.core.DeadlineExceeded` and optional work
   (hedges) is skipped; a request whose answer lands after its budget
   gets a ``deadline`` response, not a silently slow answer.

Ahead of the ladder sit the admission guards
(:mod:`repro_torch.serving.admission`): a token bucket (rate + burst) and
per-``(column family, pinned partition)`` bulkheads, both rejecting
with :class:`~repro_torch.serving.admission.RetryAfter` instead of queuing
without bound; a full queue likewise rejects at admission. Every
decision on every rung increments a ``frontdoor.stats`` counter.

Observability
=============

The decision counters live on a
:class:`~repro_torch.obs.metrics.MetricsRegistry` (``stats`` is a
read-through dict view; ``reset_stats()`` is one registry reset), and
the registry additionally carries virtual-time latency histograms
(``queue_wait_seconds``, ``request_latency_seconds``,
``batch_service_seconds``). :data:`REFUSAL_COUNTERS` and
:data:`RUNG_COUNTERS` are the audit inventories: every typed refusal
kind and every ladder rung maps onto a registry counter name, and a
test walks those inventories against the catalog.

Pass ``tracer=`` (a :class:`~repro_torch.obs.trace.Tracer`) to record one
``frontdoor.request`` span tree per request: admission → queue →
shed/service children at *virtual* timestamps, with the engine subtree
(``engine.read_many`` down to ``kernel.scan_launch``) hanging under
the ``frontdoor.service`` span when the launched group has one member,
or under a shared ``frontdoor.batch`` root (cross-linked by a
``batch`` attribute) when several requests coalesce. Completed trees
feed a :class:`~repro_torch.obs.export.SlowQueryLog` keeping the K slowest
by virtual latency. Frontdoor span timestamps are virtual-clock
quantities; engine/kernel spans below them use the tracer's own clock,
so within one tree the frontdoor stage walls (queue + service) sum to
the client-observed ``latency_s`` while engine spans carry honest
measured walls.

Determinism
===========

The front door runs a single-threaded discrete-event loop over a
*virtual* clock: requests carry arrival timestamps, queue waits and
latency percentiles are virtual-time quantities, and a ``timeline`` of
``(virtual_time, callback)`` events injects faults mid-run (the chaos
harness drives node slowdowns this way). Engine calls are real — a
batch's virtual service time is the larger of its measured wall and
the engine-reported per-query walls, so an injected straggler slows
the virtual drain exactly as it inflates reported walls. Given a
fixed arrival stream and fixed service times every scheduling,
admission, degradation, and shedding decision is reproducible — but
service times are *measured*, so counters shift with machine speed
between runs; what is invariant is the acceptance contract (every
request answers correctly or is explicitly refused), not the exact
split between refusal kinds.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

from repro_torch.core import (
    CONSISTENCY_LEVELS,
    DeadlineExceeded,
    HREngine,
    ONE,
    Query,
    ReadReport,
    ScanResult,
    slab_bounds_many,
)
from repro_torch.ft.detector import LatencyEWMA
from repro_torch.obs import MetricsRegistry, SlowQueryLog, Span, Tracer
from repro_torch.serving.admission import Bulkhead, RetryAfter, TokenBucket

__all__ = [
    "FrontDoor",
    "Request",
    "Response",
    "FRONTDOOR_COUNTERS",
    "REFUSAL_COUNTERS",
    "RUNG_COUNTERS",
]

#: response statuses — every request ends in exactly one of these
OK = "ok"
REJECTED = "rejected"  # refused at admission (RetryAfter)
SHED = "shed"  # dropped under overload (priority shed)
DEADLINE = "deadline"  # budget spent (DeadlineExceeded)

#: every decision counter the front door maintains, in ``stats`` order
#: (``max_queue_depth`` is a high-water :class:`~repro_torch.obs.metrics.Gauge`,
#: the rest are counters)
FRONTDOOR_COUNTERS = (
    "submitted",
    "admitted",
    "served_ok",
    "rejected_throttle",
    "rejected_bulkhead",
    "rejected_queue_full",
    "shed_overload",
    "shed_deadline",
    "consistency_degraded",
    "degraded_batches",
    "degrade_recoveries",
    "hedged_batches",
    "batches",
)

#: typed-refusal audit inventory: every :class:`RetryAfter` ``kind``
#: (plus the front door's own queue-bound refusal) and the two
#: non-admission refusal paths map onto a registry counter — the
#: coverage test walks this against the registry catalog
REFUSAL_COUNTERS = {
    "rate": "rejected_throttle",  # TokenBucket RetryAfter
    "bulkhead": "rejected_bulkhead",  # Bulkhead RetryAfter
    "queue": "rejected_queue_full",  # queue-bound RetryAfter
    "shed": "shed_overload",  # priority shed (rung 3)
    "deadline": "shed_deadline",  # DeadlineExceeded (rung 4)
}

#: degradation-ladder audit inventory: every rung transition that can
#: fire increments one of these
RUNG_COUNTERS = {
    "hedge": "hedged_batches",  # rung 1 engaged for a batch
    "degrade": "degraded_batches",  # rung 2 engaged for a batch
    "recover": "degrade_recoveries",  # rung 2 disengaged
    "consistency": "consistency_degraded",  # per-request rung-2 effect
    "shed": "shed_overload",  # rung 3 victims
    "deadline": "shed_deadline",  # rung 4 refusals
}


@dataclasses.dataclass(frozen=True)
class Request:
    """One client query: what to read, when it arrived, how long it may
    take (``deadline_s`` is a budget relative to arrival; None =
    unbounded), and how important it is (higher ``priority`` sheds
    last)."""

    cf_name: str
    query: Query
    arrival_s: float = 0.0
    deadline_s: float | None = None
    priority: int = 0
    consistency: str = ONE

    def __post_init__(self) -> None:
        if self.consistency not in CONSISTENCY_LEVELS:
            raise ValueError(
                f"unknown consistency {self.consistency!r} "
                f"(expected one of {CONSISTENCY_LEVELS})"
            )
        if self.arrival_s < 0.0:
            raise ValueError(f"arrival_s must be >= 0, got {self.arrival_s}")


@dataclasses.dataclass(frozen=True)
class Response:
    """The front door's answer: a result or an *explicit* refusal.
    ``status`` is one of ``ok`` / ``rejected`` / ``shed`` /
    ``deadline``; there is no silent path."""

    status: str
    result: ScanResult | None = None
    report: ReadReport | None = None
    error: str | None = None
    retry_after_s: float | None = None  # set on ``rejected``
    latency_s: float = 0.0  # virtual completion - arrival
    queue_wait_s: float = 0.0  # virtual launch - arrival
    consistency_used: str | None = None
    degraded: bool = False  # served below the requested consistency

    @property
    def ok(self) -> bool:
        return self.status == OK


@dataclasses.dataclass(eq=False)  # identity semantics: queue.remove()
class _Queued:
    """A request holding a queue slot (and its bulkhead admission)."""

    idx: int
    req: Request
    compartment: tuple[str, int] | None
    span: Span | None = None  # frontdoor.request root (tracing on)
    queue_span: Span | None = None  # open frontdoor.queue child


class FrontDoor:
    """Continuous-batching, overload-safe serving layer over one
    :class:`~repro_torch.core.HREngine` (see module docstring for the
    degradation ladder, observability, and determinism model).

    Parameters
    ----------
    max_batch, max_wait:
        Continuous-batching knobs: a batch launches as soon as
        ``max_batch`` requests wait, or when the oldest has waited
        ``max_wait`` seconds — whichever comes first.
    max_queue:
        Hard queue bound; arrivals beyond it are rejected with
        :class:`RetryAfter` (backpressure, not buffering).
    rate, burst:
        Token-bucket admission (requests/second + burst capacity);
        ``rate=None`` disables throttling.
    bulkhead_inflight:
        Outstanding-request bound per ``(cf_name, partition)``
        compartment; ``None`` disables bulkheads.
    hedge_wait_factor, degrade_wait_factor, shed_fill:
        The ladder thresholds, in units of ``max_wait`` (rungs 1–3
        above).
    metrics:
        Registry for the decision counters and latency histograms; a
        private one is created when omitted.
    tracer, slow_log, slow_log_k:
        Optional request tracing: with ``tracer`` set, every request
        grows a ``frontdoor.request`` span tree and completed trees
        are offered to ``slow_log`` (a fresh
        :class:`~repro_torch.obs.export.SlowQueryLog` of capacity
        ``slow_log_k`` when not supplied).
    """

    def __init__(
        self,
        engine: HREngine,
        *,
        max_batch: int = 64,
        max_wait: float = 2e-3,
        max_queue: int = 256,
        rate: float | None = None,
        burst: float = 32.0,
        bulkhead_inflight: int | None = None,
        hedge_wait_factor: float = 1.5,
        degrade_wait_factor: float = 4.0,
        shed_fill: float = 0.9,
        ewma_alpha: float = 0.2,
        ewma_warmup: int = 8,
        metrics: MetricsRegistry | None = None,
        tracer: Tracer | None = None,
        slow_log: SlowQueryLog | None = None,
        slow_log_k: int = 16,
    ) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait <= 0.0:
            raise ValueError(f"max_wait must be > 0, got {max_wait}")
        if max_queue < max_batch:
            raise ValueError(
                f"max_queue ({max_queue}) must be >= max_batch ({max_batch})"
            )
        if not 0.0 < shed_fill <= 1.0:
            raise ValueError(f"shed_fill must be in (0, 1], got {shed_fill}")
        if hedge_wait_factor <= 0.0 or degrade_wait_factor <= 0.0:
            raise ValueError("ladder factors must be > 0")
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait)
        self.max_queue = int(max_queue)
        self.bucket = TokenBucket(rate, burst) if rate is not None else None
        self.bulkhead = (
            Bulkhead(bulkhead_inflight, retry_after_s=max_wait)
            if bulkhead_inflight is not None
            else None
        )
        self.hedge_after = float(hedge_wait_factor) * self.max_wait
        self.degrade_after = float(degrade_wait_factor) * self.max_wait
        self.shed_trigger = max(1, int(float(shed_fill) * self.max_queue))
        self.queue_wait = LatencyEWMA(alpha=ewma_alpha)
        self.ewma_warmup = int(ewma_warmup)
        self._degraded = False  # current ladder state (for recovery count)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._ctr = {n: self.metrics.counter(n) for n in FRONTDOOR_COUNTERS}
        self._depth_gauge = self.metrics.gauge("max_queue_depth")
        self._h_queue_wait = self.metrics.histogram("queue_wait_seconds")
        self._h_latency = self.metrics.histogram("request_latency_seconds")
        self._h_service = self.metrics.histogram("batch_service_seconds")
        self.tracer = tracer
        if slow_log is not None:
            self.slow_log = slow_log
        else:
            self.slow_log = SlowQueryLog(slow_log_k) if tracer is not None else None

    @property
    def stats(self) -> dict[str, float]:
        """Read-through dict view of the decision counters (every
        ladder rung and every admission refusal increments one of
        these; ``max_queue_depth`` is the queue-depth high-water
        mark)."""
        d: dict[str, float] = {n: int(c.value) for n, c in self._ctr.items()}
        d["max_queue_depth"] = int(self._depth_gauge.value)
        return d

    def reset_stats(self) -> None:
        """Zero every counter, gauge, and histogram in one registry
        reset (handles stay live)."""
        self.metrics.reset()

    # -- tracing helpers ---------------------------------------------------

    def _finish(self, entry: _Queued, t: float, latency: float, **attrs: Any) -> None:
        """End a request's root span at virtual time ``t`` and offer
        the completed tree to the slow-query log."""
        if entry.span is None:
            return
        entry.span.end(t=t, **attrs)
        if self.slow_log is not None:
            self.slow_log.offer(entry.span, latency=latency)

    # -- admission ---------------------------------------------------------

    def _compartment(self, req: Request) -> tuple[str, int]:
        """Bulkhead compartment key: the request's column family plus
        the partition its slab pins (-1 when it fans out over several —
        fan-out queries share one per-CF compartment)."""
        cf = self.engine.column_families[req.cf_name]
        if cf.ring.n_partitions <= 1:
            return (req.cf_name, 0)
        bounds = slab_bounds_many([req.query], cf.key_names, cf.schema)
        p_lo, p_hi = cf.ring.span_partitions(bounds)
        pid = int(p_lo[0]) if int(p_lo[0]) == int(p_hi[0]) else -1
        return (req.cf_name, pid)

    def _admit(
        self, idx: int, req: Request, queue: list[_Queued], responses: list
    ) -> None:
        """Admission at virtual arrival time: queue bound, token
        bucket, bulkhead — first refusal wins and becomes an explicit
        ``rejected`` response."""
        self._ctr["submitted"].inc()
        root: Span | None = None
        adm: Span | None = None
        if self.tracer is not None:
            root = self.tracer.root(
                "frontdoor.request",
                t=req.arrival_s,
                idx=idx,
                level=req.consistency,
            )
            adm = root.child("frontdoor.admission", t=req.arrival_s)

        def _reject(kind: str, error: str, retry_after_s: float) -> None:
            self._ctr[REFUSAL_COUNTERS[kind]].inc()
            if root is not None:
                adm.end(t=req.arrival_s, outcome=f"rejected_{kind}")
                root.end(t=req.arrival_s, error="RetryAfter", status=REJECTED)
                if self.slow_log is not None:
                    self.slow_log.offer(root, latency=0.0)
            responses[idx] = Response(
                status=REJECTED,
                error=error,
                retry_after_s=retry_after_s,
            )

        if len(queue) >= self.max_queue:
            e = RetryAfter(self.max_wait, "queue full", kind="queue")
            _reject(e.kind, f"RetryAfter: {e.reason}", e.retry_after_s)
            return
        if self.bucket is not None:
            try:
                self.bucket.admit(req.arrival_s)
            except RetryAfter as e:
                _reject(e.kind, f"RetryAfter: {e.reason}", e.retry_after_s)
                return
        comp = None
        if self.bulkhead is not None:
            # the slab walk is only worth paying when a bulkhead will
            # actually compartment by it
            comp = self._compartment(req)
            try:
                self.bulkhead.acquire(comp)
            except RetryAfter as e:
                _reject(e.kind, f"RetryAfter: {e.reason}", e.retry_after_s)
                return
        self._ctr["admitted"].inc()
        entry = _Queued(idx, req, comp)
        if root is not None:
            adm.end(t=req.arrival_s, outcome="admitted")
            entry.span = root
            entry.queue_span = root.child("frontdoor.queue", t=req.arrival_s)
        queue.append(entry)
        self._depth_gauge.max(len(queue))

    def _release(self, entry: _Queued) -> None:
        if self.bulkhead is not None and entry.compartment is not None:
            self.bulkhead.release(entry.compartment)

    def _refuse_queued(self, entry: _Queued, now: float, reason: str) -> float:
        """Shared shed/deadline bookkeeping for a queued entry: release
        the bulkhead slot, close its spans at virtual ``now``, and
        return the virtual wait (== latency for a queue refusal)."""
        self._release(entry)
        wait = now - entry.req.arrival_s
        if entry.queue_span is not None:
            entry.queue_span.end(t=now, outcome=reason)
            entry.queue_span = None
            entry.span.child("frontdoor.shed", t=now, reason=reason).end(t=now)
        self._finish(
            entry, now, wait, status=SHED if reason == "overload" else DEADLINE
        )
        return wait

    # -- the event loop ----------------------------------------------------

    def serve(
        self,
        requests: Sequence[Request],
        *,
        timeline: Sequence[tuple[float, Callable[[], Any]]] = (),
    ) -> list[Response]:
        """Run the open-loop simulation to completion and return one
        :class:`Response` per request, in input order.

        ``timeline`` entries ``(virtual_time, callback)`` fire once the
        virtual clock first reaches their time — the chaos harness uses
        them to inject/clear node slowdowns and fault budgets mid-run.
        """
        order = sorted(range(len(requests)), key=lambda i: (requests[i].arrival_s, i))
        responses: list[Response | None] = [None] * len(requests)
        events = sorted(timeline, key=lambda e: e[0])
        queue: list[_Queued] = []
        now = 0.0
        ai = ei = 0

        def fire_events(upto: float) -> None:
            nonlocal ei
            while ei < len(events) and events[ei][0] <= upto:
                events[ei][1]()
                ei += 1

        def admit_upto(t: float) -> None:
            nonlocal ai
            while ai < len(order) and requests[order[ai]].arrival_s <= t:
                idx = order[ai]
                fire_events(requests[idx].arrival_s)
                self._admit(idx, requests[idx], queue, responses)
                ai += 1

        while True:
            admit_upto(now)
            if not queue:
                if ai >= len(order):
                    break
                now = requests[order[ai]].arrival_s  # idle: jump to next arrival
                continue

            # -- continuous batching: launch at max_batch or max_wait --
            if len(queue) >= self.max_batch:
                launch = now
            else:
                launch = max(now, queue[0].req.arrival_s + self.max_wait)
                # arrivals before the timer expires may fill the batch early
                while (
                    ai < len(order)
                    and requests[order[ai]].arrival_s <= launch
                    and len(queue) < self.max_batch
                ):
                    idx = order[ai]
                    fire_events(requests[idx].arrival_s)
                    self._admit(idx, requests[idx], queue, responses)
                    ai += 1
                if len(queue) >= self.max_batch:
                    launch = max(now, queue[-1].req.arrival_s)
            fire_events(launch)
            now = launch

            # -- rung 3: priority shed when the queue is nearly full --
            if len(queue) > self.shed_trigger:
                target = max(self.max_batch, self.shed_trigger)
                victims = sorted(
                    queue, key=lambda e: (e.req.priority, -e.req.arrival_s)
                )
                for entry in victims:
                    if len(queue) <= target:
                        break
                    queue.remove(entry)
                    self._ctr[REFUSAL_COUNTERS["shed"]].inc()
                    wait = self._refuse_queued(entry, now, "overload")
                    responses[entry.idx] = Response(
                        status=SHED,
                        error="Shed: queue over shed_fill, lower priority",
                        latency_s=wait,
                        queue_wait_s=wait,
                    )
                if not queue:
                    continue

            # -- ladder state for this batch --
            oldest_wait = now - queue[0].req.arrival_s
            degrade = oldest_wait > self.degrade_after
            hedge = (
                self.queue_wait.count >= self.ewma_warmup
                and self.queue_wait.mean() > self.hedge_after
            )
            if degrade:
                self._ctr[RUNG_COUNTERS["degrade"]].inc()
                self._degraded = True
            elif self._degraded:
                self._degraded = False
                self._ctr[RUNG_COUNTERS["recover"]].inc()
            if hedge:
                self._ctr[RUNG_COUNTERS["hedge"]].inc()

            # -- pick the batch: highest priority, then oldest --
            chosen = sorted(
                queue, key=lambda e: (-e.req.priority, e.req.arrival_s, e.idx)
            )[: self.max_batch]
            for entry in chosen:
                queue.remove(entry)

            # -- rung 4a: shed members whose budget is already spent --
            ready: list[_Queued] = []
            for entry in chosen:
                d = entry.req.deadline_s
                if d is not None and now - entry.req.arrival_s >= d:
                    self._ctr[REFUSAL_COUNTERS["deadline"]].inc()
                    wait = self._refuse_queued(entry, now, "deadline")
                    responses[entry.idx] = Response(
                        status=DEADLINE,
                        error=str(DeadlineExceeded(d)),
                        latency_s=wait,
                        queue_wait_s=wait,
                    )
                else:
                    ready.append(entry)

            # -- launch: one read_many per (cf, effective consistency) --
            self._ctr["batches"].inc()
            groups: dict[tuple[str, str], list[_Queued]] = {}
            for entry in ready:
                level = ONE if degrade else entry.req.consistency
                groups.setdefault((entry.req.cf_name, level), []).append(entry)
            service = 0.0
            for (cf_name, level), members in sorted(groups.items()):
                service += self._run_group(
                    cf_name, level, members, now, hedge=hedge,
                    degrade=degrade, responses=responses,
                )
            now += service
        return responses  # type: ignore[return-value]

    def _run_group(
        self,
        cf_name: str,
        level: str,
        members: list[_Queued],
        launch: float,
        *,
        hedge: bool,
        degrade: bool,
        responses: list,
    ) -> float:
        """Execute one homogeneous sub-batch and write its responses.
        Returns the group's virtual service time: the larger of the
        measured wall and the engine-reported walls, so injected node
        slowdowns (which inflate reported walls without sleeping) slow
        the virtual drain."""
        # the engine budget is the LARGEST remaining member budget, and
        # only when every member carries one: an engine DeadlineExceeded
        # then implies every member's budget is spent — shed them all,
        # requeue none
        budgets = [
            m.req.deadline_s - (launch - m.req.arrival_s)
            for m in members
            if m.req.deadline_s is not None
        ]
        deadline_s = max(budgets) if len(budgets) == len(members) else None

        # span plumbing: one frontdoor.service child per traced member;
        # the engine subtree parents under the sole service span when
        # the group has one member (one tree per request, down to the
        # kernel launch), or under a shared frontdoor.batch root that
        # each member's service span points at via its ``batch`` attr
        svc_spans: list[Span] = []
        batch_span: Span | None = None
        trace: Span | None = None
        if self.tracer is not None:
            for m in members:
                if m.span is None:
                    continue
                if m.queue_span is not None:
                    m.queue_span.end(t=launch, outcome="launched")
                    m.queue_span = None
                svc_spans.append(
                    m.span.child(
                        "frontdoor.service",
                        t=launch,
                        cf=cf_name,
                        level=level,
                        hedged=hedge,
                        degraded=degrade,
                        queries=len(members),
                    )
                )
            if len(svc_spans) == 1:
                trace = svc_spans[0]
            elif svc_spans:
                batch_span = self.tracer.root(
                    "frontdoor.batch",
                    t=launch,
                    cf=cf_name,
                    level=level,
                    queries=len(members),
                    hedged=hedge,
                )
                for s in svc_spans:
                    s.annotate(batch=batch_span.span_id)
                trace = batch_span

        t0 = time.perf_counter()
        try:
            out = self.engine.read_many(
                cf_name,
                [m.req.query for m in members],
                hedge=hedge,
                hedge_ratio=1.0 if hedge else 2.0,
                consistency=level,
                deadline_s=deadline_s,
                trace=trace,
            )
        except DeadlineExceeded as e:
            wall = time.perf_counter() - t0
            done = launch + wall
            if batch_span is not None:
                batch_span.end(t=done, error="DeadlineExceeded")
            for s in svc_spans:
                s.end(t=done, outcome="deadline")
            for m in members:
                self._release(m)
                self._ctr[REFUSAL_COUNTERS["deadline"]].inc()
                latency = done - m.req.arrival_s
                self._h_latency.observe(latency)
                self._finish(m, done, latency, status=DEADLINE)
                responses[m.idx] = Response(
                    status=DEADLINE,
                    error=str(e),
                    latency_s=latency,
                    queue_wait_s=launch - m.req.arrival_s,
                )
            return wall
        wall = time.perf_counter() - t0
        reported = sum(rep.wall_seconds for _sr, rep in out)
        service = max(wall, reported)
        self._h_service.observe(service)
        done = launch + service
        if batch_span is not None:
            batch_span.end(t=done)
        for s in svc_spans:
            s.end(t=done)
        for m, (sr, rep) in zip(members, out):
            self._release(m)
            q_wait = launch - m.req.arrival_s
            self.queue_wait.record(q_wait)
            self._h_queue_wait.observe(q_wait)
            latency = done - m.req.arrival_s
            self._h_latency.observe(latency)
            d = m.req.deadline_s
            if d is not None and latency > d:
                # the answer exists but landed late — refuse it openly
                self._ctr[REFUSAL_COUNTERS["deadline"]].inc()
                self._finish(m, done, latency, status=DEADLINE)
                responses[m.idx] = Response(
                    status=DEADLINE,
                    error=str(DeadlineExceeded(d)),
                    latency_s=latency,
                    queue_wait_s=q_wait,
                )
                continue
            self._ctr["served_ok"].inc()
            was_degraded = degrade and m.req.consistency != level
            if was_degraded:
                self._ctr[RUNG_COUNTERS["consistency"]].inc()
            self._finish(m, done, latency, status=OK)
            responses[m.idx] = Response(
                status=OK,
                result=sr,
                report=rep,
                latency_s=latency,
                queue_wait_s=q_wait,
                consistency_used=level,
                degraded=was_degraded,
            )
        return service
