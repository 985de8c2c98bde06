"""Straggler mitigation: cost-ranked hedged reads.

The HR engine already ranks replicas by estimated cost (Eq 3); hedging
duplicates a read that landed on a slow node onto the next-cheapest
replica on a different node — the paper's load-balance property made
into a tail-latency tool. ``inject_slowdown`` marks nodes as stragglers;
``measure_tail`` quantifies p50/p95/p99 with and without hedging.

Hedging is the *fast* half of the availability story: it races a
duplicate without declaring anyone unhealthy. Its slow half lives in
``ft.detector`` (phi-accrual suspicion that down-ranks a persistently
slow node in the cost matrices before the pick is even made) and
``ft.failures``/``ft.chaos`` (outage injection and the seeded
multi-fault harness that checks the whole stack against a no-fault
oracle).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import HREngine, Workload

__all__ = ["inject_slowdown", "clear_slowdowns", "measure_tail", "TailStats"]


def inject_slowdown(engine: HREngine, node_id: int, factor: float) -> None:
    engine.nodes[node_id].slowdown = factor


def clear_slowdowns(engine: HREngine) -> None:
    for n in engine.nodes:
        n.slowdown = 1.0


@dataclasses.dataclass
class TailStats:
    p50: float
    p95: float
    p99: float
    mean: float
    hedged_fraction: float


def measure_tail(
    engine: HREngine, cf: str, workload: Workload, *, hedge: bool, repeats: int = 1
) -> TailStats:
    lat = []
    hedged = 0
    for _ in range(repeats):
        for q in workload.queries:
            _, rep = engine.read(cf, q, hedge=hedge)
            lat.append(rep.wall_seconds)
            hedged += int(rep.hedged)
    lat = np.asarray(lat)
    return TailStats(
        p50=float(np.percentile(lat, 50)),
        p95=float(np.percentile(lat, 95)),
        p99=float(np.percentile(lat, 99)),
        mean=float(lat.mean()),
        hedged_fraction=hedged / max(1, len(lat)),
    )
