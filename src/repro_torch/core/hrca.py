"""HRCA — Heterogeneous Replica Constructing Algorithm (paper Alg. 1).

Search over replica *states* R = (layout_1 … layout_N), each layout a
permutation of the clustering keys. Enumerating all C(m!+N−1, N)
multisets is infeasible, so Algorithm 1 runs simulated annealing:

    NewState(R): swap two clustering keys inside one replica
    accept if C' < C, else with probability exp((C − C') / t)

Faithful options: geometric cooling from ``t0``, ``k_max`` steps.
Beyond-paper extras (all off by default, used by benchmarks/§Perf):
  * ``restarts`` — independent SA chains, keep the best (SA is cheap:
    "the algorithm is only called once … converges in ten seconds").
  * ``greedy_descent`` — steepest-descent polish over all single-swap
    neighbors after annealing.
Costs are memoized per (layout, query) — the annealer revisits states.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Sequence

import numpy as np

from .cost_model import CostModel
from .workload import Workload

__all__ = ["HRCAResult", "hrca", "exhaustive_search", "initial_state"]

State = tuple[tuple[str, ...], ...]


@dataclasses.dataclass
class HRCAResult:
    layouts: State
    cost: float
    initial_cost: float
    n_steps: int
    n_accepted: int
    wall_seconds: float
    trace: list[float]  # accepted-cost trajectory (for convergence bench)


#: What the search optimizes against: one CF-global model, or a
#: row-fraction-weighted set of per-partition models (the vnode ring's
#: view — every partition serves every query with its own selectivities,
#: so the state cost is the weighted sum of per-partition Eq (4)).
ModelSpec = "CostModel | Sequence[tuple[float, CostModel]]"


def _normalize_models(model) -> list[tuple[float, CostModel]]:
    if isinstance(model, CostModel):
        return [(1.0, model)]
    models = [(float(w), m) for w, m in model]
    if not models:
        raise ValueError("need at least one cost model")
    total = sum(w for w, _ in models)
    if total <= 0:  # empty partitions everywhere — weight uniformly
        return [(1.0 / len(models), m) for _, m in models]
    return [(w / total, m) for w, m in models]


class _MemoCost:
    """Eq (4) with per-(layout, query-index) memoization.

    Accepts a single :class:`CostModel` or a weighted sequence
    ``[(weight, model), ...]`` (per-partition stats); a query's cost is
    then the weight-blended cost across models — each partition picks
    its own cheapest replica at serve time, but the *layout set* is
    shared ring-wide, so construction optimizes the blend."""

    def __init__(self, model, workload: Workload) -> None:
        self.models = _normalize_models(model)
        self.workload = workload
        self.weights = workload.normalized_weights()
        self._cache: dict[tuple[tuple[str, ...], int], tuple[float, ...]] = {}

    def _model_costs(self, layout: tuple[str, ...], qi: int) -> tuple[float, ...]:
        """Per-model ``weight · Cost(layout, q)`` for one query."""
        key = (layout, qi)
        c = self._cache.get(key)
        if c is None:
            q = self.workload.queries[qi]
            c = tuple(w * m.query_cost(layout, q) for w, m in self.models)
            self._cache[key] = c
        return c

    def query_cost(self, layout: tuple[str, ...], qi: int) -> float:
        return float(sum(self._model_costs(layout, qi)))

    def state_cost(self, state: State) -> float:
        """Eq (4), generalized: each partition serves each query from
        *its own* cheapest replica, so the min over the layout set is
        taken per model, then blended — ``Σ_q w_q Σ_p w_p min_r
        Cost_p(r, q)``. With a single model this reduces exactly to the
        paper's ``Σ_q w_q min_r Cost(r, q)``."""
        n_m = len(self.models)
        total = 0.0
        for qi, w in enumerate(self.weights):
            per_layout = [self._model_costs(a, qi) for a in state]
            total += w * sum(
                min(pc[p] for pc in per_layout) for p in range(n_m)
            )
        return float(total)


def initial_state(key_cols: Sequence[str], n_replicas: int) -> State:
    """Arbitrary initial state R0 (paper: "arbitrary"): every replica gets
    the same natural order — also exactly the TR baseline layout set."""
    return tuple(tuple(key_cols) for _ in range(n_replicas))


def _new_state(state: State, rng: np.random.Generator) -> State:
    """NewState(R): swap two clustering keys of one replica (paper §3.2)."""
    j = int(rng.integers(len(state)))
    layout = list(state[j])
    if len(layout) < 2:
        return state
    a, b = rng.choice(len(layout), size=2, replace=False)
    layout[a], layout[b] = layout[b], layout[a]
    return state[:j] + (tuple(layout),) + state[j + 1 :]


def _greedy_polish(state: State, memo: _MemoCost) -> tuple[State, float]:
    """Steepest descent over all single-swap neighbors until no gain."""
    cur, cur_c = state, memo.state_cost(state)
    improved = True
    while improved:
        improved = False
        for j in range(len(cur)):
            lay = cur[j]
            for a in range(len(lay)):
                for b in range(a + 1, len(lay)):
                    nl = list(lay)
                    nl[a], nl[b] = nl[b], nl[a]
                    cand = cur[:j] + (tuple(nl),) + cur[j + 1 :]
                    c = memo.state_cost(cand)
                    if c < cur_c - 1e-12:
                        cur, cur_c, improved = cand, c, True
    return cur, cur_c


def hrca(
    model: "CostModel | Sequence[tuple[float, CostModel]]",
    workload: Workload,
    initial: State,
    *,
    t0: float | None = None,
    cooling: float = 0.995,
    k_max: int = 4000,
    seed: int = 0,
    restarts: int = 1,
    greedy_descent: bool = False,
) -> HRCAResult:
    """Algorithm 1. ``t0`` defaults to the initial cost (so early uphill
    moves of relative size ~1 are accepted with prob ~1/e).

    ``model`` may be a single :class:`CostModel` or a weighted sequence
    ``[(weight, model), ...]`` — the vnode ring passes one model per
    partition, weighted by the partition's row fraction, so the shared
    layout set is optimized against per-partition selectivities rather
    than the CF-global blend (see ``_MemoCost.state_cost``)."""
    memo = _MemoCost(model, workload)
    rng = np.random.default_rng(seed)
    start = time.perf_counter()
    c0 = memo.state_cost(initial)

    best_state, best_cost = initial, c0
    total_steps = total_accepted = 0
    trace: list[float] = [c0]

    for r in range(max(1, restarts)):
        state, cost = initial, c0
        t = float(t0) if t0 is not None else max(c0, 1e-9)
        for _ in range(k_max):
            total_steps += 1
            cand = _new_state(state, rng)
            c = memo.state_cost(cand)
            if c < cost or math.exp(min(0.0, (cost - c) / max(t, 1e-300))) > rng.random():
                state, cost = cand, c
                total_accepted += 1
                trace.append(cost)
                if cost < best_cost:
                    best_state, best_cost = state, cost
            t *= cooling

    if greedy_descent:
        best_state, best_cost = _greedy_polish(best_state, memo)

    return HRCAResult(
        layouts=best_state,
        cost=best_cost,
        initial_cost=c0,
        n_steps=total_steps,
        n_accepted=total_accepted,
        wall_seconds=time.perf_counter() - start,
        trace=trace,
    )


def exhaustive_search(
    model: "CostModel | Sequence[tuple[float, CostModel]]",
    workload: Workload,
    key_cols: Sequence[str],
    n_replicas: int,
) -> tuple[State, float]:
    """Enumerate all multisets of permutations — the tiny-instance oracle
    used to test HRCA optimality (feasible for m ≤ 4, N ≤ 3)."""
    memo = _MemoCost(model, workload)
    perms = [tuple(p) for p in itertools.permutations(key_cols)]
    best: tuple[State, float] | None = None
    for combo in itertools.combinations_with_replacement(perms, n_replicas):
        c = memo.state_cost(combo)
        if best is None or c < best[1]:
            best = (combo, c)
    assert best is not None
    return best
