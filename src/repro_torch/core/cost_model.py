"""Query cost model (paper §3.1, Eq 1–4).

Eq (1): with layout ``A = (ck_1 … ck_n)`` and ``i`` the first position
whose filter is a *range* (keys before it all equality-filtered):

    Row(r, q) = N · ∏_{p<i} f_{ck_p}(v_p) · (F_{ck_i}(e_i) − F_{ck_i}(s_i))

(The paper prints ``|P|`` for the leading factor; §5's "data size |P|"
confirms it is the dataset row count N.) Keys *after* position i do not
shrink the slab — they are residual predicates evaluated during the scan.

Eq (2): Cost = f(Row) with f fitted linear per environment; the slope
depends on the number of clustering keys (Fig 4b) so fits are keyed by
|A|. Eq (3)/(4): per-query cost is the min over replicas; workload cost
is the (weighted) mean of per-query minima.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .ecdf import TableStats
from .workload import Query, Workload

__all__ = [
    "estimate_rows",
    "estimate_rows_many",
    "precompute_query_stats",
    "LinearCostFunction",
    "CostModel",
]


def estimate_rows(stats: TableStats, layout: Sequence[str], query: Query) -> float:
    """Eq (1) — expected slab rows for ``query`` on a replica with ``layout``."""
    sel = 1.0
    for col in layout:
        cs = stats.columns[col]
        if query.is_equality_on(col):
            sel *= cs.pmf(query.filters[col].value)  # type: ignore[union-attr]
            if sel == 0.0:
                break
        else:
            f = query.filters.get(col)
            if f is None:
                # global range filter: selectivity 1, and the prefix ends here.
                break
            lo, hi = f.bounds(None, col)  # Range.bounds ignores schema args
            sel *= cs.range_selectivity(lo, hi)
            break
    return float(stats.n_rows) * sel


def precompute_query_stats(
    stats: TableStats, queries: Sequence[Query], columns: Sequence[str]
) -> dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Per-column (has_eq, has_rng, selectivity) arrays for a batch.

    A query's per-column selectivity (pmf for equality, F(hi)−F(lo) for
    a range) does not depend on the replica layout — only *which*
    columns contribute does. Precomputing it once lets ``read_many``
    amortize the filter extraction and the vectorized ECDF lookups
    across all replicas instead of redoing them per layout.
    """
    n_q = len(queries)
    pre = {}
    for col in columns:
        cs = stats.columns[col]
        has_eq = np.zeros(n_q, dtype=bool)
        has_rng = np.zeros(n_q, dtype=bool)
        vals = np.zeros(n_q, dtype=np.int64)
        los = np.zeros(n_q, dtype=np.float64)
        his = np.zeros(n_q, dtype=np.float64)
        for i, q in enumerate(queries):
            f = q.filters.get(col)
            if f is None:
                continue
            if f.is_equality:
                has_eq[i] = True
                vals[i] = f.value  # type: ignore[union-attr]
            else:
                has_rng[i] = True
                los[i], his[i] = f.start, f.end  # type: ignore[union-attr]
        sel = np.ones(n_q, dtype=np.float64)
        if has_eq.any():
            sel[has_eq] = cs.pmf_many(vals[has_eq])
        if has_rng.any():
            sel[has_rng] = cs.range_selectivity_many(los[has_rng], his[has_rng])
        pre[col] = (has_eq, has_rng, sel)
    return pre


def estimate_rows_many(
    stats: TableStats,
    layout: Sequence[str],
    queries: Sequence[Query],
    pre: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]] | None = None,
) -> np.ndarray:
    """Vectorized Eq (1) over a query batch: float64[len(queries)].

    Evaluates the same float64 expressions as :func:`estimate_rows`, in
    the same per-column order, so each entry is bit-identical to the
    scalar estimate — the batched scheduler makes exactly the routing
    decisions the sequential one would. Pass ``pre`` from
    :func:`precompute_query_stats` to share the per-column selectivity
    extraction across several layouts.
    """
    n_q = len(queries)
    if pre is None:
        pre = precompute_query_stats(stats, queries, layout)
    sel = np.ones(n_q, dtype=np.float64)
    active = np.ones(n_q, dtype=bool)  # equality prefix still extending
    for col in layout:
        if not active.any():
            break
        has_eq, has_rng, col_sel = pre[col]
        apply = active & (has_eq | has_rng)
        if apply.any():
            sel[apply] = sel[apply] * col_sel[apply]
        # only an equality filter extends the prefix; absent (global
        # range, selectivity 1) and range filters both terminate it
        active &= has_eq
    return float(stats.n_rows) * sel


@dataclasses.dataclass(frozen=True)
class LinearCostFunction:
    """f(Row) = slope · Row + intercept (Fig 4: linear in Row; slope grows
    with the clustering-key count, insensitive to value byte width)."""

    slope: float
    intercept: float

    def __call__(self, rows: float) -> float:
        return self.slope * float(rows) + self.intercept

    def many(self, rows: np.ndarray) -> np.ndarray:
        """Vectorized evaluation (same float64 ops as ``__call__``)."""
        return self.slope * np.asarray(rows, dtype=np.float64) + self.intercept

    @classmethod
    def fit(cls, rows: np.ndarray, times: np.ndarray) -> "LinearCostFunction":
        rows = np.asarray(rows, dtype=np.float64)
        times = np.asarray(times, dtype=np.float64)
        if rows.size < 2:
            raise ValueError("need ≥2 samples to fit")
        slope, intercept = np.polyfit(rows, times, 1)
        return cls(slope=float(slope), intercept=float(intercept))

    def r2(self, rows: np.ndarray, times: np.ndarray) -> float:
        pred = self.slope * np.asarray(rows, np.float64) + self.intercept
        t = np.asarray(times, np.float64)
        ss_res = float(((t - pred) ** 2).sum())
        ss_tot = float(((t - t.mean()) ** 2).sum())
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0


#: Default per-|A| cost functions (re-fitted by benchmarks/fig4; unit
#: slope makes Cost ≡ Row, which preserves all argmin decisions).
_IDENTITY = LinearCostFunction(slope=1.0, intercept=0.0)


@dataclasses.dataclass
class CostModel:
    """Eq (2)–(4) over a set of replica layouts."""

    stats: TableStats
    cost_fns: dict[int, LinearCostFunction] = dataclasses.field(default_factory=dict)

    def cost_fn(self, n_keys: int) -> LinearCostFunction:
        return self.cost_fns.get(n_keys, _IDENTITY)

    def query_cost(self, layout: Sequence[str], query: Query) -> float:
        """Eq (2): Cost(r, q) = f(Row(r, q))."""
        rows = estimate_rows(self.stats, layout, query)
        return self.cost_fn(len(layout))(rows)

    def cost_many(self, layout: Sequence[str], queries: Sequence[Query]) -> np.ndarray:
        """Vectorized Eq (2) over a query batch: float64[len(queries)]."""
        rows = estimate_rows_many(self.stats, layout, queries)
        return self.cost_fn(len(layout)).many(rows)

    def rank_matrices(
        self,
        layouts: Sequence[Sequence[str]],
        queries: Sequence[Query],
        *,
        stats: TableStats | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized Eq (1)–(2) over a layout set × query batch:
        ``(rows, cost)`` float64 matrices of shape
        ``[len(layouts), len(queries)]``.

        The scatter-gather planner calls this once per partition with
        ``stats=partition.stats`` so every partition's replica ranking
        uses *that partition's* selectivities; with ``stats=None`` the
        model's own (CF-global) stats apply — bit-identical to stacking
        :func:`estimate_rows_many` per layout, which is what the
        single-partition path always did.
        """
        st = self.stats if stats is None else stats
        pre = precompute_query_stats(st, queries, list(st.columns))
        rows = np.stack(
            [estimate_rows_many(st, layout, queries, pre) for layout in layouts]
        )
        cost = np.stack(
            [
                self.cost_fn(len(layout)).many(rows[s])
                for s, layout in enumerate(layouts)
            ]
        )
        return rows, cost

    def min_cost(self, layouts: Sequence[Sequence[str]], query: Query) -> tuple[float, int]:
        """Eq (3): (min cost, argmin replica index)."""
        costs = [self.query_cost(a, query) for a in layouts]
        j = int(np.argmin(costs))
        return costs[j], j

    def workload_cost(self, layouts: Sequence[Sequence[str]], workload: Workload) -> float:
        """Eq (4): weighted mean of per-query minima."""
        w = workload.normalized_weights()
        return float(
            sum(
                wi * self.min_cost(layouts, q)[0]
                for wi, q in zip(w, workload.queries)
            )
        )
