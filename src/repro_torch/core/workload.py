"""Queries and workloads (paper §3.1).

A query is a conjunction of per-column filters over the clustering keys:
equality (``d.ck = v``) or half-open range (``d.ck ∈ [s, e)``). Columns
with no filter are treated as carrying the *global* range filter (the
paper assigns these explicitly so every clustering key has a filter);
Cassandra would evaluate the residual predicates with ALLOW FILTERING.

A workload is a list of queries, optionally weighted.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence

import numpy as np

from .keys import KeySchema

__all__ = ["Eq", "Range", "Query", "Workload", "random_workload"]


@dataclasses.dataclass(frozen=True)
class Eq:
    value: int

    def bounds(self, schema: KeySchema, col: str) -> tuple[int, int]:
        return int(self.value), int(self.value) + 1

    @property
    def is_equality(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class Range:
    start: int  # inclusive
    end: int  # exclusive

    def __post_init__(self) -> None:
        if self.end < self.start:
            raise ValueError(f"empty-inverted range [{self.start}, {self.end})")

    def bounds(self, schema: KeySchema, col: str) -> tuple[int, int]:
        return int(self.start), int(self.end)

    @property
    def is_equality(self) -> bool:
        return False


Filter = Eq | Range


@dataclasses.dataclass(frozen=True)
class Query:
    """Conjunctive filters + an aggregation over a value column.

    ``agg`` ∈ {"sum", "count", "select"}: TPC-H Q1/Q2 are sums over
    ``totalprice``; "select" returns matching rows (used in tests).
    """

    filters: Mapping[str, Filter]
    agg: str = "count"
    value_col: Optional[str] = None

    def filter_bounds(self, schema: KeySchema, col: str) -> tuple[int, int]:
        """[lo, hi) bounds for a column; global range if unfiltered."""
        f = self.filters.get(col)
        if f is None:
            return 0, schema.max_value(col) + 1
        return f.bounds(schema, col)

    def is_equality_on(self, col: str) -> bool:
        f = self.filters.get(col)
        return f is not None and f.is_equality


@dataclasses.dataclass(frozen=True)
class Workload:
    queries: Sequence[Query]
    weights: Optional[Sequence[float]] = None

    def __post_init__(self) -> None:
        if self.weights is not None and len(self.weights) != len(self.queries):
            raise ValueError("weights length mismatch")

    def __len__(self) -> int:
        return len(self.queries)

    def normalized_weights(self) -> np.ndarray:
        if self.weights is None:
            return np.full(len(self.queries), 1.0 / max(1, len(self.queries)))
        w = np.asarray(self.weights, dtype=np.float64)
        return w / w.sum()


def random_workload(
    rng: np.random.Generator,
    schema: KeySchema,
    key_cols: Sequence[str],
    n_queries: int,
    *,
    p_eq: float = 0.5,
    p_absent: float = 0.2,
    range_frac: float = 0.1,
    agg: str = "count",
    value_col: Optional[str] = None,
) -> Workload:
    """Random conjunctive workload over ``key_cols`` (paper §5, simulation
    dataset: "the queries we used is randomly generated").

    Each key independently gets: no filter (p_absent), an equality filter
    (p_eq), else a range filter covering ~``range_frac`` of the domain.
    Queries with no filter at all are re-drawn.
    """
    queries: list[Query] = []
    while len(queries) < n_queries:
        filters: dict[str, Filter] = {}
        for col in key_cols:
            u = rng.random()
            dom = schema.max_value(col) + 1
            if u < p_absent:
                continue
            if u < p_absent + p_eq:
                filters[col] = Eq(int(rng.integers(0, dom)))
            else:
                width = max(1, int(dom * range_frac))
                start = int(rng.integers(0, max(1, dom - width)))
                filters[col] = Range(start, start + width)
        if not filters:
            continue
        queries.append(Query(filters=filters, agg=agg, value_col=value_col))
    return Workload(queries)
