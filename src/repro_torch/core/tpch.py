"""Synthetic TPC-H ``orders`` (paper §5) and the simulation dataset.

The paper uses the TPC-H ``orders`` table with clustering keys
(custkey, orderdate, clerk) at scale factors 1–5 (1.5 M – 7.5 M rows),
plus a "simulation dataset" whose |D| clustering keys are integers
uniform over a domain sized so that every key has ~|P|^(1/|D|) distinct
values ("value scope 0 ~ log_{|D|} |P|" — the paper's notation for a
domain that keeps the expected rows-per-full-key-prefix ≈ 1).

Query templates Q1/Q2 match the paper's SQL:
  Q1: orderdate = ?, clerk = ?, custkey ≥ 0      (range over custkey)
  Q2: custkey = ?, clerk = ?, orderdate ∈ [?, ?)  (range over orderdate)
"""

from __future__ import annotations

import numpy as np

from .keys import KeySchema
from .workload import Eq, Query, Range, Workload

__all__ = [
    "ROWS_PER_SF",
    "generate_orders",
    "orders_schema",
    "q1_q2_workload",
    "generate_simulation",
]

ROWS_PER_SF = 1_500_000

# TPC-H ratios: ~10 orders per customer, ~1500 orders per clerk, 2406
# distinct order dates. Domains scale with the dataset so the per-key
# selectivities match the paper's at any rows_per_sf (the figures are
# reproduced at reduced scale on CPU; ratios are what transfer).
N_DATES = 2406
ORDERS_PER_CUSTOMER = 10
ORDERS_PER_CLERK = 1500


def n_custkey(n_rows: int) -> int:
    return max(1024, n_rows // ORDERS_PER_CUSTOMER)


def n_clerks(n_rows: int) -> int:
    return max(32, n_rows // ORDERS_PER_CLERK)


def orders_schema() -> KeySchema:
    return KeySchema(
        {
            "custkey": 20,
            "orderdate": 12,
            "clerk": 13,
        }
    )


def generate_orders(
    scale_factor: float, seed: int = 0, rows_per_sf: int = ROWS_PER_SF
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Return (key_cols, value_cols) for ``orders`` at a scale factor."""
    n = int(scale_factor * rows_per_sf)
    rng = np.random.default_rng(seed)
    key_cols = {
        "custkey": rng.integers(0, n_custkey(n), n, dtype=np.int64),
        "orderdate": rng.integers(0, N_DATES, n, dtype=np.int64),
        "clerk": rng.integers(0, n_clerks(n), n, dtype=np.int64),
    }
    value_cols = {
        "totalprice": np.round(rng.uniform(857.71, 555285.16, n), 2),
        "shippriority": rng.integers(0, 5, n).astype(np.float64),
    }
    return key_cols, value_cols


def q1_q2_workload(
    n_instances: int = 500, seed: int = 1, date_range_days: int = 30,
    n_rows: int = ROWS_PER_SF,
) -> Workload:
    """500 instances of Q1/Q2 with randomized parameters (paper §5).
    Parameter domains follow the dataset size (see generate_orders)."""
    rng = np.random.default_rng(seed)
    nck, ncl = n_custkey(n_rows), n_clerks(n_rows)
    queries = []
    for i in range(n_instances):
        if i % 2 == 0:
            # Q1: orderdate = ?, clerk = ?, custkey >= 0
            queries.append(
                Query(
                    filters={
                        "orderdate": Eq(int(rng.integers(0, N_DATES))),
                        "clerk": Eq(int(rng.integers(0, ncl))),
                        "custkey": Range(0, nck),
                    },
                    agg="sum",
                    value_col="totalprice",
                )
            )
        else:
            # Q2: custkey = ?, clerk = ?, orderdate in [?, ?)
            span = int(rng.integers(1, date_range_days + 1))
            start = int(rng.integers(0, max(1, N_DATES - span)))
            queries.append(
                Query(
                    filters={
                        "custkey": Eq(int(rng.integers(0, nck))),
                        "clerk": Eq(int(rng.integers(0, ncl))),
                        "orderdate": Range(start, start + span),
                    },
                    agg="sum",
                    value_col="totalprice",
                )
            )
    return Workload(queries)


def generate_simulation(
    n_rows: int, n_keys: int, seed: int = 0
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray], KeySchema]:
    """Paper §5 simulation dataset: ``n_keys`` integer clustering keys,
    each uniform over a domain of ~n_rows^(1/n_keys) values (so a full
    equality prefix selects ~1 row), values random over the data space."""
    rng = np.random.default_rng(seed)
    domain = max(2, int(round(n_rows ** (1.0 / n_keys))))
    bits = max(1, (domain - 1).bit_length())
    names = [f"k{i}" for i in range(n_keys)]
    key_cols = {c: rng.integers(0, domain, n_rows, dtype=np.int64) for c in names}
    value_cols = {"metric": rng.uniform(0.0, 1.0, n_rows)}
    schema = KeySchema({c: bits for c in names})
    return key_cols, value_cols, schema
