"""Sums of signed values that cancel: the port's engine and the reference
engine each against a float64 pass, with a tolerance in eps32 · Σ|v|.

The parity contract's tolerance (rtol 1e-5, atol 1e-3, the reference's
own) grows with |Σv|, but the error of a float32 sum grows with Σ|v|: on
signed values that cancel, two correct engines can miss the exact sum,
and each other, by more than that tolerance. Here the values are drawn
from N(0, 100) with fixed numpy seeds, stored as float32, and each sum is
held against a float64 pass over the same float32 values:

    |engine - exact| <= C * eps32 * sum(|v|),   C = 16.

Why 16. A float32 summation whose evaluation tree has depth d errs by at
most about d * (eps32 / 2) * sum(|v|) (Higham, Accuracy and Stability of
Numerical Algorithms, section 4.2). The port's order is a pairwise tree of
depth 13 in each 8192-row block, then a sequential fold of the block
partials; with at most 40,000 rows (five blocks) d <= 18, so its worst
case is 9 * eps32 * sum(|v|). The reference's XLA reductions fix no
order; the worst case of a sequential order is vacuous here, but for
random signs its rounding errors are a random walk of standard deviation
about 0.3 * eps32 * sum(|v|), so 16 is some fifty deviations: a failure
is a wrong sum, not an unlucky order. Counts must be exact. No existing
tolerance changes.
"""

import numpy as np
import pytest
import torch  # noqa: F401  (the port's engine runs on torch tensors)

import repro.core as R
import repro_torch.core as T

C = 16
EPS32 = float(np.finfo(np.float32).eps)
BITS = {"a": 4, "b": 8, "c": 12}
LAYOUTS = [("a", "b", "c"), ("b", "c", "a"), ("c", "a", "b")]
N_ROWS = 40_000


def _queries(pkg, rng, n_q):
    """Sums over one to three filtered columns, from a few rows to all of
    them, plus one sum without filters."""
    qs = [pkg.Query(filters={}, agg="sum", value_col="v")]
    for i in range(n_q - 1):
        f = {}
        for c in rng.permutation(list(BITS))[: 1 + i % 3]:
            top = 1 << BITS[c]
            lo = int(rng.integers(0, top))
            if rng.random() < 0.3:
                f[c] = pkg.Eq(lo)
            else:
                f[c] = pkg.Range(lo, int(rng.integers(lo, top + 1)))
        qs.append(pkg.Query(filters=f, agg="sum", value_col="v"))
    return qs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_signed_sums_within_eps32_of_sum_abs(seed):
    rng = np.random.default_rng(seed)
    kc = {c: rng.integers(0, 1 << b, N_ROWS, dtype=np.int64) for c, b in BITS.items()}
    v = rng.normal(0.0, 100.0, N_ROWS).astype(np.float32)
    vc = {"v": v.astype(np.float64)}
    ref = R.HREngine(n_nodes=4)
    ref.create_column_family("s", kc, vc, layouts=LAYOUTS, schema=R.KeySchema(dict(BITS)), device_resident=True)
    port = T.HREngine(n_nodes=4, device="cpu")
    port.create_column_family("s", kc, vc, layouts=LAYOUTS, schema=T.KeySchema(dict(BITS)), device_resident=True)
    q_rng = np.random.default_rng(seed + 1000)
    r_qs = _queries(R, q_rng, 30)
    p_qs = [T.Query(filters=q.filters, agg=q.agg, value_col=q.value_col) for q in r_qs]
    ref_out = ref.read_many("s", r_qs)
    port_out = port.read_many("s", p_qs)
    v64 = v.astype(np.float64)
    cancel = 0.0
    for q, (ra, _), (pa, _) in zip(p_qs, ref_out, port_out):
        mask = np.ones(N_ROWS, bool)
        for c, f in q.filters.items():
            lo, hi = f.bounds(port.column_families["s"].schema, c)
            mask &= (kc[c] >= lo) & (kc[c] < hi)
        exact = float(v64[mask].sum())
        bound = C * EPS32 * float(np.abs(v64[mask]).sum())
        assert ra.rows_matched == pa.rows_matched == int(mask.sum())
        assert abs(pa.value - exact) <= bound, ("port", q.filters, pa.value, exact, bound)
        assert abs(ra.value - exact) <= bound, ("reference", q.filters, ra.value, exact, bound)
        if mask.sum() > 1000:
            cancel = max(cancel, float(np.abs(v64[mask]).sum()) / max(abs(exact), 1e-9))
    # the draw cancels: some sum is far smaller than the sum of its magnitudes
    assert cancel > 20
