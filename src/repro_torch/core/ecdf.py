"""Per-column distribution statistics: F (ECDF) and f (pmf), paper §3.1.

Eq (1) needs, per clustering key column, the distribution function
``F_k(x)`` and the density ``f_k(v)`` ("probability a row has value v").
Small integer domains get exact value counts; large domains fall back to
equi-width histograms (B bins). Stats are maintained by the engine's Cost
Evaluator and refreshed on writes.

The histogram build is a measurable hot loop at corpus scale, so it has a
hand-written CUDA kernel (``repro_torch.kernels.ecdf_hist``), wired in
behind ``merge_rows(..., device=<torch device>)`` — the engine passes its
device for device-resident column families so the Cost Evaluator's ECDF
refresh on every write runs on the card next to the data it describes:
every key column of a write batch in one launch, with one upload and one
readback. This module is the numpy reference (bit-equal: the kernel's
counts are exact integers) and the serving API.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from .keys import KeySchema

__all__ = ["ColumnStats", "TableStats"]

_EXACT_DOMAIN_LIMIT = 1 << 16


@dataclasses.dataclass
class ColumnStats:
    """Counts per bin over [0, domain); exact when bin_width == 1."""

    domain: int  # values are in [0, domain)
    bin_width: int
    counts: np.ndarray  # float64[n_bins]
    total: float

    @classmethod
    def from_values(cls, values: np.ndarray, domain: int, max_bins: int = 4096) -> "ColumnStats":
        if domain <= 0:
            raise ValueError("domain must be positive")
        if domain <= min(_EXACT_DOMAIN_LIMIT, max_bins):
            bw = 1
            nb = domain
        else:
            nb = max_bins
            bw = -(-domain // nb)  # ceil
            nb = -(-domain // bw)
        idx = np.asarray(values, dtype=np.int64) // bw
        counts = np.bincount(idx, minlength=nb).astype(np.float64)
        return cls(domain=domain, bin_width=bw, counts=counts, total=float(counts.sum()))

    @property
    def n_bins(self) -> int:
        return int(self.counts.shape[0])

    def _cum(self) -> np.ndarray:
        # cached cumulative counts (prefix-exclusive)
        cum = getattr(self, "_cum_cache", None)
        if cum is None or cum.shape[0] != self.n_bins + 1:
            cum = np.concatenate([[0.0], np.cumsum(self.counts)])
            object.__setattr__(self, "_cum_cache", cum)
        return cum

    def cdf(self, x: float) -> float:
        """F(x) = P[value < x] (left-continuous: mass strictly below x)."""
        if self.total == 0:
            return 0.0
        x = float(np.clip(x, 0, self.domain))
        b = int(x // self.bin_width)
        cum = self._cum()
        below = cum[min(b, self.n_bins)]
        frac = (x - b * self.bin_width) / self.bin_width if b < self.n_bins else 0.0
        inbin = self.counts[b] * frac if b < self.n_bins else 0.0
        return float((below + inbin) / self.total)

    def range_selectivity(self, lo: float, hi: float) -> float:
        """P[value ∈ [lo, hi)] = F(hi) − F(lo), Eq (1) range term."""
        return max(0.0, self.cdf(hi) - self.cdf(lo))

    def pmf(self, v: int) -> float:
        """f(v) — equality selectivity. Exact bins: count/total; coarse
        bins: bin mass spread uniformly across the bin's values."""
        if self.total == 0:
            return 0.0
        b = int(v) // self.bin_width
        if not 0 <= b < self.n_bins:
            return 0.0
        mass = self.counts[b] / self.total
        return float(mass if self.bin_width == 1 else mass / self.bin_width)

    # -- vectorized forms (batched read path) ------------------------------
    #
    # These evaluate the exact same float64 expressions as the scalar
    # methods, elementwise, so per-query costs from the batched estimator
    # are bit-identical to the sequential ones (routing decisions match).

    def cdf_many(self, x: np.ndarray) -> np.ndarray:
        """Vectorized ``cdf``: float64[...] → float64[...]."""
        x = np.asarray(x, dtype=np.float64)
        if self.total == 0:
            return np.zeros_like(x)
        x = np.clip(x, 0, self.domain)
        b = (x // self.bin_width).astype(np.int64)
        cum = self._cum()
        below = cum[np.minimum(b, self.n_bins)]
        interior = b < self.n_bins
        frac = np.where(interior, (x - b * self.bin_width) / self.bin_width, 0.0)
        inbin = np.where(interior, self.counts[np.minimum(b, self.n_bins - 1)], 0.0) * frac
        return (below + inbin) / self.total

    def range_selectivity_many(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """Vectorized ``range_selectivity`` over [lo, hi) pairs."""
        return np.maximum(0.0, self.cdf_many(hi) - self.cdf_many(lo))

    def pmf_many(self, v: np.ndarray) -> np.ndarray:
        """Vectorized ``pmf``: int[...] → float64[...]."""
        v = np.asarray(v, dtype=np.int64)
        if self.total == 0:
            return np.zeros(v.shape, dtype=np.float64)
        b = v // self.bin_width
        valid = (b >= 0) & (b < self.n_bins)
        mass = self.counts[np.where(valid, b, 0)] / self.total
        if self.bin_width != 1:
            mass = mass / self.bin_width
        return np.where(valid, mass, 0.0)

    # the kernel holds values and bin ids in int32 lanes and its shared-
    # memory histogram holds at most 4096 bins; the row bound mirrors the
    # reference engine's float32 count guard so both engines take the
    # same branch (the kernel's int32 counts are exact beyond it). Wider
    # domains, bin tables or batches keep the numpy path (same counts)
    _DEVICE_MAX_BINS = 4096
    _DEVICE_MAX_DOMAIN = 1 << 31
    _DEVICE_MAX_ROWS = 1 << 24

    def device_ok(self, values: np.ndarray) -> bool:
        """Whether the kernel takes this column's update: within the row
        guard, the bin budget and the int32 lanes."""
        return (
            0 < np.size(values) < self._DEVICE_MAX_ROWS
            and self.n_bins <= self._DEVICE_MAX_BINS
            and self.domain <= self._DEVICE_MAX_DOMAIN
        )

    def merge_values(self, values: np.ndarray, *, device=None) -> None:
        """Streaming update on writes (engine Write Scheduler).

        With ``device`` set (a torch device) the bin counts come from the
        ``ecdf_hist`` kernel on that device instead of host
        ``np.bincount``, so stats refresh stays on the card for
        device-resident column families. Falls back to numpy when the
        column's domain exceeds the kernel's int32 lanes or bin budget,
        or the batch exceeds the row guard."""
        values = np.asarray(values, dtype=np.int64)
        if device is not None and self.device_ok(values):
            add = device_counts([values], [self.n_bins], [self.bin_width], device)[0]
        else:
            idx = values // self.bin_width
            add = np.bincount(idx, minlength=self.n_bins).astype(np.float64)
        self.fold(add)

    def fold(self, add: np.ndarray) -> None:
        """Add per-bin counts ``add`` (float64[n_bins]) to the histogram."""
        self.counts = self.counts + add
        self.total = float(self.total + add.sum())
        if hasattr(self, "_cum_cache"):
            delattr(self, "_cum_cache")

    def merged_with(self, other: "ColumnStats") -> "ColumnStats":
        """Pure union of two compatible histograms (same domain and
        binning): bin counts add. The partition-merge stats fast path —
        two partitions' row sets are disjoint, so their histograms sum
        to exactly the merged partition's histogram, no re-scan."""
        if (self.domain, self.bin_width, self.n_bins) != (
            other.domain,
            other.bin_width,
            other.n_bins,
        ):
            raise ValueError("cannot merge ColumnStats with different binning")
        return ColumnStats(
            domain=self.domain,
            bin_width=self.bin_width,
            counts=self.counts + other.counts,
            total=self.total + other.total,
        )


@dataclasses.dataclass
class TableStats:
    """Cost-Evaluator statistics for one column family."""

    n_rows: int
    columns: dict[str, ColumnStats]

    @classmethod
    def from_columns(
        cls, key_cols: Mapping[str, np.ndarray], schema: KeySchema, max_bins: int = 4096
    ) -> "TableStats":
        n = len(next(iter(key_cols.values()))) if key_cols else 0
        cols = {
            name: ColumnStats.from_values(v, schema.max_value(name) + 1, max_bins)
            for name, v in key_cols.items()
        }
        return cls(n_rows=n, columns=cols)

    def merge_rows(
        self, key_cols: Mapping[str, np.ndarray], *, device=None
    ) -> None:
        """Fold a write batch into the stats; a ``device`` routes the
        histogram updates of every column the kernel takes
        (``ColumnStats.device_ok``) through one ``ecdf_hist_many`` launch,
        with one pinned upload and one readback (the engine's choice for
        device-resident column families); the other columns keep the
        numpy path."""
        n = len(next(iter(key_cols.values()))) if key_cols else 0
        self.n_rows += n
        on_card = []
        if device is not None:
            on_card = [name for name, v in key_cols.items() if self.columns[name].device_ok(v)]
        if on_card:
            stats = [self.columns[c] for c in on_card]
            adds = device_counts(
                [key_cols[c] for c in on_card],
                [cs.n_bins for cs in stats], [cs.bin_width for cs in stats], device,
            )
            for name, add in zip(on_card, adds):
                self.columns[name].fold(add)
        for name, v in key_cols.items():
            if name not in on_card:
                self.columns[name].merge_values(v)

    def merged_with(self, other: "TableStats") -> "TableStats":
        """Union of two disjoint row sets' stats (partition merge):
        per-column histograms add bin-wise — exactly the stats a full
        re-scan of the union would produce, without the re-scan."""
        if set(self.columns) != set(other.columns):
            raise ValueError("cannot merge TableStats with different columns")
        return TableStats(
            n_rows=self.n_rows + other.n_rows,
            columns={
                name: cs.merged_with(other.columns[name])
                for name, cs in self.columns.items()
            },
        )


def device_counts(
    values: list[np.ndarray], n_bins: list[int], bin_widths: list[int], device
) -> list[np.ndarray]:
    """Each column's counts of ``values[i] // bin_widths[i]`` over
    ``n_bins[i]`` bins, float64, from one ``ecdf_hist_many`` launch on
    ``device``: the columns (of one length) go up as one int32 block,
    pinned on a CUDA device so the copy does not wait for the stream, and
    the counts come back in one readback. The statistics refresh and the
    token histogram (``ring.TokenHistogram``) both count through here."""
    import torch

    from ..kernels.ecdf_hist import ecdf_hist_many

    device = torch.device(device)
    host = torch.empty((len(values), len(values[0])), dtype=torch.int32, pin_memory=device.type == "cuda")
    block = host.numpy()
    for i, v in enumerate(values):
        block[i] = v
    flat = ecdf_hist_many(
        host.to(device, non_blocking=True),
        n_bins=n_bins, bin_widths=bin_widths,
    ).cpu().numpy().astype(np.float64)
    return np.split(flat, np.cumsum(n_bins)[:-1])
