"""Zero-dependency metrics registry: counters, gauges, histograms.

The registry is the single home for every operational counter of the
port's engine: :class:`~repro_torch.core.engine.HREngine` registers its
counters here at construction and keeps its ``stats`` dict view as a
read-through projection.

Three metric kinds:

* :class:`Counter` — monotonically increasing float (``inc``).
* :class:`Gauge` — last-write-wins level (``set`` / ``max``).
* :class:`Histogram` — log-bucketed latency distribution with
  p50/p95/p99 readout.  Buckets are powers of two split into
  ``2**SUB_BITS`` sub-buckets via ``math.frexp`` — pure integer
  arithmetic on the exponent/mantissa, so bucketing is exact and
  deterministic on every platform and under the virtual clock (no
  float ``log`` whose last ulp could differ between libms).

Everything here is deliberately dependency-free and allocation-light:
``Counter.inc`` is one float add on a ``__slots__`` object, cheap
enough for the engine's per-query hot path.

Determinism contract: metric state is a pure function of the sequence
of ``inc``/``set``/``observe`` calls — no wall-clock reads, no
randomness — so two identical seeded runs produce identical
registries (the chaos byte-identity tests rely on this).
"""

from __future__ import annotations

import math
from typing import Iterator

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]


class Counter:
    """Monotonic counter. ``value`` is a float (rows, seconds, events)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0.0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Counter({self.name}={self.value:g})"


class Gauge:
    """Last-write-wins level (queue depth high-water marks etc.)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def max(self, v: float) -> None:
        """Raise the gauge to ``v`` if above the current value."""
        if v > self.value:
            self.value = float(v)

    def reset(self) -> None:
        self.value = 0.0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Gauge({self.name}={self.value:g})"


class Histogram:
    """Log-bucketed distribution with deterministic integer bucketing.

    A positive sample ``v = m * 2**e`` (``math.frexp``, ``m`` in
    [0.5, 1)) lands in bucket ``e * 2**SUB_BITS + floor((m - 0.5) *
    2**(SUB_BITS + 1))`` — each power-of-two octave is split into
    ``2**SUB_BITS`` equal-width sub-buckets, giving a worst-case
    relative quantile error of ``2**-SUB_BITS`` (~12% at the default
    ``SUB_BITS = 3``), plenty for p50/p95/p99 readout.  Non-positive
    samples are pooled in a dedicated zero bucket.  Quantiles report
    the *upper* bound of the bucket holding the target rank (clamped
    to the observed max) — conservative, never flattering.
    """

    SUB_BITS = 3
    _SUB = 1 << SUB_BITS

    __slots__ = ("name", "count", "total", "_counts", "_zero", "_min", "_max")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self._counts: dict[int, int] = {}
        self._zero = 0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v
        if v <= 0.0:
            self._zero += 1
            return
        m, e = math.frexp(v)
        idx = (e << self.SUB_BITS) + int((m - 0.5) * (self._SUB << 1))
        self._counts[idx] = self._counts.get(idx, 0) + 1

    def quantile(self, q: float) -> float:
        """Upper bucket bound at rank ``ceil(q * count)`` (0 when empty)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = self._zero
        if seen >= target and self._zero:
            return 0.0
        for idx in sorted(self._counts):
            seen += self._counts[idx]
            if seen >= target:
                e, j = idx >> self.SUB_BITS, idx & (self._SUB - 1)
                hi = math.ldexp(0.5 + (j + 1) / (self._SUB << 1), e)
                return min(hi, self._max)
        return self._max  # pragma: no cover - ranks always land above

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict[str, float]:
        """Flat summary used by ``MetricsRegistry.as_dict`` and reports."""
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "p50": 0.0, "p95": 0.0,
                    "p99": 0.0, "max": 0.0}
        return {
            "count": self.count,
            "sum": self.total,
            "p50": self.quantile(0.50),
            "p95": self.quantile(0.95),
            "p99": self.quantile(0.99),
            "max": self._max,
        }

    def reset(self) -> None:
        self.count = 0
        self.total = 0.0
        self._counts.clear()
        self._zero = 0
        self._min = math.inf
        self._max = -math.inf

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        s = self.snapshot()
        return (f"Histogram({self.name} n={s['count']} p50={s['p50']:g} "
                f"p99={s['p99']:g})")


_Metric = Counter | Gauge | Histogram


class MetricsRegistry:
    """Get-or-create registry keyed by metric name.

    Names are dotted lowercase (``engine.read_repairs``,
    ``frontdoor.queue_wait_s``) but the registry itself imposes no
    scheme — the owners do.  Asking for an existing name with a
    different kind is a bug and raises ``TypeError`` rather than
    silently shadowing.
    """

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, name: str, cls: type) -> _Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name)
        elif type(m) is not cls:
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get_or_create(name, Histogram)

    def get(self, name: str) -> _Metric | None:
        return self._metrics.get(name)

    def value(self, name: str) -> float:
        """Scalar value of a counter/gauge (KeyError if absent)."""
        m = self._metrics[name]
        if isinstance(m, Histogram):
            raise TypeError(f"{name!r} is a histogram; use get().snapshot()")
        return m.value

    def catalog(self) -> tuple[str, ...]:
        """Sorted names of every registered metric — the audit surface
        the counter-coverage tests walk."""
        return tuple(sorted(self._metrics))

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __iter__(self) -> Iterator[_Metric]:
        for name in sorted(self._metrics):
            yield self._metrics[name]

    def as_dict(self) -> dict[str, float]:
        """Flat snapshot: counters/gauges as ``{name: value}``,
        histograms exploded to ``{name.p50, name.p95, name.p99,
        name.count, name.sum, name.max}``."""
        out: dict[str, float] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                for k, v in m.snapshot().items():
                    out[f"{name}.{k}"] = v
            else:
                out[name] = m.value
        return out

    def reset(self) -> None:
        """Zero every metric in place (handles held by owners stay
        valid — this is the single ``reset_stats()`` primitive)."""
        for m in self._metrics.values():
            m.reset()
