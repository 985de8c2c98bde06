"""Observability of the port: the metrics registry the engine's counters
hang on. Span tracing is not ported yet; the engine keeps ``trace=None``
parameters and calls ``.child()``/``.end()`` on whatever span it is given."""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
