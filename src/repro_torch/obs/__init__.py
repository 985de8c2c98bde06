"""Observability of the port: metrics registry, structured tracing,
slow-query forensics.

* :mod:`repro_torch.obs.metrics` — counters, gauges and log-bucketed
  latency histograms behind a get-or-create
  :class:`~repro_torch.obs.metrics.MetricsRegistry`; ``HREngine.stats``
  and ``FrontDoor.stats`` are read-through views over their registries.
* :mod:`repro_torch.obs.trace` — explicit-parent spans (context is a
  call argument, never a thread-local) with a pluggable clock;
  :class:`~repro_torch.obs.trace.TickClock` makes traces
  byte-deterministic for seeded chaos replay. The stage names are a
  public contract, listed in that module's docstring; the engine opens
  them on the ``trace=`` span it is given, down to the kernel launches.
* :mod:`repro_torch.obs.export` — K-slowest span-tree log,
  deterministic JSON-lines dump/load, and the ``python -m
  repro_torch.obs`` report CLI.
"""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import Span, TickClock, Tracer, walk
from .export import (
    SlowQueryLog,
    dump_jsonl,
    format_tree,
    load_jsonl,
    render_report,
    span_to_line,
    stage_totals,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "TickClock",
    "Tracer",
    "walk",
    "SlowQueryLog",
    "dump_jsonl",
    "load_jsonl",
    "span_to_line",
    "stage_totals",
    "format_tree",
    "render_report",
]
