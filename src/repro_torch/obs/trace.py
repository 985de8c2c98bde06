"""Structured tracing: explicit-parent spans carried through call
arguments.

Context propagation is *explicit*: a caller that wants a subtree
passes its span as the ``trace=`` argument and the callee creates
children with :meth:`Span.child`.  There are no thread-locals and no
ambient "current span" — the FrontDoor's virtual-clock event loop
interleaves many requests in one thread, and deterministic replay
(the chaos byte-identity property) requires that span identity be a
pure function of the call tree, not of scheduler interleaving.

Span taxonomy
=============

Stage names are a public, stable contract — exporters, the bench
gate's stage breakdown, and downstream dashboards key on them.

Serving tier (virtual-clock timestamps from the FrontDoor event loop):

== ========================== ===========================================
.. ``frontdoor.request``      root, one per submitted request; attrs
                              ``idx``, ``priority``, ``level``; ends at
                              completion with ``status`` and
                              ``latency_s``
.. ``frontdoor.admission``    admission-guard verdict; attr ``outcome``
                              (admitted / throttle / bulkhead /
                              queue_full)
.. ``frontdoor.queue``        arrival -> batch launch wait
.. ``frontdoor.shed``         overload or deadline shed verdict
.. ``frontdoor.service``      batch launch -> completion; engine subtree
                              hangs below
.. ``frontdoor.batch``        root for a multi-request batch launch;
                              member request roots carry ``batch`` attrs
                              pointing at its ``span_id``
== ========================== ===========================================

Engine read path (tracer-clock timestamps):

== =============================== ======================================
.. ``engine.read``                 scalar fast-path read; attrs ``cf``,
                                   ``level``
.. ``engine.read_many``            attrs ``cf``, ``queries``, ``level``
.. ``engine.plan``                 cost-model routing + schedule pick
.. ``engine.scatter``              partition routing (partitioned CFs);
                                   per-partition ``engine.partition``
                                   children with attr ``partition``
.. ``engine.group_scan``           one (replica, node) group execution;
                                   attrs ``replica``, ``node``,
                                   ``queries``, ``hedged``, ``retry``
.. ``engine.flush_barrier``        read-barrier flush of staged writes
.. ``engine.cache_probe``          result-cache lookup; attrs ``hits``,
                                   ``misses``
.. ``engine.scan``                 memtable + sorted-run scan of the
                                   cache misses; attr ``rows``
.. ``view.serve``                  view-eligible aggregates answered
                                   from the materialized per-block
                                   partials (O(blocks touched), no full
                                   scan); attrs ``queries``,
                                   ``boundary_rows``,
                                   ``boundary_blocks``
.. ``engine.host_scan``            NumPy fallback when the column family
                                   is not device-resident
.. ``kernel.scan_launch``          fused device locate+scan launch wall
                                   (includes the host sync)
.. ``kernel.select_compact``       device select-index compaction launch
.. ``engine.digest``               digest-read consistency pass; attrs
                                   ``level``, ``replicas``
.. ``engine.read_repair``          one replica repair; attr ``replica``
.. ``engine.gather``               scatter results stitched back to
                                   request order
== =============================== ======================================

Engine write path:

== =========================== ==========================================
.. ``engine.write``            attrs ``cf``, ``rows``
.. ``engine.log_append``       commit-log appends (attr ``partitions``)
.. ``engine.memtable_stage``   per-replica memtable staging + hints
.. ``engine.flush``            one replica flush; attrs ``replica``,
                               ``rows``
.. ``engine.flush_merge``      sorted-run merge inside a flush
.. ``view.build``              per-block partial (re)build; attr
                               ``rows``, plus ``incremental=True`` when
                               a flush extended the existing partials
                               in O(run) instead of rebuilding
.. ``engine.compaction``       run-stack compaction triggered by a flush
== =========================== ==========================================

Harness roots:

== ==================== =================================================
.. ``chaos.probe``      one per chaos-harness QUORUM victim probe; attrs
                        ``tag`` (step label), ``probe`` (query index);
                        the byte-determinism fixture uses these with a
                        :class:`TickClock` tracer
== ==================== =================================================

Timestamps come from the tracer's clock: ``time.perf_counter`` by
default (honest walls for benchmarks), the FrontDoor's virtual clock
for ``frontdoor.*`` spans (passed explicitly via ``t=``), or
:class:`TickClock` — a deterministic integer counter — when byte-exact
trace equality across runs matters (chaos replay). Span ids are
sequential per tracer, so identity is also deterministic.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterator

__all__ = ["Span", "TickClock", "Tracer", "walk"]


class TickClock:
    """Deterministic clock: each read returns the next integer tick.

    Used by the chaos determinism tests — span timestamps become a
    pure function of the number of prior clock reads, so two runs of
    the same seeded schedule export byte-identical traces.
    """

    __slots__ = ("_t",)

    def __init__(self, start: int = 0):
        self._t = start

    def __call__(self) -> float:
        t = self._t
        self._t = t + 1
        return float(t)


class Span:
    """One timed stage. Children are created via :meth:`child`, never
    by mutating ``parent_id`` — the tree is built top-down and stays
    consistent by construction."""

    __slots__ = ("tracer", "name", "span_id", "parent_id", "t_start",
                 "t_end", "attrs", "children")

    def __init__(self, tracer: "Tracer", name: str, span_id: int,
                 parent_id: int | None, t_start: float,
                 attrs: dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_start = t_start
        self.t_end: float | None = None
        self.attrs = attrs
        self.children: list[Span] = []

    def child(self, name: str, *, t: float | None = None, **attrs: Any) -> "Span":
        """Open a child span (explicit parent: ``self``)."""
        s = self.tracer._make(name, self.span_id, t, attrs)
        self.children.append(s)
        return s

    def end(self, *, t: float | None = None, **attrs: Any) -> "Span":
        """Close the span; extra attrs merge in. Returns self."""
        self.t_end = self.tracer.now() if t is None else float(t)
        if attrs:
            self.attrs.update(attrs)
        return self

    def annotate(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def wall(self) -> float:
        """Duration in the span's own time base (0 while open)."""
        return 0.0 if self.t_end is None else self.t_end - self.t_start

    def to_dict(self) -> dict[str, Any]:
        """JSON-ready nested dict (deterministic: attrs sorted)."""
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "attrs": {k: self.attrs[k] for k in sorted(self.attrs)},
            "children": [c.to_dict() for c in self.children],
        }

    def find(self, name: str) -> "Span | None":
        """First span named ``name`` in pre-order, self included."""
        for s in walk(self):
            if s.name == name:
                return s
        return None

    def find_all(self, name: str) -> list["Span"]:
        return [s for s in walk(self) if s.name == name]

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        state = f"{self.wall:g}" if self.t_end is not None else "open"
        return f"Span({self.name}#{self.span_id} {state})"


def walk(span: Span) -> Iterator[Span]:
    """Pre-order iteration over a span tree."""
    stack = [span]
    while stack:
        s = stack.pop()
        yield s
        stack.extend(reversed(s.children))


class Tracer:
    """Span factory with a pluggable clock and sequential ids.

    ``clock`` is any zero-arg callable returning a float; the default
    is ``time.perf_counter``.  ``Tracer(clock=TickClock())`` gives
    fully deterministic traces.  The tracer keeps a list of root spans
    (``roots``) so a harness can export everything it produced.
    """

    def __init__(self, clock: Callable[[], float] | None = None):
        self.clock = clock if clock is not None else time.perf_counter
        self.roots: list[Span] = []
        self._next_id = 0
        self.spans_started = 0

    def now(self) -> float:
        return self.clock()

    def _make(self, name: str, parent_id: int | None,
              t: float | None, attrs: dict[str, Any]) -> Span:
        sid = self._next_id
        self._next_id = sid + 1
        self.spans_started += 1
        t0 = self.now() if t is None else float(t)
        return Span(self, name, sid, parent_id, t0, attrs)

    def root(self, name: str, *, t: float | None = None, **attrs: Any) -> Span:
        """Open a new root span (one per request / probe / batch)."""
        s = self._make(name, None, t, attrs)
        self.roots.append(s)
        return s

    def clear(self) -> None:
        """Drop accumulated roots (ids keep counting up)."""
        self.roots.clear()
