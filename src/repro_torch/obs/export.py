"""Slow-query log and trace exporters.

:class:`SlowQueryLog` keeps the K slowest span trees seen so far (a
bounded min-heap keyed on root latency — the "ring buffer" of
forensics targets).  Export is JSON-lines: one span tree per line,
``sort_keys=True`` and no whitespace variance, so identical traces
serialize to identical bytes (the chaos determinism property is
asserted on these bytes).  ``python -m repro_torch.obs`` renders the
human-readable report.

The stage names rendered here are the public taxonomy documented in
:mod:`repro_torch.obs.trace` — ``stage_totals`` aggregates by exactly those
names: the per-stage breakdown a serving run reports.
"""

from __future__ import annotations

import heapq
import io
import json
from typing import Any, Iterable, TextIO

from .trace import Span

__all__ = [
    "SlowQueryLog",
    "dump_jsonl",
    "load_jsonl",
    "span_to_line",
    "stage_totals",
    "format_tree",
    "render_report",
]


class SlowQueryLog:
    """Bounded log of the K slowest span trees.

    ``offer(span, latency)`` keeps the tree iff it ranks among the K
    slowest so far; ``latency`` defaults to the root span's wall.
    Ties break on insertion order (earlier entry survives), keeping
    the contents deterministic for equal-latency streams.
    """

    def __init__(self, k: int = 32):
        if k <= 0:
            raise ValueError("k must be positive")
        self.k = k
        self._seq = 0
        # min-heap of (latency, seq, span): root is the *fastest* kept
        # entry, evicted first when a slower tree arrives
        self._heap: list[tuple[float, int, Span]] = []

    def __len__(self) -> int:
        return len(self._heap)

    def offer(self, span: Span, latency: float | None = None) -> bool:
        """Consider a finished span tree; True if kept."""
        lat = span.wall if latency is None else float(latency)
        item = (lat, self._seq, span)
        self._seq += 1
        if len(self._heap) < self.k:
            heapq.heappush(self._heap, item)
            return True
        # evict-or-reject against the fastest kept entry; strict > so
        # an equal-latency newcomer loses to the incumbent
        if lat > self._heap[0][0]:
            heapq.heapreplace(self._heap, item)
            return True
        return False

    def entries(self) -> list[tuple[float, Span]]:
        """(latency, tree) pairs, slowest first (stable order)."""
        return [(lat, span) for lat, _seq, span
                in sorted(self._heap, key=lambda it: (-it[0], it[1]))]

    def reset(self) -> None:
        self._heap.clear()
        self._seq = 0


def span_to_line(span: Span, latency: float | None = None) -> str:
    """One deterministic JSON line for a span tree."""
    doc: dict[str, Any] = span.to_dict()
    if latency is not None:
        doc = {"latency": latency, "tree": doc}
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def dump_jsonl(entries: Iterable[tuple[float, Span] | Span],
               out: TextIO | str) -> int:
    """Write span trees (or ``(latency, tree)`` pairs) as JSON-lines.

    ``out`` is a path or an open text file; returns the line count.
    """
    if isinstance(out, str):
        with open(out, "w") as f:
            return dump_jsonl(entries, f)
    n = 0
    for e in entries:
        if isinstance(e, Span):
            out.write(span_to_line(e))
        else:
            lat, span = e
            out.write(span_to_line(span, lat))
        out.write("\n")
        n += 1
    return n


def load_jsonl(src: TextIO | str) -> list[dict[str, Any]]:
    """Parse a JSON-lines trace dump back into span-tree dicts.

    Raises ``ValueError`` naming the offending line on malformed input
    — a traced run's check depends on this being loud.
    """
    if isinstance(src, str):
        with open(src) as f:
            return load_jsonl(f)
    out: list[dict[str, Any]] = []
    for lineno, line in enumerate(src, 1):
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"malformed JSON-lines trace at line {lineno}: {e}")
        if not isinstance(doc, dict):
            raise ValueError(f"line {lineno}: expected an object, got "
                             f"{type(doc).__name__}")
        tree = doc.get("tree", doc)
        if "name" not in tree or "span_id" not in tree:
            raise ValueError(f"line {lineno}: not a span tree (missing "
                             "name/span_id)")
        out.append(doc)
    return out


def _walk_dict(tree: dict[str, Any]):
    stack = [tree]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(reversed(node.get("children", ())))


def _node_wall(node: dict[str, Any]) -> float:
    t0, t1 = node.get("t_start"), node.get("t_end")
    if t0 is None or t1 is None:
        return 0.0
    return float(t1) - float(t0)


def stage_totals(trees: Iterable[dict[str, Any] | Span]) -> dict[str, dict[str, float]]:
    """Aggregate wall time by stage name across span trees.

    Returns ``{stage: {"count": n, "total": seconds}}`` sorted by
    descending total — the per-stage breakdown the serving benchmark
    publishes.  Accepts live ``Span`` roots or exported dicts.
    """
    agg: dict[str, list[float]] = {}
    for t in trees:
        if isinstance(t, Span):
            t = t.to_dict()
        t = t.get("tree", t)
        for node in _walk_dict(t):
            slot = agg.setdefault(node["name"], [0, 0.0])
            slot[0] += 1
            slot[1] += _node_wall(node)
    ordered = sorted(agg.items(), key=lambda kv: (-kv[1][1], kv[0]))
    return {name: {"count": c, "total": tot} for name, (c, tot) in ordered}


def format_tree(tree: dict[str, Any] | Span, *, unit: str = "s") -> str:
    """Indented one-tree rendering: name, wall, attrs."""
    if isinstance(tree, Span):
        tree = tree.to_dict()
    tree = tree.get("tree", tree)
    scale = {"s": 1.0, "ms": 1e3, "us": 1e6, "ticks": 1.0}[unit]
    lines: list[str] = []

    def rec(node: dict[str, Any], depth: int) -> None:
        wall = _node_wall(node) * scale
        attrs = node.get("attrs") or {}
        attr_s = " ".join(f"{k}={attrs[k]}" for k in sorted(attrs))
        lines.append(
            f"{'  ' * depth}{node['name']}  {wall:,.3f}{unit}"
            + (f"  [{attr_s}]" if attr_s else "")
        )
        for c in node.get("children", ()):
            rec(c, depth + 1)

    rec(tree, 0)
    return "\n".join(lines)


def render_report(docs: list[dict[str, Any]], *, top: int = 5,
                  unit: str = "ms") -> str:
    """Human-readable report over an exported trace dump: stage
    breakdown table plus the ``top`` slowest trees in full."""
    buf = io.StringIO()
    totals = stage_totals(docs)
    scale = {"s": 1.0, "ms": 1e3, "us": 1e6, "ticks": 1.0}[unit]
    buf.write(f"trace report: {len(docs)} span trees\n\n")
    buf.write("stage breakdown (total wall, descending):\n")
    width = max((len(n) for n in totals), default=10)
    for name, row in totals.items():
        buf.write(
            f"  {name:<{width}}  n={row['count']:>6}  "
            f"total={row['total'] * scale:>12,.3f}{unit}\n"
        )

    def latency(doc: dict[str, Any]) -> float:
        if "latency" in doc:
            return float(doc["latency"])
        return _node_wall(doc.get("tree", doc))

    slowest = sorted(docs, key=latency, reverse=True)[:top]
    if slowest:
        buf.write(f"\nslowest {len(slowest)} trees:\n")
        for i, doc in enumerate(slowest, 1):
            buf.write(f"\n#{i}  latency={latency(doc) * scale:,.3f}{unit}\n")
            buf.write(format_tree(doc, unit=unit))
            buf.write("\n")
    return buf.getvalue()
