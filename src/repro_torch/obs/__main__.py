"""Trace report CLI: ``python -m repro_torch.obs TRACE.jsonl``.

Loads a JSON-lines trace dump (as written by ``dump_jsonl`` — e.g.
``python -m repro_torch.ft.chaos --overload --trace out.jsonl``) and
prints the stage breakdown plus the slowest span trees.  Exits
non-zero on malformed JSON-lines or an empty dump, which is exactly
the contract a traced run's check relies on.
"""

from __future__ import annotations

import argparse
import sys

from .export import load_jsonl, render_report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="render a human-readable report from a JSON-lines "
                    "trace dump",
    )
    ap.add_argument("trace", help="JSON-lines trace file (one span tree per line)")
    ap.add_argument("--top", type=int, default=5,
                    help="how many slowest trees to print in full (default 5)")
    ap.add_argument("--unit", choices=("s", "ms", "us", "ticks"), default="ms",
                    help="time unit for rendering (default ms; use 'ticks' "
                         "for TickClock traces)")
    args = ap.parse_args(argv)

    try:
        docs = load_jsonl(args.trace)
    except (OSError, ValueError) as e:
        print(f"[obs] ERROR: {e}", file=sys.stderr)
        return 1
    if not docs:
        print(f"[obs] ERROR: {args.trace} holds no span trees "
              "(empty slow-query log?)", file=sys.stderr)
        return 1
    print(render_report(docs, top=args.top, unit=args.unit), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
