"""Automatic compaction policy for device-resident run stacks.

Flushed memtable runs are *appended* to a resident table's device arrays
(``device_state_append``): reads stay exact at any run count, but each
run adds an O(N) ``row_map`` maintenance cost on the host. This policy
bounds the stack: a replica is compacted when its appended rows exceed
``appended_frac`` of the base run, or when the run count alone exceeds
``max_runs`` (many small flushes). Compaction runs the hand-written
merge-rank kernel (``SortedTable.compact_runs`` →
``repro_torch.kernels.merge_device_runs``), collapsing the runs *on
device* — no host re-upload.
"""

from __future__ import annotations

import dataclasses

__all__ = ["CompactionPolicy", "compact_table"]


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """Threshold rule: compact when appended rows outgrow the base run
    (``appended_frac``) or the stack outgrows ``max_runs``.

    Every compaction folds the appended rows into the base, so the
    *next* ``appended_frac`` trigger needs ``appended_frac ×`` the new,
    larger base — a geometric full-merge cadence. Under a steady drip of
    small writes that trigger therefore goes quiet and ``max_runs``
    becomes the binding rule, bounding the run stack at one full merge
    per ``max_runs`` flushes. ``base_rows`` is always ``run_starts[1]``
    of the live device state, and an append onto an *empty* base becomes
    the base run itself rather than a phantom appended run
    (``device_state_append``)."""

    appended_frac: float = 0.5
    max_runs: int = 8

    def __post_init__(self) -> None:
        if self.appended_frac < 0:
            raise ValueError("appended_frac must be >= 0")
        if self.max_runs < 1:
            raise ValueError("max_runs must be >= 1")

    def should_compact(
        self, *, base_rows: int, appended_rows: int, n_runs: int
    ) -> bool:
        if n_runs <= 1:
            return False
        if n_runs > self.max_runs:
            return True
        return appended_rows > self.appended_frac * max(base_rows, 1)


def compact_table(table, policy: CompactionPolicy) -> bool:
    """Apply ``policy`` to one table; returns True when a compaction ran.

    Host tables never compact (the host merge path is always fully
    merged — runs are a device-residency structure only).
    """
    state = getattr(table, "_device", None)
    if state is None or state.get("n_runs", 1) <= 1:
        return False
    run_starts = state["run_starts"]
    base_rows = int(run_starts[1]) if len(run_starts) > 1 else int(state["n_rows"])
    appended = int(state["n_rows"]) - base_rows
    if not policy.should_compact(
        base_rows=base_rows, appended_rows=appended, n_runs=int(state["n_runs"])
    ):
        return False
    table.compact_runs()
    return True
