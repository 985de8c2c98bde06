"""Failure simulation + recovery orchestration.

``FailurePlan`` injects node failures at chosen steps; a step-loop
driver responds by: (1) rebuilding lost data-index replicas through the
HR engine's Recovery module (log replay or survivor re-sort), (2)
restarting the step loop from the last checkpoint. This is the single-host simulation of the pod-level
contract: checkpoint/restart + replica rebuild, with straggler hedging
handled in ``ft.straggler``, suspicion-based routing in
``ft.detector`` and randomized multi-fault scheduling in ``ft.chaos``.

Two outage shapes, per plan entry:

* ``durations`` absent or 0 — the legacy instant fail-and-recover: the
  node goes down and is rebuilt within the same ``maybe_fail`` call
  (what a driver that only checkpoints/restarts expects).
* ``durations[i] > 0`` — an *open outage*: the node stays down for
  that many steps while the cluster serves degraded, then
  ``maybe_recover`` (or ``tick``) heals it — via hinted handoff
  (``HREngine.node_up``) when the plan is ``transient``, else the full
  ``recover_node`` rebuild.

Entries sharing a step all fire at that step (each against its own
node) — indexing the plan by entry, not by step value, is what makes
repeated steps well defined.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import HREngine

__all__ = ["FailurePlan", "FailureInjector"]


@dataclasses.dataclass(frozen=True)
class FailurePlan:
    fail_at_steps: tuple[int, ...] = ()
    nodes: tuple[int, ...] = ()  # node failing at each entry (cycled)
    durations: tuple[int, ...] = ()  # outage length in steps (cycled; 0 = instant)
    transient: bool = False  # transient outage (heal = node_up) vs node loss

    def entry(self, idx: int) -> tuple[int, int, int]:
        """(step, node, duration) of plan entry ``idx``."""
        step = self.fail_at_steps[idx]
        node = self.nodes[idx % len(self.nodes)] if self.nodes else 0
        dur = self.durations[idx % len(self.durations)] if self.durations else 0
        return step, node, dur


class FailureInjector:
    def __init__(self, plan: FailurePlan, engine: HREngine | None) -> None:
        self.plan = plan
        self.engine = engine
        self.log: list[dict] = []
        # plan entry indices already fired — NOT step values: two
        # entries at the same step are distinct failures, and after a
        # checkpoint-restart rewind a fired entry must not re-fire
        self._fired: set[int] = set()
        self._open: list[dict] = []  # outages awaiting recovery

    @property
    def open_outages(self) -> list[dict]:
        """Outages currently down, each ``{"node", "recover_step"}``."""
        return [dict(o) for o in self._open]

    def maybe_fail(self, step: int) -> bool:
        """Fire every not-yet-fired plan entry scheduled at ``step``.
        Zero-duration entries fail and recover atomically (legacy
        shape); positive durations leave the node down until
        ``maybe_recover`` reaches ``step + duration``."""
        fired = False
        for idx in range(len(self.plan.fail_at_steps)):
            entry_step, node, dur = self.plan.entry(idx)
            if entry_step != step or idx in self._fired:
                continue
            self._fired.add(idx)
            fired = True
            secs = 0.0
            if self.engine is not None:
                self.engine.fail_node(node, transient=self.plan.transient)
                if dur <= 0:
                    secs = self._heal(node)
            if dur > 0:
                self._open.append({"node": node, "recover_step": step + dur})
            self.log.append(
                {
                    "step": step,
                    "node": node,
                    "duration": dur,
                    "recovery_s": secs,
                }
            )
        return fired

    def maybe_recover(self, step: int) -> bool:
        """Heal every open outage whose recovery step has arrived."""
        due = [o for o in self._open if o["recover_step"] <= step]
        if not due:
            return False
        self._open = [o for o in self._open if o["recover_step"] > step]
        for o in due:
            secs = self._heal(o["node"]) if self.engine is not None else 0.0
            self.log.append(
                {"step": step, "node": o["node"], "recovered": True,
                 "recovery_s": secs}
            )
        return True

    def tick(self, step: int) -> bool:
        """One driver step: recoveries due first (a node can come back
        the same step another goes down), then new failures."""
        recovered = self.maybe_recover(step)
        failed = self.maybe_fail(step)
        return recovered or failed

    def _heal(self, node: int) -> float:
        if self.plan.transient:
            return self.engine.node_up(node)
        return self.engine.recover_node(node)
