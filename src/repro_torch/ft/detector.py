"""Accrual failure detection (phi-style) over per-node scan latencies.

Cassandra never answers "is this node down?" with a boolean — its
phi-accrual detector (Hayashibara et al.) outputs a *suspicion level*
that grows continuously as a node's responses fall outside the latency
distribution its peers establish, and each consumer picks its own
threshold. This module is that idea fitted to the simulated cluster:

* ``record(node_id, latency)`` feeds one measured scan wall time per
  executed replica group (the engine calls it from the read path;
  result-cache hits don't execute and are not samples).
* ``record_failure(node_id)`` feeds a raised scan (injected fault /
  chaos event); consecutive failures add a fixed phi step each, and
  one successful sample clears the streak — the classic accrual shape
  where silence is evidence that accumulates.
* ``phi(node_id)`` is the suspicion level: the failure-streak term plus
  ``-log10 P(latency >= observed mean | peer distribution)`` under a
  normal fit of the *other* nodes' recent samples. Comparing against
  peers, not the node's own history, is what makes a straggler visible:
  its own window would just normalize the slowness away.
* ``cost_factor(node_id)`` maps phi onto the engine's cost matrices:
  1.0 while alive, ``suspect_penalty`` at ``phi >= phi_suspect``,
  ``dead_penalty`` at ``phi >= phi_dead``. The engine *multiplies*
  ranking costs by this factor — soft avoidance (Cassandra's dynamic
  snitch badness threshold), never hard exclusion: a suspected node
  still serves when it is the only replica, and keeps producing the
  samples that can clear its suspicion.

Everything is deterministic — phi is a pure function of the recorded
samples, so seeded chaos schedules replay to identical routing.
"""

from __future__ import annotations

import math
from collections import deque

__all__ = ["FailureDetector", "LatencyEWMA"]

#: sigma floor as a fraction of the peer mean: scan walls are heavy-
#: tailed at microsecond scale, and a near-zero fitted sigma would let
#: scheduler jitter alone push phi past any threshold.
_SIGMA_FLOOR_FRAC = 0.25


class LatencyEWMA:
    """Exponentially-weighted latency tracker: mean plus mean absolute
    deviation of a stream of wall-time samples.

    The serving front door feeds it per-request queue waits and reads
    it to decide when to *hedge* — the same observed-latency idea as
    the phi detector above, but over the front door's own queue rather
    than per-node scan walls, and with a threshold the caller owns
    (``mean() > k × max_wait`` style) instead of a suspicion level.
    Deterministic: the state is a pure fold over the recorded samples.
    """

    def __init__(self, *, alpha: float = 0.2) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self._mean: float | None = None
        self._dev: float = 0.0
        self._count: int = 0

    def record(self, latency_s: float) -> None:
        """Fold one wall-seconds sample into the running estimates."""
        x = float(latency_s)
        if self._mean is None:
            self._mean = x
        else:
            err = abs(x - self._mean)
            self._dev += self.alpha * (err - self._dev)
            self._mean += self.alpha * (x - self._mean)
        self._count += 1

    def mean(self) -> float:
        """Smoothed mean latency (0.0 before any sample)."""
        return 0.0 if self._mean is None else self._mean

    def deviation(self) -> float:
        """Smoothed mean absolute deviation — a cheap spread estimate
        for "how far past the mean is surprising"."""
        return self._dev

    @property
    def count(self) -> int:
        """Samples recorded so far (thresholds often want a warm-up)."""
        return self._count


class FailureDetector:
    """Phi-accrual-style detector over per-node operation latencies."""

    def __init__(
        self,
        *,
        window: int = 32,
        phi_suspect: float = 4.0,
        phi_dead: float = 12.0,
        suspect_penalty: float = 4.0,
        dead_penalty: float = 64.0,
        failure_phi: float = 4.0,
        min_samples: int = 4,
    ) -> None:
        if window < 2:
            raise ValueError("window must be >= 2")
        if not 0 < phi_suspect <= phi_dead:
            raise ValueError("need 0 < phi_suspect <= phi_dead")
        if suspect_penalty < 1.0 or dead_penalty < suspect_penalty:
            raise ValueError("need 1.0 <= suspect_penalty <= dead_penalty")
        self.window = int(window)
        self.phi_suspect = float(phi_suspect)
        self.phi_dead = float(phi_dead)
        self.suspect_penalty = float(suspect_penalty)
        self.dead_penalty = float(dead_penalty)
        self.failure_phi = float(failure_phi)
        self.min_samples = int(min_samples)
        self._samples: dict[int, deque[float]] = {}
        self._failures: dict[int, int] = {}

    # -- feeding -----------------------------------------------------------

    def record(self, node_id: int, latency_s: float) -> None:
        """One successful operation's wall seconds; clears any failure
        streak (the node answered)."""
        self._samples.setdefault(int(node_id), deque(maxlen=self.window)).append(
            float(latency_s)
        )
        self._failures.pop(int(node_id), None)

    def record_failure(self, node_id: int) -> None:
        """One raised/timed-out operation; consecutive failures stack."""
        self._failures[int(node_id)] = self._failures.get(int(node_id), 0) + 1

    # -- reading -----------------------------------------------------------

    def _latency_phi(self, node_id: int) -> float:
        mine = self._samples.get(int(node_id))
        if mine is None or len(mine) < self.min_samples:
            return 0.0
        peers: list[float] = []
        for nid, dq in self._samples.items():
            if nid != int(node_id):
                peers.extend(dq)
        if len(peers) < self.min_samples:
            return 0.0
        mu = sum(peers) / len(peers)
        var = sum((x - mu) ** 2 for x in peers) / len(peers)
        sigma = max(math.sqrt(var), _SIGMA_FLOOR_FRAC * abs(mu), 1e-9)
        recent = sum(mine) / len(mine)
        z = (recent - mu) / sigma
        # one-sided survival under the peer normal; phi = -log10 of it
        sf = 0.5 * math.erfc(z / math.sqrt(2.0))
        return -math.log10(max(sf, 1e-300))

    def phi(self, node_id: int) -> float:
        """Current suspicion level: failure-streak term plus the
        latency-outlier term (0.0 for an unknown / healthy node —
        ``-log10(0.5) ≈ 0.3`` is the at-the-mean baseline)."""
        return self.failure_phi * self._failures.get(
            int(node_id), 0
        ) + self._latency_phi(node_id)

    def state(self, node_id: int) -> str:
        """``"alive"`` | ``"suspected"`` | ``"dead"`` at the configured
        thresholds (a label over :meth:`phi`, for observability)."""
        p = self.phi(node_id)
        if p >= self.phi_dead:
            return "dead"
        if p >= self.phi_suspect:
            return "suspected"
        return "alive"

    def cost_factor(self, node_id: int) -> float:
        """Multiplier the engine applies to this node's ranking costs:
        soft down-ranking, never exclusion."""
        p = self.phi(node_id)
        if p >= self.phi_dead:
            return self.dead_penalty
        if p >= self.phi_suspect:
            return self.suspect_penalty
        return 1.0

    def suspected_nodes(self) -> list[int]:
        """Node ids currently at or past ``phi_suspect``, ascending."""
        return sorted(
            nid
            for nid in set(self._samples) | set(self._failures)
            if self.phi(nid) >= self.phi_suspect
        )
