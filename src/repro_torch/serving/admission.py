"""Admission control primitives for the serving front door.

Two classic overload guards, both deterministic over a *virtual* clock
(the caller passes ``now`` explicitly — no wall-clock reads, so seeded
serving simulations replay exactly):

* :class:`TokenBucket` — rate limiting with burst tolerance. A request
  that arrives with no token available is rejected with
  :class:`RetryAfter` carrying the exact time until a token refills;
  the front door turns that into an explicit backpressure response
  instead of letting the queue grow without bound.
* :class:`Bulkhead` — bounded outstanding work per *compartment* (the
  front door compartments by ``(column family, pinned partition)``).
  One hot column family or hot partition fills only its own
  compartment and starts drawing :class:`RetryAfter`; requests for
  everything else keep their queue slots. Named after the watertight
  ship walls: a flood stays in the flooded compartment.

Rejecting at admission is the point — work that will not finish in
time is cheapest to refuse *before* it holds a queue slot. Everything
past admission (batch forming, degradation, shedding) lives in
:mod:`repro_torch.serving.frontdoor`.
"""

from __future__ import annotations

__all__ = ["RetryAfter", "TokenBucket", "Bulkhead"]


class RetryAfter(RuntimeError):
    """Explicit backpressure: the request was refused at admission and
    the client should retry no sooner than ``retry_after_s`` from now.
    Deliberately an error type, not a silent drop — every refusal is
    visible to the caller and counted in ``frontdoor.stats``.

    ``kind`` names which guard refused (``"rate"``, ``"bulkhead"``, or
    ``"queue"``); the front door maps each kind onto its registry
    counter via :data:`repro_torch.serving.frontdoor.REFUSAL_COUNTERS`, so
    every typed refusal is observable by construction."""

    def __init__(
        self, retry_after_s: float, reason: str, *, kind: str = "admission"
    ) -> None:
        super().__init__(
            f"admission refused ({reason}); retry after {retry_after_s * 1e3:.3f} ms"
        )
        self.retry_after_s = float(retry_after_s)
        self.reason = reason
        self.kind = kind


class TokenBucket:
    """Token-bucket rate limiter over a caller-supplied virtual clock.

    ``rate`` tokens/second refill continuously up to ``burst`` capacity;
    each admitted request spends one token. The bucket starts full, so
    a cold burst of up to ``burst`` requests is admitted before the
    rate binds.
    """

    def __init__(self, rate: float, burst: float) -> None:
        if rate <= 0.0:
            raise ValueError(f"rate must be > 0 tokens/s, got {rate}")
        if burst < 1.0:
            raise ValueError(f"burst must be >= 1 token, got {burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last = 0.0

    def _refill(self, now: float) -> None:
        # monotone virtual clock: a caller stepping backwards would
        # mint tokens out of nothing, so clamp to the last seen time
        if now > self._last:
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
            self._last = now

    def admit(self, now: float) -> None:
        """Spend one token at virtual time ``now`` or raise
        :class:`RetryAfter` with the exact refill wait."""
        self._refill(now)
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return
        raise RetryAfter((1.0 - self._tokens) / self.rate, "rate limit", kind="rate")

    def tokens(self, now: float) -> float:
        """Tokens available at ``now`` (observability only)."""
        self._refill(now)
        return self._tokens


class Bulkhead:
    """Bounded outstanding admissions per compartment.

    ``acquire(key)`` admits one unit of work into compartment ``key``
    (any hashable — the front door uses ``(cf_name, partition_id)``)
    and must be paired with ``release(key)`` when the work completes,
    is shed, or fails. A full compartment raises :class:`RetryAfter`;
    other compartments are unaffected.
    """

    def __init__(self, max_inflight: int, *, retry_after_s: float) -> None:
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if retry_after_s <= 0.0:
            raise ValueError(f"retry_after_s must be > 0, got {retry_after_s}")
        self.max_inflight = int(max_inflight)
        self.retry_after_s = float(retry_after_s)
        self._inflight: dict[object, int] = {}

    def acquire(self, key: object) -> None:
        n = self._inflight.get(key, 0)
        if n >= self.max_inflight:
            raise RetryAfter(
                self.retry_after_s, f"bulkhead full for {key!r}", kind="bulkhead"
            )
        self._inflight[key] = n + 1

    def release(self, key: object) -> None:
        n = self._inflight.get(key, 0)
        if n <= 0:
            raise RuntimeError(f"release without acquire for compartment {key!r}")
        if n == 1:
            del self._inflight[key]
        else:
            self._inflight[key] = n - 1

    def inflight(self, key: object) -> int:
        return self._inflight.get(key, 0)
