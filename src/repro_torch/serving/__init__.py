"""Serving layer of the port: the overload-safe front door
(:mod:`repro_torch.serving.frontdoor`) over a port ``HREngine``, and its
admission guards (:mod:`repro_torch.serving.admission`)."""

from .admission import Bulkhead, RetryAfter, TokenBucket
from .frontdoor import (
    FRONTDOOR_COUNTERS,
    REFUSAL_COUNTERS,
    RUNG_COUNTERS,
    FrontDoor,
    Request,
    Response,
)

__all__ = [
    "Bulkhead",
    "RetryAfter",
    "TokenBucket",
    "FRONTDOOR_COUNTERS",
    "REFUSAL_COUNTERS",
    "RUNG_COUNTERS",
    "FrontDoor",
    "Request",
    "Response",
]
