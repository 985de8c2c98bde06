"""Serving layer of the port: the overload-safe front door
(:mod:`repro_torch.serving.frontdoor`) over a port ``HREngine``, its
admission guards (:mod:`repro_torch.serving.admission`), and the LM
serving steps (:mod:`repro_torch.serving.steps`, loaded on first use so
that the front door does not load the models)."""

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
    "make_prefill_step",
    "make_decode_step",
]


def __getattr__(name: str):
    if name in ("make_prefill_step", "make_decode_step"):
        from . import steps

        return getattr(steps, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
