"""Fault tolerance of the port: the accrual failure detector the engine's
planner consults (``ft.detector``), straggler injection (``ft.straggler``),
failure plans (``ft.failures``) and the seeded chaos and overload harnesses
(``ft.chaos``, imported on its own: it pulls in the front door)."""

from .detector import FailureDetector, LatencyEWMA
from .failures import FailureInjector, FailurePlan
from .straggler import TailStats, clear_slowdowns, inject_slowdown, measure_tail

__all__ = [
    "FailureDetector",
    "LatencyEWMA",
    "FailureInjector",
    "FailurePlan",
    "TailStats",
    "clear_slowdowns",
    "inject_slowdown",
    "measure_tail",
]
