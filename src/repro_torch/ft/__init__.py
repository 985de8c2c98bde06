"""Fault tolerance of the port: the accrual failure detector the engine's
planner consults (``ft.detector``)."""

from .detector import FailureDetector, LatencyEWMA

__all__ = ["FailureDetector", "LatencyEWMA"]
