"""Assigned-architecture configs (exact published numbers) + smoke configs."""

from .registry import ARCHS, SHAPES, get_arch, get_smoke, shape_applicable

__all__ = ["ARCHS", "SHAPES", "get_arch", "get_smoke", "shape_applicable"]
