"""PyTorch/CUDA port of the heterogeneous-replica engine (``repro``).

The port mirrors ``repro``'s module names: ``core`` holds the keys,
workloads, statistics, cost model, HRCA, sorted tables, storage and the
engine; ``kernels`` holds the hand-written CUDA kernels of the device read
and write paths (``csrc/``) with their plain PyTorch versions. It imports
neither JAX nor ``repro``: the JAX package is the reference the port is
tested against. Entry points run on CUDA unless the caller asks for the
CPU (``HREngine(device="cpu")``), where every kernel wrapper runs its
plain version.
"""

from .core import HREngine, KeySchema, Query, ScanResult, SortedTable

__all__ = ["HREngine", "KeySchema", "Query", "ScanResult", "SortedTable"]
