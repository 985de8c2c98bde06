"""Heterogeneous-replica core of the port: composite keys → SortedTable →
ECDF stats → cost model (Eq 1–4) → HRCA (Alg 1) → HREngine (paper §4),
with materialized per-slab views on device-resident replicas and the
availability layer (hinted handoff, digest reads with read repair, hedged
reads and failover, recovery, scrub), ring migration and read deadlines."""

from .cost_model import CostModel, LinearCostFunction, estimate_rows, estimate_rows_many
from .ecdf import ColumnStats, TableStats
from .engine import (
    ALL,
    CONSISTENCY_LEVELS,
    ONE,
    QUORUM,
    ColumnFamily,
    CorruptRunError,
    DeadlineExceeded,
    HREngine,
    Node,
    ReadReport,
    TransientFault,
    TransientFlushError,
    TransientReadError,
)
from .hrca import HRCAResult, hrca, initial_state
from .keys import KeySchema, pack_columns, pack_tuple
from .ring import Partition, ReplicaHandle, TokenHistogram, TokenRing, place_replica
from .storage import (
    VIEW_ROWS_CAP,
    CommitLog,
    CompactionPolicy,
    Memtable,
    SortedRun,
    query_view_eligible,
    verify_views,
)
from .table import (
    ScanResult,
    SortedTable,
    merge_partial_scans,
    slab_bounds_for,
    slab_bounds_many,
)
from .workload import Eq, Query, Range, Workload, random_workload

__all__ = [
    "CostModel",
    "LinearCostFunction",
    "estimate_rows",
    "estimate_rows_many",
    "ColumnStats",
    "TableStats",
    "ONE",
    "QUORUM",
    "ALL",
    "CONSISTENCY_LEVELS",
    "ColumnFamily",
    "CorruptRunError",
    "DeadlineExceeded",
    "TransientFault",
    "TransientReadError",
    "TransientFlushError",
    "HREngine",
    "Node",
    "ReadReport",
    "HRCAResult",
    "hrca",
    "initial_state",
    "KeySchema",
    "pack_columns",
    "pack_tuple",
    "Partition",
    "ReplicaHandle",
    "TokenHistogram",
    "TokenRing",
    "place_replica",
    "CommitLog",
    "CompactionPolicy",
    "Memtable",
    "SortedRun",
    "VIEW_ROWS_CAP",
    "query_view_eligible",
    "verify_views",
    "ScanResult",
    "SortedTable",
    "merge_partial_scans",
    "slab_bounds_for",
    "slab_bounds_many",
    "Eq",
    "Query",
    "Range",
    "Workload",
    "random_workload",
]
