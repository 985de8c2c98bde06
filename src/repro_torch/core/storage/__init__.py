"""Durable write path — commit log → memtable → sorted runs (paper §4).

Every write is first appended to a layout-agnostic :class:`CommitLog`
shared by all replicas of the column family, staged in each replica's
:class:`Memtable`, and flushed as an immutable sorted run in the
replica's own key layout (``SortedTable.merge_run``).
:class:`CompactionPolicy` bounds how many flushed runs a device-resident
replica accumulates before the merge-rank kernel collapses them on the
device. ``views`` keeps a device-resident replica's materialized per-slab
aggregate view: per-block partial sums, extended at flush and rebuilt at
compaction.
"""

from .commitlog import CommitLog, LogRecord
from .compaction import CompactionPolicy, compact_table
from .memtable import (
    Memtable,
    SortedRun,
    combine_digests,
    content_digest,
    run_crc32,
    sort_run,
)
from .views import (
    VIEW_AGGS,
    VIEW_ROWS_CAP,
    build_views_state,
    extend_views_state,
    query_view_eligible,
    serve_view_many,
    verify_views,
    view_eligible_matrix,
)

__all__ = [
    "CommitLog",
    "LogRecord",
    "CompactionPolicy",
    "compact_table",
    "Memtable",
    "SortedRun",
    "combine_digests",
    "content_digest",
    "run_crc32",
    "sort_run",
    "VIEW_AGGS",
    "VIEW_ROWS_CAP",
    "build_views_state",
    "extend_views_state",
    "query_view_eligible",
    "serve_view_many",
    "verify_views",
    "view_eligible_matrix",
]
