"""Durable write path — commit log → memtable → sorted runs (paper §4).

Every write is first appended to a layout-agnostic :class:`CommitLog`
shared by all replicas of the column family, staged in each replica's
:class:`Memtable`, and flushed as an immutable sorted run in the
replica's own key layout (``SortedTable.merge_run``).
:class:`CompactionPolicy` bounds how many flushed runs a device-resident
replica accumulates before the merge-rank kernel collapses them on the
device.
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
]
