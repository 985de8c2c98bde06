"""HR Engine — the shim layer of paper §4 on a simulated cluster, with
device-resident column families served by hand-written CUDA kernels.

The modules of the paper's Figure 3, as far as the port carries them:

  Request Agency    → ``HREngine.read`` / ``read_many`` / ``write``
  Replica Generator → ``create_column_family`` (HRCA at CREATE, then crc32
                      placement of replicas on nodes)
  Cost Evaluator    → ``CostModel`` over live ``TableStats``
  Request Scheduler → cheapest-replica routing with a round-robin tie-break
                      and optional straggler hedging
  Write Scheduler   → commit log → per-replica memtable → flushed sorted
                      runs, each replica merging in its own layout
  Recovery          → rebuild lost replicas from the partition's commit log
                      or by re-sorting a survivor, in their own layouts

It is the reference engine (``repro.core.engine``) on the port's classes:
the same cost matrices, tie rule and round-robin draws pick the same
replica for every query, the same write path produces the same tables and
the same migrations the same rings. On a ``device_resident=True`` column family every replica's table
lives as tensors on the engine's device: each ``read``/``read_many``
replica group is one fused locate+scan launch (plus one select-compaction
launch for selects with matches), each flush appends a run to the resident
tensors, the compaction policy merges the run stack on the device, and
every write's statistics refresh runs the histogram kernel there. With
``views=True`` every replica also keeps a materialized per-slab view
(``storage.views``): view-eligible sums and counts are planned with a
capped row estimate and answered from per-block partials plus
boundary-block rescans, each flush extends the view and each compaction
rebuilds it, on the view kernels.

``partitions > 1`` splits the keyspace over a token ring
(``core.ring``): each partition holds a full heterogeneous replica set of
its rows, its own commit log, memtables, round-robin counter and
statistics. ``read_many`` scatters each query over the partitions its slab
can touch (skipping those whose observed tokens miss it), ranks each
partition's live replicas with that partition's statistics, runs each
(partition, replica) group as above, and gathers the partial answers in
ring order; writes route rows by token to their partitions' logs and
replicas, and feed the column family's token histogram, on the histogram
kernel for a device-resident column family.

Availability (the reference's layer, same semantics and counters):

* **Hinted handoff.** ``fail_node(node, transient=True)`` keeps the node's
  tables and opens a hint per hosted replica: the LSN through which its
  table is flushed (``Partition.hints``/``flushed_lsn``). ``node_up``
  replays only the log tail past the hint and merges it as one sorted run
  (on a resident table: appended to the tensors, the view extended),
  falling back to a full rebuild (``hint_fallbacks``) when the tail is
  gone. ``recover_node`` rebuilds a lost node's replicas from the log or
  from a survivor; a rebuilt replica is placed on the engine's device and
  its view built on the ``block_sums`` kernel.
* **Tunable consistency.** ``consistency="QUORUM"|"ALL"`` executes each
  query on the next cost-ranked replicas up to k and compares
  layout-independent digests (:func:`_result_digest`); a mismatch repairs
  the minority from the partition log and answers from the majority, or,
  with no majority, rebuilds every consulted replica and re-executes.
* **Failure detection and failover.** An attached ``failure_detector``
  (``repro_torch.ft.detector``) is fed one wall per executed replica group
  (``scan_timer`` × the node's slowdown) and multiplies the ranking costs
  of suspected nodes; a scan that raises a :class:`TransientFault`
  (``Node.read_fault_budget``) fails over to the next-ranked untried
  replica (``read_retries``, bounded by ``read_retry_limit``).
* **Scrub.** ``scrub_column_family`` re-verifies every live replica's
  sealed content checksum (over the host columns) and heals mismatches
  from the log; on a views column family it also audits the views against
  the resident tensors and rebuilds corrupt or missing ones.

Ring migration (the reference's contract, ``_reshard``):
``split_partition``, ``merge_partitions`` and ``rebalance`` move ring
boundaries. A partition whose range is unchanged keeps its vnode, log,
tables, memtables, statistics, cache and round-robin counter; every other
range becomes a fresh vnode whose replicas are rebuilt from the
token-sliced logs (staged rows ride along as log records), placed on the
engine's device with their views built by ``block_sums``. A replica placed
on a dead node is left for ``recover_node``. ``rebalance_imbalance`` arms
the post-flush drift trigger on the token histogram.

``write(parallel=True)`` and ``flush_memtables(parallel=True)`` map the
per-replica flush (checksum verify, ``merge_run``, digest extension) over
a shared pool of 8 threads; installation, views, memtable clears, cache
invalidation and compaction stay serial after it. ``deadline_s`` bounds a
read's latency budget: required work raises :class:`DeadlineExceeded`
once it is spent, hedges are skipped.

Batched reads (``read_many``) keep the reference's semantics exactly:
the cost matrix over (replica, query) equals Q×R scalar estimates, one
round-robin draw is consumed per query in batch order, queries are
grouped per chosen replica, and each replica keeps a result cache keyed
by ``(agg, value col, filters)``, invalidated by flushes, compactions,
node failure and recovery.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import zlib
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Mapping, Sequence

import numpy as np
import torch

from ..obs.metrics import MetricsRegistry
from .cost_model import (
    CostModel,
    estimate_rows,
    estimate_rows_many,
    precompute_query_stats,
)
from .ecdf import TableStats
from .hrca import HRCAResult, exhaustive_search, hrca, initial_state
from .keys import KeySchema, pack_columns
from .ring import Partition, ReplicaHandle, TokenHistogram, TokenRing, place_replica
from .storage import CommitLog, CompactionPolicy, Memtable, compact_table
from .storage.memtable import combine_digests, sort_run
from .storage.views import (
    VIEW_AGGS,
    VIEW_ROWS_CAP,
    query_view_eligible,
    verify_views,
    view_eligible_matrix,
)
from .table import ScanResult, SortedTable, merge_partial_scans, slab_bounds_many
from .workload import Query, Workload

__all__ = [
    "Node",
    "ReplicaHandle",
    "ColumnFamily",
    "ReadReport",
    "HREngine",
    "ONE",
    "QUORUM",
    "ALL",
    "CONSISTENCY_LEVELS",
    "TransientFault",
    "TransientReadError",
    "TransientFlushError",
    "CorruptRunError",
    "DeadlineExceeded",
    "ENGINE_COUNTERS",
    "FAULT_COUNTERS",
    "REPAIR_COUNTERS",
    "VIEW_COUNTERS",
    "resolve_device",
]

ONE = "ONE"
QUORUM = "QUORUM"
ALL = "ALL"
CONSISTENCY_LEVELS = (ONE, QUORUM, ALL)


def resolve_device(device=None) -> torch.device:
    """The engine's device: ``cuda`` unless the caller names another.
    Raises when CUDA is asked for (explicitly or by default) and absent —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch.HREngine runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


class TransientFault(RuntimeError):
    """A scan or flush raised in a retryable way (an injected fault). Carries
    the faulting node id; the read planner fails over to the next-ranked
    replica, writers retry the flush."""

    def __init__(self, node_id: int, what: str) -> None:
        super().__init__(f"transient {what} fault on node {node_id}")
        self.node_id = node_id


class TransientReadError(TransientFault):
    def __init__(self, node_id: int) -> None:
        super().__init__(node_id, "read")


class TransientFlushError(TransientFault):
    def __init__(self, node_id: int) -> None:
        super().__init__(node_id, "flush")


class CorruptRunError(RuntimeError):
    """A flushed run failed its crc32 verification before merging."""


class DeadlineExceeded(RuntimeError):
    """A read's latency budget (``deadline_s``) was spent before the answer
    was complete: the request is shed explicitly instead of served late.
    Not a :class:`TransientFault`, so failover never swallows it."""

    def __init__(self, budget_s: float | None = None) -> None:
        what = (
            "read deadline budget spent before the answer completed"
            if budget_s is None
            else f"read deadline budget of {budget_s * 1e3:.3f} ms spent "
            "before the answer completed"
        )
        super().__init__(what)
        self.budget_s = budget_s


#: Registry counters every engine registers at construction, under the
#: names the ``stats`` dict view exposes them by.
ENGINE_COUNTERS = (
    "result_cache_hits",
    "result_cache_misses",
    "commitlog_auto_checkpoints",
    "memtable_flushes",
    "compactions",
    # (partition, query) pairs the scatter path skipped: the partition's
    # observed tokens provably miss the query's slab
    "empty_partition_skips",
    # ring migration: boundaries added and removed, rows whose partition
    # a migration rebuilt
    "partition_splits",
    "partition_merges",
    "rebalance_rows_moved",
    # availability: writes that accrued a hint for a transiently-down
    # replica; node-up heals served from the hinted tail and full-rebuild
    # fallbacks; digest reads; failover retries; scrub activity
    "hints_queued",
    "hint_replays",
    "hint_rows_replayed",
    "hint_fallbacks",
    "digest_mismatches",
    "read_repairs",
    "read_retries",
    "scrub_checks",
    "scrub_repairs",
    # typed refusals, and faults raised or survived by failover
    "deadline_exceeded",
    "read_faults",
    "flush_faults",
    "corrupt_runs",
    "flush_wall_seconds",
    # materialized per-slab views: queries the view path answered, live
    # rows of the boundary blocks it rescanned, and full view rebuilds
    # (compaction; CREATE and flush extensions are not rebuilds)
    "view_hits",
    "view_boundary_rows",
    "view_rebuilds",
)

#: Typed refusal or fault → the registry counter that records it: every
#: exception type the engine raises, or survives by failover.
FAULT_COUNTERS: dict[str, str] = {
    "DeadlineExceeded": "deadline_exceeded",
    "TransientReadError": "read_faults",
    "TransientFlushError": "flush_faults",
    "CorruptRunError": "corrupt_runs",
}

#: Repair paths: each increments its counter whenever it runs.
REPAIR_COUNTERS = (
    "hint_replays",
    "hint_fallbacks",
    "read_repairs",
    "scrub_repairs",
)

#: Materialized per-slab views: queries the view path answered, boundary
#: rows it rescanned, full partial rebuilds (CREATE and flush extensions
#: excluded).
VIEW_COUNTERS = (
    "view_hits",
    "view_boundary_rows",
    "view_rebuilds",
)

# a parallel flush's pool threads share nodes' fault budgets, the failure
# detector and the fault counters; each check-and-charge holds this lock
_FLUSH_BOOKKEEPING = threading.Lock()


def _deadline_at(deadline_s: float | None) -> float | None:
    """Absolute ``perf_counter`` cutoff of a per-call budget (None =
    unbounded); a budget <= 0 is spent before any work."""
    if deadline_s is None:
        return None
    return time.perf_counter() + deadline_s


def _deadline_spent(deadline_at: float | None) -> bool:
    return deadline_at is not None and time.perf_counter() >= deadline_at


@dataclasses.dataclass
class Node:
    node_id: int
    alive: bool = True
    slowdown: float = 1.0  # > 1 = straggler: scan walls are multiplied by it
    tables: dict[tuple[str, int], SortedTable] = dataclasses.field(default_factory=dict)
    # injected fault budgets: each > 0 count makes the next scan / flush on
    # this node raise a TransientFault (a flapping node, not a clean death)
    read_fault_budget: int = 0
    flush_fault_budget: int = 0

    def bytes_stored(self) -> int:
        """Bytes of the host columns of every table the node holds (packed
        keys, key and value columns): the reference's definition, so the
        two engines report the same storage for the same rows."""
        total = 0
        for t in self.tables.values():
            total += t.packed.nbytes
            total += sum(c.nbytes for c in t.key_cols.values())
            total += sum(np.asarray(c).nbytes for c in t.value_cols.values())
        return total


@dataclasses.dataclass
class ColumnFamily:
    """One keyspace: a token ring over the canonical packed key space and
    one :class:`Partition` per ring range, each holding a full
    heterogeneous replica set of that range's rows (slot ``s`` in
    ``slot_layouts[s]``, global replica id ``vnode_id * RF + s``) with its
    own commit log, memtables, compaction policy and round-robin counter.
    ``stats`` and the cost model hold the column-family-wide
    selectivities (the ``P = 1`` planner's); a partitioned column family
    ranks each partition's replicas with ``Partition.stats``.
    ``commitlog``/``memtables``/``compaction``/``rr_counter`` are the
    single-partition views."""

    name: str
    schema: KeySchema
    key_names: tuple[str, ...]
    value_names: tuple[str, ...]
    slot_layouts: tuple[tuple[str, ...], ...]
    ring: TokenRing
    partitions: list[Partition]
    stats: TableStats
    cost_model: CostModel
    hrca_result: HRCAResult | None = None
    # replica tables held as tensors on the engine's device: reads go
    # through the fused kernels, writes append runs to the tensors
    device_resident: bool = False
    # group-commit staging threshold (0 = write-through: every write flushes)
    memtable_rows: int = 0
    # materialized per-slab aggregate views (storage.views) on every
    # resident replica: view-eligible aggregates are served O(blocks
    # touched) and the Cost Evaluator caps their row estimate at
    # VIEW_ROWS_CAP
    views: bool = False
    # observed-token histogram (P > 1 only), fed by CREATE and every write
    token_hist: TokenHistogram | None = None
    # next unused virtual-node id (vnode ids are never reused)
    next_vnode: int = 0

    @property
    def replication_factor(self) -> int:
        return len(self.slot_layouts)

    @property
    def replicas(self) -> list[ReplicaHandle]:
        """All replica handles in global-replica-id order."""
        return [r for part in self.partitions for r in part.replicas]

    @property
    def commitlog(self) -> CommitLog | None:
        return self.partitions[0].commitlog

    @property
    def memtables(self) -> dict[int, Memtable]:
        return {
            rid: mt for part in self.partitions for rid, mt in part.memtables.items()
        }

    @property
    def compaction(self) -> CompactionPolicy | None:
        return self.partitions[0].compaction

    @property
    def rr_counter(self) -> "itertools.count":
        return self.partitions[0].rr_counter

    @rr_counter.setter
    def rr_counter(self, counter: "itertools.count") -> None:
        self.partitions[0].rr_counter = counter


@dataclasses.dataclass
class ReadReport:
    replica_id: int
    node_id: int
    estimated_rows: float
    estimated_cost: float
    wall_seconds: float  # measured scan time × node slowdown
    rows_scanned: int
    hedged: bool = False


_Ranked = tuple[float, float, ReplicaHandle]  # (est_cost, est_rows, handle)


def _tie_threshold(best_cost: float) -> float:
    """Cost at or under which a replica counts as tied with the best.
    Shared by ``read`` and ``read_many``: batched/sequential routing
    parity depends on both using the identical float expression."""
    return best_cost + abs(best_cost) * 1e-9 + 1e-12


def _schedule_picks(cost_mat: np.ndarray, counter) -> tuple[np.ndarray, np.ndarray]:
    """Request Scheduler core, shared by the single-partition and
    partitioned planners: per query (column of the ``(replicas,
    queries)`` cost matrix) the within-tolerance ties are the first
    tie_count entries of the column's stable ascending order — the tie
    list a scalar ``read`` builds — and one round-robin draw from
    ``counter`` is consumed per query in batch order. Returns ``(order,
    picks)``: the stable cost order (failover, hedge and digest reads walk
    it) and each query's picked replica row."""
    order = np.argsort(cost_mat, axis=0, kind="stable")  # (R, Q)
    sorted_costs = np.take_along_axis(cost_mat, order, axis=0)
    thresh = _tie_threshold(sorted_costs[0])  # elementwise over queries
    tie_counts = (sorted_costs <= thresh[None, :]).sum(axis=0)
    n_q = cost_mat.shape[1]
    draws = np.fromiter((next(counter) for _ in range(n_q)), dtype=np.int64, count=n_q)
    return order, order[draws % tie_counts, np.arange(n_q)]


def _group_by_pick(picks: np.ndarray, qidx: Sequence[int]) -> dict[int, list[int]]:
    """Group global query indices (``qidx[j]`` is column ``j``'s) by their
    picked replica row, in order of first pick; one batched scan serves
    each group."""
    groups: dict[int, list[int]] = {}
    for j, qi in enumerate(qidx):
        groups.setdefault(int(picks[j]), []).append(qi)
    return groups


def _result_digest(
    scan: ScanResult, table: SortedTable, key_names: tuple[str, ...], schema: KeySchema,
) -> int:
    """Layout-independent digest of a ``ScanResult``: what QUORUM/ALL reads
    compare across replicas. crc32 over ``rows_matched`` (int64), the
    aggregate value quantized to float32, and for selects the sorted
    canonical packed keys of the selected rows, built from the host key
    columns (each replica reports its own serialization order, but the
    selected row set is layout-independent). ``rows_scanned`` is left out:
    it belongs to the serving layout, not to the answer. The reference's
    definition, so both packages digest the same answer alike."""
    h = zlib.crc32(np.int64(scan.rows_matched).tobytes())
    with np.errstate(over="ignore"):  # corrupt totals may exceed float32
        h = zlib.crc32(np.float32(scan.value).tobytes(), h)
    if scan.selected is not None and np.asarray(scan.selected).size:
        sel = np.asarray(scan.selected)
        keys = pack_columns({c: table.key_cols[c][sel] for c in key_names}, key_names, schema)
        h = zlib.crc32(np.ascontiguousarray(np.sort(keys)), h)
    return h


class HREngine:
    """Simulated-cluster HR engine (Request Agency facade).

    ``device`` (default ``cuda``; raises if CUDA is absent) is where
    device-resident column families keep their tensors and run their
    kernels; pass ``device="cpu"`` to run the plain PyTorch versions.
    ``result_cache`` (default on) keeps a per-replica map ``(agg, value
    col, filter signature) → ScanResult``, fed by both ``read`` and
    ``read_many``, bounded in entries (``_CACHE_MAX_ENTRIES``, FIFO) and
    in retained select-index bytes, and invalidated by flushes,
    compactions, migration, node failure and recovery; hit/miss counters
    are on :attr:`stats`. With ``result_cache=False`` every read pays its
    scan. Every flushed run is checksum-verified before it merges and
    every installed table carries a sealed content checksum; column
    families inherit the default :class:`CompactionPolicy`, and the
    counters live on the engine's own :class:`MetricsRegistry`.

    ``rebalance_imbalance`` > 0 arms
    the drift trigger: after a write's flush, a partitioned column family
    whose token histogram puts more than that multiple of the mean row
    mass in one partition is rebalanced in place (0 = manual only).

    ``failure_detector`` (duck-typed: ``record``/``record_failure``/
    ``cost_factor``, see ``repro_torch.ft.detector``) is fed every executed
    replica group's wall and down-ranks suspected nodes. ``scan_timer`` is
    the zero-argument clock those walls come from (``time.perf_counter``
    by default; a tick counter makes routing a pure function of the
    operation sequence). ``read_retry_limit`` bounds the attempts a query
    gets when scans raise transient faults (first try included; None =
    one attempt per live replica).
    """

    def __init__(
        self,
        n_nodes: int = 6,
        *,
        device=None,
        result_cache: bool = True,
        memtable_rows: int = 0,
        commitlog_checkpoint_records: int = 256,
        rebalance_imbalance: float = 0.0,
        failure_detector=None,
        read_retry_limit: int | None = None,
        scan_timer=None,
    ) -> None:
        if n_nodes < 1:
            raise ValueError("need at least one node")
        if memtable_rows < 0:
            raise ValueError("memtable_rows must be >= 0 (0 = write-through)")
        if commitlog_checkpoint_records < 0:
            raise ValueError(
                "commitlog_checkpoint_records must be >= 0 (0 = no "
                "automatic checkpointing)"
            )
        if rebalance_imbalance < 0:
            raise ValueError("rebalance_imbalance must be >= 0 (0 = manual only)")
        # the limit counts attempts (first try included), so anything below
        # 1 would turn the first transient fault into an unanswerable query
        if read_retry_limit is not None and read_retry_limit < 1:
            raise ValueError(
                "read_retry_limit must be >= 1 (attempts, first try "
                "included; None = one attempt per live replica), got "
                f"{read_retry_limit}"
            )
        self.device = resolve_device(device)
        self.nodes = [Node(node_id=i) for i in range(n_nodes)]
        self.column_families: dict[str, ColumnFamily] = {}
        self._cache_enabled = result_cache
        self._result_cache: dict[tuple[str, int], dict] = {}
        # running total of selected-array bytes per replica map
        self._cache_sel_bytes: dict[tuple[str, int], int] = {}
        self._pool: ThreadPoolExecutor | None = None
        self.memtable_rows = memtable_rows
        self.compaction = CompactionPolicy()
        # auto-checkpoint trigger: collapse the commit log after a flush
        # once more than this many records accumulated (0 disables)
        self.commitlog_checkpoint_records = commitlog_checkpoint_records
        self.rebalance_imbalance = rebalance_imbalance
        self.failure_detector = failure_detector
        self._scan_timer = scan_timer if scan_timer is not None else time.perf_counter
        self.read_retry_limit = read_retry_limit
        self.metrics = MetricsRegistry()
        for _name in ENGINE_COUNTERS:
            self.metrics.counter(_name)
        self._cache_hits = self.metrics.counter("result_cache_hits")
        self._cache_misses = self.metrics.counter("result_cache_misses")
        self._auto_checkpoints = self.metrics.counter("commitlog_auto_checkpoints")
        self._flushes = self.metrics.counter("memtable_flushes")
        self._compactions = self.metrics.counter("compactions")
        self._corrupt_runs = self.metrics.counter("corrupt_runs")
        self._flush_wall = self.metrics.counter("flush_wall_seconds")
        self._view_hits = self.metrics.counter("view_hits")
        self._view_boundary_rows = self.metrics.counter("view_boundary_rows")
        self._view_rebuilds = self.metrics.counter("view_rebuilds")
        self._empty_partition_skips = self.metrics.counter("empty_partition_skips")
        self._partition_splits = self.metrics.counter("partition_splits")
        self._partition_merges = self.metrics.counter("partition_merges")
        self._rebalance_rows_moved = self.metrics.counter("rebalance_rows_moved")
        self._hints_queued = self.metrics.counter("hints_queued")
        self._hint_replays = self.metrics.counter("hint_replays")
        self._hint_rows_replayed = self.metrics.counter("hint_rows_replayed")
        self._hint_fallbacks = self.metrics.counter("hint_fallbacks")
        self._digest_mismatches = self.metrics.counter("digest_mismatches")
        self._read_repairs = self.metrics.counter("read_repairs")
        self._read_retries = self.metrics.counter("read_retries")
        self._scrub_checks = self.metrics.counter("scrub_checks")
        self._scrub_repairs = self.metrics.counter("scrub_repairs")
        self._deadline_exceeded = self.metrics.counter("deadline_exceeded")
        self._read_faults = self.metrics.counter("read_faults")
        self._flush_faults = self.metrics.counter("flush_faults")

    @property
    def _executor(self) -> ThreadPoolExecutor:
        """The shared flush pool, created on the first parallel flush."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=8)
        return self._pool

    def __getstate__(self) -> dict:
        # a thread pool cannot be copied or pickled; it is recreated on use
        state = self.__dict__.copy()
        state["_pool"] = None
        return state

    # -- stats and result cache ----------------------------------------------

    @property
    def stats(self) -> dict:
        """Operational counters (a read-through view of :attr:`metrics`)
        plus structural keys computed live: log records and rows, staged
        rows, open hints and result-cache occupancy."""
        parts = [p for cf in self.column_families.values() for p in cf.partitions]
        out = {name: int(self.metrics.value(name)) for name in ENGINE_COUNTERS}
        out["flush_wall_seconds"] = self._flush_wall.value
        out.update(
            result_cache_entries=sum(len(c) for c in self._result_cache.values()),
            result_cache_select_bytes=sum(self._cache_sel_bytes.values()),
            partitions=len(parts),
            commitlog_records=sum(len(p.commitlog) for p in parts),
            commitlog_rows=sum(p.commitlog.n_rows for p in parts),
            staged_rows=sum(mt.n_staged for p in parts for mt in p.memtables.values()),
            hints_open=sum(len(p.hints) for p in parts),
        )
        return out

    def reset_stats(self) -> None:
        """Zero every registry-backed counter in place."""
        self.metrics.reset()

    def _check_deadline(self, deadline_at: float | None, budget_s: float | None) -> None:
        """Raise :class:`DeadlineExceeded` (counted under
        ``deadline_exceeded``) once the budget is spent. Called before each
        unit of required work: a replica-group scan, a failover retry, a
        digest read. Hedges are optional work and are skipped instead. On
        a device-resident column family a group's answers are fetched to
        the host before the next check reads the clock, so the budget
        covers the device work the call waited for."""
        if deadline_at is not None and time.perf_counter() >= deadline_at:
            self._deadline_exceeded.inc()
            raise DeadlineExceeded(budget_s)

    @staticmethod
    def _cache_keys(queries: list[Query]) -> list:
        """One key per query: aggregation + value column + filter
        signature (the cache is per replica, so the layout is implicit)."""
        return [(q.agg, q.value_col, tuple(sorted(q.filters.items()))) for q in queries]

    # each replica's map holds at most this many entries (FIFO); a select's
    # cached index array may be arbitrarily large, so entries past the
    # per-entry byte size are served but never cached, and each map evicts
    # FIFO until its retained selected-array bytes fit the budget
    _CACHE_MAX_ENTRIES = 4096
    _CACHE_MAX_SELECT_BYTES = 1 << 20
    _CACHE_MAX_MAP_BYTES = 64 << 20

    def _cache_store(self, map_key, cache: dict, key, result: ScanResult) -> None:
        """Cache hits hand out the same ScanResult object, so a select's
        index array is frozen on the way in."""
        nb = 0 if result.selected is None else int(result.selected.nbytes)
        if nb > self._CACHE_MAX_SELECT_BYTES or nb > self._CACHE_MAX_MAP_BYTES:
            return
        if result.selected is not None:
            result.selected.setflags(write=False)
        total = self._cache_sel_bytes.get(map_key, 0)
        old = cache.pop(key, None)
        if old is not None and old.selected is not None:
            total -= old.selected.nbytes
        while cache and (
            len(cache) >= self._CACHE_MAX_ENTRIES or total + nb > self._CACHE_MAX_MAP_BYTES
        ):
            evicted = cache.pop(next(iter(cache)))
            if evicted.selected is not None:
                total -= evicted.selected.nbytes
        cache[key] = result
        self._cache_sel_bytes[map_key] = total + nb

    def _invalidate_result_cache(
        self, cf_name: str, node_id: int | None = None, replica_id: int | None = None,
    ) -> None:
        """Drop the cached results of ``cf_name``'s replicas, of those on
        ``node_id`` and/or of ``replica_id`` when given."""
        for r in self.column_families[cf_name].replicas:
            if node_id is not None and r.node_id != node_id:
                continue
            if replica_id is not None and r.replica_id != replica_id:
                continue
            self._result_cache.pop((cf_name, r.replica_id), None)
            self._cache_sel_bytes.pop((cf_name, r.replica_id), None)

    # -- Replica Generator ---------------------------------------------------

    def _place(self, replica_id: int, cf_name: str) -> int:
        """Replica placement hash(replica_id, cf) → node (crc32)."""
        return place_replica(cf_name, replica_id, len(self.nodes))

    def create_column_family(
        self,
        name: str,
        key_cols: Mapping[str, np.ndarray],
        value_cols: Mapping[str, np.ndarray],
        *,
        replication_factor: int = 3,
        mechanism: str = "HR",
        workload: Workload | None = None,
        schema: KeySchema | None = None,
        hrca_kwargs: dict | None = None,
        layouts: Sequence[Sequence[str]] | None = None,
        device_resident: bool = False,
        views: bool = False,
        memtable_rows: int | None = None,
        partitions: int = 1,
        partition_balance: str = "equal",
    ) -> ColumnFamily:
        """CREATE COLUMN FAMILY: choose replica structures, build tables.

        mechanism:
          "HR" — layouts from HRCA over ``workload`` (paper), with
                 ``hrca_kwargs`` passed to :func:`hrca`.
          "TR" — the single best expert layout, identical on all replicas
                 (exhaustive for ≤5 keys, else annealing + greedy polish).
        Explicit ``layouts`` override both.

        With ``device_resident=True`` every replica table is placed on the
        engine's device at creation; reads then answer sum, count and
        select queries with the fused kernels, writes append to the
        resident tensors and the compaction policy merges them on the
        device. Raises if the schema exceeds the device path's per-column
        two-lane budget. The CREATE-time dataset is record 0 of the
        column family's commit log (of each partition's, the rows it
        owns).

        ``views=True`` (requires ``device_resident``) additionally
        materializes a per-slab aggregate view on every replica table:
        per-block partial sums of the value tile in that replica's own
        sort order (``storage.views``). View-eligible sum and count
        queries — slab filters forming a prefix of the layout — are then
        answered from the stored partials plus a rescan of at most the two
        window-edge blocks per run, bit-identical to the fused scan. Views
        extend at flush and rebuild at compaction and migration.

        ``memtable_rows`` (default: the engine's) is the group-commit
        staging threshold, 0 = write-through.

        ``partitions`` splits the keyspace over a token ring
        (``core.ring``): each of ``P`` contiguous token ranges owns a full
        heterogeneous replica set of just its rows, its own commit log,
        memtables and ``TableStats``. ``partition_balance`` places the
        boundaries: ``"equal"`` splits the key space evenly, ``"tokens"``
        at exact quantiles of the CREATE rows' tokens. With
        ``mechanism="HR"`` and ``P > 1`` HRCA optimizes the
        row-weighted blend of the per-partition cost models. On a
        device-resident column family the CREATE tokens go through the
        histogram kernel into ``ColumnFamily.token_hist``.
        ``partitions=1`` (default) is the unpartitioned engine.
        """
        if views and not device_resident:
            raise ValueError(
                "views=True requires device_resident=True (views are "
                "per-block partials of the resident value tile)"
            )
        if name in self.column_families:
            raise ValueError(f"column family {name!r} exists")
        if schema is None:
            schema = KeySchema.for_columns(key_cols)
        key_names = tuple(key_cols)
        value_names = tuple(value_cols)
        stats = TableStats.from_columns(key_cols, schema)
        model = CostModel(stats=stats)
        n = replication_factor
        hrca_result: HRCAResult | None = None

        # the ring and the per-partition stats come before the layout
        # choice: HRCA over a partitioned column family optimizes against
        # each partition's own selectivities
        tokens = token_hist = None
        part_stats: list[TableStats | None]
        if partitions == 1:
            ring = TokenRing.build(schema, key_names, 1)
            owner_masks: list = [None]  # the whole dataset, no slicing copies
            part_stats = [None]
        else:
            kc_arr = {c: np.asarray(key_cols[c]) for c in key_names}
            tokens = pack_columns(kc_arr, key_names, schema)
            if partition_balance == "equal":
                ring = TokenRing.build(schema, key_names, partitions)
            elif partition_balance == "tokens":
                ring = TokenRing.from_tokens(schema, key_names, tokens, partitions)
            else:
                raise ValueError(
                    f"unknown partition_balance {partition_balance!r} "
                    "(expected 'equal' or 'tokens')"
                )
            pids = ring.partition_of_tokens(tokens)
            owner_masks = [pids == pid for pid in range(partitions)]
            part_stats = [
                TableStats.from_columns({c: kc_arr[c][mask] for c in key_names}, schema)
                for mask in owner_masks
            ]
            token_hist = TokenHistogram.build(ring.total_bits)
            token_hist.add_tokens(tokens, device=self.device if device_resident else None)

        if layouts is not None:
            chosen = tuple(tuple(a) for a in layouts)
            if len(chosen) != n:
                raise ValueError("len(layouts) != replication_factor")
        elif mechanism == "TR":
            if workload is None:
                chosen = tuple(tuple(key_names) for _ in range(n))
            else:
                best = self._expert_layout(model, workload, key_names)
                chosen = tuple(best for _ in range(n))
        elif mechanism == "HR":
            if workload is None:
                raise ValueError("HR mechanism needs a workload for HRCA")
            if partitions == 1:
                hrca_model = model
            else:
                # per-partition models weighted by their rows: the shared
                # layout set is optimized for what each partition serves
                hrca_model = [(float(ps.n_rows), CostModel(stats=ps)) for ps in part_stats]
            hrca_result = hrca(
                hrca_model, workload, initial_state(key_names, n), **dict(hrca_kwargs or {})
            )
            chosen = hrca_result.layouts
        else:
            raise ValueError(f"unknown mechanism {mechanism!r}")

        parts: list[Partition] = []
        for pid, mask in enumerate(owner_masks):
            if mask is None:
                kc_p, vc_p = key_cols, value_cols
            else:
                kc_p = {c: np.asarray(key_cols[c])[mask] for c in key_names}
                vc_p = {c: np.asarray(value_cols[c])[mask] for c in value_names}
            handles: list[ReplicaHandle] = []
            memtables: dict[int, Memtable] = {}
            digest: int | None = None  # layout-independent: one per partition
            for slot, layout in enumerate(chosen):
                rid = pid * n + slot
                table = SortedTable.from_columns(kc_p, vc_p, layout, schema)
                if device_resident:
                    table.place_on_device(self.device)
                    if views:
                        table.build_views()
                if digest is None:
                    digest = table.seal_checksum().stored_digest
                else:
                    table.stored_digest = digest
                node_id = self._place(rid, name)
                self.nodes[node_id].tables[(name, rid)] = table
                handles.append(ReplicaHandle(rid, tuple(layout), node_id, partition_id=pid))
                memtables[rid] = Memtable(layout, schema, key_names, value_names)
            log = CommitLog(key_names=key_names, value_names=value_names)
            log.append(kc_p, vc_p)  # record 0: the rows this partition owns
            lo, hi = ring.token_range(pid)
            part = Partition(
                partition_id=pid,
                token_lo=lo,
                token_hi=hi,
                replicas=handles,
                commitlog=log,
                memtables=memtables,
                compaction=self.compaction,
                vnode_id=pid,  # birth identity == ring position at CREATE
                stats=part_stats[pid],
                # every replica table holds exactly record 0
                flushed_lsn={r.replica_id: log.next_lsn for r in handles},
            )
            if tokens is not None:
                part.observe_tokens(tokens[mask])
            parts.append(part)

        cf = ColumnFamily(
            name=name,
            schema=schema,
            key_names=key_names,
            value_names=value_names,
            slot_layouts=tuple(tuple(a) for a in chosen),
            ring=ring,
            partitions=parts,
            stats=stats,
            cost_model=model,
            hrca_result=hrca_result,
            device_resident=device_resident,
            memtable_rows=self.memtable_rows if memtable_rows is None else memtable_rows,
            views=views,
            token_hist=token_hist,
            next_vnode=partitions,
        )
        self.column_families[name] = cf
        return cf

    @staticmethod
    def _expert_layout(
        model: CostModel, workload: Workload, key_names: tuple[str, ...]
    ) -> tuple[str, ...]:
        if len(key_names) <= 5:
            state, _ = exhaustive_search(model, workload, key_names, 1)
            return state[0]
        res = hrca(
            model, workload, initial_state(key_names, 1), greedy_descent=True, k_max=2000
        )
        return res.layouts[0]

    # -- Cost Evaluator / Request Scheduler -----------------------------------

    def _table(self, cf: ColumnFamily, r: ReplicaHandle) -> SortedTable:
        return self.nodes[r.node_id].tables[(cf.name, r.replica_id)]

    def _ranked_replicas(self, cf: ColumnFamily, query: Query) -> list[_Ranked]:
        """Replicas on live nodes ranked by estimated cost (Eq 2–3), with a
        view-eligible aggregate's row estimate capped at ``VIEW_ROWS_CAP``
        on a views column family, multiplied by the failure detector's
        per-node cost factor when one is attached (suspected nodes are
        down-ranked, not excluded)."""
        det = self.failure_detector
        ranked: list[_Ranked] = []
        for r in cf.replicas:
            if not self.nodes[r.node_id].alive:
                continue
            rows = estimate_rows(cf.stats, r.layout, query)
            cost = cf.cost_model.cost_fn(len(r.layout))(rows)
            if cf.views and query.agg in VIEW_AGGS and query_view_eligible(query, r.layout):
                # view term (Eq 1–2 refined): a view-eligible aggregate
                # touches at most the two window-edge blocks per run, so
                # its row estimate is capped — a view hit beats a full
                # scan regardless of selectivity
                cost = cf.cost_model.cost_fn(len(r.layout))(min(rows, float(VIEW_ROWS_CAP)))
            if det is not None:
                cost *= det.cost_factor(r.node_id)
            ranked.append((cost, rows, r))
        if not ranked:
            raise RuntimeError(f"no live replica for {cf.name!r}")
        ranked.sort(key=lambda t: t[0])
        return ranked

    def _live_cost_factors(self, live: list[ReplicaHandle]) -> np.ndarray | None:
        """Per-live-replica detector cost factors (None when no detector is
        attached: the cost matrices then stay those of a detector-free
        engine)."""
        det = self.failure_detector
        if det is None:
            return None
        return np.array([det.cost_factor(r.node_id) for r in live], dtype=np.float64)

    @staticmethod
    def _check_consistency(consistency: str) -> None:
        if consistency not in CONSISTENCY_LEVELS:
            raise ValueError(
                f"unknown consistency {consistency!r} (expected one of {CONSISTENCY_LEVELS})"
            )

    def read(
        self,
        cf_name: str,
        query: Query,
        *,
        hedge: bool = False,
        hedge_ratio: float = 2.0,
        consistency: str = ONE,
        deadline_s: float | None = None,
        trace=None,
    ) -> tuple[ScanResult, ReadReport]:
        """Route to the cheapest live replica; ties broken round-robin.
        Same costs, tie rule and round-robin counter as ``read_many``, so
        routing is identical to ``read_many`` at Q = 1; a partitioned
        column family, and consistency above ONE, go through ``read_many``
        at Q = 1. A scan that raises a :class:`TransientFault` fails over
        to the next-ranked untried replica. With ``hedge=True`` a read that
        landed on a straggler (slowdown > ``hedge_ratio``) is duplicated on
        the cheapest replica on another node, and the faster copy wins.
        ``deadline_s`` is the call's latency budget: the scan and each
        failover retry check it first and raise :class:`DeadlineExceeded`
        once it is spent; the hedge is skipped instead (None = unbounded,
        a budget <= 0 sheds before any scan). ``trace`` (an open span, or
        None) hangs an ``engine.read`` subtree under the caller's."""
        self._check_consistency(consistency)
        cf = self.column_families[cf_name]
        if cf.ring.n_partitions > 1 or consistency != ONE:
            return self.read_many(
                cf_name, [query], hedge=hedge, hedge_ratio=hedge_ratio,
                consistency=consistency, deadline_s=deadline_s, trace=trace,
            )[0]
        deadline = _deadline_at(deadline_s)
        self._check_deadline(deadline, deadline_s)
        span = (
            trace.child("engine.read", cf=cf_name, level=consistency)
            if trace is not None
            else None
        )
        try:
            ranked = self._ranked_replicas(cf, query)
            best_cost = ranked[0][0]
            ties = [t for t in ranked if t[0] <= _tie_threshold(best_cost)]
            entry = ties[next(cf.rr_counter) % len(ties)]
            # the failover of _run_groups: a transient fault advances to the
            # next-ranked untried replica, bounded by the live count (or
            # read_retry_limit)
            limit = len(ranked) if self.read_retry_limit is None else self.read_retry_limit
            tried: set[int] = set()
            while True:
                tried.add(entry[2].replica_id)
                try:
                    result, report = self._execute_scalar(
                        cf, entry, query, hedged=False, trace=span,
                        retry=bool(tried - {entry[2].replica_id}),
                    )
                    break
                except TransientFault:
                    self._read_retries.inc()
                    self._check_deadline(deadline, deadline_s)
                    entry = next((t for t in ranked if t[2].replica_id not in tried), None)
                    if entry is None or len(tried) >= limit:
                        raise RuntimeError(
                            f"no live replica answered query 0 of {cf.name!r} "
                            f"after {len(tried)} attempts"
                        ) from None
            if (
                hedge
                and len(ranked) > 1
                and self.nodes[report.node_id].slowdown > hedge_ratio
                and not _deadline_spent(deadline)  # a hedge is optional work
            ):
                alt = next((t for t in ranked if t[2].node_id != report.node_id), None)
                if alt is not None:
                    try:
                        r2, rep2 = self._execute_scalar(cf, alt, query, hedged=True, trace=span)
                    except TransientFault:
                        pass  # a best-effort duplicate; the primary stands
                    else:
                        # ties go to the hedge (cache hits serve at zero wall)
                        if rep2.wall_seconds <= report.wall_seconds:
                            return r2, rep2
            return result, report
        finally:
            if span is not None:
                span.end()

    def _execute_scalar(
        self, cf: ColumnFamily, entry: _Ranked, query: Query, *,
        hedged: bool, trace=None, retry: bool = False,
    ) -> tuple[ScanResult, ReadReport]:
        """Execute one query on one replica through ``_scan_with_cache``."""
        est_cost, est_rows, r = entry
        g = (
            trace.child(
                "engine.group_scan", replica=r.replica_id, node=r.node_id, queries=1,
                hedged=hedged, retry=retry,
            )
            if trace is not None
            else None
        )
        try:
            scans, walls = self._scan_with_cache(cf, r, [query], trace=g)
        except TransientFault as e:
            if g is not None:
                g.end(error=type(e).__name__)
            raise
        if g is not None:
            g.end(rows=int(scans[0].rows_scanned))
        return scans[0], ReadReport(
            replica_id=r.replica_id,
            node_id=r.node_id,
            estimated_rows=est_rows,
            estimated_cost=est_cost,
            wall_seconds=walls[0],
            rows_scanned=scans[0].rows_scanned,
            hedged=hedged,
        )

    def read_many(
        self,
        cf_name: str,
        queries: Sequence[Query],
        *,
        hedge: bool = False,
        hedge_ratio: float = 2.0,
        consistency: str = ONE,
        deadline_s: float | None = None,
        trace=None,
    ) -> list[tuple[ScanResult, ReadReport]]:
        """Batched ``read``: one scheduler pass and one grouped scan per
        chosen replica (per partition and chosen replica on a partitioned
        column family, :meth:`_read_many_partitioned`), with bounded
        failover onto the next-ranked replica when a group's scan raises a
        transient fault. Returns per-query ``(ScanResult, ReadReport)`` in
        batch order; results and routing are identical to calling ``read``
        on each query in sequence. ``hedge`` duplicates straggler-bound
        queries (:meth:`_hedge_groups`); ``consistency="QUORUM"``/``"ALL"``
        adds digest reads with read repair (:meth:`_consistency_pass`), and
        the returned result is always the digest-majority answer.
        ``deadline_s`` bounds the whole batch: group scans, failover
        retries and digest reads raise :class:`DeadlineExceeded` once the
        budget is spent, hedges are skipped; a deadline never triggers
        failover."""
        self._check_consistency(consistency)
        cf = self.column_families[cf_name]
        queries = list(queries)
        if not queries:
            return []
        deadline = _deadline_at(deadline_s)
        self._check_deadline(deadline, deadline_s)
        span = (
            trace.child(
                "engine.read_many", cf=cf_name, queries=len(queries), level=consistency
            )
            if trace is not None
            else None
        )
        try:
            if cf.ring.n_partitions > 1:
                return self._read_many_partitioned(
                    cf, queries, hedge=hedge, hedge_ratio=hedge_ratio,
                    consistency=consistency, deadline_at=deadline, budget_s=deadline_s,
                    trace=span,
                )
            live = [r for r in cf.replicas if self.nodes[r.node_id].alive]
            if not live:
                raise RuntimeError(f"no live replica for {cf_name!r}")
            n_q = len(queries)
            # vectorized Cost Evaluator: Eq (1)-(2) over all (replica,
            # query); per-column selectivities are extracted once
            plan = span.child("engine.plan") if span is not None else None
            pre = precompute_query_stats(cf.stats, queries, cf.key_names)
            rows_mat = np.stack(
                [estimate_rows_many(cf.stats, r.layout, queries, pre) for r in live]
            )
            cost_mat = np.stack(
                [
                    cf.cost_model.cost_fn(len(r.layout)).many(rows_mat[k])
                    for k, r in enumerate(live)
                ]
            )
            # view term: cap eligible (replica, query) row estimates. The
            # any() guard doubles as the all-select fast path — a batch
            # with no sum/count never walks the eligibility arrays
            if cf.views and any(q.agg in VIEW_AGGS for q in queries):
                elig = view_eligible_matrix([r.layout for r in live], queries)
                if elig.any():
                    capped = np.minimum(rows_mat, float(VIEW_ROWS_CAP))
                    cost_mat = np.where(
                        elig,
                        np.stack(
                            [
                                cf.cost_model.cost_fn(len(r.layout)).many(capped[k])
                                for k, r in enumerate(live)
                            ]
                        ),
                        cost_mat,
                    )
            factors = self._live_cost_factors(live)
            if factors is not None:
                cost_mat = cost_mat * factors[:, None]
            order_mat, picks = _schedule_picks(cost_mat, cf.rr_counter)
            if plan is not None:
                plan.end(replicas=len(live))
            all_q = list(range(n_q))
            results: list[ScanResult | None] = [None] * n_q
            reports: list[ReadReport | None] = [None] * n_q
            self._run_groups(
                cf, live, order_mat, picks, all_q, queries, rows_mat, cost_mat,
                results, reports, deadline_at=deadline, budget_s=deadline_s, trace=span,
            )
            if hedge and len(live) > 1 and not _deadline_spent(deadline):
                # duplicate straggler-bound queries onto the cheapest replica
                # on another node; a faulting hedge is dropped, never failed
                # over (the primary result stands)
                for k, qidx in self._hedge_groups(live, order_mat, picks, all_q, hedge_ratio).items():
                    try:
                        self._execute_group(
                            cf, live[k], qidx, queries, rows_mat[k], cost_mat[k],
                            results, reports, hedged=True, trace=span,
                        )
                    except TransientFault:
                        continue
            if consistency != ONE:
                self._consistency_pass(
                    cf, cf.partitions[0], live, order_mat, all_q, queries, results, reports,
                    consistency, deadline_at=deadline, budget_s=deadline_s, trace=span,
                )
            return list(zip(results, reports))  # type: ignore[arg-type]
        finally:
            if span is not None:
                span.end()

    def _run_groups(
        self,
        cf: ColumnFamily,
        live: list[ReplicaHandle],
        order: np.ndarray,
        picks: np.ndarray,
        qidx: list[int],
        queries: list[Query],
        rows_live: np.ndarray,
        cost_live: np.ndarray,
        results: list,
        reports: list,
        *,
        deadline_at: float | None = None,
        budget_s: float | None = None,
        trace=None,
    ) -> None:
        """Primary grouped execution with bounded failover: the queries of
        a group that raises a :class:`TransientFault` advance to the next
        replica in their cost order not yet tried (``read_retries`` counts
        each re-routed query), up to ``read_retry_limit`` attempts per query
        (default: one per live replica). Scheduler column ``j`` of
        ``order`` is global query ``qidx[j]``. A spent ``deadline_at``
        budget raises :class:`DeadlineExceeded` before the next group."""
        col_of = {qi: j for j, qi in enumerate(qidx)}
        limit = len(live) if self.read_retry_limit is None else self.read_retry_limit
        tried: dict[int, set[int]] = {qi: set() for qi in qidx}
        queue = [(k, sub, False) for k, sub in _group_by_pick(picks, qidx).items()]
        while queue:
            self._check_deadline(deadline_at, budget_s)
            k, sub, is_retry = queue.pop(0)
            for qi in sub:
                tried[qi].add(k)
            try:
                self._execute_group(
                    cf, live[k], sub, queries, rows_live[k], cost_live[k], results, reports,
                    hedged=False, trace=trace, retry=is_retry,
                )
            except TransientFault:
                self._read_retries.inc(len(sub))
                retry: dict[int, list[int]] = {}
                for qi in sub:
                    nxt = (
                        next(
                            (int(x) for x in order[:, col_of[qi]] if int(x) not in tried[qi]),
                            None,
                        )
                        if len(tried[qi]) < limit
                        else None
                    )
                    if nxt is None:
                        raise RuntimeError(
                            f"no live replica answered query {qi} of "
                            f"{cf.name!r} after {len(tried[qi])} attempts"
                        )
                    retry.setdefault(nxt, []).append(qi)
                queue.extend((k2, sub2, True) for k2, sub2 in retry.items())

    def _scan_with_cache(
        self, cf: ColumnFamily, r: ReplicaHandle, group: list[Query], *, trace=None,
    ) -> tuple[list[ScanResult], list[float]]:
        """Core scan for one replica's query group: read-barrier flush,
        injected-fault check, result cache (when enabled), one
        ``execute_many`` for the misses, failure-detector feed. Returns
        per-query ``(scans, walls)`` aligned with ``group``; cache hits
        carry zero attributed wall. Raises :class:`TransientReadError` /
        :class:`TransientFlushError` before producing any result, so a
        faulting group is retried whole."""
        self._ensure_flushed(cf, r, trace=trace)  # may raise TransientFlushError
        table = self._table(cf, r)
        cp = trace.child("engine.cache_probe") if trace is not None else None
        cache = ckeys = None
        if self._cache_enabled:
            cache = self._result_cache.setdefault((cf.name, r.replica_id), {})
            ckeys = self._cache_keys(group)
        hit_j = set() if cache is None else {j for j, k in enumerate(ckeys) if k in cache}
        miss_j = [j for j in range(len(group)) if j not in hit_j]
        if cp is not None:
            cp.end(hits=len(hit_j), misses=len(miss_j))
        node = self.nodes[r.node_id]
        if miss_j and node.read_fault_budget > 0:
            node.read_fault_budget -= 1
            if self.failure_detector is not None:
                self.failure_detector.record_failure(node.node_id)
            self._read_faults.inc()
            raise TransientReadError(node.node_id)
        sc = (
            trace.child("engine.scan", queries=len(miss_j))
            if trace is not None and miss_j
            else None
        )
        vstats = {"hits": 0, "boundary_rows": 0} if cf.views else None
        t0 = self._scan_timer()
        miss_scans = (
            table.execute_many([group[j] for j in miss_j], trace=sc, view_stats=vstats)
            if miss_j
            else []
        )
        wall = (self._scan_timer() - t0) * node.slowdown
        if sc is not None:
            sc.end(rows=int(sum(s.rows_scanned for s in miss_scans)))
        if vstats is not None and vstats["hits"]:
            self._view_hits.inc(vstats["hits"])
            self._view_boundary_rows.inc(vstats["boundary_rows"])
        if miss_j and self.failure_detector is not None:
            # one latency sample per executed group; cache hits are not
            # operations the node performed
            self.failure_detector.record(node.node_id, wall)
        per_q_wall = wall / len(miss_j) if miss_j else 0.0
        scans: list[ScanResult | None] = [None] * len(group)
        walls = [0.0] * len(group)
        # read the hits out BEFORE storing misses: a store can FIFO-evict
        # a key that was a hit when hit_j was computed
        for j in hit_j:
            scans[j] = cache[ckeys[j]]
        for j, sr in zip(miss_j, miss_scans):
            scans[j] = sr
            walls[j] = per_q_wall
            if cache is not None:
                self._cache_store((cf.name, r.replica_id), cache, ckeys[j], sr)
        if cache is not None:
            self._cache_hits.inc(len(hit_j))
            self._cache_misses.inc(len(miss_j))
        return scans, walls  # type: ignore[return-value]

    def _execute_group(
        self,
        cf: ColumnFamily,
        r: ReplicaHandle,
        qidx: list[int],
        queries: list[Query],
        est_rows: np.ndarray,
        est_costs: np.ndarray,
        results: list,
        reports: list,
        *,
        hedged: bool,
        trace=None,
        retry: bool = False,
    ) -> None:
        """Run one replica's query group via ``_scan_with_cache``; the
        measured wall (× node slowdown) is split evenly across the queries
        that executed — cache hits are served at zero attributed wall. A
        hedged run replaces a query's primary result only when at least as
        fast (ties go to the hedge)."""
        group = [queries[i] for i in qidx]
        g = (
            trace.child(
                "engine.group_scan", replica=r.replica_id, node=r.node_id, queries=len(qidx),
                hedged=hedged, retry=retry,
            )
            if trace is not None
            else None
        )
        try:
            scans, walls = self._scan_with_cache(cf, r, group, trace=g)
        except TransientFault as e:
            if g is not None:
                g.end(error=type(e).__name__)
            raise
        if g is not None:
            g.end(rows=int(sum(sr.rows_scanned for sr in scans)))
        for j, i in enumerate(qidx):
            sr = scans[j]
            if hedged and not (reports[i] is None or walls[j] <= reports[i].wall_seconds):
                continue
            results[i] = sr
            reports[i] = ReadReport(
                replica_id=r.replica_id,
                node_id=r.node_id,
                estimated_rows=float(est_rows[i]),
                estimated_cost=float(est_costs[i]),
                wall_seconds=walls[j],
                rows_scanned=sr.rows_scanned,
                hedged=hedged,
            )

    # -- tunable consistency (digest reads and read repair) --------------------

    @staticmethod
    def _consistency_k(consistency: str, rf: int) -> int:
        """Replicas that must answer at a consistency level (read k)."""
        if consistency == ONE:
            return 1
        if consistency == QUORUM:
            return rf // 2 + 1
        if consistency == ALL:
            return rf
        raise ValueError(
            f"unknown consistency {consistency!r} (expected one of {CONSISTENCY_LEVELS})"
        )

    def _consistency_pass(
        self,
        cf: ColumnFamily,
        part: Partition,
        live: list[ReplicaHandle],
        order: np.ndarray,
        qidx: list[int],
        queries: list[Query],
        results: list,
        reports: list,
        consistency: str,
        *,
        deadline_at: float | None = None,
        budget_s: float | None = None,
        trace=None,
    ) -> None:
        """Digest reads: execute each query on the next cost-ranked replicas
        until k distinct replicas (the primary included) answered, compare
        the layout-independent digests, and on a mismatch repair divergent
        replicas from the partition log. The majority digest wins (the
        result is re-pointed at a majority replica when the primary was the
        outlier); with no majority, the log is the ground truth: every
        consulted replica is rebuilt and the query re-executes on the
        primary. Digest reads are required work: a spent budget raises
        :class:`DeadlineExceeded` before each."""
        k = self._consistency_k(consistency, len(part.replicas))
        if k <= 1:
            return
        if len(live) < k:
            raise RuntimeError(
                f"consistency {consistency} needs {k} live replicas of "
                f"partition {part.partition_id} of {cf.name!r}, have {len(live)}"
            )
        dg = trace.child("engine.digest", level=consistency, k=k) if trace is not None else None
        col_of = {qi: j for j, qi in enumerate(qidx)}
        row_of_rid = {r.replica_id: i for i, r in enumerate(live)}
        # alternates: per query the k-1 cheapest ranked replicas other than
        # the one that served the primary (a hedge may have moved it)
        consulted: dict[int, set[int]] = {}
        alt_groups: dict[int, list[int]] = {}
        for j, qi in enumerate(qidx):
            primary_row = row_of_rid.get(reports[qi].replica_id)
            consulted[qi] = {primary_row} if primary_row is not None else set()
            chosen: list[int] = []
            for x in order[:, j]:
                x = int(x)
                if x in consulted[qi]:
                    continue
                chosen.append(x)
                if len(chosen) >= k - 1:
                    break
            for x in chosen:
                alt_groups.setdefault(x, []).append(qi)
        # the digest reads, failing over like the primary pass
        alt_scans: dict[int, list[tuple[ReplicaHandle, ScanResult]]] = {}
        queue = list(alt_groups.items())
        while queue:
            self._check_deadline(deadline_at, budget_s)
            x, sub = queue.pop(0)
            for qi in sub:
                consulted[qi].add(x)
            try:
                scans, _walls = self._scan_with_cache(
                    cf, live[x], [queries[qi] for qi in sub], trace=dg
                )
            except TransientFault:
                self._read_retries.inc(len(sub))
                retry: dict[int, list[int]] = {}
                for qi in sub:
                    nxt = next(
                        (int(y) for y in order[:, col_of[qi]] if int(y) not in consulted[qi]),
                        None,
                    )
                    if nxt is None:
                        raise RuntimeError(
                            f"consistency {consistency}: fewer than {k} live "
                            f"replicas answered for {cf.name!r}"
                        )
                    retry.setdefault(nxt, []).append(qi)
                queue.extend(retry.items())
                continue
            for qi, sr in zip(sub, scans):
                alt_scans.setdefault(qi, []).append((live[x], sr))

        repaired: set[int] = set()  # replica ids healed earlier in this pass

        def _fresh(h: ReplicaHandle, qi: int, sr: ScanResult) -> ScanResult:
            # a scan taken before this pass repaired its replica is stale
            # evidence: re-read (the repair invalidated the cache)
            if h.replica_id not in repaired:
                return sr
            return self._scan_with_cache(cf, h, [queries[qi]], trace=dg)[0][0]

        def _repair(h: ReplicaHandle) -> None:
            rp = dg.child("engine.read_repair", replica=h.replica_id) if dg is not None else None
            self._repair_replica(cf, part, h)
            repaired.add(h.replica_id)
            self._read_repairs.inc()
            if rp is not None:
                rp.end()

        handle_of_rid = {r.replica_id: r for r in part.replicas}
        for qi in qidx:
            alts = alt_scans.get(qi)
            if not alts:
                continue
            prim = handle_of_rid[reports[qi].replica_id]
            entries = [(prim, _fresh(prim, qi, results[qi]))] + [
                (h, _fresh(h, qi, sr)) for h, sr in alts
            ]
            digs = [
                _result_digest(sr, self._table(cf, h), cf.key_names, cf.schema)
                for h, sr in entries
            ]
            if len(set(digs)) == 1:
                if entries[0][1] is not results[qi]:
                    results[qi] = entries[0][1]  # refreshed primary
                continue
            self._digest_mismatches.inc()
            counts: dict[int, int] = {}
            for d in digs:
                counts[d] = counts.get(d, 0) + 1
            best_d, best_n = max(counts.items(), key=lambda t: t[1])
            if best_n * 2 > len(digs):
                # majority wins: heal the minority from the log and answer
                # from a majority replica
                for (h, _sr), d in zip(entries, digs):
                    if d != best_d:
                        _repair(h)
                win, win_scan = next(e for e, d in zip(entries, digs) if d == best_d)
                results[qi] = win_scan
                reports[qi] = dataclasses.replace(
                    reports[qi], replica_id=win.replica_id, node_id=win.node_id,
                    rows_scanned=win_scan.rows_scanned,
                )
            else:
                # no majority: rebuild every consulted replica from the log
                # (the ground truth) and re-execute on the primary
                for h, _sr in entries:
                    _repair(h)
                scan = self._scan_with_cache(cf, prim, [queries[qi]], trace=dg)[0][0]
                results[qi] = scan
                reports[qi] = dataclasses.replace(reports[qi], rows_scanned=scan.rows_scanned)
        if dg is not None:
            dg.end()

    def _hedge_groups(
        self,
        live: list[ReplicaHandle],
        order: np.ndarray,
        picks: np.ndarray,
        qidx: list[int],
        hedge_ratio: float,
    ) -> dict[int, list[int]]:
        """Queries whose picked node is a straggler (slowdown >
        ``hedge_ratio``), grouped by the cheapest replica on another node —
        the alternate a scalar ``read`` hedges to. Shared by both planners;
        ``qidx[j]`` is the global query index of scheduler column ``j``."""
        groups: dict[int, list[int]] = {}
        for j, qi in enumerate(qidx):
            pick_node = live[int(picks[j])].node_id
            if self.nodes[pick_node].slowdown <= hedge_ratio:
                continue
            alt = next((int(k) for k in order[:, j] if live[int(k)].node_id != pick_node), -1)
            if alt >= 0:
                groups.setdefault(alt, []).append(qi)
        return groups

    # -- scatter-gather over the token ring ------------------------------------

    def _partition_row_offsets(self, cf: ColumnFamily) -> np.ndarray:
        """Global row offset of each partition in the cross-partition
        select index space (partitions concatenated in ring order), from
        the partition logs' row counts, so independent of staging state."""
        rows = np.array([part.n_rows_committed for part in cf.partitions], dtype=np.int64)
        offsets = np.zeros(len(rows), dtype=np.int64)
        np.cumsum(rows[:-1], out=offsets[1:])
        return offsets

    def _read_many_partitioned(
        self,
        cf: ColumnFamily,
        queries: list[Query],
        *,
        hedge: bool = False,
        hedge_ratio: float = 2.0,
        consistency: str = ONE,
        deadline_at: float | None = None,
        budget_s: float | None = None,
        trace=None,
    ) -> list[tuple[ScanResult, ReadReport]]:
        """Scatter-gather ``read_many`` over a partitioned column family.

        **Scatter** (host): each query's canonical slab bounds (the
        ``slab_bounds_many`` walk over ``key_names``, the packing the
        ring's tokens use) give a contiguous span of partitions
        (``TokenRing.span_partitions``). A ``(partition, query)`` pair
        whose slab misses the partition's observed token range
        (``Partition.may_contain``) is dropped (``empty_partition_skips``):
        no launch and no cache probe. Per partition the Cost Evaluator
        ranks the slot layouts with the partition's own ``TableStats``
        (with the view cap on a views column family), the round-robin
        tie-break draws from the partition's own counter (one draw per
        query in batch order), and each ``(partition, replica)`` group
        runs through ``_run_groups`` over the partition's live replicas
        (failover as at one partition), then the partition's hedge and
        digest passes.

        **Gather** (host): per query, the partials merge in ring order
        (``merge_partial_scans``): sums and counts add, select indices
        shift by their partition's row offset. The report carries the
        first executing partition's routing, the summed wall and whether
        any partition's answer came from a hedge; a query
        whose partitions were all skipped gets an empty result and a
        placeholder report (``replica_id == node_id == -1``).
        """
        n_q = len(queries)
        sc = trace.child("engine.scatter") if trace is not None else None
        bounds = slab_bounds_many(queries, cf.key_names, cf.schema)
        p_lo, p_hi = cf.ring.span_partitions(bounds)
        touched: dict[int, list[int]] = {}
        for qi in range(n_q):
            for pid in range(int(p_lo[qi]), int(p_hi[qi]) + 1):
                if not cf.partitions[pid].may_contain(int(bounds[qi, 0]), int(bounds[qi, 1])):
                    self._empty_partition_skips.inc()
                    continue
                touched.setdefault(pid, []).append(qi)
        if sc is not None:
            sc.end(partitions=len(touched))

        rf = cf.replication_factor
        n_slots = len(cf.slot_layouts)
        partials: dict[int, tuple[list, list]] = {}
        for pid in sorted(touched):
            self._check_deadline(deadline_at, budget_s)
            ps = trace.child("engine.partition", partition=pid) if trace is not None else None
            part = cf.partitions[pid]
            qidx = touched[pid]
            live = [r for r in part.replicas if self.nodes[r.node_id].alive]
            if not live:
                raise RuntimeError(f"no live replica for partition {pid} of {cf.name!r}")
            group = [queries[i] for i in qidx]
            rows_sub, cost_sub = cf.cost_model.rank_matrices(cf.slot_layouts, group, stats=part.stats)
            # view term: the single-partition planner's cap, per (slot
            # layout, group query)
            if cf.views and any(q.agg in VIEW_AGGS for q in group):
                elig = view_eligible_matrix(cf.slot_layouts, group)
                if elig.any():
                    capped = np.minimum(rows_sub, float(VIEW_ROWS_CAP))
                    cost_sub = np.where(
                        elig,
                        np.stack(
                            [
                                cf.cost_model.cost_fn(len(lay)).many(capped[s])
                                for s, lay in enumerate(cf.slot_layouts)
                            ]
                        ),
                        cost_sub,
                    )
            # estimates at full batch width: _execute_group indexes them by
            # global query index
            rows_mat = np.zeros((n_slots, n_q))
            cost_mat = np.zeros((n_slots, n_q))
            rows_mat[:, qidx] = rows_sub
            cost_mat[:, qidx] = cost_sub
            slots = np.asarray([r.replica_id - part.vnode_id * rf for r in live])
            factors = self._live_cost_factors(live)
            if factors is not None:
                # penalize suspected nodes' rows in place, so ranking,
                # failover order and the reported cost agree
                for k, s in enumerate(slots):
                    cost_mat[s] *= factors[k]
            order, picks = _schedule_picks(cost_mat[slots][:, qidx], part.rr_counter)
            res_p: list[ScanResult | None] = [None] * n_q
            rep_p: list[ReadReport | None] = [None] * n_q
            rows_live = rows_mat[slots]
            cost_live = cost_mat[slots]
            self._run_groups(
                cf, live, order, picks, qidx, queries, rows_live, cost_live, res_p, rep_p,
                deadline_at=deadline_at, budget_s=budget_s, trace=ps,
            )
            if hedge and len(live) > 1 and not _deadline_spent(deadline_at):
                for k, sub in self._hedge_groups(live, order, picks, qidx, hedge_ratio).items():
                    try:
                        self._execute_group(
                            cf, live[k], sub, queries, rows_live[k], cost_live[k], res_p, rep_p,
                            hedged=True, trace=ps,
                        )
                    except TransientFault:
                        continue  # a best-effort duplicate
            if consistency != ONE:
                self._consistency_pass(
                    cf, part, live, order, qidx, queries, res_p, rep_p, consistency,
                    deadline_at=deadline_at, budget_s=budget_s, trace=ps,
                )
            if ps is not None:
                ps.end()
            partials[pid] = (res_p, rep_p)

        ga = trace.child("engine.gather") if trace is not None else None
        offsets = self._partition_row_offsets(cf)
        out: list[tuple[ScanResult, ReadReport]] = []
        for qi in range(n_q):
            scans = []
            reps: list[ReadReport] = []
            for pid in range(int(p_lo[qi]), int(p_hi[qi]) + 1):
                if pid not in partials or partials[pid][0][qi] is None:
                    continue  # skipped: provably no rows in this slab
                scans.append((partials[pid][0][qi], int(offsets[pid])))
                reps.append(partials[pid][1][qi])
            if not scans:
                empty_sel = np.empty(0, dtype=np.int64) if queries[qi].agg == "select" else None
                out.append((
                    ScanResult(0.0, 0, 0, empty_sel),
                    ReadReport(
                        replica_id=-1, node_id=-1, estimated_rows=0.0, estimated_cost=0.0,
                        wall_seconds=0.0, rows_scanned=0,
                    ),
                ))
                continue
            merged = merge_partial_scans(scans, queries[qi].agg)
            first = reps[0]
            out.append((
                merged,
                ReadReport(
                    replica_id=first.replica_id,
                    node_id=first.node_id,
                    estimated_rows=first.estimated_rows,
                    estimated_cost=first.estimated_cost,
                    wall_seconds=sum(r.wall_seconds for r in reps),
                    rows_scanned=merged.rows_scanned,
                    hedged=any(r.hedged for r in reps),
                ),
            ))
        if ga is not None:
            ga.end()
        return out

    def partition_imbalance(self, cf_name: str) -> float:
        """Max/mean committed-row imbalance across the ring (1.0 =
        perfectly balanced); ``rebalance`` reports it before and after."""
        cf = self.column_families[cf_name]
        rows = np.array([p.n_rows_committed for p in cf.partitions], dtype=np.float64)
        total = rows.sum()
        if total <= 0:
            return 1.0
        return float(rows.max() / (total / rows.size))

    # -- Write Scheduler -------------------------------------------------------

    def write(
        self,
        cf_name: str,
        key_cols: Mapping[str, np.ndarray],
        value_cols: Mapping[str, np.ndarray],
        *,
        parallel: bool = False,
        flush: bool | None = None,
        trace=None,
    ) -> float:
        """Commit a batch write through the durable path and refresh
        stats; returns wall seconds. The batch is (1) appended to the
        column family's commit log, (2) staged into each live replica's
        memtable, and (3) flushed as one sorted run per replica when the
        staging threshold is reached (``memtable_rows``; 0 =
        write-through). ``flush`` forces (True) or defers (False) step 3;
        ``parallel`` runs the per-replica flushes on the engine's thread
        pool. On a device-resident column family the statistics
        refresh runs the histogram kernel on the engine's device, each
        flush appends its run to the resident tensors, and the compaction
        policy merges the run stack on the device once it outgrows the
        base.

        On a partitioned column family the batch is first split by the
        token ring: its tokens are packed once and folded into the token
        histogram (on the histogram kernel for a device-resident column
        family), each owning partition's sub-batch becomes one record in
        that partition's commit log, stages into that partition's
        replicas only and merges into that partition's statistics. The
        threshold check spans every live replica of the column family.
        After a flush, with ``rebalance_imbalance`` > 0, a column family
        whose token histogram puts more than that multiple of the mean row
        mass in one partition is rebalanced in place (:meth:`rebalance`).

        A replica on a down node neither stages nor flushes: the log holds
        the rows it missed, and a write while its hint is open counts under
        ``hints_queued`` (the hint is an LSN watermark into that log, never
        a copy)."""
        cf = self.column_families[cf_name]
        t0 = time.perf_counter()
        w = (
            trace.child(
                "engine.write", cf=cf_name,
                rows=int(len(next(iter(key_cols.values())))) if key_cols else 0,
            )
            if trace is not None
            else None
        )
        device = self.device if cf.device_resident else None
        if cf.ring.n_partitions == 1:
            routed = [(cf.partitions[0], None)]
        else:
            kc_arr = {c: np.asarray(key_cols[c]) for c in cf.key_names}
            vc_arr = {c: np.asarray(value_cols[c]) for c in cf.value_names}
            tokens = cf.ring.tokens(kc_arr, cf.schema)
            pids = cf.ring.partition_of_tokens(tokens)
            cf.token_hist.add_tokens(tokens, device=device)
            routed = []
            for pid in np.unique(pids):
                mask = pids == pid
                routed.append((
                    cf.partitions[int(pid)],
                    (
                        {c: v[mask] for c, v in kc_arr.items()},
                        {c: v[mask] for c, v in vc_arr.items()},
                        tokens[mask],
                    ),
                ))
        la = w.child("engine.log_append") if w is not None else None
        recs = []
        for part, sub in routed:
            kc_p, vc_p = (key_cols, value_cols) if sub is None else sub[:2]
            part.commitlog.append(kc_p, vc_p)
            recs.append(part.commitlog.tail)
        if la is not None:
            la.end(partitions=len(routed))
        ms = w.child("engine.memtable_stage") if w is not None else None
        # the record's columns are the log's own immutable copies, so
        # every memtable stages them by reference — one copy per write
        for (part, sub), rec in zip(routed, recs):
            for r in part.replicas:
                if self.nodes[r.node_id].alive:
                    part.memtables[r.replica_id].stage(rec.key_cols, rec.value_cols, copy=False)
                elif r.replica_id in part.hints:
                    self._hints_queued.inc()
            if sub is not None:
                part.observe_tokens(sub[2])
            if part.stats is not None:
                # the routed sub-batch folds into the partition it joined
                part.stats.merge_rows(rec.key_cols, device=device)
        cf.stats.merge_rows(key_cols, device=device)
        if ms is not None:
            ms.end()
        live = [r for r in cf.replicas if self.nodes[r.node_id].alive]
        if flush is None:
            flush = cf.memtable_rows <= 0 or any(
                self._memtable(cf, r).n_staged >= cf.memtable_rows for r in live
            )
        if flush:
            self._flush_replicas(cf, live, parallel=parallel, trace=w)
            # the drift trigger: post-flush only, so a migration (which
            # replays logs) never races staged state
            if (
                self.rebalance_imbalance > 0
                and cf.ring.n_partitions > 1
                and cf.token_hist is not None
                and cf.token_hist.imbalance(cf.ring.starts) > self.rebalance_imbalance
            ):
                self.rebalance(cf_name)
        if w is not None:
            w.end()
        return time.perf_counter() - t0

    def _flush_replicas(
        self, cf: ColumnFamily, replicas: Sequence[ReplicaHandle], *,
        parallel: bool = False, trace=None,
    ) -> None:
        """Flush the given replicas' staged rows: one sorted run per
        replica (in its own layout), checksum-verified and merged via
        ``merge_run``, result cache invalidated, then the compaction
        policy applied to the merged table. A run that fails its checksum
        raises :class:`CorruptRunError` before it merges, and its rows
        stay staged; so do those of a node whose ``flush_fault_budget``
        makes the flush raise :class:`TransientFlushError`. On a views
        column family ``merge_run`` extends each replica's view and
        compaction rebuilds it (``view_rebuilds``).

        ``parallel`` maps the per-replica part (verify, ``merge_run``,
        digest extension) over the engine's thread pool; every replica
        has its own table and tensors, and each wrapper launches on its
        calling thread's current stream. The fault budgets and the fault
        counters the threads share are charged under a lock, so a parallel
        flush counts what a serial one would; it returns or raises only
        after every replica's part has ended. Installation, views,
        memtable clears, cache invalidation and compaction stay serial, in
        replica order."""
        pending = [
            r for r in replicas
            if self.nodes[r.node_id].alive and self._memtable(cf, r).n_staged
        ]
        if not pending:
            return
        t0 = time.perf_counter()

        def _flush(r: ReplicaHandle) -> tuple[ReplicaHandle, SortedTable]:
            # peek, don't drain: the memtable is cleared only after the
            # merged table is installed, so an exception (here or in a
            # sibling thread) never loses rows
            node = self.nodes[r.node_id]
            fs = (
                trace.child(
                    "engine.flush", replica=r.replica_id, node=r.node_id,
                    rows=int(self._memtable(cf, r).n_staged),
                )
                if trace is not None
                else None
            )
            try:
                # the fault budget is shared by a node's replicas, and the
                # counters by every thread: check, charge and count as one
                with _FLUSH_BOOKKEEPING:
                    faulted = node.flush_fault_budget > 0
                    if faulted:
                        node.flush_fault_budget -= 1
                        if self.failure_detector is not None:
                            self.failure_detector.record_failure(node.node_id)
                        self._flush_faults.inc()
                if faulted:
                    raise TransientFlushError(node.node_id)
                run = self._memtable(cf, r).peek_run()
                if not run.verify():
                    with _FLUSH_BOOKKEEPING:
                        self._corrupt_runs.inc()
                    raise CorruptRunError(
                        f"flush of {cf.name!r} replica {r.replica_id}: sorted "
                        "run failed its checksum"
                    )
                table = node.tables[(cf.name, r.replica_id)]
                fm = fs.child("engine.flush_merge") if fs is not None else None
                merged = table.merge_run(run, trace=fm)
                if fm is not None:
                    fm.end()
                # extend the seal with the run's digest — O(run), and
                # derived from durable history, never from the arrays
                if table.stored_digest is not None:
                    merged.stored_digest = combine_digests(table.stored_digest, run.digest)
                else:
                    merged.seal_checksum()
            except Exception as e:
                if fs is not None:
                    fs.end(error=type(e).__name__)
                raise
            if fs is not None:
                fs.end()
            return r, merged

        if parallel and len(pending) > 1:
            # every replica's work ends before the first error is raised,
            # so no merge of a failed flush still appends to a table's
            # tensors while the caller retries
            futures = [self._executor.submit(_flush, r) for r in pending]
            wait(futures)
            merged_tables = [f.result() for f in futures]
        else:
            merged_tables = [_flush(r) for r in pending]
        for r, merged in merged_tables:
            if cf.device_resident and not merged.device_resident:
                merged.place_on_device(self.device)
            self._ensure_views(cf, merged)
            self.nodes[r.node_id].tables[(cf.name, r.replica_id)] = merged
            self._memtable(cf, r).clear()
            self._flushes.inc()
            part = cf.partitions[r.partition_id]
            # this replica's table now holds every log record below the tail
            part.flushed_lsn[r.replica_id] = part.commitlog.next_lsn
            self._invalidate_result_cache(cf.name, replica_id=r.replica_id)
            if part.compaction is not None:
                tc = trace.tracer.now() if trace is not None else 0.0
                if compact_table(merged, part.compaction):
                    # content unchanged by compaction: the seal carries over
                    self._compactions.inc()
                    if merged.has_views:
                        # compact_runs re-derived the per-block partials
                        # over the collapsed run stack (full rebuild)
                        self._view_rebuilds.inc()
                    self._invalidate_result_cache(cf.name, replica_id=r.replica_id)
                    if trace is not None:
                        trace.child("engine.compaction", t=tc, replica=r.replica_id).end()
        # count-based auto-checkpoint of each flushed partition's log once
        # every replica of that partition is drained; deferred while a hint
        # is open (a checkpoint re-numbers the record the hint points into,
        # which would force node_up onto the full-rebuild fallback)
        k = self.commitlog_checkpoint_records
        if k:
            for pid in sorted({r.partition_id for r in pending}):
                part = cf.partitions[pid]
                log = part.commitlog
                if (
                    log.should_checkpoint(k)
                    and not part.hints
                    and not any(mt.n_staged for mt in part.memtables.values())
                ):
                    log.checkpoint()
                    for rid in part.flushed_lsn:
                        part.flushed_lsn[rid] = log.next_lsn
                    self._auto_checkpoints.inc()
        self._flush_wall.inc(time.perf_counter() - t0)

    def _ensure_views(self, cf: ColumnFamily, table: SortedTable) -> None:
        """Materialize a views column family's per-block partials on
        ``table`` if absent (full rebuild from the resident tensors,
        counted under ``view_rebuilds``). Tables that already carry views
        (the incremental ``merge_run`` extension, or ``compact_runs``' own
        rebuild) are left alone. Every site that installs a new replica
        table (flush, recovery, hinted ``node_up``, read repair) passes
        through here."""
        if not cf.views or table.has_views:
            return
        if not table.device_resident:
            table.place_on_device(self.device)
        table.build_views()
        self._view_rebuilds.inc()

    def _memtable(self, cf: ColumnFamily, r: ReplicaHandle) -> Memtable:
        return cf.partitions[r.partition_id].memtables[r.replica_id]

    def _ensure_flushed(self, cf: ColumnFamily, r: ReplicaHandle, *, trace=None) -> None:
        """Flush one replica's pending staged rows (read barrier)."""
        mt = cf.partitions[r.partition_id].memtables.get(r.replica_id)
        if mt is not None and mt.n_staged:
            if trace is None:
                self._flush_replicas(cf, [r])
            else:
                fb = trace.child("engine.flush_barrier", rows=int(mt.n_staged))
                self._flush_replicas(cf, [r], trace=fb)
                fb.end()

    def flush_memtables(self, cf_name: str, *, parallel: bool = False) -> None:
        """Drain every live replica's memtable (group-commit flush);
        ``parallel`` runs the per-replica flushes on the thread pool."""
        cf = self.column_families[cf_name]
        live = [r for r in cf.replicas if self.nodes[r.node_id].alive]
        self._flush_replicas(cf, live, parallel=parallel)

    def checkpoint_commitlog(self, cf_name: str) -> int:
        """Flush every live replica, then collapse each partition's commit
        log into one snapshot record; returns the highest snapshot LSN (the
        only one when ``partitions == 1``). Every flushed replica is
        complete through the snapshot, so the watermarks advance past it;
        an open hint's tail is gone, and its ``node_up`` rebuilds."""
        self.flush_memtables(cf_name)
        top = 0
        for part in self.column_families[cf_name].partitions:
            top = max(top, part.commitlog.checkpoint())
            for rid in part.flushed_lsn:
                part.flushed_lsn[rid] = part.commitlog.next_lsn
        return top

    # -- node lifecycle and recovery -----------------------------------------------

    def _check_node(self, node_id: int) -> Node:
        if not 0 <= node_id < len(self.nodes):
            raise ValueError(f"unknown node {node_id} (cluster has {len(self.nodes)})")
        return self.nodes[node_id]

    def fail_node(self, node_id: int, *, transient: bool = False) -> None:
        """Take a node down. The default models node loss: the node's disk
        (every partition replica it hosted, across all column families) and
        memtables are gone; the partition commit logs are the durable copy
        ``recover_node`` rebuilds from. ``transient=True`` models a short
        outage: the replica tables survive, only the staged rows are lost
        (they are log records already), and each hosted replica opens a
        hint, its flushed-LSN watermark; ``node_up`` replays only the log
        tail past it. Failing a node that is already down is a no-op (the
        first failure's hints keep their older, still correct watermarks);
        an out-of-range ``node_id`` raises ``ValueError``."""
        node = self._check_node(node_id)
        if not node.alive:
            return
        node.alive = False
        for cf_name, cf in self.column_families.items():
            for part in cf.partitions:
                for r in part.replicas:
                    if r.node_id != node_id:
                        continue
                    rid = r.replica_id
                    if transient:
                        part.hints[rid] = part.flushed_lsn.get(rid, 0)
                    else:
                        part.hints.pop(rid, None)
                        part.flushed_lsn.pop(rid, None)
                    # the memtable dies with its node either way; the commit
                    # log is the durable copy every staged row replays from
                    part.memtables[rid].clear()
            self._invalidate_result_cache(cf_name, node_id=node_id)
        if not transient:
            node.tables = {}  # disk lost

    def _rebuild_replica_table(
        self, cf: ColumnFamily, part: Partition, r: ReplicaHandle, *, source: str = "log",
    ) -> SortedTable:
        """Rebuild one partition replica's whole table in its own layout:
        replay the partition's commit log (``source="log"``, the ground
        truth) or re-sort a live peer (``source="survivor"``). On a
        device-resident column family the table is placed on the engine's
        device and, on a views column family, its view built there."""
        log = part.commitlog
        if source == "log" and log is not None and len(log):
            kc, vc = log.replay_columns()
            rebuilt = SortedTable.from_columns(kc, vc, r.layout, cf.schema)
        else:
            survivor = next(
                (
                    s
                    for s in part.replicas
                    if s.replica_id != r.replica_id
                    and self.nodes[s.node_id].alive
                    and (cf.name, s.replica_id) in self.nodes[s.node_id].tables
                ),
                None,
            )
            if survivor is None:
                raise RuntimeError(
                    f"data loss: no survivor for {cf.name!r} partition "
                    f"{part.partition_id} replica {r.replica_id}"
                )
            self._ensure_flushed(cf, survivor)  # its staged rows too
            rebuilt = self._table(cf, survivor).resorted(r.layout)
        if cf.device_resident:
            rebuilt.place_on_device(self.device)
        self._ensure_views(cf, rebuilt)
        return rebuilt.seal_checksum()

    def _install_rebuilt(
        self, cf: ColumnFamily, part: Partition, r: ReplicaHandle, table: SortedTable,
    ) -> None:
        """Install a fully rebuilt replica table: a fresh memtable (a full
        rebuild is flushed state), the hint discharged, the watermark at
        the log's tail, stale cached results dropped."""
        rid = r.replica_id
        self.nodes[r.node_id].tables[(cf.name, rid)] = table
        part.memtables[rid] = Memtable(r.layout, cf.schema, cf.key_names, cf.value_names)
        part.hints.pop(rid, None)
        part.flushed_lsn[rid] = part.commitlog.next_lsn
        self._invalidate_result_cache(cf.name, replica_id=rid)

    def _repair_replica(self, cf: ColumnFamily, part: Partition, r: ReplicaHandle) -> None:
        """Heal one live replica in place from the partition log (read
        repair, scrub); the caller counts the trigger."""
        self._install_rebuilt(cf, part, r, self._rebuild_replica_table(cf, part, r))

    def node_up(self, node_id: int) -> float:
        """Bring a transiently failed node back, healing each hosted
        replica by hinted handoff: replay only the log tail past the hint
        and merge it into the surviving table as one sorted run (on a
        resident table the run is appended to the tensors and the view
        extended). A replica whose partition committed nothing meanwhile
        costs nothing. Falls back to a full rebuild, counted in
        ``hint_fallbacks``, when the table is gone (a durable failure), the
        hint predates a checkpoint (``CommitLog.can_replay_from``), or no
        hint was opened. Returns wall seconds; a live node is a no-op
        returning 0.0."""
        node = self._check_node(node_id)
        if node.alive:
            return 0.0
        t0 = time.perf_counter()
        node.alive = True
        for cf_name in self.column_families:
            self._invalidate_result_cache(cf_name, node_id=node_id)
        for cf in self.column_families.values():
            for part in cf.partitions:
                for r in part.replicas:
                    if r.node_id != node_id:
                        continue
                    rid = r.replica_id
                    log = part.commitlog
                    table = node.tables.get((cf.name, rid))
                    hint = part.hints.pop(rid, None)
                    if table is None or hint is None or not log.can_replay_from(hint):
                        self._hint_fallbacks.inc()
                        self._install_rebuilt(cf, part, r, self._rebuild_replica_table(cf, part, r))
                        continue
                    kc, vc = log.replay_columns(start_lsn=hint)
                    n_rows = next(iter(kc.values())).shape[0] if kc else 0
                    if n_rows:
                        run = sort_run(kc, vc, r.layout, cf.schema)
                        merged = table.merge_run(run)
                        if cf.device_resident and not merged.device_resident:
                            merged.place_on_device(self.device)
                        self._ensure_views(cf, merged)
                        if table.stored_digest is not None:
                            merged.stored_digest = combine_digests(table.stored_digest, run.digest)
                        else:
                            merged.seal_checksum()
                        node.tables[(cf.name, rid)] = merged
                        self._hint_replays.inc()
                        self._hint_rows_replayed.inc(n_rows)
                    # no missed rows: the surviving table is complete as is
                    part.flushed_lsn[rid] = log.next_lsn
                    part.memtables[rid] = Memtable(r.layout, cf.schema, cf.key_names, cf.value_names)
        return time.perf_counter() - t0

    def recover_node(self, node_id: int, *, source: str = "log") -> float:
        """Rebuild every partition replica a down node hosted, each in its
        own layout from its own partition (other partitions are not
        touched): ``source="log"`` (default) replays the partition's commit
        log — base rows and every committed write, the ones the node missed
        included — and ``source="survivor"`` re-sorts a live peer. Both give
        the same packed keys and key columns. Returns wall seconds; a live
        node is a no-op returning 0.0 (use ``node_up`` after a transient
        failure, ``scrub_column_family`` to audit)."""
        if source not in ("log", "survivor"):
            raise ValueError(f"unknown recovery source {source!r}")
        node = self._check_node(node_id)
        if node.alive:
            return 0.0
        t0 = time.perf_counter()
        node.alive = True
        for cf_name in self.column_families:
            self._invalidate_result_cache(cf_name, node_id=node_id)
        for cf in self.column_families.values():
            for part in cf.partitions:
                for r in part.replicas:
                    if r.node_id == node_id:
                        self._install_rebuilt(
                            cf, part, r, self._rebuild_replica_table(cf, part, r, source=source)
                        )
        return time.perf_counter() - t0

    def scrub_column_family(self, cf_name: str, *, repair: bool = True) -> dict:
        """Audit every live replica's sealed content checksum against its
        host columns and heal mismatches from the partition log
        (``scrub_repairs``). On a views column family a replica whose
        columns verify also has its view audited against a fresh fold of
        the resident tensors (``verify_views``, the ``block_sums`` kernel);
        a corrupt or missing view is rebuilt from the tensors, no log
        replay, counted under ``scrub_repairs`` and ``view_rebuilds``.
        Returns ``{"replicas_checked", "corrupt", "repaired"}``; with
        ``repair=False`` corruption is only reported."""
        cf = self.column_families[cf_name]
        checked = 0
        corrupt: list[int] = []
        repaired = 0
        for part in cf.partitions:
            for r in part.replicas:
                node = self.nodes[r.node_id]
                if not node.alive:
                    continue
                table = node.tables.get((cf.name, r.replica_id))
                if table is None:
                    continue
                checked += 1
                self._scrub_checks.inc()
                if table.verify_checksum():
                    if cf.views and (not table.has_views or not verify_views(table)):
                        corrupt.append(r.replica_id)
                        if repair:
                            table.build_views()
                            self._view_rebuilds.inc()
                            self._scrub_repairs.inc()
                            self._invalidate_result_cache(cf.name, replica_id=r.replica_id)
                            repaired += 1
                    continue
                corrupt.append(r.replica_id)
                if repair:
                    self._repair_replica(cf, part, r)
                    self._scrub_repairs.inc()
                    repaired += 1
        return {"replicas_checked": checked, "corrupt": corrupt, "repaired": repaired}

    # -- ring migration (vnode split / merge / rebalance) ---------------------------

    def split_partition(self, cf_name: str, partition_id: int, token: int | None = None) -> int:
        """Online split: cut one partition's token range in two at
        ``token`` (rows with canonical token >= ``token`` go to the right
        child); by default at the partition's median committed token, the
        cut that halves its rows. Both children are fresh vnodes rebuilt
        from token-sliced copies of the parent's log (:meth:`_reshard`);
        every other partition is untouched. Returns the cut token."""
        cf = self.column_families[cf_name]
        part = cf.partitions[partition_id]
        if token is None:
            kc, _ = part.commitlog.replay_columns()
            toks = np.sort(pack_columns(kc, cf.key_names, cf.schema))
            if toks.size:
                token = int(toks[toks.size // 2])
            else:
                token = (part.token_lo + part.token_hi + 1) // 2
            # a median equal to the range start cannot form a boundary
            token = max(token, part.token_lo + 1)
        token = int(token)
        if not part.token_lo < token <= part.token_hi:
            raise ValueError(
                f"split token {token} outside partition {partition_id}'s "
                f"range ({part.token_lo}, {part.token_hi}]"
            )
        self._reshard(cf, sorted(cf.ring.starts + (token,)))
        return token

    def merge_partitions(self, cf_name: str, partition_id: int) -> None:
        """Online merge: fuse ring-adjacent partitions ``partition_id`` and
        ``partition_id + 1`` into one fresh vnode whose log is the two
        logs concatenated in ring order (:meth:`_reshard`)."""
        cf = self.column_families[cf_name]
        if partition_id + 1 >= cf.ring.n_partitions:
            raise ValueError(f"partition {partition_id} has no right neighbor to merge with")
        starts = list(cf.ring.starts)
        del starts[partition_id + 1]
        self._reshard(cf, starts)

    def rebalance(self, cf_name: str, *, partitions: int | None = None, exact: bool = True) -> dict:
        """Move the ring boundaries to the committed rows' token quantiles,
        so each partition owns ~1/P of the rows (one ring-wide reshard).
        ``partitions`` changes P (default: keep it). ``exact=True`` takes
        quantiles of the exact committed tokens replayed from the logs;
        ``exact=False`` the token histogram's proposal (one bin's
        resolution). Partitions whose range is unchanged keep all state.
        Returns ``{"partitions", "imbalance_before", "imbalance_after",
        "rows_moved"}``; a no-op (0 rows moved) when the boundaries come
        out unchanged."""
        cf = self.column_families[cf_name]
        n_parts = cf.ring.n_partitions if partitions is None else int(partitions)
        before = self.partition_imbalance(cf_name)
        if exact or cf.token_hist is None:
            toks = np.concatenate([
                pack_columns(p.commitlog.replay_columns()[0], cf.key_names, cf.schema)
                for p in cf.partitions
            ])
            new_ring = TokenRing.from_tokens(cf.schema, cf.key_names, toks, n_parts)
        else:
            new_ring = TokenRing.from_histogram(cf.schema, cf.key_names, cf.token_hist, n_parts)
        moved = 0
        if new_ring.starts != cf.ring.starts:
            moved = self._reshard(cf, new_ring.starts)
        return {
            "partitions": n_parts,
            "imbalance_before": before,
            "imbalance_after": self.partition_imbalance(cf_name),
            "rows_moved": moved,
        }

    def _reshard(self, cf: ColumnFamily, new_starts: Sequence[int]) -> int:
        """Rebuild the ring around new boundaries; returns the rows moved.

        * A partition whose inclusive ``[lo, hi]`` range is unchanged is
          kept: same vnode, log, tables, memtables, statistics, cache,
          round-robin counter, hints and watermarks; only its
          ``partition_id`` is renumbered.
        * Every other range is a fresh vnode whose log is the token-sliced
          concatenation (ring order, fresh LSNs) of the overlapping old
          logs, and whose replica tables replay it in their layouts (the
          ``recover_node(source="log")`` path). Staged rows ride along as
          log records, so the fresh memtables start empty; the fresh
          partition has no hints and its watermarks sit at the new log's
          tail. On a device-resident column family each table is placed on
          the engine's device and, with views, its view built.
        * A replica placed on a dead node is not installed
          (``recover_node`` rebuilds it from the new log). Only the
          migrated replica ids lose their node tables and cached results,
          which releases their tensors.

        Counters: each boundary the new ring adds is a split, each it drops
        a merge; the committed rows of every rebuilt partition count as
        moved."""
        new_ring = cf.ring.with_starts(new_starts)
        old_parts = list(cf.partitions)
        old_ranges = [(p.token_lo, p.token_hi) for p in old_parts]
        old_by_range = dict(zip(old_ranges, old_parts))
        rf = cf.replication_factor
        new_parts: list[Partition] = []
        rows_moved = 0
        for pid in range(new_ring.n_partitions):
            nlo, nhi = new_ring.token_range(pid)
            kept = old_by_range.get((nlo, nhi))
            if kept is not None:
                kept.partition_id = pid
                for r in kept.replicas:
                    r.partition_id = pid
                new_parts.append(kept)
                continue
            overlap = [
                p for p, (olo, ohi) in zip(old_parts, old_ranges) if not (ohi < nlo or olo > nhi)
            ]

            def in_range(kc, _lo=nlo, _hi=nhi):
                t = pack_columns(kc, cf.key_names, cf.schema)
                return (t >= _lo) & (t <= _hi)

            log = CommitLog.concatenated([p.commitlog.sliced(in_range) for p in overlap])
            kc, vc = log.replay_columns()
            toks = pack_columns(kc, cf.key_names, cf.schema)
            # a pure union of whole old ranges adds their histograms
            # bin-wise (disjoint rows); a cut range recomputes from its rows
            if (
                len(overlap) > 1
                and overlap[0].token_lo == nlo
                and overlap[-1].token_hi == nhi
                and all(p.stats is not None for p in overlap)
            ):
                stats_p = overlap[0].stats
                for p in overlap[1:]:
                    stats_p = stats_p.merged_with(p.stats)
            else:
                stats_p = TableStats.from_columns(kc, cf.schema)
            vnode = cf.next_vnode
            cf.next_vnode += 1
            handles: list[ReplicaHandle] = []
            memtables: dict[int, Memtable] = {}
            flushed_lsn: dict[int, int] = {}
            for slot, layout in enumerate(cf.slot_layouts):
                rid = vnode * rf + slot
                node_id = self._place(rid, cf.name)
                if self.nodes[node_id].alive:
                    table = SortedTable.from_columns(kc, vc, layout, cf.schema)
                    if cf.device_resident:
                        table.place_on_device(self.device)
                    # a resharded vnode's view is built over its sliced
                    # rows; kept vnodes keep theirs
                    self._ensure_views(cf, table)
                    table.seal_checksum()
                    self.nodes[node_id].tables[(cf.name, rid)] = table
                    flushed_lsn[rid] = log.next_lsn
                handles.append(ReplicaHandle(rid, tuple(layout), node_id, partition_id=pid))
                memtables[rid] = Memtable(layout, cf.schema, cf.key_names, cf.value_names)
            part = Partition(
                partition_id=pid,
                token_lo=nlo,
                token_hi=nhi,
                replicas=handles,
                commitlog=log,
                memtables=memtables,
                compaction=overlap[0].compaction if overlap else cf.compaction,
                vnode_id=vnode,
                stats=stats_p,
                flushed_lsn=flushed_lsn,
            )
            part.observe_tokens(toks)
            new_parts.append(part)
            rows_moved += log.n_rows

        # retire the migrated partitions: their replica ids vanish, and with
        # them their node tables (and tensors) and cached results; kept
        # partitions' caches stay warm
        kept_ids = {id(p) for p in new_parts}
        for part in old_parts:
            if id(part) in kept_ids:
                continue
            for r in part.replicas:
                self.nodes[r.node_id].tables.pop((cf.name, r.replica_id), None)
                self._result_cache.pop((cf.name, r.replica_id), None)
                self._cache_sel_bytes.pop((cf.name, r.replica_id), None)
            part.memtables.clear()

        old_set, new_set = set(cf.ring.starts), set(new_ring.starts)
        self._partition_splits.inc(len(new_set - old_set))
        self._partition_merges.inc(len(old_set - new_set))
        self._rebalance_rows_moved.inc(rows_moved)
        cf.ring = new_ring
        cf.partitions = new_parts
        return rows_moved

    # -- introspection -------------------------------------------------------------

    def layouts(self, cf_name: str) -> tuple[tuple[str, ...], ...]:
        """Per-replica layouts in global replica-id order."""
        return tuple(r.layout for r in self.column_families[cf_name].replicas)

    def total_bytes(self) -> int:
        """Bytes every node stores (:meth:`Node.bytes_stored`): the measure
        of the paper's storage claim, that HR stores no more than TR."""
        return sum(n.bytes_stored() for n in self.nodes)
