"""SortedTable — the SSTable analogue (paper §3.1, Fig 2).

A table holds columnar data sorted lexicographically by a *layout*
(permutation of the clustering key columns). A query with an equality
prefix and one range filter touches a *contiguous slab* of rows: Cassandra
"traverses from the lower bound and terminates at the first key exceeding
the end boundary" — here the slab is located with two binary searches on
the packed composite key, then scanned with residual predicates.

The slab size IS the paper's ``Row(r, q)`` ground truth; ``execute``
returns it alongside the query result. A table placed on a device
(:meth:`SortedTable.place_on_device`) answers sum, count and select
queries from its resident tensors through the fused locate+scan and
select-compaction kernels (``repro_torch.kernels.ops``); writes append
runs to the resident tensors and :meth:`SortedTable.compact_runs` merges
them on the device. A resident table may also carry a materialized
per-slab view (:meth:`SortedTable.build_views`, ``storage.views``) that
answers eligible sums and counts from per-block partials.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from .keys import KeySchema, _field_shifts, pack_columns, pack_tuple
from .workload import Query

__all__ = [
    "SortedTable",
    "ScanResult",
    "slab_bounds_for",
    "slab_bounds_many",
    "merge_partial_scans",
]


@dataclasses.dataclass(frozen=True)
class ScanResult:
    """Result of executing a query on one replica's table.

    Frozen: the engine's result cache hands the same object to every
    hit, so field mutation would corrupt later reads (the ``selected``
    array's *buffer* is additionally write-protected when cached)."""

    value: float  # aggregate value ("select" reports match count here too)
    rows_scanned: int  # slab size — rows streamed from storage (paper Row())
    rows_matched: int  # rows passing all residual predicates
    selected: np.ndarray | None = None  # row indices for agg == "select"


def merge_partial_scans(
    partials: Sequence[tuple[ScanResult, int]], agg: str
) -> ScanResult:
    """Merge per-partition partial scan results into one ``ScanResult``
    (the gather half of a partitioned ``read_many``).

    ``partials`` is ``[(result, row_offset)]`` in ring order; partitions
    hold disjoint row sets, so sums, match counts and slab row counts
    simply add (partial sums accumulate in ring order, so the float
    result is deterministic). For ``agg == "select"`` each partition's
    local row indices shift by that partition's global row offset and
    concatenate — the merged index space is "partitions in ring order,
    each in its serving replica's serialization order", the P-partition
    analogue of a single replica's row order. Offsets are applied into
    fresh arrays: a partial may be a shared (frozen) result-cache entry.
    """
    if len(partials) == 1 and agg != "select":
        return partials[0][0]
    value = sum(float(r.value) for r, _ in partials)
    scanned = sum(int(r.rows_scanned) for r, _ in partials)
    matched = sum(int(r.rows_matched) for r, _ in partials)
    if agg != "select":
        return ScanResult(value, scanned, matched)
    chunks = [
        r.selected.astype(np.int64, copy=True) + off
        for r, off in partials
        if r.selected is not None and r.selected.size
    ]
    selected = (
        np.concatenate(chunks) if chunks else np.empty(0, np.int64)
    )
    return ScanResult(float(matched), scanned, matched, selected=selected)


def slab_bounds_for(
    query: Query, layout: Sequence[str], schema: KeySchema
) -> tuple[int, int]:
    """Packed-key [lo, hi) bounds of the contiguous slab a query touches.

    Walk the layout: keys with equality filters extend the fixed prefix;
    the first non-equality key contributes its range and terminates the
    prefix (everything after it is residual-filtered during the scan, so
    its slab bounds are the full per-column domain).
    """
    los: list[int] = []
    his: list[int] = []
    open_range = False
    for col in layout:
        if open_range:
            lo_c, hi_c = 0, schema.max_value(col) + 1
        else:
            lo_c, hi_c = query.filter_bounds(schema, col)
            if hi_c <= lo_c:
                # degenerate (empty) filter range: the query matches no
                # row — return an empty slab instead of packing hi_c - 1
                # (< lo_c), which would raise.
                return 0, 0
            if not query.is_equality_on(col):
                open_range = True
        los.append(lo_c)
        his.append(hi_c - 1)  # inclusive upper value per field
    lo = pack_tuple(los, layout, schema)
    hi = pack_tuple(his, layout, schema) + 1  # exclusive
    return lo, hi


def _slab_col_bounds(
    queries: Sequence[Query], layout: Sequence[str], schema: KeySchema
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-column slab bounds for a query batch: ``(los, his, nonempty)``
    with ``los``/``his`` int64[Q, K] (his *inclusive*) and ``nonempty``
    a bool[Q] mask of queries whose filter ranges are all non-degenerate.

    This is the layout walk shared by :func:`slab_bounds_many` (which
    packs the columns into composite keys for the host searchsorted) and
    the device read path (which ships them as int32 key lanes to the
    kernels — ``repro_torch.kernels.ops``). Validation is deferred and
    masked exactly like the scalar walk: only nonempty queries may raise
    on out-of-domain bounds.
    """
    schema.check_layout(layout)
    n_q, n_k = len(queries), len(layout)
    los = np.zeros((n_q, n_k), dtype=np.int64)
    his = np.zeros((n_q, n_k), dtype=np.int64)
    nonempty = np.ones(n_q, dtype=bool)
    open_range = np.zeros(n_q, dtype=bool)
    for j, col in enumerate(layout):
        full_lo, full_hi = 0, schema.max_value(col) + 1
        for i, q in enumerate(queries):
            if open_range[i] or not nonempty[i]:
                # open prefix — or a query already known empty, whose
                # remaining filters must not be evaluated (the scalar
                # walk returns before reaching them)
                lo_c, hi_c = full_lo, full_hi
            else:
                f = q.filters.get(col)
                if f is None:  # global range filter opens the prefix
                    lo_c, hi_c = full_lo, full_hi
                    open_range[i] = True
                elif f.is_equality:
                    lo_c = f.value
                    hi_c = lo_c + 1
                else:
                    lo_c, hi_c = f.start, f.end
                    if hi_c <= lo_c:
                        nonempty[i] = False
                        lo_c, hi_c = full_lo, full_hi  # placeholder; masked below
                    else:
                        open_range[i] = True
            los[i, j] = lo_c
            his[i, j] = hi_c - 1  # inclusive upper value per field
    # validation is deferred and masked: the scalar walk returns (empty
    # slab) on a degenerate range before pack_tuple ever checks the
    # other columns, so only nonempty queries may raise here
    for j, col in enumerate(layout):
        bad = nonempty & ((los[:, j] < 0) | (his[:, j] > schema.max_value(col)))
        if bad.any():
            raise ValueError(
                f"query {int(np.argmax(bad))} bounds out of range for column {col!r}"
            )
    return los, his, nonempty


def slab_bounds_many(
    queries: Sequence[Query], layout: Sequence[str], schema: KeySchema
) -> np.ndarray:
    """Packed-key [lo, hi] slab bounds for a query batch: int64[Q, 2].

    Same walk as :func:`slab_bounds_for` but with the per-column bounds
    gathered into ``int64[Q, K]`` arrays (:func:`_slab_col_bounds`) and
    packed with one vectorized shift-or per column. Unlike the scalar
    function the upper bound is returned *inclusive* — a 63-bit schema
    packs its maximum key to ``2**63 − 1``, and the scalar ``+ 1`` would
    wrap int64 (``slab_many`` compensates with ``side="right"``, an
    exact equivalent). Queries with a degenerate (empty) filter range
    get ``lo = 0, hi = −1``.
    """
    los, his, nonempty = _slab_col_bounds(queries, layout, schema)
    n_q = len(queries)
    # MSB-first packing, same field shifts as keys.pack_tuple
    sh = np.asarray(_field_shifts(schema, layout), dtype=np.int64)
    out = np.empty((n_q, 2), dtype=np.int64)
    out[:, 0] = ((los << sh).sum(axis=1)) * nonempty
    out[:, 1] = np.where(nonempty, (his << sh).sum(axis=1), -1)
    return out


@dataclasses.dataclass
class SortedTable:
    layout: tuple[str, ...]
    schema: KeySchema
    key_cols: dict[str, np.ndarray]  # sorted, int64
    value_cols: dict[str, np.ndarray]  # sorted alongside
    packed: np.ndarray  # int64, ascending
    # device-resident tensors (repro_torch.kernels.ops.build_device_state)
    # — populated by place_on_device(); never part of table identity
    _device: dict | None = dataclasses.field(default=None, repr=False, compare=False)
    # multiset content digest sealed at CREATE and *extended* (never
    # recomputed from memory) by each flush — see
    # ``storage.content_digest``. Not table identity
    stored_digest: int | None = dataclasses.field(default=None, repr=False, compare=False)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_columns(
        cls,
        key_cols: Mapping[str, np.ndarray],
        value_cols: Mapping[str, np.ndarray],
        layout: Sequence[str],
        schema: KeySchema | None = None,
    ) -> "SortedTable":
        if schema is None:
            schema = KeySchema.for_columns(key_cols)
        layout = tuple(layout)
        packed = pack_columns(key_cols, layout, schema)
        order = np.argsort(packed, kind="stable")
        return cls(
            layout=layout,
            schema=schema,
            key_cols={c: np.asarray(v)[order].astype(np.int64) for c, v in key_cols.items()},
            value_cols={c: np.asarray(v)[order] for c, v in value_cols.items()},
            packed=packed[order],
        )

    def __len__(self) -> int:
        return int(self.packed.shape[0])

    @property
    def n_rows(self) -> int:
        return len(self)

    def resorted(self, layout: Sequence[str]) -> "SortedTable":
        """Same dataset, another serialization: the recovery path that
        rebuilds a lost replica by re-sorting a survivor (paper §4). The
        result is a host table; the engine places it on its device."""
        return SortedTable.from_columns(self.key_cols, self.value_cols, layout, self.schema)

    def dataset_fingerprint(self) -> str:
        """Order-independent content hash: replicas of the same dataset have
        equal fingerprints whatever their serialization (the HR invariant).
        Rows are brought to a canonical order (lexicographic over the sorted
        column names, value columns as tie-breakers) and hashed exactly —
        the reference's definition, so the two packages' fingerprints of
        the same rows are equal."""
        import hashlib

        canon = tuple(sorted(self.key_cols))
        packed = pack_columns(self.key_cols, canon, self.schema)
        vnames = tuple(sorted(self.value_cols))
        tiebreak = [np.asarray(self.value_cols[c], dtype=np.float64) for c in reversed(vnames)]
        order = np.lexsort(tuple(tiebreak) + (packed,))
        md = hashlib.md5()
        md.update(packed[order].tobytes())
        for c in vnames:
            md.update(c.encode())
            md.update(np.asarray(self.value_cols[c], dtype=np.float64)[order].tobytes())
        return md.hexdigest()

    # -- content checksums ---------------------------------------------------

    def content_digest(self) -> int:
        """Order/layout-independent multiset digest of the key + value
        columns (see ``storage.content_digest``): every replica of the
        same row set agrees on it regardless of serialization."""
        from .storage.memtable import content_digest

        return content_digest(self.key_cols, self.value_cols)

    def seal_checksum(self) -> "SortedTable":
        """Record the current content digest in ``stored_digest`` (the
        engine seals at CREATE; a flush *extends* the seal with the run's
        digest instead). Returns ``self`` for chaining."""
        self.stored_digest = self.content_digest()
        return self

    def verify_checksum(self) -> bool:
        """True when the sealed digest still matches the content (or no
        digest was ever sealed — nothing to verify against)."""
        return self.stored_digest is None or self.content_digest() == self.stored_digest

    # -- device residency ----------------------------------------------------

    def place_on_device(self, device=None) -> "SortedTable":
        """Materialize the columns as resident tensors on ``device``
        (default ``cuda``): int32 key lanes — wide columns split into
        two — plus float32 value rows. Afterwards ``execute``/
        ``execute_many`` answer sum, count AND select queries from the
        device, and ``slab_many`` locates slabs there while the tensors
        hold one sorted run. Raises ``ValueError`` naming the offending column if a
        key column exceeds the two-lane 60-bit budget.

        Placement is *incremental*: ``merge_run`` appends each merged
        write run to the resident tensors, so a resident table is not
        re-uploaded after writes, and on a resident table this is a
        no-op. Returns ``self`` for chaining."""
        from ..kernels.ops import build_device_state

        if self._device is None:
            self._device = build_device_state(self, device="cuda" if device is None else device)
        return self

    @property
    def device_resident(self) -> bool:
        return self._device is not None

    # -- materialized per-slab views ----------------------------------------

    def build_views(self, *, trace=None) -> "SortedTable":
        """(Re)build the materialized per-slab aggregate view over the
        resident tensors (``storage.views``): per-block float32 partial
        sums of the value tile (the ``block_sums`` kernel) plus the per-run
        packed key index. Views are *derived* state. Requires device
        residency. Returns ``self`` for chaining."""
        from .storage.views import build_views_state

        if self._device is None:
            raise ValueError("build_views requires a device-resident table")
        vb = trace.child("view.build", rows=len(self)) if trace is not None else None
        self._device["views"] = build_views_state(self._device, self.packed)
        if vb is not None:
            vb.end()
        return self

    @property
    def has_views(self) -> bool:
        return self._device is not None and "views" in self._device

    def _view_eligible(self, query: Query) -> bool:
        """Queries the view answers bit-identically to the fused scan:
        sum/count whose filters the slab walk fully consumes on this
        layout (no residual predicate), with the view built and sum value
        columns resident."""
        from .storage.views import query_view_eligible

        return (
            self.has_views
            and query_view_eligible(query, self.layout)
            and (query.agg != "sum" or query.value_col in self._device["value_rows"])
        )

    def _device_eligible(self, query: Query) -> bool:
        """Queries the device path answers end-to-end: sum/count
        aggregations and "select" row emission. Sums need their value
        column resident; unknown aggregations keep the numpy path (which
        raises, same as a host table)."""
        return (
            self._device is not None
            and query.agg in ("sum", "count", "select")
            and (query.agg != "sum" or query.value_col in self.value_cols)
        )

    # -- writes (LSM-style bulk merge) --------------------------------------

    def merge_insert(
        self, key_cols: Mapping[str, np.ndarray], value_cols: Mapping[str, np.ndarray]
    ) -> "SortedTable":
        """Merge an unsorted write batch: sort it into a run in this
        table's own layout, then :meth:`merge_run` it."""
        from .storage.memtable import sort_run

        return self.merge_run(sort_run(key_cols, value_cols, self.layout, self.schema))

    def merge_run(self, run, *, trace=None) -> "SortedTable":
        """Merge one presorted run (memtable flush → SSTable merge).

        ``run`` carries ``key_cols``/``value_cols``/``packed`` already
        sorted by this table's layout (``storage.SortedRun``). Ties merge
        new-rows-first: a freshly written row lands *before* equal
        existing rows, and rows within the run keep arrival order — the
        order ``row_map`` and the device merge-rank kernel reproduce.
        The host merge is one stable sort of the concatenated packed keys
        (adaptive: two sorted runs merge in ~O(N)) and precomputed
        destination scatters for the columns.

        If this table is device-resident, the run is *appended* to the
        resident tensors (``kernels.ops.device_state_append``) instead of
        re-uploading the table: the returned table is immediately
        resident, with a ``row_map`` translating device row order (base
        rows then appended runs) back to the merged host order. A view is
        extended O(run) (``storage.views.extend_views_state``); ``trace``
        records that as a ``view.build`` span."""
        new_packed = np.asarray(run.packed)
        m = int(new_packed.shape[0])
        n_old = len(self)
        # merge positions of the new run into the existing rows
        pos = np.searchsorted(self.packed, new_packed, side="left")
        if m == 0:
            kc = {c: v.copy() for c, v in self.key_cols.items()}
            vc = {c: np.asarray(v).copy() for c, v in self.value_cols.items()}
            merged = SortedTable(self.layout, self.schema, kc, vc, self.packed.copy())
        else:
            # destination rows reproduce np.insert semantics exactly:
            # run row j lands at pos[j] + j, old row i shifts past the
            # new rows at-or-before it (ties: new rows first)
            dest_new = pos + np.arange(m, dtype=np.int64)
            shift = np.searchsorted(new_packed, self.packed, side="right")
            dest_old = np.arange(n_old, dtype=np.int64) + shift
            merged_packed = np.concatenate([self.packed, new_packed])
            merged_packed.sort(kind="stable")

            def _scatter(old: np.ndarray, new: np.ndarray) -> np.ndarray:
                out = np.empty(n_old + m, dtype=old.dtype)
                out[dest_old] = old
                out[dest_new] = new
                return out

            kc = {c: _scatter(self.key_cols[c], run.key_cols[c]) for c in self.key_cols}
            vc = {
                c: _scatter(np.asarray(self.value_cols[c]), np.asarray(run.value_cols[c]))
                for c in self.value_cols
            }
            merged = SortedTable(self.layout, self.schema, kc, vc, merged_packed)
        if self._device is not None:
            from ..kernels.ops import device_state_append

            merged._device = device_state_append(
                self._device, merged, run.key_cols, run.value_cols, pos
            )
            if "views" in self._device and m > 0:
                # extend the materialized view O(run): only blocks at or
                # after the append point refold (storage.views)
                from .storage.views import extend_views_state

                vb = (
                    trace.child("view.build", rows=m, incremental=True)
                    if trace is not None
                    else None
                )
                merged._device["views"] = extend_views_state(
                    self._device["views"], merged._device, new_packed, n_old
                )
                if vb is not None:
                    vb.end()
        return merged

    def compact_runs(self) -> "SortedTable":
        """Collapse appended device runs into one sorted run *on the
        device* (``kernels.ops.merge_device_runs``: merge ranks plus one
        scatter per resident tensor) — nothing is re-uploaded. Afterwards
        device row order equals host row order again, and a view is
        rebuilt whole (block boundaries moved with the row order). No-op
        on host tables and single-run states. Returns ``self``."""
        if self._device is not None and self._device.get("n_runs", 1) > 1:
            from ..kernels.ops import merge_device_runs

            had_views = "views" in self._device
            self._device = merge_device_runs(self._device)
            if had_views:
                self.build_views()
        return self

    # -- reads ---------------------------------------------------------------

    def slab(self, query: Query) -> tuple[int, int]:
        """Row index range [lo_idx, hi_idx) the query must stream."""
        lo_key, hi_key = slab_bounds_for(query, self.layout, self.schema)
        lo = int(np.searchsorted(self.packed, lo_key, side="left"))
        # search for the inclusive upper key with side="right": a 63-bit
        # schema's exclusive bound is 2**63, which does not fit int64 and
        # would be float-cast (losing low bits) by searchsorted
        hi = int(np.searchsorted(self.packed, hi_key - 1, side="right"))
        return lo, hi

    def slab_many(self, queries: Sequence[Query]) -> np.ndarray:
        """Row index slabs ``int64[Q, 2]`` for a query batch.

        A resident table holding a single sorted run locates them on its
        device with the k-ary search kernel
        (``kernels.ops.table_slab_locate_many``). Every other table (host
        tables, and resident tensors with appended runs, whose device row
        order is not sorted) takes one vectorized ``np.searchsorted`` over
        the packed bound array; both give the same slabs. The fused read
        path never calls this: it decides slab membership by key."""
        queries = list(queries)
        if queries and self._device is not None and self._device.get("n_runs", 1) == 1:
            from ..kernels.ops import table_slab_locate_many

            return table_slab_locate_many(self, queries)
        bounds = slab_bounds_many(queries, self.layout, self.schema)
        lo = np.searchsorted(self.packed, bounds[:, 0], side="left")
        # inclusive upper key + side="right" ≡ scalar (hi + 1, side="left")
        # without the int64 wrap at 63-bit schemas
        hi = np.searchsorted(self.packed, bounds[:, 1], side="right")
        return np.stack([lo, hi], axis=1).astype(np.int64)

    def execute(self, query: Query) -> ScanResult:
        """Stream the slab, apply residual predicates, aggregate.

        Device-resident tables answer eligible queries (sum, count,
        select) with the fused locate+scan launch at Q = 1, so a scalar
        loop and ``execute_many`` compute per-query results identically;
        numpy is the reference engine and the path for host tables.
        View-eligible queries are served from the view, bit-identical to
        the fused launch."""
        if self._view_eligible(query):
            from .storage.views import serve_view_many

            return serve_view_many(self, [query])[0]
        if self._device_eligible(query):
            from ..kernels.ops import table_execute_device_many

            return table_execute_device_many(self, [query])[0]
        lo, hi = self.slab(query)
        return self._scan_slab(query, lo, hi)

    def execute_many(
        self, queries: Sequence[Query], *, trace=None, view_stats=None
    ) -> list[ScanResult]:
        """Batched ``execute``: on a table with a view, view-eligible
        queries (sum/count fully consumed by the slab walk) are answered
        from the stored per-block partials (``storage.views.
        serve_view_many``: O(blocks touched), bit-identical to the fused
        scan); on a device-resident table every other eligible query is
        served by one ``table_execute_device_many`` call (one fused
        launch, plus one compaction launch for selects with matches); host
        tables (and ineligible aggregations) locate slabs with one
        vectorized searchsorted and run the numpy residual scan. Result
        ``i`` equals ``execute(queries[i])`` either way.

        ``trace`` (an open span, or None) records view hits as
        ``view.serve``, the device launches as ``kernel.scan_launch`` /
        ``kernel.select_compact`` children and the numpy path as
        ``engine.host_scan``. ``view_stats`` (a dict, or None) receives
        the view's ``hits`` / ``boundary_rows`` tallies."""
        queries = list(queries)
        if not queries:
            return []
        results: list[ScanResult | None] = [None] * len(queries)
        view_idx = [i for i, q in enumerate(queries) if self._view_eligible(q)]
        if view_idx:
            from .storage.views import serve_view_many

            out = serve_view_many(
                self, [queries[i] for i in view_idx], trace=trace, view_stats=view_stats
            )
            for i, r in zip(view_idx, out):
                results[i] = r
        dev_idx = [
            i for i, q in enumerate(queries) if results[i] is None and self._device_eligible(q)
        ]
        if dev_idx:
            from ..kernels.ops import table_execute_device_many

            out = table_execute_device_many(
                self, [queries[i] for i in dev_idx], trace=trace
            )
            for i, r in zip(dev_idx, out):
                results[i] = r
        host_idx = [i for i in range(len(queries)) if results[i] is None]
        if host_idx:
            hs = (
                trace.child("engine.host_scan", queries=len(host_idx))
                if trace is not None
                else None
            )
            sub = [queries[i] for i in host_idx]
            slabs = self.slab_many(sub)
            for j, i in enumerate(host_idx):
                results[i] = self._scan_slab(sub[j], int(slabs[j, 0]), int(slabs[j, 1]))
            if hs is not None:
                hs.end()
        return results  # type: ignore[return-value]

    def _scan_slab(self, query: Query, lo: int, hi: int) -> ScanResult:
        n = hi - lo
        if n <= 0:
            return ScanResult(0.0, 0, 0, np.empty(0, np.int64) if query.agg == "select" else None)
        mask = np.ones(n, dtype=bool)
        for col in self.layout:
            lo_c, hi_c = query.filter_bounds(self.schema, col)
            v = self.key_cols[col][lo:hi]
            mask &= (v >= lo_c) & (v < hi_c)
        matched = int(mask.sum())
        if query.agg == "count":
            return ScanResult(float(matched), n, matched)
        if query.agg == "sum":
            if query.value_col is None:
                raise ValueError("sum aggregation requires value_col")
            vals = self.value_cols[query.value_col][lo:hi]
            return ScanResult(float(np.sum(vals * mask)), n, matched)
        if query.agg == "select":
            idx = np.nonzero(mask)[0] + lo
            return ScanResult(float(matched), n, matched, selected=idx)
        raise ValueError(f"unknown agg {query.agg!r}")
