"""Per-replica memtable: the staging half of the LSM write path.

Each replica owns one memtable. Writes land as column batches in arrival
order (cheap appends — no sort on the write path); ``flush`` concatenates
the staged batches, sorts them **once** by the replica's own layout and
emits an immutable :class:`SortedRun` ready for
``SortedTable.merge_run``. Group commit therefore falls out of the
staging itself: ``g`` writes of ``b`` rows flush as one sort + one merge
of ``g × b`` rows instead of ``g`` separate merges.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Mapping, Sequence

import numpy as np

from ..keys import KeySchema, pack_columns

__all__ = [
    "Memtable",
    "SortedRun",
    "combine_digests",
    "content_digest",
    "run_crc32",
    "sort_run",
]


def run_crc32(
    packed: np.ndarray,
    key_cols: Mapping[str, np.ndarray],
    value_cols: Mapping[str, np.ndarray],
) -> int:
    """crc32 over a run's column arrays: the packed keys, then each
    key/value column in name-sorted order. Buffer-integrity seal for
    ``SortedRun.crc`` — the flush path verifies it before merging a
    run, catching a run corrupted between sort and merge. (Tables use
    :func:`content_digest` instead: it is order-independent, so flushes
    can maintain it incrementally.)"""
    crc = zlib.crc32(np.ascontiguousarray(packed))
    for name in sorted(key_cols):
        crc = zlib.crc32(np.ascontiguousarray(key_cols[name]), crc)
    for name in sorted(value_cols):
        crc = zlib.crc32(np.ascontiguousarray(value_cols[name]), crc)
    return crc


_U64 = np.uint64
_DIGEST_MASK = 0xFFFFFFFFFFFFFFFF


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized (uint64 wraparound is the mod)."""
    x = x.copy()
    x ^= x >> _U64(30)
    x *= _U64(0xBF58476D1CE4E5B9)
    x ^= x >> _U64(27)
    x *= _U64(0x94D049BB133111EB)
    x ^= x >> _U64(31)
    return x


def _bits64(arr: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(arr)
    if a.dtype.kind == "f":
        a = np.ascontiguousarray(a.astype(np.float64, copy=False))
    elif a.dtype.kind in "iu":
        a = np.ascontiguousarray(a.astype(np.int64, copy=False))
    else:
        raise TypeError(f"content_digest: unhashable column dtype {a.dtype}")
    return a.view(_U64)


def content_digest(
    key_cols: Mapping[str, np.ndarray],
    value_cols: Mapping[str, np.ndarray],
) -> int:
    """Order- and layout-independent digest of a row multiset: each row
    hashes to a 64-bit value — ``mix(Σ_c mix(bits_c ^ salt_c))``, the
    inner mix per column salted by column name so equal values in
    different columns differ, the outer mix binding the columns of a
    row together — and the digest is the sum of row hashes mod 2⁶⁴.
    Columns are stacked into one (rows × cols) uint64 matrix first, so
    the numpy op count is constant in the column count (this runs on
    every flush).

    The sum form is the point: ``digest(A ∪ B) = combine_digests(
    digest(A), digest(B))``, so a flush extends a table's sealed digest
    with just the run's digest (O(run), not O(table)), compaction
    carries it unchanged, and every replica of a partition — each
    sorted its own way — agrees on the value. Crucially the sealed
    digest is therefore derived from the *durable history* (CREATE seal
    + run digests), never recomputed from table memory: an in-place bit
    flip can't be laundered into a fresh seal by a later flush, and
    scrub catches it whenever it looks."""
    named = [
        (f"{group}:{name}", cols[name])
        for group, cols in (("k", key_cols), ("v", value_cols))
        for name in sorted(cols)
    ]
    if not named:
        return 0
    mat = np.stack([_bits64(arr) for _, arr in named], axis=1)
    salts = np.array(
        [zlib.crc32(tag.encode()) + 0x9E3779B9 for tag, _ in named], dtype=_U64
    )
    rows = _mix64(_mix64(mat ^ salts).sum(axis=1, dtype=_U64))
    return int(rows.sum(dtype=_U64))


def combine_digests(a: int, b: int) -> int:
    """Digest of the union of two row multisets (Σ row-hash mod 2⁶⁴)."""
    return (a + b) & _DIGEST_MASK


@dataclasses.dataclass(frozen=True)
class SortedRun:
    """An immutable flushed run: columns sorted by ``layout``, with the
    packed composite key alongside (ascending) and a crc32 over all of
    it (``crc``) sealed at sort time — the flush path verifies it
    before merging, so a run corrupted between sort and merge is caught
    instead of poisoning the table. ``digest`` is the run's multiset
    :func:`content_digest`, what the flush adds to the merged table's
    sealed digest."""

    layout: tuple[str, ...]
    key_cols: dict[str, np.ndarray]
    value_cols: dict[str, np.ndarray]
    packed: np.ndarray
    crc: int = 0
    digest: int = 0

    def __len__(self) -> int:
        return int(self.packed.shape[0])

    def verify(self) -> bool:
        """Recompute the content crc32 and compare to the sealed one."""
        return run_crc32(self.packed, self.key_cols, self.value_cols) == self.crc


def sort_run(
    key_cols: Mapping[str, np.ndarray],
    value_cols: Mapping[str, np.ndarray],
    layout: Sequence[str],
    schema: KeySchema,
) -> SortedRun:
    """Sort one batch into a run in ``layout`` order (stable, so rows
    with equal keys keep arrival order — the tie rule every merge layer
    preserves)."""
    layout = tuple(layout)
    packed = pack_columns(key_cols, layout, schema)
    order = np.argsort(packed, kind="stable")
    kc = {c: np.asarray(v)[order].astype(np.int64) for c, v in key_cols.items()}
    vc = {c: np.asarray(v)[order] for c, v in value_cols.items()}
    sorted_packed = packed[order]
    return SortedRun(
        layout=layout,
        key_cols=kc,
        value_cols=vc,
        packed=sorted_packed,
        crc=run_crc32(sorted_packed, kc, vc),
        digest=content_digest(kc, vc),
    )


class Memtable:
    """Sorted staging buffer for one replica (sorted at flush time)."""

    def __init__(
        self,
        layout: Sequence[str],
        schema: KeySchema,
        key_names: Sequence[str],
        value_names: Sequence[str],
    ) -> None:
        self.layout = tuple(layout)
        self.schema = schema
        self.key_names = tuple(key_names)
        self.value_names = tuple(value_names)
        self._key_bufs: list[dict[str, np.ndarray]] = []
        self._value_bufs: list[dict[str, np.ndarray]] = []
        self._n_staged = 0

    def __len__(self) -> int:
        return self._n_staged

    @property
    def n_staged(self) -> int:
        return self._n_staged

    def stage(
        self,
        key_cols: Mapping[str, np.ndarray],
        value_cols: Mapping[str, np.ndarray],
        *,
        copy: bool = True,
    ) -> None:
        """Absorb one write batch (arrival order, no sort). ``copy=False``
        borrows the caller's arrays instead of copying — the engine
        stages each commit-log record's already-copied columns into all
        RF memtables this way, avoiding RF redundant memcpys per write
        (the memtable never mutates staged arrays, so sharing is safe)."""
        if copy:
            kc = {
                c: np.array(key_cols[c], dtype=np.int64, copy=True)
                for c in self.key_names
            }
            vc = {c: np.array(value_cols[c], copy=True) for c in self.value_names}
        else:
            kc = {c: key_cols[c] for c in self.key_names}
            vc = {c: value_cols[c] for c in self.value_names}
        n = next(iter(kc.values())).shape[0] if kc else 0
        if n == 0:
            return
        self._key_bufs.append(kc)
        self._value_bufs.append(vc)
        self._n_staged += n

    def peek_run(self) -> SortedRun | None:
        """Sort the staged batches into one :class:`SortedRun` in this
        replica's layout (one concatenate + one stable sort for the
        whole group) WITHOUT draining them — the engine merges the run
        and calls :meth:`clear` only once the merged table is installed,
        so a failed merge never loses committed rows. ``None`` when
        nothing is staged."""
        if self._n_staged == 0:
            return None
        if len(self._key_bufs) == 1:
            kc, vc = self._key_bufs[0], self._value_bufs[0]
        else:
            kc = {
                c: np.concatenate([b[c] for b in self._key_bufs])
                for c in self.key_names
            }
            vc = {
                c: np.concatenate([b[c] for b in self._value_bufs])
                for c in self.value_names
            }
        return sort_run(kc, vc, self.layout, self.schema)

    def flush(self) -> SortedRun | None:
        """:meth:`peek_run` + :meth:`clear` in one step, for callers
        that consume the run unconditionally."""
        run = self.peek_run()
        self.clear()
        return run

    def clear(self) -> None:
        """Drop staged rows (node failure: the memtable dies with the
        node; the commit log is the durable copy)."""
        self._key_bufs = []
        self._value_bufs = []
        self._n_staged = 0
