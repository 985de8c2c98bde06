"""Append-only commit log — the layout-agnostic durability record.

One log per column family, shared by every replica: records hold the
written rows in *canonical column order* (the schema's key/value names),
never in any replica's layout, so a single record stream can rebuild any
heterogeneous serialization (replay → sort by that replica's layout).
Records carry monotonically increasing sequence numbers (LSNs); the
CREATE-time base dataset is record 0, so replaying from the beginning
reconstructs the full table, including writes a dead node missed.

Durability is modeled by the byte codec: ``to_bytes`` frames every
record as ``magic · lsn · payload length · crc32(payload) · payload``
and ``from_bytes`` replays frames until the first torn or corrupt one —
a crash mid-append loses at most the tail record, never a prefix
(classic commit-log semantics, property-tested in
``tests/test_properties.py``).

Memory: the log holds exactly one extra copy of the column family's
dataset. This system is append-only (no updates or deletes), so log
rows == current table rows — retention is O(current rows), the same
asymptote as any single replica, not O(operations). What *does* grow
with write count is the per-record framing overhead and replay's
concatenation fan-in; ``checkpoint`` collapses the history into one
snapshot record to bound both (``HREngine.checkpoint_commitlog`` is
the flush-then-checkpoint form), and the count-based trigger
(:meth:`CommitLog.should_checkpoint`, mirroring ``CompactionPolicy``'s
threshold rule) lets the engine fire it automatically after a flush
once more than ``k`` records accumulated since the last snapshot
(``HREngine(commitlog_checkpoint_records=k)``; 0 disables — the
manual method remains). Unlike Cassandra, flushed
records cannot simply be dropped: a node failure here wipes the node's
sstables too, so the log (or a surviving peer) is the only rebuild
source.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Iterator, Mapping, Sequence

import numpy as np

__all__ = ["CommitLog", "LogRecord"]

_MAGIC = 0x48524C47  # "HRLG"
_HEADER = struct.Struct("<IQQI")  # magic, lsn, payload_len, crc32(payload)


@dataclasses.dataclass(frozen=True)
class LogRecord:
    """One committed write batch: columns in canonical (schema) order."""

    lsn: int
    key_cols: dict[str, np.ndarray]
    value_cols: dict[str, np.ndarray]

    @property
    def n_rows(self) -> int:
        for v in self.key_cols.values():
            return int(v.shape[0])
        return 0


def _pack_cols(cols: Mapping[str, np.ndarray]) -> bytes:
    out = [struct.pack("<I", len(cols))]
    for name, arr in cols.items():
        a = np.ascontiguousarray(arr)
        nb = name.encode("utf-8")
        db = a.dtype.str.encode("ascii")
        out.append(struct.pack("<III", len(nb), len(db), a.shape[0]))
        out.append(nb)
        out.append(db)
        out.append(a.tobytes())
    return b"".join(out)


def _unpack_cols(buf: memoryview, off: int) -> tuple[dict[str, np.ndarray], int]:
    (n_cols,) = struct.unpack_from("<I", buf, off)
    off += 4
    cols: dict[str, np.ndarray] = {}
    for _ in range(n_cols):
        nlen, dlen, n = struct.unpack_from("<III", buf, off)
        off += 12
        name = bytes(buf[off : off + nlen]).decode("utf-8")
        off += nlen
        dtype = np.dtype(bytes(buf[off : off + dlen]).decode("ascii"))
        off += dlen
        nbytes = dtype.itemsize * n
        cols[name] = np.frombuffer(buf[off : off + nbytes], dtype=dtype).copy()
        off += nbytes
    return cols, off


class CommitLog:
    """In-order record log with LSNs, replay, truncation and a byte codec."""

    def __init__(
        self,
        key_names: Sequence[str] | None = None,
        value_names: Sequence[str] | None = None,
    ) -> None:
        self._records: list[LogRecord] = []
        self._next_lsn = 0
        self._key_names = tuple(key_names) if key_names is not None else None
        self._value_names = tuple(value_names) if value_names is not None else None
        # appends since the last checkpoint() — the auto-checkpoint
        # trigger's counter (reset by checkpoint, approximated by the
        # record count after truncate/from_bytes, where the true append
        # history is unknown)
        self._since_checkpoint = 0
        # LSN of the last snapshot record (None = never checkpointed).
        # A checkpoint collapses history into one fresh-LSN record, so
        # per-record replay from any cursor at or below it is impossible
        # — hinted-handoff watermarks must fall back to a full rebuild
        # (see can_replay_from).
        self._snapshot_lsn: int | None = None

    # -- append ------------------------------------------------------------

    def append(
        self, key_cols: Mapping[str, np.ndarray], value_cols: Mapping[str, np.ndarray]
    ) -> int:
        """Commit one write batch; returns its LSN. Columns are copied
        (the log must be immune to caller-side mutation) and stored in
        canonical order — the declared column names when the log was
        created, else the first record's order."""
        if self._key_names is None:
            self._key_names = tuple(key_cols)
            self._value_names = tuple(value_cols)
        missing = set(self._key_names) - set(key_cols)
        missing |= set(self._value_names or ()) - set(value_cols)
        if missing:
            raise KeyError(f"write batch missing columns {sorted(missing)}")
        kc = {c: np.array(key_cols[c], dtype=np.int64, copy=True) for c in self._key_names}
        vc = {c: np.array(value_cols[c], copy=True) for c in self._value_names or ()}
        n = {v.shape[0] for v in kc.values()} | {v.shape[0] for v in vc.values()}
        if len(n) > 1:
            raise ValueError(f"ragged write batch: column lengths {sorted(n)}")
        lsn = self._next_lsn
        self._next_lsn += 1
        self._records.append(LogRecord(lsn=lsn, key_cols=kc, value_cols=vc))
        self._since_checkpoint += 1
        return lsn

    # -- replay ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._records)

    @property
    def tail(self) -> LogRecord | None:
        """The most recent record (e.g. the one ``append`` just wrote).
        Its arrays are the log's own normalized copies — safe to stage
        by reference as long as the borrower never mutates them."""
        return self._records[-1] if self._records else None

    @property
    def n_rows(self) -> int:
        return sum(r.n_rows for r in self._records)

    @property
    def next_lsn(self) -> int:
        """The LSN the next ``append`` will take — the exclusive upper
        bound of the committed history. A replica flushed through every
        current record is complete up to (excluding) this LSN, which is
        exactly the hinted-handoff watermark the engine stores."""
        return self._next_lsn

    def can_replay_from(self, start_lsn: int) -> bool:
        """Can the per-record suffix ``lsn >= start_lsn`` alone bring a
        replica that is complete below ``start_lsn`` up to date? False
        once a checkpoint collapsed records at-or-after the watermark
        into a snapshot (the snapshot holds the *whole* dataset — the
        tail is no longer separable), in which case the caller must
        rebuild from a full replay instead."""
        return self._snapshot_lsn is None or start_lsn > self._snapshot_lsn

    @property
    def records_since_checkpoint(self) -> int:
        """Appends since the last :meth:`checkpoint` (what the
        count-based auto-checkpoint trigger measures — per-record
        framing and replay fan-in grow with this, not with rows)."""
        return self._since_checkpoint

    def should_checkpoint(self, max_records: int) -> bool:
        """Count-based trigger mirroring ``CompactionPolicy``: True when
        more than ``max_records`` records accumulated since the last
        snapshot. ``max_records <= 0`` disables. The caller remains
        responsible for the safety condition (every replica flushed
        through the tail — ``HREngine`` checks its partition's
        memtables are drained before firing)."""
        return max_records > 0 and self._since_checkpoint > max_records

    def replay(self, start_lsn: int = 0) -> Iterator[LogRecord]:
        """Records with ``lsn >= start_lsn`` in commit order."""
        for rec in self._records:
            if rec.lsn >= start_lsn:
                yield rec

    def replay_columns(
        self, end_lsn: int | None = None, *, start_lsn: int = 0
    ) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
        """All rows of records with ``start_lsn <= lsn < end_lsn``
        (default: all), concatenated in commit order — the input any
        replica rebuild sorts into its own layout. A nonzero
        ``start_lsn`` is the hinted-handoff tail replay: only valid when
        :meth:`can_replay_from` holds for it."""
        recs = [
            r
            for r in self._records
            if r.lsn >= start_lsn and (end_lsn is None or r.lsn < end_lsn)
        ]
        if not recs:
            kn, vn = self._key_names or (), self._value_names or ()
            return (
                {c: np.empty(0, np.int64) for c in kn},
                {c: np.empty(0, np.float64) for c in vn},
            )
        kc = {
            c: np.concatenate([r.key_cols[c] for r in recs])
            for c in recs[0].key_cols
        }
        vc = {
            c: np.concatenate([r.value_cols[c] for r in recs])
            for c in recs[0].value_cols
        }
        return kc, vc

    def truncate(self, n_records: int) -> None:
        """Keep only the first ``n_records`` records (crash simulation:
        everything after the truncation point is lost)."""
        if n_records < 0:
            raise ValueError("n_records must be >= 0")
        self._records = self._records[:n_records]
        self._next_lsn = self._records[-1].lsn + 1 if self._records else 0
        self._since_checkpoint = min(self._since_checkpoint, len(self._records))

    def checkpoint(self) -> int:
        """Collapse the whole record history into one snapshot record
        holding the concatenated rows (Cassandra's "the sstables ARE
        the checkpoint", applied to this in-memory log): replaying the
        checkpointed log rebuilds exactly the same dataset, but memory
        and future replay cost become O(current rows) instead of
        O(total rows ever written). LSNs keep counting — the snapshot
        takes a fresh LSN, so ``replay(start_lsn)`` with an old cursor
        never silently skips rows. Returns the snapshot's LSN.

        Call it only when every replica has flushed through the log's
        tail (``HREngine.checkpoint_commitlog`` enforces that): the
        per-record structure is what lets a *partially applied* suffix
        be replayed record-by-record."""
        kc, vc = self.replay_columns()
        lsn = self._next_lsn
        self._next_lsn += 1
        self._records = [LogRecord(lsn=lsn, key_cols=kc, value_cols=vc)]
        self._since_checkpoint = 0
        self._snapshot_lsn = lsn  # tail-only replay below here is gone
        return lsn

    # -- migration surgery (vnode split/merge lineage) ---------------------

    def sliced(self, row_mask) -> "CommitLog":
        """Token-slice the record stream: a new log holding, per record
        and in the same commit order, only the rows where
        ``row_mask(record.key_cols)`` is True.

        This is the migration half of partition split: the child
        partition's log is a row-filtered *view of the same history*,
        re-LSN'd contiguously from 0. Record 0 is always kept (possibly
        empty) so the CREATE-base invariant holds; later records that
        filter to zero rows are dropped — they carry no lineage.
        """
        out = CommitLog(self._key_names, self._value_names)
        for i, rec in enumerate(self._records):
            if rec.n_rows:
                m = np.asarray(row_mask(rec.key_cols), dtype=bool)
                kc = {c: v[m] for c, v in rec.key_cols.items()}
                vc = {c: v[m] for c, v in rec.value_cols.items()}
            else:
                kc = {c: v.copy() for c, v in rec.key_cols.items()}
                vc = {c: v.copy() for c, v in rec.value_cols.items()}
            if i > 0 and next(iter(kc.values()), np.empty(0)).shape[0] == 0:
                continue
            out._records.append(
                LogRecord(lsn=out._next_lsn, key_cols=kc, value_cols=vc)
            )
            out._next_lsn += 1
        out._since_checkpoint = len(out._records)
        return out

    @classmethod
    def concatenated(cls, logs: Sequence["CommitLog"]) -> "CommitLog":
        """Concatenate record streams (the merge half of partition
        merge): records of ``logs[0]`` in order, then ``logs[1]``, …,
        with fresh contiguous LSNs. Pass the logs in ring order so the
        merged partition's record 0 is the leftmost CREATE base. Empty
        non-base records are dropped; the first log's record 0 is kept
        even when empty.

        Replaying the result concatenates exactly the per-log replays
        in ring order — and because equal packed keys cannot straddle a
        partition boundary, every replica's stable re-sort of that
        replay is bit-identical to re-sorting the union (tie runs stay
        whole, in their original commit order).
        """
        if not logs:
            raise ValueError("need at least one log to concatenate")
        out = cls(logs[0]._key_names, logs[0]._value_names)
        for j, log in enumerate(logs):
            for i, rec in enumerate(log._records):
                if rec.n_rows == 0 and not (j == 0 and i == 0):
                    continue
                out._records.append(
                    LogRecord(
                        lsn=out._next_lsn,
                        key_cols=rec.key_cols,
                        value_cols=rec.value_cols,
                    )
                )
                out._next_lsn += 1
        out._since_checkpoint = len(out._records)
        return out

    # -- byte codec --------------------------------------------------------

    def to_bytes(self) -> bytes:
        """Framed serialization: per record ``magic · lsn · len ·
        crc32 · payload``."""
        frames = []
        for rec in self._records:
            payload = _pack_cols(rec.key_cols) + _pack_cols(rec.value_cols)
            frames.append(
                _HEADER.pack(_MAGIC, rec.lsn, len(payload), zlib.crc32(payload))
            )
            frames.append(payload)
        return b"".join(frames)

    @classmethod
    def from_bytes(cls, data: bytes) -> "CommitLog":
        """Replay frames until the first torn (incomplete) or corrupt
        (bad magic / crc mismatch) one: a crash mid-append drops the
        tail record and every complete earlier record survives."""
        log = cls()
        buf = memoryview(data)
        off = 0
        while off + _HEADER.size <= len(buf):
            magic, lsn, plen, crc = _HEADER.unpack_from(buf, off)
            if magic != _MAGIC or off + _HEADER.size + plen > len(buf):
                break  # corrupt header or torn payload: stop at the prefix
            payload = buf[off + _HEADER.size : off + _HEADER.size + plen]
            if zlib.crc32(payload) != crc:
                break
            kc, p_off = _unpack_cols(payload, 0)
            vc, _ = _unpack_cols(payload, p_off)
            if log._key_names is None:
                log._key_names = tuple(kc)
                log._value_names = tuple(vc)
            log._records.append(LogRecord(lsn=lsn, key_cols=kc, value_cols=vc))
            log._next_lsn = lsn + 1
            off += _HEADER.size + plen
        log._since_checkpoint = len(log._records)
        # conservative snapshot marker: a first record with lsn > 0 can
        # only come from a checkpoint collapse (appends start at 0), so
        # hint watermarks at or below it must fall back to full rebuild
        if log._records and log._records[0].lsn > 0:
            log._snapshot_lsn = log._records[0].lsn
        return log
