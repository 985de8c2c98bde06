"""Token-ring partitioning: Cassandra's ring, order-preserving form.

A row's *token* is its composite key packed in canonical order
(``key_names`` as declared at CREATE, never a replica layout). Packing is
order-preserving (``keys.pack_columns``), so token ranges are key ranges
(Cassandra's ByteOrderedPartitioner): a query's slab bounds intersect the
ring by host arithmetic (:meth:`TokenRing.span_partitions`). The ring
splits ``[0, 2**total_bits)`` into ``P`` contiguous ranges, equal in key
space (:meth:`TokenRing.build`) or at quantiles of observed tokens
(:meth:`TokenRing.from_tokens`, :meth:`TokenRing.from_histogram`). Each
:class:`Partition` owns a full heterogeneous replica set of its rows, its
own commit log, memtables, compaction policy, round-robin counter and
``TableStats``; the engine ranks a partition's replicas with that
partition's own selectivities.

:class:`TokenHistogram` is a fixed-width histogram over ``token >> shift``
(at most 4096 bins). On a device-resident column family the engine feeds
it every CREATE and write token through the ``ecdf_hist`` kernel
(``kernels.ecdf_hist_many``, one int32 row, bin width 1); it detects skew
drift (:meth:`TokenHistogram.imbalance`) and proposes boundaries
(:meth:`TokenHistogram.quantile_starts`).

Placement onto nodes is the deterministic crc32 scheme of
:func:`place_replica`, with global replica ids ``vnode_id * RF + slot``,
so partition 0 of a ``P = 1`` column family places exactly where the
unpartitioned engine does, and every replica lands on the node the
reference engine (``repro.core.ring``) puts it on. ``Partition.flushed_lsn``
and ``Partition.hints`` carry the engine's hinted handoff. The engine's
migration (split, merge, rebalance) builds its new rings with
:meth:`TokenRing.with_starts`, :meth:`TokenRing.from_tokens` and
:meth:`TokenRing.from_histogram`, and gives every fresh partition a
``vnode_id`` never used before.
"""

from __future__ import annotations

import dataclasses
import itertools
import zlib
from typing import TYPE_CHECKING, Mapping, Sequence

import numpy as np

from .ecdf import TableStats, device_counts
from .keys import KeySchema, pack_columns

if TYPE_CHECKING:  # imported for annotations only; storage never imports us
    from .storage import CommitLog, CompactionPolicy, Memtable

__all__ = [
    "TokenHistogram",
    "TokenRing",
    "Partition",
    "ReplicaHandle",
    "place_replica",
]

#: Histogram width cap — matches the ``ecdf_hist`` kernel's bin limit.
_HIST_MAX_BINS_LOG2 = 12


@dataclasses.dataclass
class TokenHistogram:
    """Fixed-width histogram over the canonical token space.

    Bin of a token is ``token >> shift`` — a pure shift so the mapping
    is monotone and the device path stays integer-exact: shifted tokens
    fit int32 (≤ ``2**_HIST_MAX_BINS_LOG2`` bins) and the kernel returns
    its counts as float32, exact below 2**24 per call. Used for cheap
    skew-drift detection (:meth:`imbalance`) and for coarse quantile
    boundary proposals (:meth:`quantile_starts`, consumed by
    :meth:`TokenRing.from_histogram`).
    """

    total_bits: int
    shift: int
    counts: np.ndarray  # float64[n_bins]

    @classmethod
    def build(cls, total_bits: int) -> "TokenHistogram":
        bins_log2 = min(int(total_bits), _HIST_MAX_BINS_LOG2)
        return cls(
            total_bits=int(total_bits),
            shift=int(total_bits) - bins_log2,
            counts=np.zeros(1 << bins_log2, dtype=np.float64),
        )

    @property
    def n_bins(self) -> int:
        return self.counts.size

    @property
    def total(self) -> float:
        return float(self.counts.sum())

    def add_tokens(self, tokens: np.ndarray, *, device=None) -> None:
        """Accumulate a token batch. With ``device`` (a torch device) the
        bin counts come from the ``ecdf_hist`` kernel on that device, for
        batches below 2**24 tokens (the reference's float32 exactness
        guard, kept so both engines take the same branch); otherwise, and
        with ``device=None``, from a host ``np.bincount``."""
        tokens = np.asarray(tokens, dtype=np.int64)
        if tokens.size == 0:
            return
        bins = tokens >> self.shift
        if device is not None and tokens.size < (1 << 24):
            add = device_counts([bins], [self.n_bins], [1], device)[0]
        else:
            add = np.bincount(bins, minlength=self.n_bins).astype(np.float64)
        self.counts += add

    def partition_masses(self, starts: Sequence[int]) -> np.ndarray:
        """Approximate row mass per partition under ``starts`` — bin
        counts split by linear interpolation where a boundary lands
        inside a bin."""
        cum = np.concatenate([[0.0], np.cumsum(self.counts)])
        edges = np.asarray(starts, dtype=np.int64)  # all < 2**total_bits, fit int64
        bin_of = edges >> self.shift
        rem = (edges - (bin_of << self.shift)).astype(np.float64)
        frac = rem / float(1 << self.shift)
        mass_at = cum[bin_of] + frac * self.counts[bin_of]
        return np.diff(np.append(mass_at, cum[-1]))

    def imbalance(self, starts: Sequence[int]) -> float:
        """Max/mean partition row mass under ``starts`` (1.0 = perfectly
        balanced; the reference engine's rebalance drift signal)."""
        masses = self.partition_masses(starts)
        total = masses.sum()
        if total <= 0 or masses.size == 0:
            return 1.0
        return float(masses.max() / (total / masses.size))

    def quantile_starts(self, n_partitions: int) -> tuple[int, ...]:
        """Boundary proposal: ``n_partitions`` start tokens placing the
        interior boundaries at histogram quantiles (linear interpolation
        within a bin). Falls back to equal splits on an empty histogram."""
        space = 1 << self.total_bits
        if not 1 <= n_partitions <= space:
            raise ValueError(f"partitions must be in [1, {space}], got {n_partitions}")
        total = self.counts.sum()
        if total <= 0:
            return tuple((space * p) // n_partitions for p in range(n_partitions))
        cum = np.concatenate([[0.0], np.cumsum(self.counts)])
        starts = [0]
        for p in range(1, n_partitions):
            target = total * p / n_partitions
            b = int(np.searchsorted(cum, target, side="right")) - 1
            b = min(max(b, 0), self.n_bins - 1)
            in_bin = self.counts[b]
            frac = (target - cum[b]) / in_bin if in_bin > 0 else 0.0
            starts.append((b << self.shift) + int(frac * (1 << self.shift)))
        return _monotone_starts(starts, space)


def _monotone_starts(starts: Sequence[int], space: int) -> tuple[int, ...]:
    """Force a boundary proposal strictly increasing inside the token
    space (duplicate quantiles — e.g. one token value holding more than
    1/P of the mass — are bumped right; the resulting empty partitions
    are valid ring members)."""
    out: list[int] = []
    prev = -1
    for s in starts:
        s = max(int(s), prev + 1)
        if s >= space:
            raise ValueError(f"cannot fit {len(starts)} distinct boundaries in [0, {space})")
        out.append(s)
        prev = s
    return tuple(out)


def place_replica(cf_name: str, replica_id: int, n_nodes: int) -> int:
    """Deterministic replica placement ``hash(cf, replica) → node``.

    crc32, not the builtin ``hash`` (salted per process), so placement
    is a pure function of the name and cluster size. Successive replica
    ids land on distinct nodes when possible; with global replica ids
    (``partition_id * RF + slot``) successive *partitions* stagger
    around the ring too. ``HREngine._place`` delegates here, so ring
    placement and engine placement can never drift apart.
    """
    h = zlib.crc32(cf_name.encode("utf-8")) % n_nodes
    return (h + replica_id) % n_nodes


@dataclasses.dataclass
class ReplicaHandle:
    """One replica of one partition: a heterogeneous serialization of
    that partition's row slice, hosted on ``node_id``. ``replica_id``
    is global across the column family (``partition_id * RF + slot``)
    — node table keys and result-cache keys stay flat."""

    replica_id: int
    layout: tuple[str, ...]
    node_id: int
    partition_id: int = 0


@dataclasses.dataclass(frozen=True)
class TokenRing:
    """Order-preserving token ring over the canonical packed key space.

    ``starts[p]`` is the first token partition ``p`` owns; partition
    ``p`` owns ``[starts[p], starts[p+1])`` (the last runs to
    ``2**total_bits``). Start tokens are built once at CREATE and are
    immutable — routing must be a pure function or replicas disagree
    about row ownership.
    """

    key_names: tuple[str, ...]
    total_bits: int
    starts: tuple[int, ...]

    @classmethod
    def build(
        cls, schema: KeySchema, key_names: Sequence[str], n_partitions: int = 1
    ) -> "TokenRing":
        """Split the canonical packed key space into ``n_partitions``
        near-equal contiguous token ranges."""
        key_names = tuple(key_names)
        schema.check_layout(key_names)
        total_bits = schema.total_bits(key_names)
        space = 1 << total_bits
        if not 1 <= n_partitions <= space:
            raise ValueError(
                f"partitions must be in [1, {space}] for a {total_bits}-bit "
                f"key space, got {n_partitions}"
            )
        starts = tuple((space * p) // n_partitions for p in range(n_partitions))
        return cls(key_names=key_names, total_bits=total_bits, starts=starts)

    @classmethod
    def from_tokens(
        cls,
        schema: KeySchema,
        key_names: Sequence[str],
        tokens: np.ndarray,
        n_partitions: int,
    ) -> "TokenRing":
        """Skew-aware ring: interior boundaries at exact quantiles of an
        observed token stream, so each partition owns ~``1/P`` of the
        *rows* rather than of the key space.

        A boundary cannot cut inside a run of equal tokens (equal token
        ⇒ same partition), so at each ideal cut the run containing the
        quantile token is rounded to whichever side leaves the realized
        cut closer to the ideal one — the residual imbalance is bounded
        by half the largest duplicate-token run. Falls back to equal
        splits when no tokens were observed.
        """
        key_names = tuple(key_names)
        schema.check_layout(key_names)
        toks = np.sort(np.asarray(tokens, dtype=np.int64))
        if toks.size == 0:
            return cls.build(schema, key_names, n_partitions)
        total_bits = schema.total_bits(key_names)
        space = 1 << total_bits
        if not 1 <= n_partitions <= space:
            raise ValueError(
                f"partitions must be in [1, {space}] for a {total_bits}-bit "
                f"key space, got {n_partitions}"
            )
        n = toks.size
        starts = [0]
        for p in range(1, n_partitions):
            cut = (n * p) // n_partitions
            t = int(toks[min(cut, n - 1)])
            left = int(np.searchsorted(toks, t, side="left"))
            right = int(np.searchsorted(toks, t, side="right"))
            # boundary = t puts the duplicate run of t on the right
            # (realized cut at ``left``); boundary = t + 1 puts it on
            # the left (realized cut at ``right``).
            if abs(left - cut) <= abs(right - cut) or t + 1 >= space:
                starts.append(t)
            else:
                starts.append(t + 1)
        return cls(
            key_names=key_names,
            total_bits=total_bits,
            starts=_monotone_starts(starts, space),
        )

    @classmethod
    def from_histogram(
        cls,
        schema: KeySchema,
        key_names: Sequence[str],
        hist: TokenHistogram,
        n_partitions: int,
    ) -> "TokenRing":
        """Skew-aware ring from a :class:`TokenHistogram` boundary
        proposal — the cheap device-friendly variant of
        :meth:`from_tokens` (resolution = one histogram bin)."""
        key_names = tuple(key_names)
        schema.check_layout(key_names)
        total_bits = schema.total_bits(key_names)
        if hist.total_bits != total_bits:
            raise ValueError(
                f"histogram covers a {hist.total_bits}-bit space, ring needs {total_bits}"
            )
        return cls(
            key_names=key_names,
            total_bits=total_bits,
            starts=hist.quantile_starts(n_partitions),
        )

    def with_starts(self, starts: Sequence[int]) -> "TokenRing":
        """Same key space, new boundaries (a migration's new ring).
        Validates ``starts`` is a well-formed ring."""
        space = 1 << self.total_bits
        starts = tuple(int(s) for s in starts)
        if not starts or starts[0] != 0:
            raise ValueError("ring starts must begin at token 0")
        if any(b <= a for a, b in zip(starts, starts[1:])) or starts[-1] >= space:
            raise ValueError("ring starts must be strictly increasing inside the token space")
        return TokenRing(key_names=self.key_names, total_bits=self.total_bits, starts=starts)

    @property
    def n_partitions(self) -> int:
        return len(self.starts)

    def token_range(self, partition_id: int) -> tuple[int, int]:
        """Inclusive ``[lo, hi]`` token range owned by a partition."""
        lo = self.starts[partition_id]
        if partition_id + 1 < len(self.starts):
            return lo, self.starts[partition_id + 1] - 1
        return lo, (1 << self.total_bits) - 1

    def tokens(
        self, key_cols: Mapping[str, np.ndarray], schema: KeySchema
    ) -> np.ndarray:
        """Row tokens: the composite keys packed in canonical order."""
        return pack_columns(key_cols, self.key_names, schema)

    def partition_of_tokens(self, tokens: np.ndarray) -> np.ndarray:
        """Owning partition id per token (vectorized)."""
        starts = np.asarray(self.starts, dtype=np.int64)
        return np.searchsorted(starts, tokens, side="right") - 1

    def span_partitions(self, bounds: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Partition id span ``[p_lo, p_hi]`` (inclusive) per query from
        canonical packed slab bounds ``int64[Q, 2]`` (inclusive ``hi``,
        the ``slab_bounds_many(queries, key_names, schema)`` output).

        Every row matching a query satisfies the query's componentwise
        filter bounds, so its canonical token lies inside the slab — a
        partition outside the span cannot hold a matching row, and the
        partitions inside it apply the full residual filters themselves
        (visiting an over-approximated partition is harmless). A query
        with a degenerate (empty) slab (``hi < lo``) is clamped to its
        home partition so it still executes (and returns zero rows)
        somewhere — mirroring the scalar empty-slab behavior.
        """
        starts = np.asarray(self.starts, dtype=np.int64)
        p_lo = np.searchsorted(starts, bounds[:, 0], side="right") - 1
        p_hi = np.searchsorted(starts, bounds[:, 1], side="right") - 1
        return p_lo, np.maximum(p_hi, p_lo)


@dataclasses.dataclass
class Partition:
    """One token range's full storage state: the heterogeneous replica
    set over its row slice, the slice's own commit log (record 0 = the
    CREATE-time rows this partition owns), per-replica memtables, the
    compaction policy bounding its device run stacks, and the
    round-robin tie-break counter for its replica set (each partition
    load-balances independently)."""

    partition_id: int
    token_lo: int
    token_hi: int
    replicas: list[ReplicaHandle]
    commitlog: "CommitLog | None" = None
    memtables: "dict[int, Memtable]" = dataclasses.field(default_factory=dict)
    compaction: "CompactionPolicy | None" = None
    rr_counter: "itertools.count" = dataclasses.field(default_factory=itertools.count)
    #: Stable virtual-node identity — assigned at birth, never reused,
    #: survives ring renumbering. Global replica ids are
    #: ``vnode_id * RF + slot``.
    vnode_id: int = 0
    #: Selectivity stats over exactly this partition's rows (None for
    #: single-partition CFs, which plan with the CF-global stats).
    stats: "TableStats | None" = None
    #: Observed committed-token extrema (None until the first row) —
    #: the scatter path's empty-range skip test. Monotone under the
    #: append-only write path, so never stale: a query slab disjoint
    #: from ``[token_min, token_max]`` cannot match any committed *or*
    #: staged row (staged rows are in the log too).
    token_min: "int | None" = None
    token_max: "int | None" = None
    #: Hinted handoff (per replica id): ``flushed_lsn[rid]`` is the
    #: exclusive log LSN through which the replica's *table* is
    #: complete (maintained by the engine at CREATE/flush/recovery),
    #: and ``hints[rid]`` — present only while the replica's node is
    #: transiently down — freezes that watermark at failure time. A
    #: hint is an LSN range against the partition's own commit log, not
    #: a data copy: node-up replays just ``[hints[rid], next_lsn)`` and
    #: merges it into the surviving table instead of rebuilding from
    #: record 0.
    flushed_lsn: "dict[int, int]" = dataclasses.field(default_factory=dict)
    hints: "dict[int, int]" = dataclasses.field(default_factory=dict)

    @property
    def n_rows_committed(self) -> int:
        """Rows this partition owns per its durable log (base + every
        committed write) — equal to any fully-flushed live replica's
        table length, and independent of staging state, which is what
        the cross-partition select offsets are built from."""
        return self.commitlog.n_rows if self.commitlog is not None else 0

    def observe_tokens(self, tokens: np.ndarray) -> None:
        """Fold a committed token batch into the token extrema."""
        if tokens.size == 0:
            return
        lo = int(tokens.min())
        hi = int(tokens.max())
        self.token_min = lo if self.token_min is None else min(self.token_min, lo)
        self.token_max = hi if self.token_max is None else max(self.token_max, hi)

    def may_contain(self, slab_lo: int, slab_hi: int) -> bool:
        """Can any committed/staged row's canonical token fall in the
        inclusive slab ``[slab_lo, slab_hi]``? False ⇒ the partition is
        guaranteed to contribute zero matching rows (the scatter path
        skips the launch and the cache probe entirely)."""
        if self.token_min is None:
            return False
        return not (slab_hi < self.token_min or slab_lo > self.token_max)
