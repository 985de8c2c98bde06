"""Token ring — the single-partition subset the port serves so far.

A row's *token* is its composite key packed in canonical order
(``key_names`` as declared at CREATE); the ring splits the token space
into contiguous ranges, each owned by a :class:`Partition` holding a full
heterogeneous replica set, its commit log, memtables and compaction
policy. This slice builds only the ``P = 1`` ring (one partition owning
the whole space): skew-aware boundaries, the token histogram and vnode
migration belong to ROADMAP Queue 1 items 3 and 4.

Placement onto nodes is the deterministic crc32 scheme of
:func:`place_replica`, with global replica ids ``partition_id * RF +
slot`` — so replicas land on the same nodes as in the reference engine.
"""

from __future__ import annotations

import dataclasses
import itertools
import zlib
from typing import TYPE_CHECKING, Sequence

from .keys import KeySchema

if TYPE_CHECKING:  # imported for annotations only; storage never imports us
    from .storage import CommitLog, CompactionPolicy, Memtable

__all__ = [
    "TokenRing",
    "Partition",
    "ReplicaHandle",
    "place_replica",
]


def place_replica(cf_name: str, replica_id: int, n_nodes: int) -> int:
    """Deterministic replica placement ``hash(cf, replica) → node``.

    crc32, not the builtin ``hash`` (salted per process), so placement
    is a pure function of the name and cluster size. Successive replica
    ids land on distinct nodes when possible.
    """
    h = zlib.crc32(cf_name.encode("utf-8")) % n_nodes
    return (h + replica_id) % n_nodes


@dataclasses.dataclass
class ReplicaHandle:
    """One replica of one partition: a heterogeneous serialization of
    that partition's row slice, hosted on ``node_id``. ``replica_id``
    is global across the column family (``partition_id * RF + slot``)."""

    replica_id: int
    layout: tuple[str, ...]
    node_id: int
    partition_id: int = 0


@dataclasses.dataclass(frozen=True)
class TokenRing:
    """Order-preserving token ring over the canonical packed key space.

    ``starts[p]`` is the first token partition ``p`` owns; partition
    ``p`` owns ``[starts[p], starts[p+1])`` (the last runs to
    ``2**total_bits``)."""

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

    @property
    def n_partitions(self) -> int:
        return len(self.starts)

    def token_range(self, partition_id: int) -> tuple[int, int]:
        """Inclusive ``[lo, hi]`` token range owned by a partition."""
        lo = self.starts[partition_id]
        if partition_id + 1 < len(self.starts):
            return lo, self.starts[partition_id + 1] - 1
        return lo, (1 << self.total_bits) - 1


@dataclasses.dataclass
class Partition:
    """One token range's full storage state: the heterogeneous replica
    set over its row slice, the slice's own commit log (record 0 = the
    CREATE-time rows), per-replica memtables, the compaction policy
    bounding its device run stacks, and the round-robin tie-break
    counter for its replica set."""

    partition_id: int
    token_lo: int
    token_hi: int
    replicas: list[ReplicaHandle]
    commitlog: "CommitLog | None" = None
    memtables: "dict[int, Memtable]" = dataclasses.field(default_factory=dict)
    compaction: "CompactionPolicy | None" = None
    rr_counter: "itertools.count" = dataclasses.field(default_factory=itertools.count)
    #: Stable virtual-node identity; global replica ids are
    #: ``vnode_id * RF + slot``.
    vnode_id: int = 0
