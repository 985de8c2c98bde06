"""Composite clustering keys.

A replica's on-disk order is lexicographic over a *permutation* of the
clustering key columns (the paper's "structure of the replica", §3.1).
To make range location O(log N) we pack the permuted integer key columns
into a single uint64 whose natural order equals the lexicographic order.

Columns are non-negative integers with a declared bit width. The packed
key allocates each column its width, most-significant field first, so
``packed(a) < packed(b)  <=>  tuple(a) < tuple(b)`` lexicographically.
Total width must fit 63 bits (we stay in int64 land to keep tensor-friendly
dtypes); all paper workloads (≤6 keys, ≤2^20 domains) fit easily.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

__all__ = ["KeySchema", "pack_columns", "pack_tuple", "unpack_key"]


@dataclasses.dataclass(frozen=True)
class KeySchema:
    """Bit layout for a set of clustering key columns.

    ``bits[name]`` is the field width for column ``name``. The packing
    order is given per-call (it is the replica layout, not a schema
    property).
    """

    bits: Mapping[str, int]

    def __post_init__(self) -> None:
        for name, b in self.bits.items():
            if not 0 < b <= 62:
                raise ValueError(f"column {name!r}: bits must be in (0, 62], got {b}")

    def total_bits(self, layout: Sequence[str]) -> int:
        return sum(self.bits[c] for c in layout)

    def check_layout(self, layout: Sequence[str]) -> None:
        missing = [c for c in layout if c not in self.bits]
        if missing:
            raise KeyError(f"layout references unknown columns {missing}")
        if len(set(layout)) != len(layout):
            raise ValueError(f"layout has duplicate columns: {layout}")
        if self.total_bits(layout) > 63:
            raise ValueError(
                f"packed key needs {self.total_bits(layout)} bits > 63; "
                "reduce column domains or split the table"
            )

    def max_value(self, col: str) -> int:
        return (1 << self.bits[col]) - 1

    @staticmethod
    def for_columns(columns: Mapping[str, np.ndarray]) -> "KeySchema":
        """Infer minimal widths from observed data (with one spare value
        of headroom so exclusive upper bounds stay representable)."""
        bits = {}
        for name, col in columns.items():
            if col.size and int(col.min()) < 0:
                raise ValueError(f"column {name!r} has negative values")
            hi = int(col.max()) + 1 if col.size else 1
            bits[name] = max(1, int(hi).bit_length())
        return KeySchema(bits)


def _field_shifts(schema: KeySchema, layout: Sequence[str]) -> list[int]:
    """Left-shift for each layout position (MSB-first packing)."""
    shifts = []
    acc = schema.total_bits(layout)
    for col in layout:
        acc -= schema.bits[col]
        shifts.append(acc)
    return shifts


def pack_columns(
    columns: Mapping[str, np.ndarray], layout: Sequence[str], schema: KeySchema
) -> np.ndarray:
    """Pack per-column arrays into a single int64 composite key array."""
    schema.check_layout(layout)
    shifts = _field_shifts(schema, layout)
    out = None
    for col, sh in zip(layout, shifts):
        v = columns[col].astype(np.int64, copy=False)
        if v.size and int(v.max()) > schema.max_value(col):
            raise ValueError(
                f"column {col!r} exceeds its {schema.bits[col]}-bit field"
            )
        term = v << np.int64(sh)
        out = term if out is None else out | term
    if out is None:
        raise ValueError("empty layout")
    return out


def pack_tuple(
    values: Sequence[int], layout: Sequence[str], schema: KeySchema
) -> int:
    """Pack one composite key value (python ints; used for bounds)."""
    schema.check_layout(layout)
    shifts = _field_shifts(schema, layout)
    out = 0
    for col, sh, v in zip(layout, shifts, values):
        if not 0 <= int(v) <= schema.max_value(col):
            raise ValueError(f"value {v} out of range for column {col!r}")
        out |= int(v) << sh
    return out


def unpack_key(key: int, layout: Sequence[str], schema: KeySchema) -> tuple[int, ...]:
    shifts = _field_shifts(schema, layout)
    return tuple(
        (int(key) >> sh) & schema.max_value(col) for col, sh in zip(layout, shifts)
    )
