"""HR replica layouts for checkpoint restore routing.

One row per checkpoint FILE with keys (stack_id, layer, kind_id); the RF
replica manifests are SortedTables in different key orders. A restore
query (full / layer-range / stack / kind subset) is costed with Eq (1)
and routed to the replica whose order makes the touched file span
contiguous — the paper's Request Scheduler applied to restore I/O.

The port's copy of ``repro.checkpoint.layouts`` over the port's
``SortedTable``, ``CostModel`` and ``TableStats``: the same plans.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from repro_torch.core import CostModel, Query, SortedTable
from repro_torch.core.ecdf import TableStats
from repro_torch.core.keys import KeySchema
from .manager import REPLICA_LAYOUTS, manifest_key_columns

__all__ = ["RestorePlan", "CheckpointRouter"]


@dataclasses.dataclass
class RestorePlan:
    replica: int
    layout: tuple[str, ...]
    files_span: int  # contiguous files streamed (slab size — the cost)
    files_needed: int  # files actually matching the query
    file_indices: np.ndarray


class CheckpointRouter:
    """Routes restore queries over a step's replica manifests."""

    def __init__(self, directory: str, step: int) -> None:
        d = os.path.join(directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest_r0.json")) as f:
            manifest = json.load(f)
        cols = manifest_key_columns(manifest["leaves"])
        keys = {k: cols[k] for k in ("stack_id", "layer", "kind_id")}
        vals = {"file_idx": cols["file_idx"].astype(np.float64)}
        self.schema = KeySchema.for_columns(keys)
        self.stats = TableStats.from_columns(keys, self.schema)
        self.model = CostModel(stats=self.stats)
        self.layouts = []
        self.tables = []
        r = 0
        while os.path.exists(os.path.join(d, f"manifest_r{r}.json")):
            with open(os.path.join(d, f"manifest_r{r}.json")) as f:
                layout = tuple(json.load(f)["layout"])
            self.layouts.append(layout)
            self.tables.append(SortedTable.from_columns(keys, vals, layout, self.schema))
            r += 1

    def plan(self, query: Query) -> RestorePlan:
        """Pick the min-cost replica (Eq 3) and return its streamed span."""
        costs = [self.model.query_cost(a, query) for a in self.layouts]
        j = int(np.argmin(costs))
        res = self.tables[j].execute(
            Query(filters=query.filters, agg="select")
        )
        return RestorePlan(
            replica=j,
            layout=self.layouts[j],
            files_span=res.rows_scanned,
            files_needed=res.rows_matched,
            file_indices=self.tables[j].value_cols["file_idx"][res.selected].astype(np.int64),
        )

    def worst_plan(self, query: Query) -> RestorePlan:
        """Span on the WORST replica (what a homogeneous layout risks)."""
        costs = [self.model.query_cost(a, query) for a in self.layouts]
        j = int(np.argmax(costs))
        res = self.tables[j].execute(Query(filters=query.filters, agg="select"))
        return RestorePlan(
            replica=j,
            layout=self.layouts[j],
            files_span=res.rows_scanned,
            files_needed=res.rows_matched,
            file_indices=self.tables[j].value_cols["file_idx"][res.selected].astype(np.int64),
        )
