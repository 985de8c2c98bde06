"""HR-routed training-data pipeline (the paper's technique as a
first-class framework feature).

The corpus *index* (doc metadata) is replicated RF× with HRCA-chosen key
orders; curriculum sampling queries ("quality ≥ 8", "domain=code ∧
length∈[2k,4k)") are routed by the engine's Request Scheduler to the
replica whose layout minimizes the scan (Eq 3). The pipeline then
materializes token batches from the selected doc ids.

``mechanism="TR"`` builds the single expert layout instead — the paper's
baseline — so benchmarks compare both under identical queries.

The port's copy of ``repro.data.pipeline`` over the port's ``HREngine``:
the same column family, HRCA arguments, routing and numpy draws, so both
packages give the same layouts, replicas, doc ids and batches. The index
is host-resident (``create_column_family``'s default); ``device`` is the
engine's (the card unless another is named).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import Eq, HREngine, Query, Range, Workload
from .corpus import CorpusSpec, SyntheticCorpus

__all__ = ["curriculum_workload", "HRDataPipeline", "BatchReport"]


def curriculum_workload(rng: np.random.Generator, n: int = 60) -> Workload:
    """Curriculum query mix: phase filters over quality/length/domain/day."""
    qs = []
    for i in range(n):
        r = i % 3
        if r == 0:  # quality-gated domain slice (equality-heavy)
            qs.append(
                Query(
                    filters={
                        "domain": Eq(int(rng.integers(0, 8))),
                        "quality": Range(7, 10),
                    },
                    agg="select",
                )
            )
        elif r == 1:  # length curriculum window
            lo = int(rng.integers(0, 12))
            qs.append(
                Query(
                    filters={
                        "length_bucket": Range(lo, lo + 4),
                        "quality": Eq(int(rng.integers(4, 10))),
                    },
                    agg="select",
                )
            )
        else:  # freshness window within a domain
            d0 = int(rng.integers(0, 900))
            qs.append(
                Query(
                    filters={
                        "day": Range(d0, d0 + 64),
                        "domain": Eq(int(rng.integers(0, 8))),
                    },
                    agg="select",
                )
            )
    return Workload(qs)


@dataclasses.dataclass
class BatchReport:
    replica_id: int
    rows_scanned: int
    rows_matched: int
    estimated_rows: float


class HRDataPipeline:
    def __init__(
        self,
        corpus: SyntheticCorpus,
        *,
        replication_factor: int = 3,
        mechanism: str = "HR",
        n_nodes: int = 6,
        workload: Workload | None = None,
        seed: int = 0,
        hrca_kwargs: dict | None = None,
        device=None,
    ) -> None:
        self.corpus = corpus
        self.rng = np.random.default_rng(seed)
        self.workload = workload or curriculum_workload(np.random.default_rng(seed + 1))
        self.engine = HREngine(n_nodes=n_nodes, device=device)
        self.cf = self.engine.create_column_family(
            "corpus_index",
            corpus.key_cols,
            corpus.value_cols,
            replication_factor=replication_factor,
            mechanism=mechanism,
            workload=self.workload,
            hrca_kwargs=hrca_kwargs or {"k_max": 2000, "seed": 0},
        )
        self.total_rows_scanned = 0
        self.n_reads = 0

    def layouts(self):
        return self.engine.layouts("corpus_index")

    def sample_batch(self, batch_size: int, seq_len: int, query: Query | None = None) -> tuple[dict, BatchReport]:
        """Route one curriculum query, draw ``batch_size`` docs from the
        matches (with replacement if needed), materialize tokens/labels."""
        if query is None:
            qi = int(self.rng.integers(0, len(self.workload)))
            query = self.workload.queries[qi]
        result, report = self.engine.read("corpus_index", query)
        self.total_rows_scanned += report.rows_scanned
        self.n_reads += 1
        if result.selected is None or len(result.selected) == 0:
            doc_ids = self.rng.integers(0, self.corpus.spec.n_docs, batch_size)
        else:
            table = self.engine._table(self.cf, self.cf.replicas[report.replica_id])
            matched_docs = table.value_cols["doc_id"][result.selected].astype(np.int64)
            idx = self.rng.integers(0, len(matched_docs), batch_size)
            doc_ids = matched_docs[idx]
        toks = self.corpus.tokens(doc_ids, seq_len + 1)
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        return batch, BatchReport(
            replica_id=report.replica_id,
            rows_scanned=report.rows_scanned,
            rows_matched=result.rows_matched,
            estimated_rows=report.estimated_rows,
        )
