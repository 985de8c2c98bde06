"""Synthetic training corpus with queryable document metadata: the port's
copy of ``repro.data.corpus`` (numpy only).

Documents carry sortable attributes — (domain, length bucket, quality
decile, ingest day) — exactly the kind of multi-dimensional sortable
metadata the paper targets. Token content is generated deterministically
from the doc id (hash-seeded), so the corpus needs no storage and any
node can materialize any document — which is what lets heterogeneous
*index* replicas stand in for heterogeneous data replicas.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CorpusSpec", "SyntheticCorpus"]

N_DOMAINS = 8
N_LENGTH_BUCKETS = 16
N_QUALITY = 10
N_DAYS = 1024


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    n_docs: int = 100_000
    vocab_size: int = 50_000
    seed: int = 0


class SyntheticCorpus:
    def __init__(self, spec: CorpusSpec) -> None:
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        n = spec.n_docs
        # correlated attributes (quality skews by domain, length by domain)
        domain = rng.integers(0, N_DOMAINS, n)
        length_bucket = np.clip(
            rng.poisson(3 + 1.5 * (domain % 4), n), 0, N_LENGTH_BUCKETS - 1
        )
        quality = np.clip(
            rng.normal(5 + (domain % 3), 2.0, n).astype(np.int64), 0, N_QUALITY - 1
        )
        day = rng.integers(0, N_DAYS, n)
        self.key_cols = {
            "domain": domain.astype(np.int64),
            "length_bucket": length_bucket.astype(np.int64),
            "quality": quality.astype(np.int64),
            "day": day.astype(np.int64),
        }
        self.value_cols = {"doc_id": np.arange(n, dtype=np.float64)}

    def tokens(self, doc_ids: np.ndarray, seq_len: int) -> np.ndarray:
        """Deterministic per-doc token stream: [len(doc_ids), seq_len]."""
        out = np.empty((len(doc_ids), seq_len), dtype=np.int32)
        for i, d in enumerate(np.asarray(doc_ids, np.int64)):
            rng = np.random.default_rng(self.spec.seed * 1_000_003 + int(d))
            out[i] = rng.integers(0, self.spec.vocab_size, seq_len, dtype=np.int32)
        return out
