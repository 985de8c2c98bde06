"""Stand-ins for every model input on the ``meta`` device: shapes and
types, no allocation (the dry-run pattern); the counterpart of
``repro.launch.input_specs``, whose ``jax.ShapeDtypeStruct``s they
match.
"""

from __future__ import annotations

import torch

from repro_torch.configs.registry import ShapeSpec
from repro_torch.models import lm
from repro_torch.models.config import ArchConfig

__all__ = ["train_batch_specs", "decode_input_specs", "prefill_batch_specs"]


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    batch = {}
    if cfg.input_mode == "tokens":
        batch["tokens"] = _sds((B, S), torch.int32)
    else:
        batch["embeds"] = _sds((B, S, cfg.d_model), torch.bfloat16)
    if cfg.n_codebooks > 1:
        batch["labels"] = _sds((B, S, cfg.n_codebooks), torch.int32)
    else:
        batch["labels"] = _sds((B, S), torch.int32)
    return batch


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    if cfg.input_mode == "tokens":
        return {"tokens": _sds((B, S), torch.int32)}
    return {"embeds": _sds((B, S, cfg.d_model), torch.bfloat16)}


def decode_input_specs(cfg: ArchConfig, shape: ShapeSpec, tp: int):
    """(cache, batch_t, pos) stand-ins: one new token against a cache of
    ``shape.seq_len`` slots."""
    B, S = shape.global_batch, shape.seq_len
    cache = lm.init_cache(cfg, B, S, device="meta", tp=tp)
    if cfg.input_mode == "tokens":
        batch_t = {"tokens": _sds((B, 1), torch.int32)}
    else:
        batch_t = {"embeds": _sds((B, 1, cfg.d_model), torch.bfloat16)}
    pos = _sds((), torch.int32)
    return cache, batch_t, pos
