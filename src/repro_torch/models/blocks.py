"""Transformer blocks of the port: kind "attn" (pre-norm GQA attention +
MLP), the counterpart of ``repro.models.blocks``.

Kinds "moe", "ssm" and "hybrid" come in later slices (ROADMAP items 7b
and 7d). A block's decode writes its new K and V into the cache at slot
``pos`` in place, then attends over the whole cache: the reference's
``_attend_gqa_sharded`` with ``ctx=None``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.parallel.padding import PaddedDims
from . import attention as attn_mod
from .config import ArchConfig
from .layers import dense, dense_init, mlp_apply, rmsnorm, rmsnorm_init

__all__ = ["Block", "RMSNorm", "MLP", "init_block", "GLOBAL_WINDOW", "KIND_SLICES"]

#: sentinel window for "global attention" layers inside a SWA arch
GLOBAL_WINDOW = 1 << 30

#: block kinds that later slices of the port bring, and where
KIND_SLICES = {
    "moe": "MoE blocks (models/moe.py) come in a later slice of the port (ROADMAP item 7b)",
    "ssm": "SSD blocks (models/ssm.py) come in a later slice of the port (ROADMAP item 7d)",
    "hybrid": "hybrid attention-SSD blocks come in a later slice of the port (ROADMAP item 7d)",
}


class RMSNorm(nn.Module):
    """An RMSNorm scale that stays float32 whatever ``Module.to`` casts the
    rest of the model to, as the reference keeps its norm scales."""

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = nn.Parameter(scale)

    def _apply(self, fn, recurse=True):
        def keep_float32(t):
            out = fn(t)
            return out if out.dtype == torch.float32 else t.to(device=out.device, dtype=torch.float32)

        return super()._apply(keep_float32, recurse)

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return rmsnorm(x, self.scale, eps)


class MLP(nn.Module):
    """``wi``, ``wo`` and, when gated, ``wg``, each ``[d_in, d_out]``."""

    def __init__(self, wi: torch.Tensor, wo: torch.Tensor, wg: torch.Tensor | None = None):
        super().__init__()
        self.wi, self.wo = nn.Parameter(wi), nn.Parameter(wo)
        if wg is not None:
            self.wg = nn.Parameter(wg)


def init_mlp(d: int, d_ff: int, gated: bool, **kw) -> MLP:
    wi, wo = dense_init(d, d_ff, **kw), dense_init(d_ff, d, **kw)
    return MLP(wi, wo, dense_init(d, d_ff, **kw) if gated else None)


class Block(nn.Module):
    """Pre-norm GQA attention, then (when ``d_ff > 0``) a pre-norm MLP, each
    added to the residual stream."""

    def __init__(self, cfg: ArchConfig, pd: PaddedDims, ln1: RMSNorm, attn: attn_mod.GQA,
                 ln2: RMSNorm | None = None, mlp: MLP | None = None):
        super().__init__()
        self.cfg, self.pd = cfg, pd
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *, window: int = 0,
                q_chunk: int = 512, kv_chunk: int = 1024) -> tuple[torch.Tensor, tuple]:
        """Prefill: (x_out, (k, v)) with k, v [B, S, Hkv, Dh]."""
        cfg = self.cfg
        xn = self.ln1(x, cfg.norm_eps)
        attn_out, kv = attn_mod.gqa_forward(
            self.attn, xn, positions, cfg, self.pd, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
        )
        return self._mlp(x + attn_out), kv

    def decode(self, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int, *,
               window: int = 0) -> torch.Tensor:
        """One token x [B, 1, D]; writes slot ``pos`` of this layer's caches
        ([B, S_alloc, Hkv, Dh]) in place before attending."""
        cfg, pd = self.cfg, self.pd
        xn = self.ln1(x, cfg.norm_eps)
        q, k_new, v_new = attn_mod.gqa_project_decode(self.attn, xn, pos, cfg, pd)
        k_cache[:, pos] = k_new.to(k_cache.dtype)
        v_cache[:, pos] = v_new.to(v_cache.dtype)
        kv_pos = torch.arange(k_cache.shape[1], dtype=torch.int32, device=x.device)
        o = attn_mod.gqa_attend_decode(q, k_cache, v_cache, kv_pos, pos, cfg, pd, window=window)
        return self._mlp(x + dense(o, self.attn.wo))

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        if self.mlp is None:
            return x
        xn2 = self.ln2(x, self.cfg.norm_eps)
        return x + mlp_apply(self.mlp, xn2, self.cfg.act, self.cfg.gated_mlp)


def init_block(cfg: ArchConfig, pd: PaddedDims, kind: str, d_ff: int, *, generator, device, dtype) -> Block:
    if kind in KIND_SLICES:
        raise NotImplementedError(KIND_SLICES[kind])
    kw = dict(generator=generator, device=device, dtype=dtype)
    d = cfg.d_model
    ln1 = RMSNorm(rmsnorm_init(d, device=device))
    attn = attn_mod.init_gqa(cfg, pd, **kw)
    if d_ff <= 0:
        return Block(cfg, pd, ln1, attn)
    mlp = init_mlp(d, d_ff, cfg.gated_mlp, **kw)
    return Block(cfg, pd, ln1, attn, RMSNorm(rmsnorm_init(d, device=device)), mlp)
