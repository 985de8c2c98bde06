"""Transformer blocks of the port, the counterpart of
``repro.models.blocks``: kinds

  attn   — pre-norm attention (GQA or MLA) + MLP
  moe    — pre-norm attention + (shared-expert MLP ∥ routed MoE)
  ssm    — pre-norm Mamba-2 SSD only (Mamba blocks carry no MLP)
  hybrid — Hymba: attention ∥ SSD on the same normed input, each branch
           RMS-normed, then averaged, + MLP

A block's prefill returns its cache entries in the reference's order
(``k, v`` or ``ckv, krope``, then ``conv_x, conv_bc, state``); its
``forward_train`` returns the auxiliary loss instead (the MoE load-balance
statistic times ``moe_aux_alpha``), which the reference's
``block_forward`` adds up. Its decode
writes every entry in place: the attention entries at slot ``pos``, then
attends over the whole cache (the reference's ``_attend_*_sharded`` with
``ctx=None``); the SSD entries whole.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.parallel.padding import PaddedDims
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ArchConfig
from .layers import KeepFloat32, dense, dense_init, mlp_apply, rmsnorm, rmsnorm_init

__all__ = ["Block", "RMSNorm", "MLP", "init_block", "init_mlp", "GLOBAL_WINDOW", "KINDS"]

#: sentinel window for "global attention" layers inside a SWA arch
GLOBAL_WINDOW = 1 << 30

KINDS = ("attn", "moe", "ssm", "hybrid")


class RMSNorm(KeepFloat32):
    """An RMSNorm scale that stays float32 whatever ``Module.to`` casts the
    rest of the model to, as the reference keeps its norm scales."""

    FLOAT32 = ("scale",)

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = nn.Parameter(scale)

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
    """One layer of kind ``kind``; the parts its kind has are set, the
    others are None: ``attn`` (``GQA`` or ``MLA``), ``ssm``, the hybrid's
    ``norm_attn`` and ``norm_ssm``, and after ``ln2`` any of ``shared``,
    ``moe`` and ``mlp``, summed."""

    def __init__(self, cfg: ArchConfig, pd: PaddedDims, kind: str, ln1: RMSNorm, *,
                 attn: nn.Module | None = None, ssm: ssm_mod.SSM | None = None,
                 norm_attn: RMSNorm | None = None, norm_ssm: RMSNorm | None = None,
                 ln2: RMSNorm | None = None, mlp: MLP | None = None, moe: moe_mod.MoE | None = None,
                 shared: MLP | None = None):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"unknown block kind {kind!r}; known: {KINDS}")
        self.cfg, self.pd, self.kind = cfg, pd, kind
        self.ln1, self.attn, self.ssm = ln1, attn, ssm
        self.norm_attn, self.norm_ssm = norm_attn, norm_ssm
        self.ln2, self.shared, self.moe, self.mlp = ln2, shared, moe, mlp

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *, window: int = 0,
                q_chunk: int = 512, kv_chunk: int = 1024) -> tuple[torch.Tensor, tuple]:
        """Prefill: (x_out, the layer's cache entries)."""
        x, entries, _ = self._full(x, positions, window, q_chunk, kv_chunk, collect=True)
        return x, entries

    def forward_train(self, x: torch.Tensor, positions: torch.Tensor, *, window: int = 0,
                      q_chunk: int = 512, kv_chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
        """Training: (x_out, aux), aux a float32 scalar: the MoE load-balance
        statistic times ``cfg.moe_aux_alpha``, 0 for the other kinds."""
        x, _, aux = self._full(x, positions, window, q_chunk, kv_chunk, collect=False)
        return x, torch.zeros((), dtype=torch.float32, device=x.device) if aux is None else aux

    def _full(self, x, positions, window: int, q_chunk: int, kv_chunk: int, *, collect: bool):
        """The reference's ``block_forward``: (x_out, cache entries, aux);
        the entries only when ``collect``."""
        cfg, pd = self.cfg, self.pd
        xn = self.ln1(x, cfg.norm_eps)
        entries: tuple = ()
        attn_out = ssm_out = None
        if self.attn is not None:
            fwd = attn_mod.mla_forward if cfg.attention == "mla" else attn_mod.gqa_forward
            attn_out, kv = fwd(self.attn, xn, positions, cfg, pd, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
            entries += kv
        if self.ssm is not None:
            if collect:
                ssm_out, st = ssm_mod.ssm_forward(self.ssm, xn, cfg, return_state=True)
                entries += (st["conv_x"], st["conv_bc"], st["state"])
            else:
                ssm_out = ssm_mod.ssm_forward(self.ssm, xn, cfg)
        x, aux = self._ffn(self._mix(x, attn_out, ssm_out))
        return x, entries, aux

    def decode(self, x: torch.Tensor, cache: tuple, pos: int, *, window: int = 0) -> torch.Tensor:
        """One token x [B, 1, D]; ``cache`` holds this layer's entries in the
        prefill's order, each written in place."""
        cfg = self.cfg
        xn = self.ln1(x, cfg.norm_eps)
        attn_out = ssm_out = None
        if self.attn is not None:
            decode = self._mla_decode if cfg.attention == "mla" else self._gqa_decode
            attn_out = decode(xn, cache[0], cache[1], pos, window)
        if self.ssm is not None:
            names = ("conv_x", "conv_bc", "state")
            entries = cache[-3:]  # after the attention entries, if any
            ssm_out, new = ssm_mod.ssm_decode(self.ssm, xn, dict(zip(names, entries)), cfg)
            for name, entry in zip(names, entries):
                entry.copy_(new[name])
        return self._ffn(self._mix(x, attn_out, ssm_out))[0]

    def _gqa_decode(self, xn, k_cache, v_cache, pos: int, window: int) -> torch.Tensor:
        """Writes slot ``pos`` of the caches ([B, S_alloc, Hkv, Dh]), then attends."""
        cfg, pd = self.cfg, self.pd
        q, k_new, v_new = attn_mod.gqa_project_decode(self.attn, xn, pos, cfg, pd)
        k_cache[:, pos] = k_new.to(k_cache.dtype)
        v_cache[:, pos] = v_new.to(v_cache.dtype)
        kv_pos = torch.arange(k_cache.shape[1], dtype=torch.int32, device=xn.device)
        o = attn_mod.gqa_attend_decode(q, k_cache, v_cache, kv_pos, pos, cfg, pd, window=window)
        return dense(o, self.attn.wo)

    def _mla_decode(self, xn, ckv, krope, pos: int, window: int) -> torch.Tensor:
        """Absorbed MLA: q_nope through W_uk in float32, slot ``pos`` of the
        latent and rope caches written, scores over both, then W_uv and
        ``wo``. Decode takes no window, as the reference's."""
        cfg, pd = self.cfg, self.pd
        B, rkv, h = xn.shape[0], cfg.kv_lora_rank, pd.n_heads
        q_nope, q_rope, c_new, kr_new = attn_mod.mla_project_decode(self.attn, xn, pos, cfg, pd)
        wk_b = self.attn.wk_b.reshape(rkv, h, cfg.qk_nope_dim)
        q_eff = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), wk_b.float())
        ckv[:, pos] = c_new.to(ckv.dtype)
        krope[:, pos] = kr_new.to(krope.dtype)
        kv_pos = torch.arange(ckv.shape[1], dtype=torch.int32, device=xn.device)
        ctx = attn_mod.mla_attend_decode(q_eff, q_rope, ckv, krope, kv_pos, pos, cfg, pd)
        wv_b = self.attn.wv_b.reshape(rkv, h, cfg.v_head_dim)
        o = torch.einsum("bhr,rhd->bhd", ctx.float(), wv_b.float())
        return dense(o.to(xn.dtype).reshape(B, 1, h * cfg.v_head_dim), self.attn.wo)

    def _mix(self, x, attn_out, ssm_out) -> torch.Tensor:
        if self.kind == "hybrid":
            eps = self.cfg.norm_eps
            return x + 0.5 * (self.norm_attn(attn_out, eps) + self.norm_ssm(ssm_out, eps))
        return x + (ssm_out if self.kind == "ssm" else attn_out)

    def _ffn(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(x + the feed-forward parts, the auxiliary loss; None but for MoE)."""
        aux = None
        if self.ln2 is None:
            return x, aux
        cfg = self.cfg
        xn2 = self.ln2(x, cfg.norm_eps)
        parts = []
        if self.shared is not None:
            parts.append(mlp_apply(self.shared, xn2, cfg.act, cfg.gated_mlp))
        if self.moe is not None:
            y, a = moe_mod.moe_forward(self.moe, xn2, cfg)
            parts.append(y.to(x.dtype))
            aux = cfg.moe_aux_alpha * a
        if self.mlp is not None:
            parts.append(mlp_apply(self.mlp, xn2, cfg.act, cfg.gated_mlp))
        h = parts[0]
        for part in parts[1:]:
            h = h + part
        return x + h, aux


def init_block(cfg: ArchConfig, pd: PaddedDims, kind: str, d_ff: int, *, generator, device, dtype) -> Block:
    """A block of ``kind`` with the reference's parts and distributions."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    d = cfg.d_model
    norm = lambda: RMSNorm(rmsnorm_init(d, device=device))  # noqa: E731
    parts: dict = {}
    if kind in ("attn", "moe", "hybrid"):
        parts["attn"] = (attn_mod.init_mla if cfg.attention == "mla" else attn_mod.init_gqa)(cfg, pd, **kw)
    if kind in ("ssm", "hybrid"):
        parts["ssm"] = ssm_mod.init_ssm(cfg, **kw)
    if kind == "hybrid":
        parts.update(norm_attn=norm(), norm_ssm=norm())
    if kind == "moe":
        parts["moe"] = moe_mod.init_moe(cfg, **kw)
        if cfg.n_shared_experts:
            parts["shared"] = init_mlp(d, cfg.n_shared_experts * cfg.moe_d_ff, cfg.gated_mlp, **kw)
        parts["ln2"] = norm()
    elif kind in ("attn", "hybrid") and d_ff > 0:
        parts.update(mlp=init_mlp(d, d_ff, cfg.gated_mlp, **kw), ln2=norm())
    return Block(cfg, pd, kind, norm(), **parts)
