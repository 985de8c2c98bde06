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
attends over the cache; the SSD entries whole.

Under a mesh (``ctx``) the weights, the activations and the cache are
DTensors, and decode attention runs in the reference's
sequence-sharded region (``_attend_sharded``, its ``_attend_*_sharded``):
each model rank owns ``S_alloc / tp`` cache slots, writes the new entries
only where it owns ``pos``, attends over its own slots, and the partials
are combined over the model group (``attention._combine_over_axis``).
The region takes the queries and new entries batch-sharded over the dp
axes and replicated over ``model`` (a ``redistribute``), and the cache
as this rank's shard (``to_local``).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.parallel.padding import PaddedDims
from repro_torch.parallel.sharding import logical_to_spec
from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ArchConfig
from .layers import KeepFloat32, contiguous_stride, dense, dense_init, mlp_apply, rmsnorm, rmsnorm_init

__all__ = ["Block", "RMSNorm", "MLP", "init_block", "init_mlp", "block_axes", "GLOBAL_WINDOW", "KINDS"]

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
                q_chunk: int = 512, kv_chunk: int = 1024, ctx=None) -> tuple[torch.Tensor, tuple]:
        """Prefill: (x_out, the layer's cache entries)."""
        x, entries, _ = self._full(x, positions, window, q_chunk, kv_chunk, ctx, collect=True)
        return x, entries

    def forward_train(self, x: torch.Tensor, positions: torch.Tensor, *, window: int = 0,
                      q_chunk: int = 512, kv_chunk: int = 1024, ctx=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Training: (x_out, aux), aux a float32 scalar: the MoE load-balance
        statistic times ``cfg.moe_aux_alpha``, 0 for the other kinds."""
        x, _, aux = self._full(x, positions, window, q_chunk, kv_chunk, ctx, collect=False)
        return x, torch.zeros((), dtype=torch.float32, device=x.device) if aux is None else aux

    def _full(self, x, positions, window: int, q_chunk: int, kv_chunk: int, ctx, *, collect: bool):
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
        x, aux = self._ffn(self._mix(x, attn_out, ssm_out), ctx)
        return x, entries, aux

    def decode(self, x: torch.Tensor, cache: tuple, pos: int, *, window: int = 0, ctx=None) -> torch.Tensor:
        """One token x [B, 1, D]; ``cache`` holds this layer's entries in the
        prefill's order, each written in place (under ``ctx``, DTensor views
        of the stacked cache's shards)."""
        cfg = self.cfg
        xn = self.ln1(x, cfg.norm_eps)
        attn_out = ssm_out = None
        if self.attn is not None:
            decode = self._mla_decode if cfg.attention == "mla" else self._gqa_decode
            attn_out = decode(xn, cache[0], cache[1], pos, window, ctx)
        if self.ssm is not None:
            names = ("conv_x", "conv_bc", "state")
            entries = cache[-3:]  # after the attention entries, if any
            ssm_out, new = ssm_mod.ssm_decode(self.ssm, xn, dict(zip(names, entries)), cfg)
            for name, entry in zip(names, entries):
                write_entry(entry, new[name])
        return self._ffn(self._mix(x, attn_out, ssm_out), ctx)[0]

    def _gqa_decode(self, xn, k_cache, v_cache, pos: int, window: int, ctx) -> torch.Tensor:
        """Writes slot ``pos`` of the caches ([B, S_alloc, Hkv, Dh]), then attends."""
        cfg, pd = self.cfg, self.pd
        q, k_new, v_new = attn_mod.gqa_project_decode(self.attn, xn, pos, cfg, pd)

        def attend(q, k_cache, v_cache, kv_pos, group=None):
            return attn_mod.gqa_attend_decode(q, k_cache, v_cache, kv_pos, pos, cfg, pd, window=window, group=group)

        o = _attend_sharded(ctx, (q,), (k_new, v_new), (k_cache, v_cache), pos, attend)
        return dense(o, self.attn.wo)

    def _mla_decode(self, xn, ckv, krope, pos: int, window: int, ctx) -> torch.Tensor:
        """Absorbed MLA: q_nope through W_uk in float32, slot ``pos`` of the
        latent and rope caches written, scores over both, then W_uv and
        ``wo``. Decode takes no window, as the reference's."""
        cfg, pd = self.cfg, self.pd
        B, rkv, h = xn.shape[0], cfg.kv_lora_rank, pd.n_heads
        q_nope, q_rope, c_new, kr_new = attn_mod.mla_project_decode(self.attn, xn, pos, cfg, pd)
        wk_b = self.attn.wk_b.reshape(rkv, h, cfg.qk_nope_dim)
        q_eff = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), wk_b.float())

        def attend(q_eff, q_rope, ckv, krope, kv_pos, group=None):
            return attn_mod.mla_attend_decode(q_eff, q_rope, ckv, krope, kv_pos, pos, cfg, pd, group=group)

        lat = _attend_sharded(ctx, (q_eff, q_rope), (c_new, kr_new), (ckv, krope), pos, attend)
        wv_b = self.attn.wv_b.reshape(rkv, h, cfg.v_head_dim)
        o = torch.einsum("bhr,rhd->bhd", lat.float(), wv_b.float())
        return dense(o.to(xn.dtype).reshape(B, 1, h * cfg.v_head_dim), self.attn.wo)

    def _mix(self, x, attn_out, ssm_out) -> torch.Tensor:
        if self.kind == "hybrid":
            eps = self.cfg.norm_eps
            return x + 0.5 * (self.norm_attn(attn_out, eps) + self.norm_ssm(ssm_out, eps))
        return x + (ssm_out if self.kind == "ssm" else attn_out)

    def _ffn(self, x: torch.Tensor, ctx=None) -> tuple[torch.Tensor, torch.Tensor | None]:
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
            y, a = moe_mod.moe_forward(self.moe, xn2, cfg, ctx)
            parts.append(y.to(x.dtype))
            aux = cfg.moe_aux_alpha * a
        if self.mlp is not None:
            parts.append(mlp_apply(self.mlp, xn2, cfg.act, cfg.gated_mlp))
        h = parts[0]
        for part in parts[1:]:
            h = h + part
        return x + h, aux


def _attend_sharded(ctx, queries: tuple, new: tuple, caches: tuple, pos: int, attend):
    """Write ``new`` (the entries of slot ``pos``, [B, ...] each) into
    ``caches`` ([B, S_alloc, ...] each), then ``attend(*queries, *caches,
    kv_pos, group)``. Without ``ctx`` on whole tensors; under ``ctx`` the
    reference's sequence-sharded region (module docstring), which returns
    a DTensor batch-sharded over the dp axes and replicated over
    ``model``."""
    if ctx is None:
        for c, n in zip(caches, new):
            c[:, pos] = n.to(c.dtype)
        kv_pos = torch.arange(caches[0].shape[1], dtype=torch.int32, device=caches[0].device)
        return attend(*queries, *caches, kv_pos)
    from torch.distributed.tensor import DTensor

    mesh = ctx.mesh
    pl = ctx.placements(logical_to_spec(ctx, ("batch",)))
    queries = [t.redistribute(mesh, pl).to_local() for t in queries]
    new = [t.redistribute(mesh, pl).to_local() for t in new]
    shards = [c.to_local() for c in caches]
    S_loc = -(-caches[0].shape[1] // ctx.tp_size)  # torch.chunk's split, as Shard's
    base = mesh.get_local_rank(ctx.tp_axis) * S_loc
    if 0 <= pos - base < shards[0].shape[1]:  # this rank owns the slot
        for c, n in zip(shards, new):
            c[:, pos - base] = n.to(c.dtype)
    kv_pos = base + torch.arange(shards[0].shape[1], dtype=torch.int32, device=shards[0].device)
    out = attend(*queries, *shards, kv_pos, mesh.get_group(ctx.tp_axis))
    B = caches[0].shape[0]
    shape = (B, *out.shape[1:])
    return DTensor.from_local(out, mesh, pl, shape=torch.Size(shape), stride=contiguous_stride(shape))


def write_entry(entry: torch.Tensor, value: torch.Tensor) -> None:
    """``entry.copy_(value)``; under a mesh ``entry`` is a DTensor view of a
    cache shard, and ``value`` is redistributed to its placements first."""
    from torch.distributed.tensor import DTensor

    if isinstance(entry, DTensor):
        entry.to_local().copy_(value.redistribute(entry.device_mesh, entry.placements).to_local())
    else:
        entry.copy_(value)


def _mlp_like_axes(gated: bool) -> dict:
    ax = {"wi": ("fsdp", "mlp"), "wo": ("mlp", "fsdp")}
    if gated:
        ax["wg"] = ("fsdp", "mlp")
    return ax


def block_axes(cfg: ArchConfig, pd: PaddedDims, tp: int, kind: str, d_ff: int) -> dict:
    """Logical axes of one layer's leaves, keyed as the reference's."""
    ax: dict = {"ln1": (None,)}
    if kind in ("attn", "moe", "hybrid"):
        ax["attn"] = attn_mod.mla_axes(cfg, pd) if cfg.attention == "mla" else attn_mod.gqa_axes(cfg, pd)
    if kind in ("ssm", "hybrid"):
        ax["ssm"] = ssm_mod.ssm_axes(cfg, tp)
    if kind == "hybrid":
        ax["norm_attn"] = (None,)
        ax["norm_ssm"] = (None,)
    if kind == "moe":
        ax["moe"] = moe_mod.moe_axes(cfg, tp)
        if cfg.n_shared_experts:
            ax["shared"] = _mlp_like_axes(cfg.gated_mlp)
        ax["ln2"] = (None,)
    elif kind in ("attn", "hybrid") and d_ff > 0:
        ax["mlp"] = _mlp_like_axes(cfg.gated_mlp)
        ax["ln2"] = (None,)
    return ax


def init_block(cfg: ArchConfig, pd: PaddedDims, kind: str, d_ff: int, *, generator, device, dtype,
               tp: int = 1) -> Block:
    """A block of ``kind`` with the reference's parts and distributions;
    ``pd`` the padded dims at ``tp``."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    d = cfg.d_model
    norm = lambda: RMSNorm(rmsnorm_init(d, device=device))  # noqa: E731
    parts: dict = {}
    if kind in ("attn", "moe", "hybrid"):
        parts["attn"] = (attn_mod.init_mla if cfg.attention == "mla" else attn_mod.init_gqa)(cfg, pd, **kw)
    if kind in ("ssm", "hybrid"):
        parts["ssm"] = ssm_mod.init_ssm(cfg, tp=tp, **kw)
    if kind == "hybrid":
        parts.update(norm_attn=norm(), norm_ssm=norm())
    if kind == "moe":
        parts["moe"] = moe_mod.init_moe(cfg, tp=tp, **kw)
        if cfg.n_shared_experts:
            parts["shared"] = init_mlp(d, cfg.n_shared_experts * cfg.moe_d_ff, cfg.gated_mlp, **kw)
        parts["ln2"] = norm()
    elif kind in ("attn", "hybrid") and d_ff > 0:
        parts.update(mlp=init_mlp(d, d_ff, cfg.gated_mlp, **kw), ln2=norm())
    return Block(cfg, pd, kind, norm(), **parts)
