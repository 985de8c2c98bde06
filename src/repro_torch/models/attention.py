"""Attention of the port: GQA (RoPE variants, sliding windows) and MLA
(DeepSeek-V3), the counterpart of ``repro.models.attention``:
  * full sequence (prefill): ``flash_attention`` (chunked online softmax
    in plain torch ops);
  * decode: one query token against a cache whose *sequence* dim may be
    sharded over the ``model`` mesh axis (SP). Each shard computes a
    partial (o, m, l) over its own slots and ``_combine_over_axis``
    merges them with an exp-rescaled sum over the axis's process group
    (flash-decoding across ranks); ``group=None`` finishes locally.

MLA decode takes the absorbed form: scores against the latent cache
directly (q_nope absorbed through W_uk by the caller, the output through
W_uv after), so a step's work is O(S · kv_lora_rank), not
O(S · n_heads · d_head).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.parallel.padding import PaddedDims
from .config import ArchConfig
from .layers import NEG, KeepFloat32, apply_rope, dense, dense_init, fit_split, flash_attention, rmsnorm

__all__ = [
    "GQA",
    "MLA",
    "init_gqa",
    "gqa_axes",
    "gqa_forward",
    "gqa_project_decode",
    "gqa_attend_decode",
    "init_mla",
    "mla_axes",
    "mla_forward",
    "mla_project_decode",
    "mla_attend_decode",
]


class GQA(nn.Module):
    """The four projections ``wq``, ``wk``, ``wv``, ``wo``, each
    ``[d_in, d_out]`` as in the reference."""

    def __init__(self, wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (nn.Parameter(w) for w in (wq, wk, wv, wo))


def init_gqa(cfg: ArchConfig, pd: PaddedDims, *, generator, device, dtype) -> GQA:
    d, dh = cfg.d_model, cfg.d_head
    hq, hkv = pd.n_heads, pd.n_kv_heads
    kw = dict(generator=generator, device=device, dtype=dtype)
    wq = dense_init(d, hq * dh, **kw)
    if pd.n_heads != cfg.n_heads:  # zero-out padded q heads
        wq = wq.reshape(d, hq, dh)
        wq[:, cfg.n_heads :, :] = 0
        wq = wq.reshape(d, hq * dh)
    return GQA(wq, dense_init(d, hkv * dh, **kw), dense_init(d, hkv * dh, **kw), dense_init(hq * dh, d, **kw))


def gqa_axes(cfg: ArchConfig, pd: PaddedDims) -> dict:
    """Logical axes of the four projections; the small KV projections are
    replicated unless their head count is a multiple of 8."""
    kv_sharded = pd.n_kv_heads % 8 == 0
    kv = ("fsdp", "heads") if kv_sharded else ("fsdp", None)
    return {"wq": ("fsdp", "heads"), "wk": kv, "wv": kv, "wo": ("heads", "fsdp")}


def _split_heads(x: torch.Tensor, n_heads: int, d_head: int) -> torch.Tensor:
    b, s, _ = x.shape
    return fit_split(x, 2, n_heads).reshape(b, s, n_heads, d_head)


def gqa_forward(
    p: GQA,
    x: torch.Tensor,  # [B, S, D]
    positions: torch.Tensor,  # [B, S]
    cfg: ArchConfig,
    pd: PaddedDims,
    *,
    window: int = 0,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Returns (output [B,S,D], (k, v) for cache seeding)."""
    dh = cfg.d_head
    q = _split_heads(dense(x, p.wq), pd.n_heads, dh)
    k = _split_heads(dense(x, p.wk), pd.n_kv_heads, dh)
    v = _split_heads(dense(x, p.wv), pd.n_kv_heads, dh)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    o = flash_attention(
        q, k, v, positions, positions,
        causal=True, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk,
    )
    out = dense(o.reshape(*x.shape[:2], pd.n_heads * dh), p.wo)
    return out, (k, v)


def _partial_softmax(scores: torch.Tensor, values: torch.Tensor, spec: str = "...k,...kd->...d"):
    """scores [..., S], values [..., S, Dv] → (o, m, l) partials (fp32);
    ``spec`` contracts the weights with the values."""
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    p = torch.where(m[..., None] <= NEG / 2, 0.0, p)
    l = p.sum(dim=-1)
    o = torch.einsum(spec, p, values.float())
    return o, m, l


def _combine_over_axis(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, group=None) -> torch.Tensor:
    """Exp-rescaled sum of softmax partials over the ranks of ``group`` (a
    process group): the largest ``m`` over the group, then the sums of
    ``l·scale`` and ``o·scale`` with ``scale = exp(m - max m)``. With
    ``group=None`` the partial is finished locally."""
    if group is None:
        return o / torch.clamp(l[..., None], min=1e-30)
    g_m = m.clone()
    dist.all_reduce(g_m, op=dist.ReduceOp.MAX, group=group)
    scale = torch.exp(m - g_m)
    g_l, g_o = l * scale, o * scale[..., None]
    dist.all_reduce(g_l, group=group)
    dist.all_reduce(g_o, group=group)
    return g_o / torch.clamp(g_l[..., None], min=1e-30)


def gqa_project_decode(
    p: GQA, x_t: torch.Tensor, pos: int, cfg: ArchConfig, pd: PaddedDims
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode-step projections: q [B,1,Hq,Dh], k_new/v_new [B,Hkv,Dh].

    The caller writes (k_new, v_new) into the cache slot for ``pos``
    BEFORE attending, so the current token attends to itself via the
    cache.
    """
    dh = cfg.d_head
    B = x_t.shape[0]
    q = _split_heads(dense(x_t, p.wq), pd.n_heads, dh)
    k_new = _split_heads(dense(x_t, p.wk), pd.n_kv_heads, dh)
    v_new = _split_heads(dense(x_t, p.wv), pd.n_kv_heads, dh)
    posb = torch.full((B, 1), pos, dtype=torch.int32, device=x_t.device)
    q = apply_rope(q, posb, cfg.rope_theta, cfg.rotary_pct)
    k_new = apply_rope(k_new, posb, cfg.rope_theta, cfg.rotary_pct)
    return q, k_new[:, 0], v_new[:, 0]


def gqa_attend_decode(
    q: torch.Tensor,  # [B, 1, Hq, Dh]
    k_cache: torch.Tensor,  # [B, S, Hkv, Dh]
    v_cache: torch.Tensor,
    kv_pos: torch.Tensor,  # [S] positions of the slots (-1 = empty slot)
    pos: int,  # the current decode position
    cfg: ArchConfig,
    pd: PaddedDims,
    *,
    window: int = 0,
    group=None,
) -> torch.Tensor:
    """Decode attention over the cache's valid slots (``0 <= kv_pos <=
    pos``, and inside ``window``) → heads [B,1,Hq·Dh]; the scale divides
    the scores after the product, as in the reference. Under a mesh the
    cache is this rank's slots and ``group`` the ranks that hold the
    others."""
    dh = cfg.d_head
    B = q.shape[0]
    hq, hkv = pd.n_heads, pd.n_kv_heads
    G = hq // hkv
    qh = q.reshape(B, hkv, G, dh).float()
    s = torch.einsum("bkgd,bskd->bkgs", qh, k_cache.float())
    s = s / math.sqrt(dh)
    valid = (kv_pos >= 0) & (kv_pos <= pos)
    if window:
        valid = valid & (kv_pos > pos - window)
    s = torch.where(valid[None, None, None, :], s, NEG)
    o, m, l = _partial_softmax(s, v_cache.transpose(1, 2)[:, :, None, :, :])
    o = _combine_over_axis(o, m, l, group)
    return o.to(q.dtype).reshape(B, 1, hq * dh)  # caller applies wo


# ---------------------------------------------------------------- MLA --------


class MLA(KeepFloat32):
    """The reference's eight leaves, ``[d_in, d_out]`` each but the norm
    scales: ``wq_a`` ``[d, rq]``, ``q_a_norm`` ``[rq]``, ``wq_b`` ``[rq,
    H·(dn+dr)]``, ``wkv_a`` ``[d, rkv+dr]``, ``kv_a_norm`` ``[rkv]``,
    ``wk_b`` ``[rkv, H·dn]``, ``wv_b`` ``[rkv, H·dv]``, ``wo`` ``[H·dv,
    d]``; the two norm scales stay float32."""

    FLOAT32 = ("q_a_norm", "kv_a_norm")
    NAMES = ("wq_a", "q_a_norm", "wq_b", "wkv_a", "kv_a_norm", "wk_b", "wv_b", "wo")

    def __init__(self, **leaves: torch.Tensor):
        super().__init__()
        if sorted(leaves) != sorted(self.NAMES):
            raise ValueError(f"MLA takes the leaves {self.NAMES}, got {sorted(leaves)}")
        for name in self.NAMES:
            setattr(self, name, nn.Parameter(leaves[name]))


def init_mla(cfg: ArchConfig, pd: PaddedDims, *, generator, device, dtype) -> MLA:
    d, h = cfg.d_model, pd.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    kw = dict(generator=generator, device=device, dtype=dtype)
    return MLA(
        wq_a=dense_init(d, rq, **kw),
        q_a_norm=torch.ones((rq,), device=device, dtype=torch.float32),
        wq_b=dense_init(rq, h * (dn + dr), **kw),
        wkv_a=dense_init(d, rkv + dr, **kw),
        kv_a_norm=torch.ones((rkv,), device=device, dtype=torch.float32),
        wk_b=dense_init(rkv, h * dn, **kw),
        wv_b=dense_init(rkv, h * dv, **kw),
        wo=dense_init(h * dv, d, **kw),
    )


def mla_axes(cfg: ArchConfig, pd: PaddedDims) -> dict:
    return {
        "wq_a": ("fsdp", None),
        "q_a_norm": (None,),
        "wq_b": (None, "heads"),
        "wkv_a": ("fsdp", None),
        "kv_a_norm": (None,),
        "wk_b": (None, "heads"),
        "wv_b": (None, "heads"),
        "wo": ("heads", "fsdp"),
    }


def _mla_qkv(p: MLA, x: torch.Tensor, positions: torch.Tensor, cfg: ArchConfig, pd: PaddedDims):
    """(q_nope, q_rope [B,S,H,dn/dr], c_kv [B,S,rkv], k_rope [B,S,dr]); both
    norms take the default eps 1e-6, not ``cfg.norm_eps``, as the
    reference's do."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    q = dense(rmsnorm(dense(x, p.wq_a), p.q_a_norm), p.wq_b).reshape(B, S, pd.n_heads, dn + dr)
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)
    kv = dense(x, p.wkv_a)
    c_kv = rmsnorm(kv[..., : cfg.kv_lora_rank], p.kv_a_norm)
    k_rope = apply_rope(kv[..., cfg.kv_lora_rank :][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(
    p: MLA,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ArchConfig,
    pd: PaddedDims,
    *,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    window: int = 0,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Materialized (prefill) MLA → (output [B,S,D], (c_kv, k_rope) for the
    cache). Keys are [k_nope, k_rope broadcast over the heads], values are
    ``v_head_dim`` wide, the scale 1/sqrt(dn + dr)."""
    B, S, _ = x.shape
    h = pd.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, positions, cfg, pd)
    k_nope = dense(c_kv, p.wk_b).reshape(B, S, h, dn)
    v = dense(c_kv, p.wv_b).reshape(B, S, h, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, h, dr)], dim=-1)
    o = flash_attention(
        q, k, v, positions, positions,
        causal=True, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk, scale=1.0 / math.sqrt(dn + dr),
    )
    return dense(o.reshape(B, S, h * dv), p.wo), (c_kv, k_rope)


def mla_project_decode(
    p: MLA, x_t: torch.Tensor, pos: int, cfg: ArchConfig, pd: PaddedDims
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode projections: q_nope [B,1,H,dn], q_rope [B,1,H,dr], and the
    cache entries of slot ``pos``, c_new [B,rkv] and krope_new [B,dr]."""
    posb = torch.full((x_t.shape[0], 1), pos, dtype=torch.int32, device=x_t.device)
    q_nope, q_rope, c_new, krope_new = _mla_qkv(p, x_t, posb, cfg, pd)
    return q_nope, q_rope, c_new[:, 0], krope_new[:, 0]


def mla_attend_decode(
    q_eff: torch.Tensor,  # [B, 1, H, rkv]: q_nope absorbed through W_uk
    q_rope: torch.Tensor,  # [B, 1, H, dr]
    ckv_cache: torch.Tensor,  # [B, S, rkv]
    krope_cache: torch.Tensor,  # [B, S, dr]
    kv_pos: torch.Tensor,  # [S]
    pos: int,
    cfg: ArchConfig,
    pd: PaddedDims,
    *,
    group=None,
) -> torch.Tensor:
    """Absorbed-form MLA decode → the latent context [B, H, rkv] in the
    cache's type; the caller applies W_uv and ``wo``. ``group`` as in
    ``gqa_attend_decode``."""
    q_eff = q_eff[:, 0].float()
    s_nope = torch.einsum("bhr,bsr->bhs", q_eff, ckv_cache.float())
    s_rope = torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(), krope_cache.float())
    s = (s_nope + s_rope) / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    valid = (kv_pos >= 0) & (kv_pos <= pos)
    s = torch.where(valid[None, None, :], s, NEG)
    o, m, l = _partial_softmax(s, ckv_cache, "bhs,bsr->bhr")  # over the latent
    return _combine_over_axis(o, m, l, group).to(krope_cache.dtype)
