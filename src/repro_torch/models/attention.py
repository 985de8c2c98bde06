"""Attention of the port: GQA with RoPE variants and sliding windows.

The counterpart of the GQA half of ``repro.models.attention``:
  * full sequence (prefill): ``flash_attention`` (chunked online softmax
    in plain torch ops);
  * decode: one query token against the whole cache, its softmax partial
    (o, m, l) finished locally. The reference's cross-chip combine (a
    sequence-sharded cache under a mesh axis) comes with the port's
    ``DeviceMesh`` (ROADMAP item 7f).

MLA (DeepSeek-V3) comes in a later slice (item 7c).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.parallel.padding import PaddedDims
from .config import ArchConfig
from .layers import NEG, apply_rope, dense, dense_init, flash_attention

__all__ = [
    "MLA_SLICE",
    "GQA",
    "init_gqa",
    "gqa_forward",
    "gqa_project_decode",
    "gqa_attend_decode",
]

MLA_SLICE = "MLA (DeepSeek-V3) comes in a later slice of the port (ROADMAP item 7c)"


class GQA(nn.Module):
    """The four projections ``wq``, ``wk``, ``wv``, ``wo``, each
    ``[d_in, d_out]`` as in the reference."""

    def __init__(self, wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (nn.Parameter(w) for w in (wq, wk, wv, wo))


def init_gqa(cfg: ArchConfig, pd: PaddedDims, *, generator, device, dtype) -> GQA:
    if cfg.attention == "mla":
        raise NotImplementedError(MLA_SLICE)
    d, dh = cfg.d_model, cfg.d_head
    hq, hkv = pd.n_heads, pd.n_kv_heads
    kw = dict(generator=generator, device=device, dtype=dtype)
    wq = dense_init(d, hq * dh, **kw)
    if pd.n_heads != cfg.n_heads:  # zero-out padded q heads
        wq = wq.reshape(d, hq, dh)
        wq[:, cfg.n_heads :, :] = 0
        wq = wq.reshape(d, hq * dh)
    return GQA(wq, dense_init(d, hkv * dh, **kw), dense_init(d, hkv * dh, **kw), dense_init(hq * dh, d, **kw))


def _split_heads(x: torch.Tensor, n_heads: int, d_head: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, d_head)


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


def _partial_softmax(scores: torch.Tensor, values: torch.Tensor):
    """scores [..., S], values [..., S, Dv] → (o, m, l) partials (fp32)."""
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    p = torch.where(m[..., None] <= NEG / 2, 0.0, p)
    l = p.sum(dim=-1)
    o = torch.einsum("...k,...kd->...d", p, values.float())
    return o, m, l


def _combine_local(o: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The reference's ``_combine_over_axis`` with ``axis_name=None``."""
    return o / torch.clamp(l[..., None], min=1e-30)


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
) -> torch.Tensor:
    """Decode attention over the cache's valid slots (``0 <= kv_pos <=
    pos``, and inside ``window``) → heads [B,1,Hq·Dh]; the scale divides
    the scores after the product, as in the reference."""
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
    o, _, l = _partial_softmax(s, v_cache.transpose(1, 2)[:, :, None, :, :])
    o = _combine_local(o, l)
    return o.to(q.dtype).reshape(B, 1, hq * dh)  # caller applies wo
