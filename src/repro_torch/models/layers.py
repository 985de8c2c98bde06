"""Shared neural layers of the port (plain PyTorch functions on tensors).

The counterpart of ``repro.models.layers``, op for op. Conventions:
activations ``[B, S, D]``; attention heads ``[B, S, H, Dh]``; dense
weights kept in the reference's ``[d_in, d_out]`` layout, so ``dense`` is
``x @ w``; norm scales float32. Products accumulate in float32 and are
cast back to the input's type, as the reference's
``preferred_element_type=float32`` does: on the card that holds when
cuBLAS may not reduce bfloat16 products in reduced precision, which the
serving steps ensure (``repro_torch.serving.steps.exact_matmul``).

Under a mesh the functions take DTensors. A reshape that splits a
sharded dimension is shardable only when the shards divide its outer
factor (a dimension of 2 KV heads cannot stay sharded over 4 ranks);
``fit_split`` gathers such a dimension first, an explicit
``redistribute`` beside each of those reshapes (the heads of
``attention._split_heads``). ``flash_attention`` runs in a region on
local shards: every (sequence, head) pair is independent, so q, k and v
keep their batch shards and, where the shards divide the KV heads, their
head shards (each rank then holds whole query groups), are gathered on
every other dimension (``redistribute``), and the chunk loop runs on
``to_local()`` shards; the output comes back as a DTensor placed as q
(``from_local``; both are differentiable).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "KeepFloat32",
    "dense_init",
    "rmsnorm_init",
    "rmsnorm",
    "dense",
    "rope_freqs",
    "apply_rope",
    "mlp_apply",
    "flash_attention",
    "combine_partial_softmax",
    "NEG",
    "INT32_MAX",
    "fit_split",
    "contiguous_stride",
    "rows",
    "region_in",
    "region_out",
    "row_partial",
    "replicated",
]

#: the score given to masked positions (finite, as in the reference)
NEG = -1e30
INT32_MAX = 2**31 - 1


class KeepFloat32(nn.Module):
    """A module whose parameters named in ``FLOAT32`` stay float32 whatever
    ``Module.to`` casts the rest of the model to, as the reference keeps its
    norm scales, the MoE router and the SSD decay parameters."""

    FLOAT32: tuple[str, ...] = ()

    def _apply(self, fn, recurse=True):
        keep = {id(self._parameters[n]) for n in self.FLOAT32 if self._parameters.get(n) is not None}

        def keep_float32(t):
            out = fn(t)
            if id(t) in keep and out.dtype != torch.float32:
                return t.to(device=out.device, dtype=torch.float32)
            return out

        return super()._apply(keep_float32, recurse)


def fit_split(x: torch.Tensor, dim: int, outer: int) -> torch.Tensor:
    """``x``, ready for a reshape that splits dimension ``dim`` into
    ``outer`` times the rest: a DTensor whose shards of ``dim`` do not
    divide ``outer`` gets that dimension gathered; anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    on = [i for i, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]
    shards = math.prod(x.device_mesh.size(i) for i in on)
    if outer % shards == 0:
        return x
    pl = [Replicate() if i in on else p for i, p in enumerate(x.placements)]
    return x.redistribute(x.device_mesh, pl)


# -- init ---------------------------------------------------------------------


def dense_init(d_in: int, d_out: int, *, generator, device, dtype) -> torch.Tensor:
    """Truncated-normal fan-in init on [-2, 2] times 1/sqrt(d_in), drawn in
    float32 on ``generator`` and cast to ``dtype``."""
    w = torch.empty((d_in, d_out), device=device, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.div_(math.sqrt(d_in)).to(dtype)


def rmsnorm_init(d: int, *, device) -> torch.Tensor:
    return torch.ones((d,), device=device, dtype=torch.float32)


# -- primitives -----------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * scale
    return y.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last axis of ``x``, accumulated in float32, in
    ``x``'s type."""
    return torch.matmul(x, w)


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation; torch's to the erf form
    return F.silu if name == "silu" else (lambda x: F.gelu(x, approximate="tanh"))


# -- RoPE -----------------------------------------------------------------------


def rope_freqs(d_rot: int, theta: float, *, device=None) -> torch.Tensor:
    """Inverse frequencies for a rotary block of width d_rot (even)."""
    return 1.0 / (theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32, device=device) / d_rot))


def apply_rope(
    x: torch.Tensor,  # [B, S, H, Dh]
    positions: torch.Tensor,  # [B, S] int
    theta: float,
    rotary_pct: float = 1.0,
) -> torch.Tensor:
    """Rotate the first ``rotary_pct`` of head dims by halves (not
    interleaved pairs); angles in float32, the other dims pass through.

    ``rotary_pct=0.5`` reproduces ChatGLM3's 2-d RoPE.
    """
    dh = x.shape[-1]
    d_rot = int(dh * rotary_pct)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    x_rot, x_pass = x[..., :d_rot], x[..., d_rot:]
    inv = replicated(rope_freqs(d_rot, theta, device=x.device), positions)  # [d_rot/2]
    ang = positions.float()[..., None] * inv  # [B, S, d_rot/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rot.to(x.dtype), x_pass], dim=-1)


# -- MLP --------------------------------------------------------------------------


def mlp_apply(p, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    """``p`` holds the weights ``wi``, ``wo`` and, when gated, ``wg`` as
    attributes."""
    h = dense(x, p.wi)
    if gated:
        h = _act(act)(dense(x, p.wg)) * h
    else:
        h = _act(act)(h)
    return dense(h, p.wo)


# -- chunked (flash-style) attention -----------------------------------------------


def combine_partial_softmax(o_a, m_a, l_a, o_b, m_b, l_b):
    """Merge two partial softmax accumulations (o: weighted values,
    m: running max, l: running denominator)."""
    m = torch.maximum(m_a, m_b)
    sa = torch.exp(m_a - m)
    sb = torch.exp(m_b - m)
    return o_a * sa[..., None] + o_b * sb[..., None], m, l_a * sa + l_b * sb


def _pad_seq(x: torch.Tensor, s_pad: int, fill=0) -> torch.Tensor:
    pad = s_pad - x.shape[1]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[1] = pad
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=1)


def rows(x) -> list:
    """Placements that keep ``x``'s batch shards (dimension 0) and
    replicate every other dimension."""
    from torch.distributed.tensor import Replicate, Shard

    return [p if p == Shard(0) else Replicate() for p in x.placements]


def region_in(t: torch.Tensor, mesh, placements, grad=None) -> torch.Tensor:
    """This rank's shard of ``t`` placed by ``placements``: a DTensor
    redistributed, a plain tensor (the same on every rank) sliced.
    ``grad`` are the placements of the shard's gradient when they differ
    from ``placements`` (``Partial`` where ranks that hold the same shard
    add different contributions)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        return t.redistribute(mesh, placements).to_local(grad_placements=grad)
    return distribute_tensor(t, mesh, placements, src_data_rank=None).to_local()


def row_partial(x) -> list:
    """The gradient placements of a whole tensor that a region uses on
    ``x``'s batch rows: summed over the ranks that hold other rows,
    replicated over the rest."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return [Partial() if p == Shard(0) else Replicate() for p in x.placements]


def replicated(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` as a replicated DTensor on ``like``'s mesh when ``like`` is a
    DTensor, else ``t``: a plain tensor that meets DTensors in an op the
    backward replays (a mask, RoPE's frequencies), where
    ``implicit_replication`` does not reach."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(like, DTensor):
        return t
    return DTensor.from_local(t, like.device_mesh, [Replicate()] * like.device_mesh.ndim, run_check=False)


def region_out(t: torch.Tensor, mesh, placements, shape) -> torch.Tensor:
    """The DTensor of global ``shape`` whose shard on this rank is ``t``."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    return DTensor.from_local(t.contiguous(), mesh, placements, shape=shape, stride=contiguous_stride(shape))


def flash_attention(q, k, v, q_positions, kv_positions, **kw) -> torch.Tensor:
    """``_flash_attention``; on DTensors in the region the module docstring
    sets out."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(q, DTensor):
        return _flash_attention(q, k, v, q_positions, kv_positions, **kw)
    mesh, Hkv = q.device_mesh, k.shape[2]
    pl = []
    for i, p in enumerate(q.placements):
        keep = isinstance(p, Shard) and (p.dim == 0 or (p.dim == 2 and Hkv % mesh.size(i) == 0))
        pl.append(p if keep else Replicate())
    o = _flash_attention(*(region_in(t, mesh, pl) for t in (q, k, v)),
                         *(region_in(t, mesh, rows(q)) for t in (q_positions, kv_positions)), **kw)
    return region_out(o, mesh, pl, (*q.shape[:3], v.shape[-1]))


def contiguous_stride(shape) -> tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, Dh]
    k: torch.Tensor,  # [B, Skv, Hkv, Dh]
    v: torch.Tensor,  # [B, Skv, Hkv, Dv]
    q_positions: torch.Tensor,  # [B, Sq] global positions of the queries
    kv_positions: torch.Tensor,  # [B, Skv]
    *,
    causal: bool = True,
    window: int = 0,  # sliding window size; 0 = unbounded
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    scale: float | None = None,
    score_bias: float = 0.0,
) -> torch.Tensor:
    """Online-softmax attention, O(q_chunk·kv_chunk) score memory.

    GQA reshapes q to [B, Sq, Hkv, G, Dh], so query head h reads KV head
    h // G. The outer loop runs over q chunks, the inner over kv chunks
    carrying (o, m, l) in float32; every chunk pair is computed and
    masked, as in the reference. Masks come from global positions: padded
    queries sit at -1 and padded keys at INT32_MAX, masked scores are
    -1e30, fully masked rows are zeroed and the output is divided by
    max(l, 1e-30).
    """
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    Dv = v.shape[-1]
    G = Hq // Hkv
    sc = scale if scale is not None else 1.0 / math.sqrt(Dh)

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    nq = -(-Sq // q_chunk)
    nk = -(-Skv // kv_chunk)
    Sq_pad, Skv_pad = nq * q_chunk, nk * kv_chunk

    qp = _pad_seq(q, Sq_pad).float().reshape(B, nq, q_chunk, Hkv, G, Dh)
    qpos = _pad_seq(q_positions, Sq_pad, fill=-1).reshape(B, nq, q_chunk)
    kp = _pad_seq(k, Skv_pad).float().reshape(B, nk, kv_chunk, Hkv, Dh)
    vp = _pad_seq(v, Skv_pad).float().reshape(B, nk, kv_chunk, Hkv, Dv)
    kpos = _pad_seq(kv_positions, Skv_pad, fill=INT32_MAX).reshape(B, nk, kv_chunk)

    outs = []
    for i in range(nq):
        qb, qposb = qp[:, i], qpos[:, i]  # [B, qc, Hkv, G, Dh], [B, qc]
        qcol = qposb[:, None, None, :, None]
        o = torch.zeros((B, Hkv, G, q_chunk, Dv), dtype=torch.float32, device=q.device)
        m = torch.full((B, Hkv, G, q_chunk), NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hkv, G, q_chunk), dtype=torch.float32, device=q.device)
        for j in range(nk):
            kb, vb, krow = kp[:, j], vp[:, j], kpos[:, j][:, None, None, None, :]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * sc + score_bias
            mask = qcol >= 0
            if causal:
                mask = mask & (krow <= qcol)
            else:
                mask = mask & (krow < INT32_MAX)
            if window:
                mask = mask & (krow > qcol - window)
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            # dead rows (fully masked) have m_new == -1e30, so p == 1: zero them
            p = torch.where(m_new[..., None] <= NEG / 2, 0.0, p)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
            m = m_new
        outs.append(o / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(outs, dim=3).reshape(B, Hkv, G, Sq_pad, Dv)  # [B, Hkv, G, nq·qc, Dv]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq_pad, Hq, Dv)
    return out[:, :Sq].to(q.dtype)
