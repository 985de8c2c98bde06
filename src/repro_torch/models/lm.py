"""Decoder LM of the port: the counterpart of ``repro.models.lm``'s
``init_lm``, ``forward_train``, ``init_cache``, ``prefill`` and
``decode_step`` for every registered architecture: the "attn" stacks
(GQA or MLA), DeepSeek-V3's dense prefix and MoE stacks, qwen2-moe's MoE
stack, Mamba-2's SSD stack and Hymba's hybrid stack with its per-layer
windows.

Layers are organized into stacks as in the reference; where the
reference stacks each stack's layers on a leading axis and scans them,
``LM`` holds one ``nn.ModuleList`` of blocks per stack and loops. The
cache is the reference's dict of stacked tensors ``"<stack>/<entry>"``
(``k``/``v`` ``[L, B, S_alloc, Hkv, Dh]``, ``ckv``/``krope`` ``[L, B,
S_alloc, r]``, ``conv_x``/``conv_bc`` ``[L, B, K-1, C]`` and the float32
``state`` ``[L, B, H, P, N]``); ``decode_step`` writes it in place.

Under a mesh (``ctx``, a ``parallel.sharding.MeshCtx``) the parameters
are DTensors placed by ``lm_axes`` (``ft.elastic.reshard_tree``), the
inputs are placed by the steps, and the functions here run with
``implicit_replication`` (plain tensors such as positions and masks act
as replicated); DTensor's sharding propagation then takes the place of
XLA's partitioner. The lookup in a vocab-sharded embedding runs in a
region (``_lookup``): DTensor's own gives a masked partial sum that it
can reduce only once, and whose gradient cannot come back from a
``Partial``; each rank looks up the rows it holds, zero elsewhere, and
the sum over the vocabulary's shards is a ``redistribute``.
DTensor shards no ``gather`` over a sharded dimension, so the loss takes
the label's logit from vocab-sharded logits as a masked sum (one term,
exact). The cache is a dict of DTensors placed by
``cache_axes``; prefill seeds it shard by shard and decode writes each
rank's shard in place (``blocks._attend_sharded``).

``forward_train`` is the training loss: cross-entropy over the labels,
the MoE auxiliary loss and, for DeepSeek-V3, the multi-token-prediction
head's loss at weight 0.3. Its ``remat`` wraps each block of the stacks
in ``torch.utils.checkpoint``: ``full`` keeps only the block's input,
``dots`` also the outputs of its matrix products without batch
dimensions (``aten.mm``, ``aten.addmm``: the projections, the MLP and
the router; not the attention scores or the expert products), as the
reference's ``dots_with_no_batch_dims_saveable`` does.
"""

from __future__ import annotations

import dataclasses
import functools

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.parallel.padding import PaddedDims, padded_dims
from repro_torch.parallel.sharding import logical_to_spec, map_axes
from . import blocks as blk
from . import ssm as ssm_mod
from .config import ArchConfig
from .layers import (NEG, contiguous_stride, dense, dense_init, region_in, region_out, replicated, rmsnorm_init, row_partial,
                     rows)

__all__ = [
    "LM",
    "MTP",
    "StackSpec",
    "stacks_for",
    "init_lm",
    "lm_axes",
    "init_cache",
    "cache_axes",
    "forward_train",
    "REMATS",
    "prefill",
    "decode_step",
    "torch_dtype",
]


@dataclasses.dataclass(frozen=True)
class StackSpec:
    name: str
    kind: str  # "attn" | "moe" | "ssm" | "hybrid"
    n_layers: int
    d_ff: int  # dense-MLP width inside the block (0 = none)


def stacks_for(cfg: ArchConfig) -> list[StackSpec]:
    if cfg.family == "ssm":
        return [StackSpec("main", "ssm", cfg.n_layers, 0)]
    if cfg.family == "hybrid":
        return [StackSpec("main", "hybrid", cfg.n_layers, cfg.d_ff)]
    if cfg.is_moe:
        stacks = []
        if cfg.first_k_dense:
            stacks.append(StackSpec("dense", "attn", cfg.first_k_dense, cfg.dense_d_ff))
        stacks.append(StackSpec("moe", "moe", cfg.n_layers - cfg.first_k_dense, 0))
        return stacks
    return [StackSpec("main", "attn", cfg.n_layers, cfg.d_ff)]


def _windows_for(cfg: ArchConfig, spec: StackSpec, layer_offset: int) -> list[int] | int:
    """Per-layer sliding windows; 0 → global (no window mask)."""
    if cfg.sliding_window <= 0:
        return 0
    glob = set(cfg.global_layers)
    return [
        blk.GLOBAL_WINDOW if (layer_offset + i) in glob else cfg.sliding_window
        for i in range(spec.n_layers)
    ]


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


# ---------------------------------------------------------------- model -------


class MTP(nn.Module):
    """DeepSeek-V3's multi-token-prediction head: ``proj`` ``[2D, D]``, an
    "attn" ``block`` and ``norm``. Only ``forward_train`` reads it."""

    def __init__(self, proj: torch.Tensor, block: blk.Block, norm: blk.RMSNorm):
        super().__init__()
        self.proj, self.block, self.norm = nn.Parameter(proj), block, norm


class LM(nn.Module):
    """The weights of one architecture: ``embed`` ``[V_pad, D]`` (token
    inputs), ``stacks[name][layer]`` blocks, ``final_norm``, untied
    ``head`` ``[D, V_pad]`` or ``[CB, D, V_pad]``, and ``mtp`` when the
    config has one, padded for tensor-parallel degree ``tp``. The
    activations take the blocks' weight type; norm scales, the router and
    the SSD decay parameters stay float32."""

    def __init__(self, cfg: ArchConfig, embed: torch.Tensor | None, stacks: dict[str, list[blk.Block]],
                 final_norm: blk.RMSNorm, head: torch.Tensor | None, mtp: MTP | None = None, *, tp: int = 1):
        super().__init__()
        self.cfg, self.tp, self.pd = cfg, tp, padded_dims(cfg, tp)
        self.embed = None if embed is None else nn.Parameter(embed)
        self.stacks = nn.ModuleDict({name: nn.ModuleList(layers) for name, layers in stacks.items()})
        self.final_norm = final_norm
        self.head = None if head is None else nn.Parameter(head)
        self.mtp = mtp

    @property
    def dtype(self) -> torch.dtype:
        """The weights' (and activations') type: the first parameter that is
        not float32, else float32."""
        return next((p.dtype for p in self.parameters() if p.dtype != torch.float32), torch.float32)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def init_lm(cfg: ArchConfig, *, generator: torch.Generator | None, device, dtype=None, tp: int = 1) -> LM:
    """Random weights from ``generator`` with the reference's distributions:
    dense weights truncated normal on [-2, 2] over sqrt(d_in), the
    embedding normal times 0.02, norm scales ones in float32, the SSD's
    parameters as ``ssm.init_ssm`` draws them; padded for tensor-parallel
    degree ``tp`` (``parallel.padding.padded_dims``), the pad heads zero.
    ``dtype`` defaults to ``cfg.dtype``; ``device`` must be the
    generator's. On the ``meta`` device (``generator=None``) it allocates
    nothing: the shapes and types alone."""
    dtype = torch_dtype(dtype or cfg.dtype)
    pd = padded_dims(cfg, tp)
    kw = dict(generator=generator, device=device, dtype=dtype, tp=tp)
    embed = None
    if cfg.input_mode == "tokens":
        embed = torch.empty((pd.vocab_size, cfg.d_model), device=device, dtype=torch.float32)
        embed = (embed.normal_(generator=generator) * 0.02).to(dtype)
    stacks = {
        spec.name: [blk.init_block(cfg, pd, spec.kind, spec.d_ff, **kw) for _ in range(spec.n_layers)]
        for spec in stacks_for(cfg)
    }
    final_norm = blk.RMSNorm(rmsnorm_init(cfg.d_model, device=device))
    head = None
    if not cfg.tie_embeddings:
        dkw = dict(generator=generator, device=device, dtype=dtype)
        if cfg.n_codebooks > 1:
            head = torch.stack([dense_init(cfg.d_model, pd.vocab_size, **dkw) for _ in range(cfg.n_codebooks)])
        else:
            head = dense_init(cfg.d_model, pd.vocab_size, **dkw)
    mtp = None
    if cfg.mtp:
        mtp = MTP(
            dense_init(2 * cfg.d_model, cfg.d_model, generator=generator, device=device, dtype=dtype),
            blk.init_block(cfg, pd, "attn", cfg.dense_d_ff or cfg.d_ff or 4 * cfg.d_model, **kw),
            blk.RMSNorm(rmsnorm_init(cfg.d_model, device=device)),
        )
    return LM(cfg, embed, stacks, final_norm, head, mtp, tp=tp)


def lm_axes(cfg: ArchConfig, tp: int = 1, *, serve: bool = False, ep_over_data: bool = False) -> dict:
    """Logical sharding axes of the parameters, keyed as the reference's
    ``init_lm`` tree (a stack leaf's first axis is ``"layers"``).
    ``serve=True`` switches to inference-time placement: no FSDP gathers
    ("fsdp" and "expert_mlp" replicated); ``ep_over_data`` also spreads
    the experts over (data, model), global EP (the caller checks that the
    expert count divides the mesh)."""
    pd = padded_dims(cfg, tp)
    ax: dict = {}
    if cfg.input_mode == "tokens":
        ax["embed"] = ("vocab", None)
    for spec in stacks_for(cfg):
        bax = blk.block_axes(cfg, pd, tp, spec.kind, spec.d_ff)
        ax[f"stack_{spec.name}"] = map_axes(lambda axes: ("layers",) + tuple(axes), bax)
    ax["final_norm"] = (None,)
    if not cfg.tie_embeddings:
        ax["head"] = (None, "fsdp", "vocab") if cfg.n_codebooks > 1 else ("fsdp", "vocab")
    if cfg.mtp:
        ax["mtp"] = {
            "proj": ("fsdp", None),
            "block": blk.block_axes(cfg, pd, tp, "attn", cfg.dense_d_ff or cfg.d_ff or 4 * cfg.d_model),
            "norm": (None,),
        }
    if serve:
        def _serve_axes(axes):
            return tuple(
                None if a in ("fsdp", "expert_mlp")
                else ("experts_serve" if (a == "experts" and ep_over_data) else a)
                for a in axes
            )

        ax = map_axes(_serve_axes, ax)
    return ax


def mesh_ops(ctx):
    """The context the model's functions run in: under a mesh plain tensors
    act as replicated DTensors (``implicit_replication``)."""
    if ctx is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


# ---------------------------------------------------------------- embed/head ---


def _embed_in(model: LM, batch: dict) -> torch.Tensor:
    cfg = model.cfg
    if cfg.input_mode == "tokens":
        x = _lookup(batch["tokens"], model.embed)
    else:
        x = batch["embeds"].to(model.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(float(cfg.d_model), dtype=torch.float32).sqrt().to(x.dtype)
    return x


def _lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding``; under a mesh a region over the table's own shards
    (module docstring)."""
    from torch.distributed.tensor import Partial, Shard

    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    pl = rows(tokens)
    on = [i for i, p in enumerate(table.placements) if p == Shard(0)]  # the vocabulary's shards
    V, n = table.shape[0], 1
    for i in on:
        n *= mesh.size(i)
    off = 0
    for i in on:  # major to minor, as Shard splits
        off = off * mesh.size(i) + mesh.get_local_rank(i)
    off *= -(-V // n)
    # the table's gradient: its own shards, summed over the ranks of other rows
    local = table.to_local(grad_placements=[Shard(0) if i in on else g for i, g in enumerate(row_partial(tokens))])
    t = region_in(tokens, mesh, pl) - off
    hit = (t >= 0) & (t < local.shape[0])
    x = F.embedding(torch.where(hit, t, 0), local) * hit[..., None].to(local.dtype)
    out_pl = [Partial() if i in on else p for i, p in enumerate(pl)]
    x = region_out(x, mesh, out_pl, (*tokens.shape, table.shape[1]))
    return x.redistribute(mesh, pl)


def _logits(model: LM, x: torch.Tensor) -> torch.Tensor:
    """x [..., D] → logits [..., V_pad] (or [..., CB, V_pad]); the padded
    vocabulary is masked to -1e30 so it never wins."""
    cfg, pd = model.cfg, model.pd
    if cfg.tie_embeddings:
        logits = dense(x, model.embed.T)
    elif cfg.n_codebooks > 1:
        logits = torch.einsum("...d,cdv->...cv", x, model.head).to(x.dtype)
    else:
        logits = dense(x, model.head)
    if pd.vocab_size != cfg.vocab_size:
        pad = replicated(torch.arange(pd.vocab_size, device=logits.device) >= cfg.vocab_size, logits)
        logits = logits.masked_fill(pad, NEG)
    return logits


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over the labels >= 0, in float32: (loss, the count
    of those labels, at least 1). logits [..., V], labels [...]."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    if isinstance(lf, DTensor):  # vocab-sharded: the label's logit as a masked sum, exact
        hit = replicated(torch.arange(lf.shape[-1], device=lf.device), lf) == labels.clamp(min=0).long()[..., None]
        ll = torch.where(hit, lf, 0.0).sum(-1)
    else:
        ll = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    valid = (labels >= 0).float()
    total = torch.clamp(valid.sum(), min=1.0)
    return torch.sum((lse - ll) * valid) / total, total


# ---------------------------------------------------------------- train --------


REMATS = ("none", "dots", "full")
#: the products ``dots`` keeps: those without batch dimensions
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS else CheckpointPolicy.PREFER_RECOMPUTE


def _run_block(block: blk.Block, x, positions, window: int, q_chunk: int, kv_chunk: int, remat: str, ctx):
    """One block's ``forward_train`` under the ``remat`` policy."""
    fn = functools.partial(block.forward_train, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk, ctx=ctx)
    if remat == "none":
        return fn(x, positions)
    kw = {} if remat == "full" else dict(context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                                       _save_products))
    return checkpoint(fn, x, positions, use_reentrant=False, **kw)


def forward_train(model: LM, batch: dict, ctx=None, *, remat: str = "dots", q_chunk: int = 512,
                  kv_chunk: int = 1024) -> tuple[torch.Tensor, dict]:
    """``{"tokens" | "embeds", "labels"}`` → (loss, metrics): the mean
    cross-entropy over labels >= 0 (labels ``[B, S]``, or ``[B, S, CB]``
    for multi-codebook archs) plus the MoE auxiliary loss, plus 0.3 times
    the MTP head's loss on the labels one position on when the model has
    one. ``metrics`` holds ``ce``, ``aux``, ``tokens`` (the count of
    labels) and, with MTP, ``mtp``. The pipeline-parallel schedule of
    the reference's ``pipeline_micro`` is ROADMAP item 7g."""
    if remat not in REMATS:
        raise ValueError(f"remat {remat!r}; known: {REMATS}")
    with mesh_ops(ctx):
        return _forward_train(model, batch, ctx, remat, q_chunk, kv_chunk)


def _forward_train(model: LM, batch: dict, ctx, remat: str, q_chunk: int, kv_chunk: int):
    cfg = model.cfg
    x = _embed_in(model, batch)
    B, S = x.shape[:2]
    positions = replicated(torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S), x)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    off = 0
    for spec in stacks_for(cfg):
        windows = _windows_for(cfg, spec, off)
        aux_stack = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, block in enumerate(model.stacks[spec.name]):
            window = windows if isinstance(windows, int) else windows[i]
            x, aux = _run_block(block, x, positions, window, q_chunk, kv_chunk, remat, ctx)
            aux_stack = aux_stack + aux
        aux_total = aux_total + aux_stack
        off += spec.n_layers

    h = model.final_norm(x, cfg.norm_eps)
    loss, n_tok = _xent(_logits(model, h), batch["labels"])
    metrics = {"ce": loss, "aux": aux_total, "tokens": n_tok}
    if model.mtp is not None:
        # predict token t+2: h_t joined with the embedding of token t+1
        mtp = model.mtp
        comb = torch.cat([h[:, :-1], _embed_in(model, batch)[:, 1:]], dim=-1)
        hm, _ = mtp.block.forward_train(dense(comb, mtp.proj), positions[:, :-1], window=0, q_chunk=q_chunk,
                                        kv_chunk=kv_chunk, ctx=ctx)
        mtp_loss, _ = _xent(_logits(model, mtp.norm(hm, cfg.norm_eps)), batch["labels"][:, 1:])
        metrics["mtp"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
    if isinstance(loss, DTensor):  # whole on every rank, which adds its own MoE statistic (``models.moe``)
        loss = loss.redistribute(loss.device_mesh, [Replicate()] * loss.device_mesh.ndim)
    return loss + aux_total, metrics


# ---------------------------------------------------------------- cache --------


#: the attention entries, written at their slot and padded to ``S_alloc``
SEQ_ENTRIES = ("k", "v", "ckv", "krope")


def _cache_entry_shapes(cfg: ArchConfig, pd: PaddedDims, spec: StackSpec, B: int, S: int, tp: int = 1):
    """(name, shape, float32 whatever the model's type, logical axes) per
    cache tensor of one stack, in the reference's order."""
    L = spec.n_layers
    out = []
    if spec.kind in ("attn", "moe", "hybrid"):
        seq = ("layers", "batch", "kv_seq", None)
        if cfg.attention == "mla":
            out += [("ckv", (L, B, S, cfg.kv_lora_rank), False, seq),
                    ("krope", (L, B, S, cfg.qk_rope_dim), False, seq)]
        else:
            kv = (L, B, S, pd.n_kv_heads, cfg.d_head)
            out += [("k", kv, False, seq + (None,)), ("v", kv, False, seq + (None,))]
    if spec.kind in ("ssm", "hybrid"):
        dims = ssm_mod.ssm_dims(cfg, tp)
        out += [
            ("conv_x", (L, B, cfg.ssm_conv - 1, dims["di"]), False, ("layers", "batch", None, "heads")),
            ("conv_bc", (L, B, cfg.ssm_conv - 1, 2 * dims["N"]), False, ("layers", "batch", None, None)),
            ("state", (L, B, dims["H_pad"], dims["P"], dims["N"]), True, ("layers", "batch", "heads", None, None)),
        ]
    return out


def init_cache(cfg: ArchConfig, B: int, S_alloc: int, *, device, dtype=None, tp: int = 1,
               ctx=None) -> dict[str, torch.Tensor]:
    """A zeroed cache for ``B`` sequences of ``S_alloc`` slots at
    tensor-parallel degree ``tp``, in ``dtype`` (default ``cfg.dtype``) but
    the SSD ``state``, float32. Under ``ctx`` (whose ``tp_size`` it takes)
    each entry is a DTensor placed by ``cache_axes``, and each rank
    allocates its own shard only; on the ``meta`` device nothing is
    allocated."""
    dtype = torch_dtype(dtype or cfg.dtype)
    if ctx is not None:
        from torch.distributed.tensor import zeros as dzeros

        tp = ctx.tp_size
    pd = padded_dims(cfg, tp)
    cache = {}
    for spec in stacks_for(cfg):
        for name, shape, f32, axes in _cache_entry_shapes(cfg, pd, spec, B, S_alloc, tp):
            dt = torch.float32 if f32 else dtype
            if ctx is None:
                cache[f"{spec.name}/{name}"] = torch.zeros(shape, device=device, dtype=dt)
            else:
                pl = ctx.placements(logical_to_spec(ctx, axes))
                cache[f"{spec.name}/{name}"] = dzeros(shape, dtype=dt, device_mesh=ctx.mesh, placements=pl)
    return cache


def cache_axes(cfg: ArchConfig, B: int, S_alloc: int, tp: int = 1) -> dict:
    """Logical axes of the cache entries: batch, then the sequence over
    ``model`` (SP) for the attention entries, the heads for the SSD's."""
    pd = padded_dims(cfg, tp)
    return {
        f"{spec.name}/{name}": axes
        for spec in stacks_for(cfg)
        for name, _, _, axes in _cache_entry_shapes(cfg, pd, spec, B, S_alloc, tp)
    }


def _entry_names(cfg: ArchConfig, spec: StackSpec) -> list[str]:
    return [e[0] for e in _cache_entry_shapes(cfg, padded_dims(cfg, 1), spec, 1, 1)]


def _layer_view(entry, i: int):
    """Layer ``i`` of a stacked cache entry: a view; under a mesh a DTensor
    over this rank's shard of it."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(entry, DTensor):
        return entry[i]
    pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in entry.placements]
    shape = entry.shape[1:]
    return DTensor.from_local(entry.to_local()[i], entry.device_mesh, pl, shape=shape,
                              stride=contiguous_stride(shape))


def _seed_entry(entry, i: int, value, S: int | None) -> None:
    """Write a prefill's cache entry of layer ``i`` into the stacked
    ``entry``; a sequence entry (``S`` given) fills its first ``S`` slots.
    Under a mesh each rank writes the slots it holds."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(entry, DTensor):
        if S is None:
            entry[i] = value
        else:
            entry[i, :, :S] = value
        return
    view = _layer_view(entry, i)
    if S is None:
        blk.write_entry(view, value)
        return
    # the whole prompt on this rank, its own slots kept
    mesh = view.device_mesh
    seq = [a for a, p in enumerate(view.placements) if p == Shard(1)]
    full = value.redistribute(mesh, [Replicate() if p == Shard(1) else p for p in view.placements]).to_local()
    local = view.to_local()
    base = mesh.get_local_rank(seq[0]) * -(-view.shape[1] // mesh.size(seq[0])) if seq else 0
    n = max(0, min(S - base, local.shape[1]))
    local[:, :n] = full[:, base : base + n]


# ---------------------------------------------------------------- prefill ------


def prefill(model: LM, batch: dict, ctx=None, *, s_alloc: int | None = None, q_chunk: int = 512,
            kv_chunk: int = 1024) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Full-prompt forward → (logits of the last position, the cache primed
    with the prompt: attention entries padded with zeros up to ``s_alloc``,
    the SSD entries as the prompt leaves them)."""
    with mesh_ops(ctx):
        cfg = model.cfg
        x = _embed_in(model, batch)
        B, S = x.shape[:2]
        s_alloc = s_alloc or S
        positions = replicated(torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S), x)
        cache = init_cache(cfg, B, s_alloc, device=x.device, dtype=x.dtype, tp=model.tp, ctx=ctx)
        off = 0
        for spec in stacks_for(cfg):
            windows = _windows_for(cfg, spec, off)
            names = _entry_names(cfg, spec)
            for i, block in enumerate(model.stacks[spec.name]):
                window = windows if isinstance(windows, int) else windows[i]
                x, entries = block(x, positions, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk, ctx=ctx)
                for name, entry in zip(names, entries):
                    _seed_entry(cache[f"{spec.name}/{name}"], i, entry, S if name in SEQ_ENTRIES else None)
            off += spec.n_layers
        h = model.final_norm(x[:, -1:], cfg.norm_eps)
        return _logits(model, h)[:, 0], cache


# ---------------------------------------------------------------- decode -------


def decode_step(model: LM, cache: dict[str, torch.Tensor], batch_t: dict, pos: int,
                ctx=None) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One token (``{"tokens": [B,1]}`` or ``{"embeds": [B,1,D]}``) at
    position ``pos`` → (logits [B, V(·CB)], the cache, written in place:
    the attention entries at slot ``pos``, the SSD entries whole)."""
    with mesh_ops(ctx):
        cfg = model.cfg
        x = _embed_in(model, batch_t)
        off = 0
        for spec in stacks_for(cfg):
            windows = _windows_for(cfg, spec, off)
            stack = [cache[f"{spec.name}/{name}"] for name in _entry_names(cfg, spec)]
            for i, block in enumerate(model.stacks[spec.name]):
                window = windows if isinstance(windows, int) else windows[i]
                x = block.decode(x, tuple(_layer_view(entry, i) for entry in stack), pos, window=window, ctx=ctx)
            off += spec.n_layers
        h = model.final_norm(x, cfg.norm_eps)
        return _logits(model, h)[:, 0], cache
