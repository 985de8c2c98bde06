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

import torch
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.parallel.padding import PaddedDims, padded_dims
from . import blocks as blk
from . import ssm as ssm_mod
from .config import ArchConfig
from .layers import NEG, dense, dense_init, rmsnorm_init

__all__ = [
    "LM",
    "MTP",
    "StackSpec",
    "stacks_for",
    "init_lm",
    "init_cache",
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
    config has one. The activations take the blocks' weight type; norm
    scales, the router and the SSD decay parameters stay float32."""

    def __init__(self, cfg: ArchConfig, embed: torch.Tensor | None, stacks: dict[str, list[blk.Block]],
                 final_norm: blk.RMSNorm, head: torch.Tensor | None, mtp: MTP | None = None):
        super().__init__()
        self.cfg, self.pd = cfg, padded_dims(cfg, 1)
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


def init_lm(cfg: ArchConfig, *, generator: torch.Generator, device, dtype=None) -> LM:
    """Random weights from ``generator`` with the reference's distributions:
    dense weights truncated normal on [-2, 2] over sqrt(d_in), the
    embedding normal times 0.02, norm scales ones in float32, the SSD's
    parameters as ``ssm.init_ssm`` draws them. ``dtype`` defaults to
    ``cfg.dtype``; ``device`` must be the generator's."""
    dtype = torch_dtype(dtype or cfg.dtype)
    pd = padded_dims(cfg, 1)
    kw = dict(generator=generator, device=device, dtype=dtype)
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
        if cfg.n_codebooks > 1:
            head = torch.stack([dense_init(cfg.d_model, pd.vocab_size, **kw) for _ in range(cfg.n_codebooks)])
        else:
            head = dense_init(cfg.d_model, pd.vocab_size, **kw)
    mtp = None
    if cfg.mtp:
        mtp = MTP(
            dense_init(2 * cfg.d_model, cfg.d_model, **kw),
            blk.init_block(cfg, pd, "attn", cfg.dense_d_ff or cfg.d_ff or 4 * cfg.d_model, **kw),
            blk.RMSNorm(rmsnorm_init(cfg.d_model, device=device)),
        )
    return LM(cfg, embed, stacks, final_norm, head, mtp)


# ---------------------------------------------------------------- embed/head ---


def _embed_in(model: LM, batch: dict) -> torch.Tensor:
    cfg = model.cfg
    if cfg.input_mode == "tokens":
        x = model.embed[batch["tokens"]]
    else:
        x = batch["embeds"].to(model.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(float(cfg.d_model), dtype=torch.float32).sqrt().to(x.dtype)
    return x


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
        pad = torch.arange(pd.vocab_size, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, NEG)
    return logits


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over the labels >= 0, in float32: (loss, the count
    of those labels, at least 1). logits [..., V], labels [...]."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
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


def _run_block(block: blk.Block, x, positions, window: int, q_chunk: int, kv_chunk: int, remat: str):
    """One block's ``forward_train`` under the ``remat`` policy."""
    fn = functools.partial(block.forward_train, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
    if remat == "none":
        return fn(x, positions)
    kw = {} if remat == "full" else dict(context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                                       _save_products))
    return checkpoint(fn, x, positions, use_reentrant=False, **kw)


def forward_train(model: LM, batch: dict, *, remat: str = "dots", q_chunk: int = 512,
                  kv_chunk: int = 1024) -> tuple[torch.Tensor, dict]:
    """``{"tokens" | "embeds", "labels"}`` → (loss, metrics): the mean
    cross-entropy over labels >= 0 (labels ``[B, S]``, or ``[B, S, CB]``
    for multi-codebook archs) plus the MoE auxiliary loss, plus 0.3 times
    the MTP head's loss on the labels one position on when the model has
    one. ``metrics`` holds ``ce``, ``aux``, ``tokens`` (the count of
    labels) and, with MTP, ``mtp``. The pipeline-parallel schedule of
    the reference's ``pipeline_micro`` comes with the port's
    ``DeviceMesh`` (ROADMAP item 7f)."""
    if remat not in REMATS:
        raise ValueError(f"remat {remat!r}; known: {REMATS}")
    cfg = model.cfg
    x = _embed_in(model, batch)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    off = 0
    for spec in stacks_for(cfg):
        windows = _windows_for(cfg, spec, off)
        aux_stack = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, block in enumerate(model.stacks[spec.name]):
            window = windows if isinstance(windows, int) else windows[i]
            x, aux = _run_block(block, x, positions, window, q_chunk, kv_chunk, remat)
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
                                        kv_chunk=kv_chunk)
        mtp_loss, _ = _xent(_logits(model, mtp.norm(hm, cfg.norm_eps)), batch["labels"][:, 1:])
        metrics["mtp"] = mtp_loss
        loss = loss + 0.3 * mtp_loss
    return loss + aux_total, metrics


# ---------------------------------------------------------------- cache --------


#: the attention entries, written at their slot and padded to ``S_alloc``
SEQ_ENTRIES = ("k", "v", "ckv", "krope")


def _cache_entry_shapes(cfg: ArchConfig, pd: PaddedDims, spec: StackSpec, B: int, S: int):
    """(name, shape, float32 whatever the model's type) per cache tensor of
    one stack, in the reference's order."""
    L = spec.n_layers
    out = []
    if spec.kind in ("attn", "moe", "hybrid"):
        if cfg.attention == "mla":
            out += [("ckv", (L, B, S, cfg.kv_lora_rank), False), ("krope", (L, B, S, cfg.qk_rope_dim), False)]
        else:
            kv = (L, B, S, pd.n_kv_heads, cfg.d_head)
            out += [("k", kv, False), ("v", kv, False)]
    if spec.kind in ("ssm", "hybrid"):
        dims = ssm_mod.ssm_dims(cfg)
        out += [
            ("conv_x", (L, B, cfg.ssm_conv - 1, dims["di"]), False),
            ("conv_bc", (L, B, cfg.ssm_conv - 1, 2 * dims["N"]), False),
            ("state", (L, B, dims["H"], dims["P"], dims["N"]), True),
        ]
    return out


def init_cache(cfg: ArchConfig, B: int, S_alloc: int, *, device, dtype=None) -> dict[str, torch.Tensor]:
    """A zeroed cache for ``B`` sequences of ``S_alloc`` slots, in ``dtype``
    (default ``cfg.dtype``) but the SSD ``state``, float32."""
    pd = padded_dims(cfg, 1)
    dtype = torch_dtype(dtype or cfg.dtype)
    return {
        f"{spec.name}/{name}": torch.zeros(shape, device=device, dtype=torch.float32 if f32 else dtype)
        for spec in stacks_for(cfg)
        for name, shape, f32 in _cache_entry_shapes(cfg, pd, spec, B, S_alloc)
    }


def _entry_names(cfg: ArchConfig, spec: StackSpec) -> list[str]:
    return [name for name, _, _ in _cache_entry_shapes(cfg, padded_dims(cfg, 1), spec, 1, 1)]


# ---------------------------------------------------------------- prefill ------


def prefill(model: LM, batch: dict, *, s_alloc: int | None = None, q_chunk: int = 512,
            kv_chunk: int = 1024) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Full-prompt forward → (logits of the last position, the cache primed
    with the prompt: attention entries padded with zeros up to ``s_alloc``,
    the SSD entries as the prompt leaves them)."""
    cfg = model.cfg
    x = _embed_in(model, batch)
    B, S = x.shape[:2]
    s_alloc = s_alloc or S
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    cache = init_cache(cfg, B, s_alloc, device=x.device, dtype=x.dtype)
    off = 0
    for spec in stacks_for(cfg):
        windows = _windows_for(cfg, spec, off)
        names = _entry_names(cfg, spec)
        for i, block in enumerate(model.stacks[spec.name]):
            window = windows if isinstance(windows, int) else windows[i]
            x, entries = block(x, positions, window=window, q_chunk=q_chunk, kv_chunk=kv_chunk)
            for name, entry in zip(names, entries):
                if name in SEQ_ENTRIES:
                    cache[f"{spec.name}/{name}"][i, :, :S] = entry
                else:
                    cache[f"{spec.name}/{name}"][i] = entry
        off += spec.n_layers
    h = model.final_norm(x[:, -1:], cfg.norm_eps)
    return _logits(model, h)[:, 0], cache


# ---------------------------------------------------------------- decode -------


def decode_step(model: LM, cache: dict[str, torch.Tensor], batch_t: dict,
                pos: int) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One token (``{"tokens": [B,1]}`` or ``{"embeds": [B,1,D]}``) at
    position ``pos`` → (logits [B, V(·CB)], the cache, written in place:
    the attention entries at slot ``pos``, the SSD entries whole)."""
    cfg = model.cfg
    x = _embed_in(model, batch_t)
    off = 0
    for spec in stacks_for(cfg):
        windows = _windows_for(cfg, spec, off)
        stack = [cache[f"{spec.name}/{name}"] for name in _entry_names(cfg, spec)]
        for i, block in enumerate(model.stacks[spec.name]):
            window = windows if isinstance(windows, int) else windows[i]
            x = block.decode(x, tuple(entry[i] for entry in stack), pos, window=window)
        off += spec.n_layers
    h = model.final_norm(x, cfg.norm_eps)
    return _logits(model, h)[:, 0], cache
