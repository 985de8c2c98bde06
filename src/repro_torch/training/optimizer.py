"""Optimizers of the port: AdamW with memory-tiered second-moment storage,
the counterpart of ``repro.training.optimizer``, as plain functions on
tensors under ``torch.no_grad()``.

Variants (``kind``):
  adamw       — float32 m, v (baseline)
  adamw_bf16  — m, v stored bfloat16 (the update's math in float32)
  adafactor   — factored second moment (row and column running means)
                for leaves of two or more dimensions, float32 m

The parameters come as ``models.convert.param_leaves(model)``: (path,
tensors) pairs in the reference's tree order, a stack leaf's tensors its
layers'. The state keeps the reference's layout: ``{"step": int,
"state": {...}}`` with those paths and at each leaf ``{"m", "v"}`` or ``{"m", "vr", "vc"}`` in the shapes of the
reference's *stacked* leaf, so ``convert.opt_to_reference`` and the
checkpoints carry it as it is. The reference decides per stacked leaf:
weight decay applies when its ``ndim >= 2`` and a leaf is factored when
its last two dimensions are at least 8. A stack's norm scale ``[L, D]``
is therefore decayed, and factored across its layers once ``L >= 8``
(``vr`` a mean over D per layer, ``vc`` a mean over the layers per
column), which no per-layer ``[D]`` rule would give. So every leaf is
classified by the reference's shape; a stack leaf is updated layer by
layer where its factoring does not couple the layers, and stacked
where it does.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models.convert import full, is_stacked, nest, tree_get
from repro_torch.parallel.sharding import map_axes

__all__ = ["OptConfig", "Leaves", "init_opt", "opt_update", "opt_state_axes", "global_norm", "schedule"]

#: (path, tensors) pairs, as ``models.convert.param_leaves`` gives them
Leaves = list[tuple[tuple[str, ...], list[torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"  # adamw | adamw_bf16 | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


KINDS = ("adamw", "adamw_bf16", "adafactor")


def _ref_shape(path, ps) -> tuple[int, ...]:
    """The reference's shape of a leaf: a stack leaf's layers stacked."""
    shape = tuple(ps[0].shape)
    return (len(ps),) + shape if is_stacked(path) else shape


def _factored(shape: tuple[int, ...]) -> bool:
    return len(shape) >= 2 and shape[-1] >= 8 and shape[-2] >= 8


def init_opt(leaves: Leaves, cfg: OptConfig) -> dict:
    """Zeroed state on the parameters' device: float32 ``m`` and ``v``
    (bfloat16 for ``adamw_bf16``); for ``adafactor``'s factored leaves
    ``m`` and the row and column moments ``vr`` (the last dimension
    reduced) and ``vc`` (the one before it)."""
    if cfg.kind not in KINDS:
        raise ValueError(f"optimizer {cfg.kind!r}; known: {KINDS}")
    state = {}
    for path, ps in leaves:
        shape, dev = _ref_shape(path, ps), ps[0].device
        zeros = lambda s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)  # noqa: E731
        if cfg.kind == "adafactor" and _factored(shape):
            state[path] = {"m": zeros(shape), "vr": zeros(shape[:-1]), "vc": zeros(shape[:-2] + shape[-1:])}
        else:
            dt = torch.bfloat16 if cfg.kind == "adamw_bf16" else torch.float32
            state[path] = {"m": zeros(shape, dt), "v": zeros(shape, dt)}
    return {"step": 0, "state": nest(state)}


def opt_state_axes(param_axes: dict, cfg: OptConfig, params_shape: dict) -> dict:
    """Logical axes of the optimizer state, from the parameters' axes and
    their stacked shapes (``params_shape``, tensors on any device, as
    ``steps.train_state_shapes`` gives them): a factored leaf's ``vr``
    drops the last axis and ``vc`` the one before it."""

    def leaf_axes(axes, p):
        axes = tuple(axes)
        if cfg.kind == "adafactor" and _factored(tuple(p.shape)):
            return {"m": axes, "vr": axes[:-1], "vc": axes[:-2] + axes[-1:]}
        return {"m": axes, "v": axes}

    return {"step": (), "state": map_axes(leaf_axes, param_axes, params_shape)}


def schedule(cfg: OptConfig, step: int) -> float:
    """Warmup then cosine decay to ``min_lr_frac``, in float32 as the
    reference's traced schedule computes it."""
    f32 = np.float32
    warm = min(f32(step) / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    prog = np.clip(f32(step - cfg.warmup_steps) / f32(max(cfg.total_steps - cfg.warmup_steps, 1)), f32(0), f32(1))
    cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * prog))
    frac = f32(cfg.min_lr_frac) + f32(1 - cfg.min_lr_frac) * cos
    return float(f32(cfg.lr) * warm * frac)


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in float32. DTensor
    gradients (placed by ``Shard`` and ``Replicate`` only, on a mesh of
    every rank, as every mesh of the port is) are summed on each rank over
    its shards, each divided by the number of ranks that hold the same
    shard, then by one all-reduce over the whole mesh: a replicated scalar
    DTensor."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(grads[0], DTensor):
        return torch.sqrt(torch.stack([torch.sum(torch.square(g.float())) for g in grads]).sum())
    mesh = grads[0].device_mesh
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"global_norm sums over every rank; the mesh holds {mesh.size()} of {dist.get_world_size()}")
    parts = []
    for g in grads:
        copies = 1
        for size, pl in zip(mesh.shape, g.placements):
            if pl.is_partial():
                raise ValueError("global_norm takes gradients placed as their parameters, not partial sums")
            copies *= size if pl == Replicate() else 1
        parts.append(torch.sum(torch.square(g.to_local().float())) / copies)
    total = torch.stack(parts).sum()
    dist.all_reduce(total)
    return torch.sqrt(DTensor.from_local(total, mesh, [Replicate()] * mesh.ndim, run_check=False))


def _update(g, s: dict, p, cfg: OptConfig, scale, lr: float, bc1: float, bc2: float, decay: bool):
    """The reference's ``leaf_update`` on one leaf, or one layer of a stack
    leaf: writes ``s``'s moments and ``p`` in place. ``g``, ``p`` and ``s``
    hold the same part of the leaf."""
    g = g.float() * scale
    m = cfg.b1 * s["m"].float() + (1 - cfg.b1) * g
    if "vr" in s:  # factored second moment
        g2 = torch.square(g) + 1e-30
        vr = cfg.b2 * s["vr"] + (1 - cfg.b2) * torch.mean(g2, dim=-1)
        vc = cfg.b2 * s["vc"] + (1 - cfg.b2) * torch.mean(g2, dim=-2)
        # rank-1 reconstruction of v (Adafactor): vr ⊗ vc / mean(vr)
        denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=1e-30)
        v_hat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
        upd = (m / bc1) / (torch.sqrt(v_hat / bc2) + cfg.eps)
        s["vr"].copy_(vr)
        s["vc"].copy_(vc)
    else:
        v = cfg.b2 * s["v"].float() + (1 - cfg.b2) * torch.square(g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        s["v"].copy_(v)
    s["m"].copy_(m)
    pf = p.float()
    if decay:
        upd = upd + cfg.weight_decay * pf
    p.copy_(pf - lr * upd)


@torch.no_grad()
def opt_update(grads: list[torch.Tensor], opt_state: dict, leaves: Leaves, cfg: OptConfig) -> dict:
    """One step: clip → Adam(-factor) → weight decay → the scheduled
    learning rate. ``grads`` are the gradients of the tensors of
    ``leaves``, leaf after leaf, layers in order. Writes the parameters
    and ``opt_state`` in place; returns ``{"lr", "grad_norm"}``
    (``grad_norm`` a device scalar)."""
    if len(grads) != sum(len(ps) for _, ps in leaves):
        raise ValueError(f"{len(grads)} gradients for {sum(len(ps) for _, ps in leaves)} parameters")
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0) if cfg.grad_clip else 1.0
    f32 = np.float32
    bc1 = float(f32(1) - f32(cfg.b1) ** f32(step))
    bc2 = float(f32(1) - f32(cfg.b2) ** f32(step))
    it = iter(grads)
    for path, ps in leaves:
        gs = [next(it) for _ in ps]
        s = tree_get(opt_state["state"], path)
        shape = _ref_shape(path, ps)
        decay = bool(cfg.weight_decay) and len(shape) >= 2
        args = (cfg, scale, lr, bc1, bc2, decay)
        if not is_stacked(path):
            _update(gs[0], s, ps[0], *args)
        elif "vr" in s and ps[0].ndim == 1:
            # [L, D] factored over (layers, D): the moments couple the layers
            stacked = torch.stack([p.detach() for p in ps])
            _update(torch.stack(gs), s, stacked, *args)
            for p, new in zip(ps, stacked):
                p.copy_(new)
        else:
            for i, (g, p) in enumerate(zip(gs, ps)):
                _update(g, {k: v[i] for k, v in s.items()}, p, *args)
    opt_state["step"] = step
    return {"lr": lr, "grad_norm": full(gnorm)}
