"""The train step of the port, the counterpart of
``repro.training.steps.make_train_step``.

``train_step(model, opt_state, batch)`` computes the loss and its
gradients (``loss_and_grads``), averaging them over ``microbatches``
slices of the batch in float32 as the reference's ``g0`` accumulator
does, then applies ``opt_update``: the parameters and the optimizer state
change in place. It runs under ``exact_matmul()`` (products accumulate in
float32, no TF32), as the serving steps do, and with autograd on.

Under a mesh (``ctx``) the parameters are placed by ``lm_axes`` (FSDP
over the dp axes and TP over ``model``; with ``param_mode="fsdp_all"``
FSDP over the whole mesh and no TP), the optimizer state by
``opt_state_axes`` and the batch by ``batch_specs``; the step places
whatever it is given so, by the axes it computed once (a no-op once
placed).
Each gradient is redistributed to its parameter's placements (the
reduce-scatter of ZeRO) before the update. A microbatch is a slice of
the global batch, as the reference's reshape takes it. The reference's
``pipeline_micro`` is ROADMAP item 7g.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import full, init_lm_shapes, nest, param_leaves
from repro_torch.parallel.sharding import MeshCtx, logical_to_spec, map_axes, place
from repro_torch.serving.steps import exact_matmul, serving_device
from .optimizer import OptConfig, init_opt, opt_state_axes, opt_update

__all__ = [
    "TrainSettings",
    "PARAM_MODES",
    "batch_specs",
    "train_state_shapes",
    "train_ctx",
    "place_train_state",
    "make_train_step",
    "loss_and_grads",
    "train_params",
]

PARAM_MODES = ("fsdp", "fsdp_all")


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    microbatches: int = 1
    remat: str = "dots"  # none | dots | full
    q_chunk: int = 512
    kv_chunk: int = 1024
    param_mode: str = "fsdp"  # fsdp (ZeRO-3 + TP) | fsdp_all (no TP)
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)


def batch_specs(cfg: ArchConfig, ctx: MeshCtx | None):
    """Specs for a training batch dict."""
    bspec = logical_to_spec(ctx, ("batch", None))
    out = {"labels": bspec if cfg.n_codebooks == 1 else logical_to_spec(ctx, ("batch", None, None))}
    if cfg.input_mode == "tokens":
        out["tokens"] = bspec
    else:
        out["embeds"] = logical_to_spec(ctx, ("batch", None, None))
    return out


def train_state_shapes(cfg: ArchConfig, settings: TrainSettings, tp: int):
    """(params, opt_state) on the ``meta`` device, in the reference's
    stacked layout: shapes and types, no allocation."""
    model = lm.init_lm(cfg, generator=None, device="meta", tp=tp)
    shapes = init_lm_shapes(cfg, tp)
    dtypes = {path: ps[0].dtype for path, ps in param_leaves(model)}
    params = nest({path: torch.empty(shape, dtype=dtypes[path], device="meta") for path, shape in shapes.items()})
    return params, init_opt(param_leaves(model), settings.opt)


def train_ctx(cfg: ArchConfig, ctx: MeshCtx | None, settings: TrainSettings) -> MeshCtx | None:
    """The ctx a train step runs under: ``param_mode="fsdp_all"`` shards the
    weights over the whole mesh when ``d_model`` divides it, else over the
    axes other than ``model`` (plain DP across ``model``); the batch still
    covers the whole mesh. MoE archs need EP, so not that mode."""
    if settings.param_mode not in PARAM_MODES:
        raise ValueError(f"param_mode {settings.param_mode!r}; known: {PARAM_MODES}")
    if settings.param_mode == "fsdp_all" and ctx is not None:
        if cfg.is_moe:
            raise ValueError("fsdp_all is for dense/ssm archs (MoE needs EP)")
        override = None
        if cfg.d_model % ctx.size != 0:
            override = tuple(a for a in ctx.axis_names if a != "model")
        ctx = dataclasses.replace(ctx, fsdp_all=True, fsdp_axes_override=override)
    return ctx


def _specs(cfg: ArchConfig, ctx: MeshCtx, settings: TrainSettings):
    """(parameter axes, optimizer-state axes, batch specs) under ``ctx``."""
    p_axes = lm.lm_axes(cfg, ctx.tp_size)
    p_shapes, _ = train_state_shapes(cfg, settings, ctx.tp_size)
    return p_axes, opt_state_axes(p_axes, settings.opt, p_shapes), batch_specs(cfg, ctx)


def place_train_state(cfg: ArchConfig, ctx: MeshCtx, settings: TrainSettings, model: lm.LM,
                      opt_state: dict | None = None) -> None:
    """Place the model's parameters by ``lm_axes`` and ``opt_state["state"]``
    by ``opt_state_axes``, in place (``ctx`` as ``train_ctx`` gives it)."""
    p_axes, o_axes, _ = _specs(cfg, ctx, settings)
    _place_state(ctx, p_axes, o_axes, model, opt_state)


def _place_state(ctx: MeshCtx, p_axes, o_axes, model: lm.LM, opt_state: dict | None) -> None:
    """``place_train_state`` by axes already computed; what is placed so
    already is left as it is."""
    from repro_torch.ft.elastic import reshard_tree

    if model.tp != ctx.tp_size:
        raise ValueError(f"the model is padded for tp={model.tp}, the mesh has tp={ctx.tp_size}")
    reshard_tree(model, ctx, p_axes)
    if opt_state is not None:
        opt_state["state"] = reshard_tree(opt_state["state"], ctx, o_axes["state"])


def train_params(model: lm.LM) -> list[torch.nn.Parameter]:
    """The parameters in the order ``opt_update`` takes their gradients."""
    return [p for _, ps in param_leaves(model) for p in ps]


def loss_and_grads(model: lm.LM, batch: dict, settings: TrainSettings, ctx: MeshCtx | None = None):
    """(loss, metrics, gradients of ``train_params(model)``, each in its
    parameter's type), as the reference's ``jax.value_and_grad`` of
    ``forward_train``; under ``exact_matmul()``. Under ``ctx`` each
    gradient comes placed as its parameter, and the loss and metrics
    whole."""
    params = train_params(model)
    with torch.enable_grad(), exact_matmul():
        loss, metrics = lm.forward_train(model, batch, ctx, remat=settings.remat, q_chunk=settings.q_chunk,
                                         kv_chunk=settings.kv_chunk)
        grads = list(torch.autograd.grad(loss, params))
    if ctx is not None:
        grads = [g.redistribute(p.device_mesh, p.placements) for g, p in zip(grads, params)]
    return full(loss.detach()), {k: full(v.detach()) for k, v in metrics.items()}, grads


def make_train_step(cfg: ArchConfig, ctx: MeshCtx | None = None, settings: TrainSettings | None = None, *,
                    device=None):
    """Returns ``(train_step, in_placements, out_placements)``: the DTensor
    placements of (parameters, optimizer state, batch) and of (parameters,
    optimizer state, metrics), trees as the reference's shardings
    (``None`` at one device; the metrics whole).

    ``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``
    with ``metrics`` the forward's (``ce``, ``aux``, ``tokens``, ``mtp``)
    and ``loss``, ``lr``, ``grad_norm``. It runs on the CUDA device unless
    ``device`` names another; with no CUDA device and none named it
    raises."""
    settings = settings or TrainSettings()
    ctx = train_ctx(cfg, ctx, settings)
    if settings.remat not in lm.REMATS:
        raise ValueError(f"remat {settings.remat!r}; known: {lm.REMATS}")
    dev = serving_device(device)
    n_mb = settings.microbatches
    in_sh = out_sh = None
    if ctx is not None:
        p_axes, o_axes, b_spec = _specs(cfg, ctx, settings)
        p_pl, o_pl = (map_axes(lambda ax: ctx.placements(logical_to_spec(ctx, ax)), a) for a in (p_axes, o_axes))
        b_pl = {k: ctx.placements(v) for k, v in b_spec.items()}
        in_sh, out_sh = (p_pl, o_pl, b_pl), (p_pl, o_pl, None)

    def train_step(model: lm.LM, opt_state: dict, batch: dict):
        if model.cfg != cfg:
            raise ValueError(f"the step trains {cfg.name}, the model is {model.cfg.name}")
        for where in (model.device, *(t.device for t in batch.values())):
            if where != dev:
                raise ValueError(f"the step runs on {dev}, a tensor lies on {where}")
        if ctx is not None:
            _place_state(ctx, p_axes, o_axes, model, opt_state)
        B = next(iter(batch.values())).shape[0]
        if B % n_mb:
            raise ValueError(f"a batch of {B} does not split into {n_mb} microbatches")
        size = B // n_mb
        if n_mb == 1:
            loss, metrics, grads = loss_and_grads(model, _mb(batch, ctx, b_spec if ctx else None, 0, B), settings,
                                                  ctx)
        else:
            acc, loss = None, torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n_mb):
                mb = _mb(batch, ctx, b_spec if ctx else None, i * size, size)
                mb_loss, metrics, g = loss_and_grads(model, mb, settings, ctx)
                g = [x.float() for x in g]
                acc = g if acc is None else [a.add_(x) for a, x in zip(acc, g)]
                loss = loss + mb_loss
            grads = [a / n_mb for a in acc]
            loss = loss / n_mb
        stats = opt_update(grads, opt_state, param_leaves(model), settings.opt)
        return model, opt_state, dict(metrics, loss=loss, **stats)

    return train_step, in_sh, out_sh


def _mb(batch: dict, ctx: MeshCtx | None, specs, start: int, size: int) -> dict:
    """Rows ``[start, start + size)`` of the global batch; under ``ctx``
    placed by ``specs`` (a placed batch is read whole first)."""
    out = {}
    for k, v in batch.items():
        v = v if size == v.shape[0] else full(v)[start : start + size]
        out[k] = v if ctx is None else place(v, ctx, specs[k])
    return out
