"""The train step of the port, the counterpart of
``repro.training.steps.make_train_step`` on one device.

``train_step(model, opt_state, batch)`` computes the loss and its
gradients (``loss_and_grads``), averaging them over ``microbatches``
slices of the batch in float32 as the reference's ``g0`` accumulator
does, then applies ``opt_update``: the parameters and the optimizer state
change in place. It runs under ``exact_matmul()`` (products accumulate in
float32, no TF32), as the serving steps do, and with autograd on. Mesh
placements (a ``ctx``, and the reference's ``pipeline_micro`` and
``param_mode`` settings that act only with one) and the sharding helpers
built on them (``batch_specs``, ``train_state_shapes``,
``opt_state_axes``) come with the port's ``DeviceMesh`` (ROADMAP item
7f).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lm
from repro_torch.models.config import ArchConfig
from repro_torch.models.convert import param_leaves
from repro_torch.serving.steps import MESH_SLICE, exact_matmul, serving_device
from .optimizer import OptConfig, opt_update

__all__ = ["TrainSettings", "make_train_step", "loss_and_grads", "train_params"]


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    microbatches: int = 1
    remat: str = "dots"  # none | dots | full
    q_chunk: int = 512
    kv_chunk: int = 1024
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)


def train_params(model: lm.LM) -> list[torch.nn.Parameter]:
    """The parameters in the order ``opt_update`` takes their gradients."""
    return [p for _, ps in param_leaves(model) for p in ps]


def loss_and_grads(model: lm.LM, batch: dict, settings: TrainSettings):
    """(loss, metrics, gradients of ``train_params(model)``, each in its
    parameter's type), as the reference's ``jax.value_and_grad`` of
    ``forward_train``; under ``exact_matmul()``."""
    with torch.enable_grad(), exact_matmul():
        loss, metrics = lm.forward_train(model, batch, remat=settings.remat, q_chunk=settings.q_chunk,
                                         kv_chunk=settings.kv_chunk)
        grads = torch.autograd.grad(loss, train_params(model))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, list(grads)


def make_train_step(cfg: ArchConfig, ctx=None, settings: TrainSettings | None = None, *, device=None):
    """Returns ``(train_step, None, None)``: no shardings at one device.

    ``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``
    with ``metrics`` the forward's (``ce``, ``aux``, ``tokens``, ``mtp``)
    and ``loss``, ``lr``, ``grad_norm``. It runs on the CUDA device unless
    ``device`` names another; with no CUDA device and none named it
    raises."""
    settings = settings or TrainSettings()
    if ctx is not None:
        raise NotImplementedError(MESH_SLICE)
    if settings.remat not in lm.REMATS:
        raise ValueError(f"remat {settings.remat!r}; known: {lm.REMATS}")
    dev = serving_device(device)
    n_mb = settings.microbatches

    def train_step(model: lm.LM, opt_state: dict, batch: dict):
        if model.cfg != cfg:
            raise ValueError(f"the step trains {cfg.name}, the model is {model.cfg.name}")
        for where in (model.device, *(t.device for t in batch.values())):
            if where != dev:
                raise ValueError(f"the step runs on {dev}, a tensor lies on {where}")
        if n_mb == 1:
            loss, metrics, grads = loss_and_grads(model, batch, settings)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % n_mb:
                raise ValueError(f"a batch of {B} does not split into {n_mb} microbatches")
            size = B // n_mb
            acc, loss = None, torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n_mb):
                mb = {k: v[i * size : (i + 1) * size] for k, v in batch.items()}
                mb_loss, metrics, g = loss_and_grads(model, mb, settings)
                g = [x.float() for x in g]
                acc = g if acc is None else [a.add_(x) for a, x in zip(acc, g)]
                loss = loss + mb_loss
            grads = [a / n_mb for a in acc]
            loss = loss / n_mb
        stats = opt_update(grads, opt_state, param_leaves(model), settings.opt)
        return model, opt_state, dict(metrics, loss=loss, **stats)

    return train_step, None, None
