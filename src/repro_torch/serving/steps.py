"""Serving steps of the port: prefill (prompt → cache) and decode (one
token → logits, the cache written in place at slot ``pos``), the
counterpart of ``repro.serving.steps``.

The reference donates the cache to its jitted decode step so that decode
is in place; here the step writes into the cache it is given. Each step
runs under ``exact_matmul()`` and ``torch.inference_mode()``; under a
mesh ``torch.no_grad()`` instead, as a view of a DTensor parameter
(the SSD's conv taps) cannot be taken in inference mode.

Under a mesh (``ctx``) decode shards the batch over the dp axes and the
cache's sequence over ``model`` (SP): each layer's attention runs as
flash-decoding across the model ranks (``models.blocks``).
``serve_sharding`` picks the weights' placement: ``"fsdp"`` reuses the
training placement, ``"tp"`` the inference one (weights pure-TP, experts
global-EP when they divide data × model). Where the reference's jitted
step re-shards what it is given by its ``in_shardings``, the port's step
places the model's parameters, the cache and the tokens by their specs
before it runs (``ft.elastic.reshard_tree``, ``parallel.sharding.place``;
a tensor placed so already is left as it is, so a model stays placed
from one call to the next). The logits come back batch-sharded and
replicated over ``model``, as the reference's ``out_shardings``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.models import lm
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ArchConfig
from repro_torch.parallel.sharding import MeshCtx, logical_to_spec, param_specs_for_tree, place

__all__ = [
    "SERVE_SHARDINGS",
    "exact_matmul",
    "serving_device",
    "serve_ctx_and_axes",
    "cache_shardings",
    "token_specs",
    "make_prefill_step",
    "make_decode_step",
]

SERVE_SHARDINGS = ("fsdp", "tp")


@contextlib.contextmanager
def exact_matmul():
    """Products of the steps accumulate in float32, as the reference's
    ``preferred_element_type=float32``: cuBLAS may neither reduce bfloat16
    products in reduced precision nor round float32 inputs to TF32. The
    previous settings come back on exit."""
    m = torch.backends.cuda.matmul
    saved = m.allow_bf16_reduced_precision_reduction, m.allow_tf32
    m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = False, False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction, m.allow_tf32 = saved


def serving_device(device=None) -> torch.device:
    """``device``, or the current CUDA device when None; with no CUDA device
    that raises: the serving path runs on the CPU only when asked to."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the serving path runs on an NVIDIA GPU unless device='cpu' is given")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def serve_ctx_and_axes(cfg: ArchConfig, ctx: MeshCtx | None, serve_sharding: str):
    """(ctx, param_axes) for the chosen serving placement.

    "fsdp" — training placement reused (FSDP gathers every layer).
    "tp"   — inference placement: weights pure-TP, experts global-EP when
             they divide (data × model).
    """
    if serve_sharding not in SERVE_SHARDINGS:
        raise ValueError(f"serve_sharding {serve_sharding!r}; known: {SERVE_SHARDINGS}")
    if ctx is None or serve_sharding == "fsdp":
        return ctx, lm.lm_axes(cfg, ctx.tp_size if ctx else 1)
    ctx = dataclasses.replace(ctx, serve_ep=True)
    epd = cfg.is_moe and moe_mod.ep_over_data_ok(cfg, ctx)
    return ctx, lm.lm_axes(cfg, ctx.tp_size, serve=True, ep_over_data=epd)


def cache_shardings(cfg: ArchConfig, ctx: MeshCtx | None, B: int, S_alloc: int):
    tp = ctx.tp_size if ctx else 1
    return param_specs_for_tree(ctx, lm.cache_axes(cfg, B, S_alloc, tp))


def token_specs(cfg: ArchConfig, ctx: MeshCtx | None):
    if cfg.input_mode == "tokens":
        return {"tokens": logical_to_spec(ctx, ("batch", None))}
    return {"embeds": logical_to_spec(ctx, ("batch", None, None))}


def _logits_spec(cfg: ArchConfig, ctx: MeshCtx):
    return logical_to_spec(ctx, ("batch", None) if cfg.n_codebooks == 1 else ("batch", None, None))


def _check_inputs(cfg: ArchConfig, dev: torch.device, model: lm.LM, tensors) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the step serves {cfg.name}, the model is {model.cfg.name}")
    for where in (model.device, *(t.device for t in tensors)):
        if where != dev:
            raise ValueError(f"the step runs on {dev}, a tensor lies on {where}")


def _no_autograd(ctx):
    return torch.inference_mode() if ctx is None else torch.no_grad()


def _placed(cfg: ArchConfig, ctx: MeshCtx, p_axes, model: lm.LM, tree: dict, specs: dict) -> dict:
    """Place the model by ``p_axes`` (in place) and ``tree`` by ``specs``."""
    from repro_torch.ft.elastic import reshard_tree

    if model.tp != ctx.tp_size:
        raise ValueError(f"the model is padded for tp={model.tp}, the mesh has tp={ctx.tp_size}")
    reshard_tree(model, ctx, p_axes)
    return {k: place(v, ctx, specs[k]) for k, v in tree.items()}


def make_prefill_step(cfg: ArchConfig, ctx: MeshCtx | None = None, *, s_alloc: int, q_chunk: int = 512,
                      kv_chunk: int = 1024, serve_sharding: str = "fsdp", device=None):
    """prefill_step(model, batch) -> (last logits, cache)."""
    ctx, p_axes = serve_ctx_and_axes(cfg, ctx, serve_sharding)
    dev = serving_device(device)

    def prefill_step(model: lm.LM, batch: dict):
        _check_inputs(cfg, dev, model, batch.values())
        if ctx is not None:
            batch = _placed(cfg, ctx, p_axes, model, batch, token_specs(cfg, ctx))
        with _no_autograd(ctx), exact_matmul():
            logits, cache = lm.prefill(model, batch, ctx, s_alloc=s_alloc, q_chunk=q_chunk, kv_chunk=kv_chunk)
            if ctx is not None:
                logits = place(logits, ctx, _logits_spec(cfg, ctx))
        return logits, cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, ctx: MeshCtx | None = None, *, serve_sharding: str = "fsdp", device=None):
    """decode_step(model, cache, batch_t, pos) -> (logits, cache), the
    cache written in place (under a mesh, a cache of whole tensors is
    placed first and the placed one comes back)."""
    ctx, p_axes = serve_ctx_and_axes(cfg, ctx, serve_sharding)
    dev = serving_device(device)

    def decode_step(model: lm.LM, cache: dict, batch_t: dict, pos: int):
        _check_inputs(cfg, dev, model, (*cache.values(), *batch_t.values()))
        if ctx is not None:
            B = next(iter(batch_t.values())).shape[0]
            S_alloc = next(iter(cache.values())).shape[2]
            cache = _placed(cfg, ctx, p_axes, model, cache, cache_shardings(cfg, ctx, B, S_alloc))
            batch_t = {k: place(v, ctx, token_specs(cfg, ctx)[k]) for k, v in batch_t.items()}
        with _no_autograd(ctx), exact_matmul():
            logits, cache = lm.decode_step(model, cache, batch_t, pos, ctx)
            if ctx is not None:
                logits = place(logits, ctx, _logits_spec(cfg, ctx))
        return logits, cache

    return decode_step
