"""Serving steps of the port: prefill (prompt → cache) and decode (one
token → logits, the cache written in place at slot ``pos``), the
counterpart of ``repro.serving.steps`` on one device.

The reference donates the cache to its jitted decode step so that decode
is in place; here the step writes into the cache it is given. Each step
runs under ``torch.inference_mode()`` and ``exact_matmul()``. Mesh
placements (a ``ctx``, ``serve_sharding="tp"``) come with the port's
``DeviceMesh`` (ROADMAP item 7f).
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.models import lm
from repro_torch.models.config import ArchConfig

__all__ = ["MESH_SLICE", "exact_matmul", "serving_device", "make_prefill_step", "make_decode_step"]

MESH_SLICE = "mesh placements come with the port's DeviceMesh in a later slice (ROADMAP item 7f)"


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


def _check(cfg: ArchConfig, ctx, serve_sharding: str) -> None:
    if ctx is not None or serve_sharding != "fsdp":
        raise NotImplementedError(MESH_SLICE)


def _check_inputs(cfg: ArchConfig, dev: torch.device, model: lm.LM, tensors) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the step serves {cfg.name}, the model is {model.cfg.name}")
    for where in (model.device, *(t.device for t in tensors)):
        if where != dev:
            raise ValueError(f"the step runs on {dev}, a tensor lies on {where}")


def make_prefill_step(cfg: ArchConfig, ctx=None, *, s_alloc: int, q_chunk: int = 512, kv_chunk: int = 1024,
                      serve_sharding: str = "fsdp", device=None):
    """prefill_step(model, batch) -> (last logits, cache)."""
    _check(cfg, ctx, serve_sharding)
    dev = serving_device(device)

    def prefill_step(model: lm.LM, batch: dict):
        _check_inputs(cfg, dev, model, batch.values())
        with torch.inference_mode(), exact_matmul():
            return lm.prefill(model, batch, s_alloc=s_alloc, q_chunk=q_chunk, kv_chunk=kv_chunk)

    return prefill_step


def make_decode_step(cfg: ArchConfig, ctx=None, *, serve_sharding: str = "fsdp", device=None):
    """decode_step(model, cache, batch_t, pos) -> (logits, cache), the
    cache written in place."""
    _check(cfg, ctx, serve_sharding)
    dev = serving_device(device)

    def decode_step(model: lm.LM, cache: dict, batch_t: dict, pos: int):
        _check_inputs(cfg, dev, model, (*cache.values(), *batch_t.values()))
        with torch.inference_mode(), exact_matmul():
            return lm.decode_step(model, cache, batch_t, pos)

    return decode_step
