"""Registry: --arch <id> → ArchConfig, shapes, and cell applicability."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ArchConfig

__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "get_arch", "get_smoke", "shape_applicable"]

_MODULES = {
    "starcoder2-3b": "starcoder2_3b",
    "yi-34b": "yi_34b",
    "chatglm3-6b": "chatglm3_6b",
    "minitron-8b": "minitron_8b",
    "mamba2-780m": "mamba2_780m",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "hymba-1.5b": "hymba_1_5b",
    "musicgen-medium": "musicgen_medium",
    "paligemma-3b": "paligemma_3b",
}

ARCHS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def _load(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_arch(name: str) -> ArchConfig:
    return _load(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _load(name).SMOKE


def shape_applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """(applicable?, reason-if-not). long_500k needs sub-quadratic decode
    state; pure full-attention archs skip it (DESIGN §4)."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, (
            "pure full-attention arch: a 524k dense KV cache is quadratic-"
            "regime; no sub-quadratic attention in the published config"
        )
    return True, ""
