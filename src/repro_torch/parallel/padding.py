"""TP-divisibility padding.

Published configs are kept verbatim in ``repro_torch.configs``; when a sharded
dimension does not divide the mesh axis it is padded at *model-build*
time with inert slots (zero-init heads / masked experts / never-sampled
vocab rows). ``padding_report`` documents every delta for DESIGN.md.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ArchConfig

__all__ = ["PaddedDims", "padded_dims", "padding_report"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class PaddedDims:
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    n_experts: int
    d_ff: int
    moe_d_ff: int

    def head_pad(self, cfg: ArchConfig) -> int:
        return self.n_heads - cfg.n_heads


def padded_dims(cfg: ArchConfig, tp: int) -> PaddedDims:
    """Padded sizes for a given tensor-parallel degree.

    - q heads → multiple of tp (zero-initialized pad heads; their output
      contribution is exactly zero through the out-projection).
    - kv heads → if >= tp, round up to multiple of tp; else keep (the
      small KV projections are replicated).
    - vocab → multiple of 128·? we use lcm(tp, 128) so the padded rows
      also satisfy MXU lane alignment; pad logits are masked to -inf in
      the loss.
    - experts → multiple of tp (pad experts get -inf router logits).
    - d_ff → multiple of tp (all assigned configs already divide; guard).
    """
    heads = _round_up(cfg.n_heads, tp) if cfg.uses_attention else cfg.n_heads
    kv = cfg.n_kv_heads
    if cfg.uses_attention and cfg.attention == "gqa":
        if kv >= tp:
            kv = _round_up(kv, tp)
        # else replicated — but the GQA group structure must stay integral:
        # ensure padded q heads divide by kv
        if heads % max(kv, 1):
            heads = _round_up(heads, max(kv, 1) * tp // _gcd(tp, max(kv, 1)))
    vocab_mult = 128 * tp // _gcd(128, tp)
    vocab = _round_up(cfg.vocab_size, vocab_mult)
    experts = _round_up(cfg.n_experts, tp) if cfg.is_moe else 0
    d_ff = _round_up(cfg.d_ff, tp) if cfg.d_ff else 0
    moe_ff = cfg.moe_d_ff  # sharded on the FSDP axis in-layer, not on tp
    return PaddedDims(
        n_heads=heads,
        n_kv_heads=kv,
        vocab_size=vocab,
        n_experts=experts,
        d_ff=d_ff,
        moe_d_ff=moe_ff,
    )


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def padding_report(cfg: ArchConfig, tp: int) -> dict[str, tuple[int, int]]:
    p = padded_dims(cfg, tp)
    rep = {}
    if p.n_heads != cfg.n_heads:
        rep["n_heads"] = (cfg.n_heads, p.n_heads)
    if p.n_kv_heads != cfg.n_kv_heads:
        rep["n_kv_heads"] = (cfg.n_kv_heads, p.n_kv_heads)
    if p.vocab_size != cfg.vocab_size:
        rep["vocab_size"] = (cfg.vocab_size, p.vocab_size)
    if cfg.is_moe and p.n_experts != cfg.n_experts:
        rep["n_experts"] = (cfg.n_experts, p.n_experts)
    if cfg.d_ff and p.d_ff != cfg.d_ff:
        rep["d_ff"] = (cfg.d_ff, p.d_ff)
    return rep
