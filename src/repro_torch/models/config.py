"""Architecture configuration (one instance per assigned arch).

Exact published numbers live in ``repro_torch.configs.<arch>``; this dataclass
is the neutral schema. Padding for TP divisibility is *not* applied here
— ``parallel.padding`` derives padded sizes at sharding time and
``padding_report()`` documents the deltas.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ArchConfig"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 → d_model // n_heads

    # attention
    attention: Literal["gqa", "mla", "none"] = "gqa"
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0  # ChatGLM3 "2d" RoPE = rotary on half the dims
    sliding_window: int = 0  # 0 = global attention
    global_layers: tuple[int, ...] = ()  # layers that stay global under SWA
    qk_norm: bool = False

    # MLA (DeepSeek-V3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # FFN
    act: Literal["silu", "gelu"] = "silu"
    gated_mlp: bool = True  # SwiGLU/GeGLU when True

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0  # DeepSeek: leading dense layers
    dense_d_ff: int = 0  # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_score: Literal["softmax", "sigmoid"] = "softmax"  # sigmoid = DeepSeek-V3
    moe_aux_alpha: float = 0.01  # 0 → aux-loss-free (DeepSeek-V3)

    # SSM (Mamba-2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # hybrid (Hymba)
    hybrid: bool = False
    meta_tokens: int = 0

    # frontend / heads
    input_mode: Literal["tokens", "embeddings"] = "tokens"
    n_codebooks: int = 1  # MusicGen: parallel output heads over the vocab
    tie_embeddings: bool = False
    mtp: bool = False  # DeepSeek multi-token prediction head
    embed_scale: bool = False  # Gemma-style sqrt(d_model) embedding scale

    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    def __post_init__(self) -> None:
        if self.d_head == 0 and self.attention != "none" and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    # -- derived -------------------------------------------------------------

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def uses_attention(self) -> bool:
        return self.attention != "none"

    @property
    def uses_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode state: SSM state and/or rolling SWA KV."""
        return self.family == "ssm" or (self.hybrid and self.sliding_window > 0)

    def param_count(self) -> int:
        """Analytic parameter count (unpadded, embeddings included)."""
        d, L = self.d_model, self.n_layers
        total = self.vocab_size * d  # input embed
        if not self.tie_embeddings:
            total += self.vocab_size * d * self.n_codebooks
        for layer in range(L):
            total += 2 * d  # norms
            if self.uses_attention:
                if self.attention == "mla":
                    total += d * self.q_lora_rank
                    total += self.q_lora_rank * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    total += d * (self.kv_lora_rank + self.qk_rope_dim)
                    total += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                    total += self.n_heads * self.v_head_dim * d
                else:
                    total += d * self.n_heads * self.d_head
                    total += 2 * d * self.n_kv_heads * self.d_head
                    total += self.n_heads * self.d_head * d
            if self.uses_ssm:
                di, H, N = self.d_inner, self.ssm_heads, self.ssm_state
                total += d * (2 * di + 2 * N + H)  # in_proj(x,z), B,C, dt
                total += self.ssm_conv * (di + 2 * N)
                total += 2 * H  # A, D
                total += di  # ssm out norm
                total += di * d
            if self.is_moe and layer >= self.first_k_dense:
                e_ff = self.moe_d_ff
                total += d * self.n_experts  # router
                total += self.n_experts * (3 if self.gated_mlp else 2) * d * e_ff
                total += self.n_shared_experts * (3 if self.gated_mlp else 2) * d * e_ff
            else:
                ff = self.dense_d_ff if (self.is_moe and layer < self.first_k_dense) else self.d_ff
                if ff:
                    total += (3 if self.gated_mlp else 2) * d * ff
        total += d  # final norm
        return total
