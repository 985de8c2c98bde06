"""Qwen1.5-MoE-A2.7B [hf Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model 2048, 16 q-heads (MHA, kv=16), vocab 151936.
MoE: 60 routed experts top-4 (d_ff 1408 each) + 4 shared experts
(fused shared MLP width 5632). Routed experts are padded 60→64 for
EP over the 16-way model axis (pad experts masked in the router).
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=0,
    vocab_size=151_936,
    attention="gqa",
    rope_theta=1_000_000.0,
    act="silu",
    gated_mlp=True,
    n_experts=60,
    n_shared_experts=4,
    moe_top_k=4,
    moe_d_ff=1408,
    moe_aux_alpha=0.001,
)

SMOKE = ArchConfig(
    name="qwen2-moe-a2.7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=128,
    attention="gqa",
    act="silu",
    gated_mlp=True,
    n_experts=8,
    n_shared_experts=2,
    moe_top_k=2,
    moe_d_ff=32,
    moe_aux_alpha=0.001,
)
