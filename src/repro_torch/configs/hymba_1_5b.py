"""Hymba-1.5B [arXiv:2411.13676; hf nvidia/Hymba-1.5B-Base].

32L, d_model 1600, 25 q-heads (GQA kv=5, d_head 64), d_ff 5504,
vocab 32001, parallel attention ∥ Mamba heads in every layer
(per-branch RMSNorm, averaged), SWA 1024 everywhere except 3 global
layers {first, middle, last}, ssm_state 16.

Adaptation notes (DESIGN §Arch-applicability): q-heads pad 25→32 for
the 16-way model axis; 128 meta tokens omitted (config ships 0);
cross-layer KV sharing omitted.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    attention="gqa",
    d_head=64,
    sliding_window=1024,
    global_layers=(0, 15, 31),
    act="silu",
    gated_mlp=True,
    hybrid=True,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
)

SMOKE = ArchConfig(
    name="hymba-1.5b-smoke",
    family="hybrid",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=128,
    attention="gqa",
    d_head=16,
    sliding_window=8,
    global_layers=(0, 2),
    act="silu",
    gated_mlp=True,
    hybrid=True,
    ssm_state=8,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=8,
)
