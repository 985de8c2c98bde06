"""Minitron-8B [arXiv:2407.14679; hf nvidia/Minitron-8B-Base] — pruned Nemotron-4.

32L, d_model 4096, 32 q-heads, GQA kv=8, d_ff 16384, vocab 256000.
Non-gated MLP (Nemotron squared-ReLU ≈ we use gelu — noted in DESIGN),
partial rotary 0.5.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256_000,
    attention="gqa",
    rotary_pct=0.5,
    act="gelu",
    gated_mlp=False,
)

SMOKE = ArchConfig(
    name="minitron-8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    attention="gqa",
    rotary_pct=0.5,
    act="gelu",
    gated_mlp=False,
)
