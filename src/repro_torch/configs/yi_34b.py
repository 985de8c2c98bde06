"""Yi-34B [arXiv:2403.04652; hf 01-ai/Yi-34B] — llama-arch GQA.

60L, d_model 7168, 56 q-heads, GQA kv=8, d_ff 20480, vocab 64000.
SwiGLU, RoPE theta 5e6.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    attention="gqa",
    rope_theta=5_000_000.0,
    act="silu",
    gated_mlp=True,
)

SMOKE = ArchConfig(
    name="yi-34b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=128,
    attention="gqa",
    act="silu",
    gated_mlp=True,
)
