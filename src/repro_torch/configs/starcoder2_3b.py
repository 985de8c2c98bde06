"""StarCoder2-3B [arXiv:2402.19173; hf bigcode/starcoder2-3b].

30L, d_model 3072, 24 q-heads, GQA kv=2, d_ff 12288, vocab 49152.
GELU (non-gated) MLP, RoPE theta 999999, tied embeddings.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    attention="gqa",
    rope_theta=999_999.0,
    act="gelu",
    gated_mlp=False,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="starcoder2-3b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=128,
    attention="gqa",
    act="gelu",
    gated_mlp=False,
    tie_embeddings=True,
)
