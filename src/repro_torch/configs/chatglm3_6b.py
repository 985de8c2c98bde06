"""ChatGLM3-6B [arXiv:2406.12793; hf THUDM/chatglm3-6b].

28L, d_model 4096, 32 q-heads, GQA kv=2, d_ff 13696, vocab 65024.
2-d RoPE (rotary on half the head dims → rotary_pct 0.5), SwiGLU.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    attention="gqa",
    rotary_pct=0.5,
    act="silu",
    gated_mlp=True,
)

SMOKE = ArchConfig(
    name="chatglm3-6b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=128,
    attention="gqa",
    rotary_pct=0.5,
    act="silu",
    gated_mlp=True,
)
