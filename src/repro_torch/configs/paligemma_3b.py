"""PaliGemma-3B [arXiv:2407.07726; hf google/paligemma-3b-pt-224].

Gemma-2B text backbone: 18L, d_model 2048, 8 q-heads (MQA kv=1,
d_head 256), d_ff 16384 (GeGLU), vocab 257216, sqrt(d) embedding scale.
The SigLIP vision tower is a STUB — input_specs() provides precomputed
patch+text embeddings [B, S, d_model]. q-heads pad 8→16 for the 16-way
model axis.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=257_216,
    attention="gqa",
    d_head=256,
    act="gelu",
    gated_mlp=True,
    input_mode="embeddings",
    embed_scale=True,
)

SMOKE = ArchConfig(
    name="paligemma-3b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=192,
    vocab_size=256,
    attention="gqa",
    d_head=16,
    act="gelu",
    gated_mlp=True,
    input_mode="embeddings",
    embed_scale=True,
)
