"""MusicGen-medium [arXiv:2306.05284; hf facebook/musicgen-medium].

48L decoder over EnCodec tokens: d_model 1536, 24 heads (MHA),
d_ff 6144, vocab 2048 per codebook × 4 codebooks. The EnCodec frontend
is a STUB — input_specs() provides precomputed frame embeddings
[B, S, d_model]; the 4 per-codebook output heads are real. (MusicGen's
sinusoidal positions are replaced by RoPE — backbone-equivalent compute,
noted in DESIGN.)
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    attention="gqa",
    act="gelu",
    gated_mlp=False,
    input_mode="embeddings",
    n_codebooks=4,
)

SMOKE = ArchConfig(
    name="musicgen-medium-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=64,
    attention="gqa",
    act="gelu",
    gated_mlp=False,
    input_mode="embeddings",
    n_codebooks=4,
)
