"""Mamba2-780m [arXiv:2405.21060; hf state-spaces/mamba2-780m] — SSD.

48L, d_model 1536 (attention-free), vocab 50280, ssm_state 128,
expand 2 (d_inner 3072), head dim 64 (48 SSD heads), conv 4.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=128,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="mamba2-780m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=128,
    attention="none",
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=16,
    tie_embeddings=True,
)
