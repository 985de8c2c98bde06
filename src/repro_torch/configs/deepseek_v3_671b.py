"""DeepSeek-V3 671B [arXiv:2412.19437; hf deepseek-ai/DeepSeek-V3].

61L, d_model 7168, 128 heads, MLA (q-LoRA 1536, kv-LoRA 512,
qk nope 128 + rope 64, v 128). MoE: 1 shared + 256 routed top-8
(expert d_ff 2048), first 3 layers dense (d_ff 18432). Sigmoid router,
aux-loss-free (alpha 0). MTP head on. vocab 129280.
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=0,
    vocab_size=129_280,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    d_head=192,  # qk_nope + qk_rope (scores dim)
    act="silu",
    gated_mlp=True,
    n_experts=256,
    n_shared_experts=1,
    moe_top_k=8,
    moe_d_ff=2048,
    first_k_dense=3,
    dense_d_ff=18432,
    router_score="sigmoid",
    moe_aux_alpha=0.0,
    mtp=True,
)

SMOKE = ArchConfig(
    name="deepseek-v3-671b-smoke",
    family="moe",
    n_layers=3,  # 1 dense + 2 moe
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=128,
    attention="mla",
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    d_head=24,
    act="silu",
    gated_mlp=True,
    n_experts=8,
    n_shared_experts=1,
    moe_top_k=2,
    moe_d_ff=32,
    first_k_dense=1,
    dense_d_ff=96,
    router_score="sigmoid",
    moe_aux_alpha=0.0,
    mtp=True,
)
