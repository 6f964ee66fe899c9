"""DeepSeek-V2-236B — MLA (kv_lora=512) + MoE 2 shared + 160 routed top-6
[arXiv:2405.04434].

Assigned spec lists d_ff=1536 = routed-expert width; the single leading dense
layer uses the published 12288 hidden width.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,          # MLA: kv heads == heads post up-projection
    head_dim=128,              # qk_nope_head_dim
    v_head_dim=128,
    d_ff=12288,                # dense (first layer) hidden width
    moe_d_ff=1536,             # routed expert width (assigned d_ff)
    vocab_size=102400,
    attention="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_rope_head_dim=64,
    rope_theta=1.0e4,
    num_experts=160,
    num_experts_per_tok=6,
    num_shared_experts=2,
    first_dense_layers=1,
    subquadratic=False,
))
