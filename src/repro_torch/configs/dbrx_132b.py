"""DBRX-132B — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,                # == routed expert width for dbrx
    moe_d_ff=10752,
    vocab_size=100352,
    attention="gqa",
    rope_theta=5.0e5,
    num_experts=16,
    num_experts_per_tok=4,
    subquadratic=False,
))
