"""Zamba2-2.7B — Mamba2 trunk + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,          # shared attention block is full MHA
    d_ff=10240,
    vocab_size=32000,
    attention="gqa",          # used by the shared attention block only
    ssm_state_dim=64,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_attn_every=6,      # one shared attn block every 6 mamba2 blocks
    tie_embeddings=True,
    subquadratic=True,        # mamba2 state decode is O(1) -> long_500k runs
))
