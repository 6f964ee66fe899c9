"""RWKV6-7B (Finch) — attention-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=32,
    d_model=4096,
    num_heads=64,              # rwkv heads (head_dim 64)
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    attention="none",          # token-mix is the rwkv6 recurrence
    ssm_state_dim=64,          # per-head (head_dim x head_dim) wkv state
    ssm_head_dim=64,
    subquadratic=True,         # O(1) decode state -> long_500k runs
))
