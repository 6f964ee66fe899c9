"""Qwen2.5-32B — dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B scaled]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    attention="gqa",
    qkv_bias=True,
    rope_theta=1.0e6,
    subquadratic=False,
))
