"""Qwen2-VL-7B language backbone — M-RoPE, dynamic resolution [arXiv:2409.12191].

Vision encoder (ViT + merger) is a STUB per spec: ``input_specs()`` supplies
precomputed patch embeddings of shape (batch, num_frontend_tokens, d_model).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    source="arXiv:2409.12191",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    attention="gqa",
    qkv_bias=True,
    rope_theta=1.0e6,
    mrope=True,
    frontend="vision",
    num_frontend_tokens=256,     # stubbed patch-embedding prefix per sample
    tie_embeddings=False,
    subquadratic=False,          # full attention -> long_500k skipped
))
