"""Gemma3-4B — 5:1 local(sliding-1024):global attention, 128k [hf:google/gemma-3-1b-pt].

long_500k eligibility: local layers are sliding-window (w=1024); at >=500k the
global layers also fall back to the windowed variant (block-sparse carve noted
in DESIGN.md), keeping decode state sub-quadratic.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-4b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    attention="gqa",
    rope_theta=1.0e6,
    sliding_window=1024,
    local_global_ratio=5,      # 5 local : 1 global
    tie_embeddings=True,
    subquadratic=True,         # sliding-window variant -> long_500k runs
))
