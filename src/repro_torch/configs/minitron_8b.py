"""Minitron-8B — width-pruned Nemotron-4, dense GQA [arXiv:2407.14679]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minitron-8b",
    family="dense",
    source="arXiv:2407.14679",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    attention="gqa",
    rope_theta=1.0e4,
    subquadratic=False,
))
