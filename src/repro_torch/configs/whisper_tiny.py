"""Whisper-tiny — encoder-decoder ASR backbone [arXiv:2212.04356].

Mel-spectrogram + conv frontend is a STUB per spec: ``input_specs()`` supplies
precomputed frame embeddings (batch, 1500, d_model) to the encoder.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=4,              # decoder layers
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    attention="gqa",           # MHA (kv == heads)
    qkv_bias=True,
    cross_attention=True,
    max_source_len=1500,
    frontend="audio",
    num_frontend_tokens=1500,
    rope_theta=0.0,            # whisper uses learned positions, not RoPE
    tie_embeddings=True,
    subquadratic=False,
))
