"""Layer-stack parameters and the pieces every stack step shares: init,
embedding, unembedding, norms and the per-layer (rope theta, window).

Counterpart of ``repro/models/stacks.py``, dense GQA branch.  Where the
JAX package stacks layers on axis 0 for ``lax.scan``, the port keeps
``params["layers"]`` as a Python list of per-layer dicts and loops over it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (dense_init, embed_init, mlp_init,
                                       rms_norm, torch_dtype)
from repro_torch.models.kvcache import check_supported

NO_WINDOW = 2 ** 30     # far beyond any max_seq_len: never masks


def _norm(w: torch.Tensor, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(x, w, cfg.norm_eps)


def _layer_theta_window(cfg: ModelConfig) -> list[tuple[float, int]]:
    """Per-layer ``(rope_theta, window)``: ``local_global_ratio`` local
    layers (theta 1e4, sliding window) per global layer, else one pair for
    every layer."""
    if cfg.local_global_ratio and cfg.sliding_window:
        r = cfg.local_global_ratio
        return [(cfg.rope_theta, NO_WINDOW) if i % (r + 1) == r
                else (1.0e4, cfg.sliding_window)
                for i in range(cfg.num_layers)]
    w = cfg.sliding_window if cfg.sliding_window else NO_WINDOW
    return [(cfg.rope_theta, w)] * cfg.num_layers


def stack_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen``'s device: ``embed (V, d)``,
    ``final_norm (d,)``, ``lm_head (d, V)`` and ``layers``, a list of
    ``{"ln1", "ln2", "attn": {wq, wk, wv, wo}, "mlp": {wi_gate, wi_up,
    wo}}`` in the JAX package's weight layouts."""
    check_supported(cfg)
    dt = torch_dtype(cfg.dtype)
    dev = gen.device

    def norm():
        return torch.zeros((cfg.d_model,), dtype=dt, device=dev)

    p: dict = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
               "final_norm": norm()}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, (cfg.vocab_size,), dt)
    p["layers"] = [{"ln1": norm(), "ln2": norm(),
                    "attn": attn.gqa_init(gen, cfg),
                    "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dt)}
                   for _ in range(cfg.num_layers)]
    return p


def _embed_tokens(p: dict, cfg: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    x = p["embed"][tokens.long()]
    if cfg.local_global_ratio:           # gemma3 scales its embeddings
        x = x * math.sqrt(cfg.d_model)
    return x


def _unembed(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and vocabulary projection; float32 logits."""
    x = _norm(p["final_norm"], x, cfg)
    w = p["embed"].t() if cfg.tie_embeddings else p["lm_head"]
    return (x @ w).float()
