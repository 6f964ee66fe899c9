"""Layer-stack parameters, the pieces every stack step shares (init,
embedding, unembedding, norms, the per-layer rope theta and window) and
the full-sequence training forward :func:`stack_forward`.

Counterpart of ``repro/models/stacks.py``, dense GQA branch.  Where the
JAX package stacks layers on axis 0 for ``lax.scan``, the port keeps
``params["layers"]`` as a Python list of per-layer dicts and loops over it.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (dense_init, embed_init, mlp_apply,
                                       mlp_init, rms_norm, torch_dtype)
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


def _dense_layer(lp: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, theta: float,
                 window: int) -> torch.Tensor:
    h = _norm(lp["ln1"], x, cfg)
    x = x + attn.gqa_apply_full(lp["attn"], cfg, h, positions,
                                window=window, rope_theta=theta)
    h = _norm(lp["ln2"], x, cfg)
    return x + mlp_apply(lp["mlp"], h)


def stack_forward(p: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                  remat: bool = False):
    """tokens: (B,S) integer -> (logits (B,S,V) float32, aux scalar 0).

    Dense GQA only; the other families raise.  ``remat=True`` wraps each
    layer in ``torch.utils.checkpoint`` (non-reentrant), the counterpart of
    the JAX package's ``jax.checkpoint`` around the scanned layer body: the
    layer's activations are recomputed in the backward pass."""
    if cfg.family != "dense" or cfg.attention != "gqa":
        raise NotImplementedError(
            f"stack_forward for family {cfg.family!r} / attention "
            f"{cfg.attention!r} is not ported yet: it comes with the "
            f"other-architectures slice (ROADMAP, modules to port)")
    B, S = tokens.shape
    x = _embed_tokens(p, cfg, tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)
    for lp, (theta, window) in zip(p["layers"], _layer_theta_window(cfg)):
        if remat:
            x = checkpoint(_dense_layer, lp, cfg, x, positions, theta,
                           window, use_reentrant=False)
        else:
            x = _dense_layer(lp, cfg, x, positions, theta, window)
    return _unembed(p, cfg, x), torch.zeros((), dtype=torch.float32,
                                            device=x.device)
