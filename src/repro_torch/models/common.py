"""Shared model building blocks: dtypes, inits, RMSNorm, SwiGLU MLP, RoPE.

Counterpart of ``repro/models/common.py``.  Weights keep the JAX package's
layouts (``(in, *out)`` for dense kernels), so converted parameters drop in
unchanged and the parity tests compare like with like.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name -> torch dtype."""
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"choose from {sorted(DTYPES)}")
    return DTYPES[name]


# ---------------------------------------------------------------------------
# Inits (explicit generator; the generator's device is the params' device)
# ---------------------------------------------------------------------------
def truncated_normal_init(gen: torch.Generator, shape, scale: float,
                          dtype: torch.dtype) -> torch.Tensor:
    """Fan-in scaled normal truncated at two standard deviations, drawn in
    float32 and cast, as the JAX package's ``truncated_normal_init``."""
    stddev = scale / math.sqrt(max(shape[0], 1))
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * stddev).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_shape: tuple,
               dtype: torch.dtype) -> torch.Tensor:
    return truncated_normal_init(gen, (in_dim, *out_shape), 1.0, dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), dtype=torch.float32, device=gen.device,
                    generator=gen)
    return (w * 0.02).to(dtype)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype) -> dict:
    return {"wi_gate": dense_init(gen, d_model, (d_ff,), dtype),
            "wi_up": dense_init(gen, d_model, (d_ff,), dtype),
            "wo": dense_init(gen, d_ff, (d_model,), dtype)}


# ---------------------------------------------------------------------------
# Norm / MLP
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32 with the weight applied as ``1 + w`` (zero-init
    weights are the identity), cast back to ``x``'s dtype."""
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (xf * (1.0 + w.float())).to(dt)


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) * x W_up) W_o``."""
    return (F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"]


# ---------------------------------------------------------------------------
# RoPE (split-half rotation)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integer.  Rotates the two halves
    of the head dim against each other in float32; ``theta <= 0`` is the
    no-rotary case."""
    if theta <= 0:
        return x
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    ang = positions.float()[..., None] * freqs                 # (B, S, D/2)
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
