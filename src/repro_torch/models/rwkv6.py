"""RWKV6 (Finch) block: data-dependent token shift and the per-channel
decay WKV recurrence [arXiv:2404.05892].  Counterpart of
``repro/models/rwkv6.py``.

The token mix keeps one shift vector per layer and the ``(H, hd, hd)`` WKV
state for decode; the channel mix keeps its own shift vector.  Prefill and
the training forward run the recurrence through
``kernels.rwkv6_scan.Rwkv6ScanFn`` (the CUDA kernel on CUDA tensors, its
plain version on CPU tensors; a plain recompute backward); decode steps it
in plain PyTorch (``models.linear_scan.decay_attention_decode_step``), as
the JAX package has no decode kernel for it.  Dtypes follow the JAX package: r, k,
v and the gate stay in the model dtype, log_w is float32 (the low-rank
decay term is cast before it is added to ``w0``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_scan import Rwkv6ScanFn
from repro_torch.models.common import (dense_init, group_norm_heads,
                                       torch_dtype)
from repro_torch.models.linear_scan import decay_attention_decode_step

MIX_RANK = 32
DECAY_RANK = 64
N_MIX = 5  # r, k, v, w, g
LN_X_EPS = 64e-5


def _dims(cfg: ModelConfig) -> tuple[int, int]:
    H = cfg.num_heads
    hd = cfg.resolved_head_dim
    assert H * hd == cfg.d_model
    return H, hd


def rwkv6_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random block parameters on ``gen``'s device, with the JAX package's
    shapes, dtypes and scales (``w0`` -6 and ``u`` zeros in float32)."""
    dt = torch_dtype(cfg.dtype)
    d = cfg.d_model
    H, hd = _dims(cfg)
    dev = gen.device

    def normal(shape):
        w = torch.randn(shape, dtype=torch.float32, device=dev,
                        generator=gen)
        return (w * 0.02).to(dt)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        # token mix
        "mu_x": zeros((d,)),
        "mu": zeros((N_MIX, d)),
        "tm_w1": dense_init(gen, d, (N_MIX * MIX_RANK,), dt),
        "tm_w2": normal((N_MIX, MIX_RANK, d)),
        "w0": torch.full((d,), -6.0, dtype=torch.float32, device=dev),
        "w1": dense_init(gen, d, (DECAY_RANK,), dt),
        "w2": normal((DECAY_RANK, d)),
        "wr": dense_init(gen, d, (d,), dt),
        "wk": dense_init(gen, d, (d,), dt),
        "wv": dense_init(gen, d, (d,), dt),
        "wg": dense_init(gen, d, (d,), dt),
        "wo": dense_init(gen, d, (d,), dt),
        "u": zeros((H, hd), torch.float32),
        "ln_x": torch.ones((H, hd), dtype=dt, device=dev),
        # channel mix
        "cm_mu_k": zeros((d,)),
        "cm_mu_r": zeros((d,)),
        "cm_wk": dense_init(gen, d, (cfg.d_ff,), dt),
        "cm_wv": dense_init(gen, cfg.d_ff, (d,), dt),
        "cm_wr": dense_init(gen, d, (d,), dt),
    }


def rwkv6_specs(cfg: ModelConfig) -> dict:
    """Logical axes of :func:`rwkv6_init`'s leaves."""
    return {
        "mu_x": ("embed",), "mu": (None, "embed"),
        "tm_w1": ("embed", None), "tm_w2": (None, None, "embed"),
        "w0": ("embed",), "w1": ("embed", None), "w2": (None, "embed"),
        "wr": ("embed", "ssm_inner"), "wk": ("embed", "ssm_inner"),
        "wv": ("embed", "ssm_inner"), "wg": ("embed", "ssm_inner"),
        "wo": ("ssm_inner", "embed"),
        "u": ("heads", "head_dim"), "ln_x": ("heads", "head_dim"),
        "cm_mu_k": ("embed",), "cm_mu_r": ("embed",),
        "cm_wk": ("embed", "ffn"), "cm_wv": ("ffn", "embed"),
        "cm_wr": ("embed", "ssm_inner"),
    }


def _shift(x, last=None):
    """xx[t] = x[t-1]; the first position comes from ``last`` (decode
    state), zeros without it."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def _token_mix_inputs(p, cfg, x, xx):
    dx = xx - x
    base = x + dx * p["mu_x"]
    B, S = x.shape[:2]
    z = torch.tanh(base @ p["tm_w1"]).reshape(B, S, N_MIX, MIX_RANK)
    mixes = torch.einsum("bsfr,frd->bsfd", z, p["tm_w2"]) + p["mu"]
    xi = x[:, :, None, :] + dx[:, :, None, :] * mixes        # (B,S,5,d)
    x_r, x_k, x_v, x_w, x_g = xi.unbind(2)
    H, hd = _dims(cfg)
    r = (x_r @ p["wr"]).reshape(B, S, H, hd)
    k = (x_k @ p["wk"]).reshape(B, S, H, hd)
    v = (x_v @ p["wv"]).reshape(B, S, H, hd)
    g = F.silu(x_g @ p["wg"])
    lw = p["w0"] + (torch.tanh(x_w @ p["w1"]) @ p["w2"]).float()
    log_w = -torch.exp(lw).reshape(B, S, H, hd)               # <= 0
    return r, k, v, g, log_w


def _token_mix_out(p, cfg, y, g, x_shape, dtype):
    y = group_norm_heads(y, p["ln_x"], LN_X_EPS).reshape(
        *x_shape[:2], cfg.d_model)
    return (y.to(dtype) * g) @ p["wo"]


def rwkv6_time_mix_full(p, cfg: ModelConfig, x, *, initial=None):
    """Token mix over a whole sequence x (B, S, d), the prefill's and the
    training forward's (differentiable through :class:`Rwkv6ScanFn`).
    ``initial``: (last_x (B, d), wkv state (B, H, hd, hd)) or None; an
    initial state runs only on CPU tensors (the kernel starts from zero).
    Returns ``(out, (last x, final wkv state))``."""
    last_x = None if initial is None else initial[0]
    xx = _shift(x, last_x)
    r, k, v, g, log_w = _token_mix_inputs(p, cfg, x, xx)
    st0 = None if initial is None else initial[1]
    y, state = Rwkv6ScanFn.apply(r, k, v, log_w, p["u"], st0)
    out = _token_mix_out(p, cfg, y, g, x.shape, x.dtype)
    return out, (x[:, -1], state)


def rwkv6_time_mix_step(p, cfg: ModelConfig, x, last_x, state):
    """One token, x (B, 1, d).  Returns ``(out, new last_x, new state)``."""
    xx = last_x[:, None]
    r, k, v, g, log_w = _token_mix_inputs(p, cfg, x, xx)
    y, state = decay_attention_decode_step(
        state, r[:, 0], k[:, 0], v[:, 0], log_w[:, 0], p["u"])
    out = _token_mix_out(p, cfg, y[:, None], g, x.shape, x.dtype)
    return out, x[:, 0], state


def rwkv6_channel_mix(p, cfg: ModelConfig, x, last_x=None):
    """A whole sequence (last_x None or (B, d)) and a single step alike.
    Returns ``(out, last x)``."""
    xx = _shift(x, last_x)
    xk = x + (xx - x) * p["cm_mu_k"]
    xr = x + (xx - x) * p["cm_mu_r"]
    kk = torch.square(torch.relu(xk @ p["cm_wk"]))
    return torch.sigmoid(xr @ p["cm_wr"]) * (kk @ p["cm_wv"]), x[:, -1]


def rwkv6_init_state(cfg: ModelConfig, batch: int, *, device) -> dict:
    """Zeroed per-layer decode state of one block."""
    H, hd = _dims(cfg)
    dt = torch_dtype(cfg.dtype)
    return {
        "att_x": torch.zeros((batch, cfg.d_model), dtype=dt, device=device),
        "ffn_x": torch.zeros((batch, cfg.d_model), dtype=dt, device=device),
        "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                           device=device),
    }
