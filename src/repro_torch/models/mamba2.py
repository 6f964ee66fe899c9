"""Mamba2 (SSD) block, zamba2's trunk [arXiv:2405.21060]; decode keeps an
O(1) state.  Counterpart of ``repro/models/mamba2.py``.

Per block: one input projection splits into the gate ``z``, the conv input
``xBC`` and the step sizes ``dt``; a depthwise causal conv of width W runs
over ``xBC``; the SSD recurrence (scalar decay per head, decay applied in
the output read, the diagonal included) runs with ``C`` as the read vector
``r``, ``B`` as the key ``k`` and ``x * dt`` as the value; a gated RMSNorm
and the output projection close it.  Prefill and the training forward run
the recurrence through ``kernels.mamba2_scan.Mamba2ScanFn`` (the CUDA
kernel on CUDA tensors, its plain version on CPU tensors; a plain
recompute backward); decode steps it in plain PyTorch
(``models.linear_scan.decay_attention_decode_step``), as the JAX package
has no decode kernel for it.

Dtypes follow the JAX package: ``r``/``k`` stay in the model dtype and are
broadcasts of one ``(B, S, 1, N)`` slice over the heads (never copied);
``dt``, ``log_w`` and ``v = x * dt`` are float32, so the scan's ``y`` is
float32 until the block casts it back.  The full-sequence projection
carries the reference's sharding annotation (``models.sharding.
constrain``), the identity outside ``activation_sharding``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba2_scan import Mamba2ScanFn
from repro_torch.models.common import dense_init, rms_norm, torch_dtype
from repro_torch.models.linear_scan import decay_attention_decode_step
from repro_torch.models.sharding import constrain


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    inner = cfg.ssm_expand * cfg.d_model
    nh = inner // cfg.ssm_head_dim
    return inner, nh, cfg.ssm_state_dim


def mamba2_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random block parameters on ``gen``'s device, with the JAX package's
    shapes, dtypes and scales (``A_log``, ``D`` and ``dt_bias`` float32)."""
    dt = torch_dtype(cfg.dtype)
    inner, nh, N = _dims(cfg)
    conv_dim = inner + 2 * N
    dev = gen.device
    conv_w = torch.randn((cfg.ssm_conv_width, conv_dim), dtype=torch.float32,
                         device=dev, generator=gen) * 0.02
    return {
        "in_proj": dense_init(gen, cfg.d_model, (2 * inner + 2 * N + nh,),
                              dt),
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                          device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "norm_w": torch.zeros((inner,), dtype=dt, device=dev),
        "out_proj": dense_init(gen, inner, (cfg.d_model,), dt),
    }


def mamba2_specs(cfg: ModelConfig) -> dict:
    """Logical axes of :func:`mamba2_init`'s leaves."""
    return {
        "in_proj": ("embed", "ssm_inner"),
        "conv_w": ("conv", "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "norm_w": ("ssm_inner",),
        "out_proj": ("ssm_inner", "embed"),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    inner, nh, N = _dims(cfg)
    z = proj[..., :inner]
    xBC = proj[..., inner:2 * inner + 2 * N]
    dt = proj[..., 2 * inner + 2 * N:]
    return z, xBC, dt


def _causal_conv(xBC, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv1d of width W.  xBC: (B, S, C); conv_state:
    (B, W-1, C), zeros without it.  Returns ``(silu(conv + b), the last
    W-1 inputs)``; a prompt shorter than W-1 leaves zero padding in the
    state, as the JAX block does."""
    W = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xBC.shape[0], W - 1, xBC.shape[-1]),
                          dtype=xBC.dtype, device=xBC.device)
    else:
        pad = conv_state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)
    S = xBC.shape[1]
    out = sum(xp[:, i:i + S] * conv_w[i] for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else pad
    return F.silu(out + conv_b), new_state


def _ssm_inputs(p, cfg: ModelConfig, x_conv, dt_raw):
    """The scan's inputs: ``x_in (B,S,nh,hd)``; ``r = C`` and ``k = B``
    broadcast to ``(B,S,nh,N)`` (stride 0 over the heads); ``v = x_in * dt``
    float32; ``log_w = -exp(A_log) * dt`` ``(B,S,nh,1)`` float32."""
    inner, nh, N = _dims(cfg)
    B_, S = x_conv.shape[:2]
    x_in = x_conv[..., :inner].reshape(B_, S, nh, cfg.ssm_head_dim)
    Bmat = x_conv[..., inner:inner + N][:, :, None, :]        # (B,S,1,N)
    Cmat = x_conv[..., inner + N:][:, :, None, :]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])             # (B,S,nh)
    log_w = (-torch.exp(p["A_log"]) * dt)[..., None]           # (B,S,nh,1)
    r = Cmat.expand(B_, S, nh, N)
    k = Bmat.expand(B_, S, nh, N)
    v = x_in * dt[..., None]
    return x_in, r, k, v, log_w


def _out(p, cfg: ModelConfig, y, x_in, z, shape, dtype):
    """Skip term ``D * x``, gated RMSNorm and the output projection."""
    inner = _dims(cfg)[0]
    y = y + p["D"][None, None, :, None] * x_in.float()
    y = y.reshape(*shape[:2], inner).to(dtype)
    y = rms_norm(y * F.silu(z), p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"]


def mamba2_apply_full(p, cfg: ModelConfig, x):
    """x: (B, S, d) -> (B, S, d), from zero conv and SSM states (every
    prefill starts from zero); the prefill's and the training forward's
    (differentiable through :class:`Mamba2ScanFn`).  Returns ``(out,
    (conv_state, ssm_state))``."""
    proj = constrain(x @ p["in_proj"], ("batch", "seq", "ffn_act"))
    z, xBC, dt_raw = _split_proj(cfg, proj)
    x_conv, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    x_in, r, k, v, log_w = _ssm_inputs(p, cfg, x_conv, dt_raw)
    y, ssm_state = Mamba2ScanFn.apply(r, k, v, log_w)
    return (_out(p, cfg, y, x_in, z, x.shape, x.dtype),
            (conv_state, ssm_state))


def mamba2_decode_step(p, cfg: ModelConfig, x, conv_state, ssm_state):
    """x: (B, 1, d); conv_state: (B, W-1, C); ssm_state: (B, nh, N, hd)
    float32.  Returns ``(out (B, 1, d), conv_state, ssm_state)``."""
    proj = x @ p["in_proj"]
    z, xBC, dt_raw = _split_proj(cfg, proj)
    x_conv, conv_state = _causal_conv(xBC, p["conv_w"], p["conv_b"],
                                      conv_state)
    x_in, r, k, v, log_w = _ssm_inputs(p, cfg, x_conv, dt_raw)
    y, ssm_state = decay_attention_decode_step(
        ssm_state, r[:, 0], k[:, 0], v[:, 0], log_w[:, 0],
        decay_in_output=True)
    return (_out(p, cfg, y[:, None], x_in, z, x.shape, x.dtype),
            conv_state, ssm_state)


def mamba2_init_state(cfg: ModelConfig, batch: int, *, device) -> dict:
    """Zeroed decode state of one block: ``conv (B, W-1, inner + 2N)`` in
    the model dtype and ``ssm (B, nh, N, hd)`` float32."""
    inner, nh, N = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, inner + 2 * N),
                            dtype=torch_dtype(cfg.dtype), device=device),
        "ssm": torch.zeros((batch, nh, N, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
    }
