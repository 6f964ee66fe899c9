"""Shared model building blocks: dtypes, inits, RMSNorm, LayerNorm, per-head
group norm, the SwiGLU and gelu MLPs, RoPE and M-RoPE.

Counterpart of ``repro/models/common.py``.  Weights keep the JAX package's
layouts (``(in, *out)`` for dense kernels), so converted parameters drop in
unchanged and the parity tests compare like with like.  Every ``*_init``
has a parallel ``*_specs`` returning the same tree with logical-axis tuples
as leaves (consumed by ``models.sharding``).
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
class AbstractGenerator(torch.Generator):
    """A generator handle whose ``device`` is ``meta``.  Every init helper
    allocates and draws on ``gen.device``, so an init given this handle
    builds the parameter tree of shapes and dtypes as empty meta tensors
    and draws nothing (``Model.init_abstract``): the same code path as a
    real init, with no storage behind it."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


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


def mlp_specs(cfg) -> dict:
    """Logical axes of :func:`mlp_init`'s leaves (``models.sharding``)."""
    return {"wi_gate": ("embed", "ffn"), "wi_up": ("embed", "ffn"),
            "wo": ("ffn", "embed")}


# ---------------------------------------------------------------------------
# Norm / MLP
# ---------------------------------------------------------------------------
# A reduction on the card may split a row differently for different row
# counts below 16 (``norm_rows.py``: the plain mean rounded a row at 2-7
# rows unlike at 8), so a decode step's norm could round a slot's row one
# way in an engine of 4 slots and another in one of 8, and a greedy token
# flip where two logits nearly tie (an elastic engine serves on several
# slot counts).  Fewer rows than NORM_GROUPS therefore take the mean of
# squares in two reductions whose shapes hold at any row count: NORM_GROUPS
# partial means a row (at least NORM_GROUPS outputs, each over a fixed
# width), then their mean.  From NORM_GROUPS rows on (prefill, training,
# decode at 16 slots) the plain mean rounds every row alike and is kept.
NORM_GROUPS = 16


def _mean_square(xf: torch.Tensor) -> torch.Tensor:
    """Mean of squares over the last axis, keepdim: for fewer than
    NORM_GROUPS rows (and a width that is a multiple of it) the mean of
    NORM_GROUPS partial means, else the plain mean."""
    d = xf.shape[-1]
    if xf.numel() >= NORM_GROUPS * d or d % NORM_GROUPS:
        return xf.pow(2).mean(-1, keepdim=True)
    return xf.pow(2).unflatten(-1, (NORM_GROUPS, d // NORM_GROUPS)).mean(
        -1).mean(-1, keepdim=True)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32 with the weight applied as ``1 + w`` (zero-init
    weights are the identity), cast back to ``x``'s dtype."""
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(_mean_square(xf) + eps)
    return (xf * (1.0 + w.float())).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in float32 with weight and bias (the
    audio family's norm), cast back to ``x``'s dtype."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).pow(2).mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * w.float() + b.float()).to(dt)


def group_norm_heads(x: torch.Tensor, w: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """Per-head group norm over the last dim in float32; x: (..., H, D),
    w: (H, D); cast back to ``x``'s dtype."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).pow(2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.float()).to(dt)


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: ``(silu(x W_gate) * x W_up) W_o``."""
    return (F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"]


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype: torch.dtype) -> dict:
    """The audio family's MLP: ``wi (d, d_ff)``, ``bi``, ``wo (d_ff, d)``,
    ``bo``; zero biases, as the JAX package's init."""
    dev = gen.device
    return {"wi": dense_init(gen, d_model, (d_ff,), dtype),
            "bi": torch.zeros((d_ff,), dtype=dtype, device=dev),
            "wo": dense_init(gen, d_ff, (d_model,), dtype),
            "bo": torch.zeros((d_model,), dtype=dtype, device=dev)}


def gelu_mlp_specs(cfg) -> dict:
    """Logical axes of :func:`gelu_mlp_init`'s leaves."""
    return {"wi": ("embed", "ffn"), "bi": ("ffn",),
            "wo": ("ffn", "embed"), "bo": ("embed",)}


def gelu_mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``gelu_tanh(x W_i + b_i) W_o + b_o``."""
    return F.gelu(x @ p["wi"] + p["bi"], approximate="tanh") @ p["wo"] \
        + p["bo"]


# ---------------------------------------------------------------------------
# RoPE (split-half rotation)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    # a Python base, not a tensor made from it: no host-to-device copy, so
    # a CUDA graph can capture the decode step (the same float32 pow)
    return 1.0 / torch.pow(float(theta), exps)


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


# ---------------------------------------------------------------------------
# M-RoPE: the rotary channels split into (temporal, height, width) sections
# in qwen2-vl's proportions (16, 24, 24) of head_dim / 2 = 64
# ---------------------------------------------------------------------------
def mrope_sections(half: int) -> tuple[int, int, int]:
    t = half // 4
    h = (half - t) // 2
    return (t, h, half - t - h)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, ...] | None = None) -> torch.Tensor:
    """x: (B, S, H, D); positions3: (3, B, S) integer (t, h, w) ids.  Each
    rotary channel takes its section's id; the rotation is
    :func:`apply_rope`'s.  The channels' ids are gathered by slicing, with
    no host tensor, so that a CUDA graph can capture the decode step."""
    half = x.shape[-1] // 2
    sections = sections or mrope_sections(half)
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (half,)
    pos = positions3.float()                                   # (3, B, S)
    chan = torch.cat([pos[i, ..., None].expand(*pos.shape[1:], n)
                      for i, n in enumerate(sections)], dim=-1)
    ang = chan * freqs                                         # (B, S, half)
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_positions_at(t: torch.Tensor, num_frontend: int) -> torch.Tensor:
    """The repo's stub M-RoPE ids at integer positions ``t`` (any shape):
    ``(3, *t.shape)`` int32.  The first ``num_frontend`` positions are
    image patches on a square grid of side ``isqrt(num_frontend)`` (t 0,
    h ``i // side``, w ``i % side``); text positions have t ``i -
    num_frontend + 1`` and h = w = ``i``.  Computed on ``t``'s device with
    no host sync (the decode step's per-slot ids)."""
    side = max(int(math.sqrt(max(num_frontend, 1))), 1)
    t = t.long()
    img = t < num_frontend
    h = torch.where(img, t // side, t)
    w = torch.where(img, t % side, t)
    tt = torch.where(img, torch.zeros_like(t), t - num_frontend + 1)
    return torch.stack([tt, h, w]).to(torch.int32)


def default_mrope_positions(batch: int, seq: int, num_frontend: int,
                            device=None) -> torch.Tensor:
    """Stub M-RoPE ids of a prefill, ``(3, batch, seq)`` int32: those of
    :func:`mrope_positions_at` over ``arange(seq)`` for every row."""
    pos = mrope_positions_at(torch.arange(seq, device=device), num_frontend)
    return pos[:, None, :].expand(3, batch, seq)
