"""GQA attention: block gather, full-sequence softmax attention, QKV
projection and init.

Counterpart of ``repro/models/attention.py`` (dense GQA only).  Prefill
uses :func:`multi_head_attention`'s direct path (materialized scores); the
blockwise path for key lengths above ``DIRECT_MAX_KV`` comes with the
training slice, together with the flash-attention kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import apply_rope, dense_init, torch_dtype

NEG_INF = -1.0e30
DIRECT_MAX_KV = 4096  # direct path threshold


def gather_blocks(pool: torch.Tensor, table: torch.Tensor,
                  axis: int = 0) -> torch.Tensor:
    """Materialize a contiguous sequence view from a paged KV pool.

    ``pool`` carries a (num_blocks, block_size) axis pair starting at
    ``axis``; ``table`` is a 1-D vector of physical block ids (0 = the null
    block, whose contents callers mask).  Returns ``pool`` with the two
    block axes merged into one sequence axis of ``len(table) *
    block_size``.
    """
    g = pool.index_select(axis, table.long())
    shape = (g.shape[:axis] + (g.shape[axis] * g.shape[axis + 1],)
             + g.shape[axis + 2:])
    return g.reshape(shape)


def multi_head_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,D), k/v: (B,Sk,Hkv,·) with H % Hkv == 0 -> (B,Sq,H,Dv).

    Scores and softmax in float32 over materialized scores; the weights
    are cast to ``v``'s dtype before the value product, as in the JAX
    direct path."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if Sk > DIRECT_MAX_KV:
        raise NotImplementedError(
            f"key length {Sk} > {DIRECT_MAX_KV} needs the blockwise path, "
            f"which comes with the training slice (flash attention)")
    G = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
    if causal:
        m = k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            m &= (q_pos[:, None] - k_pos[None, :]) < window
        s = torch.where(m, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)
    return out.reshape(B, Sq, H, -1)


def gqa_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = torch_dtype(cfg.dtype)
    hd = cfg.resolved_head_dim
    d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(gen, d, (H, hd), dt),
        "wk": dense_init(gen, d, (Hkv, hd), dt),
        "wv": dense_init(gen, d, (Hkv, hd), dt),
        "wo": dense_init(gen, H * hd, (d,), dt).reshape(H, hd, d),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", H), ("bk", Hkv), ("bv", Hkv)):
            p[name] = torch.zeros((n, hd), dtype=dt, device=gen.device)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe") as one matrix product."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e)).reshape(*x.shape[:-1], h, e)


def gqa_project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: Optional[torch.Tensor], *,
                    rope_theta: Optional[float] = None):
    """x: (B,S,d) -> q (B,S,H,hd), k/v (B,S,Hkv,hd), RoPE applied to q/k."""
    q, k, v = (_project(x, p["wq"]), _project(x, p["wk"]),
               _project(x, p["wv"]))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    theta = cfg.rope_theta if rope_theta is None else rope_theta
    if positions is not None and theta > 0:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def attn_out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshe,hed->bsd"): o (..., H, hd) x wo (H, hd, d) -> (..., d)."""
    H, e, d = wo.shape
    return o.reshape(*o.shape[:-2], H * e) @ wo.reshape(H * e, d)
