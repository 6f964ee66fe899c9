"""GQA attention: block gather, full-sequence softmax attention, QKV
projection and init.

Counterpart of ``repro/models/attention.py`` (dense GQA only).
:func:`multi_head_attention` dispatches by device.  On the CPU it takes the
JAX package's two plain paths: direct (materialized scores) up to
``DIRECT_MAX_KV`` keys, blockwise (online softmax over 1024 x 1024 blocks)
above it or when forced.  On the card it runs the flash-attention kernel
through :class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`,
the hand-written counterpart of the TPU kernel the JAX module names as
"the TPU-tiled version of the same algorithm".
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import FlashAttentionFn
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


def _causal_mask(q_pos, k_pos, window) -> torch.Tensor:
    """(Sq, Sk) bool: key at or before the query, inside the window."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def _direct_attention(q, k, v, q_pos, k_pos, *, causal, window, scale):
    """q: (B,Sq,Hkv,G,D), k/v: (B,Sk,Hkv,·) -> (B,Sq,Hkv,G,Dv).  The
    weights are cast to ``v``'s dtype before the value product."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale
    if causal:
        s = torch.where(_causal_mask(q_pos, k_pos, window), s,
                        torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", w.to(v.dtype), v)


def _blockwise_attention(q, k, v, q_pos, k_pos, *, causal, window, scale,
                         block_q: int = 1024, block_k: int = 1024):
    """Online-softmax attention over ``block_q x block_k`` blocks (Python
    loops where the JAX package scans); same signature as the direct
    path.  Padded key positions sit at 2**30, so the causal mask hides
    them; sums in float32, cast to ``v``'s dtype per query block."""
    B, Sq, Hkv, G, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    pad_k = nk * bk - Sk
    k_ = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
    v_ = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
    kp = torch.cat([k_pos, torch.full((pad_k,), 2 ** 30, dtype=k_pos.dtype,
                                      device=k_pos.device)])
    outs = []
    for qi in range(nq):
        qblk, qpos = q[:, qi * bq:(qi + 1) * bq], q_pos[qi * bq:(qi + 1) * bq]
        n = qblk.shape[1]
        m = torch.full((B, Hkv, G, n), NEG_INF, device=q.device)
        den = torch.zeros((B, Hkv, G, n), device=q.device)
        acc = torch.zeros((B, Hkv, G, n, Dv), device=q.device)
        for ki in range(nk):
            blk = slice(ki * bk, (ki + 1) * bk)
            kblk, vblk, kpos = k_[:, blk], v_[:, blk], kp[blk]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kblk).float() * scale
            if causal:
                msk = _causal_mask(qpos, kpos, window)
            else:
                msk = (kpos < Sk)[None, :].expand(n, bk)
            s = torch.where(msk, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            den = den * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vblk.float())
            m = m_new
        out = acc / den.clamp_min(1e-30)[..., None]
        outs.append(out.to(v.dtype).permute(0, 3, 1, 2, 4))  # (B,n,Hkv,G,Dv)
    return torch.cat(outs, dim=1)


def _is_arange(pos: torch.Tensor, n: int) -> bool:
    return pos.shape == (n,) and bool(torch.equal(
        pos, torch.arange(n, dtype=pos.dtype, device=pos.device)))


def multi_head_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                         window: Optional[int] = None,
                         scale: Optional[float] = None,
                         force_blockwise: Optional[bool] = None
                         ) -> torch.Tensor:
    """q: (B,Sq,H,D), k/v: (B,Sk,Hkv,·) with H % Hkv == 0 -> (B,Sq,H,Dv).

    CPU tensors take the JAX package's direct path (scores and softmax in
    float32, weights cast to ``v``'s dtype before the value product) up to
    ``DIRECT_MAX_KV`` keys and the blockwise path above it, or as
    ``force_blockwise`` says.  CUDA tensors run the flash-attention kernel
    (differentiable through :class:`FlashAttentionFn`), which takes
    self-attention over positions ``0..S-1`` with the default scale; any
    other call on the card raises rather than taking another path."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if q.device.type == "cuda":
        if not (Sq == Sk and _is_arange(q_pos, Sq)
                and _is_arange(k_pos, Sk)):
            raise ValueError("on the card multi_head_attention takes self-"
                             "attention over positions arange(S) only")
        if scale is not None and scale != D ** -0.5:
            raise ValueError("the flash kernel uses the scale D ** -0.5")
        if force_blockwise:
            raise ValueError("force_blockwise selects a CPU path")
        return FlashAttentionFn.apply(q, k, v, causal, window)
    G = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, D)
    use_blockwise = (Sk > DIRECT_MAX_KV if force_blockwise is None
                     else force_blockwise)
    fn = _blockwise_attention if use_blockwise else _direct_attention
    out = fn(qg, k, v, q_pos, k_pos, causal=causal, window=window,
             scale=scale)
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


def gqa_apply_full(p: dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: Optional[torch.Tensor], *, window=None,
                   rope_theta: Optional[float] = None,
                   causal: bool = True) -> torch.Tensor:
    """Full-sequence self-attention. x: (B,S,d) -> (B,S,d)."""
    q, k, v = gqa_project_qkv(p, cfg, x, positions, rope_theta=rope_theta)
    pos = (positions if positions is not None
           else torch.arange(x.shape[1], device=x.device))
    qpos = pos[0] if pos.dim() == 2 else pos
    out = multi_head_attention(q, k, v, qpos, qpos, causal=causal,
                               window=window)
    return attn_out(out, p["wo"])
