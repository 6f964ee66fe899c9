"""GQA and MLA attention: block gather, full-sequence softmax attention,
QKV projection, init and a batched plain one-token decode of each.

Counterpart of ``repro/models/attention.py`` (GQA with its biases, M-RoPE
and cross-attention; deepseek-v2's MLA with its expanded prefill and
absorbed decode).
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
from repro_torch.models.common import (apply_mrope, apply_rope, dense_init,
                                       rms_norm, torch_dtype)

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
    """``pos`` is ``arange(n)`` (on meta, where there are no values to
    read: of its shape)."""
    return pos.shape == (n,) and (pos.device.type == "meta" or bool(
        torch.equal(pos, torch.arange(n, dtype=pos.dtype,
                                      device=pos.device))))


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
    other call on the card raises rather than taking another path.  Meta
    tensors (the cost walk's) take the card's path."""
    Sq, Sk = q.shape[1], k.shape[1]
    if q.device.type in ("cuda", "meta"):
        if not (Sq == Sk and _is_arange(q_pos, Sq)
                and _is_arange(k_pos, Sk)):
            raise ValueError("on the card multi_head_attention takes self-"
                             "attention over positions arange(S) only")
        if scale is not None and scale != q.shape[-1] ** -0.5:
            raise ValueError("the flash kernel uses the scale D ** -0.5")
        if force_blockwise:
            raise ValueError("force_blockwise selects a CPU path")
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return plain_attention(q, k, v, q_pos, k_pos, causal=causal,
                           window=window, scale=scale,
                           force_blockwise=force_blockwise)


def plain_attention(q, k, v, q_pos, k_pos, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None,
                    force_blockwise: Optional[bool] = None) -> torch.Tensor:
    """The JAX package's ``multi_head_attention`` in PyTorch ops, on either
    device: the direct path up to ``DIRECT_MAX_KV`` keys, the blockwise
    path above it (or as ``force_blockwise`` says).  Shapes as
    :func:`multi_head_attention`'s."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
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


def gqa_specs(cfg: ModelConfig) -> dict:
    """Logical axes of :func:`gqa_init`'s leaves."""
    s = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.qkv_bias:
        s |= {"bq": ("heads", "head_dim"), "bk": ("kv_heads", "head_dim"),
              "bv": ("kv_heads", "head_dim")}
    return s


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe") as one matrix product."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e)).reshape(*x.shape[:-1], h, e)


def gqa_project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: Optional[torch.Tensor], *,
                    rope_theta: Optional[float] = None,
                    mrope_positions: Optional[torch.Tensor] = None):
    """x: (B,S,d) -> q (B,S,H,hd), k/v (B,S,Hkv,hd), with the QKV biases
    when the config has them, and M-RoPE over ``mrope_positions`` (3, B,
    S) when given, else RoPE over ``positions`` applied to q/k."""
    q = gqa_project_q(p, cfg, x)
    k, v = gqa_project_kv(p, cfg, x)
    theta = cfg.rope_theta if rope_theta is None else rope_theta
    if mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, theta)
        k = apply_mrope(k, mrope_positions, theta)
    elif positions is not None and theta > 0:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def gqa_project_q(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The query projection alone (with its bias), no rotary: the
    cross-attention's query."""
    q = _project(x, p["wq"])
    return q + p["bq"] if cfg.qkv_bias else q


def gqa_project_kv(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """The key and value projections alone (with their biases), no
    rotary: the cross-attention's K/V of the encoder's output."""
    k, v = _project(x, p["wk"]), _project(x, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def attn_out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshe,hed->bsd"): o (..., H, hd) x wo (H, hd, d) -> (..., d)."""
    H, e, d = wo.shape
    return o.reshape(*o.shape[:-2], H * e) @ wo.reshape(H * e, d)


def gqa_apply_full(p: dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: Optional[torch.Tensor], *, window=None,
                   rope_theta: Optional[float] = None,
                   mrope_positions: Optional[torch.Tensor] = None,
                   causal: bool = True) -> torch.Tensor:
    """Full-sequence self-attention (``causal=False``: bidirectional, the
    audio encoder's). x: (B,S,d) -> (B,S,d)."""
    q, k, v = gqa_project_qkv(p, cfg, x, positions, rope_theta=rope_theta,
                              mrope_positions=mrope_positions)
    pos = (positions if positions is not None
           else torch.arange(x.shape[1], device=x.device))
    qpos = pos[0] if pos.dim() == 2 else pos
    out = multi_head_attention(q, k, v, qpos, qpos, causal=causal,
                               window=window)
    return attn_out(out, p["wo"])


def gqa_apply_cross(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """Cross-attention of x (B,S,d) against precomputed encoder K/V (B,
    Ssrc, Hkv, hd) -> (B,S,d).  Plain PyTorch on either device: neither
    package has a kernel for it (the JAX package runs jnp here), so this
    is its only version."""
    q = gqa_project_q(p, cfg, x)
    qpos = torch.arange(x.shape[1], device=x.device)
    kpos = torch.arange(enc_k.shape[1], device=x.device)
    out = plain_attention(q, enc_k, enc_v, qpos, kpos, causal=False)
    return attn_out(out, p["wo"])


def gqa_decode_step(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    k_cache: torch.Tensor, v_cache: torch.Tensor,
                    index: torch.Tensor, *, window=None,
                    rope_theta: Optional[float] = None, ring: bool = False):
    """One-token decode for a batch of rows, each at its own position, in
    plain PyTorch (the hybrid family's shared attention block).

    x: (B,1,d); k/v_cache: (B,S,Hkv,hd); index: (B,) integer.  Row b
    writes its K/V at position ``index[b]`` and attends over positions
    ``<= index[b]`` (and, with ``window``, ``> index[b] - window``).  A row
    past its stripe (a dead slot that keeps stepping) writes onto the
    stripe's last position and reads only its own stripe, so nothing live
    sees it; the JAX step's ``dynamic_update_slice`` clamps the same way.
    ``ring=True`` treats each stripe as a ring buffer of S slots: position
    ``index[b]`` goes to slot ``index[b] % S``, and each slot's absolute
    position is rebuilt from it to decide validity, as the JAX step does.
    The JAX package's step takes a scalar index and its engine vmaps it
    over the slots; the rows here are as independent.  Caches are updated
    in place; returns ``(out (B,1,d), k_cache, v_cache)``."""
    B = x.shape[0]
    idx = index.long()
    q, k_new, v_new = gqa_project_qkv(p, cfg, x, idx[:, None],
                                      rope_theta=rope_theta)
    S = k_cache.shape[1]
    rows = torch.arange(B, device=x.device)
    widx = idx % S if ring else idx.clamp(max=S - 1)
    k_cache[rows, widx] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, widx] = v_new[:, 0].to(v_cache.dtype)
    H, Hkv = q.shape[2], k_cache.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, -1)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).float()
    s = s * (q.shape[-1] ** -0.5)
    kpos = torch.arange(S, device=x.device)[None, :]
    at = idx[:, None]
    if ring:
        # the slot p holds absolute position index - slot + p (p <= slot)
        # or the lap before it (p > slot)
        slot = widx[:, None]
        abs_pos = torch.where(kpos <= slot, at - slot + kpos,
                              at - slot - S + kpos)
        valid = (abs_pos >= 0) & (abs_pos <= at)
    else:
        abs_pos = kpos
        valid = kpos <= at
    if window is not None:
        valid &= (at - abs_pos) < window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", w.to(v_cache.dtype), v_cache)
    out = out.reshape(B, 1, H, -1)
    return attn_out(out, p["wo"]).to(x.dtype), k_cache, v_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): low-rank KV compression, absorbed decode
# ---------------------------------------------------------------------------
def mla_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The JAX package's MLA weights: ``wq_a (d, qr)``, ``q_norm (qr,)``,
    ``wq_b (qr, H, hd + rp)``, ``wkv_a (d, r + rp)``, ``kv_norm (r,)``,
    ``wkv_b_k (r, H, hd)``, ``wkv_b_v (r, H, vd)``, ``wo (H, vd, d)``."""
    dt = torch_dtype(cfg.dtype)
    d, H = cfg.d_model, cfg.num_heads
    hd, vd = cfg.resolved_head_dim, cfg.resolved_v_head_dim
    r, qr, rp = cfg.kv_lora_rank, cfg.q_lora_rank, cfg.qk_rope_head_dim
    dev = gen.device
    return {
        "wq_a": dense_init(gen, d, (qr,), dt),
        "q_norm": torch.zeros((qr,), dtype=dt, device=dev),
        "wq_b": dense_init(gen, qr, (H, hd + rp), dt),
        "wkv_a": dense_init(gen, d, (r + rp,), dt),
        "kv_norm": torch.zeros((r,), dtype=dt, device=dev),
        "wkv_b_k": dense_init(gen, r, (H, hd), dt),
        "wkv_b_v": dense_init(gen, r, (H, vd), dt),
        "wo": dense_init(gen, H * vd, (d,), dt).reshape(H, vd, d),
    }


def mla_specs(cfg: ModelConfig) -> dict:
    """Logical axes of :func:`mla_init`'s leaves."""
    return {
        "wq_a": ("embed", "kv_lora"),
        "q_norm": ("kv_lora",),
        "wq_b": ("kv_lora", "heads", "head_dim"),
        "wkv_a": ("embed", "kv_lora"),
        "kv_norm": ("kv_lora",),
        "wkv_b_k": ("kv_lora", "heads", "head_dim"),
        "wkv_b_v": ("kv_lora", "heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }


def _mla_q(p: dict, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor):
    """x (B, S, d) -> ``q_nope (B, S, H, hd)``, ``q_rope (B, S, H, rp)``
    (rotated at ``positions (B, S)``)."""
    hd = cfg.resolved_head_dim
    q = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = _project(q, p["wq_b"])
    return q[..., :hd], apply_rope(q[..., hd:], positions, cfg.rope_theta)


def _mla_kv_compress(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor):
    """x (B, S, d) -> the raw compressed ``c_kv (B, S, r)`` and the rotated
    ``k_rope (B, S, rp)``, one for all heads: what the cache holds."""
    r = cfg.kv_lora_rank
    kv = x @ p["wkv_a"]
    k_rope = apply_rope(kv[..., None, r:], positions, cfg.rope_theta)
    return kv[..., :r], k_rope[..., 0, :]


def mla_apply_full(p: dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """The prefill (and training) path: the compressed KV expanded to
    per-head keys of ``hd + rp`` columns (the rope part broadcast over the
    heads) and values of ``vd``, causal attention scaled by ``(hd + rp)
    ** -0.5`` through :func:`multi_head_attention` (flash's D 192 / Dv 128
    instance on the card at deepseek-v2's widths).  x (B, S, d) -> (B, S,
    d)."""
    return mla_prefill(p, cfg, x, positions)[0]


def mla_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """:func:`mla_apply_full` and what the cache keeps of x: ``(out (B, S,
    d), c_kv (B, S, r), k_rope (B, S, rp))``, the compression computed
    once (the JAX prefill computes it again for the cache)."""
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_kv_compress(p, cfg, x, positions)
    c_n = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_nope = _project(c_n, p["wkv_b_k"])
    v = _project(c_n, p["wkv_b_v"])
    k = torch.cat([k_nope, k_rope[:, :, None].expand(
        *k_nope.shape[:3], k_rope.shape[-1])], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    pos = positions[0] if positions.dim() == 2 else positions
    out = multi_head_attention(q, k, v, pos, pos, causal=True,
                               scale=q.shape[-1] ** -0.5)
    return attn_out(out, p["wo"]), c_kv, k_rope


def mla_decode_q(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 pos: torch.Tensor):
    """The cache-free half of a decode step over rows ``x (P, 1, d)`` at
    positions ``pos (P, 1)``: the absorbed query ``q_c (P, H, r)`` (``q_nope
    · wkv_b_k``, in the model dtype), ``q_rope (P, H, rp)``, and the new
    row's ``c_new (P, r)`` and ``kr_new (P, rp)``."""
    q_nope, q_rope = _mla_q(p, cfg, x, pos)
    c_new, kr_new = _mla_kv_compress(p, cfg, x, pos)
    q_c = torch.einsum("bhe,rhe->bhr", q_nope[:, 0], p["wkv_b_k"])
    return q_c, q_rope[:, 0], c_new[:, 0], kr_new[:, 0]


def mla_attend(p: dict, cfg: ModelConfig, q_c: torch.Tensor,
               q_rope: torch.Tensor, ckv: torch.Tensor, krope: torch.Tensor,
               index: torch.Tensor) -> torch.Tensor:
    """The absorbed attention of N rows over their caches ``ckv (N, S, r)``
    (raw, normalised here over every position, as the reference does at
    each step) and ``krope (N, S, rp)``, row b over positions ``<=
    index[b]``: scores ``q_c·c_n + q_rope·krope`` (each product in the
    model dtype, then float32), scaled by ``(hd + rp) ** -0.5``, a float32
    softmax, the weights cast to ``c_n``'s dtype.  Returns ``o_c (N, H,
    r)``."""
    scale = (cfg.resolved_head_dim + cfg.qk_rope_head_dim) ** -0.5
    c_n = rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    s = torch.einsum("bhr,bsr->bhs", q_c, c_n).float()
    s = s + torch.einsum("bhe,bse->bhs", q_rope, krope).float()
    s = s * scale
    valid = (torch.arange(ckv.shape[1], device=ckv.device)[None, :]
             <= index.long()[:, None])
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bsr->bhr", w.to(c_n.dtype), c_n)


def mla_decode_out(p: dict, o_c: torch.Tensor, dtype) -> torch.Tensor:
    """``o_c (P, H, r)`` through ``wkv_b_v`` and ``wo``: ``(P, 1, d)`` in
    ``dtype``."""
    o = torch.einsum("bhr,rhe->bhe", o_c, p["wkv_b_v"])
    return attn_out(o, p["wo"]).to(dtype)[:, None]


def mla_decode_step(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    ckv: torch.Tensor, krope: torch.Tensor,
                    index: torch.Tensor):
    """Absorbed one-token decode for a batch of rows, each at its own
    position, in plain PyTorch on either device (the reference has no TPU
    kernel for it).

    x: (B, 1, d); ckv: (B, S, r) raw compressed KV; krope: (B, S, rp);
    index: (B,) integer.  Row b writes its new row at ``index[b]`` (past
    the stripe, onto its last position, as the JAX step's
    ``dynamic_update_slice`` clamps) and attends over positions ``<=
    index[b]`` in the ``kv_lora`` space.  The JAX step takes a scalar
    index and its engine vmaps it over the slots; the rows here are as
    independent.  Caches are updated in place; returns ``(out (B, 1, d),
    ckv, krope)``."""
    idx = index.long()
    q_c, q_rope, c_new, kr_new = mla_decode_q(p, cfg, x, idx[:, None])
    rows = torch.arange(x.shape[0], device=x.device)
    w = idx.clamp(max=ckv.shape[1] - 1)
    ckv[rows, w] = c_new.to(ckv.dtype)
    krope[rows, w] = kr_new.to(krope.dtype)
    o_c = mla_attend(p, cfg, q_c, q_rope, ckv, krope, idx)
    return mla_decode_out(p, o_c, x.dtype), ckv, krope
