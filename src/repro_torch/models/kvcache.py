"""Decode caches for the dense GQA, vlm (qwen2-vl), audio (whisper), MoE
(dbrx; deepseek-v2 with MLA), rwkv6 (ssm) and zamba2 (hybrid) families
(plain dicts of tensors).

Counterpart of ``repro/models/kvcache.py``.  Two serving layouts for the
dense family:

* contiguous (:func:`init_cache`) — ``k``/``v`` ``(L, B, S, Hkv, hd)``, one
  ``max_len`` stripe per batch row;
* paged (:func:`init_paged_cache`) — ``k``/``v`` become shared block pools
  ``(L, num_blocks + 1, block_size, Hkv, hd)`` (block 0 is the null
  block), optionally int8 with per-position float32 scale pools.

A vlm or GQA MoE cache is the dense one.  An MLA cache (deepseek-v2)
holds the raw compressed KV and the rotated rope keys, ``ckv`` ``(L, B,
S, r)`` and ``krope`` ``(L, B, S, rp)``, both paged.  An audio cache adds
the encoder's
cross-attention keys and values, ``cross_k``/``cross_v`` ``(L, B,
max_source_len, Hkv, hd)``, written once by the prefill.

The ssm family carries no sequence-shaped leaf: its contiguous cache is
the recurrent state, ``att_x``/``ffn_x`` ``(L, B, d)`` in the model dtype
and ``wkv`` ``(L, B, H, hd, hd)`` float32.  The hybrid family carries each
Mamba2 layer's state, ``conv`` ``(L, B, W-1, inner + 2N)`` in the model
dtype and ``ssm`` ``(L, B, nh, N, hd)`` float32, and one K/V stripe per use
of the shared attention block, ``attn_k``/``attn_v`` ``(ceil(L / every), B,
S, Hkv, hd)``.

The paged layout (:func:`init_paged_cache`) pages the leaves with a
sequence axis (:func:`paged_names`) and keeps every other leaf per slot:
the dense family's ``k``/``v``, the hybrid family's ``attn_k``/``attn_v``
(its ``conv``/``ssm`` stay per slot), and nothing of the ssm family, whose
paged layout degenerates to the contiguous one (a request needs no
block).  The audio family's cross leaves have no decode-time sequence
axis either: they stay per slot and are never quantized.

Where the JAX package rebuilds a cache with ``.at[].set``, the port updates
these tensors in place (``index_put_`` / slice assignment): a cache dict is
owned by one engine or one caller at a time.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import torch_dtype
from repro_torch.models.mamba2 import mamba2_init_state
from repro_torch.models.rwkv6 import rwkv6_init_state

SCALE_SUFFIX = "_scale"


def check_supported(cfg: ModelConfig) -> None:
    """The port serves the dense GQA family (internlm2, gemma3 with its
    sliding-window layers, minitron, qwen2.5), the vlm (qwen2-vl), audio
    (whisper) and MoE families (dbrx with GQA, deepseek-v2 with MLA), the
    ssm (rwkv6) and the hybrid (zamba2) families."""
    if cfg.family == "ssm":
        return
    mla = cfg.family == "moe" and cfg.attention == "mla"
    if cfg.family not in ("dense", "vlm", "audio", "moe", "hybrid") or (
            cfg.attention != "gqa" and not mla):
        raise NotImplementedError(
            f"family {cfg.family!r} / attention {cfg.attention!r} is not "
            f"ported (the port takes MLA in the MoE family, deepseek-v2's)")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               ring: bool = False, device) -> dict:
    """Zeroed contiguous decode cache with a scalar ``index``.

    ``ring=True`` allocates sliding-window ring buffers (the long-context
    carve) instead of full-length stripes: ``S = min(max_len,
    sliding_window)`` positions a row when the config has a window, and
    the hybrid family's shared-attention stripes ``min(S, 4096)``; the
    decode step then writes position ``index`` at slot ``index % S``.  The
    ssm family has no sequence axis, and an MLA config no window, so
    ``ring`` changes nothing there."""
    check_supported(cfg)
    S = (min(max_len, cfg.sliding_window) if ring and cfg.sliding_window
         else max_len)
    idx = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.family == "ssm":     # rwkv6: one block's state per layer
        one = rwkv6_init_state(cfg, batch, device=device)
        return {name: torch.zeros((cfg.num_layers, *t.shape), dtype=t.dtype,
                                  device=device)
                for name, t in one.items()} | {"index": idx}
    dt = torch_dtype(cfg.dtype)
    if cfg.family == "hybrid":  # zamba2: mamba2 state per layer, shared K/V
        one = mamba2_init_state(cfg, batch, device=device)
        out = {name: torch.zeros((cfg.num_layers, *t.shape), dtype=t.dtype,
                                 device=device)
               for name, t in one.items()}
        n_attn = -(-cfg.num_layers // cfg.hybrid_attn_every)
        Sa = min(S, 4096) if ring else S   # the shared block's ring
        shape = (n_attn, batch, Sa, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return out | {"attn_k": torch.zeros(shape, dtype=dt, device=device),
                      "attn_v": torch.zeros(shape, dtype=dt, device=device),
                      "index": idx}
    if cfg.attention == "mla":
        seq = (cfg.num_layers, batch, S)
        return {"ckv": torch.zeros(seq + (cfg.kv_lora_rank,), dtype=dt,
                                   device=device),
                "krope": torch.zeros(seq + (cfg.qk_rope_head_dim,),
                                     dtype=dt, device=device),
                "index": idx}
    shape = (cfg.num_layers, batch, S, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    out = {"k": torch.zeros(shape, dtype=dt, device=device),
           "v": torch.zeros(shape, dtype=dt, device=device)}
    if cfg.family == "audio":   # whisper: the encoder's K/V per layer
        cross = (cfg.num_layers, batch, cfg.max_source_len,
                 cfg.num_kv_heads, cfg.resolved_head_dim)
        out |= {"cross_k": torch.zeros(cross, dtype=dt, device=device),
                "cross_v": torch.zeros(cross, dtype=dt, device=device)}
    return out | {"index": idx}


def _attn_cache_spec():
    ax = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    return {"k": ax, "v": ax}


def cache_specs(cfg: ModelConfig) -> dict:
    """:func:`init_cache`'s tree with each leaf's logical axes
    (``models.sharding``); the layer axis leads, as the cache keeps it."""
    idx = {"index": ()}
    if cfg.family in ("dense", "vlm", "moe"):
        if cfg.attention == "mla":
            return {"ckv": ("layers", "batch", "cache_seq", "kv_lora"),
                    "krope": ("layers", "batch", "cache_seq", None)} | idx
        return _attn_cache_spec() | idx
    if cfg.family == "ssm":
        return {"att_x": ("layers", "batch", "embed_act"),
                "ffn_x": ("layers", "batch", "embed_act"),
                "wkv": ("layers", "batch", "heads_act", None, None)} | idx
    if cfg.family == "hybrid":
        return {"conv": ("layers", "batch", None, "ssm_inner"),
                "ssm": ("layers", "batch", "heads_act", None, None),
                "attn_k": ("layers", "batch", "cache_seq", "kv_heads",
                           "head_dim"),
                "attn_v": ("layers", "batch", "cache_seq", "kv_heads",
                           "head_dim")} | idx
    if cfg.family == "audio":
        return _attn_cache_spec() | {
            "cross_k": ("layers", "batch", "source", "kv_heads", "head_dim"),
            "cross_v": ("layers", "batch", "source", "kv_heads",
                        "head_dim")} | idx
    raise ValueError(cfg.family)


def paged_names(cfg: ModelConfig) -> tuple[str, ...]:
    """Cache leaves that get block-paged (those with a decode-time
    sequence axis): none for the ssm family, the shared block's K/V for
    the hybrid one, ``ckv``/``krope`` for MLA, the self-attention K/V
    (not the cross leaves) for the others."""
    check_supported(cfg)
    if cfg.attention == "mla":
        return ("ckv", "krope")
    return {"ssm": (), "hybrid": ("attn_k", "attn_v")}.get(cfg.family,
                                                          ("k", "v"))


def scale_names(cfg: ModelConfig) -> tuple[str, ...]:
    """Per-position scale leaves an int8 paged cache carries."""
    return tuple(n + SCALE_SUFFIX for n in paged_names(cfg))


def quantize_kv(x: torch.Tensor, pos_ndim: int):
    """Symmetric per-token-position int8 quantization.

    The leading ``pos_ndim`` axes of ``x`` identify a token position; the
    feature axes beyond share one scale ``amax / 127`` (1.0 for an all-zero
    position).  Values round half to even (``torch.round``, as
    ``jnp.round`` on the JAX side) and clip to ±127.  Returns ``(int8
    values, float32 scales of shape x.shape[:pos_ndim])``.
    """
    xf = x.float()
    red = tuple(range(pos_ndim, x.dim()))
    amax = xf.abs().amax(dim=red) if red else xf.abs()
    # amax * (1/127), not amax / 127: XLA compiles the JAX package's
    # division by the constant into this product, and the engines compare
    # int8 pools with the JAX engine's jitted quantization
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), torch.ones_like(amax))
    q = torch.round(xf / scale.reshape(scale.shape + (1,) * len(red)))
    return q.clamp(-127, 127).to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: each position's scale broadcast over
    its feature axes."""
    s = scale.reshape(scale.shape + (1,) * (q.dim() - scale.dim()))
    return (q.float() * s).to(dtype)


def init_paged_cache(cfg: ModelConfig, num_slots: int, max_len: int, *,
                     block_size: int, num_blocks: int,
                     kv_dtype: str | None = None, device) -> dict:
    """Zeroed paged decode cache: every :func:`paged_names` leaf becomes a
    block pool ``(L, num_blocks + 1, block_size, ...)`` shared across slots
    (entry 0 is the null block), every other leaf keeps the contiguous
    per-slot layout, and ``index`` is a per-slot vector.
    ``kv_dtype="int8"`` stores the pools as int8 plus ``<name>_scale``
    pools ``(L, num_blocks + 1, block_size)`` float32, initialised to 1; a
    family with no paged leaf (ssm) has nothing to quantize and raises
    ``ValueError``."""
    if kv_dtype not in (None, "auto", "int8"):
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    int8 = kv_dtype == "int8"
    paged = set(paged_names(cfg))
    if int8 and not paged:
        raise ValueError(
            f"kv_dtype='int8' needs paged KV leaves; family {cfg.family!r} "
            "has none to quantize")
    # the contiguous layout's shapes, allocated nowhere
    shapes = init_cache(cfg, num_slots, max_len, device="meta")
    out = {"index": torch.zeros((num_slots,), dtype=torch.int32,
                                device=device)}
    for name, leaf in shapes.items():
        if name == "index":
            continue
        if name not in paged:
            out[name] = torch.zeros(leaf.shape, dtype=leaf.dtype,
                                    device=device)
            continue
        # (L, B, S, *rest) -> (L, num_blocks + 1, block_size, *rest)
        pool = (leaf.shape[0], num_blocks + 1, block_size) + leaf.shape[3:]
        out[name] = torch.zeros(pool, dtype=torch.int8 if int8 else
                                leaf.dtype, device=device)
        if int8:
            out[name + SCALE_SUFFIX] = torch.ones(pool[:3],
                                                  dtype=torch.float32,
                                                  device=device)
    return out
