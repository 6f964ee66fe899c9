"""Decode caches for the dense GQA family (plain dicts of tensors).

Counterpart of ``repro/models/kvcache.py``.  Two serving layouts:

* contiguous (:func:`init_cache`) — ``k``/``v`` ``(L, B, S, Hkv, hd)``, one
  ``max_len`` stripe per batch row;
* paged (:func:`init_paged_cache`) — ``k``/``v`` become shared block pools
  ``(L, num_blocks + 1, block_size, Hkv, hd)`` (block 0 is the null
  block), optionally int8 with per-position float32 scale pools.

Where the JAX package rebuilds a cache with ``.at[].set``, the port updates
these tensors in place (``index_put_`` / slice assignment): a cache dict is
owned by one engine or one caller at a time.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import torch_dtype

SCALE_SUFFIX = "_scale"


def check_supported(cfg: ModelConfig) -> None:
    """The port serves the dense GQA family; the others wait for theirs."""
    if cfg.family not in ("dense",) or cfg.attention != "gqa":
        raise NotImplementedError(
            f"family {cfg.family!r} / attention {cfg.attention!r} is not "
            f"ported yet: it comes with the other-architectures slice "
            f"(ROADMAP, modules to port)")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device) -> dict:
    """Zeroed contiguous decode cache with a scalar ``index``."""
    check_supported(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def paged_names(cfg: ModelConfig) -> tuple[str, ...]:
    """Cache leaves that get block-paged (those with a sequence axis)."""
    check_supported(cfg)
    return ("k", "v")


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
    """Zeroed paged decode cache: ``k``/``v`` block pools
    ``(L, num_blocks + 1, block_size, Hkv, hd)`` shared across slots
    (entry 0 is the null block) and a per-slot ``index`` vector.
    ``kv_dtype="int8"`` stores the pools as int8 plus ``<name>_scale``
    pools ``(L, num_blocks + 1, block_size)`` float32, initialised to 1."""
    if kv_dtype not in (None, "auto", "int8"):
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    check_supported(cfg)
    int8 = kv_dtype == "int8"
    pool = (cfg.num_layers, num_blocks + 1, block_size, cfg.num_kv_heads,
            cfg.resolved_head_dim)
    dt = torch.int8 if int8 else torch_dtype(cfg.dtype)
    out = {"index": torch.zeros((num_slots,), dtype=torch.int32,
                                device=device)}
    for name in paged_names(cfg):
        out[name] = torch.zeros(pool, dtype=dt, device=device)
        if int8:
            out[name + SCALE_SUFFIX] = torch.ones(pool[:3],
                                                  dtype=torch.float32,
                                                  device=device)
    return out
