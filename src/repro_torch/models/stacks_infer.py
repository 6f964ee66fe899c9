"""Prefill and the batched one-token decode step of the dense GQA stack.

Counterpart of ``repro/models/stacks_infer.py``: :func:`stack_prefill`
(dense branch) fills a contiguous cache; :func:`stack_kernel_decode_step`
decodes one token for every slot of the serving pool through the decode
attention kernels.  Caches are updated in place (slice assignment and
``index_put_``) where the JAX package rebuilds them with ``.at[].set``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
from repro_torch.models import attention as attn
from repro_torch.models import kvcache
from repro_torch.models.common import mlp_apply
from repro_torch.models.stacks import (_embed_tokens, _layer_theta_window,
                                       _norm, _unembed)


def stack_prefill(p: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: dict):
    """Full-sequence forward over ``tokens (B, S)`` that writes each layer's
    K/V into positions ``[0, S)`` of the contiguous ``cache`` (in place)
    and sets its ``index`` to S.  Returns ``(last_logits (B, V) f32,
    cache)``."""
    kvcache.check_supported(cfg)
    B, S = tokens.shape
    x = _embed_tokens(p, cfg, tokens)
    pos = torch.arange(S, device=x.device)
    positions = pos.expand(B, S)
    for li, (lp, (theta, window)) in enumerate(
            zip(p["layers"], _layer_theta_window(cfg))):
        h = _norm(lp["ln1"], x, cfg)
        q, k, v = attn.gqa_project_qkv(lp["attn"], cfg, h, positions,
                                       rope_theta=theta)
        out = attn.multi_head_attention(q, k, v, pos, pos, causal=True,
                                        window=window)
        x = x + attn.attn_out(out, lp["attn"]["wo"])
        h = _norm(lp["ln2"], x, cfg)
        x = x + mlp_apply(lp["mlp"], h)
        cache["k"][li, :, :S] = k
        cache["v"][li, :, :S] = v
    cache["index"].fill_(S)
    return _unembed(p, cfg, x[:, -1:])[:, 0], cache


def stack_kernel_decode_step(p: dict, cfg: ModelConfig, token: torch.Tensor,
                             cache: dict, *, tables=None):
    """One-token decode for the whole slot pool through the decode kernels.

    token: ``(N, 1)`` integer.  cache: the serving layout —

    * contiguous (``tables=None``): ``k``/``v`` ``(L, N, S, Hkv, hd)`` slot
      stripes, ``index`` ``(N,)``; runs ``decode_attention`` per layer;
    * paged (``tables (N, MB)`` int32): ``k``/``v`` pools
      ``(L, NB+1, bs, Hkv, hd)`` (block 0 = null), optionally int8 with
      ``k_scale``/``v_scale`` ``(L, NB+1, bs)`` (quantize on write); runs
      ``paged_decode_attention`` per layer over the tables, never a
      gathered view.

    Each slot writes its new K/V at position ``index`` and attends over
    ``index + 1`` positions.  Dead slots write where nothing live reads:
    past the stripe they are clamped onto its last position, through
    all-zero table rows into the null block.  The cache is updated in
    place (``index`` advances by one); returns ``(logits (N, V) f32,
    cache)``.
    """
    kvcache.check_supported(cfg)
    index = cache["index"]                                   # (N,)
    N = token.shape[0]
    rows = torch.arange(N, device=index.device)
    x = _embed_tokens(p, cfg, token)                         # (N, 1, d)
    pos = index[:, None]
    idx = index.long()
    quant = "k" + kvcache.SCALE_SUFFIX in cache
    if tables is None:
        widx = idx.clamp(max=cache["k"].shape[2] - 1)
    else:
        bs, MB = cache["k"].shape[2], tables.shape[1]
        pid = tables[rows, (idx // bs).clamp(max=MB - 1)].long()
        off = idx % bs
    lengths = index + 1
    for li, (lp, (theta, window)) in enumerate(
            zip(p["layers"], _layer_theta_window(cfg))):
        h = _norm(lp["ln1"], x, cfg)
        q, k_new, v_new = attn.gqa_project_qkv(lp["attn"], cfg, h, pos,
                                               rope_theta=theta)
        kr, vr = k_new[:, 0], v_new[:, 0]                   # (N, Hkv, hd)
        k_l, v_l = cache["k"][li], cache["v"][li]
        if tables is None:
            k_l[rows, widx] = kr.to(k_l.dtype)
            v_l[rows, widx] = vr.to(v_l.dtype)
            o = decode_attention(q[:, 0], k_l, v_l, lengths, window=window)
        else:
            ks_l = vs_l = None
            if quant:
                ks_l = cache["k" + kvcache.SCALE_SUFFIX][li]
                vs_l = cache["v" + kvcache.SCALE_SUFFIX][li]
                kq, ks = kvcache.quantize_kv(kr, 1)
                vq, vs = kvcache.quantize_kv(vr, 1)
                k_l[pid, off], v_l[pid, off] = kq, vq
                ks_l[pid, off], vs_l[pid, off] = ks, vs
            else:
                k_l[pid, off] = kr.to(k_l.dtype)
                v_l[pid, off] = vr.to(v_l.dtype)
            o = paged_decode_attention(q[:, 0], k_l, v_l, tables, lengths,
                                       window=window, k_scale=ks_l,
                                       v_scale=vs_l)
        x = x + attn.attn_out(o, lp["attn"]["wo"])[:, None].to(x.dtype)
        h = _norm(lp["ln2"], x, cfg)
        x = x + mlp_apply(lp["mlp"], h)
    index.add_(1)
    return _unembed(p, cfg, x)[:, 0], cache
