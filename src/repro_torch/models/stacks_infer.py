"""Prefill and the batched one-token decode steps of the dense GQA, rwkv6
(ssm) and zamba2 (hybrid) stacks.

Counterpart of ``repro/models/stacks_infer.py``: :func:`stack_prefill`
(dense, ssm and hybrid branches) fills a contiguous cache;
:func:`stack_kernel_decode_step` decodes one token for every slot of the
serving pool through the decode attention kernels (dense GQA, contiguous
or paged); :func:`stack_decode_step` decodes one token for every row of a
contiguous cache of any batch (dense through the kernel step; ssm and
hybrid in plain PyTorch: the recurrent state has no sequence axis for a
decode kernel, and the JAX engine refuses its kernel backend for the
hybrid family).  Caches are updated in place (slice assignment and
``index_put_``) where the JAX package rebuilds them with ``.at[].set``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
from repro_torch.models import attention as attn
from repro_torch.models import kvcache
from repro_torch.models import mamba2 as mb
from repro_torch.models import rwkv6 as rw
from repro_torch.models.common import mlp_apply
from repro_torch.models.stacks import (_embed_tokens, _layer_theta_window,
                                       _norm, _unembed)


def stack_prefill(p: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: dict):
    """Full-sequence forward over ``tokens (B, S)`` that writes each layer's
    K/V into positions ``[0, S)`` of the contiguous ``cache`` (dense), each
    layer's final recurrent state (ssm: ``att_x``, ``ffn_x``, ``wkv``), or
    each Mamba2 layer's state and each shared-attention use's K/V (hybrid:
    ``conv``, ``ssm``, ``attn_k``, ``attn_v``), in place, and sets its
    ``index`` to S.  Returns ``(last_logits (B, V) f32, cache)``."""
    kvcache.check_supported(cfg)
    B, S = tokens.shape
    x = _embed_tokens(p, cfg, tokens)
    if cfg.family == "hybrid":
        return _hybrid_prefill(p, cfg, x, cache)
    if cfg.family == "ssm":
        for li, lp in enumerate(p["layers"]):
            h = _norm(lp["ln1"], x, cfg)
            o, (ax, wkv) = rw.rwkv6_time_mix_full(lp["mix"], cfg, h)
            x = x + o
            h = _norm(lp["ln2"], x, cfg)
            o, fx = rw.rwkv6_channel_mix(lp["mix"], cfg, h)
            x = x + o
            cache["att_x"][li] = ax
            cache["ffn_x"][li] = fx
            cache["wkv"][li] = wkv
        cache["index"].fill_(S)
        return _unembed(p, cfg, x[:, -1:])[:, 0], cache
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


def _shared_block_full(sp: dict, cfg: ModelConfig, x, positions, pos):
    """The hybrid family's shared attention + MLP block over a whole
    sequence; returns ``(x, k, v)``."""
    h = _norm(sp["ln1"], x, cfg)
    q, k, v = attn.gqa_project_qkv(sp["attn"], cfg, h, positions)
    out = attn.multi_head_attention(q, k, v, pos, pos, causal=True)
    x = x + attn.attn_out(out, sp["attn"]["wo"])
    h = _norm(sp["ln2"], x, cfg)
    return x + mlp_apply(sp["mlp"], h), k, v


def _hybrid_prefill(p: dict, cfg: ModelConfig, x, cache: dict):
    """zamba2: every layer runs its Mamba2 block (the SSD scan kernel on
    the card); after layer ``idx`` with ``(idx + 1) % every == 0`` the
    shared block runs and its K/V go to use ``idx // every`` of
    ``attn_k``/``attn_v``.  The JAX package stacks all layers' K/V (dummies
    where the block does not run) and slices every ``every``-th; the port
    writes the uses directly."""
    B, S = x.shape[:2]
    every = cfg.hybrid_attn_every
    pos = torch.arange(S, device=x.device)
    positions = pos.expand(B, S)
    sp = p["shared_attn"]
    for li, lp in enumerate(p["layers"]):
        h = _norm(lp["norm"], x, cfg)
        m, (conv, ssm) = mb.mamba2_apply_full(lp["mamba"], cfg, h)
        x = x + m
        cache["conv"][li] = conv
        cache["ssm"][li] = ssm
        if (li + 1) % every == 0:
            x, k, v = _shared_block_full(sp, cfg, x, positions, pos)
            cache["attn_k"][li // every, :, :S] = k
            cache["attn_v"][li // every, :, :S] = v
    cache["index"].fill_(S)
    return _unembed(p, cfg, x[:, -1:])[:, 0], cache


def kernel_supported(cfg: ModelConfig) -> bool:
    """Whether :func:`stack_kernel_decode_step` serves this config: GQA
    transformer stacks only.  The ssm family carries no sequence-shaped KV
    for a decode kernel and steps its recurrence in
    :func:`stack_decode_step`; so does the hybrid family, whose kernel
    backend the JAX engine refuses."""
    return cfg.family == "dense" and cfg.attention == "gqa"


def stack_decode_step(p: dict, cfg: ModelConfig, token: torch.Tensor,
                      cache: dict, *, ring: bool = False):
    """One-token decode for every row of a contiguous cache.

    token: ``(N, 1)`` integer.  cache: ``index`` ``(N,)``, or a scalar
    that every row shares (a batch=1 view, or the static ``generate``
    batch, as in the JAX package), and the family's leaves — dense:
    ``k``/``v`` ``(L, N, S, Hkv, hd)``; ssm: ``att_x``/``ffn_x`` ``(L, N,
    d)``, ``wkv`` ``(L, N, H, hd, hd)`` float32; hybrid: ``conv`` ``(L, N,
    W-1, C)``, ``ssm`` ``(L, N, nh, N_state, hd)`` float32,
    ``attn_k``/``attn_v`` ``(n_attn, N, S, Hkv, hd)``.

    The dense family runs :func:`stack_kernel_decode_step` (the decode
    attention kernel on the card, its plain version on the CPU); ssm and
    hybrid step their recurrences in plain PyTorch (the recurrent state
    has no sequence axis for a decode kernel, and the JAX engine refuses
    its kernel backend for the hybrid family).  The JAX engine vmaps a
    batch-1 step over the slots; the rows here are as independent, so one
    batched step computes the same thing.  The cache is updated in place
    (``index`` advances by one); returns ``(logits (N, V) f32, cache)``.
    ``ring`` (the sliding-window ring buffer of the long-context cells) is
    not ported."""
    if ring:
        raise NotImplementedError(
            "ring decode (the sliding-window ring-buffer cache of the "
            "long-context cells) is not ported yet")
    index = cache["index"]
    if index.dim() == 0:
        # one position for every row: step a per-row copy, then advance
        # the shared one
        rows = dict(cache, index=index.expand(token.shape[0]).clone())
        logits, _ = stack_decode_step(p, cfg, token, rows)
        index.add_(1)
        return logits, cache
    if cfg.family == "dense":
        return stack_kernel_decode_step(p, cfg, token, cache)
    x = _embed_tokens(p, cfg, token)                         # (N, 1, d)
    if cfg.family == "hybrid":
        x = _hybrid_decode(p, cfg, x, cache)
        cache["index"].add_(1)
        return _unembed(p, cfg, x)[:, 0], cache
    for li, lp in enumerate(p["layers"]):
        h = _norm(lp["ln1"], x, cfg)
        o, ax, wkv = rw.rwkv6_time_mix_step(
            lp["mix"], cfg, h, cache["att_x"][li], cache["wkv"][li])
        x = x + o
        h = _norm(lp["ln2"], x, cfg)
        o, fx = rw.rwkv6_channel_mix(lp["mix"], cfg, h, cache["ffn_x"][li])
        x = x + o
        cache["att_x"][li] = ax
        cache["ffn_x"][li] = fx
        cache["wkv"][li] = wkv
    cache["index"].add_(1)
    return _unembed(p, cfg, x)[:, 0], cache


def _hybrid_decode(p: dict, cfg: ModelConfig, x, cache: dict):
    """zamba2's layers for one token of every slot: each Mamba2 block steps
    its conv and SSM state; after layer ``idx`` with ``(idx + 1) % every ==
    0`` the shared block decodes against use ``occ = idx // every``."""
    every = cfg.hybrid_attn_every
    sp = p["shared_attn"]
    index = cache["index"]
    for li, lp in enumerate(p["layers"]):
        h = _norm(lp["norm"], x, cfg)
        m, conv, ssm = mb.mamba2_decode_step(
            lp["mamba"], cfg, h, cache["conv"][li], cache["ssm"][li])
        x = x + m
        cache["conv"][li] = conv
        cache["ssm"][li] = ssm
        if (li + 1) % every == 0:
            occ = li // every
            h = _norm(sp["ln1"], x, cfg)
            a, _, _ = attn.gqa_decode_step(
                sp["attn"], cfg, h, cache["attn_k"][occ],
                cache["attn_v"][occ], index)
            x = x + a
            h = _norm(sp["ln2"], x, cfg)
            x = x + mlp_apply(sp["mlp"], h)
    return x


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
    if not kernel_supported(cfg):
        raise ValueError(f"stack_kernel_decode_step serves GQA stacks, not "
                         f"family {cfg.family!r}: use stack_decode_step")
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
