"""Prefill and the batched one-token decode steps of the dense GQA, rwkv6
(ssm) and zamba2 (hybrid) stacks.

Counterpart of ``repro/models/stacks_infer.py``: :func:`stack_prefill`
(dense, ssm and hybrid branches) fills a contiguous cache;
:func:`stack_kernel_decode_step` decodes one token for every slot of the
serving pool through the decode attention kernels (dense GQA, contiguous
or paged; and the hybrid family's paged pool, its shared attention block
through the paged kernel);
:func:`stack_decode_step` decodes one token for every row of a contiguous
cache of any batch (dense through the kernel step; ssm and hybrid in plain
PyTorch: the recurrent state has no sequence axis for a decode kernel, and
the JAX engine refuses its kernel backend for the hybrid family).  Caches
are updated in place (slice assignment and ``index_put_``) where the JAX
package rebuilds them with ``.at[].set``.
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
    """Whether :func:`stack_kernel_decode_step` serves this config on a
    contiguous cache: GQA transformer stacks only.  The ssm family carries
    no sequence-shaped KV for a decode kernel and steps its recurrence in
    :func:`stack_decode_step`; so does the hybrid family on contiguous
    stripes, whose kernel backend the JAX engine refuses; its paged pool
    decodes through :func:`stack_kernel_decode_step`."""
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

    ``ring=True`` decodes over a ring cache (``init_cache(ring=True)``, the
    long-context carve in which every layer is windowed): dense through
    the kernel step (:func:`stack_kernel_decode_step`), the hybrid
    family's shared block through the plain ``gqa_decode_step`` with its
    window at the stripe length, as the JAX package does; the ssm family
    has nothing to ring and ignores it."""
    index = cache["index"]
    if index.dim() == 0:
        # one position for every row: step a per-row copy, then advance
        # the shared one
        rows = dict(cache, index=index.expand(token.shape[0]).clone())
        logits, _ = stack_decode_step(p, cfg, token, rows, ring=ring)
        index.add_(1)
        return logits, cache
    if cfg.family == "dense":
        return stack_kernel_decode_step(p, cfg, token, cache, ring=ring)
    x = _embed_tokens(p, cfg, token)                         # (N, 1, d)
    if cfg.family == "hybrid":
        x = _hybrid_decode(p, cfg, x, cache, ring=ring)
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


def _hybrid_decode(p: dict, cfg: ModelConfig, x, cache: dict, tables=None,
                   ring: bool = False):
    """zamba2's layers for one token of every slot: each Mamba2 block steps
    its conv and SSM state; after layer ``idx`` with ``(idx + 1) % every ==
    0`` the shared block decodes against use ``occ = idx // every``: over
    the contiguous ``attn_k``/``attn_v`` stripes in plain PyTorch (with
    ``ring``, ring buffers windowed at their length), or with ``tables``
    over their block pools through ``paged_decode_attention`` (quantized
    on the write for int8 pools), never a gathered view."""
    every = cfg.hybrid_attn_every
    window = cache["attn_k"].shape[2] if ring else None
    sp = p["shared_attn"]
    index = cache["index"]
    if tables is not None:
        idx = index.long()
        pid, off = _paged_position(cache["attn_k"].shape[2], idx, tables)
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
            if tables is None:
                a, _, _ = attn.gqa_decode_step(
                    sp["attn"], cfg, h, cache["attn_k"][occ],
                    cache["attn_v"][occ], index, window=window, ring=ring)
            else:
                q, k_new, v_new = attn.gqa_project_qkv(sp["attn"], cfg, h,
                                                       idx[:, None])
                o = _paged_attention(cache, ("attn_k", "attn_v"), occ,
                                     q[:, 0], k_new[:, 0], v_new[:, 0], pid,
                                     off, tables, index + 1)
                a = attn.attn_out(o, sp["attn"]["wo"])[:, None].to(x.dtype)
            x = x + a
            h = _norm(sp["ln2"], x, cfg)
            x = x + mlp_apply(sp["mlp"], h)
    return x


def _paged_position(bs: int, idx: torch.Tensor, tables: torch.Tensor):
    """Pool block and offset of each slot's position ``idx`` through its
    table row; a row past its table (a dead slot that keeps stepping) is
    clamped onto the row's last entry, the null block once released."""
    rows = torch.arange(idx.shape[0], device=idx.device)
    pid = tables[rows, (idx // bs).clamp(max=tables.shape[1] - 1)].long()
    return pid, idx % bs


def _paged_attention(cache: dict, names, li: int, q, k_row, v_row, pid, off,
                     tables, lengths, window=None):
    """Write each slot's new K/V row ``(N, Hkv, hd)`` into layer ``li`` of
    the ``names`` block pools at ``(pid, off)`` (quantized, with its scale,
    when the pool is int8) and attend ``q (N, H, hd)`` over ``lengths``
    positions through the tables with ``paged_decode_attention``."""
    k_l, v_l = cache[names[0]][li], cache[names[1]][li]
    ks_l = vs_l = None
    if names[0] + kvcache.SCALE_SUFFIX in cache:
        ks_l = cache[names[0] + kvcache.SCALE_SUFFIX][li]
        vs_l = cache[names[1] + kvcache.SCALE_SUFFIX][li]
        kq, ks = kvcache.quantize_kv(k_row, 1)
        vq, vs = kvcache.quantize_kv(v_row, 1)
        k_l[pid, off], v_l[pid, off] = kq, vq
        ks_l[pid, off], vs_l[pid, off] = ks, vs
    else:
        k_l[pid, off] = k_row.to(k_l.dtype)
        v_l[pid, off] = v_row.to(v_l.dtype)
    return paged_decode_attention(q, k_l, v_l, tables, lengths,
                                  window=window, k_scale=ks_l, v_scale=vs_l)


def stack_kernel_decode_step(p: dict, cfg: ModelConfig, token: torch.Tensor,
                             cache: dict, *, tables=None, ring: bool = False):
    """One-token decode for the whole slot pool through the decode kernels.

    token: ``(N, 1)`` integer.  cache: the serving layout —

    * contiguous (``tables=None``, dense only): ``k``/``v`` ``(L, N, S,
      Hkv, hd)`` slot stripes, ``index`` ``(N,)``; runs
      ``decode_attention`` per layer;
    * paged (``tables (N, MB)`` int32): the paged leaves are pools
      ``(L, NB+1, bs, Hkv, hd)`` (block 0 = null), optionally int8 with
      ``<name>_scale`` ``(L, NB+1, bs)`` (quantize on write), every other
      leaf per slot.  Dense: ``k``/``v``, ``paged_decode_attention`` per
      layer over the tables, never a gathered view.  Hybrid: each Mamba2
      layer steps its per-slot ``conv``/``ssm``, and each use of the
      shared block runs ``paged_decode_attention`` over its
      ``attn_k``/``attn_v`` pool.  The ssm family's pool pages nothing
      and decodes through :func:`stack_decode_step`.

    Each slot writes its new K/V at position ``index`` and attends over
    ``index + 1`` positions.  Dead slots write where nothing live reads:
    past the stripe they are clamped onto its last position, through
    all-zero table rows into the null block.  The cache is updated in
    place (``index`` advances by one); returns ``(logits (N, V) f32,
    cache)``.

    ``ring=True`` (dense, contiguous only: the paged pool takes no ring)
    reads the stripes of S slots as ring buffers: position ``index`` is
    written at slot ``index % S`` and the kernel attends over ``min(index
    + 1, S)`` slots with no window.  That is the windowed attention of the
    JAX ring step because the ring carve windows every layer at
    ``sliding_window >= S`` (``_layer_theta_window(ring=True)``): a ring
    of S slots then holds exactly the live window's positions, every slot
    once, and the softmax does not depend on the order the slots hold
    them in.
    """
    kvcache.check_supported(cfg)
    if ring and (tables is not None or not kernel_supported(cfg)):
        raise ValueError("ring decode runs on contiguous dense stripes "
                         "here; the hybrid family's ring goes through "
                         "stack_decode_step, and the paged pool takes no "
                         "ring")
    if not kernel_supported(cfg):
        if tables is None or cfg.family != "hybrid":
            raise ValueError(f"stack_kernel_decode_step serves GQA stacks "
                             f"and paged hybrid pools, not family "
                             f"{cfg.family!r} here: use stack_decode_step")
        x = _hybrid_decode(p, cfg, _embed_tokens(p, cfg, token), cache,
                           tables)
        cache["index"].add_(1)
        return _unembed(p, cfg, x)[:, 0], cache
    index = cache["index"]                                   # (N,)
    N = token.shape[0]
    rows = torch.arange(N, device=index.device)
    x = _embed_tokens(p, cfg, token)                         # (N, 1, d)
    pos = index[:, None]
    idx = index.long()
    S = cache["k"].shape[2]
    lengths = index + 1
    if ring:
        widx = idx % S
        lengths = lengths.clamp(max=S)
    elif tables is None:
        widx = idx.clamp(max=S - 1)
    else:
        pid, off = _paged_position(S, idx, tables)
    for li, (lp, (theta, window)) in enumerate(
            zip(p["layers"], _layer_theta_window(cfg, ring=ring))):
        if ring:
            window = None           # the ring holds the window, no more
        h = _norm(lp["ln1"], x, cfg)
        q, k_new, v_new = attn.gqa_project_qkv(lp["attn"], cfg, h, pos,
                                               rope_theta=theta)
        kr, vr = k_new[:, 0], v_new[:, 0]                   # (N, Hkv, hd)
        if tables is None:
            k_l, v_l = cache["k"][li], cache["v"][li]
            k_l[rows, widx] = kr.to(k_l.dtype)
            v_l[rows, widx] = vr.to(v_l.dtype)
            o = decode_attention(q[:, 0], k_l, v_l, lengths, window=window)
        else:
            o = _paged_attention(cache, ("k", "v"), li, q[:, 0], kr, vr,
                                 pid, off, tables, lengths, window)
        x = x + attn.attn_out(o, lp["attn"]["wo"])[:, None].to(x.dtype)
        h = _norm(lp["ln2"], x, cfg)
        x = x + mlp_apply(lp["mlp"], h)
    index.add_(1)
    return _unembed(p, cfg, x)[:, 0], cache
