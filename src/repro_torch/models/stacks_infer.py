"""Prefill and the batched one-token decode steps of the dense GQA, vlm,
audio, MoE (GQA, and deepseek-v2's MLA), rwkv6 (ssm) and zamba2 (hybrid)
stacks.

Counterpart of ``repro/models/stacks_infer.py``: :func:`stack_prefill`
(dense, vlm with its frontend and M-RoPE, audio with its encoder and
cross-attention, MoE, ssm and hybrid branches) fills a contiguous cache;
:func:`stack_kernel_decode_step` decodes one token for every slot of the
serving pool through the decode attention kernels (dense GQA, vlm, audio
and MoE, contiguous or paged; and the hybrid family's paged pool, its shared
attention block through the paged kernel);
:func:`stack_decode_step` decodes one token for every row of a contiguous
cache of any batch (dense, vlm, audio and MoE through the kernel step; ssm
and hybrid in plain PyTorch: the recurrent state has no sequence axis for a
decode kernel, and the JAX engine refuses its kernel backend for the
hybrid family).  An MLA stack decodes in plain PyTorch on either device
(:func:`_mla_decode`; the reference has no kernel for its absorbed
decode): :func:`stack_decode_step` routes its MoE rows together (the
reference's batched step), the serving pool's step
(:func:`stack_kernel_decode_step`) routes each row alone (the reference
engine's per-slot step).  Caches are updated in place (slice assignment
and ``index_put_``) where the JAX package rebuilds them with
``.at[].set``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  paged_decode_attention)
from repro_torch.models import attention as attn
from repro_torch.models import kvcache
from repro_torch.models import mamba2 as mb
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv6 as rw
from repro_torch.models.common import (default_mrope_positions,
                                       gelu_mlp_apply, mlp_apply,
                                       mrope_positions_at)
from repro_torch.models.stacks import (_embed_tokens, _layer_theta_window,
                                       _norm, _shared_block_full, _sinusoid,
                                       _unembed, decoder_layers,
                                       encode_source)

# A product on the card may take another kernel at another row count, and
# split a row's sums another way: cuBLAS takes another kernel for
# internlm2's 8192 x 2048 product at 16 rows than at 8, and the norms'
# plain mean reduction splits rows by the row count.  So that a slot's row
# rounds alike at every slot count up to DECODE_ROWS (an elastic engine
# serves on several, a batch=1 injection on one), the kernel decode step
# runs its embedding, norms, products and logits on at least DECODE_ROWS
# rows, the rows past the live ones zero-token padding that nothing reads;
# only the attention kernels see the live rows, and an MoE layer, whose
# capacity couples the rows it routes, routes the live rows alone.
DECODE_ROWS = 16


def _ffn(lp: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """A layer's feed-forward block over ``h (B, S, d)``: its MoE layer
    (all B·S rows routed together; the aux loss dropped, as the
    reference's inference steps drop it) or its SwiGLU MLP."""
    if "moe" in lp:
        return moe_lib.moe_apply(lp["moe"], cfg, h)[0]
    return mlp_apply(lp["mlp"], h)


def stack_prefill(p: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: dict, *, frontend=None):
    """Full-sequence forward over ``tokens (B, S)`` that writes each layer's
    K/V into positions ``[0, S)`` of the contiguous ``cache`` (dense, vlm;
    audio also the encoder's ``cross_k``/``cross_v``; MLA its raw ``ckv``
    and rotated ``krope``), each layer's final
    recurrent state (ssm: ``att_x``, ``ffn_x``, ``wkv``), or each Mamba2
    layer's state and each shared-attention use's K/V (hybrid: ``conv``,
    ``ssm``, ``attn_k``, ``attn_v``), in place, and sets its ``index`` to
    S.  ``frontend``: the vlm family's vision embeddings ``(B, F, d)``,
    written over the first F positions (F at most S; the M-RoPE ids take
    the config's ``num_frontend_tokens`` whatever F is, as the JAX
    package's), or the audio family's frame embeddings ``(B,
    max_source_len, d)``, which it needs; other families ignore it.  An
    MoE model routes all B·S rows of a layer together.  Returns
    ``(last_logits (B, V) f32, cache)``."""
    kvcache.check_supported(cfg)
    B, S = tokens.shape
    x = _embed_tokens(p, cfg, tokens, frontend)
    if cfg.family == "hybrid":
        return _hybrid_prefill(p, cfg, x, cache)
    if cfg.family == "audio":
        return _audio_prefill(p, cfg, x, cache, frontend)
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
    mrope = (default_mrope_positions(B, S, cfg.num_frontend_tokens,
                                     x.device) if cfg.mrope else None)
    mla = cfg.attention == "mla"
    for li, (lp, (theta, window)) in enumerate(
            zip(decoder_layers(p), _layer_theta_window(cfg))):
        h = _norm(lp["ln1"], x, cfg)
        if mla:     # the raw compressed KV and the rotated rope keys
            a, ckv, krope = attn.mla_prefill(lp["attn"], cfg, h, positions)
            x = x + a
            cache["ckv"][li, :, :S] = ckv
            cache["krope"][li, :, :S] = krope
        else:
            q, k, v = attn.gqa_project_qkv(lp["attn"], cfg, h, positions,
                                           rope_theta=theta,
                                           mrope_positions=mrope)
            out = attn.multi_head_attention(q, k, v, pos, pos, causal=True,
                                            window=window)
            x = x + attn.attn_out(out, lp["attn"]["wo"])
            cache["k"][li, :, :S] = k
            cache["v"][li, :, :S] = v
        h = _norm(lp["ln2"], x, cfg)
        x = x + _ffn(lp, cfg, h)
    cache["index"].fill_(S)
    return _unembed(p, cfg, x[:, -1:])[:, 0], cache


def _audio_prefill(p: dict, cfg: ModelConfig, x, cache: dict, frontend):
    """whisper: the encoder over ``frontend`` (flash with ``causal=False``
    on the card), each decoder layer's cross K/V of its output into
    ``cross_k``/``cross_v``, then the decoder over the prompt with
    sinusoidal positions: causal self-attention (flash on the card) whose
    K/V go to the cache, cross-attention (plain PyTorch on either device:
    neither package has a kernel for it) and the gelu MLP."""
    if frontend is None:
        raise ValueError("the audio family needs its frame embeddings: "
                         "frontend (B, max_source_len, d_model)")
    if frontend.shape[1] != cache["cross_k"].shape[2]:
        raise ValueError(f"a frontend of {frontend.shape[1]} frames; the "
                         f"cache's cross leaves hold "
                         f"{cache['cross_k'].shape[2]}")
    enc = encode_source(p, cfg, frontend)
    B, S = x.shape[:2]
    x = x + _sinusoid(S, cfg.d_model, device=x.device).to(x.dtype)
    pos = torch.arange(S, device=x.device)
    positions = pos.expand(B, S)
    for li, (lp, cp) in enumerate(zip(p["layers"], p["cross"])):
        ek, ev = attn.gqa_project_kv(cp["attn"], cfg, enc)
        cache["cross_k"][li] = ek
        cache["cross_v"][li] = ev
        h = _norm(lp["ln1"], x, cfg)
        q, k, v = attn.gqa_project_qkv(lp["attn"], cfg, h, positions,
                                       rope_theta=0.0)
        out = attn.multi_head_attention(q, k, v, pos, pos, causal=True)
        x = x + attn.attn_out(out, lp["attn"]["wo"])
        h = _norm(cp["ln"], x, cfg)
        x = x + attn.gqa_apply_cross(cp["attn"], cfg, h, ek, ev)
        h = _norm(lp["ln2"], x, cfg)
        x = x + gelu_mlp_apply(lp["mlp"], h)
        cache["k"][li, :, :S] = k
        cache["v"][li, :, :S] = v
    cache["index"].fill_(S)
    return _unembed(p, cfg, x[:, -1:])[:, 0], cache


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
    contiguous cache: GQA transformer stacks (dense, vlm, MoE, and audio,
    whose cross-attention runs the contiguous decode kernel over its
    encoder K/V).  The ssm family carries no sequence-shaped KV for a decode
    kernel and steps its recurrence in :func:`stack_decode_step`; so does
    the hybrid family on contiguous stripes, whose kernel backend the JAX
    engine refuses; its paged pool decodes through
    :func:`stack_kernel_decode_step`."""
    return (cfg.family in ("dense", "vlm", "audio", "moe")
            and cfg.attention == "gqa")


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

    The dense, vlm, audio and MoE families run
    :func:`stack_kernel_decode_step`
    (the decode attention kernel on the card, its plain version on the
    CPU); ssm and
    hybrid step their recurrences in plain PyTorch (the recurrent state
    has no sequence axis for a decode kernel, and the JAX engine refuses
    its kernel backend for the hybrid family).  The JAX engine vmaps a
    batch-1 step over the slots; the rows here are as independent, so one
    batched step computes the same thing (an MoE model's rows are not
    independent: its layers route all N rows together, as the JAX batched
    step does).  An MLA stack (``ckv``/``krope`` ``(L, N, S, ·)``) runs
    :func:`_mla_decode` with its MoE layers routing all N rows together,
    as the JAX batched step does.  The cache is updated in place
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
    if cfg.attention == "mla":
        return _mla_decode(p, cfg, token, cache, per_slot=False)
    if kernel_supported(cfg):
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
    _pool_write(cache, names[0], li, pid, off, k_row)
    _pool_write(cache, names[1], li, pid, off, v_row)
    ks_l = vs_l = None
    if names[0] + kvcache.SCALE_SUFFIX in cache:
        ks_l = cache[names[0] + kvcache.SCALE_SUFFIX][li]
        vs_l = cache[names[1] + kvcache.SCALE_SUFFIX][li]
    return paged_decode_attention(q, cache[names[0]][li],
                                  cache[names[1]][li], tables, lengths,
                                  window=window, k_scale=ks_l, v_scale=vs_l)


def _mla_view(cache: dict, name: str, li: int, tables: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """Layer ``li`` of the ``name`` block pool gathered through each
    slot's table row into a contiguous ``(N, MB · bs, ·)`` view in
    ``dtype``, dequantized when the pool is int8 (the JAX engine's view)."""
    pool = cache[name][li]
    n = tables.shape[0]
    g = attn.gather_blocks(pool, tables.reshape(-1)).view(
        n, -1, *pool.shape[2:])
    if name + kvcache.SCALE_SUFFIX not in cache:
        return g.to(dtype)
    sc = attn.gather_blocks(cache[name + kvcache.SCALE_SUFFIX][li],
                            tables.reshape(-1)).view(n, -1)
    return kvcache.dequantize_kv(g, sc, dtype)


def _mla_decode(p: dict, cfg: ModelConfig, token: torch.Tensor,
                cache: dict, tables=None, *, per_slot: bool = True):
    """One-token decode of an MLA stack for N rows at per-row positions
    ``cache["index"] (N,)``, in plain PyTorch on either device (the JAX
    package's absorbed ``mla_decode_step``, which has no kernel).

    Everything but the attention over the caches runs on ``P = max(N,
    DECODE_ROWS)`` rows (see ``DECODE_ROWS``; the pad rows' cache reads and
    writes are cut off).  ``per_slot=True`` is the serving pool's step,
    the JAX engine's vmapped batch=1 step: each MoE layer routes all P
    rows with ``capacity`` P, which drops nothing, and so computes each
    row's own function, whatever its companions.  ``per_slot=False`` is
    :func:`stack_decode_step`, the JAX batched step: each MoE layer routes
    the N rows together at the config's capacity.

    Contiguous (``tables=None``): ``ckv``/``krope`` ``(L, N, S, ·)``
    stripes; a row past its stripe writes onto its last position and
    attends over the whole stripe, as the JAX step's clamped
    ``dynamic_update_slice`` does.  Paged (``tables (N, MB)``): each layer
    gathers every slot's blocks into a ``(N, MB · bs, ·)`` view in the
    model dtype (dequantized from an int8 pool), writes the new row there
    unquantized, attends over the view, and writes the row into the pool
    (quantized per position for int8): the JAX engine's gathered-view
    step, whose current row enters its attention at full precision.  Dead
    slots write through their table rows into the null block.  The cache
    is updated in place (``index`` advances by one); returns ``(logits (N,
    V) f32, cache)``."""
    index = cache["index"]                                   # (N,)
    N = token.shape[0]
    P = max(N, DECODE_ROWS)
    rows = torch.arange(N, device=index.device)
    idx = index.long()
    pos = _pad_rows(index, P)[:, None]                       # (P, 1)
    x = _embed_tokens(p, cfg, _pad_rows(token, P))           # (P, 1, d)
    if tables is None:
        widx = idx.clamp(max=cache["ckv"].shape[2] - 1)
    else:
        bs = cache["ckv"].shape[2]
        pid, off = _paged_position(bs, idx, tables)
        widx = idx.clamp(max=tables.shape[1] * bs - 1)
    for li, lp in enumerate(decoder_layers(p)):
        h = _norm(lp["ln1"], x, cfg)
        q_c, q_rope, c_new, kr_new = attn.mla_decode_q(lp["attn"], cfg, h,
                                                       pos)
        c_row, kr_row = c_new[:N], kr_new[:N]
        if tables is None:
            ckv, krope = cache["ckv"][li], cache["krope"][li]
        else:
            ckv = _mla_view(cache, "ckv", li, tables, x.dtype)
            krope = _mla_view(cache, "krope", li, tables, x.dtype)
            _pool_write(cache, "ckv", li, pid, off, c_row)
            _pool_write(cache, "krope", li, pid, off, kr_row)
        ckv[rows, widx] = c_row.to(ckv.dtype)
        krope[rows, widx] = kr_row.to(krope.dtype)
        o_c = attn.mla_attend(lp["attn"], cfg, q_c[:N], q_rope[:N], ckv,
                              krope, idx)
        x = x + attn.mla_decode_out(lp["attn"], _pad_rows(o_c, P), x.dtype)
        h = _norm(lp["ln2"], x, cfg)
        if "moe" not in lp:
            x = x + mlp_apply(lp["mlp"], h)
        elif per_slot:
            x = x + moe_lib.moe_apply(lp["moe"], cfg, h, capacity=P)[0]
        else:
            x = x + _pad_rows(_ffn(lp, cfg, h[:N]), P)
    index.add_(1)
    return _unembed(p, cfg, x)[:N, 0], cache


def _pool_write(cache: dict, name: str, li: int, pid, off,
                row: torch.Tensor) -> None:
    """Write each slot's new row ``(N, ·)`` into layer ``li`` of the
    ``name`` block pool at ``(pid, off)``, quantized with its scale when
    the pool is int8."""
    pool = cache[name][li]
    if name + kvcache.SCALE_SUFFIX in cache:
        q, sc = kvcache.quantize_kv(row, 1)
        pool[pid, off] = q
        cache[name + kvcache.SCALE_SUFFIX][li][pid, off] = sc
    else:
        pool[pid, off] = row.to(pool.dtype)


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """``t`` with zero rows appended on axis 0 up to ``rows``."""
    n = t.shape[0]
    return t if n >= rows else torch.cat(
        [t, t.new_zeros((rows - n, *t.shape[1:]))])


@functools.lru_cache(maxsize=None)
def _source_lengths(n: int, length: int, device) -> torch.Tensor:
    """A persistent ``(n,)`` int32 device tensor of ``length``: every
    slot's cross-attention length (the encoder's positions).  Made once
    per shape, outside any CUDA graph, and never written."""
    return torch.full((n,), length, dtype=torch.int32, device=device)


def stack_kernel_decode_step(p: dict, cfg: ModelConfig, token: torch.Tensor,
                             cache: dict, *, tables=None, ring: bool = False):
    """One-token decode for the whole slot pool through the decode kernels.

    token: ``(N, 1)`` integer.  cache: the serving layout —

    * contiguous (``tables=None``; dense, vlm, audio): ``k``/``v`` ``(L,
      N, S, Hkv, hd)`` slot stripes, ``index`` ``(N,)``; runs
      ``decode_attention`` per layer;
    * paged (``tables (N, MB)`` int32): the paged leaves are pools
      ``(L, NB+1, bs, Hkv, hd)`` (block 0 = null), optionally int8 with
      ``<name>_scale`` ``(L, NB+1, bs)`` (quantize on write), every other
      leaf per slot.  Dense, vlm, audio: ``k``/``v``,
      ``paged_decode_attention`` per layer over the tables, never a
      gathered view.  Hybrid: each Mamba2 layer steps its per-slot
      ``conv``/``ssm``, and each use of the shared block runs
      ``paged_decode_attention`` over its ``attn_k``/``attn_v`` pool.  The
      ssm family's pool pages nothing and decodes through
      :func:`stack_decode_step`.

    Each slot writes its new K/V at position ``index`` and attends over
    ``index + 1`` positions.  Dead slots write where nothing live reads:
    past the stripe they are clamped onto its last position, through
    all-zero table rows into the null block.  The cache is updated in
    place (``index`` advances by one); returns ``(logits (N, V) f32,
    cache)``.

    The vlm family rotates with M-RoPE at per-slot ids from ``index``
    (:func:`~repro_torch.models.common.mrope_positions_at`, on the
    device).  The audio family adds sinusoidal positions at each slot's
    ``index``, runs its self-attention as above (no rotary), then its
    cross-attention through ``decode_attention`` over the per-slot
    ``cross_k``/``cross_v`` (every length ``max_source_len``), then its
    gelu MLP; the JAX engine vmaps a batch=1 step whose scalar index is
    each slot's own.

    Everything but the attention kernels and the MoE layers runs on
    ``max(N, DECODE_ROWS)`` rows (see ``DECODE_ROWS``), so that a slot's
    logits round alike at every slot count up to it (a dense model's).  An
    MoE layer routes the N slot rows alone, dead slots included, as the
    JAX kernel step does: its capacity is set by N and the rows compete
    for it, so a slot's logits depend on its companions and the slot
    count.

    An MLA stack takes :func:`_mla_decode` with per-slot routing, on
    either layout (``ring`` changes nothing: MLA has no window): no decode
    kernel runs there.

    ``ring=True`` (dense and vlm, contiguous only: the paged pool takes no
    ring) reads the stripes of S slots as ring buffers: position ``index``
    is written at slot ``index % S`` and the kernel attends over ``min(index
    + 1, S)`` slots with no window.  That is the windowed attention of the
    JAX ring step because the ring carve windows every layer at
    ``sliding_window >= S`` (``_layer_theta_window(ring=True)``): a ring
    of S slots then holds exactly the live window's positions, every slot
    once, and the softmax does not depend on the order the slots hold
    them in.
    """
    kvcache.check_supported(cfg)
    if cfg.attention == "mla":     # no window: a ring changes nothing
        return _mla_decode(p, cfg, token, cache, tables)
    if ring and (tables is not None or not kernel_supported(cfg)
                 or cfg.family == "audio"):
        raise ValueError("ring decode runs on contiguous dense and vlm "
                         "stripes here; the hybrid family's ring goes "
                         "through stack_decode_step, and the paged pool and "
                         "the audio family take no ring")
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
    P = max(N, DECODE_ROWS)
    rows = torch.arange(N, device=index.device)
    pos = _pad_rows(index, P)[:, None]                       # (P, 1)
    x = _embed_tokens(p, cfg, _pad_rows(token, P))           # (P, 1, d)
    mrope = (mrope_positions_at(pos, cfg.num_frontend_tokens) if cfg.mrope
             else None)                                      # (3, P, 1)
    audio = cfg.family == "audio"
    if audio:
        x = x + _sinusoid(1, cfg.d_model, offset=pos[:, 0]).to(x.dtype)
        src = cache["cross_k"]
        src_len = _source_lengths(N, src.shape[2], src.device)
    idx = index.long()
    S = cache["k"].shape[2]
    lengths = index + 1
    past = None
    if ring:
        widx = idx % S
        lengths = lengths.clamp(max=S)
    elif tables is None:
        widx = idx.clamp(max=S - 1)
        # An MoE layer routes the dead rows too, so a dead slot's row must
        # be the reference's: past its stripe it writes nothing, as the
        # JAX kernel step's out-of-bounds scatter drops, and attends over
        # the stripe as it stands.  Other families' dead rows reach no live
        # one, and write clamped onto the last position.
        past = (idx >= S)[:, None, None] if cfg.is_moe else None
    else:
        pid, off = _paged_position(S, idx, tables)
    for li, (lp, (theta, window)) in enumerate(
            zip(decoder_layers(p), _layer_theta_window(cfg, ring=ring))):
        if ring:
            window = None           # the ring holds the window, no more
        h = _norm(lp["ln1"], x, cfg)
        q, k_new, v_new = attn.gqa_project_qkv(lp["attn"], cfg, h, pos,
                                               rope_theta=theta,
                                               mrope_positions=mrope)
        q, kr, vr = q[:N, 0], k_new[:N, 0], v_new[:N, 0]    # (N, H·, hd)
        if tables is None:
            k_l, v_l = cache["k"][li], cache["v"][li]
            kr, vr = kr.to(k_l.dtype), vr.to(v_l.dtype)
            if past is not None:
                kr = torch.where(past, k_l[rows, widx], kr)
                vr = torch.where(past, v_l[rows, widx], vr)
            k_l[rows, widx] = kr
            v_l[rows, widx] = vr
            o = decode_attention(q, k_l, v_l, lengths, window=window)
        else:
            o = _paged_attention(cache, ("k", "v"), li, q, kr, vr, pid, off,
                                 tables, lengths, window)
        x = x + attn.attn_out(_pad_rows(o, P), lp["attn"]["wo"])[:, None].to(
            x.dtype)
        if audio:
            cp = p["cross"][li]
            h = _norm(cp["ln"], x, cfg)
            qc = attn.gqa_project_q(cp["attn"], cfg, h)[:N, 0]
            o = decode_attention(qc, cache["cross_k"][li],
                                 cache["cross_v"][li], src_len)
            x = x + attn.attn_out(_pad_rows(o, P), cp["attn"]["wo"])[
                :, None].to(x.dtype)
            h = _norm(lp["ln2"], x, cfg)
            x = x + gelu_mlp_apply(lp["mlp"], h)
        elif "moe" in lp:
            h = _norm(lp["ln2"], x, cfg)
            x = x + _pad_rows(_ffn(lp, cfg, h[:N]), P)
        else:
            h = _norm(lp["ln2"], x, cfg)
            x = x + mlp_apply(lp["mlp"], h)
    index.add_(1)
    return _unembed(p, cfg, x)[:N, 0], cache
