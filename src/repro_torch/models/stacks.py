"""Layer-stack parameters, the pieces every stack step shares (init and
its logical specs :func:`stack_specs`, embedding, unembedding, norms, the
per-layer rope theta and window) and the full-sequence training forward
:func:`stack_forward`.

Counterpart of ``repro/models/stacks.py``: the dense GQA, vlm (qwen2-vl),
audio (whisper: LayerNorm, gelu MLPs, an encoder and cross-attention), MoE
(dbrx, and deepseek-v2 with MLA: leading dense layers, then MoE layers),
ssm (rwkv6) and hybrid (zamba2) branches of the init and of the forward,
the vision-embedding overlay and the audio encoder
(:func:`encode_source`).  Where the
JAX package stacks layers on axis 0 for ``lax.scan``, the port keeps
``params["layers"]`` as a Python list of per-layer dicts and loops over it.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (default_mrope_positions,
                                       dense_init, embed_init,
                                       gelu_mlp_apply, gelu_mlp_init,
                                       gelu_mlp_specs, layer_norm,
                                       mlp_apply, mlp_init, mlp_specs,
                                       rms_norm, torch_dtype)
from repro_torch.models.kvcache import check_supported
from repro_torch.models.mamba2 import (mamba2_apply_full, mamba2_init,
                                       mamba2_specs)
from repro_torch.models.moe import moe_apply, moe_init, moe_specs
from repro_torch.models.rwkv6 import (rwkv6_channel_mix, rwkv6_init,
                                      rwkv6_specs, rwkv6_time_mix_full)
from repro_torch.models.sharding import constrain

NO_WINDOW = 2 ** 30     # far beyond any max_seq_len: never masks


def _norm(w, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The audio family's LayerNorm (``w = {"w", "b"}``), everyone else's
    RMSNorm (``w`` a tensor)."""
    if cfg.family == "audio":
        return layer_norm(x, w["w"], w["b"], cfg.norm_eps)
    return rms_norm(x, w, cfg.norm_eps)


def _sinusoid(seq: int, d: int, offset=0, device=None) -> torch.Tensor:
    """Sinusoidal positions ``(seq, d)`` float32 of positions ``arange(seq)
    + offset`` (the audio family's).  ``offset`` may be an integer tensor
    of any shape, which then leads the result: ``(*offset.shape, seq, d)``
    (a decode step's per-slot positions, computed on the device)."""
    if isinstance(offset, torch.Tensor):
        device = offset.device
        pos = (torch.arange(seq, device=device)
               + offset.long()[..., None]).float()
    else:
        pos = torch.arange(offset, offset + seq, device=device).float()
    inv = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=device) / d * math.log(10000.0))
    ang = pos[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[..., :d]


def _layer_theta_window(cfg: ModelConfig, *,
                        ring: bool = False) -> list[tuple[float, int]]:
    """Per-layer ``(rope_theta, window)``: ``local_global_ratio`` local
    layers (theta 1e4, sliding window) per global layer, else one pair for
    every layer.  ``ring=True`` is the long-context carve of a ring cache:
    the global layers are windowed too (their thetas stay)."""
    if cfg.local_global_ratio and cfg.sliding_window:
        r = cfg.local_global_ratio
        glob = NO_WINDOW if not ring else cfg.sliding_window
        return [(cfg.rope_theta, glob) if i % (r + 1) == r
                else (1.0e4, cfg.sliding_window)
                for i in range(cfg.num_layers)]
    w = cfg.sliding_window if cfg.sliding_window else NO_WINDOW
    return [(cfg.rope_theta, w)] * cfg.num_layers


def stack_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on ``gen``'s device: ``embed (V, d)``,
    ``final_norm (d,)``, ``lm_head (d, V)`` and ``layers``, a list of
    ``{"ln1", "ln2", "attn": {wq, wk, wv, wo}, "mlp": {wi_gate, wi_up,
    wo}}`` (dense; vlm adds the QKV biases ``bq``, ``bk``, ``bv``),
    ``{"ln1", "ln2", "mix": <rwkv6 block>}`` (ssm) or ``{"norm", "mamba":
    <mamba2 block>}`` (hybrid, which also holds one ``shared_attn =
    {"ln1", "attn", "ln2", "mlp"}`` that every ``hybrid_attn_every``-th
    layer applies) in the JAX package's weight layouts.  The MoE family
    has ``layers`` of ``{"ln1", "ln2", "attn", "moe": <moe block>}`` and,
    with ``first_dense_layers``, a leading ``dense_layers`` group of dense
    layers whose MLP is ``d_ff`` wide; with ``attention="mla"`` every
    ``attn`` of both is an MLA block (:func:`~repro_torch.models.attention.
    mla_init`).  The audio family
    has LayerNorms ``{"w", "b"}``, gelu MLPs ``{wi, bi, wo, bo}``, an
    ``encoder = {"layers", "final_norm"}`` of such layers and ``cross``, a
    list of ``{"ln", "attn"}`` per decoder layer."""
    check_supported(cfg)
    dt = torch_dtype(cfg.dtype)
    dev = gen.device

    def norm():
        if cfg.family == "audio":
            return {"w": torch.ones((cfg.d_model,), dtype=dt, device=dev),
                    "b": torch.zeros((cfg.d_model,), dtype=dt, device=dev)}
        return torch.zeros((cfg.d_model,), dtype=dt, device=dev)

    p: dict = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
               "final_norm": norm()}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, (cfg.vocab_size,), dt)
    if cfg.family == "ssm":
        p["layers"] = [{"ln1": norm(), "ln2": norm(),
                        "mix": rwkv6_init(gen, cfg)}
                       for _ in range(cfg.num_layers)]
        return p
    if cfg.family == "hybrid":
        p["layers"] = [{"norm": norm(), "mamba": mamba2_init(gen, cfg)}
                       for _ in range(cfg.num_layers)]
        p["shared_attn"] = {"ln1": norm(), "attn": attn.gqa_init(gen, cfg),
                            "ln2": norm(),
                            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dt)}
        return p
    if cfg.family == "audio":
        def layer():
            return {"ln1": norm(), "ln2": norm(),
                    "attn": attn.gqa_init(gen, cfg),
                    "mlp": gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dt)}
        p["layers"] = [layer() for _ in range(cfg.num_layers)]
        p["encoder"] = {"layers": [layer()
                                   for _ in range(cfg.encoder_layers)],
                        "final_norm": norm()}
        p["cross"] = [{"ln": norm(), "attn": attn.gqa_init(gen, cfg)}
                      for _ in range(cfg.num_layers)]
        return p

    def attention():
        return (attn.mla_init(gen, cfg) if cfg.attention == "mla"
                else attn.gqa_init(gen, cfg))

    def dense_layer():
        return {"ln1": norm(), "ln2": norm(), "attn": attention(),
                "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dt)}
    if cfg.is_moe:
        n_dense = cfg.first_dense_layers
        if n_dense:
            p["dense_layers"] = [dense_layer() for _ in range(n_dense)]
        p["layers"] = [{"ln1": norm(), "ln2": norm(), "attn": attention(),
                        "moe": moe_init(gen, cfg)}
                       for _ in range(cfg.num_layers - n_dense)]
        return p
    p["layers"] = [dense_layer() for _ in range(cfg.num_layers)]
    return p


def _norm_spec(cfg: ModelConfig):
    if cfg.family == "audio":
        return {"w": ("embed",), "b": ("embed",)}
    return ("embed",)


def _dense_layer_specs(cfg: ModelConfig, *, use_moe: bool) -> dict:
    s = {"ln1": _norm_spec(cfg), "ln2": _norm_spec(cfg)}
    s["attn"] = (attn.mla_specs(cfg) if cfg.attention == "mla"
                 else attn.gqa_specs(cfg))
    if use_moe:
        s["moe"] = moe_specs(cfg)
    elif cfg.family == "audio":
        s["mlp"] = gelu_mlp_specs(cfg)
    else:
        s["mlp"] = mlp_specs(cfg)
    return s


def stack_specs(cfg: ModelConfig) -> dict:
    """:func:`stack_init`'s tree with each leaf's logical axes
    (``models.sharding``).  A layer group is a list of per-layer spec
    dicts, without the reference's leading ``"layers"`` axis."""
    s: dict = {"embed": ("vocab", "embed"), "final_norm": _norm_spec(cfg)}
    if not cfg.tie_embeddings:
        s["lm_head"] = ("embed", "vocab")
    fam = cfg.family

    def dense(n):
        return [_dense_layer_specs(cfg, use_moe=False) for _ in range(n)]
    if fam in ("dense", "vlm", "moe", "audio"):
        if cfg.is_moe:
            if cfg.first_dense_layers:
                s["dense_layers"] = dense(cfg.first_dense_layers)
            s["layers"] = [_dense_layer_specs(cfg, use_moe=True) for _ in
                           range(cfg.num_layers - cfg.first_dense_layers)]
        else:
            s["layers"] = dense(cfg.num_layers)
        if fam == "audio":
            s["encoder"] = {"layers": dense(cfg.encoder_layers),
                            "final_norm": _norm_spec(cfg)}
            s["cross"] = [{"ln": _norm_spec(cfg),
                           "attn": attn.gqa_specs(cfg)}
                          for _ in range(cfg.num_layers)]
    elif fam == "ssm":
        s["layers"] = [{"ln1": _norm_spec(cfg), "ln2": _norm_spec(cfg),
                        "mix": rwkv6_specs(cfg)}
                       for _ in range(cfg.num_layers)]
    elif fam == "hybrid":
        s["layers"] = [{"norm": _norm_spec(cfg), "mamba": mamba2_specs(cfg)}
                       for _ in range(cfg.num_layers)]
        s["shared_attn"] = {"ln1": _norm_spec(cfg),
                            "attn": attn.gqa_specs(cfg),
                            "ln2": _norm_spec(cfg), "mlp": mlp_specs(cfg)}
    return s


def decoder_layers(p: dict) -> list:
    """The attention stack's layers in order: an MoE model's leading
    ``dense_layers`` (when it has them), then ``layers``.  The cache's
    layer index and :func:`_layer_theta_window` run across both."""
    return p.get("dense_layers", []) + p["layers"]


def _embed_tokens(p: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  frontend=None) -> torch.Tensor:
    """Token embeddings ``(B, S, d)``; gemma3 scales them by sqrt(d).  A
    vlm ``frontend`` ``(B, F, d)`` (precomputed vision embeddings) is
    written over the first F positions; other families ignore it here
    (the audio family's goes to :func:`encode_source`)."""
    x = torch.nn.functional.embedding(tokens.long(), p["embed"])
    if cfg.local_global_ratio:           # gemma3 scales its embeddings
        x = x * math.sqrt(cfg.d_model)
    if frontend is not None and cfg.family == "vlm":
        F = frontend.shape[1]
        if F > x.shape[1]:
            raise ValueError(f"a frontend of {F} positions is longer than "
                             f"the prompt's {x.shape[1]}")
        x = torch.cat([frontend.to(x.dtype).expand(x.shape[0], F, -1),
                       x[:, F:]], dim=1)
    return constrain(x, ("batch", "seq", "embed_act"))


def _unembed(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and vocabulary projection; float32 logits."""
    x = _norm(p["final_norm"], x, cfg)
    w = p["embed"].t() if cfg.tie_embeddings else p["lm_head"]
    return constrain((x @ w).float(), ("batch", "seq", "vocab_act"))


def _shared_block_full(sp: dict, cfg: ModelConfig, x, positions, pos):
    """The hybrid family's shared attention + MLP block over a whole
    sequence; returns ``(x, k, v)``."""
    h = _norm(sp["ln1"], x, cfg)
    q, k, v = attn.gqa_project_qkv(sp["attn"], cfg, h, positions)
    out = attn.multi_head_attention(q, k, v, pos, pos, causal=True)
    x = x + attn.attn_out(out, sp["attn"]["wo"])
    h = _norm(sp["ln2"], x, cfg)
    return x + mlp_apply(sp["mlp"], h), k, v


def _decoder_layer(lp: dict, cfg: ModelConfig, x, aux, positions, theta,
                   window, mrope):
    """One dense, vlm or MoE layer (GQA or MLA attention; an MoE layer adds
    its aux loss to ``aux``); returns ``(x, aux)``."""
    h = _norm(lp["ln1"], x, cfg)
    if cfg.attention == "mla":
        a = attn.mla_apply_full(lp["attn"], cfg, h, positions)
    else:
        a = attn.gqa_apply_full(lp["attn"], cfg, h, positions, window=window,
                                rope_theta=theta, mrope_positions=mrope)
    x = x + a
    h = _norm(lp["ln2"], x, cfg)
    if "moe" in lp:
        f, al = moe_apply(lp["moe"], cfg, h)
        aux = aux + al
    else:
        f = mlp_apply(lp["mlp"], h)
    return x + f, aux


def _rwkv6_layer(lp: dict, cfg: ModelConfig, x):
    h = _norm(lp["ln1"], x, cfg)
    x = x + rwkv6_time_mix_full(lp["mix"], cfg, h)[0]
    h = _norm(lp["ln2"], x, cfg)
    return x + rwkv6_channel_mix(lp["mix"], cfg, h)[0]


def _hybrid_layer(lp: dict, shared, cfg: ModelConfig, x, positions):
    """A Mamba2 layer, then the shared block when ``shared`` is given."""
    h = _norm(lp["norm"], x, cfg)
    x = x + mamba2_apply_full(lp["mamba"], cfg, h)[0]
    if shared is not None:
        x = _shared_block_full(shared, cfg, x, positions, positions[0])[0]
    return x


def _audio_layer(lp: dict, cp: dict, cfg: ModelConfig, x, enc, positions):
    """A decoder layer: causal self-attention, cross-attention over the
    K/V projected from the encoder output ``enc``, the gelu MLP."""
    h = _norm(lp["ln1"], x, cfg)
    x = x + attn.gqa_apply_full(lp["attn"], cfg, h, positions)
    h = _norm(cp["ln"], x, cfg)
    ek, ev = attn.gqa_project_kv(cp["attn"], cfg, enc)
    x = x + attn.gqa_apply_cross(cp["attn"], cfg, h, ek, ev)
    h = _norm(lp["ln2"], x, cfg)
    return x + gelu_mlp_apply(lp["mlp"], h)


def stack_forward(p: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                  frontend=None, remat: bool = False):
    """tokens: (B,S) integer -> (logits (B,S,V) float32, aux float32
    scalar), the training forward of every family, step for step the JAX
    package's:

    * dense, vlm and MoE share one layer body: a vlm ``frontend (B, F, d)``
      overlays the first F embeddings and M-RoPE rotates at
      ``default_mrope_positions(B, S, num_frontend_tokens)``; an MoE model
      runs its leading ``dense_layers``, then its MoE layers, and ``aux``
      sums their load-balance losses; MLA goes through
      :func:`~repro_torch.models.attention.mla_apply_full`;
    * ssm (rwkv6): the time mix and the channel mix of each layer;
    * hybrid (zamba2): each Mamba2 layer, and after every
      ``hybrid_attn_every``-th the one ``shared_attn`` block (its
      gradients add up over its uses);
    * audio (whisper): :func:`encode_source` over the ``frontend`` frames
      (which it needs), sinusoidal decoder positions, and a cross-attention
      per layer over K/V projected from the encoder output.

    ``aux`` is 0 but for the MoE family.  ``remat=True`` wraps each
    decoder layer in ``torch.utils.checkpoint`` (non-reentrant), the
    counterpart of the JAX package's ``jax.checkpoint`` around the scanned
    layer body: the layer's activations, its kernels' launches included,
    are recomputed in the backward pass."""
    B, S = tokens.shape
    x = _embed_tokens(p, cfg, tokens, frontend)
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    if cfg.family == "ssm":
        for lp in p["layers"]:
            x = layer(_rwkv6_layer, lp, cfg, x)
    elif cfg.family == "hybrid":
        every = cfg.hybrid_attn_every
        for li, lp in enumerate(p["layers"]):
            shared = p["shared_attn"] if (li + 1) % every == 0 else None
            x = layer(_hybrid_layer, lp, shared, cfg, x, positions)
    elif cfg.family == "audio":
        if frontend is None:
            raise ValueError("the audio family needs its frame embeddings: "
                             "frontend (B, max_source_len, d_model)")
        enc = encode_source(p, cfg, frontend)
        x = x + _sinusoid(S, cfg.d_model, device=x.device).to(x.dtype)
        for lp, cp in zip(p["layers"], p["cross"]):
            x = layer(_audio_layer, lp, cp, cfg, x, enc, positions)
    else:
        mrope = (default_mrope_positions(B, S, cfg.num_frontend_tokens,
                                         x.device) if cfg.mrope else None)
        for lp, (theta, window) in zip(decoder_layers(p),
                                       _layer_theta_window(cfg)):
            x, aux = layer(_decoder_layer, lp, cfg, x, aux, positions, theta,
                           window, mrope)
    return _unembed(p, cfg, x), aux


def encode_source(p: dict, cfg: ModelConfig,
                  frontend: torch.Tensor) -> torch.Tensor:
    """The audio encoder over precomputed frame embeddings ``(B, Ssrc, d)``:
    sinusoidal positions, then bidirectional self-attention layers (flash
    with ``causal=False`` on the card) with gelu MLPs, then its final
    LayerNorm.  Returns ``(B, Ssrc, d)`` in the model dtype."""
    enc = p["encoder"]
    x = frontend.to(torch_dtype(cfg.dtype))
    x = x + _sinusoid(x.shape[1], cfg.d_model, device=x.device).to(x.dtype)
    pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    for lp in enc["layers"]:
        h = _norm(lp["ln1"], x, cfg)
        x = x + attn.gqa_apply_full(lp["attn"], cfg, h, pos, causal=False,
                                    rope_theta=0.0)
        h = _norm(lp["ln2"], x, cfg)
        x = x + gelu_mlp_apply(lp["mlp"], h)
    return _norm(enc["final_norm"], x, cfg)
