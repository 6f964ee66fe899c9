"""The plain float32 forward of the benchmark's architecture.

Written from the published description, in plain PyTorch, with no kernel,
cache or batching, and nothing of the program under test: a dense GQA
decoder (InternLM2, arXiv:2403.17297) of RMSNorm, rotary positions on
queries and keys (the two halves of each head rotated against each
other), grouped-query causal softmax attention, a SwiGLU MLP, a final
RMSNorm and an untied output head.

Its sizes come from the configuration's file alone (the published keys:
``num_hidden_layers``, ``hidden_size``, ``num_attention_heads``,
``num_key_value_heads``, ``head_dim``, ``intermediate_size``,
``vocab_size``, ``rope_theta``, ``rms_norm_eps``,
``tie_word_embeddings``); :func:`weight_shapes` states the weights those
sizes imply, which the harness holds the program's against.

The one departure from the published model, which the configuration's
file lists under ``assumed`` as well: every RMSNorm scales by ``1 + w``
(a zero weight is the identity).

Weights arrive as a nested dict of tensors (the layout the benchmark
hands to both sides); every product here is float32, so the caller turns
TF32 off (:func:`float32_matmuls`).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def float32_matmuls():
    """Products in true float32: TF32 off for matmuls and convolutions,
    restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, theta):
    """x (B, S, H, D) at positions 0..S-1: channel i of the first half and
    channel i of the second half rotate by the angle pos * theta^(-i/half)."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    inv = 1.0 / theta ** (torch.arange(half, device=x.device,
                                       dtype=torch.float32) / half)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(p, x, cfg):
    """Grouped-query causal attention of ``x`` (B, S, d): query head h reads
    key/value head ``h // (H / Hkv)``; scores scaled by D^-1/2."""
    B, S, _ = x.shape
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"])
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    H, Hkv, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    k = k.repeat_interleave(H // Hkv, dim=2)
    v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhe,bkhe->bhqk", q, k) * D ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    a = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhe->bqhe", a, v)
    return torch.einsum("bqhe,hed->bqd", o, p["wo"])


def swiglu(p, x):
    return (F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"]


def weight_shapes(cfg) -> dict:
    """``{path: shape}`` of the weights the configuration's sizes imply,
    paths as the benchmark's trees name them."""
    d, V, F_ = cfg["hidden_size"], cfg["vocab_size"], cfg["intermediate_size"]
    H, Hkv, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                 cfg["head_dim"])
    out = {"embed": (V, d), "final_norm": (d,)}
    if not cfg["tie_word_embeddings"]:
        out["lm_head"] = (d, V)
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers/{i}/"
        out.update({p + "ln1": (d,), p + "ln2": (d,),
                    p + "attn/wq": (d, H, D), p + "attn/wk": (d, Hkv, D),
                    p + "attn/wv": (d, Hkv, D), p + "attn/wo": (H, D, d),
                    p + "mlp/wi_gate": (d, F_), p + "mlp/wi_up": (d, F_),
                    p + "mlp/wo": (F_, d)})
    return out


def forward(params, cfg, tokens):
    """tokens (B, S) -> float32 logits (B, S, V)."""
    eps = cfg["rms_norm_eps"]
    x = params["embed"][tokens.long()]
    for lp in params["layers"]:
        x = x + causal_attention(lp["attn"], rms_norm(x, lp["ln1"], eps),
                                 cfg)
        x = x + swiglu(lp["mlp"], rms_norm(x, lp["ln2"], eps))
    x = rms_norm(x, params["final_norm"], eps)
    head = (params["embed"].t() if cfg["tie_word_embeddings"]
            else params["lm_head"])
    return x @ head
