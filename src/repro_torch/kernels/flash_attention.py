"""Causal GQA flash attention: the CUDA forward kernel, its plain version,
and the autograd function the training forward runs through.

Counterpart of ``repro/kernels/flash_attention.py`` (oracle
``repro/kernels/ref.py`` ``flash_attention_ref``).  The kernel is
``csrc/flash_attention.cu``; its header says what bounds it on the H100
and how the design answers that.  Layouts are the JAX package's: ``q
(B, S, H, D)``, ``k`` ``(B, S, Hkv, D)`` and ``v`` ``(B, S, Hkv, Dv)``
with ``H % Hkv == 0``; the kernel reads them in place through their
strides.  ``Dv`` is ``D`` but for deepseek-v2's MLA prefill, whose
expanded keys are 192 wide (128 + 64 rope columns) and values 128 (the
instance ``MLA_HEAD_DIMS``); the scores are scaled by ``D ** -0.5``.

:func:`flash_attention` dispatches by the device of ``q``: a CPU tensor
runs the plain PyTorch version, a CUDA tensor launches the kernel or
raises, a ``meta`` tensor (the cost walk's) is validated as a CUDA one and
takes the meta case (``kernels.work``), which computes nothing.
``flash_attention.launches`` counts kernel launches.

:class:`FlashAttentionFn` is the differentiable form: its forward is
:func:`flash_attention` (which also returns the per-row log-sum-exp), its
backward :func:`flash_attention_backward_plain`, plain PyTorch that
recomputes the probabilities from q, k and the log-sum-exp over 1024-row
query chunks, for ``Dv == D`` and for MLA's ``Dv != D``.  The JAX package
has no backward kernel; a hand-written one is later work (ROADMAP).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, work

NEG_INF = -1.0e30
NO_WINDOW = 2 ** 30     # matches models.stacks.NO_WINDOW: never masks
MAX_HEAD_DIM = 256      # the largest of the kernels' head-dim instances
SMALL_HEAD_DIMS = 128   # every multiple of 16 up to it has an instance
MLA_HEAD_DIMS = (192, 128)  # (D, Dv): the one instance with Dv != D
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _window(window) -> int:
    return NO_WINDOW if window is None else int(window)


def _mask(q_pos, k_pos, causal: bool, window) -> torch.Tensor:
    """(Sq, Sk) bool: key j is visible from query i."""
    if not causal:
        return torch.ones((len(q_pos), len(k_pos)), dtype=torch.bool,
                          device=q_pos.device)
    m = k_pos[None, :] <= q_pos[:, None]
    return m & ((q_pos[:, None] - k_pos[None, :]) < _window(window))


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the chip smoke's reference)
# ---------------------------------------------------------------------------
def flash_attention_plain(q, k, v, *, causal: bool = True, window=None,
                          return_lse: bool = False):
    """``flash_attention_ref``: scores (scaled by ``D ** -0.5``), softmax
    and the value sum in float32 over positions ``0..S-1``, cast to q's
    dtype at the end: ``(B, S, H, Dv)``.  With
    ``return_lse`` also the log-sum-exp ``(B, H, S)`` float32 of the
    scaled, masked scores."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.float().reshape(B, S, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * D ** -0.5
    pos = torch.arange(S, device=q.device)
    s = torch.where(_mask(pos, pos, causal, window), s,
                    torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    out = o.reshape(B, S, H, -1).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(s, dim=-1).reshape(B, H, S)


def flash_attention_backward_plain(q, k, v, out, lse, dout, *,
                                   causal: bool = True, window=None,
                                   block_q: int = 1024):
    """Gradients of :func:`flash_attention` with respect to q, k and v.

    Recomputes ``p = exp(s - lse)`` (masked entries exactly 0) one chunk of
    ``block_q`` query rows at a time, so memory stays ``O(block_q * S)``
    per head; with ``delta = rowsum(dout * out)``, ``ds = p * (dout v^T -
    delta)``.  Sums in float32; dk and dv are summed over the G query heads
    of each KV head.  ``dout`` and ``out`` are ``Dv`` wide, as ``v`` (MLA's
    192 / 128).  Returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    B, S, H, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    G = H // Hkv
    scale = D ** -0.5
    qf = q.float().reshape(B, S, Hkv, G, D)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(B, S, Hkv, G, Dv)
    delta = (do * out.float().reshape(B, S, Hkv, G, Dv)).sum(-1)  # (B,S,Hkv,G)
    lse_g = lse.reshape(B, Hkv, G, S)
    dq = torch.empty_like(qf)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    pos = torch.arange(S, device=q.device)
    for a in range(0, S, block_q):
        e = min(a + block_q, S)
        n = e if causal else S          # keys past the chunk's last row
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, a:e], kf[:, :n]) * scale
        p = torch.where(_mask(pos[a:e], pos[:n], causal, window),
                        torch.exp(s - lse_g[..., a:e, None]),
                        torch.zeros_like(s))
        dv[:, :n] += torch.einsum("bhgqk,bqhgd->bkhd", p, do[:, a:e])
        dp = torch.einsum("bqhgd,bkhd->bhgqk", do[:, a:e], vf[:, :n])
        ds = p * (dp - delta[:, a:e].permute(0, 2, 3, 1)[..., None])
        dq[:, a:e] = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf[:, :n]) * scale
        dk[:, :n] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qf[:, a:e]) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    return_lse: bool = False):
    """q: (B,S,H,D); k: (B,S,Hkv,D); v: (B,S,Hkv,Dv); H % Hkv == 0; bf16
    or float32.  Causal (optionally windowed) self-attention over
    positions ``0..S-1``, scores scaled by ``D ** -0.5``.  Returns
    ``(B,S,H,Dv)`` in q's dtype, and with ``return_lse`` the ``(B,H,S)``
    float32 log-sum-exp as well.  ``Dv == D`` (a multiple of 16 up to
    128, or 256), or ``(D, Dv) == MLA_HEAD_DIMS``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     return_lse=return_lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention takes CPU or CUDA tensors, not "
                         f"{q.device.type}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B,S,H,D), (B,S,Hkv,D) "
                         f"and (B,S,Hkv,Dv)")
    B, S, H, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[3]
    if k.shape[:2] != (B, S) or k.shape[3] != D or H % Hkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H % Hkv must be 0)")
    if (D, Dv) != MLA_HEAD_DIMS and (
            Dv != D or D % 16 or (D > SMALL_HEAD_DIMS and D != MAX_HEAD_DIM)):
        raise ValueError(f"kernel takes head dims Dv = D that are multiples "
                         f"of 16 up to {SMALL_HEAD_DIMS}, and "
                         f"{MAX_HEAD_DIM}, and (D, Dv) = {MLA_HEAD_DIMS}; "
                         f"got ({D}, {Dv})")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                        f"kernel takes all bfloat16 or all float32")
    vec = 16 // q.element_size()        # elements per 16-byte load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name} strides {t.stride()}: the head dim "
                             f"must be contiguous and the other strides "
                             f"multiples of {vec} elements")
    if q.device.type == "meta":
        return _flash_meta(q, k, v, causal, window, return_lse)
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    err = lib.flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], B, S, H, Hkv, D, Dv, int(causal), _window(window),
        D ** -0.5, _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", err, "flash_attention launch")
    _build.count(flash_attention)
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def _flash_meta(q, k, v, causal, window, return_lse):
    """The meta case: keys and values gathered over their sequence and
    head dims, q over its head dim; outputs in q's batch, sequence and head
    placements; the local shards' work recorded."""
    q = work.gather_dims(q, (3,))
    k, v = (work.gather_dims(t, (1, 3)) for t in (k, v))
    ql, kl = work.local(q), work.local(k)
    B, Sq, H, D = ql.shape
    S, Hkv, Dv = kl.shape[1], kl.shape[2], v.shape[3]
    ops, n_bytes = work.flash_attention_work(
        B, S, H, Hkv, D, Dv, causal=causal, window=window,
        elem=q.element_size(), q_rows=Sq)
    work.record("flash_attention", ops, n_bytes)
    out = work.wrap_like(torch.empty((B, Sq, H, Dv), dtype=q.dtype,
                                     device="meta"), q, {0: 0, 1: 1, 2: 2})
    if not return_lse:
        return out
    lse = work.wrap_like(torch.empty((B, H, Sq), dtype=torch.float32,
                                     device="meta"), q, {0: 0, 1: 2, 2: 1})
    return out, lse


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable :func:`flash_attention`: the kernel (or, on the CPU,
    the plain version) forward; the plain chunked backward
    (:func:`flash_attention_backward_plain`), for ``Dv == D`` and for
    MLA's ``Dv != D`` alike."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, window=None):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if work.is_dtensor(q):
            return _backward_meta(ctx, q, k, v, dout)
        with work.scope("flash_attention_backward"):
            dq, dk, dv = flash_attention_backward_plain(
                q, k, v, out, lse, dout, causal=ctx.causal,
                window=ctx.window)
        return dq, dk, dv, None, None


def _backward_meta(ctx, q, k, v, dout):
    """The plain backward's meta case on ``DTensor``\\ s: walked on meta
    tensors of one rank's shapes (q's local rows and heads, the keys
    gathered as the forward's meta case gathers them, one key head a
    local group), zeros returned in the inputs' placements."""
    k_l = work.local(work.gather_dims(k, (1, 3)))
    work.gather_dims(v, (1, 3))
    B, S, H, D = work.local(work.gather_dims(q, (3,))).shape
    Dv, f32 = v.shape[3], torch.float32
    Hkv = max(1, H * k.shape[2] // q.shape[2])
    with work.scope("flash_attention_backward"):
        flash_attention_backward_plain(
            work.empty(B, S, H, D, dtype=q.dtype),
            work.empty(B, S, Hkv, D, dtype=k_l.dtype),
            work.empty(B, S, Hkv, Dv, dtype=v.dtype),
            work.empty(B, S, H, Dv, dtype=q.dtype),
            work.empty(B, H, S, dtype=f32),
            work.empty(B, S, H, Dv, dtype=dout.dtype),
            causal=ctx.causal, window=ctx.window)
    return work.zero_grads((q, k, v), ctx.needs_input_grad[:3]) \
        + (None, None)
