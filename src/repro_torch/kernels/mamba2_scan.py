"""Mamba2 (SSD) chunked scan: the CUDA kernel and its plain version.

Counterpart of ``repro/kernels/mamba2_scan.py`` ``mamba2_scan`` (oracle
``repro/kernels/ref.py`` ``mamba2_scan_ref``).  The kernel is
``csrc/mamba2_scan.cu``: the chunked SSD algorithm in three launches (each
chunk's own state, the state passed from chunk to chunk, the output), its
products on the tensor cores; its header says what bounds it on the H100 and
how the design answers that.  Per batch row and head, from a zero state S::

    y_t = r_t^T (w_t S_{t-1} + k_t v_t^T)
    S_t = w_t S_{t-1} + k_t v_t^T,     w_t = exp(log_w_t), one per head

with ``r``/``k`` ``(B, S, H, N)``, ``v`` ``(B, S, H, hd)`` and ``log_w``
``(B, S, H, 1)``; returns ``y`` ``(B, S, H, hd)`` in v's dtype and the final
state ``(B, H, N, hd)`` float32.

:func:`mamba2_scan` dispatches by the device of ``r``: a CPU tensor runs the
plain version, a CUDA tensor launches the kernels or raises, a ``meta``
tensor (the cost walk's) is validated as a CUDA one and takes the meta
case (``kernels.work``), which computes nothing.
``mamba2_scan.launches`` counts calls that launched them (one a call).

:class:`Mamba2ScanFn` is the differentiable form that the model calls,
prefill and training alike: its forward is :func:`mamba2_scan`, its
backward the plain version recomputed under autograd
(:func:`~repro_torch.kernels._recompute.plain_grads`), as the JAX package
differentiates its jnp scan.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels._recompute import plain_grads

MAX_DIM = 128           # N and hd: the kernel's shared-memory sizing
CHUNK = 64              # the kernel's positions per chunk
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def mamba2_scan_plain(r, k, v, log_w, *, chunk: int = 64):
    """The chunked recurrence in float32 PyTorch from a zero state:
    ``models.linear_scan.chunked_decay_attention`` with the decay in the
    output.  ``chunk`` changes the summation order only."""
    # imported here: models.mamba2 imports this module
    from repro_torch.models.linear_scan import chunked_decay_attention
    return chunked_decay_attention(r, k, v, log_w, None, chunk=chunk,
                                   decay_in_output=True)


def mamba2_scan(r, k, v, log_w):
    """r/k: (B,S,H,N); v: (B,S,H,hd); log_w: (B,S,H,1).  Returns
    ``(y (B,S,H,hd) in v's dtype, state (B,H,N,hd) float32)``.

    The kernel takes r and k of one dtype and v of any, each bfloat16 or
    float32 (the model passes r/k in its dtype and v float32), log_w
    float32, N and hd up to 128, and any strides with the last dim
    contiguous (r and k may be stride-0 broadcasts over the heads).  Both
    start from a zero state, as the TPU kernel does."""
    if r.device.type == "cpu":
        return mamba2_scan_plain(r, k, v, log_w)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"mamba2_scan takes CPU or CUDA tensors, not "
                         f"{r.device.type}")
    if r.dim() != 4 or k.shape != r.shape or v.dim() != 4 \
            or v.shape[:3] != r.shape[:3] \
            or tuple(log_w.shape) != (*r.shape[:3], 1):
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, log_w {tuple(log_w.shape)}: "
                         f"want two (B,S,H,N), one (B,S,H,hd) and one "
                         f"(B,S,H,1)")
    B, S, H, N = r.shape
    hd = v.shape[3]
    if S < 1 or N > MAX_DIM or hd > MAX_DIM:
        raise ValueError(f"kernel takes S >= 1 and N, hd up to {MAX_DIM}; "
                         f"got S {S}, N {N}, hd {hd}")
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype \
            or v.dtype not in _DTYPE_CODES:
        raise TypeError(f"r/k/v dtypes {r.dtype}/{k.dtype}/{v.dtype}: the "
                        f"kernel takes r and k of one dtype and v, each "
                        f"bfloat16 or float32")
    if log_w.dtype != torch.float32:
        raise TypeError(f"log_w {log_w.dtype}: the kernel takes float32")
    for name, t in (("r", r), ("k", k), ("v", v), ("log_w", log_w)):
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
        if name != "log_w" and t.stride(-1) != 1:
            raise ValueError(f"{name} strides {t.stride()}: the last dim "
                             f"must be contiguous")
    if r.device.type == "meta":
        return _scan_meta(r, k, v, log_w)
    y = torch.empty((B, S, H, hd), dtype=v.dtype, device=r.device)
    state = torch.empty((B, H, N, hd), dtype=torch.float32, device=r.device)
    # the kernel's scratch (its size checked there): every chunk's (D, D)
    # state, then its decay
    D = 64 if max(N, hd) <= 64 else 128
    scratch = torch.empty((B * -(-S // CHUNK) * H * (D * D + 1),),
                          dtype=torch.float32, device=r.device)
    err = _build.load("mamba2_scan").mamba2_scan_forward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
        scratch.numel() * scratch.element_size(),
        *(s for t in (r, k, v, log_w, y) for s in t.stride()[:3]),
        B, S, H, N, hd, _DTYPE_CODES[r.dtype], _DTYPE_CODES[v.dtype],
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check("mamba2_scan", err, "mamba2_scan launch")
    _build.count(mamba2_scan)
    return y, state


mamba2_scan.launches = 0


def _scan_meta(r, k, v, log_w):
    """The meta case: every input gathered over its sequence and last
    dims; y and the state in v's batch and head placements; the local
    shards' work recorded, r and k counted once a head when they are
    broadcasts over the heads (stride 0), as the model passes them."""
    shared = r.stride(2) == 0 and k.stride(2) == 0
    r, k, v, log_w = (work.gather_dims(t, (1, 3))
                      for t in (r, k, v, log_w))
    B, S, H, hd = work.local(v).shape
    N = r.shape[3]
    work.record("mamba2_scan", *work.mamba2_scan_work(
        B, S, H, N, hd, work.elem_name(r.dtype), work.elem_name(v.dtype),
        shared=shared))
    y = work.wrap_like(torch.empty((B, S, H, hd), dtype=v.dtype,
                                   device="meta"), v, {0: 0, 2: 2})
    state = work.wrap_like(torch.empty((B, H, N, hd), dtype=torch.float32,
                                       device="meta"), v, {0: 0, 2: 1})
    return y, state


class Mamba2ScanFn(torch.autograd.Function):
    """Differentiable :func:`mamba2_scan`: ``apply(r, k, v, log_w) -> (y,
    state)``.  The forward is the kernel (the plain version on the CPU)
    and launches nothing more; the backward recomputes
    :func:`mamba2_scan_plain` from the saved inputs and takes the gradients
    of ``y`` and of the final state (None when the caller drops it).  Each
    gradient has its input's shape: where the model passes r and k as
    stride-0 broadcasts over the heads, autograd sums them back through
    the expand."""

    @staticmethod
    def forward(ctx, r, k, v, log_w):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, log_w)
        return mamba2_scan(r, k, v, log_w)

    @staticmethod
    def backward(ctx, dy, dstate):
        saved, needs = ctx.saved_tensors, ctx.needs_input_grad
        if work.is_dtensor(saved[2]):
            # the meta case: the recompute walked on one rank's shapes
            r, k, v, _ = saved
            shared = r.stride(2) == 0 and k.stride(2) == 0
            gathered = [work.gather_dims(t, (1, 3)) for t in saved]
            B, S, H, hd = work.local(gathered[2]).shape
            N, f32 = r.shape[3], torch.float32
            rk = [work.empty(B, S, 1 if shared else H, N, dtype=t.dtype)
                  .expand(B, S, H, N) for t in (r, k)]
            with work.scope("mamba2_scan_backward"):
                plain_grads(mamba2_scan_plain, (
                    *rk, work.empty(B, S, H, hd, dtype=v.dtype),
                    work.empty(B, S, H, 1, dtype=f32)), needs, (
                    None if dy is None else work.empty(B, S, H, hd,
                                                       dtype=dy.dtype),
                    None if dstate is None else work.empty(B, H, N, hd,
                                                           dtype=f32)))
            return work.zero_grads(saved, needs)
        return plain_grads(mamba2_scan_plain, saved, needs, (dy, dstate))
