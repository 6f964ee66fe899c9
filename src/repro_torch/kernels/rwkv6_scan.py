"""RWKV6 (Finch) chunked WKV scan: the CUDA kernel and its plain version.

Counterpart of ``repro/kernels/rwkv6_scan.py`` ``rwkv6_scan`` (oracle
``repro/kernels/ref.py`` ``rwkv6_scan_ref``).  The kernel is
``csrc/rwkv6_scan.cu``, three launches a call (chunk states, state
passing, output) with every chunk in parallel; its header says what
bounds it on the H100 and how the design answers that.  Per batch row and
head, from a zero state S::

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(exp(log_w_t)) S_{t-1} + k_t v_t^T

with ``r``/``k``/``log_w`` ``(B, S, H, Dk)``, ``v`` ``(B, S, H, Dv)``, ``u``
``(H, Dk)``; returns ``y`` ``(B, S, H, Dv)`` in v's dtype and the final
state ``(B, H, Dk, Dv)`` float32.

:func:`rwkv6_scan` dispatches by the device of ``r``: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel or raises, a ``meta``
tensor (the cost walk's) is validated as a CUDA one and takes the meta
case (``kernels.work``), which computes nothing.
``rwkv6_scan.launches`` counts kernel launches.

:class:`Rwkv6ScanFn` is the differentiable form that the model calls,
prefill and training alike: its forward is :func:`rwkv6_scan`, its
backward the plain version recomputed under autograd
(:func:`~repro_torch.kernels._recompute.plain_grads`), as the JAX package
differentiates its jnp scan.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels._recompute import plain_grads

MAX_HEAD_DIM = 128      # the kernel's shared-memory sizing
CHUNK = 64              # positions per chunk of the kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rwkv6_scan_plain(r, k, v, log_w, u, *, initial_state=None):
    """The chunked recurrence in float32 PyTorch (64-position chunks):
    ``models.linear_scan.chunked_decay_attention`` with the bonus ``u``,
    from ``initial_state`` (default zeros)."""
    # imported here: models.rwkv6 imports this module
    from repro_torch.models.linear_scan import chunked_decay_attention
    return chunked_decay_attention(r, k, v, log_w, u,
                                   initial_state=initial_state)


def rwkv6_scan(r, k, v, log_w, u, *, initial_state=None):
    """r/k/log_w: (B,S,H,Dk); v: (B,S,H,Dv); u: (H,Dk).  Returns
    ``(y (B,S,H,Dv) in v's dtype, state (B,H,Dk,Dv) float32)``.

    The kernel takes r, k and v all bfloat16 or all float32, log_w and u
    float32, head dims up to 128, and starts from a zero state, as the TPU
    kernel does: an ``initial_state`` runs only on the CPU."""
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, log_w, u,
                                initial_state=initial_state)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"rwkv6_scan takes CPU or CUDA tensors, not "
                         f"{r.device.type}")
    if initial_state is not None:
        raise NotImplementedError(
            "the CUDA rwkv6_scan starts from a zero state, as the TPU kernel "
            "does; every prefill starts from zero and no caller passes one")
    if r.dim() != 4 or k.shape != r.shape or log_w.shape != r.shape \
            or v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)}, log_w "
                         f"{tuple(log_w.shape)}, v {tuple(v.shape)}: want "
                         f"three (B,S,H,Dk) and one (B,S,H,Dv)")
    B, S, H, Dk = r.shape
    Dv = v.shape[3]
    if tuple(u.shape) != (H, Dk):
        raise ValueError(f"u {tuple(u.shape)}: want (H, Dk) = {(H, Dk)}")
    if S < 1 or Dk > MAX_HEAD_DIM or Dv > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes S >= 1 and head dims up to "
                         f"{MAX_HEAD_DIM}; got S {S}, Dk {Dk}, Dv {Dv}")
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise TypeError(f"r/k/v dtypes {r.dtype}/{k.dtype}/{v.dtype}: the "
                        f"kernel takes all bfloat16 or all float32")
    if log_w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"log_w {log_w.dtype}, u {u.dtype}: the kernel "
                        f"takes both float32")
    for name, t in (("r", r), ("k", k), ("v", v), ("log_w", log_w),
                    ("u", u)):
        if t.device != r.device:
            raise ValueError(f"{name} on {t.device}, r on {r.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} strides {t.stride()}: the head dim "
                             f"must be contiguous")
    if r.device.type == "meta":
        return _scan_meta(r, k, v, log_w, u)
    u = u.contiguous()
    y = torch.empty((B, S, H, Dv), dtype=v.dtype, device=r.device)
    state = torch.empty((B, H, Dk, Dv), dtype=torch.float32,
                        device=r.device)
    # the kernel's scratch (its size checked there): every chunk's (D, D)
    # state, then its decay, a vector over the key dim
    D = 64 if max(Dk, Dv) <= 64 else 128
    scratch = torch.empty((B * -(-S // CHUNK) * H * D * (D + 1),),
                          dtype=torch.float32, device=r.device)
    lib = _build.load("rwkv6_scan")
    err = lib.rwkv6_scan_forward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
        u.data_ptr(), y.data_ptr(), state.data_ptr(), scratch.data_ptr(),
        scratch.numel() * scratch.element_size(),
        *(s for t in (r, k, v, log_w, y) for s in t.stride()[:3]),
        B, S, H, Dk, Dv, _DTYPE_CODES[r.dtype],
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check("rwkv6_scan", err, "rwkv6_scan launch")
    _build.count(rwkv6_scan)
    return y, state


rwkv6_scan.launches = 0


def _scan_meta(r, k, v, log_w, u):
    """The meta case: every input gathered over its sequence and head
    dims (and u over its key dim); y and the state in v's batch and head
    placements; the local shards' work recorded."""
    r, k, log_w, v = (work.gather_dims(t, (1, 3)) for t in (r, k, log_w, v))
    u = work.gather_dims(u, (1,))
    B, S, H, Dk = work.local(r).shape
    Dv = v.shape[3]
    work.record("rwkv6_scan", *work.rwkv6_scan_work(
        B, S, H, Dk, Dv, work.elem_name(r.dtype), rkv_elem=r.element_size()))
    y = work.wrap_like(torch.empty((B, S, H, Dv), dtype=v.dtype,
                                   device="meta"), v, {0: 0, 2: 2})
    state = work.wrap_like(torch.empty((B, H, Dk, Dv), dtype=torch.float32,
                                       device="meta"), v, {0: 0, 2: 1})
    return y, state


class Rwkv6ScanFn(torch.autograd.Function):
    """Differentiable :func:`rwkv6_scan`: ``apply(r, k, v, log_w, u,
    initial_state=None) -> (y, state)``.  The forward is the kernel (the
    plain version on the CPU) and launches nothing more; the backward
    recomputes :func:`rwkv6_scan_plain` from the saved inputs and takes
    the gradients of ``y`` and of the final state (None when the caller
    drops it) to r, k, v, log_w, u (and the CPU-only initial state)."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, initial_state=None):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, log_w, u, initial_state)
        return rwkv6_scan(r, k, v, log_w, u, initial_state=initial_state)

    @staticmethod
    def backward(ctx, dy, dstate):
        def plain(r, k, v, log_w, u, initial_state=None):
            return rwkv6_scan_plain(r, k, v, log_w, u,
                                    initial_state=initial_state)
        saved, needs = ctx.saved_tensors, ctx.needs_input_grad
        if work.is_dtensor(saved[0]):
            # the meta case: the recompute walked on one rank's shapes
            r, v = saved[0], saved[2]
            gathered = [work.gather_dims(t, (1, 3)) for t in saved[:4]]
            B, S, H, Dk = work.local(gathered[0]).shape
            Dv, f32 = v.shape[3], torch.float32
            with work.scope("rwkv6_scan_backward"):
                plain_grads(plain, (
                    work.empty(B, S, H, Dk, dtype=r.dtype),
                    work.empty(B, S, H, Dk, dtype=saved[1].dtype),
                    work.empty(B, S, H, Dv, dtype=v.dtype),
                    work.empty(B, S, H, Dk, dtype=f32),
                    work.empty(H, Dk, dtype=f32), None), needs, (
                    None if dy is None else work.empty(B, S, H, Dv,
                                                       dtype=dy.dtype),
                    None if dstate is None else work.empty(B, H, Dk, Dv,
                                                           dtype=f32)))
            return work.zero_grads(saved, needs)
        return plain_grads(plain, saved, needs, (dy, dstate))
