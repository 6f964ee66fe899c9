"""Chunked linear attention with per-channel decay, shared by RWKV6 (Finch)
and Mamba2 (SSD).  Counterpart of ``repro/models/linear_scan.py``.

Recurrence (per batch b, head h; state S in R^{Dk x Dv})::

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T ( d_t * S_{t-1} + diag(u_t) k_t v_t^T )

with log w_t <= 0 and

* Mamba2: d_t = w_t (decay applies to the output too), u_t = 1, w scalar
  per head;
* RWKV6: d_t = 1 (the output reads the un-decayed previous state), u_t a
  learned bonus, w per channel and data-dependent.

The chunked algorithm only ever exponentiates non-positive numbers
(exp(cl_t - cl_s) with s <= t), so it is safe in float32.  The CUDA kernel
``kernels/csrc/rwkv6_scan.cu`` runs the same math for RWKV6 prefill; all
three functions here are plain PyTorch.
"""
from __future__ import annotations

import torch


def naive_decay_attention(r, k, v, log_w, u=None, decay_in_output=False):
    """The oracle: a Python loop over time, O(S Dk Dv).

    r, k, log_w: (B, S, H, Dk); v: (B, S, H, Dv); u: (H, Dk) or None.
    Returns ``(y (B, S, H, Dv) in v's dtype, final state (B, H, Dk, Dv)
    float32)``."""
    B, S, H, Dk = r.shape
    Dv = v.shape[-1]
    rf, kf, vf = r.float(), k.float(), v.float()
    lwf = torch.broadcast_to(log_w.float(), r.shape)
    state = torch.zeros((B, H, Dk, Dv), dtype=torch.float32,
                        device=r.device)
    ys = []
    for t in range(S):
        y_t, state = decay_attention_decode_step(
            state, rf[:, t], kf[:, t], vf[:, t], lwf[:, t], u,
            decay_in_output=decay_in_output)
        ys.append(y_t)
    return torch.stack(ys, dim=1).to(v.dtype), state


def chunked_decay_attention(r, k, v, log_w, u=None, *, chunk: int = 64,
                            decay_in_output: bool = False,
                            initial_state=None):
    """Chunk-parallel form: O(S c Dk + S Dk Dv / c) work per step.

    Shapes as in :func:`naive_decay_attention`; log_w broadcastable over Dk
    (Mamba2 passes (B, S, H, 1)); ``initial_state`` (B, H, Dk, Dv) or None
    (zeros).  Returns ``(y, final state)``."""
    B, S, H, Dk = r.shape
    Dv = v.shape[-1]
    f32 = torch.float32
    c = min(chunk, S)
    pad = (-S) % c
    n = (S + pad) // c

    def to_chunks(x):                                   # (n, B, c, H, .)
        x = torch.nn.functional.pad(x.to(f32), (0, 0, 0, 0, 0, pad))
        return x.reshape(B, n, c, H, -1).transpose(0, 1)

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, log_w))
    lwc = torch.broadcast_to(lwc, rc.shape)
    cl = torch.cumsum(lwc, dim=2)                       # (n, B, c, H, Dk)
    # e_t: decay exponent applied to S_0 when reading at position t
    e = cl if decay_in_output else cl - lwc             # cl_{t-1}
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     0 if decay_in_output else -1)
    eye = torch.eye(c, dtype=f32, device=r.device)
    state = (torch.zeros((B, H, Dk, Dv), dtype=f32, device=r.device)
             if initial_state is None else initial_state.to(f32))
    ys = []
    for i in range(n):
        rcb, kcb, vcb, clb, eb = rc[i], kc[i], vc[i], cl[i], e[i]
        # inter-chunk: read S_0 with decay exp(e_t)
        y = torch.einsum("bthk,bhkv->bthv", rcb * torch.exp(eb), state)
        # intra-chunk: A[t,s] = sum_d r_t k_s exp(e_t - cl_s), s < t (or
        # s <= t); the exponent is clamped at 0 so the masked upper
        # triangle cannot give inf
        expo = torch.exp(torch.clamp(eb[:, :, None] - clb[:, None], max=0))
        A = torch.einsum("bthk,bshk,btshk->bhts", rcb, kcb, expo)
        A = torch.where(tri, A, torch.zeros_like(A))
        if not decay_in_output:
            rb = rcb * u.to(f32) if u is not None else rcb
            diag = torch.einsum("bthk,bthk->bht", rb, kcb)   # (B, H, c)
            A = A + diag[..., None] * eye
        y = y + torch.einsum("bhts,bshv->bthv", A, vcb)
        ys.append(y)
        # state update: S_end = diag(exp(cl_c)) S_0
        #                       + sum_s exp(cl_c - cl_s) k_s v_s^T
        clc = clb[:, -1]                                # (B, H, Dk)
        k_sc = kcb * torch.exp(clc[:, None] - clb)
        state = torch.exp(clc)[..., None] * state + torch.einsum(
            "bshk,bshv->bhkv", k_sc, vcb)
    y = torch.stack(ys, dim=1).reshape(B, n * c, H, Dv)[:, :S]
    return y.to(v.dtype), state


def decay_attention_decode_step(state, r, k, v, log_w, u=None,
                                decay_in_output=False):
    """Single-token decode.  state: (B, H, Dk, Dv) float32; r/k/log_w:
    (B, H, Dk); v: (B, H, Dv).  Returns ``(y (B, H, Dv) in v's dtype, new
    state)``."""
    f32 = torch.float32
    rt, kt, vt = r.to(f32), k.to(f32), v.to(f32)
    wt = torch.exp(torch.broadcast_to(log_w.to(f32), rt.shape))
    kv = kt[..., :, None] * vt[..., None, :]
    if decay_in_output:
        read = wt[..., None] * state + kv
    elif u is not None:
        read = state + u[None, :, :, None].to(f32) * kv
    else:
        read = state + kv
    y = torch.einsum("bhk,bhkv->bhv", rt, read)
    new_state = wt[..., None] * state + kv
    return y.to(v.dtype), new_state
