"""One-token GQA decode attention: the CUDA kernels and their plain versions.

Counterpart of ``repro/kernels/decode_attention.py``.  Both kernels live in
``csrc/decode_attention.cu`` (its header says what bounds them on the H100
and how the design answers that).  The public functions keep the JAX
layouts: ``q (B, H, D)``; contiguous ``k``/``v (B, S, Hkv, D)``; paged
pools ``(NB, bs, Hkv, D)`` with ``block_tables (B, MB)``.  The kernels read
those layouts in place.

Dispatch is by the device of ``q``: a CPU tensor runs the plain PyTorch
version, a CUDA tensor launches the kernel or raises, anything else
raises.  There is no fallback from the kernel to the plain version.  Each
wrapper counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -1.0e30
NO_WINDOW = 2 ** 30     # matches models.stacks.NO_WINDOW: never masks
MAX_GROUP, MAX_HEAD_DIM = 8, 128   # the kernel's register/shared sizing
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _lengths(lengths, B: int, device) -> torch.Tensor:
    """Scalar or (B,) live lengths -> contiguous (B,) int32 on ``device``."""
    t = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    return t.reshape(-1).expand(B).contiguous()


def _window(window) -> int:
    return NO_WINDOW if window is None else int(window)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the chip smoke's reference)
# ---------------------------------------------------------------------------
def decode_attention_plain(q, k, v, lengths, *, window=None):
    """Masked softmax attention of the single query at ``lengths[b] - 1``
    over positions ``pos < lengths[b]`` with ``lengths[b] - 1 - pos <
    window``, in float32; a row with nothing live gives zeros."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    L = _lengths(lengths, B, q.device).long()[:, None]
    pos = torch.arange(S, device=q.device)
    valid = ((pos < L) & (L - 1 - pos < _window(window)))[:, None, None, :]
    s = torch.einsum("bhgd,bshd->bhgs", q.float().reshape(B, Hkv, G, D),
                     k.float()) * D ** -0.5
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, H, D).to(q.dtype)


def gather_view(pool, block_tables, scale=None):
    """Per-row contiguous view ``(B, MB * bs, Hkv, D)`` of a paged pool,
    dequantized to float32 when ``scale`` (an int8 pool's ``(NB, bs)``
    scales) is given."""
    B, MB = block_tables.shape
    idx = block_tables.reshape(-1).long()
    g = pool.index_select(0, idx).reshape(B, MB * pool.shape[1],
                                          *pool.shape[2:])
    if scale is None:
        return g
    s = scale.index_select(0, idx).reshape(B, MB * pool.shape[1])
    return g.float() * s[..., None, None]


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, lengths,
                                 *, window=None, k_scale=None, v_scale=None):
    """:func:`decode_attention_plain` over the gathered (and, for int8,
    dequantized) view of the block pools."""
    return decode_attention_plain(
        q, gather_view(k_pool, block_tables, k_scale),
        gather_view(v_pool, block_tables, v_scale), lengths, window=window)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
def _check_cuda(q, named: dict) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"decode attention takes CPU or CUDA tensors, "
                         f"not {q.device.type}")
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype} not in (float32, bfloat16)")


def _check_heads(H: int, Hkv: int, D: int) -> None:
    if H % Hkv or H // Hkv > MAX_GROUP or D > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes H % Hkv == 0, H/Hkv <= {MAX_GROUP}, "
                         f"D <= {MAX_HEAD_DIM}; got H={H} Hkv={Hkv} D={D}")


def decode_attention(q, k, v, lengths, *, window=None):
    """q: (B,H,D); k/v: (B,S,Hkv,D) slot stripes; lengths: scalar or (B,)
    live prefix per row; window: optional sliding window.  Returns
    (B,H,D) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, window=window)
    B, H, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D \
            or v.shape != k.shape:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    S, Hkv = k.shape[1], k.shape[2]
    lens = _lengths(lengths, B, q.device)
    _check_cuda(q, {"q": q, "k": k, "v": v, "lengths": lens})
    _check_heads(H, Hkv, D)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k/v dtype {k.dtype}/{v.dtype} != q dtype {q.dtype}")
    out = torch.empty_like(q)
    lib = _build.load("decode_attention")
    err = lib.decode_attention_contiguous(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), B, H, Hkv, D, S, _window(window), D ** -0.5,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", err, "decode_attention launch")
    decode_attention.launches += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           window=None, k_scale=None, v_scale=None):
    """Block-table GQA decode over a shared paged pool.

    q: (B,H,D); k_pool/v_pool: (NB,bs,Hkv,D) (entry 0 = null block);
    block_tables: (B,MB) int32 physical block ids; lengths: (B,).  Row b
    attends over logical positions ``[0, lengths[b])`` of
    ``concat(pool[tables[b]])``.  With ``k_scale``/``v_scale`` ((NB,bs)
    float32) the pools are int8 and each position is multiplied by its
    scale after the load.  Returns (B,H,D) in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, block_tables, lengths, window=window,
            k_scale=k_scale, v_scale=v_scale)
    B, H, D = q.shape
    if k_pool.dim() != 4 or k_pool.shape[3] != D \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)}")
    NB, bs, Hkv = k_pool.shape[:3]
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.dtype != torch.int32:
        raise ValueError("block_tables must be (B, MB) int32")
    lens = _lengths(lengths, B, q.device)
    named = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
             "block_tables": block_tables, "lengths": lens}
    quant = k_pool.dtype == torch.int8
    if quant:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 pools need k_scale and v_scale")
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if s.shape != (NB, bs) or s.dtype != torch.float32:
                raise ValueError(f"{name} must be ({NB}, {bs}) float32")
            named[name] = s
    elif k_scale is not None or v_scale is not None:
        raise ValueError("scales are for int8 pools only")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pool dtype {k_pool.dtype} != q dtype {q.dtype}")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError("k_pool and v_pool dtypes differ")
    _check_cuda(q, named)
    _check_heads(H, Hkv, D)
    out = torch.empty_like(q)
    lib = _build.load("decode_attention")
    err = lib.decode_attention_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, H, Hkv, D, bs, block_tables.shape[1], _window(window),
        D ** -0.5, _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", err, "paged_decode_attention launch")
    paged_decode_attention.launches += 1
    return out


decode_attention.launches = 0
paged_decode_attention.launches = 0
