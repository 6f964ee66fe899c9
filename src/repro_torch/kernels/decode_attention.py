"""One-token GQA decode attention: the CUDA kernels and their plain versions.

Counterpart of ``repro/kernels/decode_attention.py``.  Both kernels live in
``csrc/decode_attention.cu`` (its header says what bounds them on the H100
and how the design answers that).  The public functions keep the JAX
layouts: ``q (B, H, D)``; contiguous ``k``/``v (B, S, Hkv, D)``; paged
pools ``(NB, bs, Hkv, D)`` with ``block_tables (B, MB)``.  The kernels read
those layouts in place.

Dispatch is by the device of ``q``: a CPU tensor runs the plain PyTorch
version, a CUDA tensor launches the kernel or raises, a ``meta`` tensor
(the cost walk's) is validated as a CUDA one and takes the meta case
(``kernels.work``), which computes nothing, and anything else raises.
There is no fallback from the kernel to the plain version.  Each
wrapper counts its calls that launch the kernels in ``<wrapper>.launches``
(one per call: the split pass and the merge).

The kernels split each row's positions into ``n_split`` chunks of
``chunk`` (:func:`split_plan`, from shapes only), write per-split partials
and merge them; :func:`decode_attention_partials_plain` and
:func:`merge_partials_plain` are the plain versions of the two passes,
which the tests hold to the unsplit plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, work

NEG_INF = -1.0e30
NO_WINDOW = 2 ** 30     # matches models.stacks.NO_WINDOW: never masks
MAX_GROUP, MAX_HEAD_DIM = 8, 256   # the kernel's register/shared sizing
WIDE_HEAD_DIM, WIDE_MAX_GROUP = 128, 2   # above this D, G <= 2 only
SPLIT_CHUNK, MAX_SPLITS = 128, 64  # positions per CTA; splits per row
LOG2E = 1.4426950408889634
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _lengths(lengths, B: int, device) -> torch.Tensor:
    """Scalar or (B,) live lengths -> contiguous (B,) int32 on ``device``;
    a tensor that already is one is returned as it is (the engine's case:
    no copy, no launch)."""
    if isinstance(lengths, torch.Tensor) and lengths.dtype == torch.int32 \
            and lengths.shape == (B,) and lengths.device == device \
            and lengths.is_contiguous():
        return lengths
    t = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    return t.reshape(-1).expand(B).contiguous()


def split_plan(seq_len: int) -> tuple[int, int]:
    """``(chunk, n_split)`` for rows of ``seq_len`` positions (the stripe
    length S, or MB * bs of a paged table): each (row, KV head) gets
    ``n_split`` CTAs of ``chunk`` positions, ``chunk`` a multiple of
    SPLIT_CHUNK grown past it only to keep ``n_split <= MAX_SPLITS``.  A
    function of the shape alone: the live lengths are device data, and
    reading them would cost a host sync per layer."""
    chunk = SPLIT_CHUNK * max(1, -(-seq_len // (SPLIT_CHUNK * MAX_SPLITS)))
    return chunk, max(1, -(-seq_len // chunk))


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


def decode_attention_partials_plain(q, k, v, lengths, chunk, n_split, *,
                                    window=None):
    """What the split pass writes, per query head and split s over
    positions ``[s * chunk, (s + 1) * chunk)``: ``m (B, H, n_split)`` the
    largest live score in base 2 (scores times log2 e), ``l`` the sum of
    ``exp2(score - m)`` and ``acc (B, H, n_split, D)`` the same weights
    times V, all float32.  A split with nothing live has ``l = 0`` (and
    ``m = NEG_INF``, ``acc = 0``)."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G, P = H // Hkv, chunk * n_split
    if P < S:
        raise ValueError(f"{n_split} splits of {chunk} do not cover S={S}")
    L = _lengths(lengths, B, q.device).long()[:, None]
    pos = torch.arange(P, device=q.device)
    valid = (pos < L) & (L - 1 - pos < _window(window)) & (pos < S)
    valid = valid.reshape(B, 1, 1, n_split, chunk)
    pad = (0, 0, 0, 0, 0, P - S)
    kf = torch.nn.functional.pad(k.float(), pad).reshape(B, n_split, chunk,
                                                          Hkv, D)
    vf = torch.nn.functional.pad(v.float(), pad).reshape(B, n_split, chunk,
                                                          Hkv, D)
    s = torch.einsum("bhgd,bnchd->bhgnc", q.float().reshape(B, Hkv, G, D),
                     kf) * (D ** -0.5 * LOG2E)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    p = torch.where(valid, torch.exp2(s - m[..., None]), torch.zeros_like(s))
    acc = torch.einsum("bhgnc,bnchd->bhgnd", p, vf)
    return (m.reshape(B, H, n_split), p.sum(-1).reshape(B, H, n_split),
            acc.reshape(B, H, n_split, D))


def merge_partials_plain(m, l, acc, dtype=torch.float32):
    """What the merge pass computes from the partials of
    :func:`decode_attention_partials_plain`: split i weighed by
    ``exp2(m_i - M)`` (M the largest m of a live split), splits with
    ``l = 0`` skipped, divided by the weighed sum of l; a head with no
    live split gives zeros.  Returns ``(B, H, D)`` in ``dtype``."""
    live = l > 0
    M = torch.where(live, m, torch.full_like(m, NEG_INF)).amax(
        -1, keepdim=True)
    w = torch.where(live, torch.exp2(m - M), torch.zeros_like(m))
    total = (w * l).sum(-1, keepdim=True)
    a = (w[..., None] * torch.where(live[..., None], acc,
                                    torch.zeros_like(acc))).sum(-2)
    out = torch.where(total > 0, a / total.clamp_min(1e-30),
                      torch.zeros_like(a))
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
def _check_cuda(q, named: dict) -> None:
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode attention takes CPU or CUDA tensors, "
                         f"not {q.device.type}")
    for name, t in named.items():
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype} not in (float32, bfloat16)")


def _workspace(q, n_split: int):
    """The float32 partials ``m | l | acc`` of ``n_split`` splits."""
    B, H, D = q.shape
    return torch.empty(B * H * n_split * (D + 2), dtype=torch.float32,
                       device=q.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_heads(H: int, Hkv: int, D: int) -> None:
    """The kernel's instances: D up to WIDE_HEAD_DIM at G up to MAX_GROUP,
    D up to MAX_HEAD_DIM (gemma3-4b's 256) at G up to WIDE_MAX_GROUP."""
    g_max = MAX_GROUP if D <= WIDE_HEAD_DIM else WIDE_MAX_GROUP
    if H % Hkv or H // Hkv > g_max or D > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes H % Hkv == 0, H/Hkv <= {MAX_GROUP} "
                         f"at D <= {WIDE_HEAD_DIM} and <= {WIDE_MAX_GROUP} "
                         f"at D <= {MAX_HEAD_DIM}; got H={H} Hkv={Hkv} "
                         f"D={D}")


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
    if q.device.type == "meta":
        return _decode_meta("decode_attention", q, (k, v), S, window)
    lib = _build.load("decode_attention")
    chunk, n_split = split_plan(S)
    out, partials = torch.empty_like(q), _workspace(q, n_split)
    err = lib.decode_attention_contiguous(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        out.data_ptr(), partials.data_ptr(), B, H, Hkv, D, S,
        _window(window), chunk, n_split, D ** -0.5, _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[k.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", err, "decode_attention launch")
    _build.count(decode_attention)
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
    MB = block_tables.shape[1]
    if q.device.type == "meta":
        return _decode_meta("paged_decode_attention", q, (k_pool, v_pool),
                            MB * bs, window, tables=block_tables,
                            quantized=quant)
    lib = _build.load("decode_attention")
    chunk, n_split = split_plan(MB * bs)
    out, partials = torch.empty_like(q), _workspace(q, n_split)
    err = lib.decode_attention_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        _ptr(k_scale), _ptr(v_scale), block_tables.data_ptr(),
        lens.data_ptr(), out.data_ptr(), partials.data_ptr(), B, H, Hkv, D,
        bs, MB, _window(window), chunk, n_split, D ** -0.5,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("decode_attention", err, "paged_decode_attention launch")
    _build.count(paged_decode_attention)
    return out


decode_attention.launches = 0
paged_decode_attention.launches = 0


def _decode_meta(name, q, kv, S, window, *, tables=None, quantized=False):
    """The meta case of either wrapper: K/V (stripes or pools) gathered
    over every dimension but a stripe's batch and heads, q over its head
    dim; the output in q's placements; the work of every row attending
    over ``min(S, window)`` positions (the data's lengths are not known
    on meta: the stripe or table length is what a full cache reads)."""
    q = work.gather_dims(q, (2,))
    paged = tables is not None
    kl = work.local(work.gather_dims(kv[0], (0, 1, 3) if paged else (1, 3)))
    work.local(work.gather_dims(kv[1], (0, 1, 3) if paged else (1, 3)))
    tables = work.local(work.gather_dims(tables, (1,)))
    ql = work.local(q)
    B, H, D = ql.shape
    live = B * (S if window is None else min(S, int(window)))
    ops, n_bytes = work.decode_attention_work(
        B, H, kl.shape[2], D, live, q_elem=q.element_size(),
        kv_elem=kl.element_size(), quantized=quantized,
        table_entries=0 if tables is None else tables.numel())
    work.record(name, ops, n_bytes)
    return work.wrap_like(torch.empty(ql.shape, dtype=q.dtype,
                                      device="meta"), q, {0: 0, 1: 1})
