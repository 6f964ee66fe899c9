"""The work of one call of each kernel, and the meta case every wrapper
shares.

The formulas here give a call's operations (by the input type whose peak
rate they run at) and its bytes (each input read once, each output written
once) from its shapes.  ``chip_smoke.py`` divides them by the card's rates
for each kernel's bound, and the cost walk (``launch/cost.py``) adds them to
a step's count when a wrapper meets a ``meta`` tensor: both read one
formula.

On a ``meta`` tensor (plain, or a ``DTensor`` over meta shards: the
dry-run's) a wrapper validates its arguments as on CUDA, then calls its
meta case, which computes nothing: it redistributes a ``DTensor`` whose
placement shards a dimension the kernel reduces over to ``Replicate`` on
that mesh dimension (as XLA's partitioner inserts an all-gather), works on
the local shards, returns empty outputs of the right shapes and dtypes
(wrapped back with ``DTensor.from_local`` in the placements of the input
they follow), and records the local shards' work and one launch in the
active walk (:func:`walking`).  Outside a walk it records nothing.  The
wrappers' ``launches`` counters count real launches only.  A kernel
Function's plain backward meeting ``DTensor``\\ s runs on plain meta
tensors of the local shards' shapes (walked, so counted) and returns
zeros in the inputs' placements (:func:`zero_grads`).
"""
from __future__ import annotations

import contextlib
import threading

SCAN_CHUNK = 64          # the scan kernels' positions per chunk
_walk = threading.local()   # .sink: the active walk's costs


# ---------------------------------------------------------------------------
# Work formulas
# ---------------------------------------------------------------------------
def causal_pairs(S: int, window=None) -> int:
    """(query, key) pairs a causal attention over S positions scores: key j
    visible from query i when j <= i and i - j < window."""
    w = S if window is None else min(int(window), S)
    return w * (w + 1) // 2 + (S - w) * w


def flash_attention_work(B, S, H, Hkv, D, Dv, *, causal=True, window=None,
                         elem=2, q_rows=None) -> tuple[dict, int]:
    """``({"bfloat16" or "float32": ops}, bytes)`` of one flash forward:
    2 (D + Dv) operations a visible (query, key) pair and head (the scores
    and the value sum), q, k, v and the output read or written once at
    ``elem`` bytes, the float32 log-sum-exp written once.  ``q_rows``
    (default S) is the number of query rows this call computes when they
    are a slice of the S (a sequence-sharded query): the pairs scale by
    ``q_rows / S``."""
    pairs = causal_pairs(S, window) if causal else S * S
    q_rows = S if q_rows is None else q_rows
    pairs = pairs * q_rows // S
    n_bytes = (B * q_rows * H * D + B * S * Hkv * (D + Dv)
               + B * q_rows * H * Dv) * elem + B * H * q_rows * 4
    dtype = "bfloat16" if elem == 2 else "float32"
    return {dtype: 2 * B * H * (D + Dv) * pairs}, n_bytes


def decode_attention_work(B, H, Hkv, D, live, *, q_elem=2, kv_elem=2,
                          quantized=False, table_entries=0
                          ) -> tuple[dict, int]:
    """``({"bfloat16": ops}, bytes)`` of one decode attention call over
    ``live`` (row, position) pairs in all: 4 H D operations a live
    position (scores and value sum), each live K and V position read once
    at ``kv_elem`` bytes (int8 pools also their float32 scales), q read
    and the output written at ``q_elem``, the lengths, and a paged call's
    ``table_entries`` non-null int32 table entries."""
    n_bytes = (live * Hkv * D * 2 * kv_elem + (live * 4 * 2 if quantized
                                               else 0)
               + 2 * B * H * D * q_elem + B * 4 + table_entries * 4)
    return {"bfloat16": 4 * H * D * live}, n_bytes


def greedy_sample_work(B, V) -> tuple[dict, int]:
    """``({"float32": ops}, bytes)``: 3 operations an entry (the max, the
    exponential and the sum), the float32 logits read once and a token and
    a log-probability written a row."""
    return {"float32": 3 * B * V}, B * V * 4 + B * 8


def topk_work(B, V, k, *, with_mask=False) -> tuple[dict, int]:
    """``({}, bytes)``: the logits read once, the k values (and the
    ``(B, V)`` mask) written once; the selection's compares are not
    counted."""
    return {}, B * V * 4 + (B * V * 4 if with_mask else B * k * 4)


def scan_ops(B, S, H, Dk, Dv, c=SCAN_CHUNK):
    """Operations of the chunked scan as the earlier one-chunk-at-a-time
    kernel counted them, per chunk of the run's length: the
    intra-chunk weights (4 per (t, s < t, d) term: difference,
    exponential, two products), the u diagonal, the decayed read of the
    state, A v over s <= t, and the state update.  Kept beside
    :func:`wkv_ops` so shares stated against it stay comparable."""
    n = 0
    for c0 in range(0, S, c):
        m = min(c, S - c0)
        n += (4 * Dk * m * (m - 1) // 2 + 3 * Dk * m + 2 * m * Dk * Dv
              + 2 * Dv * m * (m + 1) // 2 + 2 * m * Dk * Dv)
    return n * B * H


def wkv_ops(B, S, H, Dk, Dv, dtype, c=SCAN_CHUNK, sub=16):
    """Operations of the chunk-parallel scan at the rates the kernel runs
    them, counted per chunk of the run's length.  On the tensor cores, at
    the tf32 rate, each product as often as it is issued (3xTF32: three
    tf32 products, two against bf16 v): K~^T V in every chunk, (r exp(e))
    S_in in every chunk after the first, R~ K~^T over the (t, s) pairs of
    different 16-row sub-blocks, A V over s <= t.  On the CUDA cores, at
    the float32 rate: the diagonal sub-blocks (4 per (t, s < t, d) term)
    and the u diagonal, the decayed factors (r exp(e), k exp(cl_last - cl),
    and R~ and K~ for each sub-block pair), the state passing."""
    n_v = 2 if dtype == "bfloat16" else 3
    tc = f32 = 0
    for i, c0 in enumerate(range(0, S, c)):
        m = min(c, S - c0)
        rows = [min(sub, m - b0) for b0 in range(0, m, sub)]
        diag = sum(n * (n - 1) // 2 for n in rows)
        below = m * (m - 1) // 2 - diag
        tc += 2 * m * Dk * Dv * n_v
        tc += 2 * m * Dk * Dv * 3 * (1 if i else 0)
        tc += 2 * Dk * below * 3
        tc += 2 * Dv * (below + diag + m) * n_v
        f32 += 4 * Dk * diag + 3 * Dk * m + 5 * m * Dk
        f32 += 3 * Dk * sum(rows[i] + rows[j] for i in range(len(rows))
                            for j in range(i))
        f32 += 2 * Dk * Dv
    return {"tfloat32": tc * B * H, "float32": f32 * B * H}


def rwkv6_scan_work(B, S, H, Dk, Dv, dtype, *, rkv_elem=2
                    ) -> tuple[dict, int]:
    """``(wkv_ops, bytes)`` of one rwkv6 scan: r, k, v at ``rkv_elem``
    bytes, log_w and u float32 read once, y written at ``rkv_elem``, the
    float32 final state written once."""
    n_bytes = (B * S * H * (2 * Dk + Dv) * rkv_elem + B * S * H * Dk * 4
               + H * Dk * 4 + B * S * H * Dv * rkv_elem + B * H * Dk * Dv * 4)
    return wkv_ops(B, S, H, Dk, Dv, dtype), n_bytes


def mamba2_ops(B, S, H, N, hd, rk_dtype, v_dtype="float32", shared=True,
               c=SCAN_CHUNK):
    """Operations of the chunked SSD scan at the rates the kernel runs
    them, counted per chunk of the run's length.  On the tensor cores, at
    the bf16 rate, each product as often as it is issued: an operand in bf16
    parts (1 for bf16, 3 for float32, exact) times another costs one
    product per pair of parts i + j <= 2; R K^T over s <= t once per (b,
    chunk) when r and k are broadcasts over the heads (else per head),
    (G o L) V over s <= t (G o L in 3 parts), K^T (dk V) in every chunk
    and R S_in in every chunk after the first (dk V and S_in in 3 parts).
    On the CUDA cores, at the float32 rate: the decay weights (an
    exponential and a product per s <= t), the scalings by exp(cl_t) and
    dk_s, the state passing."""
    def pairs_of(pa, pb):
        return sum(i + j <= 2 for i in range(pa) for j in range(pb))
    p_rk = 1 if rk_dtype == "bfloat16" else 3
    p_v = 1 if v_dtype == "bfloat16" else 3
    tc = f32 = 0
    for i, c0 in enumerate(range(0, S, c)):
        m = min(c, S - c0)
        pairs = m * (m + 1) // 2
        tc += 2 * N * pairs * pairs_of(p_rk, p_rk) * (1 if shared else H)
        tc += H * (2 * hd * pairs * pairs_of(3, p_v) + 2 * m * N * hd
                   * pairs_of(p_rk, 3) * (2 if i else 1))
        f32 += H * (2 * pairs + 2 * m * hd + 2 * N * hd)
    return {"bfloat16": tc * B, "float32": f32 * B}


def mamba2_scan_work(B, S, H, N, hd, rk_dtype, v_dtype, *, shared=True
                     ) -> tuple[dict, int]:
    """``(mamba2_ops, bytes)`` of one SSD scan: r and k read once (one
    ``(B, S, 1, N)`` slice each when ``shared``, a broadcast over the
    heads), v and the float32 log_w read once, y written in v's dtype, the
    float32 final state written once."""
    rk = 2 if rk_dtype == "bfloat16" else 4
    ve = 2 if v_dtype == "bfloat16" else 4
    n_bytes = (2 * B * S * (1 if shared else H) * N * rk
               + B * S * H * hd * ve + B * S * H * 4 + B * S * H * hd * ve
               + B * H * N * hd * 4)
    return mamba2_ops(B, S, H, N, hd, rk_dtype, v_dtype, shared), n_bytes


# ---------------------------------------------------------------------------
# The meta case
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def walking(sink):
    """Send this thread's kernel records to ``sink`` (an object with
    ``add_kernel(name, ops, n_bytes)``) for the duration."""
    prev = getattr(_walk, "sink", None)
    _walk.sink = sink
    try:
        yield sink
    finally:
        _walk.sink = prev


@contextlib.contextmanager
def scope(name: str):
    """Label what the walk counts inside with ``name`` too (the plain
    backward of a kernel's autograd function, say)."""
    stack = getattr(_walk, "scopes", ())
    _walk.scopes = stack + (name,)
    try:
        yield
    finally:
        _walk.scopes = stack


def scopes() -> tuple:
    """This thread's open :func:`scope` labels, outermost first."""
    return getattr(_walk, "scopes", ())


def record(name: str, ops: dict, n_bytes: int) -> None:
    """One launch of kernel ``name`` with its work, into the active walk."""
    sink = getattr(_walk, "sink", None)
    if sink is not None:
        sink.add_kernel(name, ops, n_bytes)


def is_dtensor(t) -> bool:
    """``t`` is a ``DTensor`` (the dry-run's sharded meta tensors), told
    by its type's name so that plain calls import nothing of
    ``torch.distributed``."""
    return type(t).__name__ == "DTensor"


def empty(*shape, dtype):
    """An empty meta tensor: a local shard's stand-in in a backward's
    meta case."""
    import torch
    return torch.empty(shape, dtype=dtype, device="meta")


def zero_grads(saved, needs) -> tuple:
    """The meta case of a kernel Function's backward returns zeros in each
    input's own placements (its plain backward having been walked on the
    local shards' shapes): nothing is computed on meta, and the walk
    counts the local work, not DTensor's redistributions of a plain
    recompute that splits heads across ranks."""
    import torch
    return tuple(torch.zeros_like(t) if n and t is not None else None
                 for t, n in zip(saved, needs))


def gather_dims(t, dims):
    """``t`` with every mesh dimension that shards one of the tensor
    dimensions ``dims`` redistributed to ``Replicate`` (the all-gather a
    partitioner inserts before a reduction over them); a plain tensor or
    ``None`` as it is."""
    if t is None or not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    dims = {d % t.dim() for d in dims}
    place = [Replicate() if (isinstance(p, Shard) and p.dim in dims)
             or p.is_partial() else p for p in t.placements]
    if list(place) == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, place)


def local(t):
    """The local shard of a ``DTensor``, a plain tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def wrap_like(out, like, dim_map: dict):
    """``out`` (a local meta tensor) as a ``DTensor`` in ``like``'s mesh,
    sharded where ``like`` shards a dimension that ``dim_map`` carries
    (``like``'s dim -> ``out``'s dim); replicated elsewhere.  ``out`` as it
    is when ``like`` is a plain tensor."""
    if not is_dtensor(like):
        return out
    from torch.distributed.tensor import DTensor, Replicate, Shard
    place = []
    for p in like.placements:
        if isinstance(p, Shard) and p.dim in dim_map:
            place.append(Shard(dim_map[p.dim]))
        elif isinstance(p, Shard):
            raise ValueError(f"a placement {p} of the input has no "
                             f"counterpart in the output")
        else:
            place.append(Replicate())
    return DTensor.from_local(out, like.device_mesh, place, run_check=False)


def elem_name(dtype) -> str:
    """``"bfloat16"`` or ``"float32"`` for a torch dtype."""
    import torch
    return "bfloat16" if dtype == torch.bfloat16 else "float32"
