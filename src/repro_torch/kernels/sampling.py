"""Sampling epilogues: greedy sampling and top-k, CUDA kernels and their
plain versions.

Counterpart of ``repro/kernels/sampling.py``.

* ``greedy_sample(logits)`` (kernel ``csrc/greedy_sample.cu``) returns the
  first-occurrence argmax token of each row and its log-probability
  ``log_softmax(logits)[token] = -log(sum exp(x - max))``.
* ``topk_values(logits, k)`` (kernel ``csrc/topk.cu``) returns the k
  largest values of each row, descending, as a multiset;
  ``topk_mask(logits, k)`` keeps every entry ``>=`` the k-th value (ties at
  the threshold all survive) and sets the rest to ``NEG_INF``.  No entry
  point calls them: the JAX engine samples the whole vocabulary, and so
  does the port's.

A CPU tensor runs the plain version, a CUDA tensor launches the kernel or
raises, a ``meta`` tensor (the cost walk's) is validated as a CUDA one and
takes the meta case (``kernels.work``), which computes nothing.  Each
wrapper's ``launches`` counts its kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, work

NEG_INF = -1.0e30
MAX_TOPK = 1024         # the kernel's shared-memory sizing
TOPK_CLUSTER = 8        # CTAs per row: one thread-block cluster
GREEDY_MAX_CLUSTER = 16     # CTAs per row of the greedy kernel, at most
GREEDY_ROWS = 16            # row counts up to this share one cluster size
SMS = 132                   # the H100's streaming multiprocessors


def greedy_cluster(B: int) -> int:
    """CTAs per row of the greedy kernel's cluster: the largest power of
    two up to 16 that keeps ``max(B, GREEDY_ROWS) * cluster`` within the
    card's SMs, at least 1.  Every row count up to GREEDY_ROWS takes the
    same cluster (8), so that a row's log-sum-exp sums its slices in one
    order at every slot count up to 16, as the decode step's rows round
    (``stacks_infer.DECODE_ROWS``): a 16-slot engine's logprobs are then
    an 8-slot one's bit for bit."""
    c = GREEDY_MAX_CLUSTER
    while c > 1 and max(B, GREEDY_ROWS) * c > SMS:
        c //= 2
    return c


def greedy_slice(V: int, cluster: int) -> int:
    """Entries of a row each CTA of the greedy kernel's cluster reduces: a
    multiple of 4 (16-byte loads); the last slices may be shorter or
    empty."""
    return (-(-V // cluster) + 3) // 4 * 4


def topk_slice(V: int) -> int:
    """Entries of a row each CTA of the top-k kernel's cluster holds: a
    multiple of 4 (16-byte loads); the last slice may be shorter."""
    return (-(-V // TOPK_CLUSTER) + 3) // 4 * 4


def greedy_sample_plain(logits):
    """``argmax`` (first occurrence) plus the ``log_softmax`` at it."""
    x = logits.float()
    tokens = torch.argmax(x, dim=-1)
    logp = torch.log_softmax(x, dim=-1).gather(-1, tokens[:, None])[:, 0]
    return tokens.to(torch.int32), logp


def greedy_sample(logits):
    """logits: (B, V) float32 -> (tokens (B,) int32, logprobs (B,) f32).

    On the card each row is split over a cluster of
    :func:`greedy_cluster` CTAs."""
    if logits.device.type == "cpu":
        return greedy_sample_plain(logits)
    if logits.device.type == "meta":
        _check_logits(logits, "greedy_sample")
        x = work.gather_dims(logits, (1,))
        B, V = work.local(x).shape
        work.record("greedy_sample", *work.greedy_sample_work(B, V))
        return tuple(work.wrap_like(torch.empty((B,), dtype=dt,
                                                device="meta"), x, {0: 0})
                     for dt in (torch.int32, torch.float32))
    out = _greedy_launch(logits, greedy_cluster(logits.shape[0]))
    _build.count(greedy_sample)
    return out


def _greedy_launch(logits, cluster: int):
    """One launch of the greedy kernel with ``cluster`` CTAs per row."""
    _check_logits(logits, "greedy_sample")
    B, V = logits.shape
    tokens = torch.empty((B,), dtype=torch.int32, device=logits.device)
    logprobs = torch.empty((B,), dtype=torch.float32, device=logits.device)
    lib = _build.load("greedy_sample")
    err = lib.greedy_sample_launch(
        logits.data_ptr(), tokens.data_ptr(), logprobs.data_ptr(), B, V,
        cluster, greedy_slice(V, cluster),
        torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check("greedy_sample", err, "greedy_sample launch")
    return tokens, logprobs


greedy_sample.launches = 0


def _check_logits(logits, what: str) -> None:
    """The kernels' checks of the logits: a CUDA (or meta) contiguous
    ``(B, V)`` float32 tensor."""
    if logits.device.type not in ("cuda", "meta"):
        raise ValueError(f"{what} takes CPU or CUDA tensors, not "
                         f"{logits.device.type}")
    if logits.dim() != 2 or logits.dtype != torch.float32 \
            or not logits.is_contiguous():
        raise ValueError("logits must be contiguous (B, V) float32")


def topk_values_plain(logits, k: int):
    """The k largest values per row, descending (``torch.sort``)."""
    _check_k(logits, k)
    return torch.sort(logits.float(), dim=-1, descending=True)[0][:, :k]


def topk_mask_plain(logits, k: int):
    """Entries below the k-th largest of their row become ``NEG_INF``."""
    thresh = topk_values_plain(logits, k)[:, k - 1]
    x = logits.float()
    return torch.where(x >= thresh[:, None], x, torch.full_like(x, NEG_INF))


def _check_k(logits, k: int) -> None:
    if logits.dim() != 2:
        raise ValueError(f"logits {tuple(logits.shape)}: want (B, V)")
    if not 0 < k <= logits.shape[1]:
        raise ValueError(f"k={k} out of range for vocab {logits.shape[1]}")


def _topk_launch(logits, k: int, with_mask: bool):
    """One launch of the top-k kernel: ``(values (B, k), mask (B, V) or
    None)``."""
    _check_k(logits, k)
    _check_logits(logits, "topk")
    if k > MAX_TOPK:
        raise ValueError(f"the kernel takes k up to {MAX_TOPK}; got {k}")
    B, V = logits.shape
    if logits.device.type == "meta":
        x = work.gather_dims(logits, (1,))
        B, V = work.local(x).shape
        work.record("topk_mask" if with_mask else "topk_values",
                    *work.topk_work(B, V, k, with_mask=with_mask))
        top = work.wrap_like(torch.empty((B, k), dtype=torch.float32,
                                         device="meta"), x, {0: 0})
        mask = (work.wrap_like(torch.empty((B, V), dtype=torch.float32,
                                           device="meta"), x, {0: 0})
                if with_mask else None)
        return top, mask
    top = torch.empty((B, k), dtype=torch.float32, device=logits.device)
    mask = (torch.empty((B, V), dtype=torch.float32, device=logits.device)
            if with_mask else None)
    lib = _build.load("topk")
    err = lib.topk_launch(
        logits.data_ptr(), top.data_ptr(),
        mask.data_ptr() if with_mask else None, B, V, k,
        torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check("topk", err, "topk launch")
    return top, mask


def topk_values(logits, k: int):
    """logits: (B, V) float32 -> (B, k) largest values per row,
    descending; a value that occurs m times fills up to m places."""
    if logits.device.type == "cpu":
        return topk_values_plain(logits, k)
    top, _ = _topk_launch(logits, k, with_mask=False)
    if logits.device.type == "cuda":        # not the meta case
        _build.count(topk_values)
    return top


def topk_mask(logits, k: int):
    """logits: (B, V) float32 -> (B, V) float32 with every entry below the
    row's k-th largest value set to ``NEG_INF``; ties at the threshold all
    survive, so a row may keep more than k entries.  On the card one
    kernel launch computes the threshold and writes the mask."""
    if logits.device.type == "cpu":
        return topk_mask_plain(logits, k)
    _, mask = _topk_launch(logits, k, with_mask=True)
    if logits.device.type == "cuda":        # not the meta case
        _build.count(topk_mask)
    return mask


topk_values.launches = 0
topk_mask.launches = 0
