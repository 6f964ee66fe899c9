"""Fused greedy sampling epilogue: the CUDA kernel and its plain version.

Counterpart of ``repro/kernels/sampling.py`` ``greedy_sample``; the kernel
is ``csrc/greedy_sample.cu``.  ``greedy_sample(logits)`` returns the
first-occurrence argmax token of each row and its log-probability
``log_softmax(logits)[token] = -log(sum exp(x - max))``.

A CPU tensor runs the plain version, a CUDA tensor launches the kernel or
raises.  ``greedy_sample.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def greedy_sample_plain(logits):
    """``argmax`` (first occurrence) plus the ``log_softmax`` at it."""
    x = logits.float()
    tokens = torch.argmax(x, dim=-1)
    logp = torch.log_softmax(x, dim=-1).gather(-1, tokens[:, None])[:, 0]
    return tokens.to(torch.int32), logp


def greedy_sample(logits):
    """logits: (B, V) float32 -> (tokens (B,) int32, logprobs (B,) f32)."""
    if logits.device.type == "cpu":
        return greedy_sample_plain(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"greedy_sample takes CPU or CUDA tensors, not "
                         f"{logits.device.type}")
    if logits.dim() != 2 or logits.dtype != torch.float32 \
            or not logits.is_contiguous():
        raise ValueError("logits must be contiguous (B, V) float32")
    B, V = logits.shape
    tokens = torch.empty((B,), dtype=torch.int32, device=logits.device)
    logprobs = torch.empty((B,), dtype=torch.float32, device=logits.device)
    lib = _build.load("greedy_sample")
    err = lib.greedy_sample_launch(
        logits.data_ptr(), tokens.data_ptr(), logprobs.data_ptr(), B, V,
        torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check("greedy_sample", err, "greedy_sample launch")
    greedy_sample.launches += 1
    return tokens, logprobs


greedy_sample.launches = 0
