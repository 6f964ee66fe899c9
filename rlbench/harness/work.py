"""The yardstick of the kernels and the whole step: the H100's published
peaks, each kernel's operations and bytes from its shapes, and a step's
model FLOPs.

Frozen copies of the program's ``kernels/work.py`` (``causal_pairs``,
``flash_attention_work``) and ``launch/roofline.py`` (the peaks,
``model_flops_for``'s 6 N per trained and 2 N per forward token), so that
a change to the program cannot change how its work is counted.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 datasheet, dense (no sparsity), at the 700 W limit
PEAK = {"bfloat16": 989e12, "tfloat32": 495e12, "float32": 67e12}
HBM_BPS = 3.35e12


def bound_s(ops: dict, n_bytes: int) -> float:
    """The least time of a call: the larger of its operations at the peak
    rate of their input type (parts at different rates add up) and its
    bytes at the memory rate."""
    return max(sum(n / PEAK[t] for t, n in ops.items()), n_bytes / HBM_BPS)


def causal_pairs(S: int, window=None) -> int:
    """(query, key) pairs a causal attention over S positions scores."""
    w = S if window is None else min(int(window), S)
    return w * (w + 1) // 2 + (S - w) * w


def flash_attention_work(B, S, H, Hkv, D, Dv, *, causal=True, window=None,
                         elem=2):
    """``({dtype: ops}, bytes)`` of one flash forward: 2 (D + Dv)
    operations a visible pair and head; q, k, v and the output at ``elem``
    bytes once each, the float32 log-sum-exp written once."""
    pairs = causal_pairs(S, window) if causal else S * S
    n_bytes = (B * S * H * D + B * S * Hkv * (D + Dv) + B * S * H * Dv) \
        * elem + B * H * S * 4
    dtype = "bfloat16" if elem == 2 else "float32"
    return {dtype: 2 * B * H * (D + Dv) * pairs}, n_bytes


def grpo_model_flops(n_params: int, trained: int, forward_tokens: int):
    """Model FLOPs of GRPO work: 6 N per trained position (forward and
    backward, recomputation not counted) and 2 N per prefilled or
    generated token."""
    return 6.0 * n_params * trained + 2.0 * n_params * forward_tokens
