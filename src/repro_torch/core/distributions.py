"""Long-tailed rollout response-length model (paper Fig 11 / C2).

Generation lengths follow a heavy-tailed lognormal clipped at the job's max
token limit; a rollout phase's duration is set by its slowest response
(skewness bubbles) while most GPUs finish at the ~80th percentile.

Counterpart of ``repro/core/distributions.py``: the same numpy draws.
"""
from __future__ import annotations

import numpy as np


def sample_response_fractions(rng: np.random.Generator, n: int,
                              sigma: float = 0.9,
                              clip_frac: float = 1.0) -> np.ndarray:
    """Per-response completion times as fractions of the max-token time."""
    x = rng.lognormal(mean=-1.2, sigma=sigma, size=n)
    return np.clip(x, 0.02, clip_frac)


def phase_profile(rng: np.random.Generator, n_responses: int = 256,
                  sigma: float = 0.9) -> tuple[float, float]:
    """Returns (t80_frac, t_max_frac): 80th-percentile and max completion
    fractions of the worst-case (max-token) duration."""
    fr = sample_response_fractions(rng, n_responses, sigma)
    return float(np.quantile(fr, 0.8)), float(fr.max())


def straggler_stats(rng: np.random.Generator, n: int = 256,
                    sigma: float = 0.9) -> dict:
    fr = sample_response_fractions(rng, n, sigma)
    return {
        "p50": float(np.quantile(fr, 0.5)),
        "p80": float(np.quantile(fr, 0.8)),
        "p99": float(np.quantile(fr, 0.99)),
        "max": float(fr.max()),
        # mean GPU idleness while waiting for stragglers (skewness bubble)
        "bubble_frac": float(1.0 - fr.mean() / fr.max()),
    }
