"""GRPO / PPO objectives (the paper's workloads train with these, §4.4).

Counterpart of ``repro/rl/grpo.py``: group advantages in numpy, the token
log-probabilities and the clipped policy-gradient loss in torch, with the
same metrics.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class GRPOConfig:
    group_size: int = 4          # completions per prompt
    clip_eps: float = 0.2
    kl_coef: float = 0.0
    adv_eps: float = 1.0e-4


def group_advantages(rewards: np.ndarray, group_size: int,
                     eps: float = 1e-4) -> np.ndarray:
    """GRPO: advantage = (r - mean_group) / (std_group + eps).

    rewards: (B,) where B = n_prompts * group_size, grouped contiguously.
    """
    r = rewards.reshape(-1, group_size)
    mean = r.mean(axis=1, keepdims=True)
    std = r.std(axis=1, keepdims=True)
    return ((r - mean) / (std + eps)).reshape(-1).astype(np.float32)


def token_logprobs(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits: (B,S,V) fp32; labels: (B,S) -> (B,S) log p(label)."""
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, labels.long()[..., None])[..., 0]


def policy_gradient_loss(logits, labels, advantages, loss_mask,
                         behavior_logp=None, clip_eps: float = 0.2):
    """Clipped-ratio policy gradient (PPO/GRPO); ratio = 1 when no behaviour
    logprobs are given (pure on-policy single update, the paper's setting).

    logits (B,S,V), labels/advantages/loss_mask (B,S).  Returns (loss,
    metrics): ``pg_loss``, ``entropy``, ``clip_frac``, and the masked
    ``ratio_mean`` / ``ratio_max`` off-policy drift diagnostics."""
    logp = token_logprobs(logits, labels)
    adv = advantages
    denom = loss_mask.sum().clamp_min(1.0)
    one = torch.ones((), dtype=torch.float32, device=logits.device)
    if behavior_logp is None:
        pg = -(logp * adv * loss_mask).sum() / denom
        clip_frac = torch.zeros_like(one)
        ratio_mean = ratio_max = one
    else:
        ratio = torch.exp(logp - behavior_logp)
        unclipped = ratio * adv
        clipped = ratio.clamp(1 - clip_eps, 1 + clip_eps) * adv
        pg = -(torch.minimum(unclipped, clipped) * loss_mask).sum() / denom
        clip_frac = (((ratio - 1).abs() > clip_eps) * loss_mask).sum() / denom
        ratio_mean = (ratio * loss_mask).sum() / denom
        ratio_max = torch.where(loss_mask > 0, ratio, one).max()
    ent = -(torch.softmax(logits, dim=-1)
            * torch.log_softmax(logits, dim=-1)).sum(-1)
    entropy = (ent * loss_mask).sum() / denom
    return pg, {"pg_loss": pg, "entropy": entropy, "clip_frac": clip_frac,
                "ratio_mean": ratio_mean, "ratio_max": ratio_max}
