"""AdamW and the learning-rate schedule, on plain dicts of tensors.

Counterpart of ``repro/train/optimizer.py``.  Parameters, gradients and
moments are nested dicts (and the per-layer lists of the port's stacks) of
tensors; :func:`tree_leaves` walks them in the JAX package's leaf order
(dict keys sorted).  The moments are float32.  Global-norm clipping, the
bias corrections and the update follow the JAX package's order of
operations in float32.  ``torch.optim.AdamW`` is not used: it places eps
and the weight decay differently.

:func:`adamw_update` updates the parameters and moments **in place** under
``torch.no_grad()`` (where JAX returns new arrays): the caller's state dict
holds the new values afterwards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3.0e-5
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1.0e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def tree_leaves(tree) -> list[torch.Tensor]:
    """Tensors of a nested dict/list tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree):
    """The same nested dict/list structure with ``fn`` applied to each
    tensor."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()) -> dict:
    dt = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": step}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the float32 sum of squares."""
    total = 0
    for x in tree_leaves(tree):
        total = total + x.float().square().sum()
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt, params, cfg: AdamWConfig,
                 lr_schedule: Callable | None = None):
    """One AdamW step.  Updates ``params``, ``opt["mu"]``, ``opt["nu"]``
    and ``opt["step"]`` in place; returns ``(params, opt, metrics)`` with
    ``metrics = {"grad_norm", "lr"}`` (float32 scalars)."""
    step = opt["step"] + 1
    gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = cfg.lr if lr_schedule is None else lr_schedule(step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt["mu"]), tree_leaves(opt["nu"])):
        g = g.to(m.dtype)
        if scale is not None:
            g = g * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(m.dtype)
        p.copy_((p.to(m.dtype) - lr * delta).to(p.dtype))
    opt["step"] = step
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    return params, opt, {"grad_norm": gnorm, "lr": lr_t}


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> Callable:
    """step (integer tensor) -> float32 learning rate: linear warmup over
    ``warmup`` steps, then cosine decay to ``min_frac * base_lr`` at
    ``total``."""
    def sched(step):
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return sched
