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
holds the new values afterwards.  Every leaf is squared for the norm and
updated a flat slice of at most ``SLICE`` elements at a time, so that the
update's float32 temporaries stay a slice's size (a full-width MoE layer's
stacked experts are one leaf of 1.06 B elements in dbrx-132b, 4.2 GB for
each float32 temporary); the update is elementwise, so its result is the
same bit for bit as the whole leaf's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.kernels.work import is_dtensor

SLICE = 1 << 26      # elements of a leaf's slice in the norm and the update


def _slices(*ts):
    """Matching flat slices of at most SLICE elements of contiguous tensors
    of one shape (in-place views); of ``DTensor``\\ s (the dry-run's
    sharded state, all in one placement), of their local shards: the
    update is elementwise."""
    ts = [t.to_local() if is_dtensor(t) else t for t in ts]
    flat = [t.view(-1) for t in ts]
    return [tuple(f[a:a + SLICE] for f in flat)
            for a in range(0, flat[0].numel(), SLICE)]


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
        return torch.zeros_like(p, dtype=dt)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": step}


def adamw_opt_specs(param_specs) -> dict:
    """Logical specs for the optimizer state, mirroring the params tree:
    :func:`adamw_init`'s ``mu`` and ``nu`` take the parameters' specs (a
    moment is sharded as its parameter is), the scalar ``step`` none."""
    return {"mu": param_specs, "nu": param_specs, "step": ()}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the float32 sum of squares (each
    leaf summed a slice at a time)."""
    total = 0
    for x in tree_leaves(tree):
        if is_dtensor(x):      # a sharded leaf: DTensor sums the shards
            total = total + x.float().square().sum()
            continue
        for (s,) in _slices(x.contiguous()):
            total = total + s.float().square().sum()
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
        if is_dtensor(scale):      # replicated: every shard's factor
            scale = scale.full_tensor()
    lr = cfg.lr if lr_schedule is None else lr_schedule(step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    if is_dtensor(stepf):          # replicated: every shard's count
        stepf = stepf.full_tensor()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)
    for leaf in zip(tree_leaves(params), tree_leaves(grads),
                    tree_leaves(opt["mu"]), tree_leaves(opt["nu"])):
        p0, g0 = leaf[:2]
        if is_dtensor(g0) and g0.placements != p0.placements:
            g0 = g0.redistribute(p0.device_mesh, p0.placements)
        for p, g, m, v in _slices(p0, g0.contiguous(), *leaf[2:]):
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
