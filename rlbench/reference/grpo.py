"""Plain GRPO training steps that follow a program's first iterations.

From the published descriptions: GRPO's group-normalised advantages
(arXiv:2402.03300), PPO's clipped-ratio objective averaged over the
response tokens, AdamW with global-norm clipping and bias correction
(arXiv:1711.05101), and a learning rate that rises linearly over its
warm-up steps.  Every product and sum is float32.

The weights are stored as the configuration states them: after the
initial weights and after each update every leaf is rounded to its
storage type (``store``: the configuration's, bfloat16), as a model
whose weights are bfloat16 numbers keeps them; the moments are float32.  :func:`fake_quant_fp8` is the control's
storage: the same weights held as float8 e4m3 numbers with one float32
scale per leaf.

The behaviour log-probabilities are this side's own, detached, so the
ratio is 1 and the reference is on-policy, as the program's rollout is.
"""
from __future__ import annotations

import numpy as np
import torch

from rlbench.reference.models import float32_matmuls, forward


def tree_leaves(tree, prefix=""):
    """``[(path, tensor)]`` of a nested dict/list tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in tree_leaves(t, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def fake_quant_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the whole tensor
    (its largest magnitude at e4m3's largest finite 448), back in float32."""
    amax = t.abs().max().clamp_min(1e-30)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def rounder(store: str, dtypes: dict):
    """The storage rounding of each leaf: ``store`` "config" rounds a leaf
    to its configured dtype (``dtypes[path]``), "fp8" to float8 e4m3."""
    def rnd(path, t):
        if store == "fp8":
            return fake_quant_fp8(t)
        return t.to(dtypes[path]).float()
    return rnd


def group_advantages(rewards: np.ndarray, group: int, eps: float = 1e-4):
    """(r - group mean) / (group std + eps), per group of consecutive rows."""
    r = np.asarray(rewards, np.float64).reshape(-1, group)
    adv = (r - r.mean(1, keepdims=True)) / (r.std(1, keepdims=True) + eps)
    return adv.reshape(-1).astype(np.float32)


def warmup_lr(base: float, warmup: int, step: int) -> float:
    """The learning rate of optimizer step ``step`` (1-based) within the
    linear warm-up."""
    if step >= warmup:
        raise ValueError("the reference follows warm-up steps only")
    return base * step / warmup


class Follower:
    """Float32 GRPO training from ``params0``, one :meth:`step` per
    iteration the program ran.  ``rows_per_block`` bounds the rows of one
    forward and backward (the gradient of the whole batch is the sum of
    the blocks')."""

    def __init__(self, params0, cfg: dict, dtypes: dict, *, store="config",
                 opt: dict, rows_per_block: int = 4):
        # ``params0`` is not kept: :meth:`change_norms` takes the initial
        # weights again, so the device holds one float32 copy of them
        self.cfg = cfg
        self.opt = opt
        self.rows = rows_per_block
        self.round = rounder(store, dtypes)
        self.paths = [p for p, _ in tree_leaves(params0)]
        self.params = tree_map(lambda t: t.detach().float().clone(), params0)
        self._apply_round()
        self.mu = self.nu = None        # made by the first step
        self.t = 0
        self.first_grad = None        # per-leaf norms of step 1's clipped g
        self.first_raw = None         # per-leaf norms of step 1's raw g

    def _apply_round(self):
        with torch.no_grad():
            for path, t in tree_leaves(self.params):
                t.copy_(self.round(path, t))

    def logp(self, tokens: torch.Tensor) -> torch.Tensor:
        """Log-probabilities (B, S-1) of ``tokens[:, 1:]``, no gradient."""
        out = []
        with torch.no_grad(), float32_matmuls():
            for i in range(0, tokens.shape[0], self.rows):
                tk = tokens[i:i + self.rows]
                lg = forward(self.params, self.cfg, tk[:, :-1])
                out.append(torch.log_softmax(lg, -1).gather(
                    -1, tk[:, 1:, None].long())[..., 0])
                del lg
        return torch.cat(out)

    def step(self, tokens, loss_mask, advantages, clip_eps=0.2):
        """One iteration on ``tokens (B, S)``; ``loss_mask`` and
        ``advantages`` (B, S-1) over the label positions.  Returns ``{loss,
        grad_norm, logp}`` with ``logp`` (B, S-1) of the tokens under the
        weights before the update."""
        leaves = dict(tree_leaves(self.params))
        if self.mu is None:
            self.mu = {p: torch.zeros_like(t) for p, t in leaves.items()}
            self.nu = {p: torch.zeros_like(t) for p, t in leaves.items()}
        for t in leaves.values():
            t.requires_grad_(True)
        grads = {p: torch.zeros_like(t) for p, t in leaves.items()}
        denom = loss_mask.sum().clamp_min(1.0)
        loss = torch.zeros((), device=tokens.device)
        logps = []
        with float32_matmuls():
            for i in range(0, tokens.shape[0], self.rows):
                tk = tokens[i:i + self.rows]
                lg = forward(self.params, self.cfg, tk[:, :-1])
                lp = torch.log_softmax(lg, -1).gather(
                    -1, tk[:, 1:, None].long())[..., 0]
                del lg
                ratio = torch.exp(lp - lp.detach())
                a = advantages[i:i + self.rows]
                obj = torch.minimum(ratio * a,
                                    ratio.clamp(1 - clip_eps, 1 + clip_eps)
                                    * a)
                part = -(obj * loss_mask[i:i + self.rows]).sum() / denom
                g = torch.autograd.grad(part, list(leaves.values()),
                                        allow_unused=True)
                for (p, _), gi in zip(leaves.items(), g):
                    if gi is not None:
                        grads[p] += gi
                loss += part.detach()
                logps.append(lp.detach())
        for t in leaves.values():
            t.requires_grad_(False)
        self._update(grads)
        return {"loss": float(loss), "grad_norm": self._gnorm,
                "logp": torch.cat(logps)}

    @torch.no_grad()
    def _update(self, grads):
        o = self.opt
        self.t += 1
        gnorm = torch.sqrt(sum(g.double().square().sum()
                               for g in grads.values()))
        self._gnorm = float(gnorm)
        scale = min(1.0, o["grad_clip"] / (self._gnorm + 1e-9)) \
            if o["grad_clip"] > 0 else 1.0
        lr = warmup_lr(o["lr"], o["warmup"], self.t)
        bc1, bc2 = 1 - o["b1"] ** self.t, 1 - o["b2"] ** self.t
        if self.t == 1:
            self.first_raw = {p: float(g.norm()) for p, g in grads.items()}
            self.first_grad = {p: float(g.norm()) * scale
                               for p, g in grads.items()}
        leaves = dict(tree_leaves(self.params))
        for p, g in grads.items():
            g = g * scale
            m, v, w = self.mu[p], self.nu[p], leaves[p]
            m.mul_(o["b1"]).add_((1 - o["b1"]) * g)
            v.mul_(o["b2"]).add_((1 - o["b2"]) * g.square())
            delta = (m / bc1) / (torch.sqrt(v / bc2) + o["eps"])
            if o["weight_decay"]:
                delta = delta + o["weight_decay"] * w
            w.copy_(self.round(p, w - lr * delta))

    def change_norms(self, params0) -> dict:
        """Per-leaf norm of the weights' change since ``params0`` (the
        initial weights, given again), in their stored precision."""
        p0 = dict(tree_leaves(params0))
        with torch.no_grad():
            return {p: float((t - self.round(p, p0[p].float())).norm())
                    for p, t in tree_leaves(self.params)}
