"""The training phase: RL policy-gradient step (forward, backward, AdamW)
with microbatched gradient accumulation and activation checkpointing.

Counterpart of ``repro/rl/train_step.py``.  Where the JAX package takes
``jax.value_and_grad`` of a pure loss, the step runs the loss on detached
aliases of the parameters that require grad and calls
``torch.autograd.grad``; the parameters themselves never require grad, so
the rollout engine builds no autograd graph with them.  The AdamW update
is in place (see :mod:`repro_torch.train.optimizer`).
"""
from __future__ import annotations

import torch

from repro_torch.rl.grpo import policy_gradient_loss
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update, tree_leaves, tree_map)


def make_loss_fn(model, *, remat: bool = True, clip_eps: float = 0.2):
    """loss_fn(params, batch) -> (loss, metrics); ``batch`` holds
    ``tokens``, ``labels``, ``advantages``, ``loss_mask`` and optionally
    ``behavior_logp``, each (B, S)."""
    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch["tokens"], remat=remat)
        pg, metrics = policy_gradient_loss(
            logits, batch["labels"], batch["advantages"], batch["loss_mask"],
            behavior_logp=batch.get("behavior_logp"), clip_eps=clip_eps)
        loss = pg + aux
        return loss, dict(metrics, moe_aux=aux, loss=loss)

    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """(metrics, detached) and the gradients, a tree like ``params`` in the
    parameters' dtypes."""
    train = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = loss_fn(train, batch)
    leaves = tree_leaves(train)
    by_leaf = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda t: by_leaf[id(t)], train))


def make_train_step(model, opt_cfg: AdamWConfig = AdamWConfig(), *,
                    microbatches: int = 1, remat: bool = True,
                    lr_schedule=None):
    """Returns ``train_step(state, batch) -> (state, metrics)`` with
    ``state = {"params", "opt"}``, updated in place.

    ``microbatches > 1`` slices the batch on dim 0 into equal parts, sums
    their gradients in float32 and divides by the count (the JAX package's
    ``lax.scan`` accumulation); the metrics are the last microbatch's.
    With one microbatch the gradients stay in the parameters' dtype."""
    loss_fn = make_loss_fn(model, remat=remat)

    def train_step(state, batch):
        params = state["params"]
        if microbatches <= 1:
            metrics, grads = _value_and_grad(loss_fn, params, batch)
        else:
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            for i in range(microbatches):
                size = next(iter(batch.values())).shape[0] // microbatches
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                metrics, g = _value_and_grad(loss_fn, params, mb)
                for acc, gi in zip(tree_leaves(gsum), tree_leaves(g)):
                    acc.add_(gi)
                del g
            grads = tree_map(lambda g: g / microbatches, gsum)
        _, _, opt_metrics = adamw_update(grads, state["opt"], params,
                                         opt_cfg, lr_schedule)
        return state, metrics | opt_metrics

    return train_step


def init_train_state(model, generator: torch.Generator,
                     opt_cfg: AdamWConfig = AdamWConfig()) -> dict:
    """Random parameters on the generator's device and fresh AdamW
    moments."""
    params = model.init(generator)
    return {"params": params, "opt": adamw_init(params, opt_cfg)}
