"""The backward that the scan kernels' autograd functions share: the plain
version recomputed under autograd from the saved inputs.

The JAX package has no backward kernel for any Pallas function: its
training forward differentiates its jnp paths.  So the port's scan
functions run their kernel forward and take their gradients from the plain
version, recomputed in float32 one call at a time.  A hand-written backward
kernel is later work (ROADMAP §2).
"""
from __future__ import annotations

import torch


def plain_grads(plain, saved, needs, grad_outputs) -> tuple:
    """Gradients of ``plain(*saved)`` with respect to each input whose
    ``needs`` flag is set (None for the others), for the gradients
    ``grad_outputs`` of its outputs (None where an output got none: the
    final state that training drops)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) if t is not None else None
                  for t, n in zip(saved, needs)]
        outs = plain(*leaves)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None]
        want = [t for t, n in zip(leaves, needs) if n]
        if not pairs or not want:
            return (None,) * len(needs)
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], want, [g for _, g in pairs],
            allow_unused=True))
    return tuple(next(got) if n else None for n in needs)
