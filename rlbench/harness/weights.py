"""Seeded weights made on the device in a few large draws.

The benchmark makes the weights and hands the same tensors to the program
and to the reference.  The tree's structure (names, shapes, storage types)
comes from the configuration's file (``config.file_abstract``); the values
come from one ``torch.Generator`` on the device: normal draws of up to
``DRAW`` elements, cut into the leaves in path order and scaled by each
leaf's rule.
"""
from __future__ import annotations

import math

import torch

from rlbench.reference.grpo import tree_leaves

DRAW = 1 << 28           # elements of one normal draw
ZEROS = {"ln1", "ln2", "final_norm"}


def _rule(path: str, shape: tuple):
    """``(kind, std)`` of a leaf by its name: norm gains zero (the norms
    scale by 1 + w), the embedding 0.02, every product weight fan-in
    scaled (the attention output's fan-in is heads x head size)."""
    name = path.rsplit("/", 1)[-1]
    if name in ZEROS:
        return "zeros", 0.0
    if name == "embed":
        return "normal", 0.02
    if name == "wo" and len(shape) == 3:
        return "normal", 1.0 / math.sqrt(shape[0] * shape[1])
    return "normal", 1.0 / math.sqrt(shape[0])


def rebuild(tree, fn, prefix=""):
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf)``;
    paths as :func:`~rlbench.reference.grpo.tree_leaves` names them."""
    if isinstance(tree, dict):
        return {k: rebuild(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(t, fn, f"{prefix}{i}/")
                          for i, t in enumerate(tree))
    return fn(prefix.rstrip("/"), tree)


def make_weights(abstract, seed: int, device) -> dict:
    """The tree of ``abstract`` (meta tensors) filled from ``seed`` on
    ``device``, each leaf in its own dtype."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    leaves = tree_leaves(abstract)
    left = sum(t.numel() for p, t in leaves
               if _rule(p, tuple(t.shape))[0] == "normal")
    values = {}
    buf = torch.empty(0, device=device)
    for path, t in leaves:
        kind, std = _rule(path, tuple(t.shape))
        if kind == "zeros":
            values[path] = torch.zeros(t.shape, dtype=t.dtype, device=device)
        else:
            parts, n = [], t.numel()
            while n:
                if not buf.numel():
                    buf = torch.randn(min(DRAW, left), generator=gen,
                                      device=device)
                k = min(n, buf.numel())
                parts.append(buf[:k])
                buf, n, left = buf[k:], n - k, left - k
            x = parts[0] if len(parts) == 1 else torch.cat(parts)
            values[path] = (x * std).to(t.dtype).view(t.shape)
    return rebuild(abstract, lambda p, _: values[p])


def storage_dtypes(abstract) -> dict:
    """``{path: dtype}`` of the tree's leaves."""
    return {p: t.dtype for p, t in tree_leaves(abstract)}
