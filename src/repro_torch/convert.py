"""Convert the JAX package's parameter pytree (and train state) into the
port's.

The input is the JAX pytree as nested dicts of numpy arrays (``jax.tree.map
(np.asarray, params)``), so this module needs neither JAX nor the JAX
package.  Layer groups the JAX stack keeps stacked on axis 0 for
``lax.scan`` (``layers``, ``dense_layers``, whisper's ``cross`` and the
``layers`` of its ``encoder``) become Python lists of per-layer dicts
(zamba2's ``layers`` hold ``norm`` and the nested ``mamba`` block);
unstacked groups such as zamba2's ``shared_attn`` and whisper's
``encoder`` keep their nesting; every array keeps its layout and dtype (zamba2's
``A_log``, ``D`` and ``dt_bias`` stay float32 in a bf16 model).  float32 converts exactly;
bfloat16 (numpy's ``ml_dtypes`` bfloat16) goes bit for bit through a
``uint16`` view into ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

STACKED = ("layers", "dense_layers", "cross")


def to_tensor(a, device="cpu") -> torch.Tensor:
    a = np.array(a)               # an owned, writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _unstack(tree) -> list:
    """A tree whose leaves share a leading axis n -> n trees."""
    leaves = []

    def collect(t):
        if isinstance(t, dict):
            for v in t.values():
                collect(v)
        else:
            leaves.append(np.asarray(t).shape[0])
    collect(tree)
    n = leaves[0]
    if any(m != n for m in leaves):
        raise ValueError(f"stacked leaves disagree on the layer count: "
                         f"{sorted(set(leaves))}")

    def take(t, i):
        return ({k: take(v, i) for k, v in t.items()}
                if isinstance(t, dict) else np.asarray(t)[i])
    return [take(tree, i) for i in range(n)]


def from_jax_params(tree: dict, device="cpu") -> dict:
    """JAX parameter pytree (nested dicts of numpy arrays) -> port params
    on ``device``."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return to_tensor(t, device)

    out = {}
    for k, v in tree.items():
        if k in STACKED:
            out[k] = [conv(layer) for layer in _unstack(v)]
        elif k == "encoder":      # whisper: {"layers": stacked, final_norm}
            out[k] = from_jax_params(v, device)
        else:
            out[k] = conv(v)
    return out


def from_jax_train_state(state: dict, device="cpu") -> dict:
    """JAX train state ``{"params", "opt": {"mu", "nu", "step"}}`` (nested
    dicts of numpy arrays) -> the port's train state on ``device``: the
    parameters and both AdamW moments converted like parameters, the step
    a 0-d int32 tensor."""
    opt = state["opt"]
    return {"params": from_jax_params(state["params"], device),
            "opt": {"mu": from_jax_params(opt["mu"], device),
                    "nu": from_jax_params(opt["nu"], device),
                    "step": to_tensor(np.asarray(opt["step"], np.int32),
                                      device)}}
