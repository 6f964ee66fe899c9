"""The configuration's file held against the program's model.

The file is the benchmark's statement of the model it runs.  A run builds
the program's model by the name the file gives (``port_arch``) and goes on
only where the program's config states every one of the file's sizes
alike (:data:`PORT_FIELDS`), and where the weights the program would take
have the names, shapes and storage type that the file's sizes imply
(``rlbench.reference.models.weight_shapes``).  The reference takes its
sizes from the file alone.
"""
from __future__ import annotations

import torch

from rlbench.reference.grpo import tree_leaves
from rlbench.reference.models import weight_shapes

# the file's key -> the program's ModelConfig attribute (``head_dim`` its
# resolved value)
PORT_FIELDS = {
    "family": "family",
    "num_hidden_layers": "num_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "head_dim": "resolved_head_dim",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "attention": "attention",
    "qkv_bias": "qkv_bias",
    "sliding_window": "sliding_window",
    "mrope": "mrope",
    "dtype": "dtype",
}


class ConfigMismatch(Exception):
    """The program's model is not the one the configuration's file
    states."""


def file_view(port_cfg) -> dict:
    """The file's keys as the program's config states them."""
    return {k: getattr(port_cfg, a) for k, a in PORT_FIELDS.items()}


def differences(cfg: dict, port_cfg, abstract) -> list:
    """Every way in which the program's config and weights depart from the
    file ``cfg``: a size stated otherwise, a weight missing, extra, of
    another shape or stored in another type."""
    out = [f"{k}: file {cfg[k]!r}, program {v!r}"
           for k, v in file_view(port_cfg).items() if cfg.get(k) != v]
    want = weight_shapes(cfg)
    dtype = getattr(torch, cfg["dtype"])
    have = dict(tree_leaves(abstract))
    out += [f"weight {p}: missing" for p in sorted(set(want) - set(have))]
    out += [f"weight {p}: not in the file's model"
            for p in sorted(set(have) - set(want))]
    for p in sorted(set(want) & set(have)):
        t = have[p]
        if tuple(t.shape) != want[p] or t.dtype != dtype:
            out.append(f"weight {p}: file {want[p]} {dtype}, program "
                       f"{tuple(t.shape)} {t.dtype}")
    return out


def check_model(cfg: dict, model, abstract) -> None:
    """Raise :class:`ConfigMismatch` naming every difference."""
    diff = differences(cfg, model.cfg, abstract)
    if diff:
        raise ConfigMismatch("the program's model departs from "
                             f"{cfg['name']}'s file: " + "; ".join(diff))


def file_abstract(cfg: dict):
    """The weights' tree as the file's sizes imply it: meta tensors in
    the file's storage type, nested as the program nests its weights
    (numbered levels as lists)."""
    dtype = getattr(torch, cfg["dtype"])
    tree: dict = {}
    for path, shape in weight_shapes(cfg).items():
        *parents, leaf = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = torch.empty(shape, dtype=dtype, device="meta")

    def nest(t):
        if not isinstance(t, dict):
            return t
        if all(k.isdigit() for k in t):
            return [nest(t[str(i)]) for i in range(len(t))]
        return {k: nest(v) for k, v in t.items()}
    return nest(tree)
