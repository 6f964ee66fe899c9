"""Mixture-of-Experts layer: top-k routing with capacity-bounded,
sort-based dispatch.

Counterpart of ``repro/models/moe.py``, computed the same way step for
step: float32 router logits and softmax, top-k gates renormalised, the
Switch load-balance loss, a capacity of ``max(int(T·k/E·capacity_factor),
4)`` assignments an expert (at most T), a stable sort of the flat expert
ids that gives each (token, expert) assignment its place in its expert's
buffer, assignments past the capacity sent to a drop row, SwiGLU experts
over the ``(E, C, d)`` buffer, and the combine in the model dtype.

Every shape follows from T, k, E and the capacity, and nothing reads a
device value on the host (no ``.item()``, ``nonzero`` or boolean-mask
indexing), so a CUDA graph can capture a decode step through this layer.

The combine adds each token's k contributions in ascending expert id,
starting from its first, in the model dtype: the order in which the
reference's scatter-add over expert-sorted updates applies them.  It
gathers them and adds, with no atomic scatter, so that a token's output
rounds alike from run to run.

The capacity couples the rows: an expert chosen by more than C of the T
rows drops the later assignments (in token order), so a row's output
depends on the other rows of the call.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (dense_init, mlp_apply, mlp_init,
                                       mlp_specs, torch_dtype)
from repro_torch.models.sharding import constrain


def moe_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """``router (d, E)`` float32, ``wi_gate``/``wi_up (E, d, f)`` and ``wo
    (E, f, d)`` in the model dtype, each expert's matrix drawn as a dense
    kernel of its own fan-in (the JAX init vmaps ``dense_init`` over the
    experts), and ``shared``, an MLP ``num_shared_experts · moe_d_ff``
    wide, when the config has shared experts."""
    dt = torch_dtype(cfg.dtype)
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def experts(n_in, n_out):
        w = torch.empty((E, n_in, n_out), dtype=dt, device=gen.device)
        if w.device.type != "meta":     # an abstract init draws nothing
            for e in range(E):
                w[e] = dense_init(gen, n_in, (n_out,), dt)
        return w

    p = {"router": dense_init(gen, d, (E,), torch.float32),
         "wi_gate": experts(d, f), "wi_up": experts(d, f),
         "wo": experts(f, d)}
    if cfg.num_shared_experts:
        p["shared"] = mlp_init(gen, d, cfg.num_shared_experts * f, dt)
    return p


def moe_specs(cfg: ModelConfig) -> dict:
    """Logical axes of :func:`moe_init`'s leaves: experts over the model
    axis, their embed rows over data."""
    s = {
        "router": ("embed", None),
        "wi_gate": ("experts", "embed", "ffn"),
        "wi_up": ("experts", "embed", "ffn"),
        "wo": ("experts", "ffn", "embed"),
    }
    if cfg.num_shared_experts:
        s["shared"] = mlp_specs(cfg)
    return s


def capacity_for(cfg: ModelConfig, T: int,
                 capacity: Optional[int] = None) -> int:
    """Assignments an expert takes from T rows: ``max(int(T·k/E·
    capacity_factor), 4)`` unless given, and at most T."""
    if capacity is None:
        k, E = cfg.num_experts_per_tok, cfg.num_experts
        capacity = max(int(T * k / E * cfg.capacity_factor), 4)
    return min(capacity, T)


def moe_route(p: dict, cfg: ModelConfig, xf: torch.Tensor,
              capacity: Optional[int] = None) -> dict:
    """Route the rows ``xf (T, d)``: ``gates (T, k)`` (the top-k of the
    float32 softmax over their sum), the ``aux`` loss, the ``capacity``
    C, and the dispatch: ``order`` (a stable sort of the flat expert ids),
    ``keep`` (the assignment, in that order, fits its expert's capacity),
    ``dest`` (its row of the ``(E·C + 1, d)`` buffer, ``E·C`` the drop
    row) and ``tok`` (its token)."""
    T = xf.shape[0]
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = xf.float() @ p["router"]                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)                  # (T, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss; the counts by comparison, not by a
    # scatter or one_hot (which reads the ids on the host)
    experts = torch.arange(E, device=xf.device)
    density = (idx[..., None] == experts).sum((0, 1)).float() / (T * k)
    aux = E * torch.sum(density * probs.mean(0)) * cfg.router_aux_loss
    C = capacity_for(cfg, T, capacity)
    flat_e = idx.reshape(-1)                                   # (T·k,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(T * k, device=xf.device) - first
    keep = pos < C
    dest = torch.where(keep, se * C + pos, E * C)
    return {"gates": gates, "aux": aux, "capacity": C, "order": order,
            "keep": keep, "dest": dest, "tok": order // k}


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
              capacity: Optional[int] = None):
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, aux loss float32
    scalar).  All B·S rows are routed together (see the module's note on
    the capacity)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    xf = x.reshape(T, d)
    r = moe_route(p, cfg, xf, capacity)
    C, dest = r["capacity"], r["dest"]
    buf = xf.new_zeros((E * C + 1, d))
    # repeats only at the drop row E·C
    buf[dest] = constrain(xf[r["tok"]], ("moe_tokens", None))
    eb = constrain(buf[:E * C].view(E, C, d), ("experts_act", None, None))
    h = F.silu(torch.bmm(eb, p["wi_gate"])) * torch.bmm(eb, p["wi_up"])
    h = constrain(h, ("experts_act", None, "ffn_act"))
    out = torch.cat([torch.bmm(h, p["wo"]).reshape(E * C, d),
                     xf.new_zeros((1, d))])
    gb = r["gates"].reshape(-1)[r["order"]].to(x.dtype)
    contrib = constrain(out[dest] * gb[:, None],     # (T·k, d), sorted
                        ("moe_tokens", None))
    # each token's k places in the sorted order, ascending: its experts
    # in ascending id, the order the reference's scatter-add applies them
    order = r["order"]
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * k, device=x.device))
    c = contrib[inv.view(T, k).sort(-1).values]      # (T, k, d)
    y = c[:, 0]
    for j in range(1, k):
        y = y + c[:, j]
    if "shared" in p:
        y = y + mlp_apply(p["shared"], xf)
    return y.reshape(B, S, d), r["aux"]
