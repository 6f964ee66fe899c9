"""The comparison that decides ``correct``, and the faults its tests plant.

Every compared number is a gap between what the program produced and
what the plain reference works out from the same inputs, each held to a
limit of its own (the cell file's ``check.limits``):

* ``logp_gap``: the widest gap, over every response token of the first
  iterations' rollouts, between the log-probability the program recorded
  for the token it sampled and the reference's log-probability of that
  token (its forward over the prompt and the response, under its own
  weights);
* ``loss_gap``: the widest gap between the program's GRPO loss and the
  reference's over the followed steps, in nats;
* ``grad_norm_gap``: the widest relative gap between the global gradient
  norms (before clipping) of the followed steps;
* ``first_grad_gap``: the first step's gradient as the optimizer got it
  (clipped; the program's read from its first moment after one step), by
  the worst leaf: the gap between the two norms of a leaf over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger;
* ``update_gap``: the weights' change over the followed steps, by the
  worst leaf as above, leaving out the leaves whose reference gradient is
  under a thousandth of the median leaf's (they move by round-off alone).
"""
from __future__ import annotations

import statistics
from types import SimpleNamespace

import torch

NUMBERS = ("logp_gap", "loss_gap", "grad_norm_gap", "first_grad_gap",
           "update_gap")
ZERO_GRAD = 1e-3     # a leaf's gradient under this share of the median's


def worst_leaf(prog: dict, ref: dict, skip=()) -> float:
    """max over leaves of | |a| - |b| | / max(|b|, median |b|)."""
    med = statistics.median(ref.values())
    return max(abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30)
               for p in ref if p not in skip)


def training_numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of one job from the program's readings
    (``loss``, ``grad_norm`` lists, ``first_grad``, ``change`` per-leaf
    norms, ``logp`` per step) and the reference's (the same, with
    ``first_raw``, its unclipped first gradient)."""
    med = statistics.median(ref["first_raw"].values())
    skip = {p for p, g in ref["first_raw"].items() if g < ZERO_GRAD * med}
    logp = [float((a - b).abs().max()) if a.numel() else 0.0
            for a, b in zip(prog["logp"], ref["logp"])]
    return {
        "logp_gap": max(logp),
        "loss_gap": max(abs(a - b) for a, b in zip(prog["loss"],
                                                   ref["loss"])),
        "grad_norm_gap": max(abs(a - b) / max(b, 1e-30) for a, b in
                             zip(prog["grad_norm"], ref["grad_norm"])),
        "first_grad_gap": worst_leaf(prog["first_grad"], ref["first_grad"]),
        "update_gap": worst_leaf(prog["change"], ref["change"], skip),
    }


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """``(correct, [(name, value, limit)])``: correct when every number is
    finite and within its limit."""
    rows = [(n, numbers[n], limits[n]) for n in limits]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows


# ---------------------------------------------------------------------------
# Faults planted by the check's tests (the timed path broken underneath)
# ---------------------------------------------------------------------------
def alter_tokens(out: dict) -> dict:
    """A token altered where the rollout produced it: the middle response
    token of every row becomes id 300 (301 where it was 300); its
    recorded log-probability stays."""
    out = dict(out)
    comp = out["completions"].clone()
    j = comp.shape[1] // 2
    comp[:, j] = torch.where(comp[:, j] == 300, 301, 300).to(comp.dtype)
    out["completions"] = comp
    Sp = out["tokens"].shape[1] - comp.shape[1]
    tokens = out["tokens"].clone()
    tokens[:, Sp:] = comp
    out["tokens"] = tokens
    return out


def half_batch(b, out: dict, group: int):
    """Half of the batch left out: the train step sees the first half of
    the prompt groups, and its mean runs over them alone."""
    n = out["tokens"].shape[0] // 2 // group * group
    b = SimpleNamespace(prompts=b.prompts[:n // group],
                        answers=b.answers[:n // group])
    out = {k: (v[:n] if isinstance(v, torch.Tensor)
               or hasattr(v, "shape") else v) for k, v in out.items()}
    return b, out
