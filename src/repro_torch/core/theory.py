"""Theorem 1 (utilization optimality of the round-robin meta-iteration) —
numeric checker used by tests and the scheduler-quality benchmark.

Counterpart of ``repro/core/theory.py``.
"""
from __future__ import annotations

import itertools

from repro_torch.core.cluster import Node, H20, H800
from repro_torch.core.group import CoExecutionGroup, Placement
from repro_torch.core.job import RLJob


def make_group(t_rolls, t_trains, *, slo=10.0, n_roll_nodes=1) -> CoExecutionGroup:
    """Single-rollout-node, single-train-node group (the appendix setting)."""
    nodes_r = [Node(f"r{i}", H20) for i in range(n_roll_nodes)]
    nodes_t = [Node("t0", H800)]
    G = CoExecutionGroup("thm", nodes_r, nodes_t)
    for i, (tr, tt) in enumerate(zip(t_rolls, t_trains)):
        j = RLJob(f"j{i}", t_roll=float(tr), t_train=float(tt), slo=slo)
        G.add_job(j, Placement((nodes_r[i % n_roll_nodes].node_id,)))
    return G


def aggregate_utilization(G: CoExecutionGroup, **sim_kw) -> float:
    res = G.simulate(**sim_kw)
    return res.rollout_util + res.train_util


def check_theorem1(t_rolls, t_trains) -> dict:
    """For an unsaturated group: round-robin utilization >= any job-repetition
    schedule and >= any alternative ordering. Returns the measurements."""
    G = make_group(t_rolls, t_trains)
    assert not G.saturated(), "theorem applies to unsaturated groups only"
    base = aggregate_utilization(G, n_cycles=120, discard=30)
    jids = list(G.jobs)
    # (2) repetition is suboptimal
    rep_utils = []
    for j in jids:
        rep_utils.append(aggregate_utilization(
            G, n_cycles=120, discard=30, extra_phases={j: 1}))
    # orderings achieve at most the round-robin utilization
    order_utils = []
    for perm in itertools.islice(itertools.permutations(jids), 6):
        order_utils.append(aggregate_utilization(
            G, n_cycles=120, discard=30, order=list(perm)))
    return {
        "round_robin": base,
        "max_repetition": max(rep_utils) if rep_utils else 0.0,
        "max_order": max(order_utils) if order_utils else base,
    }
