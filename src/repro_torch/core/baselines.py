"""Scheduler baselines from the paper's evaluation:
Solo-D, colocated veRL, Gavel+, Random, Greedy (most-idle), Offline-Optimal.

Counterpart of ``repro/core/baselines.py``.
"""
from __future__ import annotations

import random as _random
from typing import Optional

from repro_torch.core.cluster import Node, NodeAllocator
from repro_torch.core.group import CoExecutionGroup, Placement
from repro_torch.core.inter_group import Decision, InterGroupScheduler
from repro_torch.core.job import RLJob


class SoloDisaggregation(InterGroupScheduler):
    """Standard disaggregation: every job gets a dedicated group (paper Fig 1-top)."""

    def schedule(self, job: RLJob) -> Decision:
        G = self._new_group(job)
        placement = Placement(tuple(G.rollout_nodes))
        G.add_job(job, placement)
        return Decision(G, placement, self._isolated_cost(job), "isolated")


class VeRLColocated:
    """Monolithic co-location on the training pool: rollout runs on H800 with
    a memory-bandwidth slowdown; no rollout pool is provisioned."""

    def __init__(self, allocator: NodeAllocator):
        self.alloc = allocator
        self.jobs: dict[str, tuple[RLJob, list[Node]]] = {}

    def rollout_slowdown(self) -> float:
        return (self.alloc.rollout_accel.hbm_tbps
                / self.alloc.train_accel.hbm_tbps)  # H20 4.0 / H800 3.35

    def schedule(self, job: RLJob):
        nodes = self.alloc.alloc_train(job.n_train_nodes)
        self.jobs[job.job_id] = (job, nodes)

    def iter_time(self, job: RLJob) -> float:
        return job.t_roll * self.rollout_slowdown() + job.t_train

    def release(self, job_id: str) -> None:
        _, nodes = self.jobs.pop(job_id, (None, []))
        self.alloc.release(nodes)

    def total_cost_per_hour(self) -> float:
        return sum(sum(n.price_per_hour for n in ns)
                   for _, ns in self.jobs.values())


class RandomScheduler(InterGroupScheduler):
    """Random feasible group (memory + size only — no SLO guarantee)."""

    def __init__(self, allocator, *, max_group_size=5, seed=0):
        super().__init__(allocator, max_group_size=max_group_size,
                         slo_check=False)
        self.rng = _random.Random(seed)

    def schedule(self, job: RLJob) -> Decision:
        cands = []
        for G in self.groups.values():
            if len(G.jobs) >= self.max_group_size or not G.jobs:
                continue
            if len(G.rollout_nodes) < job.n_roll_nodes:
                continue
            nids = self.rng.sample(list(G.rollout_nodes), job.n_roll_nodes)
            pl = Placement(tuple(nids))
            if G.fits_memory(job, pl):
                cands.append((G, pl))
        if cands and self.rng.random() < 0.5:
            G, pl = self.rng.choice(cands)
            G.add_job(job, pl)
            return Decision(G, pl, 0.0, "pack")
        G = self._new_group(job)
        pl = Placement(tuple(G.rollout_nodes))
        G.add_job(job, pl)
        return Decision(G, pl, self._isolated_cost(job), "isolated")


class GreedyMostIdle(InterGroupScheduler):
    """Most-idle group first, least-loaded nodes — no SLO guarantee."""

    def __init__(self, allocator, *, max_group_size=5):
        super().__init__(allocator, max_group_size=max_group_size,
                         slo_check=False)

    def schedule(self, job: RLJob) -> Decision:
        best = None
        for G in self.groups.values():
            if len(G.jobs) >= self.max_group_size or not G.jobs:
                continue
            if len(G.rollout_nodes) < job.n_roll_nodes:
                continue
            idle = 1.0 - G.t_load() / max(G.t_cycle(), 1e-9)
            load = {nid: 0.0 for nid in G.rollout_nodes}
            for jid, pl in G.placements.items():
                for nid in pl.rollout_node_ids:
                    load[nid] += G.jobs[jid].t_roll
            nids = tuple(sorted(load, key=load.get)[:job.n_roll_nodes])
            pl = Placement(nids)
            if not G.fits_memory(job, pl):
                continue
            if best is None or idle > best[0]:
                best = (idle, G, pl)
        if best is not None and best[0] > 0:
            _, G, pl = best
            G.add_job(job, pl)
            return Decision(G, pl, 0.0, "pack")
        G = self._new_group(job)
        pl = Placement(tuple(G.rollout_nodes))
        G.add_job(job, pl)
        return Decision(G, pl, self._isolated_cost(job), "isolated")


class GavelPlus(GreedyMostIdle):
    """Heterogeneity-aware job-level scheduler (Gavel + RL support): shares
    pools across jobs but multiplexes at *job* granularity — a job's
    rollout+train pair runs as one atomic block, so dependency bubbles
    inside the block are never reclaimed. Modeled via the job_atomic DES flag.
    """
    job_atomic = True


# ---------------------------------------------------------------------------
# Offline optimal (brute force over set partitions; small instances only)
# ---------------------------------------------------------------------------
def _partitions(items: list):
    if not items:
        yield []
        return
    first, rest = items[0], items[1:]
    for part in _partitions(rest):
        for i, block in enumerate(part):
            yield part[:i] + [[first] + block] + part[i + 1:]
        yield [[first]] + part


def _best_group_cost(jobs: list[RLJob], alloc: NodeAllocator,
                     max_group_size: int) -> Optional[float]:
    """Min provisioning cost of one SLO-feasible group for these jobs."""
    if len(jobs) > max_group_size:
        return None
    r_price = alloc.rollout_accel.price_per_gpu_hour * 8
    t_price = alloc.train_accel.price_per_gpu_hour * 8
    n_train = max(j.n_train_nodes for j in jobs)
    lo = max(j.n_roll_nodes for j in jobs)
    hi = sum(j.n_roll_nodes for j in jobs)
    for n_roll in range(lo, hi + 1):
        nodes_r = [Node(f"r{i}", alloc.rollout_accel) for i in range(n_roll)]
        nodes_t = [Node(f"t{i}", alloc.train_accel) for i in range(n_train)]
        G = CoExecutionGroup("opt", nodes_r, nodes_t)
        # LPT bin packing of rollout load onto nodes
        load = {n.node_id: 0.0 for n in nodes_r}
        ok = True
        for j in sorted(jobs, key=lambda j: -j.t_roll):
            nids = sorted(load, key=load.get)[:j.n_roll_nodes]
            pl = Placement(tuple(nids))
            if not G.fits_memory(j, pl):
                ok = False
                break
            G.add_job(j, pl)
            for nid in nids:
                load[nid] += j.t_roll
        if not ok:
            continue
        if G.saturated() or not G.slo_ok():
            continue
        return n_roll * r_price + n_train * t_price
    return None


def offline_optimal_cost(jobs: list[RLJob], alloc: NodeAllocator,
                         max_group_size: int = 5) -> float:
    """Brute-force minimum total $/h over all partitions (paper §7.5 'Opt')."""
    best = float("inf")
    for part in _partitions(list(jobs)):
        total = 0.0
        feasible = True
        for block in part:
            c = _best_group_cost(block, alloc, max_group_size)
            if c is None:
                feasible = False
                break
            total += c
        if feasible:
            best = min(best, total)
    return best
