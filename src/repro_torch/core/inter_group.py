"""Inter-group scheduler — Algorithm 1 (paper §4.2).

Online, marginal-cost-minimizing placement with conservative (worst-case)
SLO admission, memory-residency constraints, and saturation pruning.

Counterpart of ``repro/core/inter_group.py``.  A :class:`Decision`'s
``latency_s`` is the host's own clock; every other field is the same in
both copies.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.cluster import NodeAllocator
from repro_torch.core.group import CoExecutionGroup, Placement
from repro_torch.core.job import RLJob


@dataclass
class Decision:
    group: CoExecutionGroup
    placement: Placement
    delta_cost: float
    strategy: str            # "pack" | "scale_rollout" | "isolated"
    latency_s: float = 0.0


class InterGroupScheduler:
    def __init__(self, allocator: NodeAllocator, *, max_group_size: int = 5,
                 slo_check: bool = True, admission_margin: float = 0.93,
                 overload_tolerance: float = 1.10):
        # admission_margin < 1 reserves headroom for context-switch latency
        # and non-preemptive scheduling anomalies (realized phase times
        # shorter than the worst-case bound can reorder FIFO queues).
        # overload_tolerance: a placement may saturate the group slightly
        # (Fig 10a packs two identical jobs at load ~104% of cycle) but
        # never heavily (Fig 3/Fig 6: over-saturated groups are avoided).
        self.alloc = allocator
        self.groups: dict[str, CoExecutionGroup] = {}
        self._gid = itertools.count()
        self.max_group_size = max_group_size
        self.slo_check = slo_check
        self.admission_margin = admission_margin
        self.overload_tolerance = overload_tolerance
        self.decision_latencies: list[float] = []

    # ------------------------------------------------------------------
    def schedule(self, job: RLJob) -> Decision:
        t0 = time.perf_counter()
        best: Optional[tuple] = None  # (delta, tiebreak, G, placement, strategy, n_new)

        for G in self.groups.values():
            # line 4: prune (over-)saturated groups — no slack to absorb work
            if not G.jobs or G.t_load() > self.overload_tolerance * G.t_cycle():
                continue
            if len(G.jobs) >= self.max_group_size:     # residency-bounded size
                continue
            for placement, n_new, strategy in self._gen_placements(G, job):
                cand = self._evaluate(G, job, placement, n_new)
                if cand is None:
                    continue
                delta, tiebreak = cand
                key = (delta, tiebreak)
                if best is None or key < (best[0], best[1]):
                    best = (delta, tiebreak, G, placement, strategy, n_new)

        iso_delta = self._isolated_cost(job)
        lat = time.perf_counter() - t0
        self.decision_latencies.append(lat)

        if best is not None and best[0] < iso_delta:
            delta, _, G, placement, strategy, n_new = best
            if n_new:
                new_nodes = self.alloc.alloc_rollout(n_new)
                for n in new_nodes:
                    G.rollout_nodes[n.node_id] = n
                placement = Placement(tuple(n.node_id for n in new_nodes))
            G.add_job(job, placement)
            return Decision(G, placement, delta, strategy, lat)

        # fallback: isolated provisioning (line 15-17)
        G = self._new_group(job)
        placement = Placement(tuple(G.rollout_nodes))
        G.add_job(job, placement)
        return Decision(G, placement, iso_delta, "isolated", lat)

    # ------------------------------------------------------------------
    def _gen_placements(self, G: CoExecutionGroup, job: RLJob):
        """Direct packing (Δ=0) and rollout scaling (Δ=new rollout nodes)."""
        k = job.n_roll_nodes
        if len(G.rollout_nodes) >= k:
            # pack onto the k least-loaded rollout nodes
            load = {nid: 0.0 for nid in G.rollout_nodes}
            for jid, pl in G.placements.items():
                for nid in pl.rollout_node_ids:
                    load[nid] += G.jobs[jid].t_roll
            chosen = tuple(sorted(load, key=load.get)[:k])
            yield Placement(chosen), 0, "pack"
        yield Placement(()), k, "scale_rollout"   # nodes allocated on commit

    def _evaluate(self, G: CoExecutionGroup, job: RLJob,
                  placement: Placement, n_new: int):
        """Hypothetically admit; returns (delta_cost, tiebreak) or None."""
        added = []
        if n_new:
            # simulate fresh rollout nodes without touching the allocator
            accel = self.alloc.rollout_accel
            from repro_torch.core.cluster import Node
            added = [Node(f"__tmp{i}", accel) for i in range(n_new)]
            for n in added:
                G.rollout_nodes[n.node_id] = n
            placement = Placement(tuple(n.node_id for n in added))
        try:
            if not G.fits_memory(job, placement):           # line 8
                return None
            G.add_job(job, placement)
            try:
                # Admitting may saturate the group slightly (Fig 10a packs
                # two identical jobs at load ~104% of cycle) but heavily
                # over-saturated placements are rejected (Fig 3 / Fig 6).
                if G.t_load() > self.overload_tolerance * G.t_cycle():
                    return None
                if self.slo_check and not G.slo_ok(
                        margin=self.admission_margin):      # line 10
                    return None
                delta = sum(n.price_per_hour for n in added)
                slack = G.t_load() / max(G.t_cycle(), 1e-9)
                return delta, slack
            finally:
                G.remove_job(job.job_id)
        finally:
            for n in added:
                G.rollout_nodes.pop(n.node_id, None)

    def _isolated_cost(self, job: RLJob) -> float:
        r = job.n_roll_nodes * self.alloc.rollout_accel.price_per_gpu_hour * 8
        t = job.n_train_nodes * self.alloc.train_accel.price_per_gpu_hour * 8
        return r + t

    def _new_group(self, job: RLJob) -> CoExecutionGroup:
        G = CoExecutionGroup(
            f"g{next(self._gid)}",
            self.alloc.alloc_rollout(job.n_roll_nodes),
            self.alloc.alloc_train(job.n_train_nodes))
        self.groups[G.gid] = G
        return G

    # ------------------------------------------------------------------
    def release(self, job_id: str) -> None:
        """Job departed: free nodes no longer pinned by anyone."""
        for gid, G in list(self.groups.items()):
            if job_id not in G.jobs:
                continue
            G.remove_job(job_id)
            if not G.jobs:
                self.alloc.release(list(G.rollout_nodes.values()))
                self.alloc.release(list(G.train_nodes.values()))
                del self.groups[gid]
            else:
                pinned = {nid for pl in G.placements.values()
                          for nid in pl.rollout_node_ids}
                loose = [n for nid, n in G.rollout_nodes.items()
                         if nid not in pinned]
                for n in loose:
                    del G.rollout_nodes[n.node_id]
                self.alloc.release(loose)
            return

    def total_cost_per_hour(self) -> float:
        return sum(G.cost_per_hour() for G in self.groups.values())

    # ------------------------------------------------------------------
    def slo_contract(self) -> dict[str, float]:
        """Export the per-job slowdown bounds admission has guaranteed:
        ``{job_id: bound}`` with ``bound = job.slo * admission_margin``
        (the margin the planner reserved for context-switch latency and
        stochastic draws is part of the promise, so the serving layer
        enforces the *tightened* bound too).

        This is the wire between planning and serving: the engine policy
        for a job's rollout traffic is
        ``SLOPolicy.from_contract(sched.slo_contract(), job_id)`` — the
        same bound ``slo_ok`` admitted against now orders and gates
        per-request admission inside the engine.
        """
        return {jid: G.slowdown_bound(jid, margin=self.admission_margin)
                for G in self.groups.values() for jid in G.jobs}
