"""Co-execution group (paper §4.1) + the intra-group round-robin schedule
(§4.3) as a discrete-event simulation.

The DES is used three ways:
  * admission control — worst-case durations, migration off (conservative);
  * at-scale trace replay — stochastic durations, migration on;
  * Theorem 1 checking — comparing round-robin against perturbed schedules.

Counterpart of ``repro/core/group.py``.  Per-job draws come from ``zlib``
and numpy seed sequences exactly as there, so both copies simulate the
same numbers.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.cluster import Node
from repro_torch.core.job import RLJob

TRAIN_POOL = "__train__"
REWARD_POOL = "__reward__"


@dataclass(frozen=True)
class Placement:
    rollout_node_ids: tuple[str, ...]


@dataclass
class SimResult:
    iter_time: dict[str, float]          # steady-state per-job iteration time
    rollout_util: float                  # busy fraction of rollout nodes
    train_util: float
    rollout_bubble: float                # idle fraction (dependency bubbles)
    train_bubble: float
    makespan: float


@dataclass
class SwitchCosts:
    """Context-switch latencies (paper Fig 4). Warm = host-DRAM reload;
    cold = cross-cluster fetch / re-init."""
    warm_s: float = 1.6
    cold_s: float = 75.0


class CoExecutionGroup:
    def __init__(self, gid: str, rollout_nodes: list[Node],
                 train_nodes: list[Node]):
        self.gid = gid
        self.rollout_nodes: dict[str, Node] = {n.node_id: n for n in rollout_nodes}
        self.train_nodes: dict[str, Node] = {n.node_id: n for n in train_nodes}
        self.jobs: dict[str, RLJob] = {}
        self.placements: dict[str, Placement] = {}

    # ---- bookkeeping ---------------------------------------------------
    def add_job(self, job: RLJob, placement: Placement) -> None:
        self.jobs[job.job_id] = job
        self.placements[job.job_id] = placement

    def remove_job(self, job_id: str) -> None:
        self.jobs.pop(job_id, None)
        self.placements.pop(job_id, None)

    def cost_per_hour(self) -> float:
        return (sum(n.price_per_hour for n in self.rollout_nodes.values())
                + sum(n.price_per_hour for n in self.train_nodes.values()))

    # ---- saturation math (paper §4.2, Algorithm 1 line 4) ----------------
    def t_cycle(self) -> float:
        return max((j.t_solo for j in self.jobs.values()), default=0.0)

    def t_load(self) -> float:
        if not self.jobs:
            return 0.0
        pool = len(self.train_nodes)
        train_load = sum(j.train_time_on(pool) for j in self.jobs.values())
        node_load: dict[str, float] = {nid: 0.0 for nid in self.rollout_nodes}
        for jid, pl in self.placements.items():
            for nid in pl.rollout_node_ids:
                node_load[nid] += self.jobs[jid].t_roll
        roll_load = max(node_load.values(), default=0.0)
        return max(train_load, roll_load)

    def saturated(self) -> bool:
        return bool(self.jobs) and self.t_load() >= self.t_cycle()

    # ---- host-memory residency (paper C3) --------------------------------
    def node_mem_used(self) -> dict[str, float]:
        used = {nid: 0.0 for nid in (*self.rollout_nodes, *self.train_nodes)}
        for jid, pl in self.placements.items():
            j = self.jobs[jid]
            for nid in pl.rollout_node_ids:
                used[nid] += j.mem_roll_gb
            for nid in self.train_nodes:
                used[nid] += j.mem_train_gb
        return used

    def fits_memory(self, job: RLJob, placement: Placement) -> bool:
        used = self.node_mem_used()
        for nid in placement.rollout_node_ids:
            if used.get(nid, 0.0) + job.mem_roll_gb > self.rollout_nodes[nid].host_mem_gb:
                return False
        for nid, node in self.train_nodes.items():
            if used.get(nid, 0.0) + job.mem_train_gb > node.host_mem_gb:
                return False
        return True

    # ---- intra-group DES (paper §4.3) -------------------------------------
    def simulate(self, *, n_cycles: int = 14, discard: int = 4,
                 migration: bool = False, migration_overhead_frac: float = 0.02,
                 stochastic: bool = False, seed_salt: int = 0,
                 rng: Optional[np.random.Generator] = None,
                 switch: Optional[SwitchCosts] = None,
                 order: Optional[list[str]] = None,
                 extra_phases: Optional[dict[str, int]] = None,
                 job_atomic: bool = False,
                 work_conserving: bool = False) -> SimResult:
        """Intra-group schedule DES, two modes:

        * strict round-robin meta-iteration (default) — the paper's §4.3
          abstraction and Theorem 1 setting. Start times are max-plus
          recurrences, monotone in durations, so worst-case admission
          bounds runtime (no non-preemptive scheduling anomalies). Used
          for admission control and the theory checker.
        * ``work_conserving=True`` — the paper's §5.1 runtime hooks: a
          phase is enqueued the moment its predecessor finishes and each
          resource serves the earliest-startable request (FIFO). Short
          jobs iterate faster than the meta-iteration bound; this is what
          the execution plane actually does and what the replay uses.

        ``rng=None`` -> deterministic worst-case durations (admission mode).
        ``extra_phases`` repeats a job's phases k extra times per cycle —
        only used by the Theorem 1 checker to show repetition is suboptimal.
        ``job_atomic`` models job-granular schedulers (Gavel+): the rollout
        and training phases run as one block holding both pools.
        """
        if not self.jobs:
            return SimResult({}, 0.0, 0.0, 1.0, 1.0, 0.0)
        jids = order or list(self.jobs)
        free: dict[str, float] = {nid: 0.0 for nid in self.rollout_nodes}
        free[TRAIN_POOL] = 0.0
        # third pool: reward verification (paper's streaming mux).  Jobs
        # with t_reward == 0 never touch it, so classic two-pool groups
        # simulate exactly as before.
        free[REWARD_POOL] = 0.0
        last_user: dict[str, Optional[str]] = {k: None for k in free}
        resident: set[tuple[str, str]] = set()
        pool = len(self.train_nodes)

        reps = {j: 1 + (extra_phases or {}).get(j, 0) for j in jids}
        ready = {j: 0.0 for j in jids}
        completions: dict[str, list[float]] = {j: [] for j in jids}
        busy = {k: 0.0 for k in free}

        def draw(jid: str) -> float:
            """Runtime-duration scale. Stochastic mode draws ONE static scale
            per job (common random numbers: identical whether the job is
            simulated solo or in any group), matching the paper's simulation
            setup (Table 6 durations are per-job draws); the admission
            planner's worst-case bound (scale=1) then provably covers it.
            Intra-phase straggler stochasticity is modeled separately via
            t80_frac (long-tail migration)."""
            job = self.jobs[jid]
            if rng is not None:
                lo, hi = job.runtime_scale
                return float(rng.uniform(lo, hi))
            if not stochastic:
                return 1.0
            ss = np.random.SeedSequence(
                [zlib.crc32(jid.encode()) & 0x7FFFFFFF, seed_salt])
            lo, hi = job.runtime_scale
            return float(np.random.default_rng(ss).uniform(lo, hi))

        # Strict cyclic round-robin (the paper's meta-iteration): every
        # resource serves phases in a FIXED (cycle, rr-order) sequence.
        # Start times are then max-plus recurrences, monotone in phase
        # durations — runtime draws <= the worst-case bound can never
        # reorder the schedule, which is what makes conservative admission
        # a real guarantee (no non-preemptive scheduling anomalies).
        def switch_cost(j, nodes) -> float:
            if switch is None:
                return 0.0
            sw = 0.0
            for n in nodes:
                if last_user[n] not in (None, j):
                    sw = max(sw, switch.warm_s if (j, n) in resident
                             else switch.cold_s)
            return sw

        def run_phase(j, kind, scale):
            """Execute one phase for job j at the earliest start; returns end."""
            job = self.jobs[j]
            if job_atomic:
                nodes = (*self.placements[j].rollout_node_ids, TRAIN_POOL)
                dur = (job.t_roll + job.t_reward
                       + job.train_time_on(pool)) * scale
                occupy = dur
            elif kind == "roll":
                nodes = self.placements[j].rollout_node_ids
                dur = job.t_roll * scale
                occupy = (dur * job.t80_frac + dur * migration_overhead_frac
                          if migration else dur)
            elif kind == "reward":
                nodes = (REWARD_POOL,)
                dur = job.t_reward * scale
                occupy = dur
            else:
                nodes = (TRAIN_POOL,)
                dur = job.train_time_on(pool) * scale
                occupy = dur
            start = max(ready[j], max(free[n] for n in nodes))
            sw = switch_cost(j, nodes)
            for n in nodes:
                free[n] = start + sw + occupy
                busy[n] += sw + occupy
                last_user[n] = j
                resident.add((j, n))
            ready[j] = start + sw + dur
            return ready[j]

        if work_conserving:
            # greedy FIFO: at each step dispatch the earliest-startable phase
            todo = {j: n_cycles * reps[j] for j in jids}
            phase = {j: "roll" for j in jids}
            t_end = 0.0
            while any(v > 0 for v in todo.values()):
                best, best_key = None, None
                for j in jids:
                    if todo[j] <= 0:
                        continue
                    if job_atomic:
                        nodes = (*self.placements[j].rollout_node_ids,
                                 TRAIN_POOL)
                    elif phase[j] == "roll":
                        nodes = self.placements[j].rollout_node_ids
                    elif phase[j] == "reward":
                        nodes = (REWARD_POOL,)
                    else:
                        nodes = (TRAIN_POOL,)
                    start = max(ready[j], max(free[n] for n in nodes))
                    key = (start, ready[j])
                    if best_key is None or key < best_key:
                        best, best_key = j, key
                j = best
                end = run_phase(j, phase[j], draw(j))
                if job_atomic or phase[j] == "train":
                    todo[j] -= 1
                    completions[j].append(end)
                    phase[j] = "roll"
                elif phase[j] == "roll" and self.jobs[j].t_reward > 0:
                    phase[j] = "reward"
                else:
                    phase[j] = "train"
                t_end = max(t_end, end)
            return self._summarize(jids, reps, completions, busy, t_end,
                                   discard)

        t_end = 0.0
        for cycle in range(n_cycles):
            for j in jids:
                job = self.jobs[j]
                for _ in range(reps[j]):
                    scale = draw(j)
                    if job_atomic:
                        nodes = (*self.placements[j].rollout_node_ids,
                                 TRAIN_POOL)
                        start = max(ready[j], max(free[n] for n in nodes))
                        sw = switch_cost(j, nodes)
                        dur = (job.t_roll + job.t_reward
                               + job.train_time_on(pool)) * scale
                        for n in nodes:
                            free[n] = start + sw + dur
                            busy[n] += sw + dur
                            last_user[n] = j
                            resident.add((j, n))
                        ready[j] = start + sw + dur
                        completions[j].append(ready[j])
                        t_end = max(t_end, ready[j])
                        continue
                    # rollout phase
                    nodes = self.placements[j].rollout_node_ids
                    start = max(ready[j], max(free[n] for n in nodes))
                    sw = switch_cost(j, nodes)
                    dur = job.t_roll * scale
                    occupy = dur
                    if migration:
                        occupy = (dur * job.t80_frac
                                  + dur * migration_overhead_frac)
                    for n in nodes:
                        free[n] = start + sw + occupy
                        busy[n] += sw + occupy
                        last_user[n] = j
                        resident.add((j, n))
                    ready[j] = start + sw + dur
                    # reward-verification phase (third pool; skipped when
                    # the job's verifier is modeled as inline/free)
                    if job.t_reward > 0:
                        start = max(ready[j], free[REWARD_POOL])
                        sw = switch_cost(j, (REWARD_POOL,))
                        dur = job.t_reward * scale
                        free[REWARD_POOL] = start + sw + dur
                        busy[REWARD_POOL] += sw + dur
                        last_user[REWARD_POOL] = j
                        resident.add((j, REWARD_POOL))
                        ready[j] = start + sw + dur
                    # training phase
                    start = max(ready[j], free[TRAIN_POOL])
                    sw = switch_cost(j, (TRAIN_POOL,))
                    dur = job.train_time_on(pool) * scale
                    free[TRAIN_POOL] = start + sw + dur
                    busy[TRAIN_POOL] += sw + dur
                    last_user[TRAIN_POOL] = j
                    resident.add((j, TRAIN_POOL))
                    ready[j] = start + sw + dur
                    completions[j].append(ready[j])
                    t_end = max(t_end, ready[j])

        return self._summarize(jids, reps, completions, busy, t_end, discard)

    def _summarize(self, jids, reps, completions, busy, t_end,
                   discard) -> SimResult:
        iter_time = {}
        for j in jids:
            cs = completions[j][discard * reps[j]:]
            if len(cs) >= 2:
                iter_time[j] = (cs[-1] - cs[0]) / (len(cs) - 1) * reps[j]
            else:
                iter_time[j] = self.jobs[j].t_solo
        roll_busy = sum(busy[n] for n in self.rollout_nodes)
        roll_total = max(t_end, 1e-9) * max(len(self.rollout_nodes), 1)
        train_busy = busy[TRAIN_POOL]
        return SimResult(
            iter_time=iter_time,
            rollout_util=roll_busy / roll_total,
            train_util=train_busy / max(t_end, 1e-9),
            rollout_bubble=1.0 - roll_busy / roll_total,
            train_bubble=1.0 - train_busy / max(t_end, 1e-9),
            makespan=t_end)

    # ---- SLO check used by the inter-group scheduler ----------------------
    def slo_ok(self, *, n_cycles: int = 14, margin: float = 1.0) -> bool:
        """Conservative admission: worst-case durations, migration off.
        ``margin`` < 1 tightens the target to absorb runtime stochasticity
        (straggler draws of co-members) and context-switch latency."""
        res = self.simulate(n_cycles=n_cycles)
        return all(res.iter_time[j] <= self.jobs[j].slo * margin
                   * self.jobs[j].t_solo + 1e-6 for j in self.jobs)

    # ---- the contract the serving layer enforces --------------------------
    def slowdown_bound(self, job_id: Optional[str] = None,
                       *, margin: float = 1.0) -> float:
        """The slowdown this group's admission *guaranteed* a job: worst-case
        iteration time stays within ``slowdown_bound * t_solo`` (that is
        what :meth:`slo_ok` checked before the job was admitted).

        This is the number the serving engine's ``SLOPolicy`` consumes
        (``repro_torch.serve.sched``): per-request deadlines of
        ``arrival + bound * est_solo_latency`` turn the planner's per-job
        promise into an admission rule the rollout engine enforces under
        contention.  Without ``job_id`` the group's *tightest* bound is
        returned — the constraint every co-executed request must respect
        for no co-member's promise to break.
        """
        if job_id is not None:
            return self.jobs[job_id].slo * margin
        return min((j.slo for j in self.jobs.values()), default=1.0) * margin
