"""Cluster-level discrete-event simulator: replays an arrival trace through a
scheduler, accounting provisioning cost, GPU usage, and SLO attainment
(paper §7.4 testbed replay + §7.5 simulations).

Counterpart of ``repro/core/simulator.py``.  :func:`simulate_profiles` takes
the :class:`~repro_torch.core.phase_control.PhaseProfile` records a mux run
measured on the card (``MuxReport.profiles``).
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.cluster import GPUS_PER_NODE, Node, NodeAllocator
from repro_torch.core.group import CoExecutionGroup, Placement, SwitchCosts
from repro_torch.core.job import RLJob


@dataclass
class Report:
    total_cost: float                    # $ integrated over the replay
    avg_cost_per_hour: float
    makespan_h: float
    slo_attained: int
    n_jobs: int
    peak_rollout_gpus: int
    peak_train_gpus: int
    rollout_bubble: float                # time-weighted avg idle fraction
    train_bubble: float
    per_job_slowdown: dict[str, float] = field(default_factory=dict)

    @property
    def slo_rate(self) -> float:
        return self.slo_attained / max(self.n_jobs, 1)


class ClusterSimulator:
    """Replays jobs through any group-based scheduler
    (InterGroupScheduler / SoloDisaggregation / Random / Greedy / Gavel+)."""

    def __init__(self, scheduler, *, migration: bool = True,
                 switch: Optional[SwitchCosts] = SwitchCosts(), seed: int = 0):
        self.sched = scheduler
        self.migration = migration
        self.switch = switch
        self.rng = np.random.default_rng(seed)

    def _group_of(self, jid: str):
        for G in self.sched.groups.values():
            if jid in G.jobs:
                return G
        return None

    def run(self, jobs: list[RLJob]) -> Report:
        jobs = sorted(jobs, key=lambda j: j.arrival)
        jmap = {j.job_id: j for j in jobs}
        atomic = getattr(self.sched, "job_atomic", False)

        seq = [0]

        def nseq() -> int:
            seq[0] += 1
            return seq[0]

        events: list[tuple[float, int, str, str]] = []
        for j in jobs:
            heapq.heappush(events, (j.arrival, nseq(), "arrive", j.job_id))

        iters_total: dict[str, float] = {}
        iters_done: dict[str, float] = {}
        rate: dict[str, float] = {}
        active_time: dict[str, float] = {}
        bubbles: dict[str, tuple[float, float]] = {}   # gid -> (roll, train)
        solo_rate_cache: dict[str, float] = {}

        def solo_rate(job: RLJob) -> float:
            """Realized solo iteration time with the job's own (common-random-
            number) duration draws — the SLO reference."""
            if job.job_id not in solo_rate_cache:
                nr = [Node(f"__sr{i}", self.sched.alloc.rollout_accel)
                      for i in range(job.n_roll_nodes)]
                nt = [Node(f"__st{i}", self.sched.alloc.train_accel)
                      for i in range(job.n_train_nodes)]
                G = CoExecutionGroup("__solo", nr, nt)
                G.add_job(job, Placement(tuple(n.node_id for n in nr)))
                res = G.simulate(stochastic=True, migration=self.migration,
                                 switch=self.switch, work_conserving=True)
                solo_rate_cache[job.job_id] = res.iter_time[job.job_id]
            return solo_rate_cache[job.job_id]

        now = 0.0
        cost = 0.0
        broll_int = btrain_int = nroll_int = ntrain_int = 0.0
        slo_ok: dict[str, bool] = {}
        slowdown: dict[str, float] = {}

        def advance(to: float) -> None:
            nonlocal now, cost, broll_int, btrain_int, nroll_int, ntrain_int
            dt = to - now
            if dt <= 0:
                now = max(now, to)
                return
            cost += self.sched.total_cost_per_hour() * dt / 3600.0
            for G in self.sched.groups.values():
                nroll_int += len(G.rollout_nodes) * dt
                ntrain_int += len(G.train_nodes) * dt
                br, bt = bubbles.get(G.gid, (1.0, 1.0))
                broll_int += br * len(G.rollout_nodes) * dt
                btrain_int += bt * len(G.train_nodes) * dt
            for jid, r in rate.items():
                iters_done[jid] += dt / r
                active_time[jid] += dt
            now = to

        def refresh(G) -> None:
            res = G.simulate(migration=self.migration, switch=self.switch,
                             stochastic=True, job_atomic=atomic,
                             work_conserving=True)
            bubbles[G.gid] = (res.rollout_bubble, res.train_bubble)
            for jid, r in res.iter_time.items():
                rate[jid] = max(r, 1e-6)

        def push_finish(jid: str) -> None:
            rem = (iters_total[jid] - iters_done[jid]) * rate[jid]
            heapq.heappush(events, (now + max(rem, 0.0), nseq(), "finish", jid))

        while events:
            t, _, kind, jid = heapq.heappop(events)
            advance(t)
            if kind == "arrive":
                job = jmap[jid]
                self.sched.schedule(job)
                iters_total[jid] = job.duration / max(solo_rate(job), 1e-6)
                iters_done[jid] = 0.0
                active_time[jid] = 0.0
                G = self._group_of(jid)
                refresh(G)
                for member in G.jobs:
                    push_finish(member)
            else:
                if jid not in rate:
                    continue
                if iters_done[jid] < iters_total[jid] - 1e-6:
                    push_finish(jid)     # stale prediction (rates changed)
                    continue
                job = jmap[jid]
                realized = active_time[jid] / max(iters_done[jid], 1e-9)
                # SLO contract is against the *estimated* solo iteration time
                # (paper §4.2: "T_solo is the estimated iteration time when
                # job k is running alone"), i.e. the worst-case bound used
                # at admission.
                slowdown[jid] = realized / max(job.t_solo, 1e-9)
                slo_ok[jid] = slowdown[jid] <= job.slo * 1.001
                G = self._group_of(jid)
                rate.pop(jid, None)
                self.sched.release(jid)
                if G is not None and G.jobs:
                    refresh(G)
                    for member in G.jobs:
                        push_finish(member)

        makespan_h = now / 3600.0
        return Report(
            total_cost=cost,
            avg_cost_per_hour=cost / max(makespan_h, 1e-9),
            makespan_h=makespan_h,
            slo_attained=sum(slo_ok.values()),
            n_jobs=len(jobs),
            peak_rollout_gpus=self.sched.alloc.peak_rollout * GPUS_PER_NODE,
            peak_train_gpus=self.sched.alloc.peak_train * GPUS_PER_NODE,
            rollout_bubble=broll_int / max(nroll_int, 1e-9),
            train_bubble=btrain_int / max(ntrain_int, 1e-9),
            per_job_slowdown=slowdown)


def group_from_profiles(profiles, *, gid: str = "measured",
                        rollout_nodes: int = 1, train_nodes: int = 1,
                        accel=None, **job_overrides) -> CoExecutionGroup:
    """Build a co-execution group whose job durations are *engine-measured*
    :class:`~repro_torch.core.phase_control.PhaseProfile` records instead of
    modeled worst cases — the feedback path from the execution plane
    (``rl.coexec`` / ``launch.train --mux``) into the planner.

    ``profiles`` is an iterable of PhaseProfiles (e.g. the dict values from
    ``RollMuxRuntime.phase_profiles()``).  All jobs share one rollout
    placement, matching the in-process runtime's single rollout pool.
    """
    from repro_torch.core.cluster import H20, H800

    roll = [Node(f"{gid}-r{i}", accel or H20) for i in range(rollout_nodes)]
    train = [Node(f"{gid}-t{i}", accel or H800) for i in range(train_nodes)]
    G = CoExecutionGroup(gid, roll, train)
    placement = Placement(tuple(n.node_id for n in roll))
    for prof in profiles:
        G.add_job(prof.to_job(**job_overrides), placement)
    return G


def simulate_profiles(profiles, *, work_conserving: bool = True,
                      switch: Optional[SwitchCosts] = None, **group_kw):
    """Run the intra-group DES on measured phase profiles; returns the
    ``SimResult`` whose iter_time / bubble fractions reflect served
    durations.  This is what closes the loop: decisions the simulator
    makes (admission, grouping) can now be checked against — and driven
    by — what the engine actually measured."""
    G = group_from_profiles(profiles, **group_kw)
    return G.simulate(work_conserving=work_conserving, switch=switch)


def replay_verl(jobs: list[RLJob], alloc: NodeAllocator) -> Report:
    """Analytic replay of the colocated veRL baseline: every job runs all
    phases on its own training-pool nodes; rollout pays the HBM-bandwidth
    slowdown of compute GPUs; no rollout pool is billed."""
    slowdown_bw = alloc.rollout_accel.hbm_tbps / alloc.train_accel.hbm_tbps
    t_price = alloc.train_accel.price_per_gpu_hour
    cost = 0.0
    peak_t: list[tuple[float, int]] = []
    slo_ok = 0
    end = 0.0
    for j in jobs:
        iter_co = j.t_roll * slowdown_bw + j.t_train
        life = j.duration * iter_co / j.t_solo
        cost += j.n_train_gpus * t_price * life / 3600.0
        peak_t.append((j.arrival, j.n_train_gpus))
        peak_t.append((j.arrival + life, -j.n_train_gpus))
        slo_ok += iter_co <= j.slo * j.t_solo * 1.001
        end = max(end, j.arrival + life)
    peak = cur = 0
    for _, d in sorted(peak_t):
        cur += d
        peak = max(peak, cur)
    makespan_h = end / 3600.0
    # dependency bubble on the (joint) pool: rollout's compute units idle
    # during memory-bound rollout is a hardware mismatch, not idleness; we
    # report the training-FLOP idle share during rollout as the bubble.
    roll_frac = float(np.mean([j.t_roll * slowdown_bw /
                               (j.t_roll * slowdown_bw + j.t_train)
                               for j in jobs]))
    return Report(
        total_cost=cost, avg_cost_per_hour=cost / max(makespan_h, 1e-9),
        makespan_h=makespan_h, slo_attained=slo_ok, n_jobs=len(jobs),
        peak_rollout_gpus=0, peak_train_gpus=peak,
        rollout_bubble=0.0, train_bubble=roll_frac)
