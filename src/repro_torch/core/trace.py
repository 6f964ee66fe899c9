"""Workload/trace generation: paper Table 6 simulation profiles + a
Philly-like multi-tenant arrival trace (paper §7.5) + the two-week
production replay mix (§7.4).

Counterpart of ``repro/core/trace.py``: the same numpy draws from the same
seeds.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.configs.paper_jobs import MEM_FOOTPRINT_GB, SIM_PROFILES
from repro_torch.core.job import RLJob

_SIZES = {"S": (8, 8), "M": (8, 8), "L": (16, 16)}
_MEM = {"S": "7B", "M": "14B", "L": "32B"}


def make_sim_job(rng: np.random.Generator, job_id: str, *,
                 workload: str = "Mixed", slo: Optional[float] = None,
                 arrival: float = 0.0, duration: float = 3600.0) -> RLJob:
    """Sample one job from paper Table 6 (BL/RH/TH x S/M/L, Unif bounds)."""
    wl = workload if workload != "Mixed" else rng.choice(["BL", "RH", "TH"])
    size = rng.choice(["S", "M", "L"])
    (rl, rh), (tl, th) = SIM_PROFILES[wl][size]
    t_roll = float(rng.uniform(rl, rh))
    t_train = float(rng.uniform(tl, th))
    n_r, n_t = _SIZES[size]
    mem = MEM_FOOTPRINT_GB[_MEM[size]]
    return RLJob(
        job_id=job_id, t_roll=t_roll, t_train=t_train,
        n_roll_gpus=n_r, n_train_gpus=n_t,
        mem_roll_gb=mem["rollout"], mem_train_gb=mem["train"],
        slo=float(slo if slo is not None else rng.uniform(1.0, 2.0)),
        arrival=arrival, duration=duration,
        t80_frac=float(rng.uniform(0.45, 0.75)),
        model=f"{wl}-{size}", turns="multi" if wl == "RH" else "single")


def philly_like_trace(n_jobs: int = 300, horizon_h: float = 580.0, *,
                      mean_duration_h: float = 14.4,
                      max_duration_h: float = 142.9,
                      workload: str = "Mixed",
                      slo: Optional[float] = None,
                      seed: int = 0) -> list[RLJob]:
    """Arrival pattern modeled on the Microsoft Philly trace segment the
    paper uses (300 jobs / 580 h, mean 14.4 h, max 142.9 h)."""
    rng = np.random.default_rng(seed)
    arrivals = np.sort(rng.uniform(0, horizon_h * 3600.0, n_jobs))
    sigma = 1.1
    mu = np.log(mean_duration_h) - sigma ** 2 / 2
    durations = np.clip(rng.lognormal(mu, sigma, n_jobs), 0.2, max_duration_h)
    jobs = []
    for i in range(n_jobs):
        jobs.append(make_sim_job(
            rng, f"job{i}", workload=workload, slo=slo,
            arrival=float(arrivals[i]), duration=float(durations[i] * 3600.0)))
    return jobs


# The paper's Fig 2: production RL traffic concentrates on ~10 recurring
# workload types (model x dataset x interaction mode) with phase durations
# in the 50-900 s range and multi-turn rollouts 3-4x their training phases.
# (name, size, turns, t_roll, t_train, n_gpus)
PRODUCTION_JOB_TYPES = [
    ("math-7B[S]",   "7B",  "single", 180.0, 170.0, 8),
    ("math-14B[S]",  "14B", "single", 280.0, 255.0, 8),
    ("code-7B[S]",   "7B",  "single", 230.0, 190.0, 8),
    ("code-32B[S]",  "32B", "single", 430.0, 400.0, 16),
    ("rlhf-3B[S]",   "3B",  "single",  90.0, 110.0, 8),
    ("agent-8B[M]",  "8B",  "multi",  520.0, 200.0, 8),
    ("agent-14B[M]", "14B", "multi",  780.0, 230.0, 8),
    ("tool-8B[M]",   "8B",  "multi",  640.0, 170.0, 8),
    ("game-3B[M]",   "3B",  "multi",  350.0, 100.0, 8),
    ("swe-32B[M]",   "32B", "multi",  900.0, 260.0, 16),
]
_TYPE_POPULARITY = np.array([0.16, 0.12, 0.10, 0.06, 0.08,
                             0.14, 0.10, 0.10, 0.08, 0.06])


def production_replay_trace(n_jobs: int = 200, *, horizon_h: float = 336.0,
                            jitter: float = 0.10, seed: int = 1) -> list[RLJob]:
    """Two-week, 200-job production replay (paper §7.4): jobs drawn from the
    ~10 recurring workload types of Fig 2 (mean duration 27.9 h)."""
    rng = np.random.default_rng(seed)
    arrivals = np.sort(rng.uniform(0, horizon_h * 3600.0, n_jobs))
    sigma = 0.9
    mu = np.log(27.9) - sigma ** 2 / 2
    durations = np.clip(rng.lognormal(mu, sigma, n_jobs), 0.5, horizon_h)
    kinds = rng.choice(len(PRODUCTION_JOB_TYPES), n_jobs, p=_TYPE_POPULARITY)
    jobs = []
    for i, k in enumerate(kinds):
        name, size, turns, t_roll, t_train, n = PRODUCTION_JOB_TYPES[k]
        mem = MEM_FOOTPRINT_GB[size]
        jobs.append(RLJob(
            job_id=f"prod{i}",
            t_roll=float(t_roll * rng.uniform(1 - jitter, 1 + jitter)),
            t_train=float(t_train * rng.uniform(1 - jitter, 1 + jitter)),
            n_roll_gpus=n, n_train_gpus=n,
            mem_roll_gb=mem["rollout"], mem_train_gb=mem["train"],
            slo=float(rng.uniform(1.0, 2.0)),
            arrival=float(arrivals[i]), duration=float(durations[i] * 3600.0),
            t80_frac=float(rng.uniform(0.45, 0.7)),
            model=name, turns=turns))
    return jobs
