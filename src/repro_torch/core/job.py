"""RL post-training job model consumed by the RollMux schedulers.

Counterpart of ``repro/core/job.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.cluster import GPUS_PER_NODE


@dataclass
class RLJob:
    job_id: str
    # worst-case phase durations (conservative planning, paper §4.2):
    t_roll: float             # rollout phase on its rollout nodes (s)
    t_train: float            # training phase on its requested train nodes (s)
    # reward-verification phase on the reward pool (s); 0 models the
    # classic inline-verified loop (reward folded into training), > 0 the
    # streaming mux's third pool where external verifiers take real time
    t_reward: float = 0.0
    n_roll_gpus: int = 8
    n_train_gpus: int = 8
    mem_roll_gb: float = 275.0    # host footprint per rollout node (Table 2)
    mem_train_gb: float = 240.0
    slo: float = 2.0              # tolerated slowdown vs solo (paper: Unif(1,2))
    arrival: float = 0.0
    duration: float = 3600.0      # trace job lifetime (s)
    # runtime stochasticity: actual phase times = worst-case * Unif draw
    runtime_scale: tuple[float, float] = (0.5, 1.0)
    # long-tail rollout shape: fraction of phase at which 80% of responses done
    t80_frac: float = 0.6
    model: str = ""
    turns: str = "single"

    @property
    def t_solo(self) -> float:
        """Back-to-back solo iteration: rollout, then (when modeled)
        reward verification, then the train step."""
        return self.t_roll + self.t_reward + self.t_train

    @property
    def n_roll_nodes(self) -> int:
        return max(1, self.n_roll_gpus // GPUS_PER_NODE)

    @property
    def n_train_nodes(self) -> int:
        return max(1, self.n_train_gpus // GPUS_PER_NODE)

    def train_time_on(self, pool_nodes: int) -> float:
        """Paper footnote 2: DP degree adapts to the group train pool size."""
        return self.t_train * self.n_train_nodes / max(pool_nodes, 1)


def from_profile(profile, job_id: str, *, slo: float = 2.0, arrival=0.0,
                 duration=3600.0) -> RLJob:
    """Build an RLJob from a configs.paper_jobs.JobProfile."""
    return RLJob(
        job_id=job_id, t_roll=profile.t_roll, t_train=profile.t_train,
        n_roll_gpus=profile.n_roll_gpus, n_train_gpus=profile.n_train_gpus,
        mem_roll_gb=profile.mem_roll_gb, mem_train_gb=profile.mem_train_gb,
        slo=slo, arrival=arrival, duration=duration, model=profile.model,
        turns=profile.turns)
