"""Paper Table 3 / Table 6 job profiles for the scheduler experiments.

These are *workload profiles* (phase durations, memory footprints, GPU
counts), not model-zoo configs — they feed the RollMux scheduler and the
discrete-event simulator exactly as the paper's profiler output would.

Durations are the paper's own published characteristics:
  * Table 2 memory footprints (GB per 8-GPU node),
  * Table 3 micro-benchmark job types (A-E),
  * Table 6 simulation profiles (BL/RH/TH x S/M/L, Unif bounds).

Counterpart of ``repro/configs/paper_jobs.py``.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class JobProfile:
    name: str
    model: str
    turns: str              # "single" | "multi"
    t_roll: float           # rollout phase duration (s), worst-case estimate
    t_train: float          # training phase duration (s), worst-case estimate
    mem_roll_gb: float      # host-memory footprint of rollout actor (8-GPU node)
    mem_train_gb: float     # host-memory footprint of training actor
    n_roll_gpus: int
    n_train_gpus: int
    max_new_tokens: int = 8192


# Paper Table 2 (GB per 8-GPU node)
MEM_FOOTPRINT_GB = {
    "3B":  {"rollout": 113.4, "train": 156.2},
    "7B":  {"rollout": 275.7, "train": 240.0},
    "8B":  {"rollout": 290.0, "train": 260.0},   # interpolated
    "14B": {"rollout": 445.4, "train": 456.1},
    "32B": {"rollout": 490.3, "train": 520.4},
}

# Paper Table 3 micro-benchmark job types. Phase durations follow Fig 2's
# 50-900s range with the stated skews (Type-D: T_roll ~ 2.5 T_train,
# Type-E: T_roll ~ 6 T_train).
TYPE_A = JobProfile("Type-A", "Qwen2.5-7B",  "single", 170.0, 185.0,
                    MEM_FOOTPRINT_GB["7B"]["rollout"], MEM_FOOTPRINT_GB["7B"]["train"], 8, 8)
TYPE_B = JobProfile("Type-B", "Qwen2.5-14B", "single", 250.0, 265.0,
                    MEM_FOOTPRINT_GB["14B"]["rollout"], MEM_FOOTPRINT_GB["14B"]["train"], 8, 8)
TYPE_C = JobProfile("Type-C", "Qwen2.5-32B", "single", 320.0, 500.0,
                    MEM_FOOTPRINT_GB["32B"]["rollout"], MEM_FOOTPRINT_GB["32B"]["train"], 16, 16)
TYPE_D = JobProfile("Type-D", "Qwen3-8B",    "multi",  500.0, 200.0,
                    MEM_FOOTPRINT_GB["8B"]["rollout"], MEM_FOOTPRINT_GB["8B"]["train"], 8, 8)
TYPE_E = JobProfile("Type-E", "Qwen3-14B",   "multi",  900.0, 150.0,
                    MEM_FOOTPRINT_GB["14B"]["rollout"], MEM_FOOTPRINT_GB["14B"]["train"], 8, 8,
                    max_new_tokens=16384)

PAPER_JOB_TYPES = {j.name: j for j in (TYPE_A, TYPE_B, TYPE_C, TYPE_D, TYPE_E)}

# Paper Table 6: simulation profiles — (lo, hi) of Unif for (t_roll, t_train).
SIM_PROFILES: dict[str, dict[str, tuple[tuple[float, float], tuple[float, float]]]] = {
    "BL": {"S": ((50, 100), (50, 100)),
           "M": ((100, 200), (100, 200)),
           "L": ((200, 300), (200, 300))},
    "RH": {"S": ((100, 200), (25, 50)),
           "M": ((200, 400), (50, 100)),
           "L": ((400, 600), (100, 200))},
    "TH": {"S": ((25, 50), (100, 200)),
           "M": ((50, 100), (200, 400)),
           "L": ((100, 200), (400, 600))},
}
