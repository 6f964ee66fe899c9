"""At-scale trace replay (paper §7.4) on the port's planner: 200
production-like RL jobs through RollMux vs Solo-D vs colocated veRL.

    PYTHONPATH=src python examples/torch/trace_replay.py [--jobs 200] \
        [--seed 1]

A host-only simulation (``repro_torch.core``): it runs no model and takes
no device.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.core import (ClusterSimulator,  # noqa: E402
                              InterGroupScheduler, NodeAllocator,
                              SoloDisaggregation, replay_verl)
from repro_torch.core.trace import production_replay_trace  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=200)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    jobs = production_replay_trace(n_jobs=args.jobs, seed=args.seed)
    print(f"replaying {len(jobs)} jobs "
          f"({sum(j.turns == 'multi' for j in jobs)} multi-turn)...")

    r = ClusterSimulator(InterGroupScheduler(NodeAllocator()), seed=1)\
        .run(list(jobs))
    s = ClusterSimulator(SoloDisaggregation(NodeAllocator()), seed=1)\
        .run(list(jobs))
    v = replay_verl(list(jobs), NodeAllocator())

    def row(name, rep, extra=""):
        print(f"{name:10s} ${rep.avg_cost_per_hour:7.1f}/h  "
              f"SLO {rep.slo_rate:6.1%}  peak GPUs R={rep.peak_rollout_gpus:3d} "
              f"T={rep.peak_train_gpus:3d}  bubbles R={rep.rollout_bubble:.2f} "
              f"T={rep.train_bubble:.2f} {extra}")

    row("RollMux", r)
    row("Solo-D", s, f"({s.avg_cost_per_hour/r.avg_cost_per_hour:.2f}x cost)")
    row("veRL", v, f"({v.avg_cost_per_hour/r.avg_cost_per_hour:.2f}x cost)")
    print(f"\npaper reference: RollMux 1.84x cheaper than Solo-D, "
          f"1.38x than veRL, 100% SLO")


if __name__ == "__main__":
    main()
