"""Quickstart on the PyTorch/CUDA port: end-to-end synchronous on-policy RL
post-training of a small model on a verifiable arithmetic task (RLVR).

    PYTHONPATH=src python examples/torch/quickstart.py [--steps 150] \
        [--arch ID] [--device cpu]

The workload RollMux schedules: rollout -> verify/reward -> GRPO
advantages -> train -> weight sync, strictly on-policy, through
``repro_torch.launch.train.run_training`` on the reduced variant of the
architecture.  Runs on the CUDA card unless ``--device cpu``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro_torch.launch.train import run_training  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b",
                    help="any served arch id but whisper-tiny (the reduced "
                         "variant is used)")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--group", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=6)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    _, hist = run_training(args.arch, reduced=True, steps=args.steps,
                           batch=args.batch, group=args.group,
                           max_new=args.max_new, lr=args.lr, log_every=10,
                           device=args.device)
    n = min(10, len(hist))
    first = sum(h["reward"] for h in hist[:n]) / n
    last = sum(h["reward"] for h in hist[-n:]) / n
    print(f"\nreward: first-{n} avg {first:.3f} -> last-{n} avg {last:.3f}")


if __name__ == "__main__":
    main()
