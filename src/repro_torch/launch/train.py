"""End-to-end GRPO post-training driver on the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --steps 2 --batch 4 --group 4 --max-new 128 [--kv paged]

Runs the synchronous on-policy loop the paper schedules: rollout through
the continuous-batching engine -> verifiable reward -> GRPO advantages ->
training step (forward through the flash-attention kernel, backward,
AdamW) -> the trained weights serve the next rollout.  On the CUDA card at
the architecture's full width with random weights from ``--seed``;
``--reduced --device cpu`` runs the smoke-test variant on the CPU with the
kernels' plain versions.

Only ``--mux off`` (rollout and training back-to-back, the
standard-disaggregation baseline) is ported; the multiplexing executors
come with the mux slice (ROADMAP).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.rl.coexec import GRPOJob, MuxConfig, run_sequential
from repro_torch.rl.rewards import make_reward


def run_training(arch: str = "internlm2-1.8b", *, reduced: bool = False,
                 steps: int = 50, batch: int = 8, group: int = 4,
                 max_new: int = 8, lr: float = 3e-4, seed: int = 0,
                 log_every: int = 5, model=None, params=None,
                 rollout: str = "engine", temperature: float = 1.0,
                 num_slots: int | None = None, engine_block_size: int = 1,
                 kv: str = "contiguous", kv_block_size: int = 16,
                 sched: str = "fifo", kv_dtype: str | None = None,
                 slo_bound: float = 2.0, mux: str = "off",
                 reward: str = "arith", reward_latency: float = 0.0,
                 reward_fn=None, device=None, return_report: bool = False):
    """GRPO post-training with rollout and training back-to-back.

    ``model``/``params`` default to ``arch`` (full width unless
    ``reduced``) with random weights from ``seed`` on ``device`` (the CUDA
    card unless ``device="cpu"``).  ``reward_fn``, a row-wise verifier
    ``fn(completions, mask, answers) -> (B,) float32``, replaces the named
    ``reward``.  Returns ``(state, history)``, plus the
    :class:`~repro_torch.rl.coexec.MuxReport` when ``return_report``."""
    cfg = MuxConfig(mode=mux)
    if cfg.mode != "off":
        raise NotImplementedError(
            f"--mux {cfg.mode} is not ported yet: the multiplexing "
            f"executors (pipeline, coexec, stream) come with the mux slice "
            f"(ROADMAP)")
    job = GRPOJob(
        "job0", model=model, arch=arch, reduced=reduced, seed=seed,
        steps=steps, batch=batch, group=group, max_new=max_new, lr=lr,
        temperature=temperature, rollout=rollout, num_slots=num_slots,
        engine_block_size=engine_block_size, kv=kv,
        kv_block_size=kv_block_size, sched=sched, kv_dtype=kv_dtype,
        slo_bound=slo_bound,
        reward_fn=reward_fn or make_reward(reward, latency_s=reward_latency,
                                           seed=seed),
        params=params, device=device)
    state, hist, report = run_sequential(job, log_every=log_every)
    if return_report:
        return state, hist, report
    return state, hist


def _main():
    ap = argparse.ArgumentParser(
        description="GRPO post-training on the PyTorch/CUDA port",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-test variant (2 layers, fp32)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain versions)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--group", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="rollout sampling temperature (0 = greedy)")
    ap.add_argument("--rollout", choices=("static", "engine"),
                    default="engine",
                    help="rollout backend (only the continuous-batching "
                         "engine is ported)")
    ap.add_argument("--slots", type=int, default=None,
                    help="engine KV slots (default = batch * group)")
    ap.add_argument("--kv", choices=("contiguous", "paged"),
                    default="contiguous", help="engine KV layout")
    ap.add_argument("--kv-block-size", type=int, default=16)
    ap.add_argument("--kv-dtype", choices=("auto", "int8"), default=None,
                    help="engine paged KV storage dtype (--kv paged)")
    ap.add_argument("--sched", choices=("fifo", "deadline", "slo"),
                    default="fifo", help="engine admission policy")
    ap.add_argument("--slo-bound", type=float, default=2.0,
                    help="slowdown bound the slo policy enforces")
    ap.add_argument("--mux", choices=("off", "pipeline", "coexec", "stream"),
                    default="off",
                    help="phase multiplexing (only 'off' is ported)")
    ap.add_argument("--reward", default="arith",
                    choices=("arith", "length", "format", "composite"),
                    help="verifier (rl.rewards)")
    ap.add_argument("--reward-latency", type=float, default=0.0,
                    help="wrap the verifier in the slow external-verifier "
                         "stub with this mean latency (seconds)")
    args = ap.parse_args()
    t0 = time.time()
    _, hist, report = run_training(
        args.arch, reduced=args.reduced, steps=args.steps, batch=args.batch,
        group=args.group, max_new=args.max_new, lr=args.lr, seed=args.seed,
        rollout=args.rollout, temperature=args.temperature,
        num_slots=args.slots, kv=args.kv, kv_block_size=args.kv_block_size,
        sched=args.sched, kv_dtype=args.kv_dtype, slo_bound=args.slo_bound,
        mux=args.mux, reward=args.reward,
        reward_latency=args.reward_latency, device=args.device,
        return_report=True)
    wall = time.time() - t0
    print(f"done in {wall:.1f}s; final reward {hist[-1]['reward']:.3f}")
    s = report.summary()
    print(f"mux={report.mode}: rollout busy {s['total_rollout_s']:.2f}s, "
          f"train busy {s['total_train_s']:.2f}s, "
          f"overlap {s['overlap_s']:.2f}s "
          f"({s['reclaimed_bubble_frac']:.0%} of the back-to-back bubble "
          f"reclaimed)")


if __name__ == "__main__":
    _main()
