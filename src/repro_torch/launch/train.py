"""End-to-end GRPO post-training driver on the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --steps 2 --batch 4 --group 4 --max-new 128 [--kv paged] \
        [--mux off|pipeline|coexec|stream]

``--arch`` takes every family the port serves: dense (internlm2-1.8b,
gemma3-4b, minitron-8b, qwen2.5-32b), vlm (qwen2-vl-7b, trained without
vision embeddings, as the JAX loop trains it), MoE (dbrx-132b,
deepseek-v2-236b with MLA), ssm (rwkv6-7b) and hybrid (zamba2-2.7b).  The
audio family (whisper-tiny) is refused by name: its forward needs frame
embeddings that the GRPO loop does not carry; it trains through
``rl.train_step.make_train_step`` on a batch with a ``frontend``.

Runs the synchronous on-policy loop the paper schedules: rollout (the
static ``generate`` batch by default, as in the JAX package, or with
``--rollout engine`` the continuous-batching engine) -> verifiable
reward -> GRPO advantages ->
training step (forward through the flash-attention kernel, backward,
AdamW) -> the trained weights serve the next rollout.  On the CUDA card at
the architecture's full width with random weights from ``--seed``;
``--reduced --device cpu`` runs the smoke-test variant on the CPU with the
kernels' plain versions.

``--mux`` picks the phase-multiplexing executor (``rl.coexec``,
``rl.stream``); on the card each executor thread runs its rollout and
training phases on CUDA streams of their own:

* ``off`` (default): rollout and training back-to-back, the
  standard-disaggregation baseline.
* ``pipeline``: the rollout of iteration ``k+1`` overlaps the training
  step of iteration ``k``; ``--mux-staleness`` bounds how many optimizer
  steps the rollout weights may lag (``0`` is bit-exact to ``off``).
* ``coexec``: ``--jobs`` jobs (job ``i`` uses ``seed + i``) round-robin
  over the shared rollout and train pools with warm-start switches from
  the host cache; each job's losses are bit-exact to running it alone.
* ``stream``: completed prompt groups flow to ``--reward-workers``
  verifiers and to the trainer (``--micro-groups`` per step; default one
  bit-exact full-batch step per iteration) while the engine still decodes
  the stragglers, behind the same staleness guard; ``--elastic`` retunes
  the reward permit pool between iterations from the runtime's
  telemetry.

``--carry`` (``--mux stream --rollout engine``) is partial-rollout
continuation: each weight sync is swapped into the live engine, whose
in-flight generations are suspended and resumed under the new weights.
``--prefix-share`` (``--rollout engine --kv paged``) serves each GRPO
group's duplicated prompt from one prefill through the radix tree.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.rl.coexec import (GRPOJob, MuxConfig, run_coexec,
                                   run_pipelined, run_sequential)
from repro_torch.rl.rewards import make_reward
from repro_torch.rl.stream import run_streaming
from repro_torch.serve.spec import RolloutSpec


def run_training(arch: str = "internlm2-1.8b", *, reduced: bool = False,
                 steps: int = 50, batch: int = 8, group: int = 4,
                 max_new: int = 8, lr: float = 3e-4, seed: int = 0,
                 log_every: int = 5, model=None, params=None,
                 rollout: str = "static", temperature: float = 1.0,
                 num_slots: int | None = None, engine_block_size: int = 1,
                 kv: str = "contiguous", kv_block_size: int = 16,
                 sched: str = "fifo", kv_dtype: str | None = None,
                 prefix_share: bool = False,
                 spec: RolloutSpec | None = None,
                 slo_bound: float = 2.0, mux: str = "off",
                 mux_staleness: int = 1, jobs: int = 2,
                 reward: str = "arith", reward_latency: float = 0.0,
                 reward_workers: int = 2, micro_groups: int | None = None,
                 elastic: bool = False, carry: bool = False,
                 reward_fn=None, device=None, return_report: bool = False):
    """GRPO post-training through the phase-multiplexed executors.

    ``model``/``params`` default to ``arch`` (full width unless
    ``reduced``) with random weights from ``seed`` on ``device`` (the CUDA
    card unless ``device="cpu"``); the sequential, pipelined and
    streaming executors train ``params`` in place.  ``reward_fn``, a
    row-wise verifier ``fn(completions, mask, answers) -> (B,) float32``,
    replaces the named ``reward``.  The engine rollout's shape is
    ``spec`` (a :class:`~repro_torch.serve.spec.RolloutSpec`), or the
    loose ``num_slots`` ... ``prefix_share`` arguments.  Returns
    ``(state, history)`` (for ``mux="coexec"`` dicts of them keyed by job
    id), plus the :class:`~repro_torch.rl.coexec.MuxReport` when
    ``return_report``."""
    cfg = MuxConfig(mode=mux, max_staleness=mux_staleness,
                    reward_workers=reward_workers, micro_groups=micro_groups)
    if carry and rollout != "engine":
        raise ValueError("--carry swaps weights into a live engine: it "
                         "needs --rollout engine")
    if cfg.mode == "coexec" and params is not None:
        raise ValueError("--mux coexec: each job starts from its own "
                         "seed's weights; params= names only one set")
    reward_fn = reward_fn or make_reward(reward, latency_s=reward_latency,
                                         seed=seed)
    if spec is None:
        spec = RolloutSpec(num_slots=num_slots, block_size=engine_block_size,
                           kv_layout=kv, kv_block_size=kv_block_size,
                           sched=sched, kv_dtype=kv_dtype,
                           prefix_share=prefix_share, carry=carry)

    def make_job(jid: str, job_seed: int, job_params=None) -> GRPOJob:
        return GRPOJob(
            jid, model=model, arch=arch, reduced=reduced, seed=job_seed,
            steps=steps, batch=batch, group=group, max_new=max_new, lr=lr,
            temperature=temperature, rollout=rollout, spec=spec,
            slo_bound=slo_bound, reward_fn=reward_fn, params=job_params,
            device=device, carry=carry)

    if cfg.mode == "off":
        out = run_sequential(make_job("job0", seed, params),
                             log_every=log_every)
    elif cfg.mode == "pipeline":
        out = run_pipelined(make_job("job0", seed, params),
                            max_staleness=cfg.max_staleness,
                            log_every=log_every)
    elif cfg.mode == "stream":
        out = run_streaming(make_job("job0", seed, params),
                            max_staleness=cfg.max_staleness,
                            reward_workers=cfg.reward_workers,
                            micro_groups=cfg.micro_groups,
                            log_every=log_every, elastic=elastic)
    else:                                   # "coexec"
        if jobs < 1:
            raise ValueError("coexec needs >= 1 jobs")
        out = run_coexec([make_job(f"job{i}", seed + i)
                          for i in range(jobs)],
                         host_cache_gb=cfg.host_cache_gb,
                         log_every=log_every)
    return out if return_report else out[:2]


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
                    default="static",
                    help="rollout backend: the static generate batch or "
                         "the continuous-batching engine")
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
    ap.add_argument("--prefix-share", action="store_true",
                    help="radix prompt-prefix KV sharing (--rollout engine "
                         "--kv paged): each GRPO group's duplicated prompt "
                         "prefills once, its full blocks pinned under every "
                         "member")
    ap.add_argument("--mux", choices=("off", "pipeline", "coexec", "stream"),
                    default="off",
                    help="phase multiplexing: 'off' runs rollout and "
                         "training back-to-back (baseline); 'pipeline' "
                         "overlaps next-iteration rollout with the current "
                         "training step behind the --mux-staleness guard; "
                         "'coexec' round-robins --jobs jobs over the shared "
                         "rollout/train pools with warm-start switches; "
                         "'stream' pipelines at prompt-group granularity "
                         "through the --reward-workers reward pool")
    ap.add_argument("--mux-staleness", type=int, default=1,
                    help="pipeline/stream modes: max optimizer iterations "
                         "the rollout weights may lag (0 = force sync; "
                         "bit-exact to --mux off but with no overlap)")
    ap.add_argument("--carry", action="store_true",
                    help="stream mode, engine rollout: partial-rollout "
                         "continuation (each weight sync is swapped into "
                         "the live engine; in-flight generations carry "
                         "over)")
    ap.add_argument("--jobs", type=int, default=2,
                    help="coexec mode: number of co-executing jobs "
                         "(job i uses seed+i)")
    ap.add_argument("--reward", default="arith",
                    choices=("arith", "length", "format", "composite"),
                    help="verifier (rl.rewards)")
    ap.add_argument("--reward-latency", type=float, default=0.0,
                    help="wrap the verifier in the slow external-verifier "
                         "stub with this mean latency (seconds); --mux "
                         "stream hides it on the reward pool")
    ap.add_argument("--reward-workers", type=int, default=2,
                    help="stream mode: reward permit-pool capacity "
                         "(concurrent verifier calls)")
    ap.add_argument("--micro-groups", type=int, default=None,
                    help="stream mode: rewarded groups per train "
                         "micro-step (default: all groups of an iteration "
                         "in one bit-exact full-batch step)")
    ap.add_argument("--elastic", action="store_true",
                    help="stream mode: retune the reward permit pool "
                         "between iterations from the runtime's telemetry "
                         "(grow toward --reward-workers while verifiers "
                         "queue, shrink while the pool idles)")
    args = ap.parse_args()
    t0 = time.time()
    _, hist, report = run_training(
        args.arch, reduced=args.reduced, steps=args.steps, batch=args.batch,
        group=args.group, max_new=args.max_new, lr=args.lr, seed=args.seed,
        rollout=args.rollout, temperature=args.temperature,
        spec=RolloutSpec.from_args(args), slo_bound=args.slo_bound,
        mux=args.mux, mux_staleness=args.mux_staleness, jobs=args.jobs,
        reward=args.reward, reward_latency=args.reward_latency,
        reward_workers=args.reward_workers, micro_groups=args.micro_groups,
        elastic=args.elastic, carry=args.carry, device=args.device,
        return_report=True)
    wall = time.time() - t0
    if args.mux == "coexec":
        finals = {jid: h[-1]["reward"] for jid, h in hist.items() if h}
        print(f"done in {wall:.1f}s; final rewards "
              + ", ".join(f"{j}={r:.3f}" for j, r in sorted(finals.items())))
    else:
        print(f"done in {wall:.1f}s; final reward {hist[-1]['reward']:.3f}")
    s = report.summary()
    reward_part = (f"reward busy {s['total_reward_s']:.2f}s, "
                   if s["total_reward_s"] else "")
    print(f"mux={report.mode}: rollout busy {s['total_rollout_s']:.2f}s, "
          f"train busy {s['total_train_s']:.2f}s, {reward_part}"
          f"overlap {s['overlap_s']:.2f}s "
          f"({s['reclaimed_bubble_frac']:.0%} of the back-to-back bubble "
          f"reclaimed)")


if __name__ == "__main__":
    _main()
