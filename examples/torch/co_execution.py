"""Co-execution demo on the PyTorch/CUDA port (paper Fig 1-bottom): two RL
jobs time-multiplex the rollout and training pools under the RollMux
phase-centric runtime (``repro_torch.core.RollMuxRuntime``), with
warm-start context switching through the host state cache.  Prints the
per-pool execution timeline and the bubble reclamation against running
the jobs back to back.

    PYTHONPATH=src python examples/torch/co_execution.py [--iters 4] \
        [--device cpu]

Each job is the reduced internlm2-1.8b: a static ``generate`` rollout,
the arithmetic reward, GRPO advantages, ``build_train_batch``, one
``make_train_step`` step, and the weight sync
(``sync_params_between_jobs``) into the job's rollout entry of the host
cache.  Runs on the CUDA card unless ``--device cpu``.
"""
import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core.phase_control import RollMuxRuntime  # noqa: E402
from repro_torch.data import ArithmeticTask  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.rl.coexec import build_train_batch  # noqa: E402
from repro_torch.rl.grpo import group_advantages  # noqa: E402
from repro_torch.rl.rewards import arithmetic_reward  # noqa: E402
from repro_torch.rl.rollout import SamplerConfig, generate  # noqa: E402
from repro_torch.rl.train_step import (init_train_state,  # noqa: E402
                                       make_train_step)
from repro_torch.sync import sync_params_between_jobs  # noqa: E402


def make_job(rt, jid, seed, iters, dev):
    model = build_model("internlm2-1.8b", reduced=True)
    task = ArithmeticTask(seed=seed)
    sampler = SamplerConfig(max_new_tokens=4, temperature=1.0)
    train_step = make_train_step(model, remat=False)

    def init():
        return init_train_state(model,
                                torch.Generator(device=dev).manual_seed(seed))

    def done():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    @rt.phase("rollout", name="roll",
              init_fn=lambda: {"params": init()["params"]})
    def roll(state, prompts, gen):
        out = generate(model, state["params"], prompts, sampler,
                       generator=gen)
        done()
        return state, out

    @rt.phase("train", name="train", init_fn=init)
    def train(state, batch):
        state, _ = train_step(state, batch)
        done()
        return state, state["params"]

    def loop():
        gen = torch.Generator(device=dev).manual_seed(seed)
        for _ in range(iters):
            b = task.sample_batch(4)
            prompts = np.repeat(b.prompts, 2, axis=0)
            out = roll(jid, prompts, gen)
            r = arithmetic_reward(out["completions"].cpu(),
                                  out["mask"].cpu(),
                                  [a for a in b.answers for _ in range(2)])
            tb = build_train_batch(out, group_advantages(r, 2),
                                   b.prompts.shape[1])
            new_params = train(jid, tb)
            # sync phase: updated weights -> rollout actor (host cache)
            rstate, _ = rt.cache.restore(f"{jid}/rollout")
            rstate["params"] = sync_params_between_jobs(new_params,
                                                        rstate["params"])
            rt.cache.offload(f"{jid}/rollout", rstate)
    return loop


def render_timeline(pool, width=78):
    """ASCII gantt of a pool's busy segments."""
    if not pool.timeline:
        return ""
    t_end = max(t1 for _, _, t1 in pool.timeline)
    line = ["."] * width
    for who, t0, t1 in pool.timeline:
        c = who[3]  # job index digit
        for i in range(int(t0 / t_end * (width - 1)),
                       max(int(t1 / t_end * (width - 1)), 1)):
            line[i] = c
    return "".join(line)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    # --- co-executed ---
    rt = RollMuxRuntime(host_cache_gb=4.0)
    rt.pool("rollout", 1)
    rt.pool("train", 1)
    loops = [make_job(rt, f"job{i}", i, args.iters, dev) for i in range(2)]
    t0 = time.perf_counter()
    ts = [threading.Thread(target=fn) for fn in loops]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    co_wall = time.perf_counter() - t0

    # --- sequential (solo) ---
    rt2 = RollMuxRuntime(host_cache_gb=4.0)
    rt2.pool("rollout", 1)
    rt2.pool("train", 1)
    t0 = time.perf_counter()
    for fn in [make_job(rt2, f"job{i}", i, args.iters, dev)
               for i in range(2)]:
        fn()
    seq_wall = time.perf_counter() - t0

    print("\nco-execution timeline (0/1 = job id, . = dependency bubble):")
    print(f"  rollout pool: {render_timeline(rt.pools['rollout'])}")
    print(f"  train pool:   {render_timeline(rt.pools['train'])}")
    for name, p in rt.pools.items():
        busy = p.busy_time
        total = max(t1 for _, _, t1 in p.timeline)
        print(f"  {name:8s} utilization: {busy/total:6.1%}")
    stats = rt.stats
    warm = sum(s.warm_starts for s in stats.values())
    cold = sum(s.cold_starts for s in stats.values())
    print(f"  context switches: {cold} cold (init), {warm} warm "
          f"(host-DRAM cache)")
    print(f"\nwall time: co-executed {co_wall:.2f}s vs sequential "
          f"{seq_wall:.2f}s on {dev}")


if __name__ == "__main__":
    main()
