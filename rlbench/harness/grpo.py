"""The GRPO cells: jobs of the program's ``GRPOJob`` driven through its
executors (``run_coexec`` or ``run_sequential``), timed over whole
iterations, checked against the plain reference.

One executor call runs every iteration of a run.  Its first ``steps``
iterations (the cell's ``check.steps``) are set-up: they compile and
capture, and the reference follows them afterwards.  The window is the
next ``window_iterations`` iterations of every job (the cell file's count
at the manifest's ``run_seconds``, scaled to a run of other ``seconds``,
at least one), from the start of the first one's rollout phase to the end
of the last one's train phase, read from the runtime's pool timelines.
The model is the configuration file's: the program's is held against it
before anything runs (``config.check_model``), and the weights both sides
get are shaped by the file.  The job is one object
from its seed to the window's end: the harness only observes it, through
a subclass that times each phase and records what the check needs.
"""
from __future__ import annotations

import contextlib
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from rlbench.harness import check
from rlbench.harness.config import check_model, file_abstract
from rlbench.harness.stats import reclaimed_bubble_frac
from rlbench.harness.trace import Tracer, kernel_seconds
from rlbench.harness.weights import make_weights, rebuild, storage_dtypes
from rlbench.harness import work
from rlbench.reference.grpo import (Follower, group_advantages,
                                   tree_leaves, tree_map)

PAD = 256            # the port's byte tokenizer's pad id
FIRST_ID = 260       # content ids start above the tokenizer's specials


class PromptTask:
    """The job's task stream: each prompt's content length drawn
    log-uniform from ``content_len`` and its ids uniform above the
    specials, left-padded to ``prompt_len``; answers are unused (the
    reward reads the completions alone)."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        self.rng = np.random.default_rng([int(seed), 1])
        self.lo, self.hi = traffic["content_len"]
        self.prompt_len = traffic["prompt_len"]
        self.vocab = vocab

    def sample_batch(self, n: int):
        lens = np.exp(self.rng.uniform(np.log(self.lo), np.log(self.hi + 1),
                                       n)).astype(np.int64)
        lens = np.clip(lens, self.lo, self.hi)
        prompts = np.full((n, self.prompt_len), PAD, np.int32)
        for i, m in enumerate(lens):
            prompts[i, -m:] = self.rng.integers(FIRST_ID, self.vocab, m)
        return SimpleNamespace(prompts=prompts, answers=[""] * n)


def make_reward(seed: int, vocab: int):
    """A row's reward: the share of its recorded tokens in a seeded half
    of the vocabulary.  It differs from row to row, so every GRPO group
    has advantages to learn from."""
    good = np.random.default_rng([int(seed), 2]).random(vocab) < 0.5

    def reward(completions, mask, answers):
        comp, m = np.asarray(completions), np.asarray(mask)
        hits = (good[comp] * m).sum(1)
        return (hits / np.maximum(m.sum(1), 1)).astype(np.float32)
    return reward


class Observer:
    """What the run records: per job, each rollout's engine counters and
    each train phase's host span, the first ``steps`` iterations' tokens,
    log-probabilities, masks, losses and gradient norms, the per-leaf norms
    the check compares; and the traced span's flash calls."""

    def __init__(self, steps: int, trace_at: int, tracer):
        self.steps = steps
        self.trace_at = trace_at          # the traced train phase's iteration
        self.tracer = tracer
        self.jobs: dict = {}
        self.kernel_calls = {"flash": []}
        self.kernel_counts = {}

    def job(self, jid):
        return self.jobs.setdefault(jid, {
            "rollouts": {}, "train": {}, "data": {}, "first_grad": None,
            "change": None})


def _leaf_norms(tree, scale: float = 1.0) -> dict:
    """Per-leaf norms of ``tree``, read back in one copy."""
    leaves = tree_leaves(tree)
    norms = torch.stack([t.float().norm() for _, t in leaves]).tolist()
    return {p: n * scale for (p, _), n in zip(leaves, norms)}


def job_class():
    """The observed ``GRPOJob`` (imported here: the program loads only
    once the run has checked for its card)."""
    from repro_torch.rl.coexec import GRPOJob

    class BenchJob(GRPOJob):
        def __init__(self, *a, observer, abstract, fault=None, **kw):
            super().__init__(*a, **kw)
            self.obs = observer
            self.abstract = abstract
            self.fault = fault
            self._trained = 0

        def init_state(self):
            state = super().init_state()
            self.params = None        # the cache or the state holds them now
            return state

        def rollout_step(self, params, k):
            t0 = time.perf_counter()
            b, out = super().rollout_step(params, k)
            t1 = time.perf_counter()
            if self.fault == "token":
                out = check.alter_tokens(out)
            st = out["engine_stats"]
            rec = self.obs.job(self.job_id)
            rec["rollouts"][k] = {"t": (t0, t1), "decode_s": st.decode_time_s,
                                  "steps": st.steps,
                                  "prefills": st.prefills}
            if k < self.obs.steps:
                rec["data"][k] = {n: out[n].detach().cpu() for n in
                                  ("tokens", "behavior_logp", "mask",
                                   "completions")}
            return b, out

        def train_phase(self, state, b, out, rewards=None):
            if self.fault == "half":
                b, out = check.half_batch(b, out, self.group)
            if self.fault == "frozen":
                before = tree_map(torch.clone, state)
            k = self._trained
            traced = (self.obs.tracer is not None and k == self.obs.trace_at
                      and self.job_id == "job0")
            if traced:
                self.obs.tracer.start()
            t0 = time.perf_counter()
            state, rec = super().train_phase(state, b, out, rewards)
            t1 = time.perf_counter()
            if traced:
                self.obs.tracer.end()
            if self.fault == "frozen":
                for a, c in zip(tree_leaves(state), tree_leaves(before)):
                    a[1].copy_(c[1])
                del before
            self._trained += 1
            o = self.obs.job(self.job_id)
            o["train"][k] = {"t": (t0, t1), "tokens": rec["tokens"],
                             "loss": rec["loss"],
                             "grad_norm": rec["grad_norm"]}
            if k == 0:
                o["first_grad"] = _leaf_norms(state["opt"]["mu"],
                                              1.0 / (1.0 - self.opt_cfg.b1))
            if k == self.obs.steps - 1:
                p0 = make_weights(self.abstract, self.seed,
                                  state["params"]["embed"].device)
                d0 = dict(tree_leaves(p0))
                o["change"] = _leaf_norms(rebuild(
                    state["params"],
                    lambda p, t: t.float() - d0[p].float()))
                del p0, d0
            return state, rec

    return BenchJob


def recording_cache(capacity_bytes: int):
    """The program's host cache, recording each CUDA copy's kind, bytes,
    timing events and host time (``HostStateCache._copied``), and the host
    seconds of each key's first offload (which pins its buffer)."""
    from repro_torch.train.checkpoints import HostStateCache

    class RecordingCache(HostStateCache):
        def __init__(self, capacity):
            super().__init__(capacity)
            self.copies = []
            self.first_offload_s = 0.0

        def offload(self, key, tree):
            first = not self.resident(key)
            s = super().offload(key, tree)
            if first:
                self.first_offload_s += s
            return s

        def _copied(self, key, kind, nbytes, start, end):
            self.copies.append((key, kind, nbytes, start, end,
                                time.perf_counter()))

    return RecordingCache(capacity_bytes)


class KernelCalls:
    """Each launch of the flash kernel while the trace is open, with its
    shapes, recorded at the kernel's Python entry (a module attribute the
    autograd Function looks up at call time).  On exit the
    calls seen over the whole run are held against the wrappers'
    ``launches`` counters (``obs.kernel_counts``: kind -> (calls,
    launches)); a call that launched nothing, or a launch that bypassed
    the entry, would make the two differ."""

    def __init__(self, obs: Observer):
        self.obs = obs
        self.saved = []
        self.calls = {"flash": 0}

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        obs = self.obs

        def wrap(mod, name, kind, shape_of):
            orig = getattr(mod, name)

            def entry(*a, **kw):
                if a[0].is_cuda:
                    self.calls[kind] += 1
                    if obs.tracer is not None and obs.tracer.active:
                        obs.kernel_calls[kind].append(shape_of(*a, **kw))
                return orig(*a, **kw)
            entry.launches = orig.launches
            setattr(mod, name, entry)
            self.saved.append((mod, name, kind, orig, orig.launches))

        def flash_shape(q, k, v, *, causal=True, window=None, **_):
            return (q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                    q.shape[3], v.shape[3], causal, window,
                    q.element_size())
        wrap(fa, "flash_attention", "flash", flash_shape)
        return self

    def __exit__(self, *a):
        for mod, name, kind, orig, before in reversed(self.saved):
            entry = getattr(mod, name)
            orig.launches = entry.launches
            setattr(mod, name, orig)
            self.obs.kernel_counts[kind] = (self.calls[kind],
                                            entry.launches - before)
        return False


def run(ctx) -> dict:
    """One run of a GRPO cell; ``ctx`` carries the cell (``workload``,
    ``config``), ``seed``, ``seconds`` and the manifest's
    ``run_seconds``, ``trace``, ``device``, the process start ``t_start``,
    an optional ``model`` (tests: a reduced one, with a configuration that
    states it) and ``fault`` / ``control`` (the check's own tests)."""
    from repro_torch.core.phase_control import RollMuxRuntime
    from repro_torch.models import build_model
    from repro_torch.rl.coexec import run_coexec, run_sequential

    wl, cfg, dev = ctx.workload, ctx.config, ctx.device
    steps = wl["check"]["steps"]
    n_win = max(1, round(wl["window_iterations"] * ctx.seconds
                         / ctx.run_seconds))
    n_jobs = wl["jobs"]
    model = ctx.model or build_model(cfg["port_arch"])
    check_model(cfg, model, model.init_abstract())
    vocab = cfg["vocab_size"]
    abstract = file_abstract(cfg)
    tracer = Tracer(dev.type) if ctx.trace else None
    obs = Observer(steps, steps + n_win - 1, tracer)
    BenchJob = job_class()
    jobs = []
    for i in range(n_jobs):
        seed = ctx.seed + i
        job = BenchJob(
            f"job{i}", model, seed=seed, steps=steps + n_win,
            batch=wl["prompts"], group=wl["group"], max_new=wl["max_new"],
            lr=wl["lr"], temperature=wl["temperature"], rollout="engine",
            num_slots=wl["slots"], kv=wl["kv"],
            reward_fn=make_reward(seed, vocab),
            params=make_weights(abstract, seed, dev), device=dev,
            observer=obs, abstract=abstract, fault=ctx.fault)
        job.task = PromptTask(wl, seed, vocab)
        jobs.append(job)
    rt = RollMuxRuntime()
    rt.cache = recording_cache(rt.cache.capacity)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with KernelCalls(obs) if ctx.trace else contextlib.nullcontext():
        try:
            if wl["executor"] == "coexec":
                states, _, _ = run_coexec(jobs, runtime=rt)
            elif wl["executor"] == "sequential":
                states, _, _ = run_sequential(jobs[0], runtime=rt)
            else:
                raise ValueError(f"unknown executor {wl['executor']!r}")
        finally:
            if tracer is not None:
                t_stop = time.perf_counter()
                tracer.stop()
                log(f"profiler stopped in {time.perf_counter() - t_stop:.1f} s")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        peak = 0
    t_rt0 = rt._t0

    # ---- the window ------------------------------------------------------
    first, last = steps, steps + n_win - 1
    roll = {j.job_id: [iv for iv in rt.pools["rollout"].timeline
                       if iv[0].startswith(j.job_id + ":")] for j in jobs}
    train = {j.job_id: [iv for iv in rt.pools["train"].timeline
                        if iv[0].startswith(j.job_id + ":")] for j in jobs}
    w0 = t_rt0 + min(roll[j][first][1] for j in roll)
    w1 = t_rt0 + max(train[j][last][2] for j in train)
    window_s = w1 - w0
    tokens = sum(obs.jobs[j]["train"][k]["tokens"] for j in obs.jobs
                 for k in range(first, last + 1))
    # one rate, named by the manifest for a job alone or for co-executed jobs
    result = {
        "setup_s": w0 - ctx.t_start, "grpo_tokens_per_s": tokens / window_s,
        "mux_tokens_per_s": tokens / window_s,
        "peak": peak, "attempted": n_jobs * n_win, "failed": 0,
        "info": {"window_s": window_s, "tokens": tokens,
                 "iterations": n_win, "first_offload_s":
                 rt.cache.first_offload_s, **_phase_info(obs, first, last)}}
    if ctx.trace:
        result["layers"] = _layer_obs(obs, rt, wl, cfg, first, last,
                                      t_rt0, roll, train, w0, w1)
    del jobs, states, rt
    _free(dev)
    log(f"window closed: {window_s:.3f} s, {tokens} tokens, setup "
        f"{result['setup_s']:.3f} s, peak {peak / 2**30:.2f} GiB")

    # ---- the check -------------------------------------------------------
    t_ref = time.perf_counter()
    numbers = check_jobs(ctx, obs, abstract, vocab)
    log(f"reference checked in {time.perf_counter() - t_ref:.1f} s")
    result["numbers"] = numbers
    return result


def _phase_info(obs, first, last) -> dict:
    """Mean rollout and train phase seconds and decode milliseconds a step
    over the window, for the line's ``info``."""
    roll, train, dec, steps = [], [], 0.0, 0
    for o in obs.jobs.values():
        for k in range(first, last + 1):
            r, t = o["rollouts"][k], o["train"][k]
            roll.append(r["t"][1] - r["t"][0])
            train.append(t["t"][1] - t["t"][0])
            dec += r["decode_s"]
            steps += r["steps"]
    return {"rollout_s": sum(roll) / len(roll),
            "train_s": sum(train) / len(train),
            "decode_ms": 1e3 * dec / max(steps, 1)}


def log(msg: str) -> None:
    print(f"rlbench: {msg}", file=sys.stderr, flush=True)


def _free(dev):
    import gc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def _layer_obs(obs, rt, wl, cfg, first, last, t_rt0, roll, train,
               w0, w1) -> dict:
    """The raw observations the per-layer readers take."""
    in_win = range(first, last + 1)
    pools = {"rollout": [(t_rt0 + a, t_rt0 + b) for j in roll
                         for k, (_, a, b) in enumerate(roll[j]) if k in in_win],
             "train": [(t_rt0 + a, t_rt0 + b) for j in train
                       for k, (_, a, b) in enumerate(train[j])
                       if k in in_win]}
    restores = [(n, s.elapsed_time(e) / 1e3) for _, kind, n, s, e, t
                in rt.cache.copies if kind == "restore" and w0 <= t <= w1]
    decode = [(r["decode_s"], r["steps"]) for o in obs.jobs.values()
              for k, r in o["rollouts"].items() if k in in_win]
    train_s = [t[1] - t[0] for o in obs.jobs.values()
               for k, t in ((k, v["t"]) for k, v in o["train"].items())
               if k in in_win]
    B = wl["prompts"] * wl["group"]
    S = wl["prompt_len"] + wl["max_new"]
    gen = sum(obs.jobs[j]["train"][k]["tokens"] for j in obs.jobs
              for k in in_win)
    n_it = len(obs.jobs) * len(in_win)
    flops = work.grpo_model_flops(cfg["flop_params"], n_it * B * (S - 1),
                                  n_it * B * wl["prompt_len"] + gen)
    spans = []
    for j in roll:
        spans += [(f"{j}:roll", t_rt0 + a, t_rt0 + b) for _, a, b in roll[j]]
        spans += [(f"{j}:train", t_rt0 + a, t_rt0 + b)
                  for _, a, b in train[j]]
    t_sum = time.perf_counter()
    tr = obs.tracer.summary(spans)
    log(f"trace read in {time.perf_counter() - t_sum:.1f} s: "
        f"{tr['events']} device events over {tr['window_s']:.2f} s")
    flash = [work.bound_s(*work.flash_attention_work(
        B_, S_, H, Hkv, D, Dv, causal=c, window=w, elem=e))
        for B_, S_, H, Hkv, D, Dv, c, w, e in obs.kernel_calls["flash"]]
    calls, launches = obs.kernel_counts["flash"]
    if calls != launches:
        log(f"flash: {calls} calls seen at the entry, {launches} "
            f"launches counted: no roofline")
        flash.clear()
    return {
        "pools": pools, "restores": restores, "decode": decode,
        "train_s": train_s, "model_flops": flops, "window_s": w1 - w0,
        "trace": tr,
        "flash": {"bound_s": sum(flash), "calls": len(flash),
                  "device_s": kernel_seconds(tr["kernel_s"], ("flash_fwd",))},
        "reclaimed": reclaimed_bubble_frac(pools),
    }


def follow(ctx, obs_job, abstract, vocab, seed, store="config"):
    """The reference's readings of one job: it trains from the job's
    initial weights on the program's first iterations (their tokens and
    masks; its own log-probabilities, rewards and advantages).  ``logp``
    holds, per step, its log-probabilities of the response tokens the
    program recorded (mask 1), on the host."""
    wl, dev = ctx.workload, ctx.device
    f = Follower(make_weights(abstract, seed, dev), ctx.config,
                 storage_dtypes(abstract), store=store,
                 opt={**wl["opt"], "lr": wl["lr"]},
                 rows_per_block=wl["check"]["rows_per_block"])
    reward = make_reward(seed, vocab)
    Sp = wl["prompt_len"]
    out = {"loss": [], "grad_norm": [], "logp": []}
    for k in range(wl["check"]["steps"]):
        d = obs_job["data"][k]
        mask = d["mask"].to(dev)
        rewards = reward(d["completions"].numpy(), d["mask"].numpy(), None)
        adv = torch.as_tensor(group_advantages(rewards, wl["group"]),
                              device=dev)
        B, T = mask.shape
        zeros = torch.zeros((B, Sp - 1), device=dev)
        r = f.step(d["tokens"].to(dev), torch.cat([zeros, mask], 1),
                   torch.cat([zeros, adv[:, None].expand(B, T)], 1))
        out["logp"].append(r["logp"][:, Sp - 1:][mask > 0].cpu())
        out["loss"].append(r["loss"])
        out["grad_norm"].append(r["grad_norm"])
    out["first_grad"] = f.first_grad
    out["first_raw"] = f.first_raw
    out["change"] = f.change_norms(make_weights(abstract, seed, dev))
    del f
    _free(dev)
    return out


def check_jobs(ctx, obs, abstract, vocab) -> dict:
    """The compared numbers, worst over the jobs: each job's program
    readings against the reference that follows it (for the control, the
    reference with float8 weights in the program's place)."""
    steps = ctx.workload["check"]["steps"]
    worst = {}
    for i, (jid, o) in enumerate(sorted(obs.jobs.items())):
        seed = ctx.seed + i
        ref = follow(ctx, o, abstract, vocab, seed)
        if ctx.control:
            prog = follow(ctx, o, abstract, vocab, seed, store="fp8")
        else:
            prog = {"loss": [o["train"][k]["loss"] for k in range(steps)],
                    "grad_norm": [o["train"][k]["grad_norm"]
                                  for k in range(steps)],
                    "first_grad": o["first_grad"], "change": o["change"],
                    "logp": [o["data"][k]["behavior_logp"][
                        o["data"][k]["mask"] > 0] for k in range(steps)]}
        for k, v in check.training_numbers(prog, ref).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst
