"""Phase-multiplexed GRPO execution: the jobs, the measured report and the
back-to-back executor.

Counterpart of ``repro/rl/coexec.py``.  A :class:`GRPOJob` runs its rollout
phase through the continuous-batching ``serve.Engine`` and its training
phase through ``rl.train_step``; executors schedule the two under
``core.phase_control`` run permits and return a :class:`MuxReport` of the
measured per-pool timelines.

Ported so far: :func:`run_sequential` (``--mux off``), the
standard-disaggregation baseline, rollout and training back-to-back in one
thread, with the phases under permits so the executed timeline (and the
bubble a mux mode would reclaim) is measured the same way.  The pipelined,
co-executing and streaming executors come with the mux slice, which needs
``Engine.reset`` (ROADMAP).  The rollout takes the engine only: the static
``generate`` scan needs ``stack_decode_step`` (ROADMAP).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.phase_control import PhaseProfile, RollMuxRuntime
from repro_torch.data import ArithmeticTask
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.rl.grpo import group_advantages
from repro_torch.rl.rewards import arithmetic_reward
from repro_torch.rl.rollout import SamplerConfig, generate_continuous
from repro_torch.rl.train_step import make_train_step
from repro_torch.serve.sched import make_policy
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         warmup_cosine)


def build_train_batch(out, adv, prompt_len):
    """Rollout output + GRPO advantages -> the train-step batch dict (on
    the rollout's device)."""
    tokens = out["tokens"][:, :-1]
    labels = out["tokens"][:, 1:]
    B, T = out["completions"].shape
    dev = out["tokens"].device
    zeros = torch.zeros((B, prompt_len - 1), dtype=torch.float32, device=dev)
    loss_mask = torch.cat([zeros, out["mask"]], dim=1)
    advm = torch.as_tensor(np.asarray(adv, np.float32), device=dev)
    advantages = torch.cat([zeros, advm[:, None].expand(B, T)], dim=1)
    return {"tokens": tokens, "labels": labels, "loss_mask": loss_mask,
            "advantages": advantages,
            "behavior_logp": torch.cat([zeros, out["behavior_logp"]], dim=1)}


@dataclass(frozen=True)
class MuxConfig:
    """Phase-multiplexing mode (``--mux``); only ``"off"`` runs so far.
    The other modes' knobs come with their executors (mux slice)."""
    mode: str = "off"                 # "off" | "pipeline" | "coexec" | "stream"

    def __post_init__(self):
        if self.mode not in ("off", "pipeline", "coexec", "stream"):
            raise ValueError(f"unknown mux mode {self.mode!r}")


class GRPOJob:
    """One logical RL post-training job: model, task stream, sampler and
    train step, with its rollout phase served by the continuous-batching
    engine.

    Executors drive :meth:`rollout_step` and :meth:`train_phase` in
    iteration order.  Task batches are drawn from the job's numpy stream
    (the JAX package's, prompt for prompt) and sampled tokens from the
    job's ``torch.Generator`` on ``device``, both in call order.  A new
    engine serves each iteration (``Engine.reset`` comes with the mux
    slice).  ``params`` are the initial weights (default: the model's
    random init from ``seed``)."""

    def __init__(self, job_id: str, model=None, *,
                 arch: str = "internlm2-1.8b", reduced: bool = False,
                 seed: int = 0, steps: int = 50, batch: int = 8,
                 group: int = 4, max_new: int = 8, lr: float = 3e-4,
                 temperature: float = 1.0, rollout: str = "engine",
                 num_slots: Optional[int] = None, engine_block_size: int = 1,
                 kv: str = "contiguous", kv_block_size: int = 16,
                 num_kv_blocks: Optional[int] = None, sched: str = "fifo",
                 kv_dtype: Optional[str] = None,
                 token_budget: Optional[int] = None, slo_bound: float = 2.0,
                 reward_fn=None, params=None, device=None):
        if rollout == "static":
            raise NotImplementedError(
                "rollout='static' (the generate scan) needs "
                "stack_decode_step, which is not ported yet (ROADMAP, "
                "modules to port); use rollout='engine'")
        if rollout != "engine":
            raise ValueError(f"unknown rollout backend {rollout!r}")
        self.job_id = job_id
        self.device = resolve_device(device)
        self.model = model or build_model(arch, reduced=reduced)
        self.seed = seed
        self.steps = steps
        self.batch = batch
        self.group = group
        self.num_slots = num_slots
        self.engine_block_size = engine_block_size
        self.kv = kv
        self.kv_block_size = kv_block_size
        self.num_kv_blocks = num_kv_blocks
        self.sched = sched
        self.kv_dtype = kv_dtype
        # per-job token budget for deadline/SLO admission: one full GRPO
        # iteration's rollout (batch * group members, max_new tokens each)
        self.token_budget = (token_budget if token_budget is not None
                             else batch * group * max_new)
        self.slo_bound = slo_bound
        self.reward_fn = reward_fn or arithmetic_reward
        self.opt_cfg = AdamWConfig(lr=lr)
        self.task = ArithmeticTask(seed=seed)
        self.sampler = SamplerConfig(max_new_tokens=max_new,
                                     temperature=temperature)
        self._train_step = make_train_step(
            self.model, self.opt_cfg,
            lr_schedule=warmup_cosine(self.opt_cfg.lr, 10, steps))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.params = params

    def init_state(self) -> dict:
        """Optimizer state around the initial weights; also the initial
        rollout weights."""
        params = self.params
        if params is None:
            params = self.model.init(
                torch.Generator(device=self.device).manual_seed(self.seed))
        return {"params": params, "opt": adamw_init(params, self.opt_cfg)}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- rollout phase -----------------------------------------------------
    def _make_policy(self):
        """The admission policy this job's engine enforces; deadline/SLO
        policies carry the job's token budget (and the SLO policy its
        slowdown bound)."""
        if self.sched == "fifo":
            return make_policy("fifo")
        kw = {"token_budgets": {self.job_id: self.token_budget}}
        if self.sched == "slo":
            kw["slowdown"] = self.slo_bound
        return make_policy(self.sched, **kw)

    def rollout_step(self, params, k: int):
        """Generate completions for iteration ``k`` with weights ``params``.
        Returns ``(task_batch, rollout_out)``; waits for the card so permit
        timelines measure real phase time."""
        b = self.task.sample_batch(self.batch)
        prompts = np.repeat(b.prompts, self.group, axis=0)
        B = prompts.shape[0]
        with torch.no_grad():
            out = generate_continuous(
                self.model, params, prompts, self.sampler,
                generator=self.generator, num_slots=self.num_slots or B,
                device=self.device, block_size=self.engine_block_size,
                kv_layout=self.kv, kv_block_size=self.kv_block_size,
                num_kv_blocks=self.num_kv_blocks, sched=self.sched,
                kv_dtype=self.kv_dtype, policy=self._make_policy())
        self._sync()
        return b, out

    # ---- reward phase ------------------------------------------------------
    def compute_rewards(self, b, out) -> np.ndarray:
        """Batch-at-once verification on the host."""
        answers = [a for a in b.answers for _ in range(self.group)]
        return self.reward_fn(out["completions"].cpu().numpy(),
                              out["mask"].cpu().numpy(), answers)

    # ---- training phase ----------------------------------------------------
    def train_phase(self, state, b, out, rewards: Optional[np.ndarray] = None):
        """Reward (unless given) -> GRPO advantages -> one optimizer step,
        in place on ``state``.  Returns ``(state, rec)`` with the scalar
        metrics the history records (the JAX package's, plus the step's
        ``grad_norm`` and the rollout's ``prefills`` and
        ``decode_steps``)."""
        if rewards is None:
            rewards = self.compute_rewards(b, out)
        adv = group_advantages(rewards, self.group)
        tb = build_train_batch(out, adv, b.prompts.shape[1])
        state, metrics = self._train_step(state, tb)
        self._sync()
        stats = out["engine_stats"]
        rec = {"reward": float(rewards.mean()),
               "acc": float((rewards >= 1.0).mean()),
               "loss": float(metrics["loss"]),
               "entropy": float(metrics["entropy"]),
               "clip_frac": float(metrics["clip_frac"]),
               "ratio_mean": float(metrics["ratio_mean"]),
               "ratio_max": float(metrics["ratio_max"]),
               "grad_norm": float(metrics["grad_norm"]),
               "tokens": int(out["mask"].sum()),
               "prefills": stats.prefills, "decode_steps": stats.steps}
        return state, rec


# ---------------------------------------------------------------------------
# Reporting: measured timelines -> reclaimed bubble + PhaseProfiles
# ---------------------------------------------------------------------------
def _union_s(intervals: list[tuple[float, float]]) -> float:
    """Total length of the union of (possibly overlapping) intervals."""
    ivs = sorted(intervals)
    tot = 0.0
    cur_lo = cur_hi = None
    for lo, hi in ivs:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                tot += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        tot += cur_hi - cur_lo
    return tot


@dataclass
class MuxReport:
    """What a mux run measured: per-pool busy timelines, the overlap they
    achieved, and the per-job :class:`PhaseProfile` records that feed the
    co-execution simulator.

    Overlap generalizes to any number of pools (rollout/train, plus the
    streaming executor's reward pool): ``overlap_s`` is total busy time
    minus the union of all busy intervals — every second during which two
    or more permits were in flight at once counts once per *extra* permit.
    With only rollout and train this reduces exactly to their pairwise
    intersection, so the two-pool modes report the same numbers as before.
    """
    mode: str
    wall_s: float
    timelines: dict[str, list[tuple[str, float, float]]]
    profiles: dict[str, PhaseProfile] = field(default_factory=dict)
    cache_stats: dict = field(default_factory=dict)

    def _pool_busy_s(self, name: str) -> float:
        return sum(t1 - t0 for _, t0, t1 in self.timelines.get(name, []))

    @property
    def total_rollout_s(self) -> float:
        return self._pool_busy_s("rollout")

    @property
    def total_train_s(self) -> float:
        return self._pool_busy_s("train")

    @property
    def total_reward_s(self) -> float:
        """Reward-pool busy time (0 for executors that verify inline)."""
        return self._pool_busy_s("reward")

    @property
    def _total_busy_s(self) -> float:
        return sum(self._pool_busy_s(p) for p in self.timelines)

    @property
    def overlap_s(self) -> float:
        """Wall time re-claimed by concurrency: total permit-busy seconds
        minus the union of all busy intervals (see class docstring)."""
        all_ivs = [(t0, t1) for tl in self.timelines.values()
                   for _, t0, t1 in tl]
        return self._total_busy_s - _union_s(all_ivs)

    @property
    def bubble_back_to_back_s(self) -> float:
        """The dependency bubble the fully serialized schedule pays: with
        every phase back-to-back, wall time is the sum of all phases while
        the ideal is the busiest pool's total — the difference
        (``sum - max``; ``min(roll, train)`` in the two-pool case) is the
        reclaimable part."""
        busiest = max((self._pool_busy_s(p) for p in self.timelines),
                      default=0.0)
        return self._total_busy_s - busiest

    @property
    def reclaimed_bubble_frac(self) -> float:
        """Fraction of the back-to-back bubble the schedule reclaimed."""
        return self.overlap_s / max(self.bubble_back_to_back_s, 1e-9)

    def summary(self) -> dict:
        return {
            "mode": self.mode,
            "wall_s": self.wall_s,
            "total_rollout_s": self.total_rollout_s,
            "total_train_s": self.total_train_s,
            "total_reward_s": self.total_reward_s,
            "overlap_s": self.overlap_s,
            "bubble_back_to_back_s": self.bubble_back_to_back_s,
            "reclaimed_bubble_frac": self.reclaimed_bubble_frac,
            "cache_stats": dict(self.cache_stats),
        }


def _report(mode: str, rt: RollMuxRuntime, wall_s: float) -> MuxReport:
    return MuxReport(
        mode=mode, wall_s=wall_s,
        timelines={name: list(p.timeline) for name, p in rt.pools.items()},
        profiles=rt.phase_profiles(),
        cache_stats=dict(rt.cache.stats))


def _log(rec: dict, log_every: int, jid: str = "") -> None:
    if log_every and rec["step"] % log_every == 0:
        tag = f"[{jid}] " if jid else ""
        print(f"{tag}step {rec['step']:4d} reward={rec['reward']:.3f} "
              f"acc={rec['acc']:.3f} loss={rec['loss']:.4f} "
              f"entropy={rec['entropy']:.3f}", flush=True)


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------
def run_sequential(job: GRPOJob, *, steps: Optional[int] = None,
                   runtime: Optional[RollMuxRuntime] = None,
                   log_every: int = 0):
    """``--mux off``: the back-to-back baseline.  Phases run under permits
    so the executed (bubbled) timeline is measured like the mux modes.
    ``steps`` overrides the job's step count (e.g. a short warmup run)."""
    rt = runtime or RollMuxRuntime()
    state = job.init_state()
    history = []
    t0 = time.perf_counter()
    for k in range(job.steps if steps is None else steps):
        with rt.permit("rollout", f"{job.job_id}:roll"):
            b, out = job.rollout_step(state["params"], k)
        with rt.permit("train", f"{job.job_id}:train"):
            state, rec = job.train_phase(state, b, out)
        rec = {"step": k, **rec, "rollout_staleness": 0}
        history.append(rec)
        _log(rec, log_every)
    return state, history, _report("off", rt, time.perf_counter() - t0)
