"""Phase-multiplexed GRPO execution: the jobs, the measured report and the
executors.

Counterpart of ``repro/rl/coexec.py``.  A :class:`GRPOJob` runs its rollout
phase through the static ``rl.rollout.generate`` batch (the default, as in
the JAX package) or a persistent continuous-batching ``serve.Engine``
(weights swapped in by ``Engine.reset`` every iteration), and its training
phase through ``rl.train_step``; executors schedule the two under
``core.phase_control`` run permits and return a :class:`MuxReport` of the
measured per-pool timelines.  Three executors live here (the fourth,
``run_streaming``, in ``rl/stream.py``):

* :func:`run_sequential` (``--mux off``): the standard-disaggregation
  baseline, rollout and training back-to-back in one thread.
* :func:`run_pipelined` (``--mux pipeline``): one job, the rollout of
  iteration ``k+1`` overlapping the training step of iteration ``k``
  behind the on-policy staleness guard (``max_staleness=0`` is bit-exact
  to ``off``).
* :func:`run_coexec` (``--mux coexec``): several jobs round-robin over the
  shared rollout and train pools, each job's state suspended to the host
  cache between phases and warm-started back, so each job computes what it
  would alone.

On the card every executor thread runs each pool's phases on its own CUDA
stream (``core.phase_control.PhaseStreams``), so that the kernels of one
phase can fill the device time the other leaves idle; tensors that cross
streams (rollout outputs to the trainer, weights to the rollout) go
through ``hand_over``/``take_over``.  The port's AdamW updates the weights
in place, where the JAX package makes new arrays: wherever a rollout may
run while the optimizer steps, it is handed a snapshot of the weights (a
clone on the train stream), never the live tensors.

With span recording on (``core.telemetry``) a job's rollout is a
``rollout`` span (the engine's spans, ``rollout.pack`` and
``rollout.sync`` beneath it), its train phase a ``train`` span
(``train.reward``, ``train.batch``, the train step's ``train.forward``,
``train.backward`` and ``train.adamw``, ``train.sync``), and
:func:`run_coexec`'s weight sync a ``sync`` span around its offload.
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core import telemetry
from repro_torch.core.phase_control import (PhaseProfile, PhaseStreams,
                                            RollMuxRuntime, hand_over,
                                            sync_current_stream, take_over)
from repro_torch.data import ArithmeticTask
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.rl.grpo import group_advantages
from repro_torch.rl.rewards import arithmetic_reward
from repro_torch.rl.rollout import (SamplerConfig, generate,
                                   generate_continuous,
                                   generate_continuous_stream)
from repro_torch.rl.train_step import make_train_step
from repro_torch.serve.sched import make_policy
from repro_torch.serve.spec import RolloutSpec
from repro_torch.train.optimizer import (AdamWConfig, adamw_init, tree_map,
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
    """Phase-multiplexing knobs (``--mux`` and its flags)."""
    mode: str = "off"                 # "off" | "pipeline" | "coexec" | "stream"
    max_staleness: int = 1            # pipeline/stream: optimizer steps the
    #                                   rollout weights may lag (0 = sync,
    #                                   bit-exact to the sequential path)
    host_cache_gb: float = 8.0        # coexec actor-cache budget
    reward_workers: int = 2           # stream: reward permit-pool capacity
    micro_groups: Optional[int] = None    # stream: groups per train
    #                                       micro-step (None = one full-batch
    #                                       step per iteration, bit-exact)

    def __post_init__(self):
        if self.mode not in ("off", "pipeline", "coexec", "stream"):
            raise ValueError(f"unknown mux mode {self.mode!r}")
        if self.max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        if self.reward_workers < 1:
            raise ValueError("reward_workers must be >= 1")
        if self.micro_groups is not None and self.micro_groups < 1:
            raise ValueError("micro_groups must be >= 1 (or None)")


class GRPOJob:
    """One logical RL post-training job: model, task stream, sampler and
    train step, with its rollout phase routed through the static
    ``generate`` batch (``rollout="static"``, the default) or the
    continuous-batching engine (``rollout="engine"``).

    Executors drive :meth:`rollout_step` (or :meth:`rollout_stream`) and
    :meth:`train_phase` in iteration order.  Task batches are drawn from
    the job's numpy stream (the JAX package's, prompt for prompt) and
    sampled tokens from the job's ``torch.Generator`` on ``device``, both
    in call order.  On the engine, one persistent engine per shape serves
    every iteration, its weights swapped in by ``Engine.reset``.
    ``params`` are the initial weights (default: the model's random init
    from ``seed``); the sequential and pipelined executors train them in
    place.  ``carry`` (partial-rollout continuation, engine rollout) lets
    the streaming executor swap each weight sync into the live engine.
    The engine's shape is ``spec`` (a
    :class:`~repro_torch.serve.spec.RolloutSpec`: with ``prefix_share``
    each GRPO group's prompt prefills once, with ``disagg`` the rollout
    runs through a ``DisaggRouter``), or, without one, the loose
    ``num_slots`` ... ``prefix_share`` arguments.  Every family the port
    serves trains here but the audio one, whose forward needs the frames
    that no GRPO rollout carries (the JAX loop cannot run it either); a
    vlm trains without its vision embeddings, as in the JAX loop."""

    def __init__(self, job_id: str, model=None, *,
                 arch: str = "internlm2-1.8b", reduced: bool = False,
                 seed: int = 0, steps: int = 50, batch: int = 8,
                 group: int = 4, max_new: int = 8, lr: float = 3e-4,
                 temperature: float = 1.0, rollout: str = "static",
                 num_slots: Optional[int] = None, engine_block_size: int = 1,
                 kv: str = "contiguous", kv_block_size: int = 16,
                 num_kv_blocks: Optional[int] = None, sched: str = "fifo",
                 kv_dtype: Optional[str] = None, prefix_share: bool = False,
                 spec: Optional[RolloutSpec] = None,
                 token_budget: Optional[int] = None, slo_bound: float = 2.0,
                 reward_fn=None, params=None, device=None,
                 carry: bool = False):
        if rollout not in ("static", "engine"):
            raise ValueError(f"unknown rollout backend {rollout!r}")
        self.job_id = job_id
        self.rollout = rollout
        self.device = resolve_device(device)
        self.model = model or build_model(arch, reduced=reduced)
        if self.model.cfg.family == "audio":
            raise ValueError(
                f"{self.model.cfg.name}: the GRPO loop carries no frontends "
                f"and the audio family needs its frame embeddings; train it "
                f"through rl.train_step.make_train_step with a batch that "
                f"holds a frontend")
        self.seed = seed
        self.steps = steps
        self.batch = batch
        self.group = group
        if spec is None:
            spec = RolloutSpec(
                num_slots=num_slots, block_size=engine_block_size,
                kv_layout=kv, kv_block_size=kv_block_size,
                num_kv_blocks=num_kv_blocks, sched=sched,
                prefix_share=prefix_share, kv_dtype=kv_dtype)
        # the spec is the engine shape: it builds the job's engines and
        # is checked against a persistent one at every rollout
        self.spec = spec.replace(group=group, carry=spec.carry or carry)
        self.num_slots = self.spec.num_slots
        self.sched = self.spec.sched
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
        self.carry = self.spec.carry
        self._engines: dict[int, object] = {}      # max_seq_len -> Engine

    def init_state(self) -> dict:
        """Optimizer state around the initial weights; also the initial
        rollout weights."""
        params = self.params
        if params is None:
            params = self.model.init(
                torch.Generator(device=self.device).manual_seed(self.seed))
        return {"params": params, "opt": adamw_init(params, self.opt_cfg)}

    def _sync(self) -> None:
        """Wait for this phase's work: the current stream only, never the
        other executor thread's."""
        sync_current_stream(self.device)

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

    def _engine_for(self, params, num_slots: int, max_seq_len: int):
        """The persistent engine of this shape (built on first use with
        ``params``), reused across GRPO iterations through ``Engine.reset``:
        the slot pool stays, the weights are swapped."""
        eng = self._engines.get(max_seq_len)
        if eng is None:
            eng = self.spec.build_engine(
                self.model, params, batch=num_slots, max_seq_len=max_seq_len,
                eos_id=self.sampler.eos_id,
                temperature=self.sampler.temperature,
                policy=self._make_policy(), device=self.device,
                generator=self.generator)
            self._engines[max_seq_len] = eng
        return eng

    @contextlib.contextmanager
    def _serving(self, params, prompts):
        """The engine for ``prompts``; once its rollout ends the drained
        engine lets go of the weights, so that a snapshot or a
        warm-started copy is freed with its phase (the next ``reset``
        swaps weights in again)."""
        B, Sp = prompts.shape
        eng = self._engine_for(params, self.num_slots or B,
                               Sp + self.sampler.max_new_tokens)
        try:
            yield eng
        finally:
            eng.params = None

    def rollout_step(self, params, k: int):
        """Generate completions for iteration ``k`` with weights ``params``.
        Returns ``(task_batch, rollout_out)``; waits for this phase's stream
        so permit timelines measure real phase time."""
        with telemetry.span("rollout"):
            b = self.task.sample_batch(self.batch)
            prompts = np.repeat(b.prompts, self.group, axis=0)
            if self.rollout == "static":
                out = generate(self.model, params, prompts, self.sampler,
                               generator=self.generator)
            else:
                with torch.no_grad(), self._serving(params, prompts) as eng:
                    out = generate_continuous(self.model, params, prompts,
                                              self.sampler, engine=eng,
                                              spec=self.spec)
            with telemetry.span("rollout.sync"):
                self._sync()
        return b, out

    def rollout_stream(self, params, k: int, on_group, on_batch=None,
                       sync_params=None):
        """Streaming rollout for iteration ``k``: ``on_group(gout)`` fires
        the moment each GRPO prompt group finishes decoding, while the
        engine keeps serving the stragglers.  The same task batch,
        generator stream and computation as :meth:`rollout_step`, so the
        streamed groups stacked by row are its output bit for bit.
        ``on_batch(b)``, when given, receives the task batch before the
        rollout runs (reward workers need the answers first).
        ``sync_params`` (engine rollout) is the newest-weights poll the
        engine swaps in live mid-rollout
        (:func:`~repro_torch.rl.rollout.generate_continuous_stream`).
        Returns ``(task_batch, engine_stats)``, the latter this rollout's
        ``Engine.metrics()``.  The static rollout has no group to hand out
        early: it generates the whole batch, then emits the groups in row
        order, with ``engine_stats`` None."""
        b = self.task.sample_batch(self.batch)
        if on_batch is not None:
            on_batch(b)
        prompts = np.repeat(b.prompts, self.group, axis=0)
        if self.rollout == "static":
            out = generate(self.model, params, prompts, self.sampler,
                           generator=self.generator)
            arrays = {k: out[k].cpu().numpy()
                      for k in ("completions", "behavior_logp", "mask")}
            g = self.group
            for gi in range(prompts.shape[0] // g):
                rows = list(range(gi * g, (gi + 1) * g))
                on_group({"group_index": gi, "rows": rows,
                          **{k: a[rows] for k, a in arrays.items()}})
            self._sync()
            return b, None
        with torch.no_grad(), self._serving(params, prompts) as eng:
            for gout in generate_continuous_stream(
                    self.model, params, prompts, self.sampler,
                    group=self.group, engine=eng, sync_params=sync_params,
                    spec=self.spec):
                on_group(gout)
            stats = eng.metrics()
        self._sync()
        return b, stats

    # ---- reward phase ------------------------------------------------------
    def compute_rewards(self, b, out) -> np.ndarray:
        """Batch-at-once verification on the host."""
        answers = [a for a in b.answers for _ in range(self.group)]
        return self.reward_fn(out["completions"].cpu().numpy(),
                              out["mask"].cpu().numpy(), answers)

    def reward_group(self, b, gout) -> np.ndarray:
        """Verify one streamed group on a reward worker.  Verifiers are
        row-wise, so per-group verdicts concatenated in row order are
        :meth:`compute_rewards` on the assembled batch, bit for bit."""
        answers = [b.answers[gout["group_index"]]] * len(gout["rows"])
        return self.reward_fn(gout["completions"], gout["mask"], answers)

    # ---- training phase ----------------------------------------------------
    def train_phase(self, state, b, out, rewards: Optional[np.ndarray] = None):
        """Reward (unless given) -> GRPO advantages -> one optimizer step,
        in place on ``state``.  Returns ``(state, rec)`` with the scalar
        metrics the history records (the JAX package's, plus the step's
        ``grad_norm`` and, when ``out`` carries ``engine_stats``, the
        rollout's ``prefills``, ``prefix_hits`` and ``decode_steps``)."""
        with telemetry.span("train"):
            with telemetry.span("train.reward"):
                if rewards is None:
                    rewards = self.compute_rewards(b, out)
                adv = group_advantages(rewards, self.group)
            with telemetry.span("train.batch"):
                tb = build_train_batch(out, adv, b.prompts.shape[1])
            state, metrics = self._train_step(state, tb)
            with telemetry.span("train.sync"):
                self._sync()
            rec = {"reward": float(rewards.mean()),
                   "acc": float((rewards >= 1.0).mean()),
                   "loss": float(metrics["loss"]),
                   "entropy": float(metrics["entropy"]),
                   "clip_frac": float(metrics["clip_frac"]),
                   "ratio_mean": float(metrics["ratio_mean"]),
                   "ratio_max": float(metrics["ratio_max"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "tokens": int(out["mask"].sum())}
            if "engine_stats" in out:
                rec.update(_rollout_counts(out["engine_stats"]))
        return state, rec


def _rollout_counts(stats) -> dict:
    """The engine rollout's prefills (admissions), the radix exact hits
    among them (admitted with no model compute) and decode steps (none
    for the static rollout)."""
    if stats is None:
        return {}
    return {"prefills": stats.prefills, "prefix_hits": stats.prefix_hits,
            "decode_steps": stats.steps}


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


def _weights_for_rollout(params, snapshot: bool):
    """The weights a rollout thread is handed, with the event it waits on:
    a clone made on the current (train) stream when a rollout may run
    while the optimizer updates ``params`` in place, else ``params``
    themselves."""
    if snapshot:
        params = tree_map(torch.clone, params)
    return params, hand_over(params)


def _raise_first(shared: dict) -> None:
    if shared["err"] is not None:
        raise shared["err"]


def run_pipelined(job: GRPOJob, *, max_staleness: int = 1,
                  runtime: Optional[RollMuxRuntime] = None,
                  log_every: int = 0):
    """``--mux pipeline``: overlap the rollout of iteration ``k+1`` with
    the training step of iteration ``k`` (one job, two permit pools, two
    threads, each on its own CUDA stream), behind the on-policy staleness
    guard.

    The rollout thread may generate for iteration ``k`` only once
    ``trained >= k - max_staleness`` optimizer steps have completed, and
    it takes the newest synced weights when the guard opens.
    ``max_staleness=0`` therefore runs the sequential schedule (same
    weights, same generator stream, bit-exact losses) and hands the
    rollout the live weights, as no step runs beside it; ``>= 1`` buys
    overlap at the price of a bounded, importance-corrected policy lag
    (recorded per step as ``rollout_staleness``), and each weight sync is
    a snapshot: at most two are alive, the newest and the one the rollout
    serves with."""
    if max_staleness < 0:
        raise ValueError("max_staleness must be >= 0")
    rt = runtime or RollMuxRuntime()
    steps = job.steps
    snapshot = max_staleness > 0
    state = job.init_state()
    cv = threading.Condition()
    shared = {"sync": _weights_for_rollout(state["params"], snapshot),
              "trained": 0, "err": None}
    rollouts: dict[int, tuple] = {}
    history = []
    t0 = time.perf_counter()

    def roll_loop():
        streams = PhaseStreams(job.device, ("rollout",))
        try:
            with streams("rollout"):
                for k in range(steps):
                    with cv:
                        while (shared["trained"] < k - max_staleness
                               and shared["err"] is None):
                            cv.wait()
                        if shared["err"] is not None:
                            return
                        params, event = shared["sync"]   # newest weights
                        version = shared["trained"]
                    take_over(params, event)
                    with rt.permit("rollout", f"{job.job_id}:roll"):
                        b, out = job.rollout_step(params, k)
                    event = hand_over(out)
                    with cv:
                        rollouts[k] = (b, out, version, event)
                        cv.notify_all()
        except BaseException as e:           # surface into the train loop
            with cv:
                shared["err"] = e
                cv.notify_all()

    t = threading.Thread(target=roll_loop, name=f"{job.job_id}-rollout")
    t.start()
    try:
        with PhaseStreams(job.device, ("train",))("train"):
            for k in range(steps):
                with cv:
                    while k not in rollouts and shared["err"] is None:
                        cv.wait()
                    _raise_first(shared)
                    b, out, version, event = rollouts.pop(k)
                take_over(out, event)
                with rt.permit("train", f"{job.job_id}:train"):
                    state, rec = job.train_phase(state, b, out)
                del out
                sync = (_weights_for_rollout(state["params"], snapshot)
                        if k + 1 < steps else None)
                with cv:
                    if sync is not None:
                        shared["sync"] = sync            # weight sync
                    shared["trained"] = k + 1
                    cv.notify_all()
                del sync
                rec = {"step": k, **rec, "rollout_staleness": k - version}
                history.append(rec)
                _log(rec, log_every)
    except BaseException:
        with cv:
            if shared["err"] is None:
                shared["err"] = RuntimeError("train loop aborted")
            cv.notify_all()
        raise
    finally:
        t.join()
    return state, history, _report("pipeline", rt, time.perf_counter() - t0)


def run_coexec(jobs: list[GRPOJob], *, host_cache_gb: float = 8.0,
               runtime: Optional[RollMuxRuntime] = None, log_every: int = 0):
    """``--mux coexec``: N logical jobs' GRPO loops time-multiplex the
    shared ``rollout`` / ``train`` permit pools (intra-group FIFO =
    round-robin once saturated), one thread per job with a CUDA stream per
    pool.  While one job holds the train permit, another's rollout drains
    through its engine.

    Per-job state lives in the host actor cache between phases
    (``RollMuxRuntime.phase`` offloads after, warm-starts before), and the
    weight sync pushes freshly trained params into the job's rollout
    entry, so each job computes exactly what it would alone: only the
    schedule changes.  Every job is seeded from its ``init_state()``
    before any phase runs; the phases work on restored copies, so the
    weights a job was given are never updated.

    Returns ``(states, histories, report)`` keyed by ``job_id``."""
    rt = runtime or RollMuxRuntime(host_cache_gb=host_cache_gb)
    rt.pool("rollout", 1)
    rt.pool("train", 1)
    for job in jobs:
        state0 = job.init_state()
        rt.seed_state(job.job_id, "train", state0)
        rt.seed_state(job.job_id, "rollout", {"params": state0["params"]})
        del state0
    histories: dict[str, list] = {j.job_id: [] for j in jobs}
    errors: dict[str, BaseException] = {}

    def make_loop(job: GRPOJob):
        jid = job.job_id

        @rt.phase("rollout", name="roll")
        def roll(rstate, k):
            b, out = job.rollout_step(rstate["params"], k)
            return rstate, (b, out)

        @rt.phase("train", name="train")
        def train(tstate, b, out):
            tstate, rec = job.train_phase(tstate, b, out)
            return tstate, (tstate["params"], rec)

        def loop():
            streams = PhaseStreams(job.device)
            try:
                for k in range(job.steps):
                    with streams("rollout"):
                        b, out = roll(jid, k)
                        event = hand_over(out)
                    with streams("train"):
                        take_over(out, event)
                        new_params, rec = train(jid, b, out)
                        # weight sync: trained params -> this job's
                        # rollout entry of the actor cache
                        with telemetry.span("sync", job=jid):
                            rt.cache.offload(f"{jid}/rollout",
                                             {"params": new_params})
                    del out, new_params
                    rec = {"step": k, **rec, "rollout_staleness": 0}
                    histories[jid].append(rec)
                    _log(rec, log_every, jid)
            except BaseException as e:
                errors[jid] = e
        return loop

    t0 = time.perf_counter()
    threads = [threading.Thread(target=make_loop(j), name=j.job_id)
               for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        jid, e = next(iter(errors.items()))
        raise RuntimeError(f"co-executed job {jid} failed") from e
    wall = time.perf_counter() - t0
    states = {}
    for job in jobs:
        state, _ = rt.cache.restore(f"{job.job_id}/train")
        states[job.job_id] = state
        # the restore returns with its copies queued: finish them, so that
        # the states are whole on any stream and the cache may go
        sync_current_stream(job.device)
    return states, histories, _report("coexec", rt, wall)
