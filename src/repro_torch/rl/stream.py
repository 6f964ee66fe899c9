"""Streaming phase mux (``--mux stream``): group-level rollout -> reward ->
train pipelining behind a reward permit pool.

Counterpart of ``repro/rl/stream.py``.  The pipeline executor
(:func:`repro_torch.rl.coexec.run_pipelined`) overlaps whole phases; this
one pipelines inside an iteration:

* **Group streaming**: the engine yields each GRPO prompt group the moment
  its last member finishes decoding
  (``rl.rollout.generate_continuous_stream`` over ``Engine.harvest``).
* **Reward permit pool**: a third pool (capacity ``reward_workers``) runs
  the verifiers on host threads, off the critical path; a group goes to a
  reward worker as soon as it streams out of the engine.
* **Micro-batched training**: by default one optimizer step per iteration
  over the re-assembled batch (bit-exact to the pipeline and sequential
  paths); ``micro_groups=m`` steps on every ``m`` rewarded groups in
  completion order instead.
* **Staleness**: the rollout of iteration ``k`` may start once ``trained
  >= k - max_staleness``, on the newest synced weights; every record
  carries ``rollout_staleness`` and the clipped importance-ratio
  diagnostics.

On the card the rollout thread and the train loop each run on their own
CUDA stream; the reward workers stay on the host.  Wherever a rollout may
run while the optimizer updates the weights in place (staleness >= 1, or
micro-steps that start before the iteration's last group), each weight
sync hands the rollout a snapshot.

* **Elastic reward pool** (``elastic=True``): between iterations the
  runtime's telemetry retunes the reward permit count within ``[1,
  reward_workers]``.
* **Partial-rollout carry** (a job with ``carry=True``, engine rollout):
  the rollout polls the newest synced weights between engine ticks and
  swaps them into the live engine (``Engine.reset(carry_live=True)``), so
  the stragglers finish on them; each record counts the rows whose tokens
  mix weight versions.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.core.phase_control import (PhaseStreams, RollMuxRuntime,
                                            take_over)
from repro_torch.rl.coexec import (GRPOJob, _log, _raise_first, _report,
                                   _rollout_counts, _weights_for_rollout)

__all__ = ["run_streaming"]


def _assemble_out(b, gouts: list[dict], group: int, device) -> dict:
    """Stack streamed group dicts into the batch rollout's output layout,
    as tensors on ``device`` (made on the current stream).

    ``gouts`` in row order reproduces ``generate_continuous``'s arrays bit
    for bit; in completion order (micro-batching) the rows are permuted
    and each group still lines up with its own advantages."""
    rows = np.concatenate([np.asarray(g["rows"], np.int64) for g in gouts])
    prompts = np.repeat(np.asarray(b.prompts, np.int32), group, axis=0)[rows]
    out = {k: torch.from_numpy(np.concatenate([g[k] for g in gouts]))
           .to(device) for k in ("completions", "behavior_logp", "mask")}
    out["prompts"] = torch.from_numpy(prompts).to(device)
    out["tokens"] = torch.cat([out["prompts"], out["completions"]], dim=1)
    return out


def _merge_recs(recs: list[dict]) -> dict:
    """Collapse an iteration's micro-step records into one history row:
    token-weighted means for rates, sums for counts, the largest
    ``ratio_max`` and ``grad_norm``."""
    if len(recs) == 1:
        return dict(recs[0])
    toks = np.asarray([max(r["tokens"], 1) for r in recs], np.float64)
    w = toks / toks.sum()
    out = {key: float(sum(wi * r[key] for wi, r in zip(w, recs)))
           for key in ("reward", "acc", "loss", "entropy", "clip_frac",
                       "ratio_mean")}
    for key in ("ratio_max", "grad_norm"):
        out[key] = float(max(r[key] for r in recs))
    out["tokens"] = int(sum(r["tokens"] for r in recs))
    return out


def run_streaming(job: GRPOJob, *, max_staleness: int = 1,
                  reward_workers: int = 2,
                  micro_groups: Optional[int] = None,
                  runtime: Optional[RollMuxRuntime] = None,
                  log_every: int = 0, elastic: bool = False):
    """``--mux stream``: group-level rollout -> reward -> train pipelining.

    * the **rollout thread** holds the ``rollout`` permit while the engine
      streams completed prompt groups, each handed to a reward worker at
      once (the engine keeps decoding);
    * ``reward_workers`` **reward workers** verify groups under the
      ``reward`` permit pool (capacity = worker count);
    * the **train loop** (this thread) consumes rewarded groups under the
      ``train`` permit: one optimizer step per iteration over the
      re-assembled batch, or one every ``micro_groups`` rewarded groups.

    With ``max_staleness=0``, instant rewards and the full-batch trainer
    the losses and weights are bit-exact to the sequential run.  Returns
    ``(state, history, report)``; the report's timelines include the
    ``reward`` pool.  Each record carries ``rollout_staleness``,
    ``micro_steps``, the engine rollout's ``prefills`` and
    ``decode_steps``, and, as the JAX package's, ``carried_rows`` (rows
    whose tokens mix weight versions) and ``behavior_versions`` (the
    distinct weight versions that sampled the iteration's batch).

    ``job.carry`` (engine rollout) wires partial-rollout continuation:
    the rollout polls the weight version, which every optimizer step's
    sync advances, between engine ticks, and when it moved swaps the newest
    weights into the live engine (``Engine.reset(carry_live=True)``) on the
    rollout thread's stream.

    ``elastic=True`` closes the capacity loop on the reward pool, as the
    JAX package's executor does: after each iteration, queued reward work
    (the pool's ``waiting`` gauge) grows the permit count by one toward
    ``reward_workers``, and a pool busy less than 0.2 of the run so far
    (``rt.metrics().pool_busy_frac``) with nothing waiting shrinks it by
    one, never below 1 (:meth:`PermitPool.resize`).  The worker threads
    stay ``reward_workers``; only the permit bound moves, so the losses
    are those of the run without it.  Each record then carries
    ``reward_permits``."""
    if max_staleness < 0:
        raise ValueError("max_staleness must be >= 0")
    if reward_workers < 1:
        raise ValueError("reward_workers must be >= 1")
    if micro_groups is not None and micro_groups < 1:
        raise ValueError("micro_groups must be >= 1 (or None)")
    rt = runtime or RollMuxRuntime()
    rt.pool("rollout", 1)
    rt.pool("train", 1)
    rt.pool("reward", reward_workers)
    steps = job.steps
    n_groups = job.batch                    # one GRPO group per task prompt
    # a micro-step may start while the engine still decodes the
    # iteration's stragglers, so it too needs the rollout on a snapshot
    snapshot = max_staleness > 0 or micro_groups is not None
    state = job.init_state()
    cv = threading.Condition()
    # "version" counts weight syncs (optimizer steps), finer than
    # "trained" (iterations): the carry path polls it mid-rollout
    shared = {"sync": _weights_for_rollout(state["params"], snapshot),
              "trained": 0, "version": 0, "err": None}
    batches: dict[int, object] = {}         # k -> task batch (answers)
    versions: dict[int, int] = {}           # k -> behaviour-weight version
    rollout_stats: dict[int, object] = {}   # k -> the rollout's metrics()
    rewarded: dict[int, list] = {}          # k -> [(gout, rewards)] arrivals
    history = []
    pool = ThreadPoolExecutor(max_workers=reward_workers,
                              thread_name_prefix=f"{job.job_id}-reward")
    t0 = time.perf_counter()

    def fail(e: BaseException) -> None:
        with cv:
            if shared["err"] is None:
                shared["err"] = e
            cv.notify_all()

    def reward_task(k: int, gout: dict) -> None:
        try:
            with rt.permit("reward", f"{job.job_id}:reward",
                           capacity=reward_workers):
                r = job.reward_group(batches[k], gout)
            with cv:
                rewarded.setdefault(k, []).append((gout, r))
                cv.notify_all()
        except BaseException as e:          # surface into the train loop
            fail(e)

    taken_version = None

    def sync_fn():
        """The newest synced weights and their version, polled by the
        engine rollout between ticks (``job.carry`` only), taken over on
        the rollout thread's stream when the version moved."""
        nonlocal taken_version
        with cv:
            (params, event), version = shared["sync"], shared["version"]
        if version != taken_version:
            take_over(params, event)
            taken_version = version
        return params, version

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
                        versions[k] = shared["trained"]
                    take_over(params, event)

                    def publish(b, k=k):
                        with cv:
                            batches[k] = b
                    with rt.permit("rollout", f"{job.job_id}:roll"):
                        _, stats = job.rollout_stream(
                            params, k,
                            on_group=lambda g, k=k: pool.submit(
                                reward_task, k, g),
                            on_batch=publish,
                            sync_params=sync_fn if job.carry else None)
                    with cv:
                        rollout_stats[k] = stats
                        cv.notify_all()
        except BaseException as e:
            fail(e)

    roll_thread = threading.Thread(target=roll_loop,
                                   name=f"{job.job_id}-rollout")
    try:
        roll_thread.start()
        with PhaseStreams(job.device, ("train",))("train"):
            for k in range(steps):
                recs: list[dict] = []
                consumed = 0
                pending_gouts: list[dict] = []
                pending_rewards: list[np.ndarray] = []
                carried_rows = 0            # rows with mixed weight versions
                vers_seen: set[int] = set()     # versions that sampled them
                want = micro_groups if micro_groups is not None \
                    else n_groups
                while consumed < n_groups:
                    with cv:
                        while not rewarded.get(k) and shared["err"] is None:
                            cv.wait()
                        _raise_first(shared)
                        take, rewarded[k] = rewarded[k], []
                    for gout, _ in take:
                        tv = gout.get("token_versions")
                        if tv is None:
                            continue
                        msk = np.asarray(gout["mask"]) > 0
                        for row in range(tv.shape[0]):
                            vs = tv[row][msk[row]]
                            if vs.size:
                                vers_seen.update(int(v)
                                                 for v in np.unique(vs))
                                carried_rows += int(vs.min() != vs.max())
                    pending_gouts += [g for g, _ in take]
                    pending_rewards += [r for _, r in take]
                    consumed += len(take)
                    while (len(pending_gouts) >= want
                           or (consumed == n_groups and pending_gouts)):
                        m = min(want, len(pending_gouts))
                        gouts, rs = pending_gouts[:m], pending_rewards[:m]
                        del pending_gouts[:m], pending_rewards[:m]
                        if micro_groups is None:
                            # full batch: restore row order, bit-exact
                            order = np.argsort([g["group_index"]
                                                for g in gouts])
                            gouts = [gouts[i] for i in order]
                            rs = [rs[i] for i in order]
                        b = batches[k]
                        out = _assemble_out(b, gouts, job.group, job.device)
                        rewards = np.concatenate(rs).astype(np.float32)
                        # advantages normalise within each GRPO group, so
                        # a micro-step computes what the full batch would
                        # on the same rows
                        with rt.permit("train", f"{job.job_id}:train"):
                            state, rec = job.train_phase(state, b, out,
                                                         rewards=rewards)
                        recs.append(rec)
                        done = consumed == n_groups and not pending_gouts
                        sync = None if done and k + 1 == steps else \
                            _weights_for_rollout(state["params"], snapshot)
                        with cv:
                            if sync is not None:
                                shared["sync"] = sync    # weight sync
                                shared["version"] += 1
                            if done:    # with its weights, atomically
                                shared["trained"] = k + 1
                            cv.notify_all()
                        del sync
                with cv:
                    while k not in rollout_stats and shared["err"] is None:
                        cv.wait()
                    _raise_first(shared)
                    stats = rollout_stats.pop(k)
                    rewarded.pop(k, None)
                    batches.pop(k, None)
                if elastic:
                    rp = rt.pools["reward"]
                    busy = rt.metrics().pool_busy_frac.get("reward", 0.0)
                    if rp.waiting and rp.capacity < reward_workers:
                        rp.resize(rp.capacity + 1)
                    elif busy < 0.2 and rp.capacity > 1 and not rp.waiting:
                        rp.resize(rp.capacity - 1)
                rec = {"step": k, **_merge_recs(recs),
                       **_rollout_counts(stats),
                       "rollout_staleness": k - versions[k],
                       "micro_steps": len(recs),
                       "carried_rows": carried_rows,
                       "behavior_versions": max(len(vers_seen), 1)}
                if elastic:
                    rec["reward_permits"] = rt.pools["reward"].capacity
                history.append(rec)
                _log(rec, log_every)
    except BaseException:
        fail(RuntimeError("train loop aborted"))
        raise
    finally:
        roll_thread.join()
        pool.shutdown(wait=True)
    return state, history, _report("stream", rt, time.perf_counter() - t0)
