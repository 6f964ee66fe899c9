"""Phase-centric control model (paper §5.1): ``@rollmux.phase`` decorator,
run permits, warm-start state management, and runtime hooks.

The execution plane is in-process: resource pools are permit queues, job
states live in a HostStateCache between phases (a copy back to the
device = warm start), and the intra-group FIFO queues drive the round-robin schedule.

Executed phases leave measured per-phase timelines behind
(:attr:`PermitPool.timeline`); :meth:`RollMuxRuntime.phase_profiles`
distills them into :class:`PhaseProfile` records the co-execution
simulator consumes in place of modeled worst-case durations
(``core.simulator.simulate_profiles``) — served, not modeled, phase times
drive the multiplexing decisions.

Counterpart of ``repro/core/phase_control.py``.  A phase ends with
``torch.cuda.synchronize()`` on the state's card where the JAX package
blocks until its arrays are ready.  Not ported yet: ``PhaseProfile.to_job``
(it feeds the co-execution simulator, ``core/job.py``) and
``RollMuxRuntime.metrics`` (the elastic controller's telemetry); both come
with the slices that port those modules (ROADMAP).
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.train.checkpoints import HostStateCache
from repro_torch.train.optimizer import tree_leaves


def _synchronize(state) -> None:
    """Wait for the card that holds ``state`` (a no-op on the CPU)."""
    leaves = tree_leaves(state)
    if leaves and leaves[0].device.type == "cuda":
        torch.cuda.synchronize(leaves[0].device)


class PermitPool:
    """A resource pool (e.g. 'rollout', 'train') with FIFO run permits —
    the per-worker queue of §5.1."""

    def __init__(self, name: str, capacity: int = 1):
        self.name = name
        self.capacity = capacity
        self._cv = threading.Condition()
        self._queue: deque[int] = deque()
        self._active = 0
        self._ticket = 0
        self.busy_time = 0.0
        self.timeline: list[tuple[str, float, float]] = []  # (who, t0, t1)

    def acquire(self) -> int:
        with self._cv:
            self._ticket += 1
            my = self._ticket
            self._queue.append(my)
            while self._queue[0] != my or self._active >= self.capacity:
                self._cv.wait()
            self._queue.popleft()
            self._active += 1
            return my

    def release(self) -> None:
        with self._cv:
            self._active -= 1
            self._cv.notify_all()

    def resize(self, capacity: int) -> None:
        """Retune the pool's permit count on a live pool (the elastic
        controller's actuator).  Growing wakes waiters immediately; when
        shrinking, permits already held are never revoked — the pool
        simply stops admitting until ``_active`` drains below the new
        capacity (``acquire`` re-checks the bound under the condition
        variable)."""
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        with self._cv:
            self.capacity = capacity
            self._cv.notify_all()

    @property
    def waiting(self) -> int:
        """Tickets queued behind the permit bound (telemetry gauge)."""
        with self._cv:
            return len(self._queue)


@dataclass
class PhaseStats:
    runs: int = 0
    warm_starts: int = 0
    cold_starts: int = 0
    switch_time: float = 0.0
    run_time: float = 0.0
    wait_time: float = 0.0


@dataclass(frozen=True)
class PhaseProfile:
    """Engine-measured per-phase timeline of one job: every executed rollout
    and training phase duration, in order.  This is the bridge from the real
    execution plane to the planner: where ``RLJob`` carries *modeled*
    worst-case durations, a profile carries what the serving engine and
    train step actually took (worst-case = max observed)."""
    job_id: str
    rollout_s: tuple[float, ...] = ()
    train_s: tuple[float, ...] = ()
    # reward-verification phase durations (the third permit pool): empty
    # for executors that verify inline on the critical path; the streaming
    # mux (``rl.stream``) populates it with per-group verifier times.
    reward_s: tuple[float, ...] = ()
    # KV transfer durations (disaggregated prefill->decode hand-over,
    # ``serve.router.DisaggRouter`` under a runtime): empty for monolithic
    # engines.  Transfers sit on the rollout critical path — a handle must
    # be adopted before its decode starts.
    transfer_s: tuple[float, ...] = ()

    @property
    def t_roll(self) -> float:
        """Worst-case (admission-bound) rollout duration."""
        return max(self.rollout_s, default=0.0)

    @property
    def t_transfer(self) -> float:
        """Worst per-iteration KV-transfer total (many permits per
        iteration — one per adopted handle — hence the chunked max, same
        accounting as reward/train)."""
        return self._worst_iteration_total(self.transfer_s)

    def _worst_iteration_total(self, xs: tuple[float, ...]) -> float:
        """Worst per-*iteration* total of a phase that may take several
        permits per iteration (the streaming executor holds one reward
        permit per GRPO group and one train permit per micro-step).  The
        per-permit durations are in execution order with a uniform count
        per iteration, so chunking them evenly and taking the heaviest
        chunk gives the iteration-level worst case the conservative
        admission planner needs — a plain ``max`` over permits would
        under-report the phase load by the groups-per-iteration factor."""
        if not xs:
            return 0.0
        it = max(self.iterations, 1)
        per = max(-(-len(xs) // it), 1)             # ceil division
        return max(sum(xs[i:i + per])
                   for i in range(0, len(xs), per))

    @property
    def t_train(self) -> float:
        return self._worst_iteration_total(self.train_s)

    @property
    def t_reward(self) -> float:
        return self._worst_iteration_total(self.reward_s)

    @property
    def t_roll_mean(self) -> float:
        return sum(self.rollout_s) / max(len(self.rollout_s), 1)

    @property
    def t_train_mean(self) -> float:
        return sum(self.train_s) / max(len(self.train_s), 1)

    @property
    def t_reward_mean(self) -> float:
        return sum(self.reward_s) / max(len(self.reward_s), 1)

    @property
    def iterations(self) -> int:
        return min(len(self.rollout_s), len(self.train_s))


class RollMuxRuntime:
    """In-process execution plane shared by the co-executing jobs."""

    def __init__(self, host_cache_gb: float = 64.0):
        self.pools: dict[str, PermitPool] = {}
        self.cache = HostStateCache(int(host_cache_gb * 2**30))
        self.stats: dict[str, PhaseStats] = {}
        self.hooks: list[Callable[[str, str, str], None]] = []
        self._t0 = time.perf_counter()

    def pool(self, name: str, capacity: int = 1) -> PermitPool:
        if name not in self.pools:
            self.pools[name] = PermitPool(name, capacity)
        return self.pools[name]

    def runtime_hook(self, fn: Callable) -> Callable:
        """@rollmux.runtime_hook — called as fn(job_id, phase, event)."""
        self.hooks.append(fn)
        return fn

    def _emit(self, job_id: str, phase_name: str, event: str) -> None:
        for h in self.hooks:
            h(job_id, phase_name, event)

    def phase(self, pool: str, name: Optional[str] = None, *,
              init_fn: Optional[Callable] = None):
        """Decorator: wraps a phase function into a schedulable entity.

        The wrapped function signature becomes fn(job_id, *args) and receives
        the job's restored state as first arg: fn(state, *args) -> (state, out).
        State is offloaded to host DRAM after the phase (lightweight
        suspension: the compiled executables — the control plane — stay
        alive, only data-plane arrays move).
        """
        def deco(fn):
            pname = name or fn.__name__

            @functools.wraps(fn)
            def wrapped(job_id: str, *args, **kwargs):
                key = f"{job_id}/{pool}"
                st = self.stats.setdefault(f"{job_id}:{pname}", PhaseStats())
                t_req = time.perf_counter()
                p = self.pool(pool)
                p.acquire()                       # run permit (intra-group FIFO)
                try:
                    t_start = time.perf_counter()
                    st.wait_time += t_start - t_req
                    self._emit(job_id, pname, "start")
                    state, sw = self.cache.restore(key)
                    if state is None:             # cold start
                        t0 = time.perf_counter()
                        if init_fn is None:
                            raise RuntimeError(
                                f"no cached state and no init_fn for {key}")
                        state = init_fn()
                        sw = time.perf_counter() - t0
                        st.cold_starts += 1
                    else:
                        st.warm_starts += 1
                    st.switch_time += sw
                    state, out = fn(state, *args, **kwargs)
                    _synchronize(state)
                    self.cache.offload(key, state)  # suspend: data plane out
                    t_end = time.perf_counter()
                    st.run_time += t_end - t_start
                    st.runs += 1
                    p.timeline.append((f"{job_id}:{pname}", t_start - self._t0,
                                       t_end - self._t0))
                    p.busy_time += t_end - t_start
                    self._emit(job_id, pname, "end")
                    return out
                finally:
                    p.release()

            wrapped.pool_name = pool
            wrapped.phase_name = pname
            return wrapped
        return deco

    @contextlib.contextmanager
    def permit(self, pool: str, who: str, capacity: int = 1):
        """Run-permit scope without the state-offload machinery of
        :meth:`phase`: acquire the pool's FIFO permit, run the body, record
        the busy interval on the pool timeline.  The mux executors use this
        for phases whose state stays in the driver (e.g. the pipelined
        single-job trainer, where params are handed over directly instead
        of through the actor cache)."""
        p = self.pool(pool, capacity)
        p.acquire()
        t_start = time.perf_counter()
        try:
            yield p
        finally:
            t_end = time.perf_counter()
            p.timeline.append((who, t_start - self._t0, t_end - self._t0))
            p.busy_time += t_end - t_start
            p.release()

    def seed_state(self, job_id: str, pool: str, state) -> None:
        """Pre-populate the actor cache (Init phase of the dependency graph)."""
        self.cache.offload(f"{job_id}/{pool}", state)

    def phase_profiles(self, *, rollout_pool: str = "rollout",
                       train_pool: str = "train",
                       reward_pool: str = "reward",
                       transfer_pool: str = "transfer"
                       ) -> dict[str, PhaseProfile]:
        """Distill the executed pool timelines into per-job
        :class:`PhaseProfile` records (measured durations, in execution
        order).  Timeline entries are tagged ``"job:phase"`` by both
        :meth:`phase` and :meth:`permit`.  The reward and transfer pools
        are optional — executors that verify inline / serve monolithically
        never create them and the profiles simply carry no such
        durations (the transfer pool is populated by a
        ``serve.router.DisaggRouter`` given this runtime: each
        prefill→decode KV hand-over takes a permit there)."""
        roll: dict[str, list[float]] = {}
        train: dict[str, list[float]] = {}
        reward: dict[str, list[float]] = {}
        transfer: dict[str, list[float]] = {}
        for pool_name, acc in ((rollout_pool, roll), (train_pool, train),
                               (reward_pool, reward),
                               (transfer_pool, transfer)):
            p = self.pools.get(pool_name)
            if p is None:
                continue
            for who, t0, t1 in p.timeline:
                acc.setdefault(who.split(":")[0], []).append(t1 - t0)
        return {jid: PhaseProfile(jid, tuple(roll.get(jid, ())),
                                  tuple(train.get(jid, ())),
                                  tuple(reward.get(jid, ())),
                                  tuple(transfer.get(jid, ())))
                for jid in sorted(set(roll) | set(train) | set(reward)
                                  | set(transfer))}
