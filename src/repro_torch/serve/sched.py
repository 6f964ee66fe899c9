"""Pluggable admission policies for the serving engine.

The engine's scheduler loop asks its policy one question per admission
attempt: *given the waiting queue and an admissibility oracle, which
request (by queue position) goes into the next free slot?*  Everything
else — slot assignment, prefill, block accounting — stays in the engine,
so policies are pure host-side decision logic and trivially unit-testable.

Three policies ship (``launch/serve.py --sched``, ``launch/train.py
--sched``):

* :class:`FIFOPolicy` — strict arrival order, the PR 3 behaviour: the head
  is admitted iff it fits, and is never skipped.  Greedy engine output is
  the baseline every other policy must match token-for-token (admission
  order can change *when* a request decodes, never *what* it decodes —
  per-slot decode is independent).
* :class:`DeadlinePolicy` — earliest-deadline-first with **bounded head
  skipping** and **per-job token budgets**.  When the EDF head does not
  fit (no slot / not enough KV blocks / job over budget) a later
  admissible request may overtake it, but each waiting request may be
  overtaken by *newer* arrivals at most ``max_skips`` times: after that it
  becomes a barrier — no younger request is admitted before it — so its
  remaining wait is bounded by the drain time of requests already ahead
  of it (the no-starvation property ``tests/test_serve_sched.py`` sweeps).
  ``token_budgets`` caps each job's in-flight decode tokens so one job's
  burst cannot monopolise the slot pool of a co-executed engine.
* :class:`SLOPolicy` — the deadline policy fed by the **inter-group SLO
  contract**: requests without an explicit deadline get one derived from
  the co-execution group's admitted slowdown bound
  (``CoExecutionGroup.slowdown_bound`` / ``InterGroupScheduler.
  slo_contract``): ``arrival + slowdown * est_solo_latency`` where the
  solo-latency estimate is the request's decode budget times a per-token
  service-time estimate.  The engine thereby *enforces* per-request what
  the planner *promised* per-job: co-executed rollout traffic stays
  inside its slowdown bound under contention.
"""
from __future__ import annotations

import math
from typing import Callable, Mapping, Optional, Sequence

from repro_torch.serve.request import Request

_INF = math.inf


class SchedulerPolicy:
    """Admission-decision interface (host-side, stateful per engine).

    ``pick`` returns the queue position of the next request to admit, or
    ``None`` when nothing admissible should be admitted right now.  It is
    called repeatedly within one scheduler tick (the engine loops until it
    returns ``None``), with ``live_tokens`` reflecting admissions already
    made this tick.
    """

    name = "base"

    def pick(self, waiting: Sequence[Request],
             can_admit: Callable[[Request], bool], *,
             now: float = 0.0,
             live_tokens: Optional[Mapping[str, int]] = None
             ) -> Optional[int]:
        raise NotImplementedError

    def observe_finish(self, out) -> None:
        """Optional hook: a request finished (SLO policies fall back to
        refining their service-time estimate from it when no step
        measurements have been seen)."""

    def observe_step(self, service_s: float, tokens: int) -> None:
        """Optional hook the engine calls after every decode dispatch:
        ``tokens`` decode steps (one token per live slot each) took
        ``service_s`` of wall time, measured around the device call.  SLO
        policies feed this straight into their per-token estimate — the
        engine's own ``step()`` accounting, not a finish-time heuristic."""

    def on_reset(self) -> None:
        """Optional hook ``Engine.reset`` calls between request batches.
        Policies drop *per-request* bookkeeping here (rids repeat across
        GRPO iterations on a persistent engine) but must keep measured
        *hardware* state: the engine keeps its jit cache across resets, so
        anything calibrated against compilation — the SLO policy's
        first-sample discard — must not re-trigger."""

    def on_backend_change(self) -> None:
        """Optional hook ``Engine.set_kernel_backend`` calls when the decode
        kernel backend flips on an (idle) engine.  Unlike ``on_reset``,
        measured *hardware* state is exactly what is now stale: per-token
        service times learned against one backend's kernels say nothing
        about the other's, and the new backend's first step re-compiles."""


class FIFOPolicy(SchedulerPolicy):
    """Strict arrival order; the head is never skipped (PR 3 semantics)."""

    name = "fifo"

    def pick(self, waiting, can_admit, *, now=0.0, live_tokens=None):
        if waiting and can_admit(waiting[0]):
            return 0
        return None


class DeadlinePolicy(SchedulerPolicy):
    """EDF admission with bounded head skipping and per-job token budgets.

    Ordering key: ``(expired?, deadline (None = +inf), -priority, arrival
    seq)`` — already-expired requests are served best-effort *last* (EDF
    under overload would otherwise spend every slot on doomed work, since
    missed deadlines sort earliest).  A request whose admission is refused
    while a *newer* request is admitted counts one skip; at ``max_skips``
    it becomes a barrier (only requests that arrived before it may still
    be admitted), which bounds every request's wait — see the module
    docstring.
    """

    name = "deadline"

    def __init__(self, *, max_skips: int = 4,
                 token_budgets: Optional[Mapping[str, int]] = None):
        if max_skips < 0:
            raise ValueError("max_skips must be >= 0")
        self.max_skips = max_skips
        self.token_budgets = dict(token_budgets or {})
        self._seq: dict[int, int] = {}      # rid -> arrival sequence number
        self._skips: dict[int, int] = {}    # rid -> times overtaken by newer
        self._owner: dict[int, int] = {}    # rid -> queue identity
        self._next_seq = 0

    # -- bookkeeping --------------------------------------------------------
    def _note(self, waiting: Sequence[Request]) -> None:
        # One policy object may drive several queues (the disagg router
        # shares it across all prefill engines so per-job budgets and the
        # SLO service-time estimate are global).  Rids are pruned per
        # *queue* — keyed on the queue object's identity — so a pick on
        # engine A never drops the arrival seqs / skip counts of requests
        # still waiting on engine B.
        qid = id(waiting)
        for r in waiting:
            if r.rid not in self._seq:
                self._seq[r.rid] = self._next_seq
                self._next_seq += 1
            self._owner[r.rid] = qid
        live = {r.rid for r in waiting}
        for rid in [rid for rid, owner in self._owner.items()
                    if owner == qid and rid not in live]:
            self._seq.pop(rid, None)
            self._skips.pop(rid, None)
            self._owner.pop(rid, None)

    def effective_deadline(self, req: Request, now: float) -> float:
        return _INF if req.deadline is None else req.deadline

    def _within_budget(self, req: Request,
                       live_tokens: Mapping[str, int]) -> bool:
        if req.job_id is None or req.job_id not in self.token_budgets:
            return True
        budget = self.token_budgets[req.job_id]
        return live_tokens.get(req.job_id, 0) + req.max_new_tokens <= budget

    # -- decision -----------------------------------------------------------
    def pick(self, waiting, can_admit, *, now=0.0, live_tokens=None):
        if not waiting:
            return None
        live_tokens = live_tokens or {}
        self._note(waiting)

        def key(i):
            r = waiting[i]
            dl = self.effective_deadline(r, now)
            # EDF is only optimal while the queue is feasible: under
            # overload, already-expired requests carry the *earliest*
            # deadlines and would hog every slot while still-feasible work
            # misses too.  Expired requests are served, but last
            # (best-effort), which keeps attainment from collapsing.
            # EXCEPT once a request has hit max_skips: demoting a starving
            # request for being expired would re-open the starvation window
            # the barrier exists to close — it blocks younger work (below)
            # yet would itself wait behind *all* other work, wedging the
            # queue under expired-heavy overload.  A starving request keeps
            # its EDF position regardless of expiry.
            starving = self._skips.get(r.rid, 0) >= self.max_skips
            return (dl < now and not starving, dl, -r.priority,
                    self._seq[r.rid])

        order = sorted(range(len(waiting)), key=key)
        # starvation barrier: once any request has been overtaken max_skips
        # times, only requests at least as old as the oldest such request
        # may still be admitted (its wait is then bounded by the drain of
        # already-admitted + strictly-older work).
        blocked = [self._seq[r.rid] for r in waiting
                   if self._skips.get(r.rid, 0) >= self.max_skips]
        barrier = min(blocked) if blocked else None
        for i in order:
            req = waiting[i]
            if barrier is not None and self._seq[req.rid] > barrier:
                continue
            if not self._within_budget(req, live_tokens):
                continue
            if not can_admit(req):
                continue
            chosen_seq = self._seq[req.rid]
            for r in waiting:
                if r.rid != req.rid and self._seq[r.rid] < chosen_seq:
                    self._skips[r.rid] = self._skips.get(r.rid, 0) + 1
            return i
        return None

    def on_reset(self) -> None:
        """Drop per-request state between batches.  ``_note`` prunes rids
        that leave the queue, but on a persistent engine the *last* batch's
        rids repeat in the next one (GRPO rows are always 0..B-1): a stale
        entry would hand a fresh request an ancient arrival seq — and any
        stale skip count could make it an instant barrier."""
        self._seq.clear()
        self._skips.clear()
        self._owner.clear()


class SLOPolicy(DeadlinePolicy):
    """Deadline admission driven by the co-execution group's SLO contract.

    ``slowdown`` is the admitted slowdown bound exported by the inter-group
    scheduler (``InterGroupScheduler.slo_contract()[job_id]`` — worst-case
    iteration time at most ``slowdown`` x solo).  A request without an
    explicit deadline gets ``arrival + slowdown * est_solo_latency``, with
    ``est_solo_latency = time_per_token * max_new_tokens`` (decode
    dominates rollout serving).

    The per-token estimate comes from the engine's own ``step()``
    accounting: every decode dispatch reports its measured service time
    via :meth:`observe_step` and the estimate tracks it directly (light
    EMA to smooth scheduler-tick jitter; the first sample — which carries
    jit compilation — only seeds it).  ``observe_finish`` remains as a
    fallback for drivers that never run a real engine (policy unit tests,
    simulators): it refines from finished requests, but only until the
    first step measurement arrives — engine-measured service time always
    wins over the finish-interval heuristic.
    """

    name = "slo"

    def __init__(self, *, slowdown: float = 2.0,
                 time_per_token: float = 0.05, ema: float = 0.2,
                 max_skips: int = 4,
                 token_budgets: Optional[Mapping[str, int]] = None):
        super().__init__(max_skips=max_skips, token_budgets=token_budgets)
        if slowdown < 1.0:
            raise ValueError("slowdown bound must be >= 1 (x solo latency)")
        self.slowdown = slowdown
        self.time_per_token = time_per_token
        self._initial_time_per_token = time_per_token
        self.ema = ema
        self._step_samples = 0      # engine step() measurements consumed

    @classmethod
    def from_contract(cls, contract: Mapping[str, float], job_id: str,
                      **kw) -> "SLOPolicy":
        """Build the policy a job's engine enforces from the inter-group
        scheduler's exported contract (``slo_contract()``)."""
        return cls(slowdown=contract[job_id], **kw)

    def effective_deadline(self, req: Request, now: float) -> float:
        if req.deadline is not None:
            return req.deadline
        est_solo = self.time_per_token * req.max_new_tokens
        return req.arrival_time + self.slowdown * est_solo

    def on_reset(self) -> None:
        # Per-request bookkeeping goes (rids repeat across batches); the
        # measured service-time state — ``time_per_token`` and the
        # ``_step_samples`` counter — stays.  ``Engine.reset`` keeps the
        # jit cache, so the next batch's first decode step is NOT
        # compile-contaminated: re-triggering the first-sample discard
        # would throw away a clean measurement and leave low-sample
        # estimates skewed toward whatever the previous batch ended on.
        super().on_reset()

    def on_backend_change(self) -> None:
        # The learned per-token estimate was measured against the *old*
        # backend's kernels; carrying it across the flip would admit (or
        # reject) against fiction.  Fall back to the configured prior and
        # re-arm the first-sample discard: the new backend's first decode
        # step pays a fresh jit compile.
        self.time_per_token = self._initial_time_per_token
        self._step_samples = 0

    def observe_step(self, service_s: float, tokens: int) -> None:
        # The engine's own decode accounting: ``tokens`` decode steps took
        # ``service_s`` measured around the device dispatch + host sync.
        # The very first sample per engine shape carries jit compilation
        # and is discarded; the next one initializes the estimate directly
        # and later samples converge fast (EMA over steps, not finishes —
        # every tick contributes, so the estimate tracks load changes
        # within one batch of requests).
        # ``tokens < 1`` guards the zero-decode-steps path (a tick that
        # admitted but ran no decode): dividing by it would poison the
        # estimate with inf/NaN, which every later EMA step inherits.
        if tokens < 1 or service_s < 0:
            return
        self._step_samples += 1
        if self._step_samples == 1:
            return                      # compile-contaminated; discard
        per_tok = service_s / tokens
        if self._step_samples == 2:
            self.time_per_token = per_tok
        else:
            a = max(self.ema, 0.3)      # steps are plentiful; track fast
            self.time_per_token = ((1 - a) * self.time_per_token
                                   + a * per_tok)

    def observe_finish(self, out) -> None:
        # Fallback only: once the engine has consumed a real step()
        # measurement (sample 2+ — sample 1 is discarded as compile
        # noise, so it must not retire the fallback alone), the
        # finish-interval heuristic is dropped — it under-measures
        # whenever a request's budget fits one fused decode block and it
        # never sees prefill-era service time at all.
        if self._step_samples > 1:
            return
        # Refine from *service* time (first token -> finish), never total
        # latency: latency includes queueing delay, and folding that into
        # the estimate would loosen deadlines exactly under the contention
        # the contract is supposed to bound.  Requests whose whole budget
        # fits one fused decode block land with finish == first_token
        # (zero observable service interval) and are skipped.
        if out.num_tokens >= 2 and out.finish_time > out.first_token_time > 0:
            per_tok = ((out.finish_time - out.first_token_time)
                       / (out.num_tokens - 1))
            self.time_per_token = ((1 - self.ema) * self.time_per_token
                                   + self.ema * per_tok)


def make_policy(name: str, **kwargs) -> SchedulerPolicy:
    """Policy factory behind the ``--sched fifo|deadline|slo`` flags."""
    policies = {"fifo": FIFOPolicy, "deadline": DeadlinePolicy,
                "slo": SLOPolicy}
    if name not in policies:
        raise ValueError(f"unknown scheduler policy {name!r} "
                         f"(choose from {sorted(policies)})")
    return policies[name](**kwargs)
