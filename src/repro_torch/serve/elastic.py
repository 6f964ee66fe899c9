"""Elastic capacity: closed-loop autoscaling over the engine's telemetry,
and overload admission control that degrades before it sheds.

Counterpart of ``repro/serve/elastic.py``, host code copied case for case.
Three layers, smallest first:

* :func:`resize_engine` / :func:`resize_router`, the actuators.  A resize
  is a rebuild: every live generation is suspended
  (``Engine._suspend_slot``: a paged slot's full blocks pinned in the old
  pool, its tail block and slot rows copied), a new engine is built at the
  new slot count, and the suspended work resumes on it with
  ``continue_output=True``, the machinery weight syncs and tool
  boundaries use, so no live KV is lost and greedy continuation stays
  bit for bit.  Counters (``EngineStats``), finished outputs, the
  admission policy (with its measured service time), the clock and the
  weight version carry over, so telemetry is monotone across resizes.  On
  the card a new engine runs its decode block once on its empty pool
  (:meth:`~repro_torch.serve.engine.Engine.warm_up`) and captures the
  block's CUDA graph on its first tick with work, outside the timed
  window: the counterpart of the JAX package's compile of a new slot
  count.  Controllers walk a small *ladder* of sizes.

* :class:`ElasticController`, the feedback loop.  It reads one
  :class:`~repro_torch.core.telemetry.MetricsSnapshot` from what it
  steers (an ``Engine`` or a ``DisaggRouter``, one API) and grows or
  shrinks along its ladder on queue pressure or occupancy, with
  hysteresis and a cooldown after each resize.  For routers the prefill
  pool scales with the decode pool at the configured ratio.
  ``run_trace`` calls :meth:`ElasticController.attach`,
  :meth:`~ElasticController.admit`, :meth:`~ElasticController.maybe_resize`
  and :meth:`~ElasticController.summary`; the summary lands in the trace
  report under ``"elastic"``.

* Admission control (inside the controller): when the predicted finish
  of a deadline request misses its deadline, the controller first
  *degrades*, clamping ``max_new_tokens`` to the largest budget that still
  fits (greedy tokens of a clamped request are a prefix of the unclamped
  ones), and *sheds* only when even the minimum budget cannot fit.  Sheds
  are recorded, never silent; with no queue the predictor never fires,
  so at sub-saturation nothing is shed.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

__all__ = ["ElasticConfig", "ElasticController", "resize_engine",
           "resize_router", "rederive_slo"]


# ---------------------------------------------------------------------------
# actuators
# ---------------------------------------------------------------------------

def resize_engine(engine, num_slots: int, *, num_kv_blocks="keep",
                  timings: Optional[dict] = None):
    """Rebuild ``engine`` at a new slot count without losing work.

    Live generations are suspended (paged: their full blocks pinned in the
    old pool), queued requests carry over in order, and a new
    :class:`~repro_torch.serve.engine.Engine` is built at ``num_slots``
    with the same model, weights, device, generator and policy.  The
    suspended generations resume on it with ``continue_output=True``:
    tokens, logprobs and per-token weight versions continue where they
    left off.  Stats, finished outputs and the harvest backlog carry over.

    ``num_kv_blocks="keep"`` (default) keeps the old config's paged pool
    sizing (a block count, or ``None`` = scale with ``num_slots``); pass an
    int (or ``None``) to override.

    Handles suspended *before* the resize (agentic tool boundaries) stay
    registered on, and pinned in, the old engine; they resume on the new
    one as on any engine of the same serving shape.  The old pool is
    conservation-checked: once the carried work is re-admitted it holds
    exactly those handles' pins.  The old engine's CUDA graphs are
    released.  ``timings``, when given, receives the host seconds of the
    three parts: ``suspend_s`` (every live slot), ``build_s`` (the new
    engine and its warm-up) and ``resume_s``."""
    from repro_torch.serve.engine import Engine
    if num_slots < 1:
        raise ValueError(f"num_slots must be >= 1, got {num_slots}")
    if num_slots == engine.config.num_slots and num_kv_blocks == "keep":
        return engine
    if engine.num_active > num_slots:
        raise ValueError(
            f"cannot shrink to {num_slots} slots with "
            f"{engine.num_active} live requests; shrink targets must be "
            f"clamped to the live count")
    t0 = time.perf_counter()
    carried = [engine._suspend_slot(slot) for slot in sorted(engine._active)]
    engine.release_graphs()             # a retired engine replays no more
    t1 = time.perf_counter()
    queued = list(engine.queue._q)
    engine.queue._q.clear()
    kw = {"num_slots": num_slots}
    if num_kv_blocks != "keep":
        kw["num_kv_blocks"] = num_kv_blocks
    cfg = dataclasses.replace(engine.config, **kw)
    new = Engine(engine.model, engine.params, cfg, device=engine.device,
                 policy=engine.policy, generator=engine.generator)
    new.warm_up()
    t2 = time.perf_counter()
    new.clock = engine.clock
    new.weight_version = engine.weight_version
    new._slot_version = [engine.weight_version] * num_slots
    new._stats = engine._stats          # counters stay monotone
    new.finished.update(engine.finished)
    new._unharvested.extend(engine._unharvested)
    engine._unharvested = []
    new.queue.rejected = engine.queue.rejected
    if engine.radix is not None:
        # the old tree's snapshots reference the old pool; it must not
        # outlive its engine (the new engine grows its own tree)
        engine.radix.flush()
    for sreq in carried:
        new.resume(sreq, continue_output=True)
    if timings is not None:
        timings.update(suspend_s=t1 - t0, build_s=t2 - t1,
                       resume_s=time.perf_counter() - t2)
    new.queue._q.extend(queued)
    if engine.paged:
        pins = [b for s in engine.suspended.values() for b in s.block_ids]
        if pins:
            engine.slots.check(extra_pins=pins)
        else:
            engine.slots.alloc.assert_clean(context="resize_engine")
    return new


def resize_router(router, *, prefill_slots: Optional[int] = None,
                  decode_slots: Optional[int] = None):
    """Rebuild a :class:`~repro_torch.serve.router.DisaggRouter` at a new
    prefill/decode shape without losing work.

    Live decode generations are suspended and resumed on the new decode
    pool (as in :func:`resize_engine`); prefilled, un-adopted transfer
    handles fold back into waiting requests (their prompt KV is paid again
    by a prefill on the new shape, the exactness argument ``export_state``
    makes) and the combined waiting set is routed over the new prefill
    engines through ``_route``.  Decode counters, transfer counters and
    the shared admission policy carry over."""
    from repro_torch.serve.router import DisaggRouter
    cfg = router.config
    new_cfg = dataclasses.replace(
        cfg,
        prefill_slots=(cfg.prefill_slots if prefill_slots is None
                       else prefill_slots),
        decode_slots=(cfg.decode_slots if decode_slots is None
                      else decode_slots))
    if new_cfg == cfg:
        return router
    if router.decode.num_active > new_cfg.decode_slots:
        raise ValueError(
            f"cannot shrink decode to {new_cfg.decode_slots} slots with "
            f"{router.decode.num_active} live requests")
    # fold un-adopted handles back to waiting requests, release their pins
    for pe in router.prefills:
        router.pending_transfer.extend(pe.pop_ready())
    requeue = [h.req for h in router.pending_transfer]
    router.drop_pending()
    held = [r for pe in router.prefills for r in pe.queue._q]
    for pe in router.prefills:
        pe.queue._q.clear()
        if pe.radix is not None:
            pe.radix.flush()
        if pe.paged:
            pe.slots.alloc.assert_clean(context="resize_router")
    carried = [router.decode._suspend_slot(s)
               for s in sorted(router.decode._active)]
    router.decode.release_graphs()
    new = DisaggRouter(router.model, router.decode.params, new_cfg,
                       device=router.decode.device,
                       generator=router.decode.generator,
                       policy=router.prefill.policy,
                       runtime=router.runtime, job_id=router.job_id)
    new.decode.warm_up()
    new.clock = router.clock
    new.decode.weight_version = router.decode.weight_version
    new.decode._stats = router.decode._stats
    new.decode.finished.update(router.decode.finished)
    new.decode._unharvested.extend(router.decode._unharvested)
    router.decode._unharvested = []
    # prefill and transfer counters stay monotone: seed engine 0's record
    # and the new RouterStats with the old totals
    ps = new.prefills[0].stats
    for pe in router.prefills:
        ps.prefills += pe.stats.prefills
        ps.prefix_hits += pe.stats.prefix_hits
        ps.prefix_partial_hits += pe.stats.prefix_partial_hits
        ps.blocks_saved += pe.stats.blocks_saved
    new.prefills[0].queue.rejected = sum(
        pe.queue.rejected for pe in router.prefills)
    for attr in ("transfers", "transfer_time_s", "transferred_blocks",
                 "kv_routed"):
        setattr(new._stats, attr, getattr(router._stats, attr))
    for sreq in carried:
        new.decode.resume(sreq, continue_output=True)
    new._requeue(requeue + held)
    if router.decode.paged:
        pins = [b for s in router.decode.suspended.values()
                for b in s.block_ids]
        if pins:
            router.decode.slots.check(extra_pins=pins)
        else:
            router.decode.slots.alloc.assert_clean(context="resize_router")
    return new


def rederive_slo(policy, runtime, *, rollout_nodes: int = 1,
                 train_nodes: int = 1, margin: float = 1.0):
    """Re-derive an :class:`~repro_torch.serve.sched.SLOPolicy`'s slowdown
    contract from the DES planner on measured phase profiles, the
    planning half of a capacity change.

    Builds a co-execution group whose job durations are the runtime's
    measured :class:`~repro_torch.core.phase_control.PhaseProfile` records
    (``core.simulator.group_from_profiles``) and installs the group's
    tightest guaranteed slowdown bound as the policy's ``slowdown``.
    Returns the new bound, or ``None`` when the policy carries no contract
    or no profiles exist yet."""
    if not hasattr(policy, "slowdown") or runtime is None:
        return None
    profiles = list(runtime.phase_profiles().values())
    if not profiles:
        return None
    from repro_torch.core.simulator import group_from_profiles
    G = group_from_profiles(profiles, gid="elastic",
                            rollout_nodes=rollout_nodes,
                            train_nodes=train_nodes)
    bound = G.slowdown_bound(margin=margin)
    policy.slowdown = bound
    return bound


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ElasticConfig:
    """Feedback-loop knobs.  Thresholds are in units of the snapshot's
    derived ratios (``queue_pressure`` = waiting per configured slot,
    ``occupancy`` = live per configured slot)."""
    ladder: tuple = (2, 4, 8)        # slot counts the controller may visit
    interval_s: float = 0.25         # min seconds between control decisions
    cooldown_s: float = 0.75         # settle time after a resize
    grow_pressure: float = 1.0       # queue_pressure >= this => grow
    shrink_pressure: float = 0.25    # queue_pressure <= this and ...
    shrink_occupancy: float = 0.5    # ... occupancy <= this => shrink
    shed: bool = False               # enable shed/degrade admission control
    degrade: bool = True             # clamp budgets before shedding
    min_degrade_tokens: int = 8      # never clamp below this budget
    deadline_margin: float = 0.0     # seconds reserved before the deadline


class ElasticController:
    """Closed-loop capacity controller for ``run_trace`` (and the serve
    launcher): an admission gate and a periodic resize along a slot
    ladder.

    It reads only the telemetry API (``engine.metrics()``, a
    :class:`~repro_torch.core.telemetry.MetricsSnapshot`) and acts through
    :func:`resize_engine` / :func:`resize_router`.  It keeps a capacity log
    of ``(t, slots)`` segments whose integral (capacity-seconds) is the
    cost side of the elastic-against-static comparison."""

    def __init__(self, config: Optional[ElasticConfig] = None, *,
                 runtime=None):
        self.cfg = config if config is not None else ElasticConfig()
        if not self.cfg.ladder:
            raise ValueError("ladder must name at least one slot count")
        self.ladder = tuple(sorted(set(int(n) for n in self.cfg.ladder)))
        if self.ladder[0] < 1:
            raise ValueError("ladder slot counts must be >= 1")
        self.runtime = runtime          # optional: SLO re-derivation source
        self.capacity_log: list[tuple[float, int]] = []
        self.shed_records: list[dict] = []
        self.degrade_records: list[dict] = []
        self.resizes: list[tuple[float, int, int]] = []   # (t, from, to)
        self.class_counts: dict[str, dict] = {}
        self._static_slots = 0
        self._t0 = 0.0
        self._last_check = float("-inf")
        self._last_resize = float("-inf")
        self._budget_ema = 0.0          # mean admitted decode budget
        self._decisions: dict[int, tuple] = {}   # rid -> (verdict, req)

    # -- helpers ----------------------------------------------------------
    @staticmethod
    def _is_router(engine) -> bool:
        return hasattr(engine, "pending_transfer")

    @staticmethod
    def _slots_of(engine) -> int:
        if ElasticController._is_router(engine):
            return engine.config.decode_slots
        return engine.config.num_slots

    @staticmethod
    def classify(req) -> str:
        """Service class for accounting: requests with a deadline are
        interactive traffic, the rest batch."""
        return "interactive" if req.deadline is not None else "batch"

    def _count(self, cls: str, key: str) -> None:
        c = self.class_counts.setdefault(
            cls, {"admitted": 0, "degraded": 0, "shed": 0})
        c[key] += 1

    # -- run_trace hooks --------------------------------------------------
    def attach(self, engine, now: float) -> None:
        """Start of a trace: pin the static baseline shape and open the
        capacity log."""
        self._static_slots = self._slots_of(engine)
        self._t0 = now
        self.capacity_log = [(now, self._static_slots)]
        self._last_check = now
        self._last_resize = float("-inf")
        self._decisions.clear()

    def admit(self, req, now: float, engine):
        """Admission gate: returns ``(verdict, req)``, the verdict one of
        ``"admit"`` (unchanged), ``"degrade"`` (the returned request's
        decode budget clamped to fit its deadline) or ``"shed"`` (the
        caller drops it; the controller has recorded it).

        The predictor is conservative: with no measured service time yet,
        or no queue backlog, a deadline request is admitted at full
        budget; a shed needs a measured backlog that makes the miss
        certain."""
        if req.rid in self._decisions:
            # queue backpressure made run_trace retry this arrival: the
            # decision (and its records) stand
            return self._decisions[req.rid]
        cls = self.classify(req)
        self._budget_ema = (req.max_new_tokens if not self._budget_ema else
                            0.8 * self._budget_ema + 0.2 * req.max_new_tokens)
        if not self.cfg.shed or req.deadline is None:
            self._count(cls, "admitted")
            return self._decide(req, "admit", req)
        snap = engine.metrics()
        tpt = snap.time_per_token
        if tpt <= 0.0:
            self._count(cls, "admitted")
            return self._decide(req, "admit", req)
        # expected wait for a slot: the queued work ahead, spread over the
        # pool (continuous batching serves every slot each step)
        wait_s = tpt * snap.queue_depth * self._budget_ema \
            / max(snap.num_slots, 1)
        slack_s = req.deadline - self.cfg.deadline_margin - now - wait_s
        fit = int(slack_s / tpt)        # largest budget that still fits
        if fit >= req.max_new_tokens:
            self._count(cls, "admitted")
            return self._decide(req, "admit", req)
        if self.cfg.degrade and fit >= self.cfg.min_degrade_tokens:
            clamped = dataclasses.replace(req, max_new_tokens=fit)
            self.degrade_records.append({
                "rid": req.rid, "class": cls, "t": now,
                "from": req.max_new_tokens, "to": fit})
            self._count(cls, "admitted")
            self._count(cls, "degraded")
            return self._decide(req, "degrade", clamped)
        self.shed_records.append({
            "rid": req.rid, "class": cls, "t": now,
            "reason": (f"predicted finish misses deadline by "
                       f"{-slack_s + tpt * req.max_new_tokens:.3f}s even "
                       f"degraded")})
        self._count(cls, "shed")
        return self._decide(req, "shed", req)

    def _decide(self, req, verdict: str, out_req):
        self._decisions[req.rid] = (verdict, out_req)
        return verdict, out_req

    def maybe_resize(self, engine, now: float):
        """Periodic control decision: read one snapshot and walk the ladder
        one rung on pressure (grow) or slack (shrink).  Returns the engine
        to drive on: the same object when nothing changed, a rebuilt one
        after a resize."""
        if now - self._last_check < self.cfg.interval_s:
            return engine
        self._last_check = now
        if now - self._last_resize < self.cfg.cooldown_s:
            return engine
        snap = engine.metrics()
        current = self._slots_of(engine)
        target = None
        rungs = self.ladder
        if current not in rungs:
            # off-ladder start: snap to the nearest rung on first decision
            rungs = tuple(sorted(set(rungs) | {current}))
        i = rungs.index(current)
        if snap.queue_pressure >= self.cfg.grow_pressure \
                and i + 1 < len(rungs):
            target = rungs[i + 1]
        elif (snap.queue_pressure <= self.cfg.shrink_pressure
              and snap.occupancy <= self.cfg.shrink_occupancy and i > 0):
            cand = rungs[i - 1]
            live = (engine.decode.num_active if self._is_router(engine)
                    else engine.num_active)
            if cand >= live:
                target = cand
        if target is None or target == current:
            return engine
        if self._is_router(engine):
            ratio = max(engine.config.prefill_slots
                        / max(engine.config.decode_slots, 1), 1e-9)
            engine = resize_router(
                engine, decode_slots=target,
                prefill_slots=max(1, round(target * ratio)))
        else:
            engine = resize_engine(engine, target)
        self.resizes.append((now, current, target))
        self.capacity_log.append((now, target))
        self._last_resize = now
        # capacity changed: the planner re-derives the SLO contract on the
        # new shape (a no-op without a runtime or an SLO policy)
        rederive_slo(engine.policy if hasattr(engine, "policy")
                     else engine.prefill.policy, self.runtime)
        return engine

    def summary(self, makespan: float) -> dict:
        """The trace report's ``"elastic"`` section: capacity-seconds
        against the static baseline, shed and degrade records (sheds are
        reported, never silent) and the resize history."""
        end = self._t0 + makespan
        cap = 0.0
        log = self.capacity_log or [(self._t0, self._static_slots)]
        for (t, slots), nxt in zip(log, log[1:] + [(end, 0)]):
            cap += slots * max(nxt[0] - t, 0.0)
        static = self._static_slots * max(makespan, 0.0)
        return {
            "capacity_seconds": cap,
            "static_capacity_seconds": static,
            "capacity_seconds_ratio": cap / max(static, 1e-9),
            "sheds": len(self.shed_records),
            "shed_records": list(self.shed_records),
            "degrades": len(self.degrade_records),
            "degrade_records": list(self.degrade_records),
            "resizes": len(self.resizes),
            "resize_log": [list(r) for r in self.resizes],
            "capacity_log": [list(c) for c in self.capacity_log],
            "class_counts": {k: dict(v)
                             for k, v in self.class_counts.items()},
        }
