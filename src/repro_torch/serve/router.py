"""Prefill/decode disaggregation router.

Counterpart of ``repro/serve/router.py``.  :class:`DisaggRouter` composes
one or more :class:`~repro_torch.serve.disagg.PrefillEngine`\\ s and a
decode :class:`~repro_torch.serve.engine.Engine` over independently
sized slot and block pools (:class:`DisaggConfig`) and moves
:class:`~repro_torch.serve.disagg.KVTransferHandle`\\ s between them::

    submit -> [queue] -policy-> PrefillEngine -handle-> (transfer queue)
                                 P slots, P blocks            |
              backpressure <- pinned blocks                   v
                                           Engine.admit_prefilled
                                            D slots, D blocks -> finished

Each tick runs prefill admission (the policy picks from the waiting
queue), adopts as many ready handles as the decode pool admits (FIFO in
completion order: admission order changes when a request decodes, never
what, so output stays bit-exact for every policy), then one decode tick.
Un-adopted handles pin prefill blocks, which throttles prefill admission
when decode falls behind.

The router duck-types the ``Engine`` surface that ``run_trace``,
``generate_continuous`` and the streaming executor drive
(:class:`~repro_torch.serve.protocol.EngineProtocol`), so every driver
takes it unchanged.  Pass a
:class:`~repro_torch.core.phase_control.RollMuxRuntime` and each adoption
runs under ``runtime.permit("transfer", "<job>:transfer")``: the transfer
is a phase on the planner's timeline.
"""
from __future__ import annotations

import contextlib
import copy
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.telemetry import MetricsSnapshot, warn_legacy_once
from repro_torch.data import tokenizer as tok
from repro_torch.serve.disagg import KVTransferHandle, PrefillEngine
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.serve.sched import make_policy

# DisaggRouter.stats legacy-shim warn-once flag (mutable so tests reset it)
_warned_legacy = [False]


@dataclass(frozen=True)
class DisaggConfig:
    """Two-pool serving shape: one ``max_seq_len``/layout/sampler contract,
    independently sized prefill and decode pools.

    ``prefill_slots`` bounds prefills per tick (paged) or resident
    un-adopted handles (contiguous); ``prefill_kv_blocks`` sizes the pool
    those handles pin.  ``decode_slots``/``decode_kv_blocks`` size the
    decode engine as a monolithic ``EngineConfig`` would.  The admission
    policy (``sched``) runs on the prefill side, where requests wait;
    ``prefix_share`` builds a radix tree over each prefill pool.

    ``prefill_engines`` scales the prefill side out, each engine with its
    own pools and its own radix tree; ``kv_routing`` steers each request:
    ``"kv_aware"`` to the engine whose tree holds the longest prefix of
    its prompt (ties to the least loaded), ``"queue"`` by load alone.
    ``kv_dtype`` is both pools' paged storage dtype."""
    prefill_slots: int = 2
    decode_slots: int = 8
    max_seq_len: int = 256
    eos_id: int = tok.EOS
    temperature: float = 0.0
    block_size: int = 1
    max_waiting: Optional[int] = None
    kv_layout: str = "contiguous"
    kv_block_size: int = 16
    prefill_kv_blocks: Optional[int] = None
    decode_kv_blocks: Optional[int] = None
    sched: str = "fifo"
    prefix_share: bool = False
    prefill_engines: int = 1
    kv_routing: str = "kv_aware"
    kv_dtype: Optional[str] = None

    def prefill_config(self) -> EngineConfig:
        return EngineConfig(
            num_slots=self.prefill_slots, max_seq_len=self.max_seq_len,
            eos_id=self.eos_id, temperature=self.temperature,
            block_size=self.block_size, max_waiting=self.max_waiting,
            kv_layout=self.kv_layout, kv_block_size=self.kv_block_size,
            num_kv_blocks=self.prefill_kv_blocks, sched=self.sched,
            prefix_share=self.prefix_share, kv_dtype=self.kv_dtype)

    def decode_config(self) -> EngineConfig:
        # fed adopted handles, never a policy-ordered queue; adopted
        # prompts bypass prefix lookup by construction
        return EngineConfig(
            num_slots=self.decode_slots, max_seq_len=self.max_seq_len,
            eos_id=self.eos_id, temperature=self.temperature,
            block_size=self.block_size, kv_layout=self.kv_layout,
            kv_block_size=self.kv_block_size,
            num_kv_blocks=self.decode_kv_blocks, sched="fifo",
            prefix_share=False, kv_dtype=self.kv_dtype)


class RouterStats:
    """Transfer counters, and the two sides' counters under the names a
    single engine's stats have."""

    def __init__(self, router: "DisaggRouter"):
        self._router = router
        self.transfers = 0
        self.transfer_time_s = 0.0
        self.transferred_blocks = 0
        self.kv_routed = 0          # requests steered to a non-empty prefix

    @property
    def transfer_overhead_frac(self) -> float:
        """Transfer wall time over transfer + decode time (0 when nothing
        was served)."""
        busy = self.transfer_time_s + self._router.decode._stats.decode_time_s
        if busy <= 0.0:
            return 0.0
        return self.transfer_time_s / busy

    # -- the decode side's (what run_trace reads) ---------------------------
    @property
    def steps(self):
        return self._router.decode._stats.steps

    @property
    def decode_time_s(self):
        return self._router.decode._stats.decode_time_s

    @property
    def time_per_token(self):
        return self._router.decode._stats.time_per_token

    @property
    def slot_utilization(self):
        return self._router.decode._stats.slot_utilization

    @property
    def peak_active(self):
        return self._router.decode._stats.peak_active

    @property
    def peak_kv_blocks(self):
        return self._router.decode._stats.peak_kv_blocks

    @property
    def recorded_tokens(self):
        return self._router.decode._stats.recorded_tokens

    # -- the prefill side's, summed over its engines -------------------------
    @property
    def prefills(self):
        return sum(pe.stats.prefills for pe in self._router.prefills)

    @property
    def prefix_hits(self):
        return sum(pe.stats.prefix_hits for pe in self._router.prefills)

    @property
    def prefix_partial_hits(self):
        return sum(pe.stats.prefix_partial_hits
                   for pe in self._router.prefills)

    @property
    def blocks_saved(self):
        return sum(pe.stats.blocks_saved for pe in self._router.prefills)


class DisaggRouter:
    """One request stream through disaggregated prefill and decode pools.

    ``device`` (default: the CUDA card) and ``generator`` (sampled
    decoding) are the decode engine's; ``runtime``/``job_id`` make each
    transfer a planner-visible phase.  :attr:`transfer_timeline` records
    every transfer either way."""

    def __init__(self, model, params, config: DisaggConfig, *, device=None,
                 generator: Optional[torch.Generator] = None, policy=None,
                 runtime=None, job_id: Optional[str] = None):
        if config.prefill_engines < 1:
            raise ValueError(
                f"prefill_engines must be >= 1, got {config.prefill_engines}")
        if config.kv_routing not in ("kv_aware", "queue"):
            raise ValueError(
                f"kv_routing must be 'kv_aware' or 'queue', "
                f"got {config.kv_routing!r}")
        self.model = model
        self.config = config
        # one policy object drives every prefill queue: per-job token
        # budgets and the SLO service-time estimate are router-wide
        shared_policy = policy if policy is not None \
            else make_policy(config.sched)
        self.decode = Engine(model, params, config.decode_config(),
                             device=device, generator=generator)
        self.prefills = [
            PrefillEngine(model, params, config.prefill_config(),
                          policy=shared_policy, device=self.decode.device)
            for _ in range(config.prefill_engines)]
        self.pending_transfer: deque[KVTransferHandle] = deque()
        self.runtime = runtime
        self.job_id = job_id
        self._stats = RouterStats(self)
        self.transfer_timeline: list[tuple[str, float, float]] = []
        self._clock = None

    # ---- telemetry ---------------------------------------------------------
    @property
    def stats(self) -> RouterStats:
        """Deprecated stats facade; use :meth:`metrics`.  Warn-once
        shim."""
        warn_legacy_once(
            _warned_legacy,
            "DisaggRouter.stats is deprecated; read the unified telemetry "
            "via DisaggRouter.metrics() (core.telemetry.MetricsSnapshot)")
        return self._stats

    def metrics(self) -> MetricsSnapshot:
        """The decode engine's snapshot, the prefill side's counters summed
        over its engines, and the router's transfer counters and backlog."""
        snap = self.decode.metrics()
        snap.source = "router"
        for pe in self.prefills:
            s = pe.stats
            snap.prefills += s.prefills
            snap.prefix_hits += s.prefix_hits
            snap.prefix_partial_hits += s.prefix_partial_hits
            snap.blocks_saved += s.blocks_saved
            snap.queue_depth += len(pe.queue)
            snap.rejected_submits += pe.queue.rejected
            if pe.radix is not None:
                rs = pe.radix.stats
                snap.prefix_misses += rs["misses"]
                snap.prefix_evictions += rs["evictions"]
                snap.pinned_blocks += rs["pinned_blocks"]
                snap.prefix_snapshots += rs["snapshots"]
                snap.snapshot_demotions += rs["snapshot_demotions"]
        snap.transfers = self._stats.transfers
        snap.transfer_time_s = self._stats.transfer_time_s
        snap.transferred_blocks = self._stats.transferred_blocks
        snap.transfer_backlog = len(self.pending_transfer)
        snap.kv_routed = self._stats.kv_routed
        return snap

    # ---- Engine surface ----------------------------------------------------
    @property
    def prefill(self):
        """The first prefill engine (the single-engine surface)."""
        return self.prefills[0]

    @property
    def clock(self):
        return self._clock

    @clock.setter
    def clock(self, fn):
        self._clock = fn
        for pe in self.prefills:
            pe.clock = fn
        self.decode.clock = fn

    @property
    def device(self):
        return self.decode.device

    @property
    def params(self):
        return self.decode.params

    @params.setter
    def params(self, value):
        # a driver drops the weights of a drained engine (params = None)
        self.decode.params = value
        for pe in self.prefills:
            pe.params = value

    @property
    def paged(self) -> bool:
        return self.decode.paged

    @property
    def slots(self):
        return self.decode.slots

    @property
    def radix(self):
        return self.prefill.radix

    @property
    def queue(self):
        return self.prefill.queue

    @property
    def finished(self):
        return self.decode.finished

    @property
    def num_active(self) -> int:
        return self.decode.num_active + len(self.pending_transfer)

    @property
    def idle(self) -> bool:
        return (not any(pe.queue for pe in self.prefills)
                and not self.pending_transfer and self.decode.idle)

    def harvest(self):
        return self.decode.harvest()

    def submit(self, req) -> bool:
        """Check the request against *both* pools, then enqueue it on the
        prefill side.  One too big for either pool raises; a full queue
        returns ``False`` (backpressure)."""
        if req.total_budget > self.config.max_seq_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + budget "
                f"{req.max_new_tokens} exceeds max_seq_len "
                f"{self.config.max_seq_len}")
        if self.decode.paged:
            need = self.decode.slots.blocks_required(req.total_budget)
            if need > self.decode.slots.alloc.num_blocks:
                raise ValueError(
                    f"request {req.rid}: needs {need} KV blocks but the "
                    f"decode pool has {self.decode.slots.alloc.num_blocks}")
        self.decode._validate_stop_tokens(req)
        for pe in self._route(req):
            if pe.submit(req):
                return True
        return False

    def _route(self, req) -> list:
        """The prefill engines in the order ``req`` tries them: with
        ``kv_aware`` routing by longest registered prefix first (each
        tree probed with an uncounted ``match``), ties by load (queue
        depth + resident handles); with ``queue`` routing by load alone.
        A refusing queue passes the request on to the next."""
        if len(self.prefills) == 1:
            return [self.prefills[0]]
        scored = []
        for i, pe in enumerate(self.prefills):
            score = 0
            if (self.config.kv_routing == "kv_aware" and pe.radix is not None
                    and req.frontend is None):
                m = pe.radix.match(req)
                if m is not None:
                    score = m.n_shared + (1 if m.exact else 0)
            load = len(pe.queue) + pe.resident
            scored.append((-score, load, i, pe))
        scored.sort(key=lambda s: s[:3])
        if -scored[0][0] > 0:
            self._stats.kv_routed += 1
        return [s[3] for s in scored]

    # ---- scheduler ---------------------------------------------------------
    def step(self) -> int:
        """One router tick: prefill admission, handle adoption, decode.
        Returns the decode steps run, or 1 when only prefill or transfer
        progressed (0 keeps ``Engine.step``'s "no work" meaning)."""
        prefilled = 0
        for pe in self.prefills:
            prefilled += pe.step()
            self.pending_transfer.extend(pe.pop_ready())
        moved = 0
        while (self.pending_transfer
               and self.decode.can_admit_prefilled(
                   self.pending_transfer[0].req)):
            self._transfer(self.pending_transfer.popleft())
            moved += 1
        k = self.decode.step()
        if not (prefilled or moved or k):
            if self.pending_transfer and self.decode.idle:
                h = self.pending_transfer[0]
                raise RuntimeError(
                    f"transfer stalled: handle for rid {h.req.rid} "
                    f"(budget {h.req.total_budget}) does not fit the idle "
                    f"decode pool — check decode slot/block sizing")
            waiting = sum(len(pe.queue) for pe in self.prefills)
            if waiting and self.decode.idle:
                raise RuntimeError(
                    f"admission stalled: {waiting} waiting, "
                    f"0 active — check prefill pool sizing")
            return 0
        return k if k else 1

    def _transfer(self, handle: KVTransferHandle) -> None:
        who = f"{self.job_id or handle.req.job_id or 'serve'}:transfer"
        ctx = (self.runtime.permit("transfer", who)
               if self.runtime is not None else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            # from the engine that prefilled it: its blocks live there
            one = handle.source.export_cache(handle)
            self.decode.admit_prefilled(handle.req, handle.logits, one)
        n_blocks = len(handle.block_ids)
        handle.release()
        dt = time.perf_counter() - t0
        now = self._clock() if self._clock is not None else t0 + dt
        self.transfer_timeline.append((who, now - dt, now))
        self._stats.transfers += 1
        self._stats.transfer_time_s += dt
        self._stats.transferred_blocks += n_blocks

    def run(self, *, max_ticks: Optional[int] = None,
            should_yield=None):
        """Drive until the queues, the transfer queue and the decode pool
        are empty (or ``max_ticks`` / ``should_yield()``, as
        ``Engine.run``); outputs by rid."""
        ticks = 0
        while not self.idle:
            if max_ticks is not None and ticks >= max_ticks:
                break
            if should_yield is not None and ticks and should_yield():
                break
            self.step()
            ticks += 1
        return [self.finished[r] for r in sorted(self.finished)]

    # ---- suspend / resume --------------------------------------------------
    @property
    def weight_version(self) -> int:
        return self.decode.weight_version

    @property
    def suspended(self):
        return self.decode.suspended

    def harvest_suspended(self):
        return self.decode.harvest_suspended()

    def suspend(self, rid: int):
        """Suspend a request that is decoding.  One still waiting or in
        transfer has no KV worth keeping: drop and resubmit it."""
        return self.decode.suspend(rid)

    def can_resume(self, sreq, tool_tokens=(), *,
                   max_new_tokens: Optional[int] = None) -> bool:
        return self.decode.can_resume(sreq, tool_tokens,
                                      max_new_tokens=max_new_tokens)

    def resume(self, sreq, tool_tokens=(), *,
               max_new_tokens: Optional[int] = None,
               rid: Optional[int] = None,
               stop_tokens: Optional[tuple] = None,
               continue_output: bool = False) -> int:
        """Resume straight into the decode pool: the suspended KV lives on
        the decode side, so the prefill engines are bypassed."""
        return self.decode.resume(
            sreq, tool_tokens, max_new_tokens=max_new_tokens, rid=rid,
            stop_tokens=stop_tokens, continue_output=continue_output)

    def can_admit_prefilled(self, req) -> bool:
        return self.decode.can_admit_prefilled(req)

    def admit_prefilled(self, req, logits, one) -> int:
        return self.decode.admit_prefilled(req, logits, one)

    # ---- checkpoint --------------------------------------------------------
    def export_state(self) -> dict:
        """The decode engine's snapshot plus the prefill side's waiting
        requests.  Prefilled, un-adopted handles fold back into waiting
        requests at the front (their pins released): prefilling them again
        under the same weights gives the same bits."""
        for pe in self.prefills:
            self.pending_transfer.extend(pe.pop_ready())
        requeue = [h.req for h in self.pending_transfer]
        self.drop_pending()
        for req in reversed(requeue):
            self.prefill.queue._q.appendleft(req)
        state = self.decode.export_state()
        state["prefill_queue"] = copy.deepcopy(
            [r for pe in self.prefills for r in pe.queue._q])
        return state

    def import_state(self, state: dict) -> None:
        state = dict(state)
        waiting = state.pop("prefill_queue", [])
        for pe in self.prefills:
            self.pending_transfer.extend(pe.pop_ready())
        self.drop_pending()
        for pe in self.prefills:
            if pe.radix is not None:
                pe.radix.flush()
            if pe.paged:
                pe.slots.alloc.assert_clean(
                    context="DisaggRouter.import_state")
            pe.queue._q.clear()
        self._requeue(copy.deepcopy(waiting))
        self.decode.import_state(state)

    def _requeue(self, reqs) -> None:
        """Spread waiting requests back over the prefill engines through
        :meth:`_route`; when every queue refuses, the best-ranked engine
        takes the request on its raw deque (never dropped)."""
        for req in reqs:
            order = self._route(req)
            for pe in order:
                if pe.queue.push(req):
                    break
            else:
                order[0].queue._q.append(req)

    def drop_pending(self) -> int:
        """Release every handle still waiting for adoption (a mid-flight
        drop); ``reset`` then finds the pools clean."""
        n = len(self.pending_transfer)
        while self.pending_transfer:
            self.pending_transfer.popleft().release()
        return n

    def reset(self, params=None, generator: Optional[torch.Generator] = None,
              *, carry_live: bool = False) -> None:
        """Ready both sides for the next batch: in-flight handles dropped
        (their pins released), both pools asserted leak-free, the
        counters restarted (as ``Engine.reset``'s).

        ``carry_live=True``: the decode engine suspends its live
        generations and resumes them under the new weights, the waiting
        queue is kept across the prefill reset, and prefilled, un-adopted
        handles become waiting requests again (their KV is stale with the
        new weights)."""
        if not carry_live:
            if any(pe.queue for pe in self.prefills) or not self.decode.idle:
                raise RuntimeError("reset() on a live router; drain first")
            for pe in self.prefills:
                self.pending_transfer.extend(pe.pop_ready())
            self.drop_pending()
            for pe in self.prefills:
                pe.reset(params)
            self.decode.reset(params, generator)
            self._stats = RouterStats(self)
            return
        for pe in self.prefills:
            self.pending_transfer.extend(pe.pop_ready())
        requeue = [h.req for h in self.pending_transfer]
        self.drop_pending()
        held = [r for pe in self.prefills for r in pe.queue._q]
        for pe in self.prefills:
            pe.queue._q.clear()
            pe.reset(params, carry_live=True)
        self.decode.reset(params, generator, carry_live=True)
        self._requeue(requeue + held)
