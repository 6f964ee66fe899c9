"""Continuous-batching rollout engine (in-flight batching over a slot pool).

Counterpart of ``repro/serve/engine.py`` for greedy decoding.  A
:class:`~repro_torch.serve.queue.RequestQueue` feeds a fixed pool of
KV-cache slots in the order an admission policy picks
(:mod:`repro_torch.serve.sched`); each scheduler iteration prefills picked
requests into free slots, then runs ``block_size`` decode steps for every
slot at once.  A slot is recycled the moment its request hits EOS or its
decode budget, and the next queued request prefills into it.

Every decode step samples the next token of every slot from the previous
step's logits (at temperature 0 with the fused greedy kernel,
``kernels.sampling``; above it by :func:`sample_logp`'s Gumbel-max draw
from the engine's ``torch.Generator``), then runs the model's batched
decode step: ``Model.kernel_decode_step`` for GQA stacks (decode attention
in a kernel, per layer, over contiguous stripes or paged block pools),
``Model.decode_step`` for rwkv6 and zamba2 (the recurrences and zamba2's
shared attention block in plain PyTorch, over contiguous slots; their
paged layouts are not ported and raise ``NotImplementedError``).  The model's family decides, as the JAX engine's
``_resolve_backend`` does; there is no backend switch: on CUDA tensors the
kernels run, on CPU tensors their plain versions.  Admission prefills one
request at a time and never samples.

:meth:`Engine.reset` readies a drained engine for the next batch: a
training driver swaps freshly synced weights (and a generator) into the
same slot pool every GRPO iteration; each swap bumps ``weight_version``,
which every generated token records in ``RequestOutput.token_versions``.

Not ported yet, and refused with ``NotImplementedError``: radix prefix
sharing, stop-token suspension and resume (and with them
``reset(carry_live=True)``), disaggregated adoption and ``export_state``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.data import tokenizer as tok
from repro_torch.device import resolve_device
from repro_torch.kernels.sampling import greedy_sample
from repro_torch.serve.queue import RequestQueue
from repro_torch.serve.request import Request, RequestOutput
from repro_torch.serve.sched import make_policy
from repro_torch.serve.slots import (PagedSlotManager, SlotManager,
                                     insert_cache, insert_paged)


@dataclass(frozen=True)
class EngineConfig:
    num_slots: int = 8
    max_seq_len: int = 256
    eos_id: int = tok.EOS
    temperature: float = 0.0          # 0 => greedy
    block_size: int = 1               # decode steps per scheduler tick
    max_waiting: Optional[int] = None
    kv_layout: str = "contiguous"     # "contiguous" | "paged"
    kv_block_size: int = 16           # tokens per KV block (paged only)
    num_kv_blocks: Optional[int] = None   # paged pool size (default: same
    #                                       memory as contiguous num_slots)
    sched: str = "fifo"               # "fifo" | "deadline" | "slo"
    prefix_share: bool = False        # radix sharing: not ported yet
    kv_dtype: Optional[str] = None    # paged only: None/"auto" | "int8"

    def __post_init__(self):
        if self.num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.max_seq_len < 2:
            raise ValueError("max_seq_len must cover prompt + decode")
        if self.kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_layout {self.kv_layout!r}")
        if self.kv_block_size < 1:
            raise ValueError("kv_block_size must be >= 1")
        if self.sched not in ("fifo", "deadline", "slo"):
            raise ValueError(f"unknown sched policy {self.sched!r}")
        if self.kv_dtype not in (None, "auto", "int8"):
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}")
        if self.kv_dtype == "int8" and self.kv_layout != "paged":
            raise ValueError("kv_dtype='int8' requires kv_layout='paged' "
                             "(quantization is per KV block)")


@dataclass
class EngineStats:
    steps: int = 0                    # decode steps executed (all slots)
    blocks: int = 0                   # scheduler ticks that ran a decode
    prefills: int = 0
    recorded_tokens: int = 0          # useful (mask=1) tokens produced
    slot_steps: int = 0               # num_slots * steps (capacity offered)
    peak_active: int = 0              # max concurrently live requests
    peak_kv_blocks: int = 0           # max KV blocks in use (paged only)
    decode_time_s: float = 0.0        # wall time inside decode dispatch+sync

    @property
    def slot_utilization(self) -> float:
        return self.recorded_tokens / max(self.slot_steps, 1)


def sample_logp(logits: torch.Tensor, temperature: float, *,
                generator: Optional[torch.Generator] = None,
                gumbel: Optional[torch.Tensor] = None):
    """(N, V) float32 logits -> (next token (N,) int32, its log-probability
    (N,) float32).  Counterpart of the JAX engine's ``_make_sampler``.

    Temperature 0 is the fused greedy kernel.  Above it the token is
    ``argmax(logits / T + g)`` with ``g`` standard Gumbel noise, which is
    how ``jax.random.categorical`` draws; ``g`` comes from ``generator``
    (on the logits' device) unless the caller passes it as ``gumbel``.
    The log-probability is that of the untempered logits, as the JAX
    engine records it."""
    if temperature == 0:
        return greedy_sample(logits)
    if gumbel is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
        tiny = torch.finfo(torch.float32).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    nxt = torch.argmax(logits / temperature + gumbel, dim=-1)
    logp = torch.log_softmax(logits, dim=-1).gather(-1, nxt[:, None])[:, 0]
    return nxt.to(torch.int32), logp


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP, modules to "
        f"port: radix, suspend/resume, disagg and elastic)")


class Engine:
    """Continuous-batching generation engine over a fixed slot pool.

    ``device`` defaults to the CUDA card and raises without one; pass
    ``device="cpu"`` to run the plain versions of the kernels.  ``params``
    must already live on that device.  Sampled decoding (``temperature >
    0``) draws from ``generator`` (a ``torch.Generator`` on ``device``;
    default: one seeded with 0, as the JAX engine defaults to
    ``PRNGKey(0)``)."""

    def __init__(self, model, params, config: EngineConfig, *, device=None,
                 policy=None, generator: Optional[torch.Generator] = None):
        if config.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if config.prefix_share:
            raise _not_ported("prefix_share (radix prefix sharing)")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        if config.temperature > 0 and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator
        self.model = model
        self.params = params
        self.config = config
        self.queue = RequestQueue(config.max_waiting)
        self.policy = policy if policy is not None else \
            make_policy(config.sched)
        self.paged = config.kv_layout == "paged"
        kv_dtype = None if config.kv_dtype == "auto" else config.kv_dtype
        N = config.num_slots
        if self.paged:
            self.slots = PagedSlotManager(
                model, N, config.max_seq_len,
                block_size=config.kv_block_size,
                num_blocks=config.num_kv_blocks, kv_dtype=kv_dtype,
                device=self.device)
        else:
            self.slots = SlotManager(model, N, config.max_seq_len,
                                     device=self.device)
        self._last_logits = torch.zeros((N, model.cfg.vocab_size),
                                        dtype=torch.float32,
                                        device=self.device)
        self._alive = torch.zeros((N,), dtype=torch.bool, device=self.device)
        self._remaining = torch.zeros((N,), dtype=torch.int32,
                                      device=self.device)
        self._host_index = [0] * N    # per-slot sequence position (host view)
        self._active: dict[int, tuple[Request, RequestOutput]] = {}
        self.finished: dict[int, RequestOutput] = {}
        self._unharvested: list[RequestOutput] = []
        self.stats = EngineStats()
        # weights swapped in by reset(params=...) bump the version; every
        # recorded token carries the version it was sampled under
        self.weight_version = 0

    # ---- submission --------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Enqueue a request.  Malformed requests raise; a full queue
        returns ``False`` (backpressure: retry after the engine drains)."""
        if req.stop_tokens:
            raise _not_ported("stop_tokens (suspension at a tool boundary)")
        if req.frontend is not None:
            raise NotImplementedError(
                "frontend embeddings come with the vlm/audio architectures")
        if req.total_budget > self.config.max_seq_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + budget "
                f"{req.max_new_tokens} exceeds max_seq_len "
                f"{self.config.max_seq_len}")
        if self.paged:
            need = self.slots.blocks_required(req.total_budget)
            if need > self.slots.alloc.num_blocks:
                raise ValueError(
                    f"request {req.rid}: needs {need} KV blocks but the "
                    f"pool has {self.slots.alloc.num_blocks}")
        return self.queue.push(req)

    @property
    def num_active(self) -> int:
        return len(self._active)

    @property
    def idle(self) -> bool:
        return not self.queue and not self._active

    # ---- scheduler ---------------------------------------------------------
    def _can_admit(self, req: Request) -> bool:
        """A free slot and (paged) enough uncommitted KV blocks for the
        candidate's worst-case budget."""
        if not self.paged:
            return bool(self.slots.num_free)
        return self.slots.can_admit(req.total_budget)

    def _admit(self) -> None:
        """Admit waiting requests into free slots, in the policy's order."""
        live_tokens: dict[str, int] = {}
        for r, _ in self._active.values():
            if r.job_id is not None:
                live_tokens[r.job_id] = (live_tokens.get(r.job_id, 0)
                                         + r.max_new_tokens)
        while self.queue:
            idx = self.policy.pick(self.queue, self._can_admit, now=0.0,
                                   live_tokens=live_tokens)
            if idx is None:
                break
            req = self.queue.pop_at(idx)
            self._admit_one(req)
            if req.job_id is not None:
                live_tokens[req.job_id] = (live_tokens.get(req.job_id, 0)
                                           + req.max_new_tokens)
        self.stats.peak_active = max(self.stats.peak_active,
                                     len(self._active))
        if self.paged:
            self.stats.peak_kv_blocks = max(self.stats.peak_kv_blocks,
                                            self.slots.blocks_in_use)

    def _admit_one(self, req: Request) -> None:
        """Prefill one picked request into a free slot: a batch=1 cache is
        prefilled, then written into the slot's stripe (contiguous) or
        through its block-table row (paged)."""
        prompt = torch.from_numpy(req.prompt).to(self.device)[None]
        one = self.model.init_cache(1, self.config.max_seq_len,
                                    device=self.device)
        logits, one = self.model.prefill(self.params, prompt, one)
        if not self.paged:
            slot = self.slots.assign(req.rid)
            insert_cache(self.slots.cache, one, slot)
        else:
            slot = self.slots.assign(req.rid, prompt_len=req.prompt_len,
                                     total_budget=req.total_budget)
            insert_paged(self.slots.cache, one,
                         self.slots.device_tables()[slot], slot)
        self._last_logits[slot] = logits[0]
        self._alive[slot] = True
        self._remaining[slot] = req.max_new_tokens
        self._host_index[slot] = req.prompt_len
        out = RequestOutput(rid=req.rid, prompt=req.prompt,
                            prefill_step=self.stats.steps,
                            arrival_time=req.arrival_time,
                            priority=req.priority, deadline=req.deadline,
                            job_id=req.job_id)
        self._active[slot] = (req, out)
        self.stats.prefills += 1

    def _finalize(self, slot: int) -> None:
        req, out = self._active[slot]
        out.finish_reason = ("eos" if out.tokens and
                             out.tokens[-1] == self.config.eos_id else "length")
        out.finish_step = self.stats.steps
        self.finished[req.rid] = out
        self._unharvested.append(out)
        del self._active[slot]
        self.slots.release(slot)
        self.policy.observe_finish(out)

    def harvest(self) -> list[RequestOutput]:
        """Pop the requests that finished since the last harvest, without
        draining the engine; outputs also stay in :attr:`finished`."""
        out, self._unharvested = self._unharvested, []
        return out

    def _decode_step(self, tables):
        """Sample every slot's next token from the last logits, then decode
        it for the whole pool; returns (tokens, logprobs, recorded)."""
        nxt, logp = sample_logp(self._last_logits, self.config.temperature,
                                generator=self.generator)
        rec = self._alive & (self._remaining > 0)
        if self.model.kernel_supported():
            self._last_logits, self.slots.cache = \
                self.model.kernel_decode_step(self.params, nxt[:, None],
                                              self.slots.cache,
                                              tables=tables)
        else:
            self._last_logits, self.slots.cache = self.model.decode_step(
                self.params, nxt[:, None], self.slots.cache)
        self._alive &= nxt != self.config.eos_id
        self._remaining -= rec.to(torch.int32)
        return nxt, logp, rec

    def step(self) -> int:
        """One scheduler iteration: admit waiting requests, then run
        ``block_size`` decode steps for all slots.  Returns the number of
        decode steps executed (0 = no work)."""
        self._admit()
        if not self._active:
            if self.queue:
                raise RuntimeError(
                    f"admission stalled: {len(self.queue)} waiting, 0 "
                    f"active — check policy token budgets / pool sizing")
            return 0
        K = self.config.block_size
        t_decode = time.perf_counter()
        tables = None
        if self.paged:
            # materialize the blocks this decode block will write into
            for slot in self._active:
                self.slots.ensure(slot, self._host_index[slot] + K - 1)
            self.stats.peak_kv_blocks = max(self.stats.peak_kv_blocks,
                                            self.slots.blocks_in_use)
            tables = self.slots.device_tables()
        steps = [self._decode_step(tables) for _ in range(K)]
        for slot in self._active:
            self._host_index[slot] += K
        toks, logps, recs = (torch.stack(t).cpu().numpy()
                             for t in zip(*steps))        # (K, N) each
        alive = self._alive.cpu().numpy()
        remaining = self._remaining.cpu().numpy()
        t_decode = time.perf_counter() - t_decode
        self.stats.decode_time_s += t_decode
        self.policy.observe_step(t_decode, K)
        self.stats.steps += K
        self.stats.blocks += 1
        self.stats.slot_steps += K * self.config.num_slots
        for slot in list(self._active):
            _, o = self._active[slot]
            rec_col = recs[:, slot]
            n_rec = int(rec_col.sum())
            if n_rec:
                o.tokens.extend(int(t) for t in toks[rec_col, slot])
                o.logprobs.extend(float(x) for x in logps[rec_col, slot])
                o.token_versions.extend([self.weight_version] * n_rec)
                self.stats.recorded_tokens += n_rec
            if (not alive[slot]) or remaining[slot] <= 0:
                self._finalize(slot)
        return K

    def run(self, *, max_ticks: Optional[int] = None,
            should_yield=None) -> list[RequestOutput]:
        """Drive the engine until queue and slots are empty; outputs by
        rid.  ``max_ticks`` bounds the scheduler iterations and
        ``should_yield()``, checked between ticks, lets a driver preempt
        the engine cooperatively; either may return with work still in
        flight (``idle`` False): call ``run`` again to continue."""
        ticks = 0
        while not self.idle:
            if max_ticks is not None and ticks >= max_ticks:
                break
            if should_yield is not None and ticks and should_yield():
                break
            self.step()
            ticks += 1
        return [self.finished[r] for r in sorted(self.finished)]

    def reset(self, params=None, generator: Optional[torch.Generator] = None,
              *, carry_live: bool = False) -> None:
        """Ready a drained engine for its next batch of requests: swap in
        freshly synced ``params`` (bumping ``weight_version``) and, when
        given, a new ``generator``, and drop the previous batch's outputs.
        :attr:`stats` restart from zero, so they count one batch.  The
        slot pool stays; this is how a training driver reuses one engine
        across GRPO iterations.  Raises on a live engine or a non-empty
        queue.  ``carry_live=True`` (partial-rollout continuation) suspends
        and resumes live generations, which is not ported yet."""
        if carry_live:
            raise NotImplementedError(
                "reset(carry_live=True) (partial-rollout continuation) "
                "needs suspend/resume, which is not ported to repro_torch "
                "yet (ROADMAP, modules to port)")
        if self._active or self.queue:
            raise RuntimeError("reset() on a live engine; drain it first")
        if params is not None:
            if params["embed"].device != self.device:
                raise ValueError(f"params live on {params['embed'].device}, "
                                 f"the engine on {self.device}")
            self.params = params
            self.weight_version += 1
        if generator is not None:
            self.generator = generator
        # rids repeat across batches: per-request bookkeeping goes, the
        # measured service time stays
        self.policy.on_reset()
        if self.paged:
            # an idle engine holds no block: a dangling one here is a leak
            # that would compound across iterations
            self.slots.alloc.assert_clean(context="Engine.reset")
        self.finished.clear()
        self._unharvested.clear()
        self.stats = EngineStats()

    # ---- not ported yet ----------------------------------------------------
    def suspend(self, rid: int):
        raise _not_ported("suspend")

    def resume(self, sreq, tool_tokens=(), **kw):
        raise _not_ported("resume")

    def admit_prefilled(self, req: Request, logits, one) -> int:
        raise _not_ported("admit_prefilled (disaggregated adoption)")

    def export_state(self) -> dict:
        raise _not_ported("export_state")
