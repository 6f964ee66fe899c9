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

On the card a tick's ``block_size`` decode steps run as one CUDA graph,
the counterpart of the JAX engine's jitted ``lax.scan`` block: the
engine's first tick runs the block eagerly, later ticks replay a capture
of it (:meth:`Engine._graph_for_tick`).  A capture is keyed on the
addresses it reads and writes (weights, cache, block tables, the engine's
own buffers) and the generator it draws from, and a tick whose key
differs captures anew; a failed capture raises.  On the CPU the block
always runs eagerly.

Telemetry is the JAX engine's: :meth:`Engine.metrics` (a
``core.telemetry.MetricsSnapshot``), the deprecated ``stats`` record,
and the wall clock ``Engine.clock`` that stamps first-token and finish
times, which :func:`run_trace` sets while it replays a timed trace.

:meth:`Engine.reset` readies a drained engine for the next batch: a
training driver swaps freshly synced weights (and a generator) into the
same slot pool every GRPO iteration; each swap bumps ``weight_version``,
which every generated token records in ``RequestOutput.token_versions``.

Not ported yet, and refused with ``NotImplementedError``: radix prefix
sharing, stop-token suspension and resume (and with them
``reset(carry_live=True)``), disaggregated adoption, ``export_state`` and
``run_trace``'s elastic ``controller``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.telemetry import MetricsSnapshot, warn_legacy_once
from repro_torch.data import tokenizer as tok
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
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


# Engine.stats legacy-shim warn-once flag (mutable so tests can reset it)
_warned_legacy = [False]


@dataclass
class EngineStats:
    """The JAX engine's counter record.  The prefix-sharing, adoption and
    suspend/resume counters stay 0 until those features are ported."""
    steps: int = 0                    # decode steps executed (all slots)
    blocks: int = 0                   # scheduler ticks that ran a decode
    prefills: int = 0
    recorded_tokens: int = 0          # useful (mask=1) tokens produced
    slot_steps: int = 0               # num_slots * steps (capacity offered)
    peak_active: int = 0              # max concurrently live requests
    peak_kv_blocks: int = 0           # max KV blocks in use (paged only)
    prefix_hits: int = 0              # admits that skipped prefill entirely
    prefix_partial_hits: int = 0      # admits that shared blocks but prefilled
    blocks_saved: int = 0             # KV blocks pinned instead of allocated
    decode_time_s: float = 0.0        # wall time inside decode dispatch+sync
    adoptions: int = 0                # admits fed by a KV transfer handle
    suspends: int = 0                 # requests suspended
    resumes: int = 0                  # suspended requests re-admitted

    @property
    def slot_utilization(self) -> float:
        return self.recorded_tokens / max(self.slot_steps, 1)

    @property
    def time_per_token(self) -> float:
        """Measured service time of one decode step (all live slots decode
        one token each in that time), the estimate SLO admission consumes
        (``SchedulerPolicy.observe_step``)."""
        return self.decode_time_s / max(self.steps, 1)


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


def _addresses(tree, out: list) -> list:
    """Append the data addresses of a nested dict/list tree's tensors to
    ``out``, in the tree's own order (no sorting: it runs every tick)."""
    if isinstance(tree, dict):
        for v in tree.values():
            _addresses(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _addresses(v, out)
    else:
        out.append(tree.data_ptr())
    return out


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
    ``PRNGKey(0)``).

    ``captures`` and ``capture_s`` count the CUDA graphs this engine
    captured and the host seconds the captures took, over its lifetime."""

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
        # the decode block's state: buffers owned for the engine's
        # lifetime and only ever written in place, so that a CUDA graph of
        # the block can read and write them by address
        self._last_logits = torch.zeros((N, model.cfg.vocab_size),
                                        dtype=torch.float32,
                                        device=self.device)
        self._alive = torch.zeros((N,), dtype=torch.bool, device=self.device)
        self._remaining = torch.zeros((N,), dtype=torch.int32,
                                      device=self.device)
        # the block's outputs, copied to the host in one piece per tick:
        # rows [0, K) tokens, [K, 2K) log-probabilities (float32 bits),
        # [2K, 3K) recorded flags, 3K alive and 3K + 1 remaining after it
        K = config.block_size
        self._out = torch.zeros((3 * K + 2, N), dtype=torch.int32,
                                device=self.device)
        self._host_index = [0] * N    # per-slot sequence position (host view)
        self._active: dict[int, tuple[Request, RequestOutput]] = {}
        self.finished: dict[int, RequestOutput] = {}
        self._unharvested: list[RequestOutput] = []
        self._stats = EngineStats()
        self.clock = None             # optional wall clock (run_trace's)
        # weights swapped in by reset(params=...) bump the version; every
        # recorded token carries the version it was sampled under
        self.weight_version = 0
        # the CUDA graph of the decode block (see _graph_for_tick)
        self._warm = False            # a tick has run the block eagerly
        self._graph = None
        self._graph_key_at = None     # the key the graph was captured at
        self._graph_counts: dict = {}     # kernel launches per replay
        self._capture_stream = None
        self.captures = 0
        self.capture_s = 0.0

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

    # ---- telemetry ---------------------------------------------------------
    @property
    def stats(self) -> EngineStats:
        """Deprecated raw counter record; use :meth:`metrics` (the unified
        ``core.telemetry.MetricsSnapshot``).  Still served, with a
        one-time ``DeprecationWarning``."""
        warn_legacy_once(
            _warned_legacy,
            "Engine.stats is deprecated; read the unified telemetry via "
            "Engine.metrics() (core.telemetry.MetricsSnapshot)")
        return self._stats

    def metrics(self) -> MetricsSnapshot:
        """One :class:`~repro_torch.core.telemetry.MetricsSnapshot` of this
        engine: queue and slot occupancy, decode counters, KV block
        occupancy, and the prefix-sharing and suspend/resume counters
        (0 until those are ported)."""
        s = self._stats
        snap = MetricsSnapshot(
            source="engine",
            queue_depth=len(self.queue),
            rejected_submits=self.queue.rejected,
            num_slots=self.config.num_slots,
            num_active=len(self._active),
            peak_active=s.peak_active,
            slot_steps=s.slot_steps,
            steps=s.steps,
            decode_time_s=s.decode_time_s,
            prefills=s.prefills,
            recorded_tokens=s.recorded_tokens,
            generated_tokens=s.recorded_tokens,
            peak_kv_blocks=s.peak_kv_blocks,
            prefix_hits=s.prefix_hits,
            prefix_partial_hits=s.prefix_partial_hits,
            blocks_saved=s.blocks_saved,
            adoptions=s.adoptions,
            suspends=s.suspends,
            resumes=s.resumes,
            weight_version=self.weight_version)
        if self.paged:
            snap.kv_blocks_total = self.slots.alloc.num_blocks
            snap.kv_blocks_in_use = self.slots.blocks_in_use
        return snap

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
        now = self.clock() if self.clock is not None else 0.0
        while self.queue:
            idx = self.policy.pick(self.queue, self._can_admit, now=now,
                                   live_tokens=live_tokens)
            if idx is None:
                break
            req = self.queue.pop_at(idx)
            self._admit_one(req)
            if req.job_id is not None:
                live_tokens[req.job_id] = (live_tokens.get(req.job_id, 0)
                                           + req.max_new_tokens)
        self._stats.peak_active = max(self._stats.peak_active,
                                      len(self._active))
        if self.paged:
            self._stats.peak_kv_blocks = max(self._stats.peak_kv_blocks,
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
                            prefill_step=self._stats.steps,
                            arrival_time=req.arrival_time,
                            priority=req.priority, deadline=req.deadline,
                            job_id=req.job_id)
        self._active[slot] = (req, out)
        self._stats.prefills += 1

    def _finalize(self, slot: int) -> None:
        req, out = self._active[slot]
        out.finish_reason = ("eos" if out.tokens and
                             out.tokens[-1] == self.config.eos_id else "length")
        out.finish_step = self._stats.steps
        if self.clock is not None:
            out.finish_time = self.clock()
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

    def _decode_block(self, tables) -> None:
        """The tick's ``block_size`` decode steps, eagerly: each samples
        every slot's next token from ``_last_logits``, then decodes it for
        the whole pool.  It writes only buffers the engine owns for its
        lifetime, in place (``_last_logits``, ``_alive``, ``_remaining``,
        ``_out`` and the cache), which is what lets a CUDA graph capture
        it.  The graph is checked against this method."""
        K = self.config.block_size
        out = self._out
        for j in range(K):
            nxt, logp = sample_logp(self._last_logits,
                                    self.config.temperature,
                                    generator=self.generator)
            rec = self._alive & (self._remaining > 0)
            # the model updates the cache in place
            if self.model.kernel_supported():
                logits, _ = self.model.kernel_decode_step(
                    self.params, nxt[:, None], self.slots.cache,
                    tables=tables)
            else:
                logits, _ = self.model.decode_step(
                    self.params, nxt[:, None], self.slots.cache)
            self._last_logits.copy_(logits)
            self._alive &= nxt != self.config.eos_id
            self._remaining -= rec.to(torch.int32)
            out[j] = nxt
            out[K + j] = logp.view(torch.int32)
            out[2 * K + j] = rec
        out[3 * K] = self._alive
        out[3 * K + 1] = self._remaining

    # ---- the decode block as a CUDA graph ----------------------------------
    def _graph_key(self) -> tuple:
        """What a capture of the decode block depends on: the addresses of
        the weights, the cache, the block tables and the engine's own
        buffers, and the generator it draws from.  A graph replays raw
        pointers, so a tick whose key differs from the capture's (new
        weights from ``reset(params=...)``, a weight snapshot, weights
        dropped with ``params = None``, a new generator) captures anew."""
        params = (None if self.params is None else
                  tuple(_addresses(self.params, [])))
        bufs = [self._last_logits, self._alive, self._remaining, self._out,
                self.slots.cache]
        if self.paged:
            bufs.append(self.slots.device_tables())
        return (params, tuple(_addresses(bufs, [])), self.generator)

    def _graph_for_tick(self):
        """The CUDA graph this tick replays, or ``None`` for the eager
        block: on the CPU, and on the engine's first tick.

        *Warm-up.*  The first tick runs the block eagerly and does real
        work: it loads the kernels and runs their one-time set-up (such
        as the greedy kernel's cluster-size attribute), which must not
        happen inside a capture.  A throwaway step would advance the
        cache's ``index``, write K/V and consume the generator, so there
        is none.  Later ticks capture, when the key moved, here, before
        the tick's timed window: ``decode_time_s`` times replays only, and
        the first sample the SLO policy keeps (it drops the first) is a
        replay's."""
        if self.device.type != "cuda" or not self._warm:
            return None
        key = self._graph_key()
        if self._graph is None or key != self._graph_key_at:
            self._capture(key)
        return self._graph

    def _capture(self, key: tuple) -> None:
        """Capture the decode block into a new CUDA graph, or raise.

        *Memory.*  The old graph is reset first, which releases its
        private memory pool, so that recapturing every GRPO iteration does
        not grow the device memory.
        *Sampled decoding.*  The engine's generator is registered with the
        graph, so that every replay draws what the eager block would
        (same seed, same tokens) and advances the generator as it would.
        *Threads.*  The mux executors run a rollout and a train phase on
        two threads and streams at once: the capture uses
        ``capture_error_mode="thread_local"`` on this thread's current
        stream (a side stream when that is the default stream, which
        cannot be captured), so that the other thread may allocate, launch
        and synchronize meanwhile.
        *Launch counts.*  A replay calls no kernel wrapper, so the
        wrappers' counts made while capturing (this thread's only) are
        kept and added on every replay."""
        if self._graph is not None:
            self._graph.reset()
            self._graph = self._graph_key_at = None
        sampled = self.config.temperature > 0
        if sampled and not hasattr(torch.cuda.CUDAGraph,
                                   "register_generator_state"):
            raise RuntimeError(
                f"sampled decoding in a CUDA graph needs "
                f"CUDAGraph.register_generator_state, which PyTorch "
                f"{torch.__version__} lacks")
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        stream = cur
        if cur == torch.cuda.default_stream(self.device):
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(self.device)
            stream = self._capture_stream
        tables = self.slots.device_tables() if self.paged else None
        graph = torch.cuda.CUDAGraph()
        if sampled:
            graph.register_generator_state(self.generator)
        with torch.cuda.stream(stream), _build.recording() as counts:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._decode_block(tables)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass                # the block's own error is the one
                raise
            graph.capture_end()
        self._graph, self._graph_key_at = graph, key
        self._graph_counts = counts
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def step(self) -> int:
        """One scheduler iteration: admit waiting requests, then run
        ``block_size`` decode steps for all slots (on the card, one replay
        of the block's CUDA graph).  Returns the number of decode steps
        executed (0 = no work)."""
        self._admit()
        if not self._active:
            if self.queue:
                raise RuntimeError(
                    f"admission stalled: {len(self.queue)} waiting, 0 "
                    f"active — check policy token budgets / pool sizing")
            return 0
        K = self.config.block_size
        graph = self._graph_for_tick()
        t_decode = time.perf_counter()
        tables = None
        if self.paged:
            # materialize the blocks this decode block will write into;
            # the refresh of the static device tables is queued before the
            # block reads them
            for slot in self._active:
                self.slots.ensure(slot, self._host_index[slot] + K - 1)
            self._stats.peak_kv_blocks = max(self._stats.peak_kv_blocks,
                                             self.slots.blocks_in_use)
            tables = self.slots.device_tables()
        if graph is not None:
            graph.replay()
            _build.add_counts(self._graph_counts)
        else:
            self._decode_block(tables)
        for slot in self._active:
            self._host_index[slot] += K
        host = self._out.cpu().numpy()    # the tick's one copy to the host
        t_decode = time.perf_counter() - t_decode
        self._warm = True
        toks, recs = host[:K], host[2 * K:3 * K].astype(bool)
        logps = host[K:2 * K].view(np.float32)
        alive, remaining = host[3 * K], host[3 * K + 1]
        self._stats.decode_time_s += t_decode
        self.policy.observe_step(t_decode, K)
        self._stats.steps += K
        self._stats.blocks += 1
        self._stats.slot_steps += K * self.config.num_slots
        for slot in list(self._active):
            _, o = self._active[slot]
            rec_col = recs[:, slot]
            n_rec = int(rec_col.sum())
            if n_rec:
                if not o.tokens and self.clock is not None:
                    o.first_token_time = self.clock()  # first token on host
                o.tokens.extend(int(t) for t in toks[rec_col, slot])
                o.logprobs.extend(float(x) for x in logps[rec_col, slot])
                o.token_versions.extend([self.weight_version] * n_rec)
                self._stats.recorded_tokens += n_rec
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
        self._stats = EngineStats()

    # ---- not ported yet ----------------------------------------------------
    def suspend(self, rid: int):
        raise _not_ported("suspend")

    def resume(self, sreq, tool_tokens=(), **kw):
        raise _not_ported("resume")

    def admit_prefilled(self, req: Request, logits, one) -> int:
        raise _not_ported("admit_prefilled (disaggregated adoption)")

    def export_state(self) -> dict:
        raise _not_ported("export_state")


def run_trace(engine: Engine, requests: list[Request], *,
              realtime: bool = True, controller=None) -> dict:
    """Replay a timed arrival trace through ``engine`` against the wall
    clock: each request is submitted once ``arrival_time`` (seconds from
    trace start) has elapsed, and per-request first-token and finish
    times are stamped through ``engine.clock``.  ``realtime=False``
    fast-forwards idle gaps instead of sleeping through them: when the
    engine runs dry the next pending request is submitted at once and its
    ``arrival_time`` rebased to the current clock, so latency and TTFT
    stay well defined.  Returns the JAX package's report: latency,
    throughput, slot utilization, backpressure, deadline and KV block
    aggregates.

    ``controller`` (the JAX package's ``serve.elastic`` capacity loop)
    is not ported yet and raises."""
    if controller is not None:
        raise NotImplementedError(
            "run_trace(controller=...) needs serve/elastic.py, which is "
            "not ported to repro_torch yet (ROADMAP, modules to port)")
    pending = sorted(requests, key=lambda r: (r.arrival_time, r.rid))
    t0 = time.perf_counter()
    engine.clock = lambda: time.perf_counter() - t0
    while pending or not engine.idle:
        now = engine.clock()
        while pending and pending[0].arrival_time <= now:
            if not engine.submit(pending[0]):
                break                       # queue full: defer, retry after
            pending.pop(0)                  # the engine drains a bit
        progressed = engine.step()
        if not progressed and pending:
            if realtime:
                # no work until the head arrives: sleep the gap in one go
                wait = pending[0].arrival_time - engine.clock()
                if wait > 0:
                    time.sleep(wait)
            else:
                nxt = pending[0]
                nxt.arrival_time = engine.clock()
                if engine.submit(nxt):
                    pending.pop(0)
    makespan = engine.clock()
    engine.clock = None
    outs = [engine.finished[r] for r in sorted(engine.finished)]
    lat = np.array([o.finish_time - o.arrival_time for o in outs])
    ttft = np.array([o.first_token_time - o.arrival_time for o in outs])
    n_tok = sum(o.num_tokens for o in outs)
    s = engine._stats
    report = {
        "outputs": outs,
        "makespan_s": makespan,
        "tokens": n_tok,
        "tok_per_s": n_tok / max(makespan, 1e-9),
        "latency_mean_s": float(lat.mean()) if len(lat) else 0.0,
        "latency_p95_s": float(np.quantile(lat, 0.95)) if len(lat) else 0.0,
        "ttft_mean_s": float(ttft.mean()) if len(ttft) else 0.0,
        "slot_utilization": s.slot_utilization,
        "peak_active": s.peak_active,
        "rejected_submits": engine.queue.rejected,
    }
    with_dl = [o for o in outs if o.deadline is not None]
    if with_dl:
        met = sum(o.finish_time <= o.deadline for o in with_dl)
        report["deadline_total"] = len(with_dl)
        report["deadline_met"] = int(met)
        report["deadline_attainment"] = met / len(with_dl)
    if engine.paged:
        total = engine.slots.alloc.num_blocks
        report["kv_blocks_total"] = total
        report["peak_kv_blocks"] = s.peak_kv_blocks
        report["kv_block_utilization"] = s.peak_kv_blocks / max(total, 1)
    return report
