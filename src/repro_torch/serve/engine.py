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
in a kernel, per layer, over contiguous stripes or paged block pools) and
for zamba2's paged pool (its shared attention block runs the paged kernel
over the ``attn_k``/``attn_v`` pools) and for deepseek-v2's MLA on either
layout (its absorbed decode in plain PyTorch, each slot's MoE rows routed
alone, as the JAX engine's vmapped batch=1 step does), ``Model.decode_step`` for rwkv6 on
either layout (its pool pages nothing) and contiguous zamba2 (the
recurrences and zamba2's shared attention block in plain PyTorch).  The
layout and the model's family decide; there is no backend
switch: on CUDA tensors the kernels run, on CPU tensors their plain
versions.  Admission prefills one request at a time and never samples.

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

Suspend and resume are the JAX engine's: a request whose ``stop_tokens``
it samples (a tool-call boundary), or one :meth:`Engine.suspend` names,
leaves its slot as a :class:`SuspendedRequest` (a paged slot's full
blocks pinned in place, its partial last block, a contiguous slot's
stripe and the boundary logits copied), and :meth:`Engine.resume`
adopts it into a free slot through :meth:`Engine.admit_prefilled`,
feeding tool tokens through the model's own decode step first.
``reset(carry_live=True)`` carries live generations across a weight
swap that way, and :meth:`Engine.export_state` /
:meth:`Engine.import_state` checkpoint a live engine.  On the card
every one of these writes the engine's buffers in place, so that the
decode block's CUDA graph stays valid: only new weights capture anew.

``EngineConfig.prefix_share`` (paged only) is the JAX engine's radix
prompt-prefix sharing (:mod:`repro_torch.serve.radix`): requests that
agree on a block-aligned token prefix share those KV blocks, pinned under
every sharing slot.  An exact repeat of a registered prompt admits with
no model compute from the boundary snapshot (a copy of its tail block,
logits row and slot rows, seeded into the slot in place); a partial
overlap prefills the whole prompt but writes it through a row whose
shared entries point at the null block, so a shared block is never
written.  Admission gates on *net-new* blocks and LRU-evicts the tree
under pressure.  Every prompt admitted, adopted or resumed registers
once its slot holds it.  New weights (``reset(params=...)``) flush the
tree.

:func:`run_trace` takes an elastic ``controller``
(:mod:`repro_torch.serve.elastic`): it gates every arrival (admit, degrade
or shed) and may replace the engine between steps by a resized one.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core import telemetry
from repro_torch.core.telemetry import MetricsSnapshot, warn_legacy_once
from repro_torch.data import tokenizer as tok
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.sampling import greedy_sample
from repro_torch.models.kvcache import SCALE_SUFFIX
from repro_torch.serve.queue import RequestQueue
from repro_torch.serve.radix import RadixPrefixIndex
from repro_torch.serve.request import Request, RequestOutput
from repro_torch.serve.sched import make_policy
from repro_torch.serve.slots import (PagedSlotManager, SlotManager,
                                     extract_cache, insert_cache)


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
    prefix_share: bool = False        # radix prompt-prefix KV sharing
    #                                   (paged layout only)
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
        if self.prefix_share and self.kv_layout != "paged":
            raise ValueError("prefix_share requires kv_layout='paged' "
                             "(sharing is block-granular)")
        if self.kv_dtype not in (None, "auto", "int8"):
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}")
        if self.kv_dtype == "int8" and self.kv_layout != "paged":
            raise ValueError("kv_dtype='int8' requires kv_layout='paged' "
                             "(quantization is per KV block)")


# Engine.stats legacy-shim warn-once flag (mutable so tests can reset it)
_warned_legacy = [False]


@dataclass
class EngineStats:
    """The JAX engine's counter record."""
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
    adoptions: int = 0                # admits of a prefilled cache
    #                                   (admit_prefilled, every resume)
    suspends: int = 0                 # requests suspended (tool boundary or
    #                                   carry_live weight sync)
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


def check_frontend(cfg, req: Request) -> None:
    """A request's ``frontend`` against the model's config: a vlm takes
    ``(1, F, d_model)`` vision embeddings with F at most the prompt's
    length (or none: a text-only prompt), an audio model needs ``(1,
    max_source_len, d_model)`` frame embeddings (its cache's cross leaves
    have that length), a text model takes none.  Raises ``ValueError``."""
    fr = req.frontend
    if cfg.frontend is None:
        if fr is not None:
            raise ValueError(f"request {req.rid}: family {cfg.family!r} "
                             f"takes no frontend embeddings")
        return
    if fr is None:
        if cfg.family == "audio":
            raise ValueError(f"request {req.rid}: the audio family needs "
                             f"frontend frame embeddings (1, "
                             f"{cfg.max_source_len}, {cfg.d_model})")
        return
    shape = tuple(fr.shape)
    ok = (len(shape) == 3 and shape[0] == 1 and shape[2] == cfg.d_model
          and (shape[1] == cfg.max_source_len if cfg.family == "audio"
               else 1 <= shape[1] <= req.prompt_len))
    if not ok:
        want = (f"(1, {cfg.max_source_len}, {cfg.d_model})"
                if cfg.family == "audio" else
                f"(1, F <= {req.prompt_len}, {cfg.d_model})")
        raise ValueError(f"request {req.rid}: frontend of shape {shape}; "
                         f"{cfg.name} takes {want}")


def _prefill(model, params, req: Request, max_seq_len: int, device):
    """The model's prefill of ``req``'s prompt (and its frontend, a numpy
    array or a tensor) on a new batch=1 cache: ``(logits (V,), cache)``."""
    prompt = torch.from_numpy(req.prompt).to(device)[None]
    frontend = (None if req.frontend is None
                else torch.as_tensor(req.frontend).to(device))
    logits, one = model.prefill(params, prompt, model.init_cache(
        1, max_seq_len, device=device), frontend=frontend)
    return logits[0], one


def _evict_for(radix, slots, total_budget: int, m=None) -> bool:
    """Under block pressure, LRU-evict ``radix`` until a request of
    ``total_budget`` sharing ``m``'s blocks fits ``slots``' pool, sparing
    ``m``'s path; as a last resort evict that path too, for an unshared
    admit.  False without a tree or when nothing fits."""
    if radix is None or not len(radix):
        return False
    full = slots.blocks_required(total_budget)
    if m is not None and radix.evict_for(max(full - m.n_shared, 0),
                                         protect=m.node_ids):
        return True
    return radix.evict_for(full)


def _clone_tree(tree):
    """Copies of a nested dict's tensors (None stays None)."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return None if tree is None else tree.clone()


def _as_device(tree, device):
    """A nested dict of tensors or numpy arrays (an exported state back
    from a host cache) as tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _as_device(v, device) for k, v in tree.items()}
    return (None if tree is None
            else torch.as_tensor(tree).to(device, copy=True))


class SuspendedRequest:
    """A live generation taken out of its slot at a stop-token boundary
    (or a weight sync), waiting to be resumed: the JAX engine's handle.

    A paged engine pins the sequence's full KV blocks in its pool (one
    ``incref`` each, no copy), keeps a copy of the partial last block in
    ``tail`` (as the pool stores it) and copies of the slot's rows of the
    slot-resident leaves in ``slot_leaves`` (zamba2's ``conv``/``ssm``,
    all of rwkv6's state); a contiguous engine keeps a copy of the slot's
    whole stripe in ``one``.  ``logits`` is a copy of the
    slot's last logits row.  Copies, never views: the engine's buffers and
    pool are rewritten in place by every later decode step and admit.  The
    slot itself is released at suspension.

    ``history`` is the token sequence behind ``index`` (prompt and the
    tokens generated so far); :meth:`Engine.resume` adopts it, with any
    tool tokens, as the prompt of a new request through
    :meth:`Engine.admit_prefilled`.  ``logits`` is usable
    (``logits_valid``) only when the stop token was the last step of its
    decode block; a stop cut out of a ``block_size > 1`` block recomputes
    the boundary logits at resume.  :meth:`release` drops the pins exactly
    once."""

    __slots__ = ("req", "out", "history", "index", "remaining", "logits",
                 "logits_valid", "block_ids", "tail", "slot_leaves", "one",
                 "source", "weight_version", "released")

    def __init__(self, req: Request, out: RequestOutput, history, index: int,
                 remaining: int, logits, *, source, logits_valid: bool = True,
                 block_ids=(), tail=None, slot_leaves=None, one=None,
                 weight_version: int = 0):
        self.req = req
        self.out = out
        self.history = np.asarray(history, np.int32).reshape(-1)
        self.index = int(index)
        self.remaining = int(remaining)
        self.logits = logits
        self.logits_valid = logits_valid
        self.block_ids = tuple(int(b) for b in block_ids)
        self.tail = tail if tail is not None else {}
        self.slot_leaves = slot_leaves if slot_leaves is not None else {}
        self.one = one                      # contiguous: the batch=1 stripe
        self.source = source                # the Engine holding the pins
        self.weight_version = weight_version
        self.released = False

    def release(self) -> None:
        """Drop this handle's pins in the source pool (idempotent)."""
        if self.released:
            return
        self.released = True
        self.source._release_suspended(self)
        self.one = None
        self.tail = {}
        self.slot_leaves = {}
        self.logits = None


class Engine:
    """Continuous-batching generation engine over a fixed slot pool.

    ``device`` defaults to the CUDA card and raises without one; pass
    ``device="cpu"`` to run the plain versions of the kernels.  ``params``
    must already live on that device.  Sampled decoding (``temperature >
    0``) draws from ``generator`` (a ``torch.Generator`` on ``device``;
    default: one seeded with 0, as the JAX engine defaults to
    ``PRNGKey(0)``).

    ``captures`` counts the CUDA graphs of the decode block this engine
    captured, ``inject_captures`` those of its batch=1 injection
    (:meth:`resume`), and ``capture_s`` the host seconds all of them took,
    over its lifetime."""

    def __init__(self, model, params, config: EngineConfig, *, device=None,
                 policy=None, generator: Optional[torch.Generator] = None):
        if config.temperature < 0:
            raise ValueError("temperature must be >= 0")
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
        self.radix = (RadixPrefixIndex(self.slots.alloc)
                      if config.prefix_share else None)
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
        # weights swapped in by reset(params=...) bump the version; each
        # slot remembers the version its last-logits row was computed
        # under, which the next token it samples records
        self.weight_version = 0
        self._slot_version = [0] * N
        # a resumed output with continue_output carries earlier tokens:
        # how many, per slot, so that index = prompt + tokens of this slot
        self._seed_tokens: dict[int, int] = {}
        self.suspended: dict[int, SuspendedRequest] = {}    # by rid
        self._newly_suspended: list[SuspendedRequest] = []
        # cutting a block's outputs at a stop token rolls the slot back,
        # which only sequence-shaped leaves allow (attention masks
        # positions >= index): recurrent state cannot rewind, so those
        # families suspend at block_size 1 only
        paged_names = set(model.paged_cache_names())
        # the pool's batched step: through the kernels for GQA stacks and
        # pools with paged leaves (zamba2's shared block over its
        # attn_k/attn_v pools); MLA's step with per-slot routing on either
        # layout; rwkv6's pool pages nothing and steps as a contiguous
        # cache does
        self._kernel_step = (model.kernel_supported()
                             or model.cfg.attention == "mla"
                             or (self.paged and bool(paged_names)))
        self._rollback_safe = all(
            k == "index" or k in paged_names or k.endswith(SCALE_SUFFIX)
            for k in self.slots.cache)
        # the CUDA graph of the decode block (see _graph_for_tick)
        self._warm = False            # a tick has run the block eagerly
        self._graph = None
        self._graph_key_at = None     # the key the graph was captured at
        self._graph_counts: dict = {}     # kernel launches per replay
        self._capture_stream = None
        self.captures = 0
        self.capture_s = 0.0
        # the batch=1 decode of forced tokens on the card (_inject,
        # _inject_in_slot): buffers whose addresses the graphs hold, and a
        # graph per kind and token count
        self._inject_one = None
        self._inject_toks = None
        self._inject_row = self._inject_index = None
        self._inject_graphs: dict = {}
        self._inject_warm: set = set()
        self.inject_captures = 0

    # ---- submission --------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Enqueue a request.  Malformed requests raise; a full queue
        returns ``False`` (backpressure: retry after the engine drains)."""
        check_frontend(self.model.cfg, req)
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
        self._validate_stop_tokens(req)
        return self.queue.push(req)

    def _validate_stop_tokens(self, req: Request) -> None:
        if not req.stop_tokens:
            return
        if self.config.eos_id in req.stop_tokens:
            raise ValueError(
                f"request {req.rid}: stop_tokens contain eos_id "
                f"{self.config.eos_id} — EOS finishes, it cannot suspend")
        if self.config.block_size > 1 and not self._rollback_safe:
            raise ValueError(
                f"request {req.rid}: stop-token suspension on family "
                f"{self.model.cfg.family!r} needs block_size=1 — its "
                f"recurrent cache state cannot be rolled back past a "
                f"mid-block stop boundary")

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
        occupancy, suspend/resume traffic and the prefix-sharing counters."""
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
            suspended=len(self.suspended),
            weight_version=self.weight_version)
        if self.paged:
            snap.kv_blocks_total = self.slots.alloc.num_blocks
            snap.kv_blocks_in_use = self.slots.blocks_in_use
        if self.radix is not None:
            rs = self.radix.stats
            snap.prefix_misses = rs["misses"]
            snap.prefix_evictions = rs["evictions"]
            snap.pinned_blocks = rs["pinned_blocks"]
            snap.prefix_snapshots = rs["snapshots"]
            snap.snapshot_demotions = rs["snapshot_demotions"]
        return snap

    # ---- scheduler ---------------------------------------------------------
    def _match(self, req: Request, *, count: bool = False):
        """Radix lookup for ``req`` (``None`` with sharing off or no
        match).  ``count=True`` marks the admission lookup: the index owns
        the hit/partial/miss counters and bumps exactly one per counted
        call.  A request carrying frontend embeddings never shares: its KV
        depends on more than its token ids, so it bypasses the tree (no
        lookup, no count) and never registers."""
        if self.radix is None or req.frontend is not None:
            return None
        return self.radix.match(req, count=count)

    def _can_admit(self, req: Request) -> bool:
        """A free slot and (paged) enough uncommitted KV blocks for the
        candidate's worst-case budget net of prefix-shared blocks,
        evicting the radix tree under pressure."""
        if not self.paged:
            return bool(self.slots.num_free)
        if not self.slots.num_free:
            return False
        m = self._match(req)
        if self.slots.can_admit(req.total_budget, shared_blocks=(
                m.n_shared if m is not None else 0)):
            return True
        return _evict_for(self.radix, self.slots, req.total_budget, m)

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
        """Admit one picked request into a free slot.  A radix exact hit
        runs no model (:meth:`_admit_shared_exact`); otherwise a batch=1
        cache is prefilled, then written into the slot's stripe
        (contiguous) or through its block-table row (paged), on a partial
        hit through a copy of the row whose shared entries are 0, so that
        the shared blocks go unwritten.  With sharing on, the admitted
        prompt then registers."""
        m = self._match(req, count=True)
        shared = m.n_shared if m is not None else 0
        if m is not None and m.exact:
            slot = self._admit_shared_exact(req, m)
        else:
            with telemetry.span("engine.prefill", rid=req.rid,
                                device=self.device):
                logits, one = _prefill(self.model, self.params, req,
                                       self.config.max_seq_len, self.device)
                if not self.paged:
                    slot = self.slots.assign(req.rid)
                    insert_cache(self.slots.cache, one, slot)
                else:
                    if m is not None:
                        self.radix.touch(m)
                        slot = self.slots.assign_shared(
                            req.rid, prompt_len=req.prompt_len,
                            total_budget=req.total_budget,
                            shared_ids=m.block_ids)
                        self._stats.prefix_partial_hits += 1
                    else:
                        slot = self.slots.assign(
                            req.rid, prompt_len=req.prompt_len,
                            total_budget=req.total_budget)
                    self.slots.insert_prompt(slot, one, shared)
                self._last_logits[slot] = logits
            if self.radix is not None:
                self._register_prefix(req, slot)
        self._alive[slot] = True
        self._remaining[slot] = req.max_new_tokens
        self._host_index[slot] = req.prompt_len
        self._slot_version[slot] = self.weight_version
        self._seed_tokens[slot] = 0
        out = RequestOutput(rid=req.rid, prompt=req.prompt,
                            prefill_step=self._stats.steps,
                            arrival_time=req.arrival_time,
                            priority=req.priority, deadline=req.deadline,
                            job_id=req.job_id, prefix_shared_blocks=shared)
        self._active[slot] = (req, out)
        self._stats.prefills += 1
        self._stats.blocks_saved += shared

    def _register_prefix(self, req: Request, slot: int) -> None:
        """Register the prompt slot ``slot`` holds: its full blocks and a
        boundary snapshot of copies taken from the slot itself
        (:meth:`PagedSlotManager.boundary`, and the logits row), so that
        an exact hit seeds the same bits.  A frontend request does not
        register (:meth:`_match`)."""
        if req.frontend is not None:
            return
        block_ids, tail, rows = self.slots.boundary(slot, req.prompt_len)
        self.radix.register(req, block_ids,
                            logits=self._last_logits[slot].clone(),
                            tail=tail, slot_leaves=rows)

    def _admit_shared_exact(self, req: Request, m) -> int:
        """A radix exact hit, with no model compute: pin the shared full
        blocks under the slot, seed its private tail block, its slot rows
        and its logits row from the boundary snapshot, in place."""
        self.radix.touch(m)
        snap = m.snapshot
        slot = self.slots.assign_shared(
            req.rid, prompt_len=req.prompt_len,
            total_budget=req.total_budget, shared_ids=m.block_ids)
        if snap.tail:
            self.slots.seed_block(int(self.slots.tables[slot, m.n_shared]),
                                  snap.tail)
        self.slots.seed_rows(slot, snap.slot_leaves)
        self.slots.cache["index"][slot] = req.prompt_len
        self._last_logits[slot].copy_(snap.logits)
        self._stats.prefix_hits += 1
        return slot

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
        self._seed_tokens.pop(slot, None)
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
            logits = self._model_step(nxt[:, None], self.slots.cache,
                                      tables)
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
            with telemetry.span("engine.capture", kind="block"):
                self._capture(key)
        return self._graph

    def warm_up(self) -> None:
        """Run the decode block once, eagerly, on an idle engine on the
        card, so that the first tick with work captures the block's graph
        before its timed window and replays it: neither the eager block nor
        the capture lands in ``decode_time_s``, which the elastic admission
        gate reads as the time per token (a resized engine would otherwise
        look saturated for its first tick).  Every slot is dead, so the
        block writes only where no request reads: stripes and slot rows an
        admit overwrites, the null block through zeroed table rows.  A
        sampled engine's generator is restored afterwards.  A no-op on the
        CPU and on an engine that has run a tick; a live engine raises."""
        if self.device.type != "cuda" or self._warm:
            return
        if self._active:
            raise RuntimeError("warm_up() on a live engine")
        state = (None if self.generator is None
                 else self.generator.get_state())
        self._decode_block(self.slots.device_tables() if self.paged
                           else None)
        if state is not None:
            self.generator.set_state(state)
        self._warm = True

    def release_graphs(self) -> None:
        """Release the engine's CUDA graphs (the decode block's and the
        forced-token ones) and their private memory pools, as a retired
        engine should (``resize_engine``); a later tick captures anew."""
        if self._graph is not None:
            self._graph.reset()
        for entry in self._inject_graphs.values():
            entry[1].reset()
        self._graph = self._graph_key_at = None
        self._inject_graphs = {}

    def _capture(self, key: tuple) -> None:
        """Capture the decode block into a new CUDA graph, or raise.

        *Memory.*  The old graph is reset first, which releases its
        private memory pool, so that recapturing every GRPO iteration does
        not grow the device memory.
        *Sampled decoding.*  The engine's generator is registered with the
        graph, so that every replay draws what the eager block would
        (same seed, same tokens) and advances the generator as it would.
        *Threads and launch counts:* :meth:`_record_graph`."""
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
        tables = self.slots.device_tables() if self.paged else None
        graph, _, counts = self._record_graph(
            lambda: self._decode_block(tables),
            self.generator if sampled else None)
        self._graph, self._graph_key_at = graph, key
        self._graph_counts = counts
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def _record_graph(self, fn, generator=None):
        """``fn()`` captured into a new CUDA graph: ``(graph, what fn
        returned, the kernel launches one replay makes)``.

        *Threads.*  The mux executors run a rollout and a train phase on
        two threads and streams at once: the capture uses
        ``capture_error_mode="thread_local"`` on this thread's current
        stream (a side stream when that is the default stream, which
        cannot be captured), so that the other thread may allocate, launch
        and synchronize meanwhile.
        *Launch counts.*  A replay calls no kernel wrapper, so the
        wrappers' counts made while capturing (this thread's only) are
        kept and added on every replay."""
        cur = torch.cuda.current_stream(self.device)
        stream = cur
        if cur == torch.cuda.default_stream(self.device):
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(self.device)
            stream = self._capture_stream
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        with torch.cuda.stream(stream), _build.recording() as counts:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass                # the block's own error is the one
                raise
            graph.capture_end()
        return graph, out, counts

    def step(self) -> int:
        """One scheduler iteration: admit waiting requests, then run
        ``block_size`` decode steps for all slots (on the card, one replay
        of the block's CUDA graph).  Returns the number of decode steps
        executed (0 = no work).  An ``engine.step`` span, holding
        ``engine.admit`` (an ``engine.prefill`` a prefilled request),
        ``engine.capture`` and ``engine.tick``: the tick's span is the
        interval ``decode_time_s`` adds, with the device seconds of its
        replay and copy to the host."""
        with telemetry.span("engine.step"):
            return self._step()

    def _step(self) -> int:
        with telemetry.span("engine.admit"):
            self._admit()
        if not self._active:
            if self.queue:
                raise RuntimeError(
                    f"admission stalled: {len(self.queue)} waiting, 0 "
                    f"active — check policy token budgets / pool sizing")
            return 0
        K = self.config.block_size
        graph = self._graph_for_tick()
        tick = telemetry.span("engine.tick", device=self.device)
        t_decode = time.perf_counter_ns()
        tick.start(t_decode)
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
        t_end = time.perf_counter_ns()
        tick.stop(t_end)
        t_decode = (t_end - t_decode) / 1e9
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
            req, o = self._active[slot]
            rec_col = recs[:, slot]
            n_rec = int(rec_col.sum())
            stop_at = None                  # position of a stop trigger
            if n_rec:
                if not o.tokens and self.clock is not None:
                    o.first_token_time = self.clock()  # first token on host
                new_toks = [int(t) for t in toks[rec_col, slot]]
                if req.stop_tokens:
                    for j, t in enumerate(new_toks):
                        if t in req.stop_tokens:
                            stop_at = j
                            break
                # a stop trigger is recorded like EOS; what the block ran
                # past it is cut (its KV lies past the rolled-back index,
                # where attention masks it)
                keep = n_rec if stop_at is None else stop_at + 1
                o.tokens.extend(new_toks[:keep])
                o.logprobs.extend(
                    float(x) for x in logps[rec_col, slot][:keep])
                # the block's first token was sampled from the slot's
                # remembered logits (stale across a carried weight swap),
                # the later ones from logits this block computed
                o.token_versions.extend(
                    [self._slot_version[slot]]
                    + [self.weight_version] * (keep - 1))
                self._slot_version[slot] = self.weight_version
                self._stats.recorded_tokens += keep
            if stop_at is not None:
                # a tool boundary before EOS or the budget: suspend and
                # free the slot; the boundary logits are live only when
                # the trigger was the block's last step
                o.finish_reason = "stop"
                self._newly_suspended.append(self._suspend_slot(
                    slot, logits_valid=(stop_at + 1 == K)))
            elif (not alive[slot]) or remaining[slot] <= 0:
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

    # ---- suspend / resume --------------------------------------------------
    def harvest_suspended(self) -> list[SuspendedRequest]:
        """Pop the requests that hit a stop-token boundary since the last
        call (the agentic driver's pickup point, :meth:`harvest`'s twin).
        Handles stay in :attr:`suspended` until resumed or released."""
        out, self._newly_suspended = self._newly_suspended, []
        return out

    def suspend(self, rid: int) -> SuspendedRequest:
        """Suspend a live request by rid, at a block boundary (so its
        boundary logits are valid), freeing its slot.  Returns the handle,
        also kept in :attr:`suspended` until resumed or released."""
        for slot, (req, _) in self._active.items():
            if req.rid == rid:
                return self._suspend_slot(slot)
        raise KeyError(f"rid {rid} is not live")

    def _suspend_slot(self, slot: int, *,
                      logits_valid: bool = True) -> SuspendedRequest:
        """Take slot ``slot``'s generation out into a handle and release
        the slot.  Paged: pin the sequence's full blocks, copy its partial
        last block and its slot-resident rows.  Contiguous: copy the
        stripe.  The slot's device rows
        stay as they are: a freed slot keeps decoding in the block, into
        its own stripe or, through its zeroed table row, the null block."""
        req, out = self._active.pop(slot)
        seed = self._seed_tokens.pop(slot, 0)
        produced = len(out.tokens) - seed   # tokens of this slot's lifetime
        idx = req.prompt_len + produced     # the rolled-back position
        self._host_index[slot] = idx
        history = np.concatenate(
            [req.prompt, np.asarray(out.tokens[seed:], np.int32)])
        kwargs = dict(source=self, logits_valid=logits_valid,
                      weight_version=self._slot_version[slot])
        logits = self._last_logits[slot].clone()
        if not self.paged:
            one = extract_cache(self.slots.cache, slot)
            one["index"].fill_(idx)
            sreq = SuspendedRequest(
                req, out, history, idx, req.max_new_tokens - produced,
                logits, one=one, **kwargs)
        else:
            bs = self.config.kv_block_size
            has_paged = bool(self.slots.paged_names)
            n_full = idx // bs if has_paged else 0
            pinned = self.slots.pin_prefix(slot, n_full)
            # the copies are queued before the release lets an admit reuse
            # the block and the rows, on the same stream
            tail = (self.slots.snapshot_block(
                int(self.slots.tables[slot, n_full]))
                if has_paged and idx % bs else {})
            sreq = SuspendedRequest(
                req, out, history, idx, req.max_new_tokens - produced,
                logits, block_ids=pinned, tail=tail,
                slot_leaves=self.slots.slot_rows(slot), **kwargs)
        self.slots.release(slot)
        self.suspended[req.rid] = sreq
        self._stats.suspends += 1
        return sreq

    def _materialize(self, sreq: SuspendedRequest) -> dict:
        """A batch=1 contiguous cache of a handle suspended from this
        engine: the stripe's copy itself (contiguous; a resume consumes
        it), or the pinned blocks gathered with the tail spliced on (paged,
        :meth:`PagedSlotManager.fetch`) beside the slot rows' copies."""
        if sreq.released:
            raise RuntimeError(
                f"suspended rid {sreq.req.rid} was already released")
        if not self.paged:
            one = dict(sreq.one)
            one["index"] = torch.tensor(sreq.index, dtype=torch.int32,
                                        device=self.device)
            return one
        one = self.slots.fetch(sreq.block_ids, sreq.tail, sreq.index)
        one.update(sreq.slot_leaves)
        return one

    def _release_suspended(self, sreq: SuspendedRequest) -> None:
        if self.paged:
            for bid in sreq.block_ids:
                self.slots.alloc.decref(bid)
        if self.suspended.get(sreq.req.rid) is sreq:
            del self.suspended[sreq.req.rid]

    def _forced_decode(self, kind: str, n: int, key: tuple, fn):
        """``fn()``, ``n`` forced decode steps at batch 1 on buffers this
        engine owns, on the card: the counterpart of the JAX engine's
        jitted ``inject`` scan, which specialises on the token count too.
        The first call of a ``kind`` runs eagerly and loads its kernels;
        later ones replay a CUDA graph per ``(kind, n)``, captured anew
        when ``key`` (the addresses ``fn`` reads and writes) moved."""
        if kind not in self._inject_warm:
            self._inject_warm.add(kind)
            return fn()
        entry = self._inject_graphs.get((kind, n))
        if entry is None or entry[0] != key:
            if entry is not None:
                entry[1].reset()
            t0 = time.perf_counter()
            with telemetry.span("engine.capture", kind="inject"):
                graph, out, counts = self._record_graph(fn)
            entry = self._inject_graphs[(kind, n)] = (key, graph, out,
                                                      counts)
            self.inject_captures += 1
            self.capture_s += time.perf_counter() - t0
        _, graph, out, counts = entry
        graph.replay()
        _build.add_counts(counts)
        return out

    def _forced_tokens(self, tokens: np.ndarray) -> torch.Tensor:
        """``tokens`` on the card, in the engine's token buffer (the graph
        of :meth:`_forced_decode` reads them there)."""
        toks = torch.from_numpy(tokens.astype(np.int32)).to(self.device)
        if self.device.type != "cuda":
            return toks
        if self._inject_toks is None:
            self._inject_toks = torch.zeros((self.config.max_seq_len,),
                                            dtype=torch.int32,
                                            device=self.device)
        self._inject_toks[:toks.shape[0]].copy_(toks)
        return self._inject_toks[:toks.shape[0]]

    def _inject(self, tokens: np.ndarray, one: dict):
        """Feed forced tokens (a tool's reply, or the replayed last token
        of a cut block) through the model's own decode step at batch 1 on
        the batch=1 cache ``one``, before it is adopted (contiguous
        pools); returns the logits after the last token, which predict
        the next one, and the advanced cache.  On the card ``one`` is
        copied into a cache buffer of the engine's first, whose steps
        :meth:`_forced_decode` runs; both results stay in engine buffers
        until the next injection (:meth:`admit_prefilled` copies them into
        the slot at once).  On the CPU the steps advance ``one`` itself."""
        toks = self._forced_tokens(tokens)
        if self.device.type != "cuda":
            return self._decode_steps(toks, one)
        buf = self._inject_one
        if buf is None or any(buf[k].shape != v.shape
                              for k, v in one.items()):
            buf = self._inject_one = {k: torch.empty_like(v)
                                      for k, v in one.items()}
        for k, v in one.items():
            buf[k].copy_(v)
        key = (tuple(_addresses(self.params, [])),
               tuple(_addresses([buf, toks], [])))
        return self._forced_decode(
            "copy", toks.shape[0], key, lambda: self._decode_steps(toks, buf))

    def _decode_steps(self, toks: torch.Tensor, one: dict):
        for i in range(toks.shape[0]):
            logits, one = self.model.decode_step(self.params,
                                                 toks[i:i + 1, None], one)
        return logits[0], one

    def _inject_in_slot(self, tokens: np.ndarray, slot: int):
        """Feed forced tokens through the pool's own batch-1 decode step
        in slot ``slot``, already admitted (paged pools): the kernel reads
        and writes the pool through the slot's table row, so an int8 pool
        stays int8 where a dequantized copy would round every K/V element
        to the model dtype.  Returns the logits after the last token.  On
        the card the row and the slot's index go through buffers of the
        engine's (the graph's addresses), the index back into the pool
        after the steps."""
        toks = self._forced_tokens(tokens)
        pool = self.slots.cache
        row = self.slots.device_tables()[slot:slot + 1]
        if self.device.type != "cuda":
            view = self.slots.slot_view(slot, pool["index"][slot:slot + 1])
            return self._pool_steps(toks, view, row)
        if self._inject_row is None:
            self._inject_row = torch.zeros_like(row)
            self._inject_index = torch.zeros((1,), dtype=torch.int32,
                                             device=self.device)
        self._inject_row.copy_(row)
        self._inject_index.copy_(pool["index"][slot:slot + 1])
        view = self.slots.slot_view(slot, self._inject_index)
        key = (tuple(_addresses(self.params, [])),
               tuple(_addresses([view, self._inject_row, toks], [])))
        logits = self._forced_decode(
            "slot", toks.shape[0], key,
            lambda: self._pool_steps(toks, view, self._inject_row))
        pool["index"][slot:slot + 1].copy_(self._inject_index)
        return logits

    def _model_step(self, token: torch.Tensor, cache: dict, tables):
        """One decode step of ``token`` over ``cache``, which the model
        updates in place; returns the logits."""
        if self._kernel_step:
            return self.model.kernel_decode_step(self.params, token, cache,
                                                 tables=tables)[0]
        return self.model.decode_step(self.params, token, cache)[0]

    def _pool_steps(self, toks: torch.Tensor, view: dict,
                    row: torch.Tensor):
        for i in range(toks.shape[0]):
            logits = self._model_step(toks[i:i + 1, None], view, row)
        return logits[0]

    def can_resume(self, sreq: SuspendedRequest, tool_tokens=(), *,
                   max_new_tokens: Optional[int] = None) -> bool:
        """Re-admission gate for a handle: a free slot and (paged) blocks
        for the continued sequence's worst-case budget."""
        if not self.slots.num_free:
            return False
        if not self.paged:
            return True
        budget = (max_new_tokens if max_new_tokens is not None
                  else max(sreq.remaining, 1))
        total = sreq.index + len(tool_tokens) + budget
        return self.slots.can_admit(total) or _evict_for(self.radix,
                                                         self.slots, total)

    def resume(self, sreq: SuspendedRequest, tool_tokens=(), *,
               max_new_tokens: Optional[int] = None,
               rid: Optional[int] = None,
               stop_tokens: Optional[tuple] = None,
               continue_output: bool = False) -> int:
        """Adopt a suspended generation into a free slot, feeding
        ``tool_tokens`` (the environment's reply) through the model first.

        The adoption is :meth:`admit_prefilled` of a request whose prompt
        is the handle's history (and the tool tokens), so a handle resumes
        on any engine of the same serving shape (``sreq.source`` holds the
        pins until it is materialized here).  With no tool tokens and the
        boundary logits carried, every tensor decode restarts from is moved
        by copies (an int8 pool's values and scales as stored): greedy
        continuation equals the uninterrupted run bit for bit.  A boundary
        cut out of a ``block_size > 1`` block replays the last history
        token, and tool tokens run, through a decode step at batch 1, whose
        products may round unlike the batched block's: on a paged pool in
        the adopted slot through the pool's own kernel
        (:meth:`_inject_in_slot`), on a contiguous one on the cache before
        it is adopted (:meth:`_inject`).

        ``continue_output=True`` (carrying a generation across a weight
        swap) continues the handle's :class:`RequestOutput`: tokens,
        behaviour logprobs and per-token weight versions accumulate.
        ``max_new_tokens`` grants a fresh budget (default: the handle's
        remaining one) and ``stop_tokens`` replaces the request's (``()``
        lets a final turn run to EOS; ``None`` inherits).  A resume
        consumes the handle.  Returns the slot."""
        if sreq.released:
            raise RuntimeError(
                f"suspended rid {sreq.req.rid} was already released")
        tool = np.asarray(tool_tokens, np.int32).reshape(-1)
        if tool.size == 0 and not sreq.logits_valid \
                and not self._rollback_safe:
            raise RuntimeError(
                f"rid {sreq.req.rid} was cut out of a fused decode block "
                f"and family {self.model.cfg.family!r} cannot replay past "
                f"recurrent state; resume with tool tokens")
        budget = (max_new_tokens if max_new_tokens is not None
                  else max(sreq.remaining, 1))
        prompt = (np.concatenate([sreq.history, tool])
                  if tool.size else sreq.history)
        src = sreq.req
        req = Request(rid=src.rid if rid is None else rid, prompt=prompt,
                      max_new_tokens=budget, arrival_time=src.arrival_time,
                      frontend=src.frontend, priority=src.priority,
                      deadline=src.deadline, job_id=src.job_id,
                      stop_tokens=(src.stop_tokens if stop_tokens is None
                                   else stop_tokens))
        if req.total_budget > self.config.max_seq_len:
            raise ValueError(
                f"resume of rid {req.rid}: history {sreq.index} + tool "
                f"{tool.size} + budget {budget} exceeds max_seq_len "
                f"{self.config.max_seq_len}")
        if not self.slots.num_free:
            raise RuntimeError("no free slot: gate resume on can_resume")
        one = sreq.source._materialize(sreq)
        forced = tool
        if not tool.size and not sreq.logits_valid:
            # the boundary logits were cut out of a fused block: replay
            # the last history token one position back, an overwrite of
            # the same KV position (attention masks by index)
            forced = sreq.history[-1:]
            one["index"] = torch.tensor(sreq.index - 1, dtype=torch.int32,
                                        device=self.device)
        if not forced.size:
            # the first resumed token samples from the carried boundary
            # row, stale across a carried weight swap: its version says so
            slot = self.admit_prefilled(req, sreq.logits, one)
            version = sreq.weight_version
        elif self.paged:
            # the slot holds the prompt only once the forced tokens ran:
            # it registers then
            slot = self._adopt(req, sreq.logits, one)
            self._last_logits[slot].copy_(self._inject_in_slot(forced, slot))
            if self.radix is not None:
                self._register_prefix(req, slot)
            version = self.weight_version
        else:
            logits, one = self._inject(forced, one)
            slot = self.admit_prefilled(req, logits, one)
            version = self.weight_version
        self._slot_version[slot] = version
        if continue_output:
            prev = sreq.out
            _, out = self._active[slot]
            out.prompt = prev.prompt
            out.tokens = list(prev.tokens)
            out.logprobs = list(prev.logprobs)
            out.token_versions = list(prev.token_versions)
            out.finish_reason = ""
            out.prefill_step = prev.prefill_step
            out.arrival_time = prev.arrival_time
            out.first_token_time = prev.first_token_time
            out.prefix_shared_blocks = prev.prefix_shared_blocks
            self._seed_tokens[slot] = len(out.tokens)
        sreq.release()
        self._stats.resumes += 1
        return slot

    def can_admit_prefilled(self, req: Request) -> bool:
        """Adoption gate for a prefilled cache (a transfer handle's, a
        resume's): a free slot and (paged) enough uncommitted blocks for
        the request's worst-case budget, evicting the radix tree under
        pressure.  No radix match: the prompt's KV arrives prefilled."""
        if not self.slots.num_free:
            return False
        return (not self.paged or self.slots.can_admit(req.total_budget)
                or _evict_for(self.radix, self.slots, req.total_budget))

    def admit_prefilled(self, req: Request, logits, one) -> int:
        """Adopt a prefilled request into a free slot, without running the
        model.  ``one`` is a batch=1 contiguous cache holding the prompt's
        state (``index`` = prompt length) and ``logits`` the logits after
        it (an int8 pool's blocks may come as stored, with their scales:
        :meth:`PagedSlotManager.fetch`).  The cache is written through the
        same in-place splice the admit path uses (:func:`insert_cache` /
        :meth:`PagedSlotManager.insert_prompt`) and
        the row's logits, liveness and budget are copied into the engine's
        buffers, so the decode block's CUDA graph stays valid.  With
        sharing on, the adopted prompt registers (for a resume, the
        episode's whole history), so that later requests share it.
        Returns the slot; gate on :meth:`can_admit_prefilled`, a full pool
        raises."""
        slot = self._adopt(req, logits, one)
        if self.radix is not None:
            self._register_prefix(req, slot)
        return slot

    def _adopt(self, req: Request, logits, one) -> int:
        """:meth:`admit_prefilled` short of the registration."""
        self._validate_stop_tokens(req)
        extra = set(one) - set(self.slots.cache)
        if extra:
            raise ValueError(f"cache leaves {sorted(extra)} (an int8 "
                             f"handle's) have no place in this pool")
        if not self.paged:
            slot = self.slots.assign(req.rid)
            insert_cache(self.slots.cache, one, slot)
        else:
            slot = self.slots.assign(req.rid, prompt_len=req.prompt_len,
                                     total_budget=req.total_budget)
            self.slots.insert_prompt(slot, one)
            self._stats.peak_kv_blocks = max(self._stats.peak_kv_blocks,
                                             self.slots.blocks_in_use)
        self._last_logits[slot].copy_(logits)
        self._alive[slot] = True
        self._remaining[slot] = req.max_new_tokens
        self._host_index[slot] = req.prompt_len
        self._slot_version[slot] = self.weight_version
        self._seed_tokens[slot] = 0
        out = RequestOutput(rid=req.rid, prompt=req.prompt,
                            prefill_step=self._stats.steps,
                            arrival_time=req.arrival_time,
                            priority=req.priority, deadline=req.deadline,
                            job_id=req.job_id)
        self._active[slot] = (req, out)
        self._stats.prefills += 1
        self._stats.adoptions += 1
        self._stats.peak_active = max(self._stats.peak_active,
                                      len(self._active))
        return slot

    def reset(self, params=None, generator: Optional[torch.Generator] = None,
              *, carry_live: bool = False) -> None:
        """Ready a drained engine for its next batch of requests: swap in
        freshly synced ``params`` (bumping ``weight_version``) and, when
        given, a new ``generator``, and drop the previous batch's outputs.
        :attr:`stats` restart from zero, so they count one batch.  The
        slot pool stays; this is how a training driver reuses one engine
        across GRPO iterations.  Raises on a live engine, a non-empty
        queue or suspended handles still pinning the pool.

        ``carry_live=True`` is partial-rollout continuation: every live
        generation is suspended, the weights swapped, and the generations
        resumed under the new weights with their outputs carried forward
        (each token's version says which weights sampled it).  Queued
        requests stay queued and the stats keep counting the batch;
        harvest finished outputs first, the reset drops them.  New weights
        capture the decode block's graph anew, once.  An ``engine.reset``
        span."""
        with telemetry.span("engine.reset"):
            self._reset(params, generator, carry_live)

    def _reset(self, params, generator, carry_live: bool) -> None:
        if params is not None and params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        carried: list[SuspendedRequest] = []
        if carry_live:
            for slot in sorted(self._active):
                carried.append(self._suspend_slot(slot))
        if self._active or (self.queue and not carry_live):
            raise RuntimeError("reset() on a live engine; drain it first")
        if self.suspended and not carry_live:
            raise RuntimeError(
                f"reset() with {len(self.suspended)} suspended request(s) "
                f"still pinning the pool (rids "
                f"{sorted(self.suspended)!r}); resume or release them, or "
                f"reset(carry_live=True)")
        if params is not None:
            self.params = params
            self.weight_version += 1
        if generator is not None:
            self.generator = generator
        if self.radix is not None:
            # new weights invalidate every cached prefill (logits and KV)
            self.radix.flush()
        # rids repeat across batches: per-request bookkeeping goes, the
        # measured service time stays
        self.policy.on_reset()
        if self.paged:
            pins = [b for s in self.suspended.values() for b in s.block_ids]
            if pins:
                # suspended handles hold blocks: conservation against
                # their pins instead of an empty pool
                self.slots.check(extra_pins=pins)
            else:
                # an idle engine holds no block: a dangling one here is a
                # leak that would compound across iterations
                self.slots.alloc.assert_clean(context="Engine.reset")
        self.finished.clear()
        self._unharvested.clear()
        if not carry_live:
            self._stats = EngineStats()
        for sreq in carried:
            self.resume(sreq, continue_output=True)

    # ---- checkpoints -------------------------------------------------------
    def export_state(self) -> dict:
        """Checkpoint the live serving state mid-flight: ``{"device":
        <tensor tree>, "host": <bookkeeping>}``.  The device part is
        copies (the engine's buffers keep changing in place), the host
        part a deep copy, so the snapshot stays valid however the engine
        runs on; :meth:`import_state` on an engine of the same model and
        config continues token for token."""
        device = {"cache": _clone_tree(self.slots.cache),
                  "last_logits": self._last_logits.clone(),
                  "alive": self._alive.clone(),
                  "remaining": self._remaining.clone()}
        if self.suspended:
            # the handles' tensors travel in the device section, their
            # metadata in the host one; their pins are in the alloc state
            device["suspended"] = {
                rid: {"logits": s.logits.clone(), "one": _clone_tree(s.one),
                      "tail": _clone_tree(s.tail),
                      "slot_leaves": _clone_tree(s.slot_leaves)}
                for rid, s in self.suspended.items()}
        slots: dict = {"owner": list(self.slots.owner),
                       "free": list(self.slots.free),
                       "events": list(self.slots.events)}
        if self.paged:
            a = self.slots.alloc
            slots.update(
                tables=self.slots.tables.copy(),
                nblocks=list(self.slots.nblocks),
                shared={s: list(v) for s, v in self.slots.shared.items()},
                alloc={"free": list(a.free),
                       "refcount": dict(a.refcount),
                       "quota": dict(a.quota),
                       "owned": {k: list(v) for k, v in a.owned.items()},
                       "events": list(a.events)})
        host = copy.deepcopy({
            "host_index": list(self._host_index),
            "active": dict(self._active),
            "queue": list(self.queue._q),
            "finished": dict(self.finished),
            "unharvested_rids": [o.rid for o in self._unharvested],
            "stats": self._stats,
            "slots": slots,
            "weight_version": self.weight_version,
            "slot_version": list(self._slot_version),
            "seed_tokens": dict(self._seed_tokens),
            "generator": (None if self.generator is None
                          else self.generator.get_state()),
            "suspended": {
                rid: {"req": s.req, "out": s.out, "history": s.history,
                      "index": s.index, "remaining": s.remaining,
                      "block_ids": s.block_ids,
                      "weight_version": s.weight_version,
                      "logits_valid": s.logits_valid}
                for rid, s in self.suspended.items()},
            "newly_suspended": [s.req.rid for s in self._newly_suspended],
        })
        if self.radix is not None:
            # the snapshots are copies no one writes: they travel as they
            # are; the tree's pins are in the alloc state
            device["radix"] = self.radix.export_device_state()
            host["radix"] = self.radix.export_host_state()
        return {"device": device, "host": host}

    def import_state(self, state: dict) -> None:
        """Restore an :meth:`export_state` snapshot (device leaves may come
        back as numpy arrays from a host cache).  Everything is copied into
        the engine's own buffers, in place: the decode block's CUDA graph
        keeps its addresses and is not captured anew."""
        dev = state["device"]
        for name, leaf in self.slots.cache.items():
            leaf.copy_(torch.as_tensor(dev["cache"][name]))
        for buf, key in ((self._last_logits, "last_logits"),
                         (self._alive, "alive"),
                         (self._remaining, "remaining")):
            buf.copy_(torch.as_tensor(dev[key]))
        host = copy.deepcopy(state["host"])
        if host["generator"] is not None and self.generator is not None:
            self.generator.set_state(host["generator"])
        self._host_index = list(host["host_index"])
        self._active = dict(host["active"])
        self.queue._q.clear()
        self.queue._q.extend(host["queue"])
        self.finished = dict(host["finished"])
        self._unharvested = [self.finished[r]
                             for r in host["unharvested_rids"]
                             if r in self.finished]
        self._stats = host["stats"]
        self.weight_version = host["weight_version"]
        self._slot_version = list(host["slot_version"])
        self._seed_tokens = {int(k): int(v)
                             for k, v in host["seed_tokens"].items()}
        dev_susp = dev.get("suspended", {})
        self.suspended = {}
        for rid, m in host["suspended"].items():
            d = dev_susp[rid]
            self.suspended[int(rid)] = SuspendedRequest(
                m["req"], m["out"], m["history"], m["index"],
                m["remaining"], _as_device(d["logits"], self.device),
                source=self, logits_valid=m["logits_valid"],
                block_ids=m["block_ids"],
                tail=_as_device(d["tail"], self.device),
                slot_leaves=_as_device(d.get("slot_leaves", {}),
                                       self.device),
                one=_as_device(d["one"], self.device),
                weight_version=m["weight_version"])
        self._newly_suspended = [self.suspended[r]
                                 for r in host["newly_suspended"]
                                 if r in self.suspended]
        sl = host["slots"]
        self.slots.owner = list(sl["owner"])
        self.slots.free = list(sl["free"])
        self.slots.events = list(sl["events"])
        if self.paged:
            self.slots.tables = sl["tables"].copy()
            self.slots.nblocks = list(sl["nblocks"])
            self.slots.shared = {int(s): list(v)
                                 for s, v in sl["shared"].items()}
            self.slots._dirty = True
            a = self.slots.alloc
            a.free = list(sl["alloc"]["free"])
            a.refcount = dict(sl["alloc"]["refcount"])
            a.quota = dict(sl["alloc"]["quota"])
            a.owned = {k: list(v) for k, v in sl["alloc"]["owned"].items()}
            a.events = list(sl["alloc"]["events"])
        if self.radix is not None:
            self.radix.import_state(
                host.get("radix"), _as_device(dev.get("radix", {}),
                                              self.device))


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

    ``controller`` (a :class:`~repro_torch.serve.elastic.ElasticController`)
    closes the capacity loop: every arrival passes its admission gate,
    which may shed it (recorded by the controller, never submitted) or
    clamp its decode budget, and between steps the controller may replace
    the engine by a resized one, live work carried over.  The report then
    has an ``"elastic"`` section (capacity-seconds, sheds and degrades,
    the resize history) and ``"engine"``, the engine the trace ended on."""
    pending = sorted(requests, key=lambda r: (r.arrival_time, r.rid))
    t0 = time.perf_counter()
    engine.clock = lambda: time.perf_counter() - t0
    if controller is not None:
        controller.attach(engine, engine.clock())
    while pending or not engine.idle:
        now = engine.clock()
        while pending and pending[0].arrival_time <= now:
            req = pending[0]
            if controller is not None:
                verdict, req = controller.admit(req, now, engine)
                if verdict == "shed":
                    pending.pop(0)          # recorded by the controller
                    continue
            if not engine.submit(req):
                break                       # queue full: defer, retry after
            pending.pop(0)                  # the engine drains a bit
        if controller is not None:
            engine = controller.maybe_resize(engine, engine.clock())
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
                if controller is not None:
                    verdict, nxt = controller.admit(nxt, engine.clock(),
                                                    engine)
                    if verdict == "shed":
                        pending.pop(0)
                        continue
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
    if engine.radix is not None:
        report["prefix"] = dict(engine.radix.stats,
                                blocks_saved=s.blocks_saved,
                                hit_admits=s.prefix_hits)
    if controller is not None:
        report["elastic"] = controller.summary(makespan)
        report["engine"] = engine
    return report
