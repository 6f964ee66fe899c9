"""Disaggregated prefill: a dedicated prefill engine that hands finished
prompts to a decode engine as ref-counted KV transfer handles.

Counterpart of ``repro/serve/disagg.py``.  Prompt prefill is
compute-bound and comes in bursts, decode is bound by memory bandwidth
and steady, so each gets an engine of its own with its own slot and block
pool; the router (:mod:`repro_torch.serve.router`) moves handles between
the two pools on one card, in process.  Everything the decode side needs
travels in the handle.

Paged, the transfer rides the allocator's reference counts:

* the prefill engine admits a request under its admission policy,
  prefills it into a transient slot of its own pool and takes a boundary
  snapshot, as radix registration does: a copy of the partial tail block
  (as the pool stores it), the slot-resident rows and the post-prompt
  logits;
* the prompt's **full** blocks are pinned (``incref``) under a
  :class:`KVTransferHandle` and the slot is released at once, so its tail
  block is recycled while the full blocks stay in the prefill pool,
  uncopied, until the decode engine adopts or drops the handle.
  Un-adopted handles are the prefill pool's backpressure: admission gates
  on uncommitted blocks;
* adoption (:meth:`PrefillEngine.export_cache`, then
  ``Engine.admit_prefilled``) gathers the pinned blocks through a padded
  table row (:meth:`~repro_torch.serve.slots.PagedSlotManager.fetch`),
  splices the tail back in and writes the result into a fresh slot of the
  *decode* pool; then the handle's pins drop.  Every tensor the decode
  side starts from is the prefill's output moved by copies, so greedy
  tokens and log-probabilities equal the monolithic engine's bit for bit.
  Between int8 pools the handle carries the int8 values and their scales
  as stored, and the decode pool takes them unchanged.  (The JAX package
  dequantizes on the way out and quantizes again on the way in; in
  float32 the scale ``amax * (1/127)`` recomputed from the dequantized
  block can move by an ulp, which moved logprobs by 9.5e-7 on the CPU.)

With ``prefix_share`` the prefill engine keeps a radix tree over its own
pool: an exact repeat becomes a handle with no model compute, and a
request sharing a block-aligned prefix pins those blocks and writes only
its extension.  A paged handle of rwkv6 or zamba2 carries the slot rows
of their recurrent state in ``slot_leaves`` (rwkv6's state is all slot
rows: no block is pinned).  The contiguous layout disaggregates too, the
handle carrying the whole batch=1 prefill cache (slots bound how many
un-adopted handles may be resident).
"""
from __future__ import annotations

import time

import torch

from repro_torch.device import resolve_device
from repro_torch.serve.engine import (EngineConfig, EngineStats,
                                      _evict_for, _prefill, check_frontend)
from repro_torch.serve.queue import RequestQueue
from repro_torch.serve.radix import RadixPrefixIndex
from repro_torch.serve.request import Request
from repro_torch.serve.sched import make_policy
from repro_torch.serve.slots import PagedSlotManager


class KVTransferHandle:
    """Everything the decode engine needs to adopt one finished prompt.

    Paged: ``block_ids`` are the prompt's full blocks, in the *prefill*
    pool and pinned (one ``incref`` each) for this handle; ``tail``,
    ``slot_leaves`` and ``logits`` are the snapshot a radix entry carries.
    Contiguous: ``one`` is the whole batch=1 prefill cache and
    ``block_ids`` is empty.

    :meth:`release` drops the pins exactly once (idempotent), so whoever
    notices a handle dropped mid-flight may release it.  The prefill
    engine's ``reset`` asserts a clean pool once every handle is
    released."""

    __slots__ = ("req", "logits", "block_ids", "tail", "slot_leaves",
                 "one", "source", "prefill_time_s", "from_prefix_hit",
                 "released")

    def __init__(self, req: Request, logits, block_ids, tail, slot_leaves,
                 *, source, one=None, prefill_time_s: float = 0.0,
                 from_prefix_hit: bool = False):
        self.req = req
        self.logits = logits
        self.block_ids = tuple(int(b) for b in block_ids)
        self.tail = tail
        self.slot_leaves = slot_leaves
        self.one = one                      # contiguous: batch=1 cache
        self.source = source                # the PrefillEngine holding pins
        self.prefill_time_s = prefill_time_s
        self.from_prefix_hit = from_prefix_hit
        self.released = False

    def release(self) -> None:
        """Drop this handle's pins in the prefill pool (idempotent)."""
        if self.released:
            return
        self.released = True
        self.source._release_handle(self)
        self.one = None
        self.tail = {}
        self.slot_leaves = {}


class PrefillEngine:
    """Prompt-only engine: admits requests under a scheduler policy,
    prefills them into its own pool, and emits
    :class:`KVTransferHandle`\\ s.

    ``config.num_slots`` bounds prefills per scheduler tick (paged: the
    donor slot is transient) or resident un-adopted handles (contiguous:
    each holds a whole cache).  ``config.num_kv_blocks`` sizes the paged
    pool that un-adopted handles and the radix tree occupy.  ``device``
    defaults to the CUDA card; ``params`` must live there."""

    def __init__(self, model, params, config: EngineConfig, *, policy=None,
                 device=None):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"prefill engine on {self.device}")
        self.model = model
        self.params = params
        self.config = config
        self.queue = RequestQueue(config.max_waiting)
        self.policy = policy if policy is not None else \
            make_policy(config.sched)
        self.paged = config.kv_layout == "paged"
        if self.paged:
            self.slots = PagedSlotManager(
                model, config.num_slots, config.max_seq_len,
                block_size=config.kv_block_size,
                num_blocks=config.num_kv_blocks,
                kv_dtype=(None if config.kv_dtype == "auto"
                          else config.kv_dtype),
                device=self.device)
        else:
            # the prefill makes a self-contained batch=1 cache: there is
            # no donor pool, capacity is resident handles
            self.slots = None
        self.radix = (RadixPrefixIndex(self.slots.alloc)
                      if config.prefix_share else None)
        self.ready: list[KVTransferHandle] = []
        self.resident = 0                   # handles made, not released
        self.stats = EngineStats()
        self.clock = None

    # ---- submission --------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Enqueue; ``False`` = queue full (backpressure).  Only the
        prompt's limits (and its frontend) are checked here; the router
        checks the decode side first."""
        check_frontend(self.model.cfg, req)
        if req.prompt_len > self.config.max_seq_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} exceeds "
                f"prefill max_seq_len {self.config.max_seq_len}")
        if self.paged:
            need = self.slots.blocks_required(req.prompt_len)
            if need > self.slots.alloc.num_blocks:
                raise ValueError(
                    f"request {req.rid}: prompt needs {need} KV blocks but "
                    f"the prefill pool has {self.slots.alloc.num_blocks}")
        return self.queue.push(req)

    @property
    def idle(self) -> bool:
        return not self.queue

    # ---- admission ---------------------------------------------------------
    def _match(self, req: Request, *, count: bool = False):
        """Radix lookup (``None`` with sharing off or no match);
        ``count=True`` marks the admission lookup.  A frontend request
        bypasses the tree, as in :meth:`Engine._match`."""
        if self.radix is None or req.frontend is not None:
            return None
        return self.radix.match(req, count=count)

    def _can_admit(self, req: Request) -> bool:
        """Enough uncommitted blocks for the *prompt* (the decode budget
        is the decode pool's), net of prefix-shared blocks.  Exact hits
        need neither compute nor blocks and always pass.  Under pressure
        the tree LRU-evicts, sparing this request's path, and as a last
        resort that path too."""
        m = self._match(req)
        if m is not None and m.exact:
            return True
        if not self.paged:
            return self.resident < self.config.num_slots
        if not self.slots.num_free:
            return False
        if self.slots.can_admit(req.prompt_len, shared_blocks=(
                m.n_shared if m is not None else 0)):
            return True
        return _evict_for(self.radix, self.slots, req.prompt_len, m)

    @torch.no_grad()
    def step(self) -> int:
        """One prefill tick: admit and prefill up to ``num_slots`` picked
        requests, a handle each onto :attr:`ready`.  Returns the handles
        made (0 = nothing admissible)."""
        made = 0
        now = self.clock() if self.clock is not None else 0.0
        while self.queue and made < self.config.num_slots:
            idx = self.policy.pick(self.queue, self._can_admit, now=now,
                                   live_tokens={})
            if idx is None:
                break
            req = self.queue.pop_at(idx)
            self.ready.append(self._prefill_one(req))
            made += 1
        return made

    def pop_ready(self) -> list[KVTransferHandle]:
        out, self.ready = self.ready, []
        return out

    def _prefill_one(self, req: Request) -> KVTransferHandle:
        t0 = time.perf_counter()
        m = self._match(req, count=True)
        if m is not None and m.exact:
            # a handle straight from the boundary snapshot, no compute:
            # the path's blocks pinned under it (the tree keeps its own)
            self.radix.touch(m)
            snap = m.snapshot
            for bid in m.block_ids:
                self.slots.alloc.incref(bid)
            self.stats.prefix_hits += 1
            self.stats.blocks_saved += m.n_shared
            handle = KVTransferHandle(
                req, snap.logits, m.block_ids, dict(snap.tail),
                dict(snap.slot_leaves), source=self,
                prefill_time_s=time.perf_counter() - t0,
                from_prefix_hit=True)
        elif not self.paged:
            logits, one = _prefill(self.model, self.params, req,
                                   self.config.max_seq_len, self.device)
            handle = KVTransferHandle(req, logits, (), {}, {}, source=self,
                                      one=one,
                                      prefill_time_s=time.perf_counter() - t0)
        else:
            handle = self._prefill_paged(req, t0, m)
        self.resident += 1
        self.stats.prefills += 1
        if self.paged:
            self.stats.peak_kv_blocks = max(self.stats.peak_kv_blocks,
                                            self.slots.blocks_in_use)
        return handle

    def _prefill_paged(self, req: Request, t0: float,
                       m=None) -> KVTransferHandle:
        """Donor and partial-hit path: prefill into a transient slot (on a
        partial hit the matched blocks pinned, not allocated, and the
        write masked off them), snapshot, register, pin the full blocks
        under the handle and release the slot."""
        logits, one = _prefill(self.model, self.params, req,
                               self.config.max_seq_len, self.device)
        n_shared = m.n_shared if m is not None else 0
        if m is not None:
            self.radix.touch(m)
            slot = self.slots.assign_shared(
                req.rid, prompt_len=req.prompt_len,
                total_budget=req.prompt_len, shared_ids=m.block_ids)
            self.stats.prefix_partial_hits += 1
            self.stats.blocks_saved += n_shared
        else:
            slot = self.slots.assign(req.rid, prompt_len=req.prompt_len,
                                     total_budget=req.prompt_len)
        self.slots.insert_prompt(slot, one, n_shared)
        block_ids, tail, slot_leaves = self.slots.boundary(slot,
                                                           req.prompt_len)
        if self.radix is not None and req.frontend is None:
            self.radix.register(req, block_ids, logits=logits, tail=tail,
                                slot_leaves=slot_leaves)
        pinned = self.slots.pin_prefix(slot, len(block_ids))
        self.slots.release(slot)        # the tail block lives in `tail`
        return KVTransferHandle(req, logits, pinned, tail, slot_leaves,
                                source=self,
                                prefill_time_s=time.perf_counter() - t0)

    # ---- adoption / release ------------------------------------------------
    def export_cache(self, handle: KVTransferHandle) -> dict:
        """The batch=1 cache the decode engine adopts (the transfer
        itself).  Paged: the pinned blocks gathered from this pool as
        stored, the tail spliced on (:meth:`PagedSlotManager.fetch`).
        Contiguous: the handle's cache."""
        if handle.released:
            raise RuntimeError(
                f"handle for rid {handle.req.rid} was already released")
        if not self.paged:
            return handle.one
        one = self.slots.fetch(handle.block_ids, handle.tail,
                               handle.req.prompt_len)
        one.update(handle.slot_leaves)
        return one

    def _release_handle(self, handle: KVTransferHandle) -> None:
        for bid in handle.block_ids:
            self.slots.alloc.decref(bid)
        self.resident -= 1

    def reset(self, params=None, *, carry_live: bool = False) -> None:
        """Swap weights between batches.  Requires the queue drained and
        every handle released; asserts the block pool clean afterwards,
        the conservation check ``Engine.reset`` makes, over handle pins
        too.  :attr:`stats` restart from zero, as ``Engine.reset``'s do,
        unless ``carry_live`` (the router's live weight sync: the batch
        goes on)."""
        if self.queue or self.ready:
            raise RuntimeError("reset() on a live prefill engine; drain or "
                               "drop pending handles first")
        if self.resident:
            raise RuntimeError(
                f"reset() with {self.resident} un-released transfer "
                f"handle(s) still pinning the prefill pool")
        if params is not None:
            if params["embed"].device != self.device:
                raise ValueError(f"params live on {params['embed'].device}, "
                                 f"the prefill engine on {self.device}")
            self.params = params
        if self.radix is not None:
            self.radix.flush()
        self.policy.on_reset()
        if self.paged:
            self.slots.alloc.assert_clean(context="PrefillEngine.reset")
        if not carry_live:
            self.stats = EngineStats()
