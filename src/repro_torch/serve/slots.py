"""Slot-based KV-cache managers for continuous batching.

Counterpart of ``repro/serve/slots.py``.  Two memory layouts back the same
slot abstraction:

**Contiguous** (:class:`SlotManager`) — one stacked decode cache whose
``index`` is a per-slot vector; each slot owns a full ``max_seq_len``
stripe, and :func:`insert_cache` overwrites a whole stripe with a freshly
prefilled single-request cache (so a recycled slot can never leak the
previous request's KV).

**Paged** (:class:`PagedSlotManager`) — ``k``/``v`` live in a shared pool
of fixed-size blocks; each live slot holds a block-table row of physical
block ids.  Blocks are reserved at admit for the request's whole budget
and materialized as its ``index`` crosses block boundaries
(:meth:`PagedSlotManager.ensure`).  Unassigned and released table entries
point at the null block 0.  :func:`insert_paged` writes a prefilled cache
through a table row.

Both write the pool tensors in place (slice assignment / ``index_put_``)
where the JAX package rebuilds them with ``.at[].set``.

Suspension reads a slot back out: :func:`extract_cache` copies a
contiguous slot's stripe into a batch=1 cache, and
:meth:`PagedSlotManager.pin_prefix` pins a paged slot's full blocks in
place, so that they outlive the slot's release.  Prefix sharing
(``assign_shared``) comes with the radix slice.
"""
from __future__ import annotations

from typing import Optional

import torch
import numpy as np

from repro_torch.models.attention import gather_blocks
from repro_torch.models.common import torch_dtype
from repro_torch.models.kvcache import (SCALE_SUFFIX, dequantize_kv,
                                        quantize_kv)
from repro_torch.serve.blocks import BlockAllocator, blocks_for


def insert_cache(pool: dict, one: dict, slot: int) -> dict:
    """Write a batch=1 cache into ``pool`` at batch position ``slot``, in
    place (every non-index leaf keeps batch at axis 1)."""
    for name, leaf in pool.items():
        if name == "index":
            leaf[slot] = one[name]
        else:
            leaf[:, slot] = one[name][:, 0]
    return pool


def extract_cache(pool: dict, slot: int) -> dict:
    """Slot ``slot`` of a contiguous ``pool`` as a batch=1 cache: the
    inverse of :func:`insert_cache`.  Every leaf is a copy, never a view:
    the pool is written in place by later decode steps (a CUDA graph's
    replays among them) and admits, and the copy must keep what the slot
    held when it was taken."""
    return {name: (leaf[slot] if name == "index" else
                   leaf[:, slot:slot + 1]).clone()
            for name, leaf in pool.items()}


def insert_paged(pool: dict, one: dict, table_row: torch.Tensor,
                 slot: int) -> dict:
    """Write a prefilled batch=1 contiguous cache into the block pools
    through ``table_row (MB,)``, in place: the sequence is cut into
    ``MB`` blocks (zero-padded) and block j lands in pool block
    ``table_row[j]`` (unassigned entries are 0, so those blocks fall into
    the null block).  int8 pools quantize each position on the write."""
    for name, leaf in pool.items():
        if name.endswith(SCALE_SUFFIX):
            continue                     # written beside the parent leaf
        if name == "index":
            leaf[slot] = one[name]
            continue
        bs, MB = leaf.shape[2], table_row.shape[0]
        u = one[name][:, 0]                               # (L, S, Hkv, hd)
        u = torch.nn.functional.pad(
            u, (0, 0, 0, 0, 0, MB * bs - u.shape[1]))
        u = u.reshape(u.shape[0], MB, bs, *u.shape[2:])
        rows = table_row.long()
        if name + SCALE_SUFFIX in pool:
            q, s = quantize_kv(u, 3)
            leaf[:, rows] = q
            pool[name + SCALE_SUFFIX][:, rows] = s
        else:
            leaf[:, rows] = u.to(leaf.dtype)
    return pool


class SlotManager:
    """Fixed pool of ``num_slots`` batch slots over one stacked KV cache."""

    def __init__(self, model, num_slots: int, max_seq_len: int, *, device):
        self.model = model
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len
        cache = model.init_cache(num_slots, max_seq_len, device=device)
        cache["index"] = torch.zeros((num_slots,), dtype=torch.int32,
                                     device=device)
        self.cache = cache
        self.owner: list[Optional[int]] = [None] * num_slots  # rid per slot
        self.free: list[int] = list(range(num_slots - 1, -1, -1))  # LIFO
        self.events: list[tuple] = []     # ("assign"|"release", rid, slot)

    @property
    def num_free(self) -> int:
        return len(self.free)

    def assign(self, rid: int) -> int:
        """Claim the lowest-numbered free slot for request ``rid``."""
        if not self.free:
            raise RuntimeError("no free slot")
        slot = self.free.pop()
        if self.owner[slot] is not None:
            raise AssertionError(f"slot {slot} already owned by "
                                 f"{self.owner[slot]}")
        self.owner[slot] = rid
        self.events.append(("assign", rid, slot))
        return slot

    def release(self, slot: int) -> None:
        """Recycle a slot whose request finished (EOS or budget)."""
        rid = self.owner[slot]
        if rid is None:
            raise AssertionError(f"slot {slot} is already free")
        self.owner[slot] = None
        self.free.append(slot)
        self.events.append(("release", rid, slot))


class PagedSlotManager:
    """Slot pool whose ``k``/``v`` live in shared fixed-size blocks.

    ``num_blocks`` defaults to the contiguous pool's footprint
    (``num_slots`` full stripes)."""

    def __init__(self, model, num_slots: int, max_seq_len: int, *,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 kv_dtype: Optional[str] = None, device):
        self.model = model
        self.num_slots = num_slots
        self.max_seq_len = max_seq_len
        self.block_size = block_size
        self.kv_dtype = kv_dtype
        self.device = device
        self.max_blocks = blocks_for(max_seq_len, block_size)  # per slot
        if num_blocks is None:
            num_blocks = num_slots * self.max_blocks
        self.alloc = BlockAllocator(num_blocks, block_size)
        self.cache = model.init_paged_cache(
            num_slots, max_seq_len, block_size=block_size,
            num_blocks=num_blocks, kv_dtype=kv_dtype, device=device)
        self.owner: list[Optional[int]] = [None] * num_slots
        self.free: list[int] = list(range(num_slots - 1, -1, -1))
        self.events: list[tuple] = []
        self.tables = np.zeros((num_slots, self.max_blocks), np.int32)
        self.nblocks = [0] * num_slots     # materialized blocks per slot
        # one device buffer for the manager's lifetime (a CUDA graph of
        # the decode block reads it by address), staged through a host
        # buffer of its own
        self._tables_host = torch.zeros(self.tables.shape, dtype=torch.int32)
        self._tables_dev = torch.zeros(self.tables.shape, dtype=torch.int32,
                                       device=device)
        self._dirty = False

    @property
    def num_free(self) -> int:
        return len(self.free)

    @property
    def blocks_in_use(self) -> int:
        return self.alloc.num_live

    def blocks_required(self, total_budget: int) -> int:
        """Worst-case blocks a request with this prompt+decode budget can
        write."""
        return blocks_for(min(total_budget, self.max_seq_len),
                          self.block_size)

    def can_admit(self, total_budget: int) -> bool:
        """Admission gate: a free slot and enough uncommitted pool for the
        request's worst-case budget."""
        return bool(self.free) and self.alloc.can_reserve(
            self.blocks_required(total_budget))

    def assign(self, rid: int, *, prompt_len: int, total_budget: int) -> int:
        """Claim a slot + block reservation; materialize the prompt's
        blocks."""
        if not self.free:
            raise RuntimeError("no free slot")
        slot = self.free.pop()
        if self.owner[slot] is not None:
            raise AssertionError(f"slot {slot} already owned by "
                                 f"{self.owner[slot]}")
        self.alloc.reserve(rid, self.blocks_required(total_budget))
        self.owner[slot] = rid
        self.events.append(("assign", rid, slot))
        if prompt_len:
            self.ensure(slot, prompt_len - 1)
        return slot

    def ensure(self, slot: int, upto_pos: int) -> None:
        """Materialize blocks so the slot's table covers positions
        ``<= upto_pos``, clamped to the request's quota (writes past the
        budget fall through to the null block by design)."""
        rid = self.owner[slot]
        if rid is None:
            raise AssertionError(f"ensure on free slot {slot}")
        want = min(upto_pos // self.block_size + 1, self.max_blocks)
        while self.nblocks[slot] < want and self.alloc.quota.get(rid, 0) > 0:
            bid = self.alloc.allocate(rid)
            self.tables[slot, self.nblocks[slot]] = bid
            self.nblocks[slot] += 1
            self._dirty = True

    def pin_prefix(self, slot: int, n: int) -> list[int]:
        """Incref the slot's first ``n`` table entries (full blocks that no
        decode step writes again) for a holder outside the slot, such as a
        suspended request, and return their ids.  The pins survive
        :meth:`release` of the slot: the blocks stay where they are,
        uncopied, until the holder decrefs them."""
        rid = self.owner[slot]
        if rid is None:
            raise AssertionError(f"pin_prefix on free slot {slot}")
        if n > self.nblocks[slot]:
            raise AssertionError(
                f"pin_prefix: {n} blocks requested but slot {slot} has "
                f"only {self.nblocks[slot]} materialized")
        ids = [int(b) for b in self.tables[slot, :n]]
        for bid in ids:
            self.alloc.incref(bid)
        return ids

    def copy_block(self, pid: int) -> dict:
        """Block ``pid`` of every paged leaf, ``(L, bs, Hkv, hd)``, as a
        copy in the model dtype (int8 dequantized): a suspended sequence's
        partial last block, which the slot's release hands back to the
        allocator."""
        dt = torch_dtype(self.model.cfg.dtype)
        out = {}
        for name in self.model.paged_cache_names():
            blk = self.cache[name][:, pid]
            if name + SCALE_SUFFIX in self.cache:
                out[name] = dequantize_kv(
                    blk, self.cache[name + SCALE_SUFFIX][:, pid], dt)
            else:
                out[name] = blk.clone()
        return out

    def fetch(self, block_ids, tail: dict, index: int) -> dict:
        """A batch=1 contiguous cache of a sequence whose full blocks are
        ``block_ids`` of this pool (pinned) and whose partial last block
        is ``tail`` (:meth:`copy_block`'s copy, or empty): the blocks
        gathered through a null-padded table row, int8 dequantized to the
        model dtype, the tail spliced after them, ``index`` its length.
        Positions past ``index`` hold what the null block holds; a decode
        step writes a position before anything reads it.  The port's copy
        of the JAX package's handle fetch (``serve/disagg.py``
        ``_transfer_fns``)."""
        bs, n_full = self.block_size, len(block_ids)
        row = torch.zeros((self.max_blocks,), dtype=torch.int32)
        row[:n_full] = torch.as_tensor(list(block_ids), dtype=torch.int32)
        row = row.to(self.device)
        dt = torch_dtype(self.model.cfg.dtype)
        out = {"index": torch.tensor(index, dtype=torch.int32,
                                     device=self.device)}
        for name in self.model.paged_cache_names():
            seq = gather_blocks(self.cache[name], row, axis=1)
            if name + SCALE_SUFFIX in self.cache:
                seq = dequantize_kv(seq, gather_blocks(
                    self.cache[name + SCALE_SUFFIX], row, axis=1), dt)
            if name in tail:
                seq[:, n_full * bs:(n_full + 1) * bs] = tail[name]
            out[name] = seq[:, None]          # re-grow the batch=1 axis
        return out

    def release(self, slot: int) -> None:
        """Recycle a finished slot: free its blocks (pinned ones stay live
        until their holder lets go), zero its table row."""
        rid = self.owner[slot]
        if rid is None:
            raise AssertionError(f"slot {slot} is already free")
        self.alloc.free_all(rid)
        self.tables[slot, :] = 0           # dead slot writes -> null block
        self.nblocks[slot] = 0
        self._dirty = True
        self.owner[slot] = None
        self.free.append(slot)
        self.events.append(("release", rid, slot))

    def device_tables(self) -> torch.Tensor:
        """The block tables on the device: one ``(N, MB)`` int32 buffer,
        the same tensor on every call, refreshed in place when the host
        tables changed since the last call.

        The refresh snapshots ``self.tables`` into a host buffer and copies
        that: the live array keeps mutating in place, so a copy read from
        it (on the CPU, or asynchronously on the card) would let a later
        row zeroing (a slot released right after its admit) rewrite
        tables already handed to a scatter or a decode step.  Until the
        next call the buffer keeps what it was given."""
        if self._dirty:
            np.copyto(self._tables_host.numpy(), self.tables)
            self._tables_dev.copy_(self._tables_host, non_blocking=True)
            self._dirty = False
        return self._tables_dev

    def check(self, extra_pins=()) -> None:
        """Cross-structure invariants: released rows zeroed, live rows
        disjoint and, with ``extra_pins`` (block ids held by pins outside
        the slots, such as suspended requests'), in sync with the
        allocator."""
        self.alloc.check()
        flat = []
        for s in range(self.num_slots):
            if self.owner[s] is None:
                assert not self.tables[s].any(), "released row not zeroed"
                continue
            row = self.tables[s]
            assert not row[self.nblocks[s]:].any()
            flat += [int(b) for b in row[:self.nblocks[s]]]
        assert 0 not in flat, "live table row points at the null block"
        assert len(set(flat)) == len(flat), "block shared across slots"
        live = set(flat) | set(extra_pins)
        assert live == set(self.alloc.refcount), \
            "materialized blocks out of sync with tables/pins"
        for bid in extra_pins:
            assert self.alloc.refcount.get(bid, 0) >= 1
