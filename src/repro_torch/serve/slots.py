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
where the JAX package rebuilds them with ``.at[].set``.  Prefix sharing
(``assign_shared``, ``pin_prefix``) comes with the radix slice.
"""
from __future__ import annotations

from typing import Optional

import torch
import numpy as np

from repro_torch.models.kvcache import SCALE_SUFFIX, quantize_kv
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
        self._tables_dev = torch.from_numpy(self.tables.copy()).to(device)
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

    def release(self, slot: int) -> None:
        """Recycle a finished slot: free its blocks, zero its table row."""
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
        """Device copy of the block tables (re-uploaded only when changed).

        The upload snapshots ``self.tables`` (``.copy()``) before
        ``torch.from_numpy``: ``from_numpy`` aliases the host buffer, which
        keeps mutating in place, so without the snapshot a CPU "upload"
        would be the live array itself and a later row zeroing (a slot
        released right after its admit) would rewrite tables already handed
        to a scatter or a decode step."""
        if self._dirty:
            self._tables_dev = torch.from_numpy(self.tables.copy()).to(
                self.device)
            self._dirty = False
        return self._tables_dev

    def check(self) -> None:
        """Cross-structure invariants: released rows zeroed, live rows
        disjoint and in sync with the allocator."""
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
        assert set(flat) == set(self.alloc.refcount), \
            "materialized blocks out of sync with tables"
