"""Slot-based KV-cache managers for continuous batching.

Counterpart of ``repro/serve/slots.py``.  Two memory layouts back the same
slot abstraction:

**Contiguous** (:class:`SlotManager`) — one stacked decode cache whose
``index`` is a per-slot vector; each slot owns a full ``max_seq_len``
stripe, and :func:`insert_cache` overwrites a whole stripe with a freshly
prefilled single-request cache (so a recycled slot can never leak the
previous request's KV).

**Paged** (:class:`PagedSlotManager`) — the leaves with a sequence axis
(``k``/``v``; zamba2's ``attn_k``/``attn_v``) live in a shared pool of
fixed-size blocks; each live slot holds a block-table row of physical
block ids.  Blocks are reserved at admit for the request's whole budget
and materialized as its ``index`` crosses block boundaries
(:meth:`PagedSlotManager.ensure`).  Unassigned and released table entries
point at the null block 0.  Every other leaf (zamba2's ``conv``/``ssm``,
all of rwkv6's state) stays per slot and rides with it; a family with no
paged leaf needs no block at all.  :func:`insert_paged` writes a
prefilled cache through a table row.

Both write the pool tensors in place (slice assignment / ``index_put_``)
where the JAX package rebuilds them with ``.at[].set``.

Suspension reads a slot back out: :func:`extract_cache` copies a
contiguous slot's stripe into a batch=1 cache, and
:meth:`PagedSlotManager.pin_prefix` pins a paged slot's full blocks in
place, so that they outlive the slot's release;
:meth:`PagedSlotManager.fetch` gathers such blocks back into a batch=1
cache as they are stored.

Radix prefix sharing (``serve/radix.py``) puts one block in several table
rows: :meth:`PagedSlotManager.assign_shared` claims a slot whose leading
entries are shared prompt blocks, each pinned (``incref``) under the slot
in ``shared`` and unpinned at release.  A slot's *owned* entries stay
disjoint across slots; shared ones repeat (:meth:`PagedSlotManager.check`).
:meth:`PagedSlotManager.insert_prompt` writes a prompt past its shared
blocks, and :meth:`PagedSlotManager.boundary` copies what a radix entry
keeps: the partial last block as the pool stores it
(:meth:`PagedSlotManager.snapshot_block`, int8 with its scales, written
back by :meth:`PagedSlotManager.seed_block`) and the slot rows.
"""
from __future__ import annotations

from typing import Optional

import torch
import numpy as np

from repro_torch.models.attention import gather_blocks
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
                 slot: int, paged) -> dict:
    """Write a prefilled batch=1 contiguous cache into a paged pool, in
    place.  Each ``paged`` leaf's sequence is cut into ``MB`` blocks
    (zero-padded) and block j lands in pool block ``table_row[j]``
    (unassigned entries are 0, so those blocks fall into the null block);
    int8 pools quantize each position on the write, unless ``one`` carries
    int8 values with their scales (``PagedSlotManager.fetch``): those are
    written as they are.  Every other leaf is slot-resident and lands in
    row ``slot``, as :func:`insert_cache` writes it."""
    def blocks(u, MB, bs):
        u = u[:, 0]                                    # (L, S, ...)
        pad = [0, 0] * (u.dim() - 2) + [0, MB * bs - u.shape[1]]
        u = torch.nn.functional.pad(u, pad)
        return u.reshape(u.shape[0], MB, bs, *u.shape[2:])

    for name, leaf in pool.items():
        if name.endswith(SCALE_SUFFIX):
            continue                     # written beside the parent leaf
        if name == "index":
            leaf[slot] = one[name]
            continue
        if name not in paged:
            leaf[:, slot] = one[name][:, 0]
            continue
        bs, MB = leaf.shape[2], table_row.shape[0]
        rows = table_row.long()
        sname = name + SCALE_SUFFIX
        if sname in one:
            leaf[:, rows] = blocks(one[name], MB, bs)
            pool[sname][:, rows] = blocks(one[sname], MB, bs)
            continue
        u = blocks(one[name], MB, bs)
        if sname in pool:
            q, s = quantize_kv(u, 3)
            leaf[:, rows] = q
            pool[sname][:, rows] = s
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
        self.paged_names = model.paged_cache_names()
        self.alloc = BlockAllocator(num_blocks, block_size)
        self.cache = model.init_paged_cache(
            num_slots, max_seq_len, block_size=block_size,
            num_blocks=num_blocks, kv_dtype=kv_dtype, device=device)
        self.owner: list[Optional[int]] = [None] * num_slots
        self.free: list[int] = list(range(num_slots - 1, -1, -1))
        self.events: list[tuple] = []
        self.tables = np.zeros((num_slots, self.max_blocks), np.int32)
        self.nblocks = [0] * num_slots     # materialized blocks per slot
        # slot -> leading table entries pinned by prefix sharing (each
        # incref'd on behalf of this slot; decref'd on release)
        self.shared: dict[int, list[int]] = {}
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
        write (0 for a family with no paged leaf, such as rwkv6)."""
        if not self.paged_names:
            return 0
        return blocks_for(min(total_budget, self.max_seq_len),
                          self.block_size)

    def can_admit(self, total_budget: int, *, shared_blocks: int = 0) -> bool:
        """Admission gate: a free slot and enough uncommitted pool for the
        request's net-new blocks (its worst-case budget less the
        prompt-prefix blocks sharing pins instead of allocating)."""
        need = max(self.blocks_required(total_budget) - shared_blocks, 0)
        return bool(self.free) and self.alloc.can_reserve(need)

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

    def assign_shared(self, rid: int, *, prompt_len: int, total_budget: int,
                      shared_ids: list[int]) -> int:
        """Claim a slot whose leading table entries are *shared* prompt
        blocks (a radix hit): each is pinned under this slot, only the
        net-new rest of the worst-case budget is reserved, and the
        prompt's own tail block and decode growth materialize from that
        reservation through :meth:`ensure`."""
        if not self.free:
            raise RuntimeError("no free slot")
        if len(shared_ids) > self.blocks_required(total_budget):
            raise AssertionError("shared prefix longer than the budget")
        slot = self.free.pop()
        if self.owner[slot] is not None:
            raise AssertionError(f"slot {slot} already owned by "
                                 f"{self.owner[slot]}")
        self.alloc.reserve(rid, self.blocks_required(total_budget)
                           - len(shared_ids))
        for bid in shared_ids:
            self.alloc.incref(bid)
        self.owner[slot] = rid
        if shared_ids:
            self.shared[slot] = list(shared_ids)
            self.tables[slot, :len(shared_ids)] = shared_ids
            self.nblocks[slot] = len(shared_ids)
            self._dirty = True
        self.events.append(("assign", rid, slot))
        if prompt_len:
            self.ensure(slot, prompt_len - 1)
        return slot

    def ensure(self, slot: int, upto_pos: int) -> None:
        """Materialize blocks so the slot's table covers positions
        ``<= upto_pos``, clamped to the request's quota (writes past the
        budget fall through to the null block by design).  Nothing to do
        for a family with no paged leaf."""
        if not self.paged_names:
            return
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

    def _blocked(self) -> list:
        """The names of the pool's block leaves: the paged leaves and, on
        an int8 pool, their scales."""
        return [name for name in self.cache
                if name in self.paged_names or name.endswith(SCALE_SUFFIX)]

    def snapshot_block(self, pid: int) -> dict:
        """Block ``pid`` of every block leaf, copied as the pool stores it
        (int8 with its scales): a suspended sequence's or a radix
        boundary's partial last block, which :meth:`seed_block` writes
        back bit for bit."""
        return {name: self.cache[name][:, pid].clone()
                for name in self._blocked()}

    def seed_block(self, pid: int, blk: dict) -> None:
        """Write a :meth:`snapshot_block` copy into block ``pid``, in
        place."""
        for name, t in blk.items():
            self.cache[name][:, pid].copy_(t)

    def slot_rows(self, slot: int) -> dict:
        """Copies of slot ``slot``'s rows of the pool's slot-resident
        leaves (batch at axis 1): every leaf that is neither the index nor
        a paged leaf or its scales (zamba2's ``conv``/``ssm``, all of
        rwkv6's state).  The dense family has none."""
        blocked = self._blocked()
        return {name: leaf[:, slot:slot + 1].clone()
                for name, leaf in self.cache.items()
                if name != "index" and name not in blocked}

    def seed_rows(self, slot: int, rows: dict) -> None:
        """Write :meth:`slot_rows` copies into slot ``slot``, in place."""
        for name, t in rows.items():
            self.cache[name][:, slot:slot + 1].copy_(t)

    def slot_view(self, slot: int, index: torch.Tensor) -> dict:
        """The pool as a batch=1 cache of slot ``slot``: the block leaves
        whole (a table row selects the slot's blocks), the slot-resident
        leaves as views of its row, so that a decode step on the view
        writes the pool, and ``index`` as given."""
        blocked = self._blocked()
        return {name: (index if name == "index" else
                       leaf if name in blocked else leaf[:, slot:slot + 1])
                for name, leaf in self.cache.items()}

    def boundary(self, slot: int, prompt_len: int) -> tuple:
        """The boundary of the prompt slot ``slot`` holds: the ids of its
        full blocks, a :meth:`snapshot_block` copy of its partial last
        block (empty when it ends on a block edge) and the slot's
        :meth:`slot_rows`, what a radix entry and a transfer handle keep.
        Copies: the slot's blocks and rows are written again once it
        decodes or is recycled.  A family with no paged leaf has no block
        to keep: its boundary is the slot rows alone (for the radix tree,
        a snapshot at the root)."""
        bs = self.block_size
        n_full = prompt_len // bs if self.paged_names else 0
        tail = (self.snapshot_block(int(self.tables[slot, n_full]))
                if self.paged_names and prompt_len % bs else {})
        return ([int(b) for b in self.tables[slot, :n_full]], tail,
                self.slot_rows(slot))

    def insert_prompt(self, slot: int, one: dict, n_shared: int = 0) -> None:
        """Write a prefilled batch=1 cache into slot ``slot``'s blocks
        (:func:`insert_paged`).  The first ``n_shared`` entries of its row
        are shared blocks: the write goes through a copy of the row with
        those entries 0 (the null block), so that a shared block is never
        written; a tensor of its own, since the device tables are a CUDA
        graph's buffer and the host tables change in place."""
        if n_shared:
            masked = self.tables[slot].copy()
            masked[:n_shared] = 0
            row = torch.from_numpy(masked).to(self.device)
        else:
            row = self.device_tables()[slot]
        insert_paged(self.cache, one, row, slot, self.paged_names)

    def fetch(self, block_ids, tail: dict, index: int) -> dict:
        """A batch=1 contiguous cache of a sequence whose full blocks are
        ``block_ids`` of this pool (pinned) and whose partial last block
        is ``tail`` (a :meth:`snapshot_block` copy, or empty): the blocks
        gathered through a null-padded table row as they are stored (an
        int8 pool's with their scales, ``<name>_scale`` ``(L, 1, S)``),
        the tail spliced after them, ``index`` its length (slot-resident
        leaves are not here: their holder keeps them).  Positions past
        ``index`` hold what the null block holds; a decode step writes a
        position before anything reads it.  :func:`insert_paged` writes
        the result into a pool of the same storage unchanged.  The port's
        copy of the JAX package's handle fetch (``serve/disagg.py``
        ``_transfer_fns``), which dequantizes int8 blocks and leaves the
        quantizing to the receiving pool."""
        bs, n_full = self.block_size, len(block_ids)
        row = torch.zeros((self.max_blocks,), dtype=torch.int32)
        row[:n_full] = torch.as_tensor(list(block_ids), dtype=torch.int32)
        row = row.to(self.device)
        out = {"index": torch.tensor(index, dtype=torch.int32,
                                     device=self.device)}
        span = slice(n_full * bs, (n_full + 1) * bs)
        for name in self._blocked():
            seq = gather_blocks(self.cache[name], row, axis=1)
            if name in tail:
                seq[:, span] = tail[name]
            out[name] = seq[:, None]          # re-grow the batch=1 axis
        return out

    def release(self, slot: int) -> None:
        """Recycle a finished slot: free its blocks (pinned ones stay live
        until their holder lets go), unpin its shared ones, zero its table
        row."""
        rid = self.owner[slot]
        if rid is None:
            raise AssertionError(f"slot {slot} is already free")
        for bid in self.shared.pop(slot, []):
            self.alloc.decref(bid)         # co-owners keep it alive
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
        """Cross-structure invariants: released rows zeroed, and, with
        ``extra_pins`` (block ids held by pins outside the slots: the
        radix tree's, suspended requests' and transfer handles'), live
        rows in sync with the allocator.  A slot's *owned* entries are
        disjoint across slots; its *shared* entries may repeat across
        slots and in ``extra_pins``."""
        self.alloc.check()
        owned_flat, shared_flat = [], []
        for s in range(self.num_slots):
            if self.owner[s] is None:
                assert not self.tables[s].any(), "released row not zeroed"
                assert s not in self.shared
                continue
            ns = len(self.shared.get(s, ()))
            row = self.tables[s]
            assert not row[self.nblocks[s]:].any()
            assert [int(b) for b in row[:ns]] == self.shared.get(s, []), \
                "shared prefix out of sync with table row"
            owned_flat += [int(b) for b in row[ns:self.nblocks[s]]]
            shared_flat += [int(b) for b in row[:ns]]
        flat = owned_flat + shared_flat
        assert 0 not in flat, "live table row points at the null block"
        # owned entries are allocated once; shared ones may repeat across
        # slots and coincide with the donor's still-owned entries
        assert len(set(owned_flat)) == len(owned_flat), \
            "owned block shared across slots"
        live = set(flat) | set(extra_pins)
        assert live == set(self.alloc.refcount), \
            "materialized blocks out of sync with tables/pins"
        for bid in shared_flat + list(extra_pins):
            assert self.alloc.refcount.get(bid, 0) >= 1
