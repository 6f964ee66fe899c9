"""Ref-counted block allocator for the paged KV cache.

The serving pool's KV memory is a fixed array of ``num_blocks`` equal-sized
blocks (``block_size`` token positions each).  Block id ``0`` is reserved as
the *null block*: unassigned block-table entries point at it, recycled slots'
tables are zeroed to it, and any write from a dead or over-budget slot lands
there harmlessly (nothing unmasked ever reads it).  Real blocks carry ids
``1..num_blocks``.

Admission control uses *quota reservation*: at admit time a request reserves
the worst-case number of blocks its total budget (prompt + decode cap) can
ever touch, but blocks are only **materialized on demand** as the request's
``index`` crosses a block boundary.  Because the allocator never reserves
more than ``num_blocks`` across owners, every on-demand ``allocate`` within
quota is guaranteed to succeed — the engine can never deadlock mid-decode.
Long-tail traffic thus reserves what it might use, not a full
``max_seq_len`` stripe, which is exactly where paged beats the contiguous
layout on concurrency at equal memory.

Blocks are ref-counted (``incref``/``decref``), which is what radix
prompt-prefix sharing (radix sharing, not ported yet) builds on: a donor request
allocates a prompt's blocks under its own reservation, the prefix index
pins them with one extra ref, and every sharing slot increfs them again —
an immutable full block lives until its *last* owner (slot or index) lets
go, and ``free_all`` on any single owner only drops that owner's refs.

Invariants (enforced here, locked in by ``tests/test_serve_paged.py`` and
the shared-interleaving sweeps in ``tests/test_serve_radix.py``):
  * a free block is never handed out twice (no double-assignment);
  * ``num_free + live_blocks == num_blocks`` at all times (conservation);
  * total committed (reserved-but-unmaterialized + live) never exceeds
    ``num_blocks``;
  * the null block 0 never enters the free list or the refcount map;
  * ``decref`` below zero / freeing an unknown block raises.
"""
from __future__ import annotations


def blocks_for(total_tokens: int, block_size: int) -> int:
    """Blocks needed to cover token positions ``0..total_tokens-1``."""
    return -(-total_tokens // block_size)


class BlockAllocator:
    """Fixed pool of ``num_blocks`` KV blocks with quota reservation."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list; id 0 is the null block and never enters it.
        self.free: list[int] = list(range(num_blocks, 0, -1))
        self.refcount: dict[int, int] = {}        # bid -> live refs
        self.quota: dict[int, int] = {}           # owner -> claimable blocks
        self.owned: dict[int, list[int]] = {}     # owner -> materialized bids
        self.events: list[tuple] = []             # ("reserve"|"alloc"|"free", ...)

    # ---- accounting --------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self.free)

    @property
    def num_live(self) -> int:
        return len(self.refcount)

    @property
    def num_committed(self) -> int:
        """Blocks spoken for: materialized + still-claimable reservations."""
        return self.num_live + sum(self.quota.values())

    def can_reserve(self, n: int) -> bool:
        return n <= self.num_blocks - self.num_committed

    # ---- lifecycle ---------------------------------------------------------
    def reserve(self, owner: int, n: int) -> None:
        """Set aside ``n`` blocks the request may later materialize."""
        if owner in self.quota:
            raise AssertionError(f"owner {owner} already has a reservation")
        if not self.can_reserve(n):
            raise RuntimeError(
                f"cannot reserve {n} blocks "
                f"({self.num_blocks - self.num_committed} uncommitted)")
        self.quota[owner] = n
        self.owned[owner] = []
        self.events.append(("reserve", owner, n))

    def allocate(self, owner: int) -> int:
        """Materialize one reserved block for ``owner``; returns its id."""
        if self.quota.get(owner, 0) <= 0:
            raise RuntimeError(f"owner {owner} has no remaining quota")
        if not self.free:                  # unreachable if invariants hold
            raise AssertionError("free list empty despite live reservation")
        bid = self.free.pop()
        if bid in self.refcount:           # invariant: never hand out twice
            raise AssertionError(f"block {bid} already live")
        self.refcount[bid] = 1
        self.quota[owner] -= 1
        self.owned[owner].append(bid)
        self.events.append(("alloc", owner, bid))
        return bid

    def incref(self, bid: int) -> None:
        if bid not in self.refcount:
            raise AssertionError(f"incref on non-live block {bid}")
        self.refcount[bid] += 1

    def decref(self, bid: int) -> None:
        if bid not in self.refcount:
            raise AssertionError(f"decref on non-live block {bid}")
        self.refcount[bid] -= 1
        if self.refcount[bid] == 0:
            del self.refcount[bid]
            self.free.append(bid)

    def free_all(self, owner: int) -> None:
        """Drop the owner's reservation and decref every block it holds."""
        if owner not in self.quota:
            raise AssertionError(f"owner {owner} has no reservation")
        for bid in self.owned.pop(owner):
            self.decref(bid)
        del self.quota[owner]
        self.events.append(("free", owner, None))

    def assert_clean(self, context: str = "") -> None:
        """Assert the pool is fully returned: every block free, zero
        dangling refcounts, no outstanding reservations.  This is the
        leak check engines run after ``reset`` (idle + flushed radix +
        released transfer handles ⇒ nothing may hold a block) — raising
        here turns a slow cross-iteration leak into an immediate, located
        failure."""
        self.check()
        if self.refcount or self.quota or self.num_free != self.num_blocks:
            where = f" after {context}" if context else ""
            raise RuntimeError(
                f"KV block leak{where}: {len(self.refcount)} block(s) still "
                f"referenced {sorted(self.refcount)!r}, outstanding "
                f"reservations {dict(self.quota)!r}, "
                f"free {self.num_free}/{self.num_blocks}")

    # ---- invariant check (cheap; called by property tests) -----------------
    def check(self) -> None:
        assert 0 not in self.refcount and 0 not in self.free
        assert len(set(self.free)) == len(self.free), "free list duplicates"
        assert not (set(self.free) & set(self.refcount)), \
            "block both free and live"
        assert self.num_free + self.num_live == self.num_blocks, \
            "block count not conserved"
        assert self.num_committed <= self.num_blocks
        owned_flat = [b for bids in self.owned.values() for b in bids]
        assert len(set(owned_flat)) == len(owned_flat), \
            "block owned by two requests"
        assert all(b in self.refcount for b in owned_flat)
        assert all(q >= 0 for q in self.quota.values())
