"""Content-addressed radix tree over paged KV blocks: prompt-prefix
sharing by *token content*, not caller tags.

Counterpart of ``repro/serve/radix.py``: host-only (numpy, hashlib), the
same tree case for case (node ids, block ids, hit / partial / miss
counters, eviction order).  Only what a :class:`BoundarySnapshot` holds
differs: torch tensors on the engine's device, each a copy.

Prompts that share a block-aligned token prefix share those KV blocks,
across requests, jobs, tenants and multi-turn episode histories.  Each
:class:`RadixNode` owns exactly one **full** block's worth of prompt
tokens and the physical block id holding that KV, pinned under one
allocator ``incref`` for as long as the node lives.  A node's identity is
the content hash of ``(parent_hash, tokens)``, so a path from a root
spells out a block-aligned token prefix and two requests agreeing on any
prefix walk the same path: admission is longest-prefix match
(:meth:`RadixPrefixIndex.match`), with all shared full blocks pinned
instead of allocated and the write-masked scatter never touching them.

**Boundary snapshots.**  Block sharing alone still prefills; an *exact*
repeat of a registered prompt admits with zero model compute.
Registration therefore stores a :class:`BoundarySnapshot` (the partial
tail block, the slot-resident rows and the post-prompt logits) at the
final node of the registered path, keyed by the prompt's residual tail
tokens.  A match that covers every full block *and* finds the tail's
snapshot is exact.

**Namespaces.**  ``Request.prefix_key`` is an optional isolation
namespace: each distinct key gets its own root.  ``None`` is the global
namespace.

**Eviction.**  Under block pressure :meth:`evict_for` frees
least-recently-used *leaves* first (an inner node's block only becomes
reusable once its subtree is gone), skipping nodes whose block is still
shared by a live slot or handle (``refcount > 1``) and the ``protect``\\ ed
path of the request being admitted.  Victims are collected into a heap
**once per call** and parents enter it as their last child is evicted.
The eviction sequence is recorded in :attr:`RadixPrefixIndex.eviction_log`
(cleared on ``flush``).

Counter ownership: :meth:`match` with ``count=True`` (the admission
lookup) bumps exactly one of ``hits``/``partial_hits``/``misses`` per
request; capacity probes and the router's KV-aware scoring pass the
default ``count=False`` and never move the stats.
"""
from __future__ import annotations

import hashlib
import heapq
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

import numpy as np

__all__ = ["BoundarySnapshot", "PrefixMatch", "RadixNode",
           "RadixPrefixIndex"]


def _content_hash(parent_hash: bytes, token_bytes: bytes) -> bytes:
    return hashlib.sha1(parent_hash + token_bytes).digest()


class RadixNode:
    """One full KV block of prompt tokens in the tree.

    ``tokens`` (``block_size`` int32s) is the edge label from ``parent``;
    ``block_id`` is the physical block pinned on this node's behalf
    (``None`` on namespace roots, which own no KV).  ``block_hash`` is
    the sglang-style ``(parent_hash, tokens)`` content id: equal hashes
    ⇔ equal block-aligned prefixes within a namespace.  ``snapshots``
    maps residual tail tokens (bytes) to the :class:`BoundarySnapshot`
    registered at this boundary."""

    __slots__ = ("node_id", "parent", "children", "tokens", "key",
                 "block_id", "block_hash", "snapshots", "last_used")

    def __init__(self, node_id: int, parent: Optional["RadixNode"],
                 tokens: Optional[np.ndarray], block_id: Optional[int],
                 block_hash: bytes, last_used: int = 0):
        self.node_id = node_id
        self.parent = parent
        self.children: dict[bytes, RadixNode] = {}
        self.tokens = tokens
        self.key = tokens.tobytes() if tokens is not None else b""
        self.block_id = block_id
        self.block_hash = block_hash
        self.snapshots: dict[bytes, BoundarySnapshot] = {}
        self.last_used = last_used

    @property
    def is_root(self) -> bool:
        return self.parent is None

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"RadixNode(id={self.node_id}, block={self.block_id}, "
                f"children={len(self.children)}, "
                f"snapshots={len(self.snapshots)})")


@dataclass
class BoundarySnapshot:
    """Zero-compute admission state at a registered prompt boundary: the
    donor's partial tail block, slot-resident rows and post-prompt
    logits (tensor copies on the engine's device), keyed under its node
    by ``tail_tokens``, the prompt tokens past the last full block."""
    sid: int
    tail_tokens: np.ndarray
    logits: Any
    tail: dict
    slot_leaves: dict
    hits: int = 0
    last_used: int = 0             # LRU tick of registration / last hit


@dataclass
class PrefixMatch:
    """Longest-prefix match result: the walked node path (one node per
    shared full block, root excluded) and, when the whole prompt is
    covered, the boundary snapshot for zero-compute admission."""
    namespace: Any
    nodes: list = field(default_factory=list)
    snapshot: Optional[BoundarySnapshot] = None

    @property
    def n_shared(self) -> int:
        return len(self.nodes)

    @property
    def exact(self) -> bool:
        return self.snapshot is not None

    @property
    def block_ids(self) -> list[int]:
        return [n.block_id for n in self.nodes]

    @property
    def node_ids(self) -> list[int]:
        return [n.node_id for n in self.nodes]


class RadixPrefixIndex:
    """Radix tree of registered prompt prefixes over one block pool.

    The tree holds one ``incref`` per node — blocks stay resident after
    every sharing slot releases, until LRU eviction under pressure
    (:meth:`evict_for`) or a weight-sync :meth:`flush` unpins them.
    ``len(index)`` is the number of block-bearing nodes."""

    def __init__(self, alloc):
        self.alloc = alloc
        self.block_size = alloc.block_size
        self.roots: dict[Any, RadixNode] = {}      # namespace -> root
        self.nodes: dict[int, RadixNode] = {}      # block-bearing nodes
        self.hits = 0                  # exact-match admissions
        self.partial_hits = 0          # block-sharing admissions
        self.misses = 0                # admissions that found nothing
        self.evictions = 0             # nodes evicted under pressure
        self.snapshot_demotions = 0    # snapshots dropped by TTL demotion
        self.eviction_log: list[int] = []   # node ids, eviction order
        self._tick = 0                 # LRU clock
        self._next_id = 0
        self._next_sid = 0
        self._n_snapshots = 0

    # ---- bookkeeping -------------------------------------------------------
    def __len__(self) -> int:
        return len(self.nodes)

    def _bump(self) -> int:
        self._tick += 1
        return self._tick

    def _fresh_id(self) -> int:
        self._next_id += 1
        return self._next_id - 1

    def _fresh_sid(self) -> int:
        self._next_sid += 1
        return self._next_sid - 1

    @staticmethod
    def _tok(req) -> np.ndarray:
        return np.asarray(req.prompt, np.int32).reshape(-1)[:req.prompt_len]

    def _root(self, namespace, *, create: bool = False
              ) -> Optional[RadixNode]:
        root = self.roots.get(namespace)
        if root is None and create:
            root = RadixNode(self._fresh_id(), None, None, None,
                             hashlib.sha1(repr(namespace).encode()).digest())
            self.roots[namespace] = root
        return root

    def _all_nodes(self) -> Iterator[RadixNode]:
        yield from self.roots.values()
        yield from self.nodes.values()

    # ---- lookup ------------------------------------------------------------
    def match(self, req, *, count: bool = False) -> Optional[PrefixMatch]:
        """Longest block-aligned prefix of ``req.prompt`` registered under
        its namespace (``req.prefix_key``); ``None`` when nothing
        matches.

        ``count=True`` marks this as the request's *admission* lookup
        and bumps exactly one of the hit/partial/miss counters — this
        method owns all counter accounting; callers never bump them."""
        tokens = self._tok(req)
        bs = self.block_size
        n_full = len(tokens) // bs
        nodes: list[RadixNode] = []
        snapshot = None
        node = self._root(req.prefix_key)
        if node is not None:
            for d in range(n_full):
                child = node.children.get(
                    tokens[d * bs:(d + 1) * bs].tobytes())
                if child is None:
                    break
                nodes.append(child)
                node = child
            if len(nodes) == n_full:
                snapshot = node.snapshots.get(tokens[n_full * bs:].tobytes())
        if count:
            if snapshot is not None:
                self.hits += 1
            elif nodes:
                self.partial_hits += 1
            else:
                self.misses += 1
        if snapshot is None and not nodes:
            return None
        return PrefixMatch(namespace=req.prefix_key, nodes=nodes,
                           snapshot=snapshot)

    def touch(self, m: PrefixMatch) -> None:
        """Bump recency along a matched path (LRU protection for the
        admission about to share it).  Counters are ``match``'s job."""
        t = self._bump()
        root = self.roots.get(m.namespace)
        if root is not None:
            root.last_used = t
        for node in m.nodes:
            node.last_used = t
        if m.snapshot is not None:
            m.snapshot.hits += 1
            m.snapshot.last_used = t

    # ---- registration ------------------------------------------------------
    def register(self, req, block_ids, *, logits, tail,
                 slot_leaves) -> RadixNode:
        """Record a freshly prefilled (or adopted) prompt: walk/extend the
        namespace's tree with one node per full block — new nodes pin
        their block with an ``incref`` of the registering slot's table
        entry; blocks whose content already has a node keep the
        incumbent's pin — and store the boundary snapshot at the final
        node (first donor wins per distinct tail)."""
        tokens = self._tok(req)
        bs = self.block_size
        t = self._bump()
        node = self._root(req.prefix_key, create=True)
        node.last_used = t
        for d, bid in enumerate(block_ids):
            chunk = tokens[d * bs:(d + 1) * bs]
            key = chunk.tobytes()
            child = node.children.get(key)
            if child is None:
                child = RadixNode(self._fresh_id(), node, chunk.copy(),
                                  int(bid),
                                  _content_hash(node.block_hash, key))
                node.children[key] = child
                self.nodes[child.node_id] = child
                self.alloc.incref(int(bid))
            child.last_used = t
            node = child
        tail_key = tokens[len(block_ids) * bs:].tobytes()
        if tail_key not in node.snapshots:
            node.snapshots[tail_key] = BoundarySnapshot(
                sid=self._fresh_sid(),
                tail_tokens=tokens[len(block_ids) * bs:].copy(),
                logits=logits, tail=tail, slot_leaves=slot_leaves,
                last_used=t)
            self._n_snapshots += 1
        return node

    # ---- eviction ----------------------------------------------------------
    def _evictable(self, node: RadixNode, protect: frozenset) -> bool:
        return (not node.children and not node.is_root
                and node.node_id not in protect
                and self.alloc.refcount.get(node.block_id, 0) == 1)

    def _evict_node(self, node: RadixNode) -> None:
        assert not node.children, "evicting a non-leaf radix node"
        self.alloc.decref(node.block_id)
        del node.parent.children[node.key]
        del self.nodes[node.node_id]
        self._n_snapshots -= len(node.snapshots)
        node.snapshots.clear()
        self.evictions += 1
        self.eviction_log.append(node.node_id)

    def evict_for(self, n_blocks: int, *, protect=()) -> bool:
        """LRU-evict leaf nodes until ``n_blocks`` can be reserved.

        Candidates are collected **once**: every current leaf whose
        block no live slot/handle still shares (tree-only
        ``refcount == 1``) and whose id is not in ``protect`` (the path
        the pending request would share from).  A parent becomes a
        candidate the moment its last child is evicted — pushed onto the
        same heap, keeping the whole call ``O(n log n)`` instead of the
        old re-sort-per-victim loop.  Heap order is strict LRU:
        ``register``/``touch`` bump whole paths, so a parent is never
        less recent than its children and leaf-first never violates
        recency order.  Returns whether the reservation now fits."""
        if self.alloc.can_reserve(n_blocks):
            return True
        protect = frozenset(protect)
        heap: list[tuple[int, int]] = [
            (node.last_used, node.node_id)
            for node in self.nodes.values()
            if self._evictable(node, protect)]
        heapq.heapify(heap)
        while heap and not self.alloc.can_reserve(n_blocks):
            _, nid = heapq.heappop(heap)
            node = self.nodes.get(nid)
            if node is None or not self._evictable(node, protect):
                continue
            parent = node.parent
            self._evict_node(node)
            if not parent.is_root and self._evictable(parent, protect):
                heapq.heappush(heap, (parent.last_used, parent.node_id))
        return self.alloc.can_reserve(n_blocks)

    def demote_stale(self, ttl: int) -> int:
        """Age-based snapshot demotion: drop every boundary snapshot not
        touched within the last ``ttl`` LRU ticks (``register``/``touch``
        calls).  Long-lived servers otherwise hold snapshot device arrays
        until block-pressure eviction or a weight-sync flush — boundary
        snapshots are *not* allocator blocks, so ``evict_for`` pressure
        never reclaims a snapshot whose node the tree keeps.  The tree
        structure (and its block pins) is untouched: a demoted prompt
        still block-shares, it just re-prefills its tail on the next
        exact repeat.  Returns the number demoted (also accumulated in
        ``snapshot_demotions`` / the ``stats`` dict)."""
        if ttl < 0:
            raise ValueError("ttl must be >= 0")
        horizon = self._tick - ttl
        n = 0
        for node in self._all_nodes():
            stale = [k for k, s in node.snapshots.items()
                     if s.last_used < horizon]
            for k in stale:
                del node.snapshots[k]
            n += len(stale)
        self._n_snapshots -= n
        self.snapshot_demotions += n
        return n

    def flush(self) -> int:
        """Drop the whole tree (weight sync: every cached prefill is
        stale), unpinning every node's block.  Not counted as
        evictions.  Returns the number of nodes + snapshots dropped."""
        n = len(self.nodes) + self._n_snapshots
        for node in self.nodes.values():
            self.alloc.decref(node.block_id)
        self.nodes.clear()
        self.roots.clear()
        self._n_snapshots = 0
        self.eviction_log.clear()
        return n

    # ---- introspection -----------------------------------------------------
    def pinned_blocks(self) -> list[int]:
        """Block ids currently pinned by the tree (one per node)."""
        return [node.block_id for node in self.nodes.values()]

    @property
    def stats(self) -> dict:
        return {"nodes": len(self.nodes),
                "entries": self._n_snapshots,
                "snapshots": self._n_snapshots,
                "hits": self.hits,
                "partial_hits": self.partial_hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "snapshot_demotions": self.snapshot_demotions,
                "pinned_blocks": len(self.nodes)}

    # ---- checkpoint --------------------------------------------------------
    def export_device_state(self) -> dict:
        """Snapshot tensors (device tensors), keyed by snapshot id."""
        return {snap.sid: {"logits": snap.logits, "tail": snap.tail,
                           "slot_leaves": snap.slot_leaves}
                for node in self._all_nodes()
                for snap in node.snapshots.values()}

    def export_host_state(self) -> dict:
        """Tree structure + counters (host data only — parent links by
        node id, tokens as arrays, snapshots by sid)."""
        return {
            "roots": [{"id": r.node_id, "namespace": ns,
                       "last_used": r.last_used}
                      for ns, r in self.roots.items()],
            "nodes": [{"id": n.node_id, "parent": n.parent.node_id,
                       "tokens": n.tokens.copy(), "block_id": n.block_id,
                       "last_used": n.last_used}
                      for n in self.nodes.values()],
            "snapshots": [{"sid": s.sid, "node": n.node_id,
                           "tail_tokens": s.tail_tokens.copy(),
                           "hits": s.hits, "last_used": s.last_used}
                          for n in self._all_nodes()
                          for s in n.snapshots.values()],
            "counters": {"tick": self._tick, "hits": self.hits,
                         "partial_hits": self.partial_hits,
                         "misses": self.misses,
                         "evictions": self.evictions,
                         "demotions": self.snapshot_demotions,
                         "next_id": self._next_id,
                         "next_sid": self._next_sid},
        }

    def import_state(self, host: Optional[dict], device: dict) -> None:
        """Rebuild the tree from :meth:`export_host_state` +
        :meth:`export_device_state`.  Structural only — the block pins
        the nodes stand behind travel in the allocator's own exported
        state, so nothing is increfed here (mirroring the engine's
        alloc import)."""
        self.roots.clear()
        self.nodes.clear()
        self._n_snapshots = 0
        self.eviction_log.clear()
        if not host:
            return
        by_id: dict[int, RadixNode] = {}
        for r in host["roots"]:
            ns = r["namespace"]
            root = RadixNode(
                r["id"], None, None, None,
                hashlib.sha1(repr(ns).encode()).digest(),
                last_used=r["last_used"])
            self.roots[ns] = root
            by_id[root.node_id] = root
        # parents are always created before children (smaller ids), so
        # the tree rebuilds in id order without a second pass
        for n in sorted(host["nodes"], key=lambda d: d["id"]):
            parent = by_id[n["parent"]]
            tokens = np.asarray(n["tokens"], np.int32)
            node = RadixNode(
                n["id"], parent, tokens, int(n["block_id"]),
                _content_hash(parent.block_hash, tokens.tobytes()),
                last_used=n["last_used"])
            parent.children[node.key] = node
            self.nodes[node.node_id] = node
            by_id[node.node_id] = node
        for s in host["snapshots"]:
            d = device[s["sid"]]
            node = by_id[s["node"]]
            tt = np.asarray(s["tail_tokens"], np.int32)
            node.snapshots[tt.tobytes()] = BoundarySnapshot(
                sid=s["sid"], tail_tokens=tt, logits=d["logits"],
                tail=d["tail"], slot_leaves=d["slot_leaves"],
                hits=s["hits"], last_used=s.get("last_used", 0))
            self._n_snapshots += 1
        c = host["counters"]
        self._tick = c["tick"]
        self.hits = c["hits"]
        self.partial_hits = c["partial_hits"]
        self.misses = c["misses"]
        self.evictions = c["evictions"]
        self.snapshot_demotions = c.get("demotions", 0)
        self._next_id = c["next_id"]
        self._next_sid = c["next_sid"]
