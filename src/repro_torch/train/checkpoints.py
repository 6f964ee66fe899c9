"""The host-memory actor cache behind RollMux's warm-start context
switching (paper §5.1 / C3).

Counterpart of ``repro/train/checkpoints.py`` ``HostStateCache``: offloaded
job states live here as host (CPU) tensors; a warm start copies them back
to the device they came from (``.to(device)``, where the JAX package does
``device_put``).  Both copies run on the caller's current CUDA stream: the
offload returns once its copy is complete (a device-to-host copy into
pageable memory waits for it), so a phase may release its permit right
after; the restored tensors are ready for the work that stream queues
next.  The copies are pageable: every offload allocates new host tensors.
Disk checkpoints are not ported.
"""
from __future__ import annotations

import threading
import time

import torch

from repro_torch.train.optimizer import tree_leaves, tree_map


class HostStateCache:
    """Host-memory residency cache with a byte budget (the paper's residency
    constraint).  Evicting a resident job = falling back to cold start."""

    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self._store: dict[str, tuple[object, torch.device]] = {}
        self.stats = {"warm_hits": 0, "cold_misses": 0, "offloads": 0}
        self._lock = threading.Lock()   # co-executing jobs' threads share it

    def used_bytes(self) -> int:
        with self._lock:
            trees = [tree for tree, _ in self._store.values()]
        return sum(t.numel() * t.element_size()
                   for tree in trees for t in tree_leaves(tree))

    def can_admit(self, nbytes: int) -> bool:
        return self.used_bytes() + nbytes <= self.capacity

    def offload(self, key: str, tree) -> float:
        """Device -> host.  Returns seconds spent."""
        t0 = time.perf_counter()
        device = tree_leaves(tree)[0].device
        host = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
        with self._lock:
            self._store[key] = (host, device)
            self.stats["offloads"] += 1
        return time.perf_counter() - t0

    def restore(self, key: str):
        """Host -> device (warm start).  Returns (tree, seconds) or
        (None, 0)."""
        t0 = time.perf_counter()
        with self._lock:
            entry = self._store.get(key)
            self.stats["cold_misses" if entry is None else "warm_hits"] += 1
        if entry is None:
            return None, 0.0
        host, device = entry
        tree = tree_map(lambda t: t.to(device, copy=True), host)
        return tree, time.perf_counter() - t0

    def evict(self, key: str) -> None:
        with self._lock:
            self._store.pop(key, None)

    def resident(self, key: str) -> bool:
        return key in self._store
