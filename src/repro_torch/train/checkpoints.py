"""Checkpointing: disk save/load and the host-memory actor cache behind
RollMux's warm-start context switching (paper §5.1 / C3).

Counterpart of ``repro/train/checkpoints.py``.

:func:`save_checkpoint` / :func:`load_checkpoint` are the cold-start path.
The JAX package pickles numpy leaves beside a jax treedef; the port stores
its nested dict/list tree of CPU tensors with ``torch.save``, so the two
formats are the port's and the JAX package's own: neither reads the
other's files.

:class:`HostStateCache` holds offloaded job states between phases; a warm
start copies a state back to the device it came from.

* A state on a CUDA device goes into page-locked host memory: one flat
  buffer per cache key, allocated at that key's first offload at the
  state's exact size and registered with ``cudaHostRegister`` (PyTorch's
  pinned allocator rounds each block up to a power of two, which for an
  18.9 GB train state would pin up to twice its bytes).  Every later
  offload of the key whose leaves have the same shapes and dtypes reuses
  the buffer; one whose leaves differ gets a new buffer, the old one
  released first.  Pinning that fails raises: there is no pageable
  fallback.
* Both copies are issued with ``non_blocking=True`` on the caller's
  current stream (the phase's, ``core.phase_control.PhaseStreams``) and
  record an event.  An offload waits for its own event before it returns,
  so a phase that releases its permit after offloading leaves a whole
  state in the cache.  A restore returns once its copies are queued: the
  tensors are ready for the work queued after them on that stream.  The
  next offload of the key makes its stream wait for the restore's event
  before it writes into the buffer the restore reads (restore and offload
  may run on different threads' streams).  The buffer keeps that event,
  and releasing it waits for the event before it unregisters and frees
  the memory: on ``evict``, on a new layout under the key, and when the
  cache is collected with a restore still in flight.  PyTorch does not
  know the registered memory, so a queued copy does not keep it alive.
* A state on the CPU is copied into new host tensors at every offload, as
  in the JAX package; that follows from the tensors' device.

``used_bytes`` counts the host bytes the cache holds: for a CUDA state the
pinned buffer, alignment padding included.
"""
from __future__ import annotations

import os
import threading
import time

import torch

from repro_torch.core import telemetry
from repro_torch.train.optimizer import tree_leaves, tree_map

_ALIGN = 256          # byte alignment of each leaf inside a pinned buffer


def save_checkpoint(path: str, tree) -> None:
    """Write ``tree`` (a nested dict/list of tensors) to ``path`` as CPU
    tensors with ``torch.save``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(tree_map(lambda t: t.detach().cpu(), tree), path)


def load_checkpoint(path: str):
    """The tree :func:`save_checkpoint` wrote, as CPU tensors."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves replaced by ``leaves``, given in
    :func:`tree_leaves` order (dict keys sorted); dicts keep their own key
    order."""
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            new = {k: go(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(go(x) for x in t)
        return next(it)
    return go(tree)


def _layout(leaves) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in leaves)


class _PinnedBuffer:
    """One host buffer of exactly ``nbytes`` bytes, page-locked with
    ``cudaHostRegister`` until :meth:`release` (or until it is collected).
    ``last_read`` is the event after the last copy out of it; releasing
    waits for it."""

    def __init__(self, nbytes: int, what: str):
        self.tensor = None
        self.last_read = None
        self.tensor = torch.empty(nbytes, dtype=torch.uint8)
        cudart = torch.cuda.cudart()
        err = cudart.cudaHostRegister(self.tensor.data_ptr(), nbytes, 0)
        if err != cudart.cudaError.success:
            self.tensor = None
            raise RuntimeError(f"host cache: page-locking {nbytes} bytes for "
                               f"{what} failed ({err}); the cache has no "
                               f"pageable fallback")
        self.nbytes = nbytes

    def release(self) -> None:
        """Wait for the last copy out of the buffer, then unpin and free
        it."""
        if self.tensor is not None:
            if self.last_read is not None:
                self.last_read.synchronize()
                self.last_read = None
            cudart = torch.cuda.cudart()
            err = cudart.cudaHostUnregister(self.tensor.data_ptr())
            self.tensor = None
            if err != cudart.cudaError.success:
                raise RuntimeError(f"host cache: unregistering a pinned "
                                   f"buffer failed ({err})")

    def __del__(self):
        self.release()


class _Entry:
    """One key's host copy: the tree of host tensors, its leaves in
    :func:`tree_leaves` order, the device it came from and the host bytes it
    holds.  For a CUDA state the leaves are views of one pinned buffer."""

    def __init__(self, host_tree, leaves, device, nbytes, buffer=None):
        self.host_tree = host_tree
        self.leaves = leaves
        self.layout = _layout(leaves)
        self.device = device
        self.nbytes = nbytes
        self.buffer = buffer
        self.lock = threading.Lock()

    def release(self) -> None:
        """Wait for a restore still reading the buffer, then free it."""
        if self.buffer is None:
            return
        with self.lock:
            self.leaves, self.host_tree = [], None
            self.buffer.release()


def _pinned_entry(leaves, device, what: str) -> _Entry:
    offsets, n = [], 0
    for t in leaves:
        offsets.append(n)
        n += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    buf = _PinnedBuffer(max(n, _ALIGN), what)
    views = [buf.tensor[o:o + t.numel() * t.element_size()]
             .view(t.dtype).view(t.shape) for o, t in zip(offsets, leaves)]
    return _Entry(None, views, device, buf.nbytes, buf)


class HostStateCache:
    """Host-memory residency cache with a byte budget (the paper's residency
    constraint).  Evicting a resident job = falling back to cold start."""

    def __init__(self, capacity_bytes: int):
        self.capacity = capacity_bytes
        self._store: dict[str, _Entry] = {}
        self.stats = {"warm_hits": 0, "cold_misses": 0, "offloads": 0}
        self._lock = threading.Lock()   # co-executing jobs' threads share it

    def used_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._store.values())

    def can_admit(self, nbytes: int) -> bool:
        return self.used_bytes() + nbytes <= self.capacity

    def _copied(self, key: str, kind: str, nbytes: int, start, end) -> None:
        """Called after each CUDA copy is issued (``kind`` "offload" or
        "restore") with the timing events around it on its stream; a
        subclass may record them."""

    def offload(self, key: str, tree) -> float:
        """Device -> host.  Returns seconds spent.  A ``cache.offload``
        span with its bytes and (on the card) its copies' events."""
        t0 = time.perf_counter()
        with telemetry.span("cache.offload") as sp:
            leaves = [t.detach() for t in tree_leaves(tree)]
            device = leaves[0].device
            if any(t.device != device for t in leaves):
                raise ValueError(f"host cache: {key!r} spans devices "
                                 f"{sorted({str(t.device) for t in leaves})}")
            if device.type != "cuda":
                host = tree_map(lambda t: t.detach().to("cpu", copy=True),
                                tree)
                host_leaves = tree_leaves(host)
                entry = _Entry(host, host_leaves, device,
                               sum(t.numel() * t.element_size()
                                   for t in host_leaves))
                self._put(key, entry)
                sp.note(nbytes=entry.nbytes)
                return time.perf_counter() - t0
            while True:
                entry = self._pinned_for(key, leaves, device)
                with entry.lock:
                    if entry.buffer.tensor is None:   # released meanwhile
                        continue
                    stream = torch.cuda.current_stream(device)
                    if entry.buffer.last_read is not None:
                        stream.wait_event(entry.buffer.last_read)
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record(stream)
                    for h, t in zip(entry.leaves, leaves):
                        h.copy_(t, non_blocking=True)
                    end.record(stream)
                    end.synchronize()
                    entry.host_tree = _rebuild(tree, entry.leaves)
                break
            self._put(key, entry)
            sp.note(nbytes=entry.nbytes, start=start, end=end)
            self._copied(key, "offload", entry.nbytes, start, end)
            return time.perf_counter() - t0

    def _pinned_for(self, key: str, leaves, device) -> _Entry:
        """The key's pinned entry if its leaves match ``leaves``' shapes and
        dtypes, else a new one (the old one released first)."""
        with self._lock:
            entry = self._store.get(key)
        if (entry is not None and entry.buffer is not None
                and entry.device == device
                and entry.layout == _layout(leaves)):
            return entry
        if entry is not None:
            with self._lock:
                if self._store.get(key) is entry:
                    del self._store[key]
            entry.release()
        return _pinned_entry(leaves, device, repr(key))

    def _put(self, key: str, entry: _Entry) -> None:
        with self._lock:
            old = self._store.get(key)
            self._store[key] = entry
            self.stats["offloads"] += 1
        if old is not None and old is not entry:
            old.release()

    def restore(self, key: str):
        """Host -> device (warm start).  Returns (tree, seconds) or
        (None, 0)."""
        t0 = time.perf_counter()
        while True:
            with self._lock:
                entry = self._store.get(key)
            if entry is None or entry.buffer is None:
                break
            tree = self._restore_pinned(key, entry)
            if tree is not None:
                break                         # else released meanwhile
        with self._lock:
            self.stats["cold_misses" if entry is None else "warm_hits"] += 1
        if entry is None:
            return None, 0.0
        if entry.buffer is None:
            with telemetry.span("cache.restore") as sp:
                sp.note(nbytes=entry.nbytes)
                tree = tree_map(lambda t: t.to(entry.device, copy=True),
                                entry.host_tree)
        return tree, time.perf_counter() - t0

    def _restore_pinned(self, key: str, entry: _Entry):
        """Queue the copies of ``entry`` to its device on the current
        stream; None if its buffer was released before they could be.  A
        ``cache.restore`` span with its bytes and its copies' events."""
        with telemetry.span("cache.restore") as sp, entry.lock:
            if entry.buffer.tensor is None:
                sp.discard()
                return None
            stream = torch.cuda.current_stream(entry.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = [h.to(entry.device, non_blocking=True)
                   for h in entry.leaves]
            end.record(stream)
            entry.buffer.last_read = end
            tree = _rebuild(entry.host_tree, out)
            sp.note(nbytes=entry.nbytes, start=start, end=end)
        self._copied(key, "restore", entry.nbytes, start, end)
        return tree

    def evict(self, key: str) -> None:
        with self._lock:
            entry = self._store.pop(key, None)
        if entry is not None:
            entry.release()

    def resident(self, key: str) -> bool:
        with self._lock:
            return key in self._store
