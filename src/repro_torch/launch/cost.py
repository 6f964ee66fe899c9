"""The cost walk: one rank's FLOPs, bytes and collectives of a step, counted
while the step runs on ``meta`` tensors.

Counterpart of ``repro/launch/hlo_cost.py``, which walks the compiled
per-device HLO of a jitted step.  Eager PyTorch compiles nothing, so the
walk runs the step itself on ``meta`` tensors (plain ones for one rank,
``DTensor``\\ s over meta shards in a fake world for a mesh) under a
``TorchDispatchMode`` that sees every aten op on the local shards:

* flops       -- every aten product (``mm``, ``bmm``, ``addmm``, ...) by
                 ``torch.utils.flop_counter``'s formulas on the local
                 shapes, plus the kernels' work: a kernel wrapper meeting a
                 meta tensor records its formula's operations, bytes and
                 one launch (``kernels.work``), since a ctypes launch is
                 invisible to any dispatch mode;
* bytes       -- every other aten op's inputs plus its outputs (eager ops
                 do not fuse; views and allocations are free), plus the
                 kernels' bytes;
* collectives -- each ``_c10d_functional`` op's result bytes by kind, with
                 the reference's factors (all-reduce 2, the others 1).

A ``DTensor`` op goes back to DTensor, which runs it as local ops and
collectives that the walk then counts.  Where DTensor has no sharding for
an op (a view that splits a sharded dimension unevenly, say), the walk
gathers the op's ``DTensor`` arguments to ``Replicate`` and runs it again,
as XLA's partitioner would insert an all-gather: the gather is counted.

A backward under ``remat=True`` walks the recompute, as the card runs it.
The walk also tracks the peak of the bytes that the step's own ops hold
live at once (``weakref.finalize`` on each op's non-view outputs): the
counterpart of XLA's ``temp_size_in_bytes`` (arguments not included).
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work

COLLECTIVES = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}
_C10D_KINDS = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "broadcast": "collective-permute",
               "broadcast_": "collective-permute"}
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "wait_tensor", "detach", "lift_fresh",
         "_to_copy_meta", "sym_size", "sym_stride", "sym_numel"}


@dataclass
class Costs:
    """One rank's counts; ``flops`` is ``product_flops`` plus the kernels'
    operations.  ``scoped_flops`` holds what was counted inside each
    ``kernels.work.scope`` label (the plain backward of flash attention:
    ``"flash_attention_backward"``)."""
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict = field(default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    coll_ops: float = 0.0
    product_flops: float = 0.0
    scoped_flops: dict = field(default_factory=dict)
    kernel_ops: dict = field(default_factory=dict)
    kernel_bytes: dict = field(default_factory=dict)
    kernel_launches: dict = field(default_factory=dict)
    fallbacks: dict = field(default_factory=dict)
    ops: int = 0
    live_bytes: float = 0.0
    peak_bytes: float = 0.0

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll.values())

    @property
    def kernel_flops(self) -> float:
        return sum(sum(d.values()) for d in self.kernel_ops.values())

    def add_kernel(self, name: str, ops: dict, n_bytes: int) -> None:
        """One launch of kernel ``name`` (``kernels.work.record``)."""
        have = self.kernel_ops.setdefault(name, {})
        for t, n in ops.items():
            have[t] = have.get(t, 0) + n
        n_ops = sum(ops.values())
        self.flops += n_ops
        self.bytes += n_bytes
        self.kernel_bytes[name] = self.kernel_bytes.get(name, 0) + n_bytes
        self.kernel_launches[name] = self.kernel_launches.get(name, 0) + 1
        for s in work.scopes():
            self.scoped_flops[s] = self.scoped_flops.get(s, 0) + n_ops

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _alloc(self, t: torch.Tensor) -> None:
        n = _nbytes(t)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(t, self._free, n)

    def count_op(self, func, args, kwargs, out) -> None:
        self.ops += 1
        name = func._schema.name
        ns, _, op = name.partition("::")
        if ns in ("_c10d_functional", "c10d_functional"):
            kind = _C10D_KINDS.get(op)
            if kind is not None:
                self.coll[kind] += _tree_bytes(out) * COLLECTIVES[kind]
                self.coll_ops += 1
            return
        if op in _FREE or func.is_view:
            return
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            n = fn(*args, **kwargs, out_val=out)
            self.product_flops += n
            self.flops += n
            for s in work.scopes():
                self.scoped_flops[s] = self.scoped_flops.get(s, 0) + n
        self.bytes += _tree_bytes(args) + _tree_bytes(kwargs) \
            + _tree_bytes(out)
        for t in _tensors(out):
            if not _aliases_input(t, args):
                self._alloc(t)

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "product_flops": self.product_flops,
                "kernel_flops": self.kernel_flops,
                "kernel_launches": dict(self.kernel_launches),
                "collective_bytes": self.collective_bytes,
                "coll": dict(self.coll), "coll_ops": self.coll_ops,
                "peak_bytes": self.peak_bytes, "ops": self.ops,
                "fallbacks": dict(self.fallbacks)}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    """Bytes an op touches in ``t``: its elements, or its storage when
    that is smaller (a broadcast)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in _tensors(tree))


def _aliases_input(t, args) -> bool:
    try:
        ptr = t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return False
    return any(a.untyped_storage()._cdata == ptr for a in _tensors(args))


def _gathered(tree, mesh_dims=None):
    """``tree`` with every ``DTensor`` gathered to ``Replicate`` on the
    mesh dimensions ``mesh_dims`` (all when None)."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(tree, DTensor):
        place = [Replicate() if mesh_dims is None or i in mesh_dims else p
                 for i, p in enumerate(tree.placements)]
        if place == list(tree.placements):
            return tree
        return tree.redistribute(tree.device_mesh, place)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_gathered(x, mesh_dims) for x in tree)
    if isinstance(tree, dict):
        return {k: _gathered(v, mesh_dims) for k, v in tree.items()}
    return tree


# (lhs, rhs) argument positions, contraction dims and whether dim 0 is a
# batch dim of the products whose operands the walk places itself
_PRODUCTS = {"mm": (0, 1, 1, 0, False), "bmm": (0, 1, 2, 1, True),
             "addmm": (1, 2, 1, 0, False), "baddbmm": (1, 2, 2, 1, True)}


def _place_product(func, args):
    """A product whose operands both shard a dimension over one mesh axis
    in a way that no local product can combine (not both the contraction,
    not both a bmm's batch) gathers, on that axis, the operand that shards
    its contraction there (an FSDP-sharded weight against batch-sharded
    activations, as XLA's partitioner does, rather than letting DTensor
    move the activations), or where both shard a free dimension the one
    with fewer local bytes; a partial sum against a sharded operand is
    reduced first.  Returns the args, placed."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    spec = _PRODUCTS.get(func._overloadpacket.__name__)
    if spec is None:
        return args
    i, j, ci, cj, batched = spec
    a, b = args[i], args[j]
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        return args
    pa, pb = list(a.placements), list(b.placements)
    small_a = a.to_local().numel() * a.element_size() \
        <= b.to_local().numel() * b.element_size()
    for m, (x, y) in enumerate(zip(a.placements, b.placements)):
        # a partial sum (a row-parallel product's output) meets a sharded
        # operand: reduce it first, as XLA does, rather than computing the
        # product on the gathered other operand
        if x.is_partial() and isinstance(y, Shard):
            pa[m] = Replicate()
            continue
        if y.is_partial() and isinstance(x, Shard):
            pb[m] = Replicate()
            continue
        if not (isinstance(x, Shard) and isinstance(y, Shard)):
            continue
        if (x.dim, y.dim) == (ci, cj) or (batched and x.dim == y.dim == 0):
            continue
        if x.dim == ci or (y.dim != cj and small_a):
            pa[m] = Replicate()
        else:
            pb[m] = Replicate()
    args = list(args)
    if pa != list(a.placements):
        args[i] = a.redistribute(a.device_mesh, pa)
    if pb != list(b.placements):
        args[j] = b.redistribute(b.device_mesh, pb)
    return tuple(args)


_NEW_OPS = {"new_zeros", "new_empty", "new_full", "new_ones"}


def _new_like(func, args, kwargs):
    """``x.new_zeros(size)`` of a ``DTensor`` (a gather's backward makes
    its input's gradient so): DTensor makes a replicated tensor of the
    whole size; a partitioner makes it sharded as ``x`` where the size has
    ``x``'s rank and each sharded dimension divides.  The op runs on the
    local shape, wrapped back in those placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x, size = args[0], list(args[1])
    mesh = x.device_mesh
    place = [p if isinstance(p, Shard) and len(size) == x.dim()
             else Replicate() for p in x.placements]
    local = list(size)
    for m, p in enumerate(place):
        if isinstance(p, Shard):
            if local[p.dim] % mesh.shape[m]:
                return None
            local[p.dim] //= mesh.shape[m]
    out = func(x.to_local(), local, *args[2:], **kwargs)
    return DTensor.from_local(out, mesh, place, run_check=False)


def _run_placed(func, args, kwargs, costs: Costs):
    """Run a ``DTensor`` op; where DTensor has no sharding for it, gather
    its arguments one mesh dimension at a time (innermost first), then on
    every one, and run it again (counted in ``costs.fallbacks``); where it
    has none at all, run it replicated on the gathered local tensors.  A
    slice over a whole dimension is the tensor itself, a slice that
    DTensor gathers is sharded back as its input was, and an in-place
    write into a shard is counted as the shard's update
    (:func:`_update_shard`).  An in-place op returns its own self."""
    from torch.distributed.tensor import DTensor
    mesh = next(a.device_mesh for a in _tensors((args, kwargs))
                if isinstance(a, DTensor))
    if func._overloadpacket.__name__ in _NEW_OPS:
        out = _new_like(func, args, kwargs)
        if out is not None:
            return out
    try:
        out = func(*_place_product(func, args), **kwargs)
    except Exception:                   # no sharding for this op
        key = str(func)
        costs.fallbacks[key] = costs.fallbacks.get(key, 0) + 1
        if _whole_slice(func, args, kwargs):
            return args[0]
        if func._schema.is_mutable and args and isinstance(args[0], DTensor):
            return _update_shard(args, kwargs, costs)
        for dims in [{d} for d in reversed(range(mesh.ndim))] + [None]:
            rargs, rkw = _gathered(args, dims), _gathered(kwargs, dims)
            try:
                out = func(*rargs, **rkw)
            except Exception:
                continue
            if func._schema.is_mutable and args and out is rargs[0]:
                return args[0]
            return _reshard_like(out, args)
        return _run_replicated(func, args, kwargs, mesh)
    if str(func) == "aten.slice.Tensor":  # a microbatch of a sharded batch
        return _reshard_like(out, args)
    return out


def _whole_slice(func, args, kwargs) -> bool:
    """``aten.slice`` over the whole of a dimension (``cache[:, :S]`` of a
    stripe S long): the tensor itself, whatever shards the dimension."""
    if str(func) != "aten.slice.Tensor":
        return False
    x, dim, start, end, step = (list(args) + [0, None, None, 1])[:5]
    dim, start = kwargs.get("dim", dim), kwargs.get("start", start)
    end, step = kwargs.get("end", end), kwargs.get("step", step)
    n = x.shape[dim]
    return (start or 0) == 0 and (end is None or end >= n) and step == 1


def _update_shard(args, kwargs, costs: Costs):
    """An in-place write into a sharded ``DTensor`` (a cache update at
    the step's positions) that DTensor cannot shard: the rank holding the
    positions updates its shard, as XLA's dynamic-update-slice does, so
    the walk gathers the values and indices, counts reading and writing
    them, and leaves the shard in place."""
    from torch.distributed.tensor import DTensor
    rest = _gathered((args[1:], kwargs))
    n = sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
            for t in _tensors(rest))
    costs.bytes += 2 * n
    return args[0]


def _run_replicated(func, args, kwargs, mesh):
    """An op DTensor has no strategy for at all (``searchsorted``, say):
    every argument gathered, the op run on the full local tensors (as a
    partitioner replicates an op it cannot split), its tensor outputs
    wrapped back as replicated ``DTensor``\\ s."""
    from torch.distributed.tensor import DTensor, Replicate

    def local(x):
        if isinstance(x, DTensor):
            return x.to_local()
        if isinstance(x, (list, tuple)):
            return type(x)(local(y) for y in x)
        if isinstance(x, dict):
            return {k: local(v) for k, v in x.items()}
        return x

    def wrap(x):
        if isinstance(x, torch.Tensor) and not isinstance(x, DTensor):
            return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        if isinstance(x, (list, tuple)):
            return type(x)(wrap(y) for y in x)
        return x
    out = func(*local(_gathered(args)), **local(_gathered(kwargs)))
    if func._schema.is_mutable and args:
        return args[0]
    return wrap(out)


def _reshard_like(out, args):
    """A gathered op's ``DTensor`` output sharded back as its first
    ``DTensor`` argument was, where it has that argument's rank and each
    sharded dimension divides (a local slice, no communication), as XLA
    keeps an operand's sharding through an op that preserves it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    like = next((a for a in _tensors(args) if isinstance(a, DTensor)), None)
    if not isinstance(out, DTensor) or like is None \
            or out.dim() != like.dim():
        return out
    place = [p if isinstance(p, Shard) else Replicate()
             for p in like.placements]
    split = {}
    for m, p in enumerate(place):
        if isinstance(p, Shard):
            split[p.dim] = split.get(p.dim, 1) * like.device_mesh.shape[m]
    if place == list(out.placements) \
            or any(out.shape[d] % n for d, n in split.items()):
        return out
    return out.redistribute(out.device_mesh, place)


class _Walk(TorchDispatchMode):
    """Counts the plain (local) aten ops into ``costs``.  The outer walk
    runs a ``DTensor`` op itself under an inner one (which hands DTensor
    ops back to DTensor), so that it can place a product's operands and
    gather and retry an op that DTensor cannot shard."""

    def __init__(self, costs: Costs, outer: bool):
        super().__init__()
        self.costs, self.outer = costs, outer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor for t in types):
            from torch._subclasses.fake_tensor import FakeTensor
            from torch.distributed.tensor import DTensor
            if any(issubclass(t, FakeTensor) for t in types):
                return func(*args, **kwargs)    # DTensor's shape inference
            if not self.outer or not any(issubclass(t, DTensor)
                                         for t in types):
                return NotImplemented
            with _Walk(self.costs, outer=False):
                return _run_placed(func, args, kwargs, self.costs)
        out = func(*args, **kwargs)
        self.costs.count_op(func, args, kwargs, out)
        return out


@contextlib.contextmanager
def walk(costs: Costs | None = None):
    """Count what runs inside into the yielded :class:`Costs`: aten ops on
    meta tensors (and ``DTensor``\\ s over them, plain tensors mixed in
    treated as replicated) and the kernels' meta cases."""
    costs = Costs() if costs is None else costs
    with contextlib.ExitStack() as stack:
        try:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            stack.enter_context(implicit_replication())
        except ImportError:          # a build without torch.distributed
            pass
        stack.enter_context(work.walking(costs))
        stack.enter_context(_Walk(costs, outer=True))
        yield costs


def analyze_step(fn, *args, **kwargs) -> Costs:
    """Run ``fn(*args, **kwargs)`` on meta tensors under :func:`walk`;
    returns the rank's :class:`Costs` (the result of ``fn`` is dropped)."""
    with walk() as costs:
        fn(*args, **kwargs)
    return costs
