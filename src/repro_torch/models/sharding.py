"""Logical-axis sharding rules (MaxText-style) with divisibility fallbacks,
resolved to DTensor placements.

Counterpart of ``repro/models/sharding.py``.  Every parameter and
activation dimension carries a *logical* axis name; a rule table maps
logical axes to mesh axes.  A mapping is dropped (the dimension left
replicated) when the dimension's size is not divisible by the mesh axes'
product, and no mesh axis is used twice in one spec: that is what lets one
rule table serve every architecture on a fixed ``(data, model)`` mesh.

A resolved spec is a plain tuple with one entry a dimension, as the
reference's ``PartitionSpec``: ``None``, one mesh axis name, or a tuple of
names (major to minor).  :func:`spec_to_placements` turns it into one
placement a mesh dimension (``Shard(d)`` or ``Replicate()``) for
``distribute_tensor``.  The mesh passed to :meth:`ShardingRules.resolve` is
anything whose ``shape`` maps axis names to sizes (a test's fake mesh) or a
``DeviceMesh`` with named dimensions.

The port's parameter tree keeps stacked layer groups as Python lists of
per-layer dicts, so their specs come without the reference's leading
``"layers"`` axis (whose rule, ``((),)``, never shards); the decode cache
stays stacked on axis 0 and its specs keep it.
"""
from __future__ import annotations

import contextvars
from collections.abc import Mapping
from contextlib import contextmanager
from dataclasses import dataclass, field

# Default logical->mesh rules. Order matters: first divisible candidate wins.
DEFAULT_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    # activations
    "batch":      (("pod", "data"), ("data",)),
    "seq":        ((),),
    "cache_seq":  (("model",), ()),      # decode KV/context sharded over model
    "embed_act":  ((),),
    "heads_act":  (("model",), ()),
    "ffn_act":    (("model",), ()),
    "vocab_act":  (("model",), ()),
    "experts_act": (("model",), ()),
    "moe_tokens": (("data",), ()),   # (T*k,) flat dispatch assignments
    "frontend":   ((),),
    # params (FSDP over data on the embed/row dim, tensor over model)
    "embed":      (("data",), ()),
    "heads":      (("model",), ()),
    "kv_heads":   (("model",), ()),
    "head_dim":   ((),),
    "ffn":        (("model",), ()),
    "vocab":      (("model",), ()),
    "experts":    (("model",), ()),
    "experts_embed": ((),),   # replicated: avoid partial-sum ARs per layer
    "experts_ffn": ((),),
    "kv_lora":    ((),),
    "ssm_inner":  (("model",), ()),
    "ssm_state":  ((),),
    "conv":       ((),),
    "layers":     ((),),                  # stacked layer dim — never sharded
    "source":     ((),),                  # enc-dec source positions
}


# Named rule profiles, the reference's alternatives to the default table;
# "baseline" is the paper-faithful default.
RULE_PROFILES: dict[str, dict] = {
    "baseline": {},
    # decode KV cache sharded on head_dim instead of sequence
    "cache_hd": {
        "cache_seq": ((),),
        "head_dim": (("model",), ()),
        "kv_lora": (("model",), ()),
    },
    # expert-parallel MoE and fully-sharded parameters over both axes
    "fsdp2d": {
        "embed": (("data",), ()),
        "ffn": (("model",), ()),
        "vocab": (("model",), ()),
    },
    # sequence parallelism for long prefill: activations sharded over seq
    # on the model axis
    "seqpar": {
        "seq": (("model",), ()),
    },
}


def axis_sizes(mesh) -> Mapping:
    """``{axis name: size}`` of a mesh: its ``shape`` when that is a
    mapping, else a ``DeviceMesh``'s named dimensions."""
    if isinstance(mesh.shape, Mapping):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to resolve "
                         "logical axes")
    return dict(zip(names, mesh.shape))


@dataclass(frozen=True)
class ShardingRules:
    rules: dict[str, tuple[tuple[str, ...], ...]] = field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def with_overrides(self, **ov) -> "ShardingRules":
        r = dict(self.rules)
        for k, v in ov.items():
            r[k] = v
        return ShardingRules(r)

    def resolve(self, logical: tuple[str | None, ...],
                shape: tuple[int, ...], mesh) -> tuple:
        """Map logical axes for a concrete shape to a spec tuple.

        Drops any candidate whose mesh-axis product does not divide the
        dimension, and never assigns one mesh axis to two dims.
        """
        assert len(logical) == len(shape), (logical, shape)
        sizes = axis_sizes(mesh)
        used: set[str] = set()
        out: list = []
        for name, size in zip(logical, shape):
            if name is None:
                out.append(None)
                continue
            cands = self.rules.get(name)
            if cands is None:
                raise KeyError(f"no sharding rule for logical axis {name!r}")
            chosen: tuple[str, ...] = ()
            for cand in cands:
                cand = tuple(a for a in cand if a in sizes)
                if not cand or any(a in used for a in cand):
                    continue
                prod = 1
                for a in cand:
                    prod *= sizes[a]
                if size % prod == 0:
                    chosen = cand
                    break
            used.update(chosen)
            out.append(chosen if len(chosen) > 1
                       else (chosen[0] if chosen else None))
        return tuple(out)


def spec_to_placements(spec: tuple, mesh) -> tuple:
    """One placement a dimension of ``mesh`` (a ``DeviceMesh``):
    ``Shard(d)`` where tensor dimension d's entry names that mesh axis,
    else ``Replicate()``.  A dimension over several axes shards in mesh
    order, the reference's major-to-minor order; an entry that names its
    axes in another order raises, since DTensor cannot express it."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    place = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise KeyError(f"spec {spec} names axes {missing} that the mesh "
                           f"{tuple(names)} lacks")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} lists its axes out of the "
                             f"mesh's order {tuple(names)}")
        for m in idx:
            place[m] = Shard(d)
    return tuple(place)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def map_specs(fn, specs, tree, path: str = ""):
    """``fn(spec, leaf)`` at every spec of the ``specs`` tree and the
    ``tree`` leaf in its place, in ``tree``'s structure (nested dicts and
    lists); raises where the two structures differ."""
    if _is_spec(specs):
        return fn(specs, tree)
    if isinstance(specs, dict):
        if not isinstance(tree, dict) or set(tree) != set(specs):
            raise ValueError(f"spec tree and tree differ at {path or '.'}")
        return {k: map_specs(fn, specs[k], v, f"{path}.{k}")
                for k, v in tree.items()}
    if isinstance(specs, list):
        if not isinstance(tree, list) or len(tree) != len(specs):
            raise ValueError(f"spec tree and tree differ at {path or '.'}")
        return [map_specs(fn, s, t, f"{path}.{i}")
                for i, (s, t) in enumerate(zip(specs, tree))]
    raise TypeError(f"not a spec tree at {path or '.'}: {specs!r}")


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def spec_tree_to_pspecs(tree_logical, tree_shapes, mesh,
                        rules: ShardingRules):
    """The resolved spec of every leaf; ``tree_shapes`` holds tensors or
    shapes."""
    return map_specs(lambda log, x: rules.resolve(log, _shape(x), mesh),
                     tree_logical, tree_shapes)


def logical_to_sharding(tree_logical, tree_shapes, mesh,
                        rules: ShardingRules):
    """The placements of every leaf on ``mesh`` (a ``DeviceMesh``)."""
    return map_specs(
        lambda log, x: spec_to_placements(
            rules.resolve(log, _shape(x), mesh), mesh),
        tree_logical, tree_shapes)


def shard_params(params, specs, mesh, rules: ShardingRules):
    """``distribute_tensor`` of every leaf to its resolved placements: a
    tree of DTensors whose local tensors are this rank's shards.  Every
    rank holds the whole tree (the same weights) and keeps its own slices
    of it, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    return map_specs(
        lambda log, t: distribute_tensor(t, mesh, spec_to_placements(
            rules.resolve(log, tuple(t.shape), mesh), mesh),
            src_data_rank=None),
        specs, params)


# ---------------------------------------------------------------------------
# Activation sharding constraints — active only inside a distributed driver;
# model code calls ``constrain`` unconditionally and outside the context it
# returns its argument.
# ---------------------------------------------------------------------------
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "activation_sharding", default=None)


@contextmanager
def activation_sharding(mesh, rules: ShardingRules):
    tok = _ACTIVE.set((mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def constrain(x, logical: tuple[str | None, ...]):
    """``x`` itself outside :func:`activation_sharding`; inside it, the
    DTensor ``x`` redistributed to the placements its logical axes resolve
    to.  A plain tensor inside the context raises: it has no placement to
    change."""
    ctx = _ACTIVE.get()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    mesh, rules = ctx
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain{logical} inside activation_sharding "
                        f"needs a DTensor, got {type(x).__name__}")
    spec = rules.resolve(logical, tuple(x.shape), mesh)
    return x.redistribute(mesh, spec_to_placements(spec, mesh))
