"""The port's sharding rules (``repro_torch.models.sharding``), every
family's logical specs and the meshes, against the JAX package's.

* For every arch: ``logical_specs()`` covers the port's reduced init, one
  spec a leaf of matching rank, and equals the reference's ``stack_specs``
  with the leading ``"layers"`` axis dropped on the stacked groups (which
  the port keeps as lists of per-layer dicts); ``cache_logical_specs()``
  equals the reference's ``cache_specs`` and covers the port's cache.
* ``resolve`` equals the reference's on every parameter leaf at full width
  (shapes from the reference's ``init_abstract()``) and on every cache leaf,
  on fake meshes {data 16, model 16}, {pod 2, data 16, model 16} and {data
  2, model 2}, under every ``RULE_PROFILES`` entry; and on the reference
  test's spot cases.
* On a gloo world of 2 x 2 ``("data", "model")`` ranks, for reduced
  internlm2, dbrx and zamba2: ``shard_params`` gives each rank the slice
  its coordinates select under the reference's resolved spec, and
  ``full_tensor()`` is the leaf bit for bit; each arch has leaves sharded
  on each axis.  ``constrain`` redistributes a DTensor there and raises on
  a plain tensor; a two-axis entry shards major to minor, one out of the
  mesh's order raises; ``make_production_mesh`` raises on the 4-rank
  world.  ``constrain`` outside the context returns its argument.
* ``make_local_mesh("cpu")`` gives a (1, 1) mesh in a fresh process.
"""
import os
from datetime import timedelta

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import list_archs  # noqa: E402

MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 2})
GLOO_ARCHS = ("internlm2-1.8b", "dbrx-132b", "zamba2-2.7b")


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _is_spec(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _drop_lead(tree, lead):
    """A stacked group's specs without their first entry, ``lead``."""
    if isinstance(tree, dict):
        return {k: _drop_lead(v, lead) for k, v in tree.items()}
    assert tree[0] == lead, tree
    return tree[1:]


def _to_port_layout(ref, port, lead="layers"):
    """The reference's (logical or resolved) spec tree in the port's
    layout: each group the port keeps as a list gets one per-layer copy of
    the group, its first entry (``lead``) dropped."""
    if isinstance(port, list):
        one = _drop_lead(ref, lead)
        return [one] * len(port)
    if isinstance(port, dict):
        assert isinstance(ref, dict) and set(ref) == set(port), (ref, port)
        return {k: _to_port_layout(ref[k], port[k], lead) for k in port}
    return ref


def _flat(tree):
    """The leaves of nested dicts (keys sorted) and lists."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in _flat(t)]
    return [tree]


def _leaves_with_paths(tree, path=()):
    """``(path, leaf)`` of a nested dict of spec or shape leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_paths(tree[k], path + (k,))]
    return [(path, tree)]


def _port_spec_at(port_specs, path):
    """The port's spec at a reference path, and whether the path runs
    through a stacked group (a list: its layer 0 stands for all)."""
    node, stacked = port_specs, False
    for k in path:
        node = node[k]
        if isinstance(node, list):
            node, stacked = node[0], True
    return node, stacked


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference_and_cover_tree(arch):
    from repro.models import build_model as ref_build

    from repro_torch.models import build_model
    from repro_torch.models.sharding import map_specs
    m = build_model(arch, reduced=True)
    specs = m.logical_specs()
    params = m.init(torch.Generator().manual_seed(0))
    n = []
    map_specs(lambda s, t: n.append(len(s) == t.dim()), specs, params)
    assert n and all(n)
    ref = ref_build(arch, reduced=True).logical_specs()
    assert specs == _to_port_layout(ref, specs)


@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_reference_and_cover_cache(arch):
    from repro.models import build_model as ref_build

    from repro_torch.models import build_model
    from repro_torch.models.sharding import map_specs
    m = build_model(arch, reduced=True)
    specs = m.cache_logical_specs()
    assert specs == ref_build(arch, reduced=True).cache_logical_specs()
    cache = m.init_cache(2, 32, device="cpu")
    n = []
    map_specs(lambda s, t: n.append(len(s) == t.dim()), specs, cache)
    assert len(n) == len(cache) and all(n)


@pytest.mark.parametrize("arch", list_archs())
def test_resolve_matches_reference_at_full_width(arch):
    from repro.models import build_model as ref_build
    from repro.models.sharding import RULE_PROFILES as REF_PROFILES
    from repro.models.sharding import ShardingRules as RefRules

    from repro_torch.models import build_model
    from repro_torch.models.sharding import RULE_PROFILES, ShardingRules
    assert RULE_PROFILES == REF_PROFILES
    assert ShardingRules().rules == RefRules().rules
    ref_model, port = ref_build(arch), build_model(arch)
    abstract = ref_model.init_abstract()
    ref_specs, port_specs = ref_model.logical_specs(), port.logical_specs()
    shapes = dict(_leaves_with_paths(jax.tree.map(
        lambda x: tuple(x.shape), abstract)))
    cache = jax.eval_shape(lambda: ref_model.init_cache(16, 4096))
    cache_shapes = {k: tuple(v.shape) for k, v in cache.items()}
    checked = 0
    for profile, ov in RULE_PROFILES.items():
        ours = ShardingRules().with_overrides(**ov)
        theirs = RefRules().with_overrides(**ov)
        for sizes in MESHES:
            mesh = FakeMesh(sizes)
            for path, spec in _leaves_with_paths(ref_specs):
                want = tuple(theirs.resolve(spec, shapes[path], mesh))
                mine, stacked = _port_spec_at(port_specs, path)
                if stacked:
                    assert want[0] is None
                    assert ours.resolve(mine, shapes[path][1:], mesh) == \
                        want[1:], (profile, sizes, path)
                else:
                    assert ours.resolve(mine, shapes[path], mesh) == want, \
                        (profile, sizes, path)
                checked += 1
            for name, spec in port.cache_logical_specs().items():
                assert ours.resolve(spec, cache_shapes[name], mesh) == tuple(
                    theirs.resolve(spec, cache_shapes[name], mesh))
    assert checked == len(shapes) * len(RULE_PROFILES) * len(MESHES)


def test_reference_spot_cases():
    """``tests/test_sharding.py``'s cases on the port's rules."""
    from repro.models.sharding import ShardingRules as RefRules

    from repro_torch.models.sharding import ShardingRules
    rules, ref = ShardingRules(), RefRules()
    single = FakeMesh({"data": 16, "model": 16})
    pod = FakeMesh({"pod": 2, "data": 16, "model": 16})
    cases = (
        (single, ("embed", "heads", "head_dim"), (3584, 28, 128),
         P("data", None, None)),
        (single, ("embed", "heads", "head_dim"), (4096, 32, 128),
         P("data", "model", None)),
        (single, ("embed", "vocab"), (384, 51865), P("data", None)),
        (single, ("layers", "batch", "cache_seq", "kv_heads", None),
         (24, 128, 32768, 32, 128), P(None, "data", "model", None, None)),
        (pod, ("batch", "seq"), (256, 4096), P(("pod", "data"), None)),
        (pod, ("batch", "seq"), (1, 524288), P(None, None)))
    for mesh, logical, shape, want in cases:
        got = rules.resolve(logical, shape, mesh)
        assert got == tuple(want) == tuple(ref.resolve(logical, shape, mesh))
    with pytest.raises(KeyError, match="no sharding rule"):
        rules.resolve(("nonesuch",), (4,), single)


def test_constrain_is_the_identity_outside_the_context():
    from repro_torch.models.sharding import constrain
    x = torch.ones(2, 3, 4)
    assert constrain(x, ("batch", "seq", "vocab_act")) is x


def _slice_of(spec, shape, coord, sizes):
    """The index of the block that mesh coordinate ``coord`` holds under a
    resolved spec: a dimension over several axes splits major to minor."""
    idx = []
    for entry, n in zip(spec, shape):
        axes = () if entry is None else ((entry,) if isinstance(entry, str)
                                         else entry)
        k, parts = 0, 1
        for a in axes:
            k, parts = k * sizes[a] + coord[a], parts * sizes[a]
        step = n // parts
        idx.append(slice(k * step, (k + 1) * step))
    return tuple(idx)


def _shard_rank(rank, world, store, out_dir):
    """One rank of the 2 x 2 ("data", "model") gloo world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.models.sharding import (ShardingRules,
                                             activation_sharding,
                                             constrain, shard_params,
                                             spec_to_placements)

    def raises(exc, fn, *args, **kw):
        try:
            fn(*args, **kw)
        except exc as e:
            return str(e)
        return None

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        res = {"coord": tuple(mesh.get_coordinate())}
        for arch in GLOO_ARCHS:
            m = build_model(arch, reduced=True)
            params = m.init(torch.Generator().manual_seed(0))
            sharded = shard_params(params, m.logical_specs(), mesh,
                                   ShardingRules())
            # each leaf: its local shard, and whether the gathered tensor
            # is the leaf bit for bit
            res[arch] = [(d.to_local().clone(),
                          torch.equal(d.full_tensor(), t))
                         for d, t in zip(_flat(sharded), _flat(params))]
        # constrain inside the context: a DTensor is redistributed, a plain
        # tensor raises; outside it returns its argument
        x = torch.arange(4 * 6 * 8, dtype=torch.float32).view(4, 6, 8)
        dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
        logical = ("batch", "seq", "vocab_act")
        with activation_sharding(mesh, ShardingRules()):
            dy = constrain(dx, logical)
            res["plain raises"] = raises(TypeError, constrain, x, logical)
        res["constrain"] = (tuple(dy.placements), dy.to_local().clone(),
                            torch.equal(dy.full_tensor(), x))
        res["outside"] = constrain(dx, logical) is dx
        # a two-axis entry shards major to minor; one out of the mesh's
        # order raises
        rows = torch.arange(8 * 3, dtype=torch.float32).view(8, 3)
        place = spec_to_placements((("data", "model"), None), mesh)
        res["two axes"] = (place, distribute_tensor(
            rows, mesh, list(place)).to_local().clone())
        res["out of order"] = raises(ValueError, spec_to_placements,
                                     (("model", "data"), None), mesh)
        res["production"] = raises(RuntimeError, make_production_mesh,
                                   device_type="cpu")
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _local_mesh_rank(rank, world, store, out_dir):
    """A fresh process with no world: ``make_local_mesh("cpu")``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    torch.set_num_threads(1)
    mesh = make_local_mesh("cpu")
    again = make_local_mesh("cpu")          # reuses the one-rank world
    res = {"shape": tuple(mesh.shape), "names": mesh.mesh_dim_names,
           "type": mesh.device_type, "world": dist.get_world_size(),
           "again": tuple(again.shape)}
    dist.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _spawn(fn, world, d):
    import torch.multiprocessing as mp
    mp.start_processes(fn, args=(world, str(d / "store"), str(d)),
                       nprocs=world, start_method="spawn")
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def gloo_2x2(tmp_path_factory):
    return _spawn(_shard_rank, 4, tmp_path_factory.mktemp("shard_gloo"))


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_shard_params_slices_as_the_reference(gloo_2x2, arch):
    from repro.models import build_model as ref_build
    from repro.models.sharding import ShardingRules as RefRules

    from repro_torch.models import build_model
    sizes = {"data": 2, "model": 2}
    m = build_model(arch, reduced=True)
    leaves = _flat(m.init(torch.Generator().manual_seed(0)))
    ref_model = ref_build(arch, reduced=True)
    resolved = jax.tree.map(
        lambda s, x: tuple(RefRules().resolve(s, x.shape, FakeMesh(sizes))),
        ref_model.logical_specs(), ref_model.init_abstract(),
        is_leaf=_is_spec)
    want = _flat(_to_port_layout(resolved, m.logical_specs(), lead=None))
    assert len(want) == len(leaves)
    axes_used = {a for spec in want for e in spec if e
                 for a in ((e,) if isinstance(e, str) else e)}
    assert axes_used == {"data", "model"}      # the check is not vacuous
    for res in gloo_2x2:
        coord = dict(zip(("data", "model"), res["coord"]))
        assert len(res[arch]) == len(leaves)
        for (local, full_ok), leaf, spec in zip(res[arch], leaves, want):
            assert full_ok, (arch, spec)
            blk = _slice_of(spec, leaf.shape, coord, sizes)
            assert torch.equal(local, leaf[blk]), (arch, spec, coord)


def test_constrain_and_placements_on_gloo(gloo_2x2):
    from torch.distributed.tensor import Shard
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).view(4, 6, 8)
    rows = torch.arange(8 * 3, dtype=torch.float32).view(8, 3)
    for res in gloo_2x2:
        d, m = res["coord"]
        place, local, full_ok = res["constrain"]
        assert place == (Shard(0), Shard(2)) and full_ok
        assert torch.equal(local, x[2 * d:2 * d + 2, :, 4 * m:4 * m + 4])
        assert res["plain raises"] and "needs a DTensor" in res[
            "plain raises"]
        assert res["outside"]
        place, local = res["two axes"]
        assert place == (Shard(0), Shard(0))
        k = 2 * d + m                       # data major, model minor
        assert torch.equal(local, rows[2 * k:2 * k + 2])
        assert "out of the mesh's order" in res["out of order"]
        assert "256 ranks" in res["production"] and "has 4" in res[
            "production"]


def test_make_local_mesh_in_a_fresh_process(tmp_path):
    (res,) = _spawn(_local_mesh_rank, 1, tmp_path)
    assert res == {"shape": (1, 1), "names": ("data", "model"),
                   "type": "cpu", "world": 1, "again": (1, 1)}
