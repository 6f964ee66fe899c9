"""The port's input shapes and abstract inputs against the JAX package's.

* ``SHAPES`` and ``shape_applicable`` equal the reference's for every arch
  x shape.
* ``Model.input_specs`` gives meta tensors with the reference's names,
  shapes and dtypes (its ``ShapeDtypeStruct``\\ s) for every arch x shape,
  the decode cache (ring for ``long_500k`` on a windowed config) included.
* ``Model.init_abstract`` gives, for every arch at full width, meta leaves
  with the reference's ``init_abstract`` shapes and dtypes, the port's
  per-layer lists against the reference's stacked leaves; it draws nothing
  and takes well under a second (deepseek-v2-236b at full depth).
* ``adamw_opt_specs`` mirrors the reference's on the port's tree.
"""
import time

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import list_archs  # noqa: E402

ARCHS = list_archs()
CASES = [(a, s) for a in ARCHS for s in REF_SHAPES]


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_paths(tree[k], path + (k,))]
    return [(path, tree)]


def _port_leaf(tree, path):
    """The port's leaves at a reference path: ``(leaves, stacked)``, a list
    of per-layer leaves where the path runs through a layer list."""
    nodes, stacked = [tree], False
    for k in path:
        nxt = []
        for n in nodes:
            n = n[k]
            if isinstance(n, list):
                nxt.extend(n)
                stacked = True
            else:
                nxt.append(n)
        nodes = nxt
    return nodes, stacked


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_count(v) for v in tree)
    return 1


def test_shapes_equal_the_reference():
    from repro_torch.configs import (DECODE_32K, LONG_500K, PREFILL_32K,
                                     SHAPES, TRAIN_4K, InputShape)
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind)
            for k, v in SHAPES.items()} == \
        {k: (v.name, v.seq_len, v.global_batch, v.kind)
         for k, v in REF_SHAPES.items()}
    assert [s.name for s in (TRAIN_4K, PREFILL_32K, DECODE_32K,
                             LONG_500K)] == list(REF_SHAPES)
    assert all(isinstance(s, InputShape) for s in SHAPES.values())


@pytest.mark.parametrize("arch,shape", CASES)
def test_shape_applicable_equals_the_reference(arch, shape):
    from repro.configs import get_config as ref_config
    from repro.configs import shape_applicable as ref_applicable

    from repro_torch.configs import SHAPES, get_config, shape_applicable
    assert shape_applicable(get_config(arch), SHAPES[shape]) == \
        ref_applicable(ref_config(arch), REF_SHAPES[shape])


@pytest.mark.parametrize("arch,shape", CASES)
def test_input_specs_match_the_reference(arch, shape):
    from repro.models import build_model as ref_build

    from repro_torch.configs import SHAPES
    from repro_torch.models import build_model
    ref = ref_build(arch).input_specs(REF_SHAPES[shape])
    port = build_model(arch).input_specs(SHAPES[shape])
    assert set(port) == set(ref)
    for name, want in ref.items():
        got = port[name]
        if name == "cache":
            assert set(got) == set(want)
            for k, w in want.items():
                assert got[k].device.type == "meta"
                assert (tuple(got[k].shape), _dtype(got[k])) == \
                    (tuple(w.shape), _dtype(w)), (name, k)
            continue
        assert got.device.type == "meta"
        assert (tuple(got.shape), _dtype(got)) == \
            (tuple(want.shape), _dtype(want)), name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_abstract_matches_the_reference(arch):
    from repro.models import build_model as ref_build

    from repro_torch.models import build_model
    ref = ref_build(arch).init_abstract()
    port = build_model(arch).init_abstract()
    ref_leaves = _leaves_with_paths(jax.tree.map(lambda x: x, ref))
    n = 0
    for path, want in ref_leaves:
        leaves, stacked = _port_leaf(port, path)
        shape = tuple(want.shape)[1:] if stacked else tuple(want.shape)
        assert len(leaves) == (want.shape[0] if stacked else 1), path
        for t in leaves:
            assert t.device.type == "meta", path
            assert (tuple(t.shape), _dtype(t)) == (shape, _dtype(want)), path
        n += len(leaves)
    assert n == _count(port)


def test_init_abstract_draws_nothing_and_is_fast():
    from repro_torch.models import build_model
    m = build_model("deepseek-v2-236b")
    m.init_abstract()                  # the first call imports lazily
    state = torch.random.get_rng_state()
    t0 = time.perf_counter()
    p = m.init_abstract()
    dt = time.perf_counter() - t0
    assert dt < 0.5, dt
    assert torch.equal(state, torch.random.get_rng_state())
    from repro_torch.train.optimizer import tree_leaves
    leaves = tree_leaves(p)
    assert leaves and all(t.device.type == "meta" for t in leaves)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "zamba2-2.7b"])
def test_adamw_opt_specs_mirror_the_reference(arch):
    from repro.train.optimizer import adamw_opt_specs as ref_opt_specs

    from repro_torch.models import build_model
    from repro_torch.models.sharding import map_specs
    from repro_torch.train.optimizer import adamw_init, adamw_opt_specs
    m = build_model(arch, reduced=True)
    specs = m.logical_specs()
    got = adamw_opt_specs(specs)
    assert got == ref_opt_specs(specs)
    opt = adamw_init(m.init_abstract())
    n = []
    map_specs(lambda s, t: n.append(len(s) == t.dim()), got, opt)
    assert n and all(n)
