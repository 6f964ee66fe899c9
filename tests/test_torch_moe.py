"""The MoE family (dbrx-132b) on the port against the JAX package.

On the reduced dbrx config in float32 (16 experts top 4 cut to 4 top 2,
d_model 256) with ``capacity_factor`` set back to the config's 1.25 in
both packages (``reduced()`` sets it to 1e9, where nothing drops), and
weights converted from the JAX init, on the CPU:

* the config equals the JAX one field for field, with equal
  ``param_count()``;
* ``moe_apply`` at T = 1, 8, 16 and (1, 40) rows of seeded inputs that
  share a direction (so that experts overflow) equals the JAX function:
  outputs within 1e-5, the aux loss within 1e-6; the inputs drop at least
  one assignment at T 8 and 16, and none at ``capacity_factor`` 1e9;
* with ``num_shared_experts=1`` and ``first_dense_layers=1``, the prefill
  and teacher-forced decode steps equal the JAX model's within 1e-4;
* ``stack_kernel_decode_step`` over 6 slots (C = 4 < 6), one of them dead
  past its stripe or through a zeroed table row, equals the JAX kernel
  step in interpret mode within 1e-5, cache included; it drops
  assignments;
* the engine (8 prompts on 6 slots: slots recycle, and four go dead while
  the last two requests decode) equals the JAX engine's Pallas path
  (``kernel_backend="pallas"``, whose batched step routes all slots
  together): greedy tokens identical, logprobs within 1e-4 (int8 2e-3);
  the same run at ``capacity_factor`` 1e9 gives other logprobs, so the
  drops reach the engine;
* ``build_model("dbrx-132b", reduced=True)`` serves on every layout, and
  the training forward runs the family (and MLA, whose serving is
  admitted).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import stacks_infer as jinfer  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.rl.rollout import SamplerConfig as JaxSampler  # noqa: E402
from repro.rl.rollout import \
    generate_continuous as jax_generate_continuous  # noqa: E402
from repro.serve import RolloutSpec  # noqa: E402
from repro_torch.configs import ModelConfig, get_config  # noqa: E402
from repro_torch.convert import from_jax_params, to_tensor  # noqa: E402
from repro_torch.launch.serve import serve_continuous  # noqa: E402
from repro_torch.models import build_model, kvcache  # noqa: E402
from repro_torch.models import moe, stacks_infer  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.rl import SamplerConfig, generate_continuous  # noqa: E402

ARCH = "dbrx-132b"
CF = 1.25                # dbrx's capacity factor, restored after reduced()
TOL = dict(atol=1e-4, rtol=0)
N_SLOTS, N_REQ, SP, NEW, BS = 6, 8, 12, 8, 4


def _cfgs(**kw):
    """The reduced float32 dbrx config of both packages with ``kw``."""
    kw = dict(dtype="float32", capacity_factor=CF) | kw
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _pair(seed=1, **kw):
    jc, tc = _cfgs(**kw)
    jm = JaxModel(jc)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(seed))
    return jm, jp, Model(tc), from_jax_params(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def shared_pair():
    return _pair(seed=2, num_shared_experts=1, first_dense_layers=1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _drops(monkeypatch):
    """Count the assignments ``moe_route`` drops (a list the caller
    reads): ``moe_apply`` looks the router up by name at each call."""
    route, seen = moe.moe_route, []

    def counting(*a, **kw):
        r = route(*a, **kw)
        seen.append(int((~r["keep"]).sum()))
        return r
    monkeypatch.setattr(moe, "moe_route", counting)
    return seen


def test_config_matches_jax():
    ours, ref = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count() == 131596517376
    assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(
        ref.reduced())


@pytest.fixture(scope="module")
def moe_layer():
    jc, tc = _cfgs()
    jp = jax.jit(jmoe.moe_init, static_argnums=1)(jax.random.PRNGKey(0), jc)
    return jc, jp, tc, {k: to_tensor(np.asarray(v)) for k, v in jp.items()}


@pytest.mark.parametrize("shape", [(1, 1), (8, 1), (16, 1), (1, 40)])
def test_moe_apply_matches_jax(moe_layer, shape, monkeypatch):
    jc, jp, tc, tp = moe_layer
    rs = np.random.RandomState(sum(shape))
    # rows that share a direction, as a layer's hidden states do: they
    # agree on experts, which then overflow their capacity
    x = (rs.randn(*shape, jc.d_model) + rs.randn(jc.d_model)).astype(
        np.float32)
    jy, jaux = jax.jit(jmoe.moe_apply, static_argnums=1)(jp, jc,
                                                         jnp.asarray(x))
    seen = _drops(monkeypatch)
    ty, taux = moe.moe_apply(tp, tc, _t(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=0)
    T = shape[0] * shape[1]
    if T in (8, 16):
        assert seen[0] > 0, "the seeded rows drop nothing"
    free = dataclasses.replace(tc, capacity_factor=1.0e9)
    moe.moe_apply(tp, free, _t(x))
    assert seen[1] == 0


def test_prefill_and_decode_match_jax_shared_and_dense_first(shared_pair):
    """A leading dense layer and a shared expert: prefill of P ids, then
    S - P teacher-forced decode steps, against the JAX model."""
    jm, jp, tm, tp = shared_pair
    assert len(tp["dense_layers"]) == 1 and "mlp" in tp["dense_layers"][0]
    assert "shared" in tp["layers"][0]["moe"]
    rs = np.random.RandomState(2)
    B, P, S = 2, 24, 32
    tokens = rs.randint(0, tm.cfg.vocab_size, size=(B, S)).astype(np.int32)
    jl, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(tokens[:, :P]),
                                     jm.init_cache(B, S))
    tl, tcache = tm.prefill(tp, _t(tokens[:, :P]),
                            tm.init_cache(B, S, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)
    step = jax.jit(jm.decode_step)
    for t in range(P, S):
        jl, jcache = step(jp, jnp.asarray(tokens[:, t:t + 1]), jcache)
        tl, tcache = tm.decode_step(tp, _t(tokens[:, t:t + 1]), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("paged", [False, True])
def test_kernel_decode_step_matches_jax_interpret(pair, paged, monkeypatch):
    """One batched kernel step over 6 slots at seeded positions with
    seeded K/V; the last slot is dead: past its stripe (contiguous, where
    the JAX scatter drops its write) or through a zeroed table row into
    the null block (paged)."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rs = np.random.RandomState(4)
    S, L = 32, cfg.num_layers
    index = np.asarray([3, 9, 17, 25, 31, 40], np.int32)
    N = len(index)
    shape = (L, N, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    k = rs.randn(*shape).astype(np.float32)
    v = rs.randn(*shape).astype(np.float32)
    tables = None
    if paged:
        index[-1] = 7
        MB = S // BS
        ids = rs.permutation(np.arange(1, N * MB + 1)).reshape(N, MB)
        tables = ids.astype(np.int32)
        pool = np.zeros((L, N * MB + 1, BS) + shape[3:], np.float32)
        vpool = np.zeros_like(pool)
        for b in range(N):
            pool[:, tables[b]] = k[:, b].reshape(L, MB, BS, *shape[3:])
            vpool[:, tables[b]] = v[:, b].reshape(L, MB, BS, *shape[3:])
        tables[-1] = 0                      # a released slot's row
        k, v = pool, vpool
    tok = rs.randint(0, cfg.vocab_size, size=(N, 1)).astype(np.int32)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v),
          "index": jnp.asarray(index)}
    tc = {"k": _t(k), "v": _t(v), "index": _t(index)}
    jl, jc = jinfer.stack_kernel_decode_step(
        jp, jm.cfg, jnp.asarray(tok), jc,
        tables=None if tables is None else jnp.asarray(tables),
        interpret=True)
    seen = _drops(monkeypatch)
    tl, tc = stacks_infer.stack_kernel_decode_step(
        tp, cfg, _t(tok), tc, tables=None if tables is None else _t(tables))
    assert moe.capacity_for(cfg, N) == 4 and sum(seen) > 0, seen
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tc["index"].numpy(), index + 1)


def _prompts():
    rs = np.random.RandomState(0)
    return rs.randint(0, 512, size=(N_REQ, SP)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_runs(pair):
    """The JAX engine's Pallas-path runs, by layout, made on first use."""
    jm, jp, _, _ = pair
    runs = {}

    def get(layout, kv_dtype):
        key = (layout, kv_dtype)
        if key not in runs:
            runs[key] = jax.tree.map(np.asarray, jax_generate_continuous(
                jm, jp, _prompts(), jax.random.PRNGKey(0),
                JaxSampler(max_new_tokens=NEW, temperature=0.0),
                spec=RolloutSpec(num_slots=N_SLOTS, kv_layout=layout,
                                 kv_block_size=BS, kernel_backend="pallas",
                                 kv_dtype=kv_dtype)))
        return runs[key]
    return get


def _port_run(model, params, layout, kv_dtype):
    return generate_continuous(
        model, params, _prompts(), SamplerConfig(max_new_tokens=NEW),
        num_slots=N_SLOTS, kv_layout=layout, kv_block_size=BS,
        kv_dtype=kv_dtype, device="cpu")


@pytest.mark.parametrize("layout,kv_dtype", [("contiguous", None),
                                             ("paged", None),
                                             ("paged", "int8")])
def test_engine_matches_jax_pallas(pair, jax_runs, layout, kv_dtype,
                                   monkeypatch):
    _, _, tm, tp = pair
    ref = jax_runs(layout, kv_dtype)
    seen = _drops(monkeypatch)
    got = _port_run(tm, tp, layout, kv_dtype)
    assert sum(seen) > 0, "the run drops nothing"
    np.testing.assert_array_equal(got["completions"].numpy(),
                                  ref["completions"])
    np.testing.assert_array_equal(got["mask"].numpy(), ref["mask"])
    np.testing.assert_allclose(got["behavior_logp"].numpy(),
                               ref["behavior_logp"],
                               atol=1e-4 if kv_dtype is None else 2e-3,
                               rtol=0)
    stats = got["engine_stats"]
    assert stats.prefills == N_REQ and stats.peak_active == N_SLOTS


def test_drops_reach_the_engine(pair, jax_runs):
    """The same port run with drop-free capacity leaves the reference."""
    _, _, tm, tp = pair
    ref = jax_runs("contiguous", None)
    free = Model(dataclasses.replace(tm.cfg, capacity_factor=1.0e9))
    got = _port_run(free, tp, "contiguous", None)
    lp_gap = np.abs(got["behavior_logp"].numpy() - ref["behavior_logp"])
    assert (got["completions"].numpy() != ref["completions"]).any() \
        or lp_gap.max() > 1e-3, lp_gap.max()


@pytest.mark.parametrize("kw", [
    dict(kv="contiguous"), dict(kv="paged"),
    dict(kv="paged", kv_dtype="int8"),
    dict(kv="paged", prefix_share=True), dict(disagg=True)],
    ids=["contiguous", "paged", "paged-int8", "radix", "disagg"])
def test_reduced_dbrx_serves_every_layout(kw):
    prompts = [[5, 6, 7, 8, 9, 10, 11, 12]] * 2 + [[1, 2, 3]]
    rep = serve_continuous(ARCH, prompts, reduced=True, max_new=4,
                           num_slots=2, kv_block_size=4, device="cpu", **kw)
    outs = rep["outputs"]
    assert sorted(o.rid for o in outs) == [0, 1, 2]
    assert all(o.num_tokens == 4 for o in outs)


def test_mla_and_moe_training_forward_runs(pair):
    """Serving MLA is admitted (deepseek-v2 builds and inits); the
    training forward runs MLA and the MoE family: finite logits, a
    positive aux loss, and (all rows routed together in both) the
    prefill's last logits."""
    ds = ModelConfig(**dataclasses.asdict(jax_get_config(
        "deepseek-v2-236b")))
    kvcache.check_supported(ds)
    assert build_model(ds).cfg.attention == "mla"
    mla = build_model(ds, reduced=True)
    mp = mla.init(torch.Generator().manual_seed(0))
    _, _, tm, tp = pair
    tokens = torch.arange(1, 5, dtype=torch.int32)[None]
    for model, params in ((mla, mp), (tm, tp)):
        logits, aux = model.forward(params, tokens)
        last, _ = model.prefill(params, tokens,
                                model.init_cache(1, 8, device="cpu"))
        assert logits.shape == (1, 4, model.cfg.vocab_size)
        assert torch.isfinite(logits).all() and float(aux) > 0
        np.testing.assert_allclose(logits[:, -1].numpy(), last.numpy(),
                                   atol=1e-5, rtol=0)
