"""whisper-tiny (the audio family: LayerNorm, gelu MLPs, sinusoidal
positions, a bidirectional encoder and cross-attention) on the port against
the JAX package.

On converted reduced weights in float32 (2 encoder and 2 decoder layers,
d_model 256, 4 heads of 64, 64 source frames), every QKV, MLP and
LayerNorm bias and every LayerNorm weight set to seeded values (the
inits make the biases 0, and with them the reduced model repeats one
token), seeded random frames, on the CPU:

* the config equals the JAX one field for field, with equal
  ``param_count()``;
* ``layer_norm``, the gelu MLP and ``_sinusoid`` (at an offset, and at a
  vector of per-slot offsets) equal the JAX functions;
* ``encode_source``, the prefill's logits and its ``cross_k``/``cross_v``
  and self-attention K/V, and teacher-forced decode steps equal the JAX
  model within 1e-4; ``stack_kernel_decode_step`` at per-slot positions
  equals the JAX model's batch=1 step slot by slot, contiguous and paged;
* the engine equals the JAX engine on contiguous, paged and paged-int8
  KV: greedy tokens identical (the reference's not one repeated token),
  logprobs within 1e-4 (int8 2e-3, ROADMAP §3);
* requests with one prompt and two frontends never share a radix prefix,
  and a router equals the monolithic engine bit for bit; the static
  ``generate`` equals the JAX one;
* the engine refuses an audio request without frames, or with frames of
  another length.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import stacks as jstacks  # noqa: E402
from repro.rl import SamplerConfig as JaxSampler  # noqa: E402
from repro.rl import generate as jax_generate  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common, stacks, stacks_infer  # noqa: E402
from repro_torch.rl.rollout import SamplerConfig, generate  # noqa: E402
from repro_torch.serve import (DisaggConfig, DisaggRouter, Engine,  # noqa
                               EngineConfig, Request)

ARCH = "whisper-tiny"
TOL = dict(atol=1e-4, rtol=0)
MAX_LEN, BS, NEW = 48, 4, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def perturb(tree, seed):
    """The JAX params with every bias set to ``0.1 * N(0, 1)`` and every
    LayerNorm weight to ``1 + 0.1 * N(0, 1)``, seeded."""
    rs = np.random.RandomState(seed)

    def leaf(path, a):
        keys = [getattr(k, "key", None) for k in path]
        a = np.asarray(a)
        if keys[-1] in ("bq", "bk", "bv", "bi", "bo", "b"):
            return jnp.asarray((0.1 * rs.randn(*a.shape)).astype(a.dtype))
        if keys[-1] == "w":
            return jnp.asarray((1 + 0.1 * rs.randn(*a.shape)).astype(
                a.dtype))
        return jnp.asarray(a)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def audio():
    jm = jax_build(ARCH, reduced=True)
    jp = perturb(jax.jit(jm.init)(jax.random.PRNGKey(1)), 12)
    tm = build_model(ARCH, reduced=True)
    return jm, jp, tm, from_jax_params(jax.tree.map(np.asarray, jp))


def _frames(cfg, seed, n=1, S=None):
    rs = np.random.RandomState(seed)
    S = cfg.max_source_len if S is None else S
    return rs.randn(n, S, cfg.d_model).astype(np.float32)


def _prompts(n=3, seed=5):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 512, size=int(k)).astype(np.int32)
            for k in rs.randint(6, 25, size=n)]


def test_config_matches_jax():
    ours, ref = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count() == 39372672
    assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(
        ref.reduced())


def test_norm_mlp_sinusoid_match_jax(audio):
    jm, jp, tm, tp = audio
    cfg = tm.cfg
    rs = np.random.RandomState(3)
    x = (3 * rs.randn(2, 7, cfg.d_model)).astype(np.float32)
    lp_j = jax.tree.map(lambda a: a[0], jp["layers"])
    lp_t = tp["layers"][0]
    ln = lp_j["ln1"]
    np.testing.assert_allclose(
        common.layer_norm(_t(x), lp_t["ln1"]["w"], lp_t["ln1"]["b"],
                          cfg.norm_eps).numpy(),
        np.asarray(jcommon.layer_norm(jnp.asarray(x), ln["w"], ln["b"],
                                      cfg.norm_eps)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        common.gelu_mlp_apply(lp_t["mlp"], _t(x)).numpy(),
        np.asarray(jcommon.gelu_mlp_apply(lp_j["mlp"], jnp.asarray(x))),
        atol=1e-5, rtol=0)
    # sin and cos of angles up to ~40 rad, whose float32 arguments (a
    # product with an exp) differ by an ulp or two between XLA's and
    # PyTorch's exp: 5e-5
    for offset in (0, 37):
        np.testing.assert_allclose(
            stacks._sinusoid(5, cfg.d_model, offset=offset).numpy(),
            np.asarray(jstacks._sinusoid(5, cfg.d_model, offset=offset)),
            atol=5e-5, rtol=0)
    # per-slot offsets (a decode step's) lead the result
    off = np.asarray([0, 3, 300], np.int32)
    got = stacks._sinusoid(1, cfg.d_model, offset=_t(off)).numpy()
    for i, o in enumerate(off):
        np.testing.assert_allclose(
            got[i], np.asarray(jstacks._sinusoid(1, cfg.d_model,
                                                 offset=jnp.int32(o))),
            atol=5e-5, rtol=0)
    half = cfg.d_model // 2         # [sin of each angle, cos of each]
    assert math.isclose(float(got[1, 0, 0]), math.sin(3.0), abs_tol=1e-6)
    assert math.isclose(float(got[1, 0, half]), math.cos(3.0),
                        abs_tol=1e-6)


def test_encoder_prefill_and_decode_match_jax(audio):
    jm, jp, tm, tp = audio
    cfg = tm.cfg
    rs = np.random.RandomState(2)
    B, P, S = 2, 12, 20
    tokens = rs.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    fr = _frames(cfg, 3, B)
    enc = stacks.encode_source(tp, cfg, _t(fr))
    np.testing.assert_allclose(
        enc.numpy(), np.asarray(jstacks.encode_source(jp, jm.cfg,
                                                      jnp.asarray(fr))),
        **TOL)
    jcache, tcache = jm.init_cache(B, S), tm.init_cache(B, S, device="cpu")
    jl, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(tokens[:, :P]), jcache,
                                     frontend=jnp.asarray(fr))
    tl, tcache = tm.prefill(tp, _t(tokens[:, :P]), tcache, frontend=_t(fr))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v", "cross_k", "cross_v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)
    step = jax.jit(jm.decode_step)
    for t in range(P, S):
        jl, jcache = step(jp, jnp.asarray(tokens[:, t:t + 1]), jcache)
        tl, tcache = tm.decode_step(tp, _t(tokens[:, t:t + 1]), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("paged", [False, True])
def test_kernel_decode_step_matches_jax_per_slot(audio, paged):
    """One batched kernel step over slots at their own positions (seeded
    random self and cross K/V) against the JAX model's batch=1 decode
    step of each slot at its scalar index, as the JAX engine vmaps it."""
    jm, jp, tm, tp = audio
    cfg = tm.cfg
    rs = np.random.RandomState(4)
    index = np.asarray([0, 5, 11, 19], np.int32)
    N, S, L = len(index), 20, cfg.num_layers
    kv = (L, N, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    cross = (L, N, cfg.max_source_len) + kv[3:]
    leaves = {n: rs.randn(*shp).astype(np.float32) for n, shp in
              (("k", kv), ("v", kv), ("cross_k", cross), ("cross_v", cross))}
    tok = rs.randint(0, cfg.vocab_size, size=(N, 1)).astype(np.int32)
    step = jax.jit(jm.decode_step)
    want = []
    for b in range(N):
        one = {n: jnp.asarray(a[:, b:b + 1]) for n, a in leaves.items()}
        one["index"] = jnp.int32(index[b])
        want.append(np.asarray(step(jp, jnp.asarray(tok[b:b + 1]), one)[0]))
    cache = {n: _t(a) for n, a in leaves.items()}
    cache["index"] = _t(index)
    tables = None
    if paged:
        MB = S // BS
        tables = rs.permutation(np.arange(1, N * MB + 1)).reshape(
            N, MB).astype(np.int32)
        for n in ("k", "v"):
            pool = np.zeros((L, N * MB + 1, BS) + kv[3:], np.float32)
            for b in range(N):
                pool[:, tables[b]] = leaves[n][:, b].reshape(L, MB, BS,
                                                              *kv[3:])
            cache[n] = _t(pool)
        tables = _t(tables)
    got, cache = stacks_infer.stack_kernel_decode_step(tp, cfg, _t(tok),
                                                       cache, tables=tables)
    np.testing.assert_allclose(got.numpy(), np.concatenate(want), **TOL)
    np.testing.assert_array_equal(cache["index"].numpy(), index + 1)


def _run(engine, prompts, frontends, req_cls, to=np.asarray):
    for i, (p, f) in enumerate(zip(prompts, frontends)):
        engine.submit(req_cls(rid=i, prompt=p, max_new_tokens=NEW,
                              frontend=to(f)))
    return {o.rid: o for o in engine.run()}


@pytest.mark.parametrize("layout,kv_dtype", [("contiguous", None),
                                             ("paged", None),
                                             ("paged", "int8")])
def test_engine_matches_jax(audio, layout, kv_dtype):
    jm, jp, tm, tp = audio
    kw = dict(num_slots=2, max_seq_len=MAX_LEN, kv_layout=layout,
              kv_block_size=BS, kv_dtype=kv_dtype)
    prompts = _prompts()
    frs = [_frames(tm.cfg, 20 + i) for i in range(len(prompts))]
    ref = _run(JaxEngine(jm, jp, JaxEngineConfig(temperature=0.0, **kw)),
               prompts, frs, JaxRequest, jnp.asarray)
    got = _run(Engine(tm, tp, EngineConfig(**kw), device="cpu"), prompts,
               frs, Request)
    for rid in ref:
        assert len(set(ref[rid].tokens)) > 1, ref[rid].tokens
        assert got[rid].tokens == ref[rid].tokens, rid
        np.testing.assert_allclose(got[rid].logprobs, ref[rid].logprobs,
                                   atol=1e-4 if kv_dtype is None else 2e-3,
                                   rtol=0)


def test_radix_router_and_generate(audio):
    """One prompt under two sets of frames with radix sharing on: no hit,
    nothing registered, different tokens; a router bit for bit with the
    monolithic engine; the static ``generate`` against the JAX one."""
    jm, jp, tm, tp = audio
    cfg = tm.cfg
    prompt = _prompts(1, seed=7)[0]
    frs = [_frames(cfg, 40), _frames(cfg, 41)]
    kw = dict(max_seq_len=MAX_LEN, kv_layout="paged", kv_block_size=BS,
              prefix_share=True)
    eng = Engine(tm, tp, EngineConfig(num_slots=2, **kw), device="cpu")
    outs = _run(eng, [prompt, prompt], frs, Request)
    m = eng.metrics()
    assert (m.prefix_hits, m.prefix_partial_hits, len(eng.radix)) == (0, 0, 0)
    assert outs[0].tokens != outs[1].tokens
    router = DisaggRouter(tm, tp, DisaggConfig(prefill_slots=1,
                                               decode_slots=2, **kw),
                          device="cpu")
    rout = _run(router, [prompt, prompt], frs, Request)
    for rid in outs:
        assert rout[rid].tokens == outs[rid].tokens
        np.testing.assert_array_equal(rout[rid].logprobs,
                                      outs[rid].logprobs)
    batch = np.stack([prompt, prompt])
    got = generate(tm, tp, batch, SamplerConfig(max_new_tokens=NEW,
                                                 temperature=0.0),
                   frontend=np.concatenate(frs))
    ref = jax_generate(jm, jp, jnp.asarray(batch), jax.random.PRNGKey(0),
                       JaxSampler(max_new_tokens=NEW, temperature=0.0),
                       frontend=jnp.asarray(np.concatenate(frs)))
    np.testing.assert_array_equal(got["completions"].numpy(),
                                  np.asarray(ref["completions"]))
    np.testing.assert_allclose(got["behavior_logp"].numpy(),
                               np.asarray(ref["behavior_logp"]), **TOL)
    assert got["completions"][0].tolist() == outs[0].tokens


def test_engine_refusals(audio):
    _, _, tm, tp = audio
    cfg = tm.cfg
    eng = Engine(tm, tp, EngineConfig(num_slots=1, max_seq_len=MAX_LEN),
                 device="cpu")
    prompt = _prompts(1)[0]
    with pytest.raises(ValueError, match="needs frontend"):
        eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=2))
    for fr in (_frames(cfg, 1, S=cfg.max_source_len - 1),
               _frames(cfg, 1, n=2),
               np.zeros((1, cfg.max_source_len, cfg.d_model + 1),
                        np.float32)):
        with pytest.raises(ValueError, match="frontend"):
            eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=2,
                               frontend=fr))
    with pytest.raises(ValueError, match="frame embeddings"):
        tm.prefill(tp, _t(prompt[None]),
                   tm.init_cache(1, MAX_LEN, device="cpu"))
    # the training forward needs the frames as the prefill does; with them
    # its last position's logits are the prefill's
    with pytest.raises(ValueError, match="frame embeddings"):
        tm.forward(tp, _t(prompt[None]))
    fr = _t(_frames(cfg, 3))
    logits, aux = tm.forward(tp, _t(prompt[None]), frontend=fr)
    last, _ = tm.prefill(tp, _t(prompt[None]),
                         tm.init_cache(1, MAX_LEN, device="cpu"), frontend=fr)
    assert logits.shape == (1, len(prompt), cfg.vocab_size)
    assert float(aux) == 0 and torch.isfinite(logits).all()
    np.testing.assert_allclose(logits[:, -1].numpy(), last.numpy(),
                               atol=1e-5, rtol=0)
