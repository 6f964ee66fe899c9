"""qwen2-vl-7b (the vlm family: M-RoPE, QKV biases, the vision-embedding
overlay) on the port against the JAX package.

On converted reduced weights in float32 (28/4 heads cut to 4/1, head dim
64, 16 frontend positions on a 4 x 4 grid), every QKV bias and norm
weight set to seeded non-zero values (the inits make them 0), seeded
random frontends, on the CPU:

* the config equals the JAX one field for field, with equal
  ``param_count()``;
* ``apply_mrope``, ``default_mrope_positions`` and the decode step's
  per-slot ids equal the JAX functions (exactly for the ids, 1e-6 for
  the rotation);
* ``stack_prefill`` with and without a frontend, then ``stack_decode_step``
  across the text positions, equal the JAX model within 1e-4 (a frontend
  moves the logits); ``stack_kernel_decode_step`` at per-slot positions
  inside and past the image grid equals the JAX kernel step in interpret
  mode, contiguous and paged;
* the engine equals the JAX engine on contiguous, paged and paged-int8 KV
  with a frontend per request: greedy tokens identical (the reference's
  not one repeated token), logprobs within 1e-4.  int8: the two packages'
  pools after the first admission differ only where a value sits on a
  quantizer rounding boundary (one int8 step, a handful of entries: their
  float32 K/V differ in the last bits, ROADMAP §3), and logprobs are held
  within INT8_TOL (5e-3: with the QKV biases the boundary cases move
  them by up to 3e-3 here, where the bias-free models stay within 2e-3);
* requests that share a prompt but not a frontend never share a radix
  prefix, through the engine and through a router, and each equals the
  static ``generate`` with its frontend, which equals the JAX ``generate``;
* suspend and resume of a frontend request is bit for bit with the
  uninterrupted run on paged KV;
* the engine refuses a frontend longer than the prompt, of another width,
  or on a text model.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import stacks_infer as jinfer  # noqa: E402
from repro.rl import SamplerConfig as JaxSampler  # noqa: E402
from repro.rl import generate as jax_generate  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import stacks_infer  # noqa: E402
from repro_torch.rl.rollout import SamplerConfig, generate  # noqa: E402
from repro_torch.serve import (DisaggConfig, DisaggRouter, Engine,  # noqa
                               EngineConfig, Request)

ARCH = "qwen2-vl-7b"
TOL = dict(atol=1e-4, rtol=0)
INT8_TOL = 5e-3
MAX_LEN, BS, NEW = 64, 4, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def perturb(tree, seed):
    """The JAX params with every bias (``b*``) and norm weight set to
    seeded values: ``0.1 * N(0, 1)`` for biases and RMSNorm weights,
    ``1 + 0.1 * N(0, 1)`` for a LayerNorm's ``w``."""
    rs = np.random.RandomState(seed)

    def leaf(path, a):
        keys = [getattr(k, "key", None) for k in path]
        name = keys[-1]
        a = np.asarray(a)
        if name in ("bq", "bk", "bv", "bi", "bo", "b") or \
                name in ("ln", "ln1", "ln2", "final_norm"):
            return jnp.asarray((0.1 * rs.randn(*a.shape)).astype(a.dtype))
        if name == "w" and keys[-2] in ("ln", "ln1", "ln2", "final_norm"):
            return jnp.asarray((1 + 0.1 * rs.randn(*a.shape)).astype(
                a.dtype))
        return jnp.asarray(a)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def vlm():
    jm = jax_build(ARCH, reduced=True)
    jp = perturb(jax.jit(jm.init)(jax.random.PRNGKey(1)), 11)
    tm = build_model(ARCH, reduced=True)
    return jm, jp, tm, from_jax_params(jax.tree.map(np.asarray, jp))


def _frontend(cfg, seed, n=1, F=None):
    rs = np.random.RandomState(seed)
    F = cfg.num_frontend_tokens if F is None else F
    return rs.randn(n, F, cfg.d_model).astype(np.float32)


def _prompts(n=3, seed=5):
    """Prompts of 20-40 ids: every one longer than the 16 frontend
    positions, so that text follows the image grid."""
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 512, size=int(k)).astype(np.int32)
            for k in rs.randint(20, 41, size=n)]


def test_config_matches_jax():
    ours, ref = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count() == 7615483904
    assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(
        ref.reduced())


@pytest.mark.parametrize("half", [32, 64])
@pytest.mark.parametrize("F", [16, 256, 0])
def test_mrope_matches_jax(half, F):
    rs = np.random.RandomState(half + F)
    B, S, H = 2, 40, 3
    assert common.mrope_sections(half) == jcommon.mrope_sections(half)
    pos = common.default_mrope_positions(B, S, F)
    ref = np.asarray(jcommon.default_mrope_positions(B, S, F))
    np.testing.assert_array_equal(pos.numpy(), ref)
    x = rs.randn(B, S, H, 2 * half).astype(np.float32)
    got = common.apply_mrope(_t(x), pos, 1.0e6)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(ref), 1.0e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    # the decode steps' per-slot ids are the prefill's at their positions
    idx = np.asarray([0, 5, 15, 16, 17, 39], np.int32)
    at = common.mrope_positions_at(_t(idx), F).numpy()
    np.testing.assert_array_equal(at, ref[:, 0, idx])


@pytest.mark.parametrize("with_frontend", [True, False])
def test_prefill_and_decode_match_jax(vlm, with_frontend):
    """Prefill of P ids (with the first 16 overlaid by a frontend, or
    none) and S - P teacher-forced decode steps against the JAX model."""
    jm, jp, tm, tp = vlm
    cfg = tm.cfg
    rs = np.random.RandomState(2)
    B, P, S = 2, 24, 32
    tokens = rs.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    fr = _frontend(cfg, 3, B) if with_frontend else None
    jcache, tcache = jm.init_cache(B, S), tm.init_cache(B, S, device="cpu")
    jl, jcache = jax.jit(jm.prefill)(
        jp, jnp.asarray(tokens[:, :P]), jcache,
        frontend=None if fr is None else jnp.asarray(fr))
    tl, tcache = tm.prefill(tp, _t(tokens[:, :P]), tcache,
                            frontend=None if fr is None else _t(fr))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    if with_frontend:
        plain, _ = tm.prefill(tp, _t(tokens[:, :P]),
                              tm.init_cache(B, S, device="cpu"))
        assert np.abs(plain.numpy() - tl.numpy()).max() > 1e-2
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)
    step = jax.jit(jm.decode_step)
    for t in range(P, S):
        jl, jcache = step(jp, jnp.asarray(tokens[:, t:t + 1]), jcache)
        tl, tcache = tm.decode_step(tp, _t(tokens[:, t:t + 1]), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("paged", [False, True])
def test_kernel_decode_step_matches_jax_interpret(vlm, paged):
    """One batched kernel step over a pool whose slots sit at positions
    inside the image grid, at its edge and past it (seeded random K/V),
    against the JAX kernel step with the Pallas kernels in interpret
    mode."""
    jm, jp, tm, tp = vlm
    cfg = tm.cfg
    rs = np.random.RandomState(4)
    index = np.asarray([3, 15, 16, 30], np.int32)
    N, S, L = len(index), 32, cfg.num_layers
    shape = (L, N, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    k = rs.randn(*shape).astype(np.float32)
    v = rs.randn(*shape).astype(np.float32)
    tables = None
    if paged:
        MB = S // BS
        ids = rs.permutation(np.arange(1, N * MB + 1)).reshape(N, MB)
        tables = ids.astype(np.int32)
        pool = np.zeros((L, N * MB + 1, BS) + shape[3:], np.float32)
        vpool = np.zeros_like(pool)
        for b in range(N):
            pool[:, tables[b]] = k[:, b].reshape(L, MB, BS, *shape[3:])
            vpool[:, tables[b]] = v[:, b].reshape(L, MB, BS, *shape[3:])
        k, v = pool, vpool
    tok = rs.randint(0, cfg.vocab_size, size=(N, 1)).astype(np.int32)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v),
          "index": jnp.asarray(index)}
    tc = {"k": _t(k), "v": _t(v), "index": _t(index)}
    jl, jc = jinfer.stack_kernel_decode_step(
        jp, jm.cfg, jnp.asarray(tok), jc,
        tables=None if tables is None else jnp.asarray(tables),
        interpret=True)
    tl, tc = stacks_infer.stack_kernel_decode_step(
        tp, cfg, _t(tok), tc, tables=None if tables is None else _t(tables))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_array_equal(tc["index"].numpy(), index + 1)


def _run(engine, prompts, frontends, req_cls, to=np.asarray):
    for i, (p, f) in enumerate(zip(prompts, frontends)):
        engine.submit(req_cls(rid=i, prompt=p, max_new_tokens=NEW,
                              frontend=None if f is None else to(f)))
    return {o.rid: o for o in engine.run()}


def _same(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        assert a[rid].tokens == b[rid].tokens, rid
        np.testing.assert_array_equal(np.asarray(a[rid].logprobs),
                                      np.asarray(b[rid].logprobs))


@pytest.mark.parametrize("layout,kv_dtype", [("contiguous", None),
                                             ("paged", None),
                                             ("paged", "int8")])
def test_engine_matches_jax(vlm, layout, kv_dtype):
    jm, jp, tm, tp = vlm
    kw = dict(num_slots=2, max_seq_len=MAX_LEN, kv_layout=layout,
              kv_block_size=BS, kv_dtype=kv_dtype)
    prompts = _prompts()
    frs = [_frontend(tm.cfg, 20 + i) for i in range(len(prompts))]
    jeng = JaxEngine(jm, jp, JaxEngineConfig(temperature=0.0, **kw))
    teng = Engine(tm, tp, EngineConfig(**kw), device="cpu")
    ref = _run(jeng, prompts, frs, JaxRequest, jnp.asarray)
    got = _run(teng, prompts, frs, Request)
    for rid in ref:
        assert len(set(ref[rid].tokens)) > 1, ref[rid].tokens
        assert got[rid].tokens == ref[rid].tokens, rid
        np.testing.assert_allclose(got[rid].logprobs, ref[rid].logprobs,
                                   atol=1e-4 if kv_dtype is None
                                   else INT8_TOL, rtol=0)
    if kv_dtype == "int8":
        assert_boundary_only(jm, jp, tm, tp, kw, prompts[0], frs[0])


def assert_boundary_only(jm, jp, tm, tp, kw, prompt, fr):
    """One request admitted into each package's int8 pool: the pools'
    entries equal but for a few one-step quantizer boundary cases, and
    their scales within float32 noise of each other (1e-4 of the
    largest)."""
    pools = []
    for eng, cls, to in ((JaxEngine(jm, jp, JaxEngineConfig(
            temperature=0.0, **kw)), JaxRequest, jnp.asarray),
            (Engine(tm, tp, EngineConfig(**kw), device="cpu"), Request,
             np.asarray)):
        eng.submit(cls(rid=0, prompt=prompt, max_new_tokens=1,
                       frontend=to(fr)))
        eng.step()
        pools.append({n: np.asarray(eng.slots.cache[n]) for n in
                      ("k", "v", "k_scale", "v_scale")})
    for name in ("k", "v"):
        d = pools[0][name].astype(int) - pools[1][name].astype(int)
        assert np.abs(d).max() <= 1 and (d != 0).mean() < 0.01, name
        ref = pools[0][name + "_scale"]
        np.testing.assert_allclose(pools[1][name + "_scale"], ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())


def test_frontend_requests_never_share(vlm):
    """The JAX test of the same name on the port, plus a router: one
    prompt under two frontends, radix sharing on; no hit, nothing
    registered, and each request's tokens are the static ``generate``'s
    with its frontend (the port's equal to the JAX one's), which differ."""
    jm, jp, tm, tp = vlm
    cfg = tm.cfg
    prompt = _prompts(1, seed=7)[0]
    frs = [np.zeros((1, cfg.num_frontend_tokens, cfg.d_model), np.float32),
           np.ones((1, cfg.num_frontend_tokens, cfg.d_model), np.float32)]
    kw = dict(max_seq_len=MAX_LEN, kv_layout="paged", kv_block_size=BS,
              prefix_share=True)
    eng = Engine(tm, tp, EngineConfig(num_slots=2, **kw), device="cpu")
    outs = _run(eng, [prompt, prompt], frs, Request)
    m = eng.metrics()
    assert (m.prefix_hits, m.prefix_partial_hits, m.prefix_misses) == \
        (0, 0, 0)
    assert len(eng.radix) == 0 and eng.radix.stats["entries"] == 0
    router = DisaggRouter(tm, tp, DisaggConfig(prefill_slots=1,
                                               decode_slots=2, **kw),
                          device="cpu")
    _same(_run(router, [prompt, prompt], frs, Request), outs)
    assert router.metrics().prefix_hits == 0
    assert all(len(pe.radix) == 0 for pe in router.prefills)
    sampler = SamplerConfig(max_new_tokens=NEW, temperature=0.0)
    for rid, fr in enumerate(frs):
        got = generate(tm, tp, prompt[None], sampler, frontend=fr)
        ref = jax_generate(jm, jp, jnp.asarray(prompt)[None],
                           jax.random.PRNGKey(0),
                           JaxSampler(max_new_tokens=NEW, temperature=0.0),
                           frontend=jnp.asarray(fr))
        want = np.asarray(ref["completions"])[0].tolist()
        assert got["completions"][0].tolist() == want
        np.testing.assert_allclose(got["behavior_logp"][0].numpy(),
                                   np.asarray(ref["behavior_logp"])[0],
                                   **TOL)
        n = int(np.asarray(ref["mask"])[0].sum())
        assert outs[rid].tokens[:n] == want[:n], rid
    assert outs[0].tokens != outs[1].tokens


def test_suspend_resume_bit_for_bit(vlm):
    """A frontend request suspended after 3 decode steps and resumed (its
    slot's KV pinned) ends where its uninterrupted run does."""
    _, _, tm, tp = vlm
    cfg = EngineConfig(num_slots=2, max_seq_len=MAX_LEN, kv_layout="paged",
                       kv_block_size=BS)
    prompt, fr = _prompts(1)[0], _frontend(tm.cfg, 30)
    ref = _run(Engine(tm, tp, cfg, device="cpu"), [prompt], [fr],
               Request)[0]
    eng = Engine(tm, tp, cfg, device="cpu")
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=NEW,
                       frontend=fr))
    for _ in range(3):
        eng.step()
    sreq = eng.suspend(0)
    assert sreq.req.frontend is fr
    eng.resume(sreq, (), continue_output=True)
    [out] = eng.run()
    assert out.tokens == ref.tokens
    np.testing.assert_array_equal(out.logprobs, ref.logprobs)
    eng.slots.check()


def test_engine_refusals(vlm):
    _, _, tm, tp = vlm
    cfg = tm.cfg
    eng = Engine(tm, tp, EngineConfig(num_slots=1, max_seq_len=MAX_LEN),
                 device="cpu")
    prompt = _prompts(1)[0]
    for fr in (_frontend(cfg, 1, F=len(prompt) + 1),
               np.zeros((1, 4, cfg.d_model + 1), np.float32),
               np.zeros((2, 4, cfg.d_model), np.float32)):
        with pytest.raises(ValueError, match="frontend"):
            eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=2,
                               frontend=fr))
    # a shorter frontend and none at all are served
    assert eng.submit(Request(rid=1, prompt=prompt, max_new_tokens=2,
                              frontend=_frontend(cfg, 1, F=4)))
    assert eng.submit(Request(rid=2, prompt=prompt, max_new_tokens=2))
    assert len(eng.run()) == 2
    text = build_model("internlm2-1.8b", reduced=True)
    tparams = text.init(torch.Generator().manual_seed(0))
    teng = Engine(text, tparams, EngineConfig(num_slots=1,
                                              max_seq_len=MAX_LEN),
                  device="cpu")
    with pytest.raises(ValueError, match="no frontend"):
        teng.submit(Request(rid=0, prompt=prompt, max_new_tokens=2,
                            frontend=np.zeros((1, 4, 256), np.float32)))
    with pytest.raises(ValueError, match="longer than the prompt"):
        tm.prefill(tp, _t(prompt[None, :8]),
                   tm.init_cache(1, MAX_LEN, device="cpu"),
                   frontend=_t(_frontend(cfg, 1, F=9)))
