"""gemma3-4b (sliding-window layers, 5 local : 1 global), ring decode, the
head-dim-256 kernels' plain versions, and the minitron-8b and qwen2.5-32b
configs, on the port against the JAX package.

On converted reduced weights in float32 (gemma3 reduced: a local layer
windowed at 32 and a global one; head dim 64), on the CPU:

* the three ported configs equal the JAX ones field for field, with equal
  ``param_count()``;
* the forward, and prefill + decode across the window, equal the JAX
  model's within 1e-5 (gemma3, minitron-8b, qwen2.5-32b);
* ``init_cache(ring=True)`` has the JAX shapes (dense: a window-long
  stripe; hybrid: the shared block's stripe cut to 4096), and ring decode
  for 2 x window steps equals the JAX ring decode within 1e-5, every layer
  windowed or the local:global ratio kept, and on zamba2's shared block;
* the plain ``gqa_decode_step(ring=True, window=)`` equals the JAX step at
  and after a wrap;
* the gemma3 engine equals the JAX engine on contiguous, paged and
  paged-int8 with prompts longer than the window: greedy tokens identical,
  logprobs within 1e-4 (int8 2e-3, ROADMAP §3); an exact radix hit is bit
  for bit with the unshared run and a router with the monolithic engine;
* the plain decode, paged and flash versions at D 256 with a window equal
  the JAX kernels in interpret mode (float32 summation order, 1e-5).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as jax_dec  # noqa: E402
from repro.kernels.decode_attention import \
    paged_decode_attention as jax_paged  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as jax_flash  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.attention import \
    gqa_decode_step as jax_gqa_decode_step  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, paged_decode_attention)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import gqa_decode_step  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import (DisaggConfig, DisaggRouter, Engine,  # noqa
                               EngineConfig, Request)

ARCH = "gemma3-4b"
ARCHS = ("gemma3-4b", "minitron-8b", "qwen2.5-32b")
TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reduced JAX model's parameters and their conversion, made once
    per architecture (a JAX init takes seconds on the CPU)."""
    jp = jax.jit(jax_build(arch, reduced=True).init)(jax.random.PRNGKey(1))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _pair(arch, **replace):
    """JAX and port models of the reduced ``arch`` with ``replace``d config
    fields (none of which changes a parameter's shape), on its params."""
    jm = jax_build(arch, reduced=True)
    if replace:
        jm = JaxModel(dataclasses.replace(jm.cfg, **replace))
    tm = Model(dataclasses.replace(build_model(arch, reduced=True).cfg,
                                   **replace))
    return (jm, *_params(arch)[:1], tm, *_params(arch)[1:])


@pytest.fixture(scope="module")
def gemma():
    return _pair(ARCH)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
    ours, ref = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(
        ref.reduced())


@pytest.mark.parametrize("arch,S,P", [(ARCH, 48, 40), ("minitron-8b", 20, 16),
                                      ("qwen2.5-32b", 20, 16)])
def test_forward_and_decode_across_window(arch, S, P):
    """Forward over S positions (gemma3: past its reduced window of 32),
    and prefill of P ids + S - P decode steps, against the JAX model."""
    jm, jp, tm, tp = _pair(arch)
    rs = np.random.RandomState(2)
    B = 2
    tokens = rs.randint(0, tm.cfg.vocab_size, size=(B, S)).astype(np.int32)
    ref, _ = jax.jit(jm.forward)(jp, jnp.asarray(tokens))
    got, _ = tm.forward(tp, _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    jcache = jm.init_cache(B, S)
    tcache = tm.init_cache(B, S, device="cpu")
    jl, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(tokens[:, :P]), jcache)
    tl, tcache = tm.prefill(tp, _t(tokens[:, :P]), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    step = jax.jit(jm.decode_step)
    for t in range(P, S):
        jl, jcache = step(jp, jnp.asarray(tokens[:, t:t + 1]), jcache)
        tl, tcache = tm.decode_step(tp, _t(tokens[:, t:t + 1]), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(tl.numpy(), got[:, t].numpy(), **TOL)


@pytest.mark.parametrize("arch,max_len", [(ARCH, 16), (ARCH, 100),
                                          ("zamba2-2.7b", 24),
                                          ("zamba2-2.7b", 5000)])
@pytest.mark.parametrize("ring", [False, True])
def test_init_cache_shapes_match_jax(arch, max_len, ring):
    jm = jax_build(arch, reduced=True)
    tm = build_model(arch, reduced=True)
    ref = jm.init_cache(2, max_len, ring=ring)
    got = tm.init_cache(2, max_len, ring=ring, device="meta")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    if ring and arch == ARCH and max_len > 32:
        assert got["k"].shape[2] == 32 < max_len      # a window-long ring
    if ring and max_len == 5000:
        assert got["attn_k"].shape[2] == 4096         # the shared block's


@pytest.mark.parametrize("arch,replace,max_len,steps", [
    (ARCH, dict(local_global_ratio=0), 128, 64),   # every layer windowed
    (ARCH, {}, 128, 64),                           # 1 local : 1 global kept
    ("zamba2-2.7b", {}, 8, 20),                    # the shared block's ring
])
def test_ring_decode_matches_jax(arch, replace, max_len, steps):
    """2 x window teacher-forced steps (gemma3's ring of 32 wraps at step
    32; zamba2's of 8 twice) from an empty ring cache against the JAX
    ring decode; gemma3's every-layer-windowed run also against its own
    full cache, which it must equal."""
    jm, jp, tm, tp = _pair(arch, **replace)
    B = 2
    tokens = np.random.RandomState(3).randint(
        0, tm.cfg.vocab_size, size=(B, steps)).astype(np.int32)
    jcache = jm.init_cache(B, max_len, ring=True)
    tcache = tm.init_cache(B, max_len, ring=True, device="cpu")
    full = tm.init_cache(B, max_len, device="cpu")
    every = replace.get("local_global_ratio", 1) == 0
    step = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, ring=True))
    for t in range(steps):
        tok = tokens[:, t:t + 1]
        jl, jcache = step(jp, jnp.asarray(tok), jcache)
        tl, tcache = tm.decode_step(tp, _t(tok), tcache, ring=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        if every:
            fl, full = tm.decode_step(tp, _t(tok), full)
            np.testing.assert_allclose(tl.numpy(), fl.numpy(), **TOL)
    for name in ("k", "v", "attn_k", "attn_v"):
        if name in tcache:
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]), **TOL)


@pytest.mark.parametrize("index", [15, 16, 40])
@pytest.mark.parametrize("window", [None, 12])
def test_plain_ring_step_matches_jax(gemma, index, window):
    """The plain ``gqa_decode_step(ring=True)`` over a 16-slot ring at,
    just after and well after its first wrap, each row at its own index,
    against the JAX step (one row at a time: its index is a scalar)."""
    jm, jp, tm, tp = gemma
    cfg = tm.cfg
    rs = np.random.RandomState(index)
    B, S, hd = 2, 16, cfg.resolved_head_dim
    x = rs.randn(B, 1, cfg.d_model).astype(np.float32)
    k = rs.randn(B, S, cfg.num_kv_heads, hd).astype(np.float32)
    v = rs.randn(B, S, cfg.num_kv_heads, hd).astype(np.float32)
    idx = np.asarray([index, index + 5], np.int32)
    lp_j = jax.tree.map(lambda a: a[0], jp["layers"])["attn"]
    lp_t = tp["layers"][0]["attn"]
    kt, vt = _t(k), _t(v)
    out, kt, vt = gqa_decode_step(lp_t, cfg, _t(x), kt, vt, _t(idx),
                                  window=window, rope_theta=1.0e4,
                                  ring=True)
    step = jax.jit(functools.partial(jax_gqa_decode_step, cfg=jm.cfg,
                                     window=window, rope_theta=1.0e4,
                                     ring=True))
    for b in range(B):
        ro, rk, rv = step(lp_j, x=jnp.asarray(x[b:b + 1]),
                          k_cache=jnp.asarray(k[b:b + 1]),
                          v_cache=jnp.asarray(v[b:b + 1]),
                          index=jnp.asarray(idx[b]))
        np.testing.assert_allclose(out[b:b + 1].numpy(), np.asarray(ro),
                                   **TOL)
        np.testing.assert_allclose(kt[b:b + 1].numpy(), np.asarray(rk),
                                   **TOL)
        np.testing.assert_allclose(vt[b:b + 1].numpy(), np.asarray(rv),
                                   **TOL)


MAX_LEN, BS, NEW = 64, 4, 6


def _prompts(n=3, group=1):
    """Prompts of 35-50 ids: every one longer than the reduced window."""
    rs = np.random.RandomState(5)
    ps = [rs.randint(0, 512, size=int(n_)).astype(np.int32)
          for n_ in rs.randint(35, 51, size=n)]
    return [p for p in ps for _ in range(group)]


def _run(engine, prompts, req_cls):
    for i, p in enumerate(prompts):
        engine.submit(req_cls(rid=i, prompt=p, max_new_tokens=NEW))
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
def test_engine_matches_jax(gemma, layout, kv_dtype):
    jm, jp, tm, tp = gemma
    kw = dict(num_slots=2, max_seq_len=MAX_LEN, kv_layout=layout,
              kv_block_size=BS, kv_dtype=kv_dtype)
    prompts = _prompts()
    ref = _run(JaxEngine(jm, jp, JaxEngineConfig(temperature=0.0, **kw)),
               prompts, JaxRequest)
    got = _run(Engine(tm, tp, EngineConfig(**kw), device="cpu"), prompts,
               Request)
    for rid in ref:
        assert got[rid].tokens == ref[rid].tokens, rid
        np.testing.assert_allclose(got[rid].logprobs, ref[rid].logprobs,
                                   atol=1e-4 if kv_dtype is None else 2e-3,
                                   rtol=0)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_radix_exact_hit_and_router_bit_for_bit(gemma, kv_dtype):
    """GRPO-shaped traffic (2 prompts x group 3) with radix sharing against
    the unshared paged engine, and a 1 + 2 router against a 2-slot
    monolithic engine: tokens and logprobs bit for bit."""
    _, _, tm, tp = gemma
    kw = dict(max_seq_len=MAX_LEN, kv_layout="paged", kv_block_size=BS,
              kv_dtype=kv_dtype)
    prompts = _prompts(2, group=3)
    base = _run(Engine(tm, tp, EngineConfig(num_slots=3, **kw),
                       device="cpu"), prompts, Request)
    eng = Engine(tm, tp, EngineConfig(num_slots=3, prefix_share=True, **kw),
                 device="cpu")
    _same(_run(eng, prompts, Request), base)
    assert (eng.radix.hits, eng.radix.misses) == (4, 2)
    assert eng.metrics().prefix_hits == 4
    mono = _run(Engine(tm, tp, EngineConfig(num_slots=2, **kw),
                       device="cpu"), prompts, Request)
    router = DisaggRouter(tm, tp, DisaggConfig(prefill_slots=1,
                                               decode_slots=2, **kw),
                          device="cpu")
    _same(_run(router, prompts, Request), mono)
    assert router.metrics().transfers == len(prompts)


D = 256


@pytest.mark.parametrize("window", [None, 24])
def test_d256_decode_plain_matches_jax(window):
    rs = np.random.RandomState(6)
    B, S, H, Hkv = 3, 48, 4, 2
    q = rs.randn(B, H, D).astype(np.float32)
    k = rs.randn(B, S, Hkv, D).astype(np.float32)
    v = rs.randn(B, S, Hkv, D).astype(np.float32)
    lengths = np.asarray([5, 30, 48], np.int32)
    got = decode_attention(_t(q), _t(k), _t(v), _t(lengths), window=window)
    ref = jax_dec(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(lengths), window=window, block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_d256_paged_plain_matches_jax(int8):
    from repro.models import kvcache as jkv
    rs = np.random.RandomState(7 + int8)
    bs, Hkv = 8, 2
    lengths = np.asarray([7, 17, 30], np.int32)
    B, MB = len(lengths), 5
    NB = B * MB + 1
    k_pool = rs.randn(NB, bs, Hkv, D).astype(np.float32)
    v_pool = rs.randn(NB, bs, Hkv, D).astype(np.float32)
    tables = np.zeros((B, MB), np.int32)
    ids = rs.permutation(np.arange(1, NB))
    for b, n in enumerate(lengths):
        nb = -(-int(n) // bs)
        tables[b, :nb] = ids[b * MB:b * MB + nb]
    q = rs.randn(B, 4, D).astype(np.float32)
    kw_j, kw_t = {}, {}
    if int8:
        kq, ks = (np.asarray(a) for a in jkv.quantize_kv(k_pool, 2))
        vq, vs = (np.asarray(a) for a in jkv.quantize_kv(v_pool, 2))
        k_pool, v_pool = kq, vq
        kw_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        kw_t = dict(k_scale=_t(ks), v_scale=_t(vs))
    got = paged_decode_attention(_t(q), _t(k_pool), _t(v_pool), _t(tables),
                                 _t(lengths), window=12, **kw_t)
    ref = jax_paged(jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
                    jnp.asarray(tables), jnp.asarray(lengths), window=12,
                    **kw_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("window", [None, 20])
def test_d256_flash_plain_matches_jax(window):
    rs = np.random.RandomState(9)
    B, S, H, Hkv = 1, 64, 4, 2
    q = rs.randn(B, S, H, D).astype(np.float32)
    k = rs.randn(B, S, Hkv, D).astype(np.float32)
    v = rs.randn(B, S, Hkv, D).astype(np.float32)
    got = flash_attention(_t(q), _t(k), _t(v), window=window)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    window=window, block_q=32, block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
