"""deepseek-v2's MLA (the MoE family with multi-head latent attention) on
the port against the JAX package.

On the reduced deepseek-v2 config in float32 (1 dense and 1 MoE layer, 4
experts top 2 with 1 shared, DK 96 = 64 + 32 rope columns, DV 64, r 64)
with ``capacity_factor`` set back to 1.25 in both packages (``reduced()``
sets it to 1e9, where nothing drops) and weights converted from the JAX
init, on the CPU:

* the config equals the JAX one field for field, with equal
  ``param_count()``;
* ``mla_apply_full`` and ``mla_decode_step`` (6 rows at their own
  positions) equal the JAX functions within 1e-5;
* the prefill's logits and cache and teacher-forced decode steps equal
  the JAX model's within 1e-4; ``stack_decode_step`` over 6 rows at
  per-row positions equals the JAX batched step (the JAX ``mla_decode_step``
  vmapped over the rows, each MoE layer routing all 6 together) within
  1e-4, and drops assignments (capacity 4 < 6);
* the engine (8 prompts on 6 slots: slots recycle, and some go dead
  while the last requests decode) equals the JAX engine's default
  ``jnp`` path, whose vmapped batch=1 step routes each slot alone:
  contiguous and paged give identical tokens with logprobs within 1e-4,
  paged-int8 within 2e-3; the port engine's decode drops nothing, while
  the batched routing of the same rows drops;
* flash's plain version at DK 96 / DV 64 equals the JAX
  ``multi_head_attention`` within 1e-5, and so do ``FlashAttentionFn``'s
  gradients at DV != DK the JAX vjp's;
* reduced deepseek-v2 serves through radix, a router and suspend/resume,
  and the training forward runs MLA.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _jax_weights import jax_init  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import mlp_apply as jmlp_apply  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.stacks import _embed_tokens as jembed  # noqa: E402
from repro.models.stacks import _norm as jnorm  # noqa: E402
from repro.models.stacks import _unembed as junembed  # noqa: E402
from repro.rl.rollout import SamplerConfig as JaxSampler  # noqa: E402
from repro.rl.rollout import \
    generate_continuous as jax_generate_continuous  # noqa: E402
from repro.serve import RolloutSpec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttentionFn, flash_attention_plain)
from repro_torch.models import attention, moe, stacks_infer  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.rl import SamplerConfig, generate_continuous  # noqa: E402
from repro_torch.serve import (DisaggConfig, DisaggRouter,  # noqa: E402
                               Engine, EngineConfig, Request)

ARCH = "deepseek-v2-236b"
CF = 1.25                # the capacity factor, restored after reduced()
TOL = dict(atol=1e-4, rtol=0)
N_SLOTS, N_REQ, SP, NEW, BS = 6, 8, 12, 8, 4


def _cfgs(**kw):
    """The reduced float32 deepseek-v2 config of both packages."""
    kw = dict(dtype="float32", capacity_factor=CF) | kw
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


@pytest.fixture(scope="module")
def pair():
    jc, tc = _cfgs()
    jm = JaxModel(jc)
    jp = jax_init(jm, 3)
    return jm, jp, Model(tc), from_jax_params(jax.tree.map(np.asarray, jp))


def _t(a):
    return torch.from_numpy(np.array(a))


def _drops(monkeypatch, batched_rows=None):
    """Count the assignments ``moe_route`` drops (lists the caller reads;
    ``moe_apply`` looks the router up by name): ``"routed"``, calls at the
    config's capacity (prefills, the batched step); ``"per_slot"``, calls
    given a ``capacity`` (the engine's step); and, with ``batched_rows``,
    ``"batched"``: each per-slot call's first ``batched_rows`` rows routed
    again at the config's capacity, as the batched step would."""
    route = moe.moe_route
    seen = {"routed": [], "per_slot": [], "batched": []}

    def counting(p, cfg, xf, capacity=None):
        r = route(p, cfg, xf, capacity)
        kind = "routed" if capacity is None else "per_slot"
        seen[kind].append(int((~r["keep"]).sum()))
        if batched_rows is not None and capacity is not None:
            b = route(p, cfg, xf[:batched_rows])
            seen["batched"].append(int((~b["keep"]).sum()))
        return r
    monkeypatch.setattr(moe, "moe_route", counting)
    return seen


def test_config_matches_jax():
    ours, ref = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count() == 235741306840
    assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(
        ref.reduced())
    jc, tc = _cfgs()
    assert (tc.resolved_head_dim + tc.qk_rope_head_dim,
            tc.resolved_v_head_dim, tc.kv_lora_rank) == (96, 64, 64)
    assert (tc.first_dense_layers, tc.num_layers, tc.num_experts,
            tc.num_experts_per_tok, tc.num_shared_experts) == (1, 2, 4, 2, 1)


@pytest.fixture(scope="module")
def mla_layer(pair):
    """The MoE layer's MLA block of ``pair``'s weights, in both packages."""
    jm, jp, tm, tp = pair
    return (jm.cfg, jax.tree.map(lambda a: a[0], jp["layers"]["attn"]),
            tm.cfg, tp["layers"][0]["attn"])


def test_mla_apply_full_matches_jax(mla_layer):
    jc, jp, tc, tp = mla_layer
    rs = np.random.RandomState(0)
    B, S = 2, 24
    x = rs.randn(B, S, jc.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = jax.jit(jattn.mla_apply_full, static_argnums=1)(
        jp, jc, jnp.asarray(x), jnp.asarray(pos))
    got = attention.mla_apply_full(tp, tc, _t(x), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_mla_decode_step_matches_jax(mla_layer):
    """6 rows at their own positions, one past its stripe (its write
    clamps onto the last position and it attends over the whole stripe):
    each row against the JAX step at its scalar index, caches too."""
    jc, jp, tc, tp = mla_layer
    rs = np.random.RandomState(1)
    S = 16
    index = np.asarray([0, 3, 7, 11, 15, 20], np.int32)
    N = len(index)
    x = rs.randn(N, 1, jc.d_model).astype(np.float32)
    ckv = rs.randn(N, S, jc.kv_lora_rank).astype(np.float32)
    krope = rs.randn(N, S, jc.qk_rope_head_dim).astype(np.float32)
    step = jax.jit(jattn.mla_decode_step, static_argnums=1)
    out, tc_ckv, tc_kr = attention.mla_decode_step(
        tp, tc, _t(x), _t(ckv), _t(krope), _t(index))
    for b in range(N):
        o, c, k = step(jp, jc, jnp.asarray(x[b:b + 1]),
                       jnp.asarray(ckv[b:b + 1]),
                       jnp.asarray(krope[b:b + 1]), int(index[b]))
        np.testing.assert_allclose(out[b:b + 1].numpy(), np.asarray(o),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(tc_ckv[b:b + 1].numpy(), np.asarray(c),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(tc_kr[b:b + 1].numpy(), np.asarray(k),
                                   atol=1e-5, rtol=0)


def test_prefill_and_decode_match_jax(pair):
    """Prefill of P ids, then S - P teacher-forced decode steps (every row
    at one position, the JAX model's own batched step), logits and
    cache."""
    jm, jp, tm, tp = pair
    assert len(tp["dense_layers"]) == 1 and "mlp" in tp["dense_layers"][0]
    assert "shared" in tp["layers"][0]["moe"]
    assert set(tp["layers"][0]["attn"]) == {
        "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b_k", "wkv_b_v",
        "wo"}
    rs = np.random.RandomState(2)
    B, P, S = 2, 20, 26
    tokens = rs.randint(0, tm.cfg.vocab_size, size=(B, S)).astype(np.int32)
    jl, jcache = jax.jit(jm.prefill)(jp, jnp.asarray(tokens[:, :P]),
                                     jm.init_cache(B, S))
    tl, tcache = tm.prefill(tp, _t(tokens[:, :P]),
                            tm.init_cache(B, S, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)
    step = jax.jit(jm.decode_step)
    for t in range(P, S):
        jl, jcache = step(jp, jnp.asarray(tokens[:, t:t + 1]), jcache)
        tl, tcache = tm.decode_step(tp, _t(tokens[:, t:t + 1]), tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tcache["ckv"].numpy(),
                               np.asarray(jcache["ckv"]), **TOL)


def _jax_batched_step(jm, jp, tok, cache, index):
    """The JAX batched step at per-row positions, from the JAX package's
    functions: its ``mla_decode_step`` on each row at its scalar index
    (vmapped), each MoE layer routing all rows together, as
    ``stack_decode_step``'s body does."""
    cfg = jm.cfg
    x = jembed(jp, cfg, tok)
    layers = [jax.tree.map(lambda a: a[i], jp["dense_layers"])
              for i in range(cfg.first_dense_layers)]
    layers += [jax.tree.map(lambda a: a[i], jp["layers"])
               for i in range(cfg.num_layers - cfg.first_dense_layers)]
    row = jax.vmap(lambda p, h, c, k, i: jattn.mla_decode_step(
        p, cfg, h[None], c[None], k[None], i),
        in_axes=(None, 0, 0, 0, 0))
    ckv, krope = [], []
    for li, lp in enumerate(layers):
        h = jnorm(lp["ln1"], x, cfg)
        a, c, k = row(lp["attn"], h, cache["ckv"][li], cache["krope"][li],
                      index)
        x = x + a[:, 0]
        h = jnorm(lp["ln2"], x, cfg)
        f = (jmoe.moe_apply(lp["moe"], cfg, h)[0] if "moe" in lp
             else jmlp_apply(lp["mlp"], h))
        x = x + f
        ckv.append(c[:, 0])
        krope.append(k[:, 0])
    return junembed(jp, cfg, x)[:, 0], jnp.stack(ckv), jnp.stack(krope)


def test_stack_decode_step_per_row_matches_jax_batched(pair, monkeypatch):
    """``stack_decode_step`` over 6 rows at seeded positions with seeded
    caches that share a direction (one row past its stripe), all fed one
    token, against the JAX batched step: logits and caches within 1e-4;
    the MoE layer routes the 6 rows together (capacity 4) and drops."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rs = np.random.RandomState(4)
    S, L = 24, cfg.num_layers
    index = np.asarray([2, 5, 9, 14, 23, 30], np.int32)
    N = len(index)
    # caches whose positions share a direction, and one token for every
    # row: the rows' hidden states share it too, so they pick the same
    # experts and overflow them
    ckv = (rs.randn(cfg.kv_lora_rank)
           + 0.1 * rs.randn(L, N, S, cfg.kv_lora_rank)).astype(np.float32)
    krope = rs.randn(L, N, S, cfg.qk_rope_head_dim).astype(np.float32)
    tok = np.full((N, 1), rs.randint(0, cfg.vocab_size), np.int32)
    jl, jckv, jkr = jax.jit(_jax_batched_step, static_argnums=0)(
        jm, jp, jnp.asarray(tok), {"ckv": jnp.asarray(ckv),
                                   "krope": jnp.asarray(krope)},
        jnp.asarray(index))
    seen = _drops(monkeypatch)
    tcache = {"ckv": _t(ckv), "krope": _t(krope), "index": _t(index)}
    tl, tcache = stacks_infer.stack_decode_step(tp, cfg, _t(tok), tcache)
    assert moe.capacity_for(cfg, N) == 4, moe.capacity_for(cfg, N)
    assert sum(seen["routed"]) > 0 and not seen["per_slot"], seen
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tcache["ckv"].numpy(), np.asarray(jckv),
                               **TOL)
    np.testing.assert_allclose(tcache["krope"].numpy(), np.asarray(jkr),
                               **TOL)
    np.testing.assert_array_equal(tcache["index"].numpy(), index + 1)


def _prompts():
    rs = np.random.RandomState(0)
    return rs.randint(0, 512, size=(N_REQ, SP)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_runs(pair):
    """The JAX engine's default (``jnp``) runs, by layout, made on first
    use."""
    jm, jp, _, _ = pair
    runs = {}

    def get(layout, kv_dtype):
        key = (layout, kv_dtype)
        if key not in runs:
            runs[key] = jax.tree.map(np.asarray, jax_generate_continuous(
                jm, jp, _prompts(), jax.random.PRNGKey(0),
                JaxSampler(max_new_tokens=NEW, temperature=0.0),
                spec=RolloutSpec(num_slots=N_SLOTS, kv_layout=layout,
                                 kv_block_size=BS, kv_dtype=kv_dtype)))
        return runs[key]
    return get


@pytest.mark.parametrize("layout,kv_dtype", [("contiguous", None),
                                             ("paged", None),
                                             ("paged", "int8")])
def test_engine_matches_jax_jnp(pair, jax_runs, layout, kv_dtype,
                                monkeypatch):
    _, _, tm, tp = pair
    ref = jax_runs(layout, kv_dtype)
    seen = _drops(monkeypatch, batched_rows=N_SLOTS)
    got = generate_continuous(
        tm, tp, _prompts(), SamplerConfig(max_new_tokens=NEW),
        num_slots=N_SLOTS, kv_layout=layout, kv_block_size=BS,
        kv_dtype=kv_dtype, device="cpu")
    # every decode step routed per slot and dropped nothing; the batched
    # routing of the same rows (capacity 4 of 6) drops
    assert seen["per_slot"] and sum(seen["per_slot"]) == 0, seen
    assert sum(seen["batched"]) > 0, seen
    np.testing.assert_array_equal(got["completions"].numpy(),
                                  ref["completions"])
    np.testing.assert_array_equal(got["mask"].numpy(), ref["mask"])
    np.testing.assert_allclose(got["behavior_logp"].numpy(),
                               ref["behavior_logp"],
                               atol=1e-4 if kv_dtype is None else 2e-3,
                               rtol=0)
    stats = got["engine_stats"]
    assert stats.prefills == N_REQ and stats.peak_active == N_SLOTS


def test_flash_plain_mla_dims_match_jax():
    """Flash's plain version at DK 96 / DV 64 (the reduced MLA prefill's)
    against the JAX ``multi_head_attention`` at the reference's scale, and
    ``FlashAttentionFn``'s gradients at DV != DK against the JAX vjp, all
    within 1e-5."""
    rs = np.random.RandomState(5)
    B, S, H = 2, 40, 4
    q = rs.randn(B, S, H, 96).astype(np.float32)
    k = rs.randn(B, S, H, 96).astype(np.float32)
    v = rs.randn(B, S, H, 64).astype(np.float32)
    pos = jnp.arange(S)
    want = jax.jit(lambda q, k, v: jattn.multi_head_attention(
        q, k, v, pos, pos, causal=True, scale=96 ** -0.5))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = flash_attention_plain(_t(q), _t(k), _t(v))
    assert got.shape == (B, S, H, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    dout = rs.randn(B, S, H, 64).astype(np.float32)
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out = FlashAttentionFn.apply(*leaves, True, None)
    got = torch.autograd.grad(out, leaves, _t(dout))
    _, vjp = jax.vjp(lambda q, k, v: jattn.multi_head_attention(
        q, k, v, pos, pos, causal=True, scale=96 ** -0.5),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, w in zip(got, vjp(jnp.asarray(dout))):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def _serve(engine, prompts):
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=NEW))
    return {o.rid: o for o in engine.run()}


@pytest.mark.parametrize("mode", ["radix", "router", "suspend"])
def test_reduced_deepseek_serves_radix_router_suspend(pair, mode):
    """Radix serves (its suffix prefills route other rows than a full
    prefill, so it keeps no bit identity for the MoE family); a 1 + 2
    router and a request suspended after 3 steps and resumed equal the
    monolithic engine bit for bit (the engine routes each slot alone)."""
    _, _, tm, tp = pair
    prompts = [p for p in _prompts()[:3]]
    prompts[1] = np.concatenate([prompts[0][:8], prompts[1][:6]])
    kw = dict(max_seq_len=32, kv_layout="paged", kv_block_size=BS)
    ref = _serve(Engine(tm, tp, EngineConfig(num_slots=2, **kw),
                        device="cpu"), prompts)
    if mode == "radix":
        eng = Engine(tm, tp, EngineConfig(num_slots=2, prefix_share=True,
                                          **kw), device="cpu")
        outs = _serve(eng, prompts)
        assert eng.metrics().prefix_partial_hits >= 1
        assert all(o.num_tokens == NEW for o in outs.values())
        return
    if mode == "router":
        outs = _serve(DisaggRouter(tm, tp, DisaggConfig(
            prefill_slots=1, decode_slots=2, **kw), device="cpu"), prompts)
    else:
        eng = Engine(tm, tp, EngineConfig(num_slots=2, **kw), device="cpu")
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=NEW))
        for _ in range(3):
            eng.step()
        sreq = eng.suspend(0)
        outs = {o.rid: o for o in eng.run()}
        eng.resume(sreq, (), continue_output=True)
        outs |= {o.rid: o for o in eng.run()}
        eng.slots.check()
    assert sorted(outs) == sorted(ref)
    for rid, o in outs.items():
        assert o.tokens == ref[rid].tokens, rid
        np.testing.assert_array_equal(o.logprobs, ref[rid].logprobs)


def test_training_forward_runs_mla(pair):
    """The training forward runs MLA (through flash's Dv != D path):
    finite logits, the MoE layer's aux loss, and (all rows routed together
    in both) the prefill's last logits."""
    _, _, tm, tp = pair
    tokens = torch.arange(1, 5, dtype=torch.int32)[None]
    logits, aux = tm.forward(tp, tokens)
    last, _ = tm.prefill(tp, tokens, tm.init_cache(1, 8, device="cpu"))
    assert logits.shape == (1, 4, tm.cfg.vocab_size)
    assert torch.isfinite(logits).all() and float(aux) > 0
    np.testing.assert_allclose(logits[:, -1].numpy(), last.numpy(),
                               atol=1e-5, rtol=0)
