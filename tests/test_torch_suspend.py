"""Suspend/resume on the port against the JAX engine's.

The port's ``Engine`` (plain kernel versions on the CPU) and the JAX
package's (jnp backend) on converted reduced-internlm2 weights, float32:

* a request suspended at a stop token and resumed with no tool tokens
  continues as the uninterrupted run does, on contiguous, paged and
  paged-int8 KV at ``block_size`` 1 and 4, with the stop at a block's last
  step (boundary logits carried) and inside a block (the boundary logits
  replayed).  Between the suspension and the resume another request is
  served in the freed slot and blocks, so a handle that kept views of the
  pool instead of copies would resume from that request's KV.  Tokens are
  the JAX engine's; logprobs within 1e-4 of its; on int8 no further from
  them than the uninterrupted runs already are (the packages' int8 pools
  differ by a quantizer step where a value sits on a rounding boundary,
  ROADMAP's faults) plus 2e-3.  Against the port's own uninterrupted run:
  bit for bit where the logits were carried on float pools, within 1e-5
  where the boundary was replayed at batch 1 and on int8 (the JAX
  package's own int8 contract: the dequantized tail quantized again moves
  a scale by an ulp);
* tool tokens injected at resume give the JAX engine's tokens (logprobs
  at 1e-4 on float pools) and, on float pools, what a fresh request on the
  continued prompt gives (1e-5);
* dropped handles restore block conservation;
* ``reset(carry_live=True)`` across a weight swap gives the JAX engine's
  tokens and ``token_versions``; ``generate_continuous_stream(
  sync_params=...)`` the JAX generator's;
* ``export_state``/``import_state`` with suspended handles continue token
  for token, contiguous and paged int8;
* rwkv6 and zamba2 suspend at ``block_size`` 1 and are refused above it.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402
from _jax_weights import jax_init  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.rl import SamplerConfig as JaxSampler  # noqa: E402
from repro.rl.rollout import \
    generate_continuous_stream as jax_stream  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import RolloutSpec  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.data import tokenizer as tok  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.rl import SamplerConfig  # noqa: E402
from repro_torch.rl.rollout import generate_continuous_stream  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, Request  # noqa: E402

ARCH = "internlm2-1.8b"
MAX_NEW, MAX_LEN = 12, 40
LAYOUTS = [("contiguous", None), ("paged", None), ("paged", "int8")]


def _pair(jm, seed=1):
    jp = jax_init(jm, seed)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(ARCH, reduced=True)
    jp, tp = _pair(jm)
    return jm, jp, build_model(ARCH, reduced=True), tp


@pytest.fixture(scope="module")
def params7(pair):
    """The second weights (seed 7) that the weight-sync tests swap in."""
    return _pair(pair[0], seed=7)


@pytest.fixture(scope="module")
def uninterrupted(pair):
    """Each package's uninterrupted run of the default request, by
    (layout, int8, block size), made on first use: ``(jax, port)``, each
    ``(tokens, logprobs)``."""
    runs = {}

    def get(kv, kv_dtype, block_size=1):
        key = (kv, kv_dtype, block_size)
        if key not in runs:
            runs[key] = tuple(_uninterrupted(e, c) for e, c in zip(
                _engines(pair, kv, kv_dtype, block_size),
                (JaxRequest, Request)))
        return runs[key]
    return get


def _prompt(seed=0, n=7):
    return np.random.RandomState(seed).randint(0, 256, size=n).astype(
        np.int32)


def _engines(pair, kv, kv_dtype, block_size=1, num_slots=2, params=None):
    jm, jp, tm, tp = pair
    kw = dict(num_slots=num_slots, max_seq_len=MAX_LEN, temperature=0.0,
              kv_layout=kv, kv_block_size=4, kv_dtype=kv_dtype,
              block_size=block_size)
    jp, tp = params or (jp, tp)
    return (JaxEngine(jm, jp, JaxEngineConfig(**kw)),
            Engine(tm, tp, EngineConfig(**kw), device="cpu"))


def _req(cls, rid=0, stop=(), prompt=None, max_new=MAX_NEW):
    return cls(rid=rid, prompt=_prompt() if prompt is None else prompt,
               max_new_tokens=max_new, stop_tokens=stop)


def _uninterrupted(eng, cls):
    eng.submit(_req(cls))
    [out] = eng.run()
    return out.tokens, np.asarray(out.logprobs, np.float32)


def _stop_index(tokens, block_size, at_block_end):
    """The first position whose token is new there, with a token after it,
    at (or off) the end of a decode block."""
    for j in range(1, len(tokens) - 1):
        if tokens[j] in tokens[:j] or tokens[j] == tok.EOS:
            continue
        if ((j + 1) % block_size == 0) == at_block_end:
            return j
    raise AssertionError(f"no usable stop position in {tokens}")


def _suspend_serve_other_resume(eng, cls, stop):
    """Suspend at ``stop``, serve another request in the freed slot and
    blocks, then resume the handle with no tool tokens; returns the
    handle and the tokens and logprobs of both turns."""
    eng.submit(_req(cls, stop=(stop,)))
    eng.run()
    [sreq] = eng.harvest_suspended()
    assert sreq.out.finish_reason == "stop" and sreq.out.tokens[-1] == stop
    eng.submit(_req(cls, rid=5, prompt=_prompt(3, 9), max_new=6))
    eng.run()
    eng.harvest()
    n0 = len(sreq.out.tokens)
    eng.resume(sreq, (), max_new_tokens=MAX_NEW - n0, rid=1, stop_tokens=())
    [out] = [o for o in eng.run() if o.rid == 1]
    return (sreq, sreq.out.tokens + out.tokens,
            np.asarray(list(sreq.out.logprobs) + list(out.logprobs),
                       np.float32))


@pytest.mark.parametrize("kv,kv_dtype", LAYOUTS)
@pytest.mark.parametrize("block_size,at_end", [(1, True), (4, True),
                                               (4, False)])
def test_resume_matches_uninterrupted(pair, uninterrupted, kv, kv_dtype,
                                      block_size, at_end):
    jref, tref = uninterrupted(kv, kv_dtype, block_size)
    assert tref[0] == jref[0]
    stop = jref[0][_stop_index(jref[0], block_size, at_end)]
    jeng, teng = _engines(pair, kv, kv_dtype, block_size)
    jh, jtoks, jlp = _suspend_serve_other_resume(jeng, JaxRequest, stop)
    th, ttoks, tlp = _suspend_serve_other_resume(teng, Request, stop)
    assert jtoks == jref[0]                 # the reference's own contract
    assert th.logits_valid == jh.logits_valid == at_end
    assert (th.index, th.remaining, th.block_ids) == (
        jh.index, jh.remaining, jh.block_ids)
    assert ttoks == jtoks == tref[0]
    int8 = kv_dtype == "int8"
    if int8:
        # the packages' int8 pools already differ uninterrupted (ROADMAP,
        # faults: a value on a quantizer rounding boundary lands one step
        # apart; 3.7e-3 on this prompt): suspension adds at most 2e-3
        drift = np.abs(tref[1] - jref[1])
        assert (np.abs(tlp - jlp) <= drift + 2e-3).all(), (tlp, jlp, drift)
        np.testing.assert_allclose(tlp, tref[1], atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(tlp, jlp, atol=1e-4, rtol=0)
        if at_end:
            np.testing.assert_array_equal(tlp, tref[1])    # carried: copies
        else:
            np.testing.assert_allclose(tlp, tref[1], atol=1e-5, rtol=0)
    if kv == "paged":
        teng.slots.check()
        teng.slots.alloc.assert_clean(context="after resume")


@pytest.mark.parametrize("kv,kv_dtype", LAYOUTS)
def test_resume_with_tool_tokens_matches_prompt_continuation(
        pair, uninterrupted, kv, kv_dtype):
    """Resuming with tool tokens injected equals a fresh request on the
    prompt, the turn and the tool tokens (float layouts), and the JAX
    engine's resume."""
    tool = np.asarray([7, 11, 13, 2, 250], np.int32)
    jref, _ = uninterrupted(kv, kv_dtype)[0]
    stop = jref[_stop_index(jref, 1, True)]
    outs = []
    for eng, cls in zip(_engines(pair, kv, kv_dtype), (JaxRequest, Request)):
        eng.submit(_req(cls, stop=(stop,)))
        eng.run()
        [sreq] = eng.harvest_suspended()
        eng.resume(sreq, tool, max_new_tokens=6, rid=1, stop_tokens=())
        [out] = [o for o in eng.run() if o.rid == 1]
        outs.append((sreq.out.tokens, out))
    (jturn, jout), (tturn, tout) = outs
    assert tturn == jturn and tout.tokens == jout.tokens
    if kv_dtype is None:
        np.testing.assert_allclose(tout.logprobs, jout.logprobs, atol=1e-4,
                                   rtol=0)
        cont = np.concatenate([_prompt(), np.asarray(tturn, np.int32),
                               tool])
        fresh = _engines(pair, kv, kv_dtype)[1]
        fresh.submit(Request(rid=0, prompt=cont, max_new_tokens=6))
        [ref] = fresh.run()
        assert tout.tokens == ref.tokens
        np.testing.assert_allclose(tout.logprobs, ref.logprobs, atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_dropped_handle_restores_block_conservation(pair, uninterrupted,
                                                   kv_dtype):
    _, teng = _engines(pair, "paged", kv_dtype)
    ref, _ = uninterrupted("paged", kv_dtype)[1]
    stop = ref[_stop_index(ref, 1, True)]
    teng.submit(_req(Request, rid=0, stop=(stop,)))
    teng.submit(_req(Request, rid=1, stop=(stop,), prompt=_prompt(2, 5)))
    teng.run()
    handles = teng.harvest_suspended()
    assert handles and teng.metrics().suspended == len(handles)
    pins = [b for h in handles for b in h.block_ids]
    assert pins
    teng.slots.check(extra_pins=pins)
    alloc = teng.slots.alloc
    live = alloc.num_live
    with pytest.raises(RuntimeError, match="suspended"):
        teng.reset()                        # handles still pin the pool
    for h in handles:
        h.release()
        h.release()                         # idempotent
    assert alloc.num_live < live
    assert alloc.num_free + alloc.num_live == alloc.num_blocks
    teng.slots.check()
    alloc.assert_clean(context="dropped suspended handles")
    with pytest.raises(RuntimeError, match="released"):
        teng.resume(handles[0])
    teng.reset()


@pytest.mark.parametrize("kv,kv_dtype", [("contiguous", None),
                                         ("paged", None)])
def test_carry_live_across_weight_sync(pair, params7, uninterrupted, kv,
                                      kv_dtype):
    """``reset(params2, carry_live=True)`` mid-generation: the JAX
    engine's tokens, logprobs and ``token_versions``; the tokens before
    the swap the old weights' run bit for bit; deterministic."""
    jp2, tp2 = params7
    tref = uninterrupted(kv, kv_dtype)[1]

    def carry(eng, cls, new_params):
        eng.submit(_req(cls))
        for _ in range(4):
            eng.step()
        eng.reset(new_params, carry_live=True)
        [out] = eng.run()
        return out
    jeng, teng = _engines(pair, kv, kv_dtype)
    jout, tout = carry(jeng, JaxRequest, jp2), carry(teng, Request, tp2)
    vers = list(tout.token_versions)
    assert vers == list(jout.token_versions) and set(vers) == {0, 1}
    assert vers == sorted(vers)
    assert tout.tokens == jout.tokens and len(tout.tokens) == MAX_NEW
    np.testing.assert_allclose(tout.logprobs, jout.logprobs, atol=1e-4,
                               rtol=0)
    n_old = vers.count(0)
    assert tout.tokens[:n_old] == tref[0][:n_old]
    np.testing.assert_array_equal(np.asarray(tout.logprobs[:n_old],
                                             np.float32), tref[1][:n_old])
    assert tout.tokens[n_old:] != tref[0][n_old:]
    m = teng.metrics()
    assert (m.suspends, m.resumes, m.suspended) == (1, 1, 0)
    again = carry(_engines(pair, kv, kv_dtype)[1], Request, tp2)
    assert again.tokens == tout.tokens
    assert again.logprobs == tout.logprobs
    assert again.token_versions == tout.token_versions


def test_stream_sync_params_versions_match_jax(pair, params7):
    """``generate_continuous_stream(sync_params=...)``: a version bump
    mid-rollout carries the live generations onto the new weights; the
    groups' tokens and ``token_versions`` are the JAX generator's."""
    jm, jp, tm, tp = pair
    jp2, tp2 = params7
    prompts = np.stack([_prompt(0), _prompt(0), _prompt(4), _prompt(4)])

    def poll(old, new):
        n = [0]

        def sync():
            n[0] += 1
            return (new, 1) if n[0] > 3 else (old, 0)
        return sync, n
    jsync, jn = poll(jp, jp2)
    tsync, tn = poll(tp, tp2)
    jg = list(jax_stream(jm, jp, prompts, jax.random.PRNGKey(0),
                         JaxSampler(max_new_tokens=8, temperature=0.0),
                         spec=RolloutSpec(num_slots=2, group=2),
                         sync_params=jsync))
    tg = list(generate_continuous_stream(
        tm, tp, prompts, SamplerConfig(max_new_tokens=8), group=2,
        num_slots=2, sync_params=tsync, device="cpu"))
    assert tn[0] == jn[0] > 3
    jg = sorted(jg, key=lambda g: g["group_index"])
    tg = sorted(tg, key=lambda g: g["group_index"])
    for a, b in zip(tg, jg):
        assert a["rows"] == b["rows"]
        np.testing.assert_array_equal(a["completions"],
                                      np.asarray(b["completions"]))
        np.testing.assert_array_equal(a["token_versions"],
                                      np.asarray(b["token_versions"]))
        np.testing.assert_allclose(a["behavior_logp"],
                                   np.asarray(b["behavior_logp"]),
                                   atol=1e-4, rtol=0)
    tv = np.concatenate([g["token_versions"] for g in tg])
    msk = np.concatenate([g["mask"] for g in tg]) > 0
    assert 1 in set(tv[msk].tolist()) and -1 not in set(tv[msk].tolist())


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return None if tree is None else tree.numpy()


@pytest.mark.parametrize("kv,kv_dtype", [("contiguous", None),
                                         ("paged", "int8")])
def test_export_import_roundtrip_with_suspended_handles(pair, kv, kv_dtype):
    """A snapshot taken mid-flight, with a suspended handle pinning the
    pool and live requests in their slots, continues on a fresh engine
    (device leaves passed back as numpy arrays, as from a host cache)
    token for token as the engine it was taken from."""
    ref, _ = _uninterrupted(_engines(pair, kv, kv_dtype)[1], Request)
    stop = ref[_stop_index(ref, 1, True)]

    def fill(eng):
        eng.submit(_req(Request, rid=0, stop=(stop,)))
        eng.submit(_req(Request, rid=1, prompt=_prompt(5, 6)))
        eng.submit(_req(Request, rid=2, prompt=_prompt(6, 8)))

    def run_out(eng):
        outs = {}
        while True:
            eng.run()
            for o in eng.harvest():
                outs[o.rid] = (o.tokens, o.logprobs)
            sus = eng.harvest_suspended() + list(eng.suspended.values())
            if not sus and eng.idle:
                return outs
            for s in {id(s): s for s in sus}.values():
                eng.resume(s, (), max_new_tokens=MAX_NEW - len(s.out.tokens),
                           rid=100 + s.req.rid, stop_tokens=())
    _, a = _engines(pair, kv, kv_dtype)
    fill(a)
    want = run_out(a)
    _, b = _engines(pair, kv, kv_dtype)
    fill(b)
    for _ in range(MAX_NEW):
        b.step()
        if b.suspended:
            break
    assert b.suspended and b.num_active, "a handle and live slots"
    state = b.export_state()
    state["device"] = _to_numpy(state["device"])
    _, fresh = _engines(pair, kv, kv_dtype)
    bufs = [fresh._last_logits.data_ptr()] + [
        t.data_ptr() for t in fresh.slots.cache.values()]
    fresh.import_state(state)
    assert bufs == [fresh._last_logits.data_ptr()] + [
        t.data_ptr() for t in fresh.slots.cache.values()]  # copied in place
    assert run_out(fresh) == run_out(b) == want
    fresh.reset()
    if kv == "paged":
        fresh.slots.alloc.assert_clean(context="after the round trip")


def _recurrent_pair(arch):
    jcfg = jax_get_config(arch).reduced()
    jcfg = dataclasses.replace(jcfg, dtype="float32",
                               num_layers=min(jcfg.num_layers, 4))
    jm = JaxModel(jcfg)
    tm = build_model(dataclasses.replace(build_model(arch, reduced=True).cfg,
                                         num_layers=jcfg.num_layers))
    jp, tp = _pair(jm)
    return jm, jp, tm, tp


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_recurrent_suspend_block1_ok_and_refused_above(arch):
    rpair = _recurrent_pair(arch)
    jref, tref = (_uninterrupted(e, c) for e, c in zip(
        _engines(rpair, "contiguous", None), (JaxRequest, Request)))
    assert tref[0] == jref[0]
    stop = jref[0][_stop_index(jref[0], 1, True)]
    _, teng = _engines(rpair, "contiguous", None)
    teng.submit(_req(Request, stop=(stop,)))
    teng.run()
    [sreq] = teng.harvest_suspended()
    n0 = len(sreq.out.tokens)
    assert 0 < n0 < MAX_NEW
    teng.resume(sreq, (), max_new_tokens=MAX_NEW - n0, rid=1,
                stop_tokens=())
    [out] = teng.run()
    assert sreq.out.tokens + out.tokens == tref[0]
    np.testing.assert_array_equal(
        np.asarray(list(sreq.out.logprobs) + list(out.logprobs),
                   np.float32), tref[1])
    _, fused = _engines(rpair, "contiguous", None, block_size=4)
    with pytest.raises(ValueError, match="block_size"):
        fused.submit(_req(Request, stop=(stop,)))
