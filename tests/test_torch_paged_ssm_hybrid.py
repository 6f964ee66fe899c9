"""Paged layouts of the ssm (rwkv6) and hybrid (zamba2) families on the port.

Reduced rwkv6-7b and a 4-layer reduced zamba2-2.7b (two uses of the
shared attention block) in float32 on the CPU, the JAX init redrawn from
a seed as the families' own tests do, carried across by
``repro_torch.convert``:

* the paged engine (zamba2 on float and int8 pools, rwkv6 on its
  degenerate pool) against the JAX package's paged engine: tokens
  identical, logprobs within 1e-4 (int8 2e-3, ROADMAP's faults); and
  against the port's contiguous engine: rwkv6 bit for bit (one decode
  step), zamba2 within 1e-4 (the shared block through the paged kernel's
  plain version instead of ``gqa_decode_step``);
* rwkv6 requests need zero blocks: a one-block pool admits every slot;
* radix sharing: zamba2 exact and partial hits, rwkv6 exact hits on the
  root snapshot (``blocks_saved`` 0), each bit for bit with the unshared
  port run and with the JAX engine's counters;
* suspend/resume at block size 1 (another request served in the freed
  slot meanwhile) bit for bit with the uninterrupted run, tool tokens in
  the slot against a prefill of the continued prompt, ``export_state`` /
  ``import_state`` with a suspended handle, and the block size 2 refusal;
* a router of paged prefill and decode engines bit for bit with the
  monolithic paged engine.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _jax_weights import jax_init  # noqa: E402
from test_torch_rwkv6 import _randomize as rwkv_randomize  # noqa: E402
from test_torch_zamba2 import _randomize as zamba_randomize  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import (DisaggConfig, DisaggRouter,  # noqa: E402
                               Engine, EngineConfig, PagedSlotManager,
                               Request)

MAX_LEN, BS, MAX_NEW = 40, 4, 6
LENS = (9, 5, 9, 13, 5)


def _pair(arch, layers, randomize):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               num_layers=layers, dtype="float32")
    jm = JaxModel(jcfg)
    jp_np = randomize(jax_init(jm, 1))
    tm = build_model(dataclasses.replace(build_model(arch, reduced=True).cfg,
                                         num_layers=layers))
    return jm, jax.tree.map(jnp.asarray, jp_np), tm, from_jax_params(jp_np)


@pytest.fixture(scope="module")
def models():
    return {"zamba2": _pair("zamba2-2.7b", 4, zamba_randomize),
            "rwkv6": _pair("rwkv6-7b", 2, rwkv_randomize)}


@pytest.fixture(scope="module")
def served(models):
    """The port's paged engine on the default prompts, by (arch, int8),
    made on first use: ``(outputs, the drained engine)``, the monolithic
    run several tests hold theirs to."""
    runs = {}

    def get(arch, kv_dtype=None):
        if (arch, kv_dtype) not in runs:
            eng = _engine(models, arch, kv_dtype=kv_dtype)
            runs[arch, kv_dtype] = (_serve(eng, _prompts()), eng)
        return runs[arch, kv_dtype]
    return get


def _prompts(lens=LENS, seed=7):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, n).astype(np.int32) for n in lens]


def _cfg(cls, **kw):
    base = dict(num_slots=2, max_seq_len=MAX_LEN, temperature=0.0,
                kv_layout="paged", kv_block_size=BS)
    base.update(kw)
    return cls(**base)


def _engine(models, arch, **kw):
    _, _, tm, tp = models[arch]
    return Engine(tm, tp, _cfg(EngineConfig, **kw), device="cpu")


def _serve(eng, prompts, req_cls=Request, max_new=MAX_NEW):
    for i, p in enumerate(prompts):
        assert eng.submit(req_cls(rid=i, prompt=p, max_new_tokens=max_new))
    return {o.rid: o for o in eng.run()}


def _same(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        assert a[rid].tokens == b[rid].tokens, rid
        np.testing.assert_array_equal(np.asarray(a[rid].logprobs),
                                      np.asarray(b[rid].logprobs))


def _close(a, b, atol):
    assert sorted(a) == sorted(b)
    for rid in a:
        assert a[rid].tokens == b[rid].tokens, rid
        np.testing.assert_allclose(a[rid].logprobs, b[rid].logprobs,
                                   atol=atol, rtol=0)


@pytest.mark.parametrize("arch,kv_dtype", [("zamba2", None),
                                           ("zamba2", "int8"),
                                           ("rwkv6", None)])
def test_paged_engine_matches_jax_and_contiguous(models, served, arch,
                                                 kv_dtype):
    jm, jp, _, _ = models[arch]
    prompts = _prompts()
    port, eng = served(arch, kv_dtype)
    ref = _serve(JaxEngine(jm, jp, _cfg(JaxEngineConfig, kv_dtype=kv_dtype)),
                 prompts, JaxRequest)
    _close(port, ref, 2e-3 if kv_dtype else 1e-4)
    contiguous = _serve(_engine(models, arch, kv_layout="contiguous"),
                        prompts)
    if arch == "rwkv6":
        _same(port, contiguous)
        assert eng.metrics().peak_kv_blocks == 0
    else:
        _close(port, contiguous, 2e-3 if kv_dtype else 1e-4)
    eng.slots.check()
    eng.slots.alloc.assert_clean(context="test")


def test_ssm_requests_need_no_blocks(models):
    _, _, tm, _ = models["rwkv6"]
    sm = PagedSlotManager(tm, 2, MAX_LEN, block_size=8, num_blocks=1,
                          device="cpu")
    assert sm.paged_names == () and sm.blocks_required(MAX_LEN) == 0
    assert sm.can_admit(MAX_LEN)
    slot = sm.assign(0, prompt_len=6, total_budget=MAX_LEN)
    assert sm.blocks_in_use == 0
    block_ids, tail, rows = sm.boundary(slot, 6)
    assert (block_ids, tail) == ([], {})
    assert sorted(rows) == ["att_x", "ffn_x", "wkv"]
    sm.release(slot)
    sm.check()
    eng = _engine(models, "rwkv6", num_kv_blocks=1)
    outs = _serve(eng, _prompts())
    assert len(outs) == 5 and eng.metrics().peak_active == 2


def test_zamba2_radix_exact_and_partial_hits(models):
    jm, jp, _, _ = models["zamba2"]
    a, b = _prompts((9, 6), seed=3)
    ext = np.concatenate([a, _prompts((4,), seed=4)[0]])
    prompts = [a, b, a, ext, b]
    base = _serve(_engine(models, "zamba2"), prompts)
    for kv_dtype in (None, "int8"):
        eng = _engine(models, "zamba2", prefix_share=True, kv_dtype=kv_dtype)
        shared = _serve(eng, prompts)
        if kv_dtype is None:
            _same(shared, base)
        else:
            _same(shared, _serve(_engine(models, "zamba2",
                                         kv_dtype="int8"), prompts))
        r = eng.radix
        assert (r.hits, r.partial_hits, r.misses) == (2, 1, 2)
        assert eng.metrics().blocks_saved == 5       # 2 + 1 + 2 of ext
    jeng = JaxEngine(jm, jp, _cfg(JaxEngineConfig, prefix_share=True))
    _serve(jeng, prompts, JaxRequest)
    jr = jeng.radix
    assert (jr.hits, jr.partial_hits, jr.misses) == (2, 1, 2)
    assert jeng.metrics().blocks_saved == 5


def test_rwkv6_sharing_is_a_prefill_cache(models):
    jm, jp, _, _ = models["rwkv6"]
    p = _prompts((7,), seed=2)[0]
    prompts = [p, p, p]
    kw = dict(kv_block_size=8)
    base = _serve(_engine(models, "rwkv6", **kw), prompts)
    eng = _engine(models, "rwkv6", prefix_share=True, **kw)
    _same(_serve(eng, prompts), base)
    m = eng.metrics()
    assert (m.prefix_hits, m.blocks_saved, m.prefills) == (2, 0, 3)
    assert len(eng.radix) == 0 and eng.radix.stats["snapshots"] == 1
    jeng = JaxEngine(jm, jp, _cfg(JaxEngineConfig, prefix_share=True, **kw))
    _serve(jeng, prompts, JaxRequest)
    assert (jeng.radix.hits, jeng.radix.misses) == (2, 1)


def _suspend_mid_run(eng, prompts, rid=0, after=3):
    """Serve ``prompts``; after ``after`` ticks suspend ``rid``, tick on
    (another request takes the freed slot), then resume it."""
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=MAX_NEW))
    for _ in range(after):
        eng.step()
    held = eng.suspend(rid)
    assert held.slot_leaves and not held.released
    for _ in range(2):
        eng.step()
    while not eng.can_resume(held):
        eng.step()
    eng.resume(held, continue_output=True)
    return {o.rid: o for o in eng.run()}


@pytest.mark.parametrize("arch,kv_dtype", [("zamba2", None),
                                           ("zamba2", "int8"),
                                           ("rwkv6", None)])
def test_suspend_resume_at_block_1(models, served, arch, kv_dtype):
    prompts = _prompts()
    base = served(arch, kv_dtype)[0]
    eng = _engine(models, arch, kv_dtype=kv_dtype)
    _same(_suspend_mid_run(eng, prompts), base)
    assert eng.metrics().suspends == eng.metrics().resumes == 1
    eng.slots.alloc.assert_clean(context="test")


def test_zamba2_tool_tokens_export_import_and_refusal(models, served):
    _, _, tm, tp = models["zamba2"]
    p = _prompts((9,), seed=5)[0]
    tool = _prompts((3,), seed=6)[0]
    eng = _engine(models, "zamba2")
    eng.submit(Request(rid=0, prompt=p, max_new_tokens=MAX_NEW))
    for _ in range(3):
        eng.step()
    held = eng.suspend(0)
    eng.resume(held, tool, max_new_tokens=4)
    [out] = eng.run()
    fresh = _serve(_engine(models, "zamba2"), [np.concatenate(
        [held.history, tool])], max_new=4)[0]
    assert out.tokens == fresh.tokens
    np.testing.assert_allclose(out.logprobs, fresh.logprobs, atol=1e-4,
                               rtol=0)
    # a checkpoint with a suspended handle continues token for token
    prompts = _prompts()
    base = served("zamba2")[0]
    eng = _engine(models, "zamba2")
    for i, q in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=q, max_new_tokens=MAX_NEW))
    for _ in range(3):
        eng.step()
    eng.suspend(1)
    state = eng.export_state()
    twin = _engine(models, "zamba2")
    twin.import_state(state)
    handle = twin.suspended[1]
    assert sorted(handle.slot_leaves) == ["conv", "ssm"]
    twin.step()
    while not twin.can_resume(handle):
        twin.step()
    twin.resume(handle, continue_output=True)
    _same({o.rid: o for o in twin.run()}, base)
    with pytest.raises(ValueError, match="block_size=1"):
        _engine(models, "zamba2", block_size=2).submit(Request(
            rid=0, prompt=p, max_new_tokens=4, stop_tokens=(3,)))


@pytest.mark.parametrize("arch,kv_dtype", [("zamba2", None),
                                           ("zamba2", "int8"),
                                           ("rwkv6", None)])
def test_router_matches_monolithic(models, served, arch, kv_dtype):
    _, _, tm, tp = models[arch]
    prompts = _prompts()
    mono = served(arch, kv_dtype)[0]
    router = DisaggRouter(tm, tp, DisaggConfig(
        prefill_slots=1, decode_slots=2, max_seq_len=MAX_LEN,
        temperature=0.0, kv_layout="paged", kv_block_size=BS,
        kv_dtype=kv_dtype, prefix_share=True), device="cpu")
    _same(_serve(router, prompts), mono)
    assert router.metrics().transfers == len(prompts)
    router.reset()
