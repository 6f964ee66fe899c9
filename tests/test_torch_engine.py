"""The whole slice: the port's engine against the JAX engine's Pallas path.

``generate_continuous`` on the port (plain kernel versions on the CPU)
against the JAX package's ``generate_continuous`` with
``kernel_backend="pallas"`` (interpret mode) on converted reduced-internlm2
params, with fewer slots than requests so that requests queue and slots
recycle.  Greedy tokens must be identical; logprobs agree within 1e-4
(float32 summation order).  The int8 run is compared with JAX int8, with
logprobs within 2e-3: XLA and PyTorch compute the prompt's K/V a few
float32 ulps apart, and an element that sits on a rounding boundary of the
quantizer (x / scale = 15.5 on one side, 15.4999... on the other, seen in
this very trace) lands one int8 step apart, which moves the later
logprobs of that request by ~5e-4.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.rl.rollout import SamplerConfig as JaxSampler  # noqa: E402
from repro.rl.rollout import \
    generate_continuous as jax_generate_continuous  # noqa: E402
from repro.serve import RolloutSpec  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.data import tokenizer as tok  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.rl import SamplerConfig, generate_continuous  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, Request  # noqa: E402

ARCH = "internlm2-1.8b"
T = 6


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(ARCH, reduced=True)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(ARCH, reduced=True)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _prompts():
    rs = np.random.RandomState(0)
    return rs.randint(0, 256, size=(5, 7)).astype(np.int32)


@pytest.mark.parametrize("layout,kv_dtype", [("contiguous", None),
                                             ("paged", None),
                                             ("paged", "int8")])
def test_generate_continuous_matches_jax_pallas(pair, layout, kv_dtype):
    jm, jp, tm, tp = pair
    prompts = _prompts()
    ref = jax_generate_continuous(
        jm, jp, prompts, jax.random.PRNGKey(0),
        JaxSampler(max_new_tokens=T, temperature=0.0),
        spec=RolloutSpec(num_slots=2, kv_layout=layout, kv_block_size=4,
                         kernel_backend="pallas", kv_dtype=kv_dtype))
    got = generate_continuous(
        tm, tp, prompts, SamplerConfig(max_new_tokens=T), num_slots=2,
        kv_layout=layout, kv_block_size=4, kv_dtype=kv_dtype, device="cpu")
    np.testing.assert_array_equal(got["completions"].numpy(),
                                  np.asarray(ref["completions"]))
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(ref["mask"]))
    np.testing.assert_allclose(got["behavior_logp"].numpy(),
                               np.asarray(ref["behavior_logp"]),
                               atol=1e-4 if kv_dtype is None else 2e-3,
                               rtol=0)
    stats = got["engine_stats"]
    assert stats.prefills == len(prompts)
    assert stats.peak_active == 2            # queued and recycled


def test_paged_release_after_admit_keeps_prompt_kv(pair):
    """Host-aliasing regression: the device tables are a snapshot, so a
    slot released right after its admit leaves the already-uploaded
    tables untouched, and the prompt's KV sits in the blocks it named."""
    _, _, tm, tp = pair
    bs = 4
    eng = Engine(tm, tp, EngineConfig(num_slots=2, max_seq_len=24,
                                      kv_layout="paged", kv_block_size=bs),
                 device="cpu")
    prompt = _prompts()[0]
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
    eng._admit()
    (slot,) = eng._active
    tables = eng.slots.device_tables()
    row = tables[slot].clone()
    n_blk = -(-len(prompt) // bs)
    assert (row[:n_blk] > 0).all()
    eng.slots.release(slot)                  # zeroes the host row
    assert torch.equal(tables[slot], row)    # the snapshot did not move
    ref = tm.prefill(tp, torch.from_numpy(prompt)[None],
                     tm.init_cache(1, 24, device="cpu"))[1]
    pool = eng.slots.cache["k"]              # (L, NB+1, bs, Hkv, hd)
    got = pool[:, row[:n_blk].long()].reshape(pool.shape[0], n_blk * bs,
                                              *pool.shape[3:])
    torch.testing.assert_close(got[:, :len(prompt)],
                               ref["k"][:, 0, :len(prompt)], rtol=0, atol=0)


def test_engine_invariants_and_stats(pair):
    _, _, tm, tp = pair
    eng = Engine(tm, tp, EngineConfig(num_slots=2, max_seq_len=24,
                                      kv_layout="paged", kv_block_size=4,
                                      block_size=3), device="cpu")
    for i, p in enumerate(_prompts()[:3]):
        assert eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    outs = eng.run()
    assert [o.rid for o in outs] == [0, 1, 2]
    assert all(o.finish_reason in ("length", "eos") for o in outs)
    assert all(1 <= o.num_tokens <= 5 for o in outs)
    eng.slots.check()
    assert eng.slots.alloc.num_live == 0 and eng.idle
    s = eng.stats
    assert s.steps % 3 == 0 and s.recorded_tokens == sum(
        o.num_tokens for o in outs)


def test_engine_refuses_what_is_not_ported(pair):
    _, _, tm, tp = pair
    # sampled decoding is ported: it draws from a seeded generator
    eng = Engine(tm, tp, EngineConfig(temperature=1.0), device="cpu")
    assert eng.generator is not None
    with pytest.raises(ValueError, match="temperature"):
        Engine(tm, tp, EngineConfig(temperature=-1.0), device="cpu")
    with pytest.raises(NotImplementedError, match="prefix_share"):
        Engine(tm, tp, EngineConfig(kv_layout="paged", prefix_share=True),
               device="cpu")
    eng = Engine(tm, tp, EngineConfig(num_slots=1, max_seq_len=16),
                 device="cpu")
    with pytest.raises(NotImplementedError, match="stop_tokens"):
        eng.submit(Request(rid=0, prompt=[tok.BOS], max_new_tokens=2,
                           stop_tokens=(5,)))
    for call in (lambda: eng.reset(), lambda: eng.export_state(),
                 lambda: eng.suspend(0)):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(ValueError, match="params live on"):
        Engine(tm, tp, EngineConfig(), device="meta")
