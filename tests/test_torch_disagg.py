"""Disaggregated prefill/decode serving on the port (``serve.disagg``,
``serve.router``, ``serve.spec``, ``serve.protocol``) against its own
monolithic engine and the JAX package's router.

The port's engines (plain kernel versions on the CPU) on converted
reduced weights, float32:

* the router equals a monolithic engine with as many slots as its decode
  pool bit for bit (tokens and logprobs) for fifo, deadline and slo
  admission on contiguous, paged and paged-with-sharing KV, and on int8
  pools; tokens equal the JAX router's on the same configuration, with
  the JAX router's radix counters;
* contiguous disaggregation of rwkv6-7b and zamba2-2.7b (reduced), the
  handle carrying the whole batch=1 cache;
* independently sized pools, oversized requests refused;
* ``generate_continuous(spec=RolloutSpec(disagg=...))`` bit-exact;
* handle reference counts under random interleavings, idempotent
  release, ``PrefillEngine.reset`` refusing live handles, reset cycles
  leak-free with sharing (monolithic and router);
* the transfer phase on a ``RollMuxRuntime`` timeline; kv-aware against
  queue routing across two prefill engines;
* ``EngineProtocol`` conformance of ``Engine`` and ``DisaggRouter``,
  ``RolloutSpec.from_args`` on both CLIs' namespaces, and the CLIs
  ``launch.serve --prefix-share --group 4`` / ``--disagg`` and
  ``launch.train --prefix-share`` on the CPU at reduced size;
* two GRPO iterations through ``run_training(spec=...)`` with sharing,
  and through a router, bit for bit with the plain paged engine;
* an int8 handle carries its stored payload (bit for bit), where the JAX
  package's dequantized interchange lands about 1e-6 off.
"""
import argparse
import sys

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402
from _jax_weights import jax_init  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import DisaggConfig as JaxDisaggConfig  # noqa: E402
from repro.serve import DisaggRouter as JaxRouter  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.phase_control import RollMuxRuntime  # noqa: E402
from repro_torch.models.kvcache import (SCALE_SUFFIX,  # noqa: E402
                                        dequantize_kv)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.rl import SamplerConfig, generate_continuous  # noqa: E402
from repro_torch.serve import (ENGINE_ATTRS, DisaggConfig,  # noqa: E402
                               DisaggRouter, Engine, EngineConfig,
                               EngineProtocol, KVTransferHandle,
                               PrefillEngine, Request, RolloutSpec)

ARCH = "internlm2-1.8b"
MAX_LEN, BS = 40, 4


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(ARCH, reduced=True)
    jp = jax_init(jm, 1)
    return jm, jp, build_model(ARCH, reduced=True), from_jax_params(
        jax.tree.map(np.asarray, jp))


def _prompts(n=4, share=False):
    rs = np.random.RandomState(0)
    out = [rs.randint(0, 256, size=int(rs.randint(5, 11))).astype(np.int32)
           for _ in range(n)]
    if share:                       # two exact repeats of the first prompt
        out[2] = out[0].copy()
        out[3] = out[0].copy()
    return out


def _reqs(prompts, cls=Request, max_new=6, deadlines=False):
    return [cls(rid=i, prompt=p, max_new_tokens=max_new,
                deadline=(10.0 - i) if deadlines else None)
            for i, p in enumerate(prompts)]


def _mono(model, params, reqs, *, slots=2, **kw):
    eng = Engine(model, params, EngineConfig(
        num_slots=slots, max_seq_len=MAX_LEN, kv_block_size=BS, **kw),
        device="cpu")
    for r in reqs:
        eng.submit(r)
    return {o.rid: o for o in eng.run()}


def _router(model, params, reqs, *, prefill_slots=1, decode_slots=2, **kw):
    router = DisaggRouter(model, params, DisaggConfig(
        prefill_slots=prefill_slots, decode_slots=decode_slots,
        max_seq_len=MAX_LEN, kv_block_size=BS, **kw), device="cpu")
    for r in reqs:
        router.submit(r)
    return {o.rid: o for o in router.run()}, router


def _same(a, b):
    assert sorted(a) == sorted(b)
    for rid in a:
        assert a[rid].tokens == b[rid].tokens, rid
        np.testing.assert_array_equal(np.asarray(a[rid].logprobs),
                                      np.asarray(b[rid].logprobs))


ROUTER_CASES = [(sched, kv, share, None) for sched in ("fifo", "deadline",
                                                       "slo")
                for kv, share in (("contiguous", False), ("paged", False),
                                  ("paged", True))] + [
    ("fifo", "paged", False, "int8"), ("fifo", "paged", True, "int8")]


@pytest.mark.parametrize("sched,kv,share,kv_dtype", ROUTER_CASES)
def test_router_matches_monolithic_and_jax(pair, sched, kv, share, kv_dtype):
    jm, jp, tm, tp = pair
    prompts = _prompts(share=share)
    kw = dict(kv_layout=kv, sched=sched, prefix_share=share,
              kv_dtype=kv_dtype)
    mono = _mono(tm, tp, _reqs(prompts, deadlines=sched != "fifo"), **kw)
    dis, router = _router(tm, tp, _reqs(prompts, deadlines=sched != "fifo"),
                          **kw)
    _same(mono, dis)
    assert router.metrics().transfers == len(prompts)
    jrouter = JaxRouter(jm, jp, JaxDisaggConfig(
        prefill_slots=1, decode_slots=2, max_seq_len=MAX_LEN,
        temperature=0.0, kv_block_size=BS, **kw))
    for r in _reqs(prompts, JaxRequest, deadlines=sched != "fifo"):
        jrouter.submit(r)
    jouts = {o.rid: o for o in jrouter.run()}
    for rid in jouts:
        assert dis[rid].tokens == jouts[rid].tokens, rid
    if share:
        assert (router.radix.hits, router.radix.misses) == \
            (jrouter.radix.hits, jrouter.radix.misses) == (2, 2)
    router.reset()


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-2.7b"])
def test_contiguous_disagg_recurrent(arch):
    """The handle carries the whole batch=1 cache (recurrent state and,
    for zamba2, the shared attention's K/V)."""
    jm = jax_build(arch, reduced=True)
    tm = build_model(arch, reduced=True)
    tp = from_jax_params(jax.tree.map(np.asarray, jax_init(jm, 1)))
    prompts = _prompts(3)
    mono = _mono(tm, tp, _reqs(prompts, max_new=5))
    dis, router = _router(tm, tp, _reqs(prompts, max_new=5))
    _same(mono, dis)
    assert router.metrics().transfers == 3 and router.prefill.slots is None


def test_pool_sizing_independent_and_oversized_rejected(pair):
    _, _, tm, tp = pair
    reqs = _reqs(_prompts(), max_new=5)
    mono = _mono(tm, tp, reqs, kv_layout="paged")
    dis, router = _router(tm, tp, _reqs(_prompts(), max_new=5),
                          kv_layout="paged", prefill_kv_blocks=6,
                          decode_kv_blocks=40)
    _same(mono, dis)
    assert router.prefill.slots.alloc.num_blocks == 6
    assert router.decode.slots.alloc.num_blocks == 40
    router.reset()
    _, small = _router(tm, tp, [], kv_layout="paged", decode_kv_blocks=4)
    with pytest.raises(ValueError, match="decode pool"):
        small.submit(Request(rid=0, prompt=np.zeros(8, np.int32),
                             max_new_tokens=30))
    with pytest.raises(ValueError, match="max_seq_len"):
        small.submit(Request(rid=1, prompt=np.zeros(MAX_LEN, np.int32),
                             max_new_tokens=4))


def test_generate_continuous_spec_disagg_bit_exact(pair):
    _, _, tm, tp = pair
    prompts = np.stack([p[:5] for p in _prompts()])
    sampler = SamplerConfig(max_new_tokens=6, temperature=0.0)
    mono = generate_continuous(tm, tp, prompts, sampler, device="cpu",
                               spec=RolloutSpec(num_slots=2,
                                                kv_layout="paged",
                                                kv_block_size=BS))
    dis = generate_continuous(tm, tp, prompts, sampler, device="cpu",
                              spec=RolloutSpec(
                                  num_slots=2, kv_layout="paged",
                                  kv_block_size=BS,
                                  disagg={"prefill_slots": 1,
                                          "decode_slots": 2}))
    for k in ("completions", "behavior_logp", "mask"):
        assert torch.equal(mono[k], dis[k]), k
    assert dis["engine_stats"].transfers == prompts.shape[0]
    # the loose keywords build the same router
    loose = generate_continuous(tm, tp, prompts, sampler, device="cpu",
                                num_slots=2, kv_layout="paged",
                                kv_block_size=BS,
                                disagg={"prefill_slots": 1,
                                        "decode_slots": 2})
    assert torch.equal(loose["behavior_logp"], dis["behavior_logp"])
    with pytest.raises(ValueError, match="spec= given alongside"):
        generate_continuous(tm, tp, prompts, sampler, device="cpu",
                            spec=RolloutSpec(num_slots=2), num_slots=4)


def _conservation(alloc):
    assert alloc.num_free + alloc.num_live == alloc.num_blocks
    for bid, rc in alloc.refcount.items():
        assert rc > 0, f"dangling refcount on block {bid}"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_handle_refcounts_under_random_interleaving(pair, seed):
    """submit / prefill tick / drop / full tick in a random order: block
    conservation at every step, both pools clean after the drain."""
    _, _, tm, tp = pair
    rs = np.random.RandomState(seed)
    router = DisaggRouter(tm, tp, DisaggConfig(
        prefill_slots=2, decode_slots=2, max_seq_len=MAX_LEN,
        kv_layout="paged", kv_block_size=BS, prefix_share=True),
        device="cpu")
    rid = 0
    for op in rs.randint(0, 4, size=24):
        if op == 0 and rid < 6:
            router.submit(Request(
                rid=rid, prompt=rs.randint(1, 50, int(rs.randint(3, 9))),
                max_new_tokens=int(rs.randint(1, 5)),
                prefix_key=f"g{rid % 2}"))
            rid += 1
        elif op == 1:
            router.prefill.step()
            router.pending_transfer.extend(router.prefill.pop_ready())
        elif op == 2 and router.pending_transfer:
            router.pending_transfer.popleft().release()
        elif not router.idle:
            router.step()
        _conservation(router.prefill.slots.alloc)
        _conservation(router.decode.slots.alloc)
        router.prefill.slots.check(extra_pins=router.radix.pinned_blocks()
                                   + [b for h in router.pending_transfer
                                      for b in h.block_ids])
    router.run()
    router.reset()


def test_handle_release_idempotent_and_prefill_reset_refuses(pair):
    _, _, tm, tp = pair
    router = DisaggRouter(tm, tp, DisaggConfig(
        prefill_slots=1, decode_slots=1, max_seq_len=MAX_LEN,
        kv_layout="paged", kv_block_size=BS), device="cpu")
    router.submit(_reqs(_prompts(1))[0])
    router.prefill.step()
    (h,) = router.prefill.pop_ready()
    assert isinstance(h, KVTransferHandle) and h.block_ids
    with pytest.raises(RuntimeError, match="un-released"):
        router.prefill.reset()
    h.release()
    h.release()                              # a no-op
    router.prefill.slots.alloc.assert_clean()
    with pytest.raises(RuntimeError, match="already released"):
        router.prefill.export_cache(h)
    router.prefill.reset()


def test_dropped_handles_restore_conservation(pair):
    _, _, tm, tp = pair
    router = DisaggRouter(tm, tp, DisaggConfig(
        prefill_slots=2, decode_slots=2, max_seq_len=MAX_LEN,
        kv_layout="paged", kv_block_size=BS), device="cpu")
    for r in _reqs(_prompts(), max_new=4):
        router.submit(r)
    router.prefill.step()
    router.pending_transfer.extend(router.prefill.pop_ready())
    assert router.prefill.slots.alloc.num_live > 0
    assert router.drop_pending() == 2
    assert len(router.run()) == 2
    router.reset()


@pytest.mark.parametrize("kind", ["mono", "router"])
def test_reset_cycles_leak_free_with_sharing(pair, kind):
    _, _, tm, tp = pair
    if kind == "mono":
        eng = Engine(tm, tp, EngineConfig(
            num_slots=2, max_seq_len=MAX_LEN, kv_layout="paged",
            kv_block_size=BS, prefix_share=True), device="cpu")
    else:
        eng = DisaggRouter(tm, tp, DisaggConfig(
            prefill_slots=1, decode_slots=2, max_seq_len=MAX_LEN,
            kv_layout="paged", kv_block_size=BS, prefix_share=True),
            device="cpu")
    base = _prompts(2)
    for cycle in range(3):
        for i, p in enumerate(base * 2):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=4,
                               prefix_key=f"c{cycle}"))
        assert len(eng.run()) == 4
        assert eng.metrics().prefix_hits == 2
        eng.reset()                          # asserts clean pools
        assert len(eng.radix) == 0


def test_transfer_phase_lands_on_runtime_timeline(pair):
    _, _, tm, tp = pair
    rt = RollMuxRuntime(host_cache_gb=0.5)
    router = DisaggRouter(tm, tp, DisaggConfig(
        prefill_slots=1, decode_slots=2, max_seq_len=MAX_LEN,
        kv_layout="paged", kv_block_size=BS), device="cpu", runtime=rt,
        job_id="jobA")
    for r in _reqs(_prompts(3), max_new=4):
        router.submit(r)
    router.run()
    pool = rt.pools["transfer"]
    assert len(pool.timeline) == 3
    assert all(who == "jobA:transfer" for who, _, _ in pool.timeline)
    prof = rt.phase_profiles()["jobA"]
    assert len(prof.transfer_s) == 3 and prof.t_transfer > 0.0
    assert prof.to_job().t_roll == pytest.approx(prof.t_roll
                                                 + prof.t_transfer)
    m = router.metrics()
    assert m.transfers == 3 and 0.0 < m.transfer_overhead_frac < 1.0


@pytest.mark.parametrize("routing", ["kv_aware", "queue"])
def test_kv_aware_against_queue_routing(pair, routing):
    """Two prefill engines, two prompts warmed one on each engine, then
    repeats: kv_aware sends each repeat to its prompt's holder (exact
    hits, no compute), queue routing by load alone; outputs equal the
    warm-up's either way."""
    _, _, tm, tp = pair
    pa, pb = _prompts(2)
    router = DisaggRouter(tm, tp, DisaggConfig(
        prefill_slots=1, decode_slots=2, max_seq_len=MAX_LEN,
        kv_layout="paged", kv_block_size=BS, prefix_share=True,
        prefill_engines=2, kv_routing=routing), device="cpu")
    router.submit(Request(rid=0, prompt=pa, max_new_tokens=5))
    router.prefills[1].submit(Request(rid=1, prompt=pb, max_new_tokens=5))
    outs = {o.rid: o for o in router.run()}
    router.submit(Request(rid=2, prompt=pb, max_new_tokens=5))
    router.submit(Request(rid=3, prompt=pa, max_new_tokens=5))
    outs.update({o.rid: o for o in router.run()})
    hits = [pe.stats.prefix_hits for pe in router.prefills]
    if routing == "kv_aware":
        assert router.metrics().kv_routed == 2 and hits == [1, 1]
    else:
        assert router.metrics().kv_routed == 0 and sum(hits) < 2
    assert outs[3].tokens == outs[0].tokens
    assert outs[2].tokens == outs[1].tokens
    router.reset()


@pytest.mark.parametrize("kind", ["mono", "router"])
def test_engine_protocol_conformance(pair, kind):
    _, _, tm, tp = pair
    eng = (Engine(tm, tp, EngineConfig(num_slots=2, max_seq_len=MAX_LEN),
                  device="cpu") if kind == "mono" else
           DisaggRouter(tm, tp, DisaggConfig(prefill_slots=1, decode_slots=2,
                                             max_seq_len=MAX_LEN),
                        device="cpu"))
    assert isinstance(eng, EngineProtocol)
    for attr in ENGINE_ATTRS:
        assert hasattr(eng, attr), f"{kind} missing {attr}"

    class Almost:
        def submit(self, req):
            return True
    assert not isinstance(Almost(), EngineProtocol)


def test_spec_from_args_and_both_topologies(pair):
    _, _, tm, tp = pair
    serve_ns = argparse.Namespace(
        slots=4, block_size=2, kv="paged", kv_block_size=8,
        num_kv_blocks=32, sched="slo", prefix_share=True, disagg=True,
        prefill_slots=1, decode_slots=3, prefill_kv_blocks=None,
        decode_kv_blocks=None, prefill_engines=2, kv_routing="queue",
        kv_dtype="int8", group=4)
    spec = RolloutSpec.from_args(serve_ns)
    assert (spec.num_slots, spec.kv_layout, spec.kv_block_size,
            spec.block_size) == (4, "paged", 8, 2)
    assert spec.disagg == {"prefill_slots": 1, "decode_slots": 3,
                           "prefill_engines": 2, "kv_routing": "queue"}
    assert spec.kv_dtype == "int8" and spec.sched == "slo"
    assert spec.prefix_share and spec.group == 4
    train_ns = argparse.Namespace(
        slots=None, kv="paged", kv_block_size=16, sched="fifo",
        kv_dtype=None, prefix_share=True, carry=True, group=4)
    spec = RolloutSpec.from_args(train_ns)
    assert spec.num_slots is None and spec.prefix_share and spec.carry
    assert spec.disagg is None
    mono = RolloutSpec(num_slots=2).build_engine(
        tm, tp, batch=2, max_seq_len=MAX_LEN, eos_id=-1, temperature=0.0,
        device="cpu")
    assert isinstance(mono, Engine)
    dis = RolloutSpec(num_slots=4, disagg=True).build_engine(
        tm, tp, batch=4, max_seq_len=MAX_LEN, eos_id=-1, temperature=0.0,
        device="cpu")
    assert isinstance(dis, DisaggRouter)
    assert (dis.config.prefill_slots, dis.config.decode_slots) == (1, 3)


@pytest.mark.parametrize("module,argv,want", [
    ("serve", ["--kv", "paged", "--prefix-share", "--group", "4",
               "--batch", "2"], "6 prefix hits"),
    ("serve", ["--disagg", "--batch", "4", "--slots", "4"],
     "4 KV transfers"),
    ("train", ["--steps", "1", "--batch", "2", "--group", "2",
               "--rollout", "engine", "--kv", "paged", "--prefix-share"],
     "final reward")])
def test_clis_on_the_cpu(module, argv, want, monkeypatch, capsys):
    if module == "serve":
        from repro_torch.launch.serve import _main
    else:
        from repro_torch.launch.train import _main
    monkeypatch.setattr(sys, "argv", [module, "--reduced", "--device",
                                      "cpu", "--max-new", "4"] + argv)
    _main()
    assert want in capsys.readouterr().out



def _train(pair, **spec_kw):
    from repro_torch.launch.train import run_training
    _, _, tm, tp = pair
    return run_training(
        model=tm, params=jax.tree.map(lambda t: t.clone(), tp), steps=2,
        batch=2, group=4, max_new=6, rollout="engine", device="cpu",
        log_every=0, spec=RolloutSpec(kv_layout="paged", kv_block_size=BS,
                                      **spec_kw))


@pytest.fixture(scope="module")
def plain_training(pair):
    return _train(pair)


# a prefill pool as wide as the batch: every row is adopted before the
# first decode tick, as the monolithic engine admits it, so the sampled
# rows draw the same noise (with fewer prefill slots a row starts a tick
# later and draws another row of it: equal in distribution, not in bits)
@pytest.mark.parametrize("spec_kw", [
    {"prefix_share": True},
    {"prefix_share": True, "disagg": {"prefill_slots": 8,
                                      "decode_slots": 8}}],
    ids=["prefix_share", "disagg+prefix_share"])
def test_grpo_training_through_spec_bit_for_bit(pair, plain_training,
                                                spec_kw):
    """Two GRPO iterations (batch 2 x group 4, sampled at temperature 1)
    through ``run_training(spec=...)`` equal the plain paged engine
    rollout's bit for bit: losses, rewards, the trained weights; with
    sharing each iteration prefills only its distinct prompts."""
    s0, h0 = plain_training
    s1, h1 = _train(pair, **spec_kw)
    for k in ("loss", "reward", "tokens"):
        assert [r[k] for r in h0] == [r[k] for r in h1], k
    for a, b in zip(jax.tree.leaves(s0["params"]),
                    jax.tree.leaves(s1["params"])):
        assert torch.equal(a, b)
    if "disagg" not in spec_kw:          # (a router's prefills count its
        # adoptions too, as the JAX router's do)
        assert all(r["prefills"] - r["prefix_hits"] <= 2 for r in h1)


def dequantized(one):
    """An int8 handle's cache as the JAX package hands it over: each
    block leaf dequantized (to float32, the reduced model's dtype), the
    scales dropped."""
    return {name: (dequantize_kv(t, one[name + SCALE_SUFFIX])
                   if name + SCALE_SUFFIX in one else t)
            for name, t in one.items() if not name.endswith(SCALE_SUFFIX)}


def test_int8_handle_payload(pair):
    """Between int8 pools a handle carries the int8 values and scales as
    stored: bit for bit with the monolithic int8 engine.  The JAX
    package's interchange (dequantize out, quantize in) recomputes each
    scale from a dequantized float32 block, an ulp off, which moves the
    logprobs by about 1e-6 (ROADMAP §3)."""
    _, _, tm, tp = pair
    prompts = _prompts()
    kw = dict(kv_layout="paged", kv_dtype="int8")
    mono = _mono(tm, tp, _reqs(prompts), **kw)
    raw, _ = _router(tm, tp, _reqs(prompts), **kw)
    _same(mono, raw)
    router = DisaggRouter(tm, tp, DisaggConfig(
        prefill_slots=1, decode_slots=2, max_seq_len=MAX_LEN,
        kv_block_size=BS, **kw), device="cpu")
    pe = router.prefill
    pe.export_cache = lambda h: dequantized(PrefillEngine.export_cache(pe, h))
    for r in _reqs(prompts):
        router.submit(r)
    deq = {o.rid: o for o in router.run()}
    diff = max(np.abs(np.subtract(deq[r].logprobs, mono[r].logprobs)).max()
               for r in mono)
    assert all(deq[r].tokens == mono[r].tokens for r in mono)
    assert 0.0 < diff < 1e-5
