"""Elastic serving on the port against the JAX package's.

The port's ``serve/elastic.py`` (plain kernel versions on the CPU) and the
JAX package's on converted reduced-internlm2 weights, float32:

* ``resize_engine`` from the same mid-run state (two requests live, two
  queued) on contiguous and paged KV: tokens equal the JAX engine's,
  logprobs within 1e-4, and the carried counters are monotone (steps and
  prefills kept, every suspend resumed);
* a shrink below the live count raises, a same-size resize returns the
  engine itself;
* the conservation case: a paged pool holding radix pins and an agentic
  handle at the resize; the handle resumes on the new engine and both
  pools end clean, the tokens the port's static run's;
* a ladder 4 -> 8 -> 16 across the 16 rows where the plain mean of
  squares and the products' kernels would change their rounding, and a
  static engine of 16 slots, both bit for bit (tokens and logprobs) with
  a static engine of 8 slots: the decode step runs on ``DECODE_ROWS``
  rows at any slot count up to 16;
* ``run_trace`` with a controller forced up a 1 -> 2 -> 4 ladder, and a
  router resized the same way, give the static run's tokens; under a
  deadline that degrades, every degraded request's tokens are a prefix of
  the static run's and every shed is recorded;
* ``ElasticController`` driven by one seeded sequence of stub snapshots
  and requests gives the JAX controller's verdicts, clamps, resize
  targets and summary, value for value, for an engine and a router;
* ``rederive_slo`` gives the JAX bound on the same phase profiles.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.phase_control import PhaseProfile as JaxProfile  # noqa
from repro.core.telemetry import MetricsSnapshot as JaxSnapshot  # noqa
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import elastic as jelastic  # noqa: E402
from repro.serve.sched import SLOPolicy as JaxSLOPolicy  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.phase_control import PhaseProfile  # noqa: E402
from repro_torch.core.telemetry import MetricsSnapshot  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import (DisaggConfig, DisaggRouter,  # noqa: E402
                               ElasticConfig, ElasticController, Engine,
                               EngineConfig, Request, rederive_slo,
                               resize_engine, resize_router, run_trace)
from repro_torch.serve import elastic as telastic  # noqa: E402
from repro_torch.serve.sched import FIFOPolicy, SLOPolicy  # noqa: E402

ARCH = "internlm2-1.8b"
MAX_NEW, MAX_LEN, PROMPT = 6, 24, 7


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(ARCH, reduced=True)
    jp = jm.init(jax.random.PRNGKey(1))
    return jm, jp, build_model(ARCH, reduced=True), from_jax_params(
        jax.tree.map(np.asarray, jp))


def _requests(cls, n, max_new=MAX_NEW, deadline=None):
    rs = np.random.RandomState(5)
    return [cls(rid=i, prompt=rs.randint(0, 256, PROMPT).astype(np.int32),
                max_new_tokens=max_new, deadline=deadline)
            for i in range(n)]


def _engine(pair, slots, **over):
    _, _, tm, tp = pair
    kw = dict(num_slots=slots, max_seq_len=MAX_LEN, temperature=0.0,
              eos_id=-1)
    kw.update(over)
    return Engine(tm, tp, EngineConfig(**kw), device="cpu")


def _static_tokens(pair, n, **over):
    eng = _engine(pair, 4, **over)
    for r in _requests(Request, n):
        eng.submit(r)
    return {o.rid: o.tokens for o in eng.run()}


@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_resize_engine_matches_jax(pair, kv):
    jm, jp, _, _ = pair
    kw = dict(num_slots=2, max_seq_len=MAX_LEN, temperature=0.0, eos_id=-1,
              kv_layout=kv, kv_block_size=4)
    jeng = JaxEngine(jm, jp, JaxEngineConfig(**kw))
    teng = _engine(pair, 2, kv_layout=kv, kv_block_size=4)
    outs = []
    for eng, cls, resize in ((jeng, JaxRequest, jelastic.resize_engine),
                             (teng, Request, resize_engine)):
        for r in _requests(cls, 4):
            eng.submit(r)
        for _ in range(3):
            eng.step()
        before = eng.metrics()
        assert (before.num_active, before.queue_depth) == (2, 2)
        new = resize(eng, 4)
        after = new.metrics()
        assert new is not eng and new.config.num_slots == 4
        assert (after.steps, after.prefills) == (before.steps,
                                                 before.prefills + 2)
        assert after.suspends == before.suspends + 2 == after.resumes
        outs.append({o.rid: o for o in new.run()})
        m = new.metrics()
        assert m.steps > after.steps and m.prefills == after.prefills + 2
    jout, tout = outs
    assert sorted(tout) == sorted(jout) == [0, 1, 2, 3]
    for rid, o in tout.items():
        assert o.tokens == jout[rid].tokens, rid
        np.testing.assert_allclose(o.logprobs, jout[rid].logprobs, atol=1e-4,
                                   rtol=0)
        assert o.token_versions == jout[rid].token_versions


def test_resize_refusals_and_noop(pair):
    eng = _engine(pair, 4)
    for r in _requests(Request, 4):
        eng.submit(r)
    eng.step()
    assert eng.num_active == 4
    with pytest.raises(ValueError, match="live requests"):
        resize_engine(eng, 2)
    with pytest.raises(ValueError, match=">= 1"):
        resize_engine(eng, 0)
    assert resize_engine(eng, 4) is eng


def test_resize_conserves_blocks_with_suspended_handle_and_radix(pair):
    eng = _engine(pair, 2, kv_layout="paged", kv_block_size=4,
                  num_kv_blocks=64, prefix_share=True)
    for r in _requests(Request, 3):
        eng.submit(r)
    for _ in range(2):
        eng.step()
    held = eng._suspend_slot(sorted(eng._active)[0])
    assert eng.slots.alloc.refcount and len(eng.radix)
    new = resize_engine(eng, 4)        # conservation asserted inside
    new.resume(held, continue_output=True)
    outs = {o.rid: o.tokens for o in new.run()}
    assert outs == _static_tokens(pair, 3, kv_layout="paged",
                                  kv_block_size=4)
    eng.slots.alloc.assert_clean(context="test")
    new.radix.flush()
    new.slots.alloc.assert_clean(context="test")


def _forced_ladder():
    return ElasticController(ElasticConfig(
        ladder=(1, 2, 4), interval_s=0.0, cooldown_s=0.0,
        grow_pressure=0.5))


@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_run_trace_with_controller_matches_static(pair, kv):
    static = _static_tokens(pair, 8, kv_layout=kv, kv_block_size=4)
    ctl = _forced_ladder()
    rep = run_trace(_engine(pair, 1, kv_layout=kv, kv_block_size=4),
                    _requests(Request, 8), realtime=False, controller=ctl)
    e = rep["elastic"]
    assert e["resizes"] >= 1 and e["resizes"] == len(e["resize_log"])
    assert e["sheds"] == 0 and e["class_counts"]["batch"]["admitted"] == 8
    assert e["capacity_log"][0][1] == 1
    assert [c[1] for c in e["capacity_log"][1:]] == \
        [r[2] for r in e["resize_log"]]
    assert rep["engine"].config.num_slots == e["resize_log"][-1][2]
    assert {o.rid: o.tokens for o in rep["outputs"]} == static


@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_ladder_across_16_slots_bit_for_bit(pair, kv):
    n = 20

    def static(slots):
        eng = _engine(pair, slots, kv_layout=kv, kv_block_size=4)
        for r in _requests(Request, n):
            eng.submit(r)
        return {o.rid: o for o in eng.run()}
    ref, ref16 = static(8), static(16)
    ctl = ElasticController(ElasticConfig(
        ladder=(4, 8, 16), interval_s=0.0, cooldown_s=0.0,
        grow_pressure=0.5))
    rep = run_trace(_engine(pair, 4, kv_layout=kv, kv_block_size=4),
                    _requests(Request, n), realtime=False, controller=ctl)
    assert max(c[1] for c in rep["elastic"]["capacity_log"]) == 16
    got = {o.rid: o for o in rep["outputs"]}
    for run in (ref16, got):
        assert sorted(run) == sorted(ref)
        for rid, o in run.items():
            assert o.tokens == ref[rid].tokens, rid
            np.testing.assert_array_equal(o.logprobs, ref[rid].logprobs)


def test_degraded_requests_are_prefixes_and_sheds_recorded(pair):
    static = _static_tokens(pair, 8)
    eng = _engine(pair, 1)
    # a measured service time, so that the predictor has something to read
    eng.submit(_requests(Request, 1)[0])
    eng.run()
    eng.finished.clear()
    ctl = ElasticController(ElasticConfig(ladder=(1,), shed=True,
                                          min_degrade_tokens=2))
    tpt = eng.metrics().time_per_token
    reqs = _requests(Request, 8, deadline=3.5 * tpt)
    rep = run_trace(eng, reqs, realtime=False, controller=ctl)
    e = rep["elastic"]
    done = {o.rid: o.tokens for o in rep["outputs"]}
    shed = {r["rid"] for r in e["shed_records"]}
    assert e["sheds"] == len(shed) and not shed & set(done)
    assert shed | set(done) == set(range(8))
    clamped = {r["rid"]: r["to"] for r in e["degrade_records"]}
    assert e["degrades"] >= 1
    for rid, toks in done.items():
        want = static[rid][:clamped.get(rid, MAX_NEW)]
        assert toks == want, rid
    cc = e["class_counts"]["interactive"]
    assert cc["admitted"] + cc["shed"] == 8


def test_resize_router_matches_monolithic(pair):
    _, _, tm, tp = pair

    def router(decode):
        return DisaggRouter(tm, tp, DisaggConfig(
            prefill_slots=1, decode_slots=decode, max_seq_len=MAX_LEN,
            temperature=0.0, eos_id=-1, kv_layout="paged", kv_block_size=4),
            device="cpu")

    mono = _static_tokens(pair, 6, kv_layout="paged", kv_block_size=4)
    r = router(2)
    for q in _requests(Request, 6):
        r.submit(q)
    for _ in range(3):
        r.step()
    before = r.metrics()
    new = resize_router(r, decode_slots=4, prefill_slots=2)
    assert new.config.decode_slots == 4 and new.config.prefill_slots == 2
    assert new.metrics().transfers == before.transfers
    assert resize_router(new, decode_slots=4) is new
    assert {o.rid: o.tokens for o in new.run()} == mono
    rep = run_trace(router(1), _requests(Request, 6), realtime=False,
                    controller=_forced_ladder())
    assert rep["elastic"]["resizes"] >= 1
    assert {o.rid: o.tokens for o in rep["outputs"]} == mono


# ---------------------------------------------------------------------------
# The controller and the SLO re-derivation, value for value
# ---------------------------------------------------------------------------
class _StubEngine:
    """What the controller reads of an engine or a router: ``metrics()``
    (the next of a seeded sequence of readings), the slot counts, the live
    count and the policy."""

    def __init__(self, snap_cls, readings, slots, router=False,
                 prefill=1):
        self._snap_cls, self._readings = snap_cls, readings
        self.policy = FIFOPolicy()
        if router:
            self.pending_transfer = ()
            self.config = DisaggConfig(prefill_slots=prefill,
                                       decode_slots=slots)
            self.decode = self
            self.prefill = self
        else:
            self.config = EngineConfig(num_slots=slots)
        self.num_active = 0

    def metrics(self):
        queue, frac, steps, dt = self._readings.pop(0)
        slots = getattr(self.config, "num_slots", None) or \
            self.config.decode_slots
        self.num_active = int(frac * slots)
        return self._snap_cls(queue_depth=queue, num_slots=slots,
                              num_active=self.num_active, steps=steps,
                              decode_time_s=dt)


def _drive(ctl_cls, cfg_cls, snap_cls, req_cls, module, monkeypatch,
           router):
    rs = np.random.RandomState(11)
    readings = [(int(rs.randint(0, 12)), float(rs.rand()),
                 int(rs.randint(0, 400)), float(rs.rand() * 2))
                for _ in range(400)]
    resized = []

    def fake_resize(engine, num_slots=None, *, decode_slots=None,
                    prefill_slots=None, **_):
        target = num_slots if num_slots is not None else decode_slots
        resized.append((target, prefill_slots))
        return _StubEngine(snap_cls, readings, target, router=router,
                           prefill=prefill_slots or 1)

    monkeypatch.setattr(module, "resize_router" if router else
                        "resize_engine", fake_resize)
    ctl = ctl_cls(cfg_cls(ladder=(1, 2, 4, 8), interval_s=0.1,
                          cooldown_s=0.3, shed=True, min_degrade_tokens=4))
    eng = _StubEngine(snap_cls, readings, 2, router=router, prefill=1)
    ctl.attach(eng, 0.0)
    verdicts = []
    for i in range(120):
        now = 0.05 * i
        deadline = None if i % 5 == 0 else now + float(rs.rand() * 3)
        req = req_cls(rid=i % 100, prompt=np.arange(3, dtype=np.int32),
                      max_new_tokens=int(rs.randint(1, 64)),
                      deadline=deadline)
        v, out = ctl.admit(req, now, eng)
        verdicts.append((v, out.max_new_tokens))
        eng = ctl.maybe_resize(eng, now)
    return verdicts, resized, ctl.summary(6.0)


@pytest.mark.parametrize("router", [False, True])
def test_controller_matches_jax(monkeypatch, router):
    from repro.serve import ElasticConfig as JaxElasticConfig
    from repro.serve import ElasticController as JaxElasticController
    port = _drive(ElasticController, ElasticConfig, MetricsSnapshot,
                  Request, telastic, monkeypatch, router)
    ref = _drive(JaxElasticController, JaxElasticConfig, JaxSnapshot,
                 JaxRequest, jelastic, monkeypatch, router)
    assert port == ref
    verdicts, resized, summary = port
    assert {v for v, _ in verdicts} == {"admit", "degrade", "shed"}
    assert resized and summary["resizes"] == len(resized)


def test_rederive_slo_matches_jax():
    class Runtime:
        def __init__(self, cls, profiles):
            self._p = {p.job_id: cls(**dataclasses.asdict(p))
                       for p in profiles}

        def phase_profiles(self):
            return self._p

    profiles = [PhaseProfile(job_id="job0", rollout_s=(2.0, 2.2),
                             train_s=(1.0, 1.1)),
                PhaseProfile(job_id="job1", rollout_s=(0.7, 0.9, 0.8),
                             train_s=(1.9, 2.1, 2.0))]
    for margin in (1.0, 1.3):
        tpol, jpol = SLOPolicy(slowdown=2.0), JaxSLOPolicy(slowdown=2.0)
        got = rederive_slo(tpol, Runtime(PhaseProfile, profiles),
                           margin=margin, rollout_nodes=2)
        want = jelastic.rederive_slo(jpol, Runtime(JaxProfile, profiles),
                                     margin=margin, rollout_nodes=2)
        assert got == want and tpol.slowdown == jpol.slowdown == got
    assert rederive_slo(FIFOPolicy(), Runtime(PhaseProfile, profiles)) \
        is None
    assert rederive_slo(SLOPolicy(), None) is None
    assert rederive_slo(SLOPolicy(), Runtime(PhaseProfile, [])) is None
