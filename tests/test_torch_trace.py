"""The port's serving telemetry against the JAX engine's.

``run_trace``, ``Engine.metrics()``, the wall clock ``Engine.clock`` and
``EngineStats.time_per_token`` on the port (plain kernel versions on the
CPU) against the JAX package's engine with ``kernel_backend="pallas"``
(interpret mode) on converted reduced-internlm2 params:

* ``run_trace(realtime=False)`` over the same requests, 2 slots and
  ``max_waiting=1`` so that submissions are refused and deferred, half of
  them arriving far in the future so that the replay fast-forwards idle
  gaps; contiguous, paged and paged-int8.  Greedy tokens identical,
  logprobs within 1e-4 (int8 2e-3, as ``tests/test_torch_engine.py``
  states why), the same report keys, and equal counts: ``tokens``,
  ``peak_active``, ``rejected_submits``, ``slot_utilization``, the
  deadline counts (deadlines of 1e9) and the KV block counts.
* ``metrics()`` after that run: every field equal but the timed one
  (``decode_time_s``).
* A counting clock (each call returns the next multiple of 0.5) stamps
  first-token and finish times at the same calls in both engines, so the
  stamps are equal exactly, ``0 < first_token_time <= finish_time``, and
  the SLO policy's finish-interval fallback learns the same estimate.
"""
import itertools
import warnings

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import sched as jsched  # noqa: E402
from repro.serve.request import Request as JaxRequest  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.telemetry import MetricsSnapshot  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import (Engine, EngineConfig, Request,  # noqa: E402
                               SLOPolicy, run_trace)
from repro_torch.serve import engine as tengine  # noqa: E402

ARCH = "internlm2-1.8b"
N_REQ, PROMPT, MAX_NEW = 6, 7, 5
LAYOUTS = [("contiguous", None), ("paged", None), ("paged", "int8")]


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(ARCH, reduced=True)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(ARCH, reduced=True)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _trace(cls):
    """Prompts of one length (the JAX prefill compiles per length); the
    first half arrive at once, the rest far past any run's end, with
    deadlines no run misses."""
    rs = np.random.RandomState(3)
    return [cls(rid=i, prompt=rs.randint(0, 256, PROMPT).astype(np.int32),
                max_new_tokens=MAX_NEW - i % 2,
                arrival_time=0.0 if i < N_REQ // 2 else 1e6 + i,
                deadline=1e9)
            for i in range(N_REQ)]


def _engines(pair, layout, kv_dtype, **over):
    jm, jp, tm, tp = pair
    policy = over.pop("policy", None)
    kw = dict(num_slots=2, max_seq_len=PROMPT + MAX_NEW, max_waiting=1,
              kv_layout=layout, kv_block_size=4, kv_dtype=kv_dtype)
    kw.update(over)
    jeng = jengine.Engine(jm, jp, jengine.EngineConfig(
        kernel_backend="pallas", **kw), policy=policy and policy[0])
    teng = Engine(tm, tp, EngineConfig(**kw), device="cpu",
                  policy=policy and policy[1])
    return jeng, teng


def _check_outputs(touts, jouts, kv_dtype):
    assert [o.rid for o in touts] == [o.rid for o in jouts]
    for a, b in zip(touts, jouts):
        assert a.tokens == b.tokens and a.finish_reason == b.finish_reason
        np.testing.assert_allclose(a.logprobs, b.logprobs, rtol=0,
                                   atol=1e-4 if kv_dtype is None else 2e-3)


@pytest.mark.parametrize("layout,kv_dtype", LAYOUTS)
def test_run_trace_and_metrics_match_jax(pair, layout, kv_dtype):
    jeng, teng = _engines(pair, layout, kv_dtype)
    jrep = jengine.run_trace(jeng, _trace(JaxRequest), realtime=False)
    trep = run_trace(teng, _trace(Request), realtime=False)
    _check_outputs(trep["outputs"], jrep["outputs"], kv_dtype)
    assert set(trep) == set(jrep)
    counted = ["tokens", "peak_active", "rejected_submits",
               "slot_utilization", "deadline_total", "deadline_met",
               "deadline_attainment"]
    if layout == "paged":
        counted += ["kv_blocks_total", "peak_kv_blocks",
                    "kv_block_utilization"]
    assert {k: trep[k] for k in counted} == {k: jrep[k] for k in counted}
    assert trep["rejected_submits"] > 0          # backpressure happened
    assert trep["deadline_attainment"] == 1.0
    for o in trep["outputs"]:
        assert 0 <= o.arrival_time < o.first_token_time <= o.finish_time
    # rebased by the fast-forward: no request waited 1e6 s
    assert max(trep["latency_p95_s"], trep["ttft_mean_s"]) < 1e5
    assert teng.clock is None and jeng.clock is None
    tm, jmx = teng.metrics(), jeng.metrics()
    assert isinstance(tm, MetricsSnapshot)
    got, want = tm.to_dict(), jmx.to_dict()
    for timed in ("decode_time_s", "time_per_token"):
        assert got.pop(timed) > 0 and want.pop(timed) > 0
    assert got == want


def test_stats_warn_once_and_time_per_token(pair):
    _, _, tm, tp = pair
    eng = Engine(tm, tp, EngineConfig(num_slots=2, max_seq_len=16,
                                      block_size=2), device="cpu")
    for r in _trace(Request)[:3]:
        eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=4))
    eng.run()
    tengine._warned_legacy[0] = False
    with pytest.warns(DeprecationWarning, match="Engine.metrics"):
        s = eng.stats
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert eng.stats is s                   # once per process
    assert s.steps > 0 and s.steps % 2 == 0
    assert s.time_per_token == s.decode_time_s / s.steps
    assert eng.metrics().time_per_token == s.time_per_token
    assert s.prefix_hits == s.adoptions == s.suspends == s.resumes == 0
    # the suspend/resume counters count: one suspension, one resume (an
    # adoption), and the gauge of live handles between them
    o = eng.finished[0]
    stop = next(t for t in o.tokens if t != eng.config.eos_id)
    eng.reset()
    eng.submit(Request(rid=0, prompt=o.prompt, max_new_tokens=4,
                       stop_tokens=(stop,)))
    eng.run()
    [h] = eng.harvest_suspended()
    m = eng.metrics()
    assert (m.suspends, m.resumes, m.adoptions, m.suspended) == (1, 0, 0, 1)
    eng.resume(h, stop_tokens=())
    eng.run()
    m = eng.metrics()
    assert (m.suspends, m.resumes, m.adoptions, m.suspended) == (1, 1, 1, 0)
    assert m.prefix_hits == 0


def _counting_clock():
    c = itertools.count(1)
    return lambda: next(c) * 0.5


def test_clock_stamps_and_slo_fallback_match_jax(pair):
    """Every request finishes inside the one fused block of 4 steps the
    engine runs, so the SLO policy has no second step sample and learns
    from the finish intervals the clock stamped."""
    policies = (jsched.SLOPolicy(slowdown=2.0),
                SLOPolicy(slowdown=2.0))
    jeng, teng = _engines(pair, "paged", None, block_size=4, num_slots=4,
                          max_waiting=None, policy=policies)
    for eng, cls in ((jeng, JaxRequest), (teng, Request)):
        eng.clock = _counting_clock()
        for r in _trace(cls)[:4]:
            r.max_new_tokens = 3
            r.arrival_time = 0.0
            assert eng.submit(r)
        eng.run()
    touts = [teng.finished[r] for r in sorted(teng.finished)]
    jouts = [jeng.finished[r] for r in sorted(jeng.finished)]
    _check_outputs(touts, jouts, None)
    for a, b in zip(touts, jouts):
        assert 0 < a.first_token_time < a.finish_time
        assert (a.first_token_time, a.finish_time, a.deadline) == (
            b.first_token_time, b.finish_time, b.deadline)
    assert teng.metrics().steps == 4                    # one tick
    assert policies[1].time_per_token != 0.05           # it learned
    assert policies[1].time_per_token == policies[0].time_per_token
    # without a clock nothing is stamped, as in the JAX engine
    eng = Engine(pair[2], pair[3], EngineConfig(num_slots=1, max_seq_len=16),
                 device="cpu")
    eng.submit(Request(rid=0, prompt=_trace(Request)[0].prompt,
                       max_new_tokens=2))
    (o,) = eng.run()
    assert o.first_token_time == o.finish_time == 0.0


def test_run_trace_realtime_and_refusals(pair):
    """``realtime=True`` sleeps through an idle gap instead of rebasing
    arrivals; a ``controller=`` on a one-rung ladder never resizes and
    reports a capacity ratio of 1."""
    _, _, tm, tp = pair
    eng = Engine(tm, tp, EngineConfig(num_slots=2, max_seq_len=16),
                 device="cpu")
    reqs = [Request(rid=i, prompt=r.prompt, max_new_tokens=2,
                    arrival_time=0.0 if i == 0 else 0.3)
            for i, r in enumerate(_trace(Request)[:2])]
    rep = run_trace(eng, reqs)
    assert [o.rid for o in rep["outputs"]] == [0, 1]
    assert reqs[1].arrival_time == 0.3                  # not rebased
    assert rep["makespan_s"] >= 0.3
    assert rep["outputs"][1].first_token_time >= 0.3
    assert "kv_blocks_total" not in rep and "deadline_total" not in rep
    from repro_torch.serve import ElasticConfig, ElasticController
    eng = Engine(tm, tp, EngineConfig(num_slots=2, max_seq_len=16),
                 device="cpu")
    reqs = [Request(rid=i, prompt=r.prompt, max_new_tokens=2)
            for i, r in enumerate(_trace(Request)[:2])]
    ctl = ElasticController(ElasticConfig(ladder=(2,), interval_s=0.0,
                                          cooldown_s=0.0))
    rep = run_trace(eng, reqs, realtime=False, controller=ctl)
    e = rep["elastic"]
    assert [o.rid for o in rep["outputs"]] == [0, 1]
    assert e["resizes"] == 0 and e["sheds"] == 0
    assert e["capacity_seconds_ratio"] == pytest.approx(1.0)
    assert e["class_counts"] == {"batch": {"admitted": 2, "degraded": 0,
                                           "shed": 0}}
