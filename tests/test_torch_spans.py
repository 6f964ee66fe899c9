"""The port's span recorder (``core.telemetry``) and the sites that record
spans in a GRPO iteration.

Reduced internlm2 in float32 on the CPU (plain kernel versions), rollouts
through the engine:

* with recording off a ``run_sequential`` records nothing, and no site
  makes a span: each gets the one shared ``NO_SPAN``;
* with it on, each rollout holds one ``engine.reset``, one
  ``engine.prefill`` a row with distinct request ids, as many
  ``engine.step`` spans holding an ``engine.tick`` as the engine ran
  blocks, and tick spans that sum exactly to its ``decode_time_s``; each
  train phase holds one ``train.forward``, ``train.backward`` and
  ``train.adamw``;
* in ``run_coexec`` each job's spans have only that job's parents, on its
  own thread; each ``phase`` holds its job's ``permit.wait``,
  ``cache.restore`` and ``cache.offload``, and the weight sync's offload
  sits under a ``sync`` span;
* the recorder itself: parents, job ids, clock readings given by the
  caller, discarded spans, what an exception leaves open, and threads that
  never adopt each other's spans under a short switch interval.
"""
import sys
import threading
from collections import Counter, defaultdict

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import numpy as np  # noqa: E402

from repro_torch.core import telemetry  # noqa: E402
from repro_torch.core.phase_control import RollMuxRuntime  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.rl.coexec import (GRPOJob, run_coexec,  # noqa: E402
                                   run_sequential)

KW = dict(steps=2, batch=2, group=2, max_new=5, temperature=1.0,
          rollout="engine", num_slots=3)


def toy_reward(completions, mask, answers):
    c = np.asarray(completions, np.int64)
    m = np.asarray(mask)
    return ((c * m).sum(axis=1) % 5).astype(np.float32)


class CountingJob(GRPOJob):
    """Keeps each rollout's engine blocks and decode seconds."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.rollouts = []

    def rollout_step(self, params, k):
        b, out = super().rollout_step(params, k)
        (eng,) = self._engines.values()
        self.rollouts.append((eng._stats.blocks,
                              out["engine_stats"].decode_time_s))
        return b, out


def make_job(model, jid="job0", seed=0):
    return CountingJob(jid, model=model, seed=seed, reward_fn=toy_reward,
                       device="cpu", **KW)


@pytest.fixture
def recording():
    """Recording on for one test, off and emptied afterwards."""
    telemetry.take_spans()
    telemetry.set_recording(True)
    try:
        yield
    finally:
        telemetry.set_recording(False)
        telemetry.take_spans()


@pytest.fixture(scope="module")
def model():
    return build_model("internlm2-1.8b", reduced=True)


def _recorded(run):
    telemetry.take_spans()
    telemetry.set_recording(True)
    try:
        out = run()
    finally:
        telemetry.set_recording(False)
    return out, telemetry.take_spans()


@pytest.fixture(scope="module")
def sequential(model):
    job = make_job(model)
    _, spans = _recorded(lambda: run_sequential(job))
    return job, spans


@pytest.fixture(scope="module")
def coexec(model):
    jobs = [make_job(model, "job0", 0), make_job(model, "job1", 1)]
    _, spans = _recorded(lambda: run_coexec(jobs))
    return jobs, spans


def children(spans):
    out = defaultdict(list)
    for s in spans:
        out[s.parent].append(s)
    return out


def under(spans, top):
    """Every span beneath ``top`` (children, their children, ...)."""
    kids, out, todo = children(spans), [], [top.id]
    while todo:
        for s in kids[todo.pop()]:
            out.append(s)
            todo.append(s.id)
    return out


def named(spans, name):
    return sorted((s for s in spans if s.name == name), key=lambda s: s.t0_ns)


# ---- recording off ---------------------------------------------------------
def test_off_records_nothing_and_every_site_gets_the_shared_no_op(
        model, monkeypatch):
    telemetry.set_recording(False)
    telemetry.take_spans()

    def refuse(*a, **kw):
        raise AssertionError("a site made a span with recording off")
    monkeypatch.setattr(telemetry, "Span", refuse)
    run_sequential(make_job(model), steps=1)
    assert telemetry.take_spans() == []
    assert (telemetry.span("engine.tick", device=torch.device("cpu"))
            is telemetry.span("cache.offload") is telemetry.phase_span("j:r")
            is telemetry.NO_SPAN)
    sp = telemetry.NO_SPAN
    with sp as inner:
        inner.note(nbytes=1)
        inner.discard()
    assert sp.start(1) is sp and sp.stop(2) is None


# ---- run_sequential --------------------------------------------------------
def test_each_rollout_holds_one_engine_reset_and_its_named_parts(sequential):
    job, spans = sequential
    rollouts = named(spans, "rollout")
    assert len(rollouts) == KW["steps"]
    for r in rollouts:
        names = Counter(s.name for s in under(spans, r))
        assert names["engine.reset"] == 1
        assert names["rollout.pack"] == names["rollout.sync"] == 1
        assert r.job == "job0"


def test_one_prefill_a_row_with_distinct_request_ids(sequential):
    _, spans = sequential
    rows = KW["batch"] * KW["group"]
    for r in named(spans, "rollout"):
        pre = [s for s in under(spans, r) if s.name == "engine.prefill"]
        assert sorted(s.rid for s in pre) == list(range(rows))
        by_id = {s.id: s for s in spans}
        assert {by_id[s.parent].name for s in pre} == {"engine.admit"}
        assert all(s.device_s is None for s in pre)     # no events off the card


def test_steps_with_a_tick_count_the_engine_blocks(sequential):
    job, spans = sequential
    kids = children(spans)
    for r, (blocks, _) in zip(named(spans, "rollout"), job.rollouts):
        steps = [s for s in under(spans, r) if s.name == "engine.step"]
        ticked = [s for s in steps
                  if any(c.name == "engine.tick" for c in kids[s.id])]
        assert blocks > 0 and len(ticked) == blocks
        for s in steps:
            assert Counter(c.name for c in kids[s.id])["engine.admit"] == 1


def test_tick_spans_sum_exactly_to_decode_time(sequential):
    job, spans = sequential
    for r, (_, decode_s) in zip(named(spans, "rollout"), job.rollouts):
        ticks = [s for s in under(spans, r) if s.name == "engine.tick"]
        ticks.sort(key=lambda s: s.t0_ns)
        assert decode_s > 0
        total = 0.0       # added in the engine's order (sum() compensates)
        for s in ticks:
            total += s.seconds
        assert total == decode_s


def test_each_train_step_holds_forward_backward_and_adamw_once(sequential):
    _, spans = sequential
    trains = named(spans, "train")
    assert len(trains) == KW["steps"]
    for t in trains:
        names = Counter(s.name for s in under(spans, t))
        for n in ("train.forward", "train.backward", "train.adamw",
                  "train.reward", "train.batch", "train.sync"):
            assert names[n] == 1, n
    by_id = {s.id: s for s in spans}
    for p in named(spans, "phase"):
        assert p.kind in ("roll", "train") and p.job == "job0"
    for t in trains:
        assert by_id[t.parent].name == "phase"
        assert by_id[t.parent].kind == "train"


# ---- run_coexec ------------------------------------------------------------
def test_coexec_spans_have_only_their_own_jobs_parents(coexec):
    _, spans = coexec
    by_id = {s.id: s for s in spans}
    jobs_of_thread = defaultdict(set)
    for s in spans:
        if s.parent is None:
            continue
        p = by_id[s.parent]
        assert s.job == p.job and s.thread == p.thread, (s, p)
        assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
        jobs_of_thread[s.thread].add(s.job)
    assert sorted(j for js in jobs_of_thread.values() for j in js) == [
        "job0", "job1"]


def test_coexec_phases_hold_their_wait_restore_and_offload(coexec):
    jobs, spans = coexec
    kids = children(spans)
    phases = named(spans, "phase")
    assert len(phases) == 2 * len(jobs) * KW["steps"]
    for p in phases:
        names = Counter(c.name for c in kids[p.id])
        assert names["permit.wait"] == 1
        assert names["cache.restore"] == names["cache.offload"] == 1
        assert {c.job for c in kids[p.id]} == {p.job}
        wait = next(c for c in kids[p.id] if c.name == "permit.wait")
        assert wait.t0_ns == min(c.t0_ns for c in kids[p.id])
        body = "rollout" if p.kind == "roll" else "train"
        assert names[body] == 1
        assert all(c.bytes > 0 for c in kids[p.id]
                   if c.name.startswith("cache."))


def test_coexec_weight_sync_offloads_under_a_sync_span(coexec):
    jobs, spans = coexec
    kids = children(spans)
    syncs = named(spans, "sync")
    assert Counter(s.job for s in syncs) == {j.job_id: KW["steps"]
                                             for j in jobs}
    for s in syncs:
        assert s.parent is None
        (off,) = kids[s.id]
        assert off.name == "cache.offload" and off.job == s.job
        assert off.bytes > 0


# ---- the recorder ----------------------------------------------------------
def test_parents_jobs_and_request_ids_nest(recording):
    with telemetry.span("a", job="j"):
        with telemetry.span("b", kind="k"):
            with telemetry.span("c", rid=3) as c:
                c.note(nbytes=10)
    recs = {s.name: s for s in telemetry.take_spans()}
    assert recs["a"].parent is None
    assert recs["b"].parent == recs["a"].id
    assert recs["c"].parent == recs["b"].id
    assert [recs[n].job for n in "abc"] == ["j"] * 3
    assert (recs["b"].kind, recs["c"].rid, recs["c"].bytes) == ("k", 3, 10)
    assert recs["a"].t0_ns <= recs["c"].t0_ns <= recs["c"].t1_ns
    assert telemetry.take_spans() == []


def test_caller_clock_readings_are_kept_as_given(recording):
    sp = telemetry.span("engine.tick", device=torch.device("cpu"))
    sp.start(1_000)
    sp.stop(2_500)
    (rec,) = telemetry.take_spans()
    assert (rec.t0_ns, rec.t1_ns, rec.seconds) == (1_000, 2_500, 1.5e-6)
    assert rec.device_s is None


def test_discarded_and_abandoned_spans_are_not_recorded(recording):
    with telemetry.span("kept"):
        with telemetry.span("dropped") as sp:
            sp.discard()
        telemetry.span("left open").start()
    with pytest.raises(ValueError):
        with telemetry.span("raised"):
            telemetry.span("open at the raise").start()
            raise ValueError
    with telemetry.span("after"):
        pass
    recs = {s.name: s for s in telemetry.take_spans()}
    assert set(recs) == {"kept", "raised", "after"}
    assert recs["after"].parent is None


def test_a_permit_carries_its_job_and_ends_its_wait_at_the_grant(recording):
    rt = RollMuxRuntime(host_cache_gb=0.01)
    with rt.permit("rollout", "j7:roll"):
        with telemetry.span("body"):
            pass
    recs = {s.name: s for s in telemetry.take_spans()}
    ph, wait, body = recs["phase"], recs["permit.wait"], recs["body"]
    assert (ph.job, ph.kind) == ("j7", "roll")
    assert wait.parent == body.parent == ph.id
    assert wait.job == body.job == "j7"
    assert wait.t1_ns <= body.t0_ns <= body.t1_ns <= ph.t1_ns


def test_a_cold_phase_records_init_and_no_restore(recording):
    rt = RollMuxRuntime(host_cache_gb=0.01)

    @rt.phase("train", init_fn=lambda: {"w": torch.zeros(4)})
    def step(state):
        state["w"] += 1
        return state, float(state["w"].sum())

    assert step("j0") == 4.0 and step("j0") == 8.0
    spans = telemetry.take_spans()
    kids = children(spans)
    cold, warm = named(spans, "phase")
    assert [c.name for c in sorted(kids[cold.id], key=lambda s: s.t0_ns)] == [
        "permit.wait", "init", "cache.offload"]
    assert [c.name for c in sorted(kids[warm.id], key=lambda s: s.t0_ns)] == [
        "permit.wait", "cache.restore", "cache.offload"]
    assert {c.bytes for c in kids[warm.id] if c.name.startswith("cache.")} == {
        16}


def test_threads_never_adopt_each_others_spans(recording):
    n_threads, n_iter = 8, 150
    errors = []

    def work(i):
        try:
            for _ in range(n_iter):
                with telemetry.span("outer", job=f"t{i}"):
                    with telemetry.span("inner"):
                        pass
        except BaseException as e:       # surfaced by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors
    spans = telemetry.take_spans()
    assert len(spans) == 2 * n_threads * n_iter
    assert len({s.id for s in spans}) == len(spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "inner":
            p = by_id[s.parent]
            assert p.name == "outer" and p.thread == s.thread
            assert p.job == s.job
        else:
            assert s.parent is None
    assert len({s.job for s in spans}) == n_threads
