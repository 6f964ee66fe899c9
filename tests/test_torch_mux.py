"""The port's phase-multiplexing executors and the engine surface they drive.

Reduced internlm2 in float32 on the CPU (plain kernel versions).  The
contract is the JAX package's (``tests/test_coexec.py``,
``tests/test_stream.py``): an executor changes when phases run, never what
they compute.  So, on the port:

* ``run_pipelined(max_staleness=0)`` and ``run_streaming(max_staleness=0)``
  are bit-exact (``torch.equal``) to ``run_sequential`` at temperature 1:
  losses, weights and AdamW moments;
* ``run_coexec`` is bit-exact to each job's solo ``run_sequential``, with
  every context switch a warm start, and its pools round-robin;
* at staleness 1 each rollout equals a fresh greedy rollout with the
  weights after ``k - rollout_staleness`` steps: the optimizer updates the
  weights in place, so a rollout served from the live tensors while a step
  runs would not;

and against the JAX package (converted weights, ``rollout="engine"``,
``kernel_backend="pallas"`` in interpret mode) each executor at
temperature 0 over two iterations gives identical tokens and rewards, and
loss, entropy and ratio diagnostics within 1e-4 (float32 summation order,
as ``tests/test_torch_train.py`` states).
"""
import sys
import threading

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.rl import coexec as jcoexec  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core import (PhaseStreams, hand_over,  # noqa: E402
                              take_over)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.rl.coexec import (GRPOJob, MuxConfig, run_coexec,  # noqa: E402
                                   run_pipelined, run_sequential)
from repro_torch.rl.rollout import (SamplerConfig,  # noqa: E402
                                    generate_continuous,
                                    generate_continuous_stream)
from repro_torch.rl.stream import run_streaming  # noqa: E402
from repro_torch.rl.train_step import make_train_step  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, Request  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig, tree_leaves,  # noqa: E402
                                         tree_map)

ARCH = "internlm2-1.8b"
KW = dict(steps=3, batch=3, group=2, max_new=6, temperature=1.0,
          rollout="engine")
DIAG = ("loss", "entropy", "clip_frac", "ratio_mean", "ratio_max")


def toy_reward(completions, mask, answers):
    """Row-wise reward that differs inside a group (a random model earns
    no arithmetic reward, which would make every advantage 0)."""
    c = np.asarray(completions, np.int64)
    m = np.asarray(mask)
    return ((c * m).sum(axis=1) % 5).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    return build_model(ARCH, reduced=True)


def make_job(model, jid="job0", seed=0, **over):
    kw = dict(KW, **over)
    return GRPOJob(jid, model=model, seed=seed, reward_fn=toy_reward,
                   device="cpu", **kw)


def assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def record_train_inputs(job):
    """Wrap ``job.train_phase`` to keep each step's rollout arrays (in
    call order, one call per iteration here) as numpy."""
    seen = []
    inner = job.train_phase

    def train_phase(state, b, out, rewards=None):
        seen.append({k: np.asarray(out[k]) for k in
                     ("completions", "behavior_logp", "mask")})
        return inner(state, b, out, rewards)
    job.train_phase = train_phase
    return seen


# ---------------------------------------------------------------------------
# (a), (b), (e): bit-exact to the sequential run; round-robin timelines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def solo(model):
    return {seed: run_sequential(make_job(model, f"job{seed}", seed))
            for seed in (0, 1)}


@pytest.mark.parametrize("mode", ["pipeline", "stream"])
def test_sync_executors_bit_exact_to_sequential(model, solo, mode):
    s_off, h_off, r_off = solo[0]
    run = run_pipelined if mode == "pipeline" else run_streaming
    state, hist, report = run(make_job(model), max_staleness=0)
    assert [r["loss"] for r in hist] == [r["loss"] for r in h_off]
    for key in ("reward", "tokens", "prefills", "decode_steps"):
        assert [r[key] for r in hist] == [r[key] for r in h_off], key
    assert all(r["rollout_staleness"] == 0 for r in hist)
    assert_trees_equal(state["params"], s_off["params"])
    assert_trees_equal(state["opt"], s_off["opt"])
    assert r_off.overlap_s == 0.0 and report.mode == mode
    if mode == "stream":
        assert all(r["micro_steps"] == 1 for r in hist)
        assert len(report.timelines["reward"]) == KW["steps"] * KW["batch"]


@pytest.fixture(scope="module")
def coexec_run(model):
    return run_coexec([make_job(model, "job0", 0), make_job(model, "job1", 1)])


def test_coexec_bit_exact_to_solo_runs(solo, coexec_run):
    states, hists, report = coexec_run
    for jid, seed in (("job0", 0), ("job1", 1)):
        s_solo, h_solo, _ = solo[seed]
        assert [r["loss"] for r in hists[jid]] == \
            [r["loss"] for r in h_solo], jid
        assert_trees_equal(states[jid]["params"], s_solo["params"])
        assert_trees_equal(states[jid]["opt"], s_solo["opt"])
    # every context switch after seeding was a warm start
    assert report.cache_stats["cold_misses"] == 0
    assert report.cache_stats["warm_hits"] > 0


def test_coexec_round_robin_timeline_no_overlap(coexec_run):
    _, _, report = coexec_run
    for pool in ("rollout", "train"):
        tl = sorted(report.timelines[pool], key=lambda e: e[1])
        assert len(tl) == 2 * KW["steps"]
        for (_, _, t1_prev), (_, t0_next, _) in zip(tl, tl[1:]):
            assert t0_next >= t1_prev - 1e-9
        users = [who.split(":")[0] for who, _, _ in tl]
        assert set(users) == {"job0", "job1"}
        for u_prev, u_next in zip(users[1:], users[2:]):
            assert u_prev != u_next, users
    for jid in ("job0", "job1"):
        prof = report.profiles[jid]
        assert len(prof.rollout_s) == len(prof.train_s) == KW["steps"]


# ---------------------------------------------------------------------------
# (c): a stale rollout is served from the weights of its version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["pipeline", "stream"])
def test_stale_rollouts_use_the_weights_of_their_version(model, mode):
    """Greedy at staleness 1: rollout k equals a fresh rollout with the
    weights after ``k - rollout_staleness`` optimizer steps.  The
    optimizer updates the weights in place; to make a step land inside a
    rollout every time, each decode step of a rollout waits for the train
    step in flight, so a rollout served from the live tensors would
    decode its later tokens with the new weights.  Greedy rows of a group
    are equal, so their advantages cancel and the gradient is 0: weight
    decay makes every step move the weights all the same."""
    params = model.init(torch.Generator().manual_seed(3))
    job = make_job(model, steps=4, temperature=0.0, params=params)
    job._train_step = make_train_step(
        model, AdamWConfig(lr=1e-2, weight_decay=0.1))
    weights = [tree_map(torch.clone, params)]   # after j optimizer steps
    cv = threading.Condition()
    running = [0]                               # train steps in flight
    inner_train = job.train_phase

    def train_phase(state, b, out, rewards=None):
        with cv:
            running[0] += 1
        try:
            state, rec = inner_train(state, b, out, rewards)
            weights.append(tree_map(torch.clone, state["params"]))
        finally:
            with cv:
                running[0] -= 1
                cv.notify_all()
        return state, rec
    job.train_phase = train_phase
    inner_engine = job._engine_for

    def engine_for(*args):
        eng = inner_engine(*args)
        if not hasattr(eng, "inner_step"):
            eng.inner_step = eng.step

            def step():
                n = eng.inner_step()
                with cv:
                    assert cv.wait_for(lambda: running[0] == 0, timeout=60)
                return n
            eng.step = step
        return eng
    job._engine_for = engine_for
    rollouts = []
    inner_batch = job.task.sample_batch

    def sample_batch(n):
        b = inner_batch(n)
        rollouts.append(np.repeat(b.prompts, job.group, axis=0))
        return b
    job.task.sample_batch = sample_batch
    seen = record_train_inputs(job)
    run = run_pipelined if mode == "pipeline" else run_streaming
    _, hist, _ = run(job, max_staleness=1)
    stale = [r["rollout_staleness"] for r in hist]
    assert all(s in (0, 1) for s in stale) and 1 in stale, stale
    assert not torch.equal(weights[0]["embed"], weights[-1]["embed"])
    sampler = SamplerConfig(max_new_tokens=KW["max_new"], temperature=0.0)
    for k, r in enumerate(hist):
        ref = generate_continuous(model, weights[k - r["rollout_staleness"]],
                                  rollouts[k], sampler, device="cpu")
        for key in ("completions", "behavior_logp", "mask"):
            np.testing.assert_array_equal(seen[k][key], ref[key].numpy(),
                                          err_msg=f"rollout {k} {key}")


# ---------------------------------------------------------------------------
# (d): each executor against the JAX package's run_sequential
# ---------------------------------------------------------------------------
JAX_KW = dict(steps=2, batch=2, group=2, max_new=6, temperature=0.0)


@pytest.fixture(scope="module")
def jax_runs():
    jm = jax_build(ARCH, reduced=True)
    out = {}
    for seed in (0, 1):
        job = jcoexec.GRPOJob(f"job{seed}", model=jm, seed=seed,
                              rollout="engine", kernel_backend="pallas",
                              reward_fn=toy_reward, **JAX_KW)
        params = from_jax_params(jax.tree.map(np.asarray,
                                              job.init_state()["params"]))
        seen = record_train_inputs(job)
        _, hist, _ = jcoexec.run_sequential(job)
        out[seed] = (params, hist, seen)
    return out


@pytest.mark.parametrize("mode", ["pipeline", "stream", "coexec"])
def test_executors_match_jax_sequential(model, jax_runs, mode):
    def job(seed):
        j = GRPOJob(f"job{seed}", model=model, seed=seed,
                    reward_fn=toy_reward, device="cpu", rollout="engine",
                    params=jax_runs[seed][0], **JAX_KW)
        return j, record_train_inputs(j)
    if mode == "coexec":
        jobs = [job(0), job(1)]
        _, hists, _ = run_coexec([j for j, _ in jobs])
        got = {s: (hists[f"job{s}"], jobs[s][1]) for s in (0, 1)}
    else:
        (j, seen) = job(0)
        run = run_pipelined if mode == "pipeline" else run_streaming
        _, hist, _ = run(j, max_staleness=0)
        got = {0: (hist, seen)}
    for seed, (hist, seen) in got.items():
        _, jhist, jseen = jax_runs[seed]
        assert len(hist) == len(jhist) == JAX_KW["steps"]
        for a, b in zip(seen, jseen):
            np.testing.assert_array_equal(a["completions"], b["completions"])
            np.testing.assert_array_equal(a["mask"], b["mask"])
            np.testing.assert_allclose(a["behavior_logp"], b["behavior_logp"],
                                       atol=1e-4, rtol=1e-4)
        for r, jr in zip(hist, jhist):
            assert (r["reward"], r["acc"], r["tokens"]) == (
                jr["reward"], jr["acc"], jr["tokens"])
            for k in DIAG:
                np.testing.assert_allclose(r[k], jr[k], atol=1e-4,
                                           rtol=1e-4, err_msg=k)


def test_stream_elastic_retunes_permits_without_changing_math(
        model, jax_runs, monkeypatch, capsys):
    """``run_streaming(elastic=True)`` moves only the reward permit bound
    (tests/test_elastic.py on the JAX package): its losses are those of
    the run without it, bit for bit, and those of the JAX package's
    ``run_streaming(elastic=True)`` at temperature 0 within 1e-4; every
    record carries ``reward_permits`` within [1, reward_workers], and no
    record without elastic does.  The CLI's ``--mux stream --elastic``
    runs."""
    from repro.rl.stream import run_streaming as jax_run_streaming

    def job():
        return GRPOJob("job0", model=model, seed=0, reward_fn=toy_reward,
                       device="cpu", rollout="engine",
                       params=jax_runs[0][0], **JAX_KW)
    _, h_ref, _ = run_streaming(job(), max_staleness=0, reward_workers=3)
    _, h_el, _ = run_streaming(job(), max_staleness=0, reward_workers=3,
                               elastic=True)
    jjob = jcoexec.GRPOJob("job0", model=jax_build(ARCH, reduced=True),
                           seed=0, rollout="engine", kernel_backend="pallas",
                           reward_fn=toy_reward, **JAX_KW)
    _, h_jax, _ = jax_run_streaming(jjob, max_staleness=0, reward_workers=3,
                                    elastic=True)
    assert [r["loss"] for r in h_ref] == [r["loss"] for r in h_el]
    assert all(1 <= r["reward_permits"] <= 3 for r in h_el + h_jax)
    assert all("reward_permits" not in r for r in h_ref)
    assert len(h_el) == len(h_jax) == JAX_KW["steps"]
    for r, jr in zip(h_el, h_jax):
        assert (r["reward"], r["tokens"]) == (jr["reward"], jr["tokens"])
        for k in DIAG:
            np.testing.assert_allclose(r[k], jr[k], atol=1e-4, rtol=1e-4,
                                       err_msg=k)
    monkeypatch.setattr(sys, "argv", [
        "train", "--reduced", "--device", "cpu", "--mux", "stream",
        "--elastic", "--steps", "2", "--batch", "2", "--group", "2",
        "--max-new", "4"])
    train_cli._main()
    assert "mux=stream" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# (f): the streamed groups are the batch rollout's arrays
# ---------------------------------------------------------------------------
def test_stream_groups_stack_to_the_batch_rollout(model):
    params = model.init(torch.Generator().manual_seed(1))
    prompts = np.random.RandomState(4).randint(0, 256, (6, 5)).astype(
        np.int32)
    sampler = SamplerConfig(max_new_tokens=7, temperature=1.0)
    kw = dict(num_slots=3, device="cpu", kv_layout="paged", kv_block_size=4)
    ref = generate_continuous(model, params, prompts, sampler,
                              generator=torch.Generator().manual_seed(2),
                              **kw)
    groups = list(generate_continuous_stream(
        model, params, prompts, sampler, group=2,
        generator=torch.Generator().manual_seed(2), **kw))
    assert sorted(g["group_index"] for g in groups) == [0, 1, 2]
    rows = np.concatenate([g["rows"] for g in groups])
    assert sorted(rows) == list(range(6))
    for key in ("completions", "behavior_logp", "mask", "token_versions"):
        stacked = np.empty_like(np.concatenate([g[key] for g in groups]))
        stacked[rows] = np.concatenate([g[key] for g in groups])
        want = ref[key] if isinstance(ref[key], np.ndarray) \
            else ref[key].numpy()
        np.testing.assert_array_equal(stacked, want, err_msg=key)


# ---------------------------------------------------------------------------
# (g): Engine.reset and the persistent engine
# ---------------------------------------------------------------------------
def _prompt():
    return np.asarray([1, 5, 9, 2], np.int32)


def test_engine_reset_refuses_a_live_engine_and_swaps_weights(model):
    p1 = model.init(torch.Generator().manual_seed(0))
    p2 = model.init(torch.Generator().manual_seed(1))
    eng = Engine(model, p1, EngineConfig(num_slots=1, max_seq_len=24),
                 device="cpu")
    eng.submit(Request(rid=0, prompt=_prompt(), max_new_tokens=3))
    eng.step()
    with pytest.raises(RuntimeError, match="live engine"):
        eng.reset()
    first = eng.run()
    assert eng.weight_version == 0
    assert first[0].token_versions == [0] * first[0].num_tokens
    eng.submit(Request(rid=1, prompt=_prompt(), max_new_tokens=3))
    with pytest.raises(RuntimeError, match="live engine"):
        eng.reset(p2)                       # queued: not drained
    eng.run()
    eng.reset(p2)
    assert eng.params is p2 and eng.weight_version == 1
    assert eng.idle and not eng.finished and not eng.harvest()
    assert eng.stats.prefills == 0 and eng.stats.steps == 0
    eng.submit(Request(rid=0, prompt=_prompt(), max_new_tokens=3))
    (out,) = eng.run()
    assert out.token_versions == [1] * out.num_tokens
    # the new weights serve: a fresh engine on p2 gives the same tokens
    fresh = Engine(model, p2, EngineConfig(num_slots=1, max_seq_len=24),
                   device="cpu")
    fresh.submit(Request(rid=0, prompt=_prompt(), max_new_tokens=3))
    assert fresh.run()[0].tokens == out.tokens
    # should_yield preempts between ticks; run() again continues
    eng.reset()
    assert eng.weight_version == 1          # no params: no new version
    eng.submit(Request(rid=0, prompt=_prompt(), max_new_tokens=3))
    assert eng.run(should_yield=lambda: True) == [] and not eng.idle
    assert len(eng.run()) == 1


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_persistent_engine_matches_a_new_engine_per_call(model, layout):
    """Two rollouts on one engine through reset equal two rollouts on new
    engines (same generator stream), and each call's stats count its own
    work only."""
    ps = [model.init(torch.Generator().manual_seed(s)) for s in (0, 1)]
    prompts = np.random.RandomState(5).randint(0, 256, (4, 5)).astype(
        np.int32)
    sampler = SamplerConfig(max_new_tokens=6, temperature=1.0)
    kw = dict(num_slots=2, device="cpu", kv_layout=layout, kv_block_size=4)
    g_new, g_eng = (torch.Generator().manual_seed(7) for _ in range(2))
    new = [generate_continuous(model, p, prompts, sampler, generator=g_new,
                               **kw) for p in ps]
    eng = Engine(model, ps[0], EngineConfig(
        num_slots=2, max_seq_len=5 + 6, temperature=1.0, kv_layout=layout,
        kv_block_size=4), device="cpu", generator=g_eng)
    reused = [generate_continuous(model, p, prompts, sampler, engine=eng,
                                  **kw) for p in ps]
    for i, (a, b) in enumerate(zip(new, reused)):
        for key in ("completions", "behavior_logp", "mask"):
            assert torch.equal(a[key], b[key]), key
        assert b["engine_stats"].prefills == 4
        assert b["engine_stats"].steps == a["engine_stats"].steps
        m = b["mask"].numpy() > 0
        assert (b["token_versions"][m] == i + 1).all()
        assert (b["token_versions"][~m] == -1).all()
        assert (a["token_versions"][m] == 0).all()
    assert reused[1]["engine_stats"] == eng.metrics()
    bad = [dict(kw, kv_layout="contiguous" if layout == "paged"
                else "paged"),
           dict(kw, kv_dtype="int8")]
    for over in bad:
        with pytest.raises(ValueError, match="persistent engine"):
            generate_continuous(model, ps[0], prompts, sampler, engine=eng,
                                **over)
    with pytest.raises(ValueError, match="max_seq_len"):
        generate_continuous(model, ps[0], prompts, SamplerConfig(
            max_new_tokens=7, temperature=1.0), engine=eng, **kw)
    with pytest.raises(ValueError, match="temperature"):
        generate_continuous(model, ps[0], prompts, SamplerConfig(
            max_new_tokens=6, temperature=0.0), engine=eng, **kw)


# ---------------------------------------------------------------------------
# (h), (i): configuration and what is refused by name
# ---------------------------------------------------------------------------
def test_mux_config_validates():
    with pytest.raises(ValueError):
        MuxConfig(mode="sideways")
    with pytest.raises(ValueError):
        MuxConfig(max_staleness=-1)
    with pytest.raises(ValueError):
        MuxConfig(reward_workers=0)
    with pytest.raises(ValueError):
        MuxConfig(micro_groups=0)
    cfg = MuxConfig(mode="pipeline")
    assert (cfg.max_staleness, cfg.host_cache_gb, cfg.reward_workers,
            cfg.micro_groups) == (1, 8.0, 2, None)


def test_what_needs_unported_modules_is_refused_by_name(model, monkeypatch):
    """Suspend/resume is ported, so what waited on it runs: ``reset(
    carry_live=True)``, ``sync_params``, a carry job and the CLI's
    ``--carry``.  What stays malformed is refused by name: ``--carry``
    without the engine rollout, coexec with one set of ``params``."""
    params = model.init(torch.Generator().manual_seed(0))
    eng = Engine(model, params, EngineConfig(num_slots=1, max_seq_len=16),
                 device="cpu")
    eng.reset(carry_live=True)             # nothing live: a plain reset
    assert eng.idle and eng.weight_version == 0
    polls = []

    def sync_params():
        polls.append(1)
        return params, int(len(polls) > 2)  # the version moves once
    gouts = list(generate_continuous_stream(
        model, params, np.zeros((2, 3), np.int32),
        SamplerConfig(max_new_tokens=4), sync_params=sync_params,
        num_slots=1, device="cpu"))
    assert len(polls) > 2
    assert sorted(r for g in gouts for r in g["rows"]) == [0, 1]
    tv = np.concatenate([g["token_versions"] for g in gouts])
    assert set(tv[tv >= 0].tolist()) == {0, 1}
    _, hist, _ = run_streaming(make_job(model, carry=True))
    assert all(r["behavior_versions"] >= 1 and r["carried_rows"] >= 0
               for r in hist)
    monkeypatch.setattr(sys, "argv", [
        "train", "--reduced", "--device", "cpu", "--mux", "stream",
        "--carry", "--rollout", "engine", "--steps", "2", "--batch", "2",
        "--group", "2", "--max-new", "4"])
    train_cli._main()
    with pytest.raises(ValueError, match="rollout engine"):
        train_cli.run_training(ARCH, reduced=True, mux="stream", carry=True,
                               device="cpu")
    with pytest.raises(ValueError, match="coexec"):
        train_cli.run_training(ARCH, reduced=True, mux="coexec",
                               params=params, device="cpu")


# ---------------------------------------------------------------------------
# streams and counters
# ---------------------------------------------------------------------------
def test_stream_helpers_are_no_ops_on_the_cpu():
    tree = {"a": torch.ones(2), "b": [torch.zeros(1)]}
    with PhaseStreams("cpu")("train"):
        assert hand_over(tree) is None
        assert take_over(tree, None) is tree


def test_launch_counter_loses_no_increment_across_threads():
    """More threads than cores bump one counter under a short switch
    interval: a read-modify-write without the lock loses increments."""
    def fake():
        pass
    fake.launches = 0
    n_threads, n_each = 32, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(
            target=lambda: [_build.count(fake) for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert fake.launches == n_threads * n_each
