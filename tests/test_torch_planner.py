"""The port's copy of the RollMux planner against the JAX package's.

Both copies are numpy on one host, so they are held **exactly** equal on
the same inputs: traces, cluster replays (``Report``), the intra-group DES
(``SimResult``), the inter-group scheduler's decisions (all but
``latency_s``, the host's clock) and its SLO contract, Theorem 1's checker
on the same hypothesis draws, and the offline optimum.  The reference
tests' own assertions (``tests/test_simulator.py``,
``tests/test_scheduler.py``, ``tests/test_theory.py``) run on both copies,
with the package as the parameter.  Then the bridges the port adds to the
planner: measured ``PhaseProfile``s -> ``RLJob`` / group / simulation, the
runtime's ``MetricsSnapshot``, and the contract -> ``SLOPolicy`` chain.
"""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import numpy as np  # noqa: E402
from _hypothesis_compat import given, settings, strategies as st  # noqa: E402

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.configs import paper_jobs as jpaper  # noqa: E402
from repro.core import phase_control as jpc  # noqa: E402
from repro.serve.sched import SLOPolicy as JSLOPolicy  # noqa: E402
from repro.serve.request import Request as JRequest  # noqa: E402
from repro_torch.configs import paper_jobs as tpaper  # noqa: E402
from repro_torch.core import phase_control as tpc  # noqa: E402
from repro_torch.serve.request import Request as TRequest  # noqa: E402
from repro_torch.serve.sched import SLOPolicy as TSLOPolicy  # noqa: E402

PKGS = {"jax": J, "torch": T}
pkg_param = pytest.mark.parametrize("pkg", list(PKGS), ids=list(PKGS))


def asdict(x):
    return dataclasses.asdict(x)


def jobs_equal(a, b):
    assert [asdict(j) for j in a] == [asdict(j) for j in b]


# ---------------------------------------------------------------------------
# exports and constants
# ---------------------------------------------------------------------------
def test_port_exports_every_name_of_the_reference():
    assert set(J.__all__) <= set(T.__all__)
    for name in J.__all__:
        assert hasattr(T, name), name


def test_paper_tables_are_the_references():
    for name in ("H20", "H800", "V5E"):
        assert asdict(getattr(T, name)) == asdict(getattr(J, name))
    assert (T.GPUS_PER_NODE, T.HOST_MEM_GB) == (J.GPUS_PER_NODE,
                                                J.HOST_MEM_GB)
    assert tpaper.MEM_FOOTPRINT_GB == jpaper.MEM_FOOTPRINT_GB
    assert tpaper.SIM_PROFILES == jpaper.SIM_PROFILES
    assert ({k: asdict(v) for k, v in tpaper.PAPER_JOB_TYPES.items()}
            == {k: asdict(v) for k, v in jpaper.PAPER_JOB_TYPES.items()})
    for name, prof in jpaper.PAPER_JOB_TYPES.items():
        assert asdict(T.from_profile(tpaper.PAPER_JOB_TYPES[name], name,
                                     slo=1.5, arrival=3.0)) == asdict(
            J.from_profile(prof, name, slo=1.5, arrival=3.0))


def test_distributions_draw_the_same_numbers():
    for fn, kw in (("sample_response_fractions", dict(n=64)),
                   ("phase_profile", {}), ("straggler_stats", {})):
        a = getattr(J.distributions, fn)(np.random.default_rng(5), **kw)
        b = getattr(T.distributions, fn)(np.random.default_rng(5), **kw)
        np.testing.assert_array_equal(np.asarray(a if not isinstance(a, dict)
                                                 else list(a.values())),
                                      np.asarray(b if not isinstance(b, dict)
                                                 else list(b.values())))


# ---------------------------------------------------------------------------
# traces and cluster replays (tests/test_simulator.py)
# ---------------------------------------------------------------------------
def trace_of(pkg):
    return PKGS[pkg].trace.production_replay_trace(n_jobs=40, seed=3)


def test_traces_identical():
    jobs_equal(J.trace.production_replay_trace(n_jobs=40, seed=3),
               T.trace.production_replay_trace(n_jobs=40, seed=3))
    jobs_equal(J.trace.philly_like_trace(n_jobs=50, seed=0),
               T.trace.philly_like_trace(n_jobs=50, seed=0))
    for wl in ("BL", "RH", "TH", "Mixed"):
        ja = J.trace.make_sim_job(np.random.default_rng(2), "x", workload=wl)
        tb = T.trace.make_sim_job(np.random.default_rng(2), "x", workload=wl)
        assert asdict(ja) == asdict(tb)


SCHEDULERS = {
    "rollmux": lambda p: p.InterGroupScheduler(p.NodeAllocator()),
    "solo": lambda p: p.SoloDisaggregation(p.NodeAllocator()),
    "greedy": lambda p: p.GreedyMostIdle(p.NodeAllocator()),
    "random": lambda p: p.RandomScheduler(p.NodeAllocator(), seed=4),
    "gavel": lambda p: p.GavelPlus(p.NodeAllocator()),
}


def replay(pkg, sched):
    p = PKGS[pkg]
    return p.ClusterSimulator(SCHEDULERS[sched](p), seed=1).run(trace_of(pkg))


@pytest.mark.parametrize("sched", list(SCHEDULERS))
def test_cluster_replay_reports_identical(sched):
    assert asdict(replay("torch", sched)) == asdict(replay("jax", sched))


def test_verl_replay_identical():
    assert asdict(T.replay_verl(trace_of("torch"), T.NodeAllocator())) == \
        asdict(J.replay_verl(trace_of("jax"), J.NodeAllocator()))


@pkg_param
def test_rollmux_full_slo_and_cheaper_than_solo(pkg):
    r, s = replay(pkg, "rollmux"), replay(pkg, "solo")
    assert r.slo_rate == 1.0                      # paper: 100 % attainment
    assert s.slo_rate == 1.0                      # solo trivially meets SLO
    assert r.total_cost < s.total_cost            # bubbles reclaimed
    assert r.peak_train_gpus <= s.peak_train_gpus


@pkg_param
def test_baselines_violate_slo(pkg):
    assert replay(pkg, "greedy").slo_rate < 1.0   # no SLO guarantee


@pkg_param
def test_verl_replay_sane(pkg):
    p = PKGS[pkg]
    v = p.replay_verl(trace_of(pkg), p.NodeAllocator())
    assert v.peak_rollout_gpus == 0               # colocated: no rollout pool
    assert v.total_cost > 0
    assert 0.0 <= v.slo_rate <= 1.0


@pkg_param
def test_report_accounting(pkg):
    r = replay(pkg, "rollmux")
    assert r.n_jobs == 40
    assert len(r.per_job_slowdown) == 40
    assert all(s > 0 for s in r.per_job_slowdown.values())
    assert 0.0 <= r.rollout_bubble <= 1.0
    assert 0.0 <= r.train_bubble <= 1.0


@pkg_param
def test_philly_trace_shape(pkg):
    jobs = PKGS[pkg].trace.philly_like_trace(n_jobs=50, seed=0)
    assert len(jobs) == 50
    arr = [j.arrival for j in jobs]
    assert arr == sorted(arr)
    assert all(1.0 <= j.slo <= 2.0 for j in jobs)


# ---------------------------------------------------------------------------
# inter-group scheduler and group DES (tests/test_scheduler.py)
# ---------------------------------------------------------------------------
def mk_job(p, jid, troll, ttrain, slo=2.0, mem_r=100.0, mem_t=100.0, n=8):
    return p.RLJob(jid, t_roll=troll, t_train=ttrain, slo=slo,
                   mem_roll_gb=mem_r, mem_train_gb=mem_t,
                   n_roll_gpus=n, n_train_gpus=n)


def decision_fields(d):
    """Everything a ``Decision`` says but its latency."""
    G = d.group
    return (G.gid, sorted(G.jobs), sorted(G.rollout_nodes),
            sorted(G.train_nodes), d.placement.rollout_node_ids,
            d.delta_cost, d.strategy)


def schedule_all(p, specs, **kw):
    sched = p.InterGroupScheduler(p.NodeAllocator(), **kw)
    return sched, [sched.schedule(mk_job(p, *s)) for s in specs]


SCHEDULE_CASES = {
    "complementary": [("a", 100, 90), ("b", 95, 85)],
    "rollout_heavy": [(f"rh{i}", 600, 150, 1.5) for i in range(4)],
    "saturating": [("a", 100, 100), ("b", 100, 100), ("c", 100, 100)],
    "memory": [("a", 600, 100, 2.0, 900.0, 900.0),
               ("b", 600, 100, 2.0, 900.0, 900.0)],
    "slo_reject": [("long", 500, 500, 2.0), ("short", 50, 50, 1.1)],
    "marginal": [("a", 300, 100, 2.0), ("b", 280, 90, 2.0)],
    "mixed": [("a", 300, 100, 1.7), ("b", 80, 260, 1.3),
              ("c", 150, 150, 2.0, 200.0, 300.0, 16), ("d", 40, 45, 1.05),
              ("e", 500, 120, 1.9)],
}


@pytest.mark.parametrize("case", list(SCHEDULE_CASES))
def test_decisions_and_contract_identical(case):
    js, jd = schedule_all(J, SCHEDULE_CASES[case])
    ts, td = schedule_all(T, SCHEDULE_CASES[case])
    assert [decision_fields(d) for d in td] == [decision_fields(d)
                                                for d in jd]
    assert all(d.latency_s >= 0 for d in td)
    assert ts.slo_contract() == js.slo_contract()
    assert ts.total_cost_per_hour() == js.total_cost_per_hour()
    for gid, G in js.groups.items():
        assert asdict(ts.groups[gid].simulate()) == asdict(G.simulate())
        assert ts.groups[gid].slowdown_bound() == G.slowdown_bound()
    first = SCHEDULE_CASES[case][0][0]
    js.release(first)
    ts.release(first)
    assert ts.total_cost_per_hour() == js.total_cost_per_hour()
    assert ts.slo_contract() == js.slo_contract()
    assert (ts.alloc.peak_rollout, ts.alloc.peak_train) == (
        js.alloc.peak_rollout, js.alloc.peak_train)


@pkg_param
def test_complementary_jobs_share_cycle(pkg):
    p = PKGS[pkg]
    sched = p.InterGroupScheduler(p.NodeAllocator())
    d1 = sched.schedule(mk_job(p, "a", 100, 90))
    d2 = sched.schedule(mk_job(p, "b", 95, 85))
    assert d2.group is d1.group            # packed together
    res = d1.group.simulate()
    assert res.iter_time["a"] == pytest.approx(195.0)
    assert res.iter_time["b"] == pytest.approx(195.0)
    assert res.iter_time["a"] <= 1.1 * d1.group.t_cycle()


@pkg_param
def test_rollout_heavy_jobs_share_train_pool(pkg):
    p = PKGS[pkg]
    sched = p.InterGroupScheduler(p.NodeAllocator())
    for i in range(4):
        d = sched.schedule(mk_job(p, f"rh{i}", 600, 150, slo=1.5))
    G = d.group
    assert len(G.jobs) == 4
    assert len(G.train_nodes) == 1          # one shared train pool
    assert len(G.rollout_nodes) == 4        # rollout scaling per job
    res = G.simulate()
    for j in G.jobs.values():
        assert res.iter_time[j.job_id] <= j.slo * j.t_solo + 1e-6


@pkg_param
def test_saturation_pruning(pkg):
    p = PKGS[pkg]
    sched = p.InterGroupScheduler(p.NodeAllocator())
    d1 = sched.schedule(mk_job(p, "a", 100, 100, slo=2.0))
    d2 = sched.schedule(mk_job(p, "b", 100, 100, slo=2.0))
    if d2.group is d1.group:
        assert d1.group.saturated() or d1.group.t_load() <= d1.group.t_cycle()
        d3 = sched.schedule(mk_job(p, "c", 100, 100, slo=2.0))
        assert d3.group is not d1.group or not d1.group.saturated()


@pkg_param
def test_memory_residency_blocks_admission(pkg):
    p = PKGS[pkg]
    sched = p.InterGroupScheduler(p.NodeAllocator())
    big = 900.0  # GB; two of these exceed the 1536 GB node budget
    d1 = sched.schedule(mk_job(p, "a", 600, 100, mem_r=big, mem_t=big))
    d2 = sched.schedule(mk_job(p, "b", 600, 100, mem_r=big, mem_t=big))
    assert d2.group is not d1.group


@pkg_param
def test_slo_admission_rejects_slow_pairing(pkg):
    p = PKGS[pkg]
    sched = p.InterGroupScheduler(p.NodeAllocator())
    d1 = sched.schedule(mk_job(p, "long", 500, 500, slo=2.0))
    d2 = sched.schedule(mk_job(p, "short", 50, 50, slo=1.1))
    assert d2.group is not d1.group


@pkg_param
def test_marginal_cost_prefers_packing(pkg):
    p = PKGS[pkg]
    sched = p.InterGroupScheduler(p.NodeAllocator())
    sched.schedule(mk_job(p, "a", 300, 100, slo=2.0))
    d = sched.schedule(mk_job(p, "b", 280, 90, slo=2.0))
    assert d.strategy in ("pack", "scale_rollout")
    assert d.delta_cost < sched._isolated_cost(mk_job(p, "b", 280, 90))


@pkg_param
def test_release_frees_nodes(pkg):
    p = PKGS[pkg]
    sched = p.InterGroupScheduler(p.NodeAllocator())
    sched.schedule(mk_job(p, "a", 100, 90))
    sched.schedule(mk_job(p, "b", 95, 85))
    sched.release("a")
    sched.release("b")
    assert sched.total_cost_per_hour() == 0.0
    assert not sched.groups


def two_job_group(p, n_roll=1, t80=None):
    nodes_r = [p.Node(f"r{i}", p.H20) for i in range(n_roll)]
    G = p.CoExecutionGroup("g", nodes_r, [p.Node("t0", p.H800)])
    for k, jid in enumerate(("a", "b")):
        j = mk_job(p, jid, 200 if t80 else 100, 80 if t80 else 100)
        if t80:
            j.t80_frac = t80
        G.add_job(j, p.Placement((nodes_r[k % n_roll].node_id,)))
    return G


SIM_KW = {
    "strict": {}, "migration": dict(migration=True),
    "atomic": dict(job_atomic=True),
    "work_conserving": dict(work_conserving=True, stochastic=True,
                            migration=True, switch=None),
    "switch": dict(switch="switch"), "stochastic": dict(stochastic=True),
    "extra": dict(extra_phases={"a": 1}, n_cycles=20, discard=5),
    "order": dict(order=["b", "a"]),
}


@pytest.mark.parametrize("mode", list(SIM_KW))
def test_group_des_identical(mode):
    for n_roll, t80 in ((1, 0.5), (2, None)):
        out = []
        for p in (J, T):
            kw = dict(SIM_KW[mode])
            if kw.get("switch") == "switch":
                kw["switch"] = p.SwitchCosts(warm_s=0.7, cold_s=30.0)
            out.append(asdict(two_job_group(p, n_roll, t80).simulate(**kw)))
        assert out[1] == out[0]


@pkg_param
def test_group_des_migration_improves_packing(pkg):
    p = PKGS[pkg]
    G = two_job_group(p, 1, t80=0.5)
    base = G.simulate(migration=False)
    mig = G.simulate(migration=True)
    assert mig.makespan < base.makespan
    assert all(mig.iter_time[j] < base.iter_time[j] - 1e-6 for j in ("a", "b"))


@pkg_param
def test_gavel_job_atomic_is_worse(pkg):
    p = PKGS[pkg]
    G = two_job_group(p, 2)
    assert G.simulate(job_atomic=True).iter_time["a"] > \
        G.simulate().iter_time["a"]


@pkg_param
def test_decision_latency_scales(pkg):
    import time
    p = PKGS[pkg]
    rng = np.random.default_rng(0)
    sched = p.InterGroupScheduler(p.NodeAllocator())
    for i in range(60):
        sched.schedule(p.trace.make_sim_job(rng, f"j{i}", duration=1e9))
    t0 = time.perf_counter()
    sched.schedule(p.trace.make_sim_job(rng, "probe", duration=1e9))
    assert time.perf_counter() - t0 < 1.0   # sub-second (paper Table 5)


def test_offline_optimal_cost_identical():
    specs = [("a", 100, 90), ("b", 95, 85), ("c", 300, 60, 1.5),
             ("d", 50, 200, 1.2)]
    got = [p.offline_optimal_cost([mk_job(p, *s) for s in specs],
                                  p.NodeAllocator()) for p in (J, T)]
    assert got[1] == got[0]
    assert np.isfinite(got[1]) and got[1] > 0


# ---------------------------------------------------------------------------
# Theorem 1 (tests/test_theory.py) on the same hypothesis draws
# ---------------------------------------------------------------------------
dur = st.floats(20.0, 400.0)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.tuples(dur, dur), min_size=2, max_size=4))
def test_theorem1_checker_identical(pairs):
    t_rolls = [p[0] for p in pairs]
    t_trains = [p[1] for p in pairs]
    G = T.theory.make_group(t_rolls, t_trains)
    assert G.saturated() == J.theory.make_group(t_rolls, t_trains).saturated()
    if G.saturated():
        return
    res = T.theory.check_theorem1(t_rolls, t_trains)
    assert res == J.theory.check_theorem1(t_rolls, t_trains)
    # Theorem 1's content: repetition is strictly suboptimal
    assert res["max_repetition"] <= res["round_robin"] + 1e-6
    if G.t_load() <= 0.9 * G.t_cycle():
        assert res["max_order"] <= res["round_robin"] * 1.005 + 1e-6
    else:
        assert res["max_order"] <= res["round_robin"] * 1.03 + 1e-6


@settings(max_examples=20, deadline=None)
@given(st.lists(st.tuples(dur, dur), min_size=1, max_size=4))
def test_unsaturated_group_achieves_cycle_time_both(pairs):
    for p in (J, T):
        G = p.theory.make_group([q[0] for q in pairs], [q[1] for q in pairs])
        if G.saturated():
            return
        res = G.simulate(n_cycles=30, discard=8)
        for it in res.iter_time.values():
            assert it <= G.t_cycle() + 1e-6
        assert max(res.iter_time.values()) == pytest.approx(G.t_cycle(),
                                                            rel=1e-6)


@settings(max_examples=15, deadline=None)
@given(st.lists(st.tuples(dur, dur), min_size=2, max_size=4))
def test_monotonic_in_durations_both(pairs):
    t_rolls = [p[0] for p in pairs]
    t_trains = [p[1] for p in pairs]
    out = []
    for p in (J, T):
        r1 = p.theory.make_group(t_rolls, t_trains).simulate(n_cycles=20,
                                                              discard=5)
        r2 = p.theory.make_group([t * 0.7 for t in t_rolls],
                                 [t * 0.7 for t in t_trains]).simulate(
            n_cycles=20, discard=5)
        for j in r1.iter_time:
            assert r2.iter_time[j] <= r1.iter_time[j] + 1e-6
        out.append((asdict(r1), asdict(r2)))
    assert out[1] == out[0]


@pkg_param
def test_saturated_group_exceeds_cycle(pkg):
    G = PKGS[pkg].theory.make_group([100, 100, 100], [100, 100, 100])
    assert G.saturated()
    res = G.simulate(n_cycles=30, discard=8)
    assert max(res.iter_time.values()) > G.t_cycle() - 1e-6
    assert PKGS[pkg].theory.aggregate_utilization(G) > 0


# ---------------------------------------------------------------------------
# measured profiles -> planner, runtime telemetry, contract -> engine policy
# ---------------------------------------------------------------------------
PROFILE = dict(rollout_s=(4.21, 3.87, 5.02), train_s=(0.41, 0.33, 0.36),
               reward_s=(0.01, 0.02, 0.012, 0.013, 0.011, 0.02),
               transfer_s=(0.003, 0.004, 0.002))


@pytest.mark.parametrize("overrides", [{}, dict(slo=1.4, n_roll_gpus=16),
                                       dict(t80_frac=0.5, duration=60.0)])
def test_profile_to_job_identical(overrides):
    jp = jpc.PhaseProfile("job0", **PROFILE)
    tp = tpc.PhaseProfile("job0", **PROFILE)
    tj = tp.to_job(**overrides)
    assert isinstance(tj, T.RLJob)
    assert asdict(tj) == asdict(jp.to_job(**overrides))
    # worst rollout plus the worst iteration's transfers (one a permit)
    assert tj.t_roll == pytest.approx(5.02 + 0.004)
    assert tj.t_train == 0.41
    # two reward permits an iteration: the heaviest pair
    assert tj.t_reward == pytest.approx(0.011 + 0.02)
    assert tj.runtime_scale == (pytest.approx(min(3.87 / 5.02, 0.33 / 0.41)),
                                1.0)
    empty = tpc.PhaseProfile("idle").to_job()
    assert asdict(empty) == asdict(jpc.PhaseProfile("idle").to_job())


@pytest.mark.parametrize("switch", [None, (0.5, 20.0)])
def test_simulate_profiles_identical(switch):
    jprofs = [jpc.PhaseProfile("job0", (4.2, 3.9), (0.41, 0.35)),
              jpc.PhaseProfile("job1", (4.6, 4.4), (0.38, 0.44))]
    tprofs = [tpc.PhaseProfile(p.job_id, p.rollout_s, p.train_s)
              for p in jprofs]
    jg = J.group_from_profiles(jprofs, slo=2.0)
    tg = T.group_from_profiles(tprofs, slo=2.0)
    assert sorted(tg.jobs) == ["job0", "job1"]
    assert [asdict(j) for j in tg.jobs.values()] == \
        [asdict(j) for j in jg.jobs.values()]
    assert [p.rollout_node_ids for p in tg.placements.values()] == [
        p.rollout_node_ids for p in jg.placements.values()]
    kw = {} if switch is None else dict(
        switch=T.SwitchCosts(warm_s=switch[0], cold_s=switch[1]))
    jkw = {} if switch is None else dict(
        switch=J.SwitchCosts(warm_s=switch[0], cold_s=switch[1]))
    res = T.simulate_profiles(tprofs, **kw)
    assert asdict(res) == asdict(J.simulate_profiles(jprofs, **jkw))
    assert set(res.iter_time) == {"job0", "job1"}
    assert all(np.isfinite(v) and v > 0 for v in res.iter_time.values())


def test_runtime_metrics_identical(monkeypatch):
    """``RollMuxRuntime.metrics`` with the clock pinned: both runtimes
    report the same busy fractions and capacities."""
    import time
    snaps = []
    for pc in (jpc, tpc):
        rt = pc.RollMuxRuntime(host_cache_gb=0.01)
        rt.pool("rollout", 2).busy_time = 3.0
        rt.pool("train", 1).busy_time = 12.5
        rt.pool("reward", 4).busy_time = 0.25
        rt._t0 = 100.0
        monkeypatch.setattr(time, "perf_counter", lambda: 110.0)
        snaps.append(rt.metrics())
        monkeypatch.undo()
    js, ts = snaps
    assert isinstance(ts, T.MetricsSnapshot)
    assert ts.to_dict() == js.to_dict()
    assert ts.pool_busy_frac == {"rollout": 0.3, "train": 1.0,
                                 "reward": 0.025}
    assert ts.pool_capacity == {"rollout": 2, "train": 1, "reward": 4}
    merged = ts.merge(T.MetricsSnapshot(source="engine", steps=3,
                                        decode_time_s=0.3))
    jmerged = js.merge(J.MetricsSnapshot(source="engine", steps=3,
                                         decode_time_s=0.3))
    assert merged.to_dict() == jmerged.to_dict()
    assert merged.source == "runtime+engine"


def test_warn_legacy_once_warns_once():
    from repro_torch.core.telemetry import warn_legacy_once
    flag = [False]
    with pytest.warns(DeprecationWarning, match="old"):
        warn_legacy_once(flag, "old")
    assert flag == [True]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        warn_legacy_once(flag, "old")     # the second call is silent


def test_slo_contract_flows_into_the_port_policy():
    """``tests/test_serve_sched.py``'s chain: the inter-group scheduler's
    contract -> ``SLOPolicy.from_contract``, through both packages."""
    out = {}
    for name, p, policy_cls, req_cls in (("jax", J, JSLOPolicy, JRequest),
                                         ("torch", T, TSLOPolicy, TRequest)):
        sched = p.InterGroupScheduler(p.NodeAllocator(n_rollout_gpus=64,
                                                      n_train_gpus=64))
        sched.schedule(p.RLJob("jobA", t_roll=60, t_train=30, slo=1.8))
        sched.schedule(p.RLJob("jobB", t_roll=50, t_train=25, slo=1.4))
        contract = sched.slo_contract()
        assert set(contract) == {"jobA", "jobB"}
        assert contract["jobA"] == pytest.approx(1.8 * sched.admission_margin)
        G = next(iter(sched.groups.values()))
        assert G.slowdown_bound("jobA") == pytest.approx(1.8)
        assert G.slowdown_bound() <= min(contract.values()) / \
            sched.admission_margin + 1e-9
        policy = policy_cls.from_contract(contract, "jobA",
                                          time_per_token=0.01)
        req = req_cls(rid=0, prompt=[1, 2, 3], max_new_tokens=40,
                      arrival_time=2.0)
        out[name] = (contract, policy.slowdown,
                     policy.effective_deadline(req, now=2.0))
    assert out["torch"] == out["jax"]
    assert out["torch"][2] == pytest.approx(2.0 + 1.8 * 0.93 * 0.4)
