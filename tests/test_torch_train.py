"""The port's training slice against the JAX package.

Reduced internlm2 in float32 on the CPU, with JAX parameters (and train
state) carried across by ``repro_torch.convert``; every other input is
made with numpy from a seed and fed to both sides.  Tolerances, and why:

* model logits, the loss and its metrics: ``1e-4`` / ``1e-5`` — XLA and
  PyTorch sum the same float32 products in different orders;
* AdamW and the schedule on identical gradients: ``1e-6`` — the same
  float32 operations in the same order, up to ``pow``/``cos`` ulps;
* a whole train step's new weights: ``atol = 1e-2 * lr`` where the
  gradient is well above AdamW's ``eps`` (``|g| > 100 * eps``), and one
  step's size ``lr`` elsewhere — the first AdamW step moves each weight by
  ``lr * g / (|g| + eps)``, which turns an ulp of difference in a gradient
  near 0 into up to ``ulp / eps`` of the step.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.phase_control import RollMuxRuntime as JaxRuntime  # noqa: E402
from repro.data import ArithmeticTask as JaxTask  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.rl import coexec as jcoexec  # noqa: E402
from repro.rl import grpo as jgrpo  # noqa: E402
from repro.rl import rewards as jrewards  # noqa: E402
from repro.rl.rollout import completions_to_text as jax_c2t  # noqa: E402
from repro.rl.train_step import init_train_state as jax_init_state  # noqa: E402
from repro.rl.train_step import make_train_step as jax_train_step  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.convert import from_jax_params, from_jax_train_state  # noqa: E402
from repro_torch.core import RollMuxRuntime  # noqa: E402
from repro_torch.data import ArithmeticTask  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.rl import coexec, grpo, rewards  # noqa: E402
from repro_torch.rl.rollout import (SamplerConfig, completions_to_text,  # noqa: E402
                                    generate_continuous)
from repro_torch.rl.train_step import make_train_step  # noqa: E402
from repro_torch.serve.engine import sample_logp  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.checkpoints import HostStateCache  # noqa: E402

ARCH = "internlm2-1.8b"
TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: numpy} with the port's per-layer lists and JAX's stacked
    layers both split as layers/<i>/..."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
    else:
        a = tree.detach().float().numpy() if isinstance(tree, torch.Tensor) \
            else np.asarray(tree, np.float32)
        out[prefix[:-1]] = a
    return out


def _flat_jax(tree):
    out = {}
    for path, a in _flat(_np_tree(tree)).items():
        if path.startswith("layers/"):
            for i in range(a.shape[0]):
                out[f"layers/{i}/{path[len('layers/'):]}"] = a[i]
        else:
            out[path] = a
    return out


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(ARCH, reduced=True)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(ARCH, reduced=True)
    return jm, jp, tm, from_jax_params(_np_tree(jp))


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("remat", [False, True])
def test_stack_forward_matches_jax(pair, remat):
    jm, jp, tm, tp = pair
    tokens = np.random.RandomState(0).randint(0, 512, (3, 11)).astype(
        np.int32)
    lj, aj = jm.forward(jp, jnp.asarray(tokens), remat=remat)
    lt, at = tm.forward(tp, _t(tokens), remat=remat)
    assert lt.dtype == torch.float32 and lt.shape == (3, 11, 512)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert float(at) == float(aj) == 0.0


def test_stack_forward_refuses_other_families(pair):
    _, _, tm, tp = pair
    from repro_torch.models.stacks import stack_forward
    cfg = dataclasses.replace(tm.cfg, family="ssm")
    with pytest.raises(NotImplementedError, match="ssm"):
        stack_forward(tp, cfg, torch.zeros((1, 3), dtype=torch.int32))


def _loss_inputs(seed=0, B=3, S=7, V=40):
    rs = np.random.RandomState(seed)
    logits = (rs.randn(B, S, V) * 2).astype(np.float32)
    labels = rs.randint(0, V, (B, S)).astype(np.int32)
    adv = rs.randn(B, S).astype(np.float32)
    mask = (rs.rand(B, S) > 0.3).astype(np.float32)
    # behaviour logprobs far enough from the policy's that clipping bites
    logp = np.take_along_axis(
        np.asarray(jax.nn.log_softmax(jnp.asarray(logits))),
        labels[..., None], -1)[..., 0]
    blogp = (logp + rs.randn(B, S) * 0.5).astype(np.float32)
    return logits, labels, adv, mask, blogp


@pytest.mark.parametrize("behavior", [False, True],
                         ids=["on-policy", "clipped"])
def test_policy_gradient_loss_matches_jax(behavior):
    logits, labels, adv, mask, blogp = _loss_inputs()
    jargs = [jnp.asarray(x) for x in (logits, labels, adv, mask)]
    targs = [_t(x) for x in (logits, labels, adv, mask)]
    jl, jm = jgrpo.policy_gradient_loss(
        *jargs, behavior_logp=jnp.asarray(blogp) if behavior else None)
    tl, tm = grpo.policy_gradient_loss(
        *targs, behavior_logp=_t(blogp) if behavior else None)
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    if behavior:
        assert 0.1 < float(tm["clip_frac"]) < 0.9      # clipping active
    np.testing.assert_allclose(
        grpo.token_logprobs(_t(logits), _t(labels)).numpy(),
        np.asarray(jgrpo.token_logprobs(jargs[0], jargs[1])), atol=1e-5)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def _opt_tree(rs):
    return {"w": rs.randn(6, 5).astype(np.float32),
            "b": {"c": rs.randn(7).astype(np.float32),
                  "a": rs.randn(3, 2).astype(np.float32)}}


@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_matches_jax_over_three_steps(schedule):
    rs = np.random.RandomState(0)
    params = _opt_tree(rs)
    grads = [jax.tree.map(lambda a: (a * 3).astype(np.float32),
                          _opt_tree(rs)) for _ in range(3)]
    cfg = dict(lr=1e-2, weight_decay=0.05, grad_clip=1.0)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    jsched = jopt.warmup_cosine(1e-2, 2, 5) if schedule else None
    tsched = topt.warmup_cosine(1e-2, 2, 5) if schedule else None
    jp = jax.tree.map(jnp.asarray, params)
    jo = jopt.adamw_init(jp, jcfg)
    tp = jax.tree.map(_t, params)
    to = topt.adamw_init(tp, tcfg)
    for g in grads:
        jp, jo, jmet = jopt.adamw_update(jax.tree.map(jnp.asarray, g), jo,
                                         jp, jcfg, jsched)
        tp, to, tmet = topt.adamw_update(jax.tree.map(_t, g), to, tp, tcfg,
                                         tsched)
        assert float(tmet["grad_norm"]) > 1.0          # clipping active
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-6, err_msg=k)
        for tree_t, tree_j in ((tp, jp), (to["mu"], jo["mu"]),
                               (to["nu"], jo["nu"])):
            got, want = _flat(tree_t), _flat(_np_tree(tree_j))
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], atol=1e-6,
                                           rtol=1e-6, err_msg=k)
    assert int(to["step"]) == int(jo["step"]) == 3


def test_adamw_keeps_bf16_params_and_scales_in_float32():
    """bf16 parameters and gradients: the clip scale multiplies the
    gradient in float32, as JAX's type promotion does, and the new weight
    rounds back to bf16 once (results within one bf16 ulp, 2**-8)."""
    rs = np.random.RandomState(1)
    p = rs.randn(64).astype(np.float32)
    g = (rs.randn(64) * 5).astype(np.float32)
    cfg = dict(lr=1e-2, grad_clip=1.0)
    jp, jg = jnp.asarray(p, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    jo = jopt.adamw_init({"p": jp}, jopt.AdamWConfig(**cfg))
    jnew, jo, _ = jopt.adamw_update({"p": jg}, jo, {"p": jp},
                                    jopt.AdamWConfig(**cfg))
    tp = {"p": torch.from_numpy(p).to(torch.bfloat16)}
    tg = {"p": torch.from_numpy(g).to(torch.bfloat16)}
    to = topt.adamw_init(tp, topt.AdamWConfig(**cfg))
    topt.adamw_update(tg, to, tp, topt.AdamWConfig(**cfg))
    assert tp["p"].dtype == torch.bfloat16 and to["mu"]["p"].dtype == \
        torch.float32
    np.testing.assert_allclose(to["mu"]["p"].numpy(),
                               np.asarray(jo["mu"]["p"]), rtol=1e-6)
    np.testing.assert_allclose(tp["p"].float().numpy(),
                               np.asarray(jnew["p"], np.float32),
                               rtol=2 ** -8, atol=0)


def test_warmup_cosine_matches_jax():
    js, ts = jopt.warmup_cosine(3e-4, 10, 50), topt.warmup_cosine(3e-4, 10,
                                                                   50)
    for step in (0, 1, 5, 10, 11, 30, 50, 70):
        np.testing.assert_allclose(
            float(ts(torch.tensor(step, dtype=torch.int32))),
            float(js(jnp.int32(step))), rtol=1e-6)


# ---------------------------------------------------------------------------
# the whole train step
# ---------------------------------------------------------------------------
def _synthetic_batch(seed=0, B=4, S=12, V=512):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, V, (B, S + 1)).astype(np.int32)
    mask = np.zeros((B, S), np.float32)
    mask[:, 4:] = (rs.rand(B, S - 4) > 0.2)
    adv = np.repeat(rs.randn(B, 1), S, 1).astype(np.float32) * (mask > 0)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
            "loss_mask": mask, "advantages": adv,
            "behavior_logp": (rs.randn(B, S) * 0.3 - 6.3).astype(np.float32)
            * mask}


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(pair, microbatches):
    """Loss and metrics at 1e-5 (summation order), grad_norm at 1e-4
    relative (a norm of gradients that agree at 1e-5 relative, summed over
    differently grouped leaves), the moments at 1e-5 of their scale and the
    new weights as the module docstring says."""
    jm, jp, tm, _ = pair
    lr = 1e-3
    jstate = jax_init_state(jm, jax.random.PRNGKey(1),
                            jopt.AdamWConfig(lr=lr))
    tstate = from_jax_train_state(_np_tree(jstate))
    batch = _synthetic_batch()
    jstep = jax.jit(jax_train_step(jm, jopt.AdamWConfig(lr=lr),
                                   microbatches=microbatches))
    jnew, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstep = make_train_step(tm, topt.AdamWConfig(lr=lr),
                            microbatches=microbatches)
    tnew, tmet = tstep(tstate, {k: _t(v) for k, v in batch.items()})
    assert set(tmet) == set(jmet)
    for k in jmet:
        tol = dict(rtol=1e-4) if k == "grad_norm" else dict(atol=1e-5,
                                                            rtol=1e-5)
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **tol,
                                   err_msg=k)
    assert float(tmet["grad_norm"]) > 0 and float(tmet["clip_frac"]) > 0
    got, want = _flat(tnew["params"]), _flat_jax(jnew["params"])
    before = _flat_jax(jstate["params"])
    mu = _flat_jax(jnew["opt"]["mu"])           # (1 - b1) * clipped grad
    assert set(got) == set(want)
    for k in want:
        sharp = np.abs(mu[k]) / 0.1 > 100 * 1e-8
        assert sharp.any(), k
        np.testing.assert_allclose(got[k][sharp], want[k][sharp],
                                   atol=1e-2 * lr, rtol=0, err_msg=k)
        np.testing.assert_allclose(got[k], want[k], atol=lr, rtol=0,
                                   err_msg=k)
        assert np.abs(got[k] - before[k]).max() > 0.5 * lr, k   # it moved
    for name in ("mu", "nu"):
        g, w = _flat(tnew["opt"][name]), _flat_jax(jnew["opt"][name])
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=1e-5 * np.abs(
                w[k]).max(), rtol=1e-3, err_msg=f"{name}/{k}")
    assert int(tnew["opt"]["step"]) == int(jnew["opt"]["step"]) == 1


def test_single_microbatch_grads_keep_the_param_dtype():
    """With one microbatch the gradients stay in the parameters' dtype (as
    jax.value_and_grad leaves them); with several they are float32 sums."""
    from repro_torch.rl import train_step as ts
    m = build_model(ARCH, reduced=True)
    params = topt.tree_map(lambda t: t.to(torch.bfloat16),
                           m.init(torch.Generator().manual_seed(0)))
    batch = {k: _t(v) for k, v in _synthetic_batch().items()}
    loss_fn = ts.make_loss_fn(m, remat=False)
    _, grads = ts._value_and_grad(loss_fn, params, batch)
    assert {g.dtype for g in topt.tree_leaves(grads)} == {torch.bfloat16}
    assert not any(p.requires_grad for p in topt.tree_leaves(params))


# ---------------------------------------------------------------------------
# task, rewards, advantages, train batch
# ---------------------------------------------------------------------------
def test_task_rewards_and_advantages_match_jax():
    jt, tt = JaxTask(seed=3), ArithmeticTask(seed=3)
    for _ in range(2):
        jb, tb = jt.sample_batch(5), tt.sample_batch(5)
        np.testing.assert_array_equal(tb.prompts, jb.prompts)
        assert tb.answers == jb.answers and tb.prompt_text == jb.prompt_text
    texts = ["12", " 12 ", "1", "-3", "abc", "", "7x", "123456"]
    answers = ["12", "12", "12", "-3", "5", "0", "7", "123456"]
    T = 8
    comp = np.full((len(texts), T), 258, np.int32)
    mask = np.zeros((len(texts), T), np.float32)
    for i, t in enumerate(texts):
        ids = list(t.encode())
        comp[i, :len(ids)] = ids
        mask[i, :len(ids) + 1] = 1.0
    assert completions_to_text(comp, mask) == jax_c2t(comp, mask)
    assert completions_to_text(_t(comp), _t(mask)) == jax_c2t(comp, mask)
    for name in ("arith", "length", "format", "composite"):
        np.testing.assert_array_equal(
            rewards.make_reward(name)(comp, mask, answers),
            jrewards.make_reward(name)(comp, mask, answers), err_msg=name)
    r = np.random.RandomState(0).rand(12).astype(np.float32)
    np.testing.assert_array_equal(grpo.group_advantages(r, 4),
                                  jgrpo.group_advantages(r, 4))


def test_build_train_batch_matches_jax():
    rs = np.random.RandomState(1)
    B, Sp, T = 4, 5, 6
    out = {"prompts": rs.randint(0, 256, (B, Sp)).astype(np.int32),
           "completions": rs.randint(0, 256, (B, T)).astype(np.int32),
           "mask": (rs.rand(B, T) > 0.3).astype(np.float32),
           "behavior_logp": -rs.rand(B, T).astype(np.float32)}
    out["tokens"] = np.concatenate([out["prompts"], out["completions"]], 1)
    adv = rs.randn(B).astype(np.float32)
    want = jcoexec.build_train_batch(
        {k: jnp.asarray(v) for k, v in out.items()}, adv, Sp)
    got = coexec.build_train_batch({k: _t(v) for k, v in out.items()}, adv,
                                   Sp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# sampled decoding
# ---------------------------------------------------------------------------
def test_sampler_with_injected_gumbel_noise():
    rs = np.random.RandomState(0)
    logits = (rs.randn(6, 50) * 3).astype(np.float32)
    g = rs.gumbel(size=logits.shape).astype(np.float32)
    T = 0.7
    tokens, logp = sample_logp(_t(logits), T, gumbel=_t(g))
    want = np.argmax(logits / np.float32(T) + g, axis=-1)
    np.testing.assert_array_equal(tokens.numpy(), want)
    assert tokens.dtype == torch.int32
    lsm = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))  # untempered
    np.testing.assert_allclose(logp.numpy(), lsm[np.arange(6), want],
                               atol=1e-6)
    # a seeded generator reproduces its draws; another seed does not
    draws = [sample_logp(_t(logits), 1.0, generator=torch.Generator(
        ).manual_seed(s))[0] for s in (5, 5, 6)]
    assert torch.equal(draws[0], draws[1])
    many = [sample_logp(_t(np.zeros((200, 50), np.float32)), 1.0,
                        generator=torch.Generator().manual_seed(s))[0]
            for s in (5, 6)]
    assert not torch.equal(*many)
    # temperature 0 is the greedy path
    g0, lp0 = sample_logp(_t(logits), 0.0)
    np.testing.assert_array_equal(g0.numpy(), logits.argmax(-1))


def test_sampled_engine_logprobs_are_the_policy_logprobs(pair):
    """Sampled decoding through the engine: a seeded generator reproduces
    the completions, and each recorded behaviour logprob is the untempered
    policy's log-probability of the sampled token, as a teacher-forced
    forward pass computes it."""
    _, _, tm, tp = pair
    prompts = np.random.RandomState(2).randint(0, 256, (3, 5)).astype(
        np.int32)
    sampler = SamplerConfig(max_new_tokens=6, temperature=0.8)
    outs = [generate_continuous(
        tm, tp, prompts, sampler, generator=torch.Generator().manual_seed(s),
        num_slots=2, device="cpu") for s in (9, 9)]
    torch.testing.assert_close(outs[0]["completions"], outs[1]["completions"],
                               rtol=0, atol=0)
    out = outs[0]
    logits, _ = tm.forward(tp, out["tokens"][:, :-1])
    lp = torch.log_softmax(logits, -1).gather(
        -1, out["tokens"][:, 1:, None].long())[..., 0][:, prompts.shape[1] - 1:]
    m = out["mask"] > 0
    torch.testing.assert_close(out["behavior_logp"][m], lp[m], atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# one GRPO iteration end to end
# ---------------------------------------------------------------------------
def test_greedy_grpo_iteration_matches_jax(pair):
    """GRPOJob at temperature 0 on the engine rollout against the JAX
    package's (``rollout="engine"``, ``kernel_backend="pallas"``): identical
    tokens and rewards; loss and entropy at 1e-4."""
    jm, _, tm, _ = pair
    kw = dict(seed=0, steps=4, batch=2, group=2, max_new=6, temperature=0.0)
    jjob = jcoexec.GRPOJob("job0", model=jm, rollout="engine",
                           kernel_backend="pallas", **kw)
    tjob = coexec.GRPOJob("job0", model=tm, device="cpu", **kw)
    jstate = jjob.init_state()
    tstate = from_jax_train_state(_np_tree(jstate))
    jb, jout = jjob.rollout_step(jstate["params"], 0)
    tb, tout = tjob.rollout_step(tstate["params"], 0)
    np.testing.assert_array_equal(tb.prompts, jb.prompts)
    for k in ("completions", "mask", "tokens"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    np.testing.assert_allclose(tout["behavior_logp"].numpy(),
                               np.asarray(jout["behavior_logp"]), atol=1e-4)
    np.testing.assert_array_equal(tjob.compute_rewards(tb, tout),
                                  jjob.compute_rewards(jb, jout))
    _, jrec = jjob.train_phase(jstate, jb, jout)
    tstate, trec = tjob.train_phase(tstate, tb, tout)
    for k in ("reward", "acc", "tokens"):
        assert trec[k] == jrec[k], k
    for k in ("loss", "entropy", "clip_frac", "ratio_mean", "ratio_max"):
        np.testing.assert_allclose(trec[k], jrec[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    assert trec["prefills"] == 4 and trec["decode_steps"] >= 1


def test_run_training_on_cpu_and_what_is_not_ported():
    state, hist, report = run_training(
        ARCH, reduced=True, steps=2, batch=2, group=2, max_new=4, seed=1,
        kv="paged", kv_block_size=4, log_every=0, device="cpu",
        return_report=True)
    assert [r["step"] for r in hist] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["prefills"] == 4 for r in hist)
    assert int(state["opt"]["step"]) == 2
    s = report.summary()
    assert report.mode == "off" and s["overlap_s"] == pytest.approx(0.0)
    assert len(report.timelines["rollout"]) == len(
        report.timelines["train"]) == 2
    assert set(report.profiles) == {"job0"}
    with pytest.raises(NotImplementedError, match="mux slice"):
        run_training(ARCH, reduced=True, mux="pipeline", device="cpu")
    with pytest.raises(ValueError, match="unknown mux"):
        run_training(ARCH, reduced=True, mux="bogus", device="cpu")
    with pytest.raises(NotImplementedError, match="stack_decode_step"):
        coexec.GRPOJob("j", reduced=True, rollout="static", device="cpu")


# ---------------------------------------------------------------------------
# phase control and the host cache
# ---------------------------------------------------------------------------
def _drive(rt, state0):
    rt.seed_state("a", "train", state0)

    @rt.phase("train", name="train")
    def train(state, x):
        return jax.tree.map(lambda t: t + x, state), float(x)

    @rt.phase("train", name="cold", init_fn=lambda: state0)
    def cold(state):
        return state, None

    outs = [train("a", 1.0), train("a", 2.0), cold("b")]
    with rt.permit("rollout", "a:roll"):
        pass
    return outs


def test_runtime_phases_match_jax():
    """The same phase program on both runtimes: outputs, warm/cold counts,
    cache stats, the restored state and the profiles' shape agree."""
    jrt, trt = JaxRuntime(host_cache_gb=1.0), RollMuxRuntime(host_cache_gb=1.0)
    base = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "n": [np.ones(2, np.float32)]}
    jouts = _drive(jrt, jax.tree.map(jnp.asarray, base))
    touts = _drive(trt, jax.tree.map(_t, base))
    assert touts == jouts
    for k in jrt.stats:
        js, ts = jrt.stats[k], trt.stats[k]
        assert (ts.runs, ts.warm_starts, ts.cold_starts) == (
            js.runs, js.warm_starts, js.cold_starts), k
    assert trt.cache.stats == jrt.cache.stats
    jstate, _ = jrt.cache.restore("a/train")
    tstate, _ = trt.cache.restore("a/train")
    np.testing.assert_array_equal(tstate["w"].numpy(), np.asarray(jstate["w"]))
    np.testing.assert_array_equal(tstate["n"][0].numpy(),
                                  np.asarray(jstate["n"][0]))
    assert trt.cache.used_bytes() == jrt.cache.used_bytes()
    jp, tp = jrt.phase_profiles(), trt.phase_profiles()
    assert set(tp) == set(jp)
    for jid in jp:
        assert (len(tp[jid].rollout_s), len(tp[jid].train_s)) == (
            len(jp[jid].rollout_s), len(jp[jid].train_s))


def test_host_cache_round_trip_is_a_copy():
    cache = HostStateCache(1 << 20)
    state = {"p": torch.arange(4.0), "opt": {"step": torch.tensor(3)}}
    cache.offload("k", state)
    state["p"].add_(1.0)                     # the cache holds a copy
    back, _ = cache.restore("k")
    assert torch.equal(back["p"], torch.arange(4.0))
    assert int(back["opt"]["step"]) == 3
    assert cache.used_bytes() == 4 * 4 + 8 and cache.resident("k")
    assert cache.restore("missing") == (None, 0.0)
    assert cache.stats == {"warm_hits": 1, "cold_misses": 1, "offloads": 1}
    cache.evict("k")
    assert not cache.resident("k")


def test_convert_train_state(pair):
    jm, _, _, _ = pair
    js = jax_init_state(jm, jax.random.PRNGKey(0))
    ts = from_jax_train_state(_np_tree(js))
    assert set(ts) == {"params", "opt"} and set(ts["opt"]) == {"mu", "nu",
                                                               "step"}
    assert ts["opt"]["step"].dtype == torch.int32 and ts["opt"]["step"].dim() == 0
    for part in ("mu", "nu"):
        got, want = _flat(ts["opt"][part]), _flat_jax(js["opt"][part])
        assert set(got) == set(want) == set(_flat(ts["params"]))
