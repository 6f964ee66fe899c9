"""The static ``generate`` rollout and the ``rollout="static"`` default.

``repro_torch.rl.generate`` (prefill once, one batched decode step per
token through ``Model.decode_step``; plain kernel versions on the CPU)
against the JAX package's jitted ``generate`` scan on converted reduced
weights in float32, at temperature 0: tokens and mask identical,
logprobs within 1e-4, for the dense, ssm and hybrid families.  Sampled,
the static batch draws from the job's generator what the engine draws
when every row has a slot from the first tick, so the two rollouts give
the same tokens (logprobs within 1e-5).  ``GRPOJob()`` and the training
CLI default to ``rollout="static"``, as the JAX package does, and a
greedy static GRPO iteration matches the JAX job's (tokens and rewards
identical; loss, entropy and ratios at 1e-4).
"""
import dataclasses
import sys

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.rl import coexec as jcoexec  # noqa: E402
from repro.rl.rollout import SamplerConfig as JaxSampler  # noqa: E402
from repro.rl.rollout import generate as jax_generate  # noqa: E402
from repro_torch.convert import from_jax_params, from_jax_train_state  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.rl import SamplerConfig, generate  # noqa: E402
from repro_torch.rl import coexec  # noqa: E402
from repro_torch.rl.rollout import generate_continuous  # noqa: E402

T = 8


def _pair(arch):
    jcfg = jax_get_config(arch).reduced()
    jcfg = dataclasses.replace(jcfg, dtype="float32",
                               num_layers=min(jcfg.num_layers, 4))
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(dataclasses.replace(build_model(arch, reduced=True).cfg,
                                         num_layers=jcfg.num_layers))
    return jm, jp, tm, from_jax_params(jax.tree.map(np.asarray, jp))


def _prompts(B=5, S=7):
    return np.random.RandomState(0).randint(0, 256, size=(B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "rwkv6-7b",
                                  "zamba2-2.7b"])
def test_generate_matches_jax_generate(arch):
    jm, jp, tm, tp = _pair(arch)
    prompts = _prompts()
    ref = jax_generate(jm, jp, prompts, jax.random.PRNGKey(0),
                       JaxSampler(max_new_tokens=T, temperature=0.0))
    got = generate(tm, tp, prompts, SamplerConfig(max_new_tokens=T))
    for k in ("prompts", "completions", "tokens", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["behavior_logp"].numpy(),
                               np.asarray(ref["behavior_logp"]), atol=1e-4,
                               rtol=0)
    assert got["completions"].dtype == torch.int32
    assert got["mask"].dtype == torch.float32


def test_sampled_generate_draws_what_the_engine_draws():
    _, _, tm, tp = _pair("internlm2-1.8b")
    prompts = _prompts()
    sampler = SamplerConfig(max_new_tokens=T, temperature=1.0)
    static = generate(tm, tp, prompts, sampler,
                      generator=torch.Generator().manual_seed(3))
    eng = generate_continuous(tm, tp, prompts, sampler, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    mask = static["mask"].numpy()
    np.testing.assert_array_equal(mask, eng["mask"].numpy())
    np.testing.assert_array_equal(static["completions"].numpy() * mask,
                                  eng["completions"].numpy() * mask)
    np.testing.assert_allclose(static["behavior_logp"].numpy() * mask,
                               eng["behavior_logp"].numpy(), atol=1e-5,
                               rtol=0)


def test_static_grpo_iteration_matches_jax_and_is_the_default():
    jm, _, tm, _ = _pair("internlm2-1.8b")
    kw = dict(seed=0, steps=4, batch=2, group=2, max_new=6, temperature=0.0)
    jjob = jcoexec.GRPOJob("job0", model=jm, **kw)
    tjob = coexec.GRPOJob("job0", model=tm, device="cpu", **kw)
    assert jjob.rollout == tjob.rollout == "static"
    jstate = jjob.init_state()
    tstate = from_jax_train_state(jax.tree.map(np.asarray, jstate))
    jb, jout = jjob.rollout_step(jstate["params"], 0)
    tb, tout = tjob.rollout_step(tstate["params"], 0)
    for k in ("completions", "mask", "tokens"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    np.testing.assert_allclose(tout["behavior_logp"].numpy(),
                               np.asarray(jout["behavior_logp"]), atol=1e-4)
    _, jrec = jjob.train_phase(jstate, jb, jout)
    _, trec = tjob.train_phase(tstate, tb, tout)
    for k in ("reward", "acc", "tokens"):
        assert trec[k] == jrec[k], k
    for k in ("loss", "entropy", "clip_frac", "ratio_mean", "ratio_max"):
        np.testing.assert_allclose(trec[k], jrec[k], atol=1e-4, rtol=1e-4,
                                   err_msg=k)
    assert "prefills" not in trec           # no engine behind it
    # the streaming rollout hands the static batch out group by group, in
    # row order
    groups = []
    b, stats = tjob.rollout_stream(tstate["params"], 1, groups.append)
    assert stats is None
    assert [g["rows"] for g in groups] == [[0, 1], [2, 3]]


def test_cli_defaults_to_the_static_rollout(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "train", "--reduced", "--device", "cpu", "--steps", "2", "--batch",
        "2", "--group", "2", "--max-new", "4"])
    seen = []
    real = coexec.GRPOJob.__init__

    def spy(self, *a, **kw):
        real(self, *a, **kw)
        seen.append(self.rollout)
    monkeypatch.setattr(coexec.GRPOJob, "__init__", spy)
    train_cli._main()
    assert seen == ["static"]
    assert "final reward" in capsys.readouterr().out
    _, hist = train_cli.run_training(reduced=True, steps=2, batch=2,
                                     group=2, max_new=4, log_every=0,
                                     device="cpu")
    assert seen == ["static", "static"] and len(hist) == 2
    assert all(np.isfinite(r["loss"]) for r in hist)
