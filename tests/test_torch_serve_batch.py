"""The static ``serve_batch`` entry point, its CLI and the port's examples.

* ``repro_torch.launch.serve.serve_batch`` on the CPU (reduced float32
  configs, weights converted from the JAX package's) against the
  reference's ``serve_batch`` at temperature 0: texts and token counts
  identical, completions identical to the reference ``generate`` on the
  same encoded prompts, log-probabilities within 1e-4 (dense, ssm, hybrid
  and audio with its zero frames).
* With no device and no card it raises instead of running on the CPU.
* ``python -m repro_torch.launch.serve --engine static --device cpu`` runs.
* Each ``examples/torch/*.py`` runs on the CPU at its smallest flags.
"""
import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402
from _jax_weights import jax_init  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["1+2=", "10+20=", "7+5=", "123+456="]
T = 6


def _pair(arch):
    from repro_torch.convert import from_jax_params
    from repro_torch.models import build_model
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               dtype="float32")
    jcfg = dataclasses.replace(jcfg, num_layers=min(jcfg.num_layers, 4))
    jm = JaxModel(jcfg)
    jp = jax_init(jm, 1)
    tm = build_model(dataclasses.replace(
        build_model(arch, reduced=True).cfg, num_layers=jcfg.num_layers))
    return jm, jp, tm, from_jax_params(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "rwkv6-7b",
                                  "zamba2-2.7b", "whisper-tiny"])
def test_serve_batch_matches_the_reference(arch):
    from repro.launch import serve as ref_serve
    from repro.rl.rollout import SamplerConfig as JaxSampler
    from repro.rl.rollout import generate as jax_generate

    from repro_torch.launch.serve import serve_batch
    jm, jp, tm, tp = _pair(arch)
    ref = ref_serve.serve_batch(arch, PROMPTS, max_new=T, temperature=0.0,
                                model=jm, params=jp)
    got = serve_batch(arch, PROMPTS, max_new=T, temperature=0.0,
                      device="cpu", model=tm, params=tp)
    assert set(ref) <= set(got)
    assert got["texts"] == ref["texts"]
    assert got["tokens"] == ref["tokens"]
    assert got["wall_s"] > 0 and got["tok_per_s"] > 0
    prompts, fr = ref_serve._encode_prompts(jm, PROMPTS)
    out = jax_generate(jm, jp, prompts, jax.random.PRNGKey(0),
                       JaxSampler(max_new_tokens=T, temperature=0.0),
                       frontend=fr)
    np.testing.assert_array_equal(got["completions"].numpy(),
                                  np.asarray(out["completions"]))
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(out["mask"]))
    np.testing.assert_allclose(got["logprobs"].numpy(),
                               np.asarray(out["behavior_logp"]), atol=1e-4,
                               rtol=0)


def test_encode_prompts_matches_the_reference():
    from repro.launch import serve as ref_serve

    from repro_torch.launch.serve import _encode_prompts
    from repro_torch.models import build_model
    for arch in ("internlm2-1.8b", "qwen2-vl-7b", "whisper-tiny"):
        jm = JaxModel(jax_get_config(arch).reduced())
        rp, rf = ref_serve._encode_prompts(jm, PROMPTS)
        p, f = _encode_prompts(build_model(arch, reduced=True), PROMPTS,
                               torch.device("cpu"))
        np.testing.assert_array_equal(np.asarray(p), np.asarray(rp))
        assert (f is None) == (rf is None)
        if f is not None:
            assert tuple(f.shape) == tuple(rf.shape)
            assert not f.any()


def test_serve_batch_needs_a_device(monkeypatch):
    from repro_torch.launch.serve import serve_batch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_batch("internlm2-1.8b", PROMPTS, reduced=True, max_new=2)


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stdout + p.stderr
    return p.stdout


def test_cli_static_engine_runs():
    out = _run(["-m", "repro_torch.launch.serve", "--engine", "static",
                "--reduced", "--device", "cpu", "--batch", "2", "--max-new",
                "4"])
    assert "[static] served 2 requests" in out


@pytest.mark.parametrize("script,args,want", [
    ("quickstart.py", ["--steps", "2", "--batch", "2", "--group", "2",
                       "--max-new", "2"], "reward: first-2 avg"),
    ("serve_batch.py", ["--arch", "internlm2-1.8b", "--batch", "2",
                        "--slots", "1", "--max-new", "2"], "[continuous, 1"),
    ("serve_batch.py", ["--arch", "internlm2-1.8b", "--batch", "2",
                        "--max-new", "2", "--engine", "static"],
     "[static]:"),
    ("trace_replay.py", ["--jobs", "8"], "RollMux"),
    ("co_execution.py", ["--iters", "1"], "context switches"),
])
def test_example_runs_on_the_cpu(script, args, want):
    extra = [] if script == "trace_replay.py" else ["--device", "cpu"]
    out = _run([os.path.join("examples", "torch", script), *args, *extra])
    assert want in out
