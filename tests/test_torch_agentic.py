"""The multi-turn agentic driver on the port against the JAX package's.

``repro_torch.rl.run_episodes`` over the port's engine (plain kernel
versions on the CPU) and ``repro.rl.run_episodes`` over the JAX engine
(jnp backend), on converted reduced-internlm2 weights in float32, with
the same ``CountdownToolEnv``: the episodes' turns, tokens, tool replies,
action masks and finish reasons are equal, logprobs within 1e-4, and the
driver's ``stats`` (ticks, turns, tool calls, tool wait) are equal.  The
three arms of the reference bench (suspend, hold the slot, zero-latency
tools) are token-identical and suspend takes no more ticks than hold; the
driver is deterministic; an environment may end an episode at a boundary,
and job tags reach the requests.
"""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.rl import CountdownToolEnv as JaxEnv  # noqa: E402
from repro.rl import run_episodes as jax_run_episodes  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.data import tokenizer as tok  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.rl import CountdownToolEnv, run_episodes  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, Request  # noqa: E402

ARCH = "internlm2-1.8b"
MAX_NEW, MAX_LEN = 14, 48


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(ARCH, reduced=True)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    return jm, jp, build_model(ARCH, reduced=True), tp


def _prompts():
    # three prompts that reach the tool boundary, one long-tail straggler
    return [np.asarray(tok.encode(t, bos=True), np.int32)
            for t in ["1+2=", "0+1=", "1+2=", "2+3="]]


def _engine(pair, kv="paged", num_slots=2, jax_engine=False):
    jm, jp, tm, tp = pair
    kw = dict(num_slots=num_slots, max_seq_len=MAX_LEN, temperature=0.0,
              kv_layout=kv, kv_block_size=4)
    if jax_engine:
        return JaxEngine(jm, jp, JaxEngineConfig(**kw))
    return Engine(tm, tp, EngineConfig(**kw), device="cpu")


def _stop(pair):
    """The greedy path's third token of the first prompt, as the JAX
    tests pick it: it fires mid-sequence."""
    eng = _engine(pair)
    eng.submit(Request(rid=0, prompt=_prompts()[0], max_new_tokens=MAX_NEW))
    [out] = eng.run()
    return (out.tokens[2],)


def _env(pair, cls=CountdownToolEnv, turns=2, tool_len=3):
    return cls(_stop(pair), vocab=pair[2].cfg.vocab_size, turns=turns,
               tool_len=tool_len)


def _same_episodes(a, b, atol=0.0):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.gen_tokens == y.gen_tokens, x.index
        assert x.full_completion == y.full_completion
        assert x.action_mask == y.action_mask
        assert x.finish_reason == y.finish_reason
        assert [t.tool_tokens for t in x.turns] == \
            [list(map(int, t.tool_tokens)) for t in y.turns]
        assert x.token_versions == y.token_versions
        np.testing.assert_allclose(x.logprobs, y.logprobs, atol=atol,
                                   rtol=0)


@pytest.mark.parametrize("kv", ["contiguous", "paged"])
def test_run_episodes_matches_jax(pair, kv):
    env = _env(pair)
    jenv = _env(pair, JaxEnv)
    for hold in (False, True):
        eps, stats = run_episodes(_engine(pair, kv), env, _prompts(),
                                  max_new_tokens=MAX_NEW,
                                  tool_latency_ticks=4, hold_slots=hold)
        jeps, jstats = jax_run_episodes(
            _engine(pair, kv, jax_engine=True), jenv, _prompts(),
            max_new_tokens=MAX_NEW, tool_latency_ticks=4, hold_slots=hold)
        _same_episodes(eps, jeps, atol=1e-4)
        assert stats == jstats
        assert [(e.submit_tick, e.finish_tick, e.tool_wait_ticks)
                for e in eps] == [(e.submit_tick, e.finish_tick,
                                   e.tool_wait_ticks) for e in jeps]
    assert any(len(e.turns) >= 2 for e in eps)   # multi-turn happened


def test_three_arms_are_token_identical(pair):
    """suspend, hold and zero-latency tools (the bench's ideal) generate
    the same tokens; suspend reclaims ticks hold spends waiting."""
    env = _env(pair)
    runs = {}
    for name, latency, hold in (("suspend", 6, False), ("hold", 6, True),
                                ("ideal", 0, False)):
        runs[name] = run_episodes(_engine(pair), env, _prompts(),
                                  max_new_tokens=MAX_NEW,
                                  tool_latency_ticks=latency,
                                  hold_slots=hold)
    for other in ("hold", "ideal"):
        _same_episodes(runs["suspend"][0], runs[other][0])
    ticks = {k: v[1]["ticks"] for k, v in runs.items()}
    assert ticks["ideal"] <= ticks["suspend"] < ticks["hold"]
    assert runs["suspend"][1]["tool_calls"] == \
        runs["hold"][1]["tool_calls"] > 0


def test_episode_structure_and_masks(pair):
    env = _env(pair)
    eng = _engine(pair)
    eps, stats = run_episodes(eng, env, _prompts(), max_new_tokens=MAX_NEW)
    multi = [e for e in eps if len(e.turns) >= 2]
    assert multi
    for e in eps:
        assert len(e.gen_tokens) <= MAX_NEW
        assert sum(e.action_mask) == len(e.gen_tokens)
        assert len(e.action_mask) == len(e.full_completion)
        assert len(e.logprobs) == len(e.token_versions) == len(e.gen_tokens)
        assert e.finish_reason in ("eos", "length", "env_done")
        for turn in e.turns[:-1]:
            assert turn.tokens[-1] in env.stop_tokens
            assert len(turn.tool_tokens) == env.tool_len
    # the first turn is the uninterrupted run's prefix
    e = multi[0]
    ref = _engine(pair)
    ref.submit(Request(rid=0, prompt=e.prompt, max_new_tokens=MAX_NEW))
    [out] = ref.run()
    assert e.turns[0].tokens == out.tokens[:len(e.turns[0].tokens)]
    assert stats["turns"] == sum(len(e.turns) for e in eps)
    m = eng.metrics()
    assert m.suspends == m.resumes == stats["tool_calls"]
    assert m.suspended == 0
    eng.slots.alloc.assert_clean(context="after the episodes")


def test_driver_is_deterministic_across_runs(pair):
    env = _env(pair)
    a, _ = run_episodes(_engine(pair), env, _prompts(),
                        max_new_tokens=MAX_NEW, tool_latency_ticks=3)
    b, _ = run_episodes(_engine(pair), env, _prompts(),
                        max_new_tokens=MAX_NEW, tool_latency_ticks=3)
    _same_episodes(a, b)


def test_env_can_terminate_episode_at_boundary(pair):
    class OneShotEnv(CountdownToolEnv):
        def react(self, episode, turn_tokens):
            return None, True               # done at the first boundary

    env = _env(pair, OneShotEnv)
    eng = _engine(pair)
    eps, _ = run_episodes(eng, env, _prompts(), max_new_tokens=MAX_NEW)
    assert any(e.finish_reason == "env_done" and len(e.turns) == 1
               for e in eps)
    eng.reset()                             # dropped handles left no pin
    eng.slots.alloc.assert_clean(context="env_done episodes")


def test_job_tags_flow_to_requests(pair):
    env = _env(pair)
    eng = _engine(pair)
    seen = []
    submit = eng.submit

    def spy(req):
        seen.append((req.job_id, req.priority))
        return submit(req)
    eng.submit = spy
    eps, _ = run_episodes(eng, env, _prompts(), max_new_tokens=MAX_NEW,
                          job_ids=["a", "a", "b", "b"],
                          priorities=[1, 0, 0, 2])
    assert [e.job_id for e in eps] == ["a", "a", "b", "b"]
    assert [e.priority for e in eps] == [1, 0, 0, 2]
    assert seen == [("a", 1), ("a", 0), ("b", 0), ("b", 2)]
