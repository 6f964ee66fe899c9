"""The plain reference against the program at tiny sizes on the CPU: the
forward, and one GRPO step (loss, gradient norm, AdamW update) in
float32, where the two must agree to float32 rounding; and each
configuration's file against the program's config, which a run refuses
to go on without."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from rlbench import run as R
from rlbench.harness.config import (ConfigMismatch, check_model, differences,
                                    file_abstract, file_view)
from rlbench.harness.weights import make_weights, storage_dtypes
from rlbench.reference.grpo import Follower, group_advantages, tree_leaves
from rlbench.reference.models import forward

ARCHS = ("internlm2-1.8b",)
CONFIGS = [c["file"] for c in json.loads(
    (R.ROOT / "BENCHMARK.json").read_text())["configs"]]
OPT = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.0,
       "grad_clip": 1.0, "warmup": 10, "lr": 3e-4}


def tiny(arch, dtype="float32"):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    return Model(dataclasses.replace(get_config(arch).reduced(),
                                     dtype=dtype))


def tiny_file(m) -> dict:
    """A configuration file that states the tiny model."""
    return {"name": m.cfg.name, **file_view(m.cfg)}


@pytest.mark.parametrize("path", CONFIGS)
def test_config_file_states_the_programs_model(path):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = json.loads((R.ROOT / path).read_text())
    m = Model(get_config(cfg["port_arch"]))
    assert differences(cfg, m.cfg, m.init_abstract()) == []
    abstract = file_abstract(cfg)
    assert sum(t.numel() for _, t in tree_leaves(abstract)) \
        == cfg["parameters"]
    assert [(p, t.shape, t.dtype) for p, t in tree_leaves(abstract)] \
        == [(p, t.shape, t.dtype) for p, t in tree_leaves(m.init_abstract())]
    # nested in the program's own order, so the program's weights are
    # laid out as its own init lays them out
    assert [list(x) for x in (abstract, abstract["layers"][0])] == [
        list(x) for x in (m.init_abstract(), m.init_abstract()["layers"][0])]


@pytest.mark.parametrize("key,value", [("hidden_size", 2304),
                                       ("num_key_value_heads", 16),
                                       ("rope_theta", 10000.0),
                                       ("tie_word_embeddings", True)])
def test_a_program_that_departs_from_the_file_is_refused(key, value):
    m = tiny("internlm2-1.8b", "bfloat16")
    cfg = tiny_file(m)
    check_model(cfg, m, m.init_abstract())
    with pytest.raises(ConfigMismatch, match=key):
        check_model({**cfg, key: value}, m, m.init_abstract())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_program(arch):
    m = tiny(arch)
    cfg = tiny_file(m)
    p = make_weights(file_abstract(cfg), 5, "cpu")
    tok = torch.randint(0, m.cfg.vocab_size, (2, 37),
                        generator=torch.Generator().manual_seed(1))
    want, _ = m.forward(p, tok)
    got = forward(p, cfg, tok)
    assert (got - want).abs().max() < 2e-4 * want.abs().max()


@pytest.mark.parametrize("arch", ARCHS)
def test_one_grpo_step_matches_program(arch):
    from repro_torch.rl.coexec import build_train_batch
    from repro_torch.rl.train_step import make_train_step
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             warmup_cosine)
    m = tiny(arch)
    abstract = m.init_abstract()
    gen = torch.Generator().manual_seed(3)
    B, Sp, T, G = 4, 10, 6, 2
    tokens = torch.randint(0, m.cfg.vocab_size, (B, Sp + T), generator=gen)
    mask = torch.ones(B, T)
    mask[1, 4:] = 0
    rewards = np.array([0.1, 0.7, 0.4, 0.2], np.float32)
    adv = group_advantages(rewards, G)
    # the program: its train step on the rollout's batch, on-policy
    params = make_weights(abstract, 9, "cpu")
    with torch.no_grad():
        lg, _ = m.forward(params, tokens)
        blogp = torch.log_softmax(lg[:, Sp - 1:-1], -1).gather(
            -1, tokens[:, Sp:, None])[..., 0]
    out = {"tokens": tokens, "completions": tokens[:, Sp:], "mask": mask,
           "behavior_logp": blogp}
    cfg = AdamWConfig(lr=OPT["lr"])
    step = make_train_step(m, cfg, lr_schedule=warmup_cosine(cfg.lr, 10, 50))
    state = {"params": params, "opt": adamw_init(params, cfg)}
    state, met = step(state, build_train_batch(out, adv, Sp))
    # the reference from the same weights
    f = Follower(make_weights(abstract, 9, "cpu"), tiny_file(m),
                 storage_dtypes(abstract), opt=OPT, rows_per_block=3)
    zeros = torch.zeros(B, Sp - 1)
    r = f.step(tokens, torch.cat([zeros, mask], 1),
               torch.cat([zeros, torch.as_tensor(adv)[:, None].expand(B, T)],
                         1))
    assert abs(float(met["loss"]) - r["loss"]) < 1e-5
    assert abs(float(met["grad_norm"]) - r["grad_norm"]) \
        < 1e-4 * r["grad_norm"]
    prog = dict(tree_leaves(state["params"]))
    ref = dict(tree_leaves(f.params))
    for p, t in ref.items():
        assert (prog[p] - t).abs().max() < 1e-5, p


def test_storage_rounding_keeps_bf16_values():
    m = tiny("internlm2-1.8b", "bfloat16")
    abstract = m.init_abstract()
    f = Follower(make_weights(abstract, 2, "cpu"), tiny_file(m),
                 storage_dtypes(abstract), opt=OPT)
    for _, t in tree_leaves(f.params):
        assert torch.equal(t, t.to(torch.bfloat16).float())
    g = Follower(make_weights(abstract, 2, "cpu"), tiny_file(m),
                 storage_dtypes(abstract), opt=OPT, store="fp8")
    diffs = [float((a - b).abs().max()) for (_, a), (_, b)
             in zip(tree_leaves(f.params), tree_leaves(g.params))]
    assert max(diffs) > 0
