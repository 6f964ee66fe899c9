"""Training of every family the port serves, against the JAX package.

Reduced float32 qwen2-vl-7b (vlm: M-RoPE, the vision-embedding overlay),
whisper-tiny (audio: encoder, cross-attention), dbrx-132b and
deepseek-v2-236b (MoE, deepseek with MLA and a leading dense layer; both at
``capacity_factor`` 1.25, where the batch below drops assignments),
rwkv6-7b (ssm) and zamba2-2.7b (hybrid), with the port's seeded weights
stacked into the JAX layout (the inverse of ``repro_torch.convert``; a JAX
init would cost a compile per family) and every other input made with
numpy from a seed, on the CPU:

* the port's ``make_loss_fn`` under ``torch.autograd.grad`` against
  ``jax.value_and_grad`` of the JAX ``make_loss_fn(model, remat=False)``:
  the loss within 1e-5 relative (XLA and PyTorch sum the same float32
  products in other orders), each gradient leaf within 1e-4 of its norm
  (the same sums, through a backward of some hundred operations); only
  the leaves whose exact gradient is 0 (``ZERO_GRAD``: whisper's key
  biases, attention without RoPE, to which the softmax is invariant) are
  held instead to float32 noise below 1e-6 of the whole gradient's norm
  on both sides;
* one ``make_train_step`` step against the JAX AdamW update of the JAX
  gradients (the JAX ``make_train_step`` body): new weights within
  ``1e-2 * lr`` where the gradient is well above AdamW's ``eps``, one
  step's size elsewhere (``tests/test_torch_train.py`` says why);
* ``remat=True`` against ``remat=False``; the plain flash backward at
  (D, Dv) = (192, 128) against autograd of the plain forward;
  ``Rwkv6ScanFn`` and ``Mamba2ScanFn`` against autograd through their
  plain versions (r/k broadcast over the heads, the state's gradient
  given or None);
* two GRPO iterations through ``run_training`` for each family the JAX
  loop trains, and whisper's refusal there.

Each family's JAX reference runs once, in a module-scoped fixture.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.rl.train_step import make_loss_fn as jax_loss_fn  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import STACKED, from_jax_params  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttentionFn, flash_attention_plain)
from repro_torch.kernels.mamba2_scan import (Mamba2ScanFn,  # noqa: E402
                                             mamba2_scan_plain)
from repro_torch.kernels.rwkv6_scan import (Rwkv6ScanFn,  # noqa: E402
                                            rwkv6_scan_plain)
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.rl.train_step import make_loss_fn, make_train_step  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

FAMILIES = ("qwen2-vl-7b", "whisper-tiny", "dbrx-132b", "deepseek-v2-236b",
            "rwkv6-7b", "zamba2-2.7b")
MOE_CF = 1.25          # the MoE configs' capacity factor, set back
B, S, F = 2, 16, 8     # rows, positions, vlm frontend positions
LR = 1e-3
# the leaves whose exact gradient is 0, by the end of their path: the key
# biases of attention without RoPE (whisper's self- and cross-attention)
ZERO_GRAD = {"whisper-tiny": "attn/bk"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch):
    kw = {"dtype": "float32"}
    if get_config(arch).is_moe:
        kw["capacity_factor"] = MOE_CF
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _batch(cfg, seed=0):
    """The GRPO batch of ``tests/test_torch_train.py`` with a seeded
    frontend for the vlm and audio families."""
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    mask = np.zeros((B, S), np.float32)
    mask[:, 4:] = (rs.rand(B, S - 4) > 0.2)
    adv = np.repeat(rs.randn(B, 1), S, 1).astype(np.float32) * (mask > 0)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "loss_mask": mask, "advantages": adv,
             "behavior_logp": (rs.randn(B, S) * 0.3 - 6.3).astype(
                 np.float32) * mask}
    n = {"vlm": F, "audio": cfg.max_source_len}.get(cfg.family)
    if n:
        batch["frontend"] = rs.randn(B, n, cfg.d_model).astype(np.float32)
    return batch


def _flat(tree, prefix=""):
    """{path: float32 numpy} of a port tree (per-layer lists split)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.array(tree.detach().float())
    return out


def _port_grads(model, params, batch, remat=False):
    leaves = []

    def alias(t):
        a = t.detach().clone().requires_grad_()
        leaves.append(a)
        return a
    train = _tree_map(alias, params)
    loss, metrics = make_loss_fn(model, remat=remat)(
        train, {k: _t(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss, metrics, _tree_map(lambda _: next(it), params)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _to_jax(tree):
    """A port parameter tree -> the JAX package's layout in numpy (the
    inverse of ``convert.from_jax_params``: per-layer lists stacked)."""
    if isinstance(tree, dict):
        return {k: (jax.tree.map(lambda *xs: np.stack(xs),
                                 *map(_to_jax, v))
                    if k in STACKED else _to_jax(v))
                for k, v in tree.items()}
    return tree.numpy()


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """One family's reduced model with the port's seeded init, its batch,
    and the JAX loss, gradients and AdamW update on the same weights."""
    arch = request.param
    jc, tc = _cfgs(arch)
    model = Model(tc)
    params = model.init(torch.Generator().manual_seed(1))
    jp = _to_jax(params)
    batch = _batch(tc)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ocfg = jopt.AdamWConfig(lr=LR)

    def reference(jp, jb):
        (loss, _), g = jax.value_and_grad(
            jax_loss_fn(JaxModel(jc), remat=False), has_aux=True)(jp, jb)
        new, opt, _ = jopt.adamw_update(g, jopt.adamw_init(jp, ocfg), jp,
                                        ocfg)
        return loss, g, new, opt["mu"]
    jloss, jg, jnew, jmu = jax.jit(reference)(jp, jb)
    conv = lambda tree: from_jax_params(jax.tree.map(np.asarray, tree))  # noqa: E731
    return {"arch": arch, "model": model, "params": params, "batch": batch,
            "loss": float(jloss), "grads": conv(jg), "new": conv(jnew),
            "mu": conv(jmu)}


def test_loss_and_grads_match_jax(family, monkeypatch):
    drops = []
    route = moe.moe_route

    def counting(*a, **kw):
        r = route(*a, **kw)
        drops.append(int((~r["keep"]).sum()))
        return r
    monkeypatch.setattr(moe, "moe_route", counting)
    loss, metrics, grads = _port_grads(family["model"], family["params"],
                                       family["batch"])
    np.testing.assert_allclose(float(loss.detach()), family["loss"],
                               rtol=1e-5,
                               atol=1e-7)
    got, want = _flat(grads), _flat(family["grads"])
    assert set(got) == set(want)
    total = np.sqrt(sum(np.square(w).sum() for w in want.values()))
    zero = ZERO_GRAD.get(family["arch"])
    floored = []
    for k, w in want.items():
        norm, err = np.linalg.norm(w), np.linalg.norm(got[k] - w)
        assert norm > 0, k
        if zero and k.endswith(zero):
            assert max(norm, np.linalg.norm(got[k]), err) <= 1e-6 * total, k
            floored.append(k)
        else:
            assert err <= 1e-4 * norm, (k, err / norm)
    assert bool(floored) == bool(zero), floored
    cfg = family["model"].cfg
    if cfg.is_moe:
        # the capacity of 1.25 drops assignments on this batch, and the
        # aux loss reaches the loss
        assert sum(drops) > 0 and float(metrics["moe_aux"]) > 0
    else:
        assert drops == [] and float(metrics["moe_aux"]) == 0.0


def test_adamw_step_matches_jax(family):
    """One port ``make_train_step`` (remat off, as the JAX reference's)
    against the JAX AdamW update of the JAX gradients."""
    params = _tree_map(lambda t: t.clone(), family["params"])
    state = {"params": params, "opt": topt.adamw_init(
        params, topt.AdamWConfig(lr=LR))}
    step = make_train_step(family["model"], topt.AdamWConfig(lr=LR),
                           remat=False)
    state, metrics = step(state, {k: _t(v)
                                  for k, v in family["batch"].items()})
    assert np.isfinite(float(metrics["grad_norm"]))
    got, want = _flat(state["params"]), _flat(family["new"])
    before, mu = _flat(family["params"]), _flat(family["mu"])
    for k, w in want.items():
        sharp = np.abs(mu[k]) / 0.1 > 100 * 1e-8
        np.testing.assert_allclose(got[k][sharp], w[sharp], atol=1e-2 * LR,
                                   rtol=0, err_msg=k)
        np.testing.assert_allclose(got[k], w, atol=LR, rtol=0, err_msg=k)
        if sharp.any():                 # not a leaf whose gradient is 0
            assert np.abs(got[k] - before[k]).max() > 0.5 * LR, k


def test_remat_matches_no_remat():
    """zamba2 (the SSD scan Function, and the shared block used by every
    second layer): checkpointed layers give the same loss and gradients on
    the CPU, bit for bit."""
    _, tc = _cfgs("zamba2-2.7b")
    model = Model(tc)
    params = model.init(torch.Generator().manual_seed(3))
    batch = _batch(tc, seed=1)
    l0, _, g0 = _port_grads(model, params, batch, remat=False)
    l1, _, g1 = _port_grads(model, params, batch, remat=True)
    assert float(l0) == float(l1)
    a, b = _flat(g0), _flat(g1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_backward_mla_widths(causal):
    """(D, Dv) = (192, 128), G 2, S 40: FlashAttentionFn's plain chunked
    backward (16-row chunks, so that the causal key range grows) against
    autograd through ``flash_attention_plain``, within 1e-5 (float32 sums
    in other orders)."""
    from repro_torch.kernels.flash_attention import \
        flash_attention_backward_plain
    rs = np.random.RandomState(7)
    q = _t(rs.randn(2, 40, 4, 192).astype(np.float32)).requires_grad_()
    k = _t(rs.randn(2, 40, 2, 192).astype(np.float32)).requires_grad_()
    v = _t(rs.randn(2, 40, 2, 128).astype(np.float32)).requires_grad_()
    dout = _t(rs.randn(2, 40, 4, 128).astype(np.float32))
    out = flash_attention_plain(q, k, v, causal=causal)
    want = torch.autograd.grad(out, (q, k, v), dout)
    fn = FlashAttentionFn.apply(q, k, v, causal, None)
    np.testing.assert_array_equal(fn.detach().numpy(), out.detach().numpy())
    got = torch.autograd.grad(fn, (q, k, v), dout)
    o, lse = flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                   causal=causal, return_lse=True)
    chunked = flash_attention_backward_plain(
        q.detach(), k.detach(), v.detach(), o, lse, dout, causal=causal,
        block_q=16)
    for g, c, w in zip(got, chunked, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(c.numpy(), w.numpy(), atol=1e-5, rtol=0)


def _scan_grads(fn, plain, inputs, with_state, seed=0):
    """Gradients of ``sum(y * gy) [+ sum(state * gs)]`` through ``fn`` and
    through ``plain`` with autograd, for every input that requires one."""
    rs = np.random.RandomState(seed)
    y, st = plain(*inputs)
    gy = _t(rs.randn(*y.shape).astype(np.float32))
    gs = _t(rs.randn(*st.shape).astype(np.float32))
    leaves = [t for t in inputs if t.requires_grad]
    out = []
    for f in (fn, plain):
        y, st = f(*inputs)
        loss = (y * gy).sum() + ((st * gs).sum() if with_state else 0)
        out.append(torch.autograd.grad(loss, leaves))
    return out


@pytest.mark.parametrize("with_state", [True, False])
def test_rwkv6_scan_fn_grads(with_state):
    """Rwkv6ScanFn at S 70 (two chunks), Dk 8, Dv 12 against autograd
    through the plain scan, within 1e-5 of each gradient's scale."""
    rs = np.random.RandomState(1)
    Bs, Ss, H, Dk, Dv = 2, 70, 3, 8, 12
    r, k = (_t(rs.randn(Bs, Ss, H, Dk).astype(np.float32)).requires_grad_()
            for _ in range(2))
    v = _t(rs.randn(Bs, Ss, H, Dv).astype(np.float32)).requires_grad_()
    lw = _t(-np.exp(rs.randn(Bs, Ss, H, Dk) - 2).astype(
        np.float32)).requires_grad_()
    u = _t(rs.randn(H, Dk).astype(np.float32) * 0.5).requires_grad_()
    got, want = _scan_grads(Rwkv6ScanFn.apply, rwkv6_scan_plain,
                            (r, k, v, lw, u), with_state)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("with_state", [True, False])
def test_mamba2_scan_fn_grads_through_the_head_broadcast(with_state):
    """Mamba2ScanFn with r and k stride-0 broadcasts of one (B, S, 1, N)
    slice over the heads, as the model passes them: their gradients sum
    over the heads through the expand, equal to autograd through the
    plain scan within 1e-5 of each gradient's scale."""
    rs = np.random.RandomState(2)
    Bs, Ss, H, N, hd = 2, 70, 3, 8, 12
    r0, k0 = (_t(rs.randn(Bs, Ss, 1, N).astype(np.float32)).requires_grad_()
              for _ in range(2))
    v = _t(rs.randn(Bs, Ss, H, hd).astype(np.float32)).requires_grad_()
    lw = _t(-np.exp(rs.randn(Bs, Ss, H, 1) - 2).astype(
        np.float32)).requires_grad_()

    def call(f):
        def run(r0, k0, v, lw):
            return f(r0.expand(Bs, Ss, H, N), k0.expand(Bs, Ss, H, N), v, lw)
        return run
    got, want = _scan_grads(call(Mamba2ScanFn.apply),
                            call(mamba2_scan_plain), (r0, k0, v, lw),
                            with_state)
    assert got[0].shape == (Bs, Ss, 1, N)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


def test_adamw_slices_large_leaves_bit_for_bit(monkeypatch):
    """Leaves squared and updated in flat slices of 4 elements (several a
    leaf) against the default SLICE (one a leaf): without clipping (whose scale would carry the
    norm's other summation order into the step) the update is bit for bit
    the unsliced one, and the norm within 1e-6."""
    rs = np.random.RandomState(4)
    params = {"a": _t(rs.randn(5, 7).astype(np.float32)),
              "b": _t(rs.randn(3).astype(np.float32))}
    grads = {k: _t(rs.randn(*v.shape).astype(np.float32) * 3)
             for k, v in params.items()}
    cfg = topt.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=0.0)
    out = []
    for slice_ in (topt.SLICE, 4):
        monkeypatch.setattr(topt, "SLICE", slice_)
        p = _tree_map(lambda t: t.clone(), params)
        opt = topt.adamw_init(p, cfg)
        for _ in range(2):
            _, _, m = topt.adamw_update(grads, opt, p, cfg)
        out.append((p, opt, float(m["grad_norm"])))
    (p0, o0, n0), (p1, o1, n1) = out
    for a, b in zip(topt.tree_leaves([p0, o0["mu"], o0["nu"]]),
                    topt.tree_leaves([p1, o1["mu"], o1["nu"]])):
        assert torch.equal(a, b)
    assert n1 == pytest.approx(n0, rel=1e-6)


def _low_half_reward(vocab_size):
    """A row's share of completion tokens in the lower half of the
    vocabulary: it differs from row to row, so that GRPO's advantages and
    gradients are not all 0 (the arithmetic verifier gives a random model
    0 everywhere)."""
    def reward(completions, mask, answers):
        low = ((np.asarray(completions) < vocab_size // 2) * mask).sum(1)
        return (low / np.maximum(mask.sum(1), 1)).astype(np.float32)
    return reward


@pytest.mark.parametrize("arch", [a for a in FAMILIES if a != "whisper-tiny"])
def test_run_training_two_iterations(arch):
    """Two GRPO iterations on the engine rollout: finite losses and
    gradient norms, the policy's log-probabilities the behaviour ones (a
    ratio of 1 within 1e-5: the trainer's forward and the engine's decode
    score the sampled tokens alike in float32; not for the MoE family,
    whose capacity couples other rows in training than in decode), and
    weights that move."""
    _, tc = _cfgs(arch)
    model = Model(tc)
    params = model.init(torch.Generator().manual_seed(0))
    before = _flat(params)
    state, hist = run_training(
        arch, model=model, params=params, steps=2, batch=1, group=3,
        max_new=3, rollout="engine", reward_fn=_low_half_reward(
            tc.vocab_size), log_every=0, device="cpu")
    assert [r["step"] for r in hist] == [0, 1]
    for r in hist:
        assert np.isfinite(r["loss"]) and r["grad_norm"] > 0, r
        assert tc.is_moe or abs(r["ratio_mean"] - 1) < 1e-5, r
    after = _flat(state["params"])
    assert all(np.abs(after[k] - before[k]).max() > 0 for k in before)


def test_run_training_refuses_whisper_by_name():
    with pytest.raises(ValueError, match="whisper-tiny.*no frontends"):
        run_training("whisper-tiny", reduced=True, steps=1, device="cpu")
