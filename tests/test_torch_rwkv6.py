"""The rwkv6 serving slice of the port against the JAX package.

Reduced rwkv6-7b (2 layers, d_model 256, 4 heads of 64, vocab 512) in
float32 on the CPU, with the JAX init carried across by
``repro_torch.convert``.  The JAX init leaves the token-shift mixes, the
bonus ``u`` and the group-norm weights at constants (zeros, ones) and the
decays almost at 1 (``w0 = -6``), which would hide a wrong shift, a dropped
bonus or a wrong decay; :func:`_randomize` redraws those leaves with numpy
from a seed before both sides see them.

Scan inputs are numpy arrays from a seed fed to both sides.  The plain scan
agrees with the JAX Pallas kernel (interpret mode) and the JAX chunked scan
within 2e-5 of the output's largest magnitude plus 1e-5 relative
(:func:`_close_scaled`), and with the naive oracle at the JAX kernel test's
own 2e-3 / 5e-4.  The bound is scaled because float32 sums of a few
hundred terms of magnitude ~50 differ by more than 1e-5 in absolute terms
between any two summation orders: on these inputs the JAX package's own
Pallas kernel and chunked scan differ by up to 4.6e-4 on outputs of
magnitude 47.5, and with strong decays the running sums reach ~-512, where
a float32 ulp is 3e-5, so XLA's cumsum association and PyTorch's move each
exp(cl_c - cl_s) by that much relatively.  Whole-model tolerances are 1e-4,
as for the dense slice.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv6_scan  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import linear_scan as jls  # noqa: E402
from repro.models import rwkv6 as jrw  # noqa: E402
from repro.models.common import group_norm_heads as jax_gn  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (rwkv6_scan,  # noqa: E402
                                            rwkv6_scan_plain)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import linear_scan as tls  # noqa: E402
from repro_torch.models import rwkv6 as trw  # noqa: E402
from repro_torch.models.common import group_norm_heads  # noqa: E402
from repro_torch.models.stacks import stack_forward  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, Request  # noqa: E402
from repro_torch.serve.slots import insert_cache  # noqa: E402

ARCH = "rwkv6-7b"
ROOT = Path(__file__).resolve().parents[1]
ORACLE_TOL = dict(atol=5e-4, rtol=2e-3)       # tests/test_kernels.py:74
TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(t):
    return t.detach().numpy()


def _close_scaled(got, want, err_msg=""):
    """|got - want| <= 2e-5 max|want| + 1e-5 |want| (see the docstring)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=2e-5 * float(np.abs(want).max()),
                               err_msg=err_msg)


def _randomize(jp, seed=0):
    """Redraw the constant-initialised rwkv6 leaves (numpy, from ``seed``):
    mixes in [0, 1), bonus u ~ N(0, 0.5), group-norm weights near 1, layer
    norms near 0, and w0 in [-2, 1) so the decays are far from 1."""
    rs = np.random.RandomState(seed)
    p = jax.tree.map(np.asarray, jp)
    mix = dict(p["layers"]["mix"])
    for name in ("mu_x", "mu", "cm_mu_k", "cm_mu_r"):
        mix[name] = rs.uniform(0, 1, mix[name].shape).astype(np.float32)
    mix["u"] = (rs.randn(*mix["u"].shape) * 0.5).astype(np.float32)
    mix["ln_x"] = (1 + 0.1 * rs.randn(*mix["ln_x"].shape)).astype(np.float32)
    mix["w0"] = rs.uniform(-2, 1, mix["w0"].shape).astype(np.float32)
    layers = dict(p["layers"], mix=mix)
    for name in ("ln1", "ln2"):
        layers[name] = (0.1 * rs.randn(*layers[name].shape)).astype(
            np.float32)
    return dict(p, layers=layers)


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(ARCH, reduced=True)
    jp_np = _randomize(jm.init(jax.random.PRNGKey(1)))
    jp = jax.tree.map(jnp.asarray, jp_np)
    tm = build_model(ARCH, reduced=True)
    tp = from_jax_params(jp_np)
    return jm, jp, tm, tp


def _scan_inputs(S, Dk, Dv, decay, B=2, H=2, seed=0):
    rs = np.random.RandomState(seed)
    r = rs.randn(B, S, H, Dk).astype(np.float32)
    k = rs.randn(B, S, H, Dk).astype(np.float32)
    v = rs.randn(B, S, H, Dv).astype(np.float32)
    if decay == "normal":                   # the JAX kernel test's decays
        lw = -np.exp(rs.randn(B, S, H, Dk))
    else:                                   # strong: down to -8 per step
        lw = -rs.uniform(1e-3, 8.0, (B, S, H, Dk))
    u = rs.randn(H, Dk).astype(np.float32)
    return r, k, v, lw.astype(np.float32), u


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S,Dk,Dv,decay", [
    (33, 16, 16, "normal"),          # shorter than a chunk
    (64, 32, 32, "normal"),          # exactly one chunk
    (100, 16, 16, "normal"),         # ragged second chunk
    (130, 32, 16, "normal"),         # ragged third chunk, Dk > Dv
    (70, 16, 48, "normal"),          # Dk < Dv
    (130, 16, 16, "strong"),         # cl reaches ~-512 inside a chunk
    (64, 8, 24, "strong"),
])
def test_scan_plain_matches_jax_kernel_chunked_and_oracle(S, Dk, Dv, decay):
    r, k, v, lw, u = _scan_inputs(S, Dk, Dv, decay)
    y, st = rwkv6_scan_plain(*map(_t, (r, k, v, lw, u)))
    assert y.shape == (2, S, 2, Dv) and st.shape == (2, 2, Dk, Dv)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    ja = tuple(map(jnp.asarray, (r, k, v, lw, u)))
    for name, (jy, jst) in (
            ("pallas", jax_rwkv6_scan(*ja, interpret=True)),
            ("chunked", jls.chunked_decay_attention(*ja))):
        _close_scaled(_n(y), jy, name)
        _close_scaled(_n(st), jst, name)
    jy, jst = jref.rwkv6_scan_ref(*ja)
    np.testing.assert_allclose(_n(y), np.asarray(jy), **ORACLE_TOL)
    np.testing.assert_allclose(_n(st), np.asarray(jst), **ORACLE_TOL)


def test_scan_wrapper_on_cpu_is_the_plain_version():
    r, k, v, lw, u = map(_t, _scan_inputs(100, 16, 16, "normal"))
    before = rwkv6_scan.launches
    y, st = rwkv6_scan(r, k, v, lw, u)
    y0, st0 = rwkv6_scan_plain(r, k, v, lw, u)
    assert torch.equal(y, y0) and torch.equal(st, st0)
    assert rwkv6_scan.launches == before        # no kernel on the CPU


def test_scan_plain_bf16_keeps_v_dtype_and_float32_state():
    r, k, v, lw, u = map(_t, _scan_inputs(40, 16, 16, "normal"))
    bf = torch.bfloat16
    y, st = rwkv6_scan_plain(r.to(bf), k.to(bf), v.to(bf), lw, u)
    y32, st32 = rwkv6_scan_plain(r.to(bf).float(), k.to(bf).float(),
                                 v.to(bf).float(), lw, u)
    assert y.dtype == bf and st.dtype == torch.float32
    assert torch.equal(y, y32.to(bf)) and torch.equal(st, st32)


# ---------------------------------------------------------------------------
# models/linear_scan.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("decay_in_output,with_u,with_initial", [
    (True, False, False),            # Mamba2's form
    (True, False, True),
    (False, True, True),             # RWKV6 continuing from a state
    (False, False, False),
])
def test_chunked_decay_attention_matches_jax(decay_in_output, with_u,
                                             with_initial):
    r, k, v, lw, u = _scan_inputs(100, 16, 24, "normal", seed=3)
    if decay_in_output:                      # scalar decay per head
        lw = lw[..., :1]
    rs = np.random.RandomState(4)
    s0 = rs.randn(2, 2, 16, 24).astype(np.float32) if with_initial else None
    uu = u if with_u else None
    y, st = tls.chunked_decay_attention(
        _t(r), _t(k), _t(v), _t(lw), None if uu is None else _t(uu),
        decay_in_output=decay_in_output,
        initial_state=None if s0 is None else _t(s0))
    jy, jst = jls.chunked_decay_attention(
        jnp.asarray(r), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lw),
        None if uu is None else jnp.asarray(uu),
        decay_in_output=decay_in_output,
        initial_state=None if s0 is None else jnp.asarray(s0))
    _close_scaled(_n(y), jy)
    _close_scaled(_n(st), jst)


@pytest.mark.parametrize("decay_in_output,with_u", [(False, True),
                                                    (True, False),
                                                    (False, False)])
def test_naive_and_decode_step_match_jax(decay_in_output, with_u):
    r, k, v, lw, u = _scan_inputs(20, 16, 8, "normal", seed=5)
    uu = u if with_u else None
    y, st = tls.naive_decay_attention(
        _t(r), _t(k), _t(v), _t(lw), None if uu is None else _t(uu),
        decay_in_output=decay_in_output)
    jy, jst = jls.naive_decay_attention(
        *map(jnp.asarray, (r, k, v, lw)),
        None if uu is None else jnp.asarray(uu),
        decay_in_output=decay_in_output)
    _close_scaled(_n(y), jy)
    _close_scaled(_n(st), jst)
    s0 = np.random.RandomState(6).randn(2, 2, 16, 8).astype(np.float32)
    y1, st1 = tls.decay_attention_decode_step(
        _t(s0), _t(r[:, 0]), _t(k[:, 0]), _t(v[:, 0]), _t(lw[:, 0]),
        None if uu is None else _t(uu), decay_in_output=decay_in_output)
    jy1, jst1 = jls.decay_attention_decode_step(
        jnp.asarray(s0), *map(jnp.asarray, (r[:, 0], k[:, 0], v[:, 0],
                                            lw[:, 0])),
        None if uu is None else jnp.asarray(uu),
        decay_in_output=decay_in_output)
    _close_scaled(_n(y1), jy1)
    _close_scaled(_n(st1), jst1)


def test_group_norm_heads_matches_jax():
    rs = np.random.RandomState(7)
    x = rs.randn(2, 5, 4, 64).astype(np.float32) * 3 + 1
    w = (1 + 0.1 * rs.randn(4, 64)).astype(np.float32)
    np.testing.assert_allclose(
        _n(group_norm_heads(_t(x), _t(w), 64e-5)),
        np.asarray(jax_gn(jnp.asarray(x), jnp.asarray(w), 64e-5)),
        atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Blocks, parameters
# ---------------------------------------------------------------------------
def _leaves(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_matches_the_ports_own_init(dtype):
    """Every converted leaf lands where the port's init puts it, with its
    shape and dtype (``mu (5, d)``, ``tm_w2 (5, 32, d)`` unstacked per
    layer; ``w0`` and ``u`` float32 in a bf16 model), bit for bit."""
    from repro.configs.base import get_config as jax_get_config

    from repro.models.model import Model as JaxModel
    cfg = dataclasses.replace(jax_get_config(ARCH).reduced(), dtype=dtype)
    jp = jax.tree.map(np.asarray, JaxModel(cfg).init(jax.random.PRNGKey(2)))
    want = {}                         # JAX leaves, stacked layers split
    for path, a in _leaves(jp).items():
        if path.startswith("layers/"):
            for i in range(a.shape[0]):
                want[f"layers/{i}/{path[len('layers/'):]}"] = a[i]
        else:
            want[path] = a
    conv = _leaves(from_jax_params(jp))
    own_model = build_model(dataclasses.replace(
        build_model(ARCH, reduced=True).cfg, dtype=dtype))
    own = _leaves(own_model.init(torch.Generator().manual_seed(0)))
    assert set(conv) == set(own) == set(want)
    for path, t in conv.items():
        assert t.shape == own[path].shape and t.dtype == own[path].dtype, \
            path
        a = want[path]
        got = (t.view(torch.int16).numpy().view(np.uint16)
               if t.dtype == torch.bfloat16 else t.numpy())
        np.testing.assert_array_equal(
            got, a.view(np.uint16) if a.dtype.name == "bfloat16" else a,
            err_msg=path)
    assert own["layers/0/mix/w0"].dtype == own["layers/0/mix/u"].dtype \
        == torch.float32
    assert float(own["layers/0/mix/w0"][0]) == -6.0
    assert not own["layers/0/mix/u"].any()


def test_time_mix_and_channel_mix_match_jax(pair):
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    jmix = jax.tree.map(lambda a: a[0], jp["layers"]["mix"])
    tmix = tp["layers"][0]["mix"]
    rs = np.random.RandomState(8)
    x = rs.randn(2, 70, cfg.d_model).astype(np.float32)
    out, (ax, st) = trw.rwkv6_time_mix_full(tmix, cfg, _t(x))
    jout, (jax_, jst) = jrw.rwkv6_time_mix_full(jmix, jm.cfg, jnp.asarray(x))
    for a, b in ((out, jout), (ax, jax_), (st, jst)):
        np.testing.assert_allclose(_n(a), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    # one step from a non-zero state and shift vector
    x1 = rs.randn(2, 1, cfg.d_model).astype(np.float32)
    last = rs.randn(2, cfg.d_model).astype(np.float32)
    s0 = rs.randn(2, cfg.num_heads, 64, 64).astype(np.float32)
    got = trw.rwkv6_time_mix_step(tmix, cfg, _t(x1), _t(last), _t(s0))
    want = jrw.rwkv6_time_mix_step(jmix, jm.cfg, jnp.asarray(x1),
                                   jnp.asarray(last), jnp.asarray(s0))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_n(a), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    for lx in (None, last):
        got = trw.rwkv6_channel_mix(tmix, cfg, _t(x),
                                    None if lx is None else _t(lx))
        want = jrw.rwkv6_channel_mix(jmix, jm.cfg, jnp.asarray(x),
                                     None if lx is None
                                     else jnp.asarray(lx))
        for a, b in zip(got, want):
            np.testing.assert_allclose(_n(a), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)


# ---------------------------------------------------------------------------
# Prefill, decode step, engine
# ---------------------------------------------------------------------------
def _check_cache(cache, jcache, tol=TOL):
    assert set(cache) == set(jcache) == {"att_x", "ffn_x", "wkv", "index"}
    for name in ("att_x", "ffn_x", "wkv", "index"):
        np.testing.assert_allclose(_n(cache[name]), np.asarray(jcache[name]),
                                   **tol, err_msg=name)


def test_prefill_matches_jax(pair):
    jm, jp, tm, tp = pair
    tokens = np.random.RandomState(9).randint(0, 512, (2, 70)).astype(
        np.int32)
    logits, cache = tm.prefill(tp, _t(tokens),
                               tm.init_cache(2, 96, device="cpu"))
    jlogits, jcache = jm.prefill(jp, jnp.asarray(tokens),
                                 jm.init_cache(2, 96))
    np.testing.assert_allclose(_n(logits), np.asarray(jlogits), **TOL)
    _check_cache(cache, jcache)
    assert int(cache["index"]) == 70


def test_batched_decode_step_matches_jax_per_slot(pair):
    """Three slots at different positions, two decode steps of the whole
    pool against the JAX model's batch-1 decode step per slot (what the
    JAX engine vmaps)."""
    jm, jp, tm, tp = pair
    rs = np.random.RandomState(10)
    prompts = [rs.randint(0, 512, n).astype(np.int32) for n in (5, 70, 33)]
    pool = tm.init_cache(3, 96, device="cpu")
    pool["index"] = torch.zeros((3,), dtype=torch.int32)
    jcaches = []
    for slot, pr in enumerate(prompts):
        _, one = tm.prefill(tp, _t(pr[None]),
                            tm.init_cache(1, 96, device="cpu"))
        insert_cache(pool, one, slot)
        _, jone = jm.prefill(jp, jnp.asarray(pr[None]), jm.init_cache(1, 96))
        jcaches.append(jone)
    for step in range(2):
        token = rs.randint(0, 512, (3, 1)).astype(np.int32)
        logits, pool = tm.decode_step(tp, _t(token), pool)
        for slot in range(3):
            jlogits, jcaches[slot] = jm.decode_step(
                jp, jnp.asarray(token[slot:slot + 1]), jcaches[slot])
            np.testing.assert_allclose(_n(logits[slot]),
                                       np.asarray(jlogits[0]), **TOL)
            one = {n: (t[slot] if n == "index" else t[:, slot:slot + 1])
                   for n, t in pool.items()}
            _check_cache(one, jcaches[slot])
    assert pool["index"].tolist() == [7, 72, 35]
    assert not tm.kernel_supported()


def test_engine_matches_jax_engine(pair):
    """Six ragged requests through three slots (slots are reused), greedy,
    eight new tokens: tokens identical to the JAX engine's jnp path,
    logprobs within 1e-4."""
    jm, jp, tm, tp = pair
    rs = np.random.RandomState(11)
    prompts = [rs.randint(0, 512, n).astype(np.int32)
               for n in (5, 17, 9, 70, 3, 33)]
    T = 8

    def run(engine, request_cls):
        for i, pr in enumerate(prompts):
            assert engine.submit(request_cls(rid=i, prompt=pr,
                                             max_new_tokens=T))
        return engine.run()

    outs = run(Engine(tm, tp, EngineConfig(num_slots=3, max_seq_len=96),
                      device="cpu"), Request)
    jouts = run(JaxEngine(jm, jp, JaxEngineConfig(
        num_slots=3, max_seq_len=96, kernel_backend="jnp")), JaxRequest)
    assert [o.rid for o in outs] == [o.rid for o in jouts] == list(range(6))
    for o, jo in zip(outs, jouts):
        assert o.tokens == jo.tokens, o.rid
        assert o.finish_reason == jo.finish_reason
        np.testing.assert_allclose(o.logprobs, jo.logprobs, atol=1e-4,
                                   rtol=0)
    assert sum(o.num_tokens for o in outs) > 6


# ---------------------------------------------------------------------------
# Refusals and the CLI
# ---------------------------------------------------------------------------
def test_ssm_refusals(pair):
    jm, jp, tm, tp = pair
    # the training forward runs the family (through Rwkv6ScanFn): its last
    # position's logits are the prefill's
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    logits, aux = stack_forward(tp, tm.cfg, tokens)
    last, _ = tm.prefill(tp, tokens, tm.init_cache(1, 8, device="cpu"))
    assert logits.shape == (1, 4, tm.cfg.vocab_size) and float(aux) == 0
    assert torch.isfinite(logits).all()
    np.testing.assert_allclose(logits[:, -1].numpy(), last.numpy(),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="int8"):
        Engine(tm, tp, EngineConfig(num_slots=2, max_seq_len=32,
                                    kv_layout="paged", kv_dtype="int8"),
               device="cpu")
    eng = Engine(tm, tp, EngineConfig(num_slots=2, max_seq_len=32,
                                      kv_layout="paged"), device="cpu")
    assert eng.slots.paged_names == () and eng.slots.blocks_required(32) == 0
    with pytest.raises(ValueError, match="stack_decode_step"):
        tm.kernel_decode_step(tp, torch.zeros((2, 1), dtype=torch.int32),
                              tm.init_cache(2, 8, device="cpu"))
    with pytest.raises(ValueError, match="stack_decode_step"):
        tm.kernel_decode_step(tp, torch.zeros((2, 1), dtype=torch.int32),
                              eng.slots.cache,
                              tables=eng.slots.device_tables())
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        r = torch.zeros(1, 8, 2, 16, device="cuda")
        u = torch.zeros(2, 16, device="cuda")
        with pytest.raises(NotImplementedError, match="zero state"):
            rwkv6_scan(r, r, r, r, u,
                       initial_state=torch.zeros(1, 2, 16, 16,
                                                 device="cuda"))


@pytest.mark.parametrize("case", ["log_w_bf16", "mixed_rkv", "head_dim",
                                  "u_shape"])
def test_scan_wrapper_refuses_what_the_kernel_does_not_take(case):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        D = 160 if case == "head_dim" else 16
        r = torch.zeros(1, 8, 2, D, device="cuda")
        lw = r.to(torch.bfloat16) if case == "log_w_bf16" else r
        k = r.to(torch.bfloat16) if case == "mixed_rkv" else r
        u = torch.zeros(3 if case == "u_shape" else 2, D, device="cuda")
        err = TypeError if case in ("log_w_bf16", "mixed_rkv") \
            else ValueError
        with pytest.raises(err):
            rwkv6_scan(r, k, r, lw, u)


def test_serve_cli_reduced_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--batch", "3", "--slots", "2",
         "--max-new", "6"], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "[continuous] served 3 requests on cpu, 18 tokens" in out.stdout
