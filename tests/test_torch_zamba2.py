"""The zamba2 serving slice of the port against the JAX package.

Reduced zamba2-2.7b in float32 on the CPU (d_model 256, 4 Mamba2 layers
with 16 SSD heads of 32 and state 16, the shared attention block after
every 2nd layer, so two uses of it; vocab 512), with the JAX init carried
across by ``repro_torch.convert``.  The JAX init leaves ``dt_bias``,
``conv_b``, ``norm_w`` and the norms at zero, ``D`` at one and ``A_log`` at
a fixed ramp, which would hide a dropped bias, skip term or gate weight;
:func:`_randomize` redraws those leaves with numpy from a seed before both
sides see them.

Scan inputs are numpy arrays from a seed fed to both sides.  The plain scan
is held to the JAX Pallas kernel (interpret mode) and to the naive oracle
``ref.mamba2_scan_ref`` at the JAX kernel test's own tolerance
(``tests/test_kernels.py``: rtol 2e-3, atol 5e-4).  Blocks are held at
1e-5 and whole-model paths at 1e-4, as for the other slices.
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

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba2_scan import mamba2_scan as jax_mamba2_scan  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import mamba2 as jmb  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.kernels.mamba2_scan import (mamba2_scan,  # noqa: E402
                                             mamba2_scan_plain)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import mamba2 as tmb  # noqa: E402
from repro_torch.models.stacks import stack_forward  # noqa: E402
from repro_torch.models.stacks_infer import \
    stack_kernel_decode_step  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, Request  # noqa: E402
from repro_torch.serve.slots import insert_cache  # noqa: E402

ARCH = "zamba2-2.7b"
ROOT = Path(__file__).resolve().parents[1]
ORACLE_TOL = dict(atol=5e-4, rtol=2e-3)       # tests/test_kernels.py
BLOCK_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
LAYERS, VOCAB, MAX_LEN = 4, 512, 96


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(t):
    return t.detach().numpy()


def _randomize(jp, seed=0):
    """Redraw the constant-initialised zamba2 leaves (numpy, from
    ``seed``): ``dt_bias`` in [-1, 1), ``conv_b`` and ``norm_w`` ~ N(0,
    0.1), ``D`` in [0, 2), ``A_log`` in [-2, 1) per layer and head, and
    every norm near 0."""
    rs = np.random.RandomState(seed)
    p = jax.tree.map(np.asarray, jp)

    def normal(a, s=0.1):
        return (s * rs.randn(*a.shape)).astype(np.float32)

    mb = dict(p["layers"]["mamba"])
    mb["dt_bias"] = rs.uniform(-1, 1, mb["dt_bias"].shape).astype(np.float32)
    mb["conv_b"] = normal(mb["conv_b"])
    mb["norm_w"] = normal(mb["norm_w"])
    mb["D"] = rs.uniform(0, 2, mb["D"].shape).astype(np.float32)
    mb["A_log"] = rs.uniform(-2, 1, mb["A_log"].shape).astype(np.float32)
    layers = dict(p["layers"], mamba=mb, norm=normal(p["layers"]["norm"]))
    shared = dict(p["shared_attn"], ln1=normal(p["shared_attn"]["ln1"]),
                  ln2=normal(p["shared_attn"]["ln2"]))
    return dict(p, layers=layers, shared_attn=shared,
                final_norm=normal(p["final_norm"]))


@pytest.fixture(scope="module")
def pair():
    """JAX and port models at 4 layers (two shared-attention uses)."""
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                               num_layers=LAYERS, dtype="float32")
    jm = JaxModel(jcfg)
    jp_np = _randomize(jm.init(jax.random.PRNGKey(1)))
    jp = jax.tree.map(jnp.asarray, jp_np)
    tm = build_model(dataclasses.replace(build_model(ARCH, reduced=True).cfg,
                                         num_layers=LAYERS))
    tp = from_jax_params(jp_np)
    return jm, jp, tm, tp


def _scan_inputs(B, S, H, N, hd, decay, seed=0):
    rs = np.random.RandomState(seed)
    r = rs.randn(B, S, H, N).astype(np.float32)
    k = rs.randn(B, S, H, N).astype(np.float32)
    v = rs.randn(B, S, H, hd).astype(np.float32)
    if decay == "normal":                   # the JAX kernel test's decays
        lw = -np.exp(rs.randn(B, S, H, 1))
    elif decay == "weak":                   # the state carries every chunk
        lw = -np.full((B, S, H, 1), 1e-3)
    else:                                   # strong: cl near -700 a chunk
        lw = -rs.uniform(0.7, 11.0, (B, S, H, 1))
    return r, k, v, lw.astype(np.float32)


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,N,hd,chunk,decay", [
    (2, 100, 3, 16, 32, 32, "normal"),       # the JAX kernel test's shapes
    (1, 64, 2, 64, 64, 64, "normal"),
    (2, 130, 4, 8, 16, 32, "normal"),        # ragged padding
    (1, 200, 2, 16, 16, 64, "weak"),         # carried across four chunks
    (2, 130, 2, 16, 8, 64, "strong"),
])
def test_scan_plain_matches_jax_kernel_and_oracle(B, S, H, N, hd, chunk,
                                                  decay):
    r, k, v, lw = _scan_inputs(B, S, H, N, hd, decay)
    ja = tuple(map(jnp.asarray, (r, k, v, lw)))
    jy, jst = jax_mamba2_scan(*ja, chunk=chunk, interpret=True)
    oy, ost = jref.mamba2_scan_ref(*ja)
    for c in sorted({chunk, 64}):
        y, st = mamba2_scan_plain(*map(_t, (r, k, v, lw)), chunk=c)
        assert y.shape == (B, S, H, hd) and st.shape == (B, H, N, hd)
        assert y.dtype == st.dtype == torch.float32
        assert torch.isfinite(y).all() and torch.isfinite(st).all()
        for name, (wy, wst) in (("pallas", (jy, jst)), ("oracle", (oy, ost))):
            np.testing.assert_allclose(_n(y), np.asarray(wy), **ORACLE_TOL,
                                       err_msg=f"{name} y, chunk {c}")
            np.testing.assert_allclose(_n(st), np.asarray(wst), **ORACLE_TOL,
                                       err_msg=f"{name} state, chunk {c}")


def test_scan_plain_takes_the_models_mixed_dtypes():
    """r/k bf16 broadcasts of one (B, S, 1, N) slice, v float32: y is
    float32 and equals the scan of the same values materialised in
    float32."""
    r, k, v, lw = _scan_inputs(2, 70, 3, 16, 8, "normal", seed=1)
    bf = torch.bfloat16
    r1, k1 = _t(r[:, :, :1]).to(bf), _t(k[:, :, :1]).to(bf)
    rb, kb = r1.expand(2, 70, 3, 16), k1.expand(2, 70, 3, 16)
    assert rb.stride(2) == 0
    y, st = mamba2_scan_plain(rb, kb, _t(v), _t(lw))
    y32, st32 = mamba2_scan_plain(rb.float().contiguous(),
                                  kb.float().contiguous(), _t(v), _t(lw))
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    assert torch.equal(y, y32) and torch.equal(st, st32)
    jy, jst = jref.mamba2_scan_ref(*map(jnp.asarray, (
        np.broadcast_to(_n(r1.float()), (2, 70, 3, 16)),
        np.broadcast_to(_n(k1.float()), (2, 70, 3, 16)), v, lw)))
    np.testing.assert_allclose(_n(y), np.asarray(jy), **ORACLE_TOL)
    np.testing.assert_allclose(_n(st), np.asarray(jst), **ORACLE_TOL)


def test_scan_wrapper_on_cpu_is_the_plain_version():
    r, k, v, lw = map(_t, _scan_inputs(1, 100, 2, 16, 16, "normal"))
    before = mamba2_scan.launches
    y, st = mamba2_scan(r, k, v, lw)
    y0, st0 = mamba2_scan_plain(r, k, v, lw)
    assert torch.equal(y, y0) and torch.equal(st, st0)
    assert mamba2_scan.launches == before        # no kernel on the CPU


# ---------------------------------------------------------------------------
# Parameters and the Mamba2 block
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
    shape and dtype (``layers`` unstacked per layer, ``shared_attn`` once;
    ``A_log``, ``D`` and ``dt_bias`` float32 in a bf16 model), bit for
    bit."""
    cfg = dataclasses.replace(jax_get_config(ARCH).reduced(), dtype=dtype)
    jp = jax.tree.map(np.asarray, JaxModel(cfg).init(jax.random.PRNGKey(2)))
    want = {}
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
    for name in ("A_log", "D", "dt_bias"):
        assert own[f"layers/0/mamba/{name}"].dtype == torch.float32


def test_mamba2_block_and_decode_step_match_jax(pair):
    """The full-sequence block (the scan's plain version) and one decode
    step from a non-zero conv and SSM state, on a layer whose perturbed
    ``dt_bias``, ``conv_b``, ``D``, ``norm_w`` and ``A_log`` all enter."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    jblk = jax.tree.map(lambda a: a[1], jp["layers"]["mamba"])
    tblk = tp["layers"][1]["mamba"]
    rs = np.random.RandomState(3)
    x = rs.randn(2, 70, cfg.d_model).astype(np.float32)
    out, (conv, ssm) = tmb.mamba2_apply_full(tblk, cfg, _t(x))
    jout, (jconv, jssm) = jmb.mamba2_apply_full(jblk, jm.cfg, jnp.asarray(x))
    for a, b in ((out, jout), (conv, jconv), (ssm, jssm)):
        np.testing.assert_allclose(_n(a), np.asarray(b), **BLOCK_TOL)
    x1 = rs.randn(2, 1, cfg.d_model).astype(np.float32)
    c0 = rs.randn(*conv.shape).astype(np.float32)
    s0 = rs.randn(*ssm.shape).astype(np.float32)
    got = tmb.mamba2_decode_step(tblk, cfg, _t(x1), _t(c0), _t(s0))
    want = jmb.mamba2_decode_step(jblk, jm.cfg, jnp.asarray(x1),
                                  jnp.asarray(c0), jnp.asarray(s0))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_n(a), np.asarray(b), **BLOCK_TOL)
    # each perturbed leaf moves the block's output
    for name in ("dt_bias", "conv_b", "D", "norm_w", "A_log"):
        moved = dict(tblk, **{name: tblk[name] + 0.5})
        alt, _ = tmb.mamba2_apply_full(moved, cfg, _t(x))
        assert (alt - out).abs().max() > 1e-3, name


def test_batched_gqa_decode_step_matches_jax_per_slot(pair):
    """Three rows at distinct positions (one of them past the stripe, as a
    dead slot is) against the JAX step with a scalar index per row."""
    jm, jp, tm, tp = pair
    cfg = tm.cfg
    rs = np.random.RandomState(4)
    S = 24
    index = np.asarray([0, 13, 30], np.int32)
    hd = cfg.resolved_head_dim
    x = rs.randn(3, 1, cfg.d_model).astype(np.float32)
    kc = rs.randn(3, S, cfg.num_kv_heads, hd).astype(np.float32)
    vc = rs.randn(3, S, cfg.num_kv_heads, hd).astype(np.float32)
    out, k2, v2 = tattn.gqa_decode_step(tp["shared_attn"]["attn"], cfg,
                                        _t(x), _t(kc), _t(vc), _t(index))
    for b in range(3):
        jout, jk, jv = jattn.gqa_decode_step(
            jp["shared_attn"]["attn"], jm.cfg, jnp.asarray(x[b:b + 1]),
            jnp.asarray(kc[b:b + 1]), jnp.asarray(vc[b:b + 1]),
            jnp.int32(index[b]))
        np.testing.assert_allclose(_n(out[b]), np.asarray(jout[0]),
                                   **BLOCK_TOL)
        np.testing.assert_allclose(_n(k2[b]), np.asarray(jk[0]), **BLOCK_TOL)
        np.testing.assert_allclose(_n(v2[b]), np.asarray(jv[0]), **BLOCK_TOL)


# ---------------------------------------------------------------------------
# Prefill, decode step, engine
# ---------------------------------------------------------------------------
LEAVES = {"conv", "ssm", "attn_k", "attn_v", "index"}


def _check_cache(cache, jcache, tol=TOL):
    assert set(cache) == set(jcache) == LEAVES
    for name in sorted(LEAVES):
        np.testing.assert_allclose(_n(cache[name]), np.asarray(jcache[name]),
                                   **tol, err_msg=name)


def test_prefill_matches_jax(pair):
    jm, jp, tm, tp = pair
    tokens = np.random.RandomState(5).randint(0, VOCAB, (2, 70)).astype(
        np.int32)
    cache = tm.init_cache(2, MAX_LEN, device="cpu")
    assert cache["attn_k"].shape == (2, 2, MAX_LEN, 4, 64)
    assert cache["conv"].shape == (LAYERS, 2, 3, 544)
    assert cache["ssm"].shape == (LAYERS, 2, 16, 16, 32)
    logits, cache = tm.prefill(tp, _t(tokens), cache)
    jlogits, jcache = jm.prefill(jp, jnp.asarray(tokens),
                                 jm.init_cache(2, MAX_LEN))
    np.testing.assert_allclose(_n(logits), np.asarray(jlogits), **TOL)
    _check_cache(cache, jcache)
    assert int(cache["index"]) == 70
    assert cache["attn_k"][:, :, :70].abs().amin(dim=(2, 3, 4)).gt(0).any()


def test_batched_decode_step_matches_jax_per_slot(pair):
    """Three slots at different positions (one prompt shorter than the conv
    width), two decode steps of the whole pool against the JAX model's
    batch-1 decode step per slot (what the JAX engine vmaps)."""
    jm, jp, tm, tp = pair
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, VOCAB, n).astype(np.int32) for n in (2, 70, 33)]
    pool = tm.init_cache(3, MAX_LEN, device="cpu")
    pool["index"] = torch.zeros((3,), dtype=torch.int32)
    jcaches = []
    for slot, pr in enumerate(prompts):
        _, one = tm.prefill(tp, _t(pr[None]),
                            tm.init_cache(1, MAX_LEN, device="cpu"))
        insert_cache(pool, one, slot)
        _, jone = jm.prefill(jp, jnp.asarray(pr[None]),
                             jm.init_cache(1, MAX_LEN))
        jcaches.append(jone)
    for step in range(2):
        token = rs.randint(0, VOCAB, (3, 1)).astype(np.int32)
        logits, pool = tm.decode_step(tp, _t(token), pool)
        for slot in range(3):
            jlogits, jcaches[slot] = jm.decode_step(
                jp, jnp.asarray(token[slot:slot + 1]), jcaches[slot])
            np.testing.assert_allclose(_n(logits[slot]),
                                       np.asarray(jlogits[0]), **TOL)
            one = {n: (t[slot] if n == "index" else t[:, slot:slot + 1])
                   for n, t in pool.items()}
            _check_cache(one, jcaches[slot])
    assert pool["index"].tolist() == [4, 72, 35]
    assert not tm.kernel_supported()


def test_engine_matches_jax_engine(pair):
    """Seven ragged requests (three shorter than the conv width) through
    three slots (slots are reused), greedy, eight new tokens: tokens
    identical to the JAX engine's, logprobs within 1e-4."""
    jm, jp, tm, tp = pair
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, VOCAB, n).astype(np.int32)
               for n in (5, 1, 17, 2, 70, 3, 33)]
    T = 8

    def run(engine, request_cls):
        for i, pr in enumerate(prompts):
            assert engine.submit(request_cls(rid=i, prompt=pr,
                                             max_new_tokens=T))
        return engine.run()

    outs = run(Engine(tm, tp, EngineConfig(num_slots=3, max_seq_len=MAX_LEN),
                      device="cpu"), Request)
    jouts = run(JaxEngine(jm, jp, JaxEngineConfig(
        num_slots=3, max_seq_len=MAX_LEN, kernel_backend="jnp")), JaxRequest)
    assert [o.rid for o in outs] == [o.rid for o in jouts] == list(range(7))
    for o, jo in zip(outs, jouts):
        assert o.tokens == jo.tokens, o.rid
        assert o.finish_reason == jo.finish_reason
        np.testing.assert_allclose(o.logprobs, jo.logprobs, atol=1e-4,
                                   rtol=0)
    assert sum(o.num_tokens for o in outs) > 7


# ---------------------------------------------------------------------------
# Refusals and the CLI
# ---------------------------------------------------------------------------
def test_hybrid_refusals(pair):
    jm, jp, tm, tp = pair
    # the training forward runs the family (through Mamba2ScanFn and the
    # shared block): its last position's logits are the prefill's
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    logits, aux = stack_forward(tp, tm.cfg, tokens)
    last, _ = tm.prefill(tp, tokens, tm.init_cache(1, 8, device="cpu"))
    assert logits.shape == (1, 4, tm.cfg.vocab_size) and float(aux) == 0
    assert torch.isfinite(logits).all()
    np.testing.assert_allclose(logits[:, -1].numpy(), last.numpy(),
                               atol=1e-5, rtol=0)
    eng = Engine(tm, tp, EngineConfig(num_slots=2, max_seq_len=32,
                                      kv_layout="paged", kv_dtype="int8",
                                      prefix_share=True), device="cpu")
    assert eng.slots.paged_names == ("attn_k", "attn_v")
    assert sorted(eng.slots.slot_rows(0)) == ["conv", "ssm"]
    pool = tm.init_cache(2, 8, device="cpu")
    pool["index"] = torch.zeros((2,), dtype=torch.int32)
    # ring decode runs since the gemma3 slice (test_torch_gemma3.py holds
    # it to the JAX ring decode); the kernel step still refuses it here
    with pytest.raises(ValueError, match="stack_decode_step"):
        stack_kernel_decode_step(tp, tm.cfg,
                                 torch.zeros((2, 1), dtype=torch.int32),
                                 pool, ring=True)
    with pytest.raises(ValueError, match="stack_decode_step"):
        tm.kernel_decode_step(tp, torch.zeros((2, 1), dtype=torch.int32),
                              pool)


@pytest.mark.parametrize("case", ["log_w_bf16", "mixed_rk", "dim",
                                  "log_w_shape", "v_heads", "v_strides"])
def test_scan_wrapper_refuses_what_the_kernel_does_not_take(case):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        N = 160 if case == "dim" else 16
        r = torch.zeros(1, 8, 2, N, device="cuda")
        k = r.to(torch.bfloat16) if case == "mixed_rk" else r
        v = torch.zeros(1, 8, 3 if case == "v_heads" else 2, 16,
                        device="cuda")
        if case == "v_strides":
            v = torch.empty_strided((1, 8, 2, 16), (512, 64, 32, 2),
                                    device="cuda")
        lw = torch.zeros(1, 8, 2, N if case == "log_w_shape" else 1,
                         device="cuda")
        if case == "log_w_bf16":
            lw = lw.to(torch.bfloat16)
        err = TypeError if case in ("log_w_bf16", "mixed_rk") \
            else ValueError
        with pytest.raises(err):
            mamba2_scan(r, k, v, lw)


def test_serve_cli_reduced_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--reduced", "--device", "cpu", "--batch", "3", "--slots", "2",
         "--max-new", "6"], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                       "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "[continuous] served 3 requests on cpu, 18 tokens" in out.stdout
