"""Port model pieces against the JAX package on converted parameters.

Reduced internlm2 in float32 on the CPU.  Parameters come from the JAX
init and go through ``repro_torch.convert``; token and activation inputs
are made with numpy from a seed and fed to both sides.  Whole-model
tolerances are ``atol=rtol=1e-4``: XLA and PyTorch sum the same products
in different orders.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import build_model as jax_build  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models.attention import gqa_project_qkv as jax_qkv  # noqa: E402
from repro.models.common import apply_rope as jax_rope  # noqa: E402
from repro.models.common import rms_norm as jax_rms  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import gqa_project_qkv  # noqa: E402
from repro_torch.models.common import apply_rope, rms_norm  # noqa: E402

ARCH = "internlm2-1.8b"
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(ARCH, reduced=True)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(ARCH, reduced=True)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix=""):
    """{path: array-like} with JAX-stacked layers split as layers/<i>/..."""
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


def _jax_leaves_unstacked(jp):
    out = {}
    for path, a in _leaves(jax.tree.map(np.asarray, jp)).items():
        if path.startswith("layers/"):
            for i in range(a.shape[0]):
                out[f"layers/{i}/{path[len('layers/'):]}"] = a[i]
        else:
            out[path] = a
    return out


def test_convert_shapes_both_ways_and_fp32_exact(pair):
    jm, jp, tm, tp = pair
    jl = _jax_leaves_unstacked(jp)
    conv = _leaves(tp)
    own = _leaves(tm.init(torch.Generator().manual_seed(0)))
    # JAX -> port: every converted leaf is where the port's own init puts
    # it, with its shape and dtype; port -> JAX: and nothing is missing
    assert set(conv) == set(jl) == set(own)
    for path, a in jl.items():
        assert tuple(conv[path].shape) == a.shape == tuple(own[path].shape)
        assert conv[path].dtype == own[path].dtype == torch.float32
        np.testing.assert_array_equal(conv[path].numpy(), a)


def test_convert_bf16_bit_exact():
    from repro.configs.base import get_config
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="bfloat16")
    jp = JaxModel(cfg).init(jax.random.PRNGKey(2))
    jl = _jax_leaves_unstacked(jp)
    conv = _leaves(from_jax_params(jax.tree.map(np.asarray, jp)))
    for path, a in jl.items():
        assert conv[path].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            conv[path].view(torch.int16).numpy().view(np.uint16),
            a.view(np.uint16))


def test_rms_norm_and_rope_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 256).astype(np.float32)
    w = (rs.randn(256) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(_t(x), _t(w), 1e-5).numpy(),
        np.asarray(jax_rms(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=1e-6, rtol=1e-6)
    xh = rs.randn(2, 5, 4, 64).astype(np.float32)
    pos = rs.randint(0, 1000, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        apply_rope(_t(xh), _t(pos), 1.0e6).numpy(),
        np.asarray(jax_rope(jnp.asarray(xh), jnp.asarray(pos), 1.0e6)),
        atol=1e-5, rtol=1e-5)


def test_gqa_project_qkv_matches_jax(pair):
    jm, jp, tm, tp = pair
    rs = np.random.RandomState(1)
    x = rs.randn(2, 6, jm.cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    got = gqa_project_qkv(tp["layers"][0]["attn"], tm.cfg, _t(x), _t(pos))
    lp = jax.tree.map(lambda a: a[0], jp["layers"])
    ref = jax_qkv(lp["attn"], jm.cfg, jnp.asarray(x), jnp.asarray(pos))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=1e-5)


def _prefill_both(pair, tokens, max_len):
    jm, jp, tm, tp = pair
    lj, cj = jm.prefill(jp, jnp.asarray(tokens),
                        jm.init_cache(tokens.shape[0], max_len))
    lt, ct = tm.prefill(tp, _t(tokens),
                        tm.init_cache(tokens.shape[0], max_len, device="cpu"))
    return lj, cj, lt, ct


def test_prefill_matches_jax(pair):
    rs = np.random.RandomState(2)
    tokens = rs.randint(0, 512, size=(2, 12)).astype(np.int32)
    lj, cj, lt, ct = _prefill_both(pair, tokens, 24)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                   **TOL)
    assert int(ct["index"]) == 12


@pytest.mark.parametrize("layout", ["contiguous", "paged", "paged-int8"])
def test_kernel_decode_step_teacher_forced_matches_jax(pair, layout):
    """Three teacher-forced batched decode steps over ragged slots, from
    identical caches: logits and every written cache entry agree."""
    jm, jp, tm, tp = pair
    rs = np.random.RandomState(3)
    N, S, bs = 3, 24, 8
    tokens = rs.randint(0, 512, size=(N, 10)).astype(np.int32)
    _, cj, _, _ = _prefill_both(pair, tokens, S)
    index = np.asarray([10, 7, 4], np.int32)        # ragged live prefixes
    k, v = np.asarray(cj["k"]), np.asarray(cj["v"])  # (L, N, S, Hkv, hd)
    tables = None
    if layout == "contiguous":
        cache = {"k": k, "v": v, "index": index}
    else:
        MB = S // bs
        ids = rs.permutation(np.arange(1, N * MB + 1))
        tables = np.zeros((N, MB), np.int32)
        pool_k = np.zeros((k.shape[0], N * MB + 1, bs) + k.shape[3:],
                          np.float32)
        pool_v = np.zeros_like(pool_k)
        for b in range(N):
            tables[b] = ids[b * MB:(b + 1) * MB]
            if b == 2:
                tables[b, 1:] = 0       # null-block tail past its 7 tokens
            for j in range(MB):
                if tables[b, j]:
                    pool_k[:, tables[b, j]] = k[:, b, j * bs:(j + 1) * bs]
                    pool_v[:, tables[b, j]] = v[:, b, j * bs:(j + 1) * bs]
        cache = {"k": pool_k, "v": pool_v, "index": index}
        if layout == "paged-int8":
            for name in ("k", "v"):
                q, s = jkv.quantize_kv(jnp.asarray(cache[name]), 3)
                cache[name] = np.asarray(q)
                cache[name + jkv.SCALE_SUFFIX] = np.asarray(s)
    cj = {n: jnp.asarray(a) for n, a in cache.items()}
    ct = {n: _t(a) for n, a in cache.items()}
    tj = None if tables is None else jnp.asarray(tables)
    tt = None if tables is None else _t(tables)
    for step in range(3):
        tok = rs.randint(0, 512, size=(N, 1)).astype(np.int32)
        lj, cj = jm.kernel_decode_step(jp, jnp.asarray(tok), cj, tables=tj,
                                       interpret=True)
        lt, ct = tm.kernel_decode_step(tp, _t(tok), ct, tables=tt)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL,
                                   err_msg=f"{layout} step {step}")
    np.testing.assert_array_equal(ct["index"].numpy(), index + 3)
    for name in cache:
        if name == "index":
            continue
        got, ref = ct[name].numpy(), np.asarray(cj[name])
        if got.dtype == np.int8:        # division order: rare ±1
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, ref, **TOL)
