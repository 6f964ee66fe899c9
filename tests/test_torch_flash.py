"""The port's flash attention and attention paths against the JAX package.

On the CPU the port's ``flash_attention`` runs its plain version and
``FlashAttentionFn`` its plain chunked backward; the JAX side runs its
Pallas kernel in interpret mode, its oracle ``flash_attention_ref``, and
``jax.grad`` of the oracle.  Inputs are made with numpy from a seed and
fed to both.  float32 compares at 1e-5 (the two sides sum in different
orders); bfloat16 at 2e-2 (the Pallas kernel and the port round the same
float32 results to bfloat16, one ulp apart at most, and bf16's ulp at
magnitudes up to 4 is 2**-6).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.ref import flash_attention_ref  # noqa: E402
from repro.models.attention import multi_head_attention as jax_mha  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttentionFn, flash_attention, flash_attention_backward_plain,
    flash_attention_plain)
from repro_torch.models.attention import multi_head_attention  # noqa: E402

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# (B, S, H, Hkv, D): G = 1 and G = 2, S not a multiple of 64
SHAPES = [(2, 70, 2, 2, 16), (2, 70, 4, 2, 16), (1, 130, 4, 2, 32)]


def _qkv(shape, seed=0):
    B, S, H, Hkv, D = shape
    rs = np.random.RandomState(seed)
    return (rs.randn(B, S, H, D).astype(np.float32),
            rs.randn(B, S, Hkv, D).astype(np.float32),
            rs.randn(B, S, Hkv, D).astype(np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("shape", SHAPES, ids=["G1", "G2", "G2-S130"])
def test_plain_flash_matches_jax_kernel_and_oracle(shape, window, dtype):
    q, k, v = _qkv(shape)
    jdt = jnp.dtype(dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    tdt = getattr(torch, dtype)
    got = flash_attention(*(_t(x, tdt) for x in (q, k, v)), window=window)
    assert got.dtype == tdt and got.shape == q.shape
    for ref in (jax_flash(jq, jk, jv, window=window, interpret=True),
                flash_attention_ref(jq, jk, jv, window=window)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), **TOL[dtype])


def test_plain_flash_log_sum_exp():
    q, k, v = _qkv(SHAPES[1])
    out, lse = flash_attention(*(_t(x) for x in (q, k, v)), window=7,
                               return_lse=True)
    B, S, H, D = q.shape
    G = H // k.shape[2]
    s = np.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, S, -1, G, D), k) \
        * D ** -0.5
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    s = np.where((j <= i) & (i - j < 7), s, -1e30)
    ref = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    assert lse.shape == (B, H, S)
    np.testing.assert_allclose(lse.numpy(), ref.reshape(B, H, S),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(out.numpy(), flash_attention_plain(
        *(_t(x) for x in (q, k, v)), window=7).numpy())


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("shape", SHAPES[1:], ids=["G2", "G2-S130"])
def test_flash_backward_matches_jax_grad(shape, window):
    """FlashAttentionFn's backward on CPU tensors against ``jax.grad`` of
    the oracle, with dk and dv summed over each KV head's query heads."""
    q, k, v = _qkv(shape, seed=1)
    do = np.random.RandomState(2).randn(*q.shape).astype(np.float32)

    def f(q_, k_, v_):
        return jnp.sum(flash_attention_ref(q_, k_, v_, window=window) * do)
    ref = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = FlashAttentionFn.apply(tq, tk, tv, True, window)
    out.backward(_t(do))
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_backward_chunks_agree():
    """The 1024-row chunking is a memory bound, not a change of result:
    chunks of 16 rows give the same gradients."""
    q, k, v = (_t(x) for x in _qkv(SHAPES[2], seed=3))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(4))
    out, lse = flash_attention_plain(q, k, v, window=9, return_lse=True)
    whole = flash_attention_backward_plain(q, k, v, out, lse, do, window=9)
    parts = flash_attention_backward_plain(q, k, v, out, lse, do, window=9,
                                           block_q=16)
    for a, b in zip(whole, parts):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("force", [False, True],
                         ids=["direct", "blockwise"])
@pytest.mark.parametrize("window", [None, 300])
def test_attention_paths_match_jax(force, window):
    """The port's plain attention paths against JAX's, across 1024-wide
    blocks (S = 1100)."""
    B, S, H, Hkv, D = 1, 1100, 2, 1, 8
    q, k, v = _qkv((B, S, H, Hkv, D), seed=5)
    pos = np.arange(S, dtype=np.int32)
    ref = jax_mha(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(pos),
                  jnp.asarray(pos), window=window, force_blockwise=force)
    got = multi_head_attention(*(_t(x) for x in (q, k, v)),
                               torch.from_numpy(pos), torch.from_numpy(pos),
                               window=window, force_blockwise=force)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_long_keys_take_the_blockwise_path():
    """Above 4096 keys the CPU takes the blockwise path, as JAX does,
    instead of raising."""
    B, S, H, Hkv, D = 1, 4100, 1, 1, 4
    q, k, v = _qkv((B, S, H, Hkv, D), seed=6)
    pos = np.arange(S, dtype=np.int32)
    ref = jax_mha(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(pos),
                  jnp.asarray(pos))
    got = multi_head_attention(*(_t(x) for x in (q, k, v)),
                               torch.from_numpy(pos), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_direct_path_casts_weights_like_jax(dtype):
    """The direct path casts the softmax weights to v's dtype before the
    value product, as JAX's does; the blockwise path sums in float32."""
    q, k, v = _qkv(SHAPES[1], seed=7)
    S = q.shape[1]
    pos = np.arange(S, dtype=np.int32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jax_mha(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                  jnp.asarray(pos), jnp.asarray(pos), window=4)
    got = multi_head_attention(*(_t(x, tdt) for x in (q, k, v)),
                               torch.from_numpy(pos), torch.from_numpy(pos),
                               window=4)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])
