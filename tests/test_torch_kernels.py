"""Port kernels' plain versions against the JAX package's Pallas kernels.

On the CPU every port wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernels in interpret mode, as ``test_kernel_backend.py``
does.  Inputs are made with numpy from a seed and fed to both.  Tolerances
are float32 summation-order tolerances: the two sides reduce in different
orders.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import decode_attention as jax_dec  # noqa: E402
from repro.kernels.decode_attention import \
    paged_decode_attention as jax_paged  # noqa: E402
from repro.kernels.sampling import greedy_sample as jax_greedy  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models.attention import gather_blocks as jax_gather  # noqa: E402
from repro.serve.blocks import blocks_for  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, paged_decode_attention)
from repro_torch.kernels.sampling import greedy_sample  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models.attention import gather_blocks  # noqa: E402

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_jax(window):
    rs = np.random.RandomState(0)
    B, S, H, Hkv, D = 4, 40, 4, 2, 16
    q = rs.randn(B, H, D).astype(np.float32)
    k = rs.randn(B, S, Hkv, D).astype(np.float32)
    v = rs.randn(B, S, Hkv, D).astype(np.float32)
    lengths = np.asarray([1, 7, 33, 40], np.int32)     # ragged
    before = decode_attention.launches
    got = decode_attention(_t(q), _t(k), _t(v), _t(lengths), window=window)
    ref = jax_dec(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  jnp.asarray(lengths), window=window, block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    assert decode_attention.launches == before   # plain path: no count


def _paged_case(rs, lengths, bs, Hkv=2, D=16, extra_null=1):
    """Pools, shuffled block tables with null-block (0) tails."""
    B = len(lengths)
    MB = blocks_for(int(max(lengths)), bs) + extra_null
    NB = B * MB + 1
    k_pool = rs.randn(NB, bs, Hkv, D).astype(np.float32)
    v_pool = rs.randn(NB, bs, Hkv, D).astype(np.float32)
    ids = rs.permutation(np.arange(1, NB))
    tables = np.zeros((B, MB), np.int32)
    nxt = 0
    for b, n in enumerate(lengths):
        nb = blocks_for(int(n), bs)
        tables[b, :nb] = ids[nxt:nxt + nb]
        nxt += nb
    return k_pool, v_pool, tables


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_attention_matches_jax(bs, int8):
    """Block-boundary sweep ({bs-1, bs, bs+1, 2bs, 2bs+1}) over shuffled
    tables with null-block tails, float and int8 pools."""
    rs = np.random.RandomState(bs + int8)
    lengths = np.asarray([bs - 1, bs, bs + 1, 2 * bs, 2 * bs + 1], np.int32)
    k_pool, v_pool, tables = _paged_case(rs, lengths, bs)
    q = rs.randn(len(lengths), 4, 16).astype(np.float32)
    kw_j, kw_t = {}, {}
    if int8:
        kq, ks = (np.asarray(a) for a in jkv.quantize_kv(k_pool, 2))
        vq, vs = (np.asarray(a) for a in jkv.quantize_kv(v_pool, 2))
        k_pool, v_pool = kq, vq
        kw_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        kw_t = dict(k_scale=_t(ks), v_scale=_t(vs))
    before = paged_decode_attention.launches
    got = paged_decode_attention(_t(q), _t(k_pool), _t(v_pool), _t(tables),
                                 _t(lengths), **kw_t)
    ref = jax_paged(jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
                    jnp.asarray(tables), jnp.asarray(lengths), **kw_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    assert paged_decode_attention.launches == before


def test_paged_window_matches_jax():
    rs = np.random.RandomState(3)
    lengths = np.asarray([3, 20, 31], np.int32)
    k_pool, v_pool, tables = _paged_case(rs, lengths, 8)
    q = rs.randn(3, 4, 16).astype(np.float32)
    got = paged_decode_attention(_t(q), _t(k_pool), _t(v_pool), _t(tables),
                                 _t(lengths), window=9)
    ref = jax_paged(jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
                    jnp.asarray(tables), jnp.asarray(lengths), window=9)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def test_greedy_sample_matches_jax_with_cross_block_ties():
    rs = np.random.RandomState(4)
    B, V = 4, 3000                            # 3 vocab blocks of 1024
    logits = rs.randn(B, V).astype(np.float32)
    logits[0, [100, 2100]] = 50.0             # tie across blocks 0 and 2
    logits[1, [1023, 1024]] = 40.0            # tie across a block edge
    logits[2, [2999, 5]] = 30.0               # last column vs an early one
    before = greedy_sample.launches
    tok_t, lp_t = greedy_sample(_t(logits))
    tok_j, lp_j = jax_greedy(jnp.asarray(logits))
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), atol=1e-6,
                               rtol=0)
    assert tok_t.dtype == torch.int32
    assert tok_t[:3].tolist() == [100, 1023, 5]
    assert greedy_sample.launches == before


def test_quantize_kv_matches_jax_and_is_idempotent():
    rs = np.random.RandomState(5)
    x = (rs.randn(6, 32, 2, 16) * 3.0).astype(np.float32)
    x[0, 0] = 0.0                             # all-zero position: scale 1
    q_t, s_t = tkv.quantize_kv(_t(x), 2)
    q_j, s_j = (np.asarray(a) for a in jkv.quantize_kv(jnp.asarray(x), 2))
    diff = np.abs(q_t.numpy().astype(np.int32) - q_j.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=1e-6, atol=0)
    assert s_t[0, 0].item() == 1.0
    d = tkv.dequantize_kv(q_t, s_t)
    q2, s2 = tkv.quantize_kv(d, 2)
    assert torch.equal(q2, q_t)
    np.testing.assert_allclose(s2.numpy(), s_t.numpy(), rtol=1e-6)


def test_gather_blocks_matches_jax():
    rs = np.random.RandomState(6)
    pool = rs.randn(2, 7, 4, 3).astype(np.float32)   # (L, NB, bs, ...)
    table = np.asarray([3, 0, 6], np.int32)
    got = gather_blocks(_t(pool), _t(table), axis=1)
    ref = jax_gather(jnp.asarray(pool), jnp.asarray(table), axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
