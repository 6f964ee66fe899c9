"""Port kernels' plain versions against the JAX package's Pallas kernels.

On the CPU every port wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernels in interpret mode, as ``test_kernel_backend.py``
does.  Inputs are made with numpy from a seed and fed to both.  Tolerances
are float32 summation-order tolerances: the two sides reduce in different
orders.
"""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

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


# ---------------------------------------------------------------------------
# Split-K arithmetic around the decode kernels: the plan, the plain split
# and merge passes, and the wrappers' launch arguments.
# ---------------------------------------------------------------------------
from repro_torch.kernels import decode_attention as tda  # noqa: E402

SPLIT_LENGTHS = np.asarray([0, 1, 127, 128, 129, 256, 384], np.int32)


@pytest.mark.parametrize("seq_len", [1, 127, 128, 129, 1024, 4096, 8192,
                                     8193, 20000])
def test_split_plan_covers_the_row_with_no_split_past_it(seq_len):
    chunk, n_split = tda.split_plan(seq_len)
    assert chunk % tda.SPLIT_CHUNK == 0
    assert 1 <= n_split <= tda.MAX_SPLITS
    assert chunk * n_split >= seq_len > (n_split - 1) * chunk
    if seq_len <= tda.SPLIT_CHUNK * tda.MAX_SPLITS:
        assert chunk == tda.SPLIT_CHUNK
    assert tda.split_plan(1024) == (128, 8)    # internlm2's serving stripe


@pytest.mark.parametrize("window", [None, 100, 200])
def test_split_merge_matches_plain_and_jax(window):
    """Partials at the plan's boundaries (lengths on chunk edges, empty
    splits, a window that empties leading splits, a zero-length row),
    merged, equal the unsplit plain version and the JAX kernel."""
    rs = np.random.RandomState(11)
    B, S, H, Hkv, D = len(SPLIT_LENGTHS), 384, 4, 2, 16
    q = rs.randn(B, H, D).astype(np.float32)
    k = rs.randn(B, S, Hkv, D).astype(np.float32)
    v = rs.randn(B, S, Hkv, D).astype(np.float32)
    chunk, n_split = tda.split_plan(S)
    assert (chunk, n_split) == (128, 3)
    m, l, acc = tda.decode_attention_partials_plain(
        _t(q), _t(k), _t(v), _t(SPLIT_LENGTHS), chunk, n_split,
        window=window)
    assert bool((l[1, :, 1:] == 0).all())          # length 1: two empty
    if window == 100:          # length 384 sees 284-383: split 2 alone
        assert bool((l[-1, :, :2] == 0).all()) and bool((l[-1, :, 2] > 0)
                                                        .all())
    got = tda.merge_partials_plain(m, l, acc)
    assert bool(torch.isfinite(got).all()) and bool((got[0] == 0).all())
    ref = tda.decode_attention_plain(_t(q), _t(k), _t(v),
                                     _t(SPLIT_LENGTHS), window=window)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    jref = jax_dec(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(SPLIT_LENGTHS), window=window, block_k=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("bs", [1, 16])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_split_merge_matches_plain_and_jax(bs, int8):
    """The paged view split at the plan of ``MB * bs`` and merged equals
    the unsplit paged plain version and the JAX kernel, float and int8."""
    rs = np.random.RandomState(12 + bs + int8)
    k_pool, v_pool, tables = _paged_case(rs, SPLIT_LENGTHS, bs)
    q = rs.randn(len(SPLIT_LENGTHS), 4, 16).astype(np.float32)
    kw_j, kw_t = {}, {}
    if int8:
        kq, ks = (np.asarray(a) for a in jkv.quantize_kv(k_pool, 2))
        vq, vs = (np.asarray(a) for a in jkv.quantize_kv(v_pool, 2))
        k_pool, v_pool = kq, vq
        kw_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        kw_t = dict(k_scale=_t(ks), v_scale=_t(vs))
    chunk, n_split = tda.split_plan(tables.shape[1] * bs)
    kg = tda.gather_view(_t(k_pool), _t(tables), kw_t.get("k_scale"))
    vg = tda.gather_view(_t(v_pool), _t(tables), kw_t.get("v_scale"))
    got = tda.merge_partials_plain(*tda.decode_attention_partials_plain(
        _t(q), kg, vg, _t(SPLIT_LENGTHS), chunk, n_split))
    assert bool(torch.isfinite(got).all()) and bool((got[0] == 0).all())
    ref = tda.paged_decode_attention_plain(
        _t(q), _t(k_pool), _t(v_pool), _t(tables), _t(SPLIT_LENGTHS), **kw_t)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=0)
    jref = jax_paged(jnp.asarray(q), jnp.asarray(k_pool),
                     jnp.asarray(v_pool), jnp.asarray(tables),
                     jnp.asarray(SPLIT_LENGTHS), **kw_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), atol=ATOL,
                               rtol=0)


def test_merge_partials_plain_skips_empty_splits():
    """Empty splits (l = 0) are never weighed, whatever their m and acc
    hold; a head with no live split gives zeros."""
    rs = np.random.RandomState(13)
    m = _t(rs.randn(2, 3, 4).astype(np.float32))
    l_ = _t(rs.rand(2, 3, 4).astype(np.float32) + 0.5)
    acc = _t(rs.randn(2, 3, 4, 8).astype(np.float32))
    want = tda.merge_partials_plain(m[..., :2], l_[..., :2], acc[..., :2, :])
    l_[..., 2:] = 0.0
    m[..., 2] = float("inf")
    acc[..., 2:, :] = float("nan")
    got = tda.merge_partials_plain(m, l_, acc)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=0)
    l_[1] = 0.0
    got = tda.merge_partials_plain(m, l_, acc)
    assert bool((got[1] == 0).all()) and bool(torch.isfinite(got).all())


def test_lengths_passes_the_engines_tensor_through():
    """The engine's contiguous (B,) int32 lengths reach the kernel as they
    are: no copy, no launch; other forms are converted."""
    t = torch.arange(1, 5, dtype=torch.int32)
    assert tda._lengths(t, 4, t.device) is t
    assert tda._lengths(7, 4, t.device).tolist() == [7] * 4
    c = tda._lengths(t.long(), 4, t.device)
    assert c.dtype == torch.int32 and torch.equal(c, t)


class _StubLib:
    """Records the launch arguments in place of the built library."""

    def __init__(self):
        self.calls = []

    def decode_attention_contiguous(self, *args):
        self.calls.append(args)
        return 0

    decode_attention_paged = decode_attention_contiguous


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("mode", ["contiguous", "paged", "paged-int8"])
@pytest.mark.parametrize("seq_len", [128, 1024, 4096])
def test_wrapper_plan_depends_only_on_shapes(mode, seq_len, monkeypatch):
    """With storage-less CUDA tensors (any read of the lengths on the host
    would raise), each wrapper launches once with the plan of its shapes
    and a workspace for the partials, one split or many."""
    from types import SimpleNamespace

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import _build
    stub = _StubLib()
    monkeypatch.setattr(_build, "load", lambda name: stub)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    B, H, Hkv, D, bs = 8, 16, 8, 128, 16
    with FakeTensorMode():
        bf = dict(dtype=torch.bfloat16, device="cuda")
        q = torch.zeros(B, H, D, **bf)
        lengths = torch.zeros(B, dtype=torch.int32, device="cuda")
        if mode == "contiguous":
            kv = torch.zeros(B, seq_len, Hkv, D, **bf)
            before = tda.decode_attention.launches
            tda.decode_attention(q, kv, kv, lengths)
            assert tda.decode_attention.launches == before + 1
            chunk, n_split = stub.calls[0][12:14]
            work = stub.calls[0][5]
        else:
            MB = seq_len // bs
            tables = torch.zeros(B, MB, dtype=torch.int32, device="cuda")
            kw = {}
            pool = torch.zeros(B * MB + 1, bs, Hkv, D, **bf)
            if mode == "paged-int8":
                pool = pool.to(torch.int8)
                scale = torch.ones(B * MB + 1, bs, dtype=torch.float32,
                                   device="cuda")
                kw = dict(k_scale=scale, v_scale=scale)
            before = tda.paged_decode_attention.launches
            tda.paged_decode_attention(q, pool, pool, tables, lengths, **kw)
            assert tda.paged_decode_attention.launches == before + 1
            chunk, n_split = stub.calls[0][16:18]
            work = stub.calls[0][8]
    assert len(stub.calls) == 1
    assert (chunk, n_split) == tda.split_plan(seq_len)
    assert work is not None


def test_wrappers_read_no_device_data_on_the_host():
    """No ``.item()``, ``.cpu()``, ``.tolist()`` or ``.numpy()`` in the
    kernel wrappers or the helpers they call."""
    import inspect
    for fn in (tda.decode_attention, tda.paged_decode_attention,
               tda._lengths, tda.split_plan, tda._workspace, tda._check_cuda):
        src = inspect.getsource(fn)
        for bad in (".item(", ".cpu(", ".tolist(", ".numpy("):
            assert bad not in src, f"{fn.__name__} calls {bad}"
