"""The algorithms of the SSD-scan and top-k CUDA kernels, mirrored in plain
code on the CPU, against the JAX package.

The kernels themselves (``csrc/mamba2_scan.cu``, ``csrc/topk.cu``) run only
on the card.  These tests hold the decompositions they implement:

* the SSD scan in three passes: each chunk's own state dS and decay, the
  state passed from chunk to chunk, and the output (G o L) V + exp(cl) (R
  S_in).  Optionally every product is taken as the kernel's tensor cores
  take it: each operand split into bf16 parts (hi + mid + lo, which hold a
  float32 exactly; a bf16 operand is its hi part), the part products with
  i + j <= 2 kept, each 16-term block of the contraction summed from zero
  and the blocks added in float32 (the CPU rounds where the tensor cores
  truncate).  Held to the JAX Pallas kernel (interpret mode) and the
  oracle ``ref.mamba2_scan_ref`` at ``tests/test_torch_zamba2.py``'s
  tolerance, and to the port's plain version at the chip's (1e-3), where
  a split into two parts (hi + lo, 16 bits) is shown to miss it;
* top-k as a cluster of slices: the radix select over the summed byte
  histograms of the slices, each slice's values above the k-th key
  gathered in slice order and placed by rank, the rest filled with the
  k-th value.  Held bit for bit (a zero's sign aside) to the JAX
  ``topk_values``/``topk_mask`` with ties across slice edges.

Inputs are numpy arrays from a seed.
"""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba2_scan import mamba2_scan as jax_mamba2_scan  # noqa: E402
from repro.kernels.sampling import topk_mask as jax_topk_mask  # noqa: E402
from repro.kernels.sampling import topk_values as jax_topk_values  # noqa: E402
from repro_torch.kernels.mamba2_scan import mamba2_scan_plain  # noqa: E402
from repro_torch.kernels.sampling import (NEG_INF, TOPK_CLUSTER,  # noqa: E402
                                          topk_slice)

ORACLE_TOL = dict(atol=5e-4, rtol=2e-3)       # tests/test_torch_zamba2.py
CHIP_TOL = dict(atol=1e-3, rtol=1e-3)         # chip_smoke.py, float32 y


# ---------------------------------------------------------------------------
# The SSD scan in three passes
# ---------------------------------------------------------------------------
def _parts(x, n):
    """x's first ``n`` bf16 parts, as float32: hi, mid, lo of x exact."""
    parts, rest = [], x
    for _ in range(n):
        parts.append(rest.to(torch.bfloat16).float())
        rest = rest - parts[-1]
    return parts


def _product(eq, a, b, parts):
    """einsum of two operands over one index; with ``parts`` as the
    kernel's tensor cores take it: both split into that many bf16 parts,
    the part products i + j < parts kept, each 16-term block of the
    contracted index summed from zero, the blocks added in turn."""
    a, b = a.float(), b.float()
    if not parts:
        return torch.einsum(eq, a, b)
    ins, out = eq.split("->")
    ea, eb = ins.split(",")
    (c,) = (set(ea) & set(eb)) - set(out)

    def blocks(x, e):                   # index c -> (block Z, c within it)
        i = e.index(c)
        x = torch.nn.functional.pad(
            x, [0, 0] * (x.dim() - 1 - i) + [0, -x.shape[i] % 16])
        return x.unflatten(i, (-1, 16)), e.replace(c, "Z" + c)
    (a, ea), (b, eb) = blocks(a, ea), blocks(b, eb)
    pa, pb = _parts(a, parts), _parts(b, parts)
    per_block = sum(torch.einsum(f"{ea},{eb}->Z{out}", pa[i], pb[j])
                    for i in range(parts) for j in range(parts)
                    if i + j < parts)
    acc = torch.zeros_like(per_block[0])
    for block in per_block:
        acc = acc + block
    return acc


def ssd_three_pass(r, k, v, log_w, chunk=64, parts=0):
    """y (B,S,H,hd) and the final state (B,H,N,hd), float32, by the
    kernel's decomposition; ``parts`` 3 takes the products as the kernel
    does (0: plain float32 products)."""
    B, S, H, N = r.shape
    hd = v.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S

    def chunks(x):                                  # (B, nc, C, H, .)
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(B, nc, chunk, H, x.shape[-1])
    rc, kc, vc, wc = map(chunks, (r, k, v, log_w))
    cl = torch.cumsum(wc, dim=2)                    # inclusive, (B,nc,C,H,1)
    last = cl[:, :, -1:]                            # (B, nc, 1, H, 1)
    # 1. each chunk's own state and decay
    dk = torch.exp(last - cl)                       # <= 0 exponentiated
    ds = _product("bcshn,bcshj->bchnj", kc, dk * vc, parts)
    decay = torch.exp(last[:, :, 0, :, 0])          # (B, nc, H)
    # 2. the state entering each chunk
    s = torch.zeros(B, H, N, hd)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = decay[:, c, :, None, None] * s + ds[:, c]
    s_in = torch.stack(s_in, dim=1)                 # (B, nc, H, N, hd)
    # 3. the output
    g = _product("bcthn,bcshn->bchts", rc, kc, parts)
    clh = cl[..., 0].permute(0, 1, 3, 2)            # (B, nc, H, C)
    diff = clh[..., :, None] - clh[..., None, :]    # cl_t - cl_s
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    lmat = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)),
                       0.0)
    y = torch.exp(cl) * _product("bcthn,bchnj->bcthj", rc, s_in, parts)
    y = y + _product("bchts,bcshj->bcthj", g * lmat, vc, parts)
    return y.reshape(B, nc * chunk, H, hd)[:, :S], s


def _scan_inputs(B, S, H, N, hd, decay, seed=0):
    rs = np.random.RandomState(seed)
    r = rs.randn(B, S, H, N).astype(np.float32)
    k = rs.randn(B, S, H, N).astype(np.float32)
    v = rs.randn(B, S, H, hd).astype(np.float32)
    if decay == "normal":                   # the JAX kernel test's decays
        lw = -np.exp(rs.randn(B, S, H, 1))
    elif decay == "weak":                   # the state carries every chunk
        lw = -np.full((B, S, H, 1), 1e-3) * np.exp(0.1 * rs.randn(B, S, H, 1))
    else:                                   # strong: cl near -700 a chunk
        lw = -rs.uniform(1.0, 21.0, (B, S, H, 1))
    return r, k, v, lw.astype(np.float32)


SCAN_CASES = [
    (2, 100, 3, 16, 32, "normal"),          # ragged, two chunks
    (1, 40, 2, 16, 16, "normal"),           # S below one chunk
    (1, 1, 2, 8, 8, "weak"),                # one position
    (2, 130, 2, 16, 8, "weak"),             # carried across three chunks
    (1, 200, 2, 8, 16, "strong"),           # cl near -700 inside a chunk
]


@pytest.mark.parametrize("parts", [0, 3])
@pytest.mark.parametrize("B,S,H,N,hd,decay", SCAN_CASES)
def test_ssd_three_pass_matches_jax_kernel_and_oracle(B, S, H, N, hd, decay,
                                                      parts):
    r, k, v, lw = _scan_inputs(B, S, H, N, hd, decay)
    ja = tuple(map(jnp.asarray, (r, k, v, lw)))
    jy, jst = jax_mamba2_scan(*ja, chunk=64, interpret=True)
    oy, ost = jref.mamba2_scan_ref(*ja)
    y, st = ssd_three_pass(*map(torch.from_numpy, (r, k, v, lw)), parts=parts)
    assert y.shape == (B, S, H, hd) and st.shape == (B, H, N, hd)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    for name, (wy, wst) in (("pallas", (jy, jst)), ("oracle", (oy, ost))):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **ORACLE_TOL,
                                   err_msg=f"{name} y")
        np.testing.assert_allclose(st.numpy(), np.asarray(wst),
                                   **ORACLE_TOL, err_msg=f"{name} state")


# the chip's tolerance also where the state carries over many chunks (the
# case two parts miss) and at the kernel's widest state, N = hd = 128
CHIP_CASES = SCAN_CASES + [(1, 512, 2, 64, 64, "weak"),
                           (1, 200, 3, 128, 128, "weak")]


def _chip_share(got, ref):
    """The largest |got - ref| / (atol + rtol |ref|) at the chip's limits."""
    return float(((got - ref).abs() / (CHIP_TOL["atol"] + CHIP_TOL["rtol"]
                                       * ref.abs())).max())


@pytest.mark.parametrize("B,S,H,N,hd,decay", CHIP_CASES)
def test_ssd_split_products_hold_the_chips_tolerance(B, S, H, N, hd, decay):
    """The exact three-part bf16 split of the tensor-core products stays
    within the 1e-3 the chip holds the kernel to, against the port's plain
    version; the mixed dtypes of the model (r/k bf16, v float32)
    included."""
    r, k, v, lw = map(torch.from_numpy, _scan_inputs(B, S, H, N, hd, decay,
                                                     seed=1))
    for rk in (torch.float32, torch.bfloat16):
        rr, kk = r.to(rk), k.to(rk)
        y, st = ssd_three_pass(rr, kk, v, lw, parts=3)
        y0, st0 = mamba2_scan_plain(rr, kk, v, lw)
        torch.testing.assert_close(y, y0, **CHIP_TOL)
        torch.testing.assert_close(st, st0, **CHIP_TOL)


@pytest.mark.parametrize("rk", [torch.float32, torch.bfloat16])
def test_ssd_two_part_split_misses_the_chips_tolerance(rk):
    """Why the kernel splits into three parts: with two (hi + lo, 16 bits)
    y, a sum of terms in the hundreds that cancels where the state carries
    over eight chunks, misses 1e-3; three parts hold it."""
    r, k, v, lw = map(torch.from_numpy, _scan_inputs(1, 512, 2, 64, 64,
                                                     "weak", seed=1))
    r, k = r.to(rk), k.to(rk)
    y0, _ = mamba2_scan_plain(r, k, v, lw)
    assert _chip_share(ssd_three_pass(r, k, v, lw, parts=2)[0], y0) > 1
    assert _chip_share(ssd_three_pass(r, k, v, lw, parts=3)[0], y0) < 1


def test_ssd_without_state_passing_fails_the_chips_tolerance():
    """The planted fault of the chip smoke: chunks that start from zero
    (pass 2 dropped) are far outside 1e-3 when the state carries."""
    r, k, v, lw = map(torch.from_numpy, _scan_inputs(1, 200, 2, 16, 16,
                                                     "weak", seed=2))
    y0, _ = mamba2_scan_plain(r, k, v, lw)
    bad = torch.cat([mamba2_scan_plain(*(t[:, c:c + 64]
                                         for t in (r, k, v, lw)))[0]
                     for c in range(0, 200, 64)], dim=1)
    assert _chip_share(bad, y0) > 10


# ---------------------------------------------------------------------------
# Top-k as a cluster of slices
# ---------------------------------------------------------------------------
def _keys(x):
    u = x.view(np.uint32).copy()
    u[u == 0x80000000] = 0
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _value_of(key):
    key = np.uint32(key)
    u = key & np.uint32(0x7fffffff) if key & np.uint32(0x80000000) else ~key
    return np.array([u], np.uint32).view(np.float32)[0]


def topk_cluster(x, k, drop_slice=None):
    """(values (B, k), mask (B, V)) by the kernel's algorithm; with
    ``drop_slice`` that slice's candidates are lost (a planted fault)."""
    B, V = x.shape
    sl = topk_slice(V)
    top = np.empty((B, k), np.float32)
    mask = np.empty_like(x)
    for b in range(B):
        row = x[b]
        keys = _keys(row)
        parts = [keys[r * sl:(r + 1) * sl] for r in range(TOPK_CLUSTER)]
        prefix, known, rem = 0, 0, k
        for shift in (24, 16, 8, 0):
            tot = np.zeros(256, np.int64)
            for p in parts:         # each slice's histogram, summed
                m = (p & np.uint32(known)) == np.uint32(prefix)
                tot += np.bincount((p[m] >> np.uint32(shift)) & 0xff,
                                   minlength=256)
            cum = 0
            for bin_ in range(255, -1, -1):
                if cum + tot[bin_] >= rem:
                    prefix |= bin_ << shift
                    rem -= cum
                    break
                cum += tot[bin_]
            known |= 0xff << shift
        thresh = _value_of(prefix)
        cand = np.concatenate([
            row[r * sl:(r + 1) * sl][parts[r] > np.uint32(prefix)]
            for r in range(TOPK_CLUSTER) if r != drop_slice])
        ck = _keys(cand)
        g = len(cand)
        for j in range(g):
            pos = int(np.sum(ck > ck[j]) + np.sum(ck[:j] == ck[j]))
            if pos < k:
                top[b, pos] = cand[j]
        top[b, g:] = thresh
        mask[b] = np.where(row >= thresh, row, np.float32(NEG_INF))
    return top, mask


def _tied_logits(V, seed=0):
    """Rows with ties across the slice edges, at the top and at the k-th
    value, a row of equal entries, and a row whose k-th value is a zero of
    either sign."""
    rs = np.random.RandomState(seed)
    x = rs.randn(4, V).astype(np.float32)
    sl = topk_slice(V)
    edges = [e for r in range(1, TOPK_CLUSTER) for e in (r * sl - 1, r * sl)
             if r * sl < V]
    x[0, edges] = 6.0                       # tied across every slice edge
    x[0, edges[:3]] = 7.0
    x[1] = 1.5                              # every entry equal
    x[2] = -np.abs(x[2]) - 1.0              # above zeros of both signs
    x[2, edges[:2]] = 3.0
    x[2, 0::7] = 0.0
    x[2, 3::7] = -0.0
    x[3, edges] = x[3].max()                # ties at the row's maximum
    return x


@pytest.mark.parametrize("V", [1000, 999])
@pytest.mark.parametrize("k", [1, 7, 64, 130])
def test_topk_cluster_is_bit_identical_to_jax(V, k):
    x = _tied_logits(V)
    jx = jnp.asarray(x)
    top, mask = topk_cluster(x, k)
    np.testing.assert_array_equal(top, np.asarray(
        jax_topk_values(jx, k, interpret=True)))   # == : a zero's sign aside
    np.testing.assert_array_equal(mask.view(np.int32), np.asarray(
        jax_topk_mask(jx, k, interpret=True)).view(np.int32))


def test_topk_slices_cover_the_row_in_multiples_of_four():
    for V in (1, 7, 999, 1000, 32000, 50001, 65536, 92544):
        sl = topk_slice(V)
        assert sl % 4 == 0 and TOPK_CLUSTER * sl >= V
        assert (TOPK_CLUSTER - 1) * sl < V + 4 * TOPK_CLUSTER


def test_topk_cluster_without_one_slice_fails_the_bit_check():
    """The planted fault of the chip smoke: one slice's candidates lost."""
    x = _tied_logits(1000, seed=1)
    want = jax_topk_values(jnp.asarray(x), 64, interpret=True)
    worst = int(np.argmax(x[3])) // topk_slice(1000)
    top, _ = topk_cluster(x, 64, drop_slice=worst)
    assert not np.array_equal(top, np.asarray(want))
