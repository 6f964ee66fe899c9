"""The algorithms of the RWKV6 WKV-scan and greedy-sampling CUDA kernels,
mirrored in plain code on the CPU, against the JAX package.

The kernels themselves (``csrc/rwkv6_scan.cu``, ``csrc/greedy_sample.cu``)
run only on the card.  These tests hold the decompositions they implement:

* the WKV scan in three passes over 64-position chunks: each chunk's own
  state dS = (k exp(cl_last - cl))^T v and its decay exp(cl_last), a
  vector over the key dim; the state passed from chunk to chunk,
  S_in,c+1 = diag(exp(cl_last,c)) S_in,c + dS_c; and the output
  (r exp(e)) S_in + A v.  The intra-chunk weights A are taken in 16-row
  sub-blocks: below the diagonal one product R~ K~^T per sub-block pair,
  with r~_t = r_t exp(e_t - b) and k~_s = k_s exp(b - cl_s) around the
  reference b = cl at the last row of the key sub-block; on the diagonal
  one exponential per (t, s < t, d) term, as on the kernel's CUDA cores.
  Optionally every product is taken as the kernel's tensor cores take it,
  in 3xTF32: each operand split into two tf32 parts (hi + lo, each
  rounded to nearest to 11 significant bits; a bf16 operand is its hi
  part), the products lo hi + hi lo + hi hi of each 8-term block of the
  contraction summed from zero and the blocks added in float32.  Held to
  the JAX Pallas kernel (interpret mode) and the oracle
  ``ref.rwkv6_scan_ref`` at ``tests/test_torch_rwkv6.py``'s tolerance,
  and to the port's plain version at the chip's (1e-3); every exponent it
  forms is checked to be <= 0;
* greedy sampling over a cluster of slices: each slice reduced to (max,
  first index, sum of exp(x - max)), the slices merged in CTA order with
  the smaller index kept at equal maxima.  Held bit for bit (tokens) to
  the JAX ``greedy_sample`` with ties across the slice edges.

Inputs are numpy arrays from a seed.
"""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_rwkv6_scan  # noqa: E402
from repro.kernels.sampling import greedy_sample as jax_greedy  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain  # noqa: E402
from repro_torch.kernels.sampling import (greedy_cluster,  # noqa: E402
                                          greedy_sample_plain, greedy_slice)

ORACLE_TOL = dict(atol=5e-4, rtol=2e-3)       # tests/test_torch_rwkv6.py
CHIP_TOL = dict(atol=1e-3, rtol=1e-3)         # chip_smoke.py, float32 y
CHUNK, SUB = 64, 16


# ---------------------------------------------------------------------------
# The WKV scan in three passes
# ---------------------------------------------------------------------------
def _tf32(x):
    """x rounded to tf32 (10 stored significand bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(eq, a, b, terms):
    """einsum of two operands over one index; with ``terms`` 3 as the
    kernel's tensor cores take it (3xTF32): both split into tf32 hi + lo,
    lo hi + hi lo + hi hi summed over each 8-term block of the contracted
    index, the blocks added in turn; ``terms`` 1 keeps hi hi alone (one
    tf32 part), 0 is the plain float32 product."""
    a, b = a.float(), b.float()
    if not terms:
        return torch.einsum(eq, a, b)
    ins, out = eq.split("->")
    ea, eb = ins.split(",")
    (c,) = (set(ea) & set(eb)) - set(out)

    def blocks(x, e):                   # index c -> (block Z, c within it)
        i = e.index(c)
        x = torch.nn.functional.pad(
            x, [0, 0] * (x.dim() - 1 - i) + [0, -x.shape[i] % 8])
        return x.unflatten(i, (-1, 8)), e.replace(c, "Z" + c)
    (a, ea), (b, eb) = blocks(a, ea), blocks(b, eb)

    def mm(x, y):
        return torch.einsum(f"{ea},{eb}->Z{out}", x, y)
    a_hi, b_hi = _tf32(a), _tf32(b)
    per_block = mm(a_hi, b_hi)
    if terms == 3:
        a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
        per_block = (mm(a_lo, b_hi) + mm(a_hi, b_lo)) + per_block
    acc = torch.zeros_like(per_block[0])
    for block in per_block:
        acc = acc + block
    return acc


class Exponents:
    """Every argument of an exponential the three passes form, kept so a
    test can check that none is positive."""

    def __init__(self):
        self.largest = -float("inf")

    def __call__(self, x):
        if x.numel():
            self.largest = max(self.largest, float(x.max()))
        return torch.exp(x)


def wkv_three_pass(r, k, v, log_w, u, terms=0, pass_state=True, exp=None):
    """y (B,S,H,Dv) and the final state (B,H,Dk,Dv), float32, by the
    kernel's decomposition; ``terms`` 3 takes the products as the kernel
    does (0: plain float32 products, 1: one tf32 part); ``pass_state=False``
    starts every chunk from zero (the planted fault); ``exp`` sees every
    exponent."""
    exp = exp or torch.exp
    B, S, H, Dk = r.shape
    Dv = v.shape[-1]
    nc = -(-S // CHUNK)
    pad = nc * CHUNK - S

    def chunks(x):                                  # (B, nc, C, H, .)
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
        return x.reshape(B, nc, CHUNK, H, x.shape[-1])
    rc, kc, vc, wc = map(chunks, (r, k, v, log_w))
    # the running sum added position by position, as one kernel thread
    # does: exactly non-increasing, so cl_t <= cl_s for s <= t
    cl = torch.empty_like(wc)
    acc = torch.zeros_like(wc[:, :, 0])
    for t in range(CHUNK):
        acc = acc + wc[:, :, t]
        cl[:, :, t] = acc
    e = torch.cat([torch.zeros_like(cl[:, :, :1]), cl[:, :, :-1]], dim=2)
    last = cl[:, :, -1:]                            # (B, nc, 1, H, Dk)
    # 1. each chunk's own state and its decay (a vector over Dk)
    ds = _product("bcshd,bcshj->bchdj", kc * exp(last - cl), vc, terms)
    decay = exp(last[:, :, 0])                      # (B, nc, H, Dk)
    # 2. the state entering each chunk
    s = torch.zeros(B, H, Dk, Dv)
    s_in = []
    for c in range(nc):
        s_in.append(s if pass_state else torch.zeros_like(s))
        s = decay[:, c, :, :, None] * s + ds[:, c]
    s_in = torch.stack(s_in, dim=1)                 # (B, nc, H, Dk, Dv)
    # 3. the output: A in 16-row sub-blocks
    a = torch.zeros(B, nc, H, CHUNK, CHUNK)
    n_sub = CHUNK // SUB
    for i in range(n_sub):
        ti = slice(SUB * i, SUB * (i + 1))
        for j in range(i):                          # below the diagonal
            sj = slice(SUB * j, SUB * (j + 1))
            ref = cl[:, :, SUB * j + SUB - 1:SUB * j + SUB]
            rt = rc[:, :, ti] * exp(e[:, :, ti] - ref)
            kt = kc[:, :, sj] * exp(ref - cl[:, :, sj])
            a[:, :, :, ti, sj] = _product("bcthd,bcshd->bchts", rt, kt,
                                          terms)
        # the diagonal sub-block: one exponential per (t, s < t, d) term,
        # float32 sums (the kernel's CUDA cores), and the bonus u at s = t
        diff = e[:, :, ti, None] - cl[:, :, None, ti]   # (B,nc,t,s,H,Dk)
        below = torch.ones(SUB, SUB, dtype=torch.bool).tril(-1)
        w = torch.zeros_like(diff)
        w[:, :, below] = exp(diff[:, :, below])
        blk = torch.einsum("bcthd,bcshd,bctshd->bchts", rc[:, :, ti],
                           kc[:, :, ti], w)
        bonus = (rc[:, :, ti] * u * kc[:, :, ti]).sum(-1)  # (B,nc,t,H)
        a[:, :, :, ti, ti] = blk + torch.diag_embed(bonus.transpose(2, 3))
    y = _product("bcthd,bchdj->bcthj", rc * exp(e), s_in, terms)
    y = y + _product("bchts,bcshj->bcthj", a, vc, terms)
    return y.reshape(B, nc * CHUNK, H, Dv)[:, :S], s


def _scan_inputs(B, S, H, Dk, Dv, decay, seed=0):
    rs = np.random.RandomState(seed)
    r = rs.randn(B, S, H, Dk).astype(np.float32)
    k = rs.randn(B, S, H, Dk).astype(np.float32)
    v = rs.randn(B, S, H, Dv).astype(np.float32)
    if decay == "weak":                     # the model's: w0 = -6
        lw = -np.exp(-6 + 0.5 * rs.randn(B, S, H, Dk))
    elif decay == "normal":                 # the JAX kernel test's decays
        lw = -np.exp(rs.randn(B, S, H, Dk))
    else:                                   # strong: cl near -700 a chunk
        lw = -rs.uniform(1.0, 21.0, (B, S, H, Dk))
    u = rs.randn(H, Dk).astype(np.float32)
    return r, k, v, lw.astype(np.float32), u


# (B, S, H, Dk, Dv, decay): one position, a sub-block and one past it, a
# chunk and one past it, a ragged 200; weak, normal and strong decays; Dk
# and Dv not multiples of 16
SCAN_CASES = [
    (1, 1, 2, 16, 16, "weak"),
    (1, 16, 2, 16, 8, "normal"),
    (2, 17, 2, 8, 16, "strong"),
    (1, 64, 2, 16, 16, "normal"),
    (2, 65, 2, 16, 16, "weak"),
    (1, 200, 2, 16, 16, "strong"),
    (1, 200, 3, 33, 20, "normal"),
]


@pytest.mark.parametrize("terms", [0, 3])
@pytest.mark.parametrize("B,S,H,Dk,Dv,decay", SCAN_CASES)
def test_wkv_three_pass_matches_jax_kernel_and_oracle(B, S, H, Dk, Dv, decay,
                                                      terms):
    r, k, v, lw, u = _scan_inputs(B, S, H, Dk, Dv, decay)
    ja = tuple(map(jnp.asarray, (r, k, v, lw, u)))
    jy, jst = jax_rwkv6_scan(*ja, interpret=True)
    oy, ost = jref.rwkv6_scan_ref(*ja)
    seen = Exponents()
    y, st = wkv_three_pass(*map(torch.from_numpy, (r, k, v, lw, u)),
                           terms=terms, exp=seen)
    assert y.shape == (B, S, H, Dv) and st.shape == (B, H, Dk, Dv)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    assert seen.largest <= 0.0, seen.largest
    for name, (wy, wst) in (("pallas", (jy, jst)), ("oracle", (oy, ost))):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **ORACLE_TOL,
                                   err_msg=f"{name} y")
        np.testing.assert_allclose(st.numpy(), np.asarray(wst),
                                   **ORACLE_TOL, err_msg=f"{name} state")


def _chip_share(got, ref):
    """The largest |got - ref| / (atol + rtol |ref|) at the chip's limits."""
    return float(((got - ref).abs() / (CHIP_TOL["atol"] + CHIP_TOL["rtol"]
                                       * ref.abs())).max())


# the chip's tolerance also where the state carries over eight chunks at
# the model's widths, and at the kernel's widest head dims
CHIP_CASES = SCAN_CASES + [(1, 512, 2, 64, 64, "weak"),
                           (1, 130, 2, 128, 128, "weak")]


@pytest.mark.parametrize("B,S,H,Dk,Dv,decay", CHIP_CASES)
def test_wkv_split_products_hold_the_chips_tolerance(B, S, H, Dk, Dv, decay):
    """The 3xTF32 tensor-core products stay within the 1e-3 the chip holds
    the kernel to, against the port's plain version, with float32 r, k and
    v (and bf16, the model's)."""
    r, k, v, lw, u = map(torch.from_numpy, _scan_inputs(B, S, H, Dk, Dv,
                                                        decay, seed=1))
    for dt in (torch.float32, torch.bfloat16):
        rr, kk, vv = r.to(dt), k.to(dt), v.to(dt)
        seen = Exponents()
        y, st = wkv_three_pass(rr, kk, vv, lw, u, terms=3, exp=seen)
        y0, st0 = rwkv6_scan_plain(rr.float(), kk.float(), vv.float(), lw, u)
        assert seen.largest <= 0.0
        assert torch.isfinite(y).all() and torch.isfinite(st).all()
        torch.testing.assert_close(y, y0, **CHIP_TOL)
        torch.testing.assert_close(st, st0, **CHIP_TOL)


def test_wkv_one_tf32_part_misses_the_chips_tolerance():
    """Why the kernel takes three tf32 products: with one (hi alone, 11
    bits) y misses 1e-3 many times over where the state carries over eight
    chunks at the model's widths; 3xTF32 holds it with a margin."""
    r, k, v, lw, u = map(torch.from_numpy, _scan_inputs(1, 512, 2, 64, 64,
                                                        "weak", seed=1))
    y0, _ = rwkv6_scan_plain(r, k, v, lw, u)
    assert _chip_share(wkv_three_pass(r, k, v, lw, u, terms=1)[0], y0) > 10
    assert _chip_share(wkv_three_pass(r, k, v, lw, u, terms=3)[0], y0) < 0.3


@pytest.mark.parametrize("S", [65, 200])
def test_wkv_without_state_passing_fails_the_chips_tolerance(S):
    """The planted fault of the chip smoke: chunks that start from zero
    (pass 2 dropped) are far outside 1e-3 when the state carries."""
    r, k, v, lw, u = map(torch.from_numpy, _scan_inputs(1, S, 2, 16, 16,
                                                        "weak", seed=2))
    y0, _ = rwkv6_scan_plain(r, k, v, lw, u)
    bad, _ = wkv_three_pass(r, k, v, lw, u, pass_state=False)
    assert _chip_share(bad, y0) > 10
    good, _ = wkv_three_pass(r, k, v, lw, u)
    assert _chip_share(good, y0) < 1


# ---------------------------------------------------------------------------
# Greedy sampling over a cluster of slices
# ---------------------------------------------------------------------------
def greedy_cluster_merge(x, cluster, drop_slice=None):
    """(tokens (B,), logprobs (B,)) by the kernel's algorithm: each of
    ``cluster`` slices reduced to (max, first index, sum exp(x - max)),
    merged in slice order, the smaller index kept at equal maxima; with
    ``drop_slice`` that slice's state is lost (a planted fault)."""
    B, V = x.shape
    sl = greedy_slice(V, cluster)
    tokens = np.zeros(B, np.int32)
    logp = np.zeros(B, np.float32)
    for b in range(B):
        m, i, l = np.float32(-1e30), 2 ** 31 - 1, np.float32(0)
        for r in range(cluster):
            part = x[b, r * sl:(r + 1) * sl]
            if r == drop_slice or part.size == 0:
                continue
            pm = part.max()
            pi = r * sl + int(np.argmax(part))
            pl = np.exp(part - pm, dtype=np.float32).sum(dtype=np.float32)
            nm = max(m, pm)
            l = np.float32(l * np.exp(m - nm) + pl * np.exp(pm - nm))
            i = i if m > pm else (pi if pm > m else min(i, pi))
            m = nm
        tokens[b] = 0 if i == 2 ** 31 - 1 else i
        logp[b] = -np.log(max(l, np.float32(1e-30)))
    return tokens, logp


def _greedy_rows(V, cluster, seed=0):
    """Rows with ties across the slice edges (one value at the last entry
    of a slice and the first of the next), a tie between an early entry
    and the row's last one, a row of equal entries (token 0), and a plain
    random row."""
    rs = np.random.RandomState(seed)
    x = rs.randn(5, V).astype(np.float32)
    sl = greedy_slice(V, cluster)
    edges = [e for r in range(1, cluster) if r * sl < V
             for e in (r * sl - 1, r * sl)]
    x[0, edges] = 9.0                       # first: the first slice's end
    x[1, edges[-2:]] = 9.0                  # the last edge inside the row
    x[2, [3, V - 1]] = 9.0
    x[3] = 0.25
    return x


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("V", [1000, 999, 50001])
def test_greedy_cluster_tokens_are_bit_identical_to_jax(V, cluster):
    x = _greedy_rows(V, cluster)
    jt, jl = jax_greedy(jnp.asarray(x), interpret=True)
    t, lp = greedy_cluster_merge(x, cluster)
    np.testing.assert_array_equal(t, np.asarray(jt))
    np.testing.assert_allclose(lp, np.asarray(jl), atol=1e-5, rtol=0)
    sl = greedy_slice(V, cluster)
    assert t[0] == sl - 1 and t[3] == 0 and t[2] == 3
    pt, plp = greedy_sample_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(t, pt.numpy())
    np.testing.assert_allclose(lp, plp.numpy(), atol=1e-5, rtol=0)


def test_greedy_slices_cover_the_row_in_multiples_of_four():
    for cluster in (1, 2, 4, 8, 16):
        for V in (1, 7, 999, 1000, 32000, 50001, 65536, 92544):
            sl = greedy_slice(V, cluster)
            assert sl % 4 == 0 and cluster * sl >= V
            assert (cluster - 1) * sl < V + 4 * cluster


def test_greedy_cluster_fills_the_card():
    """The cluster size is chosen from the row count: 8 CTAs a row at
    every count up to 16 (one summation order for a row's log-sum-exp at
    every slot count up to 16), fewer above, never more than 16, at least
    1."""
    assert {greedy_cluster(B) for B in range(1, 17)} == {8}
    assert greedy_cluster(17) == 4 and greedy_cluster(1000) == 1
    for B in range(1, 300):
        c = greedy_cluster(B)
        assert c in (1, 2, 4, 8, 16)
        assert B * c <= 132 or c == 1


def test_greedy_cluster_without_one_slice_changes_a_token():
    """The planted fault of the chip smoke: the slice that holds a row's
    maximum lost from the merge."""
    x = _greedy_rows(1000, 16, seed=1)
    want, _ = greedy_cluster_merge(x, 16)
    worst = int(np.argmax(x[4])) // greedy_slice(1000, 16)
    bad, _ = greedy_cluster_merge(x, 16, drop_slice=worst)
    assert bad[4] != want[4]
