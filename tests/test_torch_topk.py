"""The port's top-k (values and threshold mask) against the JAX package.

The plain versions must be bit-identical to the JAX Pallas kernel
(interpret mode) and to ``ref.topk_mask_ref``: top-k is a selection and
does no arithmetic.  Inputs are numpy arrays from a seed fed to both sides,
at the JAX test's shape (3, 500) and k in {1, 7, 64}, plus rows whose k-th
value is tied, and a row whose k-th value is a zero of either sign (-0.0
and +0.0 are one value to both sides).
"""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.sampling import topk_mask as jax_topk_mask  # noqa: E402
from repro.kernels.sampling import topk_values as jax_topk_values  # noqa: E402
from repro_torch.kernels.sampling import (NEG_INF, topk_mask,  # noqa: E402
                                          topk_mask_plain, topk_values,
                                          topk_values_plain)


def _logits(kind):
    rs = np.random.RandomState(0)
    x = rs.randn(3, 500).astype(np.float32)
    if kind == "ties":
        # row 0: six values of 9 above three of 8, so the 7th largest ties
        # with the 8th and 9th; row 1: a value repeats 70 times, so k = 64
        # ends inside the run; row 2: a tie at the very top
        x[0, 10:16] = 9.0
        x[0, [3, 200, 499]] = 8.0
        x[1, 100:170] = 2.5
        x[2, [0, 250, 499]] = 50.0
    elif kind == "zeros":
        # row 0: three values above 70 of +0.0 and 70 of -0.0, the rest
        # below -1, so for k = 7 and 64 the threshold is a zero
        x[0] = -np.abs(x[0]) - 1.0
        x[0, 5:8] = 3.0
        x[0, 20:160:2] = 0.0
        x[0, 21:161:2] = -0.0
    return x


@pytest.mark.parametrize("kind", ["normal", "ties", "zeros"])
@pytest.mark.parametrize("k", [1, 7, 64])
def test_topk_plain_is_bit_identical_to_jax(kind, k):
    x = _logits(kind)
    jx = jnp.asarray(x)
    vals = topk_values_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(
        vals.numpy(), np.asarray(jax_topk_values(jx, k, interpret=True)))
    mask = topk_mask_plain(torch.from_numpy(x), k)
    assert mask.dtype == torch.float32 and mask.shape == x.shape
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jax_topk_mask(jx, k, interpret=True)))
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(jref.topk_mask_ref(jx, k)))
    kept = (mask.numpy() > NEG_INF).sum(axis=1)
    assert (kept >= k).all()
    if kind == "ties" and k == 7:
        assert kept[0] > k           # every entry tied at the threshold
    if kind == "zeros" and k > 1:
        assert kept[0] == 3 + 140    # both signs of zero survive


def test_topk_wrappers_on_cpu_are_the_plain_versions():
    x = torch.from_numpy(_logits("ties"))
    before = (topk_values.launches, topk_mask.launches)
    assert torch.equal(topk_values(x, 7), topk_values_plain(x, 7))
    assert torch.equal(topk_mask(x, 7), topk_mask_plain(x, 7))
    assert (topk_values.launches, topk_mask.launches) == before


@pytest.mark.parametrize("k", [0, 501])
def test_topk_refuses_k_out_of_range(k):
    x = torch.from_numpy(_logits("normal"))
    for fn in (topk_values, topk_mask):
        with pytest.raises(ValueError, match="out of range"):
            fn(x, k)
