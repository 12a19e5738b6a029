"""ccvpe_torch.ops.gt against ccvpe_tpu.ops.gt on seeded offsets and angles.

Tolerances:
* Heatmaps: atol 5e-6.  The port's grid (rounded from float64) and
  ``jnp.linspace`` (float32, rewritten by XLA) put about a third of the
  points of a 512-point grid one ulp apart (3.1e-5 at +-256 px), and the Gaussian's steepest slope is exp(-1/2)/sigma = 0.15
  per px, so the heatmaps may differ by up to 4.6e-6.
* Bin weights and orientation fields: atol 1e-6 (float32 divisions,
  remainders, cos and sin of the same inputs).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ccvpe_tpu.ops import gt as JG
from ccvpe_torch.ops import gt as TG

HEATMAP_ATOL = 5e-6
ATOL = 1e-6


def _offsets(b, seed, span=200.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-span, span, b).astype(np.float32),
            rng.uniform(-span, span, b).astype(np.float32),
            rng.uniform(0, 360, b).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("hw", [(512, 512), (128, 128), (7, 11)])
@pytest.mark.parametrize("row,col", [(0.0, 0.0), (37.5, -12.25), (-200.0, 199.0)])
def test_gaussian_heatmap(hw, row, col):
    want = np.asarray(JG.gaussian_heatmap(*hw, jnp.float32(row), jnp.float32(col)))
    got = TG.gaussian_heatmap(*hw, torch.tensor(row), torch.tensor(col)).numpy()
    assert got.shape == want.shape == hw and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=HEATMAP_ATOL, rtol=0)


# 0, bin edges (exact multiples of 18 and 22.5 degrees), mid-bin, 359.9
ANGLES = [0.0, 18.0, 22.5, 45.0, 90.0, 180.0, 270.0, 9.0, 100.3, 359.9]


@pytest.mark.parametrize("bins", [20, 16, 4])
@pytest.mark.parametrize("clockwise", [False, True])
def test_orientation_bin_weights(bins, clockwise):
    angles = np.array(ANGLES, np.float32)
    want = np.asarray(jax.vmap(lambda v: JG.orientation_bin_weights(v, bins, clockwise))(
        jnp.asarray(angles)))
    got = TG.orientation_bin_weights(_t(angles), bins, clockwise).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    # a bin edge is one bin at weight 1; counter-clockwise bins run backwards
    edge = ANGLES.index(90.0)
    idx = int(90.0 // (360 / bins))
    assert got[edge].argmax() == (idx if clockwise else (bins - idx) % bins)


def test_orientation_map():
    angles = np.array(ANGLES, np.float32)
    want = np.stack([np.asarray(JG.orientation_map(5, 6, jnp.float32(a))) for a in angles])
    got = TG.orientation_map(5, 6, _t(angles))
    assert got.shape == (len(angles), 5, 6, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("clockwise", [False, True])
def test_synthesize_batch_dense_and_factored(clockwise):
    r, c, a = _offsets(4, seed=1)
    kw = dict(height=512, width=512, bins=20, clockwise=clockwise)
    jd = JG.synthesize_batch(jnp.asarray(r), jnp.asarray(c), jnp.asarray(a), **kw)
    jf = JG.synthesize_batch_factored(jnp.asarray(r), jnp.asarray(c), jnp.asarray(a), **kw)
    td = TG.synthesize_batch(_t(r), _t(c), _t(a), **kw)
    tf = TG.synthesize_batch_factored(_t(r), _t(c), _t(a), **kw)
    for got, want, tol in zip((*td, *tf), (*jd, *jf), (HEATMAP_ATOL, HEATMAP_ATOL, ATOL,
                                                       HEATMAP_ATOL, ATOL, ATOL)):
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)
    # the dense volume is the factored form's outer product
    gt, w, _ = tf
    torch.testing.assert_close(td[1], gt[..., None] * w[:, None, None, :], rtol=0, atol=0)
    torch.testing.assert_close(td[0][..., 0], gt, rtol=0, atol=0)
