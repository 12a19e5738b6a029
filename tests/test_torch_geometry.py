"""ccvpe_torch.ops.geometry against ccvpe_tpu.ops.geometry and PIL, on the
CPU: PIL-convention nearest and bilinear warps, torchvision's center crop,
and the KITTI aerial alignment chain (one image with PIL's matrices, and a
batch with per-sample float32 matrices).

Both packages compute the source coordinates in float32, so they agree
except where a coordinate lands within rounding of a pixel boundary; PIL
computes them in float64.  The agreement metrics are those of
``tests/test_geometry.py`` (against PIL) and ``tests/test_data.py:481-504``
(the batched chain against the host PIL chain).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from ccvpe_tpu.ops import geometry as JG
from ccvpe_torch.ops import geometry as TG

torch.set_num_threads(2)
MPP, CAM = 0.1958, (1.08, 0.26)


def _img(hw, seed=0, batch=None):
    shape = (*hw, 3) if batch is None else (batch, *hw, 3)
    return np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)


def _mismatch(a, b) -> float:
    """Share of pixels with any channel different."""
    return float(np.mean(np.any(np.asarray(a) != np.asarray(b), axis=-1)))


def test_pil_matrices_match_jax():
    for angle, hw in ((0.0, (96, 128)), (-17.19, (512, 512)), (181.7, (375, 1242))):
        assert TG.pil_rotate_matrix(angle, hw) == JG.pil_rotate_matrix(angle, hw)
    assert TG.pil_translate_matrix(5.45, -1.3) == JG.pil_translate_matrix(5.45, -1.3)


@pytest.mark.parametrize("angle", [0.0, -17.19, 33.3, 90.0, 181.7])
def test_rotate_nearest(angle):
    arr = _img((96, 128))
    m = TG.pil_rotate_matrix(angle, arr.shape[:2])
    got = TG.warp_affine(torch.from_numpy(arr), m, method="nearest").numpy()
    assert got.dtype == np.uint8 and got.shape == arr.shape
    jax_out = np.asarray(JG.warp_affine(jnp.asarray(arr), m, method="nearest"))
    pil = np.asarray(Image.fromarray(arr).rotate(angle))
    assert _mismatch(got, jax_out) < 1e-3
    assert _mismatch(got, pil) < 5e-3


@pytest.mark.parametrize("dx,dy", [(5.45, 1.31), (-12.7, 8.2), (0.0, 0.0), (200.0, -3.0)])
def test_translate_bilinear(dx, dy):
    arr = _img((64, 80), seed=1)
    m = TG.pil_translate_matrix(dx, dy)
    got = TG.warp_affine(torch.from_numpy(arr), m, method="bilinear").numpy().astype(int)
    jax_out = np.asarray(JG.warp_affine(jnp.asarray(arr), m, method="bilinear")).astype(int)
    pil = np.asarray(Image.fromarray(arr).transform(
        (80, 64), Image.AFFINE, (1, 0, dx, 0, 1, dy), resample=Image.BILINEAR)).astype(int)
    assert np.abs(got - jax_out).max() <= 1
    assert np.mean(got != jax_out) < 1e-3
    diff = np.abs(got - pil)
    assert np.mean(diff) < 0.2 and np.mean(diff > 1) < 2e-2


def test_float_images_keep_their_values():
    arr = np.random.default_rng(2).standard_normal((40, 50, 2)).astype(np.float32)
    m = TG.pil_translate_matrix(3.25, -1.5)
    got = TG.warp_affine(torch.from_numpy(arr), m, out_hw=(30, 60)).numpy()
    want = np.asarray(JG.warp_affine(jnp.asarray(arr), m, out_hw=(30, 60)))
    assert got.shape == (30, 60, 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        TG.warp_affine(torch.from_numpy(arr), m, method="bicubic")


def test_batched_warp_is_the_per_sample_warp():
    """A batch with a [B] tensor in the matrix warps each image by its own
    matrix; a Python-float matrix warps every image alike."""
    sat = torch.from_numpy(_img((48, 64), seed=3, batch=3))
    angles = torch.tensor([-30.0, 0.5, 77.7])
    shift = torch.tensor([4.25, -7.5, 0.0])
    for m, method in ((TG.rotate_matrix_traced(angles, (48, 64)), "nearest"),
                      (TG.translate_matrix_traced(shift, -shift), "bilinear"),
                      (TG.pil_translate_matrix(2.5, 1.0), "bilinear")):
        got = TG.warp_affine(sat, m, method=method)
        for i in range(3):
            mi = tuple(v[i] if isinstance(v, torch.Tensor) and v.dim() else v for v in m)
            torch.testing.assert_close(got[i], TG.warp_affine(sat[i], mi, method=method),
                                       rtol=0, atol=0)


@pytest.mark.parametrize("h,w,side", [(515, 515, 512), (517, 520, 512), (513, 514, 512),
                                      (5, 8, 8), (9, 4, 6), (6, 6, 6)])
def test_center_crop(h, w, side):
    """Banker's-rounded offsets (515 -> row 2, not 1) and a symmetric zero
    pad, the smaller half first, where the crop is larger than the image."""
    arr = np.arange(h * w * 3, dtype=np.float32).reshape(h, w, 3) + 1
    got = TG.center_crop(torch.from_numpy(arr), side).numpy()
    want = np.asarray(JG.center_crop(jnp.asarray(arr), side))
    assert got.shape == (side, side, 3)
    np.testing.assert_array_equal(got, want)
    batch = torch.from_numpy(np.stack([arr, -arr]))
    np.testing.assert_array_equal(TG.center_crop(batch, side)[1].numpy(), -want)
    if (h, side) == (515, 512):
        np.testing.assert_array_equal(got, arr[2:514, 2:514])


def _pil_chain(arr, heading, shift, ori):
    img = Image.fromarray(arr)
    r1 = img.rotate((-heading) / np.pi * 180)
    t1 = r1.transform(r1.size, Image.AFFINE, (1, 0, CAM[0] / MPP, 0, 1, CAM[1] / MPP),
                      resample=Image.BILINEAR)
    t2 = t1.transform(t1.size, Image.AFFINE, (1, 0, shift[0], 0, 1, -shift[1]),
                      resample=Image.BILINEAR)
    return np.asarray(t2.rotate(ori))


def test_kitti_chain_matches_jax_and_pil():
    arr = _img((512, 512), seed=2)
    heading, shift, ori = 0.3, (37.2, -21.5), 7.3
    got = TG.kitti_alignment_chain(torch.from_numpy(arr), heading, MPP, CAM, shift, ori,
                                   side=512).numpy()
    want = np.asarray(JG.kitti_alignment_chain(arr, heading, MPP, CAM, shift, ori, side=512))
    assert _mismatch(got, want) < 5e-3
    diff = np.abs(got.astype(int) - _pil_chain(arr, heading, shift, ori).astype(int))
    assert np.mean(diff <= 1) > 0.98 and np.median(diff) == 0


def test_batched_kitti_chain_matches_jax_and_the_host_chain():
    """A batch of four with its own heading, shifts and rotation each, cropped
    from 160 to 128: against JAX's batched chain, against the port's own
    per-image chain, and against the host PIL chain with
    ``tests/test_data.py``'s agreement metric."""
    sat = _img((160, 160), seed=4, batch=4)
    rng = np.random.default_rng(5)
    heading = rng.uniform(-np.pi, np.pi, 4).astype(np.float32)
    sx, sy = rng.uniform(-40, 40, (2, 4)).astype(np.float32)
    ori = rng.uniform(-10, 10, 4).astype(np.float32)
    got = TG.kitti_alignment_chain_batched(
        torch.from_numpy(sat), torch.from_numpy(heading), MPP, CAM, torch.from_numpy(sx),
        torch.from_numpy(sy), torch.from_numpy(ori), side=128).numpy()
    want = np.asarray(JG.kitti_alignment_chain_batched(
        jnp.asarray(sat), jnp.asarray(heading), MPP, CAM, jnp.asarray(sx), jnp.asarray(sy),
        jnp.asarray(ori), side=128))
    assert got.shape == want.shape == (4, 128, 128, 3) and got.dtype == np.uint8
    assert _mismatch(got, want) < 5e-3
    for i in range(4):
        one = TG.kitti_alignment_chain(
            torch.from_numpy(sat[i]), float(heading[i]), MPP, CAM,
            (float(sx[i]), float(sy[i])), float(ori[i]), side=128).numpy()
        assert np.mean(np.abs(got[i].astype(int) - one.astype(int)) <= 1) > 0.99
        host = _pil_chain(sat[i], float(heading[i]), (float(sx[i]), float(sy[i])),
                          float(ori[i]))[16:144, 16:144]
        # normalised units, as tests/test_data.py:498-499: |a - b| < 0.05
        close = np.mean(np.abs(got[i].astype(np.float32) - host) / 255 / 0.229 < 0.05)
        assert close > 0.95, close
