"""ccvpe_torch.data.vigor and the device half of ccvpe_torch.data.transforms
against the JAX package (ccvpe_tpu.data.vigor, .transforms), on the CPU, on
one seeded synthetic VIGOR root: the index, host samples and collated
batches bit-identical (two seeds, two epochs, any worker count and fetch
order), the device batch, the panorama roll and the blank-satellite
fallback."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ccvpe_tpu.data import pipeline as JP
from ccvpe_tpu.data import transforms as JT
from ccvpe_tpu.data import vigor as JV
from ccvpe_torch.data import pipeline as TP
from ccvpe_torch.data import transforms as TT
from ccvpe_torch.data import vigor as TV
from tests.torch_data_roots import assert_device_batch_close, assert_samples_equal, vigor_root

torch.set_num_threads(2)
HW = dict(grd_hw=(32, 64), sat_hw=(64, 64))


def test_constants_match_jax():
    assert TV.CITY_LISTS == JV.CITY_LISTS
    assert (TV.GRD_HW, TV.SAT_HW, TV.BINS) == (JV.GRD_HW, JV.SAT_HW, JV.BINS)
    assert (TT.IMAGENET_MEAN, TT.IMAGENET_STD) == (JT.IMAGENET_MEAN, JT.IMAGENET_STD)


@pytest.mark.parametrize("split,train", [("samearea", True), ("samearea", False),
                                         ("crossarea", True), ("crossarea", False)])
def test_index_matches_jax(vigor_root, split, train):
    got = TV.VigorIndex.load(vigor_root, split, train)
    want = JV.VigorIndex.load(vigor_root, split, train)
    assert len(got) == len(want) > 0
    for f in dataclasses.fields(JV.VigorIndex):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("pos_only,ori_noise", [(False, 180.0), (True, 36.0)])
@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (5, 0), (5, 1)])
def test_host_samples_bit_identical(vigor_root, pos_only, ori_noise, seed, epoch):
    idx_t, idx_j = TV.VigorIndex.load(vigor_root), JV.VigorIndex.load(vigor_root)
    ts = TV.VigorSampler(idx_t, pos_only=pos_only, ori_noise=ori_noise, seed=seed, **HW)
    js = JV.VigorSampler(idx_j, pos_only=pos_only, ori_noise=ori_noise, seed=seed, **HW)
    ts.set_epoch(epoch)
    js.set_epoch(epoch)
    for i in range(len(idx_t)):
        plan = ts.plan(i)
        assert plan == js.plan(i)
        assert_samples_equal(ts(i), js(i))


def test_random_orientation_overrides_the_draw(vigor_root):
    idx_t, idx_j = TV.VigorIndex.load(vigor_root), JV.VigorIndex.load(vigor_root)
    frozen = np.linspace(0, 359, len(idx_t))
    ts = TV.VigorSampler(idx_t, random_orientation=frozen, **HW)
    js = JV.VigorSampler(idx_j, random_orientation=frozen, **HW)
    for i in (0, 7, len(idx_t) - 1):
        assert_samples_equal(ts(i), js(i))
        assert ts(i)["rotation"] == np.float32(frozen[i] / 360.0)


def test_loader_batches_independent_of_workers_and_order(vigor_root):
    """The port's Loader over a shuffled epoch gives the JAX Loader's
    batches bit for bit, with one worker or four; a sampler asked in reverse
    order, or only for every other sample (another process's stride), gives
    the same samples."""
    idx_t, idx_j = TV.VigorIndex.load(vigor_root), JV.VigorIndex.load(vigor_root)
    n = len(idx_t)
    order = TP.epoch_indices(n, shuffle=True, rng=np.random.default_rng(3))
    np.testing.assert_array_equal(
        order, JP.epoch_indices(n, shuffle=True, rng=np.random.default_rng(3)))
    mk = lambda: TV.VigorSampler(idx_t, pos_only=False, seed=2, **HW)
    want = list(JP.Loader(JV.VigorSampler(idx_j, pos_only=False, seed=2, **HW), order,
                          batch_size=5, num_workers=2, native_batch=False))
    assert len(want) == n // 5
    for workers in (1, 4):
        got = list(TP.Loader(mk(), order, batch_size=5, num_workers=workers,
                             native_batch=False))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_samples_equal(a, b)
    fwd = [mk()(i) for i in range(n)]
    one = mk()
    rev = [one(i) for i in reversed(range(n))][::-1]
    other = mk()
    for i, (a, b) in enumerate(zip(fwd, rev)):
        assert_samples_equal(a, b)
        if i % 2:
            assert_samples_equal(other(i), a)


def test_device_batch_matches_jax(vigor_root):
    idx_t = TV.VigorIndex.load(vigor_root)
    sampler = TV.VigorSampler(idx_t, pos_only=False, **HW)
    raw = TP.collate([sampler(i) for i in range(6)])
    got = TV.device_batch(raw, train=True, sat_hw=HW["sat_hw"], device="cpu")
    want = JV.device_batch(raw, train=True, sat_hw=HW["sat_hw"])
    assert got["grd"].device == torch.device("cpu")
    assert got["bin_weights"].shape == (6, TV.BINS)
    assert_device_batch_close(got, want)
    # the roll happened: not the unrolled normalised panorama
    assert not torch.allclose(got["grd"], TT.normalize_images(torch.from_numpy(raw["grd"])))


def _half_way_rotations(w: int) -> np.ndarray:
    """float32 rotations whose float32 product with ``w`` is a half-way
    shift k + 0.5 (rounded half to even), and rotations whose float64
    product rounds to another integer than the float32 one."""
    k = np.arange(-w + 1, w - 1)
    exact = ((k + 0.5) / w).astype(np.float32)
    # each rotation and its neighbours up to 3 ulps away
    cand = (exact.view(np.int32)[:, None] + np.arange(-3, 4, dtype=np.int32)).view(np.float32)
    cand = cand[np.abs(cand) < 1].ravel()
    f32 = np.round(cand * np.float32(w))
    f64 = np.round(cand.astype(np.float64) * w)
    flips = cand[f32 != f64]
    if w & (w - 1):      # not a power of two: float32 products round
        assert len(flips) > 0
    return np.concatenate([exact, flips, np.float32([0.0, 0.999, -0.999, 0.5, -0.5])])


@pytest.mark.parametrize("w", [64, 640])
def test_roll_panorama_exact(w):
    rot = _half_way_rotations(w)
    grd = np.random.default_rng(1).integers(0, 256, (len(rot), 2, w, 3), dtype=np.uint8)
    got = TT.roll_panorama(torch.from_numpy(grd), torch.from_numpy(rot)).numpy()
    want = np.asarray(JT.roll_panorama(jnp.asarray(grd), jnp.asarray(rot)))
    np.testing.assert_array_equal(got, want)
    # round half to even: 0.5 px rolls by 0, 1.5 px by 2
    half = np.float32([0.5 / w, 1.5 / w])
    out = TT.roll_panorama(torch.from_numpy(grd[:2]), torch.from_numpy(half)).numpy()
    np.testing.assert_array_equal(out[0], grd[0])
    np.testing.assert_array_equal(out[1], np.roll(grd[1], 2, axis=1))


def test_unreadable_satellite_blank_fallback(vigor_root):
    """An unreadable satellite gives a blank tile and unscaled offsets, as
    in the JAX package and the reference, instead of raising in a worker."""
    idx_t, idx_j = TV.VigorIndex.load(vigor_root), JV.VigorIndex.load(vigor_root)
    sat_idx = int(idx_t.labels[0, 0])
    idx_t.sat_paths[sat_idx] = idx_j.sat_paths[sat_idx] = "/nonexistent/satellite.png"
    got = TV.VigorSampler(idx_t, ori_noise=0.0)(0)
    assert_samples_equal(got, JV.VigorSampler(idx_j, ori_noise=0.0)(0))
    np.testing.assert_array_equal(got["sat"], np.zeros((*TV.SAT_HW, 3), np.uint8))
    assert got["row_offset"] == np.float32(np.round(idx_t.deltas[0, 0, 0]))
    assert got["col_offset"] == np.float32(np.round(idx_t.deltas[0, 0, 1]))
