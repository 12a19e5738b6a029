"""ccvpe_torch.data.kitti against ccvpe_tpu.data.kitti, on the CPU, on one
seeded synthetic KITTI root (satmaps 160 px, larger than the 128 px crop
the tests ask for): the index, host samples bit-identical (the host PIL
chain of the test split; the train split's draws over two seeds and two
epochs; the ``device_augment`` raw samples), the device batch, and the
batched alignment chain on the device against JAX's and against the host
chain."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ccvpe_tpu.data import kitti as JK
from ccvpe_tpu.data import pipeline as JP
from ccvpe_torch.data import kitti as TK
from ccvpe_torch.data import pipeline as TP
from tests.torch_data_roots import (ATOL, assert_device_batch_close, assert_samples_equal,
                                    kitti_root)

torch.set_num_threads(2)
SAT_HW = (128, 128)


def _index(pkg, root, test):
    name = "test1_files.txt" if test else "train_files.txt"
    return pkg.KittiIndex.load(root, os.path.join(root, name), test=test)


def test_constants_match_jax():
    for name in ("DEFAULT_LAT", "SATMAP_ZOOM", "SAT_PROCESS_SIDELENGTH", "SATMAP_DIR",
                 "GRDIMAGE_DIR", "OXTS_DIR", "LEFT_COLOR_CAMERA_DIR",
                 "CAMERA_GPS_SHIFT_LEFT", "GRD_HW", "SAT_HW", "BINS"):
        assert getattr(TK, name) == getattr(JK, name), name
    for lat, scale in ((49.015, 1.0), (48.9, 2.0)):
        assert TK.meter_per_pixel(lat, scale=scale) == JK.meter_per_pixel(lat, scale=scale)
    for args in ((0.3, -0.6, 7.0, 100.0, 120.0), (-1.0, 1.0, -10.0, 50.0, 60.0),
                 (0.0, 0.0, 95.0, 1.0, 1.0)):
        assert TK._finalize_scalars(*args) == JK._finalize_scalars(*args)


@pytest.mark.parametrize("test", [False, True])
def test_index_matches_jax(kitti_root, test):
    got, want = _index(TK, kitti_root, test), _index(JK, kitti_root, test)
    assert len(got) > 0
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("device_augment", [False, True])
def test_test_split_samples_bit_identical(kitti_root, device_augment):
    kw = dict(rotation_range=10, sat_hw=SAT_HW, device_augment=device_augment)
    ts = TK.KittiSampler(_index(TK, kitti_root, True), **kw)
    js = JK.KittiSampler(_index(JK, kitti_root, True), **kw)
    for i in range(len(ts.index)):
        assert ts.plan(i) == js.plan(i)
        assert_samples_equal(ts(i), js(i))


@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (3, 0), (3, 1)])
def test_train_split_samples_bit_identical(kitti_root, seed, epoch):
    kw = dict(rotation_range=10, sat_hw=SAT_HW, seed=seed)
    ts = TK.KittiSampler(_index(TK, kitti_root, False), **kw)
    js = JK.KittiSampler(_index(JK, kitti_root, False), **kw)
    ts.set_epoch(epoch)
    js.set_epoch(epoch)
    order = np.arange(len(ts.index))[::-1]
    for a, b in zip(TP.Loader(ts, order, batch_size=4, num_workers=3, native_batch=False),
                    JP.Loader(js, order, batch_size=4, num_workers=2, native_batch=False)):
        assert_samples_equal(a, b)


def test_device_batch_matches_jax(kitti_root):
    ts = TK.KittiSampler(_index(TK, kitti_root, True), rotation_range=10, sat_hw=SAT_HW)
    raw = TP.collate([ts(i) for i in range(4)])
    got = TK.device_batch(raw, train=False, sat_hw=SAT_HW, device="cpu")
    assert_device_batch_close(got, JK.device_batch(raw, train=False, sat_hw=SAT_HW))
    assert got["bin_weights"].shape == (4, TK.BINS)


def test_device_augment_batch_matches_jax_and_the_host_chain(kitti_root):
    """``device_batch_device_aug`` on the CPU: the aligned aerial against
    JAX's batched chain (all but coordinate-rounding ties equal) and against
    the host PIL chain (``tests/test_data.py:481-504``'s metric); the GT,
    bin weights and orientation as the host path's."""
    idx = _index(TK, kitti_root, True)
    dev = TK.KittiSampler(idx, rotation_range=10, sat_hw=SAT_HW, device_augment=True)
    host = TK.KittiSampler(idx, rotation_range=10, sat_hw=SAT_HW)
    raw = TP.collate([dev(i) for i in range(4)])
    got = TK.device_batch_device_aug(raw, train=True, mpp=dev.mpp, sat_hw=SAT_HW, device="cpu")
    want = JK.device_batch_device_aug(raw, train=True, mpp=dev.mpp, sat_hw=SAT_HW)
    assert set(got) == set(want)
    sat, jsat = got["sat"].numpy(), np.asarray(want["sat"])
    assert sat.shape == jsat.shape == (4, *SAT_HW, 3)
    assert np.mean(np.any(np.abs(sat - jsat) > ATOL, axis=-1)) < 5e-3
    for key in ("grd", "bin_weights", "orientation"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["gt"].numpy(), np.asarray(want["gt"]), atol=5e-6, rtol=0)
    host_batch = TK.device_batch(TP.collate([host(i) for i in range(4)]), train=True,
                                 sat_hw=SAT_HW, device="cpu")
    close = np.mean(np.abs(sat - host_batch["sat"].numpy()) < 0.05)
    assert close > 0.95, close
    for key in ("gt", "bin_weights", "orientation"):
        torch.testing.assert_close(got[key], host_batch[key], rtol=0, atol=ATOL)
