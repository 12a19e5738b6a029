"""ccvpe_torch.data.oxford against ccvpe_tpu.data.oxford, on the CPU, on one
seeded synthetic Oxford RobotCar root: the index of each split, host
samples bit-identical (the train split's random crops over two seeds and
two epochs; the deterministic grid crops of val and test), and the device
batch with its clockwise bins."""

import dataclasses

import numpy as np
import pytest
import torch

from ccvpe_tpu.data import oxford as JO
from ccvpe_tpu.data import pipeline as JP
from ccvpe_torch.data import oxford as TO
from ccvpe_torch.data import pipeline as TP
from tests.torch_data_roots import assert_device_batch_close, assert_samples_equal, oxford_root

torch.set_num_threads(2)


def _index(pkg, root, split):
    return pkg.OxfordIndex.load(root, root + "satellite_map_new.png", split)


def test_constants_match_jax():
    assert (TO.METER_PER_PIXEL, TO.GRD_HW, TO.SAT_HW, TO.BINS, TO.TEST_TRAVERSALS) == \
        (JO.METER_PER_PIXEL, JO.GRD_HW, JO.SAT_HW, JO.BINS, JO.TEST_TRAVERSALS)
    utm = np.array([[619400.0, 5736195.0], [620100.5, 5735400.25]])
    np.testing.assert_array_equal(TO.utm_to_pixel_transform()(utm),
                                  JO.utm_to_pixel_transform()(utm))


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_index_matches_jax(oxford_root, split):
    got, want = _index(TO, oxford_root, split), _index(JO, oxford_root, split)
    assert len(got) > 0
    for f in dataclasses.fields(JO.OxfordIndex):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    if split == "test":
        assert got.traversal_lengths == (2, 2, 2)


@pytest.mark.parametrize("split,seed,epoch", [("train", 0, 0), ("train", 0, 1), ("train", 4, 0),
                                              ("train", 4, 1), ("val", 0, 0), ("test", 0, 0)])
def test_samples_bit_identical(oxford_root, split, seed, epoch):
    ts = TO.OxfordSampler(_index(TO, oxford_root, split), seed=seed)
    js = JO.OxfordSampler(_index(JO, oxford_root, split), seed=seed)
    ts.set_epoch(epoch)
    js.set_epoch(epoch)
    order = np.arange(len(ts.index))
    got = list(TP.Loader(ts, order, batch_size=2, num_workers=3, native_batch=False))
    want = list(JP.Loader(js, order, batch_size=2, num_workers=1, native_batch=False))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert_samples_equal(a, b)
    # the crops lie inside the map: not blank
    assert got[0]["sat"].std() > 10


def test_device_batch_matches_jax(oxford_root):
    ts = TO.OxfordSampler(_index(TO, oxford_root, "train"))
    raw = TP.collate([ts(i) for i in range(4)])
    got = TO.device_batch(raw, train=True, device="cpu")
    assert_device_batch_close(got, JO.device_batch(raw, train=True))
    assert got["grd"].shape == (4, *TO.GRD_HW, 3) and got["bin_weights"].shape == (4, TO.BINS)
