"""The data layer's device half on the card: ``device_prefetch``'s side
stream, and each dataset's ``device_batch`` on CUDA against the same batch
assembled on the CPU.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_data_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from ccvpe_torch.data import kitti as TK
from ccvpe_torch.data import oxford as TO
from ccvpe_torch.data import pipeline as TP
from ccvpe_torch.data import synthetic
from ccvpe_torch.data import vigor as TV

pytestmark = pytest.mark.cuda
ATOL = 1e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("roots")
    return {"vigor": synthetic.write_vigor_root(str(base / "vigor"), panos_per_city=8,
                                                pano_hw=(160, 320), sat_hw=(200, 200)),
            "kitti": synthetic.write_kitti_root(str(base / "kitti"), grd_hw=(120, 400),
                                                sat_hw=(300, 300)),
            "oxford": synthetic.write_oxford_root(str(base / "oxford") + "/")}


def _close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].device.type == "cuda" and got[k].shape == want[k].shape
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=ATOL, msg=k)


def test_vigor_and_oxford_device_batches_match_the_cpu(dev, roots):
    idx = TV.VigorIndex.load(roots["vigor"])
    raw = TP.collate([TV.VigorSampler(idx, pos_only=False, grd_hw=(160, 320),
                                      sat_hw=(256, 256))(i) for i in range(8)])
    kw = dict(train=True, sat_hw=(256, 256))
    _close(TV.device_batch(raw, device=dev, **kw), TV.device_batch(raw, device="cpu", **kw))
    oidx = TO.OxfordIndex.load(roots["oxford"], roots["oxford"] + "satellite_map_new.png",
                               "train")
    raw = TP.collate([TO.OxfordSampler(oidx)(i) for i in range(4)])
    _close(TO.device_batch(raw, train=True, device=dev),
           TO.device_batch(raw, train=True, device="cpu"))


def test_kitti_device_augment_matches_the_cpu(dev, roots):
    root = roots["kitti"]
    idx = TK.KittiIndex.load(root, os.path.join(root, "train_files.txt"))
    s = TK.KittiSampler(idx, sat_hw=(256, 256), device_augment=True)
    raw = TP.collate([s(i) for i in range(8)])
    kw = dict(train=True, mpp=s.mpp, sat_hw=(256, 256))
    got = TK.device_batch_device_aug(raw, device=dev, **kw)
    want = TK.device_batch_device_aug(raw, device="cpu", **kw)
    # the warps' float32 coordinates may land on the other side of a pixel
    # boundary on the card: all but such ties are equal
    sat_diff = (got["sat"].cpu() - want["sat"]).abs().amax(dim=-1)
    assert (sat_diff > ATOL).float().mean().item() < 1e-3
    _close({k: v for k, v in got.items() if k != "sat"},
           {k: v for k, v in want.items() if k != "sat"})


@pytest.mark.parametrize("depth", [1, 3])
def test_device_prefetch_equals_the_synchronous_batches(dev, roots, depth):
    """Batches built on the side stream and handed over (event, record_stream)
    equal the same batches built on the current stream, while the consumer
    keeps the card busy and frees each batch before taking the next."""
    idx = TV.VigorIndex.load(roots["vigor"])
    sampler = TV.VigorSampler(idx, pos_only=False, grd_hw=(160, 320), sat_hw=(256, 256))
    hosts = list(TP.Loader(sampler, np.arange(len(idx)), batch_size=4, num_workers=4))
    fn = lambda raw: TV.device_batch(raw, train=True, sat_hw=(256, 256), device=dev)
    sums = []
    for batch in TP.device_prefetch(iter(hosts), fn, depth=depth, device=dev):
        big = torch.randn(2048, 2048, device=dev)
        for _ in range(4):
            big = big @ big / 2048          # keep the consumer's stream busy
        sums.append({k: v.double().sum().item() for k, v in batch.items()})
        del batch
    assert len(sums) == len(hosts)
    for s, raw in zip(sums, hosts):
        want = fn(raw)
        for k, v in want.items():
            assert s[k] == v.double().sum().item(), k
