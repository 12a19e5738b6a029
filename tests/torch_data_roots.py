"""Shared set-up of the data-layer and CLI parity tests
(``tests/test_torch_data_*.py``, ``tests/test_torch_cli*.py``,
``tests/test_torch_harness.py``): seeded synthetic dataset roots written
once per test module by ``ccvpe_torch.data.synthetic`` (which the JAX
package reads as well), a seeded NANO ``.pt`` both packages load, and
comparisons of host samples and device batches.

Tolerances of a device batch against the JAX package's, on the CPU:
images, bin weights and orientation fields atol 1e-6; the GT heatmap atol
5e-6, the bound ``tests/test_torch_gt.py`` derives for the same function
(the two grids round some points one ulp apart).
"""

import numpy as np
import pytest
import torch

from ccvpe_torch.data import synthetic

ATOL = 1e-6
HEATMAP_ATOL = 5e-6


@pytest.fixture(scope="module")
def vigor_root(tmp_path_factory):
    return synthetic.write_vigor_root(str(tmp_path_factory.mktemp("vigor")))


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    return synthetic.write_kitti_root(str(tmp_path_factory.mktemp("kitti")), sat_hw=(160, 160))


@pytest.fixture(scope="module")
def oxford_root(tmp_path_factory):
    return synthetic.write_oxford_root(str(tmp_path_factory.mktemp("oxford")) + "/")


def write_nano_pt(path: str, seed: int) -> str:
    """A seeded NANO model of the port as a reference-format ``.pt``, its
    BatchNorm statistics calibrated on one seeded batch (with identity
    statistics the random backbones flatten the heatmap)."""
    from ccvpe_torch import api
    from ccvpe_torch.data.transforms import normalize_images
    from ccvpe_torch.nn.layers import calibrate_batch_norm_

    model = api.load_model(preset="NANO", seed=seed, device="cpu")
    rng = np.random.default_rng(seed + 1)
    g, s = (normalize_images(torch.from_numpy(rng.integers(0, 256, (2, *hw, 3), np.uint8)))
            for hw in (model.cfg.grd_hw, model.cfg.sat_hw))
    calibrate_batch_norm_(model.net, lambda: model.net(g, s))
    model.save_torch(path)
    return path


def assert_samples_equal(got: dict, want: dict) -> None:
    """Bit-identical host samples or collated batches: the same keys,
    dtypes, shapes and values."""
    assert set(got) == set(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, (key, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=key)


def assert_device_batch_close(got: dict, want: dict) -> None:
    """A port device batch (CPU tensors) against the JAX package's."""
    assert set(got) == set(want) == {"grd", "sat", "gt", "bin_weights", "orientation"}
    for key in want:
        a, b = got[key].numpy(), np.asarray(want[key])
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, (key, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=0, err_msg=key,
                                   atol=HEATMAP_ATOL if key == "gt" else ATOL)
