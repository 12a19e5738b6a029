"""Shared set-up of the data-layer parity tests (``tests/test_torch_data_*.py``):
seeded synthetic dataset roots written once per test module by
``ccvpe_torch.data.synthetic`` (which the JAX package reads as well), and
comparisons of host samples and device batches.

Tolerances of a device batch against the JAX package's, on the CPU:
images, bin weights and orientation fields atol 1e-6; the GT heatmap atol
5e-6, the bound ``tests/test_torch_gt.py`` derives for the same function
(the two grids round some points one ulp apart).
"""

import numpy as np
import pytest

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
