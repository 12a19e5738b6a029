"""``ccvpe_torch.utils.platform.env_device``: the one reader of
``CCVPE_PLATFORM`` (as the JAX package's ``utils/platform.py`` is), the
device choice of the CLIs, the service and the visualizer, and the process
group's backend choice through it."""

import pytest
import torch

from ccvpe_torch.parallel import mesh
from ccvpe_torch.train import cli as TCLI
from ccvpe_torch.utils.platform import env_device, env_platform


@pytest.mark.parametrize("value", ["cpu", "CPU"])
def test_cpu(monkeypatch, value):
    monkeypatch.setenv("CCVPE_PLATFORM", value)
    assert env_platform() == "cpu"
    assert env_device() == torch.device("cpu")


@pytest.mark.parametrize("value", [None, "", "cuda", "gpu", "GPU"])
def test_cuda_is_the_default_and_must_be_there(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("CCVPE_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("CCVPE_PLATFORM", value)
    if torch.cuda.is_available():
        assert env_device() == torch.device("cuda")
        return
    with pytest.raises(RuntimeError, match="set CCVPE_PLATFORM=cpu"):
        env_device()


@pytest.mark.parametrize("value", ["tpu", "rocm", "cuda:1"])
def test_other_values_exit_naming_the_value(monkeypatch, value):
    monkeypatch.setenv("CCVPE_PLATFORM", value)
    with pytest.raises(SystemExit, match=f"CCVPE_PLATFORM='{value}'"):
        env_device()


def test_the_process_group_reads_the_same_variable(monkeypatch):
    """``parallel.mesh`` takes gloo on ``CCVPE_PLATFORM=cpu``: it reads the
    variable through ``env_platform``; neither it nor the CLIs keep a
    reader of their own."""
    assert not hasattr(mesh, "_platform")
    assert not hasattr(TCLI, "cli_device")
    monkeypatch.setenv("CCVPE_PLATFORM", "cpu")
    assert mesh.env_platform() == "cpu"
