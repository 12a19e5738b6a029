"""The port stands alone: ``ccvpe_torch`` and ``chip_smoke.py`` import neither
``jax`` nor ``ccvpe_tpu``, and the port's entry points never fall back to the
CPU when no GPU is present."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ccvpe_tpu")


def _sources():
    return sorted((ROOT / "ccvpe_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_no_forbidden_import_in_the_source():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                bad += [(path.name, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                if _forbidden(node.module):
                    bad.append((path.name, node.module))
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ccvpe_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(ccvpe_torch.__path__, 'ccvpe_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15


def test_entry_points_need_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from ccvpe_torch import api, resolve_device
    from ccvpe_torch.models.cvm import NANO
    from ccvpe_torch.train.loop import create_train_state

    with pytest.raises(RuntimeError, match="CUDA"):
        api.load_model(preset="NANO")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(NANO)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert api.load_model(preset="NANO", device="cpu").device == torch.device("cpu")
    state = create_train_state(NANO, device="cpu")
    assert state.model.training
    assert {p.device for p in state.model.parameters()} == {torch.device("cpu")}


def test_native_loader_lives_outside_the_jax_package():
    """The port's C++ decoder is its own copy, built into its own gitignored
    directory: neither its source nor its library is under ``ccvpe_tpu/``."""
    from ccvpe_torch.data import native_loader

    jax_tree = (ROOT / "ccvpe_tpu").resolve()
    assert native_loader.SOURCE == ROOT / "ccvpe_torch" / "csrc" / "dataloader.cc"
    assert native_loader.SOURCE.exists()
    assert native_loader.BUILD_DIR == ROOT / "build" / "ccvpe_torch_native"
    for path in (native_loader.SOURCE, native_loader.BUILD_DIR, native_loader.library_path()):
        assert jax_tree not in path.resolve().parents
    assert native_loader.library_path().parent == native_loader.BUILD_DIR


@pytest.mark.parametrize("module", ["ccvpe_torch.train_VIGOR", "ccvpe_torch.train_KITTI",
                                    "ccvpe_torch.train_OxfordRobotCar", "ccvpe_torch.eval",
                                    "ccvpe_torch.visualize"])
def test_python_m_entry_points_load_no_jax(module):
    """``python -m <module> --help`` as a user runs it: it prints its flags,
    and no jax module is loaded on the way."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{module!r}, '--help']\n"
        "try:\n"
        f"    runpy.run_module({module!r}, run_name='__main__', alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    flag = "--configs" if module.endswith("eval") else "--matching_impl"
    assert "usage:" in proc.stdout and flag in proc.stdout


@pytest.mark.parametrize("module", ["mesh", "zero", "distribute"])
def test_parallel_modules_are_covered_and_load_no_jax(module):
    """``ccvpe_torch/parallel/`` is under the source scan above, and each of
    its modules imports alone without loading jax or the JAX package."""
    assert ROOT / "ccvpe_torch" / "parallel" / f"{module}.py" in _sources()
    code = (f"import ccvpe_torch.parallel.{module}, sys\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", ["visualize", "utils/trace_analysis", "utils/platform"])
def test_new_modules_are_covered_and_load_no_jax(module):
    """The visualizer and the ``utils`` modules are under the source scan
    above, and each imports alone without loading jax or the JAX package;
    ``load_exported`` lives in ``api``, which the scan covers too."""
    assert ROOT / "ccvpe_torch" / f"{module}.py" in _sources()
    name = "ccvpe_torch." + module.replace("/", ".")
    code = (f"import {name}, sys\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
