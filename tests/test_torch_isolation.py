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
