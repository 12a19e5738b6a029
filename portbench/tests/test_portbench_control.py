"""The control of each cell, on the card: the program run in the precision
below the one its configuration states (``precision.control`` in the
configuration file, switched on by ``run.py --control``: float32 with TF32
on, where the configuration states TF32 off) must come out not correct, on
three seeds, at the cell's own size.  The benchmark's runs never run it.

    python -m pytest -p no:cacheprovider -m cuda portbench/tests/test_portbench_control.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control runs on an NVIDIA card")


def _run(cell: str, seed: int, *extra: str) -> dict:
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                           "--seed", str(seed), "--seconds", "5", "--trace", "0", *extra],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7001, 7002, 7003])
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell, seed):
    result = _run(cell, seed, "--control")
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7101, 7102, 7103])
def test_half_batch_fault_on_the_card(card, seed, monkeypatch, capsys):
    """The train cell at its own size with half of each batch left out (the
    mean over the rest): its loss gap, the reading that bounds ``loss_rel``
    from above, printed for the record."""
    import time

    import torch

    from portbench.lib import harness
    from portbench.tests.test_portbench_faults import _broken_step

    _broken_step(monkeypatch, "half_batch")
    cell = harness.load_cell("vigor-train-b8")
    ctx = harness.Context(cell, seed, 2.0, False, torch.device("cuda"), time.perf_counter(),
                          harness.precision_of(cell.config))
    result, lines = harness.run(ctx)
    with capsys.disabled():
        print(f"half_batch seed {seed}:", "; ".join(lines))
    assert not result["correct"]
