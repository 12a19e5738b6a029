"""Cells of the benchmark at test size: the manifest's cells with the NANO
preset and short windows, to drive the harness on the CPU."""

from __future__ import annotations

import copy
import dataclasses
import json
import time

import torch

from portbench.lib import harness


def nano_config() -> dict:
    from ccvpe_torch.models import cvm

    arch = {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cvm.NANO).items() if k != "name"}
    precision = {"name": "float32, TF32 off", "tf32": False, "compute_dtype": "float32",
                 "param_dtype": "float32", "quantize": None,
                 "control": {"name": "float32, TF32 on", "tf32": True}}
    return {"name": "nano", "preset": "NANO", "precision": precision, "batch": 2,
            "architecture": arch, "reduced": [], "assumed": []}


SMALL = {"infer": {"batch": 2, "pool": 3, "warmup": 1, "trace_calls": 3, "trace_full_calls": 2},
         "train": {"batch": 2, "pool": 4, "span": 40.0, "warmup": 0, "trace_steps": 2,
                   "trace_full_steps": 1}}


def nano_cell(name: str, **params) -> harness.Cell:
    """The cell ``name`` with the NANO preset, small pools and batches, and
    ``params`` over its traffic parameters."""
    cell = harness.load_cell(name)
    workload = copy.deepcopy(cell.workload)
    workload["params"].update(SMALL[workload["driver"]], **params)
    return dataclasses.replace(cell, config=nano_config(), workload=workload)


def run(cell: harness.Cell, seed: int = 3, seconds: float = 2.0, trace: bool = False,
        control: bool = False) -> tuple[dict, list]:
    ctx = harness.Context(cell, seed, seconds, trace, torch.device("cpu"),
                          time.perf_counter(), harness.precision_of(cell.config, control))
    result, lines = harness.run(ctx)
    json.dumps(result)
    return result, lines
