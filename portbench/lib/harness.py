"""One run of one cell: find its files by name, check the device, hand
the cell to its driver, read the per-layer metrics, and print the result.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Its files:

* ``portbench/configs/<config>.json``: the model configuration (the
  manifest's ``file``): the program's preset, its sizes under
  ``architecture`` (the plain reference is built from them, and the
  program's preset must equal them), ``precision`` (``precision_of``),
  ``batch``, ``reduced`` and ``assumed``.
* ``portbench/workloads/<cell>.json``: ``config``, ``traffic`` (as in the
  manifest), ``driver`` and the driver's parameters, and ``checks``, the
  limit of each number that decides ``correct``.
* ``portbench/drivers/<driver>.py``: ``run(ctx) -> Outcome``.
* ``portbench/metrics/<metric>.py``: ``read(reading) -> float | None``
  for each per-layer metric of the cell.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ccvpe_tpu")
DTYPES = ("float32", "bfloat16")
QUANTIZE = (None, "int8")
# the plain reference's precision, whatever the program's
REFERENCE_PRECISION = {"name": "float32, TF32 off", "tf32": False}


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    workload = json.loads((root / "portbench" / "workloads" / f"{name}.json").read_text())
    if workload["config"] != entry["config"] or workload["traffic"] != entry["traffic"]:
        raise SystemExit(f"portbench/workloads/{name}.json names {workload['config']}/"
                         f"{workload['traffic']}, the manifest {entry['config']}/"
                         f"{entry['traffic']}")
    return Cell(name, entry["chips"], config, workload,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def cache_dirs(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout for every compiler the
    program might use (the port builds its kernels into
    ``build/ccvpe_torch_kernels/`` beside the package itself)."""
    base = root / "build" / "portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def precision_of(config: dict, control: bool = False) -> dict:
    """The precision the program runs in, from the configuration's
    ``precision``: ``name``; ``tf32`` (cuDNN's and cuBLAS's float32 paths
    through TF32); ``compute_dtype`` and ``param_dtype`` (the train step's
    images and resident parameters: ``float32`` or ``bfloat16``; the API
    serves float32 alone); ``quantize`` (None or ``int8``: the API's
    post-training quantization).  With ``control``, the keys of
    ``precision.control`` replace these: the precision below the stated
    one, which the comparison has to fail."""
    prec = {k: v for k, v in config["precision"].items() if k != "control"}
    if control:
        prec.update(config["precision"]["control"])
    if (not isinstance(prec.get("tf32"), bool) or prec.get("compute_dtype") not in DTYPES
            or prec.get("param_dtype") not in DTYPES or prec.get("quantize") not in QUANTIZE):
        raise SystemExit(f"configuration {config['name']}: unknown precision {prec!r}")
    return prec


def set_precision(prec: dict) -> None:
    """cuDNN's and cuBLAS's float32 paths as ``prec`` states them."""
    import torch

    torch.backends.cudnn.allow_tf32 = prec["tf32"]
    torch.backends.cuda.matmul.allow_tf32 = prec["tf32"]


@dataclass
class Context:
    """What a driver gets: the cell, the run's arguments and its device."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    t0: float                      # perf_counter at the process's start
    precision: dict                # precision_of(config), or its control


@dataclass
class Outcome:
    """What a driver returns."""
    e2e: dict                      # end-to-end metric -> value
    attempted: int
    failed: int
    checks: dict                   # name -> (value, limit)
    memory_peak_bytes: int
    trace: object = None           # lib.trace.Trace of the traced slice
    readings: dict = field(default_factory=dict)   # counters and rates for readers
    extra: dict = field(default_factory=dict)      # printed beside the result


def iteration_times(t0: float, ends: list[float]) -> dict:
    """What the untraced window's iterations (calls or steps, each ending
    at ``ends``) took: ``iter_s``, the window's seconds an iteration, which
    the idle share's reader holds the traced device time against, and
    ``iter_ms``, the quartiles, 95th percentile and largest of the single
    iterations (a slow run shows whether all of its iterations or a few
    stalls took the time)."""
    if not ends:
        return {}
    times = sorted(1e3 * (b - a) for a, b in zip([t0] + ends, ends))
    pick = lambda q: times[min(len(times) - 1, int(q * len(times)))]  # noqa: E731
    return {"iter_s": (ends[-1] - t0) / len(ends),
            "iter_ms": [pick(0.25), pick(0.5), pick(0.75), pick(0.95), times[-1]]}


def setup_done(ctx: Context) -> float:
    return time.perf_counter() - ctx.t0


def _reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card() -> dict:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    return {"nvidia_smi": out[0] if out else "not read"}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def checks_pass(checks: dict) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values())


def run(ctx: Context) -> tuple[dict, list[str]]:
    """Run the cell once: (the result object, the lines of compared numbers)."""
    import torch

    from . import trace as trace_lib
    from .peaks import part_of

    driver = importlib.import_module(f"portbench.drivers.{ctx.cell.workload['driver']}")
    out = driver.run(ctx)
    on_gpu = ctx.device.type == "cuda"
    kind = torch.cuda.get_device_name(0) if on_gpu else "cpu"
    units = {m["name"]: m["unit"] for m in ctx.cell.end_to_end + ctx.cell.per_layer}
    metrics = {}
    if ctx.trace:
        reading = {"trace": out.trace, "readings": out.readings, "cell": ctx.cell,
                   "part": part_of(kind)}
        for m in ctx.cell.per_layer:
            value = _reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {k: {"value": v, "unit": units[k]} for k, v in out.e2e.items()
                   if k in units}
    device = {"platform": "gpu" if on_gpu else "cpu", "kind": kind,
              "count": ctx.cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": checks_pass(out.checks) and bool(out.checks),
              "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
              "device": device}
    if ctx.trace and out.trace is not None:
        device["busy_s"] = trace_lib.busy_s(out.trace)
        device["window_s"] = out.trace.window_s
        result["breakdown"] = trace_lib.breakdown(out.trace)
        result["matching_kernels"] = trace_lib.matching_launches(out.trace)
    result["card"] = _card() if on_gpu else {"nvidia_smi": "no card"}
    result["precision"] = ctx.precision["name"]
    result["readings"] = out.readings
    result.update(out.extra)
    # a number that never came (no answer, or not finite) prints as 1e308
    result["checks"] = {k: {"value": v if math.isfinite(v) else 1e308, "limit": lim}
                        for k, (v, lim) in out.checks.items()}
    lines = [f"check {k}: {v!r} (limit {lim!r})" for k, (v, lim) in out.checks.items()]
    return result, lines
