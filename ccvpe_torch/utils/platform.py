"""Device choice of the entry points (counterpart of
``ccvpe_tpu/utils/platform.py``).

``CCVPE_PLATFORM`` is read here and nowhere else in the port.
``CCVPE_PLATFORM=cpu`` runs a CLI, the service or the visualizer on the
CPU; unset (or ``cuda``/``gpu``) they run on the CUDA device and raise
without one.  JAX pins its backend through ``jax.config`` instead
(``apply_env_platform``); PyTorch has no process-wide backend, so the port
turns the variable into the ``torch.device`` each entry point passes down.

JAX's ``utils/compilation_cache.py`` (XLA's persistent compile cache) has
no counterpart: the port compiles nothing at run time but its ``nvcc``
build of the kernels, which ``ops/_build.py`` already caches on disk.
"""

from __future__ import annotations

import os

import torch


def env_platform() -> str:
    """``CCVPE_PLATFORM``, lower-cased; ``""`` when unset."""
    return os.environ.get("CCVPE_PLATFORM", "").lower()


def env_device() -> torch.device:
    """The device ``CCVPE_PLATFORM`` asks for: ``cpu`` -> the CPU; ``cuda``,
    ``gpu`` or unset -> the CUDA device, which must be there; any other
    value exits naming it."""
    platform = env_platform() or "cuda"
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("cuda", "gpu"):
        raise SystemExit(f"CCVPE_PLATFORM={platform!r}: ccvpe_torch runs on 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("ccvpe_torch's CLIs run on a CUDA device and none is available; "
                           "set CCVPE_PLATFORM=cpu to run on the CPU")
    return torch.device("cuda")
