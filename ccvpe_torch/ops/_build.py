"""Build and load the port's CUDA kernels (``ccvpe_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  The build happens at first
use, into ``build/ccvpe_torch_kernels/`` beside the package, under a name
that hashes the source and the flags, so an edited source is rebuilt and an
unchanged one is built once.  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ccvpe_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Built(NamedTuple):
    path: Path
    seconds: float   # nvcc wall time; 0.0 when an existing build was reused
    log: str         # nvcc's output (ptxas register and spill report)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from ccvpe_torch/csrc at first use")
    return found


def build(name: str, force: bool = False) -> Built:
    """Compile ``csrc/<name>.cu`` unless an identical build exists (or
    ``force``)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    if out.exists() and not force:
        return Built(out, 0.0, log_path.read_text() if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename: concurrent first uses
    # (several processes) never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src} (exit {proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return Built(out, seconds, log)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build(name).path))
