"""ctypes bindings for the native C++ data loader
(counterpart of ``ccvpe_tpu/data/native_loader.py``).

Builds ``ccvpe_torch/csrc/dataloader.cc`` with ``g++`` on first use into
``build/ccvpe_torch_native/`` beside the package (gitignored), under a name
that hashes the source and the flags, and exposes:

    load_batch(paths, out_hw, n_threads)  -> (uint8 [N,H,W,3], statuses [N])
    resize_bilinear(img, out_hw)          -> uint8 [H,W,3]

The resampler reproduces Pillow's fixed-point bilinear algorithm
bit-for-bit, so the native path is interchangeable with the PIL path.
``available()`` is False (and ``build_error()`` says why) when the compiler
or libjpeg/libpng are missing.  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "dataloader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ccvpe_torch_native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-ljpeg", "-lpng", "-lpthread")

_lib = None
_build_lock = threading.Lock()
_build_error: str | None = None


def library_path() -> Path:
    """Where the library of the current source and flags is (or will be)."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libccvpe_dataloader_{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    """Compile under a temporary name and rename: concurrent first uses in
    several processes never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, str(SOURCE),
                        *LIBS], check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    with _build_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = library_path()
        if not path.exists():
            try:
                _build(path)
            except (subprocess.CalledProcessError, OSError) as e:
                _build_error = getattr(e, "stderr", None) or str(e)
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _build_error = str(e)
            return None
        lib.ccvpe_load_image.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.c_int]
        lib.ccvpe_load_image.restype = ctypes.c_int
        lib.ccvpe_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.ccvpe_load_batch.restype = None
        lib.ccvpe_load_batch_fast.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.ccvpe_load_batch_fast.restype = None
        lib.ccvpe_resize_bilinear.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
        lib.ccvpe_resize_bilinear.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def load_batch(paths, out_hw: tuple[int, int], n_threads: int = 8,
               return_sizes: bool = False, fast: bool = False):
    """Decode + resize a batch of image files concurrently in C++.

    Returns (batch uint8 [N, H, W, 3], statuses int32 [N]); status != 0 means
    the file was unreadable (the caller applies the blank-image fallback).
    With ``return_sizes`` also returns the pre-resize raw (h, w) per image
    as int32 [N, 2]: the VIGOR sampler rescales the ground-truth offsets by
    the raw satellite size.

    ``fast``: DCT-scaled JPEG decode (decode at the smallest M/8 scale that
    covers ``out_hw``, then Pillow-bilinear down).  2-4x faster on large
    panoramas; near- but not bit-identical to the full-decode path, so for
    training feeds only."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    n = len(paths)
    h, w = out_hw
    out = np.empty((n, h, w, 3), np.uint8)
    statuses = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    if return_sizes or fast:
        raw_hw = np.zeros((n, 2), np.int32)
        lib.ccvpe_load_batch_fast(
            arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
            n_threads, statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            raw_hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            1 if fast else 0)
        return (out, statuses, raw_hw) if return_sizes else (out, statuses)
    lib.ccvpe_load_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        n_threads, statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out, statuses


def resize_bilinear(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Pillow-exact bilinear resize of an RGB uint8 array."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    img = np.ascontiguousarray(img, np.uint8)
    in_h, in_w, c = img.shape
    if c != 3:
        raise ValueError(f"expected an RGB image [H, W, 3], got {img.shape}")
    h, w = out_hw
    out = np.empty((h, w, 3), np.uint8)
    lib.ccvpe_resize_bilinear(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), in_h, in_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w)
    return out
