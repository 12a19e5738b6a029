"""Preprocessed-array cache: decode + resize once, stream raw uint8 forever
(a copy of ``ccvpe_tpu/data/cache.py``; its lazy imports are the port's
``native_loader`` and ``transforms``).

The reference decodes and resizes every image on every epoch in Python
workers.  JPEG decode is serial per image, so on a host with few cores the
decoder, not the device, bounds training throughput.  This module packs a
split's images into one memory-mapped ``[N, H, W, 3]`` uint8 file (+ JSON
metadata): building it costs one decode pass (threaded, native C++ loader
when available); afterwards samples stream at memory bandwidth.

Usage:
    ArrayCache.build(paths, (320, 640), "cache/grd")   # once
    cache = ArrayCache.open("cache/grd")
    img = cache[i]            # uint8 [H, W, 3] view, zero-copy
"""

from __future__ import annotations

import json
import os

import numpy as np

_MAGIC = "ccvpe-array-cache-v1"


class ArrayCache:
    def __init__(self, data: np.memmap, meta: dict):
        self._data = data
        self.meta = meta

    # -- build ------------------------------------------------------------
    @staticmethod
    def build(paths, hw: tuple[int, int], out_prefix: str,
              n_threads: int = 8, chunk: int = 64,
              progress: bool = False) -> "ArrayCache":
        """Decode + resize ``paths`` into ``{out_prefix}.u8`` /
        ``{out_prefix}.json``.  Unreadable files become blank images
        (reference ``datasets.py:100-105``) and are listed in the metadata."""
        from . import native_loader, transforms

        n = len(paths)
        h, w = hw
        data_path = out_prefix + ".u8"
        os.makedirs(os.path.dirname(os.path.abspath(data_path)), exist_ok=True)
        mm = np.lib.format.open_memmap(
            data_path, mode="w+", dtype=np.uint8, shape=(n, h, w, 3))
        failed = []
        raw_sizes = []
        from PIL import Image
        for p in paths:
            try:
                with Image.open(p) as im:  # header-only read
                    raw_sizes.append(list(im.size))  # (w, h)
            except Exception:
                raw_sizes.append([w, h])
        use_native = native_loader.available()
        for start in range(0, n, chunk):
            batch_paths = list(paths[start:start + chunk])
            if use_native:
                out, status = native_loader.load_batch(batch_paths, hw,
                                                       n_threads)
                mm[start:start + len(batch_paths)] = out
                for j, s in enumerate(status):
                    if s != 0:
                        mm[start + j] = 0
                        failed.append(str(batch_paths[j]))
            else:
                for j, p in enumerate(batch_paths):
                    arr, status = transforms.load_image_status(p, hw)
                    mm[start + j] = arr
                    if status != 0:
                        # record it like the native branch: samplers gate
                        # their blank-vs-raise policy on meta["failed"]
                        failed.append(str(batch_paths[j]))
            if progress and (start // chunk) % 16 == 0:
                print(f"cache {out_prefix}: {start + len(batch_paths)}/{n}")
        mm.flush()
        meta = {"magic": _MAGIC, "n": n, "hw": [h, w],
                "paths": [str(p) for p in paths], "failed": failed,
                "raw_sizes": raw_sizes}
        with open(out_prefix + ".json", "w") as f:
            json.dump(meta, f)
        return ArrayCache.open(out_prefix)

    # -- read -------------------------------------------------------------
    @staticmethod
    def open(out_prefix: str) -> "ArrayCache":
        with open(out_prefix + ".json") as f:
            meta = json.load(f)
        if meta.get("magic") != _MAGIC:
            raise ValueError(f"{out_prefix}: not a ccvpe array cache")
        data = np.load(out_prefix + ".u8", mmap_mode="r")
        if data.shape != (meta["n"], *meta["hw"], 3):
            raise ValueError(f"{out_prefix}: data {data.shape} does not match "
                             f"its metadata")
        return ArrayCache(data, meta)

    @staticmethod
    def exists(out_prefix: str) -> bool:
        """True only for a readable, well-formed cache (corrupt metadata
        counts as absent so callers rebuild instead of crashing)."""
        if not (os.path.exists(out_prefix + ".json")
                and os.path.exists(out_prefix + ".u8")):
            return False
        try:
            with open(out_prefix + ".json") as f:
                return json.load(f).get("magic") == _MAGIC
        except (json.JSONDecodeError, OSError):
            return False

    def __len__(self):
        return self.meta["n"]

    def __getitem__(self, i: int) -> np.ndarray:
        return self._data[i]


def build_or_open(paths, hw: tuple[int, int], prefix: str,
                  n_threads: int = 8, progress: bool = False) -> ArrayCache:
    """Open ``prefix`` if it matches (same path list, same size), else
    (re)build it.  Guards against stale caches silently pairing the wrong
    images with a changed index/split — the recorded path list is the
    cache's identity."""
    paths = [str(p) for p in paths]
    if ArrayCache.exists(prefix):
        cache = ArrayCache.open(prefix)
        if (cache.meta["paths"] == paths
                and tuple(cache.meta["hw"]) == tuple(hw)):
            return cache
        print(f"cache {prefix}: stale (paths or size changed); rebuilding")
    else:
        print(f"building cache {prefix} ({len(paths)} images)...")
    return ArrayCache.build(paths, hw, prefix, n_threads=n_threads,
                            progress=progress)
