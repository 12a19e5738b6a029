"""VIGOR dataset: index parsing, host sample loading, device batch assembly
(a copy of ``ccvpe_tpu/data/vigor.py`` with the port's ``device_batch``).

Mirrors ``VIGORDataset`` (reference ``datasets.py:18-177``) with the
host/device split of this package: txt parsing + JPEG decode + PIL resize
on the host; normalisation, panorama rolling, and the Gaussian/binned GT
synthesis on the device (``data.transforms``, ``ops.gt``).  The per-sample
draws (satellite pick, then rotation) come in the JAX package's order from
the same counter-based generator, so the host batches are bit-identical.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from . import transforms

CITY_LISTS = {
    # reference ``datasets.py:32-38``
    ("samearea", True): ["NewYork", "Seattle", "SanFrancisco", "Chicago"],
    ("samearea", False): ["NewYork", "Seattle", "SanFrancisco", "Chicago"],
    ("crossarea", True): ["NewYork", "Seattle"],
    ("crossarea", False): ["SanFrancisco", "Chicago"],
}

GRD_HW = (320, 640)   # ``train_VIGOR.py:57-62``
SAT_HW = (512, 512)   # ``train_VIGOR.py:64-70``
BINS = 20


@dataclass
class VigorIndex:
    """Parsed split: ground panoramas, their 4 (semi-)positive satellite
    references, and pixel deltas (reference ``datasets.py:40-93``)."""

    root: str
    split: str
    train: bool
    grd_paths: np.ndarray      # [N] str
    labels: np.ndarray         # [N, 4] int  (satellite indices)
    deltas: np.ndarray         # [N, 4, 2] float (row, col offsets, raw px)
    sat_paths: np.ndarray      # [M] str
    cities: np.ndarray         # [N] str

    @classmethod
    def load(cls, root: str, split: str = "samearea", train: bool = True,
             label_root: str = "splits_new"):
        city_list = CITY_LISTS[(split, train)]
        sat_paths, sat_index = [], {}
        for city in city_list:
            fname = os.path.join(root, label_root, city, "satellite_list.txt")
            with open(fname) as f:
                for line in f:
                    name = line.strip()
                    if not name:
                        continue
                    sat_index[name] = len(sat_paths)
                    sat_paths.append(os.path.join(root, city, "satellite",
                                                  name))
        grd_paths, labels, deltas, cities = [], [], [], []
        for city in city_list:
            if split == "samearea":
                base = ("same_area_balanced_train.txt" if train
                        else "same_area_balanced_test.txt")
            else:
                base = "pano_label_balanced.txt"
            fname = os.path.join(root, label_root, city, base)
            with open(fname) as f:
                for line in f:
                    data = np.array(line.split(" "))
                    labels.append([sat_index[data[i]] for i in (1, 4, 7, 10)])
                    deltas.append(np.array(
                        [data[2:4], data[5:7], data[8:10], data[11:13]],
                        dtype=float))
                    grd_paths.append(os.path.join(root, city, "panorama",
                                                  data[0]))
                    cities.append(city)
        return cls(root, split, train, np.array(grd_paths),
                   np.array(labels, np.int64), np.array(deltas),
                   np.array(sat_paths), np.array(cities))

    def __len__(self):
        return len(self.grd_paths)


class VigorSampler:
    """Host-side per-sample loader producing uint8 images + scalar metadata;
    everything array-math moves to the device batch step."""

    def __init__(self, index: VigorIndex, *, pos_only: bool = True,
                 ori_noise: float = 180.0, random_orientation=None,
                 grd_hw=GRD_HW, sat_hw=SAT_HW, seed: int = 0,
                 grd_cache=None, sat_cache=None):
        self.index = index
        self.pos_only = pos_only
        self.ori_noise = ori_noise
        self.random_orientation = random_orientation
        self.grd_hw = grd_hw
        self.sat_hw = sat_hw
        self.seed = seed
        self.epoch = 0
        # optional preprocessed-array caches (data/cache.py): decode-free
        # streaming keyed by ground index / satellite-list index
        self.grd_cache = grd_cache
        self.sat_cache = sat_cache

    def set_epoch(self, epoch: int):
        """Advance the per-epoch randomness stream (fresh augmentation draws
        each epoch, like the reference's global-rng redraws)."""
        self.epoch = int(epoch)

    def _rng(self, idx: int) -> np.random.Generator:
        """Counter-based per-sample stream: a pure function of
        (seed, epoch, idx), so draws are identical no matter which process
        fetches the sample or in what order — the property that makes
        multi-host training reproduce the single-process run (a shared
        sequential rng hands sample i different noise on every host
        because each host only fetches its stride of the epoch)."""
        return np.random.default_rng((self.seed, self.epoch, int(idx)))

    def _rotation(self, idx: int, rng) -> float:
        # reference ``datasets.py:108-116``
        if self.random_orientation is not None:
            return float(self.random_orientation[idx]) / 360.0
        if self.ori_noise >= 180:
            return float(rng.uniform(0.0, 1.0))
        r = self.ori_noise / 360.0
        return float(rng.uniform(-r, r))

    def _pick_satellite(self, idx: int, rng):
        # reference ``datasets.py:123-133``
        if self.pos_only:
            pos = 0
        else:
            while True:
                pos = int(rng.integers(0, 4))
                row, col = self.index.deltas[idx, pos]
                if abs(row) < 320 and abs(col) < 320:
                    break
        return pos

    # Two-phase protocol (``pipeline.Loader`` batched native decode): phase 1
    # consumes all per-sample randomness and names the images to decode;
    # phase 2 builds the sample from images decoded elsewhere (the C++
    # thread pool decodes a whole batch in one call, no per-image Python).
    def plan(self, idx: int) -> dict:
        """Cheap, serial phase: RNG draws + image requests.

        RNG order per sample matches ``__call__`` (satellite pick, then
        rotation, reference ``datasets.py:108-133``)."""
        idx = int(idx)
        rng = self._rng(idx)
        pos = self._pick_satellite(idx, rng)
        rotation = self._rotation(idx, rng)
        sat_idx = int(self.index.labels[idx, pos])
        requests = {}
        if self.grd_cache is None:
            requests["grd"] = (str(self.index.grd_paths[idx]), self.grd_hw)
        if self.sat_cache is None:
            requests["sat"] = (str(self.index.sat_paths[sat_idx]),
                               self.sat_hw)
        return {"idx": idx, "pos": pos, "sat_idx": sat_idx,
                "rotation": rotation, "requests": requests}

    def assemble(self, plan: dict, images: dict) -> dict:
        """Build the sample from decoded images.

        ``images``: request key -> (uint8 image, status, raw (h, w));
        status != 0 applies the reference's blank-image fallback
        (``datasets.py:100-105``)."""
        idx, pos, sat_idx = plan["idx"], plan["pos"], plan["sat_idx"]
        if self.grd_cache is not None:
            grd = np.asarray(self.grd_cache[idx])
        else:
            grd, status, _ = images["grd"]
            if status != 0:
                grd = np.zeros((*self.grd_hw, 3), np.uint8)
        if self.sat_cache is not None:
            sat = np.asarray(self.sat_cache[sat_idx])
            width_raw, height_raw = self.sat_cache.meta["raw_sizes"][sat_idx]
        else:
            sat, status, raw_hw = images["sat"]
            if status != 0:  # unreadable satellite: keep offsets unscaled
                sat = np.zeros((*self.sat_hw, 3), np.uint8)
                raw_hw = self.sat_hw
            height_raw, width_raw = raw_hw
        row_offset, col_offset = self.index.deltas[idx, pos]
        # rescale offsets to model resolution (reference ``datasets.py:140-141``)
        row_offset = np.round(row_offset / height_raw * self.sat_hw[0])
        col_offset = np.round(col_offset / width_raw * self.sat_hw[1])
        return {
            "grd": grd, "sat": sat,
            "rotation": np.float32(plan["rotation"]),
            "angle": np.float32(plan["rotation"] * 360.0),
            "row_offset": np.float32(row_offset),
            "col_offset": np.float32(col_offset),
            "city": self.index.cities[idx],
        }

    def __call__(self, idx: int) -> dict:
        plan = self.plan(idx)
        images = {}
        for key, (path, hw) in plan["requests"].items():
            if key == "sat":
                try:
                    from PIL import Image
                    with Image.open(path) as im:
                        width_raw, height_raw = im.size
                    images[key] = (transforms.load_image(path, hw), 0,
                                   (height_raw, width_raw))
                except Exception:
                    # unreadable satellite: blank fallback with unscaled
                    # offsets, matching assemble()'s native-path handling
                    # and the reference (datasets.py:100-105) — one bad
                    # file must not abort the epoch from a worker thread
                    images[key] = (np.zeros((*hw, 3), np.uint8), 1, hw)
            else:
                img = transforms.load_image(path, hw, fallback_hw=hw)
                images[key] = (img, 0, img.shape[:2])
        return self.assemble(plan, images)


def device_batch(raw: dict, *, train: bool, sat_hw=SAT_HW, bins=BINS, device=None):
    """A collated host batch -> the train step's batch on ``device``
    (default ``cuda``): normalise, roll the panoramas, synthesise the GT
    (counter-clockwise bins)."""
    return transforms.assemble_device_batch(raw, sat_hw=sat_hw, bins=bins,
                                            clockwise=False, roll=True, device=device)
