"""KITTI cross-view dataset: file-list parsing, host-side aligned-aerial
augmentation, device GT synthesis (a copy of ``ccvpe_tpu/data/kitti.py``
with the port's ``device_batch`` and ``device_batch_device_aug``).

Mirrors ``SatGrdDataset`` / ``SatGrdDatasetTest`` (reference
``datasets.py:356-638``).  The aerial alignment chain (rotate to heading ->
camera-offset shift -> random/test shift -> random/test rotation -> center
crop) runs with the same PIL calls and resampling modes as the reference so
test-time numbers are bit-faithful; GT heatmap/bin synthesis runs on device
(``ops.gt``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
from PIL import Image

from .. import resolve_device
from . import transforms

# reference ``datasets.py:358-366``
DEFAULT_LAT = 49.015
SATMAP_ZOOM = 18
SAT_PROCESS_SIDELENGTH = 512
SATMAP_DIR = "satmap"
GRDIMAGE_DIR = "raw_data"
OXTS_DIR = "oxts/data"
LEFT_COLOR_CAMERA_DIR = "image_02/data"
CAMERA_GPS_SHIFT_LEFT = (1.08, 0.26)

GRD_HW = (256, 1024)   # ``train_KITTI.py:46-47``
SAT_HW = (512, 512)
BINS = 16


def meter_per_pixel(lat: float = DEFAULT_LAT, zoom: int = SATMAP_ZOOM,
                    scale: float = 1.0) -> float:
    """Web-mercator resolution (reference ``datasets.py:368-372``)."""
    mpp = 156543.03392 * np.cos(lat * np.pi / 180.0) / (2 ** zoom)
    return mpp / 2 / scale


@dataclass
class KittiIndex:
    root: str
    entries: list          # train: file names; test: (name, sx, sy, theta)
    test: bool

    @classmethod
    def load(cls, root: str, list_file: str, test: bool = False):
        with open(list_file) as f:
            lines = [ln.rstrip("\n") for ln in f if ln.strip()]
        if test:
            entries = []
            for ln in lines:
                name, sx, sy, th = ln.split(" ")
                entries.append((name, float(sx), float(sy), float(th)))
        else:
            entries = lines
        return cls(root, entries, test)

    def __len__(self):
        return len(self.entries)


class KittiSampler:
    """Per-sample host loader; train applies random shift/rotation, test
    reads them from the file columns (deterministic eval,
    reference ``datasets.py:540-638``).

    ``device_augment=True`` skips the host PIL warp chain: the sampler
    returns the raw aerial image + alignment scalars, and
    ``device_batch_device_aug`` runs the whole rotate/shift/rotate/crop chain
    batched on the device (``ops.geometry.kitti_alignment_chain_batched``):
    the host then only decodes images.  The host path stays the default for
    bit-faithful eval."""

    def __init__(self, index: KittiIndex, *, shift_range_lat: float = 20.0,
                 shift_range_lon: float = 20.0, rotation_range: float = 10.0,
                 grd_hw=GRD_HW, sat_hw=SAT_HW, seed: int = 0,
                 device_augment: bool = False,
                 grd_cache=None, sat_cache=None):
        self.device_augment = device_augment
        self.index = index
        self.mpp = meter_per_pixel(scale=1)
        self.shift_px_lat = shift_range_lat / self.mpp
        self.shift_px_lon = shift_range_lon / self.mpp
        self.rotation_range = rotation_range
        self.grd_hw = grd_hw
        self.sat_hw = sat_hw
        self.seed = seed
        self.epoch = 0
        # optional preprocessed-array caches (data/cache.py), keyed by entry
        # index: grd at grd_hw; satmaps RAW (uniform release size) since the
        # alignment chain needs full resolution
        self.grd_cache = grd_cache
        self.sat_cache = sat_cache

    def set_epoch(self, epoch: int):
        """Advance the per-epoch randomness stream (fresh shift/rotation
        draws per epoch; see the counter-based rng note in ``plan``)."""
        self.epoch = int(epoch)

    def entry_file_name(self, idx: int) -> str:
        e = self.index.entries[int(idx)]
        return e[0] if self.index.test else e

    def grd_path(self, idx: int) -> str:
        name = self.entry_file_name(idx)
        return os.path.join(self.index.root, GRDIMAGE_DIR, name[:38],
                            LEFT_COLOR_CAMERA_DIR, name[38:].lower())

    def sat_path(self, idx: int) -> str:
        return os.path.join(self.index.root, SATMAP_DIR,
                            self.entry_file_name(idx))

    def _read_oxts(self, file_name: str):
        drive_dir = file_name[:38]
        image_no = file_name[38:]
        oxts = os.path.join(self.index.root, GRDIMAGE_DIR, drive_dir,
                            OXTS_DIR, image_no.lower().replace(".png", ".txt"))
        with open(oxts) as f:
            content = f.readline().split(" ")
        return float(content[0]), float(content[1]), float(content[5])

    # Two-phase protocol (``pipeline.Loader`` batched native decode): both
    # the ground frame (resized) and the raw satmap (decoded at native size)
    # come out of one C++ batch call; the PIL alignment chain (or the
    # device-augment passthrough) runs in ``assemble``.
    def plan(self, idx: int) -> dict:
        idx = int(idx)
        if self.index.test:
            file_name, sx, sy, theta = self.index.entries[idx]
            gt_shift_x, gt_shift_y = -sx, -sy   # ``datasets.py:585-586``
            random_ori = theta * self.rotation_range
        else:
            file_name = self.index.entries[idx]
            # counter-based per-sample stream (see vigor.VigorSampler._rng):
            # fetch-order/process independent -> multi-host == single-host
            rng = np.random.default_rng((self.seed, self.epoch, idx))
            gt_shift_x = float(rng.uniform(-1, 1))
            gt_shift_y = float(rng.uniform(-1, 1))
            random_ori = float(rng.uniform(-1, 1)) * self.rotation_range
        requests = {}
        if self.grd_cache is None:
            requests["grd"] = (self.grd_path(idx), self.grd_hw)
        if self.sat_cache is None:
            sat_path = self.sat_path(idx)
            requests["sat"] = (sat_path, self._sat_raw_hw(sat_path))
        return {"idx": idx, "file_name": file_name,
                "gt_shift_x": gt_shift_x, "gt_shift_y": gt_shift_y,
                "random_ori": random_ori, "requests": requests}

    def _sat_raw_hw(self, sat_path: str) -> tuple[int, int]:
        """Raw satmap size (uniform across the KITTI-CVL release; read once
        from the first file's header).  Native decode at the raw size is a
        pure decode — the alignment chain needs full resolution."""
        if not hasattr(self, "_sat_hw_cache"):
            with Image.open(sat_path) as im:
                self._sat_hw_cache = (im.size[1], im.size[0])
        return self._sat_hw_cache

    def assemble(self, plan: dict, images: dict) -> dict:
        file_name = plan["file_name"]
        gt_shift_x, gt_shift_y = plan["gt_shift_x"], plan["gt_shift_y"]
        random_ori = plan["random_ori"]
        _, _, heading = self._read_oxts(file_name)
        if self.grd_cache is not None:
            grd = np.asarray(self.grd_cache[plan["idx"]])
        else:
            grd, status, _ = images["grd"]
            if status != 0:
                grd = np.zeros((*self.grd_hw, 3), np.uint8)
        if self.sat_cache is not None:
            # keep the direct path's guards: unreadable satmaps raise (the
            # build wrote a blank + recorded the failure), and a satmap
            # whose native size differs from the cache size is re-decoded
            # at full resolution (the alignment chain is scale-sensitive)
            meta = self.sat_cache.meta
            path = meta["paths"][plan["idx"]]
            if path in meta.get("failed", ()):
                raise FileNotFoundError(
                    f"unreadable satmap {file_name} (recorded at cache "
                    f"build; no reference fallback)")
            h, w = meta["hw"]
            if meta["raw_sizes"][plan["idx"]] != [w, h]:
                with Image.open(path) as im:
                    sat_arr = np.asarray(im.convert("RGB"), np.uint8)
            else:
                sat_arr = np.asarray(self.sat_cache[plan["idx"]])
        else:
            sat_arr, sat_status, sat_raw_hw = images["sat"]
            if sat_status != 0:
                raise FileNotFoundError(
                    f"unreadable satmap {file_name} (no reference fallback)")
            if tuple(sat_raw_hw) != sat_arr.shape[:2]:
                # the batched decode targets the cached uniform satmap size;
                # a file whose true size differs was silently resized, which
                # would corrupt the meter-per-pixel alignment chain —
                # re-decode it at its native size (rare; correctness over
                # speed)
                with Image.open(plan["requests"]["sat"][0]) as im:
                    sat_arr = np.asarray(im.convert("RGB"), np.uint8)
        sat_map = Image.fromarray(sat_arr)

        if self.device_augment:
            return self._raw_sample(grd, sat_map, heading, gt_shift_x,
                                    gt_shift_y, random_ori)

        # alignment chain, resampling modes as the reference
        # (``datasets.py:443-464``): rotate (nearest) -> affine (bilinear)
        # -> affine (bilinear) -> rotate (nearest) -> center crop
        sat_rot = sat_map.rotate((-heading) / np.pi * 180)
        sat_align_cam = sat_rot.transform(
            sat_rot.size, Image.AFFINE,
            (1, 0, CAMERA_GPS_SHIFT_LEFT[0] / self.mpp,
             0, 1, CAMERA_GPS_SHIFT_LEFT[1] / self.mpp),
            resample=Image.BILINEAR)
        sat_rand_shift = sat_align_cam.transform(
            sat_align_cam.size, Image.AFFINE,
            (1, 0, gt_shift_x * self.shift_px_lon,
             0, 1, -gt_shift_y * self.shift_px_lat),
            resample=Image.BILINEAR)
        sat_rot2 = sat_rand_shift.rotate(random_ori)
        w, h = sat_rot2.size
        side = self.sat_hw[0]
        left = (w - side) // 2
        top = (h - side) // 2
        sat = np.asarray(
            sat_rot2.crop((left, top, left + side, top + side)), np.uint8)

        # GT offsets + orientation via the single shared back-computation
        # (the device_augment path uses the same helper via _raw_sample —
        # the two paths must not drift on GT scalars)
        x_offset, y_offset, angle = _finalize_scalars(
            gt_shift_x, gt_shift_y, random_ori,
            self.shift_px_lon, self.shift_px_lat)

        return {
            "grd": grd, "sat": sat,
            "angle": np.float32(angle),
            # reference grid convention: x_offset shifts cols, y_offset rows
            # via the same meshgrid signs as VIGOR with row=-y, col=x
            "row_offset": np.float32(-y_offset),
            "col_offset": np.float32(x_offset),
            "orientation_from_north": np.float32(angle),
        }

    def __call__(self, idx: int) -> dict:
        plan = self.plan(idx)
        images = {}
        for key, (path, hw) in plan["requests"].items():
            if key == "sat":  # raw-size decode; unreadable satmap raises
                with Image.open(path) as im:
                    img = np.asarray(im.convert("RGB"), np.uint8)
            else:
                img = transforms.load_image(path, hw, fallback_hw=hw)
            images[key] = (img, 0, img.shape[:2])
        return self.assemble(plan, images)

    def _raw_sample(self, grd, sat_map, heading, gt_shift_x, gt_shift_y,
                    random_ori):
        x_offset, y_offset, angle = _finalize_scalars(
            gt_shift_x, gt_shift_y, random_ori,
            self.shift_px_lon, self.shift_px_lat)
        return {
            "grd": grd,
            "sat_raw": np.asarray(sat_map, np.uint8),
            "heading": np.float32(heading),
            "shift_x_px": np.float32(gt_shift_x * self.shift_px_lon),
            "shift_y_px": np.float32(gt_shift_y * self.shift_px_lat),
            "random_ori": np.float32(random_ori),
            "angle": np.float32(angle),
            "row_offset": np.float32(-y_offset),
            "col_offset": np.float32(x_offset),
            "orientation_from_north": np.float32(angle),
        }


def _finalize_scalars(gt_shift_x, gt_shift_y, random_ori, shift_px_lon,
                      shift_px_lat):
    """GT offsets + orientation angle from the alignment parameters
    (reference ``datasets.py:472-487``)."""
    cos_o = np.cos(random_ori / 180 * np.pi)
    sin_o = np.sin(random_ori / 180 * np.pi)
    x_offset = int(gt_shift_x * shift_px_lon * cos_o
                   - gt_shift_y * shift_px_lat * sin_o)
    y_offset = int(-gt_shift_y * shift_px_lat * cos_o
                   - gt_shift_x * shift_px_lon * sin_o)
    angle = 90.0 - random_ori
    if angle < 0:
        angle += 360
    elif angle > 360:
        angle -= 360
    return x_offset, y_offset, angle


def device_batch_device_aug(raw: dict, *, train: bool, mpp: float,
                            sat_hw=SAT_HW, bins=BINS, device=None):
    """Batch assembly for ``device_augment=True`` samples on ``device``
    (default ``cuda``): the aerial alignment chain runs batched there, then
    the GT synthesis."""
    from ..ops.geometry import kitti_alignment_chain_batched

    device = resolve_device(device)
    sat = kitti_alignment_chain_batched(
        torch.as_tensor(raw["sat_raw"], device=device), raw["heading"], mpp,
        CAMERA_GPS_SHIFT_LEFT, raw["shift_x_px"], raw["shift_y_px"], raw["random_ori"],
        side=sat_hw[0])
    out = dict(raw)
    out["sat"] = sat
    return device_batch(out, train=train, sat_hw=sat_hw, bins=bins, device=device)


def device_batch(raw: dict, *, train: bool, sat_hw=SAT_HW, bins=BINS, device=None):
    """Normalise + synthesise the GT on ``device`` (default ``cuda``;
    counter-clockwise bins, no panorama roll)."""
    return transforms.assemble_device_batch(raw, sat_hw=sat_hw, bins=bins,
                                            clockwise=False, device=device)
