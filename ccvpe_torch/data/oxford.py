"""Oxford RobotCar dataset: one stitched aerial map, per-frame crops (a
copy of ``ccvpe_tpu/data/oxford.py`` with the port's ``device_batch``).

Mirrors ``OxfordRobotCarDataset`` (reference ``datasets.py:183-353``):
UTM->pixel affine fitted by least squares on the reference's five control
points, random polar-offset 800px crops for training, deterministic
400px-grid-aligned crops for val/test, yaw-convention conversion
(west/CW-radians -> north/CW-degrees), and clockwise 20-bin GT indexing.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
from PIL import Image


from . import transforms

METER_PER_PIXEL = 0.09240351462361521   # ``datasets.py:193``
GRD_HW = (154, 231)                      # ``train_OxfordRobotCar.py:49-54``
SAT_HW = (512, 512)
BINS = 20

# control points (``datasets.py:252-261``)
_PRIMARY = np.array([[619400., 5736195.], [619400., 5734600.],
                     [620795., 5736195.], [620795., 5734600.],
                     [620100., 5735400.]])
_SECONDARY = np.array([[900., 900.], [492., 18168.], [15966., 1260.],
                       [15553., 18528.], [8255., 9688.]])

TEST_TRAVERSALS = ("test1_j.txt", "test2_j.txt", "test3_j.txt")


def utm_to_pixel_transform():
    """Least-squares affine UTM -> stitched-map pixel
    (reference ``datasets.py:263-274``)."""
    pad = lambda x: np.hstack([x, np.ones((x.shape[0], 1))])
    a, *_ = np.linalg.lstsq(pad(_PRIMARY), pad(_SECONDARY), rcond=None)
    return lambda x: (pad(np.atleast_2d(x)) @ a)[:, :-1]


@dataclass
class OxfordIndex:
    grd_image_root: str
    sat_path: str
    split: str
    grd_files: list            # per-frame relative paths
    utm: np.ndarray            # [2, N] easting/northing
    yaw: np.ndarray            # [N] radians (west-referenced, CW)
    traversal_lengths: tuple   # test split only

    @classmethod
    def load(cls, grd_image_root: str, sat_path: str, split: str = "train"):
        lists = {"train": ["training.txt"], "val": ["validation.txt"],
                 "test": list(TEST_TRAVERSALS)}[split]
        yaws = {"train": "train_yaw.npy", "val": "val_yaw.npy",
                "test": "test_yaw.npy"}[split]
        rows, lengths = [], []
        for name in lists:
            n0 = len(rows)
            with open(os.path.join(grd_image_root, name)) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if line:
                        rows.append(line.split(" "))
            lengths.append(len(rows) - n0)
        yaw = np.load(os.path.join(grd_image_root, yaws))
        arr = np.array(rows)
        utm = arr[:, 2:].astype(np.float64).T
        return cls(grd_image_root, sat_path, split,
                   [r[0] for r in rows], utm, yaw, tuple(lengths))

    def __len__(self):
        return len(self.grd_files)


class OxfordSampler:
    def __init__(self, index: OxfordIndex, *, grd_hw=GRD_HW, sat_hw=SAT_HW,
                 seed: int = 0, grd_cache=None):
        self.index = index
        self.grd_hw = grd_hw
        self.sat_hw = sat_hw
        self.transform = utm_to_pixel_transform()
        self.seed = seed
        self.epoch = 0
        # optional preprocessed-array cache of ground frames at grd_hw
        # (data/cache.py); the aerial side is already decode-free (one
        # in-memory map)
        self.grd_cache = grd_cache
        Image.MAX_IMAGE_PIXELS = None
        self._map = Image.open(index.sat_path)
        self._map.load()  # decode once up front; crops are then thread-safe

    def grd_path(self, idx: int) -> str:
        return os.path.join(self.index.grd_image_root,
                            self.index.grd_files[int(idx)])

    def set_epoch(self, epoch: int):
        """Advance the per-epoch randomness stream (fresh crops per epoch)."""
        self.epoch = int(epoch)

    def _train_offsets(self, idx: int):
        # random polar offset <= 200*sqrt(2) px (``datasets.py:290-304``);
        # counter-based per-sample stream (see vigor.VigorSampler._rng):
        # fetch-order/process independent -> multi-host == single-host
        rng = np.random.default_rng((self.seed, self.epoch, int(idx)))
        alpha = 2 * math.pi * rng.random()
        r = 200 * np.sqrt(2) * rng.random()
        return int(r * math.cos(alpha)), int(r * math.sin(alpha))

    def _train_crop(self, image_coord, row_offset, col_offset):
        row = int(image_coord[1] + row_offset)
        col = int(image_coord[0] + col_offset)
        crop = self._map.crop((col - 400, row - 400, col + 400, row + 400))
        ro = int(np.round((400 + row_offset) / 800 * 512 - 256))
        co = int(np.round((400 + col_offset) / 800 * 512 - 256))
        return crop, ro, co

    def _eval_crop(self, image_coord):
        # deterministic 400px-grid-aligned crop (``datasets.py:306-321``)
        col_split = int(image_coord[0] // 400)
        if np.round(image_coord[0] - 400 * col_split) < 200:
            col_split -= 1
        col_pixel = int(np.round(image_coord[0] - 400 * col_split))
        row_split = int(image_coord[1] // 400)
        if np.round(image_coord[1] - 400 * row_split) < 200:
            row_split -= 1
        row_pixel = int(np.round(image_coord[1] - 400 * row_split))
        crop = self._map.crop((col_split * 400, row_split * 400,
                               col_split * 400 + 800, row_split * 400 + 800))
        ro = int(-(row_pixel / 800 * 512 - 256))
        co = int(-(col_pixel / 800 * 512 - 256))
        return crop, ro, co

    def __call__(self, idx: int) -> dict:
        plan = self.plan(idx)
        images = {}
        if "grd" in plan["requests"]:
            path, hw = plan["requests"]["grd"]
            img = transforms.load_image(path, hw, fallback_hw=hw)
            images["grd"] = (img, 0, img.shape[:2])
        return self.assemble(plan, images)

    # Two-phase protocol (``pipeline.Loader`` batched native decode): ground
    # frames decode in the C++ pool; the aerial crop comes from the
    # already-decoded in-memory map in ``assemble``.
    def plan(self, idx: int) -> dict:
        idx = int(idx)
        requests = ({} if self.grd_cache is not None
                    else {"grd": (self.grd_path(idx), self.grd_hw)})
        plan = {"idx": idx, "requests": requests}
        if self.index.split == "train":
            plan["train_offsets"] = self._train_offsets(idx)
        return plan

    def assemble(self, plan: dict, images: dict) -> dict:
        idx = plan["idx"]
        if self.grd_cache is not None:
            grd = np.asarray(self.grd_cache[idx])
        else:
            grd, status, _ = images["grd"]
            if status != 0:
                grd = np.zeros((*self.grd_hw, 3), np.uint8)
        coord = self.transform(self.index.utm[:, idx])[0]
        if self.index.split == "train":
            crop, ro, co = self._train_crop(coord, *plan["train_offsets"])
        else:
            crop, ro, co = self._eval_crop(coord)
        sat = np.asarray(
            crop.convert("RGB").resize((self.sat_hw[1], self.sat_hw[0]),
                                       Image.BILINEAR), np.uint8)
        # yaw: west-referenced CW radians -> north-referenced CW degrees
        # (``datasets.py:334-337``)
        angle = float(self.index.yaw[idx]) / np.pi * 180.0 - 90.0
        if angle < 0:
            angle += 360
        return {
            "grd": grd, "sat": sat,
            "angle": np.float32(angle),
            # Oxford GT grid uses +row_offset on y (``datasets.py:327``),
            # i.e. the VIGOR convention with row = -row_offset_resized
            "row_offset": np.float32(-ro),
            "col_offset": np.float32(co),
            # per-frame heading the reference eval consumes for the
            # lateral/longitudinal decomposition
            # (``orientation_angle``, ``datasets.py:334-337``,
            # ``train_OxfordRobotCar.py:211,228``)
            "orientation_from_north": np.float32(angle),
        }


def device_batch(raw: dict, *, train: bool, sat_hw=SAT_HW, bins=BINS, device=None):
    """Normalise + synthesise the GT on ``device`` (default ``cuda``;
    clockwise bins, datasets.py:330-351)."""
    return transforms.assemble_device_batch(raw, sat_hw=sat_hw, bins=bins,
                                            clockwise=True, device=device)
