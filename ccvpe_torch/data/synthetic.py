"""Seeded synthetic dataset roots in the reference's on-disk formats.

No real VIGOR, KITTI or Oxford RobotCar data is in the repository, so the
tests and ``chip_smoke.py`` write small roots of their own and drive the
samplers over them.  Every image and number comes from
``numpy.random.default_rng`` on the given seed, so two calls with the same
arguments write the same files in any process.  The image content is
smooth noise (an upsampled coarse grid plus a little fine noise); only the
formats, sizes and file layout follow the datasets.

    write_vigor_root(root)     # splits_new/<city>/..., <city>/{panorama,satellite}/
    write_kitti_root(root)     # satmap/, raw_data/<drive>/{image_02,oxts}/, *_files.txt
    write_oxford_root(root)    # map, frames, training/validation/test*_j.txt, *_yaw.npy
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from . import oxford

VIGOR_CITIES = ("NewYork", "Seattle", "SanFrancisco", "Chicago")
KITTI_DRIVE = "2011_09_26/2011_09_26_drive_0001_sync/"


def _image(seed, hw: tuple[int, int]) -> np.ndarray:
    """A seeded smooth RGB uint8 image [H, W, 3]."""
    rng = np.random.default_rng(seed)
    h, w = hw
    coarse = rng.integers(0, 256, (max(h // 16, 2), max(w // 16, 2), 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR), np.int16)
    img = img + rng.integers(-8, 9, (h, w, 3), dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_image(path: str, seed, hw: tuple[int, int]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(_image(seed, hw)).save(path)


def write_vigor_root(root: str, *, cities=VIGOR_CITIES, panos_per_city: int = 6,
                     sats_per_city: int = 3, pano_hw=(64, 128), sat_hw=(128, 128),
                     pano_ext: str = ".png", span: float = 20.0, seed: int = 0) -> str:
    """A VIGOR root: per city, ``satellite_list.txt`` and the same split
    lines under ``same_area_balanced_{train,test}.txt`` and
    ``pano_label_balanced.txt`` (the cross-area split's file); each
    panorama lists 4 satellites with (row, col) deltas uniform in
    +-``span`` raw pixels.  Satellite tiles are PNG, as in VIGOR."""
    rng = np.random.default_rng(seed)
    for c, city in enumerate(cities):
        sats = [f"s{i}.png" for i in range(sats_per_city)]
        split_dir = os.path.join(root, "splits_new", city)
        os.makedirs(split_dir, exist_ok=True)
        with open(os.path.join(split_dir, "satellite_list.txt"), "w") as f:
            f.write("\n".join(sats) + "\n")
        for i, s in enumerate(sats):
            _write_image(os.path.join(root, city, "satellite", s), (seed, 1, c, i), sat_hw)
        lines = []
        for j in range(panos_per_city):
            pano = f"p{j}{pano_ext}"
            _write_image(os.path.join(root, city, "panorama", pano), (seed, 2, c, j), pano_hw)
            fields = [pano]
            for k in range(4):
                fields += [sats[(j + k) % sats_per_city], str(rng.uniform(-span, span)),
                           str(rng.uniform(-span, span))]
            lines.append(" ".join(fields))
        for base in ("same_area_balanced_train.txt", "same_area_balanced_test.txt",
                     "pano_label_balanced.txt"):
            with open(os.path.join(split_dir, base), "w") as f:
                f.write("\n".join(lines) + "\n")
    return root


def write_kitti_root(root: str, *, n: int = 8, n_test: int = 4, grd_hw=(94, 311),
                     sat_hw=(128, 128), seed: int = 0) -> str:
    """A KITTI root: ``n`` frames of one drive, each with a satmap, a left
    colour camera image (PNG) and an oxts line whose heading is uniform in
    (-pi, pi); ``train_files.txt`` lists all, ``test{1,2}_files.txt`` the
    first ``n_test`` with shift and rotation columns uniform in (-1, 1)."""
    rng = np.random.default_rng(seed)
    names = []
    for i in range(n):
        name = KITTI_DRIVE + f"{i:010d}.png"
        names.append(name)
        _write_image(os.path.join(root, "satmap", name), (seed, 1, i), sat_hw)
        _write_image(os.path.join(root, "raw_data", KITTI_DRIVE, "image_02/data",
                                  f"{i:010d}.png"), (seed, 2, i), grd_hw)
        oxts = os.path.join(root, "raw_data", KITTI_DRIVE, "oxts/data", f"{i:010d}.txt")
        os.makedirs(os.path.dirname(oxts), exist_ok=True)
        with open(oxts, "w") as f:
            f.write(f"49.01 8.43 112.9 0.0 0.0 {rng.uniform(-np.pi, np.pi)} "
                    + "0.0 " * 24 + "\n")
    with open(os.path.join(root, "train_files.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    for t in ("test1_files.txt", "test2_files.txt"):
        cols = rng.uniform(-1, 1, (n_test, 3))
        with open(os.path.join(root, t), "w") as f:
            f.write("\n".join(f"{m} {a} {b} {c}" for m, (a, b, c) in zip(names, cols)) + "\n")
    return root


def _pixel_to_utm():
    """The inverse of ``oxford.utm_to_pixel_transform``: a least-squares
    affine from the same control points."""
    pad = lambda x: np.hstack([x, np.ones((x.shape[0], 1))])
    a, *_ = np.linalg.lstsq(pad(oxford._SECONDARY), pad(oxford._PRIMARY), rcond=None)
    return lambda x: (pad(np.atleast_2d(x)) @ a)[:, :-1]


def write_oxford_root(root: str, *, n: int = 8, map_hw=(2400, 2400), grd_hw=(77, 115),
                      test_frames: int = 2, seed: int = 0) -> str:
    """An Oxford RobotCar root (``root`` ends with ``/``, as the reference's
    loaders expect): one stitched aerial map ``satellite_map_new.png``,
    ``n`` ground frames whose UTM positions fall inside the map at least
    700 px from its edge, ``training.txt``/``validation.txt`` over all of
    them, ``test{1,2,3}_j.txt`` over ``test_frames`` consecutive frames each
    (``3 * test_frames <= n``), and the yaw files."""
    rng = np.random.default_rng(seed)
    _write_image(root + "satellite_map_new.png", (seed, 1), map_hw)
    pix = np.stack([rng.uniform(700, map_hw[1] - 700, n),
                    rng.uniform(700, map_hw[0] - 700, n)], axis=1)
    utm = _pixel_to_utm()(pix)
    lines = [f"g{i}.png 0 {float(e)!r} {float(nn)!r}" for i, (e, nn) in enumerate(utm)]
    for split, yaw in (("training.txt", "train_yaw.npy"), ("validation.txt", "val_yaw.npy")):
        with open(root + split, "w") as f:
            f.write("\n".join(lines) + "\n")
        np.save(root + yaw, rng.uniform(0, 2 * np.pi, n))
    for i, t in enumerate(("test1_j.txt", "test2_j.txt", "test3_j.txt")):
        with open(root + t, "w") as f:
            f.write("\n".join(lines[test_frames * i:test_frames * (i + 1)]) + "\n")
    np.save(root + "test_yaw.npy", rng.uniform(0, 2 * np.pi, 3 * test_frames))
    for i in range(n):
        _write_image(root + f"g{i}.png", (seed, 2, i), grd_hw)
    return root
