"""Host image decode and resize, and the device half of batch assembly
(counterpart of ``ccvpe_tpu/data/transforms.py``).

JPEG/PNG decode and the first resize stay on the host's worker threads, so
the host-to-device copy is uint8.  ImageNet normalisation, the panorama
roll and the ground-truth synthesis run on the batch's device.

Conventions kept from the reference training scripts: PIL bilinear resize, ImageNet
mean/std normalisation, and the panorama roll by ``round(rotation * W)``
pixels.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _use_native() -> bool:
    if os.environ.get("CCVPE_NATIVE_LOADER", "0") != "1":
        return False
    from . import native_loader

    return native_loader.available()


def load_image_status(path: str, size_hw: tuple[int, int] | None = None,
                      fallback_hw: tuple[int, int] | None = None,
                      ) -> tuple[np.ndarray, int]:
    """Like ``load_image``, and also whether the decode succeeded (status 0)
    or the blank fallback was used (status 1): cache builds record failures,
    and samplers choose between the fallback and raising on it."""
    if size_hw is not None and _use_native():
        from . import native_loader

        out, status = native_loader.load_batch([path], size_hw, n_threads=1)
        if status[0] == 0:
            return out[0], 0
        return np.zeros((*size_hw, 3), np.uint8), 1
    from PIL import Image

    try:
        img = Image.open(path).convert("RGB")
    except Exception:
        hw = size_hw or fallback_hw or (320, 640)
        return np.zeros((*hw, 3), np.uint8), 1
    if size_hw is not None and img.size != (size_hw[1], size_hw[0]):
        img = img.resize((size_hw[1], size_hw[0]), Image.BILINEAR)
    return np.asarray(img, np.uint8), 0


def load_image(path: str, size_hw: tuple[int, int] | None = None,
               fallback_hw: tuple[int, int] | None = None) -> np.ndarray:
    """Decode to RGB uint8 [H, W, 3], optionally PIL-bilinear resized.

    An unreadable file gives a blank image, as in the reference.  With
    ``CCVPE_NATIVE_LOADER=1`` decode and resize go through the C++ loader
    (``native_loader``: Pillow-exact resampling; its JPEG IDCT may differ
    from PIL's by sub-LSB rounding)."""
    return load_image_status(path, size_hw, fallback_hw)[0]


def imagenet_stats(device, dtype: torch.dtype = torch.float32
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ImageNet (mean, std) per channel, as ``dtype`` tensors on ``device``."""
    return (torch.tensor(IMAGENET_MEAN, dtype=dtype, device=device),
            torch.tensor(IMAGENET_STD, dtype=dtype, device=device))


def normalize_images(x_uint8: torch.Tensor, dtype: torch.dtype = torch.float32,
                     stats: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> ImageNet-normalised float [B, H, W, 3], on
    the tensor's device.  ``stats``: ``imagenet_stats`` made beforehand (a
    CUDA graph's capture can copy nothing from the host); None makes them."""
    x = x_uint8.to(dtype) / 255.0
    mean, std = imagenet_stats(x.device, dtype) if stats is None else stats
    return (x - mean) / std


def roll_panorama(grd: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """Per-sample horizontal roll of [B, H, W, C] by ``round(rotation * W)``
    pixels (rotation [B] in (-1, 1)), as one gather.

    The shift is computed in float32 and rounded half to even, as
    ``jnp.round(rotation * w)`` does: a float64 product would move some of
    the half-way cases."""
    w = grd.shape[2]
    shifts = torch.round(rotation.to(torch.float32) * w).to(torch.int64)
    cols = torch.remainder(torch.arange(w, device=grd.device)[None, :] - shifts[:, None], w)
    index = cols[:, None, :, None].expand(grd.shape)
    return torch.gather(grd, 2, index)


def assemble_device_batch(raw: dict, *, sat_hw, bins: int, clockwise: bool,
                          roll: bool = False, device=None) -> dict:
    """A collated host batch -> the train step's batch on ``device``
    (default ``cuda``): both images ImageNet-normalised, panoramas rolled by
    their rotation when ``roll``, and the factored GT synthesised.  The
    three datasets' ``device_batch`` differ only in the bin convention
    (``clockwise``) and whether the ground image is a panorama.

    Host arrays are copied to the device here; tensors already there (from
    ``pipeline.device_prefetch`` or the KITTI alignment chain) are used as
    they are."""
    from ..ops import gt as gt_ops

    device = resolve_device(device)

    def put(key, dtype=None):
        return torch.as_tensor(raw[key], dtype=dtype, device=device)

    grd = normalize_images(put("grd"))
    if roll:
        grd = roll_panorama(grd, put("rotation", torch.float32))
    sat = normalize_images(put("sat"))
    gt, weights, omap = gt_ops.synthesize_batch_factored(
        put("row_offset", torch.float32), put("col_offset", torch.float32),
        put("angle", torch.float32), height=sat_hw[0], width=sat_hw[1],
        bins=bins, clockwise=clockwise)
    return {"grd": grd, "sat": sat, "gt": gt, "bin_weights": weights,
            "orientation": omap}
