"""Image geometry on the device with PIL's conventions (counterpart of
``ccvpe_tpu/ops/geometry.py``).

The KITTI pipeline aligns each aerial image to the vehicle's heading through
a chain of PIL calls: rotate (nearest) -> affine translate (bilinear) ->
affine translate (bilinear) -> rotate (nearest) -> center crop (reference
``datasets.py:443-464``).  ``data/kitti.py`` runs that chain on the host
with PIL for bit-faithful eval; these are its tensor equivalents, so that
training augmentation runs batched on the card:

* ``Image.transform(AFFINE, (a,b,c,d,e,f))`` maps output pixel (x, y) to
  input (a·(x+½) + b·(y+½) + c, d·(x+½) + e·(y+½) + f).
* NEAREST takes the floor of the continuous coordinate; BILINEAR samples at
  (u−½, v−½) against integer pixel centres, with zero fill.
* ``Image.rotate(angle)`` rotates counter-clockwise about the image centre
  (w/2, h/2).

Images are channels-last, [H, W, C] or a batch [B, H, W, C].  A matrix is six
entries, each a Python float or a float32 tensor of shape [B] (one matrix per
sample), so a batched chain is one gather per warp on per-sample source
coordinates.  Coordinates are float32, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def pil_rotate_matrix(angle_deg: float, hw: tuple[int, int]):
    """The 6-tuple PIL builds for ``Image.rotate(angle)`` (output->input)."""
    h, w = hw
    cx, cy = w / 2.0, h / 2.0
    a = -math.radians(angle_deg)
    cos_a, sin_a = round(math.cos(a), 15), round(math.sin(a), 15)
    # translate center to origin, rotate, translate back
    c = cx - (cos_a * cx + sin_a * cy)
    f = cy - (-sin_a * cx + cos_a * cy)
    return (cos_a, sin_a, c, -sin_a, cos_a, f)


def pil_translate_matrix(dx: float, dy: float):
    """``Image.transform(AFFINE, (1, 0, dx, 0, 1, dy))``: output (x,y) samples
    input (x+dx, y+dy)."""
    return (1.0, 0.0, dx, 0.0, 1.0, dy)


def _input_coords(matrix, out_hw, device):
    """Source coordinates (u, v) of every output pixel: [H, W], or [B, H, W]
    when an entry of the matrix is a [B] tensor."""
    h, w = out_hw
    xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5)[:, None]
    a, b, c, d, e, f = (torch.as_tensor(m, dtype=torch.float32, device=device)[..., None, None]
                        for m in matrix)
    return a * xs + b * ys + c, d * xs + e * ys + f


def warp_affine(img: torch.Tensor, matrix, out_hw=None, method: str = "bilinear"):
    """Warp [H, W, C] or [B, H, W, C] by a PIL-convention affine matrix."""
    in_h, in_w = img.shape[-3:-1]
    out_hw = out_hw or (in_h, in_w)
    u, v = _input_coords(matrix, out_hw, img.device)
    imgf = img.to(torch.float32)
    if img.dim() == 4:
        u, v = u.expand(img.shape[0], *out_hw), v.expand(img.shape[0], *out_hw)
        batch = torch.arange(img.shape[0], device=img.device)[:, None, None]

        def take(yi, xi):
            return imgf[batch, yi, xi]
    else:
        def take(yi, xi):
            return imgf[yi, xi]

    if method == "nearest":
        xi = torch.floor(u).long()
        yi = torch.floor(v).long()
        valid = (u >= 0) & (xi < in_w) & (v >= 0) & (yi < in_h)
        out = take(yi.clamp(0, in_h - 1), xi.clamp(0, in_w - 1))
        out = torch.where(valid[..., None], out, 0.0)
    elif method == "bilinear":
        uu = u - 0.5
        vv = v - 0.5
        x0 = torch.floor(uu).long()
        y0 = torch.floor(vv).long()
        wx = (uu - x0)[..., None]
        wy = (vv - y0)[..., None]

        def tap(yi, xi):
            # PIL clamps partial border neighbours to the edge pixel
            return take(yi.clamp(0, in_h - 1), xi.clamp(0, in_w - 1))

        out = (tap(y0, x0) * (1 - wx) * (1 - wy)
               + tap(y0, x0 + 1) * wx * (1 - wy)
               + tap(y0 + 1, x0) * (1 - wx) * wy
               + tap(y0 + 1, x0 + 1) * wx * wy)
        # PIL's generic transform fills the whole pixel when the *centre*
        # coordinate falls outside the input
        inside = (u >= 0) & (u < in_w) & (v >= 0) & (v < in_h)
        out = torch.where(inside[..., None], out, 0.0)
    else:
        raise ValueError(method)
    if not img.dtype.is_floating_point:
        # PIL truncates when storing back to uint8
        out = torch.clamp(torch.floor(out), 0, 255)
    return out.to(img.dtype)


def rotate_matrix_traced(angle_deg: torch.Tensor, hw: tuple[int, int]):
    """``pil_rotate_matrix`` for a float32 tensor of angles ([B] or 0-d),
    computed in float32 (without PIL's round-to-15-decimals of the trig
    terms)."""
    h, w = hw
    cx, cy = w / 2.0, h / 2.0
    a = -angle_deg * math.pi / 180.0
    cos_a, sin_a = torch.cos(a), torch.sin(a)
    c = cx - (cos_a * cx + sin_a * cy)
    f = cy - (-sin_a * cx + cos_a * cy)
    return (cos_a, sin_a, c, -sin_a, cos_a, f)


def translate_matrix_traced(dx, dy):
    return (1.0, 0.0, dx, 0.0, 1.0, dy)


def center_crop(img: torch.Tensor, side: int) -> torch.Tensor:
    """torchvision ``TF.center_crop`` of [..., H, W, C] (reference
    ``datasets.py:464``): the offset is ``int(round((h - side) / 2))``
    (banker's rounding, not floor, which moves the crop one pixel when
    ``(h - side) % 4 == 3``), and a crop larger than the image zero-pads
    symmetrically, the smaller half first."""
    h, w = img.shape[-3:-1]
    if side > h or side > w:
        ph, pw = max(side - h, 0), max(side - w, 0)
        img = F.pad(img, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        h, w = img.shape[-3:-1]
    top = int(round((h - side) / 2))
    left = int(round((w - side) / 2))
    return img[..., top:top + side, left:left + side, :]


def kitti_alignment_chain_batched(sat: torch.Tensor, heading: torch.Tensor, mpp: float,
                                  camera_shift, shift_x: torch.Tensor, shift_y: torch.Tensor,
                                  random_ori: torch.Tensor, side: int = 512) -> torch.Tensor:
    """The KITTI aerial alignment of a batch on its device: sat [B, H, W, 3]
    uint8; per-sample float32 [B] heading (radians), shift_x/shift_y
    (pixels) and random_ori (degrees)."""
    hw = tuple(sat.shape[1:3])
    f32 = dict(dtype=torch.float32, device=sat.device)
    heading, shift_x, shift_y, random_ori = (torch.as_tensor(t, **f32) for t in
                                             (heading, shift_x, shift_y, random_ori))
    x = warp_affine(sat, rotate_matrix_traced(-heading / math.pi * 180, hw), method="nearest")
    x = warp_affine(x, translate_matrix_traced(camera_shift[0] / mpp, camera_shift[1] / mpp),
                    method="bilinear")
    x = warp_affine(x, translate_matrix_traced(shift_x, -shift_y), method="bilinear")
    x = warp_affine(x, rotate_matrix_traced(random_ori, hw), method="nearest")
    return center_crop(x, side)


def kitti_alignment_chain(sat: torch.Tensor, heading: float, mpp: float, camera_shift,
                          shift_px, random_ori: float, side: int = 512) -> torch.Tensor:
    """One image's alignment with Python-float parameters and PIL's exact
    rotation matrices (reference ``datasets.py:443-464``): rotate(-heading)
    [nearest] -> camera-offset translate [bilinear] -> random/test shift
    [bilinear] -> rotate(random_ori) [nearest] -> center crop."""
    hw = tuple(sat.shape[:2])
    x = warp_affine(sat, pil_rotate_matrix(-heading / math.pi * 180, hw), method="nearest")
    x = warp_affine(x, pil_translate_matrix(camera_shift[0] / mpp, camera_shift[1] / mpp),
                    method="bilinear")
    x = warp_affine(x, pil_translate_matrix(shift_px[0], -shift_px[1]), method="bilinear")
    x = warp_affine(x, pil_rotate_matrix(random_ori, hw), method="nearest")
    return center_crop(x, side)
