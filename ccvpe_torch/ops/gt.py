"""Ground-truth synthesis on the device (counterpart of ``ccvpe_tpu/ops/gt.py``).

Per sample: a Gaussian heatmap of the camera's position, the interpolation
weights of its heading over the orientation bins, and a dense (cos, sin)
field.  The functions broadcast over leading dimensions of the offsets and
angles, so one call builds a whole batch on the tensors' device, in float32.

Semantics kept from the reference:
* the endpoint-inclusive ``linspace`` grid (step size/(size-1), not 1);
  x is shifted by +col_offset, y by -row_offset;
* VIGOR's and KITTI's counter-clockwise bins ``bins[(B - idx) % B]`` against
  Oxford's clockwise ``bins[idx]``;
* linear interpolation between the two nearest bins.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SIGMA = 4.0


def _grid(n: int, device) -> torch.Tensor:
    """``linspace(-n/2, n/2, n)`` in float32, rounded from float64
    arithmetic, so that every device gives the same grid (a float32
    ``linspace`` may round some points differently on another device)."""
    i = torch.arange(n, dtype=torch.float64, device=device)
    return (i * (n / (n - 1)) - n / 2).to(torch.float32)


def gaussian_heatmap(height: int, width: int, row_offset: torch.Tensor,
                     col_offset: torch.Tensor) -> torch.Tensor:
    """Offsets [...] -> [..., H, W] Gaussians of std ``SIGMA`` px, on the
    offsets' device."""
    dev = row_offset.device
    x = _grid(width, dev) + col_offset[..., None]
    y = _grid(height, dev) - row_offset[..., None]
    d2 = x.square()[..., None, :] + y.square()[..., :, None]
    return torch.exp(-d2 / (2.0 * SIGMA * SIGMA))


def orientation_bin_weights(angle_deg: torch.Tensor, bins: int,
                            clockwise: bool) -> torch.Tensor:
    """Angles [...] in [0, 360) -> [..., bins] interpolation weights.

    counter-clockwise (VIGOR, KITTI): w[(B - idx) % B] = 1 - ratio,
    w[(B - idx - 1) % B] = ratio; clockwise (Oxford): w[idx] = 1 - ratio,
    w[(idx + 1) % B] = ratio."""
    step = 360.0 / bins
    idx = torch.floor(angle_deg / step).long()
    ratio = (angle_deg % step) / step
    if clockwise:
        a, b = idx % bins, (idx + 1) % bins
    else:
        a, b = (bins - idx) % bins, (bins - idx - 1) % bins
    ratio = ratio[..., None]
    return (F.one_hot(a, bins).to(angle_deg.dtype) * (1 - ratio)
            + F.one_hot(b, bins).to(angle_deg.dtype) * ratio)


def orientation_map(height: int, width: int, angle_deg: torch.Tensor) -> torch.Tensor:
    """Angles [...] -> [..., H, W, 2] constant (cos, sin) fields."""
    rad = angle_deg * math.pi / 180.0
    cs = torch.stack([torch.cos(rad), torch.sin(rad)], dim=-1)
    return cs[..., None, None, :].expand(*rad.shape, height, width, 2)


def synthesize_batch(row_offset, col_offset, angle_deg, *, height: int, width: int,
                     bins: int, clockwise: bool = False):
    """Offsets and angles [B] -> (gt [B,H,W,1], gt_with_ori [B,H,W,bins],
    orientation [B,H,W,2]).  The dense binned volume: tests only (training
    takes the factored form)."""
    gt = gaussian_heatmap(height, width, row_offset, col_offset)
    w = orientation_bin_weights(angle_deg, bins, clockwise)
    return (gt[..., None], gt[..., None] * w[:, None, None, :],
            orientation_map(height, width, angle_deg))


def synthesize_batch_factored(row_offset, col_offset, angle_deg, *, height: int,
                              width: int, bins: int, clockwise: bool = False):
    """Offsets and angles [B] -> (gt [B,H,W], bin_weights [B,bins],
    orientation [B,H,W,2]).  The binned GT of a sample is
    ``gt[b] ⊗ bin_weights[b]``; the loss rebuilds its pyramid from the pooled
    Gaussian, so the [B,H,W,bins] volume never exists."""
    return (gaussian_heatmap(height, width, row_offset, col_offset),
            orientation_bin_weights(angle_deg, bins, clockwise),
            orientation_map(height, width, angle_deg))
