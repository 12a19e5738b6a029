"""Plain PyTorch reference of CCVPE's training objective and optimizer:
ground-truth synthesis, the weighted infoNCE, cross-entropy and orientation
losses (tudelft-iv/CCVPE ``losses.py``, ``train_VIGOR.py``), and Adam as
``torch.optim.Adam`` defines it.  Imports nothing of the measured program.

The GT of a sample is a Gaussian of std 4 px around the camera's position
on an endpoint-inclusive ``linspace`` grid (x shifted by +col_offset, y by
-row_offset), its heading split linearly between the two nearest of the
counter-clockwise bins ``(B - idx) % B`` and ``(B - idx - 1) % B``, and a
constant (cos, sin) field.  Each matching volume's label is the binned GT
max-pooled by 2^k; max-pooling commutes with the product by the
non-negative bin weights, so the label is pool(gaussian) x weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SIGMA = 4.0
POSITIVE_THRESHOLD = 1e-2
TEMPERATURE = 0.1
POOL_EXPONENTS = (6, 5, 4, 3, 2, 1)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def _grid(n: int, device) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.float64, device=device)
    return (i * (n / (n - 1)) - n / 2).to(torch.float32)


def ground_truth(row_offset, col_offset, angle_deg, height: int, width: int, bins: int):
    """Offsets and angles [B] -> (gaussian [B,H,W], bin weights [B,bins],
    orientation [B,H,W,2])."""
    dev = row_offset.device
    x = _grid(width, dev) + col_offset[:, None]
    y = _grid(height, dev) - row_offset[:, None]
    gauss = torch.exp(-(x.square()[:, None, :] + y.square()[:, :, None]) / (2 * SIGMA * SIGMA))
    step = 360.0 / bins
    idx = torch.floor(angle_deg / step).long()
    ratio = ((angle_deg % step) / step)[:, None]
    a, b = (bins - idx) % bins, (bins - idx - 1) % bins
    weights = F.one_hot(a, bins).float() * (1 - ratio) + F.one_hot(b, bins).float() * ratio
    rad = angle_deg * math.pi / 180.0
    cs = torch.stack([torch.cos(rad), torch.sin(rad)], dim=-1)
    orientation = cs[:, None, None, :].expand(-1, height, width, 2)
    return gauss, weights, orientation


def info_nce(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    s = scores / TEMPERATURE
    log_prob = s - torch.logsumexp(s, dim=1, keepdim=True)
    w = torch.where(labels > POSITIVE_THRESHOLD, labels, torch.zeros_like(labels))
    return -(log_prob * w).sum() / w.sum()


def total_loss(out, gauss, weights, orientation, weight_info_nce: float, weight_ori: float):
    """(loss, ce, info_nce, ori) of the model's outputs (``cvm.Outputs``)."""
    b = gauss.shape[0]
    g4 = gauss[..., None]
    flat = g4.reshape(b, -1)
    ce = -(flat / flat.sum(dim=1, keepdim=True) * torch.log_softmax(out.logits, dim=1)).sum() / b
    ori = ((orientation - out.ori).square().sum(dim=-1, keepdim=True) * g4).sum() / b
    w = weights[:, None, None, :]
    nces = []
    for stack, k in zip(out.scores, POOL_EXPONENTS):
        pooled = F.max_pool2d(g4.permute(0, 3, 1, 2), 2 ** k).permute(0, 2, 3, 1)
        nces.append(info_nce(stack.reshape(b, -1), (pooled * w).reshape(b, -1)))
    nce = sum(nces) / len(nces)
    return ce + weight_info_nce * nce + weight_ori * ori, ce, nce, ori


@torch.no_grad()
def adam_step(params: dict, grads: dict, state: dict, step: int, lr: float) -> None:
    """One ``torch.optim.Adam`` update (betas 0.9, 0.999; eps 1e-8) of
    ``params`` in place; ``state`` holds each key's moments."""
    b1, b2 = ADAM_BETAS
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for k, g in grads.items():
        m, v = state.setdefault(k, (torch.zeros_like(g), torch.zeros_like(g)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = v.sqrt() / math.sqrt(bc2) + ADAM_EPS
        params[k].addcdiv_(m, denom, value=-lr / bc1)
