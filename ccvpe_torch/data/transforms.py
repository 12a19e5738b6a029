"""Device-side image normalisation (counterpart of
``ccvpe_tpu/data/transforms.py::normalize_images``)."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(x_uint8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> ImageNet-normalised float [B, H, W, 3], on
    the tensor's device."""
    x = x_uint8.to(dtype) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=dtype, device=x.device)
    return (x - mean) / std
