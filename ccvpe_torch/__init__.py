"""PyTorch / CUDA port of the CCVPE cross-view pose estimator.

A second package beside ``ccvpe_tpu`` (the JAX reference it is tested
against).  It imports ``torch`` and numpy only.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; without a GPU they raise
instead of falling back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is absent); else the device asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ccvpe_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
