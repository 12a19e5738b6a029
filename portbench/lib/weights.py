"""Seeded weights in the reference checkpoint's key layout, made on the
device.

Every convolution, transposed convolution and linear weight and bias is
drawn from U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's default init, with
its fan-in of ``weight[0].numel()``) by one ``torch.rand`` call of a
generator on the device; BatchNorm starts at identity and the unused
ImageNet heads ``_fc`` are zero.  Then the BatchNorm statistics are set
from one seeded batch of two uniform-noise pairs, through the plain
reference in its calibrating mode: with identity statistics the random
backbones would shrink their activations to the biases, and the outputs
would not depend on the images.
"""

from __future__ import annotations

import hashlib
import math

import torch

from ..reference import cvm


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``."""
    digest = hashlib.sha256(f"{seed}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _module(key: str) -> str:
    return key.rsplit(".", 1)[0]


def _is_bn(key: str) -> bool:
    return _module(key).rsplit(".", 1)[-1].startswith("_bn")


def make_state_dict(arch: cvm.Arch, seed: int, device) -> dict[str, torch.Tensor]:
    """Weights and calibrated BatchNorm statistics for ``seed``, float32 on
    ``device`` (``num_batches_tracked`` int64)."""
    shapes = cvm.param_shapes(arch)
    drawn = [k for k in shapes if not _is_bn(k) and "._fc." not in k]
    numels = [math.prod(shapes[k]) for k in drawn]
    bounds = [1.0 / math.sqrt(math.prod(shapes[_module(k) + ".weight"][1:])) for k in drawn]
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    u = torch.rand(sum(numels), generator=gen, device=device)
    scale = torch.repeat_interleave(torch.tensor(bounds, device=device),
                                    torch.tensor(numels, device=device))
    flat = (u * 2 - 1) * scale
    sd = {k: t.view(shapes[k]) for k, t in zip(drawn, torch.split(flat, numels))}
    for k, shape in shapes.items():
        if k in sd:
            continue
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.int64, device=device)
        elif k.endswith(("running_var", ".weight")) and "._fc." not in k:
            sd[k] = torch.ones(shape, device=device)
        else:
            sd[k] = torch.zeros(shape, device=device)
    calibrate(sd, arch, seed, device)
    return {k: sd[k] for k in shapes}


@torch.no_grad()
def calibrate(sd: dict, arch: cvm.Arch, seed: int, device) -> None:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "calibration"))
    grd = torch.randint(0, 256, (2, *arch.grd_hw, 3), generator=gen, device=device,
                        dtype=torch.uint8)
    sat = torch.randint(0, 256, (2, *arch.sat_hw, 3), generator=gen, device=device,
                        dtype=torch.uint8)
    cvm.forward(sd, arch, cvm.normalize(grd), cvm.normalize(sat), mode=cvm.Mode("calibrate"))
