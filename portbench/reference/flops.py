"""The work of the model and of its two matching kernels, from shapes alone.

``forward_flops`` and ``train_flops`` count the floating-point operations
of the plain reference (``cvm.forward``, and with it the losses and the
backward) with ``torch.utils.flop_counter.FlopCounterMode`` on the meta
device: the same count whatever implements the model, and no arithmetic
is run.  ``matching_launches`` lists the launches of kernel K1 (scores,
max over bins and the normalised map from one read of x; wherever the
ground descriptor is as wide as the map, Cg == Cs) and K2 (scores alone)
that one forward makes, with the bytes they must move (each input read
once, each output written once) and the operations they must do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import cvm, train


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                         _dilation, transposed, _output_padding, _groups, output_mask,
                         out_shape=None, **kwargs) -> int:
    """Each gradient of a convolution (the input's, the weight's) costs what
    its forward costs: 2 x the weight's elements (of one group's width) x the
    batch x the positions on the convolution's output side.  torch's own
    formula leaves the groups out, counting a depthwise convolution's
    backward as if it were dense."""
    positions = math.prod(x_shape[2:] if transposed else grad_out_shape[2:])
    forward = 2 * math.prod(w_shape) * grad_out_shape[0] * positions
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def counter() -> FlopCounterMode:
    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})


def _meta_params(arch: cvm.Arch, grad: bool) -> dict:
    out = {}
    for k, shape in cvm.param_shapes(arch).items():
        dtype = torch.int64 if k.endswith("num_batches_tracked") else torch.float32
        t = torch.empty(shape, dtype=dtype, device="meta")
        trainable = dtype == torch.float32 and "running_" not in k and "._fc." not in k
        out[k] = t.requires_grad_(grad and trainable)
    return out


def _meta_images(arch: cvm.Arch, batch: int):
    return (torch.empty((batch, 3, *arch.grd_hw), device="meta"),
            torch.empty((batch, 3, *arch.sat_hw), device="meta"))


def forward_flops(arch: cvm.Arch, batch: int, loc_offsets=None) -> int:
    """Operations of one eval forward at ``batch``."""
    p = _meta_params(arch, False)
    grd, sat = _meta_images(arch, batch)
    with counter() as count, torch.no_grad():
        cvm.forward(p, arch, grd, sat, loc_offsets=loc_offsets)
    return count.get_total_flops()


def train_flops(arch: cvm.Arch, batch: int, weight_info_nce: float = 1e4,
                weight_ori: float = 1e1) -> int:
    """Operations of one training step's forward, losses and backward at
    ``batch`` (BatchNorm on batch statistics, nothing recomputed)."""
    p = _meta_params(arch, True)
    grd, sat = _meta_images(arch, batch)
    h, w = arch.sat_hw
    gauss = torch.empty((batch, h, w), device="meta")
    weights = torch.empty((batch, arch.bins), device="meta")
    orientation = torch.empty((batch, h, w, 2), device="meta")
    leaves = [t for t in p.values() if t.requires_grad]
    with counter() as count:
        out = cvm.forward(p, arch, grd, sat, mode=cvm.Mode("train"))
        loss = train.total_loss(out, gauss, weights, orientation, weight_info_nce, weight_ori)[0]
        torch.autograd.grad(loss, leaves)
    return count.get_total_flops()


class Launch(NamedTuple):
    kernel: str        # 'K1' or 'K2'
    x: tuple           # [B, H, W, Cs]
    cg: int
    bins: int
    bytes: int         # float32: x, g and the outputs, each once
    flops: int


def matching_launches(arch: cvm.Arch, batch: int, loc_offsets=None) -> list[Launch]:
    """The K1 and K2 launches of one forward, scale by scale (and the
    full-bin bottleneck stack when an orientation prior narrows the bins)."""
    bins = arch.bins if loc_offsets is None else len(tuple(loc_offsets))
    side_h, side_w = arch.sat_hw[0] // 64, arch.sat_hw[1] // 64
    out = []
    for s in range(cvm.N_SCALES):
        cs = arch.sat_desc_dim if s == 0 else arch.loc_conv_ch[s - 1]
        cg = arch.grd_desc_ch[s] * arch.grd_feat_hw[1]
        x = (batch, side_h << s, side_w << s, cs)
        out.append(launch("K1" if cg == cs else "K2", x, cg, bins))
        if s == 0 and bins != arch.bins:
            out.append(launch("K2", x, cg, arch.bins))
    return out


def launch(kernel: str, x: tuple, cg: int, bins: int) -> Launch:
    b, h, w, cs = x
    pixels = b * h * w
    if kernel == "K1":
        out_elems = pixels * (cs + bins + 1)          # xnorm, scores, max
        flops = pixels * cs * (2 * bins + 3)          # products, squares, division
    else:
        out_elems = pixels * bins
        # products; squares, masked per bin where the window is narrower
        flops = pixels * cs * (2 * bins + (2 * bins if cg < cs else 2))
    nbytes = 4 * (pixels * cs + b * cg + out_elems)
    return Launch(kernel, x, cg, bins, nbytes, flops)
