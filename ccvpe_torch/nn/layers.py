"""Core NN layers of the port (counterpart of ``ccvpe_tpu/nn/layers.py``).

Modules take NCHW tensors, as PyTorch's do; the model keeps them in
``channels_last`` memory.  Semantics carried over from the reference:

* TF-style "SAME" pads computed from the *construction-time* 224-px trace,
  not from the runtime input, and possibly asymmetric.  They are applied
  with ``F.pad`` in front of a ``padding=0`` conv.
* Horizontal circular ("wrap") padding then vertical zeros for panoramas.
* BatchNorm with eps 1e-3 and torch's momentum 0.01 (eval mode on the
  inference path).
* ``ConvTranspose2d(k=2, s=2)`` for the decoder's upsampling.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

Pad2d = tuple[tuple[int, int], tuple[int, int]]

NO_PAD: Pad2d = ((0, 0), (0, 0))

BN_EPS = 1e-3
BN_MOMENTUM = 0.01

silu = F.silu


def same_pad(traced_hw: tuple[int, int], kernel: int, stride: int,
             dilation: int = 1) -> Pad2d:
    """TF 'SAME' pad amounts ((top, bottom), (left, right)) for a traced image size."""
    ih, iw = traced_hw
    oh, ow = math.ceil(ih / stride), math.ceil(iw / stride)
    pad_h = max((oh - 1) * stride + (kernel - 1) * dilation + 1 - ih, 0)
    pad_w = max((ow - 1) * stride + (kernel - 1) * dilation + 1 - iw, 0)
    return ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2))


def traced_output_hw(traced_hw: tuple[int, int], stride: int) -> tuple[int, int]:
    """Construction-time image-size bookkeeping of a strided layer."""
    ih, iw = traced_hw
    return (math.ceil(ih / stride), math.ceil(iw / stride))


def pad2d(x: torch.Tensor, pad: Pad2d, circular: bool = False) -> torch.Tensor:
    """Pad an NCHW tensor; horizontal wrap first, then vertical zeros, when
    ``circular``."""
    (pt, pb), (pl, pr) = pad
    if circular and (pl or pr):
        x = torch.cat([x[..., x.shape[-1] - pl:], x, x[..., :pr]], dim=-1)
        pl = pr = 0
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb))
    return x


class ConvSpec(NamedTuple):
    """Static configuration of one conv layer (shapes and pads are build-time)."""

    cin: int
    cout: int
    kernel: int
    stride: int = 1
    groups: int = 1
    bias: bool = False
    pad: Pad2d = NO_PAD
    circular: bool = False


class StaticPadConv2d(nn.Conv2d):
    """``nn.Conv2d`` with padding 0 behind a build-time static (TF-SAME,
    optionally circular) pad.  State-dict keys: ``weight`` and ``bias``."""

    def __init__(self, spec: ConvSpec):
        super().__init__(spec.cin, spec.cout, spec.kernel, stride=spec.stride,
                         padding=0, groups=spec.groups, bias=spec.bias)
        self.static_pad = spec.pad
        self.circular = spec.circular

    def forward(self, x: torch.Tensor, circular: bool | None = None) -> torch.Tensor:
        circular = self.circular if circular is None else circular
        return super().forward(pad2d(x, self.static_pad, circular))


def batch_norm(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


def deconv2x2(cin: int, cout: int) -> nn.ConvTranspose2d:
    """Decoder upsampling: ``ConvTranspose2d(k=2, s=2)`` (no output overlap)."""
    return nn.ConvTranspose2d(cin, cout, 2, stride=2)


def l2_normalize(x: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) along ``dim`` (``F.normalize`` semantics)."""
    return F.normalize(x, p=2.0, dim=dim, eps=eps)


@torch.no_grad()
def calibrate_batch_norm_(module: nn.Module, run: Callable[[], object]) -> nn.Module:
    """Set every BatchNorm's running statistics to the batch statistics of
    one call of ``run`` (a forward pass through ``module``), then leave the
    module in eval mode.

    For runs on random weights: with torch-default init and identity
    statistics the activations shrink about threefold per conv, so the
    backbones' outputs end many orders of magnitude below their inputs and
    the matching sees little but biases.  Calibrated statistics keep every
    layer near unit scale, as trained ones would."""
    bns = [m for m in module.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # cumulative average: after one batch, its statistics
    module.train()
    try:
        run()
    finally:
        for m in bns:
            m.momentum = BN_MOMENTUM
        module.eval()
    return module


@torch.no_grad()
def init_uniform_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded torch-default init: every conv, deconv and linear weight and
    bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (``kaiming_uniform_(a=sqrt(5))``
    for the weight), BatchNorm at identity.  Modules are visited in
    registration order, so one seed gives one set of weights."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            # torch's fan_in: weight.size(1) * receptive field (for a
            # transposed conv that is cout * k * k)
            fan_in = m.weight[0].numel()
            bound = math.sqrt(1.0 / fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module
