"""EfficientNet-B0 (and the reduced NANO backbone) feature extractor, the
counterpart of ``ccvpe_tpu/nn/efficientnet.py``.

* The B0 block table ``r1_k3_s11_e1_i32_o16_se0.25`` ... and NANO's.
* The SE reduce width comes from the block's *declared* input filters,
  which for repeated blocks is the previous block's output filters.
* Static SAME pads computed from the construction-time 224 trace.
* Circular horizontal padding on every conv of the ground panorama encoder
  when enabled; ``forward(x, circular=False)`` turns it off for a cropped
  (limited field of view) panorama.
* Drop-connect on the identity-skip blocks at rate
  ``DROP_CONNECT_RATE * i / n`` (block i of n), only in train mode and only
  when ``forward`` is given a ``torch.Generator`` to draw from.

Module names follow the reference's state_dict keys (``_conv_stem``,
``_bn0``, ``_blocks.N._expand_conv``, ..., ``_conv_head``, ``_bn1``,
``_fc``), including the classifier head ``_fc``, which CCVPE never runs and
which is kept at zero so that ``load_state_dict(strict=True)`` finds every
key.  ``forward`` returns the head features and the list of every block
output (the multiscale skips).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .layers import (
    ConvSpec,
    StaticPadConv2d,
    batch_norm,
    drop_connect_random,
    same_pad,
    silu,
    traced_output_hw,
)


class BlockArgs(NamedTuple):
    num_repeat: int
    kernel: int
    stride: int
    expand: int
    cin: int
    cout: int
    se_ratio: float


B0_BLOCK_ARGS = (
    BlockArgs(1, 3, 1, 1, 32, 16, 0.25),
    BlockArgs(2, 3, 2, 6, 16, 24, 0.25),
    BlockArgs(2, 5, 2, 6, 24, 40, 0.25),
    BlockArgs(3, 3, 2, 6, 40, 80, 0.25),
    BlockArgs(3, 5, 1, 6, 80, 112, 0.25),
    BlockArgs(4, 5, 2, 6, 112, 192, 0.25),
    BlockArgs(1, 3, 1, 6, 192, 320, 0.25),
)

B0_IMAGE_SIZE = 224
DROP_CONNECT_RATE = 0.2

# Reduced 5-block backbone with B0's stride/skip structure, for fast tests
# (not a reference architecture).
NANO_BLOCK_ARGS = (
    BlockArgs(1, 3, 1, 1, 8, 8, 0.25),
    BlockArgs(1, 3, 2, 2, 8, 12, 0.25),
    BlockArgs(1, 3, 2, 2, 12, 16, 0.25),
    BlockArgs(1, 3, 2, 2, 16, 24, 0.25),
    BlockArgs(1, 3, 2, 2, 24, 32, 0.25),
)

# classes of the ImageNet classifier head ``_fc`` (kept only for its keys)
NUM_CLASSES = 1000

# name -> (block table, stem width, head width, construction-time image size)
BACKBONES = {
    "b0": (B0_BLOCK_ARGS, 32, 1280, B0_IMAGE_SIZE),
    "nano": (NANO_BLOCK_ARGS, 8, 256, B0_IMAGE_SIZE),
}


class BlockSpec(NamedTuple):
    expand_conv: ConvSpec | None
    depthwise_conv: ConvSpec
    se_reduce: ConvSpec
    se_expand: ConvSpec
    project_conv: ConvSpec
    id_skip: bool


class BackboneConfig(NamedTuple):
    circular: bool
    stem: ConvSpec
    blocks: tuple[BlockSpec, ...]
    head: ConvSpec


def _block_spec(args: BlockArgs, traced_hw, circular: bool) -> BlockSpec:
    mid = args.cin * args.expand
    expand = None
    if args.expand != 1:
        expand = ConvSpec(args.cin, mid, 1, 1, circular=circular)
    depthwise = ConvSpec(
        mid, mid, args.kernel, args.stride, groups=mid,
        pad=same_pad(traced_hw, args.kernel, args.stride), circular=circular)
    se_ch = max(1, int(args.cin * args.se_ratio))
    se_reduce = ConvSpec(mid, se_ch, 1, bias=True)
    se_expand = ConvSpec(se_ch, mid, 1, bias=True)
    project = ConvSpec(mid, args.cout, 1, circular=circular)
    id_skip = args.stride == 1 and args.cin == args.cout
    return BlockSpec(expand, depthwise, se_reduce, se_expand, project, id_skip)


def backbone_config(name: str, circular: bool = False) -> BackboneConfig:
    """Static backbone spec, tracking the construction-time image size the
    way the reference constructor does."""
    block_args, stem_ch, head_ch, image_size = BACKBONES[name]
    hw = (image_size, image_size)
    stem = ConvSpec(3, stem_ch, 3, 2, pad=same_pad(hw, 3, 2), circular=circular)
    hw = traced_output_hw(hw, 2)
    blocks = []
    for args in block_args:
        blocks.append(_block_spec(args, hw, circular))
        hw = traced_output_hw(hw, args.stride)
        repeat_args = args._replace(cin=args.cout, stride=1)
        for _ in range(args.num_repeat - 1):
            blocks.append(_block_spec(repeat_args, hw, circular))
    head = ConvSpec(block_args[-1].cout, head_ch, 1, circular=circular)
    return BackboneConfig(circular, stem, tuple(blocks), head)


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with squeeze-excite."""

    def __init__(self, spec: BlockSpec):
        super().__init__()
        self.id_skip = spec.id_skip
        if spec.expand_conv is not None:
            self._expand_conv = StaticPadConv2d(spec.expand_conv)
            self._bn0 = batch_norm(spec.expand_conv.cout)
        else:
            self._expand_conv = None
        self._depthwise_conv = StaticPadConv2d(spec.depthwise_conv)
        self._bn1 = batch_norm(spec.depthwise_conv.cout)
        self._se_reduce = StaticPadConv2d(spec.se_reduce)
        self._se_expand = StaticPadConv2d(spec.se_expand)
        self._project_conv = StaticPadConv2d(spec.project_conv)
        self._bn2 = batch_norm(spec.project_conv.cout)

    def forward(self, inputs: torch.Tensor, circular: bool, drop_rate: float = 0.0,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``drop_rate`` applies on an identity-skip block in train mode with
        a ``generator``."""
        x = inputs
        if self._expand_conv is not None:
            x = silu(self._bn0(self._expand_conv(x, circular)))
        x = silu(self._bn1(self._depthwise_conv(x, circular)))
        se = x.mean(dim=(2, 3), keepdim=True)
        se = self._se_expand(silu(self._se_reduce(se)))
        x = torch.sigmoid(se) * x
        x = self._bn2(self._project_conv(x, circular))
        if self.id_skip:
            if self.training and drop_rate and generator is not None:
                x = drop_connect_random(x, drop_rate, generator)
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    """Stem + MBConv blocks + head conv."""

    def __init__(self, name: str = "b0", circular: bool = False):
        super().__init__()
        cfg = backbone_config(name, circular)
        self.circular = circular
        self._conv_stem = StaticPadConv2d(cfg.stem)
        self._bn0 = batch_norm(cfg.stem.cout)
        self._blocks = nn.ModuleList(MBConvBlock(s) for s in cfg.blocks)
        self._conv_head = StaticPadConv2d(cfg.head)
        self._bn1 = batch_norm(cfg.head.cout)
        self._fc = nn.Linear(cfg.head.cout, NUM_CLASSES)
        nn.init.zeros_(self._fc.weight)
        nn.init.zeros_(self._fc.bias)

    def forward(self, x: torch.Tensor, circular: bool | None = None,
                generator: torch.Generator | None = None
                ) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """x [B, 3, H, W] -> (head features [B, C, h, w], block outputs).
        ``generator``: the draws of drop-connect in train mode (None: off)."""
        circular = self.circular if circular is None else circular
        x = silu(self._bn0(self._conv_stem(x, circular)))
        multiscale = []
        n = len(self._blocks)
        for i, block in enumerate(self._blocks):
            x = block(x, circular, DROP_CONNECT_RATE * i / n, generator)
            multiscale.append(x)
        x = silu(self._bn1(self._conv_head(x, circular)))
        return x, multiscale
