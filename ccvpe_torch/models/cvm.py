"""The CVM model family (counterpart of ``ccvpe_tpu/models/cvm.py``).

ground EfficientNet-B0 (optionally circular-padded) -> six ground descriptor
heads -> satellite EfficientNet-B0 multiscale -> 2x2-chunk satellite
descriptor grid -> six interleaved matching + Localization-Matching-
Upsampling decoder stages -> softmax heatmap, plus an orientation decoder
that gives a dense (cos, sin) field.

Convolutions run in ``channels_last`` memory, so ``x.permute(0, 2, 3, 1)``
of a feature map is a contiguous NHWC view that the matching kernels read
directly.  ``CVM.forward`` takes and returns NHWC tensors, as the JAX
package does.  Module names follow the reference's state_dict keys, so a
reference-format checkpoint loads with ``load_state_dict(strict=True)``.

Matching goes through ``ops.matching``: on a CUDA tensor, kernel K1 at every
scale where Cg == Cs (all six VIGOR scales) and K2 elsewhere and for the
ori-prior full-bin bottleneck stack; on a CPU tensor, their plain versions.
``matching_impl="plain"`` forces the plain versions on any device.  With
autograd on, the kernels' backward is autograd through the plain versions.

Training uses ``nn.Module.train()``: the BatchNorms normalise with batch
statistics and update their running statistics, and a ``generator`` passed
to ``forward`` turns on drop-connect in both backbones.  ``remat`` chooses
what the backward recomputes instead of keeping (JAX ``forward(...,
remat=)``): the MBConv blocks of both encoders, each decoder stage, or
both.

Under a profiler the forward shows as four spans
(``utils.profiling.annotate``): ``cvm.ground_encoder`` (the ground
EfficientNet and the six descriptor heads), ``cvm.aerial_encoder`` (the
aerial EfficientNet and the descriptor grid), ``cvm.localization_decoder``
(the six matching and upsampling stages and the softmax) and
``cvm.orientation_decoder``.

The forward runs in the inputs' dtype: float32, or bfloat16 with every
weight cast at its op (``nn.layers``); the matching accumulates in float32
and returns the inputs' dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.efficientnet import EfficientNet
from ..nn.layers import (
    Conv2d,
    ConvSpec,
    Linear,
    StaticPadConv2d,
    checkpoint,
    deconv2x2,
    init_uniform_,
    l2_normalize,
)
from ..ops import matching
from ..utils.profiling import annotate

N_SCALES = 6
B0_SKIP_BLOCKS = (15, 10, 4, 2, 0)
B0_SKIP_CH = (320, 112, 40, 24, 16)


@dataclass(frozen=True)
class CVMConfig:
    name: str
    bins: int
    circular: bool                   # ground-encoder horizontal wrap padding
    window: str                      # 'first' | 'center'
    sat_desc_dim: int                # 1280 (VIGOR/Oxford) | 2048 (KITTI)
    grd_desc_ch: tuple[int, ...]     # per-scale 1x1-conv channels
    grd_feat_hw: tuple[int, int]     # ground feature-volume H, W
    shifts: tuple[int, ...]          # per-scale channel roll shift
    loc_deconv_ch: tuple[int, ...]   # 6 deconv output widths (loc branch)
    loc_conv_ch: tuple[int, ...]     # 5 double_conv output widths (loc branch)
    ori_deconv_ch: tuple[int, ...]
    ori_conv_ch: tuple[int, ...]
    grd_hw: tuple[int, int]          # input image sizes
    sat_hw: tuple[int, int]
    backbone: str = "b0"
    feat_dim: int = 1280             # backbone head width
    skip_blocks: tuple[int, ...] = B0_SKIP_BLOCKS
    skip_ch: tuple[int, ...] = B0_SKIP_CH

    @property
    def grd_desc_len(self) -> tuple[int, ...]:
        w = self.grd_feat_hw[1]
        return tuple(c * w for c in self.grd_desc_ch)


VIGOR = CVMConfig(
    name="VIGOR", bins=20, circular=True, window="first", sat_desc_dim=1280,
    grd_desc_ch=(64, 32, 16, 8, 4, 2), grd_feat_hw=(10, 20),
    shifts=(64, 32, 16, 8, 4, 2),
    loc_deconv_ch=(1024, 320, 160, 80, 40, 16),
    loc_conv_ch=(640, 320, 160, 80, 40),
    ori_deconv_ch=(1024, 256, 128, 64, 32, 16),
    ori_conv_ch=(640, 256, 128, 64, 32),
    grd_hw=(320, 640), sat_hw=(512, 512))

KITTI = CVMConfig(
    name="KITTI", bins=16, circular=False, window="first", sat_desc_dim=2048,
    grd_desc_ch=(16, 8, 4, 2, 1, 1), grd_feat_hw=(8, 32),
    shifts=(128, 64, 32, 16, 8, 8),  # the reference's scale-6 shift is 8
    loc_deconv_ch=(1024, 256, 128, 64, 32, 16),
    loc_conv_ch=(512, 256, 128, 128, 32),  # conv3 widens to 128
    ori_deconv_ch=(1024, 256, 128, 64, 32, 16),
    ori_conv_ch=(512, 256, 128, 64, 32),
    grd_hw=(256, 1024), sat_hw=(512, 512))

OXFORD = CVMConfig(
    name="OxfordRobotCar", bins=20, circular=False, window="center",
    sat_desc_dim=1280,
    grd_desc_ch=(32, 16, 8, 4, 2, 1), grd_feat_hw=(4, 7),
    shifts=(64, 32, 16, 8, 4, 2),
    loc_deconv_ch=(1024, 320, 160, 80, 40, 16),
    loc_conv_ch=(640, 320, 160, 80, 40),
    ori_deconv_ch=(1024, 256, 128, 64, 32, 16),
    ori_conv_ch=(640, 256, 128, 64, 32),
    grd_hw=(154, 231), sat_hw=(512, 512))

# Small test config: VIGOR channel schedule, reduced spatial extent.
TINY = CVMConfig(
    name="TINY", bins=20, circular=True, window="first", sat_desc_dim=1280,
    grd_desc_ch=(64, 32, 16, 8, 4, 2), grd_feat_hw=(2, 4),
    shifts=(64, 32, 16, 8, 4, 2),
    loc_deconv_ch=(1024, 320, 160, 80, 40, 16),
    loc_conv_ch=(640, 320, 160, 80, 40),
    ori_deconv_ch=(1024, 256, 128, 64, 32, 16),
    ori_conv_ch=(640, 256, 128, 64, 32),
    grd_hw=(64, 128), sat_hw=(128, 128))

# Minimal test config: NANO backbone, 4 bins, the same 6-stage decoder.
NANO = CVMConfig(
    name="NANO", bins=4, circular=True, window="first", sat_desc_dim=256,
    grd_desc_ch=(16, 8, 4, 2, 2, 1), grd_feat_hw=(2, 4),
    shifts=(64, 8, 4, 2, 2, 2),
    loc_deconv_ch=(64, 32, 16, 8, 8, 8),
    loc_conv_ch=(32, 16, 8, 8, 8),
    ori_deconv_ch=(64, 32, 16, 8, 8, 8),
    ori_conv_ch=(32, 16, 8, 8, 8),
    grd_hw=(64, 128), sat_hw=(128, 128),
    backbone="nano", feat_dim=256,
    skip_blocks=(4, 3, 2, 1, 0), skip_ch=(32, 24, 16, 12, 8))

PRESETS = {"VIGOR": VIGOR, "KITTI": KITTI, "OxfordRobotCar": OXFORD,
           "TINY": TINY, "NANO": NANO}

REMAT_SCOPES = (False, True, "all", "encoder", "decoder")


def remat_scopes(remat: bool | str) -> tuple[bool, bool]:
    """(encoder, decoder) checkpointed for a ``remat`` value; a misspelt
    scope raises rather than silently turning remat off."""
    if remat not in REMAT_SCOPES:
        raise ValueError(f"remat must be False/True/'all'/'encoder'/'decoder', got {remat!r}")
    return remat in (True, "all", "encoder"), remat in (True, "all", "decoder")


class CVMOutputs(NamedTuple):
    """The reference forward's outputs, NHWC."""

    logits_flattened: torch.Tensor              # [B, H*W]
    heatmap: torch.Tensor                       # [B, H, W, 1]
    ori: torch.Tensor                           # [B, H, W, 2] (cos, sin)
    matching_scores: tuple[torch.Tensor, ...]   # 6 x [B, h_k, w_k, bins_k]


def _decoder_widths(cfg: CVMConfig, branch: str):
    """(deconv_in, deconv_out, conv_in, conv_out) per stage, as the
    reference's layer table derives them."""
    if branch == "loc":
        dec_out, conv_out = cfg.loc_deconv_ch, cfg.loc_conv_ch
        first_in = cfg.sat_desc_dim + 1
        extra = 1  # max-score channel concatenated at every stage
        final = 1
    else:
        dec_out, conv_out = cfg.ori_deconv_ch, cfg.ori_conv_ch
        first_in = cfg.sat_desc_dim + cfg.bins
        extra = 0
        final = 2
    stages = []
    x_ch = first_in
    for s in range(N_SCALES):
        d_in = x_ch
        d_out = dec_out[s]
        if s < 5:
            c_in = d_out + cfg.skip_ch[s]
            c_out = conv_out[s]
            x_ch = c_out + extra
        else:
            c_in, c_out = d_out, (16, final)
        stages.append((d_in, d_out, c_in, c_out))
    return stages


def _double_conv(cin: int, mid: int, cout: int) -> nn.Sequential:
    # the reference's own symmetric Conv2d(padding=1) pads (not TF-SAME)
    return nn.Sequential(Conv2d(cin, mid, 3, padding=1), nn.ReLU(),
                         Conv2d(mid, cout, 3, padding=1))


def _nchw(x_nhwc: torch.Tensor) -> torch.Tensor:
    return x_nhwc.permute(0, 3, 1, 2)


def _nhwc(x_nchw: torch.Tensor) -> torch.Tensor:
    return x_nchw.permute(0, 2, 3, 1)


class CVM(nn.Module):
    def __init__(self, cfg: CVMConfig):
        super().__init__()
        self.cfg = cfg
        self.grd_efficientnet = EfficientNet(cfg.backbone, cfg.circular)
        self.sat_efficientnet = EfficientNet(cfg.backbone, False)
        h = cfg.grd_feat_hw[0]
        for k in range(N_SCALES):
            # keys .0 (1x1 conv to C_k channels) and .2 (collapse of H)
            setattr(self, f"grd_feature_to_descriptor{k + 1}", nn.ModuleDict({
                "0": StaticPadConv2d(ConvSpec(cfg.feat_dim, cfg.grd_desc_ch[k], 1, bias=True)),
                "2": StaticPadConv2d(ConvSpec(h, 1, 1, bias=True)),
            }))
        self.sat_feature_to_descriptors = nn.ModuleDict(
            {"1": Linear(cfg.feat_dim * 2 * 2, cfg.sat_desc_dim)})
        for branch, suffix in (("loc", ""), ("ori", "_ori")):
            for s, (d_in, d_out, c_in, c_out) in enumerate(_decoder_widths(cfg, branch)):
                name = N_SCALES - s  # reference names run 6..1
                setattr(self, f"deconv{name}{suffix}", deconv2x2(d_in, d_out))
                mid, out = (c_out, c_out) if s < 5 else c_out
                setattr(self, f"conv{name}{suffix}", _double_conv(c_in, mid, out))

    def init_weights_(self, generator: torch.Generator) -> "CVM":
        """Seeded torch-default init; the unused classifier heads stay zero."""
        init_uniform_(self, generator)
        for backbone in (self.grd_efficientnet, self.sat_efficientnet):
            nn.init.zeros_(backbone._fc.weight)
            nn.init.zeros_(backbone._fc.bias)
        return self

    def _grd_descriptor(self, k: int, feat: torch.Tensor) -> torch.Tensor:
        """1x1 conv to C_k channels, collapse H with the learned H-vector,
        flatten as (w, c): [B, C, H, W] -> [B, W * C_k]."""
        head = getattr(self, f"grd_feature_to_descriptor{k + 1}")
        y = head["0"](feat)                                   # [B, C_k, H, W]
        conv_h = head["2"]
        wh, bh = conv_h.weight[0, :, 0, 0].to(y.dtype), conv_h.bias[0].to(y.dtype)
        d = torch.einsum("bchw,h->bwc", y, wh) + bh
        return d.reshape(d.shape[0], -1).contiguous()

    def _sat_descriptor_grid(self, feat: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] -> [B, H/2, W/2, D] contiguous NHWC: one Linear over
        each 2x2 chunk flattened in torch's (C, H, W) order."""
        b, c, h, w = feat.shape
        x = feat.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(b, h // 2, w // 2, c * 4)
        return self.sat_feature_to_descriptors["1"](x)

    def _stage(self, branch_suffix: str, s: int, x: torch.Tensor, skip):
        """One decoder stage: deconv, the skip concatenated, double conv."""
        name = N_SCALES - s
        x = getattr(self, f"deconv{name}{branch_suffix}")(x)
        if s < 5:
            x = torch.cat([x, skip], dim=1)
        return getattr(self, f"conv{name}{branch_suffix}")(x)

    def _loc_stage(self, s: int, smax: torch.Tensor, xnorm: torch.Tensor, skip):
        """A localization stage on the matching's max score and normalised map."""
        y = _nchw(torch.cat([smax, xnorm], dim=-1))           # channels_last
        return self._stage("", s, y, skip)

    def forward(self, grd: torch.Tensor, sat: torch.Tensor, *, loc_offsets=None,
                circular: bool | None = None, matching_impl: str = "kernel",
                generator: torch.Generator | None = None,
                remat: bool | str = False) -> CVMOutputs:
        """grd [B, Hg, Wg, 3], sat [B, Hs, Ws, 3] NHWC, ImageNet-normalised.

        ``loc_offsets``: orientation-bin offsets of the localization branch;
        None -> all bins.  ``range(-n, n+1)`` is the ori-prior variant, whose
        orientation decoder still takes the full-bin bottleneck stack.
        ``circular``: override the ground encoder's wrap padding (off for a
        cropped panorama).  ``matching_impl``: 'kernel' (device dispatch:
        the CUDA kernels on a CUDA tensor) or 'plain'.  ``generator``: the
        drop-connect draws of both backbones in train mode (None: no
        drop-connect, as the JAX forward without ``rng``).  ``remat``:
        False, True or 'all' (both encoders' MBConv blocks and every decoder
        stage), 'encoder' or 'decoder'.
        """
        cfg = self.cfg
        remat_enc, remat_dec = remat_scopes(remat)
        if matching_impl == "kernel":
            scores_fn, epilogue_fn = matching.matching_scores, matching.matching_epilogue
        elif matching_impl == "plain":
            scores_fn = matching.matching_scores_plain
            epilogue_fn = matching.matching_epilogue_plain
        else:
            raise ValueError(f"matching_impl must be 'kernel' or 'plain', got {matching_impl!r}")
        full_bins = tuple(range(cfg.bins))
        loc_bins = full_bins if loc_offsets is None else tuple(int(o) for o in loc_offsets)

        cl = torch.channels_last
        with annotate("cvm.ground_encoder"):
            grd = _nchw(grd).contiguous(memory_format=cl)
            grd_feat, _ = self.grd_efficientnet(grd, circular, generator, remat_enc)
            descs = [self._grd_descriptor(k, grd_feat) for k in range(N_SCALES)]
        with annotate("cvm.aerial_encoder"):
            sat = _nchw(sat).contiguous(memory_format=cl)
            sat_feat, ms = self.sat_efficientnet(sat, generator=generator, remat=remat_enc)
            skips = [ms[i] for i in cfg.skip_blocks]
            sat_desc = self._sat_descriptor_grid(sat_feat)    # NHWC, contiguous

        stacks = []
        x = sat_desc
        with annotate("cvm.localization_decoder"):
            for s in range(N_SCALES):
                g = descs[s]
                if g.shape[-1] == x.shape[-1]:
                    stack, smax, xnorm = epilogue_fn(x, g, cfg.shifts[s], loc_bins, cfg.window)
                else:
                    stack = scores_fn(x, g, cfg.shifts[s], loc_bins, cfg.window)
                    smax = stack.amax(dim=-1, keepdim=True)
                    xnorm = l2_normalize(x, dim=-1)
                if s == 0:
                    sat_desc_norm = xnorm  # bin-independent; reused by the ori branch
                    if loc_bins != full_bins:
                        stack = scores_fn(x, g, cfg.shifts[s], full_bins, cfg.window)
                stacks.append(stack)
                skip = skips[s] if s < 5 else None
                if remat_dec:
                    y = checkpoint(self._loc_stage, s, smax, xnorm, skip)
                else:
                    y = self._loc_stage(s, smax, xnorm, skip)
                x = _nhwc(y)

            b = x.shape[0]
            logits = x.reshape(b, -1)
            heatmap = F.softmax(logits, dim=-1).reshape(x.shape)

        with annotate("cvm.orientation_decoder"):
            y = _nchw(torch.cat([stacks[0], sat_desc_norm], dim=-1))
            for s in range(N_SCALES):
                args = ("_ori", s, y, skips[s] if s < 5 else None)
                y = checkpoint(self._stage, *args) if remat_dec else self._stage(*args)
            ori = _nhwc(l2_normalize(y, dim=1))
        return CVMOutputs(logits, heatmap, ori, tuple(stacks))
