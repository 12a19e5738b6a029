"""Plain PyTorch reference of CCVPE's CVM model (VIGOR and KITTI presets).

Written from the published description (Xia et al., "Convolutional
Cross-View Pose Estimation", TPAMI 2023; tudelft-iv/CCVPE ``models.py``
``CVM_VIGOR`` / ``CVM_KITTI``) and imports nothing of the measured program.
It is functional: every weight and BatchNorm statistic comes from a dict in
the reference checkpoint's key layout (``grd_efficientnet._conv_stem.weight``
...), so the benchmark hands the program and this file the same tensors.

Everything runs in float32, NCHW, with ``torch.nn.functional`` ops only;
the benchmark turns TF32 off before calling it.  Departures from the
published code, all of them shared with the program under test:

* EfficientNet-B0's TF-"SAME" pads are computed once from the 224-px trace
  of the ``efficientnet_pytorch`` constructor (static pads), not from the
  input size; the ground encoder of VIGOR wraps horizontally (circular
  padding) before the vertical zero pad.
* The matching is written as a product with a rolled, zero-padded copy of
  the ground descriptor (the same sums as the published roll-and-slice),
  and its cosine denominator is clamped at 1e-12.
* Without an orientation prior the localization decoder sees every bin;
  with one (``loc_offsets``) the orientation decoder still takes the
  full-bin bottleneck stack.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

N_SCALES = 6
BN_EPS = 1e-3
BN_MOMENTUM = 0.01
DROP_CONNECT_RATE = 0.2
TRACE_SIZE = 224
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# (repeats, kernel, stride, expand, cin, cout), se ratio 0.25 throughout
B0_BLOCKS = ((1, 3, 1, 1, 32, 16), (2, 3, 2, 6, 16, 24), (2, 5, 2, 6, 24, 40),
             (3, 3, 2, 6, 40, 80), (3, 5, 1, 6, 80, 112), (4, 5, 2, 6, 112, 192),
             (1, 3, 1, 6, 192, 320))
# a five-block backbone with B0's strides, for tests on the CPU only
NANO_BLOCKS = ((1, 3, 1, 1, 8, 8), (1, 3, 2, 2, 8, 12), (1, 3, 2, 2, 12, 16),
               (1, 3, 2, 2, 16, 24), (1, 3, 2, 2, 24, 32))
# name -> (blocks, stem width, head width)
BACKBONES = {"b0": (B0_BLOCKS, 32, 1280), "nano": (NANO_BLOCKS, 8, 256)}
SE_RATIO = 0.25
FC_CLASSES = 1000   # the unused ImageNet head, kept for its checkpoint keys


class Arch(NamedTuple):
    """The sizes of one configuration file (``portbench/configs/*.json``)."""
    bins: int
    circular: bool
    window: str
    sat_desc_dim: int
    grd_desc_ch: tuple
    grd_feat_hw: tuple
    shifts: tuple
    loc_deconv_ch: tuple
    loc_conv_ch: tuple
    ori_deconv_ch: tuple
    ori_conv_ch: tuple
    grd_hw: tuple
    sat_hw: tuple
    backbone: str
    feat_dim: int
    skip_blocks: tuple
    skip_ch: tuple


def arch_from(config: dict) -> Arch:
    a = config["architecture"]
    return Arch(**{k: tuple(a[k]) if isinstance(a[k], list) else a[k] for k in Arch._fields})


class Block(NamedTuple):
    cin: int
    mid: int
    cout: int
    kernel: int
    stride: int
    pad: tuple
    se: int
    expand: bool
    id_skip: bool


def same_pad(hw, kernel: int, stride: int) -> tuple:
    """TF-'SAME' ((top, bottom), (left, right)) for a traced image size."""
    out = []
    for i in hw:
        o = math.ceil(i / stride)
        p = max((o - 1) * stride + kernel - i, 0)
        out.append((p // 2, p - p // 2))
    return tuple(out)


def backbone_blocks(name: str) -> tuple[tuple, list[Block]]:
    """(stem pad, blocks) of a backbone, pads from the 224-px trace."""
    table, stem_ch, _ = BACKBONES[name]
    hw = (TRACE_SIZE, TRACE_SIZE)
    stem_pad = same_pad(hw, 3, 2)
    hw = tuple(math.ceil(i / 2) for i in hw)
    blocks = []
    for repeats, k, s, e, cin, cout in table:
        for r in range(repeats):
            c_in, stride = (cin, s) if r == 0 else (cout, 1)
            blocks.append(Block(c_in, c_in * e, cout, k, stride, same_pad(hw, k, stride),
                                max(1, int(c_in * SE_RATIO)), e != 1,
                                stride == 1 and c_in == cout))
            hw = tuple(math.ceil(i / stride) for i in hw)
    return stem_pad, blocks


def _decoder_stages(arch: Arch, branch: str) -> list[tuple]:
    """(deconv in, deconv out, conv in, conv mid, conv out) per stage."""
    if branch == "loc":
        dec, conv, x_ch, extra, final = (arch.loc_deconv_ch, arch.loc_conv_ch,
                                         arch.sat_desc_dim + 1, 1, 1)
    else:
        dec, conv, x_ch, extra, final = (arch.ori_deconv_ch, arch.ori_conv_ch,
                                         arch.sat_desc_dim + arch.bins, 0, 2)
    stages = []
    for s in range(N_SCALES):
        if s < 5:
            stages.append((x_ch, dec[s], dec[s] + arch.skip_ch[s], conv[s], conv[s]))
            x_ch = conv[s] + extra
        else:
            stages.append((x_ch, dec[s], dec[s], 16, final))
    return stages


def param_shapes(arch: Arch) -> dict[str, tuple]:
    """Every key of the reference checkpoint and its shape, in a fixed order.
    BatchNorm keys carry ``running_mean``, ``running_var`` and
    ``num_batches_tracked`` beside ``weight`` and ``bias``."""
    shapes: dict[str, tuple] = {}

    def bn(key, c):
        for n in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{key}.{n}"] = (c,)
        shapes[f"{key}.num_batches_tracked"] = ()

    def conv(key, cout, cin, k, bias=False):
        shapes[f"{key}.weight"] = (cout, cin, k, k)
        if bias:
            shapes[f"{key}.bias"] = (cout,)

    _, stem_ch, head_ch = BACKBONES[arch.backbone]
    _, blocks = backbone_blocks(arch.backbone)
    for enc in ("grd_efficientnet", "sat_efficientnet"):
        conv(f"{enc}._conv_stem", stem_ch, 3, 3)
        bn(f"{enc}._bn0", stem_ch)
        for i, b in enumerate(blocks):
            p = f"{enc}._blocks.{i}"
            if b.expand:
                conv(f"{p}._expand_conv", b.mid, b.cin, 1)
                bn(f"{p}._bn0", b.mid)
            conv(f"{p}._depthwise_conv", b.mid, 1, b.kernel)
            bn(f"{p}._bn1", b.mid)
            conv(f"{p}._se_reduce", b.se, b.mid, 1, bias=True)
            conv(f"{p}._se_expand", b.mid, b.se, 1, bias=True)
            conv(f"{p}._project_conv", b.cout, b.mid, 1)
            bn(f"{p}._bn2", b.cout)
        conv(f"{enc}._conv_head", head_ch, blocks[-1].cout, 1)
        bn(f"{enc}._bn1", head_ch)
        shapes[f"{enc}._fc.weight"] = (FC_CLASSES, head_ch)
        shapes[f"{enc}._fc.bias"] = (FC_CLASSES,)
    h = arch.grd_feat_hw[0]
    for k in range(N_SCALES):
        conv(f"grd_feature_to_descriptor{k + 1}.0", arch.grd_desc_ch[k], arch.feat_dim, 1, True)
        conv(f"grd_feature_to_descriptor{k + 1}.2", 1, h, 1, True)
    shapes["sat_feature_to_descriptors.1.weight"] = (arch.sat_desc_dim, arch.feat_dim * 4)
    shapes["sat_feature_to_descriptors.1.bias"] = (arch.sat_desc_dim,)
    for branch, suffix in (("loc", ""), ("ori", "_ori")):
        for s, (d_in, d_out, c_in, mid, out) in enumerate(_decoder_stages(arch, branch)):
            name = N_SCALES - s
            shapes[f"deconv{name}{suffix}.weight"] = (d_in, d_out, 2, 2)
            shapes[f"deconv{name}{suffix}.bias"] = (d_out,)
            conv(f"conv{name}{suffix}.0", mid, c_in, 3, True)
            conv(f"conv{name}{suffix}.2", out, mid, 3, True)
    return shapes


# ------------------------------------------------------------------ layers

def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> ImageNet-normalised float32 NCHW."""
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def _conv(x, w, b=None, stride=1, pad=((0, 0), (0, 0)), circular=False, groups=1):
    (pt, pb), (pl, pr) = pad
    if circular and (pl or pr):
        x = torch.cat([x[..., x.shape[-1] - pl:], x, x[..., :pr]], dim=-1)
        pl = pr = 0
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(x, w, b, stride, 0, 1, groups)


class Mode(NamedTuple):
    """How BatchNorm and drop-connect behave in one forward.

    ``bn``: 'eval' (running statistics), 'train' (batch statistics, running
    ones updated with momentum 0.01 and the unbiased variance) or
    'calibrate' (batch statistics, stored as the running ones).
    ``generator``: drop-connect draws in 'train' (None: off)."""
    bn: str = "eval"
    generator: torch.Generator | None = None


def _bn(x, p, key, mode: Mode):
    w, b = p[f"{key}.weight"], p[f"{key}.bias"]
    rm, rv = p[f"{key}.running_mean"], p[f"{key}.running_var"]
    if mode.bn == "eval":
        return F.batch_norm(x, rm, rv, w, b, False, 0.0, BN_EPS)
    if mode.bn == "train":
        return F.batch_norm(x, rm, rv, w, b, True, BN_MOMENTUM, BN_EPS)
    with torch.no_grad():
        n = x.numel() // x.shape[1]
        rm.copy_(x.mean(dim=(0, 2, 3)))
        rv.copy_(x.var(dim=(0, 2, 3), unbiased=False) * (n / max(n - 1, 1)))
    return F.batch_norm(x, None, None, w, b, True, 0.0, BN_EPS)


def encoder(p: dict, prefix: str, x: torch.Tensor, arch: Arch, circular: bool,
            mode: Mode) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """EfficientNet feature extractor: (head features, every block output)."""
    stem_pad, blocks = backbone_blocks(arch.backbone)
    pre = f"{prefix}._"
    x = F.silu(_bn(_conv(x, p[pre + "conv_stem.weight"], stride=2, pad=stem_pad,
                         circular=circular), p, pre + "bn0", mode))
    outs = []
    for i, blk in enumerate(blocks):
        q = f"{pre}blocks.{i}._"
        inputs = x
        if blk.expand:
            x = F.silu(_bn(_conv(x, p[q + "expand_conv.weight"]), p, q + "bn0", mode))
        x = _conv(x, p[q + "depthwise_conv.weight"], stride=blk.stride, pad=blk.pad,
                  circular=circular, groups=blk.mid)
        x = F.silu(_bn(x, p, q + "bn1", mode))
        se = x.mean(dim=(2, 3), keepdim=True)
        se = F.silu(_conv(se, p[q + "se_reduce.weight"], p[q + "se_reduce.bias"]))
        se = _conv(se, p[q + "se_expand.weight"], p[q + "se_expand.bias"])
        x = torch.sigmoid(se) * x
        x = _bn(_conv(x, p[q + "project_conv.weight"]), p, q + "bn2", mode)
        if blk.id_skip:
            rate = DROP_CONNECT_RATE * i / len(blocks)
            if mode.bn == "train" and rate and mode.generator is not None:
                keep = 1.0 - rate
                u = torch.rand((x.shape[0], 1, 1, 1), generator=mode.generator,
                               device=x.device, dtype=x.dtype)
                x = x / keep * torch.floor(keep + u)
            x = x + inputs
        outs.append(x)
    x = F.silu(_bn(_conv(x, p[pre + "conv_head.weight"]), p, pre + "bn1", mode))
    return x, outs


def bin_shifts(cs: int, cg: int, shift: int, offsets, window: str) -> tuple[int, ...]:
    start = 0 if window == "first" else (cs - cg) // 2
    return tuple((start + int(o) * shift) % cs for o in offsets)


def matching(x: torch.Tensor, g: torch.Tensor, shift: int, offsets, window: str
             ) -> torch.Tensor:
    """Cosine similarity of each bin's rolled window of x [B,H,W,Cs] with the
    ground descriptor g [B,Cg] -> [B,H,W,bins]."""
    cs, cg = x.shape[-1], g.shape[-1]
    ks = bin_shifts(cs, cg, shift, offsets, window)
    gp = F.pad(g, (0, cs - cg))
    banded = torch.stack([torch.roll(gp, k, dims=1) for k in ks], dim=-1)
    num = torch.einsum("bhwc,bci->bhwi", x, banded)
    c = torch.arange(cs, device=x.device)
    mask = torch.stack([(c - k) % cs < cg for k in ks], dim=1).to(x.dtype)
    sq = torch.einsum("bhwc,ci->bhwi", x * x, mask)
    gnorm = g.square().sum(dim=-1).sqrt()[:, None, None, None]
    return num / torch.clamp(sq.sqrt() * gnorm, min=1e-12)


def _l2n(x, dim):
    return F.normalize(x, p=2.0, dim=dim, eps=1e-12)


def _stage(p, name: str, x: torch.Tensor, skip):
    x = F.conv_transpose2d(x, p[f"deconv{name}.weight"], p[f"deconv{name}.bias"], stride=2)
    if skip is not None:
        x = torch.cat([x, skip], dim=1)
    x = F.relu(F.conv2d(x, p[f"conv{name}.0.weight"], p[f"conv{name}.0.bias"], padding=1))
    return F.conv2d(x, p[f"conv{name}.2.weight"], p[f"conv{name}.2.bias"], padding=1)


class Outputs(NamedTuple):
    logits: torch.Tensor        # [B, H*W]
    ori: torch.Tensor           # [B, H, W, 2] (cos, sin)
    scores: tuple               # 6 x [B, h, w, bins] matching volumes
    ori_norm: torch.Tensor      # [B, H, W] the orientation field's length before normalising


def forward(p: dict, arch: Arch, grd: torch.Tensor, sat: torch.Tensor, *,
            loc_offsets=None, circular: bool | None = None, mode: Mode = Mode()) -> Outputs:
    """grd, sat: ImageNet-normalised float32 NCHW.  ``circular``: the ground
    encoder's wrap padding (None: the configuration's; off for a panorama
    cropped to a limited field of view)."""
    circular = arch.circular if circular is None else circular
    grd_feat, _ = encoder(p, "grd_efficientnet", grd, arch, circular, mode)
    descs = []
    for k in range(N_SCALES):
        q = f"grd_feature_to_descriptor{k + 1}"
        y = F.conv2d(grd_feat, p[f"{q}.0.weight"], p[f"{q}.0.bias"])
        d = torch.einsum("bchw,h->bwc", y, p[f"{q}.2.weight"][0, :, 0, 0]) + p[f"{q}.2.bias"][0]
        descs.append(d.reshape(d.shape[0], -1))
    sat_feat, ms = encoder(p, "sat_efficientnet", sat, arch, False, mode)
    skips = [ms[i] for i in arch.skip_blocks]
    b, c, h, w = sat_feat.shape
    x = sat_feat.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    x = F.linear(x.reshape(b, h // 2, w // 2, c * 4), p["sat_feature_to_descriptors.1.weight"],
                 p["sat_feature_to_descriptors.1.bias"])          # NHWC
    full = tuple(range(arch.bins))
    loc = full if loc_offsets is None else tuple(int(o) for o in loc_offsets)
    scores = []
    for s in range(N_SCALES):
        stack = matching(x, descs[s], arch.shifts[s], loc, arch.window)
        smax = stack.amax(dim=-1, keepdim=True)
        xnorm = _l2n(x, -1)
        if s == 0:
            sat_desc_norm = xnorm
            if loc != full:
                stack = matching(x, descs[s], arch.shifts[s], full, arch.window)
        scores.append(stack)
        y = torch.cat([smax, xnorm], dim=-1).permute(0, 3, 1, 2)
        y = _stage(p, str(N_SCALES - s), y, skips[s] if s < 5 else None)
        x = y.permute(0, 2, 3, 1)
    logits = x.reshape(b, -1)
    y = torch.cat([scores[0], sat_desc_norm], dim=-1).permute(0, 3, 1, 2)
    for s in range(N_SCALES):
        y = _stage(p, f"{N_SCALES - s}_ori", y, skips[s] if s < 5 else None)
    ori = _l2n(y, 1).permute(0, 2, 3, 1)
    return Outputs(logits, ori, tuple(scores), y.detach().norm(dim=1))
