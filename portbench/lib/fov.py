"""The model that a limited field of view runs, for the work counts.

Below 360 degrees the program crops the panorama to its leading fov/360
(``api.CVMModel._cropped``) and encodes it without circular padding, so
the ground encoder sees a narrower image and the ground descriptors are
narrower than the aerial ones: every scale then matches through kernel
K2's masked window, and K1 never runs.  ``reference.flops`` counts the
work of the ``Arch`` it is given; ``cropped`` gives it the ``Arch`` of the
cropped model, whose ground feature width follows from the cropped width
through the backbone's own strides and pads.  At 360 degrees it is the
configuration's ``Arch`` itself.

``launches`` lists the matching launches of that model with the bytes the
function needs: where a K2 launch's windows (Cg channels from each bin's
shift) leave channels of x unread, as the prior's five bins do, x is
counted over the union of its windows alone.
"""

from __future__ import annotations

from ..reference import cvm as ref
from ..reference import flops
from . import peaks, readers, trace as trace_lib


def _out(size: int, kernel: int, stride: int, pad: tuple) -> int:
    return (size + pad[0] + pad[1] - kernel) // stride + 1


def feature_width(arch: ref.Arch, width: int) -> int:
    """The width of the backbone's last feature map for a ground image
    ``width`` pixels wide: the stem and each block's depthwise convolution,
    at their static pads (1x1 convolutions keep the size)."""
    stem_pad, blocks = ref.backbone_blocks(arch.backbone)
    width = _out(width, 3, 2, stem_pad[1])
    for b in blocks:
        width = _out(width, b.kernel, b.stride, b.pad[1])
    return width


def cropped(arch: ref.Arch, fov: float) -> ref.Arch:
    """The ``Arch`` of the model that a ``fov`` below 360 runs: the ground
    image ``int(W * fov / 360)`` wide, its feature width derived from that,
    no circular padding; ``arch`` itself from 360 up."""
    if fov >= 360:
        return arch
    width = int(arch.grd_hw[1] * fov / 360)
    return arch._replace(grd_hw=(arch.grd_hw[0], width),
                         grd_feat_hw=(arch.grd_feat_hw[0], feature_width(arch, width)),
                         circular=False)


def arch(reading) -> ref.Arch:
    """The cropped ``Arch`` of a reader's cell (its traffic's ``fov``)."""
    return cropped(ref.arch_from(reading["cell"].config),
                   reading["cell"].workload["params"].get("fov", 360.0))


def windows_channels(cs: int, cg: int, shift: int, offsets, window: str) -> int:
    """How many of x's ``cs`` channels some bin's window reads (``ref.matching``:
    ``cg`` channels from each bin's shift, wrapping round)."""
    read = set()
    for k in ref.bin_shifts(cs, cg, shift, offsets, window):
        read.update((k + c) % cs for c in range(cg))
    return len(read)


def launches(arch: ref.Arch, batch: int, loc_offsets=None) -> list[flops.Launch]:
    """``flops.matching_launches``, with each K2 launch's x counted over the
    channels its windows read (the bottleneck's full-bin stack reads them
    all)."""
    side = arch.sat_hw[0] // 64
    out = []
    for v in flops.matching_launches(arch, batch, loc_offsets):
        b, h, w, cs = v.x
        if v.kernel == "K2":
            scale = (h // side).bit_length() - 1
            offsets = range(arch.bins) if v.bins == arch.bins else loc_offsets
            read = windows_channels(cs, v.cg, arch.shifts[scale], offsets, arch.window)
            v = v._replace(bytes=v.bytes - 4 * b * h * w * (cs - read))
        out.append(v)
    return out


def roofline_pct(reading, kernel: str) -> float | None:
    """``readers.roofline_pct`` over ``launches`` of the cell's cropped
    model: the least time of ``kernel``'s launches in one call over their
    measured device time a call."""
    t = reading["trace"]
    if t is None or not t.iters:
        return None
    spent = trace_lib.device_s_by(t, trace_lib.matching_kernel).get(kernel, 0.0) / t.iters
    least = sum(peaks.bound_s(v.bytes, v.flops, reading["part"])
                for v in launches(arch(reading), reading["readings"]["batch"],
                                  readers.loc_offsets(reading))
                if v.kernel == kernel)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
