"""Wrappers of the CUDA matching kernels in ``ccvpe_torch/csrc/matching.cu``.

* K1, ``matching_epilogue_cuda``, replaces the fused Pallas TPU kernel
  ``ccvpe_tpu/ops/pallas_matching.py::_kernel_fused`` (``pallas_call`` at
  ``:225``): scores, max over bins and the l2-normalised feature map from one
  read of x (Cg == Cs; every VIGOR scale).
* K2, ``matching_scores_cuda``, replaces ``_kernel`` (``pallas_call`` at
  ``:116``): scores alone, with the per-bin masked window norm when Cg < Cs
  (the ori-prior full-bin bottleneck stack; Oxford and KITTI scales).

Both are bound by device-memory bytes, not arithmetic: at 20 bins they do
about 4 FLOP per byte they move.  So the kernels read x once and write each
output once (the design is in the source note of ``matching.cu``).  Each
kernel has two layouts: a warp per pixel row for maps with few rows (the
coarse scales, wide channels) and a thread per pixel row for maps with many
(the fine scales, narrow channels); ``pick_layout`` chooses.

A wrapper takes a CPU tensor to the kernel's plain version in
``ops/matching.py``.  For a CUDA tensor it checks device, dtype, shape and
NHWC contiguity and raises on anything else (no silent copy may hide a
layout bug), allocates the outputs with ``torch.empty``, launches on the
current stream and raises if the launch failed; it never falls back to the
plain version.  ``LAUNCHES`` counts each kernel's launches.  The backward is
autograd through the plain version (the TPU kernels' custom VJPs do the
same through the einsum), so the kernels also serve training.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .matching import bin_shifts, matching_epilogue_plain, matching_scores_plain

# kernel launches on the CUDA path, by kernel; reset with reset_launch_counts
LAUNCHES = {"matching_epilogue": 0, "matching_scores": 0}

MAX_BINS = 32
MAX_CHANNELS = 4096  # warp layout: 2 * Cs f32 descriptor copies in 48 KB of shared memory
ROW_LAYOUT_MAX_SMEM = 200 * 1024  # row layout: the kernel's dynamic shared-memory cap
# The row layout serves maps of at most this many channels with at least
# this many pixel rows per SM (enough 128-row blocks to fill the card).  On
# an H100 it beats the warp layout at the VIGOR scales of 40, 80 and 160
# channels and loses at 320 and above (chip_smoke.py's kernel_times).
ROW_LAYOUT_MAX_CHANNELS = 160
ROW_LAYOUT_MIN_ROWS_PER_SM = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LAYOUTS = {"warp": 0, "row": 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = _build.load("matching")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ccvpe_match_epilogue.argtypes = [p, p, p, p, p, i, i, i, i, p, i, i, i, p]
    lib.ccvpe_match_epilogue.restype = i
    lib.ccvpe_match_scores.argtypes = [p, p, p, i, i, i, i, i, p, i, i, i, p]
    lib.ccvpe_match_scores.restype = i
    lib.ccvpe_match_row_smem_bytes.argtypes = [i, i, i]
    lib.ccvpe_match_row_smem_bytes.restype = i
    return lib


def _check(x: torch.Tensor, g: torch.Tensor, bins: int) -> None:
    if x.device.type != "cuda" or g.device != x.device:
        raise ValueError(f"CUDA matching kernels need x and g on one CUDA "
                         f"device, got {x.device} and {g.device}")
    if x.dtype not in _DTYPE_CODES or g.dtype != x.dtype:
        raise TypeError(f"x and g must both be float32 or bfloat16, got "
                        f"{x.dtype} and {g.dtype}")
    if x.dim() != 4 or g.dim() != 2 or g.shape[0] != x.shape[0]:
        raise ValueError(f"expected x [B,H,W,Cs] and g [B,Cg], got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    b, h, w, cs = x.shape
    if not (0 < g.shape[1] <= cs <= MAX_CHANNELS) or b * h * w == 0:
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)} (need 0 < Cg <= Cs <= "
                         f"{MAX_CHANNELS}, non-empty x)")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the kernel grid's 65535")
    if not x.is_contiguous() or not g.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor and g contiguous "
                         "(a channels_last NCHW tensor permuted to NHWC is)")
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"the kernels take 1..{MAX_BINS} bins, got {bins}")


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _rows_per_block(shape, sms: int) -> int:
    """Warp layout: pixel rows per block, 64, halved down to 8 until the
    grid has at least four blocks per SM (small maps, e.g. the 8x8
    bottleneck)."""
    b, h, w, _ = shape
    rpb = 64
    while rpb > 8 and b * -(-(h * w) // rpb) < 4 * sms:
        rpb //= 2
    return rpb


def row_layout_fits(cs: int, cg: int, bins: int) -> bool:
    """Whether the row layout's W (and, for Cg < Cs, its mask) fit its
    shared memory."""
    need = _kernels().ccvpe_match_row_smem_bytes(cs, bins, int(cg < cs))
    return need <= ROW_LAYOUT_MAX_SMEM


def pick_layout(x: torch.Tensor, cg: int, bins: int) -> str:
    """'row' (a thread per pixel row) for maps with many rows whose W (and
    mask) fit the row layout's shared memory, else 'warp' (a warp per row)."""
    return _layout(tuple(x.shape), cg, bins, None, _sms(x.device.index or 0))


def _layout(shape, cg: int, bins: int, layout: str | None, sms: int) -> str:
    """``layout`` None picks as ``pick_layout`` says; 'warp' or 'row' forces
    one, and raises where the row layout does not fit."""
    b, h, w, cs = shape
    masked = cg < cs
    fits = row_layout_fits(cs, cg, bins)
    if layout is None:
        many = b * h * w >= ROW_LAYOUT_MIN_ROWS_PER_SM * sms
        return "row" if many and cs <= ROW_LAYOUT_MAX_CHANNELS and fits else "warp"
    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be 'warp' or 'row', got {layout!r}")
    if layout == "row" and not fits:
        raise ValueError(f"the row layout's shared memory does not fit Cs={cs}, "
                         f"{bins} bins{' (masked)' if masked else ''}")
    return layout


class _Plan(NamedTuple):
    ks: ctypes.Array      # k_i as a C int array
    bins: int
    layout: int
    rows_per_block: int


@functools.lru_cache(maxsize=1024)
def _plan(shape, cg: int, shift: int, offsets: tuple[int, ...], window: str,
          layout: str | None, device_index: int) -> _Plan:
    """What a launch needs beyond the pointers, for one call signature (the
    forward repeats a handful of them)."""
    ks = bin_shifts(shape[-1], cg, shift, offsets, window)
    sms = _sms(device_index)
    return _Plan((ctypes.c_int * len(ks))(*ks), len(ks),
                 _LAYOUTS[_layout(shape, cg, len(ks), layout, sms)],
                 _rows_per_block(shape, sms))


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


def launch_matching_epilogue(x, g, shift, offsets, window, layout=None):
    """Launch K1 on checked inputs; returns (scores, smax, xnorm)."""
    offsets = tuple(offsets)
    _check(x, g, len(offsets))
    b, h, w, cs = x.shape
    if g.shape[1] != cs:
        raise ValueError(f"matching_epilogue needs Cg == Cs, got {g.shape[1]} != {cs}")
    plan = _plan(tuple(x.shape), cs, shift, offsets, window, layout, x.device.index or 0)
    scores = torch.empty((b, h, w, plan.bins), dtype=x.dtype, device=x.device)
    smax = torch.empty((b, h, w, 1), dtype=x.dtype, device=x.device)
    xnorm = torch.empty((b, h, w, cs), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernels().ccvpe_match_epilogue(
            x.data_ptr(), g.data_ptr(), scores.data_ptr(), smax.data_ptr(),
            xnorm.data_ptr(), b, h * w, cs, plan.bins, ctypes.addressof(plan.ks),
            _DTYPE_CODES[x.dtype], plan.layout, plan.rows_per_block,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "matching_epilogue")
    LAUNCHES["matching_epilogue"] += 1
    return scores, smax, xnorm


def launch_matching_scores(x, g, shift, offsets, window, layout=None):
    """Launch K2 on checked inputs; returns the scores."""
    offsets = tuple(offsets)
    _check(x, g, len(offsets))
    b, h, w, cs = x.shape
    cg = g.shape[1]
    plan = _plan(tuple(x.shape), cg, shift, offsets, window, layout, x.device.index or 0)
    scores = torch.empty((b, h, w, plan.bins), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernels().ccvpe_match_scores(
            x.data_ptr(), g.data_ptr(), scores.data_ptr(), b, h * w, cs, cg,
            plan.bins, ctypes.addressof(plan.ks), _DTYPE_CODES[x.dtype], plan.layout,
            plan.rows_per_block, torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "matching_scores")
    LAUNCHES["matching_scores"] += 1
    return scores


def _plain_grads(plain, x, g, args, grads_out):
    with torch.enable_grad():
        xr = x.detach().requires_grad_()
        gr = g.detach().requires_grad_()
        outs = plain(xr, gr, *args)
        gx, gg = torch.autograd.grad(outs, (xr, gr), grads_out)
    return gx, gg, None, None, None


class _EpilogueFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, shift, offsets, window):
        ctx.save_for_backward(x, g)
        ctx.args = (shift, offsets, window)
        return launch_matching_epilogue(x, g, shift, offsets, window)

    @staticmethod
    def backward(ctx, d_scores, d_smax, d_xnorm):
        x, g = ctx.saved_tensors
        return _plain_grads(matching_epilogue_plain, x, g, ctx.args,
                            (d_scores, d_smax, d_xnorm))


class _ScoresFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, shift, offsets, window):
        ctx.save_for_backward(x, g)
        ctx.args = (shift, offsets, window)
        return launch_matching_scores(x, g, shift, offsets, window)

    @staticmethod
    def backward(ctx, d_scores):
        x, g = ctx.saved_tensors
        return _plain_grads(matching_scores_plain, x, g, ctx.args, d_scores)


def _needs_grad(x, g) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or g.requires_grad)


def matching_epilogue_cuda(x, g, shift: int, offsets, window: str = "first"):
    """K1: (scores, max over bins, l2-normalised x), Cg == Cs.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises."""
    offsets = tuple(int(o) for o in offsets)
    if x.device.type == "cpu":
        return matching_epilogue_plain(x, g, shift, offsets, window)
    if _needs_grad(x, g):
        return _EpilogueFn.apply(x, g, shift, offsets, window)
    return launch_matching_epilogue(x, g, shift, offsets, window)


def matching_scores_cuda(x, g, shift: int, offsets, window: str = "first"):
    """K2: scores of every bin.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises."""
    offsets = tuple(int(o) for o in offsets)
    if x.device.type == "cpu":
        return matching_scores_plain(x, g, shift, offsets, window)
    if _needs_grad(x, g):
        return _ScoresFn.apply(x, g, shift, offsets, window)
    return launch_matching_scores(x, g, shift, offsets, window)
