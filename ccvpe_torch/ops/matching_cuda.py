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
kernel has a warp per pixel row for maps with few rows (the coarse scales,
wide channels) and a thread per pixel row for maps with many (the fine
scales, narrow channels).  K1 has a third layout for the fine scales,
``tile``: persistent blocks that copy tiles of rows in 16-byte granules
through a double-buffered ring and write all outputs from shared memory.
``pick_layout`` chooses; ``tile_plan`` (tile rows, stages, shared memory,
grid) and ``choose_layout`` are pure functions of the shape, the bins, the
dtype and the device's limits, and load no library.

A wrapper takes a CPU tensor to the kernel's plain version in
``ops/matching.py``.  For a CUDA tensor it checks device, dtype, shape and
NHWC contiguity and raises on anything else (no silent copy may hide a
layout bug), allocates the outputs with ``torch.empty``, launches on the
current stream and raises if the launch failed; it never falls back to the
plain version.  ``LAUNCHES`` counts each kernel's launches and
``LAUNCHES_BY_LAYOUT`` each (kernel, layout)'s.  The backward is
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

# kernel launches on the CUDA path, by kernel and by (kernel, layout); reset
# with reset_launch_counts
LAUNCHES = {"matching_epilogue": 0, "matching_scores": 0}
LAUNCHES_BY_LAYOUT = {("matching_epilogue", "warp"): 0, ("matching_epilogue", "row"): 0,
                      ("matching_epilogue", "tile"): 0, ("matching_scores", "warp"): 0,
                      ("matching_scores", "row"): 0}

MAX_BINS = 32
MAX_CHANNELS = 4096  # warp layout: 2 * Cs f32 descriptor copies in 48 KB of shared memory
ROW_LAYOUT_MAX_SMEM = 200 * 1024  # row layout: the kernel's dynamic shared-memory cap
# The row and tile layouts serve maps of at most this many channels with at
# least this many pixel rows per SM (enough 128-row blocks to fill the card).
# On an H100 the row layout beats the warp layout at the VIGOR scales of 40,
# 80 and 160 channels and loses at 320 and above (chip_smoke.py's
# kernel_times); K1 takes its tile layout there wherever its plan applies,
# which measured faster than the row layout at all three (ms_by_layout).
ROW_LAYOUT_MAX_CHANNELS = 160
ROW_LAYOUT_MIN_ROWS_PER_SM = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LAYOUTS = {"warp": 0, "row": 1, "tile": 2}
_KERNELS = ("matching_epilogue", "matching_scores")

# Tile layout (K1): these constants are the kernel's (matching.cu).
GRANULE = 16                   # bytes of one cp.async copy and one store
TILE_ROWS = (128, 64, 32)      # rows per tile = threads per block, largest first
TILE_STAGES = 2                # tiles in the shared-memory ring
TILE_MAX_BLOCKS_PER_SM = 4     # __launch_bounds__ minimum: registers allow this many
SMEM_RESERVED_PER_BLOCK = 1024  # shared memory the CUDA runtime keeps per block


class DeviceLimits(NamedTuple):
    sms: int                    # streaming multiprocessors
    smem_per_sm: int            # shared memory of one SM, bytes


H100 = DeviceLimits(sms=132, smem_per_sm=228 * 1024)


class TilePlan(NamedTuple):
    rows: int                   # pixel rows per tile = threads per block
    stages: int
    stride: int                 # staged row stride in 16-byte granules (odd)
    smem: int                   # dynamic shared memory per block, bytes
    blocks_per_sm: int          # resident blocks per SM at that shared memory
    tiles: int                  # tiles per sample
    grid: tuple[int, int]       # (blocks per sample, batch)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in LAUNCHES_BY_LAYOUT:
        LAUNCHES_BY_LAYOUT[k] = 0


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = _build.load("matching")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ccvpe_match_epilogue.argtypes = [p, p, p, p, p, i, i, i, i, p, i, i, i, i, i, i, p]
    lib.ccvpe_match_epilogue.restype = i
    lib.ccvpe_match_scores.argtypes = [p, p, p, i, i, i, i, i, p, i, i, i, p]
    lib.ccvpe_match_scores.restype = i
    lib.ccvpe_match_row_smem_bytes.argtypes = [i, i, i]
    lib.ccvpe_match_row_smem_bytes.restype = i
    lib.ccvpe_match_tile_smem_bytes.argtypes = [i, i, i, i]
    lib.ccvpe_match_tile_smem_bytes.restype = i
    lib.ccvpe_match_tile_blocks_per_sm.argtypes = [i, i, i, i, i]
    lib.ccvpe_match_tile_blocks_per_sm.restype = i
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
def device_limits(device_index: int) -> DeviceLimits:
    props = torch.cuda.get_device_properties(device_index)
    return DeviceLimits(props.multi_processor_count, props.shared_memory_per_multiprocessor)


def _rows_per_block(shape, sms: int) -> int:
    """Warp layout: pixel rows per block, 64, halved down to 8 until the
    grid has at least four blocks per SM (small maps, e.g. the 8x8
    bottleneck)."""
    b, h, w, _ = shape
    rpb = 64
    while rpb > 8 and b * -(-(h * w) // rpb) < 4 * sms:
        rpb //= 2
    return rpb


def _nb(bins: int) -> int:
    """Bins padded to a multiple of 4 (the kernels' float4 reads of W)."""
    return -(-bins // 4) * 4


def row_smem_bytes(cs: int, cg: int, bins: int) -> int:
    """Shared memory of the row layout (matching.cu's ``row_smem``): W, the
    mask where Cg < Cs, 128 staged rows of 33 floats, g and 4 partial sums."""
    nb = _nb(bins)
    return 4 * (cs * nb * (2 if cg < cs else 1) + 128 * 33 + cs + 4)


def row_layout_fits(cs: int, cg: int, bins: int) -> bool:
    """Whether the row layout's W (and, for Cg < Cs, its mask) fit its
    shared memory."""
    return row_smem_bytes(cs, cg, bins) <= ROW_LAYOUT_MAX_SMEM


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def tile_stride(cs: int, itemsize: int) -> int:
    """Staged row stride of the tile layout in 16-byte granules, made odd so
    that eight rows' reads at one column fall in distinct banks."""
    return (cs * itemsize // GRANULE) | 1


def tile_smem_bytes(cs: int, bins: int, itemsize: int, rows: int) -> int:
    """Shared memory of the tile layout (matching.cu's ``tile_smem``): the
    ring of staged tiles, W [Cs][bins padded to 4] f32, a tile's scores and
    smax (each with up to one granule of lead), 1/||X|| per row and g."""
    v = GRANULE // itemsize
    return (TILE_STAGES * rows * tile_stride(cs, itemsize) * GRANULE + cs * _nb(bins) * 4
            + _round16((rows * bins + v) * itemsize) + _round16((rows + v) * itemsize)
            + rows * 4 + _round16(cs * 4))


def tile_plan(shape, bins: int, dtype: torch.dtype,
              limits: DeviceLimits = H100) -> TilePlan | None:
    """Launch plan of K1's tile layout for x of ``shape`` [B,H,W,Cs], or None
    where it does not apply: Cs * itemsize not a multiple of 16 bytes, or
    no tile that fits one block's shared memory.  Of the tile sizes that
    fit, the one with the most rows resident per SM (the larger on a tie).
    The grid keeps every block resident: (resident blocks // B) blocks per
    sample, at least 1 and at most the sample's tiles.  A pure function:
    it loads no library, so the CPU tests reach it."""
    b, h, w, cs = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    if (cs * itemsize) % GRANULE or not 1 <= bins <= MAX_BINS:
        return None
    cap = limits.smem_per_sm - SMEM_RESERVED_PER_BLOCK
    best = None
    for rows in TILE_ROWS:
        smem = tile_smem_bytes(cs, bins, itemsize, rows)
        if smem > cap:
            continue
        per_sm = min(TILE_MAX_BLOCKS_PER_SM,
                     limits.smem_per_sm // (smem + SMEM_RESERVED_PER_BLOCK))
        if best is None or per_sm * rows > best[1] * best[0]:
            best = (rows, per_sm, smem)
    if best is None:
        return None
    rows, per_sm, smem = best
    tiles = -(-(h * w) // rows)
    per_sample = max(1, min(tiles, limits.sms * per_sm // b))
    return TilePlan(rows, TILE_STAGES, tile_stride(cs, itemsize), smem, per_sm, tiles,
                    (per_sample, b))


def choose_layout(kernel: str, shape, cg: int, bins: int, dtype: torch.dtype,
                  limits: DeviceLimits = H100) -> str:
    """The layout ``pick_layout`` takes, as a pure function of the call:
    a warp per row for maps with few rows or wide channels; else K1 takes
    the tile layout where its plan applies, and otherwise (and K2 always)
    the row layout where its W (and mask) fit."""
    if kernel not in _KERNELS:
        raise ValueError(f"kernel must be one of {_KERNELS}, got {kernel!r}")
    b, h, w, cs = shape
    many = b * h * w >= ROW_LAYOUT_MIN_ROWS_PER_SM * limits.sms
    if not many or cs > ROW_LAYOUT_MAX_CHANNELS:
        return "warp"
    if kernel == "matching_epilogue" and tile_plan(shape, bins, dtype, limits) is not None:
        return "tile"
    return "row" if row_layout_fits(cs, cg, bins) else "warp"


def pick_layout(kernel: str, x: torch.Tensor, cg: int, bins: int) -> str:
    """The layout the wrapper of ``kernel`` ('matching_epilogue' or
    'matching_scores') launches for ``x`` on its CUDA device."""
    return choose_layout(kernel, tuple(x.shape), cg, bins, x.dtype,
                         device_limits(x.device.index or 0))


def _layout(kernel: str, shape, cg: int, bins: int, dtype, layout: str | None,
            limits: DeviceLimits) -> str:
    """``layout`` None picks as ``pick_layout`` says; 'warp', 'row' or (K1
    only) 'tile' forces one, and raises where it does not apply."""
    if layout is None:
        return choose_layout(kernel, shape, cg, bins, dtype, limits)
    cs = shape[-1]
    if layout not in _LAYOUTS or (layout == "tile" and kernel != "matching_epilogue"):
        allowed = "'warp', 'row' or 'tile'" if kernel == "matching_epilogue" else "'warp' or 'row'"
        raise ValueError(f"{kernel} takes layout {allowed}, got {layout!r}")
    if layout == "row" and not row_layout_fits(cs, cg, bins):
        raise ValueError(f"the row layout's shared memory does not fit Cs={cs}, "
                         f"{bins} bins{' (masked)' if cg < cs else ''}")
    if layout == "tile" and tile_plan(shape, bins, dtype, limits) is None:
        raise ValueError(f"the tile layout does not take Cs={cs} in {dtype}: a row must "
                         f"be whole {GRANULE}-byte granules and its tiles must fit "
                         f"shared memory")
    return layout


class _Plan(NamedTuple):
    ks: ctypes.Array      # k_i as a C int array
    bins: int
    layout: str
    rows_per_block: int   # warp layout
    tile: TilePlan | None


@functools.lru_cache(maxsize=1024)
def _plan(kernel: str, shape, dtype, cg: int, shift: int, offsets: tuple[int, ...],
          window: str, layout: str | None, device_index: int) -> _Plan:
    """What a launch needs beyond the pointers, for one call signature (the
    forward repeats a handful of them)."""
    ks = bin_shifts(shape[-1], cg, shift, offsets, window)
    limits = device_limits(device_index)
    layout = _layout(kernel, shape, cg, len(ks), dtype, layout, limits)
    tile = tile_plan(shape, len(ks), dtype, limits) if layout == "tile" else None
    return _Plan((ctypes.c_int * len(ks))(*ks), len(ks), layout,
                 _rows_per_block(shape, limits.sms), tile)


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
    plan = _plan("matching_epilogue", tuple(x.shape), x.dtype, cs, shift, offsets, window,
                 layout, x.device.index or 0)
    if plan.tile is not None and x.data_ptr() % GRANULE:
        raise ValueError(f"the tile layout needs x {GRANULE}-byte aligned; this x starts "
                         f"at byte {x.data_ptr() % GRANULE} of a granule")
    scores = torch.empty((b, h, w, plan.bins), dtype=x.dtype, device=x.device)
    smax = torch.empty((b, h, w, 1), dtype=x.dtype, device=x.device)
    xnorm = torch.empty((b, h, w, cs), dtype=x.dtype, device=x.device)
    tile = (plan.tile.rows, plan.tile.grid[0], plan.tile.smem) if plan.tile else (0, 0, 0)
    with torch.cuda.device(x.device):
        rc = _kernels().ccvpe_match_epilogue(
            x.data_ptr(), g.data_ptr(), scores.data_ptr(), smax.data_ptr(),
            xnorm.data_ptr(), b, h * w, cs, plan.bins, ctypes.addressof(plan.ks),
            _DTYPE_CODES[x.dtype], _LAYOUTS[plan.layout], plan.rows_per_block,
            *tile,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "matching_epilogue")
    LAUNCHES["matching_epilogue"] += 1
    LAUNCHES_BY_LAYOUT["matching_epilogue", plan.layout] += 1
    return scores, smax, xnorm


def launch_matching_scores(x, g, shift, offsets, window, layout=None):
    """Launch K2 on checked inputs; returns the scores."""
    offsets = tuple(offsets)
    _check(x, g, len(offsets))
    b, h, w, cs = x.shape
    cg = g.shape[1]
    plan = _plan("matching_scores", tuple(x.shape), x.dtype, cg, shift, offsets, window,
                 layout, x.device.index or 0)
    scores = torch.empty((b, h, w, plan.bins), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernels().ccvpe_match_scores(
            x.data_ptr(), g.data_ptr(), scores.data_ptr(), b, h * w, cs, cg,
            plan.bins, ctypes.addressof(plan.ks), _DTYPE_CODES[x.dtype],
            _LAYOUTS[plan.layout], plan.rows_per_block,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "matching_scores")
    LAUNCHES["matching_scores"] += 1
    LAUNCHES_BY_LAYOUT["matching_scores", plan.layout] += 1
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
