"""Wrappers of the CUDA matching kernels in ``ccvpe_torch/csrc/matching.cu``.

* K1, ``matching_epilogue_cuda``, replaces the fused Pallas TPU kernel
  ``ccvpe_tpu/ops/pallas_matching.py::_kernel_fused`` (``pallas_call`` at
  ``:225``): scores, max over bins and the l2-normalised feature map from one
  read of x (Cg == Cs; every VIGOR scale).
* K2, ``matching_scores_cuda``, replaces ``_kernel`` (``pallas_call`` at
  ``:116``): scores alone, with the per-bin masked window norm when Cg < Cs
  (the ori-prior full-bin bottleneck stack; the limited-fov VIGOR scales;
  Oxford and KITTI scales).

Both are bound by device-memory bytes, not arithmetic: at 20 bins they do
about 4 FLOP per byte they move.  So the kernels read x once and write each
output once (the design is in the source note of ``matching.cu``).  Each
kernel has a warp per pixel row for maps with few rows (the coarse scales,
wide channels) and a thread per pixel row for maps with many (the fine
scales, narrow channels).  Both have a third layout for the fine scales,
``tile``: persistent blocks that copy tiles of rows in 16-byte granules
through a ring in shared memory and write all outputs from there.  K2's
tile (also at 320 channels) may give a thread two rows and a ring of one
stage, and takes its window norms from per-segment sums of x^2: the
channels between two neighbouring window edges form a segment, and each
bin's window is a cyclic run of whole segments (``window_segments``,
``window_blocks``).  ``pick_layout`` chooses; ``window_segments``,
``tile_plan`` (tile rows, rows per thread, stages, shared memory, grid) and
``choose_layout`` are pure functions of the shape, the bins, the dtype and
the device's limits, and load no library.

A wrapper takes a CPU tensor to the kernel's plain version in
``ops/matching.py``.  For a CUDA tensor it checks device, dtype, shape and
NHWC contiguity and raises on anything else (no silent copy may hide a
layout bug), allocates the outputs with ``torch.empty``, launches on the
current stream and raises if the launch failed; it never falls back to the
plain version.  ``LAUNCH_COUNTS`` counts the launches of each (kernel,
layout, 'float32' or 'bfloat16') under a lock; ``launch_counts`` sums them
by kernel, layout or dtype.  The backward is
autograd through the plain version (the TPU kernels' custom VJPs do the
same through the einsum), so the kernels also serve training.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from ..utils.profiling import annotate
from . import _build, graphs
from .matching import bin_shifts, matching_epilogue_plain, matching_scores_plain

# kernel launches on the CUDA path, by (kernel, layout, dtype); reset with
# reset_launch_counts
LAUNCH_COUNTS = {(k, lay, d): 0 for k in ("matching_epilogue", "matching_scores")
                 for lay in ("warp", "row", "tile") for d in ("float32", "bfloat16")}
_COUNT_LOCK = threading.Lock()
_FIELDS = ("layout", "dtype")

MAX_BINS = 32
MAX_CHANNELS = 4096  # warp layout: 2 * Cs f32 descriptor copies in 48 KB of shared memory
ROW_LAYOUT_MAX_SMEM = 200 * 1024  # row layout: the kernel's dynamic shared-memory cap
# The row and tile layouts serve maps of at most this many channels with at
# least this many pixel rows per SM (enough 128-row blocks to fill the card).
# On an H100 the row layout beats the warp layout at the VIGOR scales of 40,
# 80 and 160 channels and loses at 320 and above (chip_smoke.py's
# kernel_times); both kernels take their tile layout there wherever its plan
# applies, which measured faster than the row layout at all three
# (ms_by_layout).
ROW_LAYOUT_MAX_CHANNELS = 160
ROW_LAYOUT_MIN_ROWS_PER_SM = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LAYOUTS = {"warp": 0, "row": 1, "tile": 2}
_KERNELS = ("matching_epilogue", "matching_scores")

# Tile layout: these constants are the kernel's (matching.cu).
GRANULE = 16                   # bytes of one cp.async copy and one store
MAX_SEGMENTS = 2 * MAX_BINS + 1  # window edges k_i, k_i + Cg and channel 0
TILE_ROWS = (128, 64, 32)      # K1: rows per tile = threads per block, largest first
TILE_STAGES = 2                # K1: tiles in the shared-memory ring
TILE_MAX_BLOCKS_PER_SM = 4     # __launch_bounds__ minimum: registers allow this many
# K2's tile plans as (threads, rows per thread, stages), in the order the
# plan tries them (the first whose shared memory fits one block).  From
# times on an H100 at the VIGOR scales K2's tile takes (chip_smoke.py's
# ms_by_tile_plan): two rows per thread, 64 threads and one stage where a
# row is at most K2_TILE_NARROW bytes; else a row per thread, 128 threads
# and two stages where they fit.  __launch_bounds__ guarantees 4 blocks of
# 128 threads at one row per thread and 2 at two.
K2_TILE_NARROW = 320
K2_TILE_PLANS_NARROW = ((64, 2, 1),)
K2_TILE_PLANS = ((128, 1, 2), (128, 1, 1), (64, 1, 2), (64, 1, 1), (32, 1, 2), (32, 1, 1))
K2_TILE_MAX_CHANNELS = 320     # K2 takes its tile up to 320 channels (32x32x320 VIGOR)
SMEM_RESERVED_PER_BLOCK = 1024  # shared memory the CUDA runtime keeps per block


class DeviceLimits(NamedTuple):
    sms: int                    # streaming multiprocessors
    smem_per_sm: int            # shared memory of one SM, bytes


H100 = DeviceLimits(sms=132, smem_per_sm=228 * 1024)


class Segments(NamedTuple):
    """The window norms of K2 as sums of per-segment sums of x^2.  Segment j
    is channels [ends[j-1], ends[j]) (from 0 for j = 0); bin i's window is
    segments first[i], first[i] + 1, ... (mod the count), count[i] of them."""
    ends: tuple[int, ...]
    first: tuple[int, ...]
    count: tuple[int, ...]


class WindowBlocks(NamedTuple):
    """How K2's tile kernel adds up each window from two sums per segment,
    with no loop over the window's segments.  The segments fall into blocks
    of ``block`` consecutive ones (the last block may be shorter); within
    its block, segment j has the prefix sum P[j] (from the block's first
    segment through j) and the suffix sum Q[j] (from j through the block's
    last).  Bin i's window is Q[suffix[i]], the blocks whole[i], whole[i] +
    1, ... (nwhole[i] of them, each Q of its first segment) and, unless
    prefix[i] is -1, P[prefix[i]]."""
    block: int
    suffix: tuple[int, ...]
    prefix: tuple[int, ...]
    whole: tuple[int, ...]
    nwhole: tuple[int, ...]


class TilePlan(NamedTuple):
    rows: int                   # pixel rows per tile = threads per block x rpt
    stages: int
    stride: int                 # staged row stride in 16-byte granules (odd)
    smem: int                   # dynamic shared memory per block, bytes
    blocks_per_sm: int          # resident blocks per SM at that shared memory
    tiles: int                  # tiles per sample
    grid: tuple[int, int]       # (blocks per sample, batch)
    rpt: int = 1                # pixel rows per thread (K2; K1 takes 1)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in LAUNCH_COUNTS:
            LAUNCH_COUNTS[k] = 0


def launch_counts(*by: str) -> dict:
    """``LAUNCH_COUNTS`` summed over the fields not in ``by`` ('layout',
    'dtype'): by kernel name when ``by`` is empty, else by (kernel, *by)."""
    keep = [_FIELDS.index(f) + 1 for f in by]
    out: dict = {}
    with _COUNT_LOCK:
        for key, n in LAUNCH_COUNTS.items():
            k = (key[0], *(key[i] for i in keep)) if keep else key[0]
            out[k] = out.get(k, 0) + n
    return out


def _count(kernel: str, layout: str, dtype: torch.dtype) -> None:
    """One launch of ``kernel`` in ``layout`` on ``dtype`` inputs (a CUDA
    graph's at each replay, ``ops.graphs.count``)."""
    graphs.count(LAUNCH_COUNTS, _COUNT_LOCK, (kernel, layout, str(dtype).removeprefix("torch.")))


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = _build.load("matching")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ccvpe_match_epilogue.argtypes = [p, p, p, p, p, i, i, i, i, p, i, i, i, i, i, i, p]
    lib.ccvpe_match_epilogue.restype = i
    lib.ccvpe_match_scores.argtypes = [p, p, p, i, i, i, i, i, p, i, i, i, i, i, i, i, i,
                                       i, p, i, p, p, p, p, p]
    lib.ccvpe_match_scores.restype = i
    lib.ccvpe_match_row_smem_bytes.argtypes = [i, i, i]
    lib.ccvpe_match_row_smem_bytes.restype = i
    lib.ccvpe_match_tile_smem_bytes.argtypes = [i, i, i, i]
    lib.ccvpe_match_tile_smem_bytes.restype = i
    lib.ccvpe_match_tile_blocks_per_sm.argtypes = [i, i, i, i, i]
    lib.ccvpe_match_tile_blocks_per_sm.restype = i
    lib.ccvpe_match_scores_tile_smem_bytes.argtypes = [i, i, i, i, i, i]
    lib.ccvpe_match_scores_tile_smem_bytes.restype = i
    lib.ccvpe_match_scores_tile_blocks_per_sm.argtypes = [i, i, i, i, i, i]
    lib.ccvpe_match_scores_tile_blocks_per_sm.restype = i
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


def window_segments(cs: int, cg: int, ks) -> Segments:
    """K2's windows as cyclic runs of segments.  The window of bin i is the
    Cg channels from k_i on, cyclically, so its edges k_i and (k_i + Cg) mod
    Cs, with channel 0, cut [0, Cs) into segments (at most 2 bins + 1), and
    every window is a run of whole segments.  Where Cg == Cs there is one
    segment, the whole row.  Sums of non-negative segment sums, never
    differences of prefix sums, so a window of zeros gives exactly 0."""
    ks = tuple(int(k) for k in ks)
    if not 0 < cg <= cs or any(not 0 <= k < cs for k in ks):
        raise ValueError(f"need 0 < Cg <= Cs and 0 <= k_i < Cs, got Cs={cs}, Cg={cg}, k={ks}")
    if cg == cs:
        return Segments((cs,), (0,) * len(ks), (1,) * len(ks))
    starts = sorted({0, *ks, *((k + cg) % cs for k in ks)})
    index = {c: j for j, c in enumerate(starts)}
    n = len(starts)
    first = tuple(index[k] for k in ks)
    count = tuple((index[(k + cg) % cs] - index[k]) % n for k in ks)
    return Segments((*starts[1:], cs), first, count)


def window_blocks(seg: Segments) -> WindowBlocks:
    """The pieces of each window (``WindowBlocks``).  Blocks are as long as
    the shortest window, so no window starts and ends inside one block: each
    is a suffix, whole blocks and a prefix, all sums of non-negative terms.
    Where every window has the same count and the count divides the
    segments (the VIGOR windows), that is two sums per bin."""
    n = len(seg.ends)
    block = min(seg.count)
    nblocks = -(-n // block)
    suffix, prefix, whole, nwhole = [], [], [], []
    for f, c in zip(seg.first, seg.count):
        end = min(n, (f // block + 1) * block)       # end of f's block
        left, pos = c - (end - f), end % n
        suffix.append(f)
        whole.append(pos // block)
        k = 0
        while left and left >= min(block, n - pos):  # whole blocks
            left -= min(block, n - pos)
            pos = (pos + min(block, n - pos)) % n
            k += 1
        nwhole.append(k)
        prefix.append(pos + left - 1 if left else -1)
    assert all(0 <= w < nblocks for w in whole)
    return WindowBlocks(block, tuple(suffix), tuple(prefix), tuple(whole), tuple(nwhole))


def max_segments(cs: int, cg: int, bins: int) -> int:
    """The most segments ``window_segments`` gives for ``bins`` windows."""
    return 1 if cg == cs else 2 * bins + 1


def tile_smem_bytes(cs: int, bins: int, itemsize: int, rows: int,
                    kernel: str = "matching_epilogue", nseg: int = 1,
                    stages: int = TILE_STAGES) -> int:
    """Shared memory of the tile layout (matching.cu's ``tile_smem`` for K1,
    ``scores_tile_smem`` for K2): the ring of ``stages`` staged tiles, W
    [Cs][bins padded to 4] f32, a tile's scores (with up to one granule of
    lead), then K1's smax (the same lead) and 1/||X|| per row, or, where K2
    has more than one segment, its prefix and suffix sums of x^2 per segment
    and row and a bit per channel marking the segments' ends; last g."""
    v = GRANULE // itemsize
    epi = kernel == "matching_epilogue"
    return (stages * rows * tile_stride(cs, itemsize) * GRANULE + cs * _nb(bins) * 4
            + _round16((rows * bins + v) * itemsize)
            + (_round16((rows + v) * itemsize) + rows * 4 if epi else 0)
            + (2 * nseg * rows * 4 + _round16(-(-cs // 32) * 4) if not epi and nseg > 1 else 0)
            + _round16(cs * 4))


def _k2_reg_blocks(threads: int, rpt: int) -> int:
    """Blocks per SM that K2's tile kernel's registers allow at least (its
    __launch_bounds__)."""
    return (TILE_MAX_BLOCKS_PER_SM if rpt == 1 else 2) * 128 // threads


def tile_plan(shape, bins: int, dtype: torch.dtype, limits: DeviceLimits = H100,
              kernel: str = "matching_epilogue", nseg: int = 1) -> TilePlan | None:
    """Launch plan of the tile layout of ``kernel`` (K2: with ``nseg``
    window segments) for x of ``shape`` [B,H,W,Cs], or None where it does
    not apply: Cs * itemsize not a multiple of 16 bytes, or no tile that
    fits one block's shared memory.  K1: of the tile sizes that fit, the one
    with the most rows resident per SM (the larger on a tie); K2: the first
    of its plans (``K2_TILE_PLANS_NARROW``, ``K2_TILE_PLANS``) that fits.
    The grid keeps every block resident: (resident blocks // B) blocks per
    sample, at least 1 and at most the sample's tiles.  A pure function: it
    loads no library, so the CPU tests reach it."""
    b, h, w, cs = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    if (cs * itemsize) % GRANULE or not 1 <= bins <= MAX_BINS or not 1 <= nseg <= MAX_SEGMENTS:
        return None
    if kernel == "matching_scores":
        return _k2_tile_plan(shape, bins, itemsize, limits, nseg)
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


def _k2_tile_plan(shape, bins: int, itemsize: int, limits: DeviceLimits,
                  nseg: int) -> TilePlan | None:
    b, h, w, cs = shape
    cap = limits.smem_per_sm - SMEM_RESERVED_PER_BLOCK
    narrow = cs * itemsize <= K2_TILE_NARROW
    for threads, rpt, stages in (K2_TILE_PLANS_NARROW if narrow else ()) + K2_TILE_PLANS:
        rows = threads * rpt
        smem = tile_smem_bytes(cs, bins, itemsize, rows, "matching_scores", nseg, stages)
        if smem <= cap:
            per_sm = min(_k2_reg_blocks(threads, rpt),
                         limits.smem_per_sm // (smem + SMEM_RESERVED_PER_BLOCK))
            tiles = -(-(h * w) // rows)
            per_sample = max(1, min(tiles, limits.sms * per_sm // b))
            return TilePlan(rows, stages, tile_stride(cs, itemsize), smem, per_sm, tiles,
                            (per_sample, b), rpt)
    return None


def choose_layout(kernel: str, shape, cg: int, bins: int, dtype: torch.dtype,
                  limits: DeviceLimits = H100, nseg: int | None = None) -> str:
    """The layout ``pick_layout`` takes, as a pure function of the call:
    a warp per row for maps with few rows or wide channels (K1: over 160,
    K2: over 320); else the tile layout where its plan applies (K2: with
    ``nseg`` window segments, or as many as ``bins`` windows can make), and
    otherwise, up to 160 channels, the row layout where its W (and mask)
    fit."""
    if kernel not in _KERNELS:
        raise ValueError(f"kernel must be one of {_KERNELS}, got {kernel!r}")
    b, h, w, cs = shape
    many = b * h * w >= ROW_LAYOUT_MIN_ROWS_PER_SM * limits.sms
    widest = K2_TILE_MAX_CHANNELS if kernel == "matching_scores" else ROW_LAYOUT_MAX_CHANNELS
    if not many or cs > widest:
        return "warp"
    nseg = max_segments(cs, cg, bins) if nseg is None else nseg
    if tile_plan(shape, bins, dtype, limits, kernel, nseg) is not None:
        return "tile"
    return "row" if cs <= ROW_LAYOUT_MAX_CHANNELS and row_layout_fits(cs, cg, bins) else "warp"


def pick_layout(kernel: str, x: torch.Tensor, cg: int, bins: int) -> str:
    """The layout the wrapper of ``kernel`` ('matching_epilogue' or
    'matching_scores') launches for ``x`` on its CUDA device."""
    return choose_layout(kernel, tuple(x.shape), cg, bins, x.dtype,
                         device_limits(x.device.index or 0))


def _layout(kernel: str, shape, cg: int, bins: int, dtype, layout: str | None,
            limits: DeviceLimits, nseg: int = 1) -> str:
    """``layout`` None picks as ``pick_layout`` says; 'warp', 'row' or 'tile'
    forces one, and raises where it does not apply."""
    if layout is None:
        return choose_layout(kernel, shape, cg, bins, dtype, limits, nseg)
    cs = shape[-1]
    if layout not in _LAYOUTS:
        raise ValueError(f"{kernel} takes layout 'warp', 'row' or 'tile', got {layout!r}")
    if layout == "row" and not row_layout_fits(cs, cg, bins):
        raise ValueError(f"the row layout's shared memory does not fit Cs={cs}, "
                         f"{bins} bins{' (masked)' if cg < cs else ''}")
    if layout == "tile" and tile_plan(shape, bins, dtype, limits, kernel, nseg) is None:
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
    windows: tuple  # K2's tile: segments, their ends, then WindowBlocks' fields as C ints


def _c_ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=1024)
def _plan(kernel: str, shape, dtype, cg: int, shift: int, offsets: tuple[int, ...],
          window: str, layout: str | None, device_index: int) -> _Plan:
    """What a launch needs beyond the pointers, for one call signature (the
    forward repeats a handful of them)."""
    ks = bin_shifts(shape[-1], cg, shift, offsets, window)
    seg = window_segments(shape[-1], cg, ks)
    nseg = len(seg.ends)
    limits = device_limits(device_index)
    layout = _layout(kernel, shape, cg, len(ks), dtype, layout, limits, nseg)
    tile = tile_plan(shape, len(ks), dtype, limits, kernel, nseg) if layout == "tile" else None
    wb = window_blocks(seg)
    return _Plan(_c_ints(ks), len(ks), layout, _rows_per_block(shape, limits.sms), tile,
                 (nseg, _c_ints(seg.ends), wb.block, _c_ints(wb.suffix), _c_ints(wb.prefix),
                  _c_ints(wb.whole), _c_ints(wb.nwhole)))


def _check_aligned(plan: _Plan, x: torch.Tensor) -> None:
    if plan.tile is not None and x.data_ptr() % GRANULE:
        raise ValueError(f"the tile layout needs x {GRANULE}-byte aligned; this x starts "
                         f"at byte {x.data_ptr() % GRANULE} of a granule")


def _tile_args(plan: _Plan) -> tuple[int, int, int]:
    """(rows, blocks per sample, shared memory) of a tile launch, else 0s."""
    return (plan.tile.rows, plan.tile.grid[0], plan.tile.smem) if plan.tile else (0, 0, 0)


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
    _check_aligned(plan, x)
    scores = torch.empty((b, h, w, plan.bins), dtype=x.dtype, device=x.device)
    smax = torch.empty((b, h, w, 1), dtype=x.dtype, device=x.device)
    xnorm = torch.empty((b, h, w, cs), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernels().ccvpe_match_epilogue(
            x.data_ptr(), g.data_ptr(), scores.data_ptr(), smax.data_ptr(),
            xnorm.data_ptr(), b, h * w, cs, plan.bins, ctypes.addressof(plan.ks),
            _DTYPE_CODES[x.dtype], _LAYOUTS[plan.layout], plan.rows_per_block,
            *_tile_args(plan),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "matching_epilogue")
    _count("matching_epilogue", plan.layout, x.dtype)
    return scores, smax, xnorm


def launch_matching_scores(x, g, shift, offsets, window, layout=None):
    """Launch K2 on checked inputs; returns the scores."""
    offsets = tuple(offsets)
    _check(x, g, len(offsets))
    b, h, w, cs = x.shape
    cg = g.shape[1]
    plan = _plan("matching_scores", tuple(x.shape), x.dtype, cg, shift, offsets, window,
                 layout, x.device.index or 0)
    _check_aligned(plan, x)
    scores = torch.empty((b, h, w, plan.bins), dtype=x.dtype, device=x.device)
    nseg, ends, block, *pieces = plan.windows
    with torch.cuda.device(x.device):
        rc = _kernels().ccvpe_match_scores(
            x.data_ptr(), g.data_ptr(), scores.data_ptr(), b, h * w, cs, cg,
            plan.bins, ctypes.addressof(plan.ks), _DTYPE_CODES[x.dtype],
            _LAYOUTS[plan.layout], plan.rows_per_block, *_tile_args(plan),
            *((plan.tile.stages, plan.tile.rpt) if plan.tile else (0, 0)),
            nseg, ctypes.addressof(ends), block, *map(ctypes.addressof, pieces),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(rc, "matching_scores")
    _count("matching_scores", plan.layout, x.dtype)
    return scores


def _plain_grads(plain, x, g, args, grads_out):
    """The kernels' backward: autograd through the plain version, in the
    span ``matching.backward`` (on autograd's thread, so the kernels it
    launches are the span's children)."""
    with annotate("matching.backward"), torch.enable_grad():
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
