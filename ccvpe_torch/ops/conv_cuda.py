"""The decoders' 3x3 convolutions on the card: wrappers of
``ccvpe_torch/csrc/conv3x3.cu``.

``conv3x3(x, weight, bias, relu)`` computes ``act(conv2d(x, weight, bias,
padding=1))`` in float32 with FFMA (no TF32), act a ReLU or the identity,
for a ``channels_last`` float32 ``x`` [B, Cin, H, W] and a [Cout, Cin, 3, 3]
weight, and returns a ``channels_last`` tensor.  It replaces no TPU kernel
(the JAX package leaves these convolutions to XLA); the design is in the
source note of ``conv3x3.cu``: implicit GEMMs (M = B*H*W pixels, N = Cout,
K = 9*Cin).  Where Cin is a multiple of 4 (every decoder conv to Cout > 2,
forward and dgrad) the halo kernel: a block's tile of TH x TW pixels and BN
channels, each chunk of 8 input channels staged once by TMA as a
zero-filled halo tile and its nine taps run from shared memory, four plans
(``PLANS``: h128, h64, h32, h16).  Where it is not (dgrad of the convs to
Cout 1 and 2), the gather, which copies each tap's A itself.  K is split
over blocks where the tiles leave the card's resident slots empty (the
16x16 and 32x32 stages); Cout 1 and 2 take a direct kernel.

With autograd on, ``conv3x3`` is ``Conv3x3Function``, whose backward is
hand-written kernels too: dgrad on the same kernels with the weight
transposed and flipped in its taps (``packed_weight(..., transposed=True)``,
the plan ``choose_plan(B, H, W, Cout, Cin)``), wgrad on
``conv3x3_wgrad_kernel`` (``choose_wgrad_plan`` over ``WGRAD_PLANS``:
rows 9*Cin + 1, columns Cout, K = pixels split over blocks, the bias
gradient from a row of ones), written into the weight's ``channels_last``
layout.  The first conv of a ``DoubleConv`` saves its ReLU's output and
masks the incoming gradient with it once (``threshold_backward``, as the
ReLU's own backward does); dgrad and wgrad read that copy.

``models.cvm.DoubleConv`` sends a conv here where ``takes_kernel`` holds:
``impl`` 'kernel' (``CVM.forward``'s ``matching_impl``; 'plain' means no
hand-written kernel), a CUDA float32 input, a float ``nn.layers.Conv2d``
with no hooks, and with autograd on a float32 weight and bias.  bfloat16
compute or parameters in training, ``QuantConv2d`` and the CPU keep the
modules.

``choose_plan`` and ``choose_wgrad_plan`` pick the plan and the split from
the shape alone, as pure functions that load no library, so the CPU tests
reach them.  For a CUDA tensor ``conv3x3`` checks device, dtype, shape and
layout and raises on anything else; it never falls back to the library.  A
CPU tensor takes ``conv3x3_plain``.  Every call repacks the weight to the
kernels' [K][N] layout (one copy: no cache can miss a write through
``.data`` or into an FSDP buffer) and, for the halo kernel, encodes the two
tensor maps on the host (a CUDA graph keeps those of its capture, which
hold the graph pool's addresses).  Each launch runs inside an operator
(``ccvpe::conv3x3``, ``ccvpe::conv3x3_dgrad``, ``ccvpe::conv3x3_wgrad``),
so a profiler attaches the kernels to it and to the spans around it.
``LAUNCH_COUNTS`` counts the forward and dgrad launches by plan (the halo
plans, the gather, the direct kernel; ``halo_launches`` sums the first),
``PASS_COUNTS`` the convolutions' launches by pass (forward, dgrad, wgrad),
a CUDA graph's at each replay (``ops.graphs.count``).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..nn.layers import Conv2d
from . import _build, graphs
from .matching_cuda import H100, DeviceLimits, device_limits


class ConvPlan(NamedTuple):
    """A forward (and dgrad) plan, as ``conv3x3.cu``'s ``with_plan`` has it
    under the same index (the kernel refuses an N or a Cin its tile does not
    take)."""
    name: str
    th: int          # output rows of a block's tile (the gather: 1)
    tw: int          # output columns of a block's tile (the gather: a run of flattened pixels)
    bn: int          # output channels of a block's tile
    blocks: int      # blocks resident on an SM (registers and shared memory)
    tflops: float    # the plan's rate on its padded tile at large M, H100 (the choice's weight)
    halo: bool       # the halo kernel (Cin a multiple of 4), else the gather


# The halo plans, then the gather, which takes the shapes a tensor map
# cannot stride (Cin not a multiple of 4).  Each halo plan keeps 4 or 8
# consumer warps a block, so an SM's four schedulers get equal shares; the
# rates are launch_cost's, fitted to times of every plan and split at the
# decoders' shapes on an H100 (PERF.md), the gather's from PR 17's n32.
PLANS = (
    ConvPlan("h128", 8, 16, 128, 1, 42.0, True),
    ConvPlan("h64", 8, 16, 64, 3, 45.0, True),
    ConvPlan("h32", 16, 16, 32, 3, 43.0, True),
    ConvPlan("h16", 16, 32, 16, 3, 44.0, True),
    ConvPlan("gather", 1, 256, 32, 3, 30.5, False),
)
PLAN_BY_NAME = {p.name: p for p in PLANS}
HALO_PLANS = tuple(p for p in PLANS if p.halo)
GATHER = "gather"
BK = 8                     # channels of a K chunk (the kernel's kBK)
CHUNK_K = 9 * BK           # K values of a chunk: its nine taps
DIRECT = "direct"          # Cout 1 or 2: conv3x3_direct_kernel
DIRECT_MAX_SMEM = 48 * 1024
MAX_SPLITS = 8
SPLITS = (1, 2, 3, 4, 6, 8)  # the splits of K the chooser weighs
MIN_K_PER_SPLIT = 128      # K values of each split, at least
# launch_cost's model, fitted to times of every plan and split at the decoder
# shapes on an H100 (PERF.md): an SM's rate with 1 or 2 blocks of a plan
# that keeps 3 resident, relative to 3; the extra time of a split of K
OCCUPANCY = (0.5, 0.9)
SPLIT_COST = 0.1


class WgradPlan(NamedTuple):
    """A weight-gradient tile, as ``conv3x3.cu``'s ``with_wgrad_plan`` has it
    under the same index: 9*Cin + 1 rows by Cout columns, A k-major."""
    name: str
    bm: int          # rows (taps' input channels) of a block's tile
    bn: int          # output channels of a block's tile
    blocks: int      # blocks resident on an SM
    tflops: float    # the choice's weight: the forward gather's rate on this tile, H100 (PR 17)


WGRAD_PLANS = (
    WgradPlan("wide", 128, 128, 2, 39.0),
    WgradPlan("n96", 128, 96, 2, 36.3),
    WgradPlan("n64", 128, 64, 3, 35.5),
    WgradPlan("n48", 128, 48, 2, 29.0),
    WgradPlan("n32", 256, 32, 3, 30.5),
    WgradPlan("n16", 256, 16, 4, 26.7),
)
WGRAD_PLAN_BY_NAME = {p.name: p for p in WGRAD_PLANS}
WGRAD_MIN_SLABS = 32       # K slabs (of BK pixels) of a wgrad split, at least

# launches of the halo kernel, the gather and the direct kernel (forward and
# dgrad), by plan; launches by pass
LAUNCH_COUNTS = {name: 0 for name in (*PLAN_BY_NAME, DIRECT)}
PASSES = ("forward", "dgrad", "wgrad")
PASS_COUNTS = {name: 0 for name in PASSES}
_COUNT_LOCK = threading.Lock()


class Launch(NamedTuple):
    plan: str        # a PLANS name or DIRECT
    splits: int      # blocks along K (1: no split)
    steps: int       # K steps of each split: chunks (a halo plan) or slabs of one tap (the gather)
    npad: int        # the packed weight's N: Cout rounded up to the plan's BN


class WgradLaunch(NamedTuple):
    plan: str        # a WGRAD_PLANS name: its tile shape, A k-major
    splits: int      # blocks along K (pixels)
    slabs: int       # K slabs (BK pixels) of each split
    ldw: int         # the workspace's row: 9 * Cin + 1 rounded up to 4


def launch_counts() -> dict[str, int]:
    with _COUNT_LOCK:
        return dict(LAUNCH_COUNTS)


def halo_launches(counts: dict[str, int]) -> int:
    """The halo kernel's launches in ``launch_counts()``-like counts."""
    return sum(counts[p.name] for p in HALO_PLANS)


def pass_counts() -> dict[str, int]:
    with _COUNT_LOCK:
        return dict(PASS_COUNTS)


def _count(plan: str | None, pass_: str = "forward") -> None:
    if plan is not None:
        graphs.count(LAUNCH_COUNTS, _COUNT_LOCK, plan)
    graphs.count(PASS_COUNTS, _COUNT_LOCK, pass_)


def n_waste(cout: int, bn: int) -> float:
    """Output channels a tiling by ``bn`` computes in vain, over Cout."""
    return -(-cout // bn) * bn / cout - 1


def direct_fits(cin: int, cout: int) -> bool:
    return cout in (1, 2) and cin % 4 == 0 and 9 * cin * cout * 4 <= DIRECT_MAX_SMEM


def padded_work(p: ConvPlan, batch: int, h: int, w: int, cout: int) -> int:
    """Output pixels times channels that plan ``p``'s tiles cover (the
    shape's own, and what the tiles round it up to)."""
    n = -(-cout // p.bn) * p.bn
    if p.halo:
        return batch * -(-h // p.th) * p.th * -(-w // p.tw) * p.tw * n
    return -(-(batch * h * w) // p.tw) * p.tw * n


def tiles(p: ConvPlan, batch: int, h: int, w: int, cout: int) -> int:
    return padded_work(p, batch, h, w, cout) // (p.th * p.tw * p.bn)


def launch_cost(p: ConvPlan, batch: int, h: int, w: int, cout: int, splits: int,
                limits: DeviceLimits = H100) -> float:
    """The time of plan ``p`` with K in ``splits`` splits, relative, from a
    model fitted to times on an H100: the busiest SM runs its share of the
    blocks (tiles times splits over the SMs, rounded up) in rounds of the
    plan's resident blocks, a round of fewer at the rate OCCUPANCY gives it;
    a block's work is the padded work over the blocks at the plan's rate; a
    split of K costs SPLIT_COST more (its workspace and their sum)."""
    n_blocks = tiles(p, batch, h, w, cout) * splits
    full, rem = divmod(-(-n_blocks // limits.sms), p.blocks)

    def rate(k: int) -> float:
        return 1.0 if k >= p.blocks else OCCUPANCY[k - 1]

    rounds = full * p.blocks / rate(p.blocks) + (rem / rate(rem) if rem else 0.0)
    return (padded_work(p, batch, h, w, cout) / n_blocks * rounds / p.tflops
            * (1 + SPLIT_COST * (splits > 1)))


@functools.lru_cache(maxsize=1024)
def choose_plan(batch: int, h: int, w: int, cin: int, cout: int,
                limits: DeviceLimits = H100, plan: str | None = None,
                splits: int | None = None) -> Launch:
    """The launch ``conv3x3`` makes for this shape; ``plan`` and ``splits``
    force a plan (any of PLANS, or DIRECT where it fits) or a split of K.
    Cout 1 and 2 take the direct kernel; else the halo plan and split of
    least ``launch_cost`` (the gather where Cin is not a multiple of 4); K
    split in one of SPLITS only where the tiles leave resident slots of the
    card empty, each split keeping MIN_K_PER_SPLIT K values.  A pure
    function of the shape: it loads no library."""
    if plan is None and direct_fits(cin, cout):
        plan = DIRECT
    if plan == DIRECT:
        if not direct_fits(cin, cout):
            raise ValueError(f"the direct kernel takes Cout 1 or 2 and Cin a multiple of 4 "
                             f"whose weight fits {DIRECT_MAX_SMEM} bytes, got Cin={cin}, "
                             f"Cout={cout}")
        return Launch(DIRECT, 1, 0, cout)
    if plan is None:
        plans = HALO_PLANS if cin % 4 == 0 else (PLAN_BY_NAME[GATHER],)
    elif plan in PLAN_BY_NAME:
        plans = (PLAN_BY_NAME[plan],)
        if plans[0].halo and cin % 4:
            raise ValueError(f"plan {plan!r} loads x through a tensor map and takes Cin a "
                             f"multiple of 4, got {cin}")
    else:
        raise ValueError(f"plan must be one of {(*PLAN_BY_NAME, DIRECT)}, got {plan!r}")
    best = None
    for p in plans:
        # K steps: chunks of BK channels (a halo plan) or slabs of one tap's (the gather)
        total = -(-cin // BK) * (1 if p.halo else 9)
        most = max(1, min(MAX_SPLITS, total * (CHUNK_K if p.halo else BK) // MIN_K_PER_SPLIT))
        short = tiles(p, batch, h, w, cout) < limits.sms * p.blocks
        for s in ((splits,) if splits is not None
                  else [s for s in SPLITS if s <= most] if short else (1,)):
            steps = -(-total // s)
            s = -(-total // steps)   # no empty split
            cost = launch_cost(p, batch, h, w, cout, s, limits)
            if best is None or cost < best[0]:
                best = (cost, Launch(p.name, s, steps, -(-cout // p.bn) * p.bn))
    return best[1]


@functools.lru_cache(maxsize=1024)
def choose_wgrad_plan(batch: int, h: int, w: int, cin: int, cout: int,
                      limits: DeviceLimits = H100, plan: str | None = None,
                      splits: int | None = None) -> WgradLaunch:
    """The launch of the weight gradient for this shape: the tile of least
    padded Cout over its rate, over 9 * Cin + 1 rows; K (B*H*W pixels, in
    slabs of BK) split until the tiles fill the resident slots of one wave,
    each split keeping WGRAD_MIN_SLABS slabs.  ``plan`` and ``splits`` force
    them.  A pure function of the shape."""
    if plan is None:
        p = min(WGRAD_PLANS, key=lambda p: -(-cout // p.bn) * p.bn / p.tflops)
    elif plan in WGRAD_PLAN_BY_NAME:
        p = WGRAD_PLAN_BY_NAME[plan]
    else:
        raise ValueError(f"plan must be one of {tuple(WGRAD_PLAN_BY_NAME)}, got {plan!r}")
    rows = 9 * cin + 1
    total = -(-(batch * h * w) // BK)
    if splits is None:
        n_tiles = -(-rows // p.bm) * -(-cout // p.bn)
        most = max(1, total // WGRAD_MIN_SLABS)
        splits = min(most, max(1, limits.sms * p.blocks // n_tiles))
    splits = min(splits, total, 65535)
    slabs = -(-total // splits)
    splits = -(-total // slabs)   # no empty split
    return WgradLaunch(p.name, splits, slabs, -(-rows // 4) * 4)


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                  relu: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch (what the modules compute)."""
    y = F.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype), padding=1)
    return F.relu(y) if relu else y


def takes_kernel(x: torch.Tensor, conv: torch.nn.Module, impl: str) -> bool:
    """Whether ``models.cvm.DoubleConv`` sends ``conv`` on ``x`` to the
    kernels (the route in this module's docstring).  A module with forward
    hooks (``nn.quant.calibrate``'s observers) keeps its own forward; with
    autograd on, so does a conv whose weight or bias is not float32 (the
    gradient would have to flow back through a cast)."""
    if not (impl == "kernel" and x.is_cuda and x.dtype == torch.float32
            and type(conv) is Conv2d and not (conv._forward_hooks or conv._forward_pre_hooks)):
        return False
    return not torch.is_grad_enabled() or all(
        p is None or p.dtype == torch.float32 for p in (conv.weight, conv.bias))


def packed_weight(weight: torch.Tensor, npad: int, chunk: int,
                  transposed: bool = False) -> torch.Tensor:
    """``weight`` [Cout, Cin, 3, 3] as the kernel's B, float32: K runs over
    chunks of ``chunk`` channels (Cin zero-padded to a whole number of
    them), the nine taps of each chunk in turn, so row ((j * 3 + ky) * 3 +
    kx) * chunk + cc holds ``weight[:, j * chunk + cc, ky, kx]``; columns
    zero-padded to ``npad``.  ``transposed``: the weight of dgrad instead,
    ``weight.transpose(0, 1).flip(2, 3)`` ([Cin, Cout, 3, 3]: the input's
    gradient is the conv of the output's gradient with it)."""
    w = weight.detach()
    if transposed:
        w = w.transpose(0, 1).flip(2, 3)
    cout, cin = w.shape[:2]
    cp = -(-cin // chunk) * chunk
    if cp != cin:
        w = F.pad(w, (0, 0, 0, 0, 0, cp - cin))
    packed = torch.empty((cp // chunk, 3, 3, chunk, npad), dtype=torch.float32,
                         device=weight.device)
    packed[..., :cout].copy_(w.reshape(cout, cp // chunk, chunk, 3, 3).permute(1, 3, 4, 2, 0))
    if npad > cout:
        packed[..., cout:].zero_()
    return packed.view(9 * cp, npad)


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = _build.load("conv3x3")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ccvpe_conv3x3.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    lib.ccvpe_conv3x3.restype = i
    lib.ccvpe_conv3x3_direct.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.ccvpe_conv3x3_direct.restype = i
    lib.ccvpe_conv3x3_wgrad.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.ccvpe_conv3x3_wgrad.restype = i
    lib.ccvpe_conv3x3_init.argtypes = []
    lib.ccvpe_conv3x3_init.restype = i
    rc = lib.ccvpe_conv3x3_init()
    if rc != 0:
        raise RuntimeError(f"conv3x3: the driver offers no cuTensorMapEncodeTiled (cudaError {rc})")
    return lib


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> None:
    if x.dtype != torch.float32 or x.dim() != 4:
        raise TypeError(f"conv3x3 takes a float32 [B, Cin, H, W] input, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if weight.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError(f"conv3x3 needs x, weight and bias on one device, got {x.device}, "
                         f"{weight.device}, {None if bias is None else bias.device}")
    if weight.dim() != 4 or tuple(weight.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"conv3x3 needs a [Cout, {x.shape[1]}, 3, 3] weight, got "
                         f"{tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match Cout {weight.shape[0]}")
    if not x.permute(0, 2, 3, 1).is_contiguous():
        raise ValueError("conv3x3 needs a channels_last x (its NHWC view contiguous); no "
                         "silent copy may hide a layout bug")
    if x.numel() == 0:
        raise ValueError(f"conv3x3 got an empty input {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("conv3x3 needs x 16-byte aligned")


def _run(x: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor | None, relu: bool,
         cout: int, plan: str, splits: int, steps: int, npad: int) -> torch.Tensor:
    """Allocate and launch the halo kernel, the gather or the direct kernel on
    ``x`` with the packed weight ``wp``."""
    b, cin, h, w = x.shape
    bp = None if bias is None else bias.to(torch.float32).contiguous()
    out = torch.empty((b, cout, h, w), dtype=torch.float32, device=x.device,
                      memory_format=torch.channels_last)
    bias_ptr = None if bp is None else bp.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan == DIRECT:
            rc = _kernels().ccvpe_conv3x3_direct(x.data_ptr(), wp.data_ptr(), bias_ptr,
                                                 out.data_ptr(), b, h, w, cin, cout, int(relu),
                                                 stream)
        else:
            ws = (torch.empty((splits, b * h * w, cout), dtype=torch.float32, device=x.device)
                  if splits > 1 else None)
            rc = _kernels().ccvpe_conv3x3(
                x.data_ptr(), wp.data_ptr(), bias_ptr, out.data_ptr(),
                None if ws is None else ws.data_ptr(), b, h, w, cin, cout, npad, int(relu),
                PLANS.index(PLAN_BY_NAME[plan]), splits, steps, stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3 ({plan}) launch failed: cudaError {rc}")
    return out


def _launch_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                 relu: bool, plan: str, splits: int, steps: int, npad: int) -> torch.Tensor:
    """The body of ``ccvpe::conv3x3`` on a CUDA tensor: repack, allocate, launch."""
    wp = packed_weight(weight, npad, x.shape[1] if plan == DIRECT else BK)
    return _run(x, wp, bias, relu, weight.shape[0], plan, splits, steps, npad)


def _launch_dgrad_cuda(g: torch.Tensor, weight: torch.Tensor, plan: str, splits: int,
                       steps: int, npad: int) -> torch.Tensor:
    """The body of ``ccvpe::conv3x3_dgrad``: the input's gradient from the
    output's gradient ``g`` (the forward's weight, repacked transposed and
    flipped)."""
    wp = packed_weight(weight, npad, g.shape[1] if plan == DIRECT else BK, transposed=True)
    return _run(g, wp, None, False, weight.shape[1], plan, splits, steps, npad)


def _launch_wgrad_cuda(x: torch.Tensor, g: torch.Tensor, plan: str, splits: int, slabs: int,
                       ldw: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The body of ``ccvpe::conv3x3_wgrad``: the weight's gradient, in the
    ``channels_last`` layout, and the bias's."""
    b, cin, h, w = x.shape
    cout = g.shape[1]
    ws = torch.empty((splits, cout, ldw), dtype=torch.float32, device=x.device)
    dw = torch.empty((cout, cin, 3, 3), dtype=torch.float32, device=x.device,
                     memory_format=torch.channels_last)
    db = torch.empty((cout,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _kernels().ccvpe_conv3x3_wgrad(
            x.data_ptr(), g.data_ptr(), ws.data_ptr(), dw.data_ptr(), db.data_ptr(), b, h, w,
            cin, cout, WGRAD_PLANS.index(WGRAD_PLAN_BY_NAME[plan]), splits, slabs, ldw, stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3 wgrad ({plan}) launch failed: cudaError {rc}")
    return dw, db


# The launches as dispatcher operators: a profiler records ``ccvpe::conv3x3``
# (and its dgrad and wgrad) around them and attaches the kernels to them (a
# ctypes launch outside any operator links to none, so a span's readers
# would not see it).
_LIB = torch.library.Library("ccvpe", "DEF")
_LIB.define("conv3x3(Tensor x, Tensor weight, Tensor? bias, bool relu, str plan, int splits, "
            "int steps, int npad) -> Tensor")
_LIB.impl("conv3x3", _launch_cuda, "CUDA")
_LIB.define("conv3x3_dgrad(Tensor g, Tensor weight, str plan, int splits, int steps, "
            "int npad) -> Tensor")
_LIB.impl("conv3x3_dgrad", _launch_dgrad_cuda, "CUDA")
_LIB.define("conv3x3_wgrad(Tensor x, Tensor g, str plan, int splits, int slabs, int ldw) "
            "-> (Tensor, Tensor)")
_LIB.impl("conv3x3_wgrad", _launch_wgrad_cuda, "CUDA")


def _check_size(x: torch.Tensor, cout: int, splits: int) -> None:
    b, cin, h, w = x.shape
    if b * h * w * max(cin, cout * splits) >= 2 ** 31:
        raise ValueError(f"conv3x3 indexes with 32-bit ints; {tuple(x.shape)} to "
                         f"{cout} channels ({splits} splits) is too large")


def _conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, relu: bool,
             launch: Launch) -> torch.Tensor:
    """The kernel on a checked CUDA ``x`` with the launch given (tests force
    one through ``choose_plan``'s ``plan`` and ``splits``)."""
    _check_size(x, weight.shape[0], launch.splits)
    out = torch.ops.ccvpe.conv3x3(x, weight, bias, relu, *launch)
    _count(launch.plan, "forward")
    return out


def _conv3x3_dgrad(g: torch.Tensor, weight: torch.Tensor, launch: Launch) -> torch.Tensor:
    """dgrad on a checked CUDA ``g`` with the launch given."""
    _check_size(g, weight.shape[1], launch.splits)
    out = torch.ops.ccvpe.conv3x3_dgrad(g, weight, *launch)
    _count(launch.plan, "dgrad")
    return out


def _conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor, launch: WgradLaunch
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """wgrad on checked CUDA ``x`` and ``g`` with the launch given."""
    _check_size(x, g.shape[1], 1)
    dw, db = torch.ops.ccvpe.conv3x3_wgrad(x, g, *launch)
    _count(None, "wgrad")
    return dw, db


def _limits(x: torch.Tensor) -> DeviceLimits:
    return device_limits(x.device.index or 0)


def _forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
             relu: bool) -> torch.Tensor:
    b, cin, h, w = x.shape
    return _conv3x3(x, weight, bias, relu,
                    choose_plan(b, h, w, cin, weight.shape[0], _limits(x)))


def _dgrad(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    b, cout, h, w = g.shape
    return _conv3x3_dgrad(g, weight, choose_plan(b, h, w, cout, weight.shape[1], _limits(g)))


def _wgrad(x: torch.Tensor, g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    b, cin, h, w = x.shape
    return _conv3x3_wgrad(x, g, choose_wgrad_plan(b, h, w, cin, g.shape[1], _limits(x)))


def _dense(g: torch.Tensor) -> torch.Tensor:
    """An incoming gradient as the kernels read it: channels_last, 16-byte
    aligned."""
    g = g.contiguous(memory_format=torch.channels_last)
    return g if g.data_ptr() % 16 == 0 else g.clone(memory_format=torch.channels_last)


class Conv3x3Function(torch.autograd.Function):
    """``conv3x3`` with autograd: its forward is the inference launch; its
    backward masks the gradient by the ReLU's output (``relu``), then runs
    dgrad and wgrad (``_forward``, ``_dgrad``, ``_wgrad``: the module's
    launchers, looked up at each call)."""

    @staticmethod
    def forward(ctx, x, weight, bias, relu):
        y = _forward(x, weight, bias, relu)
        ctx.relu = relu
        ctx.save_for_backward(x, weight, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, weight, y = ctx.saved_tensors
        gy = _dense(gy)
        if ctx.relu:
            gy = torch.ops.aten.threshold_backward(gy, y, 0)
        dx = _dgrad(gy, weight) if ctx.needs_input_grad[0] else None
        dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = _wgrad(x, gy)
        return dx, dw, db if ctx.needs_input_grad[2] else None, None


def _dispatch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
              relu: bool = False) -> torch.Tensor:
    """With autograd on, ``Conv3x3Function``; off, the forward's launch alone."""
    if torch.is_grad_enabled():
        return Conv3x3Function.apply(x, weight, bias, relu)
    return _forward(x, weight, bias, relu)


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
            relu: bool = False) -> torch.Tensor:
    """``act(conv2d(x, weight, bias, padding=1))`` for a ``channels_last``
    float32 ``x``, as a ``channels_last`` tensor: the kernels on a CUDA
    tensor, in the plans ``choose_plan`` and ``choose_wgrad_plan`` pick (with
    autograd on, ``Conv3x3Function``); the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias, relu)
    _check(x, weight, bias)
    return _dispatch(x, weight, bias, relu)
