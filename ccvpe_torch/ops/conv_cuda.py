"""The decoders' 3x3 convolutions on the card: wrappers of
``ccvpe_torch/csrc/conv3x3.cu``.

``conv3x3(x, weight, bias, relu)`` computes ``act(conv2d(x, weight, bias,
padding=1))`` in float32 with FFMA (no TF32), act a ReLU or the identity,
for a ``channels_last`` float32 ``x`` [B, Cin, H, W] and a [Cout, Cin, 3, 3]
weight, and returns a ``channels_last`` tensor.  It replaces no TPU kernel
(the JAX package leaves these convolutions to XLA); the design is in the
source note of ``conv3x3.cu``: an implicit GEMM (M = B*H*W pixels, N = Cout,
K = 9*Cin) with six tile plans, a split of K over blocks where the tiles
are too few for the card (the 16x16 and 32x32 stages), and a direct kernel
for Cout 1 and 2.

``models.cvm.DoubleConv`` sends a conv here where ``takes_kernel`` holds:
``impl`` 'kernel' (``CVM.forward``'s ``matching_impl``; 'plain' means no
hand-written kernel), a CUDA float32 input, autograd off (as under
``predict_batch``'s ``inference_mode``), a float ``nn.layers.Conv2d`` with no
hooks.  Training, bfloat16, ``QuantConv2d`` and the CPU keep the modules.

``choose_plan`` picks the plan and the split from the shape alone, as a pure
function that loads no library, so the CPU tests reach it.  For a CUDA
tensor ``conv3x3`` checks device, dtype, shape and layout and raises on
anything else; it never falls back to the library.  A CPU tensor takes
``conv3x3_plain``.  Every call repacks the weight to the kernel's [K][N]
layout (one copy: no cache can miss a write through ``.data`` or into an
FSDP buffer).  The launch runs inside the operator ``ccvpe::conv3x3``, so a
profiler attaches the kernels to it and to the spans around it.
``LAUNCH_COUNTS`` counts the convolutions launched, by plan, a CUDA graph's
at each replay (``ops.graphs.count``).
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
    """A GEMM tile plan, as ``conv3x3.cu``'s ``with_plan`` has it under the
    same index (the kernel refuses an N or a Cin its tile does not take)."""
    name: str
    bm: int          # output pixels of a block's tile
    bn: int          # output channels of a block's tile
    am: bool         # A m-major from 16-byte copies (Cin a multiple of 4), else k-major
    blocks: int      # blocks resident on an SM (registers and shared memory)
    tflops: float    # the plan's rate on its padded tile at large M, H100 (the choice's weight)


# From times on an H100 at the decoders' shapes (PERF.md): the 128x128 tile
# is fastest per padded FLOP, the narrower ones lose rate with the A tile's
# reuse across N but waste less of it on Cout 40, 80 and 160.
PLANS = (
    ConvPlan("wide", 128, 128, False, 2, 39.0),
    ConvPlan("n96", 128, 96, True, 2, 36.3),
    ConvPlan("n64", 128, 64, False, 3, 35.5),
    ConvPlan("n48", 128, 48, True, 2, 29.0),
    ConvPlan("n32", 256, 32, False, 3, 30.5),
    ConvPlan("n16", 256, 16, True, 4, 26.7),
)
PLAN_BY_NAME = {p.name: p for p in PLANS}
BK = 8                     # channels of one tap in a K slab (the kernel's kBK)
STAGES = 3                 # slabs in the shared-memory ring
DIRECT = "direct"          # Cout 1 or 2: conv3x3_direct_kernel
DIRECT_MAX_SMEM = 48 * 1024
MAX_SPLITS = 8
MIN_SLABS_PER_SPLIT = 16
LONG_K = 256               # slabs from which a plan short of a full wave splits K in two

# convolutions launched on the CUDA path, by plan
LAUNCH_COUNTS = {name: 0 for name in (*PLAN_BY_NAME, DIRECT)}
_COUNT_LOCK = threading.Lock()


class Launch(NamedTuple):
    plan: str        # a PLANS name or DIRECT
    splits: int      # blocks along K (1: no split)
    slabs: int       # K slabs of each split
    npad: int        # the packed weight's N: Cout rounded up to the plan's BN


def launch_counts() -> dict[str, int]:
    with _COUNT_LOCK:
        return dict(LAUNCH_COUNTS)


def _count(plan: str) -> None:
    graphs.count(LAUNCH_COUNTS, _COUNT_LOCK, plan)


def n_waste(cout: int, bn: int) -> float:
    """Output channels a tiling by ``bn`` computes in vain, over Cout."""
    return -(-cout // bn) * bn / cout - 1


def direct_fits(cin: int, cout: int) -> bool:
    return cout in (1, 2) and cin % 4 == 0 and 9 * cin * cout * 4 <= DIRECT_MAX_SMEM


def _fastest_plan(cin: int, cout: int) -> ConvPlan:
    """The plan with the least padded Cout over its rate (m-major plans
    only where Cin is a multiple of 4)."""
    fits = [p for p in PLANS if not (p.am and cin % 4)]
    return min(fits, key=lambda p: -(-cout // p.bn) * p.bn / p.tflops)


def _splits(tiles: int, total: int, p: ConvPlan, limits: DeviceLimits) -> int:
    """Blocks along K, from times on an H100.  Where the tiles do not give
    every SM a block (the 16x16 and 32x32 stages at 128x128), the split
    whose blocks fill the last of their waves of resident slots the most
    (the fewest on a tie); where they fill fewer than the resident slots and
    K is long, two; else one.  Each split keeps MIN_SLABS_PER_SPLIT slabs."""
    most = max(1, min(MAX_SPLITS, total // MIN_SLABS_PER_SPLIT))
    slots = limits.sms * p.blocks
    if tiles < limits.sms:
        return max(range(1, most + 1),
                   key=lambda s: (tiles * s / (-(-tiles * s // slots) * slots), -s))
    if tiles < slots and total >= LONG_K:
        return min(2, most)
    return 1


@functools.lru_cache(maxsize=1024)
def choose_plan(batch: int, h: int, w: int, cin: int, cout: int,
                limits: DeviceLimits = H100, plan: str | None = None,
                splits: int | None = None) -> Launch:
    """The launch ``conv3x3`` makes for this shape; ``plan`` and ``splits``
    force a plan (any of PLANS, or DIRECT where it fits) or a split of K.
    Cout 1 and 2 take the direct kernel; otherwise the plan with the least
    padded Cout over its rate (``_fastest_plan``), K split as ``_splits``
    says.  A pure function of the shape: it loads no library."""
    if plan is None and direct_fits(cin, cout):
        plan = DIRECT
    if plan == DIRECT:
        if not direct_fits(cin, cout):
            raise ValueError(f"the direct kernel takes Cout 1 or 2 and Cin a multiple of 4 "
                             f"whose weight fits {DIRECT_MAX_SMEM} bytes, got Cin={cin}, "
                             f"Cout={cout}")
        return Launch(DIRECT, 1, 0, cout)
    if plan is None:
        p = _fastest_plan(cin, cout)
    elif plan in PLAN_BY_NAME:
        p = PLAN_BY_NAME[plan]
        if p.am and cin % 4:
            raise ValueError(f"plan {plan!r} copies 4 channels at once and takes Cin a "
                             f"multiple of 4, got {cin}")
    else:
        raise ValueError(f"plan must be one of {(*PLAN_BY_NAME, DIRECT)}, got {plan!r}")
    total = 9 * -(-cin // BK)
    tiles = -(-(batch * h * w) // p.bm) * -(-cout // p.bn)
    splits = _splits(tiles, total, p, limits) if splits is None else splits
    slabs = -(-total // splits)
    splits = -(-total // slabs)   # no empty split
    return Launch(p.name, splits, slabs, -(-cout // p.bn) * p.bn)


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                  relu: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch (what the modules compute)."""
    y = F.conv2d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype), padding=1)
    return F.relu(y) if relu else y


def takes_kernel(x: torch.Tensor, conv: torch.nn.Module, impl: str) -> bool:
    """Whether ``models.cvm.DoubleConv`` sends ``conv`` on ``x`` to the
    kernel (the route in this module's docstring).  A module with forward
    hooks (``nn.quant.calibrate``'s observers) keeps its own forward."""
    return (impl == "kernel" and x.is_cuda and x.dtype == torch.float32
            and not torch.is_grad_enabled() and type(conv) is Conv2d
            and not (conv._forward_hooks or conv._forward_pre_hooks))


def packed_weight(weight: torch.Tensor, npad: int, chunk: int) -> torch.Tensor:
    """``weight`` [Cout, Cin, 3, 3] as the kernel's B, float32: K runs over
    chunks of ``chunk`` channels (Cin zero-padded to a whole number of
    them), the nine taps of each chunk in turn, so row ((j * 3 + ky) * 3 +
    kx) * chunk + cc holds ``weight[:, j * chunk + cc, ky, kx]``; columns
    zero-padded to ``npad``."""
    cout, cin = weight.shape[:2]
    cp = -(-cin // chunk) * chunk
    w = weight.detach()
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


def _launch_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                 relu: bool, plan: str, splits: int, slabs: int, npad: int) -> torch.Tensor:
    """The body of ``ccvpe::conv3x3`` on a CUDA tensor: repack, allocate, launch."""
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    wp = packed_weight(weight, npad, cin if plan == DIRECT else BK)
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
                PLANS.index(PLAN_BY_NAME[plan]), splits, slabs, stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3 ({plan}) launch failed: cudaError {rc}")
    return out


# The launch as a dispatcher operator: a profiler records ``ccvpe::conv3x3``
# around it and attaches the kernels to it (a ctypes launch outside any
# operator links to none, so a span's readers would not see it).
_LIB = torch.library.Library("ccvpe", "DEF")
_LIB.define("conv3x3(Tensor x, Tensor weight, Tensor? bias, bool relu, str plan, int splits, "
            "int slabs, int npad) -> Tensor")
_LIB.impl("conv3x3", _launch_cuda, "CUDA")


def _conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, relu: bool,
             launch: Launch) -> torch.Tensor:
    """The kernel on a checked CUDA ``x`` with the launch given (tests force
    one through ``choose_plan``'s ``plan`` and ``splits``)."""
    b, cin, h, w = x.shape
    if b * h * w * max(cin, weight.shape[0] * launch.splits) >= 2 ** 31:
        raise ValueError(f"conv3x3 indexes with 32-bit ints; {tuple(x.shape)} to "
                         f"{weight.shape[0]} channels ({launch.splits} splits) is too large")
    out = torch.ops.ccvpe.conv3x3(x, weight, bias, relu, *launch)
    _count(launch.plan)
    return out


def conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
            relu: bool = False) -> torch.Tensor:
    """``act(conv2d(x, weight, bias, padding=1))`` for a ``channels_last``
    float32 ``x``, as a ``channels_last`` tensor: the kernel on a CUDA
    tensor, in the plan ``choose_plan`` picks; the plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias, relu)
    _check(x, weight, bias)
    b, cin, h, w = x.shape
    launch = choose_plan(b, h, w, cin, weight.shape[0], device_limits(x.device.index or 0))
    return _conv3x3(x, weight, bias, relu, launch)
