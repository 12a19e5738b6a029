"""The decoders' 3x3 conv kernel (``ops.conv_cuda``, ``csrc/conv3x3.cu``)
on the card, against ``F.conv2d`` in float64 there.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without them.
This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_conv_cuda.py

Tolerance: each output is a float32 sum of 9 * Cin products (up to 12096
at the 16x16 stages) in the kernel's order, against the float64 sum.  The
typical rounding of such a sum is about sqrt(K) * 2**-24 of the terms'
scale, 6.6e-6 at K = 12096; measured on an H100 the kernel stays within
2.9e-6 of the output's largest magnitude at every decoder shape, and cuDNN's
float32 conv within 3.4e-6.  So the bar is 1e-5 of that magnitude.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ccvpe_torch import api
from ccvpe_torch.models import cvm
from ccvpe_torch.ops import conv_cuda as C
from ccvpe_torch.ops import gt as GT
from ccvpe_torch.train import loop as TLOOP
from tests.torch_conv_shapes import decoder_conv_shapes

pytestmark = pytest.mark.cuda

REL_TOL = 1e-5
SHAPES = sorted({s for cfg in (cvm.VIGOR, cvm.KITTI, cvm.OXFORD)
                 for _, s in decoder_conv_shapes(cfg, 8)})


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, h, w, cin, cout, seed=0, border=1.0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, cin, h, w, generator=g).relu()
    x[:, :, 0] *= border
    x[:, :, -1] *= border
    x[:, :, :, 0] *= border
    x[:, :, :, -1] *= border
    wt = torch.randn(cout, cin, 3, 3, generator=g) / (9 * cin) ** 0.5
    bias = torch.randn(cout, generator=g) * 0.1
    return (x.to(dev).contiguous(memory_format=torch.channels_last), wt.to(dev), bias.to(dev))


def _check(x, wt, bias, relu, **force):
    """The kernel against a float64 conv; ``force``: ``choose_plan``'s
    ``plan`` and ``splits``."""
    if force:
        b, cin, h, w = x.shape
        got = C._conv3x3(x, wt, bias, relu, C.choose_plan(b, h, w, cin, wt.shape[0], **force))
    else:
        got = C.conv3x3(x, wt, bias, relu=relu)
    want = F.conv2d(x.double(), wt.double(), bias.double(), padding=1)
    want = want.relu() if relu else want
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.permute(0, 2, 3, 1).is_contiguous()
    err = (got.double() - want).abs().max().item() / want.abs().max().item()
    assert err <= REL_TOL, err


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_decoder_shapes_match_conv2d(dev, shape):
    x, wt, bias = _inputs(dev, *shape)
    before = C.launch_counts()[C.choose_plan(*shape).plan]
    _check(x, wt, bias, relu=True)
    torch.cuda.synchronize()
    assert C.launch_counts()[C.choose_plan(*shape).plan] == before + 1


@pytest.mark.parametrize("plan", [p.name for p in C.PLANS] + [C.DIRECT])
@pytest.mark.parametrize("cin", [20, 24, 56])
@pytest.mark.parametrize("relu", [False, True])
def test_ragged_shapes_every_plan(dev, plan, cin, relu):
    """Batch 3, 17x33 (tiles straddle rows and images), Cin a multiple of 8
    but not of 16 (24, 56) or of 4 only (20: the last slab of each tap half
    zero-padding), Cout not a multiple of any tile, and a split of K."""
    cout = 2 if plan == C.DIRECT else 37
    x, wt, bias = _inputs(dev, 3, 17, 33, cin, cout, seed=cin)
    _check(x, wt, bias, relu, plan=plan)
    if plan != C.DIRECT:
        _check(x, wt, bias, relu, plan=plan, splits=3)


@pytest.mark.parametrize("plan", ["wide", "n32"])
def test_large_border_values(dev, plan):
    """Border taps that carry 1e4 times the interior: a zero-filled tap
    outside the image that were not zero would show at once."""
    x, wt, bias = _inputs(dev, 2, 9, 14, 40, 64, seed=3, border=1e4)
    _check(x, wt, bias, relu=False, plan=plan)


def test_cin_not_multiple_of_four_takes_k_major_plans(dev):
    x, wt, bias = _inputs(dev, 2, 11, 7, 6, 16, seed=4)
    assert not C.PLAN_BY_NAME[C.choose_plan(2, 11, 7, 6, 16).plan].am
    _check(x, wt, bias, relu=True)


def test_refuses_what_it_does_not_take(dev):
    x, wt, bias = _inputs(dev, 2, 8, 8, 16, 32)
    with pytest.raises(ValueError, match="channels_last"):
        C.conv3x3(x.contiguous(), wt, bias)
    with pytest.raises(TypeError):
        C.conv3x3(x.half(), wt, bias)
    with pytest.raises(ValueError, match="weight"):
        C.conv3x3(x, wt[:, :8], bias)
    with pytest.raises(ValueError, match="direct"):
        _check(x, wt, bias, False, plan=C.DIRECT)
    x6, wt6, bias6 = _inputs(dev, 2, 8, 8, 6, 16)
    with pytest.raises(ValueError, match="multiple of 4"):
        _check(x6, wt6, bias6, False, plan="n16")
    # a plan whose tile the library does not take for this N
    with pytest.raises(RuntimeError, match="launch failed"):
        C._conv3x3(x, wt, bias, False, C.Launch("wide", 1, 18, 64))


def test_weight_written_through_data_is_followed(dev):
    """A write through ``.data`` bumps no version counter; the next call
    computes with the new weight all the same."""
    x, wt, bias = _inputs(dev, 2, 8, 8, 16, 32)
    wt = torch.nn.Parameter(wt)
    with torch.inference_mode():
        before = C.conv3x3(x, wt, bias)
    version = wt._version
    wt.data.mul_(-2.0)
    assert wt._version == version
    with torch.inference_mode():
        after = C.conv3x3(x, wt, bias)
    want = F.conv2d(x.double(), wt.detach().double(), bias.double(), padding=1)
    assert (after.double() - want).abs().max().item() <= REL_TOL * want.abs().max().item()
    assert not torch.equal(before, after)


def test_profiler_sees_the_kernel_under_its_op(dev):
    """The kernels run inside the operator ``ccvpe::conv3x3``, so a profiler
    attaches them to it and to the spans around it."""
    x, wt, bias = _inputs(dev, 2, 16, 16, 64, 64)
    C.conv3x3(x, wt, bias)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        C.conv3x3(x, wt, bias)
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.name == "ccvpe::conv3x3"]
    assert len(ops) == 1
    assert any("conv3x3_gemm_kernel" in k.name for k in ops[0].kernels), ops[0].kernels


def _model(cfg, dev):
    net = cvm.CVM(cfg).init_weights_(torch.Generator().manual_seed(0))
    net = net.eval().to(device=dev, memory_format=torch.channels_last)
    return api.CVMModel(cfg, net, dev)


@pytest.mark.parametrize("cfg", [cvm.VIGOR, cvm.KITTI], ids=lambda c: c.name)
def test_predict_batch_launches_24(dev, cfg):
    model = _model(cfg, dev)
    rng = np.random.default_rng(0)
    grd = rng.integers(0, 256, (2, *cfg.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 256, (2, *cfg.sat_hw, 3), dtype=np.uint8)
    before = sum(C.launch_counts().values())
    model.predict_batch(grd, sat)
    torch.cuda.synchronize()
    assert sum(C.launch_counts().values()) - before == 24
    plain = api.CVMModel(cfg, model.net, dev, matching_impl="plain")
    before = sum(C.launch_counts().values())
    plain.predict_batch(grd, sat)
    assert sum(C.launch_counts().values()) == before


def test_train_step_launches_none(dev):
    cfg = cvm.VIGOR
    state = TLOOP.create_train_state(cfg, seed=0, device=dev)
    step = TLOOP.make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    b = 2
    off = (torch.rand((2, b), generator=gen, device=dev) * 2 - 1) * 100
    angle = torch.rand((b,), generator=gen, device=dev) * 360
    gt, weights, omap = GT.synthesize_batch_factored(
        off[0], off[1], angle, height=cfg.sat_hw[0], width=cfg.sat_hw[1], bins=cfg.bins)
    grd = torch.randn((b, *cfg.grd_hw, 3), generator=gen, device=dev)
    sat = torch.randn((b, *cfg.sat_hw, 3), generator=gen, device=dev)
    before = sum(C.launch_counts().values())
    parts = step(state, {"grd": grd, "sat": sat, "gt": gt, "bin_weights": weights,
                         "orientation": omap})
    torch.cuda.synchronize()
    assert torch.isfinite(parts["loss"])
    assert sum(C.launch_counts().values()) == before
