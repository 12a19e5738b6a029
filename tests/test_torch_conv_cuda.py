"""The decoders' 3x3 conv kernels (``ops.conv_cuda``, ``csrc/conv3x3.cu``)
on the card, against ``F.conv2d`` and its gradients in float64 there.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without them.
This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_conv_cuda.py

Tolerance: each output is a float32 sum of 9 * Cin products (up to 12096
at the 16x16 stages) in the kernel's order, against the float64 sum.  The
typical rounding of such a sum is about sqrt(K) * 2**-24 of the terms'
scale, 6.6e-6 at K = 12096; measured on an H100 the kernel stays within
2.9e-6 of the output's largest magnitude at every decoder shape, and cuDNN's
float32 conv within 3.4e-6.  So the bar is 1e-5 of that magnitude.  dgrad
sums 9 * Cout products a pixel, wgrad B*H*W (up to 2.1 M) in splits of a
few thousand, then the splits in order: the same bar, on each gradient's
largest magnitude.
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

import math

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
    """Every decoder shape of VIGOR, KITTI and Oxford at batch 8 under its
    plan: the halo kernel but for Cout 1 and 2 (the direct kernel)."""
    x, wt, bias = _inputs(dev, *shape)
    plan = C.choose_plan(*shape).plan
    assert C.PLAN_BY_NAME[plan].halo if shape[4] > 2 else plan == C.DIRECT
    before = C.launch_counts()[plan]
    _check(x, wt, bias, relu=True)
    torch.cuda.synchronize()
    assert C.launch_counts()[plan] == before + 1


@pytest.mark.parametrize("plan", [p.name for p in C.PLANS] + [C.DIRECT])
@pytest.mark.parametrize("cin", [20, 24, 56])
@pytest.mark.parametrize("relu", [False, True])
def test_ragged_shapes_every_plan(dev, plan, cin, relu):
    """Batch 3, 17x33 (H and W multiples of no tile: the halo tiles hang
    over the bottom and right edges, the gather's straddle rows and images),
    Cin a multiple of 8 but not of 16 (24, 56) or of 4 only (20: the last
    chunk half zero-padding, from the tensor map's out-of-bounds fill),
    Cout not a multiple of any tile, and a split of K."""
    cout = 2 if plan == C.DIRECT else 37
    x, wt, bias = _inputs(dev, 3, 17, 33, cin, cout, seed=cin)
    _check(x, wt, bias, relu, plan=plan)
    if plan != C.DIRECT:
        _check(x, wt, bias, relu, plan=plan, splits=3)


@pytest.mark.parametrize("plan", [p.name for p in C.PLANS])
def test_large_border_values(dev, plan):
    """Border taps that carry 1e4 times the interior: a halo pixel or tap
    outside the image that were not zero-filled would show at once."""
    x, wt, bias = _inputs(dev, 2, 9, 14, 40, 64, seed=3, border=1e4)
    _check(x, wt, bias, relu=False, plan=plan)


@pytest.mark.parametrize("plan", [p.name for p in C.HALO_PLANS])
@pytest.mark.parametrize("shape", [(2, 5, 7, 12, 20), (1, 1, 1, 8, 16), (3, 2, 40, 4, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_halo_images_smaller_than_a_tile(dev, plan, shape):
    """Images smaller than one tile (one pixel; two rows), Cin 4, 8 and 12
    (a chunk partly past Cin), forward with its border 1e3 times the
    interior and dgrad, under every halo plan."""
    x, wt, bias = _inputs(dev, *shape, seed=5, border=1e3)
    _check(x, wt, bias, relu=True, plan=plan)
    b, h, w, cin, cout = shape
    gy = torch.randn(b, cout, h, w, generator=torch.Generator().manual_seed(6)).to(dev)
    gy = gy.contiguous(memory_format=torch.channels_last)
    got = C._conv3x3_dgrad(gy, wt, C.choose_plan(b, h, w, cout, cin, plan=plan))
    want = torch.nn.grad.conv2d_input(tuple(x.shape), wt.double(), gy.double(), padding=1)
    assert _rel(got, want) <= REL_TOL


def test_cin_not_multiple_of_four_takes_k_major_plans(dev):
    """A tensor map cannot stride Cin 6: the gather takes it."""
    x, wt, bias = _inputs(dev, 2, 11, 7, 6, 16, seed=4)
    assert C.choose_plan(2, 11, 7, 6, 16).plan == C.GATHER
    before = C.launch_counts()[C.GATHER]
    _check(x, wt, bias, relu=True)
    assert C.launch_counts()[C.GATHER] == before + 1


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
        _check(x6, wt6, bias6, False, plan="h16")
    # a plan whose tile the library does not take for this N
    with pytest.raises(RuntimeError, match="launch failed"):
        C._conv3x3(x, wt, bias, False, C.Launch("h128", 1, 2, 64))
    # a halo plan on Cin 6, which no tensor map strides
    with pytest.raises(RuntimeError, match="launch failed"):
        C._conv3x3(x6, wt6, bias6, False, C.Launch("h16", 1, 1, 16))


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
    assert any("conv3x3_halo_kernel" in k.name for k in ops[0].kernels), ops[0].kernels


def _model(cfg, dev):
    net = cvm.CVM(cfg).init_weights_(torch.Generator().manual_seed(0))
    net = net.eval().to(device=dev, memory_format=torch.channels_last)
    return api.CVMModel(cfg, net, dev)


@pytest.mark.parametrize("cfg", [cvm.VIGOR, cvm.KITTI], ids=lambda c: c.name)
def test_predict_batch_launches_24(dev, cfg):
    """24 launches a call, eager (the first) and replayed: 22 on the halo
    kernel, the two convs to Cout 1 and 2 on the direct kernel."""
    model = _model(cfg, dev)
    rng = np.random.default_rng(0)
    grd = rng.integers(0, 256, (2, *cfg.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 256, (2, *cfg.sat_hw, 3), dtype=np.uint8)
    for _ in range(2):
        before = C.launch_counts()
        model.predict_batch(grd, sat)
        torch.cuda.synchronize()
        after = C.launch_counts()
        grew = {k: after[k] - before[k] for k in after}
        assert sum(grew.values()) == 24
        assert (C.halo_launches(grew), grew[C.DIRECT]) == (22, 2), grew
    plain = api.CVMModel(cfg, model.net, dev, matching_impl="plain")
    before = sum(C.launch_counts().values())
    plain.predict_batch(grd, sat)
    assert sum(C.launch_counts().values()) == before


def _vigor_batch(cfg, dev, b=2, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    off = (torch.rand((2, b), generator=gen, device=dev) * 2 - 1) * 100
    angle = torch.rand((b,), generator=gen, device=dev) * 360
    gt, weights, omap = GT.synthesize_batch_factored(
        off[0], off[1], angle, height=cfg.sat_hw[0], width=cfg.sat_hw[1], bins=cfg.bins)
    grd = torch.randn((b, *cfg.grd_hw, 3), generator=gen, device=dev)
    sat = torch.randn((b, *cfg.sat_hw, 3), generator=gen, device=dev)
    return {"grd": grd, "sat": sat, "gt": gt, "bin_weights": weights, "orientation": omap}


def test_train_step_launches_none(dev):
    """A VIGOR train step sends its 24 decoder convs through
    ``Conv3x3Function``: 24 forward, 24 dgrad and 24 wgrad launches (and no
    cuDNN convolution for them); a ``predict_batch`` 24 forward alone.  (The
    name is from when a train step kept the modules and launched none.)"""
    cfg = cvm.VIGOR
    state = TLOOP.create_train_state(cfg, seed=0, device=dev)
    step = TLOOP.make_train_step(cfg)
    before = C.pass_counts()
    parts = step(state, _vigor_batch(cfg, dev))
    torch.cuda.synchronize()
    assert torch.isfinite(parts["loss"])
    after = C.pass_counts()
    assert {k: after[k] - before[k] for k in C.PASSES} == {"forward": 24, "dgrad": 24,
                                                           "wgrad": 24}
    model = api.CVMModel(cfg, state.model.eval(), dev)
    rng = np.random.default_rng(1)
    before = C.pass_counts()
    model.predict_batch(rng.integers(0, 256, (2, *cfg.grd_hw, 3), dtype=np.uint8),
                        rng.integers(0, 256, (2, *cfg.sat_hw, 3), dtype=np.uint8))
    torch.cuda.synchronize()
    after = C.pass_counts()
    assert {k: after[k] - before[k] for k in C.PASSES} == {"forward": 24, "dgrad": 0,
                                                           "wgrad": 0}


def _grad_inputs(dev, b, h, w, cin, cout, seed=0, border=1.0):
    x, wt, bias = _inputs(dev, b, h, w, cin, cout, seed, border)
    g = torch.Generator().manual_seed(seed + 1)
    gy = torch.randn(b, cout, h, w, generator=g).to(dev).contiguous(
        memory_format=torch.channels_last)
    return x, wt, bias, gy


def _rel(got, want):
    return (got.double() - want).abs().max().item() / want.abs().max().item()


def _check_grads(x, wt, bias, gy, relu):
    """The Function's forward and backward against float64 ``conv2d_input``,
    ``conv2d_weight`` and the bias sum of the output's gradient, masked by
    the kernel's own forward output where ``relu`` (the mask is the
    forward's; near-zero outputs may round to either side).  Returns the
    gradients."""
    xg, wg, bg = (t.detach().clone().requires_grad_() for t in (x, wt, bias))
    y = C.conv3x3(xg, wg, bg, relu=relu)
    assert y.grad_fn is not None and type(y.grad_fn).__name__.startswith("Conv3x3Function")
    y.backward(gy)
    g64 = gy.double() * (y.detach() > 0) if relu else gy.double()
    want_dx = torch.nn.grad.conv2d_input(tuple(x.shape), wt.double(), g64, padding=1)
    want_dw = torch.nn.grad.conv2d_weight(x.double(), tuple(wt.shape), g64, padding=1)
    want_db = g64.sum((0, 2, 3))
    for got, want, name in ((xg.grad, want_dx, "dx"), (wg.grad, want_dw, "dw"),
                            (bg.grad, want_db, "db")):
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        err = _rel(got, want)
        assert err <= REL_TOL, (name, err)
    assert xg.grad.permute(0, 2, 3, 1).is_contiguous()
    return xg.grad, wg.grad, bg.grad


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_decoder_shapes_backward(dev, shape):
    """dgrad and wgrad with the bias gradient at every decoder shape of
    VIGOR, KITTI and Oxford at batch 8 (with and without the ReLU), and the
    same gradients bit for bit when run again."""
    x, wt, bias, gy = _grad_inputs(dev, *shape)
    before = C.pass_counts()
    grads = _check_grads(x, wt, bias, gy, relu=True)
    again = _check_grads(x, wt, bias, gy, relu=True)
    after = C.pass_counts()
    assert {k: after[k] - before[k] for k in C.PASSES} == {"forward": 2, "dgrad": 2, "wgrad": 2}
    for a, b in zip(grads, again):
        assert torch.equal(a, b)
    _check_grads(x, wt, bias, gy, relu=False)


@pytest.mark.parametrize("plan", [p.name for p in C.PLANS] + [C.DIRECT])
@pytest.mark.parametrize("cin", [6, 20, 24, 56])
def test_ragged_backward_every_plan(dev, plan, cin):
    """Batch 3, 17x33, Cin 6 (not a multiple of 4: wgrad's scalar gather),
    20, 24, 56; Cout 36 under a halo plan (dgrad's input, g, needs a
    multiple of 4), 37 under the gather and, under the direct plan's
    shapes, 1 and 2 (dgrad with Cin 1 or 2: the gather; wgrad's scalar
    loads of g): dgrad under the plan, with and without a split of K, and
    wgrad with 1, 3 and the chosen number of splits under every wgrad plan
    (the direct case) or one of them in turn."""
    if plan == C.DIRECT:
        couts, dgrad_plans, wgrad_plans = (1, 2), [C.GATHER], [p.name for p in C.WGRAD_PLANS]
    else:
        couts = (36,) if C.PLAN_BY_NAME[plan].halo else (37,)
        dgrad_plans = [plan]
        wgrad_plans = [C.WGRAD_PLANS[C.PLANS.index(C.PLAN_BY_NAME[plan])
                                     % len(C.WGRAD_PLANS)].name]
    for cout in couts:
        x, wt, bias, gy = _grad_inputs(dev, 3, 17, 33, cin, cout, seed=cin + cout)
        g64 = gy.double()
        want_dx = torch.nn.grad.conv2d_input(tuple(x.shape), wt.double(), g64, padding=1)
        for p in dgrad_plans:
            for splits in (1, 3):
                got = C._conv3x3_dgrad(gy, wt, C.choose_plan(3, 17, 33, cout, cin, plan=p,
                                                             splits=splits))
                assert _rel(got, want_dx) <= REL_TOL, (p, splits)
        want_dw = torch.nn.grad.conv2d_weight(x.double(), tuple(wt.shape), g64, padding=1)
        want_db = g64.sum((0, 2, 3))
        for p in wgrad_plans:
            for splits in (1, 3, None):
                dw, db = C._conv3x3_wgrad(x, gy, C.choose_wgrad_plan(3, 17, 33, cin, cout,
                                                                     plan=p, splits=splits))
                assert dw.is_contiguous(memory_format=torch.channels_last)
                assert _rel(dw, want_dw) <= REL_TOL, (p, splits)
                assert _rel(db, want_db) <= REL_TOL, (p, splits)


def test_backward_border_values(dev):
    """Border pixels of x and of the output's gradient that carry 1e4 times
    the interior: a tap outside the image that wgrad did not zero, or a
    halo pixel of g that dgrad's tensor map did not zero-fill, would show
    at once."""
    x, wt, bias, gy = _grad_inputs(dev, 2, 9, 14, 40, 64, seed=3, border=1e4)
    for edge in (gy[:, :, 0], gy[:, :, -1], gy[:, :, :, 0], gy[:, :, :, -1]):
        edge.mul_(1e4)
    _check_grads(x, wt, bias, gy, relu=False)


def test_backward_refuses_what_it_does_not_take(dev):
    x, wt, bias, gy = _grad_inputs(dev, 2, 8, 8, 16, 32)
    with pytest.raises(RuntimeError, match="launch failed"):
        C._conv3x3_wgrad(x, gy, C.WgradLaunch("wide", 1, 15, 148))   # 16 slabs, 15 taken
    with pytest.raises(RuntimeError, match="launch failed"):
        C._conv3x3_wgrad(x, gy, C.WgradLaunch("wide", 1, 16, 146))   # ldw not a multiple of 4


def _step_pair(cfg, dev, remat):
    """One train step of the kernel path and one of the plain path from the
    same weights and batch."""
    got = TLOOP.create_train_state(cfg, seed=0, device=dev)
    want = TLOOP.create_train_state(cfg, seed=0, device=dev)
    batch = _vigor_batch(cfg, dev)
    got_parts = TLOOP.make_train_step(cfg, remat=remat)(got, batch)
    want_parts = TLOOP.make_train_step(cfg, matching_impl="plain", remat=remat)(want, batch)
    return got, want, got_parts, want_parts


# the kernel step against the plain step (chip_smoke's TRAIN_TOL): loss parts
# rtol; each gradient ||d|| <= rel * ||g_plain|| + abs * grad_norm
STEP_TOL = {"loss_rtol": 1e-5, "grad_rel": 1e-3, "grad_abs": 1e-6}


def _held_to(got, want, got_parts, want_parts):
    for k, v in want_parts.items():
        a, b = got_parts[k].item(), v.item()
        assert math.isfinite(a) and abs(a - b) <= STEP_TOL["loss_rtol"] * abs(b), (k, a, b)
    norm = want_parts["grad_norm"].item()
    theirs = dict(want.model.named_parameters())
    for k, p in got.model.named_parameters():
        q = theirs[k]
        assert (p.grad is None) == (q.grad is None), k
        if q.grad is None:
            continue
        d = (p.grad - q.grad).norm().item()
        assert d <= STEP_TOL["grad_rel"] * q.grad.norm().item() + STEP_TOL["grad_abs"] * norm, k


@pytest.mark.parametrize("remat", [False, "decoder"])
def test_train_step_matches_plain(dev, remat):
    """The VIGOR step with the decoders' convs on the kernels (and, with
    ``remat='decoder'``, the Function's forward run again in the backward)
    against the step on the modules with ``matching_impl='plain'``."""
    cfg = cvm.VIGOR
    before = C.pass_counts()
    got, want, got_parts, want_parts = _step_pair(cfg, dev, remat)
    after = C.pass_counts()
    assert {k: after[k] - before[k] for k in C.PASSES} == {
        "forward": 48 if remat else 24, "dgrad": 24, "wgrad": 24}
    _held_to(got, want, got_parts, want_parts)


def _gloo_rank(rank, port, d):
    import torch.distributed as dist

    from ccvpe_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=2)
    cfg = cvm.VIGOR
    inp = torch.load(f"{d}/inputs.pt", weights_only=True)
    state = TLOOP.train_state_from_torch(inp["model"], cfg, device="cuda")
    local = {k: v.cuda() for k, v in mesh.shard_batch(inp["batch"]).items()}
    before = C.pass_counts()
    parts = TLOOP.make_train_step(cfg)(state, local)
    torch.cuda.synchronize()
    after = C.pass_counts()
    grads = {k: p.grad.cpu() for k, p in state.model.named_parameters() if p.grad is not None}
    torch.save({"parts": {k: v.cpu() for k, v in parts.items()}, "grads": grads,
                "passes": {k: after[k] - before[k] for k in C.PASSES}}, f"{d}/rank{rank}.pt")
    dist.destroy_process_group()


def test_two_gloo_ranks_match_the_plain_step(dev, tmp_path):
    """Two gloo ranks on the card, each on its half of a batch of 4 through
    the kernels (DDP's reduction of the Function's gradients), against one
    process's step on the whole batch with ``matching_impl='plain'``."""
    import socket

    import torch.multiprocessing as mp

    cfg = cvm.VIGOR
    model = TLOOP.create_train_state(cfg, seed=0, device="cpu").model
    batch = {k: v.cpu() for k, v in _vigor_batch(cfg, dev, b=4).items()}
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.save({"model": sd, "batch": batch}, tmp_path / "inputs.pt")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mp.start_processes(_gloo_rank, args=(port, str(tmp_path)), nprocs=2, start_method="spawn")
    want = TLOOP.train_state_from_torch(sd, cfg, device=dev)
    want_parts = TLOOP.make_train_step(cfg, matching_impl="plain")(
        want, {k: v.to(dev) for k, v in batch.items()})
    theirs = {k: p.grad for k, p in want.model.named_parameters() if p.grad is not None}
    norm = want_parts["grad_norm"].item()
    for rank in (0, 1):
        got = torch.load(tmp_path / f"rank{rank}.pt", weights_only=True)
        assert got["passes"] == {"forward": 24, "dgrad": 24, "wgrad": 24}
        for k, v in want_parts.items():
            a, b = got["parts"][k].item(), v.item()
            assert abs(a - b) <= STEP_TOL["loss_rtol"] * abs(b), (rank, k, a, b)
        assert got["grads"].keys() == theirs.keys()
        for k, q in theirs.items():
            d = (got["grads"][k].to(dev) - q).norm().item()
            lim = STEP_TOL["grad_rel"] * q.norm().item() + STEP_TOL["grad_abs"] * norm
            assert d <= lim, (rank, k, d, lim)
