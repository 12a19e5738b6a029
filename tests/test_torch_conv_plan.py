"""The decoders' 3x3 conv route and launch plans (``ops.conv_cuda``,
``models.cvm.DoubleConv``), on the CPU: the kernel itself runs only on the
card (``tests/test_torch_conv_cuda.py``)."""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from ccvpe_torch.models import cvm
from ccvpe_torch.nn.layers import Conv2d, QuantConv2d
from ccvpe_torch.ops import conv_cuda as C
from tests.torch_conv_shapes import decoder_conv_shapes

CONFIGS = [cvm.VIGOR, cvm.KITTI, cvm.OXFORD]
# the plans tile VIGOR's widths 40, 80 and 160 (5 * 2**k) with at most this
# share of padded output channels: a tile of Cout computes no more than a
# quarter of its work in vain
MAX_N_WASTE = 0.25


def _gflop(cfg) -> float:
    return sum(2 * b * h * w * 9 * cin * cout
               for _, (b, h, w, cin, cout) in decoder_conv_shapes(cfg, 8)) / 1e9


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_every_decoder_shape_gets_a_plan(cfg):
    shapes = decoder_conv_shapes(cfg, 8)
    assert len(shapes) == 24
    for name, (b, h, w, cin, cout) in shapes:
        launch = C.choose_plan(b, h, w, cin, cout)
        if cout <= 2:
            assert launch.plan == C.DIRECT, name
            continue
        plan = C.PLAN_BY_NAME[launch.plan]
        assert C.n_waste(cout, plan.bn) <= MAX_N_WASTE, (name, launch)
        assert launch.npad % plan.bn == 0 and launch.npad >= cout
        total = 9 * -(-cin // C.BK)
        assert launch.splits * launch.slabs >= total > (launch.splits - 1) * launch.slabs
        assert 1 <= launch.splits <= C.MAX_SPLITS


@pytest.mark.parametrize("cfg,gflop", [(cvm.VIGOR, 348.2), (cvm.KITTI, 319.5),
                                       (cvm.OXFORD, 348.2)], ids=lambda c: getattr(c, "name", ""))
def test_decoder_conv_shapes_match_the_model(cfg, gflop):
    """The 24 convs: two a stage, six stages of sizes 16 to 512 a branch,
    and the FLOPs of a batch-8 call counted from the model's widths."""
    shapes = decoder_conv_shapes(cfg, 8)
    assert len(shapes) == 24
    sizes = [h for _, (_, h, w, _, _) in shapes]
    assert sizes == [16, 16, 32, 32, 64, 64, 128, 128, 256, 256, 512, 512] * 2
    assert all(h == w for _, (_, h, w, _, _) in shapes)
    assert _gflop(cfg) == pytest.approx(gflop, abs=0.05)


def _cuda_like(dtype=torch.float32):
    """What ``takes_kernel`` reads of a tensor, as a CUDA tensor has it."""
    return SimpleNamespace(is_cuda=True, dtype=dtype)


def test_route():
    conv = Conv2d(8, 8, 3, padding=1)
    cpu = torch.zeros(1, 8, 4, 4)
    with torch.no_grad():
        assert C.takes_kernel(_cuda_like(), conv, "kernel")
        assert not C.takes_kernel(cpu, conv, "kernel")
        assert not C.takes_kernel(_cuda_like(torch.bfloat16), conv, "kernel")
        assert not C.takes_kernel(_cuda_like(), conv, "plain")
        quant = QuantConv2d(conv, conv.weight.round(), torch.ones(8), torch.tensor(1.0),
                            conv.bias)
        assert not C.takes_kernel(_cuda_like(), quant, "kernel")
        handle = conv.register_forward_pre_hook(lambda m, a: None)
        assert not C.takes_kernel(_cuda_like(), conv, "kernel")
        handle.remove()
        assert C.takes_kernel(_cuda_like(), conv, "kernel")
    with torch.enable_grad():
        assert not C.takes_kernel(_cuda_like(), conv, "kernel")
    with torch.inference_mode():
        assert C.takes_kernel(_cuda_like(), conv, "kernel")


def _tiny_inputs(cfg, b=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, *cfg.grd_hw, 3, generator=g),
            torch.randn(b, *cfg.sat_hw, 3, generator=g))


def test_cpu_forward_counts_no_launch():
    net = cvm.CVM(cvm.NANO).init_weights_(torch.Generator().manual_seed(0)).eval()
    net = net.to(memory_format=torch.channels_last)
    before = C.launch_counts()
    with torch.inference_mode():
        net(*_tiny_inputs(cvm.NANO), matching_impl="kernel")
    assert C.launch_counts() == before


def test_route_sends_the_24_decoder_convs(monkeypatch):
    """With the CPU let through the route, an inference forward sends
    exactly the 24 decoder convs (the first of each pair with its ReLU) and
    gives the modules' outputs bit for bit; with autograd on, none."""
    cfg = cvm.TINY
    net = cvm.CVM(cfg).init_weights_(torch.Generator().manual_seed(1)).eval()
    net = net.to(memory_format=torch.channels_last)
    sent = []

    def takes_kernel(x, conv, impl):
        return (impl == "kernel" and x.dtype == torch.float32 and not torch.is_grad_enabled()
                and type(conv) is Conv2d)

    def conv3x3(x, weight, bias, relu=False):
        sent.append((tuple(x.shape), tuple(weight.shape), relu))
        return C.conv3x3_plain(x, weight, bias, relu)

    monkeypatch.setattr(C, "takes_kernel", takes_kernel)
    monkeypatch.setattr(C, "conv3x3", conv3x3)
    grd, sat = _tiny_inputs(cfg)
    with torch.inference_mode():
        routed = net(grd, sat, matching_impl="kernel")
        modules = net(grd, sat, matching_impl="plain")
    assert len(sent) == 24
    assert [r for *_, r in sent] == [True, False] * 12
    want = decoder_conv_shapes(cfg, 1)
    assert [(s[0], s[3], s[1], s[2]) for _, s in want] == [x for x, _, _ in sent]
    for a, b in zip(routed[:3], modules[:3]):
        assert torch.equal(a, b)
    sent.clear()
    net(grd, sat, matching_impl="kernel")
    assert sent == []


def test_choose_plan_forced_and_refused():
    assert C.choose_plan(2, 8, 8, 16, 1) == C.Launch(C.DIRECT, 1, 0, 1)
    launch = C.choose_plan(2, 8, 8, 24, 40, plan="n32", splits=3)
    assert launch == C.Launch("n32", 3, 9, 64)
    # 27 slabs in splits of at most 9 slabs: never an empty split
    assert C.choose_plan(2, 8, 8, 24, 40, plan="wide", splits=8).splits == 7
    with pytest.raises(ValueError, match="plan must be"):
        C.choose_plan(2, 8, 8, 24, 40, plan="nope")
    with pytest.raises(ValueError, match="multiple of 4"):
        C.choose_plan(2, 8, 8, 6, 40, plan="n48")
    with pytest.raises(ValueError, match="direct"):
        C.choose_plan(2, 8, 8, 6, 2, plan=C.DIRECT)
    assert not C.PLAN_BY_NAME[C.choose_plan(2, 8, 8, 6, 40).plan].am


@pytest.mark.parametrize("chunk", [C.BK, 12])
def test_packed_weight_layout(chunk):
    cout, cin = 5, 12
    w = torch.randn(cout, cin, 3, 3, generator=torch.Generator().manual_seed(2))
    _check_packed(w, C.packed_weight(w, 8, chunk), chunk)


def _check_packed(w, packed, chunk):
    cout, cin = w.shape[:2]
    cp = -(-cin // chunk) * chunk
    assert packed.shape == (9 * cp, 8)
    assert torch.equal(packed[:, cout:], torch.zeros(9 * cp, 8 - cout))
    for j in range(cp // chunk):
        for ky in range(3):
            for kx in range(3):
                for cc in range(chunk):
                    row = packed[((j * 3 + ky) * 3 + kx) * chunk + cc, :cout]
                    c = j * chunk + cc
                    want = w[:, c, ky, kx] if c < cin else torch.zeros(cout)
                    assert torch.equal(row, want)


def test_packed_weight_follows_every_write():
    """The weight is repacked at every call: a write that bumps no version
    counter (through ``.data``, as an FSDP all-gather or an EMA may write)
    shows in the next packing as an optimizer's in-place step does."""
    w = torch.nn.Parameter(torch.randn(6, 16, 3, 3, generator=torch.Generator().manual_seed(4)))
    first = C.packed_weight(w, 8, C.BK)
    version = w._version
    w.data.copy_(torch.randn(6, 16, 3, 3, generator=torch.Generator().manual_seed(5)))
    assert w._version == version
    _check_packed(w.detach(), C.packed_weight(w, 8, C.BK), C.BK)
    with torch.no_grad():
        w.mul_(2)
    _check_packed(w.detach(), C.packed_weight(w, 8, C.BK), C.BK)
    assert not torch.equal(first, C.packed_weight(w, 8, C.BK))


def test_conv3x3_cpu_is_the_plain_version():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 5, 7, generator=g).contiguous(memory_format=torch.channels_last)
    w, b = torch.randn(4, 8, 3, 3, generator=g), torch.randn(4, generator=g)
    assert torch.equal(C.conv3x3(x, w, b, relu=True), F.relu(F.conv2d(x, w, b, padding=1)))
    assert torch.equal(C.conv3x3(x, w, None), F.conv2d(x, w, None, padding=1))
