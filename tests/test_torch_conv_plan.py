"""The decoders' 3x3 conv route and launch plans (``ops.conv_cuda``,
``models.cvm.DoubleConv``), the backward's formulations (dgrad as a conv with
the repacked weight, wgrad as a GEMM over pixels) and the autograd Function
with plain launchers, on the CPU: the kernels themselves run only on the
card (``tests/test_torch_conv_cuda.py``)."""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from ccvpe_torch.models import cvm
from ccvpe_torch.nn.layers import Conv2d, QuantConv2d
from ccvpe_torch.ops import conv_cuda as C
from ccvpe_torch.ops import gt as GT
from ccvpe_torch.train import loop as TLOOP
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
    """Every decoder conv to Cout > 2 takes a halo plan (its Cin is a
    multiple of 4), K split in whole chunks; Cout 1 and 2 the direct kernel."""
    shapes = decoder_conv_shapes(cfg, 8)
    assert len(shapes) == 24
    for name, (b, h, w, cin, cout) in shapes:
        launch = C.choose_plan(b, h, w, cin, cout)
        if cout <= 2:
            assert launch.plan == C.DIRECT, name
            continue
        plan = C.PLAN_BY_NAME[launch.plan]
        assert plan.halo and cin % 4 == 0, (name, launch)
        assert C.n_waste(cout, plan.bn) <= MAX_N_WASTE, (name, launch)
        assert launch.npad % plan.bn == 0 and launch.npad >= cout
        total = -(-cin // C.BK)
        assert launch.splits * launch.steps >= total > (launch.splits - 1) * launch.steps
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
    with torch.inference_mode():
        assert C.takes_kernel(_cuda_like(), conv, "kernel")


@pytest.mark.parametrize("grad", [False, True])
def test_route_with_autograd(grad):
    """With autograd on, a CUDA float32 input and float32 parameters take
    the kernels (through ``Conv3x3Function``); bfloat16 parameters (as
    ``F32MasterAdam`` keeps them), bfloat16 compute, the CPU and 'plain'
    keep the modules.  With autograd off, bfloat16 parameters take the
    kernel as before (the launch repacks them to float32)."""
    conv = Conv2d(8, 8, 3, padding=1)
    half = Conv2d(8, 8, 3, padding=1).to(torch.bfloat16)
    with torch.set_grad_enabled(grad):
        assert C.takes_kernel(_cuda_like(), conv, "kernel")
        assert not C.takes_kernel(_cuda_like(), conv, "plain")
        assert not C.takes_kernel(_cuda_like(torch.bfloat16), conv, "kernel")
        assert not C.takes_kernel(torch.zeros(1, 8, 4, 4), conv, "kernel")
        assert C.takes_kernel(_cuda_like(), half, "kernel") is not grad


def test_dispatch_sends_grad_on_to_the_function(monkeypatch):
    """``conv3x3`` on a (checked) CUDA tensor: the Function exactly when
    autograd is on, the forward's launch alone when it is off."""
    calls = []
    monkeypatch.setattr(C, "_forward", lambda x, w, b, relu: calls.append("launch") or x)
    monkeypatch.setattr(C.Conv3x3Function, "apply",
                        lambda *a: calls.append("function") or a[0])
    x = torch.zeros(1, 8, 4, 4)
    w = torch.zeros(8, 8, 3, 3)
    with torch.enable_grad():
        C._dispatch(x, w, None, False)
    with torch.no_grad():
        C._dispatch(x, w, None, False)
    with torch.inference_mode():
        C._dispatch(x, w, None, False)
    assert calls == ["function", "launch", "launch"]


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
    # the gather: 27 slabs of one tap in 3 splits
    assert C.choose_plan(2, 8, 8, 24, 40, plan=C.GATHER, splits=3) == C.Launch(C.GATHER, 3, 9, 64)
    # a halo plan: 3 chunks in 3 splits; 5 chunks in splits of at most 2
    # chunks: never an empty split
    assert C.choose_plan(2, 8, 8, 24, 40, plan="h32", splits=3) == C.Launch("h32", 3, 1, 64)
    assert C.choose_plan(2, 8, 8, 40, 40, plan="h128", splits=4).splits == 3
    with pytest.raises(ValueError, match="plan must be"):
        C.choose_plan(2, 8, 8, 24, 40, plan="nope")
    with pytest.raises(ValueError, match="multiple of 4"):
        C.choose_plan(2, 8, 8, 6, 40, plan="h64")
    with pytest.raises(ValueError, match="direct"):
        C.choose_plan(2, 8, 8, 6, 2, plan=C.DIRECT)
    assert C.choose_plan(2, 8, 8, 6, 40).plan == C.GATHER
    assert C.PLAN_BY_NAME[C.choose_plan(2, 8, 8, 4, 40).plan].halo


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


def _ints(*shape, seed, lo=-4, hi=5):
    """Small integers as float64: every product and sum below is exact."""
    return torch.randint(lo, hi, shape, generator=torch.Generator().manual_seed(seed)).double()


def _im2col(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """[B, C, H, W] -> [B*H*W, 9 * Cp]: each pixel's 3x3 neighbourhood (zero
    outside) in the kernel's K order, chunks of ``chunk`` channels (C
    zero-padded to Cp), the nine taps of a chunk in turn."""
    b, c, h, w = t.shape
    cp = -(-c // chunk) * chunk
    cols = F.unfold(F.pad(t, (0, 0, 0, 0, 0, cp - c)), 3, padding=1)  # [B, Cp*9, HW]
    cols = cols.view(b, cp // chunk, chunk, 3, 3, h * w).permute(0, 5, 1, 3, 4, 2)
    return cols.reshape(b * h * w, 9 * cp)


@pytest.mark.parametrize("cin,cout,chunk", [(12, 5, C.BK), (20, 37, C.BK), (16, 2, 2),
                                            (16, 1, C.BK)])
def test_dgrad_repack_times_im2col_is_conv2d_input(cin, cout, chunk):
    """dgrad as the forward kernel runs it: the output's gradient g
    gathered as the forward's A (Cout channels in chunks), times the weight
    packed transposed and flipped (``packed_weight(..., transposed=True)``),
    is ``conv2d_input``.  Chunk 2 is the direct kernel's packing (chunk =
    its Cin); Cout 1 and 2 are the last convs', whose dgrad has Cin 1 or 2."""
    b, h, w = 2, 5, 7
    wt = _ints(cout, cin, 3, 3, seed=cin)
    g = _ints(b, cout, h, w, seed=cout)
    npad = -(-cin // 8) * 8
    packed = C.packed_weight(wt, npad, chunk, transposed=True).double()
    assert packed.shape == (9 * (-(-cout // chunk) * chunk), npad)
    assert torch.equal(packed[:, cin:], torch.zeros_like(packed[:, cin:]))
    got = (_im2col(g, chunk) @ packed[:, :cin]).view(b, h, w, cin).permute(0, 3, 1, 2)
    want = torch.nn.grad.conv2d_input((b, cin, h, w), wt, g, padding=1)
    assert torch.equal(got, want)


def _wgrad_gemm(x: torch.Tensor, g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The weight gradient as ``conv3x3_wgrad_kernel`` computes it: rows k =
    tap * Cin + c (tap = ky * 3 + kx) of x's gathered halo and a row of
    ones, times g's rows, summed over the pixels; the result read as the
    channels_last weight [Cout][ky][kx][Cin] and the bias."""
    b, cin, h, w = x.shape
    cout = g.shape[1]
    taps = F.unfold(x, 3, padding=1).view(b, cin, 9, h * w).permute(2, 1, 0, 3)
    a = torch.cat([taps.reshape(9 * cin, b * h * w), x.new_ones(1, b * h * w)])
    c = a @ g.permute(0, 2, 3, 1).reshape(b * h * w, cout)          # [9 Cin + 1, Cout]
    flat = c.t().contiguous()                                        # ws[n][k], one split
    dw = flat[:, :9 * cin].contiguous().view(cout, 3, 3, cin).permute(0, 3, 1, 2)
    return dw, flat[:, 9 * cin]


@pytest.mark.parametrize("cin,cout", [(12, 5), (6, 2), (16, 1), (24, 40)])
def test_wgrad_gemm_is_conv2d_weight(cin, cout):
    b, h, w = 3, 4, 9
    x = _ints(b, cin, h, w, seed=cin, lo=0)
    g = _ints(b, cout, h, w, seed=cout)
    dw, db = _wgrad_gemm(x, g)
    assert dw.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(dw, torch.nn.grad.conv2d_weight(x, (cout, cin, 3, 3), g, padding=1))
    assert torch.equal(db, g.sum((0, 2, 3)))


def _halo_smem(p) -> int:
    """Bytes of shared memory a block of halo plan ``p`` asks for (the
    kernel's ``Halo::SMEM``): three stages of its halo tile (128-byte
    aligned) and its chunk of weights, and the ring's six barriers."""
    a = -(-(p.th + 2) * (p.tw + 2) * C.BK * 4 // 128) * 128
    return 3 * (a + C.CHUNK_K * p.bn * 4) + 6 * 8


@pytest.mark.parametrize("plan", C.HALO_PLANS, ids=lambda p: p.name)
def test_halo_plan_fits_tma_and_the_sm(plan):
    """A halo plan's boxes fit TMA (at most 256 elements a dimension, an
    inner box of a multiple of 16 bytes), its ring fits a block's shared
    memory and its resident blocks an SM's, and its threads make whole warps
    whose lanes span one row of pixels (the kernel's ``Halo`` asserts)."""
    th, tw, bn = plan.th, plan.tw, plan.bn
    for box in ((C.BK, tw + 2, th + 2, 1), (bn, C.CHUNK_K)):
        assert all(1 <= d <= 256 for d in box), box
        assert box[0] * 4 % 16 == 0, box
    # a block may opt into 227 KB; an SM has 228 KB, 1 KB of it reserved a block
    assert _halo_smem(plan) <= 227 * 1024
    assert plan.blocks * (_halo_smem(plan) + 1024) <= 228 * 1024
    mt, nt = th * tw // 8, bn // 8
    wn = 8 if nt % 8 == 0 else 4 if nt % 4 == 0 else 2
    assert mt * nt % 32 == 0 and nt % wn == 0 and tw % (32 // wn) == 0 and mt % tw == 0
    assert th == 8 * (mt // tw)


def _halo_gemm(x: torch.Tensor, w: torch.Tensor, p) -> torch.Tensor:
    """The halo kernel's arithmetic on the CPU: for each block's tile, each
    chunk's halo as the tensor map writes it ([TH+2][TW+2][8], zero outside
    the image and past Cin), thread tm's pixels (g + r*RG, px) with g, px =
    divmod(tm, TW), tap (dy, dx) of pixel r read at halo row
    (g + r*RG + dy)(TW + 2) + px + dx, times the chunk's packed weights."""
    b, cin, h, wd = x.shape
    cout = w.shape[0]
    chunks = -(-cin // C.BK)
    npad = -(-cout // p.bn) * p.bn
    packed = C.packed_weight(w, npad, C.BK).double()
    tiles_y, tiles_x = -(-h // p.th), -(-wd // p.tw)
    padded = x.new_zeros(b, tiles_y * p.th + 2, tiles_x * p.tw + 2, chunks * C.BK)
    padded[:, 1:h + 1, 1:wd + 1, :cin] = x.permute(0, 2, 3, 1)
    mt = p.th * p.tw // 8
    rg, hw = mt // p.tw, p.tw + 2
    g, px = torch.arange(mt) // p.tw, torch.arange(mt) % p.tw
    rows = g[:, None] + rg * torch.arange(8)[None, :]                     # [MT, 8]
    out = x.new_zeros(b, tiles_y * p.th, tiles_x * p.tw, npad)
    for bi in range(b):
        for ty in range(tiles_y):
            for tx in range(tiles_x):
                y0, x0 = ty * p.th, tx * p.tw
                acc = x.new_zeros(mt, 8, npad)
                for j in range(chunks):
                    halo = padded[bi, y0:y0 + p.th + 2, x0:x0 + p.tw + 2,
                                  j * C.BK:(j + 1) * C.BK].reshape(-1)
                    for tap in range(9):
                        at = ((rows + tap // 3) * hw + px[:, None] + tap % 3) * C.BK
                        a = halo[at[..., None] + torch.arange(C.BK)]              # [MT, 8, BK]
                        row = (j * 9 + tap) * C.BK
                        acc += a @ packed[row:row + C.BK]
                out[bi, y0 + rows, x0 + px[:, None]] = acc
    return out[:, :h, :wd, :cout].permute(0, 3, 1, 2)


@pytest.mark.parametrize("plan", C.HALO_PLANS, ids=lambda p: p.name)
def test_halo_arithmetic_is_conv2d(plan):
    """The halo kernel's index arithmetic, as ``_halo_gemm`` repeats it, is
    a zero-padded 3x3 conv: ragged tiles (H, W multiples of no tile), an
    image smaller than a tile, Cin 12 (a chunk half past Cin), Cout not a
    multiple of BN; and a thread's pixels and columns cover its tile once."""
    for shape in ((2, 11, 21, 12, 20), (1, 3, 5, 4, 8)):
        b, h, w, cin, cout = shape
        x = _ints(b, cin, h, w, seed=h, lo=-3, hi=4)
        wt = _ints(cout, cin, 3, 3, seed=w)
        assert torch.equal(_halo_gemm(x, wt, plan), F.conv2d(x, wt, padding=1)), shape
    mt, nt = plan.th * plan.tw // 8, plan.bn // 8
    pixels = {(tm // plan.tw + r * (mt // plan.tw), tm % plan.tw)
              for tm in range(mt) for r in range(8)}
    assert len(pixels) == plan.th * plan.tw and max(pixels) < (plan.th, plan.tw)
    columns = sorted((tn + hh * nt) * 4 + j for tn in range(nt) for hh in range(2)
                     for j in range(4))
    assert columns == list(range(plan.bn))


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.name)
def test_every_decoder_shape_gets_backward_plans(cfg):
    """dgrad's launch is the forward's at (Cout -> Cin): a halo plan, but
    for Cin 1 and 2 (the last convs), which take the gather.  wgrad's tiles
    cover 9 * Cin + 1 rows and Cout columns with little padding of Cout, its
    splits fill one wave of resident blocks and keep WGRAD_MIN_SLABS slabs
    each."""
    for name, (b, h, w, cin, cout) in decoder_conv_shapes(cfg, 8):
        d = C.choose_plan(b, h, w, cout, cin)
        assert d.plan == C.GATHER if cout <= 2 else C.PLAN_BY_NAME[d.plan].halo, (name, d)
        total = 9 * -(-cout // C.BK) if d.plan == C.GATHER else -(-cout // C.BK)
        assert d.splits * d.steps >= total > (d.splits - 1) * d.steps
        launch = C.choose_wgrad_plan(b, h, w, cin, cout)
        plan = C.WGRAD_PLAN_BY_NAME[launch.plan]
        if cout > 2:
            assert C.n_waste(cout, plan.bn) <= MAX_N_WASTE, (name, launch)
        pixels = -(-(b * h * w) // C.BK)
        assert launch.splits * launch.slabs >= pixels > (launch.splits - 1) * launch.slabs
        tiles = -(-(9 * cin + 1) // plan.bm) * -(-cout // plan.bn)
        assert tiles * launch.splits <= max(tiles, C.H100.sms * plan.blocks), (name, launch)
        assert launch.splits == 1 or launch.slabs >= C.WGRAD_MIN_SLABS
        assert launch.ldw % 4 == 0 and 9 * cin + 1 <= launch.ldw < 9 * cin + 5


def test_choose_wgrad_plan_forced_and_refused():
    assert C.choose_wgrad_plan(3, 17, 33, 20, 37, plan="n16", splits=3) == C.WgradLaunch(
        "n16", 3, 71, 184)
    # 211 slabs: never an empty split, never more splits than slabs
    assert C.choose_wgrad_plan(3, 17, 33, 20, 37, plan="wide", splits=10 ** 6).splits == 211
    assert C.choose_wgrad_plan(8, 512, 512, 16, 16).splits > 100
    with pytest.raises(ValueError, match="plan must be"):
        C.choose_wgrad_plan(2, 8, 8, 24, 40, plan=C.DIRECT)


def _plain_launchers(monkeypatch, calls):
    """``Conv3x3Function``'s launchers as plain CPU ops (what the modules'
    autograd runs: ``convolution_backward`` and the ReLU's
    ``threshold_backward``), each call recorded by pass."""
    def forward(x, weight, bias, relu):
        calls.append("forward")
        return C.conv3x3_plain(x, weight, bias, relu)

    def dgrad(g, weight):
        calls.append("dgrad")
        b, _, h, w = g.shape
        return torch.nn.grad.conv2d_input((b, weight.shape[1], h, w), weight, g, padding=1)

    def wgrad(x, g):
        calls.append("wgrad")
        _, dw, db = torch.ops.aten.convolution_backward(
            g, x, x.new_empty(g.shape[1], x.shape[1], 3, 3), [g.shape[1]], [1, 1], [1, 1],
            [1, 1], False, [0, 0], 1, [False, True, True])
        return dw, db

    def route(x, conv, impl):
        return (impl == "kernel" and x.dtype == torch.float32 and type(conv) is Conv2d)

    monkeypatch.setattr(C, "_forward", forward)
    monkeypatch.setattr(C, "_dgrad", dgrad)
    monkeypatch.setattr(C, "_wgrad", wgrad)
    monkeypatch.setattr(C, "takes_kernel", route)
    monkeypatch.setattr(C, "conv3x3", C._dispatch)


def _tiny_step(matching_impl: str, remat=False):
    cfg = cvm.TINY
    state = TLOOP.create_train_state(cfg, seed=4, device="cpu")
    gen = torch.Generator().manual_seed(5)
    b = 2
    off = (torch.rand((2, b), generator=gen) * 2 - 1) * 30
    angle = torch.rand((b,), generator=gen) * 360
    gt, weights, omap = GT.synthesize_batch_factored(
        off[0], off[1], angle, height=cfg.sat_hw[0], width=cfg.sat_hw[1], bins=cfg.bins)
    batch = {"grd": torch.randn((b, *cfg.grd_hw, 3), generator=gen),
             "sat": torch.randn((b, *cfg.sat_hw, 3), generator=gen),
             "gt": gt, "bin_weights": weights, "orientation": omap}
    parts = TLOOP.make_train_step(cfg, matching_impl=matching_impl, remat=remat)(state, batch)
    return state, parts


@pytest.mark.parametrize("remat", [False, "decoder"])
def test_tiny_train_step_through_the_function_is_the_modules_step(monkeypatch, remat):
    """With the route let through on the CPU and the launchers plain, a
    TINY train step sends its 24 decoder convs through ``Conv3x3Function``
    (24 forward, 24 dgrad, 24 wgrad launches; the forward again where
    ``remat='decoder'`` recomputes) and gives the modules' step bit for bit:
    loss parts, every gradient, the updated weights."""
    calls = []
    _plain_launchers(monkeypatch, calls)
    got, got_parts = _tiny_step("kernel", remat)
    counts = {p: calls.count(p) for p in C.PASSES}
    assert counts == {"forward": 48 if remat else 24, "dgrad": 24, "wgrad": 24}
    calls.clear()
    want, want_parts = _tiny_step("plain", remat)
    assert calls == []
    for k, v in want_parts.items():
        assert torch.equal(got_parts[k], v), k
    theirs = dict(want.model.named_parameters())
    for k, p in got.model.named_parameters():
        q = theirs[k]
        assert (p.grad is None) == (q.grad is None), k
        if q.grad is not None:
            assert torch.equal(p.grad, q.grad), k
        assert torch.equal(p, q), k
