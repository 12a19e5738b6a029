"""The CUDA matching kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels are built from
``ccvpe_torch/csrc`` at first use) and skips without them.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from ccvpe_torch.ops import matching as TM
from ccvpe_torch.ops import matching_cuda as MC

pytestmark = pytest.mark.cuda

F32_TOL = dict(atol=1e-5, rtol=1e-5)
# one bf16 rounding of an f32 result: relative error <= 2**-8; 2**-7 leaves margin
BF16_TOL = dict(atol=1e-5, rtol=2.0 ** -7)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, b, hw, cs, cg, seed, dtype=torch.float32):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((b, *hw, cs), generator=gen).to(dev, dtype)
    g = torch.randn((b, cg), generator=gen).to(dev, dtype)
    return x, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cs,shift,offsets,hw", [
    (1280, 64, range(20), (8, 8)),
    (40, 2, range(20), (256, 256)),
    (1280, 64, range(-2, 3), (8, 8)),
    (1280, 64, range(20), (41, 41)),
    (320, 16, range(20), (66, 66)),
])
def test_epilogue_kernel_matches_plain(dev, dtype, cs, shift, offsets, hw):
    x, g = _inputs(dev, 2, hw, cs, cs, seed=cs, dtype=dtype)
    x[1, 0, 0] = 0
    before = MC.launch_counts()["matching_epilogue"]
    got = MC.launch_matching_epilogue(x, g, shift, tuple(offsets), "first", "warp")
    torch.cuda.synchronize()
    assert MC.launch_counts()["matching_epilogue"] == before + 1
    want = TM.matching_epilogue_plain(x.float(), g.float(), shift, offsets)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cs,cg,shift,offsets,window", [
    (1280, 1280, 64, range(20), "first"),
    (1280, 224, 64, range(20), "center"),
    (2048, 512, 128, range(16), "first"),
    (256, 64, 64, range(-2, 3), "first"),
    (40, 20, 2, range(20), "first"),
])
def test_scores_kernel_matches_plain(dev, dtype, cs, cg, shift, offsets, window):
    x, g = _inputs(dev, 3, (9, 7), cs, cg, seed=cs + cg, dtype=dtype)
    before = MC.launch_counts()["matching_scores"]
    got = MC.launch_matching_scores(x, g, shift, tuple(offsets), window, "warp")
    torch.cuda.synchronize()
    assert MC.launch_counts()["matching_scores"] == before + 1
    want = TM.matching_scores_plain(x.float(), g.float(), shift, offsets, window)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.parametrize("cs,dtype", [(42, torch.float32), (150, torch.float32),
                                      (36, torch.bfloat16), (100, torch.bfloat16)])
def test_rows_of_part_granules_take_the_warp_layout(dev, cs, dtype):
    # a row that is not whole 16-byte granules has no tile plan: the
    # wrappers pick the warp layout by themselves at a map with enough rows
    # for the tile, and it matches the plain version (a zero row; K2 with a
    # masked window)
    x, g = _inputs(dev, 2, (64, 64), cs, cs, seed=cs, dtype=dtype)
    x[1, 0, 0] = 0
    gm = g[:, :cs // 2].contiguous()
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert MC.pick_layout("matching_epilogue", x, cs, 20) == "warp"
    assert MC.pick_layout("matching_scores", x, cs // 2, 20) == "warp"
    before = MC.launch_counts("layout")
    got = MC.launch_matching_epilogue(x, g, 2, tuple(range(20)), "first")
    scores = MC.launch_matching_scores(x, gm, 2, tuple(range(20)), "first")
    torch.cuda.synchronize()
    after = MC.launch_counts("layout")
    assert {k: n - before[k] for k, n in after.items() if n != before[k]} == {
        ("matching_epilogue", "warp"): 1, ("matching_scores", "warp"): 1}
    for a, b in zip(got, TM.matching_epilogue_plain(x.float(), g.float(), 2, range(20))):
        torch.testing.assert_close(a.float(), b, **tol)
    torch.testing.assert_close(
        scores.float(), TM.matching_scores_plain(x.float(), gm.float(), 2, range(20)), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hw,cs,shift,offsets", [
    (8, (64, 64), 160, 8, range(20)),      # the three fine VIGOR scales
    (8, (128, 128), 80, 4, range(20)),
    (8, (256, 256), 40, 2, range(20)),
    (1, (256, 256), 40, 2, range(-2, 3)),  # 5 bins: score spans off the granule
    (3, (41, 41), 40, 2, range(-2, 3)),    # ragged HW
    (3, (66, 66), 80, 4, range(21)),       # ragged HW, 21 bins
    (1, (5, 7), 40, 2, range(20)),         # HW smaller than one tile
    (3, (9, 9), 160, 8, range(1)),         # 1 bin
    (1, (33, 31), 80, 4, range(32)),       # 32 bins
])
def test_tile_layout_matches_plain(dev, dtype, b, hw, cs, shift, offsets):
    x, g = _inputs(dev, b, hw, cs, cs, seed=cs + b, dtype=dtype)
    x[0, 0, 0] = 0          # zero rows: the 1e-12 clamps give 0, not NaN
    x[-1, -1, -1] = 0
    before = MC.launch_counts("layout")["matching_epilogue", "tile"]
    got = MC.launch_matching_epilogue(x, g, shift, tuple(offsets), "first", "tile")
    torch.cuda.synchronize()
    assert MC.launch_counts("layout")["matching_epilogue", "tile"] == before + 1
    want = TM.matching_epilogue_plain(x.float(), g.float(), shift, offsets)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        torch.testing.assert_close(a.float(), w, **tol)
    scores, _, xnorm = got
    assert not scores[0, 0, 0].float().any() and not xnorm[0, 0, 0].float().any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hw,cs,cg,shift,offsets,window", [
    (8, (64, 64), 160, 80, 8, range(20), "first"),      # the fov=180 fine VIGOR scales
    (8, (128, 128), 80, 40, 4, range(20), "first"),
    (8, (256, 256), 40, 20, 2, range(20), "first"),
    (2, (64, 64), 160, 28, 8, range(20), "center"),     # Oxford's centred window
    (2, (128, 128), 80, 14, 4, range(20), "center"),
    (2, (96, 96), 40, 7, 2, range(20), "center"),
    (2, (64, 64), 128, 64, 16, range(16), "first"),     # KITTI, 16 bins
    (2, (64, 64), 128, 32, 8, range(16), "first"),
    (2, (128, 128), 80, 40, 4, range(-2, 3), "first"),  # negative offsets
    (3, (41, 41), 40, 20, 2, range(-2, 3), "first"),    # ragged HW, 5 bins
    (3, (66, 66), 80, 40, 4, range(21), "first"),       # ragged HW, 21 bins
    (3, (41, 41), 40, 40, 2, range(21), "first"),       # Cg == Cs: one segment
    (1, (33, 31), 80, 13, 3, range(32), "center"),      # 32 bins, uneven segments
    (8, (32, 32), 320, 160, 16, range(20), "first"),    # fov=180 at 32x32x320
    (2, (32, 32), 320, 56, 16, range(20), "center"),    # Oxford at 320 channels
])
def test_scores_tile_layout_matches_plain(dev, dtype, b, hw, cs, cg, shift, offsets, window):
    x, g = _inputs(dev, b, hw, cs, cg, seed=cs + cg + b, dtype=dtype)
    ks = TM.bin_shifts(cs, cg, shift, offsets, window)
    x[0, 0, 0] = 0                         # a zero row: the 1e-12 clamps give 0, not NaN
    # a row that is zero inside bin 1's window only (cyclically from k_1)
    inside = (torch.arange(cg, device=dev) + ks[min(1, len(ks) - 1)]) % cs
    x[-1, -1, -1, inside] = 0
    before = MC.launch_counts("layout")["matching_scores", "tile"]
    got = MC.launch_matching_scores(x, g, shift, tuple(offsets), window, "tile")
    torch.cuda.synchronize()
    assert MC.launch_counts("layout")["matching_scores", "tile"] == before + 1
    want = TM.matching_scores_plain(x.float(), g.float(), shift, offsets, window)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want, **tol)
    assert not got[0, 0, 0].float().any()
    if cg < cs:
        assert got[-1, -1, -1, min(1, len(ks) - 1)].float().item() == 0
        assert got[-1, -1, -1].float().abs().max() > 0


@pytest.mark.parametrize("plan", MC.K2_TILE_PLANS_NARROW + MC.K2_TILE_PLANS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hw,cs,cg,shift,offsets,window", [
    (2, (128, 128), 80, 40, 4, range(20), "first"),
    (3, (41, 41), 40, 7, 2, range(-2, 3), "center"),
    (2, (66, 66), 160, 160, 8, range(21), "first"),
])
def test_every_scores_tile_plan_matches_plain(dev, monkeypatch, dtype, plan, b, hw, cs, cg,
                                              shift, offsets, window):
    # each (threads, rows per thread, stages) that the plan can take, forced
    monkeypatch.setattr(MC, "K2_TILE_PLANS_NARROW", ())
    monkeypatch.setattr(MC, "K2_TILE_PLANS", (plan,))
    MC._plan.cache_clear()
    try:
        x, g = _inputs(dev, b, hw, cs, cg, seed=cs + cg, dtype=dtype)
        x[0, 0, 0] = 0
        got = MC.launch_matching_scores(x, g, shift, tuple(offsets), window, "tile")
        torch.cuda.synchronize()
    finally:
        MC._plan.cache_clear()
    want = TM.matching_scores_plain(x.float(), g.float(), shift, offsets, window)
    torch.testing.assert_close(got.float(), want,
                               **(F32_TOL if dtype == torch.float32 else BF16_TOL))


def test_tile_layout_refuses_what_it_does_not_take(dev):
    for cs, dtype in ((42, torch.float32), (36, torch.bfloat16)):
        xo, go = _inputs(dev, 2, (16, 16), cs, cs, seed=6, dtype=dtype)
        with pytest.raises(ValueError, match="tile layout"):
            MC.launch_matching_epilogue(xo, go, 2, tuple(range(20)), "first", "tile")
        with pytest.raises(ValueError, match="tile layout"):
            MC.launch_matching_scores(xo, go[:, :cs // 2].contiguous(), 2, tuple(range(20)),
                                      "first", "tile")
    x, g = _inputs(dev, 2, (16, 16), 40, 40, seed=5)
    with pytest.raises(ValueError, match="'warp' or 'tile'"):
        MC.launch_matching_scores(x, g, 2, tuple(range(20)), "first", "split")
    flat = torch.zeros(2 * 16 * 16 * 40 + 1, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        MC.launch_matching_epilogue(flat[1:].view(2, 16, 16, 40), g, 2, tuple(range(20)),
                                    "first", "tile")
    with pytest.raises(ValueError, match="aligned"):
        MC.launch_matching_scores(flat[1:].view(2, 16, 16, 40), g[:, :20].contiguous(), 2,
                                  tuple(range(20)), "first", "tile")


def test_python_plans_match_the_library(dev):
    lib = MC._kernels()
    assert MC.device_limits(0).sms == torch.cuda.get_device_properties(0).multi_processor_count
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        item = torch.empty((), dtype=dtype).element_size()
        for cs in (8, 40, 80, 160, 320):
            for bins in (1, 5, 20, 21, 32):
                # K1
                plan = MC.tile_plan((8, 64, 64, cs), bins, dtype, MC.device_limits(0))
                for rows in MC.TILE_ROWS:
                    assert MC.tile_smem_bytes(cs, bins, item, rows) == \
                        lib.ccvpe_match_tile_smem_bytes(cs, bins, code, rows)
                if plan is not None:
                    # the plan never asks for more resident blocks than the
                    # occupancy calculator (registers included) allows
                    occ = lib.ccvpe_match_tile_blocks_per_sm(cs, bins, code, plan.rows, plan.smem)
                    assert 1 <= plan.blocks_per_sm <= occ, (cs, bins, dtype, plan, occ)
                # K2 with one segment (Cg == Cs) and with the most segments
                # that `bins` windows can make (Cg < Cs), at every plan it takes
                for nseg in (1, 2 * bins + 1):
                    for threads, rpt, stages in MC.K2_TILE_PLANS_NARROW + MC.K2_TILE_PLANS:
                        assert MC.tile_smem_bytes(cs, bins, item, threads * rpt,
                                                  "matching_scores", nseg, stages) == \
                            lib.ccvpe_match_scores_tile_smem_bytes(cs, bins, code, threads * rpt,
                                                                   stages, nseg)
                    plan = MC.tile_plan((8, 64, 64, cs), bins, dtype, MC.device_limits(0),
                                        "matching_scores", nseg)
                    if plan is not None:
                        occ = lib.ccvpe_match_scores_tile_blocks_per_sm(
                            bins, code, int(nseg > 1), plan.rpt, plan.rows // plan.rpt,
                            plan.smem)
                        assert 1 <= plan.blocks_per_sm <= occ, (cs, bins, dtype, nseg, plan, occ)


def test_automatic_layout_and_grad_free_dispatch(dev):
    x, g = _inputs(dev, 8, (256, 256), 40, 40, seed=3)
    assert MC.pick_layout("matching_epilogue", x, 40, 20) == "tile"
    assert MC.pick_layout("matching_scores", x, 40, 20) == "tile"
    assert MC.pick_layout("matching_scores", x, 20, 20) == "tile"
    assert MC.pick_layout("matching_epilogue", x[:, :8, :8].contiguous(), 40, 20) == "warp"
    before = MC.launch_counts()["matching_epilogue"]
    tile = MC.launch_counts("layout")["matching_epilogue", "tile"]
    s, _, _ = TM.matching_epilogue(x, g, 2, range(20))
    assert MC.launch_counts()["matching_epilogue"] == before + 1
    assert MC.launch_counts("layout")["matching_epilogue", "tile"] == tile + 1
    torch.testing.assert_close(s, TM.matching_epilogue_plain(x, g, 2, range(20))[0], **F32_TOL)


def test_backward_is_autograd_of_the_plain_version(dev):
    x, g = _inputs(dev, 2, (4, 4), 128, 128, seed=1)
    xs, gs = x.clone().requires_grad_(), g.clone().requires_grad_()
    s, smax, xn = MC.matching_epilogue_cuda(xs, gs, 8, range(8))
    (s.square().sum() + smax.sum() + xn.pow(3).sum()).backward()
    xp, gp = x.clone().requires_grad_(), g.clone().requires_grad_()
    s, smax, xn = TM.matching_epilogue_plain(xp, gp, 8, range(8))
    (s.square().sum() + smax.sum() + xn.pow(3).sum()).backward()
    torch.testing.assert_close(xs.grad, xp.grad, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(gs.grad, gp.grad, atol=1e-5, rtol=1e-4)


# the six VIGOR scales (side of the square map, Cs, shift)
VIGOR_SCALES = [(8, 1280, 64), (16, 640, 32), (32, 320, 16), (64, 160, 8), (128, 80, 4),
                (256, 40, 2)]


def _grads(fn, x, g, args, cotangents):
    """(d x, d g) of sum(out * cotangent) over the outputs that have one
    (None: the output is unused, so its incoming gradient is zeros).  An
    input that the used outputs do not depend on gets zeros: autograd
    leaves its ``grad`` None on the plain path, while the kernel's
    ``autograd.Function`` returns zeros for it."""
    xr, gr = x.clone().requires_grad_(), g.clone().requires_grad_()
    outs = fn(xr, gr, *args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o * c).sum() for o, c in zip(outs, cotangents) if c is not None).backward()
    return tuple(torch.zeros_like(t) if t.grad is None else t.grad for t in (xr, gr))


@pytest.mark.parametrize("scale", VIGOR_SCALES)
@pytest.mark.parametrize("offsets", [range(20), range(-2, 3)])
@pytest.mark.parametrize("used", ["all", "scores", "xnorm"])
def test_epilogue_backward_at_the_vigor_scales(dev, scale, offsets, used):
    """``_EpilogueFn``'s gradients against autograd of the plain version: the
    training path's K1 at every VIGOR scale, with the prior's negative
    offsets, and with some outputs unused."""
    side, cs, shift = scale
    x, g = _inputs(dev, 2, (side, side), cs, cs, seed=side)
    args = (shift, tuple(offsets), "first")
    gen = torch.Generator(device="cpu").manual_seed(cs)
    shapes = [(2, side, side, len(offsets)), (2, side, side, 1), (2, side, side, cs)]
    cot = [torch.randn(s, generator=gen).to(dev) for s in shapes]
    if used != "all":
        cot = [c if name == used else None for c, name in zip(cot, ("scores", "smax", "xnorm"))]
    before = MC.launch_counts()
    got = _grads(MC.matching_epilogue_cuda, x, g, args, cot)
    # one launch, in the forward; the backward runs the plain version
    assert MC.launch_counts()["matching_epilogue"] == before["matching_epilogue"] + 1
    want = _grads(TM.matching_epilogue_plain, x, g, args, cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **F32_TOL)


@pytest.mark.parametrize("scale", VIGOR_SCALES)
@pytest.mark.parametrize("cg_div,offsets", [(2, range(20)), (1, range(-2, 3)), (2, range(-2, 3))])
def test_scores_backward_masked_and_prior(dev, scale, cg_div, offsets):
    """``_ScoresFn``'s gradients against autograd of the plain version: the
    fov=180 masked window (Cg = Cs / 2) at every VIGOR scale and the prior's
    negative offsets."""
    side, cs, shift = scale
    x, g = _inputs(dev, 2, (side, side), cs, cs // cg_div, seed=side + 1)
    args = (shift, tuple(offsets), "first")
    gen = torch.Generator(device="cpu").manual_seed(cs + 1)
    cot = [torch.randn((2, side, side, len(offsets)), generator=gen).to(dev)]
    before = MC.launch_counts()["matching_scores"]
    got = _grads(MC.matching_scores_cuda, x, g, args, cot)
    assert MC.launch_counts()["matching_scores"] == before + 1
    want = _grads(TM.matching_scores_plain, x, g, args, cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **F32_TOL)


def test_wrappers_raise_rather_than_copy(dev):
    x, g = _inputs(dev, 2, (4, 4), 64, 64, seed=2)
    with pytest.raises(ValueError, match="contiguous"):
        MC.matching_scores_cuda(x.transpose(1, 2), g, 8, range(4))
    with pytest.raises(TypeError):
        MC.matching_scores_cuda(x.half(), g.half(), 8, range(4))
    with pytest.raises(ValueError, match="bins"):
        MC.matching_scores_cuda(x, g, 1, range(33))
    with pytest.raises(ValueError, match="Cg == Cs"):
        MC.matching_epilogue_cuda(x, g[:, :32].contiguous(), 8, range(4))
