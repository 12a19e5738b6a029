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


@pytest.mark.parametrize("layout", ["warp", "row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cs,shift,offsets,hw", [
    (1280, 64, range(20), (8, 8)),
    (40, 2, range(20), (256, 256)),
    (1280, 64, range(-2, 3), (8, 8)),
    (1280, 64, range(20), (41, 41)),
    (320, 16, range(20), (66, 66)),
])
def test_epilogue_kernel_matches_plain(dev, layout, dtype, cs, shift, offsets, hw):
    x, g = _inputs(dev, 2, hw, cs, cs, seed=cs, dtype=dtype)
    x[1, 0, 0] = 0
    before = MC.LAUNCHES["matching_epilogue"]
    got = MC.launch_matching_epilogue(x, g, shift, tuple(offsets), "first", layout)
    torch.cuda.synchronize()
    assert MC.LAUNCHES["matching_epilogue"] == before + 1
    want = TM.matching_epilogue_plain(x.float(), g.float(), shift, offsets)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b, **tol)


@pytest.mark.parametrize("layout", ["warp", "row"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cs,cg,shift,offsets,window", [
    (1280, 1280, 64, range(20), "first"),
    (1280, 224, 64, range(20), "center"),
    (2048, 512, 128, range(16), "first"),
    (256, 64, 64, range(-2, 3), "first"),
    (40, 20, 2, range(20), "first"),
])
def test_scores_kernel_matches_plain(dev, layout, dtype, cs, cg, shift, offsets, window):
    if layout == "row" and not MC.row_layout_fits(cs, cg, len(offsets)):
        with pytest.raises(ValueError, match="row layout"):
            MC.launch_matching_scores(*_inputs(dev, 1, (2, 2), cs, cg, 0), shift,
                                      tuple(offsets), window, layout)
        return
    x, g = _inputs(dev, 3, (9, 7), cs, cg, seed=cs + cg, dtype=dtype)
    before = MC.LAUNCHES["matching_scores"]
    got = MC.launch_matching_scores(x, g, shift, tuple(offsets), window, layout)
    torch.cuda.synchronize()
    assert MC.LAUNCHES["matching_scores"] == before + 1
    want = TM.matching_scores_plain(x.float(), g.float(), shift, offsets, window)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want, **tol)


def test_automatic_layout_and_grad_free_dispatch(dev):
    x, g = _inputs(dev, 8, (256, 256), 40, 40, seed=3)
    assert MC.pick_layout(x, 40, 20) == "row"
    assert MC.pick_layout(x[:, :8, :8].contiguous(), 40, 20) == "warp"
    before = MC.LAUNCHES["matching_epilogue"]
    s, _, _ = TM.matching_epilogue(x, g, 2, range(20))
    assert MC.LAUNCHES["matching_epilogue"] == before + 1
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
