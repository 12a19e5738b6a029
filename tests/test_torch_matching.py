"""The plain versions of the port's matching kernels against the JAX package:
the Pallas kernels in interpret mode (as tests/test_pallas_matching.py runs
them) and the einsum formulation, at atol/rtol 1e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ccvpe_tpu.nn.layers import l2_normalize as jax_l2_normalize
from ccvpe_tpu.ops import matching as JM
from ccvpe_tpu.ops.pallas_matching import matching_epilogue_pallas, matching_scores_pallas
from ccvpe_torch.ops import matching as TM
from ccvpe_torch.ops import matching_cuda

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)

# (cs, cg, shift, offsets, window, spatial hw)
CASES = [
    (1280, 1280, 64, range(20), "first", (8, 8)),      # VIGOR scale 1
    (640, 640, 32, range(20), "first", (8, 8)),        # VIGOR scale 2
    (2048, 512, 128, range(16), "first", (8, 8)),      # KITTI scale 1
    (1280, 224, 64, range(20), "center", (8, 8)),      # Oxford scale 1
    (1280, 1280, 64, range(-2, 3), "first", (8, 8)),   # ori prior, n = 2
    (256, 64, 64, range(-2, 3), "first", (4, 4)),      # NANO scale 1, ori prior
    (1280, 1280, 64, range(21), "first", (8, 8)),      # 21 offsets
    (1280, 1280, 64, range(20), "first", (41, 41)),    # ragged spatial tail
    (320, 320, 16, range(20), "first", (66, 66)),      # ragged, VIGOR width
]


def _inputs(cs, cg, hw, seed, zero_row=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *hw, cs)).astype(np.float32)
    g = rng.standard_normal((2, cg)).astype(np.float32)
    if zero_row:
        x[1, 0, 0] = 0.0
    return x, g


def _case_id(case):
    cs, cg, shift, offsets, window, hw = case
    return f"{cs}-{cg}-s{shift}-o{offsets.start}:{offsets.stop}-{window}-{hw[0]}x{hw[1]}"


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_scores_plain_matches_pallas_and_einsum(case):
    cs, cg, shift, offsets, window, hw = case
    x, g = _inputs(cs, cg, hw, seed=cs + cg + hw[0])
    offsets = tuple(offsets)
    got = TM.matching_scores_plain(torch.from_numpy(x), torch.from_numpy(g),
                                   shift, offsets, window).numpy()
    pallas = matching_scores_pallas(jnp.asarray(x), jnp.asarray(g), shift, offsets,
                                    window, interpret=True)
    einsum = JM.matching_scores(jnp.asarray(x), jnp.asarray(g), shift, offsets, window)
    assert got.shape == (2, *hw, len(offsets))
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(einsum), **TOL)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == c[1]], ids=_case_id)
def test_epilogue_plain_matches_pallas_and_einsum(case):
    cs, cg, shift, offsets, window, hw = case
    x, g = _inputs(cs, cg, hw, seed=cs + hw[0] + 1)
    offsets = tuple(offsets)
    s, smax, xnorm = (t.numpy() for t in TM.matching_epilogue_plain(
        torch.from_numpy(x), torch.from_numpy(g), shift, offsets, window))
    ps, pmax, pnorm = matching_epilogue_pallas(jnp.asarray(x), jnp.asarray(g), shift,
                                               offsets, window, interpret=True)
    es, emax, enorm = JM.matching_scores_with_norm(jnp.asarray(x), jnp.asarray(g),
                                                   shift, offsets, window)
    for got, want in ((s, ps), (smax, pmax), (xnorm, pnorm), (s, es), (smax, emax),
                      (xnorm, enorm)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert smax.shape == (2, *hw, 1) and xnorm.shape == x.shape


@pytest.mark.parametrize("cs,cg,shift,offsets,window", [
    (256, 256, 16, range(16), "first"),
    (1280, 224, 64, range(20), "center"),
    (256, 64, 64, range(-2, 3), "first"),
])
def test_roll_reference_matches_jax(cs, cg, shift, offsets, window):
    x, g = _inputs(cs, cg, (4, 4), seed=9)
    got = TM.matching_scores_reference(torch.from_numpy(x), torch.from_numpy(g),
                                       shift, tuple(offsets), window).numpy()
    want = JM.matching_scores_reference(jnp.asarray(x), jnp.asarray(g), shift,
                                        tuple(offsets), window)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    plain = TM.matching_scores_plain(torch.from_numpy(x), torch.from_numpy(g), shift,
                                     tuple(offsets), window).numpy()
    np.testing.assert_allclose(plain, got, atol=1e-5, rtol=1e-4)


def test_zero_row_clamps_like_the_kernels_not_the_einsum():
    """A zero pixel row: the port's plain versions (like the Pallas and CUDA
    kernels) clamp the denominator at 1e-12 and give 0; the JAX einsum path
    has no clamp and gives NaN.  This is the one place they differ."""
    cs = 1280
    x, g = _inputs(cs, cs, (8, 8), seed=11, zero_row=True)
    offsets = tuple(range(20))
    s, smax, xnorm = TM.matching_epilogue_plain(torch.from_numpy(x), torch.from_numpy(g),
                                                64, offsets)
    scores = TM.matching_scores_plain(torch.from_numpy(x), torch.from_numpy(g), 64, offsets)
    for t in (s, smax, xnorm, scores):
        assert torch.isfinite(t).all()
    assert (s[1, 0, 0] == 0).all() and (xnorm[1, 0, 0] == 0).all() and (scores[1, 0, 0] == 0).all()
    ps, pmax, pnorm = matching_epilogue_pallas(jnp.asarray(x), jnp.asarray(g), 64, offsets,
                                               "first", interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(ps), **TOL)
    np.testing.assert_allclose(xnorm.numpy(), np.asarray(pnorm), **TOL)
    es, _, _ = JM.matching_scores_with_norm(jnp.asarray(x), jnp.asarray(g), 64, offsets)
    es = np.asarray(es)
    assert np.isnan(es[1, 0, 0]).all()
    mask = np.ones(es.shape[:3], bool)
    mask[1, 0, 0] = False
    np.testing.assert_allclose(s.numpy()[mask], es[mask], **TOL)


def test_bin_shifts_are_python_modulo():
    ks = TM.bin_shifts(1280, 1280, 64, range(-2, 3), "first")
    assert ks == (1152, 1216, 0, 64, 128)
    assert TM.bin_shifts(1280, 224, 64, [0, 1], "center") == (528, 592)
    assert TM.window_start(1280, 224, "center") == JM.window_start(1280, 224, "center")
    with pytest.raises(ValueError):
        TM.window_start(10, 5, "left")


def test_gradients_of_plain_versions_match_jax():
    """The kernels' backward is autograd through the plain versions."""
    x, g = _inputs(64, 40, (4, 4), seed=1)
    offsets = tuple(range(8))
    xt = torch.from_numpy(x).requires_grad_()
    gt = torch.from_numpy(g).requires_grad_()
    (TM.matching_scores_plain(xt, gt, 8, offsets) ** 2).sum().backward()
    jgx, jgg = jax.grad(lambda a, b: jnp.sum(JM.matching_scores(a, b, 8, offsets) ** 2),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(jgg), atol=1e-4, rtol=1e-4)

    x, g = _inputs(128, 128, (4, 4), seed=2)
    xt = torch.from_numpy(x).requires_grad_()
    gt = torch.from_numpy(g).requires_grad_()
    s, smax, xn = TM.matching_epilogue_plain(xt, gt, 16, offsets)
    ((s ** 2).sum() + smax.sum() + (xn ** 3).sum()).backward()

    def loss(a, b):
        s = JM.matching_scores(a, b, 16, offsets)
        return (jnp.sum(s ** 2) + jnp.sum(jnp.max(s, axis=-1))
                + jnp.sum(jax_l2_normalize(a, axis=-1) ** 3))

    jgx, jgg = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gt.grad.numpy(), np.asarray(jgg), atol=1e-4, rtol=1e-4)


def test_cpu_tensor_takes_the_plain_path_and_counts_nothing():
    matching_cuda.reset_launch_counts()
    x, g = _inputs(256, 256, (4, 4), seed=3)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    offsets = tuple(range(-2, 3))
    for got, want in zip(TM.matching_epilogue(xt, gt, 16, offsets),
                         TM.matching_epilogue_plain(xt, gt, 16, offsets)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    x2, g2 = _inputs(256, 64, (4, 4), seed=4)
    torch.testing.assert_close(
        matching_cuda.matching_scores_cuda(torch.from_numpy(x2), torch.from_numpy(g2), 8,
                                           range(4)),
        TM.matching_scores_plain(torch.from_numpy(x2), torch.from_numpy(g2), 8, range(4)),
        rtol=0, atol=0)
    assert matching_cuda.launch_counts() == {"matching_epilogue": 0, "matching_scores": 0}


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """Off the CPU the wrappers launch or raise; they never fall back."""
    meta = torch.empty((1, 4, 4, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        matching_cuda.matching_scores_cuda(meta, torch.empty((1, 64), device="meta"), 8,
                                           range(4))
    with pytest.raises(ValueError, match="CUDA"):
        matching_cuda.launch_matching_epilogue(torch.zeros(1, 4, 4, 64), torch.zeros(1, 64),
                                               8, range(4), "first")
    with pytest.raises(ValueError, match="Cg == Cs"):
        TM.matching_epilogue_plain(torch.zeros(1, 4, 4, 64), torch.zeros(1, 32), 8, range(4))
