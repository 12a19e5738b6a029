"""ccvpe_torch.train.losses against ccvpe_tpu.train.losses on seeded model
outputs at the VIGOR sizes (512x512 heatmap, six score volumes 8x8 ... 256x256
with 20 bins), batch 2, with GT from the JAX package's synthesis.

Tolerances: loss values rtol 1e-5 (float32 sums over up to 2.6M cells in
another order); gradients with respect to the outputs rtol 1e-4 / atol
1e-6 of their largest element; the factored loss against the binned one
rtol 1e-6 (the same labels: pooling commutes with the bin weights).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ccvpe_tpu.models.cvm import CVMOutputs as JOutputs
from ccvpe_tpu.ops import gt as JG
from ccvpe_tpu.train import losses as JL
from ccvpe_torch.models.cvm import CVMOutputs as TOutputs
from ccvpe_torch.train import losses as TL

torch.set_num_threads(2)

B, HW, BINS = 2, 512, 20
RTOL = 1e-5


def _outputs(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, HW * HW)).astype(np.float32)
    ori = rng.standard_normal((B, HW, HW, 2)).astype(np.float32)
    ori /= np.linalg.norm(ori, axis=-1, keepdims=True)
    stacks = tuple(rng.uniform(-1, 1, (B, 8 * 2 ** k, 8 * 2 ** k, BINS)).astype(np.float32)
                   for k in range(6))
    return logits, ori, stacks


def _gt(seed, clockwise=False):
    rng = np.random.default_rng(seed)
    r, c = (jnp.asarray(rng.uniform(-200, 200, B), jnp.float32) for _ in range(2))
    a = jnp.asarray(rng.uniform(0, 360, B), jnp.float32)
    kw = dict(height=HW, width=HW, bins=BINS, clockwise=clockwise)
    gt, gwo, omap = JG.synthesize_batch(r, c, a, **kw)
    _, w, _ = JG.synthesize_batch_factored(r, c, a, **kw)
    return [np.array(v) for v in (gt, gwo, omap, w)]


def _jout(logits, ori, stacks):
    return JOutputs(jnp.asarray(logits), None, jnp.asarray(ori), tuple(map(jnp.asarray, stacks)))


def _tout(logits, ori, stacks):
    return TOutputs(logits, None, ori, tuple(stacks))


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got.item(), float(want), rtol=rtol, atol=0)


@pytest.mark.parametrize("temperature", [0.1, 1.0])
@pytest.mark.parametrize("k", [0, 3, 5])
def test_info_nce_loss(temperature, k):
    _, _, stacks = _outputs(1)
    gt, gwo, _, _ = _gt(2)
    scores = stacks[k].reshape(B, -1)
    label = np.array(JL.gt_pyramid(jnp.asarray(gwo))[k]).reshape(B, -1)
    want = JL.info_nce_loss(jnp.asarray(scores), jnp.asarray(label), temperature)
    got = TL.info_nce_loss(torch.from_numpy(scores), torch.from_numpy(label), temperature)
    _close(got, want)


def test_cross_entropy_and_orientation_losses():
    logits, ori, _ = _outputs(3)
    gt, _, omap, _ = _gt(4)
    flat = gt.reshape(B, -1) / gt.reshape(B, -1).sum(1, keepdims=True)
    _close(TL.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(flat)),
           JL.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(flat)))
    _close(TL.orientation_loss(torch.from_numpy(ori), torch.from_numpy(omap),
                               torch.from_numpy(gt)),
           JL.orientation_loss(jnp.asarray(ori), jnp.asarray(omap), jnp.asarray(gt)))


def test_gt_pyramid():
    _, gwo, _, _ = _gt(5)
    want = JL.gt_pyramid(jnp.asarray(gwo))
    got = TL.gt_pyramid(torch.from_numpy(gwo))
    assert [tuple(g.shape) for g in got] == [(B, 8 * 2 ** k, 8 * 2 ** k, BINS) for k in range(6)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("clockwise", [False, True])
def test_total_loss_and_its_gradients(clockwise):
    logits, ori, stacks = _outputs(6)
    gt, gwo, omap, w = _gt(7, clockwise)

    def jloss(lg, o, st):
        return JL.total_loss(JOutputs(lg, None, o, st), jnp.asarray(gt[..., 0]),
                             jnp.asarray(w), jnp.asarray(omap))

    (jl, jparts), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(ori), tuple(map(jnp.asarray, stacks)))
    tin = [torch.from_numpy(logits).requires_grad_(), torch.from_numpy(ori).requires_grad_(),
           [torch.from_numpy(s).requires_grad_() for s in stacks]]
    tl, tparts = TL.total_loss(_tout(*tin), torch.from_numpy(gt[..., 0]), torch.from_numpy(w),
                               torch.from_numpy(omap))
    assert set(tparts) == set(jparts) == {"loss", "ce", "info_nce", "ori"}
    for k in jparts:
        _close(tparts[k], jparts[k])
    tl.backward()
    got = [tin[0].grad, tin[1].grad, *(s.grad for s in tin[2])]
    want = [jgrads[0], jgrads[1], *jgrads[2]]
    for g, wnt in zip(got, want):
        wnt = np.asarray(wnt)
        np.testing.assert_allclose(g.numpy(), wnt, rtol=1e-4, atol=1e-6 * np.abs(wnt).max())


def test_factored_equals_binned():
    logits, ori, stacks = _outputs(8)
    gt, gwo, omap, w = _gt(9)
    tout = _tout(torch.from_numpy(logits), torch.from_numpy(ori), map(torch.from_numpy, stacks))
    _, factored = TL.total_loss(tout, torch.from_numpy(gt[..., 0]), torch.from_numpy(w),
                                torch.from_numpy(omap))
    _, binned = TL.total_loss_binned(tout, torch.from_numpy(gt), torch.from_numpy(gwo),
                                     torch.from_numpy(omap))
    _, jbinned = JL.total_loss_binned(_jout(logits, ori, stacks), jnp.asarray(gt),
                                      jnp.asarray(gwo), jnp.asarray(omap))
    for k in factored:
        _close(factored[k], binned[k], rtol=1e-6)
        _close(binned[k], jbinned[k])
