"""The port's eval readouts against ccvpe_tpu.ops.readout, on the CPU:
``pose_readout_from_outputs`` (peak from the logits) and
``pose_readout_with_gt`` (from a heatmap) at 1e-6 with rows, cols and GT
peaks exact, including a rounding tie where the two disagree as JAX's do;
then ``train.loop.make_eval_readout_step`` against JAX's
``make_eval_readout_step`` on NANO, with and without an orientation prior
(rows and cols exact, prob_at_gt 1e-5 relative, cos and sin 1e-4)."""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ccvpe_tpu.io.torch_import import import_cvm
from ccvpe_tpu.models import cvm as JC
from ccvpe_tpu.ops import readout as JR
from ccvpe_tpu.train import loop as JLOOP
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.nn.layers import calibrate_batch_norm_
from ccvpe_torch.ops import gt as TG
from ccvpe_torch.ops import readout as TR
from ccvpe_torch.train import loop as TLOOP

torch.set_num_threads(2)
INT_KEYS = ("pred_row", "pred_col", "gt_row", "gt_col")


def _outputs(seed, b=3, h=12, w=10):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, h * w)).astype(np.float32)
    heatmap = torch.softmax(torch.from_numpy(logits), -1).reshape(b, h, w, 1).numpy()
    ori = rng.uniform(-1, 1, (b, h, w, 2)).astype(np.float32)
    gt = rng.uniform(0, 1, (b, h, w)).astype(np.float32)
    gto = rng.uniform(-1, 1, (b, h, w, 2)).astype(np.float32)
    return logits, heatmap, ori, gt, gto


def _check(got: dict, want: dict, tol: dict | None = None):
    """Integer keys exact; float keys within ``tol[k]`` = (atol, rtol),
    default (1e-6, 0)."""
    tol = tol or {}
    assert set(got) == set(want)
    for k in INT_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in set(want) - set(INT_KEYS):
        assert got[k].dtype == torch.float32, k
        atol, rtol = tol.get(k, (1e-6, 0))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def _jax_outputs(logits, heatmap, ori):
    return types.SimpleNamespace(logits_flattened=jnp.asarray(logits),
                                 heatmap=jnp.asarray(heatmap), ori=jnp.asarray(ori))


@pytest.mark.parametrize("gt_channel", [False, True])
def test_readout_from_outputs_matches_jax(gt_channel):
    logits, heatmap, ori, gt, gto = _outputs(0)
    g = gt[..., None] if gt_channel else gt
    out = TC.CVMOutputs(torch.from_numpy(logits), torch.from_numpy(heatmap),
                        torch.from_numpy(ori), ())
    got = TR.pose_readout_from_outputs(out, torch.from_numpy(g), torch.from_numpy(gto))
    want = JR.pose_readout_from_outputs(_jax_outputs(logits, heatmap, ori), jnp.asarray(g),
                                        jnp.asarray(gto))
    _check(got, want)


@pytest.mark.parametrize("gt_channel", [False, True])
def test_readout_with_gt_matches_jax(gt_channel):
    _, heatmap, ori, gt, gto = _outputs(1)
    g = gt[..., None] if gt_channel else gt
    got = TR.pose_readout_with_gt(*map(torch.from_numpy, (heatmap, ori, g, gto)))
    want = JR.pose_readout(*map(jnp.asarray, (heatmap, ori, g, gto)))
    _check(got, want)


def test_rounding_tie_eval_readout_follows_the_logits_api_readout_the_heatmap():
    """Logits 0 and 1e-8 over 512x512 round to one f32 softmax value: the
    eval readout takes the logits' first maximum (index 1), as JAX's
    ``pose_readout_from_outputs``; the readouts from the heatmap (the
    port's API readout and ``pose_readout_with_gt``) take the heatmap's
    (index 0), as JAX's ``pose_readout``."""
    h = w = 512
    logits = torch.full((2, h * w), -10.0)
    logits[:, 0], logits[:, 1] = 0.0, 1e-8
    logits[1, 7 * w + 3] = 5.0                 # a clear peak: no tie
    heatmap = torch.softmax(logits, dim=-1).reshape(2, h, w, 1)
    hm = heatmap[0, ..., 0].reshape(-1)
    assert logits[0].argmax() == 1 and hm[0] == hm[1] and hm.argmax() == 0
    ori = torch.from_numpy(np.random.default_rng(0).standard_normal((2, h, w, 2),
                                                                    dtype=np.float32))
    gt = heatmap[..., 0].flip(1)               # GT peaks elsewhere
    out = TC.CVMOutputs(logits, heatmap, ori, ())
    j_out = _jax_outputs(logits.numpy(), heatmap.numpy(), ori.numpy())

    from_logits = TR.pose_readout_from_outputs(out, gt, ori)
    _check(from_logits, JR.pose_readout_from_outputs(j_out, jnp.asarray(gt.numpy()),
                                                     jnp.asarray(ori.numpy())))
    assert from_logits["pred_col"].tolist() == [1, 3]

    from_heatmap = TR.pose_readout_with_gt(heatmap, ori, gt, ori)
    _check(from_heatmap, JR.pose_readout(*(jnp.asarray(t.numpy())
                                           for t in (heatmap, ori, gt, ori))))
    api = TR.pose_readout(out, want_heatmap=True)
    assert from_heatmap["pred_col"].tolist() == api["col"].tolist() == [0, 3]
    assert from_heatmap["pred_row"].tolist() == api["row"].tolist() == [0, 7]


@pytest.fixture(scope="module")
def nano():
    """A seeded NANO model with calibrated BN statistics, its JAX trees, and
    a seeded batch with its GT."""
    cfg = TC.NANO
    net = TC.CVM(cfg).init_weights_(torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    grd = torch.from_numpy(rng.standard_normal((4, *cfg.grd_hw, 3), dtype=np.float32))
    sat = torch.from_numpy(rng.standard_normal((4, *cfg.sat_hw, 3), dtype=np.float32))
    calibrate_batch_norm_(net, lambda: net(grd[:2], sat[:2]))
    net.eval()
    params, bn = import_cvm({k: v.numpy().copy() for k, v in net.state_dict().items()})
    gt, _, omap = TG.synthesize_batch_factored(
        torch.tensor([-30.0, 5.0, 17.5, 40.0]), torch.tensor([12.0, -44.0, 0.5, 20.0]),
        torch.tensor([10.0, 100.0, 200.0, 350.0]), height=cfg.sat_hw[0],
        width=cfg.sat_hw[1], bins=cfg.bins)
    return cfg, net, params, bn, grd, sat, gt, omap


@pytest.mark.parametrize("loc_offsets", [None, (-1, 0, 1)], ids=["all_bins", "prior"])
def test_eval_readout_step_matches_jax(nano, loc_offsets):
    cfg, net, params, bn, grd, sat, gt, omap = nano
    step = TLOOP.make_eval_readout_step(cfg, loc_offsets, matching_impl="plain")
    got = step(net, grd, sat, gt, omap)
    jstep = jax.jit(JLOOP.make_eval_readout_step(JC.PRESETS["NANO"], loc_offsets,
                                                 matching_impl="einsum"))
    want = jstep(params, bn, *(jnp.asarray(t.numpy()) for t in (grd, sat, gt, omap)))
    _check(got, want, tol={"prob_at_gt": (0, 1e-5), "cos_pred": (1e-4, 0),
                           "sin_pred": (1e-4, 0)})
    assert not net.training and not any(t.requires_grad for t in got.values())
