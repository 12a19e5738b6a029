"""ccvpe_torch.api against ccvpe_tpu.api on the NANO preset, on the CPU.

One set of weights serves both: the port's seeded init with calibrated
BatchNorm statistics (so the outputs depend on the images), handed to the
JAX package through ``import_cvm``, written as a reference-format ``.pt``
by ``save_torch_checkpoint`` and read back by the port's ``load_model``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ccvpe_tpu import api as JA
from ccvpe_tpu.data import transforms as JT
from ccvpe_tpu.io.torch_import import import_cvm, save_torch_checkpoint
from ccvpe_tpu.models import cvm as JC
from ccvpe_tpu.train import metrics as JMET
from ccvpe_torch import api as TA
from ccvpe_torch.data import transforms as TT
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.nn.layers import calibrate_batch_norm_
from ccvpe_torch.ops.readout import pose_readout
from ccvpe_torch.train import metrics as TMET

torch.set_num_threads(2)


def _images(batch, seed, grd_hw=(64, 128), sat_hw=(128, 128)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (batch, *grd_hw, 3), dtype=np.uint8),
            rng.integers(0, 256, (batch, *sat_hw, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    net = TC.CVM(TC.NANO).init_weights_(torch.Generator().manual_seed(0))
    grd, sat = _images(4, seed=50)
    with torch.no_grad():
        g, s = TT.normalize_images(torch.from_numpy(grd)), TT.normalize_images(torch.from_numpy(sat))
    calibrate_batch_norm_(net, lambda: net(g, s))
    params, state = import_cvm({k: v.numpy() for k, v in net.state_dict().items()})
    path = tmp_path_factory.mktemp("ckpt") / "nano.pt"
    save_torch_checkpoint(str(path), params, state)
    jmodel = JA.CVMModel(JC.NANO, params, state)
    tmodel = TA.load_model(str(path), preset="NANO", device="cpu")
    return jmodel, tmodel


def _angle_diff(a, b):
    return abs((a - b + 180.0) % 360.0 - 180.0)


@pytest.mark.parametrize("ori_noise,fov,return_heatmap", [
    (180.0, 360.0, False),
    (36.0, 360.0, False),
    (180.0, 180.0, True),
    (36.0, 360.0, True),
])
def test_predict_batch_matches_jax(models, ori_noise, fov, return_heatmap):
    jmodel, tmodel = models
    grd, sat = _images(2, seed=int(ori_noise + fov))
    want = jmodel.predict_batch(grd, sat, ori_noise=ori_noise, fov=fov,
                                return_heatmap=return_heatmap)
    got = tmodel.predict_batch(grd, sat, ori_noise=ori_noise, fov=fov,
                               return_heatmap=return_heatmap)
    assert len(got) == len(want) == 2
    for p, q in zip(got, want):
        assert (p.row, p.col) == (q.row, q.col)
        np.testing.assert_allclose(p.probability, q.probability, rtol=1e-4)
        assert _angle_diff(p.orientation_deg, q.orientation_deg) < 1e-2
        if return_heatmap:
            assert p.heatmap.shape == (128, 128)
            np.testing.assert_allclose(p.heatmap, q.heatmap, atol=1e-7, rtol=1e-4)
            r, c = np.unravel_index(p.heatmap.argmax(), p.heatmap.shape)
            assert (r, c) == (p.row, p.col)
        else:
            assert p.heatmap is None


def test_predict_resizes_like_jax(models):
    jmodel, tmodel = models
    rng = np.random.default_rng(3)
    grd = rng.integers(0, 256, (100, 222, 3), dtype=np.uint8)
    sat = rng.integers(0, 256, (150, 150, 3), dtype=np.uint8)
    p, q = tmodel.predict(grd, sat), jmodel.predict(grd, sat)
    assert (p.row, p.col) == (q.row, q.col)
    assert 0 <= p.probability <= 1 and 0 <= p.orientation_deg < 360
    assert _angle_diff(p.orientation_deg, q.orientation_deg) < 1e-2


def test_argmax_ties_take_the_row_major_first_maximum():
    h, w = 4, 5
    logits = torch.zeros(3, h * w)
    logits[0, [7, 3, 18]] = 2.0           # first maximum at flat index 3
    logits[1, [19, 10]] = 1.0             # at 10
    # all equal: index 0
    ori = torch.zeros(3, h, w, 2)
    ori[..., 0] = 1.0
    out = TC.CVMOutputs(logits, torch.softmax(logits, -1).reshape(3, h, w, 1), ori, ())
    r = pose_readout(out, want_heatmap=True)
    assert r["row"].tolist() == [0, 2, 0] and r["col"].tolist() == [3, 0, 0]
    flat = logits.numpy().argmax(axis=1)
    assert (r["row"] * w + r["col"]).tolist() == flat.tolist()
    np.testing.assert_allclose(r["prob"].numpy(),
                               out.heatmap[..., 0].reshape(3, -1).amax(1).numpy(), rtol=1e-6)
    assert r["heatmap"].shape == (3, h, w)


def test_normalize_images_and_angles_match_jax():
    x = np.random.default_rng(0).integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    np.testing.assert_allclose(TT.normalize_images(torch.from_numpy(x)).numpy(),
                               np.asarray(JT.normalize_images(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)
    rng = np.random.default_rng(1)
    cos, sin = rng.uniform(-1.2, 1.2, 64), rng.uniform(-1.2, 1.2, 64)
    for got, want in zip(TMET.angle_from_cos_sin(cos, sin), JMET.angle_from_cos_sin(cos, sin)):
        np.testing.assert_array_equal(got, want)


def test_ori_noise_to_n_matches_jax():
    for noise in (0.0, 10.0, 18.0, 36.0, 90.0, 179.9, 180.0, 360.0):
        assert TA._ori_noise_to_n(noise) == JA._ori_noise_to_n(noise)


def test_load_model_rejects_other_checkpoint_formats():
    with pytest.raises(ValueError, match=r"\.pt"):
        TA.load_model("/nonexistent/orbax_dir", preset="NANO", device="cpu")


def test_heatmap_readout_takes_the_heatmaps_first_maximum():
    """Two distinct logits that round to one f32 softmax value: with the
    heatmap asked for, the peak is the heatmap's row-major first maximum
    (index 0 here), as ``ccvpe_tpu.ops.readout.pose_readout`` reads it, not
    the logits' (index 1)."""
    from ccvpe_tpu.ops import readout as JR

    h = w = 512
    logits = torch.full((2, h * w), -10.0)
    logits[:, 0], logits[:, 1] = 0.0, 1e-8
    logits[1, 7 * w + 3] = 5.0                 # a clear peak: no tie
    heatmap = torch.softmax(logits, dim=-1).reshape(2, h, w, 1)
    hm = heatmap[0, ..., 0].reshape(-1)
    assert logits[0].argmax() == 1 and hm[0] == hm[1] and hm.argmax() == 0
    ori = torch.from_numpy(np.random.default_rng(0).standard_normal((2, h, w, 2),
                                                                    dtype=np.float32))
    out = TC.CVMOutputs(logits, heatmap, ori, ())
    r = pose_readout(out, want_heatmap=True)
    want = JR.pose_readout(jnp.asarray(heatmap.numpy()), jnp.asarray(ori.numpy()),
                           jnp.asarray(heatmap.numpy()), jnp.asarray(ori.numpy()))
    np.testing.assert_array_equal(r["row"].numpy(), np.asarray(want["pred_row"]))
    np.testing.assert_array_equal(r["col"].numpy(), np.asarray(want["pred_col"]))
    assert r["row"].tolist() == [0, 7] and r["col"].tolist() == [0, 3]
    np.testing.assert_array_equal(r["cos"].numpy(), np.asarray(want["cos_pred"]))
    np.testing.assert_array_equal(r["sin"].numpy(), np.asarray(want["sin_pred"]))
    # the probability is the heatmap's value at that pixel (= prob_at_gt
    # here, the GT being the same heatmap)
    np.testing.assert_array_equal(r["prob"].numpy(), np.asarray(want["prob_at_gt"]))
    # without the heatmap the logits' path stays: its first maximum
    assert pose_readout(out)["col"].tolist() == [1, 3]
