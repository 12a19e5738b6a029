"""ccvpe_torch.train.metrics against ccvpe_tpu.train.metrics: the pose error
accumulator on seeded readouts and heatmaps (rows with |cos| > 1, per-city
meters per pixel, headings), summaries equal to 1e-12 with the same keys,
and the error of an empty pass."""

import numpy as np
import pytest

from ccvpe_tpu.train import metrics as JM
from ccvpe_torch.train import metrics as TM

TOL = 1e-12


def _readout(rng, b, hw=(16, 16)):
    h, w = hw
    r = {"pred_row": rng.integers(0, h, b), "pred_col": rng.integers(0, w, b),
         "gt_row": rng.integers(0, h, b), "gt_col": rng.integers(0, w, b),
         "prob_at_gt": rng.uniform(0, 1e-3, b).astype(np.float32)}
    r["pixel_distance"] = np.sqrt((r["gt_row"] - r["pred_row"]) ** 2.0
                                  + (r["gt_col"] - r["pred_col"]) ** 2.0).astype(np.float32)
    # some predicted (cos, sin) outside [-1, 1]: the reference drops them
    for k in ("cos_pred", "sin_pred", "cos_gt", "sin_gt"):
        r[k] = rng.uniform(-1.2 if k.endswith("pred") else -1, 1.2 if k.endswith("pred") else 1,
                           b).astype(np.float32)
    return r


def _assert_summaries_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)


def test_constants_and_helpers_match_jax():
    assert TM.VIGOR_METER_PER_PIXEL == JM.VIGOR_METER_PER_PIXEL
    assert TM.OXFORD_METER_PER_PIXEL == JM.OXFORD_METER_PER_PIXEL
    rng = np.random.default_rng(0)
    maps = rng.standard_normal((5, 7, 9))
    maps[0, 2, 3] = maps[0, 4, 1] = maps[0].max() + 1      # a tie: the first wins
    for got, want in zip(TM.argmax_2d(maps), JM.argmax_2d(maps)):
        np.testing.assert_array_equal(got, want)
    a, b = rng.uniform(0, 360, 50), rng.uniform(0, 360, 50)
    np.testing.assert_array_equal(TM.angular_error_deg(a, b), JM.angular_error_deg(a, b))
    cos, sin = rng.uniform(-1.2, 1.2, 64), rng.uniform(-1.2, 1.2, 64)
    for got, want in zip(TM.angle_from_cos_sin(cos, sin), JM.angle_from_cos_sin(cos, sin)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("heading", [False, True])
@pytest.mark.parametrize("per_city", [False, True])
def test_readout_accumulator_matches_jax(heading, per_city):
    rng = np.random.default_rng(1 + 2 * heading + per_city)
    got, want = TM.PoseErrorAccumulator(), JM.PoseErrorAccumulator()
    cities = list(JM.VIGOR_METER_PER_PIXEL)
    for b in (5, 8, 3):
        r = _readout(rng, b)
        mpp = (np.asarray([JM.VIGOR_METER_PER_PIXEL[c] for c in rng.choice(cities, b)],
                          np.float32) if per_city else 0.2)
        head = rng.uniform(0, 360, b).astype(np.float32) if heading else None
        got.update_from_readout(dict(r), mpp, orientation_from_north=head)
        want.update_from_readout(dict(r), mpp, orientation_from_north=head)
    s = got.summary()
    _assert_summaries_equal(s, want.summary())
    assert ("mean_lateral_m" in s) == heading
    # some predictions had |cos| > 1 or |sin| > 1 and were left out
    assert len(got.orientation_err) < len(got.distance_m)


def test_heatmap_accumulator_matches_jax_and_the_readout_path():
    """``update`` on full heatmaps against JAX's, and against
    ``update_from_readout`` on the same samples' pose scalars."""
    rng = np.random.default_rng(3)
    b, h, w = 6, 12, 10
    heat = rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    gt = rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    ori = rng.uniform(-1.1, 1.1, (b, h, w, 2)).astype(np.float32)
    gto = rng.uniform(-1, 1, (b, h, w, 2)).astype(np.float32)
    mpp = rng.uniform(0.1, 0.3, b)
    head = rng.uniform(0, 360, b)
    got, want = TM.PoseErrorAccumulator(), JM.PoseErrorAccumulator()
    got.update(heat, gt, ori, gto, mpp, orientation_from_north=head)
    want.update(heat, gt, ori, gto, mpp, orientation_from_north=head)
    _assert_summaries_equal(got.summary(), want.summary())

    pr, pc = JM.argmax_2d(heat[..., 0])
    gr, gc = JM.argmax_2d(gt[..., 0])
    idx = np.arange(b)
    r = {"pred_row": pr, "pred_col": pc, "gt_row": gr, "gt_col": gc,
         "pixel_distance": np.sqrt((gr - pr) ** 2.0 + (gc - pc) ** 2.0),
         "prob_at_gt": heat[idx, gr, gc, 0],
         "cos_pred": ori[idx, pr, pc, 0], "sin_pred": ori[idx, pr, pc, 1],
         "cos_gt": gto[idx, gr, gc, 0], "sin_gt": gto[idx, gr, gc, 1]}
    from_readout = TM.PoseErrorAccumulator()
    from_readout.update_from_readout(r, mpp, orientation_from_north=head)
    _assert_summaries_equal(from_readout.summary(), got.summary())


def test_empty_pass_raises():
    for acc in (TM.PoseErrorAccumulator(), JM.PoseErrorAccumulator()):
        with pytest.raises(ValueError, match="zero accumulated samples"):
            acc.summary()
