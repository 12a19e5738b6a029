"""Evaluation metrics (counterpart of ``ccvpe_tpu/train/metrics.py``, a copy:
that module is numpy-only) -- the behavioral contract of the reference eval
loops (``train_VIGOR.py:166-338``, ``train_KITTI.py:168-432``,
``train_OxfordRobotCar.py:150-397``), vectorized over the batch in numpy.

Includes the reference's per-city meter conversions, acos-based orientation
recovery with the |cos|<=1 validity guard, lateral/longitudinal error
decomposition, and <1/3/5 m-and-degree recalls.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# meters/pixel at native 640px VIGOR aerial resolution, rescaled to the 512px
# model input (reference ``train_VIGOR.py:193-200``)
VIGOR_METER_PER_PIXEL = {
    "NewYork": 0.113248 / 512 * 640,
    "Seattle": 0.100817 / 512 * 640,
    "SanFrancisco": 0.118141 / 512 * 640,
    "Chicago": 0.111262 / 512 * 640,
}

# Oxford stitched map: 0.09240351462361521 m/px at 800px crops resized to 512
# (reference ``datasets.py:193``, ``train_OxfordRobotCar.py:204,249``)
OXFORD_METER_PER_PIXEL = 0.09240351462361521 * 800 / 512


def argmax_2d(maps):
    """[B, H, W] -> (rows [B], cols [B]) of the per-sample argmax."""
    b, h, w = maps.shape
    flat = maps.reshape(b, -1).argmax(axis=1)
    return flat // w, flat % w


def angle_from_cos_sin(cos_v, sin_v):
    """Orientation angle in degrees from a (cos, sin) pair, replicating the
    reference's acos + sin-sign disambiguation (``train_VIGOR.py:203-217``).

    Returns (angles [B], valid [B]); invalid where |cos|>1 or |sin|>1.
    """
    cos_v = np.asarray(cos_v, np.float64)
    sin_v = np.asarray(sin_v, np.float64)
    valid = (np.abs(cos_v) <= 1) & (np.abs(sin_v) <= 1)
    a = np.degrees(np.arccos(np.clip(cos_v, -1, 1)))
    angles = np.where(sin_v < 0, (-a) % 360, a)
    return angles, valid


def angular_error_deg(angle_a, angle_b):
    d = np.abs(angle_a - angle_b)
    return np.minimum(d, 360 - d)


@dataclass
class PoseErrorAccumulator:
    """Streaming accumulator for a full eval pass."""

    distance_px: list = field(default_factory=list)
    distance_m: list = field(default_factory=list)
    lateral_m: list = field(default_factory=list)
    longitudinal_m: list = field(default_factory=list)
    orientation_err: list = field(default_factory=list)
    probability_at_gt: list = field(default_factory=list)

    def update(self, heatmap, gt, ori, gt_orientation, meter_per_pixel,
               orientation_from_north=None):
        """Accumulate one batch.

        Args (all numpy, NHWC):
          heatmap: [B, H, W, 1] predicted probabilities.
          gt: [B, H, W, 1] GT Gaussian.
          ori: [B, H, W, 2] predicted (cos, sin) field.
          gt_orientation: [B, H, W, 2] GT field.
          meter_per_pixel: scalar or [B] conversion.
          orientation_from_north: optional [B] GT heading in degrees, enables
            the lateral/longitudinal decomposition
            (reference ``train_KITTI.py:320-327``).
        """
        heatmap = np.asarray(heatmap)[..., 0]
        gt = np.asarray(gt)[..., 0]
        ori = np.asarray(ori)
        gt_orientation = np.asarray(gt_orientation)
        b = heatmap.shape[0]
        mpp = np.broadcast_to(np.asarray(meter_per_pixel, np.float64), (b,))

        gr, gc = argmax_2d(gt)
        pr, pc = argmax_2d(heatmap)
        px = np.sqrt((gr - pr) ** 2.0 + (gc - pc) ** 2.0)
        self.distance_px.extend(px)
        self.distance_m.extend(px * mpp)
        self.probability_at_gt.extend(heatmap[np.arange(b), gr, gc])

        cos_p = ori[np.arange(b), pr, pc, 0]
        sin_p = ori[np.arange(b), pr, pc, 1]
        ang_p, valid = angle_from_cos_sin(cos_p, sin_p)
        cos_g = gt_orientation[np.arange(b), gr, gc, 0]
        sin_g = gt_orientation[np.arange(b), gr, gc, 1]
        ang_g, _ = angle_from_cos_sin(cos_g, sin_g)
        err = angular_error_deg(ang_g, ang_p)
        self.orientation_err.extend(err[valid])

        if orientation_from_north is not None:
            self._accumulate_lat_lon(orientation_from_north, gr, gc, pr, pc,
                                     px, mpp)

    def _accumulate_lat_lon(self, heading, gr, gc, pr, pc, px, mpp):
        """Vehicle-frame error decomposition, reference
        ``train_KITTI.py:320-327`` — one definition for both the
        full-heatmap and the device-readout eval paths."""
        heading = np.asarray(heading, np.float64)
        gt2pred = np.degrees(np.arctan2(np.abs(gc - pc), np.abs(gr - pr)))
        diff = np.abs(heading - gt2pred)
        self.longitudinal_m.extend(
            np.abs(np.cos(np.radians(diff)) * px) * mpp)
        self.lateral_m.extend(
            np.abs(np.sin(np.radians(diff)) * px) * mpp)

    def update_from_readout(self, r: dict, meter_per_pixel,
                            orientation_from_north=None):
        """Accumulate one batch from on-device pose scalars
        (``ops.readout.pose_readout_from_outputs``) — same math as ``update`` without the
        full-heatmap host transfer."""
        px = np.asarray(r["pixel_distance"], np.float64)
        b = px.shape[0]
        mpp = np.broadcast_to(np.asarray(meter_per_pixel, np.float64), (b,))
        self.distance_px.extend(px)
        self.distance_m.extend(px * mpp)
        self.probability_at_gt.extend(np.asarray(r["prob_at_gt"]))

        ang_p, valid = angle_from_cos_sin(r["cos_pred"], r["sin_pred"])
        ang_g, _ = angle_from_cos_sin(r["cos_gt"], r["sin_gt"])
        err = angular_error_deg(ang_g, ang_p)
        self.orientation_err.extend(err[valid])

        if orientation_from_north is not None:
            self._accumulate_lat_lon(
                orientation_from_north,
                np.asarray(r["gt_row"], np.float64),
                np.asarray(r["gt_col"], np.float64),
                np.asarray(r["pred_row"], np.float64),
                np.asarray(r["pred_col"], np.float64), px, mpp)

    def summary(self):
        if not self.distance_m:
            # an empty eval (empty split / over-trimmed --steps_per_epoch)
            # must fail loudly, not write NaN metrics into epoch results
            raise ValueError(
                "PoseErrorAccumulator.summary() with zero accumulated "
                "samples — the eval loader produced no batches")
        out = {
            "mean_distance_m": float(np.mean(self.distance_m)),
            "median_distance_m": float(np.median(self.distance_m)),
        }
        if self.orientation_err:
            out["mean_orientation_deg"] = float(np.mean(self.orientation_err))
            out["median_orientation_deg"] = float(
                np.median(self.orientation_err))
            oe = np.asarray(self.orientation_err)
            for t in (1, 3, 5):
                out[f"orientation_recall@{t}deg"] = float(np.mean(oe < t))
        if self.probability_at_gt:
            out["mean_probability_at_gt"] = float(
                np.mean(self.probability_at_gt))
            out["median_probability_at_gt"] = float(
                np.median(self.probability_at_gt))
        for name, vals in (("lateral", self.lateral_m),
                           ("longitudinal", self.longitudinal_m)):
            if vals:
                arr = np.asarray(vals)
                # reference prints per-axis mean/median too
                # (``train_OxfordRobotCar.py:252-255``)
                out[f"mean_{name}_m"] = float(np.mean(arr))
                out[f"median_{name}_m"] = float(np.median(arr))
                for t in (1, 3, 5):
                    out[f"{name}_recall@{t}m"] = float(np.mean(arr < t))
        return out
