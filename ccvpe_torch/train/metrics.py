"""Evaluation metrics (counterpart of ``ccvpe_tpu/train/metrics.py``); this
slice needs only the orientation readout."""

from __future__ import annotations

import numpy as np


def angle_from_cos_sin(cos_v, sin_v):
    """Orientation angle in degrees from a (cos, sin) pair: acos, with the
    sign of sin choosing the half-turn.

    Returns (angles [B], valid [B]); invalid where |cos| > 1 or |sin| > 1.
    """
    cos_v = np.asarray(cos_v, np.float64)
    sin_v = np.asarray(sin_v, np.float64)
    valid = (np.abs(cos_v) <= 1) & (np.abs(sin_v) <= 1)
    a = np.degrees(np.arccos(np.clip(cos_v, -1, 1)))
    angles = np.where(sin_v < 0, (-a) % 360, a)
    return angles, valid
