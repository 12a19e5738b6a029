"""Seeded input images: uint8 noise at model size, for the closed-loop
drivers."""

from __future__ import annotations

import numpy as np


def uniform_batches(rng: np.random.Generator, count: int, batch: int, grd_hw, sat_hw):
    return [(rng.integers(0, 256, (batch, *grd_hw, 3), dtype=np.uint8),
             rng.integers(0, 256, (batch, *sat_hw, 3), dtype=np.uint8))
            for _ in range(count)]
