"""The self-calibrating bf16 bars shared by ``tests/test_torch_bf16.py`` and
``tests/test_torch_bf16_step.py`` (the reasons and the measured values are
in their docstrings).

``assert_bar``: the port's bf16 result lies within ``BAR`` times JAX's own
bf16-vs-f32 distance of JAX's bf16 result, plus an optional slack.
``assert_rounds_in_bf16``: the port's result lies at least ``FLOOR`` times
that distance from JAX's float32 result, so it carries bfloat16's rounding
(a port that ran the whole computation in float32 would sit on JAX's
float32 result and fail).
"""

import numpy as np
import jax.numpy as jnp
import torch

BF16_RES = 2.0 ** -8
BAR = 1.5
FLOOR = 0.25


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def inf_dist(a, b) -> float:
    return float(np.abs(f32(a) - f32(b)).max())


def assert_bar(name, port, jax_bf16, jax_f32, slack: float = 0.0):
    got, bar = inf_dist(port, jax_bf16), BAR * inf_dist(jax_bf16, jax_f32) + slack
    assert got <= bar, f"{name}: port vs JAX bf16 {got} > {bar}"


def assert_rounds_in_bf16(name, port, jax_bf16, jax_f32):
    own, floor = inf_dist(port, jax_f32), FLOOR * inf_dist(jax_bf16, jax_f32)
    assert own >= floor, f"{name}: port vs JAX float32 {own} < {floor}"
