"""TINY's remat train step in the port against the JAX package's
(``make_train_step(..., remat="all")`` on both sides, einsum matching in
JAX, drop-connect off), at ``tests/test_torch_train.py``'s tolerances.
The remat scopes against the step without remat are
``tests/test_torch_remat.py``."""

import jax
import torch

from ccvpe_tpu.models import cvm as JC
from ccvpe_tpu.train import loop as JLOOP
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.train import loop as TLOOP
from tests.torch_train_parity import check_step, setup, torch_batch

torch.set_num_threads(2)


def test_tiny_remat_step_against_jax():
    """TINY (the VIGOR channel schedule) with remat 'all' on both sides,
    drop-connect off, at ``tests/test_torch_train.py``'s tolerances."""
    state, jstate, batch = setup("TINY", 2)
    before = {k: v.clone() for k, v in state.model.named_buffers()}
    jstep = jax.jit(JLOOP.make_train_step(JC.TINY, JLOOP.make_optimizer(1e-4), remat="all"))
    jnew, jparts = jstep(jstate, batch, None)
    parts = TLOOP.make_train_step(TC.TINY, remat="all")(state, torch_batch(batch))
    check_step(state, parts, jnew, jparts, before)
