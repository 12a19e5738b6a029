"""The port's train step with ``grad_accum=2`` (strided microbatches: sample
i goes to microbatch i % 2) against ``ccvpe_tpu.train.loop.make_train_step``
on NANO, on the CPU; set-up and tolerances as in test_torch_train.py."""

import jax
import torch

from ccvpe_tpu.nn import efficientnet as JE
from tests.torch_train_parity import run_both

torch.set_num_threads(2)


def test_grad_accum_2_strided_microbatches(monkeypatch):
    # the JAX step splits its key per microbatch, so it needs one; its
    # drop-connect is turned off by the rate instead
    monkeypatch.setattr(JE, "DROP_CONNECT_RATE", 0.0)
    run_both("NANO", 4, "einsum", grad_accum=2, jax_rng=jax.random.PRNGKey(0))


