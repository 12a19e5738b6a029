"""The port's train step against ``ccvpe_tpu.train.loop.make_train_step`` on
TINY (B0 backbones, the VIGOR channel schedule, Cg < Cs at every scale) with
``matching_impl="pallas"``: the JAX forward runs the Pallas kernel K2 in
interpret mode on the CPU and its backward through the einsum; the port
takes its plain versions.  Set-up and tolerances as in test_torch_train.py.
"""

import torch

from tests.torch_train_parity import run_both

torch.set_num_threads(2)


def test_one_step_tiny_pallas():
    run_both("TINY", 2, "pallas")
