"""A bf16 train step of the port (``make_train_step(compute_dtype=
"bfloat16")``) against the JAX package's on NANO from the same weights and
batch, drop-connect off, with the self-calibrating bars of
``tests/torch_bf16_bar.py`` (``tests/test_torch_bf16.py`` has the reasons).
Measured values, each as a multiple of JAX's own bf16-vs-f32 distance:

* loss parts, within 1.5x plus one bf16 rounding of the value (a single
  scalar's JAX error may be small by chance): ce 0.23, info_nce 1.41, loss
  1.44, grad_norm 1.51, ori 2.24 (0.033 against an allowance of 0.94).
* all gradient tensors together (inf-norm): 0.99 within 1.5x, and 0.47
  from JAX's float32 gradients (at least 0.25: the step rounds in bf16).
* each gradient tensor alone (2-norm), within 6x its bar
  ||jax_bf16 - jax_f32||_2 + 2**-8 ||jax_f32||_2: 76 of 234 tensors lie
  nearer JAX's bf16 than its float32 gradient; the worst five read 2.6-2.9,
  except the SE reduce bias of satellite block 1 at 5.19.  That gradient
  is a small difference of large products.  XLA fuses the SE block's
  elementwise backward and keeps float32 between its ops
  (``xla_allow_excess_precision``, on by default); the port runs op by op
  and rounds each product to bfloat16, which eager torch cannot avoid.
  Compiling JAX's step with the flag off does not bring it nearer: its
  worst tensor becomes a descriptor-head bias at 8.5x.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from ccvpe_tpu.train import loop as JLOOP
from ccvpe_torch.io.from_jax import grads_from_jax
from ccvpe_torch.train import loop as TLOOP
from tests.torch_bf16_bar import BAR, BF16_RES, FLOOR, assert_bar, inf_dist
from tests.torch_train_parity import B1, CONFIGS, JAX_CONFIGS, jax_step, setup, torch_batch

torch.set_num_threads(2)


def _jax_grads(jnew):
    return grads_from_jax(jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - B1),
                                                 jnew.opt_state[0].mu))


def test_nano_bf16_step_against_jax():
    state, jstate, batch = setup("NANO", 4)
    jcfg, cfg = JAX_CONFIGS["NANO"], CONFIGS["NANO"]

    # one train step from the same start, drop-connect off on both sides
    jstep_bf16 = jax.jit(JLOOP.make_train_step(jcfg, JLOOP.make_optimizer(1e-4),
                                               compute_dtype=jnp.bfloat16))
    jb_state, jb_parts = jstep_bf16(jstate, batch, None)
    jf_state, jf_parts = jax_step("NANO", "einsum", 1)(jstate, batch, None)
    parts = TLOOP.make_train_step(cfg, compute_dtype="bfloat16")(state, torch_batch(batch))
    for k in jf_parts:
        assert parts[k].dtype == torch.float32, k
        assert_bar(k, parts[k], jb_parts[k], jf_parts[k],
                   slack=BF16_RES * abs(float(jf_parts[k])))
    gb, gf = _jax_grads(jb_state), _jax_grads(jf_state)
    named = dict(state.model.named_parameters())
    assert {k for k, p in named.items() if p.grad is not None} == set(gb)
    worst_port = max(inf_dist(named[k].grad, gb[k]) for k in gb)
    worst_jax = max(inf_dist(gb[k], gf[k]) for k in gb)
    from_f32 = max(inf_dist(named[k].grad, gf[k]) for k in gb)
    assert worst_port <= BAR * worst_jax, (worst_port, worst_jax)
    assert from_f32 >= FLOOR * worst_jax, (from_f32, worst_jax)
    for k in gb:
        got = (named[k].grad - gb[k]).norm().item()
        bar = 6 * ((gb[k] - gf[k]).norm().item() + BF16_RES * gf[k].norm().item())
        assert got <= bar, (k, got, bar)
    # the running statistics stay float32
    for k, v in state.model.named_buffers():
        if k.endswith("running_mean"):
            assert v.dtype == torch.float32, k
