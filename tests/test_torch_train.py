"""ccvpe_torch.train.loop against ccvpe_tpu.train.loop.make_train_step on the
CPU: the same weights (the port's seeded init with BN statistics calibrated
on one seeded batch, carried to JAX by ``import_cvm``), the same batch (JAX
GT synthesis), drop-connect off on both sides (JAX ``rng=None``, the port
``generator=None``).  NANO with ``matching_impl="einsum"`` here;
``grad_accum=2`` in ``test_torch_train_accum.py``; TINY with the Pallas
kernels in interpret mode in ``test_torch_train_tiny.py``.  The shared
set-up is ``tests/torch_train_parity.py``.

The JAX step does not return its gradients: after one Adam step from zero
moments its first moment is (1 - b1) * g, so ``mu / (1 - b1)`` gives them
back to within a rounding.

Tolerances, as the port's training slice fixes them:
* loss parts and ``grad_norm``: rtol 1e-5;
* each gradient tensor: ||port - jax|| <= 1e-3 ||jax|| + 1e-6 grad_norm;
* the new BatchNorm running statistics: atol 1e-5, rtol 1e-5;
* Adam from identical gradients: parameters atol 1e-7, rtol 1e-6.
The whole step's parameters are not compared after the update: where a
gradient is near Adam's eps (1e-8), a rounding can flip its update's sign.
"""

import numpy as np
import jax
import optax
import pytest
import torch

from ccvpe_tpu.train import loop as JLOOP
from ccvpe_torch.io.from_jax import grads_from_jax, state_dict_from_jax
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.train import loop as TLOOP
from tests.torch_train_parity import RTOL, jax_step, make_batch, run_both, setup, torch_batch

torch.set_num_threads(2)


def test_one_step_nano_einsum_and_three_step_trajectory():
    state, jnew, batch = run_both("NANO", 4, "einsum")
    step, jstep = TLOOP.make_train_step(TC.NANO), jax_step("NANO", "einsum", 1)
    tb = torch_batch(batch)
    for _ in range(2):
        jnew, jparts = jstep(jnew, batch, None)
        parts = step(state, tb)
        for k in jparts:
            np.testing.assert_allclose(parts[k].item(), float(jparts[k]), rtol=RTOL, err_msg=k)
    assert state.step == 3


def test_adam_from_identical_gradients():
    """Three Adam updates of both optimizers from the same gradients, of
    magnitudes 1e-8 ... 1 (Adam's eps matters at the small end)."""
    state, jstate, _ = setup("NANO", 2)
    opt = JLOOP.make_optimizer(1e-4)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    params, opt_state = jstate.params, jstate.opt_state
    named = dict(state.model.named_parameters())
    rng = np.random.default_rng(5)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: (rng.standard_normal(p.shape) * 10.0 ** rng.integers(-8, 1)
                       ).astype(np.float32), params)
        params, opt_state = update(grads, opt_state, params)
        for k, g in grads_from_jax(grads).items():
            named[k].grad = g
        state.optimizer.step()
    want = state_dict_from_jax(params, jstate.bn_state)
    for k, p in named.items():
        torch.testing.assert_close(p.detach(), want[k], atol=1e-7, rtol=1e-6, msg=k)


def test_step_rejects_what_it_cannot_take():
    state, _, batch = setup("NANO", 4)
    with pytest.raises(ValueError, match="divisible"):
        TLOOP.make_train_step(TC.NANO, grad_accum=3)(state, torch_batch(batch))
    with pytest.raises(ValueError, match="TINY"):
        TLOOP.make_train_step(TC.TINY)(state, torch_batch(batch))
    assert state.step == 0


def test_drop_connect_draws_from_the_generator():
    """The same seed gives the same step; drop-connect changes it (TINY: B0
    has identity-skip blocks past the first, NANO none); a model handed over
    in eval mode goes back in eval mode."""
    tb = torch_batch(make_batch(TC.TINY, 2, 1))
    step = TLOOP.make_train_step(TC.TINY)
    runs = []
    for seed in (1, 1, None):
        state = TLOOP.create_train_state(TC.TINY, seed=0, device="cpu")
        state.model.eval()
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        runs.append(step(state, tb, gen))
        assert not state.model.training
    assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
    assert runs[0]["loss"].item() != runs[2]["loss"].item()


@pytest.mark.parametrize("loc_offsets", [None, (-1, 0, 1)])
def test_eval_step(loc_offsets):
    """BatchNorm on its running statistics, no autograd, no state change, the
    model's mode kept; the eval forward itself is held to JAX in
    test_torch_cvm.py."""
    state, _, batch = setup("NANO", 2)
    grd, sat = torch.from_numpy(batch["grd"]), torch.from_numpy(batch["sat"])
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    out = TLOOP.make_eval_step(TC.NANO, loc_offsets)(state.model, grd, sat)
    assert state.model.training and not out.logits_flattened.requires_grad
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with torch.no_grad():
        want = state.model.eval()(grd, sat, loc_offsets=loc_offsets)
    for got, ref in zip((out.logits_flattened, out.ori, *out.matching_scores),
                        (want.logits_flattened, want.ori, *want.matching_scores)):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
