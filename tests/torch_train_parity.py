"""Shared set-up of the port's train-step tests against the JAX package's
(``tests/test_torch_train*.py``); the tolerances are stated there."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from ccvpe_tpu.io.torch_import import import_cvm
from ccvpe_tpu.models import cvm as JC
from ccvpe_tpu.ops import gt as JG
from ccvpe_tpu.train import loop as JLOOP
from ccvpe_torch.io.from_jax import grads_from_jax, state_dict_from_jax
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.nn.layers import calibrate_batch_norm_
from ccvpe_torch.train import loop as TLOOP

RTOL = 1e-5
B1 = 0.9
# the configurations a test may name: the presets, plus what ``register`` adds
CONFIGS = dict(TC.PRESETS)
JAX_CONFIGS = dict(JC.PRESETS)


def register(name, torch_cfg, jax_cfg):
    """Make a configuration built in a test (a port and a JAX
    ``CVMConfig`` of the same fields) nameable by ``setup``/``run_both``."""
    CONFIGS[name], JAX_CONFIGS[name] = torch_cfg, jax_cfg


def make_batch(cfg, b, seed):
    """Seeded images and factored GT (offsets within +-20 px) as numpy."""
    rng = np.random.default_rng(seed)
    h, w = cfg.sat_hw
    gt, weights, omap = JG.synthesize_batch_factored(
        *(jnp.asarray(rng.uniform(lo, hi, b), jnp.float32)
          for lo, hi in ((-20, 20), (-20, 20), (0, 360))),
        height=h, width=w, bins=cfg.bins)
    return {"grd": rng.standard_normal((b, *cfg.grd_hw, 3)).astype(np.float32),
            "sat": rng.standard_normal((b, h, w, 3)).astype(np.float32),
            "gt": np.array(gt), "bin_weights": np.array(weights), "orientation": np.array(omap)}


def setup(cfg_name, b, seed=0):
    """(port TrainState, JAX TrainState, batch as numpy) from one seeded
    init with calibrated BN statistics."""
    cfg = CONFIGS[cfg_name]
    state = TLOOP.create_train_state(cfg, seed=seed, device="cpu")
    batch = make_batch(cfg, b, seed + 1)
    calib = make_batch(cfg, 2, seed + 2)
    net = state.model
    calibrate_batch_norm_(net, lambda: net(torch.from_numpy(calib["grd"]),
                                           torch.from_numpy(calib["sat"])))
    net.train()
    # copies: JAX may alias numpy memory, and runs its step asynchronously
    # while the port's step updates its tensors in place
    params, bn = import_cvm({k: v.numpy().copy() for k, v in net.state_dict().items()})
    opt = JLOOP.make_optimizer(1e-4)
    jstate = JLOOP.TrainState(jnp.zeros((), jnp.int32), params, bn, opt.init(params))
    return state, jstate, batch


@functools.cache
def jax_step(cfg_name, matching_impl, grad_accum=1):
    return jax.jit(JLOOP.make_train_step(JAX_CONFIGS[cfg_name], JLOOP.make_optimizer(1e-4),
                                         matching_impl=matching_impl, grad_accum=grad_accum))


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def check_step(state, parts, jnew, jparts, buffers_before):
    """The port's step (already taken: ``state``, ``parts``) against the JAX
    step from the same start (``jnew``, ``jparts``)."""
    assert set(parts) == set(jparts) == {"loss", "ce", "info_nce", "ori", "grad_norm"}
    for k in jparts:
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]), rtol=RTOL, err_msg=k)
    grad_norm = float(jparts["grad_norm"])
    jgrads = grads_from_jax(jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - B1),
                                                   jnew.opt_state[0].mu))
    named = dict(state.model.named_parameters())
    with_grad = {k for k, p in named.items() if p.grad is not None}
    assert with_grad == set(jgrads) == {k for k in named if "._fc." not in k}
    for k, want in jgrads.items():
        err = (named[k].grad - want).norm().item()
        lim = 1e-3 * want.norm().item() + 1e-6 * grad_norm
        assert err <= lim, (k, err, lim)
    buffers = dict(state.model.named_buffers())
    stats = [k for k in buffers if k.endswith(("running_mean", "running_var"))]
    want = state_dict_from_jax(jnew.params, jnew.bn_state)
    for k in stats:
        torch.testing.assert_close(buffers[k], want[k], atol=1e-5, rtol=1e-5, msg=k)
    assert all(not torch.equal(buffers[k], buffers_before[k]) for k in stats)


def run_both(cfg_name, b, matching_impl, grad_accum=1, jax_rng=None):
    """One step of each side from the same start; checks them; returns the
    port's state, the JAX state and the batch for further steps."""
    state, jstate, batch = setup(cfg_name, b)
    before = {k: v.clone() for k, v in state.model.named_buffers()}
    jnew, jparts = jax_step(cfg_name, matching_impl, grad_accum)(jstate, batch, jax_rng)
    step = TLOOP.make_train_step(CONFIGS[cfg_name], grad_accum=grad_accum)
    parts = step(state, torch_batch(batch))
    assert state.step == 1 and state.model.training
    check_step(state, parts, jnew, jparts, before)
    return state, jnew, batch


def sharded_axes(shardings, params, name=None) -> dict:
    """The sharded axis of each leaf of a JAX ``NamedSharding`` tree of the
    shape of ``params`` (None where replicated; ``name``: the axis sharded
    over that mesh axis only), named and laid out as the port's parameters:
    each leaf's sharded axis is marked by an arange and carried through
    ``io/from_jax``'s layout rules (``grads_from_jax``)."""
    def mark(sh, p):
        spec = list(sh.spec) + [None] * (p.ndim - len(sh.spec))
        ax = next((i for i, a in enumerate(spec)
                   if a is not None and (name is None or a == name)), None)
        if ax is None:
            return np.zeros(p.shape, np.float32)
        shape = [1] * p.ndim
        shape[ax] = p.shape[ax]
        return np.broadcast_to(np.arange(p.shape[ax], dtype=np.float32).reshape(shape),
                               p.shape).copy()

    marked = grads_from_jax(jax.tree_util.tree_map(mark, shardings, params))

    def axis(t):
        moving = [i for i in range(t.dim()) if t.shape[i] > 1 and (t.diff(dim=i) != 0).any()]
        assert len(moving) <= 1, moving
        return moving[0] if moving else None

    return {k: axis(t) for k, t in marked.items()}
