"""bfloat16-resident parameters with a float32 master (``--bf16_params``):
the port's ``F32MasterAdam`` against the JAX package's ``with_f32_master``,
on the CPU.

Each package sets the resident parameter as ``optax.apply_updates`` does:
``bf16(p + (m - p))`` in float32, from the old resident ``p`` and the new
master ``m``.  That is ``bf16(m)`` unless ``m - p`` rounds (a parameter that
lands near zero from far away) and the sum then falls on the other side of
a bfloat16 rounding point.  ``test_resident_rounding_against_apply_updates``
gives both packages the same ``p`` and ``m``, many of them across zero, and
holds the residents bit for bit.  Over three Adam steps from the same
bfloat16 gradients the masters agree at 1e-6 relative (Adam in float32 on
both sides, as ``tests/test_torch_train.py::test_adam_from_identical_gradients``
holds it, but torch's and optax's Adam round in different places: about
two thirds of the master elements differ in their last bits), so there the
residents are equal bit for bit wherever the masters are, and within one
bfloat16 step elsewhere (measured: 50 of 560376 elements).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from ccvpe_tpu.io.torch_import import import_cvm
from ccvpe_tpu.train import loop as JLOOP
from ccvpe_torch.io.from_jax import grads_from_jax, state_dict_from_jax
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.train import loop as TLOOP

torch.set_num_threads(2)


def _states():
    state = TLOOP.create_train_state(TC.NANO, seed=0, device="cpu")
    params, _ = import_cvm({k: v.numpy().copy() for k, v in state.model.state_dict().items()})
    bf16 = TLOOP.create_train_state(TC.NANO, seed=0, device="cpu", param_dtype="bfloat16")
    return params, bf16


def test_create_train_state_masters_the_unrounded_params():
    params, state = _states()
    f32 = TLOOP.create_train_state(TC.NANO, seed=0, device="cpu").model
    assert isinstance(state.optimizer, TLOOP.F32MasterAdam)
    for (k, p), m, q in zip(state.model.named_parameters(), state.optimizer.master,
                            f32.parameters()):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32, k
        assert torch.equal(m, q.detach()), k
        assert torch.equal(p, q.detach().to(torch.bfloat16)), k
        if p.dim() == 4:
            assert p.is_contiguous(memory_format=torch.channels_last), k
    for k, v in state.model.named_buffers():
        if not k.endswith("num_batches_tracked"):
            assert v.dtype == torch.float32, k


def test_three_master_steps_against_with_f32_master():
    params, state = _states()
    opt = JLOOP.make_optimizer(1e-4, f32_master=True)
    jparams = jax.tree_util.tree_map(lambda p: jnp.asarray(p).astype(jnp.bfloat16), params)
    opt_state = opt.init(params)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    named = dict(state.model.named_parameters())
    rng = np.random.default_rng(3)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray((rng.standard_normal(p.shape) * 10.0 ** rng.integers(-6, 1)
                                   ).astype(np.float32)).astype(jnp.bfloat16), params)
        jparams, opt_state = update(grads, opt_state, jparams)
        for k, g in grads_from_jax(jax.tree_util.tree_map(
                lambda g: np.asarray(g.astype(jnp.float32)), grads)).items():
            named[k].grad = g.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last if g.dim() == 4 else torch.contiguous_format)
        state.optimizer.step()
    jmaster = state_dict_from_jax(opt_state.master, None)
    jresident = state_dict_from_jax(jax.tree_util.tree_map(
        lambda p: np.asarray(p.astype(jnp.float32)), jparams), None)
    masters = dict(zip((k for k, _ in state.model.named_parameters()), state.optimizer.master))
    moved = off = total = 0
    for k, want in jresident.items():
        if k not in named:
            continue
        m, p = masters[k], named[k].detach().float()
        torch.testing.assert_close(m, jmaster[k], rtol=1e-6, atol=1e-7, msg=k)
        differ = p != want
        # residents part only where the masters do; each lies within one
        # bfloat16 step of its own package's master
        assert not (differ & (m == jmaster[k])).any(), k
        for res, mas in ((p, m), (want, jmaster[k])):
            assert ((res - mas).abs() <= torch.maximum(res.abs(), mas.abs()) * 2.0 ** -7).all(), k
        off, total = off + int(differ.sum()), total + p.numel()
        moved += not torch.equal(m, m.to(torch.bfloat16).float())
    assert moved > 100 and off <= total * 1e-3, (moved, off, total)


def test_resident_rounding_against_apply_updates():
    """The same old resident ``p`` and new master ``m`` through both
    packages' optimizers at learning rate 0 (the master stays ``m``): the
    residents bit for bit, where ``bf16(p + (m - p))`` and ``bf16(m)`` part."""
    rng = np.random.default_rng(5)
    n = 1 << 14
    p = rng.uniform(5e-5, 3e-4, n) * rng.choice([-1.0, 1.0], n)
    # half the masters land within 1e-8 of zero, across it from p; the rest
    # move a little
    m = np.where(np.arange(n) < n // 2, -np.sign(p) * rng.uniform(0, 1e-8, n),
                 p * (1 + rng.normal(0, 1e-2, n))).astype(np.float32)
    pb = jnp.asarray(p, jnp.float32).astype(jnp.bfloat16)
    grad = jnp.asarray(rng.normal(size=n), jnp.float32).astype(jnp.bfloat16)

    opt = JLOOP.make_optimizer(0.0, f32_master=True)

    @jax.jit
    def update(g, opt_state, params):
        updates, opt_state = opt.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    jres, jstate = update(grad, opt.init(jnp.asarray(m)), pb)
    want = torch.from_numpy(np.asarray(jres.astype(jnp.float32)))
    assert torch.equal(torch.from_numpy(np.asarray(jstate.master)), torch.from_numpy(m))

    param = torch.nn.Parameter(torch.from_numpy(np.asarray(pb.astype(jnp.float32))).bfloat16())
    ours = TLOOP.F32MasterAdam([param], learning_rate=0.0)
    ours.master[0].copy_(torch.from_numpy(m))
    param.grad = torch.from_numpy(np.asarray(grad.astype(jnp.float32))).bfloat16()
    ours.step()
    assert torch.equal(ours.master[0], torch.from_numpy(m))
    assert torch.equal(param.detach().float(), want)
    parted = int((param.detach() != torch.from_numpy(m).bfloat16()).sum())
    assert parted > 50, parted


def test_master_state_round_trips():
    _, state = _states()
    named = list(state.model.parameters())
    gen = torch.Generator().manual_seed(4)
    for p in named:
        p.grad = torch.randn(p.shape, generator=gen).to(torch.bfloat16)
    named[-1].grad = None
    state.optimizer.step()
    saved = state.optimizer.state_dict()
    other = TLOOP.create_train_state(TC.NANO, seed=1, device="cpu", param_dtype="bfloat16")
    other.optimizer.load_state_dict(saved)
    for a, b in zip(other.optimizer.master, state.optimizer.master):
        assert torch.equal(a, b)
    for i, s in state.optimizer.inner.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(other.optimizer.inner.state_dict()["state"][i][k], v)
    with pytest.raises(ValueError):
        other.optimizer.load_state_dict({**saved, "master": saved["master"][:-1]})
