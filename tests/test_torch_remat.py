"""Rematerialisation in the port (``remat=True|'all'|'encoder'|'decoder'``)
on the CPU.

A remat step recomputes its activations in the backward, so it must equal
the step without remat: loss parts and gradients at 1e-6, with drop-connect
on.  Two traps that JAX's functional ``jax.checkpoint`` does not have:
``nn.BatchNorm2d`` folds its batch statistics into the running ones in
place, so a recompute would apply the momentum twice (the buffers must end
equal); and drop-connect draws from the caller's ``torch.Generator``,
which ``preserve_rng_state`` does not cover, so a recompute would draw a
new mask (the gradients and the generator's end state must be equal).
TINY's remat step against JAX's is ``tests/test_torch_remat_tiny.py``.
"""

import copy

import numpy as np
import pytest
import torch

from ccvpe_tpu.models import cvm as JC
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.ops import matching as TM
from ccvpe_torch.ops import matching_cuda as MC
from ccvpe_torch.train import loop as TLOOP
from tests.torch_train_parity import setup, torch_batch

torch.set_num_threads(2)

# TINY: B0 backbones (drop-connect on nine identity-skip blocks of each) and
# the VIGOR decoder at a small spatial extent
CFG = "TINY"


def _step_pair(remat, seed=0):
    """The same TINY state stepped without remat and with ``remat``, both
    with drop-connect from generators of one seed."""
    base, _, batch = setup(CFG, 2, seed)
    other = copy.deepcopy(base)
    gens = [torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)]
    parts = [TLOOP.make_train_step(TC.PRESETS[CFG], remat=r)(s, torch_batch(batch), g)
             for r, s, g in ((False, base, gens[0]), (remat, other, gens[1]))]
    return (base, other), parts, gens


def _assert_same_step(states, parts, gens):
    (a, b), (pa, pb) = states, parts
    for k in pa:
        np.testing.assert_allclose(pb[k].item(), pa[k].item(), rtol=1e-6, err_msg=k)
    named = dict(b.model.named_parameters())
    n = 0
    for k, p in a.model.named_parameters():
        if p.grad is None:
            assert named[k].grad is None, k
            continue
        torch.testing.assert_close(named[k].grad, p.grad, rtol=1e-6, atol=1e-6 * (
            1 + p.grad.abs().max().item()), msg=k)
        n += 1
    assert n > 100
    bufs = dict(b.model.named_buffers())
    for k, v in a.model.named_buffers():
        assert torch.equal(bufs[k], v), k
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.mark.parametrize("remat", [True, "all", "encoder", "decoder"])
def test_remat_step_equals_the_plain_step_with_drop_connect(remat):
    states, parts, gens = _step_pair(remat)
    _assert_same_step(states, parts, gens)
    # drop-connect was on: the generator advanced
    assert not torch.equal(gens[0].get_state(), torch.Generator().manual_seed(11).get_state())


def test_remat_through_the_kernels_autograd_functions(monkeypatch):
    """The kernels' ``autograd.Function``s (their launches routed to the
    plain versions, as on a card) under remat 'all': the matching's backward
    nodes run between recomputed stages."""
    launches = []

    def plain_launch(plain, name):
        def launch(x, g, shift, offsets, window, layout=None):
            launches.append(name)
            return plain(x, g, shift, offsets, window)
        return launch

    monkeypatch.setattr(MC, "launch_matching_epilogue",
                        plain_launch(TM.matching_epilogue_plain, "K1"))
    monkeypatch.setattr(MC, "launch_matching_scores",
                        plain_launch(TM.matching_scores_plain, "K2"))
    monkeypatch.setattr(TM, "matching_epilogue", MC._EpilogueFn.apply)
    monkeypatch.setattr(TM, "matching_scores", MC._ScoresFn.apply)
    states, parts, gens = _step_pair("all", seed=1)
    # TINY's ground descriptors are narrower than the aerial maps (a 4-wide
    # ground grid): K2 at all six scales, in the BN calibration and each step
    assert launches == ["K2"] * 18
    _assert_same_step(states, parts, gens)


def test_misspelt_scope_raises_in_both_packages():
    with pytest.raises(ValueError, match="remat must be"):
        TLOOP.make_train_step(TC.NANO, remat="encoders")
    state, jstate, batch = setup("NANO", 2)
    with pytest.raises(ValueError, match="remat must be"):
        state.model(torch.from_numpy(batch["grd"]), torch.from_numpy(batch["sat"]),
                    remat="decoders")
    with pytest.raises(ValueError, match="remat must be"):
        JC.forward(JC.NANO, jstate.params, jstate.bn_state, batch["grd"], batch["sat"],
                   remat="decoders")
