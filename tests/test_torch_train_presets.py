"""One train step of the port against ``ccvpe_tpu.train.loop.make_train_step``
on the CPU for KITTI- and Oxford-shaped configurations, the steps the port's
``train_KITTI`` and ``train_OxfordRobotCar`` CLIs take: NANO's widths (through
``dataclasses.replace`` in both packages) with KITTI's 16 bins, first window
and no circular padding, and Oxford's 20 bins, centred window and no
circular padding; the shifts are Cs // bins at each of NANO's scales.  Both
mix the masked-window scores (Cg < Cs) and the fused epilogue (Cg == Cs).
Set-up and tolerances as ``tests/test_torch_train.py``
(``tests/torch_train_parity.py``): loss parts rtol 1e-5, each gradient
1e-3 ||g|| + 1e-6 grad_norm, BN statistics 1e-5; drop-connect off."""

import dataclasses

import pytest
import torch

from ccvpe_tpu.models import cvm as JC
from ccvpe_torch.models import cvm as TC
from tests.torch_train_parity import register, run_both

torch.set_num_threads(2)

SHAPES = {"KITTI": dict(bins=16, window="first", circular=False),
          "OxfordRobotCar": dict(bins=20, window="center", circular=False)}


def _scale_widths(cfg):
    """Cs of each matching scale: the aerial descriptor, then the stages'."""
    return (cfg.sat_desc_dim, *cfg.loc_conv_ch)


@pytest.mark.parametrize("preset", list(SHAPES))
def test_one_step_matches_jax(preset):
    kw = dict(SHAPES[preset], name=f"NANO_{preset}")
    kw["shifts"] = tuple(max(1, cs // kw["bins"]) for cs in _scale_widths(TC.NANO))
    tcfg, jcfg = dataclasses.replace(TC.NANO, **kw), dataclasses.replace(JC.NANO, **kw)
    ref = TC.PRESETS[preset]
    assert (tcfg.bins, tcfg.window, tcfg.circular) == (ref.bins, ref.window, ref.circular)
    # both matching paths: Cg == Cs (fused epilogue) and Cg < Cs (masked window)
    pairs = list(zip(tcfg.grd_desc_len, _scale_widths(tcfg)))
    assert any(cg == cs for cg, cs in pairs) and any(cg < cs for cg, cs in pairs)
    register(kw["name"], tcfg, jcfg)
    state, _, _ = run_both(kw["name"], 2, "einsum")
    assert state.step == 1
