"""The port's KITTI and Oxford RobotCar forwards at full width against
ccvpe_tpu.models.cvm.forward, on the CPU, in the style of
``tests/test_torch_cvm.py::test_vigor_full_width_parity``: seeded port
weights, BatchNorm statistics calibrated on one seeded batch and carried to
JAX by ``import_cvm``, batch 1, the same ``TOLS``.

Besides the outputs, each test holds the matching calls of both models to
each other: per scale, the bins, the ground descriptor's width Cg and the
satellite feature's width Cs (KITTI: a 2048-d descriptor, 16 bins, Cg < Cs
at every scale, scale-6 shift 8; Oxford: the 4x7 ground grid and the
centred window).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ccvpe_tpu.ops.matching as JM
from ccvpe_tpu.models import cvm as JC
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.ops import matching as TM
from tests.test_torch_cvm import _calibrated, _compare, _inputs

torch.set_num_threads(2)


def _record(monkeypatch, module, names, calls):
    """Wrap ``module.<name>`` so each call appends (Cs, Cg, bins)."""
    for name in names:
        fn = getattr(module, name)

        def wrapped(x, g, shift, offsets, window, _fn=fn):
            calls.append((int(x.shape[-1]), int(g.shape[-1]), len(tuple(offsets))))
            return _fn(x, g, shift, offsets, window)

        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("preset,loc_offsets", [
    ("KITTI", None),
    ("KITTI", (-2, -1, 0, 1, 2)),
    ("OxfordRobotCar", None),
])
def test_preset_full_width_parity(monkeypatch, preset, loc_offsets):
    cfg = TC.PRESETS[preset]
    jcfg = JC.PRESETS[preset]
    net = TC.CVM(cfg).init_weights_(torch.Generator().manual_seed(0)).eval()
    params, state = _calibrated(net, cfg, 1)
    grd, sat = _inputs(cfg, 1, seed=6)

    jcalls, tcalls = [], []
    # the JAX forward's einsum path: matching_scores (ori-prior bottleneck)
    # and matching_scores_with_norm (every stage), both looked up per call
    _record(monkeypatch, JC, ("matching_scores",), jcalls)
    _record(monkeypatch, JM, ("matching_scores_with_norm",), jcalls)
    _record(monkeypatch, TM, ("matching_scores", "matching_epilogue"), tcalls)
    jout, _ = jax.jit(lambda p, s, g, a: JC.forward(jcfg, p, s, g, a, train=False,
                                                    loc_offsets=loc_offsets))(
        params, state, jnp.asarray(grd), jnp.asarray(sat))
    with torch.no_grad():
        out = net(torch.from_numpy(grd), torch.from_numpy(sat), loc_offsets=loc_offsets)

    assert sorted(tcalls) == sorted(jcalls)
    bins = cfg.bins if loc_offsets is None else len(loc_offsets)
    loc = [c for c in jcalls if c[2] == bins]
    assert len(loc) == 6
    # in stage order: Cs is the satellite descriptor, then each loc conv's
    # output; Cg the ground descriptor of the scale
    assert [c[0] for c in loc] == [jcfg.sat_desc_dim, *jcfg.loc_conv_ch]
    assert [c[1] for c in loc] == list(jcfg.grd_desc_len)
    if preset == "KITTI":
        assert cfg.shifts[5] == 8 and cfg.loc_conv_ch[3] == 128
    else:
        assert cfg.window == "center" and cfg.grd_feat_hw == (4, 7)
    if loc_offsets is not None:
        assert (cfg.sat_desc_dim, cfg.grd_desc_len[0], cfg.bins) in jcalls
    assert out.matching_scores[0].shape[-1] == cfg.bins
    assert [s.shape[-1] for s in out.matching_scores[1:]] == [bins] * 5
    assert out.heatmap.shape == (1, *cfg.sat_hw, 1)
    # the calibrated backbones give scores that vary over the map
    assert out.matching_scores[0].flatten(1, 2).std(dim=1).min() > 1e-3
    _compare(out, jout)
