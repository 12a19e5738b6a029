"""The port's CVM forward against ccvpe_tpu.models.cvm.forward: the same
weights and the same seeded inputs, eval mode, on the CPU.

NANO and TINY (Cg < Cs at every scale: the masked matching path) take their
weights from the JAX init through ``export_cvm``; the full-width VIGOR test
(Cg == Cs: the fused-epilogue path) takes them from the port's seeded init,
because JAX's own VIGOR init is slow on a CPU.  In both, the port's
BatchNorm statistics are then calibrated on one seeded batch and the whole
state goes back to JAX through ``import_cvm``: with identity statistics the
random backbones shrink their input to almost nothing, and the matching
would see little but biases (spatially constant scores).

Tolerances: at most the ceiling of tests/test_cvm_parity.py (logits atol
5e-3 / rtol 1e-2, heatmap atol 1e-6, ori and stacks 2e-3), and tighter
where the two implementations agree more closely (see ``TOLS``).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ccvpe_tpu.io.torch_import import export_cvm, import_cvm
from ccvpe_tpu.models import cvm as JC
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.nn.layers import calibrate_batch_norm_

torch.set_num_threads(2)

# name -> (logits, heatmap, ori, stacks) as (atol, rtol)
TOLS = {
    "logits": (1e-4, 1e-4),
    "heatmap": (1e-7, 1e-4),
    "ori": (1e-4, 1e-4),
    "stacks": (1e-5, 1e-4),
}


def _inputs(cfg, batch, seed, grd_w=None):
    rng = np.random.default_rng(seed)
    grd = rng.standard_normal((batch, cfg.grd_hw[0], grd_w or cfg.grd_hw[1], 3)).astype(np.float32)
    sat = rng.standard_normal((batch, *cfg.sat_hw, 3)).astype(np.float32)
    return grd, sat


def _calibrated(net, cfg, batch):
    """Calibrate the port's BN statistics on a seeded batch; return the
    JAX (params, state) of the result."""
    grd, sat = _inputs(cfg, batch, seed=100)
    calibrate_batch_norm_(net, lambda: net(torch.from_numpy(grd), torch.from_numpy(sat)))
    return import_cvm({k: v.numpy() for k, v in net.state_dict().items()})


@functools.cache
def _port_from_jax(cfg_name, seed=0):
    jcfg = JC.PRESETS[cfg_name]
    params, state = JC.init(jax.random.PRNGKey(seed), jcfg)
    net = TC.CVM(TC.PRESETS[cfg_name]).eval()
    net.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in export_cvm(params, state).items()}, strict=True)
    params, state = _calibrated(net, jcfg, 2)
    return jcfg, params, state, net


def _compare(out, jout, tols=TOLS):
    for name, got, want in (("logits", out.logits_flattened, jout.logits_flattened),
                            ("heatmap", out.heatmap, jout.heatmap),
                            ("ori", out.ori, jout.ori)):
        atol, rtol = tols[name]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol,
                                   err_msg=name)
    assert len(out.matching_scores) == len(jout.matching_scores) == 6
    atol, rtol = tols["stacks"]
    for k, (a, b) in enumerate(zip(out.matching_scores, jout.matching_scores)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, rtol=rtol,
                                   err_msg=f"stack {k + 1}")
    hm, jhm = out.heatmap.numpy()[..., 0], np.asarray(jout.heatmap)[..., 0]
    for i in range(hm.shape[0]):
        assert np.unravel_index(hm[i].argmax(), hm[i].shape) == \
            np.unravel_index(jhm[i].argmax(), jhm[i].shape)


@pytest.mark.parametrize("cfg_name", ["NANO", "TINY"])
@pytest.mark.parametrize("loc_offsets", [None, (-1, 0, 1)])
def test_forward_parity(cfg_name, loc_offsets):
    jcfg, params, state, net = _port_from_jax(cfg_name)
    grd, sat = _inputs(jcfg, 2, seed=1)
    jout, _ = jax.jit(lambda p, s, g, a: JC.forward(jcfg, p, s, g, a, train=False,
                                                    loc_offsets=loc_offsets))(
        params, state, jnp.asarray(grd), jnp.asarray(sat))
    with torch.no_grad():
        out = net(torch.from_numpy(grd), torch.from_numpy(sat), loc_offsets=loc_offsets)
    bins = jcfg.bins
    assert out.matching_scores[0].shape[-1] == bins
    assert out.matching_scores[1].shape[-1] == (bins if loc_offsets is None else 3)
    # the calibrated backbones give scores that vary over the map
    assert out.matching_scores[0].flatten(1, 2).std(dim=1).min() > 1e-3
    _compare(out, jout)


def test_fov_cropped_non_circular_parity():
    """Limited field of view: half the panorama, circular padding off."""
    import dataclasses

    jcfg, params, state, net = _port_from_jax("NANO")
    grd, sat = _inputs(jcfg, 1, seed=3, grd_w=jcfg.grd_hw[1] // 2)
    ncfg = dataclasses.replace(jcfg, circular=False)
    jout, _ = JC.forward(ncfg, params, state, jnp.asarray(grd), jnp.asarray(sat),
                         train=False, loc_offsets=(-2, -1, 0, 1, 2))
    with torch.no_grad():
        out = net(torch.from_numpy(grd), torch.from_numpy(sat),
                  loc_offsets=range(-2, 3), circular=False)
        g = torch.from_numpy(grd).permute(0, 3, 1, 2)
        wrapped, _ = net.grd_efficientnet(g)
        zero_padded, _ = net.grd_efficientnet(g, circular=False)
    _compare(out, jout)
    # the override reaches the ground encoder: wrap padding changes its output
    assert net.grd_efficientnet.circular
    assert not torch.allclose(wrapped, zero_padded)


def test_plain_matching_impl_equals_kernel_dispatch_on_cpu():
    _, _, _, net = _port_from_jax("NANO")
    grd, sat = _inputs(JC.NANO, 1, seed=4)
    with torch.no_grad():
        a = net(torch.from_numpy(grd), torch.from_numpy(sat))
        b = net(torch.from_numpy(grd), torch.from_numpy(sat), matching_impl="plain")
    torch.testing.assert_close(a.logits_flattened, b.logits_flattened, rtol=0, atol=0)
    with pytest.raises(ValueError):
        net(torch.from_numpy(grd), torch.from_numpy(sat), matching_impl="einsum")


def test_decoder_widths_and_presets_match_jax():
    for name, jcfg in JC.PRESETS.items():
        tcfg = TC.PRESETS[name]
        assert {f: getattr(tcfg, f) for f in tcfg.__dataclass_fields__} == \
            {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
        for branch in ("loc", "ori"):
            assert TC._decoder_widths(tcfg, branch) == JC._decoder_widths(jcfg, branch)


def test_vigor_full_width_parity():
    """Full VIGOR preset (320x640 panorama, 512x512 aerial, B0, 1280-d sat
    descriptor, 20 bins) at batch 1."""
    cfg = TC.VIGOR
    net = TC.CVM(cfg).init_weights_(torch.Generator().manual_seed(0)).eval()
    params, state = _calibrated(net, cfg, 1)
    grd, sat = _inputs(cfg, 1, seed=5)
    jout, _ = jax.jit(lambda p, s, g, a: JC.forward(JC.VIGOR, p, s, g, a, train=False))(
        params, state, jnp.asarray(grd), jnp.asarray(sat))
    with torch.no_grad():
        out = net(torch.from_numpy(grd), torch.from_numpy(sat))
    assert out.heatmap.shape == (1, 512, 512, 1) and out.ori.shape == (1, 512, 512, 2)
    assert [s.shape[1:] for s in out.matching_scores] == \
        [(8 * 2 ** k, 8 * 2 ** k, 20) for k in range(6)]
    _compare(out, jout)
