"""The port's int8 post-training quantization (``ccvpe_torch.nn.quant``,
``nn.layers.QuantConv2d``, ``api.CVMModel.quantize_int8``) against
``ccvpe_tpu.nn.quant`` and ``ccvpe_tpu.nn.layers.conv_apply`` on the CPU.

* One int8 conv at each shape the models give it: the codes, the int32
  accumulators (both the ``torch._int_mm`` route of the card, which also
  runs on the CPU, and the plain float64 route) and the output (within 1
  ulp) against JAX's ``_conv_apply_int8`` on the same numpy inputs.
* Codes and scales from JAX's ``ranges`` bit-identical to JAX's; the port's
  own calibrated ranges within 1e-4 relative (the whole-model float32 bar of
  ``tests/test_torch_cvm.py``); ``quantized_fraction`` and the selection
  policies as JAX's.
* The whole NANO and TINY int8 model loaded from JAX's quantized tree:
  every int8 conv at the activations of JAX's int8 forward within 1 ulp of
  JAX's, and the whole forward against JAX's int8 forward within JAX's own
  int8-vs-float32 distance (the measured ratios and why the bar is not a
  quarter of it: ``INT8_BAR``).

Weights come from the port's seeded init with BatchNorm statistics
calibrated on one seeded batch (``tests/test_torch_cvm.py``), handed to JAX
through ``import_cvm``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccvpe_tpu.io.torch_import import import_cvm
from ccvpe_tpu.models import cvm as JC
from ccvpe_tpu.nn import layers as JL
from ccvpe_tpu.nn import quant as JQ
from ccvpe_torch import api as TA
from ccvpe_torch.io.from_jax import module_name_from_jax, quantized_from_jax
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.nn import layers as TL
from ccvpe_torch.nn import quant as TQ

torch.set_num_threads(2)

# name -> (port conv, JAX spec, input NHWC shape); the decoder's 3x3 is the
# symmetric Conv2d(padding=1), every other a StaticPadConv2d
_S2 = TL.same_pad((224, 224), 3, 2)
CONV_CASES = {
    "3x3_zero_pad": (lambda: TL.Conv2d(8, 16, 3, padding=1),
                     JL.ConvSpec(8, 16, 3, bias=True, pad=((1, 1), (1, 1))), (2, 6, 6, 8)),
    "3x3_circular_s1": (None, JL.ConvSpec(8, 16, 3, pad=((1, 1), (1, 1)), circular=True),
                        (2, 6, 10, 8)),
    "3x3_circular_s2": (None, JL.ConvSpec(8, 16, 3, 2, pad=_S2, circular=True), (2, 8, 12, 8)),
    "1x1": (None, JL.ConvSpec(24, 40, 1, circular=True), (2, 5, 7, 24)),
    "se_reduce_b1": (None, JL.ConvSpec(96, 4, 1, bias=True), (1, 1, 1, 96)),
    "se_expand_b8": (None, JL.ConvSpec(6, 144, 1, bias=True), (8, 1, 1, 6)),
    "stem_cin3": (None, JL.ConvSpec(3, 32, 3, 2, pad=_S2, circular=True), (2, 16, 32, 3)),
    "cout1": (lambda: TL.Conv2d(16, 1, 3, padding=1),
              JL.ConvSpec(16, 1, 3, bias=True, pad=((1, 1), (1, 1))), (2, 12, 12, 16)),
    "cout2": (lambda: TL.Conv2d(16, 2, 3, padding=1),
              JL.ConvSpec(16, 2, 3, bias=True, pad=((1, 1), (1, 1))), (2, 12, 12, 16)),
}


def _conv_pair(name, seed):
    """(port float conv, JAX params node, spec, x NHWC) from numpy draws."""
    make, spec, shape = CONV_CASES[name]
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((spec.kernel, spec.kernel, spec.cin, spec.cout)).astype(np.float32)
    node = {"w": w}
    conv = make() if make else TL.StaticPadConv2d(TL.ConvSpec(*spec))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        if spec.bias:
            node["b"] = rng.standard_normal(spec.cout).astype(np.float32)
            conv.bias.copy_(torch.from_numpy(node["b"]))
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    return conv, node, spec, x


def _jax_int8(node, x, spec):
    """JAX's codes, padded codes and int32 accumulators, as
    ``_conv_apply_int8`` computes them."""
    inv_sx = (1.0 / node["q_sx"]).astype(jnp.float32)
    xq = jnp.clip(jnp.round(jnp.asarray(x) * inv_sx), -127.0, 127.0).astype(jnp.int8)
    xqp = JL.pad2d(xq, spec.pad, spec.circular)
    acc = jax.lax.conv_general_dilated(
        xqp, node["w"], (spec.stride, spec.stride), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    return np.asarray(xq), np.asarray(xqp), np.asarray(acc)


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_int8_conv_matches_jax(name):
    conv, node, spec, x = _conv_pair(name, seed=sorted(CONV_CASES).index(name))
    # a calibrated range below the batch's max: the largest inputs clip at +-127
    absmax = 0.8 * float(np.abs(x).max())
    jnode = JQ._quantize_conv(node, absmax)
    q = TQ._quantize_conv(conv, absmax)
    assert isinstance(q, TL.QuantConv2d)
    np.testing.assert_array_equal(q.weight.numpy(), np.asarray(jnode["w"]).transpose(3, 2, 0, 1))
    assert q.q_sw.numpy().tobytes() == np.asarray(jnode["q_sw"]).tobytes()
    assert q.q_sx.numpy().tobytes() == np.asarray(jnode["q_sx"]).tobytes()

    xq, xqp, acc = _jax_int8(jnode, x, spec)
    assert np.abs(xq).max() == 127
    got_q = TL.quantize_activation(torch.from_numpy(x), q.inv_sx)
    np.testing.assert_array_equal(got_q.numpy(), xq)
    got_qp = TL.pad_nhwc(got_q, q.static_pad, q.circular)
    np.testing.assert_array_equal(got_qp.numpy(), xqp)
    mm = TL.int8_conv_mm(got_qp, q.w_mat, q.kernel, q.stride, spec.cout)
    plain = TL.int8_conv_plain(got_qp, q.weight, q.stride)
    assert mm.dtype == plain.dtype == torch.int32
    np.testing.assert_array_equal(mm.numpy(), acc)
    np.testing.assert_array_equal(plain.numpy(), acc)

    want = np.asarray(JL.conv_apply(jnode, jnp.asarray(x), spec))
    TL.reset_int8_counts()
    got = q(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert TL.int8_counts() == {"mm": 0, "plain": 1}
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    if spec.circular:   # the per-call override, as a cropped panorama takes it
        want = np.asarray(JL.conv_apply(jnode, jnp.asarray(x), spec._replace(circular=False)))
        got = q(torch.from_numpy(x).permute(0, 3, 1, 2), False).permute(0, 2, 3, 1)
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


def test_quantized_conv_refuses_grouped_convs():
    dw = TL.StaticPadConv2d(TL.ConvSpec(8, 8, 3, groups=8, pad=((1, 1), (1, 1))))
    with pytest.raises(ValueError, match="ungrouped"):
        TQ._quantize_conv(dw, 1.0)


def _inputs(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, *cfg.grd_hw, 3)).astype(np.float32),
            rng.standard_normal((batch, *cfg.sat_hw, 3)).astype(np.float32))


@functools.cache
def _setup(cfg_name):
    """The port's seeded float net with calibrated BN statistics, the same
    weights as a JAX tree, and JAX's calibrated ranges over one batch."""
    tcfg, jcfg = TC.PRESETS[cfg_name], JC.PRESETS[cfg_name]
    net = TC.CVM(tcfg).init_weights_(torch.Generator().manual_seed(7))
    grd, sat = _inputs(jcfg, 2, seed=100)
    TL.calibrate_batch_norm_(net, lambda: net(torch.from_numpy(grd), torch.from_numpy(sat)))
    params, state = import_cvm({k: v.numpy() for k, v in net.state_dict().items()})
    calib = _inputs(jcfg, 2, seed=101)

    def fwd(p, g, s):
        out, _ = JC.forward(jcfg, p, state, g, s, train=False)
        return out.logits_flattened

    ranges = JQ.calibrate(fwd, params, [tuple(map(jnp.asarray, calib))])
    return net, params, state, calib, ranges


def _float_copy(net):
    copy = TC.CVM(net.cfg).eval()
    copy.load_state_dict(net.state_dict(), strict=True)
    return copy


@pytest.mark.parametrize("cfg_name", ["NANO", "TINY"])
def test_calibrate_ranges_match_jax(cfg_name):
    net, _, _, calib, jranges = _setup(cfg_name)
    ranges = TQ.calibrate(net, [tuple(map(torch.from_numpy, calib))])
    want = {module_name_from_jax(k): v for k, v in jranges.items()}
    assert set(ranges) == set(want)
    # every conv JAX's conv_apply runs: both stems, the descriptor heads'
    # 1x1s, the decoders' double convs; no deconv, collapse or Linear
    assert "grd_efficientnet._conv_stem" in ranges and "conv6_ori.2" in ranges
    assert "grd_feature_to_descriptor6.0" in ranges
    assert not any(k.startswith("deconv") or k.endswith("descriptor1.2")
                   or k.startswith("sat_feature_to_descriptors") for k in ranges)
    for k, v in want.items():
        assert ranges[k] == pytest.approx(v, rel=1e-4), k


@pytest.mark.parametrize("select", ["all", "mxu", "mxu:120"])
def test_quantize_params_codes_scales_and_fraction_equal_jax(select):
    net, params, _, _, jranges = _setup("NANO")
    qparams = JQ.quantize_params(params, jranges, select=JQ.resolve_select(select))
    ranges = {module_name_from_jax(k): v for k, v in jranges.items()}
    qnet = TQ.quantize_params(_float_copy(net), ranges, select=TQ.resolve_select(select))
    assert TQ.quantized_fraction(qnet) == JQ.quantized_fraction(qparams)
    assert (TQ.quantized_fraction(qnet) > 0) == (select != "mxu")   # NANO is narrow
    # the JAX int8 nodes, under the port's names
    jnodes = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(qparams)[0]:
        keys = JQ._path_str(path)
        if keys.endswith("/q_sx"):
            node = functools.reduce(lambda n, p: n[int(p) if isinstance(n, list) else p],
                                    keys.split("/")[:-1], qparams)
            jnodes[module_name_from_jax(keys[:-len("/q_sx")])] = node
    mods = {n: m for n, m in qnet.named_modules() if isinstance(m, TL.QuantConv2d)}
    assert set(mods) == set(jnodes)
    for name, m in mods.items():
        node = jnodes[name]
        np.testing.assert_array_equal(m.weight.numpy(),
                                      np.asarray(node["w"]).transpose(3, 2, 0, 1), err_msg=name)
        assert m.q_sw.numpy().tobytes() == np.asarray(node["q_sw"]).tobytes(), name
        assert m.q_sx.numpy().tobytes() == np.asarray(node["q_sx"]).tobytes(), name
    # an int8 conv is left as it is
    again = TQ.quantize_params(qnet, ranges)
    assert all(again.get_submodule(n) is m for n, m in mods.items())


def test_resolve_select_errors_as_jax():
    for spec in ("mxu:abc", "nope"):
        with pytest.raises(ValueError) as want:
            JQ.resolve_select(spec)
        with pytest.raises(ValueError) as got:
            TQ.resolve_select(spec)
        assert str(got.value) == str(want.value)
    assert TQ.resolve_select("") is TQ.default_select
    dw = TL.StaticPadConv2d(TL.ConvSpec(8, 8, 3, groups=8))
    wide = TL.Conv2d(64, 64, 3)
    narrow = TL.StaticPadConv2d(TL.ConvSpec(16, 24, 1))
    for conv, w, want in ((dw, np.zeros((3, 3, 1, 8)), (False, False, False)),
                          (wide, np.zeros((3, 3, 64, 64)), (True, True, True)),
                          (narrow, np.zeros((1, 1, 16, 24)), (True, False, False))):
        for spec, expect in zip(("all", "mxu", "mxu:120"), want):
            assert TQ.resolve_select(spec)("c", conv) is expect
            assert JQ.resolve_select(spec)("c", {"w": w}) is expect


def _jax_int8_activations(jcfg, qparams, state, grd, sat, loc_offsets):
    """{port module name: (JAX params node, input)} of every conv of JAX's
    jitted int8 forward, from ``conv_apply``'s observer (as
    ``JQ.capture_conv_ranges`` keys convs: by their weight leaf)."""
    def inputs(p, g, s):
        paths = {id(leaf): JQ._path_str(path[:-1])
                 for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]}
        seen = {}
        JL._conv_observer = lambda node, x: seen.__setitem__(paths[id(node["w"])], x)
        try:
            JC.forward(jcfg, p, state, g, s, train=False, loc_offsets=loc_offsets)
        finally:
            JL._conv_observer = None
        return seen

    seen = jax.jit(inputs)(qparams, jnp.asarray(grd), jnp.asarray(sat))
    nodes = {JQ._path_str(path): node for path, node in
             jax.tree_util.tree_flatten_with_path(
                 qparams, is_leaf=lambda n: isinstance(n, dict) and "w" in n)[0]}
    return {module_name_from_jax(k): (nodes[k], np.asarray(x)) for k, x in seen.items()}


# The propagated bar.  A code that sits on a rounding tie within float32
# noise of the unquantized ops flips between two correct executions, and the
# random-weight networks amplify one flipped code through every later layer:
# JAX's own int8 TINY model, run jitted and run op by op, differs by 0.31
# (logits) and 0.87 (orientation) of its int8-vs-float32 distance (max abs,
# these inputs).  So the port's int8 model is held conv by conv, exactly, at
# the model's own activations, and as a whole to no more than JAX's own
# int8-vs-float32 distance.  Measured |port - JAX int8| / |JAX int8 - JAX
# f32|: NANO logits 0.26, orientation 0.29 (with the prior 0.23, 0.29);
# TINY 0.31, 0.87 (the same as JAX's jit-vs-op-by-op spread).
INT8_BAR = 1.0


@pytest.mark.parametrize("cfg_name,loc_offsets", [("NANO", None), ("NANO", (-1, 0, 1)),
                                                  ("TINY", None)])
def test_int8_model_from_jax_tree(cfg_name, loc_offsets):
    net, params, state, _, jranges = _setup(cfg_name)
    jcfg = JC.PRESETS[cfg_name]
    qparams = JQ.quantize_params(params, jranges)
    qnet = quantized_from_jax(TC.CVM(net.cfg).eval(), qparams, state)
    assert TQ.quantized_fraction(qnet) == JQ.quantized_fraction(qparams) > 0.5
    grd, sat = _inputs(jcfg, 2, seed=102)

    # every int8 conv of the model, fed JAX's int8 forward's own input: JAX's
    # output within 1 ulp
    seen = _jax_int8_activations(jcfg, qparams, state, grd, sat, loc_offsets)
    convs = TQ.observed_convs(qnet)
    assert set(seen) == {name for name, _ in convs}
    checked = 0
    for name, m in convs:
        node, x = seen[name]
        assert isinstance(m, TL.QuantConv2d) == ("q_sx" in node), name
        if "q_sx" not in node:
            continue
        o, i, k, _ = m.weight.shape
        spec = JL.ConvSpec(i, o, k, m.stride, 1, m.bias is not None, m.static_pad, m.circular)
        want = np.asarray(JL.conv_apply(node, jnp.asarray(x), spec))
        with torch.no_grad():
            got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
        checked += 1
    assert checked == sum(isinstance(m, TL.QuantConv2d) for m in qnet.modules())

    # the whole model against JAX's int8 forward
    fwd = jax.jit(lambda p, g, s: JC.forward(jcfg, p, state, g, s, train=False,
                                             loc_offsets=loc_offsets)[0])
    jf = fwd(params, jnp.asarray(grd), jnp.asarray(sat))
    jq = fwd(qparams, jnp.asarray(grd), jnp.asarray(sat))
    TL.reset_int8_counts()
    with torch.no_grad():
        out = qnet(torch.from_numpy(grd), torch.from_numpy(sat), loc_offsets=loc_offsets)
    assert TL.int8_counts() == {"mm": 0, "plain": checked}
    for name, got, q, f in (("logits", out.logits_flattened, jq.logits_flattened,
                             jf.logits_flattened),
                            ("ori", out.ori, jq.ori, jf.ori)):
        q, f = np.asarray(q, np.float64), np.asarray(f, np.float64)
        own = np.abs(q - f).max()
        assert own > 1e-3, (name, own)   # the int8 model differs from the float one
        err = np.abs(got.numpy().astype(np.float64) - q).max()
        assert err <= INT8_BAR * own, (name, err, own)


def test_api_quantize_int8_agrees_with_jax_and_refuses_twice(tmp_path):
    net, params, state, _, _ = _setup("NANO")
    rng = np.random.default_rng(103)
    calib = [(rng.integers(0, 256, (2, 64, 128, 3), dtype=np.uint8),
              rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8))]
    from ccvpe_tpu import api as JA

    jmodel = JA.CVMModel(JC.NANO, params, state).quantize_int8(calib, ori_noise=36.0)
    model = TA.CVMModel(TC.NANO, _float_copy(net), torch.device("cpu"))
    assert model.quantize_int8(calib, ori_noise=36.0) is model
    want = quantized_from_jax(TC.CVM(TC.NANO).eval(), jmodel.params, jmodel.bn_state)
    mods = {n: m for n, m in model.net.named_modules() if isinstance(m, TL.QuantConv2d)}
    wmods = {n: m for n, m in want.named_modules() if isinstance(m, TL.QuantConv2d)}
    assert set(mods) == set(wmods)
    for name, m in mods.items():   # weight codes depend on the weights alone
        torch.testing.assert_close(m.weight, wmods[name].weight, rtol=0, atol=0)
        torch.testing.assert_close(m.q_sw, wmods[name].q_sw, rtol=0, atol=0)
        torch.testing.assert_close(m.q_sx, wmods[name].q_sx, rtol=1e-4, atol=0)
    poses = model.predict_batch(*calib[0], ori_noise=36.0)
    assert all(0 <= p.probability <= 1 and np.isfinite(p.orientation_deg) for p in poses)
    with pytest.raises(ValueError, match="already int8-quantized"):
        model.quantize_int8(calib)
    with pytest.raises(ValueError, match="int8-quantized"):
        model.save_torch(str(tmp_path / "q.pt"))
    with pytest.raises(ValueError, match="unknown quant selection policy"):
        TA.CVMModel(TC.NANO, _float_copy(net), torch.device("cpu")).quantize_int8(select="x")


def test_default_calibration_batch_is_jaxs():
    """No ``calib``: JAX's seeded batch of two uniform-noise pairs, so the
    activation scales agree with JAX's default to the calibration bar."""
    net, params, state, _, _ = _setup("NANO")
    from ccvpe_tpu import api as JA

    jmodel = JA.CVMModel(JC.NANO, params, state).quantize_int8()
    model = TA.CVMModel(TC.NANO, _float_copy(net), torch.device("cpu")).quantize_int8()
    want = quantized_from_jax(TC.CVM(TC.NANO).eval(), jmodel.params, jmodel.bn_state)
    got = {n: m.q_sx.item() for n, m in model.net.named_modules()
           if isinstance(m, TL.QuantConv2d)}
    assert got and got.keys() == {n for n, m in want.named_modules()
                                  if isinstance(m, TL.QuantConv2d)}
    for name, v in got.items():
        assert v == pytest.approx(want.get_submodule(name).q_sx.item(), rel=1e-4), name
