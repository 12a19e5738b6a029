"""bfloat16 compute in the port against the JAX package's, on the CPU: the
layers and a NANO forward here, a NANO train step in
``tests/test_torch_bf16_step.py`` (the bars are ``tests/torch_bf16_bar.py``).

The layers follow JAX's casts op by op (weights and biases cast to the
input's dtype at the op, BatchNorm's batch statistics from the bfloat16
activations folded into float32 running statistics).  Where one op's
rounding decides the result, the port equals JAX's eager bfloat16 result
bit for bit: the conv, the deconv and BatchNorm in eval mode.  The same
layer computed in float32 and rounded once at the end matches in about
half the elements (measured 0.51 for the conv, 0.54 for the deconv), so
these tests fail a layer that runs in float32.

BatchNorm in train mode and the model round in many places, and the
port's roundings fall elsewhere than XLA's (XLA fuses the elementwise ops
of a jitted function and keeps float32 between them; the port's convs sum
in another order), so the bar calibrates itself on JAX: how far JAX's own
bfloat16 result lies from its float32 result.

* ``assert_bar``: ||port_bf16 - jax_bf16||inf <= 1.5 ||jax_bf16 -
  jax_f32||inf.  Measured on NANO, batch 4, as a multiple of JAX's own
  distance: logits 0.83, orientation 1.18, score stacks 0.47-1.18; BN in
  train mode 0.78.  It cannot be 1: two bfloat16 computations that round
  in different places land as far from each other as each from float32.
* ``assert_rounds_in_bf16``: ||port_bf16 - jax_f32||inf >= 0.25
  ||jax_bf16 - jax_f32||inf, the check that the port rounds as a bfloat16
  computation does (measured 0.53-1.15 on the outputs above), and inside
  the model every conv, deconv, linear and BatchNorm layer returns
  bfloat16.
Float32 stays as it was: the layers are ``torch.nn``'s own, bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ccvpe_tpu.models import cvm as JC
from ccvpe_tpu.nn import layers as JL
from ccvpe_torch.nn import layers as TL
from tests.torch_bf16_bar import assert_bar, assert_rounds_in_bf16, f32
from tests.torch_train_parity import JAX_CONFIGS, setup

torch.set_num_threads(2)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_bf16_against_bn_apply(train):
    rng = np.random.default_rng(0)
    c = 6
    x = (rng.standard_normal((4, 9, 7, c)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.standard_normal(c).astype(np.float32)}
    s = {"mean": rng.standard_normal(c).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = {k: jnp.asarray(v) for k, v in s.items()}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, new = JL.bn_apply(jp, js, xb, train=train)
    ref, ref_new = JL.bn_apply(jp, js, xb.astype(jnp.float32), train=train)
    bn = TL.batch_norm(c).train(train)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
    got = bn(_nchw(f32(xb)).bfloat16())
    assert got.dtype == torch.bfloat16 and bn.running_mean.dtype == torch.float32
    if train:
        assert_bar("bn", got.permute(0, 2, 3, 1), want, ref)
        assert_rounds_in_bf16("bn", got.permute(0, 2, 3, 1), want, ref)
    else:
        np.testing.assert_array_equal(f32(got.permute(0, 2, 3, 1)), f32(want))
    for k, name in (("mean", "running_mean"), ("var", "running_var")):
        assert_bar(k, getattr(bn, name), new[k], ref_new[k])
    assert int(bn.num_batches_tracked) == int(train)


def test_conv_deconv_linear_take_the_input_dtype():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 6, 5)).astype(np.float32)
    spec = JL.ConvSpec(5, 7, 3, 1, bias=True, pad=JL.same_pad((224, 224), 3, 1))
    jparams = JL.conv_init(jax.random.PRNGKey(0), spec)
    conv = TL.StaticPadConv2d(TL.ConvSpec(5, 7, 3, 1, bias=True,
                                          pad=TL.same_pad((224, 224), 3, 1)))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.asarray(jparams["w"]).transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(np.asarray(jparams["b"])))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    got = conv(_nchw(f32(xb)).bfloat16())
    assert got.dtype == torch.bfloat16 and conv.weight.dtype == torch.float32
    # one rounding after the float32 accumulation, one after the bias: JAX's
    np.testing.assert_array_equal(f32(got.permute(0, 2, 3, 1)),
                                  f32(JL.conv_apply(jparams, xb, spec)))
    dparams = JL.deconv2x2_init(jax.random.PRNGKey(1), 5, 3)
    dc = TL.deconv2x2(5, 3)
    with torch.no_grad():
        dc.weight.copy_(torch.from_numpy(np.asarray(dparams["w"]).transpose(0, 3, 1, 2)))
        dc.bias.copy_(torch.from_numpy(np.asarray(dparams["b"])))
    got = dc(_nchw(f32(xb)).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(got.permute(0, 2, 3, 1)),
                                  f32(JL.deconv2x2_apply(dparams, xb)))
    lin = TL.Linear(5, 3)
    y = lin(torch.from_numpy(x).bfloat16())
    assert y.dtype == torch.bfloat16 and lin.weight.dtype == torch.float32


def test_float32_layers_are_torch_nn_bit_for_bit():
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(3, 4, 9, 7, generator=gen).contiguous(memory_format=torch.channels_last)
    pairs = [(TL.Conv2d(4, 6, 3, padding=1), torch.nn.Conv2d(4, 6, 3, padding=1)),
             (TL.ConvTranspose2d(4, 2, 2, stride=2), torch.nn.ConvTranspose2d(4, 2, 2, stride=2)),
             (TL.Linear(7, 5), torch.nn.Linear(7, 5))]
    for ours, theirs in pairs:
        theirs.load_state_dict(ours.state_dict())
        assert torch.equal(ours(x), theirs(x))
    for train in (True, False):
        ours, theirs = TL.batch_norm(4).train(train), torch.nn.BatchNorm2d(
            4, eps=TL.BN_EPS, momentum=TL.BN_MOMENTUM).train(train)
        with torch.no_grad():
            ours.weight.uniform_(0.5, 1.5, generator=gen)
            ours.running_var.uniform_(0.5, 1.5, generator=gen)
        theirs.load_state_dict(ours.state_dict())
        assert torch.equal(ours(x), theirs(x))
        for k, v in ours.state_dict().items():
            assert torch.equal(v, theirs.state_dict()[k]), k


def test_nano_bf16_forward_against_jax():
    state, jstate, batch = setup("NANO", 4)
    jcfg = JAX_CONFIGS["NANO"]

    def jax_forward(dtype):
        fn = jax.jit(lambda p, s, g, t: JC.forward(jcfg, p, s, g.astype(dtype), t.astype(dtype),
                                                   train=False)[0])
        return fn(jstate.params, jstate.bn_state, batch["grd"], batch["sat"])

    jf, jb = jax_forward(jnp.float32), jax_forward(jnp.bfloat16)
    state.model.eval()
    layers = (TL.Conv2d, TL.ConvTranspose2d, TL.Linear, TL.BatchNorm2d)
    dtypes = {}
    hooks = [m.register_forward_hook(lambda m, i, o, k=k: dtypes.setdefault(k, set()).add(o.dtype))
             for k, m in state.model.named_modules() if isinstance(m, layers)]
    with torch.no_grad():
        out = state.model(torch.from_numpy(batch["grd"]).bfloat16(),
                          torch.from_numpy(batch["sat"]).bfloat16())
    for h in hooks:
        h.remove()
    assert len(dtypes) > 100     # every layer the forward calls
    assert {k for k, d in dtypes.items() if d != {torch.bfloat16}} == set()
    assert out.logits_flattened.dtype == torch.bfloat16
    outputs = [("logits", out.logits_flattened, jb.logits_flattened, jf.logits_flattened),
               ("ori", out.ori, jb.ori, jf.ori)] + [
        (f"stack {s}", *abc) for s, abc in enumerate(zip(out.matching_scores,
                                                         jb.matching_scores, jf.matching_scores))]
    for name, a, b, c in outputs:
        assert_bar(name, a, b, c)
        assert_rounds_in_bf16(name, a, b, c)
