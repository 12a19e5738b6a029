"""ccvpe_torch.nn.layers against ccvpe_tpu.nn.layers on seeded inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ccvpe_tpu.nn import layers as JL
from ccvpe_torch.nn import layers as TL

torch.set_num_threads(2)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("hw", [(224, 224), (112, 112), (28, 28), (14, 14), (7, 7),
                                (154, 231), (11, 13)])
@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (5, 1), (5, 2), (1, 1)])
def test_same_pad_and_traced_hw(hw, kernel, stride):
    assert TL.same_pad(hw, kernel, stride) == JL.same_pad(hw, kernel, stride)
    assert TL.traced_output_hw(hw, stride) == JL.traced_output_hw(hw, stride)


@pytest.mark.parametrize("pad", [((0, 1), (0, 1)), ((1, 2), (1, 2)), ((2, 2), (0, 0)),
                                 ((0, 0), (3, 1))])
@pytest.mark.parametrize("circular", [False, True])
def test_pad2d(pad, circular):
    x = np.random.default_rng(0).standard_normal((2, 5, 7, 3)).astype(np.float32)
    want = JL.pad2d(jnp.asarray(x), pad, circular)
    got = TL.pad2d(_nchw(x), pad, circular)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


@pytest.mark.parametrize("spec", [
    JL.ConvSpec(6, 8, 3, 1, pad=((1, 1), (1, 1)), circular=True),
    JL.ConvSpec(6, 8, 3, 2, pad=((0, 1), (0, 1)), circular=True),      # B0 stem
    JL.ConvSpec(6, 8, 5, 2, pad=((1, 2), (1, 2))),
    JL.ConvSpec(8, 8, 5, 1, groups=8, pad=((2, 2), (2, 2)), circular=True),
    JL.ConvSpec(6, 4, 1, bias=True),
])
def test_static_pad_conv(spec):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 13, spec.cin)).astype(np.float32)
    w = rng.standard_normal((spec.kernel, spec.kernel, spec.cin // spec.groups,
                             spec.cout)).astype(np.float32)
    params = {"w": jnp.asarray(w)}
    conv = TL.StaticPadConv2d(TL.ConvSpec(*spec))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        if spec.bias:
            b = rng.standard_normal(spec.cout).astype(np.float32)
            params["b"] = jnp.asarray(b)
            conv.bias.copy_(torch.from_numpy(b))
        got = conv(_nchw(x))
    want = JL.conv_apply(params, jnp.asarray(x), spec)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_batch_norm_eval():
    rng = np.random.default_rng(2)
    c = 6
    x = rng.standard_normal((2, 4, 5, c)).astype(np.float32)
    p = {"scale": rng.standard_normal(c).astype(np.float32),
         "bias": rng.standard_normal(c).astype(np.float32)}
    s = {"mean": rng.standard_normal(c).astype(np.float32),
         "var": rng.uniform(0.1, 2.0, c).astype(np.float32)}
    want, _ = JL.bn_apply({k: jnp.asarray(v) for k, v in p.items()},
                          {k: jnp.asarray(v) for k, v in s.items()},
                          jnp.asarray(x), train=False)
    bn = TL.batch_norm(c).eval()
    assert bn.eps == 1e-3 and bn.momentum == 0.01
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
        got = bn(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_deconv2x2():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    w = rng.standard_normal((5, 2, 2, 7)).astype(np.float32)   # [I, 2, 2, O]
    b = rng.standard_normal(7).astype(np.float32)
    want = JL.deconv2x2_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    dc = TL.deconv2x2(5, 7)
    with torch.no_grad():
        dc.weight.copy_(torch.from_numpy(w.transpose(0, 3, 1, 2).copy()))
        dc.bias.copy_(torch.from_numpy(b))
        got = dc(_nchw(x))
    assert got.shape == (2, 7, 6, 8)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_l2_normalize_with_zero_row():
    x = np.random.default_rng(4).standard_normal((3, 4, 5, 6)).astype(np.float32)
    x[1, 2, 3] = 0.0
    want = JL.l2_normalize(jnp.asarray(x), axis=-1)
    got = TL.l2_normalize(torch.from_numpy(x), dim=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    assert not torch.isnan(got).any()


def test_silu():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(TL.silu(torch.from_numpy(x)).numpy(),
                               np.asarray(JL.silu(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


def test_init_uniform_is_seeded_and_bounded():
    def make(seed):
        m = torch.nn.Sequential(torch.nn.Conv2d(4, 6, 3), TL.deconv2x2(6, 2),
                                torch.nn.Linear(5, 3), TL.batch_norm(6))
        return TL.init_uniform_(m, torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
        if k.startswith(("0.", "1.", "2.")):
            assert not torch.equal(va, vc), k
    # torch-default bounds 1/sqrt(fan_in); a transposed conv's fan_in is cout*k*k
    assert a[0].weight.abs().max() <= 1 / np.sqrt(4 * 9)
    assert a[1].weight.abs().max() <= 1 / np.sqrt(2 * 4)
    assert torch.equal(a[3].weight, torch.ones(6)) and torch.equal(a[3].bias, torch.zeros(6))


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_drop_connect_from_shared_draws(rate):
    import jax

    x = np.random.default_rng(5).standard_normal((6, 3, 4, 5)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = JL.drop_connect(jnp.asarray(x), rate, key)
    # the uniform draws JL.drop_connect makes from this key
    u = np.array(jax.random.uniform(key, (6, 1, 1, 1), jnp.float32))
    got = TL.drop_connect(_nchw(x), rate, torch.from_numpy(u))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-6, rtol=1e-6)
    # each sample is kept whole (scaled by 1/keep) or dropped whole
    kept = (_nhwc(got) != 0).reshape(6, -1)
    assert (kept.all(1) | ~kept.any(1)).all()


def test_drop_connect_random_is_seeded():
    x = torch.ones(64, 2, 3, 3)
    a = TL.drop_connect_random(x, 0.5, torch.Generator().manual_seed(0))
    b = TL.drop_connect_random(x, 0.5, torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(a.unique().tolist()) == {0.0, 2.0}


@pytest.mark.parametrize("window", [2, 4, 64, 3])
def test_max_pool(window):
    x = np.random.default_rng(6).standard_normal((2, 128, 128, 5)).astype(np.float32)
    want = JL.max_pool(jnp.asarray(x), window)
    got = TL.max_pool(torch.from_numpy(x), window)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(4, 9, 7, 6), (1, 1, 3, 6)])
def test_batch_norm_train_channels_last(shape):
    """Batch statistics in, biased variance to normalise, unbiased variance
    (n = B*H*W) into the running variance, momentum 0.01."""
    rng = np.random.default_rng(7)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(c).astype(np.float32),
         "bias": rng.standard_normal(c).astype(np.float32)}
    s = {"mean": rng.standard_normal(c).astype(np.float32),
         "var": rng.uniform(0.1, 2.0, c).astype(np.float32)}
    want, new = JL.bn_apply({k: jnp.asarray(v) for k, v in p.items()},
                            {k: jnp.asarray(v) for k, v in s.items()},
                            jnp.asarray(x), train=True)
    bn = TL.batch_norm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    got = bn(xt)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new["mean"]),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new["var"]),
                               atol=1e-6, rtol=1e-5)
