"""ccvpe_torch.nn.efficientnet against ccvpe_tpu.nn.efficientnet.b0_apply:
the same weights (JAX init -> export_b0 -> load_state_dict(strict=True)) and
the same seeded inputs, eval mode."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ccvpe_tpu.io.torch_import import export_b0
from ccvpe_tpu.nn import efficientnet as JE
from ccvpe_torch.nn import efficientnet as TE

torch.set_num_threads(2)


def _random_bn_state(state, rng):
    """Non-trivial running statistics, so BN is exercised in eval mode."""
    def walk(node):
        if isinstance(node, dict) and set(node) == {"mean", "var"}:
            c = node["mean"].shape[0]
            return {"mean": jnp.asarray(rng.standard_normal(c) * 0.1, jnp.float32),
                    "var": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)}
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node
    return walk(state)


@pytest.mark.parametrize("name", ["b0", "nano"])
@pytest.mark.parametrize("circular", [False, True])
def test_backbone_config_matches_jax(name, circular):
    assert tuple(TE.backbone_config(name, circular)) == tuple(JE.backbone_config(name, circular))


@pytest.mark.parametrize("name,hw", [("nano", (64, 128)), ("b0", (64, 128)),
                                     ("b0", (154, 231))])
@pytest.mark.parametrize("circular", [False, True])
def test_backbone_forward_parity(name, hw, circular):
    cfg = JE.backbone_config(name, circular)
    params, state = JE.b0_init(jax.random.PRNGKey(3), cfg)
    state = _random_bn_state(state, np.random.default_rng(5))
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in export_b0(params, state).items()}
    net = TE.EfficientNet(name, circular).eval()
    net.load_state_dict(sd, strict=True)

    x = np.random.default_rng(7).standard_normal((2, *hw, 3)).astype(np.float32)
    feat, ms, _ = jax.jit(lambda p, s, v: JE.b0_apply(cfg, p, s, v, train=False))(
        params, state, jnp.asarray(x))
    with torch.no_grad():
        tfeat, tms = net(torch.from_numpy(x).permute(0, 3, 1, 2)
                         .contiguous(memory_format=torch.channels_last))

    np.testing.assert_allclose(tfeat.permute(0, 2, 3, 1).numpy(), np.asarray(feat),
                               atol=2e-4, rtol=1e-3)
    assert len(tms) == len(ms) == len(cfg.blocks)
    for i, (a, b) in enumerate(zip(tms, ms)):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(b),
                                   atol=2e-4, rtol=1e-3, err_msg=f"block {i}")


def _running_stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("name", ["nano", "b0"])
@pytest.mark.parametrize("circular", [False, True])
def test_backbone_train_mode_parity(name, circular):
    """``b0_apply(train=True, rng=None)`` (batch statistics, no drop-connect)
    against the port in train mode without a generator: outputs and the
    new running statistics."""
    cfg = JE.backbone_config(name, circular)
    params, state = JE.b0_init(jax.random.PRNGKey(4), cfg)
    state = _random_bn_state(state, np.random.default_rng(6))
    net = TE.EfficientNet(name, circular).train()
    net.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in export_b0(params, state).items()}, strict=True)

    x = np.random.default_rng(8).standard_normal((3, 64, 128, 3)).astype(np.float32)
    feat, ms, new_state = jax.jit(lambda p, s, v: JE.b0_apply(cfg, p, s, v, train=True))(
        params, state, jnp.asarray(x))
    with torch.no_grad():
        tfeat, tms = net(torch.from_numpy(x).permute(0, 3, 1, 2)
                         .contiguous(memory_format=torch.channels_last))
    np.testing.assert_allclose(tfeat.permute(0, 2, 3, 1).numpy(), np.asarray(feat),
                               atol=2e-4, rtol=1e-3)
    for i, (a, b) in enumerate(zip(tms, ms)):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(b),
                                   atol=2e-4, rtol=1e-3, err_msg=f"block {i}")
    want = _running_stats(export_b0(params, new_state))
    got = _running_stats(net.state_dict())
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_drop_connect_only_in_train_mode_with_a_generator():
    net = TE.EfficientNet("b0")
    x = torch.randn(4, 3, 64, 64, generator=torch.Generator().manual_seed(0))

    def run(train, seed):
        net.train(train)
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return net(x, generator=gen)[0]

    torch.testing.assert_close(run(False, 1), run(False, None), rtol=0, atol=0)
    torch.testing.assert_close(run(True, 1), run(True, 1), rtol=0, atol=0)
    assert not torch.allclose(run(True, 1), run(True, None))
    # only the identity-skip blocks past the first drop, at 0.2 * i / n
    assert [b.id_skip for b in net._blocks].count(True) == 9
    assert TE.DROP_CONNECT_RATE == JE.DROP_CONNECT_RATE
