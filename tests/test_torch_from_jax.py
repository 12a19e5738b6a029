"""ccvpe_torch.io.from_jax.state_dict_from_jax against the JAX package's
exporter ``ccvpe_tpu.io.torch_import.export_cvm``: the same keys and the same
values, and a state_dict that the port loads with ``strict=True``.

The JAX trees come from the port's seeded init through ``import_cvm`` (with
random BN statistics), which is much faster on a CPU than ``cvm.init``."""

import numpy as np
import jax
import pytest
import torch

from ccvpe_tpu.io.torch_import import export_cvm, import_cvm, save_torch_checkpoint
from ccvpe_torch.io.from_jax import grads_from_jax, load_state_dict, state_dict_from_jax
from ccvpe_torch.models import cvm as TC

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["NANO", "TINY"])
def test_state_dict_from_jax_equals_export_cvm(name, tmp_path):
    src = TC.CVM(TC.PRESETS[name]).init_weights_(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    for k in sd:
        if k.endswith(("running_mean", "running_var")):
            sd[k] = rng.uniform(0.5, 1.5, sd[k].shape).astype(np.float32)
    params, state = import_cvm(sd)
    params = jax.tree_util.tree_map(np.array, params)
    state = jax.tree_util.tree_map(np.array, state)
    got = state_dict_from_jax(params, state)
    want = export_cvm(params, state)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == torch.from_numpy(np.array(v)).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), sd[k], err_msg=k)
    net = TC.CVM(TC.PRESETS[name])
    net.load_state_dict(got, strict=True)
    assert set(net.state_dict()) == set(got)

    path = tmp_path / "model.pt"
    save_torch_checkpoint(str(path), params, state)
    loaded = load_state_dict(path)
    assert list(loaded) == list(want)
    for k in want:
        torch.testing.assert_close(loaded[k], got[k], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["NANO", "TINY"])
def test_grads_from_jax_names_every_trained_parameter(name):
    """A tree shaped like ``params`` maps to the port's parameters without
    BN buffers and ``_fc``, with the layouts of ``state_dict_from_jax``."""
    net = TC.CVM(TC.PRESETS[name]).init_weights_(torch.Generator().manual_seed(3))
    params, state = import_cvm({k: v.numpy() for k, v in net.state_dict().items()})
    rng = np.random.default_rng(4)
    grads = jax.tree_util.tree_map(
        lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), params)
    got = grads_from_jax(grads)
    named = dict(net.named_parameters())
    assert set(got) == {k for k in named if "._fc." not in k}
    full = state_dict_from_jax(grads, state)
    for k, v in got.items():
        assert v.shape == named[k].shape, k
        torch.testing.assert_close(v, full[k], rtol=0, atol=0)
