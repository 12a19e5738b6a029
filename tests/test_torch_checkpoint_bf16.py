"""Checkpoints of the training options and ``api.load_model`` from a
checkpoint directory, on the CPU (NANO, plain matching).

* A state with bfloat16 parameters and the float32 master round-trips bit
  for bit: the bfloat16 parameters, the float32 BN statistics, the master,
  both Adam moments and the step; the next step from the restored state
  equals the next step from the live one, bit for bit.
* A file of bfloat16 parameters does not restore into a float32 model.
* ``api.load_model(<directory>)`` of a float32 and of a bfloat16-parameter
  checkpoint gives the live model's poses (bfloat16 parameters read into
  float32 exactly, as the JAX model casts them to its float32 inputs).
"""

import copy

import numpy as np
import pytest
import torch

from ccvpe_torch import api
from ccvpe_torch.io.checkpoint import CheckpointManager
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.nn.layers import calibrate_batch_norm_
from ccvpe_torch.train import loop as TLOOP
from tests.torch_train_parity import make_batch, torch_batch

torch.set_num_threads(2)


def _state(param_dtype, seed=0):
    state = TLOOP.create_train_state(TC.NANO, seed=seed, device="cpu", param_dtype=param_dtype)
    calib = make_batch(TC.NANO, 2, seed + 2)
    calibrate_batch_norm_(state.model, lambda: state.model(torch.from_numpy(calib["grd"]),
                                                           torch.from_numpy(calib["sat"])))
    state.model.train()
    return state


def _stepped(param_dtype, compute_dtype="bfloat16", steps=2):
    state = _state(param_dtype)
    step = TLOOP.make_train_step(TC.NANO, compute_dtype=compute_dtype, remat="all")
    batch = torch_batch(make_batch(TC.NANO, 2, 5))
    for _ in range(steps):
        step(state, batch)
    return state, step, batch


def _assert_equal_states(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k, v in sa.items():
        assert v.dtype == sb[k].dtype and torch.equal(v, sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa.keys() == ob.keys() and oa["state"].keys() == ob["state"].keys()
    for i, s in oa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    for x, y in zip(oa.get("master", []), ob.get("master", []), strict=True):
        assert x.dtype == torch.float32 and torch.equal(x, y)
    assert a.step == b.step


def test_bf16_param_state_round_trips_bit_for_bit(tmp_path):
    state, step, batch = _stepped("bfloat16")
    assert next(state.model.parameters()).dtype == torch.bfloat16
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state.step, state, meta={"epoch": 0, "completed": True})
    restored = mgr.restore(_state("bfloat16", seed=3))
    _assert_equal_states(restored, state)
    assert len(restored.optimizer.state_dict()["master"]) == len(list(state.model.parameters()))
    assert all(p.is_contiguous(memory_format=torch.channels_last)
               for p in restored.model.parameters() if p.dim() == 4)
    # the resumed run goes on as the live one
    live, again = step(state, batch), step(restored, batch)
    for k in live:
        assert torch.equal(live[k], again[k]), k
    _assert_equal_states(restored, state)


def test_bf16_params_do_not_restore_into_float32(tmp_path):
    state, _, _ = _stepped("bfloat16", steps=1)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state.step, state)
    with pytest.raises(ValueError, match="--bf16_params"):
        mgr.restore(_state(None))


@pytest.mark.parametrize("param_dtype", [None, "bfloat16"])
def test_load_model_from_a_checkpoint_directory(param_dtype, tmp_path):
    state, _, _ = _stepped(param_dtype, compute_dtype="float32")
    CheckpointManager(str(tmp_path / "ck")).save(state.step, state)
    model = api.load_model(str(tmp_path / "ck"), preset="NANO", device="cpu",
                           matching_impl="plain")
    assert model.matching_impl == "plain" and not model.net.training
    assert all(p.dtype == torch.float32 for p in model.net.parameters())
    live = api.CVMModel(TC.NANO, copy.deepcopy(state.model).eval(), torch.device("cpu"),
                        matching_impl="plain")
    rng = np.random.default_rng(7)
    grd = rng.integers(0, 256, (3, *TC.NANO.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 256, (3, *TC.NANO.sat_hw, 3), dtype=np.uint8)
    for kw in (dict(ori_noise=180.0), dict(ori_noise=36.0), dict(fov=180.0)):
        want = live.predict_batch(grd, sat, return_heatmap=True, **kw)
        got = model.predict_batch(grd, sat, return_heatmap=True, **kw)
        for p, q in zip(got, want):
            assert (p.row, p.col) == (q.row, q.col), kw
            assert p.probability == q.probability and p.orientation_deg == q.orientation_deg
            np.testing.assert_array_equal(p.heatmap, q.heatmap)


def test_load_model_rejects_what_it_cannot_read(tmp_path):
    with pytest.raises(FileNotFoundError):
        api.load_model(str(tmp_path), preset="NANO", device="cpu")
    with pytest.raises(ValueError, match="checkpoint directory"):
        api.load_model(str(tmp_path / "absent"), preset="NANO", device="cpu")
    state = _state(None)
    CheckpointManager(str(tmp_path / "ck")).save(0, state)
    with pytest.raises(ValueError, match="preset 'TINY'"):
        api.load_model(str(tmp_path / "ck"), preset="TINY", device="cpu")


def test_reference_pt_of_a_bf16_model_is_float32(tmp_path):
    """``CVMModel.save_torch`` of bfloat16 parameters writes the reference
    format's float32, exactly, which the JAX package reads."""
    from ccvpe_tpu.io.torch_import import load_state_dict as jax_load

    state, _, _ = _stepped("bfloat16", steps=1)
    path = str(tmp_path / "m.pt")
    api.CVMModel(TC.NANO, state.model, torch.device("cpu")).save_torch(path)
    saved = torch.load(path, weights_only=True)
    for k, v in state.model.state_dict().items():
        assert saved[k].dtype == (torch.float32 if v.is_floating_point() else v.dtype), k
        assert torch.equal(saved[k], v.float() if v.is_floating_point() else v), k
    assert jax_load(path)["deconv1.weight"].dtype == np.float32
