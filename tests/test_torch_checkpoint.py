"""ccvpe_torch.io.checkpoint (full train state through torch.save), on the
CPU: a bit-identical round trip after two steps whose next step equals the
uninterrupted one; pruning past max_to_keep (0 keeps all); the sidecar's
step check; only rank 0 writes; a save cut short before its rename is not
a step; the sidecar never names a step whose state file is missing."""

import json
import os

import pytest
import torch

from ccvpe_torch.io import checkpoint as CK
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.ops import gt as TG
from ccvpe_torch.train import loop as TLOOP

torch.set_num_threads(2)


def _batch(cfg, b=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    gt, weights, omap = TG.synthesize_batch_factored(
        torch.rand(b, generator=g) * 40 - 20, torch.rand(b, generator=g) * 40 - 20,
        torch.rand(b, generator=g) * 360, height=cfg.sat_hw[0], width=cfg.sat_hw[1],
        bins=cfg.bins)
    return {"grd": torch.randn((b, *cfg.grd_hw, 3), generator=g),
            "sat": torch.randn((b, *cfg.sat_hw, 3), generator=g),
            "gt": gt, "bin_weights": weights, "orientation": omap}


def _state(seed=0):
    return TLOOP.create_train_state(TC.NANO, seed=seed, device="cpu")


def _assert_states_equal(a, b):
    assert a.step == b.step
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys() and sa["state"]
    for i, s in sa["state"].items():
        assert set(s) == {"step", "exp_avg", "exp_avg_sq"}
        for k, v in s.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


def test_round_trip_is_bit_identical_and_the_next_step_matches(tmp_path):
    step = TLOOP.make_train_step(TC.NANO)
    state = _state()
    for s in range(2):
        step(state, _batch(TC.NANO, seed=s))
    ckpt = CK.CheckpointManager(str(tmp_path))
    ckpt.save(2, state, meta={"epoch": 0, "completed": True})
    assert ckpt.latest_step() == 2 and ckpt.meta(2) == {"step": 2, "epoch": 0, "completed": True}

    restored = ckpt.restore(_state(seed=9))
    _assert_states_equal(restored, state)
    assert restored.step == 2 and restored.model.training
    for p in restored.model.parameters():
        if p.dim() == 4:
            assert p.is_contiguous(memory_format=torch.channels_last)
    for s in restored.optimizer.state.values():
        assert s["step"].device.type == "cpu"

    batch = _batch(TC.NANO, seed=2)
    want = step(state, batch)
    got = step(restored, batch)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _assert_states_equal(restored, state)


@pytest.mark.parametrize("keep,kept", [(2, [4, 5]), (0, [1, 2, 3, 4, 5]),
                                       (None, [1, 2, 3, 4, 5])])
def test_max_to_keep_prunes_the_oldest(tmp_path, keep, kept):
    state = _state()
    ckpt = CK.CheckpointManager(str(tmp_path), max_to_keep=keep)
    assert ckpt.latest_step() is None and ckpt.all_steps() == []
    for s in range(1, 6):
        state.step = s
        ckpt.save(s, state, meta={"epoch": s})
    assert ckpt.all_steps() == kept and ckpt.latest_step() == 5
    assert sorted(os.listdir(tmp_path)) == sorted([f"ckpt_{s}.pt" for s in kept]
                                                  + [CK.META])


def test_meta_of_another_step_is_empty(tmp_path):
    state = _state()
    ckpt = CK.CheckpointManager(str(tmp_path))
    ckpt.save(3, state, meta={"epoch": 1, "completed": False})
    ckpt.save(4, state)                    # no meta: the sidecar still names step 3
    assert ckpt.meta(3) == {"step": 3, "epoch": 1, "completed": False}
    assert ckpt.meta(4) == {}
    ckpt.save_meta(4, {"epoch": 1, "completed": True})
    assert ckpt.meta(3) == {} and ckpt.meta(4)["completed"] is True
    (tmp_path / CK.META).write_text("{not json")
    assert ckpt.meta(4) == {}


def test_only_rank_zero_writes(tmp_path, monkeypatch):
    state = _state()
    CK.CheckpointManager(str(tmp_path / "r0")).save(1, state, meta={"epoch": 0})  # no group: 0
    monkeypatch.setattr(CK, "_process_index", lambda: 1)
    r1 = CK.CheckpointManager(str(tmp_path / "r1"))
    r1.save(1, state, meta={"epoch": 0})
    r1.save_meta(1, {"epoch": 0})
    assert not (tmp_path / "r1").exists()
    # every rank reads what rank 0 wrote
    r1 = CK.CheckpointManager(str(tmp_path / "r0"))
    assert r1.latest_step() == 1 and r1.meta(1)["epoch"] == 0
    r1.save(2, state, meta={"epoch": 1})
    r1.save_meta(1, {"epoch": 5})
    assert r1.all_steps() == [1] and r1.meta(1)["epoch"] == 0


def test_a_save_cut_short_is_not_a_step(tmp_path, monkeypatch):
    state = _state()
    ckpt = CK.CheckpointManager(str(tmp_path))
    ckpt.save(1, state, meta={"epoch": 0, "completed": True})
    # a stray temporary file of an interrupted save
    (tmp_path / ".ckpt_7.pt.123.tmp").write_bytes(b"partial")
    assert ckpt.latest_step() == 1

    def dies(obj, path):
        with open(path, "wb") as f:
            f.write(b"half a checkpoint")
        raise KeyboardInterrupt

    monkeypatch.setattr(CK.torch, "save", dies)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save(2, state, meta={"epoch": 1, "completed": True})
    assert ckpt.latest_step() == 1 and ckpt.all_steps() == [1]
    assert json.loads((tmp_path / CK.META).read_text())["step"] == 1
    assert not (tmp_path / ".ckpt_2.pt.{}.tmp".format(os.getpid())).exists()


def test_the_sidecar_follows_its_state_file(tmp_path):
    ckpt = CK.CheckpointManager(str(tmp_path))
    ckpt.save(1, _state())
    with pytest.raises(FileNotFoundError, match="step 2"):
        ckpt.save_meta(2, {"epoch": 0, "completed": True})
    assert ckpt.meta(2) == {} and not (tmp_path / CK.META).exists()
    with pytest.raises(FileNotFoundError):
        CK.CheckpointManager(str(tmp_path / "empty")).restore(_state())
