"""The port's three train CLIs on the CPU (NANO, one epoch of one or two
steps, seeded synthetic roots): results files in the reference's format,
checkpoints with their sidecar, ``--resume`` at the next epoch; and the
VIGOR train CLI's results files against the JAX CLI's from the same
``.pt`` (``--init_model_path``): the same lines, the ``%4f`` values within
1e-4.  Drop-connect draws cannot be matched across the two packages, so
that comparison runs with drop-connect off on both sides."""

import json
import os

import numpy as np
import pytest
import torch

from ccvpe_torch import train_KITTI as PK
from ccvpe_torch import train_OxfordRobotCar as PO
from ccvpe_torch import train_VIGOR as PV
from ccvpe_torch.io.checkpoint import CheckpointManager
from tests.torch_data_roots import kitti_root, oxford_root, vigor_root  # noqa: F401
from tests.torch_data_roots import write_nano_pt

torch.set_num_threads(2)
COMMON = ["--model_preset", "NANO", "-b", "2", "--num_workers", "2"]
STEMS = ("mean_distance_error", "median_distance_error", "mean_orientation_error",
         "median_orientation_error")


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("CCVPE_PLATFORM", "cpu")


def _results(res_dir, prefix, epochs):
    """The results files ``{prefix}{stem}.txt``: a header and a '%4f' line
    per epoch; ``{prefix}summary.json``: a JSON line per epoch."""
    for stem in STEMS:
        lines = (res_dir / f"{prefix}{stem}.txt").read_text().splitlines()
        assert lines[0::2] == [f"{e}_{prefix}{stem}:" for e in epochs]
        assert all(np.isfinite(float(v)) for v in lines[1::2])
    rows = [json.loads(x) for x in (res_dir / f"{prefix}summary.json").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == list(epochs)
    return rows


def test_vigor_train_checkpoint_and_resume(vigor_root, tmp_path, capsys):
    argv = COMMON + ["--dataset_root", vigor_root, "--steps_per_epoch", "2",
                     "--checkpoint_dir", str(tmp_path / "ckpt"),
                     "--results_dir", str(tmp_path / "res"), "--keep_checkpoints", "1"]
    assert PV.main(argv + ["--epochs", "1"]) is None
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.all_steps() == [2] and ckpt.meta(2) == {"step": 2, "epoch": 0, "completed": True}
    PV.main(argv + ["--epochs", "2", "--resume"])
    out = capsys.readouterr().out
    assert "resuming at epoch 1" in out and "Finished Training" in out
    assert ckpt.all_steps() == [4] and ckpt.meta(4)["epoch"] == 1
    rows = _results(tmp_path / "res", "samearea_HFoV360_", [0, 1])
    assert all(r["pairs_per_sec"] > 0 for r in rows)


def test_kitti_train_with_device_augment(kitti_root, tmp_path):
    PK.main(COMMON + ["--dataset_root", kitti_root, "--epochs", "1", "--steps_per_epoch", "2",
                      "--device_augment", "--rotation_range", "10",
                      "--checkpoint_dir", str(tmp_path / "ckpt"),
                      "--results_dir", str(tmp_path / "res")])
    for split in ("test1_", "test2_"):
        _results(tmp_path / "res", f"KITTI_rotation_range10.0_{split}", [0])
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 2


def test_oxford_train_and_resume(oxford_root, tmp_path):
    argv = COMMON + ["--grd_image_root", oxford_root, "--steps_per_epoch", "1",
                     "--checkpoint_dir", str(tmp_path / "ckpt"),
                     "--results_dir", str(tmp_path / "res")]
    PO.main(argv + ["--epochs", "1"])
    PO.main(argv + ["--epochs", "2", "--resume"])
    _results(tmp_path / "res", "OxfordRobotCar_", [0, 1])
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [1, 2]


def test_vigor_train_results_files_match_jax(vigor_root, tmp_path, monkeypatch):
    import train_VIGOR as JV

    import ccvpe_tpu.nn.efficientnet as JE
    import ccvpe_torch.nn.efficientnet as TE

    monkeypatch.setattr(JE, "drop_connect", lambda x, rate, rng: x)
    monkeypatch.setattr(TE, "drop_connect_random", lambda x, rate, generator: x)
    init = write_nano_pt(str(tmp_path / "init.pt"), seed=21)
    argv = ["--dataset_root", vigor_root, "--model_preset", "NANO", "-b", "4",
            "--num_workers", "2", "--steps_per_epoch", "1", "--epochs", "1",
            "--init_model_path", init]
    JV.main(argv + ["--checkpoint_dir", str(tmp_path / "jck"), "--results_dir",
                    str(tmp_path / "jax"), "--matching_impl", "einsum"])
    PV.main(argv + ["--checkpoint_dir", str(tmp_path / "tck"), "--results_dir",
                    str(tmp_path / "torch"), "--matching_impl", "plain"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch"))
    assert len(names) == 5
    for name in names:
        want = (tmp_path / "jax" / name).read_text().splitlines()
        got = (tmp_path / "torch" / name).read_text().splitlines()
        assert len(got) == len(want), name
        if name.endswith(".json"):
            w, g = json.loads(want[0]), json.loads(got[0])
            assert set(g) == set(w)
            for k in w:
                if k != "pairs_per_sec":
                    np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
            continue
        assert got[0::2] == want[0::2]
        np.testing.assert_allclose([float(v) for v in got[1::2]],
                                   [float(v) for v in want[1::2]], rtol=0, atol=1e-4,
                                   err_msg=name)


def test_profile_dir_captures_a_trace(vigor_root, tmp_path):
    """``--profile_dir`` traces the first steps of a short epoch into a
    Chrome trace that holds the train step's forward range."""
    from ccvpe_torch.train.loop import FORWARD_RANGE
    from ccvpe_torch.utils.profiling import TRACE_FILE

    PV.main(COMMON + ["--dataset_root", vigor_root, "--epochs", "1", "--steps_per_epoch", "2",
                      "--checkpoint_dir", str(tmp_path / "ckpt"),
                      "--results_dir", str(tmp_path / "res"),
                      "--profile_dir", str(tmp_path / "prof")])
    events = json.loads((tmp_path / "prof" / TRACE_FILE).read_text())["traceEvents"]
    assert sum(e.get("name") == FORWARD_RANGE for e in events) == 2
