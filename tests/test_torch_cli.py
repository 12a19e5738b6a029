"""The port's eval CLIs against the JAX package's, on the CPU, on seeded
synthetic roots and one reference-format ``.pt`` that both load: a NANO
model of the port with calibrated BatchNorm statistics, written by
``CVMModel.save_torch``.  The JAX CLIs run with ``--matching_impl einsum``,
the port's with ``plain`` under ``CCVPE_PLATFORM=cpu``.

Summaries: the same keys, values within 1e-5 relative except
``pairs_per_sec``.  Covered: VIGOR at ``--ori_noise`` 0, 36, 180 (the
shipped frozen-orientation fixture) and ``-f 180``; KITTI's two test
splits with the lateral/longitudinal keys; Oxford's three traversals.
Also: the unported flags exit naming their ROADMAP item, ``main`` without
CUDA or ``CCVPE_PLATFORM`` raises, and the BASELINE eval runner."""

import json

import numpy as np
import pytest
import torch

from ccvpe_torch import train_KITTI as PK
from ccvpe_torch import train_OxfordRobotCar as PO
from ccvpe_torch import train_VIGOR as PV
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.parallel import mesh
from ccvpe_torch.train import cli as TCLI
from tests.torch_data_roots import kitti_root, oxford_root, vigor_root  # noqa: F401
from tests.torch_data_roots import write_nano_pt

torch.set_num_threads(2)
RTOL = 1e-5


@pytest.fixture(scope="module")
def model_pt(tmp_path_factory):
    return write_nano_pt(str(tmp_path_factory.mktemp("model") / "nano.pt"), seed=11)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv("CCVPE_PLATFORM", "cpu")


def _assert_summaries_close(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if k != "pairs_per_sec":
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0, err_msg=k)


def test_save_torch_round_trips_through_jax(model_pt):
    from ccvpe_tpu.io.torch_import import export_cvm, import_cvm, load_state_dict

    from ccvpe_torch.io.from_jax import load_state_dict as t_load

    mine = t_load(model_pt)
    back = export_cvm(*import_cvm(load_state_dict(model_pt)))
    assert set(back) == set(mine)
    for k, v in back.items():
        if not k.endswith("num_batches_tracked"):   # a torch counter JAX does not keep
            np.testing.assert_array_equal(np.asarray(v), mine[k].numpy(), err_msg=k)
    assert all(t.is_contiguous() and t.device.type == "cpu" for t in mine.values())


VIGOR_SETTINGS = {"ori_noise_0": ["--ori_noise", "0"], "ori_noise_36": ["--ori_noise", "36"],
                  "ori_noise_180": ["--ori_noise", "180"],
                  "fov_180": ["--ori_noise", "0", "-f", "180"]}


def _printed_metrics(text: str) -> dict:
    """'label:  value' lines of a CLI's eval printout -> {label: value}."""
    out = {}
    for line in text.splitlines():
        label, _, value = line.rpartition(" ")
        try:
            out[label.strip()] = float(value)
        except ValueError:
            continue
    return out


@pytest.mark.parametrize("setting", list(VIGOR_SETTINGS))
def test_vigor_eval_matches_jax(vigor_root, model_pt, on_cpu, tmp_path, capsys, setting):
    import train_VIGOR as JV

    argv = ["--dataset_root", vigor_root, "--model_preset", "NANO", "--training", "False",
            "-b", "4", "--num_workers", "2", "--test_model_path", model_pt,
            "--results_dir", str(tmp_path), *VIGOR_SETTINGS[setting]]
    want = JV.main(argv + ["--matching_impl", "einsum"])
    want_printed = _printed_metrics(capsys.readouterr().out)
    got = PV.main(argv + ["--matching_impl", "plain"])
    got_printed = _printed_metrics(capsys.readouterr().out)
    _assert_summaries_close(got, want)
    assert "mean_orientation_deg" in got and got["pairs_per_sec"] > 0
    # the same printed eval lines, their numbers as the summaries'
    assert len(got_printed) == 6 and set(got_printed) <= set(want_printed)
    for label, value in got_printed.items():
        np.testing.assert_allclose(value, want_printed[label], rtol=RTOL, err_msg=label)


def test_kitti_eval_matches_jax(kitti_root, model_pt, on_cpu, tmp_path):
    import train_KITTI as JK

    argv = ["--dataset_root", kitti_root, "--model_preset", "NANO", "--training", "False",
            "--rotation_range", "10", "-b", "2", "--num_workers", "2",
            "--test_model_path", model_pt, "--results_dir", str(tmp_path)]
    want = JK.main(argv + ["--matching_impl", "einsum"])
    got = PK.main(argv + ["--matching_impl", "plain"])
    assert set(got) == set(want) == {"test1", "test2"}
    for split in want:
        _assert_summaries_close(got[split], want[split])
        assert {"mean_lateral_m", "longitudinal_recall@5m"} <= set(got[split])


def test_oxford_eval_matches_jax(oxford_root, model_pt, on_cpu, tmp_path):
    import train_OxfordRobotCar as JO

    argv = ["--grd_image_root", oxford_root, "--model_preset", "NANO", "--training", "False",
            "-b", "2", "--num_workers", "2", "--test_model_path", model_pt,
            "--results_dir", str(tmp_path)]
    want = JO.main(argv + ["--matching_impl", "einsum"])
    got = PO.main(argv + ["--matching_impl", "plain"])
    assert set(got) == set(want) == {"test1", "test2", "test3"}
    for t in want:
        _assert_summaries_close(got[t], want[t])
        assert "median_lateral_m" in got[t]


@pytest.mark.parametrize("cli,flags,want", [
    (PV, ["--zero1"], dict(zero1=True, n_model=1)),
    (PK, ["--n_model", "2"], dict(zero1=False, n_model=2)),
    (PO, ["--zero1", "--n_model", "4"], dict(zero1=True, n_model=4))])
def test_parallel_flags_reach_the_trainer(cli, flags, want, monkeypatch):
    """``--zero1`` and ``--n_model`` are the Trainer's; its mesh checks are
    the JAX trainer's (``n_model`` must divide the world size)."""
    args = cli.parse_args(["--model_preset", "NANO", *flags])
    assert (args.zero1, args.n_model) == (want["zero1"], want["n_model"])
    monkeypatch.setattr(mesh, "world_size", lambda: 4)
    trainer = TCLI.make_trainer(TC.NANO, args, label="t", checkpoint_dir="", device="cpu")
    assert (trainer.zero1, trainer.n_model) == (want["zero1"], want["n_model"])


@pytest.mark.parametrize("cli", [PV, PK, PO])
def test_main_needs_cuda_or_the_cpu_switch(cli, monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    monkeypatch.delenv("CCVPE_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CCVPE_PLATFORM=cpu"):
        cli.main(["--model_preset", "NANO", "--results_dir", str(tmp_path)])


def test_missing_model_falls_back_to_seeded_weights_and_says_so(vigor_root, on_cpu, tmp_path,
                                                                  capsys):
    summary = PV.main(["--dataset_root", vigor_root, "--model_preset", "NANO",
                       "--training", "False", "--ori_noise", "0", "-b", "4",
                       "--steps_per_epoch", "1", "--num_workers", "2",
                       "--test_model_path", str(tmp_path / "absent.pt"),
                       "--checkpoint_dir", str(tmp_path / "ckpt")])
    assert "evaluating seeded random weights" in capsys.readouterr().out
    assert np.isfinite(summary["mean_distance_m"])


def test_baseline_eval_runner(vigor_root, kitti_root, on_cpu, tmp_path):
    """Configs 2 and 4 through the port's CLIs, and 5 on an Oxford root that
    is not there: recorded as failed while the others still run."""
    from ccvpe_torch.eval.__main__ import main as eval_main

    report = eval_main(["--configs", "2,4,5", "--vigor_root", vigor_root,
                        "--kitti_root", kitti_root, "--oxford_root", str(tmp_path / "none/"),
                        "--model_preset", "NANO", "--steps", "1", "--batch_size", "2",
                        "--num_workers", "2", "--results_dir", str(tmp_path / "results"),
                        "--out", str(tmp_path / "report.json")])
    assert report["n_ok"] == 2 and report["n_failed"] == 1
    saved = json.loads((tmp_path / "report.json").read_text())
    assert saved["harness"] == "ccvpe_torch.eval"
    by_id = {r["id"]: r for r in saved["results"]}
    assert set(by_id) == {2, 4, 5} and by_id[5]["status"] == "failed"
    assert "FileNotFoundError" in by_id[5]["metrics"]["error"]
    assert {"median_distance_m", "pairs_per_sec"} <= set(by_id[2]["metrics"])
    assert set(by_id[4]["metrics"]) == {"test1", "test2"}
