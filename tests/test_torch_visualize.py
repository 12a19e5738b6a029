"""``python -m ccvpe_torch.visualize`` against ``ccvpe_tpu.visualize`` on the
CPU: seeded synthetic roots, the NANO preset, one reference-format ``.pt``
that both packages load (a NANO model of the port with BatchNorm statistics
calibrated on a seeded batch, so that the outputs depend on the images).

Each package's ``run`` is driven as a user calls it, with its ``render``
wrapped to capture what it is given: the port's heatmap, orientation field
and GT against JAX's ``make_eval_step`` outputs at 1e-5 (the orientation
field with rtol 1e-4 besides: it is a 2-vector divided by its norm, which
magnifies the float32 rounding of the decoder's last conv where that norm is
small; one KITTI element of 32768 is 1.2e-5 off, 2e-5 relative), and the two
``render``s' ``(loc_pred, loc_gt)`` equal.  Covered: VIGOR at ``--ori_noise``
180 (the shipped frozen orientations) and 36 (a +-2-bin prior), KITTI and
Oxford; the port renders a PNG; a missing fixture exits naming the file."""

import os

import numpy as np
import pytest
import torch

from ccvpe_tpu import visualize as JV
from ccvpe_torch import visualize as TV
from tests.torch_data_roots import kitti_root, oxford_root, vigor_root  # noqa: F401
from tests.torch_data_roots import write_nano_pt

pytest.importorskip("matplotlib")
torch.set_num_threads(2)
ATOL = 1e-5
ORI_RTOL = 1e-4


@pytest.fixture(scope="module")
def model_pt(tmp_path_factory):
    return write_nano_pt(str(tmp_path_factory.mktemp("model") / "nano.pt"), seed=11)


def _capture(module, monkeypatch, draw: bool) -> dict:
    """Wrap ``module.render``: record its arrays and its return value."""
    seen, real = {}, module.render

    def render(sat_img, heatmap, ori, gt, out_path, **kw):
        if draw:
            locs = real(sat_img, heatmap, ori, gt, out_path, **kw)
        else:
            locs = (np.unravel_index(heatmap.argmax(), heatmap.shape),
                    np.unravel_index(gt.argmax(), gt.shape))
        seen.update(sat=np.asarray(sat_img), heatmap=np.asarray(heatmap), ori=np.asarray(ori),
                    gt=np.asarray(gt), locs=locs)
        return locs

    monkeypatch.setattr(module, "render", render)
    return seen


def _argv(dataset: str, root: str, model_pt: str, out: str, extra=()) -> list[str]:
    return ["--dataset", dataset, "--dataset_root", root, "--model_preset", "NANO",
            "--test_model_path", model_pt, "--out", out, *extra]


def _both(dataset, root, model_pt, tmp_path, monkeypatch, extra=()):
    monkeypatch.setenv("CCVPE_PLATFORM", "cpu")
    want = _capture(JV, monkeypatch, draw=False)
    JV.main(_argv(dataset, root, model_pt, str(tmp_path / "jax.png"), extra))
    got = _capture(TV, monkeypatch, draw=True)
    out = str(tmp_path / "torch.png")
    args = TV.parse_args(_argv(dataset, root, model_pt, out, [*extra, "--matching_impl", "plain"]))
    assert TV.run(dataset, args) == out
    assert os.path.getsize(out) > 0
    np.testing.assert_array_equal(got["sat"], want["sat"])
    for key in ("heatmap", "ori", "gt"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], rtol=ORI_RTOL if key == "ori" else 0,
                                   atol=ATOL, err_msg=key)
    assert [tuple(map(int, loc)) for loc in got["locs"]] == \
        [tuple(map(int, loc)) for loc in want["locs"]]
    # one peak: the argmax is not decided by the order of equal maxima
    top2 = np.sort(got["heatmap"], axis=None)[-2:]
    assert top2[1] > top2[0]
    return got


@pytest.mark.parametrize("ori_noise", ["180", "36"])
def test_vigor_matches_jax(vigor_root, model_pt, tmp_path, monkeypatch, ori_noise):
    got = _both("VIGOR", vigor_root, model_pt, tmp_path, monkeypatch,
                ["--ori_noise", ori_noise, "--idx", "1"])
    assert got["ori"].shape[-1] == 2


def test_kitti_matches_jax(kitti_root, model_pt, tmp_path, monkeypatch):
    _both("KITTI", kitti_root, model_pt, tmp_path, monkeypatch)


def test_oxford_matches_jax(oxford_root, model_pt, tmp_path, monkeypatch):
    _both("OxfordRobotCar", oxford_root, model_pt, tmp_path, monkeypatch, ["--idx", "1"])


def test_missing_fixture_exits_naming_the_file(vigor_root, tmp_path, monkeypatch):
    monkeypatch.setenv("CCVPE_PLATFORM", "cpu")
    args = TV.parse_args(["--dataset_root", vigor_root, "--model_preset", "NANO",
                          "--orientation_dir", str(tmp_path), "--area", "crossarea",
                          "--out", str(tmp_path / "x.png")])
    with pytest.raises(SystemExit, match="crossarea_orientation_test.npy"):
        TV.run("VIGOR", args)
    assert not (tmp_path / "x.png").exists()


def test_root_visualizer_flags_work_for_vigor(vigor_root, tmp_path, monkeypatch, capsys):
    """Every flag of ``visualize_qualitative_results_VIGOR.py`` parses and
    runs here, with the seeded random init when the checkpoint is absent."""
    monkeypatch.setenv("CCVPE_PLATFORM", "cpu")
    out = str(tmp_path / "q.png")
    TV.main(["--area", "samearea", "--pos_only", "False", "--ori_noise", "0", "--idx", "2",
             "--dataset_root", vigor_root, "--test_model_path", str(tmp_path / "none.pt"),
             "--orientation_dir", ".", "--out", out, "--model_preset", "NANO",
             "--matching_impl", "plain"])
    assert os.path.getsize(out) > 0
    assert "not found; using random weights" in capsys.readouterr().out


def test_run_needs_cuda_unless_told_otherwise(vigor_root, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    monkeypatch.delenv("CCVPE_PLATFORM", raising=False)
    args = TV.parse_args(["--dataset_root", vigor_root, "--model_preset", "NANO",
                          "--out", str(tmp_path / "x.png")])
    with pytest.raises(RuntimeError, match="CUDA"):
        TV.run("VIGOR", args)
