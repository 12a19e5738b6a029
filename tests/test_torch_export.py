"""``api.export_model`` / ``load_exported`` on the CPU (the counterparts of
the JAX package's export tests in ``tests/test_api.py`` and
``tests/test_quant.py``): a seeded NANO model with calibrated BatchNorm
statistics, exported with ``torch.export``, reloaded, and held to the same
model's ``predict_batch`` exactly (row, col, heatmap, heading,
probability).  The fixed and dynamic exports are also held to the JAX
package's ``predict_batch`` on the same weights, at ``test_torch_api.py``'s
tolerances.  Covered: a fixed batch; ``batch="dynamic"`` served at 1 and
3; ``platforms=("cpu",)``; a wrong batch raises the JAX package's message;
an int8 model exports its int8 forward; ``load_exported`` needs none of the
model code; without CUDA the default device raises."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ccvpe_torch import api
from ccvpe_torch.data.transforms import normalize_images
from ccvpe_torch.nn.layers import calibrate_batch_norm_

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (batch, *cfg.grd_hw, 3), dtype=np.uint8),
            rng.integers(0, 256, (batch, *cfg.sat_hw, 3), dtype=np.uint8))


def _model(seed: int) -> api.CVMModel:
    model = api.load_model(preset="NANO", seed=seed, device="cpu")
    g, s = (normalize_images(torch.from_numpy(x)) for x in _images(model.cfg, 2, seed + 1))
    calibrate_batch_norm_(model.net, lambda: model.net(g, s))
    return model


@pytest.fixture(scope="module")
def model():
    return _model(3)


@pytest.fixture(scope="module")
def jax_model(model):
    """The same weights in the JAX package (``import_cvm`` of the port's
    reference-layout ``state_dict``)."""
    from ccvpe_tpu import api as JA
    from ccvpe_tpu.io.torch_import import import_cvm
    from ccvpe_tpu.models import cvm as JC

    params, state = import_cvm({k: v.numpy() for k, v in model.net.state_dict().items()})
    return JA.CVMModel(JC.NANO, params, state)


def _assert_close_to_jax(got, want):
    """``test_torch_api.py``'s bars: the same pixel, probability 1e-4
    relative, heading 1e-2 degrees, heatmap 1e-7 absolute plus 1e-4
    relative."""
    assert len(got) == len(want)
    for p, q in zip(got, want):
        assert (p.row, p.col) == (q.row, q.col)
        np.testing.assert_allclose(p.probability, q.probability, rtol=1e-4)
        assert abs((p.orientation_deg - q.orientation_deg + 180.0) % 360.0 - 180.0) < 1e-2
        np.testing.assert_allclose(p.heatmap, q.heatmap, atol=1e-7, rtol=1e-4)


@pytest.fixture(scope="module")
def fixed_export(model, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "fixed")
    api.export_model(model, path, batch=2, ori_noise=36.0)
    return path


def _assert_same_poses(got, want, heatmap: bool = True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.row, g.col) == (w.row, w.col)
        assert g.orientation_deg == w.orientation_deg
        assert g.probability == w.probability
        if heatmap:
            np.testing.assert_array_equal(g.heatmap, w.heatmap)


def test_fixed_batch_round_trip(model, jax_model, fixed_export):
    with open(os.path.join(fixed_export, "meta.json")) as f:
        meta = json.load(f)
    assert meta == {"preset_grd_hw": list(model.cfg.grd_hw),
                    "preset_sat_hw": list(model.cfg.sat_hw), "batch": 2, "ori_noise": 36.0}
    assert sorted(os.listdir(fixed_export)) == ["forward.cpu.pt2", "meta.json"]
    served = api.load_exported(fixed_export, device="cpu")
    grd, sat = _images(model.cfg, 2, seed=7)
    want = model.predict_batch(grd, sat, ori_noise=36.0, return_heatmap=True)
    got = served.predict_batch(grd, sat, return_heatmap=True)
    _assert_same_poses(got, want)
    _assert_close_to_jax(got, jax_model.predict_batch(grd, sat, ori_noise=36.0,
                                                      return_heatmap=True))
    without = served.predict_batch(grd, sat)
    assert all(p.heatmap is None for p in without)
    _assert_same_poses(without, want, heatmap=False)


def test_wrong_batch_raises_the_fixed_batch_message(model, fixed_export):
    grd, sat = _images(model.cfg, 3, seed=8)
    served = api.load_exported(fixed_export, device="cpu")
    with pytest.raises(ValueError, match=r"this export is fixed to batch=2; got 3 images "
                                         r"\(re-export with batch=3 or batch='dynamic', "
                                         r"or pad the batch\)"):
        served.predict_batch(grd, sat)


def test_dynamic_batch_serves_any_batch(model, jax_model, tmp_path):
    path = str(tmp_path / "dynamic")
    api.export_model(model, path, batch="dynamic")
    served = api.load_exported(path, device="cpu")
    assert served.meta["batch"] == "dynamic"
    for b in (1, 3):
        grd, sat = _images(model.cfg, b, seed=10 + b)
        got = served.predict_batch(grd, sat, return_heatmap=True)
        _assert_same_poses(got, model.predict_batch(grd, sat, return_heatmap=True))
        _assert_close_to_jax(got, jax_model.predict_batch(grd, sat, return_heatmap=True))


def test_platforms_cpu(model, tmp_path):
    path = str(tmp_path / "cpu")
    api.export_model(model, path, batch=1, platforms=("cpu",))
    assert os.path.exists(os.path.join(path, "forward.cpu.pt2"))
    grd, sat = _images(model.cfg, 1, seed=20)
    got = api.load_exported(path, device="cpu").predict_batch(grd, sat, return_heatmap=True)
    _assert_same_poses(got, model.predict_batch(grd, sat, return_heatmap=True))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            api.load_exported(path)
        with pytest.raises(RuntimeError, match="CUDA"):
            api.export_model(model, str(tmp_path / "cuda"), platforms=("cuda",))


def test_int8_model_exports_its_int8_forward(tmp_path):
    """JAX ``test_quant.py``: the export reproduces the quantized model's
    rows, probabilities within 1e-4 relative / 1e-5 absolute; here the
    heatmap with the readout of the heatmap is exact as well."""
    from ccvpe_torch.nn import layers as TL

    model = _model(5)
    grd, sat = _images(model.cfg, 2, seed=30)
    model.quantize_int8(calib=[(grd, sat)])
    after = model.predict_batch(grd, sat, ori_noise=0)
    TL.reset_int8_counts()
    path = str(tmp_path / "q_export")
    api.export_model(model, path, batch=2, ori_noise=0)
    n_int8 = sum(isinstance(m, TL.QuantConv2d) for m in model.net.modules())
    assert TL.int8_counts() == {"mm": 0, "plain": n_int8}   # traced through the int8 convs
    exported = api.ExportedModel(path, device="cpu")
    re = exported.predict_batch(grd, sat)
    np.testing.assert_allclose([p.probability for p in re], [p.probability for p in after],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal([p.row for p in re], [p.row for p in after])
    _assert_same_poses(exported.predict_batch(grd, sat, return_heatmap=True),
                       model.predict_batch(grd, sat, ori_noise=0, return_heatmap=True))


def test_load_exported_needs_no_model_code(model, fixed_export):
    grd, sat = _images(model.cfg, 2, seed=7)
    want = model.predict_batch(grd, sat, ori_noise=36.0)
    code = (
        "import sys, numpy as np\n"
        "from ccvpe_torch import api\n"
        f"rng = np.random.default_rng(7)\n"
        f"grd = rng.integers(0, 256, (2, {model.cfg.grd_hw[0]}, {model.cfg.grd_hw[1]}, 3), "
        "dtype=np.uint8)\n"
        f"sat = rng.integers(0, 256, (2, {model.cfg.sat_hw[0]}, {model.cfg.sat_hw[1]}, 3), "
        "dtype=np.uint8)\n"
        f"poses = api.load_exported({fixed_export!r}, device='cpu').predict_batch(grd, sat)\n"
        "bad = sorted(m for m in sys.modules if m.startswith(('ccvpe_torch.models', "
        "'ccvpe_torch.nn', 'ccvpe_torch.ops', 'jax', 'ccvpe_tpu')))\n"
        "assert not bad, bad\n"
        "print([(p.row, p.col) for p in poses])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == str([(p.row, p.col) for p in want])
