"""ccvpe_torch.train.harness on the CPU (NANO, a seeded synthetic VIGOR root):
resume at the right epoch after a completed and after a mid-epoch save; the
epoch orders of a resumed run equal an uninterrupted run's and the JAX
CLI's; ``append_result`` and ``write_epoch_results`` write the JAX
package's bytes; ``evaluate``'s readout path agrees with its full-heatmap
path; options the port lacks raise."""

import types

import numpy as np
import pytest
import torch

import ccvpe_tpu.data.pipeline as JP
import ccvpe_tpu.train.harness as JH
import ccvpe_torch.data.pipeline as TP
from ccvpe_torch import train_VIGOR as PV
from ccvpe_torch.data import vigor as TV
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.train import harness as TH
from ccvpe_torch.train.metrics import VIGOR_METER_PER_PIXEL
from tests.torch_data_roots import vigor_root

torch.set_num_threads(2)
CFG = TC.NANO


def _sampler(root):
    index = TV.VigorIndex.load(root, "samearea", True)
    return TV.VigorSampler(index, grd_hw=CFG.grd_hw, sat_hw=CFG.sat_hw)


def _loader(sampler, idx, b=2):
    return TP.Loader(sampler, np.asarray(idx), b, num_workers=2)


def _batch_fn(train):
    return lambda raw: TV.device_batch(raw, train=train, sat_hw=CFG.sat_hw, bins=CFG.bins,
                                       device="cpu")


def _trainer(tmp_path, **kw):
    return TH.Trainer(CFG, checkpoint_dir=str(tmp_path / "ckpt"),
                      results_dir=str(tmp_path / "res"), device="cpu", **kw)


def test_resume_starts_after_a_completed_epoch(vigor_root, tmp_path):
    sampler = _sampler(vigor_root)
    tr = _trainer(tmp_path)
    tr.init_state()
    tr.train_epoch(_loader(sampler, range(4)), _batch_fn(True), epoch=0)
    assert tr.ckpt.all_steps() == [2] and tr.ckpt.meta(2)["completed"] is True
    again = _trainer(tmp_path)
    assert again.resume() and again.start_epoch == 1
    assert again.state.step == 2 and again._global_step == 2


def test_resume_reruns_an_epoch_cut_short(vigor_root, tmp_path):
    """Saves every step; the epoch dies after its second step: resume
    re-runs that epoch.  A mid-epoch save on the epoch's last step is
    marked completed instead of saved twice."""
    sampler = _sampler(vigor_root)
    tr = _trainer(tmp_path, checkpoint_every_steps=1)
    tr.init_state()
    tr.train_epoch(_loader(sampler, range(4)), _batch_fn(True), epoch=0)
    assert tr.ckpt.all_steps() == [1, 2]        # keep_checkpoints 3, 2 steps
    assert tr.ckpt.meta(2) == {"step": 2, "epoch": 0, "completed": True}

    def dies(raw):
        if dies.calls == 2:
            raise RuntimeError("preempted")
        dies.calls += 1
        return _batch_fn(True)(raw)

    dies.calls = 0
    with pytest.raises(RuntimeError, match="preempted"):
        tr.train_epoch(_loader(sampler, range(8)), dies, epoch=1)
    assert tr.ckpt.latest_step() == 4 and tr.ckpt.meta(4)["completed"] is False
    again = _trainer(tmp_path)
    assert again.resume() and again.start_epoch == 1 and again.state.step == 4


def _record_loaders(monkeypatch, module):
    orders = []

    class Recording(module.Loader):
        def __init__(self, sample_fn, indices, *a, **kw):
            orders.append(np.asarray(indices).tolist())
            super().__init__(sample_fn, indices, *a, **kw)

    monkeypatch.setattr(module, "Loader", Recording)
    return orders


def test_resumed_epoch_orders_equal_uninterrupted_and_jax(vigor_root, tmp_path, monkeypatch):
    argv = ["--dataset_root", vigor_root, "--model_preset", "NANO", "-b", "2",
            "--steps_per_epoch", "3", "--num_workers", "2", "--matching_impl", "plain"]
    monkeypatch.setenv("CCVPE_PLATFORM", "cpu")
    orders = _record_loaders(monkeypatch, TP)

    def run(tag, *extra):
        del orders[:]
        PV.main(argv + ["--checkpoint_dir", str(tmp_path / tag),
                        "--results_dir", str(tmp_path / f"res_{tag}"), *extra])
        return list(orders)

    whole = run("whole", "--epochs", "3")
    first = run("cut", "--epochs", "1")
    rest = run("cut", "--epochs", "3", "--resume")
    assert len(whole) == 6 and first + rest == whole     # (train, val) per epoch
    assert whole[0] != whole[2] != whole[4]              # each epoch its own shuffle

    # the JAX CLI's loaders, its trainer stubbed out (only the orders count)
    import train_VIGOR as JV

    jorders = _record_loaders(monkeypatch, JP)
    monkeypatch.setattr(JH.Trainer, "train_epoch", lambda self, loader, fn, epoch: 1.0)
    monkeypatch.setattr(JH.Trainer, "evaluate", lambda self, *a, **kw: {})
    monkeypatch.setattr(JH.Trainer, "write_epoch_results", lambda self, *a, **kw: None)
    JV.main(argv[:-2] + ["--epochs", "3", "--checkpoint_dir", str(tmp_path / "jax"),
                         "--results_dir", str(tmp_path / "res_jax")])
    assert jorders == whole


def test_append_result_and_epoch_results_match_jax_bytes(tmp_path):
    summary = {"mean_distance_m": 12.3456789, "median_distance_m": 1e-7,
               "mean_orientation_deg": 179.99999951, "median_orientation_deg": 3.0,
               "orientation_recall@1deg": 0.25, "pairs_per_sec": 10.5}
    for epoch, scale in ((0, 1.0), (1, 0.5), (12, 1e4)):
        for mod, tag in ((TH, "torch"), (JH, "jax")):
            mod.append_result(str(tmp_path / tag), "x_median.txt", epoch, 3.14159265 * scale,
                              "x_median:")
            trainer = types.SimpleNamespace(results_dir=str(tmp_path / tag), label="lbl")
            s = {k: v * scale for k, v in summary.items()}
            mod.Trainer.write_epoch_results(trainer, epoch, s, prefix="test1_")
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert len(names) == 6
    for name in names:
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert (tmp_path / "torch" / "x_median.txt").read_text().startswith(
        "0_x_median:\n3.141593\n1_x_median:\n")


def test_epoch_results_are_written_by_rank_zero_only(tmp_path, monkeypatch):
    monkeypatch.setattr(TH, "_process_index", lambda: 1)
    trainer = types.SimpleNamespace(results_dir=str(tmp_path / "res"), label="lbl")
    TH.Trainer.write_epoch_results(trainer, 0, {"mean_distance_m": 1.0})
    assert not (tmp_path / "res").exists()


@pytest.mark.parametrize("with_heading", [False, True])
def test_readout_path_agrees_with_the_heatmap_path(vigor_root, tmp_path, with_heading):
    """The two eval paths on the same model and batches: the same summary
    keys; the same peaks (no logit tie on this data, checked), so distances
    to 1e-6 relative (the readout's pixel distance is float32, the
    heatmap path's float64) and probabilities at the GT to 1e-5."""
    index = TV.VigorIndex.load(vigor_root, "samearea", False)
    sampler = TV.VigorSampler(index, ori_noise=0.0, grd_hw=CFG.grd_hw, sat_hw=CFG.sat_hw)
    tr = _trainer(tmp_path, matching_impl="plain")
    tr.init_state(seed=3)
    from ccvpe_torch.nn.layers import calibrate_batch_norm_

    fn = _batch_fn(False)
    calib = fn(next(iter(_loader(sampler, range(2)))))
    calibrate_batch_norm_(tr.state.model, lambda: tr.state.model(calib["grd"], calib["sat"]))

    def batch_fn(raw):
        batch = fn(raw)
        if with_heading:      # VIGOR has no heading: feed the GT angle as one
            raw["orientation_from_north"] = raw["angle"]
        return batch

    kw = dict(meter_per_pixel=None, cities_to_mpp=VIGOR_METER_PER_PIXEL,
              loc_offsets=(0,), with_heading=with_heading)
    fast = tr.evaluate(_loader(sampler, range(12)), batch_fn, device_readout=True, **kw)
    full = tr.evaluate(_loader(sampler, range(12)), batch_fn, device_readout=False, **kw)
    assert set(fast) == set(full) and ("mean_lateral_m" in fast) == with_heading
    for k in fast:
        if k == "pairs_per_sec":
            continue
        rtol = 1e-5 if "probability" in k else 1e-6
        np.testing.assert_allclose(fast[k], full[k], rtol=rtol, err_msg=k)
    # no two top logits within rounding of each other on this data
    out = tr._get_eval_step((0,))(tr.state.model, calib["grd"], calib["sat"])
    top2 = out.logits_flattened.topk(2, dim=1).values
    assert ((top2[:, 0] - top2[:, 1]) > 1e-6 * top2[:, 0].abs()).all()


@pytest.mark.parametrize("kw,match", [
    (dict(n_model=2), r"n_model=2 must be a positive divisor of the device count \(1\)"),
    (dict(n_model=0), r"n_model=0 must be a positive divisor")])
def test_n_model_must_divide_the_world(kw, match):
    """Without a process group the world is one device: ``n_model`` 1 only
    (the message of the JAX trainer's mesh check)."""
    with pytest.raises(ValueError, match=match):
        TH.Trainer(CFG, device="cpu", **kw)


def test_zero1_alone_is_the_one_device_optimizer():
    """Without a process group ``zero1`` shards nothing: the optimizer is
    Adam's, as a one-device JAX mesh leaves the state whole."""
    tr = TH.Trainer(CFG, device="cpu", zero1=True)
    tr.init_state()
    assert type(tr.state.optimizer) is torch.optim.Adam
