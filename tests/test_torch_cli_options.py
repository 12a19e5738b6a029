"""The training options of the port's CLIs on the CPU: ``--bf16``,
``--bf16_params``, ``--remat [all|encoder|decoder]`` and
``--pretrained_b0`` are taken (``--zero1`` and ``--n_model`` still exit,
``tests/test_torch_cli.py``), and a NANO VIGOR run with all four is held
against the JAX CLI's results files.

Both CLIs start from the same weights: the seeded, BN-calibrated NANO of
``write_nano_pt`` stands in for each package's own random init, and both
then take the encoders of one raw backbone state_dict (``--pretrained_b0``).
Drop-connect is off on both sides (its draws cannot be matched across the
packages).  The bar calibrates itself as ``tests/test_torch_bf16.py``'s:
each results value of the port's bfloat16 run lies within twice the JAX
bfloat16 run's distance from the JAX float32 run, plus one bfloat16
rounding of the value and the files' ``%4f`` resolution.
"""

import json
import os

import numpy as np
import pytest
import torch

from ccvpe_torch import train_KITTI as PK
from ccvpe_torch import train_VIGOR as PV
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.nn import efficientnet as TE
from ccvpe_torch.nn.layers import init_uniform_
from ccvpe_torch.train import cli as TCLI
from ccvpe_torch.train import loop as TLOOP
from tests.torch_data_roots import vigor_root  # noqa: F401
from tests.torch_data_roots import write_nano_pt

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("CCVPE_PLATFORM", "cpu")


@pytest.mark.parametrize("cli,flags,want", [
    (PV, ["--bf16"], dict(compute="bfloat16", params="float32", remat=False)),
    (PV, ["--bf16_params"], dict(compute="float32", params="bfloat16", remat=False)),
    (PV, ["--remat"], dict(compute="float32", params="float32", remat="all")),
    (PV, ["--remat", "encoder"], dict(compute="float32", params="float32", remat="encoder")),
    (PV, ["--pretrained_b0", "b0.pt"], dict(compute="float32", params="float32", remat=False)),
    (PK, ["--bf16", "--bf16_params", "--remat", "decoder"],
     dict(compute="bfloat16", params="bfloat16", remat="decoder"))])
def test_training_option_flags_are_taken(cli, flags, want):
    args = cli.parse_args(["--model_preset", "NANO", *flags])
    trainer = TCLI.make_trainer(TC.NANO, args, label="t", checkpoint_dir="", device="cpu")
    assert trainer.compute_dtype == TLOOP.DTYPES[want["compute"]]
    assert trainer.param_dtype == TLOOP.DTYPES[want["params"]]
    assert trainer.remat == want["remat"]
    assert (trainer.zero1, trainer.n_model) == (False, 1)


def _nano_backbone_file(path, seed=5) -> str:
    """A raw backbone state_dict in the release files' keys, written by the
    JAX package's ``export_b0`` from a seeded NANO backbone tree, with
    non-trivial BN statistics."""
    from ccvpe_tpu.io.torch_import import export_b0, import_b0
    import jax

    net = init_uniform_(TE.EfficientNet("nano"), torch.Generator().manual_seed(seed))
    params, state = import_b0({k: v.numpy() for k, v in net.state_dict().items()})
    rng = np.random.default_rng(seed)
    state = jax.tree_util.tree_map(
        lambda v: v + rng.uniform(0.1, 0.5, v.shape).astype(np.float32), state)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in export_b0(params, state).items()},
               str(path))
    return str(path)


def _values(res_dir) -> dict:
    out = {}
    for name in sorted(os.listdir(res_dir)):
        lines = (res_dir / name).read_text().splitlines()
        if name.endswith(".json"):
            row = json.loads(lines[0])
            out.update({f"{name}:{k}": v for k, v in row.items()
                        if k not in ("pairs_per_sec", "epoch")})
        else:
            out[name] = float(lines[1])
    return out


def test_vigor_train_with_the_options_against_jax(vigor_root, tmp_path, monkeypatch):
    import train_VIGOR as JV

    import jax
    import jax.numpy as jnp

    import ccvpe_tpu.models.cvm as JC
    import ccvpe_tpu.nn.efficientnet as JE
    import ccvpe_tpu.train.harness as JH
    from ccvpe_tpu.io.torch_import import import_cvm
    from ccvpe_torch.io.from_jax import load_state_dict

    start = load_state_dict(write_nano_pt(str(tmp_path / "start.pt"), seed=21))
    monkeypatch.setattr(JC, "init", lambda key, cfg, dtype=None: import_cvm(
        {k: v.numpy().copy() for k, v in start.items()}))
    monkeypatch.setattr(TC.CVM, "init_weights_",
                        lambda self, gen: self.load_state_dict(start) and self)
    # JAX's create_train_state gives both encoders the one imported tree,
    # and its donating train step then fails on a multi-device CPU mesh
    # ("donate the same buffer twice"): give each leaf its own buffer
    place = JH.Trainer._place_state
    monkeypatch.setattr(JH.Trainer, "_place_state", lambda self, state: place(
        self, jax.tree_util.tree_map(lambda v: jnp.array(v, copy=True), state)))
    monkeypatch.setattr(JE, "drop_connect", lambda x, rate, rng: x)
    monkeypatch.setattr(TE, "drop_connect_random", lambda x, rate, generator: x)
    b0 = _nano_backbone_file(tmp_path / "nano_b0.pth")
    argv = ["--dataset_root", vigor_root, "--model_preset", "NANO", "-b", "4",
            "--num_workers", "2", "--steps_per_epoch", "1", "--epochs", "1",
            "--pretrained_b0", b0]
    options = ["--bf16", "--bf16_params", "--remat"]
    runs = {}
    for name, main, extra in (("jax_f32", JV.main, ["--matching_impl", "einsum"]),
                              ("jax_bf16", JV.main, options + ["--matching_impl", "einsum"]),
                              ("port_bf16", PV.main, options + ["--matching_impl", "plain"])):
        main(argv + extra + ["--checkpoint_dir", str(tmp_path / f"{name}_ck"),
                             "--results_dir", str(tmp_path / name)])
        runs[name] = _values(tmp_path / name)
    assert set(runs["port_bf16"]) == set(runs["jax_bf16"]) == set(runs["jax_f32"])
    assert len(runs["port_bf16"]) > 8
    for k, f32 in runs["jax_f32"].items():
        port, jb = runs["port_bf16"][k], runs["jax_bf16"][k]
        bar = 2 * abs(jb - f32) + 2.0 ** -8 * abs(f32) + 1e-4
        assert np.isfinite(port) and abs(port - jb) <= bar, (k, port, jb, f32)
    # the port's checkpoint holds bfloat16 parameters
    from ccvpe_torch.io.checkpoint import CheckpointManager

    weights = CheckpointManager(str(tmp_path / "port_bf16_ck")).load_weights()
    assert weights["deconv1.weight"].dtype == torch.bfloat16
    assert weights["grd_efficientnet._bn0.running_mean"].dtype == torch.float32
