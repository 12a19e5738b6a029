"""``torchrun --nproc_per_node 2 -m ccvpe_torch.train_VIGOR`` on the CPU: the
launch a user makes, through the real CLI (the counterpart of
``tests/test_multiprocess_cli.py``).

Two ranks join over gloo from torchrun's environment alone
(``parallel.mesh.maybe_init_distributed``), load their strided slices of
each global batch, train 2 steps (NANO, global batch 4) and run the epoch's
validation; rank 0 alone writes the checkpoint and the results.  The same
command in one process is the reference: the validation summary at
``tests/test_multiprocess.py``'s tolerances (rtol 1e-3, atol 1e-4; the
ranks' samples are the same, their order within a batch differs, as on the
JAX mesh) and the trained parameters' norm within 1e-4.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ccvpe_torch.data import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABEL = "samearea_HFoV360"


def _argv(root, ck, res):
    return ["-m", "ccvpe_torch.train_VIGOR", "--dataset_root", root, "--model_preset", "NANO",
            "--epochs", "1", "--steps_per_epoch", "2", "-b", "4", "--num_workers", "2",
            "--checkpoint_dir", ck, "--results_dir", res, "--matching_impl", "plain"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torchrun")
    root = synthetic.write_vigor_root(str(tmp / "vigor"))
    env = {**os.environ, "CCVPE_PLATFORM": "cpu", "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    dirs = {n: (str(tmp / f"ck_{n}"), str(tmp / f"res_{n}")) for n in ("one", "two")}
    launch = {"one": [sys.executable, *_argv(root, *dirs["one"])],
              "two": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                      "--nproc_per_node", "2", *_argv(root, *dirs["two"])]}
    procs = {n: subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, cmd in launch.items()}
    logs = {n: p.communicate(timeout=600)[0] for n, p in procs.items()}
    for n, p in procs.items():
        assert p.returncode == 0, f"{n}:\n{logs[n]}"
    return dirs, logs


def _summary(res_dir):
    with open(os.path.join(res_dir, f"{LABEL}_summary.json")) as f:
        return [json.loads(line) for line in f]


def _checkpoint(ck_dir):
    names = sorted(os.listdir(ck_dir))
    assert names == ["ckpt_2.pt", "latest_meta.json"], names
    return torch.load(os.path.join(ck_dir, "ckpt_2.pt"), weights_only=True)


def test_rank_zero_alone_writes_one_summary_line(runs):
    dirs, _ = runs
    lines = _summary(dirs["two"][1])
    assert len(lines) == 1 and lines[0]["epoch"] == 0
    for stem in ("mean_distance_error", "median_orientation_error"):
        with open(os.path.join(dirs["two"][1], f"{LABEL}_{stem}.txt")) as f:
            assert len(f.read().splitlines()) == 2    # the header and one value


def test_validation_summary_equals_the_one_process_run(runs):
    dirs, _ = runs
    (want,), (got,) = _summary(dirs["one"][1]), _summary(dirs["two"][1])
    want.pop("pairs_per_sec"), got.pop("pairs_per_sec")
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=1e-4, err_msg=k)


def test_checkpoint_is_the_one_process_runs(runs):
    """The same file layout, step and Adam state keys; the trained
    parameters' norm within 1e-4."""
    dirs, _ = runs
    one, two = (_checkpoint(dirs[n][0]) for n in ("one", "two"))
    assert one["step"] == two["step"] == 2
    assert one["model"].keys() == two["model"].keys()
    assert one["optimizer"]["state"].keys() == two["optimizer"]["state"].keys()

    def norm(sd):
        return torch.cat([v.flatten().double() for k, v in sd.items()
                          if not k.endswith(("running_mean", "running_var",
                                             "num_batches_tracked"))]).norm().item()

    np.testing.assert_allclose(norm(two["model"]), norm(one["model"]), rtol=1e-4)


def test_both_ranks_ran(runs):
    _, logs = runs
    assert logs["two"].count("Finished Training") == 2
    assert logs["one"].count("Finished Training") == 1
