"""The port's sharded layouts across two gloo ranks on the CPU: ZeRO-1 (with
and without bfloat16 parameters and the float32 master) and ``n_model=2``
(FSDP2), held to the JAX mesh's ZeRO-1 and hybrid data x model steps and
to the replicated run, and checkpoints restored across layouts, bit for
bit.  One module-scoped job (``tests/torch_parallel_job.py``, group
``layouts``) and the set-up and tolerances of
``tests/test_torch_parallel_dist.py``; the layout rules use
``min_size=1000``, as JAX's own mesh tests do, so NANO has tensors to
shard.
"""

import os

import pytest
import torch

from ccvpe_torch.io.checkpoint import CheckpointManager
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.train import loop as TLOOP
from tests.torch_parallel_parity import check_against_jax, run_job
from tests.torch_train_parity import sharded_axes

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    return run_job(tmp_path_factory, "layouts", ("zero1", "n_model"))


def _one_process_state(sd, **kw):
    return TLOOP.train_state_from_torch(sd, TC.NANO, device="cpu", **kw)


@pytest.mark.parametrize("case", ["zero1", "n_model"])
@pytest.mark.parametrize("rank", [0, 1])
def test_step_matches_the_jax_mesh(job, case, rank):
    """Loss parts of both steps, the first step's gradients (FSDP2's
    gathered) and global BN statistics, on each rank, against JAX's ZeRO-1
    step and its 1x2 hybrid mesh."""
    check_against_jax(job.ranks[rank][case], job.refs[case])


@pytest.mark.parametrize("case", ["ddp", "zero1", "n_model"])
def test_ranks_hold_the_same_parameters(job, case):
    a, b = (r[case]["params"] for r in job.ranks)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("case,tol", [("zero1", dict(rtol=1e-6, atol=1e-12)),
                                      ("n_model", dict(rtol=0, atol=1e-3))])
def test_layout_keeps_the_replicated_numbers(job, case, tol):
    """ZeRO-1 and FSDP2 change where the state lives.  ZeRO-1 runs the same
    products, so after two steps its parameters are the replicated run's
    within 1e-6 relative.  FSDP2 gathers contiguous weights where DDP's are
    channels_last, so its convolutions round differently; Adam's m/sqrt(v)
    turns that noise on near-zero gradients into whole-step differences,
    so it is held within 1e-3 (10 steps of lr 1e-4), the bound of JAX's
    own mesh-vs-single-device test (``tests/test_train.py``); its gradients
    are held to JAX's at the tolerances above."""
    got, want = job.ranks[0][case]["params"], job.ranks[0]["ddp"]["params"]
    for k in want:
        torch.testing.assert_close(got[k], want[k], msg=k, **tol)


def test_zero1_shards_what_jax_shards(job):
    """The port's ZeRO-1 optimizer keeps a slice of exactly the tensors whose
    Adam moments JAX's ``zero1_state_shardings`` shards, along the same axis."""
    want = sharded_axes(job.refs["zero1"].shardings.opt_state[0].mu, job.jstate.params)
    layout = job.ranks[0]["zero1_layout"]
    assert any(ax is not None for ax in want.values())
    assert {k: layout[k] for k in want} == want
    for k, ax in layout.items():
        full = job.ranks[0]["ddp"]["params"][k].shape
        slot = job.ranks[0]["zero1_slots"][k]
        assert slot == (full if ax is None else
                        tuple(n // 2 if i == ax else n for i, n in enumerate(full))), k


def test_zero1_optimizer_state_is_the_replicated_one(job):
    """The gathered ZeRO-1 state (every rank) is Adam's state of the
    replicated run, key for key."""
    want = job.ranks[0]["ddp"]["optimizer"]
    for r in job.ranks:
        got = r["zero1"]["optimizer"]
        assert got["param_groups"] == want["param_groups"]
        assert set(got["state"]) == set(want["state"])
        for i, st in want["state"].items():
            for k, v in st.items():
                torch.testing.assert_close(got["state"][i][k], v, rtol=1e-6, atol=1e-12,
                                           msg=f"{i} {k}")


@pytest.mark.parametrize("rank", [0, 1])
def test_zero1_with_bf16_params_matches_replicated(job, rank):
    """ZeRO-1 over bfloat16-resident parameters: the float32 masters and
    their moments sharded; the resident parameters and the masters after
    two steps are the replicated run's."""
    got, want = (job.ranks[rank][f"bf16_params_zero1_{z}"] for z in (True, False))
    for i in range(2):
        assert got["parts"][i] == pytest.approx(want["parts"][i], rel=1e-6)
    for k in want["params"]:
        assert torch.equal(got["params"][k], want["params"][k]), k
    for a, b in zip(got["optimizer"]["master"], want["optimizer"]["master"], strict=True):
        assert torch.equal(a, b)


# -- checkpoints across layouts -------------------------------------------------

def _saved(d, name):
    ck = CheckpointManager(os.path.join(d, name))
    assert ck.all_steps() == [2]
    return ck


@pytest.mark.parametrize("name,case", [("ck_zero1", "zero1"), ("ck_fsdp", "n_model"),
                                       ("ck_ddp", "ddp")])
def test_checkpoint_restores_into_one_process(job, name, case):
    """A checkpoint written by a ZeRO-1, FSDP2 or DDP run restores into a
    one-process state bit for bit: the parameters after the run's two steps
    and (ZeRO-1, DDP) Adam's state as the run gathered it."""
    st = _one_process_state(job.sd)
    _saved(job.dir, name).restore(st)
    assert st.step == 2
    for k, p in st.model.named_parameters():
        assert torch.equal(p.detach(), job.ranks[0][case]["params"][k]), k
    if "optimizer" in job.ranks[0][case]:
        want = job.ranks[0][case]["optimizer"]["state"]
        got = st.optimizer.state_dict()["state"]
        for i, s in want.items():
            for k, v in s.items():
                assert torch.equal(got[i][k], v), (i, k)


@pytest.mark.parametrize("into", ["ddp_into_zero1", "ddp_into_fsdp"])
def test_replicated_checkpoint_restores_into_a_sharded_layout(job, into):
    """The DDP run's file restored into ZeRO-1 and FSDP2 states on both
    ranks: its parameters and Adam's state, bit for bit."""
    want = job.ranks[0]["ddp"]
    for r in job.ranks:
        got = r[into]
        assert got["step"] == 2
        for k in want["params"]:
            assert torch.equal(got["params"][k], want["params"][k]), k
        for i, s in want["optimizer"]["state"].items():
            for k, v in s.items():
                assert torch.equal(got["optimizer"]["state"][i][k], v), (i, k)




def test_n_model_with_bf16_params_matches_replicated(job):
    """FSDP2 over bfloat16-resident parameters with sharded float32 masters:
    both steps' loss parts are the replicated bf16-parameter run's within
    1e-5, and its checkpoint (bfloat16 parameters, the whole masters)
    restores into a one-process bf16-parameter state bit for bit."""
    got, want = (job.ranks[0][k] for k in ("n_model_bf16_params", "bf16_params_zero1_False"))
    for i in range(2):
        for k, v in want["parts"][i].items():
            assert got["parts"][i][k] == pytest.approx(v, rel=1e-5), (i, k)
    st = _one_process_state(job.sd, param_dtype="bfloat16")
    _saved(job.dir, "ck_fsdp_bf16").restore(st)
    for k, p in st.model.named_parameters():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p.detach().float(), got["params"][k]), k
    for a, b in zip(st.optimizer.state_dict()["master"], got["optimizer"]["master"], strict=True):
        assert torch.equal(a, b)
