"""The port's multi-process training on the CPU, held to the JAX mesh: the
mesh helpers, DDP, ``grad_accum=2``, global BatchNorm and evaluation (the
layouts -- ZeRO-1, FSDP2 and checkpoints across them -- are in
``tests/test_torch_parallel_layouts.py``).

One module-scoped job (``tests/torch_parallel_job.py``, group ``base``)
runs two gloo ranks (separate processes, a ``FileStore``, one thread each)
from one NANO start (the port's seeded weights with calibrated BN
statistics, carried to JAX by ``import_cvm``, as
``tests/torch_train_parity.py`` does) and one global batch of 8, 4 per
rank.  While the ranks run, the test takes the same steps through JAX on a
2-device CPU mesh (``create_mesh(n_data=2, ...)``, ``compile_train_step``;
``tests/torch_parallel_parity.py``); each small test below checks one of
the job's results.  Drop-connect is off on both sides.

Tolerances, as the port's train-step tests state them: loss parts rtol
1e-5; each gradient ||port - jax|| <= 1e-3 ||jax|| + 1e-6 grad_norm (the
gradients read after DDP's reduction); BN running statistics 1e-5.  The
eval summaries at ``tests/test_multiprocess.py``'s tolerances (rtol 1e-3,
atol 1e-4).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ccvpe_tpu.nn.layers import bn_apply
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.train import loop as TLOOP
from ccvpe_torch.train.harness import Trainer
from tests.torch_parallel_parity import bn_inputs, check_against_jax, run_job

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    return run_job(tmp_path_factory, "base", ("ddp", "accum"))


# -- the mesh helpers ---------------------------------------------------------

def test_both_ranks_ran_in_one_group(job):
    assert [(r["rank"], r["world"]) for r in job.ranks] == [(0, 2), (1, 2)]


def test_create_mesh_shapes(job):
    for r in job.ranks:
        assert r["mesh_shapes"] == {"2x1": (2, 1), "1x2": (1, 2)}
        assert r["mesh_default"] == ("data", "model")


def test_fetch_global_joins_in_rank_order_on_every_rank(job):
    for r in job.ranks:
        np.testing.assert_array_equal(r["fetch_global"]["r"], [0, 0, 1, 1])
        np.testing.assert_array_equal(r["fetch_global"]["t"][0], [0, 1, 2, 10, 11, 12])


def test_finalize_run_counts_once(job):
    assert [r["finalize_counted"] for r in job.ranks] == [1, 1]


# -- the steps against the JAX mesh -------------------------------------------

@pytest.mark.parametrize("case", ["ddp", "accum"])
@pytest.mark.parametrize("rank", [0, 1])
def test_step_matches_the_jax_mesh(job, case, rank):
    """Loss parts of every step, the first step's gradients (after DDP's
    reduction) and global BN statistics, on each rank; ``accum``: the
    strided microbatches of each rank, normalised over both ranks, are the
    global batch's."""
    check_against_jax(job.ranks[rank][case], job.refs[case])


def test_ddp_ranks_hold_the_same_parameters(job):
    a, b = (r["ddp"]["params"] for r in job.ranks)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- global BatchNorm ----------------------------------------------------------

def _bn_apply_joined(dtype):
    """``bn_apply`` in train mode on the joined batch: y, the gradients of
    sum(y * dy) by x, scale and bias, and the new running statistics, as
    float32 NCHW tensors."""
    inp = bn_inputs()
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    x = jnp.asarray(inp["x"].numpy().transpose(0, 2, 3, 1)).astype(jdt)
    dy = jnp.asarray(inp["dy"].numpy().transpose(0, 2, 3, 1))
    params = {"scale": jnp.asarray(inp["scale"].numpy()), "bias": jnp.asarray(inp["bias"].numpy())}
    state = {"mean": jnp.asarray(inp["mean"].numpy()), "var": jnp.asarray(inp["var"].numpy())}

    def f(params, x):
        y, new = bn_apply(params, state, x, train=True)
        return (y.astype(jnp.float32) * dy).sum(), (y, new)

    (gp, gx), (y, new) = jax.grad(f, argnums=(0, 1), has_aux=True)(params, x)

    def t(a):
        a = np.asarray(jnp.asarray(a).astype(jnp.float32))
        return torch.from_numpy(a.transpose(0, 3, 1, 2).copy() if a.ndim == 4 else a)

    return {"y": t(y), "dx": t(gx), "dscale": t(gp["scale"]), "dbias": t(gp["bias"]),
            "mean": t(new["mean"]), "var": t(new["var"])}


def _bn_joined(res) -> dict:
    """The ranks' BN results as one batch's: rows joined, parameter
    gradients summed, running statistics (equal on both ranks) of rank 0."""
    a, b = res
    return {"y": torch.cat([a["y"], b["y"]]), "dx": torch.cat([a["dx"], b["dx"]]),
            "dscale": a["dscale"] + b["dscale"], "dbias": a["dbias"] + b["dbias"],
            "mean": a["mean"], "var": a["var"]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_batch_norm_against_bn_apply(job, dtype):
    """Train-mode BatchNorm on each rank's 4 rows against ``bn_apply`` on the
    joined 8: the output, the input gradient of sum(y * dy) (through the
    all-reduces of the backward), the parameter gradients summed over the
    ranks, and the running statistics (the unbiased variance over the
    global count; equal on both ranks).  float32 at 1e-5; bfloat16 at the
    bar of ``tests/torch_bf16_bar.py`` (within 1.5x JAX's own bf16-vs-f32
    distance of JAX's bf16 result, plus one bfloat16 rounding of the
    largest value, as ``tests/test_torch_bf16_step.py`` allows)."""
    res = [r[f"bn_{dtype}"] for r in job.ranks]
    for k in ("mean", "var"):
        assert torch.equal(res[0][k], res[1][k]), k
    got, want = _bn_joined(res), _bn_apply_joined(dtype)
    if dtype == "float32":
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-5, msg=k)
        return
    from tests.torch_bf16_bar import BF16_RES, assert_bar

    want32 = _bn_apply_joined("float32")
    for k, v in want.items():
        # plus one bfloat16 rounding of the largest value: the global mean
        # is an all-reduced sum over the count, rounded once to bfloat16,
        # where jnp.mean rounds its own, so an output may sit one ulp over
        assert_bar(k, got[k], v, want32[k], slack=BF16_RES * float(v.abs().max()))


# -- evaluation ----------------------------------------------------------------

@pytest.mark.parametrize("path", ["eval_readout", "eval_heatmap"])
def test_eval_summary_is_global_on_both_ranks(job, path):
    """Each rank evaluates its 4 rows of every batch; the gathered readouts
    give both ranks the one-process summary over all 16 samples."""
    tr = Trainer(TC.NANO, device="cpu", batch_size=8, matching_impl="plain")
    tr.state = TLOOP.train_state_from_torch(job.sd, TC.NANO, device="cpu")
    want = tr.evaluate(job.evals, dict, meter_per_pixel=0.2,
                       device_readout=path == "eval_readout")
    want.pop("pairs_per_sec")
    a, b = (r[path] for r in job.ranks)
    assert a == b
    assert set(a) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(a[k], v, rtol=1e-3, atol=1e-4, err_msg=k)
