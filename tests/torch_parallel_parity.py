"""The set-up shared by the two-rank tests (``tests/test_torch_parallel_dist.py``,
``tests/test_torch_parallel_layouts.py``): the inputs of the job
(``tests/torch_parallel_job.py``), JAX's steps on 2-device meshes while the
ranks run, and the check of a rank's step against JAX's; the tolerances are
stated in ``tests/test_torch_parallel_dist.py``."""

import os
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

from ccvpe_tpu.nn import efficientnet as JE
from ccvpe_tpu.parallel import mesh as JM
from ccvpe_tpu.train import loop as JLOOP
from ccvpe_torch.io.from_jax import grads_from_jax, state_dict_from_jax
from ccvpe_torch.models import cvm as TC
from tests import torch_parallel_job as JOB
from tests.torch_train_parity import B1, JAX_CONFIGS, RTOL, make_batch, setup, torch_batch

# the layout rules' threshold of JAX's own mesh tests, so NANO has tensors to shard
MIN_SIZE = 1000


def eval_batches():
    return [{k: torch.from_numpy(b[k]) for k in ("grd", "sat", "gt", "orientation")}
            for b in (make_batch(TC.NANO, 8, s) for s in (11, 12))]


def bn_inputs():
    rng = np.random.default_rng(3)
    f = np.float32
    return {"x": torch.from_numpy((rng.standard_normal((8, 6, 5, 7)) * 2 + 1).astype(f)),
            "dy": torch.from_numpy(rng.standard_normal((8, 6, 5, 7)).astype(f)),
            "scale": torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(f)),
            "bias": torch.from_numpy(rng.standard_normal(6).astype(f)),
            "mean": torch.from_numpy(rng.standard_normal(6).astype(f)),
            "var": torch.from_numpy(rng.uniform(0.5, 2, 6).astype(f))}


def jax_refs(jstate, batch, names) -> dict:
    """JAX's steps on 2-device meshes, those of ``names``: data (2 steps),
    grad_accum=2, ZeRO-1 (2 steps) and the 1x2 hybrid data x model mesh
    (2 steps)."""
    opt = JLOOP.make_optimizer(1e-4)
    devices = jax.devices()[:2]
    data = JM.create_mesh(n_data=2, devices=devices)
    hybrid = JM.create_mesh(n_data=1, n_model=2, devices=devices)
    runs = {"ddp": (data, None, 1, 2),
            "zero1": (data, JM.zero1_state_shardings(jstate, data, MIN_SIZE), 1, 2),
            "accum": (data, None, 2, 1),
            "n_model": (hybrid, JM.tree_shardings(jstate, hybrid, MIN_SIZE), 1, 2)}
    refs = {}
    for name in names:
        m, shardings, accum, steps = runs[name]
        step = JLOOP.make_train_step(JAX_CONFIGS["NANO"], opt, matching_impl="einsum",
                                     grad_accum=accum, mesh_size=m.size)
        compiled = JLOOP.compile_train_step(step, m, donate=False, state_shardings=shardings)
        s = (JM.replicate(m, jstate) if shardings is None
             else jax.tree_util.tree_map(jax.device_put, jstate, shardings))
        b = JM.shard_batch(m, batch)
        parts = []
        for i in range(steps):
            s, p = compiled(s, b, jax.random.PRNGKey(i))
            parts.append({k: float(v) for k, v in jax.device_get(p).items()})
            if i == 0:
                first = jax.device_get(s)
        refs[name] = SimpleNamespace(first=first, parts=parts, shardings=shardings)
    return refs


def run_job(tmp_path_factory, group: str, names) -> SimpleNamespace:
    """The job of ``group`` on one NANO start and one global batch of 8,
    and JAX's steps ``names`` from the same start, taken while it runs."""
    d = str(tmp_path_factory.mktemp(f"parallel_{group}"))
    state, jstate, batch = setup("NANO", 8)
    sd = {k: v.clone() for k, v in state.model.state_dict().items()}
    evals = eval_batches()
    torch.save({"model": sd, "batch": torch_batch(batch), "eval": evals, "bn": bn_inputs()},
               os.path.join(d, "inputs.pt"))
    procs = JOB.launch(d, group)
    try:
        # the JAX step splits its key per microbatch, so it gets one; its
        # drop-connect is turned off by the rate instead
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JE, "DROP_CONNECT_RATE", 0.0)
            refs = jax_refs(jstate, batch, names)
    finally:
        ranks = JOB.results(d, procs)
    return SimpleNamespace(dir=d, ranks=ranks, refs=refs, sd=sd, evals=evals, jstate=jstate)


def check_against_jax(res, ref):
    """A rank's steps against JAX's: every step's loss parts, the first
    step's gradients and BN statistics."""
    jparts = ref.parts[0]
    for i, want in enumerate(ref.parts):
        for k in want:
            np.testing.assert_allclose(res["parts"][i][k], want[k], rtol=RTOL,
                                       err_msg=f"step {i + 1} {k}")
    grad_norm = jparts["grad_norm"]
    jgrads = grads_from_jax(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1 - B1), ref.first.opt_state[0].mu))
    assert set(res["grads"]) == set(jgrads)
    for k, want in jgrads.items():
        err = (res["grads"][k] - want).norm().item()
        lim = 1e-3 * want.norm().item() + 1e-6 * grad_norm
        assert err <= lim, (k, err, lim)
    want = state_dict_from_jax(ref.first.params, ref.first.bn_state)
    assert res["bn"]
    for k, v in res["bn"].items():
        torch.testing.assert_close(v, want[k], atol=1e-5, rtol=1e-5, msg=k)


