"""The two-rank job of ``tests/test_torch_parallel_dist.py``: one process per
rank on the CPU, joined over gloo through a ``FileStore`` in the job's
directory (no port), one thread each.

    python -m tests.torch_parallel_job DIR RANK WORLD GROUP

``DIR/inputs.pt`` holds the NANO weights (``model``), a global train batch
(``batch``), two global eval batches (``eval``) and the BatchNorm inputs
(``bn``), all made by the test.  ``GROUP`` picks the cases: ``base`` (the
mesh helpers, DDP, ``grad_accum=2``, BatchNorm, evaluation;
``tests/test_torch_parallel_dist.py``) or ``layouts`` (DDP, ZeRO-1 with
and without bfloat16 parameters, FSDP2, checkpoints across them;
``tests/test_torch_parallel_layouts.py``).  Every case runs once and its
results go to ``DIR/rank{RANK}.pt``; the tests' many small checks read
them.  Rank 0 also writes the checkpoints under ``DIR/ck_*``.  No JAX
here: the tests hold these results against the JAX mesh.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

STEPS = 2


def _full(t: torch.Tensor) -> torch.Tensor:
    from ccvpe_torch.parallel.distribute import full_tensor

    return full_tensor(t).detach().float().clone()


def _grads(state) -> dict:
    return {k: _full(p.grad) for k, p in state.model.named_parameters() if p.grad is not None}


def _params(state) -> dict:
    return {k: _full(p) for k, p in state.model.named_parameters()}


def _bn(state) -> dict:
    return {k: v.detach().clone() for k, v in state.model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def _parts(parts) -> dict:
    return {k: float(v) for k, v in parts.items()}


def _steps(state, batch, n=STEPS, **kw) -> dict:
    """``n`` steps; the first's parts, gradients and BN statistics, every
    step's parts, and the parameters after the last."""
    from ccvpe_torch.models import cvm as TC
    from ccvpe_torch.train import loop as TLOOP

    step = TLOOP.make_train_step(TC.NANO, matching_impl="plain", **kw)
    res = {"parts": [_parts(step(state, batch))], "grads": _grads(state), "bn": _bn(state)}
    for _ in range(n - 1):
        res["parts"].append(_parts(step(state, batch)))
    res["params"] = _params(state)
    return res


def _bn_case(inp: dict, dtype: torch.dtype) -> dict:
    """A train-mode ``nn.layers.BatchNorm2d`` on this rank's rows of the
    global input: output, input gradient of ``sum(y * dy)``, this rank's
    parameter gradients and the new running statistics."""
    from ccvpe_torch.nn.layers import batch_norm
    from ccvpe_torch.parallel import mesh

    x, dy = mesh.shard_batch((inp["x"], inp["dy"]))
    bn = batch_norm(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(inp["scale"])
        bn.bias.copy_(inp["bias"])
        bn.running_mean.copy_(inp["mean"])
        bn.running_var.copy_(inp["var"])
    x = x.to(dtype).contiguous(memory_format=torch.channels_last).requires_grad_(True)
    y = bn(x)
    (y.float() * dy).sum().backward()
    return {"y": y.detach().float(), "dx": x.grad.float(), "dscale": bn.weight.grad.clone(),
            "dbias": bn.bias.grad.clone(), "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone()}


def _eval_case(model_sd: dict, batches: list, device_readout: bool) -> dict:
    from ccvpe_torch.models import cvm as TC
    from ccvpe_torch.parallel import mesh
    from ccvpe_torch.train import loop as TLOOP
    from ccvpe_torch.train.harness import Trainer

    tr = Trainer(TC.NANO, device="cpu", batch_size=8, matching_impl="plain")
    tr.state = TLOOP.train_state_from_torch(model_sd, TC.NANO, device="cpu")
    local = [mesh.shard_batch(b) for b in batches]
    summary = tr.evaluate(local, dict, meter_per_pixel=0.2, device_readout=device_readout)
    summary.pop("pairs_per_sec")
    return summary


def main(d: str, rank: int, world: int, group: str) -> None:
    torch.set_num_threads(1)
    os.environ["CCVPE_PLATFORM"] = "cpu"
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "store"), world),
                            rank=rank, world_size=world)
    from ccvpe_torch.io.checkpoint import CheckpointManager
    from ccvpe_torch.models import cvm as TC
    from ccvpe_torch.parallel import mesh
    from ccvpe_torch.train import loop as TLOOP

    mesh.MIN_SIZE = 1000   # the layout rules' threshold of JAX's own tests
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    sd, local = inp["model"], mesh.shard_batch(inp["batch"])
    out: dict = {"rank": rank, "world": mesh.world_size()}

    def state(**kw):
        return TLOOP.train_state_from_torch(sd, TC.NANO, device="cpu", **kw)

    st = state()
    out["ddp"] = _steps(st, local)
    out["ddp"]["optimizer"] = st.optimizer.state_dict()
    CheckpointManager(os.path.join(d, "ck_ddp")).save(st.step, st)
    if group == "base":
        _base(out, d, inp, local, state)
    else:
        _layouts(out, d, local, state)
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _base(out, d, inp, local, state) -> None:
    from ccvpe_torch.parallel import mesh

    # the helpers of parallel.mesh
    out["mesh_shapes"] = {f"{a}x{b}": tuple(mesh.create_mesh(a, b).mesh.shape)
                          for a, b in ((2, 1), (1, 2))}
    out["mesh_default"] = mesh.create_mesh().mesh_dim_names
    rank = mesh.rank()
    out["fetch_global"] = mesh.fetch_global({"r": torch.full((2,), float(rank)),
                                             "t": (torch.arange(3) + 10 * rank,)})
    before = mesh.finalize_count()
    mesh.finalize_run("job")
    out["finalize_counted"] = mesh.finalize_count() - before
    out["accum"] = _steps(state(), local, n=1, grad_accum=2)
    out["bn_float32"] = _bn_case(inp["bn"], torch.float32)
    out["bn_bfloat16"] = _bn_case(inp["bn"], torch.bfloat16)
    out["eval_readout"] = _eval_case(inp["model"], inp["eval"], True)
    out["eval_heatmap"] = _eval_case(inp["model"], inp["eval"], False)


def _layouts(out, d, local, state) -> None:
    from ccvpe_torch.io.checkpoint import CheckpointManager
    from ccvpe_torch.parallel.distribute import full_state

    st = state(zero1=True)
    out["zero1_layout"] = {k: ax for k, ax in zip(
        [k for k, _ in st.model.named_parameters()], st.optimizer.axes)}
    out["zero1_slots"] = {k: tuple(s.shape) for (k, _), s in zip(
        st.model.named_parameters(), st.optimizer.slots)}
    out["zero1"] = _steps(st, local)
    out["zero1"]["optimizer"] = st.optimizer.state_dict()
    CheckpointManager(os.path.join(d, "ck_zero1")).save(st.step, st)

    # a replicated run's checkpoint restored into a ZeRO-1 layout
    st = state(zero1=True)
    CheckpointManager(os.path.join(d, "ck_ddp")).restore(st)
    out["ddp_into_zero1"] = {"params": _params(st), "optimizer": st.optimizer.state_dict(),
                             "step": st.step}

    for zero1 in (False, True):
        st = state(param_dtype="bfloat16", zero1=zero1)
        res = _steps(st, local)
        res["optimizer"] = st.optimizer.state_dict()
        out[f"bf16_params_zero1_{zero1}"] = res

    st = state(n_model=2, param_dtype="bfloat16")
    out["n_model_bf16_params"] = _steps(st, local)
    out["n_model_bf16_params"]["optimizer"] = full_state(st.optimizer.state_dict())
    CheckpointManager(os.path.join(d, "ck_fsdp_bf16")).save(st.step, st)

    st = state(n_model=2)
    out["n_model"] = _steps(st, local)
    CheckpointManager(os.path.join(d, "ck_fsdp")).save(st.step, st)
    # a replicated run's checkpoint restored into the FSDP2 layout
    st = state(n_model=2)
    CheckpointManager(os.path.join(d, "ck_ddp")).restore(st)
    out["ddp_into_fsdp"] = {"params": _params(st), "step": st.step,
                            "optimizer": full_state(st.optimizer.state_dict())}


def launch(d: str, group: str):
    """Start the two ranks of ``group`` on the inputs in ``d`` (the caller
    waits on the processes)."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "CCVPE_PLATFORM": "cpu", "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_job", d, str(r), "2",
                              group], cwd=repo, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(2)]


def results(d: str, procs) -> list[dict]:
    """Wait for the ranks; their results, rank by rank."""
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n==== rank ====\n".join(logs)
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False) for r in range(2)]


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
