"""``ccvpe_torch.parallel`` in one process, on the CPU: the layout rules
against the JAX package's ``tree_shardings``/``zero1_state_shardings``, the
harness's and the step's mesh checks with JAX's messages, the end-of-run
barrier's count, ``CVMModel(mesh=)`` against JAX's ``mesh="data"``, and
BatchNorm under a one-rank process group.  The two-rank steps are in
``tests/test_torch_parallel_dist.py``.

The rules are compared on the TINY preset at ``min_size=1000`` (as
``tests/test_train.py`` uses them), from the shapes alone: JAX's state is
``jax.eval_shape`` of ``create_train_state``.
"""

import numpy as np
import jax
import pytest
import torch
import torch.distributed as dist

from ccvpe_tpu import api as JA
from ccvpe_tpu.io.torch_import import import_cvm
from ccvpe_tpu.models import cvm as JC
from ccvpe_tpu.parallel import mesh as JM
from ccvpe_tpu.train import harness as JH
from ccvpe_tpu.train import loop as JLOOP
from ccvpe_torch import api as TA
from ccvpe_torch.data.transforms import normalize_images
from ccvpe_torch.models import cvm as TC
from ccvpe_torch.nn.layers import BatchNorm2d, calibrate_batch_norm_
from ccvpe_torch.parallel import mesh
from ccvpe_torch.train import cli as TCLI
from ccvpe_torch.train import harness as TH
from ccvpe_torch.train import loop as TLOOP
from tests.torch_train_parity import sharded_axes

torch.set_num_threads(2)

MIN_SIZE = 1000


@pytest.fixture(scope="module")
def tiny():
    """The port's TINY model and the shapes of JAX's TINY train state, with
    and without the float32 master."""
    net = TC.CVM(TC.TINY)

    def shapes(master):
        return jax.eval_shape(lambda: JLOOP.create_train_state(
            JC.TINY, jax.random.PRNGKey(0), JLOOP.make_optimizer(f32_master=master)))

    return net, shapes(False), shapes(True)


def _mesh(n_data, n_model):
    return JM.create_mesh(n_data=n_data, n_model=n_model,
                          devices=jax.devices()[:n_data * n_model])


@pytest.mark.parametrize("n_data,n_model", [(4, 2), (2, 4), (1, 8)])
def test_model_axes_are_tree_shardings(tiny, n_data, n_model):
    """``mesh.model_axes`` shards the parameters ``tree_shardings`` shards,
    along the same axis (carried into the port's layout)."""
    net, jstate, _ = tiny
    want = sharded_axes(JM.tree_shardings(jstate, _mesh(n_data, n_model), MIN_SIZE).params,
                        jstate.params)
    got = mesh.model_axes(net, n_model, MIN_SIZE)
    assert sum(ax is not None for ax in want.values()) > 20
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("n_data,n_model", [(8, 1), (4, 2), (2, 1)])
@pytest.mark.parametrize("master", [False, True])
def test_zero1_axes_are_zero1_state_shardings(tiny, n_data, n_model, master):
    """``mesh.zero1_axes`` shards the Adam moments (and the float32 master)
    that ``zero1_state_shardings`` shards over ``data``, skipping an axis
    already model-sharded, as JAX does."""
    net, jstate, jmaster = tiny
    state = jmaster if master else jstate
    sh = JM.zero1_state_shardings(state, _mesh(n_data, n_model), MIN_SIZE)
    inner = sh.opt_state.inner if master else sh.opt_state
    trees = [inner[0].mu, inner[0].nu] + ([sh.opt_state.master] if master else [])
    taken = mesh.model_axes(net, n_model, MIN_SIZE)
    got = mesh.zero1_axes(net, n_data, MIN_SIZE, taken=taken)
    for tree in trees:
        want = sharded_axes(tree, jstate.params, name=JM.DATA_AXIS)
        assert sum(ax is not None for ax in want.values()) > 20
        assert {k: got[k] for k in want} == want


def test_largest_divisible_axis_ties_to_the_lower_axis():
    assert mesh.largest_divisible_axis((3, 3, 64, 64), 2) == 2
    assert mesh.largest_divisible_axis((7, 6), 2) == 1
    assert mesh.largest_divisible_axis((7, 6), 2, skip=1) is None
    assert mesh.largest_divisible_axis((5,), 2) is None


# -- the checks of the harness and the step, with JAX's messages ---------------

def _message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("kw", [dict(n_model=3), dict(n_model=2, batch_size=3),
                                dict(batch_size=8, grad_accum=2)])
def test_trainer_mesh_checks_say_what_jax_says(kw, monkeypatch):
    """An 8-rank world (``mesh.world_size`` patched) against the JAX trainer
    on its 8 virtual devices; the microbatch check against the JAX trainer
    handed the 8-device data mesh (without one it shrinks the mesh)."""
    jkw = dict(kw)
    if "grad_accum" in kw:
        jkw["mesh"] = JM.create_mesh(n_data=8)
    want = _message(lambda: JH.Trainer(JC.NANO, **jkw))
    monkeypatch.setattr(mesh, "world_size", lambda: 8)
    assert _message(lambda: TH.Trainer(TC.NANO, device="cpu", **kw)) == want


def test_step_microbatch_check_says_what_jax_says(monkeypatch):
    """A rank's batch of 2 in a 2-rank world with grad_accum=4: a global
    microbatch of 1 does not divide the mesh (JAX ``loop.py:207-215``)."""
    from tests.torch_train_parity import make_batch, torch_batch

    batch = make_batch(TC.NANO, 4, 0)
    jstep = JLOOP.make_train_step(JC.NANO, JLOOP.make_optimizer(), grad_accum=4, mesh_size=2)
    jstate = jax.eval_shape(lambda: JLOOP.create_train_state(
        JC.NANO, jax.random.PRNGKey(0), JLOOP.make_optimizer()))
    want = _message(lambda: jax.eval_shape(jstep, jstate, batch, jax.random.PRNGKey(0)))
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    state = TLOOP.create_train_state(TC.NANO, device="cpu")
    local = {k: v[:2] for k, v in torch_batch(batch).items()}
    got = _message(lambda: TLOOP.make_train_step(TC.NANO, grad_accum=4)(state, local))
    assert got == want
    assert state.step == 0


# -- the end-of-run barrier -------------------------------------------------------

def test_run_main_finalizes_once_after_its_body():
    before = mesh.finalize_count()
    assert TCLI.run_main(lambda argv: argv, ["x"]) == ["x"]
    assert mesh.finalize_count() == before + 1
    with pytest.raises(RuntimeError, match="boom"):
        TCLI.run_main(lambda argv: (_ for _ in ()).throw(RuntimeError("boom")))
    assert mesh.finalize_count() == before + 1


def test_eval_runner_finalize_lockstep_on_failure():
    """A config whose CLI main() dies before its barrier: the runner catches
    up the count, as JAX's does (``tests/test_cli.py``)."""
    from ccvpe_torch.eval import run_config

    before = mesh.finalize_count()
    rec = run_config({"id": 99, "name": "boom", "module": "tests.fake_failing_cli", "argv": []})
    assert rec["status"] == "failed"
    assert "boom" in rec["metrics"]["error"]
    assert mesh.finalize_count() == before + 1


def test_without_a_process_group_nothing_is_distributed():
    assert (mesh.world_size(), mesh.rank(), mesh.is_distributed()) == (1, 0, False)
    assert mesh.maybe_init_distributed() is False
    x = torch.arange(4.0)
    assert mesh.all_reduce_sum(x) is x
    assert mesh.shard_batch(x) is x
    np.testing.assert_array_equal(mesh.fetch_global({"a": x})["a"], [0, 1, 2, 3])


@pytest.mark.parametrize("index", [0, 1, 2])
def test_shard_batch_is_a_contiguous_slice(index):
    b = {"x": np.arange(12).reshape(6, 2), "y": (torch.arange(6),)}
    got = mesh.shard_batch(b, index, 3)
    np.testing.assert_array_equal(got["x"], np.arange(12).reshape(6, 2)[2 * index:2 * index + 2])
    assert got["y"][0].tolist() == [2 * index, 2 * index + 1]
    with pytest.raises(ValueError, match="divisible by the 4-device mesh"):
        mesh.shard_batch(b, 0, 4)


# -- a one-rank process group ---------------------------------------------------

@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_with_one_rank_is_the_local_one(tmp_path, dtype):
    """Under a process group of one rank BatchNorm takes its one-device
    path: output, gradients and running statistics bit for bit."""
    rng = np.random.default_rng(1)
    x0 = torch.from_numpy(rng.standard_normal((4, 6, 5, 7)).astype(np.float32)).to(dtype)

    def run():
        bn = BatchNorm2d(6, eps=1e-3, momentum=0.01).train()
        x = x0.clone().requires_grad_(True)
        y = bn(x)
        y.float().square().sum().backward()
        return y, x.grad, bn.weight.grad, bn.running_mean, bn.running_var

    alone = run()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        grouped = run()
    finally:
        dist.destroy_process_group()
    for a, b in zip(alone, grouped):
        assert torch.equal(a, b)


def test_create_mesh_on_one_rank(one_rank):
    m = mesh.create_mesh()
    assert (tuple(m.mesh.shape), m.mesh_dim_names) == ((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match=r"n_model=2 must be a positive divisor of the "
                                         r"device count \(1\)"):
        mesh.create_mesh(n_model=2)


# -- serving on a mesh --------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """The port's seeded NANO weights with calibrated BN statistics, as a
    one-device model, a two-replica CPU mesh model, and JAX's model on its
    8-device ``mesh="data"``."""
    net = TC.CVM(TC.NANO).init_weights_(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(50)
    g = normalize_images(torch.from_numpy(rng.integers(0, 256, (4, 64, 128, 3), dtype=np.uint8)))
    s = normalize_images(torch.from_numpy(rng.integers(0, 256, (4, 128, 128, 3), dtype=np.uint8)))
    calibrate_batch_norm_(net, lambda: net(g, s))
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    params, state = import_cvm({k: v.numpy() for k, v in sd.items()})

    def port(mesh_=None):
        n = TC.CVM(TC.NANO)
        n.load_state_dict(sd)
        return TA.CVMModel(TC.NANO, n.eval(), torch.device("cpu"), matching_impl="plain",
                           mesh=mesh_)

    return port(), port(["cpu", "cpu"]), JA.CVMModel(JC.NANO, params, state, mesh="data")


def _images(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (b, *TC.NANO.grd_hw, 3), dtype=np.uint8),
            rng.integers(0, 255, (b, *TC.NANO.sat_hw, 3), dtype=np.uint8))


def _angle_diff(a, b):
    return abs((a - b + 180.0) % 360.0 - 180.0)


@pytest.mark.parametrize("kw", [{}, {"ori_noise": 36.0}, {"fov": 180.0}])
def test_mesh_predict_batch_matches_jax_mesh(served, kw):
    """A batch of 8 split over two replicas, against JAX's 8-device
    ``mesh="data"`` and the port's one-device model: the same pixel per
    sample, probability 1e-4 relative (JAX's own mesh test), heading 0.1
    degree; the heatmaps within 1e-7 of the one-device model's."""
    single, meshed, jmodel = served
    assert len(meshed.replicas) == 2 and jmodel.mesh.size == 8
    grd, sat = _images(8, 8)
    got = meshed.predict_batch(grd, sat, return_heatmap=True, **kw)
    for want in (jmodel.predict_batch(grd, sat, **kw), single.predict_batch(grd, sat, **kw)):
        for g, w in zip(got, want, strict=True):
            assert (g.row, g.col) == (w.row, w.col)
            np.testing.assert_allclose(g.probability, w.probability, rtol=1e-4)
            assert _angle_diff(g.orientation_deg, w.orientation_deg) < 0.1
    for g, w in zip(got, single.predict_batch(grd, sat, return_heatmap=True, **kw)):
        np.testing.assert_allclose(g.heatmap, w.heatmap, atol=1e-7, rtol=0)


def test_mesh_batch_of_one_takes_the_first_replica(served):
    """A batch the replica count does not divide runs on the first replica
    (JAX falls back to replicated placement): the one-device answer."""
    single, meshed, jmodel = served
    grd, sat = _images(1, 9)
    calls = []
    second = meshed.replicas[1]
    second.forward_readout = lambda *a, **k: calls.append(1)
    try:
        got = meshed.predict(grd[0], sat[0])
    finally:
        del second.forward_readout
    want = single.predict(grd[0], sat[0])
    assert not calls
    assert (got.row, got.col, got.probability) == (want.row, want.col, want.probability)
    jwant = jmodel.predict(grd[0], sat[0])
    assert (got.row, got.col) == (jwant.row, jwant.col)


def test_mesh_replicas_are_distinct_copies(served):
    _, meshed, _ = served
    a, b = (r.net for r in meshed.replicas)
    assert a is meshed.net and a is not b
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w) and v.data_ptr() != w.data_ptr(), k


def test_mesh_quantize_int8_quantizes_every_replica_the_same():
    net = TA.load_model(None, preset="NANO", seed=2, device="cpu", matching_impl="plain",
                        mesh=["cpu", "cpu"])
    net.quantize_int8()
    sds = [r.net.state_dict() for r in net.replicas]
    assert sds[0].keys() == sds[1].keys() and any(k.endswith("q_sx") for k in sds[0])
    for k in sds[0]:
        assert torch.equal(sds[0][k], sds[1][k]), k
    grd, sat = _images(2, 3)
    split = net.predict_batch(grd, sat)
    whole = [net.predict(g, s) for g, s in zip(grd, sat)]
    for a, b in zip(split, whole):
        assert (a.row, a.col) == (b.row, b.col)


def test_mesh_data_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: mesh='data' is usable")
    with pytest.raises(RuntimeError, match="one replica per CUDA device"):
        TA.load_model(None, preset="NANO", mesh="data")


def test_cli_parallel_flags_default_to_one_device():
    from ccvpe_torch import train_VIGOR as PV

    args = PV.parse_args(["--model_preset", "NANO"])
    assert (args.zero1, args.n_model) == (False, 1)
