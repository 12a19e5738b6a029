"""The train step's CUDA graphs (``train.loop.GraphedStep``) on the card:
graphed steps against the same steps run eagerly from the same seeded
state, with drop-connect on, bit for bit (the loss parts and
``grad_norm``, every gradient, parameter and Adam tensor, BN's running
statistics and ``num_batches_tracked``, the drop-connect generator's
state); the parts a caller keeps; a capture again after
``optimizer.load_state_dict`` and after a checkpoint resumed; a set per
batch shape within ``MAX_STEP_GRAPH_SETS``; the VIGOR and KITTI presets;
``STEP_COUNTS`` and the kernels' launch counters per step.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without them.
This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_train_graphs.py

The eager twin runs the graphed route's own eager code (Adam
``capturable``, as its warm-up), so both sides launch the same kernels on
the same shapes, cuDNN set deterministic.
"""

import copy
import warnings

import pytest
import torch

from ccvpe_torch.data.transforms import normalize_images
from ccvpe_torch.io.checkpoint import CheckpointManager
from ccvpe_torch.models import cvm
from ccvpe_torch.nn.layers import calibrate_batch_norm_
from ccvpe_torch.ops import conv_cuda, matching_cuda
from ccvpe_torch.ops import gt as GT
from ccvpe_torch.train import loop as TLOOP

pytestmark = pytest.mark.cuda

BATCH = 2


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


def _batch(cfg, b, seed, dev):
    """Seeded uint8 images, normalised on the card, and their factored GT."""
    gen = torch.Generator().manual_seed(seed)
    h, w = cfg.sat_hw
    grd = torch.randint(0, 256, (b, *cfg.grd_hw, 3), generator=gen, dtype=torch.uint8)
    sat = torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8)
    off = ((torch.rand((2, b), generator=gen) * 2 - 1) * w / 4).to(dev)
    angle = (torch.rand((b,), generator=gen) * 360).to(dev)
    gt, weights, omap = GT.synthesize_batch_factored(off[0], off[1], angle, height=h, width=w,
                                                     bins=cfg.bins)
    return {"grd": normalize_images(grd.to(dev)), "sat": normalize_images(sat.to(dev)),
            "gt": gt, "bin_weights": weights, "orientation": omap}


def _pair(cfg, dev, seed=0):
    """A seeded train state with BN statistics from one seeded batch, and
    its eager twin."""
    state = TLOOP.create_train_state(cfg, seed=seed, device=dev)
    calib = _batch(cfg, 2, seed + 100, dev)
    net = state.model
    calibrate_batch_norm_(net, lambda: net(calib["grd"], calib["sat"]))
    net.train()
    twin = copy.deepcopy(state)
    TLOOP._capturable(twin.optimizer)
    return state, twin


class _Runs:
    """One step function run graphed on a state and eagerly on its twin,
    each with its own drop-connect generator from one seed, held equal
    after every step."""

    def __init__(self, cfg, dev, monkeypatch, seed=0):
        self.state, self.twin = _pair(cfg, dev, seed)
        self.step = TLOOP.make_train_step(cfg)
        self.eager_step = TLOOP.make_train_step(cfg)
        self.gen = torch.Generator(device=dev).manual_seed(7)
        self.twin_gen = torch.Generator(device=dev).manual_seed(7)
        self.monkeypatch = monkeypatch
        self.kept = []   # (parts, their values when returned)

    def __call__(self, batch, want: str, tag: str) -> dict:
        """One step on both sides; ``want``: how the graphed one ran."""
        before_gen = self.gen.get_state()
        counts, passes = TLOOP.step_counts(), conv_cuda.pass_counts()
        launches = matching_cuda.launch_counts()
        with warnings.catch_warnings():
            # an autograd node kept from a capture would make an eager step
            # synchronise its streams
            warnings.filterwarnings("error", message="The AccumulateGrad node's stream")
            parts = self.step(self.state, batch, self.gen)
        torch.cuda.synchronize()
        after = TLOOP.step_counts()
        assert {k: after[k] - counts[k] for k in after} == {
            k: int(k == want) for k in after}, tag
        got_passes = _delta(passes, conv_cuda.pass_counts())
        got_launches = _delta(launches, matching_cuda.launch_counts())
        passes, launches = conv_cuda.pass_counts(), matching_cuda.launch_counts()
        with self.monkeypatch.context() as m:
            m.setattr(TLOOP, "takes_graphs", lambda *a: False)
            want_parts = self.eager_step(self.twin, batch, self.twin_gen)
        torch.cuda.synchronize()
        # the replay's kernels counted as the eager step's (ops.graphs tallies)
        assert got_passes == _delta(passes, conv_cuda.pass_counts()), tag
        assert got_launches == _delta(launches, matching_cuda.launch_counts()), tag
        assert got_passes["wgrad"] > 0, tag
        # drop-connect drew, as far on both sides
        assert not torch.equal(before_gen, self.gen.get_state()), tag
        assert torch.equal(self.gen.get_state(), self.twin_gen.get_state()), tag
        assert list(parts) == list(want_parts), tag
        for k, v in want_parts.items():
            assert torch.equal(parts[k], v), (tag, k, parts[k].item(), v.item())
        _assert_same_state(self.state, self.twin, tag)
        self.kept.append((parts, {k: v.item() for k, v in parts.items()}))
        return parts

    def check_kept(self):
        """Each step's parts still read what they read when returned."""
        for i, (parts, values) in enumerate(self.kept):
            assert {k: v.item() for k, v in parts.items()} == values, i


def _delta(before, after):
    return {k: after[k] - before[k] for k in after}


def _assert_same_state(got, want, tag):
    assert got.step == want.step, tag
    theirs = dict(want.model.named_parameters())
    n_grads = 0
    for k, p in got.model.named_parameters():
        q = theirs[k]
        assert torch.equal(p, q), (tag, k)
        assert (p.grad is None) == (q.grad is None), (tag, "grad", k)
        if q.grad is not None:
            assert torch.equal(p.grad, q.grad), (tag, "grad", k)
            n_grads += 1
        sp, sq = got.optimizer.state.get(p, {}), want.optimizer.state.get(q, {})
        assert sp.keys() == sq.keys(), (tag, k)
        for name in sq:
            assert torch.equal(sp[name], sq[name]), (tag, name, k)
    assert n_grads > 0, tag
    theirs = dict(want.model.named_buffers())
    for k, b in got.model.named_buffers():
        assert torch.equal(b, theirs[k]), (tag, k)


def test_graphed_steps_equal_eager_steps(dev, monkeypatch):
    runs = _Runs(cvm.TINY, dev, monkeypatch)
    pool = [_batch(cvm.TINY, BATCH, seed, dev) for seed in range(3)]
    for i, want in enumerate(["eager", "captured"] + ["replayed"] * 4):
        runs(pool[i % len(pool)], want, f"step {i}")
    runs.check_kept()
    # the parts of distinct batches differ: the static inputs took each batch
    losses = [values["loss"] for _, values in runs.kept]
    assert len(set(losses[:3])) == 3


def _save_and_reload(how, tmp_path):
    """Bring a state back to where it was: Adam's state loaded anew, or a
    checkpoint resumed (``io.checkpoint``)."""
    if how == "load_state_dict":
        def save(state):
            return copy.deepcopy(state.optimizer.state_dict())

        def load(state, saved):
            state.optimizer.load_state_dict(saved)
    else:
        def save(state):
            ckpt = CheckpointManager(str(tmp_path / str(id(state))))
            ckpt.save(state.step, state)
            return ckpt

        def load(state, ckpt):
            ckpt.restore(state)
    return save, load


@pytest.mark.parametrize("how", ["load_state_dict", "checkpoint"])
def test_a_reload_after_capture_captures_again(dev, monkeypatch, tmp_path, how):
    save, load = _save_and_reload(how, tmp_path)
    runs = _Runs(cvm.TINY, dev, monkeypatch, seed=1)
    pool = [_batch(cvm.TINY, BATCH, seed, dev) for seed in range(10, 13)]
    for i, want in enumerate(["eager", "captured", "replayed"]):
        runs(pool[i % 3], want, f"step {i}")
    saved = save(runs.state), save(runs.twin)
    runs(pool[0], "replayed", "step 3")
    load(runs.state, saved[0])
    load(runs.twin, saved[1])
    # Adam's tensors lie elsewhere now: no replay of the old set
    for i, want in enumerate(["eager", "captured", "replayed", "replayed"]):
        runs(pool[(i + 1) % 3], want, f"reloaded step {i}")
    runs.check_kept()


def test_each_batch_shape_captures_its_own_set_within_the_bound(dev, monkeypatch):
    assert TLOOP.MAX_STEP_GRAPH_SETS == 2
    runs = _Runs(cvm.TINY, dev, monkeypatch, seed=2)
    batches = {b: _batch(cvm.TINY, b, 20 + b, dev) for b in (2, 3, 4)}
    for b in (2, 3):
        for want in ("eager", "captured", "replayed"):
            runs(batches[b], want, f"batch {b} {want}")
    runs(batches[2], "replayed", "batch 2 kept")
    runs(batches[3], "replayed", "batch 3 kept")
    runs(batches[4], "eager", "batch 4 warm-up")
    runs(batches[4], "captured", "batch 4 drops batch 2's set")
    runs(batches[3], "replayed", "batch 3 kept")
    runs(batches[2], "eager", "batch 2 dropped")
    runs.check_kept()


@pytest.mark.parametrize("preset", ["VIGOR", "KITTI"])
def test_presets_take_the_graphed_path(dev, monkeypatch, preset):
    cfg = cvm.PRESETS[preset]
    runs = _Runs(cfg, dev, monkeypatch, seed=3)
    pool = [_batch(cfg, BATCH, seed, dev) for seed in range(30, 32)]
    for i, want in enumerate(["eager", "captured", "replayed"]):
        runs(pool[i % 2], want, f"{preset} step {i}")
    runs.check_kept()
    # every decoder conv of a replayed step ran on the kernels, both passes
    before = conv_cuda.pass_counts()
    runs.step(runs.state, pool[0], runs.gen)
    torch.cuda.synchronize()
    assert _delta(before, conv_cuda.pass_counts()) == {"forward": 24, "dgrad": 24,
                                                       "wgrad": 24}
