"""What the CPU can check of the train step's CUDA graphs
(``train.loop.GraphedStep``): the route, which takes float32 Adam steps of
one process on the card and refuses every other; that a CPU step runs
eagerly and never captures; the step signature and the addresses a set is
held to; Adam's switch to device step counts; the warm-up, capture, replay
and drop of sets, with a stand-in set in place of the graphs; and the
launch tally of a capture's stream, which counts the kernels a captured
backward launches from autograd's thread.  The graphs themselves run on
the card: ``tests/test_torch_train_graphs.py``."""

import threading
import types

import pytest
import torch

from ccvpe_torch.models import cvm
from ccvpe_torch.ops import graphs
from ccvpe_torch.ops import gt as GT
from ccvpe_torch.parallel import mesh
from ccvpe_torch.train import loop

torch.set_num_threads(2)


class _Model:
    """Parameters that say they lie on a device, for the route alone."""

    def __init__(self, device="cuda", dtype=torch.float32):
        self.params = [types.SimpleNamespace(device=torch.device(device), dtype=dtype)
                       for _ in range(3)]

    def parameters(self):
        return iter(self.params)


def _state(device="cuda", dtype=torch.float32, f32_master=False):
    opt = loop.make_optimizer([torch.zeros(2, requires_grad=True)], f32_master=f32_master)
    return loop.TrainState(_Model(device, dtype), opt)


ROUTES = {
    "float32_adam": (dict(), dict(), True),
    "bf16_compute": (dict(), dict(compute_dtype=torch.bfloat16), False),
    "bf16_params_f32_master": (dict(dtype=torch.bfloat16, f32_master=True), dict(), False),
    "remat_all": (dict(), dict(remat="all"), False),
    "remat_decoder": (dict(), dict(remat="decoder"), False),
    "grad_accum_2": (dict(), dict(grad_accum=2), False),
    "cpu_tensors": (dict(device="cpu"), dict(), False),
}


@pytest.mark.parametrize("case", ROUTES)
def test_route(case):
    state_kw, step_kw, want = ROUTES[case]
    kw = {"grad_accum": 1, "remat": False, "compute_dtype": torch.float32, **step_kw}
    assert loop.takes_graphs(_state(**state_kw), **kw) is want


def test_route_refuses_a_process_group(monkeypatch):
    kw = dict(grad_accum=1, remat=False, compute_dtype=torch.float32)
    assert loop.takes_graphs(_state(), **kw)
    monkeypatch.setattr(mesh, "is_distributed", lambda: True)
    assert not loop.takes_graphs(_state(), **kw)


def test_route_refuses_another_optimizer():
    state = _state()
    state.optimizer = torch.optim.AdamW([torch.zeros(2, requires_grad=True)])
    assert not loop.takes_graphs(state, 1, False, torch.float32)


def _batch(cfg, b, seed=0):
    gen = torch.Generator().manual_seed(seed)
    h, w = cfg.sat_hw
    off = (torch.rand((2, b), generator=gen) * 2 - 1) * 20
    angle = torch.rand((b,), generator=gen) * 360
    gt, weights, omap = GT.synthesize_batch_factored(off[0], off[1], angle, height=h, width=w,
                                                     bins=cfg.bins)
    return {"grd": torch.randn((b, *cfg.grd_hw, 3), generator=gen),
            "sat": torch.randn((b, h, w, 3), generator=gen),
            "gt": gt, "bin_weights": weights, "orientation": omap}


@pytest.fixture(scope="module")
def nano():
    state = loop.create_train_state(cvm.NANO, seed=0, device="cpu")
    return state, _batch(cvm.NANO, 2)


def _delta(before):
    now = loop.step_counts()
    return {k: now[k] - before[k] for k in now}


def test_cpu_step_runs_eagerly_and_never_captures(nano):
    state, batch = nano
    step = loop.make_train_step(cvm.NANO)
    before = loop.step_counts()
    for _ in range(3):
        parts = step(state, batch)
    assert _delta(before) == {"eager": 3, "captured": 0, "replayed": 0}
    assert not state.optimizer.param_groups[0]["capturable"]
    assert all(torch.isfinite(v) for v in parts.values())


def test_signature_separates_every_key(nano):
    state, batch = nano
    gen = torch.Generator()
    base = loop.step_signature(batch, None, state.optimizer)
    assert loop.step_signature(dict(batch), None, state.optimizer) == base
    changed = [loop.step_signature({**batch, "grd": batch["grd"][:1]}, None, state.optimizer),
               loop.step_signature({**batch, "gt": batch["gt"].double()}, None,
                                   state.optimizer),
               loop.step_signature(batch, gen, state.optimizer)]
    lr = state.optimizer.param_groups[0]["lr"]
    try:
        state.optimizer.param_groups[0]["lr"] = lr * 2
        changed.append(loop.step_signature(batch, None, state.optimizer))
    finally:
        state.optimizer.param_groups[0]["lr"] = lr
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = not tf32
        changed.append(loop.step_signature(batch, None, state.optimizer))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert len({base, *changed}) == 1 + len(changed)


def test_addresses_follow_replaced_tensors_not_writes():
    state = loop.create_train_state(cvm.NANO, seed=1, device="cpu")
    step = loop.make_train_step(cvm.NANO)
    step(state, _batch(cvm.NANO, 2))
    model, opt = state.model, state.optimizer
    base = loop._addresses(model, opt)
    p = next(model.parameters())
    with torch.no_grad():
        p.add_(1)
        next(model.buffers()).add_(1)
    opt.load_state_dict(opt.state_dict())       # the same tensors, loaded back
    assert loop._addresses(model, opt) == base
    p.requires_grad_(False)
    assert loop._addresses(model, opt) != base
    p.requires_grad_(True)
    p.data = p.data.clone()
    assert loop._addresses(model, opt) != base
    base = loop._addresses(model, opt)
    opt.load_state_dict({**opt.state_dict(), "state": {
        k: {n: v.clone() for n, v in s.items()} for k, s in opt.state_dict()["state"].items()}})
    assert loop._addresses(model, opt) != base


def test_capturable_moves_the_step_counts():
    w = torch.zeros(3, requires_grad=True)
    opt = loop.make_optimizer([w])
    w.grad = torch.ones(3)
    opt.step()
    assert opt.state[w]["step"].device.type == "cpu"
    loop._capturable(opt)
    assert opt.param_groups[0]["capturable"]
    assert opt.state[w]["step"].dtype == torch.float32 and float(opt.state[w]["step"]) == 1


class _FakeGraphed:
    """A stand-in ``GraphedStep``: records its captures, is held to the
    addresses as the real one is, and returns a loss."""
    made = []
    matches = loop.GraphedStep.matches

    def __init__(self, state, batch, generator, forward):
        self.model, self.optimizer = state.model, state.optimizer
        self.addresses = loop._addresses(state.model, state.optimizer)
        self.batch = batch
        _FakeGraphed.made.append(self)

    def run(self, batch):
        return {"loss": torch.zeros(())}


@pytest.fixture
def fake_route(monkeypatch):
    """The graphed route on the CPU, with ``_FakeGraphed`` for the graphs."""
    monkeypatch.setattr(loop, "takes_graphs", lambda *a: True)
    monkeypatch.setattr(loop, "_capturable", lambda opt: None)
    monkeypatch.setattr(loop, "GraphedStep", _FakeGraphed)
    _FakeGraphed.made = []
    return _FakeGraphed.made


def test_warm_up_capture_then_replays(fake_route):
    state = loop.create_train_state(cvm.NANO, seed=2, device="cpu")
    step = loop.make_train_step(cvm.NANO)
    batch = _batch(cvm.NANO, 2)
    before = loop.step_counts()
    for _ in range(4):
        step(state, batch)
    assert _delta(before) == {"eager": 1, "captured": 1, "replayed": 2}
    assert state.step == 4 and len(fake_route) == 1
    # Adam's state loaded anew: the set is dropped, then warmed up and captured again
    opt = state.optimizer
    opt.load_state_dict({**opt.state_dict(), "state": {
        k: {n: v.clone() for n, v in s.items()} for k, s in opt.state_dict()["state"].items()}})
    before = loop.step_counts()
    for _ in range(3):
        step(state, batch)
    assert _delta(before) == {"eager": 1, "captured": 1, "replayed": 1}
    # a new train state (a resumed run's) is captured for itself
    other = loop.create_train_state(cvm.NANO, seed=2, device="cpu")
    before = loop.step_counts()
    step(other, batch)
    step(other, batch)
    assert _delta(before) == {"eager": 1, "captured": 1, "replayed": 0}
    assert len(fake_route) == 3


def test_sets_are_bounded_least_recently_used_first(fake_route):
    state = loop.create_train_state(cvm.NANO, seed=3, device="cpu")
    step = loop.make_train_step(cvm.NANO)
    gens = [None, torch.Generator(), torch.Generator()]
    assert len(gens) > loop.MAX_STEP_GRAPH_SETS
    batch = _batch(cvm.NANO, 2)
    for gen in gens:
        before = loop.step_counts()
        step(state, batch, gen)
        step(state, batch, gen)
        assert _delta(before) == {"eager": 1, "captured": 1, "replayed": 0}
    # the most recent sets replay; the oldest was dropped and warms up again
    before = loop.step_counts()
    step(state, batch, gens[2])
    step(state, batch, gens[1])
    assert _delta(before) == {"eager": 0, "captured": 0, "replayed": 2}
    before = loop.step_counts()
    step(state, batch, gens[0])
    assert _delta(before) == {"eager": 1, "captured": 0, "replayed": 0}


def test_no_capture_before_a_warm_up_of_its_own(fake_route):
    """A signature captures only on the call after its own eager warm-up:
    one call of a shape between the steps of another never captures; nor
    does a call whose warm-up's gradients a caller reset."""
    state = loop.create_train_state(cvm.NANO, seed=4, device="cpu")
    step = loop.make_train_step(cvm.NANO)
    a, b = _batch(cvm.NANO, 2), _batch(cvm.NANO, 1)
    for batch in (a, a, b, a, b, a):
        step(state, batch)
    assert len(fake_route) == 1 and fake_route[0].batch is a
    # gradients reset between the warm-up and the next call: Adam's state
    # may lack a parameter, so that call warms up again
    before = loop.step_counts()
    step(state, b)
    state.optimizer.zero_grad(set_to_none=True)
    step(state, b)
    step(state, b)
    assert _delta(before) == {"eager": 2, "captured": 1, "replayed": 0}


def test_a_capturing_streams_launches_go_to_its_tally(monkeypatch):
    """A kernel launched into a stream that a graph is capturing, from a
    thread that is not capturing (autograd's, running a captured backward),
    counts into the graph's tally."""
    current = {"stream": 7}
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=current["stream"]))
    counts, lock, tally = {"k": 0}, threading.Lock(), {}
    monkeypatch.setitem(graphs._CAPTURING, 7, tally)
    t = threading.Thread(target=graphs.count, args=(counts, lock, "k"))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert counts["k"] == 0 and tally[id(counts)][2] == {"k": 1}
    current["stream"] = 8
    graphs.count(counts, lock, "k")
    assert counts["k"] == 1
