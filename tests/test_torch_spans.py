"""The port's spans (``utils.profiling.annotate``) as a CPU ``torch.profiler``
records them: a ``predict_batch`` call's four stages with the CVM's four
parts nested in its forward, a train step's four ranges, and the matching
backward; with no profiler running, ``annotate`` is a shared no-op that
never enters ``record_function``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ccvpe_torch import api
from ccvpe_torch.data.transforms import assemble_device_batch
from ccvpe_torch.models import cvm
from ccvpe_torch.ops import matching, matching_cuda
from ccvpe_torch.train import loop
from ccvpe_torch.utils import profiling

PREDICT = ["predict.upload", "predict.forward", "predict.fetch", "predict.poses"]
CVM = ["cvm.ground_encoder", "cvm.aerial_encoder", "cvm.localization_decoder",
       "cvm.orientation_decoder"]
TRAIN = ["train_step.zero_grad", "train_step.forward", "train_step.backward",
         "train_step.optimizer"]


def _spans(prof, names) -> list:
    """The profile's events named in ``names``, in the order they started."""
    return sorted((e for e in prof.events() if e.name in names),
                  key=lambda e: e.time_range.start)


def _inside(e, outer) -> bool:
    p = e.cpu_parent
    while p is not None and p is not outer:
        p = p.cpu_parent
    return p is outer


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def test_predict_batch_records_its_stages_and_the_cvm_parts():
    model = api.load_model(preset="NANO", seed=0, device="cpu")
    rng = np.random.default_rng(0)
    grd = rng.integers(0, 256, (2, *model.cfg.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 256, (2, *model.cfg.sat_hw, 3), dtype=np.uint8)
    want = model.predict_batch(grd, sat)
    got = []
    prof = _profiled(lambda: got.extend(model.predict_batch(grd, sat)))
    assert [(p.row, p.col) for p in got] == [(p.row, p.col) for p in want]
    stages = _spans(prof, PREDICT)
    assert [e.name for e in stages] == PREDICT
    parts = _spans(prof, CVM)
    assert [e.name for e in parts] == CVM
    forward = stages[1]
    assert all(_inside(e, forward) for e in parts)
    # the stages do not overlap, and each CVM part holds ATen ops
    assert all(a.time_range.end <= b.time_range.start for a, b in zip(stages, stages[1:]))
    for e in parts:
        assert any(c.name.startswith("aten::") for c in e.cpu_children), e.name
    assert any(c.name.startswith("aten::conv") for c in parts[0].cpu_children)


def _nano_batch(b: int = 2) -> dict:
    gen = torch.Generator().manual_seed(0)
    h, w = cvm.NANO.sat_hw
    raw = {"grd": torch.randint(0, 256, (b, *cvm.NANO.grd_hw, 3), generator=gen,
                                dtype=torch.uint8),
           "sat": torch.randint(0, 256, (b, h, w, 3), generator=gen, dtype=torch.uint8),
           "row_offset": torch.tensor([10.0, -20.0][:b]),
           "col_offset": torch.tensor([-5.0, 30.0][:b]),
           "angle": torch.tensor([40.0, 250.0][:b])}
    return assemble_device_batch(raw, sat_hw=(h, w), bins=cvm.NANO.bins, clockwise=False,
                                 device="cpu")


def test_train_step_records_four_ranges_in_order():
    assert (loop.FORWARD_RANGE, loop.OPTIMIZER_RANGE) == (
        "train_step.forward", "train_step.optimizer")
    assert [loop.ZERO_GRAD_RANGE, loop.FORWARD_RANGE, loop.BACKWARD_RANGE,
            loop.OPTIMIZER_RANGE] == TRAIN
    state = loop.create_train_state(cvm.NANO, seed=0, device="cpu")
    step = loop.make_train_step(cvm.NANO)
    batch = _nano_batch()
    parts = {}
    prof = _profiled(lambda: parts.update(step(state, batch)))
    assert torch.isfinite(parts["loss"])
    ranges = _spans(prof, TRAIN)
    assert [e.name for e in ranges] == TRAIN
    assert all(a.time_range.end <= b.time_range.start for a, b in zip(ranges, ranges[1:]))
    # the CVM's parts run inside the forward range
    forward = ranges[1]
    assert [e.name for e in _spans(prof, CVM)] == CVM
    assert all(_inside(e, forward) for e in _spans(prof, CVM))
    assert any(e.name == "Optimizer.step#Adam.step" and _inside(e, ranges[3])
               for e in prof.events())


@pytest.mark.parametrize("kernel", ["epilogue", "scores"])
def test_matching_backward_records_its_span(kernel, monkeypatch):
    """``_plain_grads`` on CPU tensors, reached as on the card: through the
    kernels' autograd Functions with the launch routed to the plain
    version; the backward's ops lie inside ``matching.backward``."""
    if kernel == "epilogue":
        monkeypatch.setattr(matching_cuda, "launch_matching_epilogue",
                            lambda x, g, *a: matching.matching_epilogue_plain(x, g, *a))
        fn, cg = matching_cuda._EpilogueFn, 32
    else:
        monkeypatch.setattr(matching_cuda, "launch_matching_scores",
                            lambda x, g, *a: matching.matching_scores_plain(x, g, *a))
        fn, cg = matching_cuda._ScoresFn, 16
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 4, 32, generator=gen, requires_grad=True)
    g = torch.randn(2, cg, generator=gen, requires_grad=True)
    outs = fn.apply(x, g, 1, (0, 1, 2, 3), "first")
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum(o.square().sum() for o in outs)
    prof = _profiled(loss.backward)
    spans = _spans(prof, {"matching.backward"})
    assert len(spans) == 1
    assert any(_inside(e, spans[0]) and e.name.startswith("aten::") for e in prof.events())
    assert x.grad is not None and g.grad is not None


def test_annotate_without_a_profiler_is_a_shared_no_op(monkeypatch):
    def boom(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(profiling, "record_function", boom)
    assert not torch.autograd._profiler_enabled()
    first, second = profiling.annotate("a"), profiling.annotate("b")
    assert first is second
    with first, second:
        pass
    # the program's spans take the same path: a predict_batch and a train
    # step run whole
    model = api.load_model(preset="NANO", seed=0, device="cpu")
    grd = np.zeros((1, *model.cfg.grd_hw, 3), np.uint8)
    sat = np.zeros((1, *model.cfg.sat_hw, 3), np.uint8)
    assert len(model.predict_batch(grd, sat)) == 1
    state = loop.create_train_state(cvm.NANO, seed=0, device="cpu")
    assert torch.isfinite(loop.make_train_step(cvm.NANO)(state, _nano_batch())["loss"])

