"""The readers of the program's spans (``lib.spans`` and the seven metrics
that use it) on synthetic traces: host ops built as the profiler builds
them (``FunctionEvent``s with their kernels appended, a second thread for
autograd's backward) and device intervals placed so that each idle gap's
midpoint falls inside or outside a given span."""

from __future__ import annotations

import itertools

import pytest
from torch.autograd.profiler_util import FunctionEvent

from portbench.lib import harness, trace as trace_lib

_ids = itertools.count(1)


def _op(name, start, end, parent=None, kernels=(), thread=1):
    e = FunctionEvent(id=next(_ids), name=name, thread=thread, start_us=start, end_us=end)
    if parent is not None:
        e.set_cpu_parent(parent)
        parent.append_cpu_child(e)
    for us in kernels:
        e.append_kernel("k", 0, us)
    return e


def _trace(ops, busy, op_iters=1, lean_busy_us=600, lean_iters=1) -> trace_lib.Trace:
    """The full slice's ``ops`` and device intervals ``busy``; a lean slice
    of ``lean_iters`` iterations busy ``lean_busy_us`` in all."""
    return trace_lib.Trace(1.0, lean_iters, [(0, lean_busy_us, "k")],
                           sorted(ops, key=lambda e: e.time_range.start),
                           op_iters, [(a, b, "k") for a, b in busy])


def _read(metric: str, t, iter_s=1.6e-3):
    """The reading of ``metric``; the untraced window takes ``iter_s`` an
    iteration, so with ``_trace``'s defaults 1 ms of it is idle."""
    return harness._reader(metric).read({"trace": t, "readings": {"iter_s": iter_s},
                                         "cell": None, "part": None})


def _call(skip=()) -> list:
    """One ``predict_batch`` call: the four stages, the CVM's four parts in
    the forward, kernels of 150 + 100 us in the encoders and 30 (launched by
    the decoder's span itself, as a ctypes launch is) + 10 + 40 us in the
    decoders."""
    ops = []

    def op(name, *a, **kw):
        e = _op(name, *a, **kw)
        ops.append(e)
        return e

    op("predict.upload", 0, 100)
    fwd = op("predict.forward", 100, 1000)
    parts = {"cvm.ground_encoder": (110, 400, 150), "cvm.aerial_encoder": (400, 600, 100),
             "cvm.orientation_decoder": (800, 990, 40)}
    for name, (a, b, us) in parts.items():
        if name not in skip:
            span = op(name, a, b, fwd)
            op("aten::conv2d", a + 10, a + 20, span, (us,))
    loc = op("cvm.localization_decoder", 600, 800, fwd, (30,))
    op("aten::cat", 610, 620, loc, (10,))
    op("predict.fetch", 1000, 1200)
    op("predict.poses", 1200, 1300)
    return [e for e in ops if e.name not in skip]


# gaps (us): 40-130 mid 85 (upload), 300-320 and 420-700 and 760-900 (in
# the forward), 940-1100 mid 1020 (fetch), 1105-1350 mid 1227.5 (poses),
# 1400-1500 mid 1450 (after the call: the caller's loop); 1035 in all
CALL_BUSY = [(20, 40), (130, 300), (320, 420), (700, 760), (900, 940), (1100, 1105),
             (1350, 1400), (1500, 1510)]
BOUNDARY = (90 + 160 + 245) / 1035


def test_inference_readers():
    t = _trace(_call(), CALL_BUSY)
    assert _read("forward.encoder_ms", t) == pytest.approx(0.25)
    assert _read("forward.decoder_ms", t) == pytest.approx(0.08)
    # the untraced call's 1 ms of idle, in the share of the traced idle at
    # the call boundary; the caller's 100 us between calls is left out
    assert _read("api.idle_outside_forward_ms", t) == pytest.approx(BOUNDARY)
    assert _read("api.idle_outside_forward_ms", t, iter_s=2.6e-3) == pytest.approx(2 * BOUNDARY)
    two = _trace(_call(), CALL_BUSY, op_iters=2)
    assert _read("forward.encoder_ms", two) == pytest.approx(0.125)
    # the split does not depend on how many iterations the full slice held
    assert _read("api.idle_outside_forward_ms", two) == pytest.approx(BOUNDARY)
    lean_two = _trace(_call(), CALL_BUSY, lean_iters=2)
    assert _read("api.idle_outside_forward_ms", lean_two) == pytest.approx(1.3 * BOUNDARY)


def test_idle_readers_hold_the_untraced_window():
    """A slower host lengthens every traced gap alike: the reading keeps
    the untraced idle and the split; a window no longer than the lean busy
    time reads no idle."""
    ops = _call()
    for e in ops:
        e.time_range.start, e.time_range.end = 2 * e.time_range.start, 2 * e.time_range.end
    slow = _trace(ops, [(2 * a, 2 * b) for a, b in CALL_BUSY])
    assert _read("api.idle_outside_forward_ms", slow) == pytest.approx(BOUNDARY)
    t = _trace(_call(), CALL_BUSY)
    assert _read("api.idle_outside_forward_ms", t, iter_s=5e-4) == 0.0
    assert _read("api.idle_outside_forward_ms", t, iter_s=None) is None


def test_inference_readers_without_their_spans():
    assert _read("forward.encoder_ms", _trace(_call(skip={"cvm.aerial_encoder"}),
                                              CALL_BUSY)) is None
    assert _read("forward.decoder_ms", _trace(_call(skip={"cvm.orientation_decoder"}),
                                              CALL_BUSY)) is None
    assert _read("api.idle_outside_forward_ms", _trace(_call(skip={"predict.fetch"}),
                                                       CALL_BUSY)) is None
    for metric in ("forward.encoder_ms", "forward.decoder_ms", "api.idle_outside_forward_ms"):
        assert _read(metric, None) is None
        assert _read(metric, _trace(_call(), [])) is None         # no device activity
        assert _read(metric, _trace(_call(), CALL_BUSY, op_iters=0)) is None


def _step(new_spans=True) -> list:
    """One train step: the feed (20 us of kernels), the gradients' reset,
    the forward (300), the backward call on thread 1 (2) and autograd's
    thread 2 (500 in a convolution's backward, 70 + 5 under
    ``matching.backward``), the optimizer (100), then 3 us on thread 1 and
    9 us on thread 2 after every span."""
    ops = []

    def op(name, *a, **kw):
        e = _op(name, *a, **kw)
        ops.append(e)
        return e

    feed = op("portbench.feed", 0, 100)
    op("aten::copy_", 10, 50, feed, (20,))
    if new_spans:
        op("train_step.zero_grad", 100, 300)
    fwd = op("train_step.forward", 300, 1000)
    op("aten::convolution", 310, 400, fwd, (300,))
    bwd = op("train_step.backward", 1000, 3000) if new_spans else None
    op("aten::div", 1005, 1010, bwd, (2,))
    node = op("autograd::engine::evaluate_function: ConvolutionBackward0", 1100, 1500,
              thread=2)
    op("aten::convolution_backward", 1110, 1490, node, (400, 100), thread=2)
    node = op("autograd::engine::evaluate_function: _EpilogueFnBackward", 1600, 2500,
              thread=2)
    match = op("matching.backward", 1610, 2490, node, thread=2) if new_spans else node
    op("aten::mm", 1620, 1700, match, (70,), thread=2)
    op("aten::sum", 1700, 1750, match, (5,), thread=2)
    opt = op("train_step.optimizer", 3000, 3500)
    step = op("Optimizer.step#Adam.step", 3100, 3400, opt)
    op("aten::_foreach_add_", 3110, 3300, step, (100,))
    op("aten::add", 3600, 3610, kernels=(3,))
    op("aten::zero_", 3700, 3710, kernels=(9,), thread=2)
    return ops


# gaps (us): 40-320 mid 180 (zero_grad), 700-750 (forward), 1050-1150 and
# 1650-1700 (backward), 2900-3150 mid 3025 and 3350-3620 mid 3485
# (optimizer), 3625-3700 (after every span); 1075 in all
STEP_BUSY = [(10, 40), (320, 700), (750, 1050), (1150, 1650), (1700, 2900), (3150, 3350),
             (3620, 3625), (3700, 3709)]


def test_train_readers():
    t = _trace(_step(), STEP_BUSY)
    # the kernels launched while the backward span is open, on either thread
    assert _read("train.backward_span_ms", t) == pytest.approx((2 + 500 + 75) / 1e3)
    # the complement reading counts the 3 + 9 us after every span as well
    assert _read("train.backward_ms", t) == pytest.approx((2 + 500 + 75 + 12) / 1e3)
    assert _read("train.matching_backward_ms", t) == pytest.approx(0.075)
    # shares of the untraced step's 1 ms of idle
    assert _read("train.idle_backward_ms", t) == pytest.approx(150 / 1075)
    assert _read("train.idle_optimizer_ms", t) == pytest.approx((280 + 250 + 270) / 1075)
    half = _trace(_step(), STEP_BUSY, op_iters=2)
    assert _read("train.backward_span_ms", half) == pytest.approx((2 + 500 + 75) / 2e3)
    assert _read("train.idle_optimizer_ms", half) == pytest.approx(800 / 1075)


def test_train_readers_on_a_program_without_the_spans():
    """The parent's program marks only the forward and the optimizer: every
    new reader finds nothing and says so; the old complement still reads."""
    t = _trace(_step(new_spans=False), STEP_BUSY)
    for metric in ("train.backward_span_ms", "train.matching_backward_ms",
                   "train.idle_backward_ms", "train.idle_optimizer_ms"):
        assert _read(metric, t) is None, metric
        assert _read(metric, None) is None
        assert _read(metric, _trace(_step(), [])) is None
    assert _read("train.backward_ms", t) == pytest.approx((2 + 500 + 75 + 12) / 1e3)


def test_new_readers_are_listed_in_the_manifest():
    import json

    per_layer = {m["name"]: m for m in json.loads(
        (harness.ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    infer, train = ["vigor-infer-b8", "kitti-infer-b8"], ["vigor-train-b8"]
    for name, cells in [("forward.encoder_ms", infer), ("forward.decoder_ms", infer),
                        ("api.idle_outside_forward_ms", infer),
                        ("train.backward_span_ms", train),
                        ("train.matching_backward_ms", train),
                        ("train.idle_backward_ms", train), ("train.idle_optimizer_ms", train)]:
        m = per_layer[name]
        assert (m["unit"], m["better"], m["source"], m["workloads"]) == (
            "ms", "lower", "device_trace", cells), name
