"""``ccvpe_torch.utils.trace_analysis`` against ``ccvpe_tpu.utils.
trace_analysis``: the same report from the same durations, kernel families
of real CUDA kernel names, a hand-written Chrome trace read down to its
device spans, a CPU trace of a NANO forward read back to the profile's
own numbers, and the report of a live profile."""

import collections
import json
import os
import time

import numpy as np
import pytest
import torch

from ccvpe_tpu.utils import trace_analysis as JT
from ccvpe_torch.utils import profiling as TP
from ccvpe_torch.utils import trace_analysis as TT

torch.set_num_threads(2)

DURATIONS = [
    collections.Counter({"fusion.1": 300, "fusion.2": 250, "convolution": 1200,
                         "copy.3": 75, "convolution.4": 20}),
    collections.Counter({f"op.{i}": 10 * i + 1 for i in range(40)}),
    collections.Counter({"match_tile_kernel": 123456, "Memcpy HtoD": 7}),
]


@pytest.mark.parametrize("durations", DURATIONS)
@pytest.mark.parametrize("iters,top", [(1, 30), (3, 5)])
def test_summarize_equals_jax(durations, iters, top):
    got = TT.summarize(durations, iters=iters, top=top)
    want = JT.summarize(durations, iters=iters, hlo=None, top=top)
    assert list(got) == list(want)
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("name,fam", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "at::detail::Array<char*, 3> >(int, at::native::CUDAFunctor_add<float>, "
     "at::detail::Array<char*, 3>)", "void at::native::vectorized_elementwise_kernel"),
    ("void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>(float, float, "
     "cudnnTensorStruct, float const*, float*, float const*, float const*, float)",
     "void cudnn::bn_fw_inf_1C11_kernel_NCHW"),
    ("void match_tile_kernel<float, 20, true>(float const*, float const*, float*, int)",
     "void match_tile_kernel"),
    ("sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc_tilesize128x128x16"
     "_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn",
     "sm90_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nhwckrsc_nhwc_tilesize128x128x16"
     "_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
    ("Memset (Device)", "Memset"),
    ("fusion.12", "fusion"),
])
def test_family_of_cuda_kernel_names(name, fam):
    assert TT.family(name) == fam


def _write(logdir, events, name="trace.json"):
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, name), "w") as f:
        json.dump({"traceEvents": events}, f)


def test_a_device_trace_keeps_only_the_device_spans(tmp_path):
    events = [
        {"ph": "M", "pid": 0, "name": "process_name", "args": {"name": "python"}},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#3", "ts": 0, "dur": 900},
        {"ph": "X", "cat": "user_annotation", "name": "ccvpe.step", "ts": 1, "dur": 800},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "ccvpe.step", "ts": 5, "dur": 700},
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "ts": 2, "dur": 50},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 3, "dur": 4},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 3, "dur": 4},
        {"ph": "X", "cat": "kernel", "name": "void match_tile_kernel<float, 20, true>(int)",
         "ts": 10, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "void match_tile_kernel<float, 20, true>(int)",
         "ts": 200, "dur": 110},
        {"ph": "X", "cat": "kernel", "name": "void match_tile_kernel<float, 4, true>(int)",
         "ts": 400, "dur": 30},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
         "ts": 500, "dur": 20},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "ts": 600, "dur": 2},
        {"ph": "i", "cat": "kernel", "name": "an instant", "ts": 650},
    ]
    _write(str(tmp_path / "a"), events)
    durations, n = TT.load_device_durations(str(tmp_path))
    assert n == 1
    assert durations == {"void match_tile_kernel<float, 20, true>(int)": 210,
                         "void match_tile_kernel<float, 4, true>(int)": 30,
                         "Memcpy HtoD (Pageable -> Device)": 20, "Memset (Device)": 2}
    report = TT.summarize(durations, iters=2)
    assert report["device_ms_per_iter"] == round(262 / 2 / 1e3, 2)
    assert report["by_shape"] == []
    assert [(r["family"], r["pct"]) for r in report["by_family"]] == [
        ("void match_tile_kernel", round(100 * 240 / 262, 2)),
        ("Memcpy HtoD", round(100 * 20 / 262, 2)), ("Memset", round(100 * 2 / 262, 2))]
    TT.print_report(report)

    # the newest trace wins, however the files are named
    time.sleep(0.01)
    _write(str(tmp_path / "b"), [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0,
                                  "dur": 5}], name="host.pt.trace.json")
    assert TT.load_device_durations(str(tmp_path)) == ({"k": 5}, 2)
    with pytest.raises(FileNotFoundError):
        TT.load_device_durations(str(tmp_path / "none"))


def _top_level_host_ops(prof) -> tuple[collections.Counter, collections.Counter]:
    """``(cpu us, calls)`` by name of the profile's ATen ops that lie in no
    other op (ranges do not count as a parent)."""
    durations, calls = collections.Counter(), collections.Counter()
    for e in prof.events():
        parent = e.cpu_parent
        while parent is not None and parent.is_user_annotation:
            parent = parent.cpu_parent
        if not e.is_user_annotation and parent is None:
            durations[e.name] += e.cpu_time_total
            calls[e.name] += 1
    return durations, calls


def test_a_cpu_trace_of_a_nano_forward_reads_back(tmp_path):
    """No device spans on the CPU: the trace gives the top-level ATen ops,
    as the profile holds them, within the trace's rounding; the live
    profile's report counts device kernels only, so it is empty."""
    from torch.autograd import DeviceType

    from ccvpe_torch import api

    model = api.load_model(preset="NANO", seed=0, device="cpu")
    rng = np.random.default_rng(0)
    grd = rng.integers(0, 256, (2, *model.cfg.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 256, (2, *model.cfg.sat_hw, 3), dtype=np.uint8)
    model.predict_batch(grd, sat)
    with TP.trace(str(tmp_path)) as prof:
        with TP.annotate("ccvpe.predict"):
            model.predict_batch(grd, sat)
    durations, n = TT.load_device_durations(str(tmp_path))
    want, calls = _top_level_host_ops(prof)
    assert n == 1 and "ccvpe.predict" not in durations
    assert set(durations) == set(want) and len(want) > 10
    assert any(k.startswith("aten::conv2d") for k in durations)
    for k in want:
        assert durations[k] == pytest.approx(want[k], abs=1e-3 * calls[k]), k
    # against key_averages: a name's top-level time is part of its total,
    # and all of it lies inside the range
    totals = {e.key: e.cpu_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CPU}
    for k in want:
        assert durations[k] <= totals[k] + 1e-3 * calls[k], k
    assert sum(durations.values()) <= totals["ccvpe.predict"]
    assert TT.profile_durations(prof) == ({}, {})
    report = TT.summarize_profile(prof)
    assert (report["device_ms_per_iter"], report["distinct_ops"], report["top_ops"]) == (0, 0, [])


class _Event:
    def __init__(self, name, device_type, device_us=0.0, count=1):
        self.name = self.key = name
        self.device_type, self.device_time_total, self.count = device_type, device_us, count


class _Profile:
    """The two views of a ``torch.profiler.profile`` that
    ``profile_durations`` reads: its events and their per-name sums."""

    def __init__(self, events, averages):
        self._events, self._averages = events, averages

    def events(self):
        return self._events

    def key_averages(self):
        return self._averages


def test_summarize_profile_counts_device_kernels_and_their_launches():
    """Device kernels are kept with their launches; a range's device
    projection (it shares a host event's name), host ops and device events
    without time are left out."""
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    k1 = "void match_tile_kernel<float, 20, true>(int)"
    k2 = "void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>(float)"
    prof = _Profile(
        events=[_Event("ccvpe.step", cpu), _Event("aten::conv2d", cpu)],
        averages=[_Event("ccvpe.step", cuda, 700.0), _Event("aten::conv2d", cpu),
                  _Event(k1, cuda, 300.0, count=6), _Event(k2, cuda, 100.0, count=2),
                  _Event("cudaLaunchKernel", cpu, count=8), _Event("idle", cuda, 0.0)])
    assert TT.profile_durations(prof) == ({k1: 300.0, k2: 100.0}, {k1: 6, k2: 2})
    report = TT.summarize_profile(prof, iters=2, top=5)
    assert report == {**TT.summarize(collections.Counter({k1: 300.0, k2: 100.0}), 2, 5),
                      "top_ops": report["top_ops"]}
    assert [(r["name"], r["ms_per_iter"], r["launches"]) for r in report["top_ops"]] == [
        (k1, 0.15, 3.0), (k2, 0.05, 1.0)]
    assert [r["family"] for r in report["by_family"]] == [
        "void match_tile_kernel", "void cudnn::bn_fw_inf_1C11_kernel_NCHW"]
