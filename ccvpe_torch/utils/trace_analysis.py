"""Where device time goes, read from a ``torch.profiler`` capture
(counterpart of ``ccvpe_tpu/utils/trace_analysis.py``).

Two sources give the same report:

* ``load_device_durations(logdir)`` reads the newest Chrome trace that
  ``utils.profiling.trace`` wrote under ``logdir`` (``trace.json``) and
  sums the device spans by name: the kernels (category ``kernel``) and the
  copies and fills (``gpu_memcpy``, ``gpu_memset``, each its own family).
  It leaves out the runtime's API calls (``cuda*``), the ``record_function``
  ranges and ``ProfilerStep`` envelopes.  A CPU-only trace has no device
  spans; there it sums the top-level ATen ops (``cpu_op`` spans inside no
  other), as the JAX module falls back to its host threads.
* ``summarize_profile(prof, iters)`` builds the report from a live
  ``torch.profiler.profile`` (``key_averages``: device kernels only, the
  range names left out), so nothing has to be written to disk; its top
  kernels also carry their launches per iteration.  A profile of the CPU
  alone gives an empty report.

``summarize`` and ``print_report`` keep the JAX module's dict schema and
layout: ``device_ms_per_iter``, ``distinct_ops``, ``by_family``,
``by_shape`` and ``top_ops``.  ``by_shape`` stays empty, because a kernel's
span carries no operand shapes.  ``HloIndex`` and ``shape_bytes`` have no
counterpart: they read XLA's HLO text, which a PyTorch program does not
have.

    from ccvpe_torch.utils import profiling, trace_analysis
    with profiling.trace("prof/"):
        model.predict_batch(grd, sat)
    durations, _ = trace_analysis.load_device_durations("prof/")
    trace_analysis.print_report(trace_analysis.summarize(durations))
"""

from __future__ import annotations

import collections
import glob
import json
import os
import re

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _top_level_cpu_ops(events) -> collections.Counter:
    """Summed ``dur`` of the ``cpu_op`` spans that lie inside no other
    ``cpu_op`` span of their thread (a trace's nesting is by time)."""
    durations: collections.Counter = collections.Counter()
    by_thread = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for spans in by_thread.values():
        end = float("-inf")
        for e in sorted(spans, key=lambda e: (e["ts"], -e.get("dur", 0))):
            if e["ts"] >= end:
                durations[e.get("name", "?")] += e.get("dur", 0)
                end = e["ts"] + e.get("dur", 0)
    return durations


def load_device_durations(logdir: str) -> tuple[collections.Counter, int]:
    """Device time (us) by kernel name from the newest Chrome trace under
    ``logdir``; the top-level host ops of a CPU-only trace.  Returns
    ``(durations, n_trace_files_considered)``."""
    paths = sorted(glob.glob(os.path.join(logdir, "**", "*trace.json"), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no *trace.json under {logdir}")
    with open(paths[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    durations: collections.Counter = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            durations[e.get("name", "?")] += e.get("dur", 0)
    if not durations:
        durations = _top_level_cpu_ops(events)
    return durations, len(paths)


def profile_durations(prof) -> tuple[collections.Counter, collections.Counter]:
    """``(device us, launches)`` by kernel name from a finished
    ``torch.profiler.profile``: its device-side events, leaving out the
    device projections of the ranges (a range's name is also a host event's
    name)."""
    from torch.autograd import DeviceType

    ranges = {e.name for e in prof.events() if e.device_type == DeviceType.CPU}
    durations: collections.Counter = collections.Counter()
    counts: collections.Counter = collections.Counter()
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CPU and e.device_time_total > 0
                and e.key not in ranges):
            durations[e.key] += e.device_time_total
            counts[e.key] += e.count
    return durations, counts


def family(name: str) -> str:
    """A kernel's family: its name without template arguments ``<...>``,
    argument lists ``(...)`` and a trailing ``.N`` instance counter."""
    prev = None
    while prev != name:
        prev = name
        name = re.sub(r"<[^<>]*>", "", name)
    prev = None
    while prev != name:
        prev = name
        name = re.sub(r"\([^()]*\)", "", name)
    return re.sub(r"\.\d+$", "", name.strip())


def summarize(durations: collections.Counter, iters: int = 1, top: int = 30,
              counts: collections.Counter | None = None) -> dict:
    """The attribution report, as a JSON-friendly dict (JAX ``summarize``
    without the HLO index).  With ``counts`` (launches by name), each
    ``top_ops`` row also holds its ``launches`` per iteration."""
    total = sum(durations.values())
    by_family: collections.Counter = collections.Counter()
    for n, d in durations.items():
        by_family[family(n)] += d
    ops = [{"name": n, "us": d, "pct": round(100 * d / total, 2),
            "ms_per_iter": round(d / iters / 1e3, 3)}
           for n, d in durations.most_common(top)]
    if counts is not None:
        for row in ops:
            row["launches"] = counts[row["name"]] / iters
    return {
        "device_ms_per_iter": round(total / iters / 1e3, 2),
        "distinct_ops": len(durations),
        "by_family": [
            {"family": f, "pct": round(100 * d / total, 2),
             "ms_per_iter": round(d / iters / 1e3, 2)}
            for f, d in by_family.most_common(top)],
        "by_shape": [],
        "top_ops": ops,
    }


def summarize_profile(prof, iters: int = 1, top: int = 30) -> dict:
    """``summarize`` of a live ``torch.profiler.profile`` over ``iters``
    iterations, with each top kernel's launches."""
    durations, counts = profile_durations(prof)
    return summarize(durations, iters, top, counts)


def print_report(report: dict, top: int = 25) -> None:
    print(f"device: {report['device_ms_per_iter']} ms/iter, "
          f"{report['distinct_ops']} distinct ops")
    print("\n-- by kernel family --")
    for r in report["by_family"][:top]:
        print(f"{r['pct']:6.2f}%  {r['ms_per_iter']:8.2f} ms  {r['family']}")
    if report["by_shape"]:
        print("\n-- by output shape --")
        for r in report["by_shape"][:top]:
            print(f"{r['pct']:6.2f}%  {r['ms_per_iter']:8.2f} ms  {r['shape'][:80]}")
    print("\n-- top ops --")
    for r in report["top_ops"][:top]:
        print(f"{r['pct']:6.2f}%  {r['ms_per_iter']:8.3f} ms  {r['name'][:90]}")
