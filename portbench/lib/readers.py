"""Arithmetic shared by the per-layer metric readers (``portbench/metrics``).

A reader gets ``reading``: ``trace`` (``lib.trace.Trace`` of the traced
slice, or None), ``readings`` (the driver's counters and rates),
``cell`` and ``part`` (the card's data-sheet part, ``lib.peaks``).  It
returns None when it finds nothing to read; a share of a roofline or a
peak is never reported as 0 for want of a reading.
"""

from __future__ import annotations

from ..reference import cvm as ref
from ..reference import flops
from . import peaks, program, trace as trace_lib


def arch(reading) -> ref.Arch:
    return ref.arch_from(reading["cell"].config)


def loc_offsets(reading):
    return program.loc_offsets(reading["cell"].workload["params"].get("ori_noise", 180.0))


def mfu_pct(reading, flops_per_item: float, rate_key: str) -> float | None:
    """The model's operations per item times the items/s of the same run's
    window (untraced: a ``--trace 1`` run traces after its window), as a
    share of the card's float32 peak."""
    rate = reading["readings"].get(rate_key)
    if not rate:
        return None
    return 100.0 * flops_per_item * rate / peaks.PEAKS[reading["part"]][1]


def idle_pct(reading) -> float | None:
    """The share of an untraced iteration in which the device is idle: the
    device's busy seconds an iteration of the lean traced slice, over the
    seconds an iteration of the untraced window (``iter_s``).  The traced
    slice's own length is not the denominator: the profiler slows the host
    and so lengthens the slice's idle gaps."""
    t, per = reading["trace"], reading["readings"].get("iter_s")
    if t is None or not t.device or not t.iters or not per:
        return None
    return 100.0 * (1.0 - trace_lib.busy_s(t) / t.iters / per)


def roofline_pct(reading, kernel: str) -> float | None:
    """The least time of ``kernel``'s launches in one call (each at the
    larger of its bytes over the memory rate and its operations over the
    float32 peak) over their measured device time a call."""
    t = reading["trace"]
    if t is None or not t.iters:
        return None
    spent = trace_lib.device_s_by(t, trace_lib.matching_kernel).get(kernel, 0.0) / t.iters
    batch = reading["readings"]["batch"]
    least = sum(peaks.bound_s(launch.bytes, launch.flops, reading["part"])
                for launch in flops.matching_launches(arch(reading), batch, loc_offsets(reading))
                if launch.kernel == kernel)
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
