"""The program's spans in the traced slice that records host ops, for the
per-layer readers: device time of the kernels launched under a span or
while one was open, and the device's idle gaps placed under the span that
was open on the host at their midpoint.

A span is a ``record_function`` range of the program (``Trace.ops``,
stamped by the profiler that stamps the kernels, so both lie on one
clock).  A gap is a stretch between the merged intervals of the slice's
device ops (``Trace.op_device``), as ``lib.trace.breakdown`` takes them.
Recording host ops lengthens the gaps between launches, and by a share
that follows the host's speed, so the full slice gives idle time only its
split between spans; the amount is the untraced window's.

Every function returns None when one of the named spans is missing from
the slice or the slice has no device activity, and otherwise a number an
iteration, in milliseconds: of the full slice (``Trace.op_iters``) for
device time, of the untraced window for idle time.  The span
names are the readers' own constants: nothing here imports the program.
"""

from __future__ import annotations

import bisect

from . import trace as trace_lib


def _intervals(t: trace_lib.Trace, names) -> list[tuple[float, float]] | None:
    """The merged (start us, end us) of the spans named in ``names``, or
    None unless each name occurs in the slice."""
    found = [e for e in t.ops if e.name in names]
    if {e.name for e in found} != set(names):
        return None
    return trace_lib.merged(sorted((e.time_range.start, e.time_range.end) for e in found))


def _covered(intervals, us: float) -> bool:
    i = bisect.bisect_right([a for a, _ in intervals], us) - 1
    return i >= 0 and intervals[i][1] >= us


def _ready(t: trace_lib.Trace | None) -> bool:
    return t is not None and bool(t.op_iters) and bool(t.op_device)


def under_ms(t: trace_lib.Trace | None, names) -> float | None:
    """Device ms of the kernels whose launching op is one of the spans
    named, or lies inside one on the same thread (``lib.trace.under``)."""
    if not _ready(t) or _intervals(t, names) is None:
        return None
    return trace_lib.under(t, lambda n: n in names) / t.op_iters * 1e3


def launched_in_ms(t: trace_lib.Trace | None, names) -> float | None:
    """Device ms of the kernels launched by ops, on any thread, that start
    while a span named is open: the work that a span on the calling thread
    hands to another thread (autograd's backward)."""
    spans = _intervals(t, names) if _ready(t) else None
    if spans is None:
        return None
    us = sum(k.duration for e in t.ops if e.kernels and _covered(spans, e.time_range.start)
             for k in e.kernels)
    return us / t.op_iters / 1e3


def idle_ms(reading, names) -> float | None:
    """Device-idle ms an iteration of the untraced window under the spans
    named: the untraced idle an iteration (the window's ``iter_s`` less the
    lean slice's busy time an iteration, as ``readers.idle_pct`` holds
    them), times the share of the full slice's idle that lies in gaps whose
    midpoint is inside a span named.  The full slice's own gaps stretch with
    the host's cost of recording each op, which differs from process to
    process; only their split comes from there."""
    t, per = reading["trace"], reading["readings"].get("iter_s")
    spans = _intervals(t, names) if _ready(t) else None
    if spans is None or not per or not t.device or not t.iters:
        return None
    busy = trace_lib.merged(t.op_device)
    gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:]) if b > a]
    total = sum(b - a for a, b in gaps)
    if total <= 0:
        return 0.0
    inside = sum(b - a for a, b in gaps if _covered(spans, (a + b) / 2))
    untraced = max(per - trace_lib.busy_s(t) / t.iters, 0.0)
    return inside / total * untraced * 1e3
