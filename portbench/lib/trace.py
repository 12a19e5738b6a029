"""What a ``torch.profiler`` capture of a run says: the device's busy time,
its idle gaps and what the host did in them, device time by kernel, and
device time under given host ops or ranges.

A kernel is attached to the host op that launched it (``FunctionEvent.kernels``),
whatever thread that op ran on; ``under`` walks each op's parents, so a
kernel counts under a range or an ATen op whenever one of its launching
op's ancestors matches.  Autograd's backward runs on its own thread,
outside every range that the forward opened.

``family`` is a frozen copy of ``ccvpe_torch.utils.trace_analysis.family``.
"""

from __future__ import annotations

import bisect
import collections
import re
import time
from typing import Callable, NamedTuple

import torch
from torch.autograd import DeviceType

BREAKDOWN_ENTRIES = 10


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


_WARP_ROW = re.compile(r"match_(?:warp|row)_kernel<[^,<>]+,\s*\d+,\s*(true|false)")


def matching_kernel(name: str) -> str | None:
    """'K1', 'K2' or None for a device kernel's name (``csrc/matching.cu``:
    ``match_tile_kernel`` is K1 and ``match_scores_tile_kernel`` K2; the warp
    and row templates serve both, K1 where their EPI argument is true)."""
    if "match_scores_tile_kernel" in name:
        return "K2"
    if "match_tile_kernel" in name:
        return "K1"
    m = _WARP_ROW.search(name)
    if m:
        return "K1" if m.group(1) == "true" else "K2"
    return None


class Trace(NamedTuple):
    """Two traced slices of a run's loop.  The lean slice (``iters``
    iterations, ``window_s`` host seconds) recorded device activity alone:
    ``device``, the (start us, end us, name) of every device op.  The full
    slice (``op_iters`` iterations) recorded host ops too: ``ops``, its
    host FunctionEvents sorted by start, and ``op_device``, its device ops.
    Recording host ops costs the host tens of microseconds an op, which
    would read as idle device time, so busy time, idle share and kernel
    times come from the lean slice, and which op or range launched a kernel
    from the full one."""
    window_s: float
    iters: int
    device: list
    ops: list
    op_iters: int
    op_device: list


def _device_ops(events, host_names) -> list:
    """A host range (``record_function``) also appears as a device-side span
    under its own name, covering its kernels and the gaps between them;
    those spans are left out, as ``ccvpe_torch.utils.trace_analysis`` leaves
    them out."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type != DeviceType.CPU and e.name not in host_names)


class Tracer:
    """Runs the two slices: ``start()`` before the first traced iteration,
    ``step()`` after each (or ``next_slice()`` for slices timed by the
    caller), ``finish()`` at the end."""

    def __init__(self, lean: int = 0, full: int = 0):
        self.lean, self.full = lean, full
        self.n = 0
        self.stage = None
        self.slices: dict = {}

    def _begin(self, stage: str) -> None:
        self.prof = profiler(host=stage == "full")
        self.prof.start()
        self.stage, self.t = stage, time.perf_counter()

    def _end(self) -> None:
        """The slice's window runs from its profiler's start to the end of
        the device work it launched (not over the profiler's stop)."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window = time.perf_counter() - self.t
        self.prof.stop()
        self.slices[self.stage] = (self.prof, window, self.n)
        self.stage = None

    def start(self) -> None:
        self._begin("lean")

    def next_slice(self) -> None:
        if self.stage == "lean":
            self._end()
            self._begin("full")
        elif self.stage == "full":
            self._end()

    def step(self) -> None:
        self.n += 1
        if (self.stage == "lean" and self.n == self.lean) or (
                self.stage == "full" and self.n == self.lean + self.full):
            self.next_slice()

    def finish(self, lean_iters: int | None = None, full_iters: int | None = None) -> Trace:
        """The trace; ``*_iters`` count the slices' iterations where the
        caller timed them (the number of dispatches, say)."""
        while self.stage is not None:
            self.next_slice()
        lean, window_s, n_lean = self.slices.get("lean", (None, 0.0, 0))
        full, _, n_end = self.slices.get("full", (None, 0.0, n_lean))
        events = full.events() if full is not None else []
        ops = sorted((e for e in events if e.device_type == DeviceType.CPU),
                     key=lambda e: e.time_range.start)
        names = {e.name for e in ops}
        device = _device_ops(lean.events(), names) if lean is not None else []
        return Trace(window_s, n_lean if lean_iters is None else lean_iters, device, ops,
                     n_end - n_lean if full_iters is None else full_iters,
                     _device_ops(events, names))


def merged(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for start, end, *_ in intervals:
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def busy_s(trace: Trace) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(b - a for a, b in merged(trace.device)) / 1e6


def under(trace: Trace, match: Callable[[str], bool]) -> float:
    """Device seconds of the full slice's kernels whose launching op, or one
    of its ancestors, has a name that ``match`` accepts."""
    total = 0.0
    for e in trace.ops:
        if not e.kernels:
            continue
        p = e
        while p is not None and not match(p.name):
            p = p.cpu_parent
        if p is not None:
            total += sum(k.duration for k in e.kernels)
    return total / 1e6


def kernel_s(trace: Trace) -> float:
    """Device seconds of every kernel that a host op of the full slice
    launched."""
    return sum(k.duration for e in trace.ops for k in e.kernels) / 1e6


def device_s_by(trace: Trace, label: Callable[[str], str | None]) -> dict[str, float]:
    """Device seconds by ``label(name)`` of each device op of the lean slice
    (None: left out)."""
    out: dict[str, float] = collections.defaultdict(float)
    for start, end, name in trace.device:
        key = label(name)
        if key is not None:
            out[key] += (end - start) / 1e6
    return dict(out)


def _host_label(trace: Trace, starts: list, t: float) -> str:
    """The innermost host op running at time ``t`` (the latest-starting op
    that still covers it, among the last few hundred that started)."""
    i = bisect.bisect_right(starts, t)
    for e in reversed(trace.ops[max(0, i - 400):i]):
        if e.time_range.end >= t:
            return e.name
    return "no host op"


def breakdown(trace: Trace) -> dict:
    """The device ops that took most time (lean slice), and the idle gaps
    summed by what the host was doing (full slice), each at most
    ``BREAKDOWN_ENTRIES`` entries of [name, seconds]."""
    def label(name):
        k = matching_kernel(name)
        return f"{k} {family(name)}" if k else family(name)[:160]

    ops = sorted(device_s_by(trace, label).items(), key=lambda kv: -kv[1])
    busy = merged(trace.op_device)
    gaps: dict[str, float] = collections.defaultdict(float)
    starts = [e.time_range.start for e in trace.ops]
    for (_, a), (b, _) in zip(busy, busy[1:]):
        if b > a:
            gaps[_host_label(trace, starts, (a + b) / 2)] += (b - a) / 1e6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n, s] for n, s in ops[:BREAKDOWN_ENTRIES]],
            "idle_gaps": [[n, s] for n, s in idle[:BREAKDOWN_ENTRIES]]}


def matching_launches(trace: Trace) -> dict:
    """Launches a traced iteration of K1 and K2, and the names of any
    ``match_*`` kernel that neither rule recognises."""
    counts: dict = collections.Counter()
    unknown = set()
    for _, _, name in trace.device:
        k = matching_kernel(name)
        if k:
            counts[k] += 1
        elif "match_" in name:
            unknown.add(name[:200])
    per = {k: v / max(trace.iters, 1) for k, v in counts.items()}
    return {"per_iteration": per, "unrecognised": sorted(unknown)}


def traced(one, lean: int, full: int) -> Trace:
    """``lean`` then ``full`` traced calls of ``one``, after one profiled and
    discarded call (``warm``)."""
    warm(one)
    tracer = Tracer(lean, full)
    tracer.start()
    for _ in range(lean + full):
        one()
        tracer.step()
    return tracer.finish()


def warm(fn) -> None:
    """Profile one call of ``fn`` and throw the capture away: the profiler's
    first start in a process (CUPTI's set-up, seconds long) then falls in
    the run's set-up and not in its traced window."""
    with profiler(host=True):
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def profiler(host: bool):
    """A profiler of device activity, and of host ops where ``host`` (on a
    machine without a card, of host ops alone), not yet started."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if host or not activities:
        activities.append(ProfilerActivity.CPU)
    return profile(activities=activities)
