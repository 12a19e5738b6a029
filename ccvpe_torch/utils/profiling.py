"""Tracing and step timing (counterpart of ``ccvpe_tpu/utils/profiling.py``).

* ``trace(logdir)``: a ``torch.profiler`` capture of the enclosed block (the
  host and, on a CUDA device, the card), written to ``logdir`` as a Chrome
  trace (``trace.json``; open it in Perfetto or ``chrome://tracing``).
* ``annotate(name)``: a named range in that trace (``record_function``).
* ``StepTimer``: wall-clock step times with a percentile summary.

``utils/trace_analysis.py`` reads the trace back into the JAX package's
per-kernel report.  JAX's ``compilation_cache.py`` (XLA's persistent
compile cache) has no counterpart: see ``utils/platform.py``.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; on exit, wait for the card and write
    ``logdir/trace.json``.  Yields the ``torch.profiler.profile``."""
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    return record_function(name)


class StepTimer:
    def __init__(self):
        self._durations: list[float] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self._durations.append(time.perf_counter() - self._t0)
            self._t0 = None

    @contextlib.contextmanager
    def step(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self, skip_first: int = 1) -> dict:
        d = np.asarray(self._durations[skip_first:] or self._durations)
        if not len(d):
            return {}
        return {
            "steps": len(d),
            "mean_ms": float(d.mean() * 1e3),
            "p50_ms": float(np.percentile(d, 50) * 1e3),
            "p95_ms": float(np.percentile(d, 95) * 1e3),
        }
