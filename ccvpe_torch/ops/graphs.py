"""CUDA graphs replayed through a dispatcher operator, and launch counters
that count replays.

``Graph.capture(fn, pool)`` records what ``fn`` launches on the card into a
CUDA graph (``torch.cuda.graph`` into the memory pool ``pool``, with
``capture_error_mode="thread_local"`` so that a worker thread may capture
while other threads run) and returns ``fn``'s outputs: tensors in the pool
that every replay writes anew.  ``Graph.replay(x)`` replays it inside the
operator ``ccvpe::replay``, dispatched on ``x`` (a CUDA tensor the graph
reads), so a profiler attaches the graph's kernels to that operator and to
the spans around it, as it attaches the conv kernel to ``ccvpe::conv3x3``.

``count(counts, lock, key)`` is how a kernel wrapper counts a launch: on a
thread that is capturing a graph, or into a stream that one is capturing
(autograd's thread runs a captured backward there), into that graph's tally
(a capture runs nothing on the card); on any other, into ``counts`` under
``lock``.  Each replay adds its graph's tally to the counters, so they count
what ran on the card, launched eagerly or replayed.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import weakref

import torch

_LOCAL = threading.local()
# the tallies of the captures under way, by the stream each captures
_CAPTURING: dict[int, dict] = {}


def count(counts: dict, lock: threading.Lock, key) -> None:
    """One launch under ``key`` of ``counts`` (see the module docstring)."""
    tally = getattr(_LOCAL, "tally", None)
    if tally is None and _CAPTURING:
        tally = _CAPTURING.get(torch.cuda.current_stream().cuda_stream)
    if tally is not None:
        entry = tally.setdefault(id(counts), (counts, lock, {}))
        entry[2][key] = entry[2].get(key, 0) + 1
        return
    with lock:
        counts[key] += 1


@contextlib.contextmanager
def tallying(tally: dict):
    """Launches counted on this thread go to ``tally`` (by counter: the
    counter, its lock and launches by key) instead of their counters."""
    _LOCAL.tally = tally
    try:
        yield tally
    finally:
        _LOCAL.tally = None


def add_tally(tally: dict) -> None:
    """Add a tally's launches to their counters (a replay's)."""
    for counts, lock, keys in tally.values():
        with lock:
            for key, n in keys.items():
                counts[key] += n


# the graphs ``ccvpe::replay`` can reach, by handle (a graph goes with its owner)
_GRAPHS: weakref.WeakValueDictionary[int, "Graph"] = weakref.WeakValueDictionary()
_HANDLES = itertools.count()


class Graph:
    """One CUDA graph, its launches by counter and its handle."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.launches: dict = {}
        self.handle = next(_HANDLES)
        _GRAPHS[self.handle] = self

    def capture(self, fn, pool):
        """Capture ``fn()`` on the current device; its outputs."""
        with tallying(self.launches), torch.cuda.graph(self.graph, pool=pool,
                                                       capture_error_mode="thread_local"):
            stream = torch.cuda.current_stream().cuda_stream
            _CAPTURING[stream] = self.launches
            try:
                return fn()
            finally:
                del _CAPTURING[stream]

    def replay(self, x: torch.Tensor) -> None:
        torch.ops.ccvpe.replay(x, self.handle)


def _replay(x: torch.Tensor, handle: int) -> None:
    """The body of ``ccvpe::replay``: the graph on ``x``'s device."""
    graph = _GRAPHS[handle]
    with torch.cuda.device(x.device):
        graph.graph.replay()
    add_tally(graph.launches)


_LIB = torch.library.Library("ccvpe", "FRAGMENT")
_LIB.define("replay(Tensor x, int graph) -> ()")
_LIB.impl("replay", _replay, "CUDA")
