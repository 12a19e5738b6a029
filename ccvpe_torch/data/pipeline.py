"""Generic prefetching input pipeline (counterpart of
``ccvpe_tpu/data/pipeline.py``).

In place of torch's ``DataLoader`` (reference ``train_VIGOR.py:90-93``): a
thread-pool host loader with a bounded prefetch queue.  Worker threads
decode and resize images (PIL releases the GIL for both), batches are
collated to numpy, and ``device_prefetch`` copies batch N+1 to the card and
assembles it on a side CUDA stream while step N runs.

Under ``torch.distributed`` the process count and index are its world size
and rank; without an initialised process group they are 1 and 0.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import resolve_device
# the ``torch.distributed`` world size and rank (1 and 0 without a group)
from ..parallel.mesh import rank as _process_index, world_size as _process_count


def collate(samples: list[dict]) -> dict:
    """Stack a list of per-sample dicts into arrays (object dtype for str)."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], str) or (
                isinstance(vals[0], np.ndarray) and vals[0].dtype.kind == "U"):
            out[key] = np.asarray(vals)
        else:
            out[key] = np.stack([np.asarray(v) for v in vals])
    return out


class Loader:
    """Iterable over collated batches with background prefetch.

    Args:
      sample_fn: idx -> dict of numpy values.
      indices: epoch's sample order.
      batch_size: global batch size.
      num_workers: decode threads.
      prefetch: max batches resident in the queue.
      drop_last: drop the trailing partial batch (keeps the batch shape fixed).
      multihost: under ``torch.distributed``, load only this process's
        strided slice of the order at ``batch_size / process_count`` per
        process. No-op in a single process.
      native_batch: decode whole batches in the C++ loader
        (``native_loader.load_batch``, one call per batch per image size —
        no per-image Python/PIL round-trips) via the sampler's
        ``plan``/``assemble`` protocol.  ``None`` (default) follows the
        ``CCVPE_NATIVE_LOADER=1`` env gate; requires the sampler to expose
        ``plan``/``assemble`` and the library to build, else falls back to
        the per-sample thread pool.
      fast_decode: DCT-scaled JPEG decode inside the native batch path
        (``None`` follows ``CCVPE_FAST_DECODE=1``).  2-4x faster host decode
        for training feeds; near- but not bit-identical to PIL, so never used
        for checkpoint-parity eval.
    """

    def __init__(self, sample_fn, indices, batch_size: int,
                 num_workers: int = 8, prefetch: int = 4,
                 drop_last: bool = True, multihost: bool = False,
                 native_batch: bool | None = None,
                 fast_decode: bool | None = None):
        if multihost:
            pc = _process_count()
            if pc > 1:
                indices = multihost_indices(indices, batch_size)
                batch_size //= pc
        self.sample_fn = sample_fn
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.drop_last = drop_last
        if native_batch is None:
            import os

            native_batch = os.environ.get("CCVPE_NATIVE_LOADER", "0") == "1"
        if native_batch:
            from . import native_loader

            native_batch = (native_loader.available()
                            and hasattr(sample_fn, "plan")
                            and hasattr(sample_fn, "assemble"))
        self.native_batch = bool(native_batch)
        if fast_decode is None:
            import os

            fast_decode = os.environ.get("CCVPE_FAST_DECODE", "0") == "1"
        # fast DCT-scaled JPEG decode: training-feed only (near- but not
        # bit-identical to PIL full decode); requires the native batch path
        self.fast_decode = bool(fast_decode) and self.native_batch

    def __len__(self):
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self):
        n = len(self.indices)
        end = n - n % self.batch_size if self.drop_last else n
        for i in range(0, end, self.batch_size):
            yield self.indices[i:i + self.batch_size]

    def _native_batch_samples(self, batch_idx) -> dict:
        """Decode every image a batch needs in one C++ call per image size;
        Python only plans (RNG + paths) and assembles (GT scalars)."""
        from . import native_loader

        plans = [self.sample_fn.plan(i) for i in batch_idx]
        groups: dict = {}  # (h, w) -> [(plan_pos, request_key, path)]
        for i, plan in enumerate(plans):
            for key, (path, hw) in plan["requests"].items():
                groups.setdefault(tuple(hw), []).append((i, key, path))
        images: list[dict] = [{} for _ in plans]
        for hw, items in groups.items():
            out, statuses, raw = native_loader.load_batch(
                [p for _, _, p in items], hw, n_threads=self.num_workers,
                return_sizes=True, fast=self.fast_decode)
            for (i, key, _), img, st, rhw in zip(items, out, statuses, raw):
                images[i][key] = (img, int(st), (int(rhw[0]), int(rhw[1])))
        return collate([self.sample_fn.assemble(p, im)
                        for p, im in zip(plans, images)])

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        # consumer-gone signal: a consumer that abandons iteration mid-epoch
        # (early-stop eval, exception in the train loop) sets this, and the
        # producer's bounded put stops blocking instead of pinning `prefetch`
        # batches of memory until process exit
        closed = threading.Event()

        def put(item) -> bool:
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                if self.native_batch:
                    for batch_idx in self._batches():
                        if not put(self._native_batch_samples(batch_idx)):
                            return
                    return
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in self._batches():
                        samples = list(pool.map(self.sample_fn, batch_idx))
                        if not put(collate(samples)):
                            return
            except BaseException as e:  # surface worker errors to the consumer
                put(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
            thread.join()
        finally:
            # runs on GeneratorExit too (consumer broke out of the loop):
            # release the producer, then drain so its pending put unblocks
            closed.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=30)
            if thread.is_alive():
                # a producer wedged in sample_fn (stuck I/O) outlives the
                # iterator; make the leak visible instead of silent
                import warnings

                warnings.warn(
                    "Loader producer thread still alive 30s after the "
                    "consumer abandoned iteration (sample_fn stuck?); "
                    "thread leaked", RuntimeWarning)


def _to_device(raw: dict, device: torch.device) -> dict:
    """The numeric arrays of a host batch as tensors on ``device``; string
    arrays stay numpy.  To a CUDA device each array goes through pinned
    memory with a non-blocking copy on the current stream."""
    out = {}
    for key, v in raw.items():
        if isinstance(v, np.ndarray) and v.dtype.kind in "biuf":
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory()
            out[key] = t.to(device, non_blocking=True)
        else:
            out[key] = v
    return out


def device_prefetch(iterable, fn, depth: int = 1, device=None):
    """Map ``fn`` over host batches with a lookahead on the device.

    A producer thread copies each collated host batch to ``device`` (default
    ``cuda``) and applies ``fn`` to it (the dataset's ``device_batch``, which
    returns a dict of tensors), so
    batch N+1's copy and assembly run while the consumer's step N does.  On
    a CUDA device that work runs on a side stream, from pinned host memory
    with non-blocking copies; an event recorded after ``fn`` is waited on by
    the consumer's current stream before the batch is handed over, and
    every tensor handed over is ``record_stream``-ed on that stream, so the
    caching allocator does not give its memory to the side stream while the
    consumer still reads it.  ``depth`` bounds the batches delivered but not
    yet taken (device memory: at most ``depth + 2`` input batches resident,
    queued, consumed and being built).

    Errors in ``fn`` or the upstream iterable propagate to the consumer;
    abandoning iteration releases the producer.
    """
    device = resolve_device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    closed = threading.Event()

    def put(item) -> bool:
        while not closed.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def build(raw):
        if not cuda:
            return fn(_to_device(raw, device)), None
        with torch.cuda.device(device), torch.cuda.stream(side):
            batch = fn(_to_device(raw, device))
            done = torch.cuda.Event()
            done.record(side)
        return batch, done

    def produce():
        try:
            for item in iterable:
                if not put(build(item)):
                    return
        except BaseException as e:
            put(e)
        finally:
            put(sentinel)

    thread = threading.Thread(target=produce, daemon=True,
                              name="device-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            batch, done = item
            if done is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(done)
                for t in batch.values():
                    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                        t.record_stream(stream)
            yield batch
        thread.join()
    finally:
        closed.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=30)
        if thread.is_alive():
            import warnings

            warnings.warn(
                "device_prefetch producer thread still alive 30s after "
                "the consumer abandoned iteration; thread leaked",
                RuntimeWarning)


def epoch_indices(n: int, *, shuffle: bool, rng: np.random.Generator):
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    return idx


def multihost_indices(indices, global_batch_size: int,
                      process_index: int | None = None,
                      process_count: int | None = None):
    """This host's epoch slice under multi-host input sharding.

    Truncates to a whole number of GLOBAL batches first — otherwise hosts
    can end up with different local batch counts after drop_last and the
    SPMD loop desyncs (one host dispatches a step the others never join) —
    then takes this process's strided slice."""
    pc = _process_count() if process_count is None else process_count
    if global_batch_size % pc:
        raise ValueError(
            f"global batch {global_batch_size} must divide across "
            f"{pc} processes")
    indices = np.asarray(indices)
    usable = len(indices) - len(indices) % global_batch_size
    return shard_for_process(indices[:usable], process_index, pc)


def shard_for_process(indices, process_index: int | None = None,
                      process_count: int | None = None):
    """Multi-host input sharding: each host loads only its slice of the
    global batch order (strided so every host sees the same epoch
    distribution)."""
    pi = _process_index() if process_index is None else process_index
    pc = _process_count() if process_count is None else process_count
    if pc == 1:
        return indices
    return np.asarray(indices)[pi::pc]


def train_val_split(n: int, val_fraction: float = 0.2, seed: int = 0):
    """Reference's 80/20 shuffled split (``train_VIGOR.py:82-91``, which uses
    ``np.random.seed(0)`` then ``np.random.shuffle``)."""
    rng = np.random.RandomState(seed)
    idx = np.arange(n)
    rng.shuffle(idx)
    cut = int(n * (1 - val_fraction))
    return idx[:cut], idx[cut:]
