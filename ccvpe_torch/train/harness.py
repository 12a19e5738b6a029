"""The trainer and evaluator of the three CLIs (counterpart of
``ccvpe_tpu/train/harness.py``).

One harness drives any dataset: host ``Loader`` -> ``device_prefetch``
(batch N+1 copied and assembled on a side stream while step N runs) ->
the train step; full-state checkpoints (``io.checkpoint``) every epoch and
every N steps; evaluation through the fused eval-readout step; and the
reference's results files (one scalar appended per epoch) plus a JSON
summary per epoch.

It runs on ``device`` (default ``cuda``: under ``torchrun``, this rank's
card).  Where the JAX trainer lays its state out over a device mesh, this
one runs as one process per device under ``torch.distributed``
(``parallel.mesh.maybe_init_distributed``): each rank loads its slice of
every global batch, the step is DDP's with global BatchNorm statistics
and loss normalizers (``train.loop``); ``zero1`` shards Adam's state over
the ranks (``parallel.zero``), ``n_model`` shards the model with FSDP2
(``parallel.distribute``); evaluation gathers every rank's readouts, so
every rank's summary is the global one, and rank 0 alone writes files.
Without a process group all of that is off and nothing is reduced.
``compute_dtype='bfloat16'`` trains in bfloat16, ``param_dtype='bfloat16'``
keeps the parameters in bfloat16 with a float32 master in the optimizer,
``remat`` recomputes the chosen scope in the backward (``train.loop``);
evaluation always takes float32 inputs, so bfloat16 parameters evaluate
cast to float32 at each op.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..data.pipeline import _process_index, device_prefetch
from ..io.checkpoint import CheckpointManager
from ..parallel import mesh
from ..utils import profiling
from . import loop as train_loop
from .metrics import PoseErrorAccumulator


def append_result(results_dir: str, name: str, epoch: int, value: float, header: str):
    """np.savetxt-append format of the reference (``train_VIGOR.py:221-241``)."""
    os.makedirs(results_dir, exist_ok=True)
    with open(os.path.join(results_dir, name), "ab") as f:
        np.savetxt(f, [value], fmt="%4f", header=header, comments=f"{epoch}_")


class Trainer:
    def __init__(self, model_cfg, *, learning_rate: float = 1e-4,
                 weight_info_nce: float = 1e4, weight_ori: float = 1e1,
                 checkpoint_dir: str | None = None, results_dir: str = "results",
                 label: str = "run", log_every: int = 200, seed: int = 17,
                 batch_size: int | None = None, profile_dir: str | None = None,
                 compute_dtype: str = "float32", remat: bool | str = False,
                 checkpoint_every_steps: int = 0, param_dtype: str = "float32",
                 matching_impl: str = "kernel", n_model: int = 1,
                 keep_checkpoints: int | None = 3, zero1: bool = False,
                 grad_accum: int = 1, device: str | torch.device | None = None):
        """The JAX trainer's arguments less ``mesh``, plus ``device``.
        ``matching_impl``: 'kernel' (the CUDA kernels on a CUDA device) or
        'plain'.  ``keep_checkpoints``: retained checkpoints, ``None``/0
        keeps every step.  ``checkpoint_every_steps``: also save mid-epoch
        (0: at epoch ends only).  ``batch_size`` is the global batch.

        Under a process group: ``n_model > 1`` shards the model over that
        many ranks with FSDP2 (``parallel.distribute``; with ``zero1`` too,
        over every rank); ``zero1`` shards Adam's state (and the float32
        master) over the ranks (``parallel.zero``).  Neither changes the
        numbers.  Without one (a single device) both are no-ops, as on a
        one-device JAX mesh."""
        world = mesh.world_size()
        if n_model < 1 or world % n_model:
            raise ValueError(f"n_model={n_model} must be a positive divisor of the "
                             f"device count ({world})")
        if batch_size and batch_size % n_model:
            raise ValueError(f"global batch {batch_size} must be divisible by "
                             f"n_model={n_model} (the batch shards over the whole mesh)")
        if batch_size and batch_size % grad_accum:
            raise ValueError(f"batch {batch_size} must be divisible by grad_accum={grad_accum}")
        if batch_size and batch_size % (world * grad_accum):
            raise ValueError(
                f"global batch {batch_size} with grad_accum={grad_accum} leaves "
                f"microbatches of {batch_size // grad_accum} that do not divide the "
                f"{world}-device mesh; every microbatch must divide the mesh "
                f"(batch % (mesh * grad_accum) == 0) or grouped-conv gradients mis-reduce")
        self.n_model = n_model
        self.zero1 = zero1
        self.model_cfg = model_cfg
        self.device = resolve_device(device)
        self.learning_rate = learning_rate
        self.results_dir = results_dir
        self.label = label
        self.log_every = log_every
        self.matching_impl = matching_impl
        # bfloat16-resident parameters keep a float32 master in the optimizer
        self.param_dtype = train_loop.as_dtype(param_dtype)
        self.compute_dtype = train_loop.as_dtype(compute_dtype)
        self.remat = remat
        # drop-connect draws; seeded once and, as the JAX trainer's PRNG
        # key, not restored on resume
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._train_step = train_loop.make_train_step(
            model_cfg, weight_info_nce=weight_info_nce, weight_ori=weight_ori,
            grad_accum=grad_accum, matching_impl=matching_impl, remat=remat,
            compute_dtype=compute_dtype)
        self._eval_steps: dict = {}
        self.ckpt = (CheckpointManager(checkpoint_dir, max_to_keep=keep_checkpoints or None)
                     if checkpoint_dir else None)
        self.state: train_loop.TrainState | None = None
        self.profile_dir = profile_dir
        self._profiled = False
        self.checkpoint_every_steps = checkpoint_every_steps
        self._global_step = 0
        # the newest step this run saved: every rank takes the same save
        # decisions (a save is a collective) from it, not from the disk
        self._saved_step = None
        # the epoch the CLI loop starts at; resume() takes it from the
        # checkpoint's sidecar
        self.start_epoch = 0

    # -- state ------------------------------------------------------------
    def init_state(self, seed: int = 17, pretrained_b0: str | None = None):
        """Seeded weights; ``pretrained_b0`` starts both encoders from a raw
        EfficientNet-B0 state_dict (``train.loop.create_train_state``)."""
        self.state = train_loop.create_train_state(
            self.model_cfg, seed=seed, device=self.device, learning_rate=self.learning_rate,
            param_dtype=self.param_dtype, pretrained_b0=pretrained_b0, **self._layout())
        return self.state

    def _layout(self) -> dict:
        return {"zero1": self.zero1, "n_model": self.n_model}

    def load_torch_checkpoint(self, path: str):
        """Weights from a reference-format ``.pt``, a fresh Adam, step 0."""
        from ..io.from_jax import load_state_dict

        self.state = train_loop.train_state_from_torch(
            load_state_dict(path), self.model_cfg, device=self.device,
            learning_rate=self.learning_rate, param_dtype=self.param_dtype, spec=path,
            **self._layout())
        return self.state

    def resume(self) -> bool:
        """Restore the latest checkpoint, if any.  A completed epoch resumes
        at the next one; a mid-epoch save re-runs its epoch from the start
        (the loader's order is keyed by epoch, not by step); a save without
        a sidecar resumes at epoch 0."""
        if not self.ckpt or self.ckpt.latest_step() is None:
            return False
        if self.state is None:
            self.init_state()
        step = self.ckpt.latest_step()
        self.ckpt.restore(self.state, step)
        self._global_step = self._saved_step = self.state.step
        meta = self.ckpt.meta(step)
        self.start_epoch = (int(meta["epoch"]) + bool(meta.get("completed"))
                            if "epoch" in meta else 0)
        return True

    # -- train ------------------------------------------------------------
    def train_epoch(self, loader, device_batch_fn: Callable, epoch: int) -> float:
        """One pass over ``loader``; returns train pairs/s (up to the last
        step's end, the end-of-epoch save left out).

        The global step advances every batch; a mid-epoch checkpoint every
        ``checkpoint_every_steps``; the end-of-epoch save is keyed by the
        global step, so epoch N restores as epoch N.  The running loss sums
        on the device: the only syncs are the ``log_every`` print and the
        checkpoint writes.  With ``profile_dir``, steps 10-13 (from step 0
        in epochs of 13 batches or fewer) are traced once into it.
        """
        assert self.state is not None, "call init_state() first"
        timer = profiling.StepTimer()
        running, t0, n, pairs = None, time.time(), 0, 0
        try:
            n_batches = len(loader)
        except TypeError:
            n_batches = None
        trace_start = 10 if (n_batches is None or n_batches > 13) else 0
        tracer = None
        feed = device_prefetch(loader, device_batch_fn, device=self.device)
        for i, batch in enumerate(feed):
            timer.start()
            if self.profile_dir and not self._profiled and i == trace_start:
                tracer = contextlib.ExitStack()
                tracer.enter_context(profiling.trace(self.profile_dir))
            parts = self._train_step(self.state, batch, self.generator)
            if tracer is not None and i == trace_start + 3:
                tracer.close()
                tracer, self._profiled = None, True
            loss = parts["loss"]
            running = loss if running is None else running + loss
            n += 1
            self._global_step += 1
            pairs += int(batch["gt"].shape[0]) * mesh.world_size()
            if (i + 1) % self.log_every == 0:
                avg = running.item() / n
                print(f"[{epoch}, {i + 1:5d}] loss: {avg:.3f} "
                      f"({pairs / (time.time() - t0):.1f} pairs/s)")
                running, n = None, 0
            if (self.ckpt and self.checkpoint_every_steps
                    and self._global_step % self.checkpoint_every_steps == 0):
                self.ckpt.save(self._global_step, self.state,
                               meta={"epoch": epoch, "completed": False})
                self._saved_step = self._global_step
            timer.stop()
        if tracer is not None:
            # the epoch ended inside the capture window
            tracer.close()
            self._profiled = True
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.time() - t0
        if self.ckpt:
            if self._saved_step != self._global_step:
                self.ckpt.save(self._global_step, self.state,
                               meta={"epoch": epoch, "completed": True})
                self._saved_step = self._global_step
            else:
                # a mid-epoch save landed on this very step: mark it as the
                # epoch's end so that resume starts at the next epoch
                self.ckpt.save_meta(self._global_step, {"epoch": epoch, "completed": True})
        stats = timer.summary()
        if stats:
            # host times: a step's issue and the wait for its batch; the
            # log_every and checkpoint steps absorb the device syncs
            print(f"epoch {epoch} step time: p50 {stats['p50_ms']:.0f} ms "
                  f"p95 {stats['p95_ms']:.0f} ms over {stats['steps']} steps")
        return pairs / max(elapsed, 1e-9)

    # -- eval -------------------------------------------------------------
    def _get_eval_step(self, loc_offsets, readout: bool = False):
        key = (tuple(loc_offsets) if loc_offsets is not None else None, readout)
        if key not in self._eval_steps:
            make = train_loop.make_eval_readout_step if readout else train_loop.make_eval_step
            self._eval_steps[key] = make(self.model_cfg, loc_offsets,
                                         matching_impl=self.matching_impl)
        return self._eval_steps[key]

    def evaluate(self, loader, device_batch_fn: Callable, *, meter_per_pixel,
                 loc_offsets=None, cities_to_mpp=None, with_heading: bool = False,
                 device_readout: bool = True) -> dict:
        """A full eval pass; returns the metric summary with ``pairs_per_sec``.

        ``meter_per_pixel``: a scalar, or None with ``cities_to_mpp`` to
        convert per sample from the batch's 'city' field (VIGOR, reference
        ``train_VIGOR.py:193-200``).  ``with_heading``: also the lateral and
        longitudinal errors from the batch's 'orientation_from_north'.

        ``device_readout``: reduce each sample to its pose scalars on the
        device (``make_eval_readout_step``) and fetch those, batch N's
        while batch N+1 runs; else fetch the full heatmaps (the same metrics
        except where two logits round to one softmax value).

        Under a process group each rank runs its slice of every batch and
        the results of all ranks are gathered (``parallel.mesh.fetch_global``)
        before they are counted, so every rank returns the global summary.
        """
        assert self.state is not None
        model = self.state.model
        step = self._get_eval_step(loc_offsets, readout=device_readout)
        acc = PoseErrorAccumulator()
        t0, pairs = time.time(), 0

        def mpp_of(raw, b):
            if cities_to_mpp is not None:
                return np.asarray([cities_to_mpp[c] for c in raw["city"]], np.float32)
            return np.full(b, meter_per_pixel, np.float32)

        if device_readout:
            def prepare(raw):
                batch = device_batch_fn(raw)
                batch["mpp"] = mpp_of(raw, int(batch["gt"].shape[0]))
                if with_heading:
                    batch["heading"] = torch.as_tensor(raw["orientation_from_north"],
                                                       dtype=torch.float32)
                return batch

            cuda = self.device.type == "cuda"

            def fetch(r):
                # batch N's scalars start for the host right behind its
                # forward; flush waits for that copy only, not for the
                # forward of batch N+1 issued after it
                host = {k: v.to("cpu", non_blocking=cuda) for k, v in r.items()}
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record()
                return host, done

            def flush(pending):
                nonlocal pairs
                (host, done), mpp = pending
                if done is not None:
                    done.synchronize()
                r = mesh.fetch_global({**{k: v.numpy() for k, v in host.items()}, "mpp": mpp})
                heading, mpp = r.pop("heading", None), r.pop("mpp")
                acc.update_from_readout(r, mpp, orientation_from_north=heading)
                pairs += len(mpp)

            pending = None
            for batch in device_prefetch(loader, prepare, device=self.device):
                r = step(model, batch["grd"], batch["sat"], batch["gt"], batch["orientation"])
                if with_heading:
                    r["heading"] = batch["heading"]
                current = (fetch(r), batch["mpp"])
                if pending is not None:
                    flush(pending)
                pending = current
            if pending is not None:
                flush(pending)
        else:
            for raw in loader:
                batch = device_batch_fn(raw)
                b = int(batch["gt"].shape[0])
                out = step(model, batch["grd"], batch["sat"])
                # the full-heatmap (parity) path gathers whole heatmaps from
                # every rank: heavy, but exact, as JAX's on a pod
                g = mesh.fetch_global({
                    "heatmap": out.heatmap, "gt": batch["gt"], "ori": out.ori,
                    "orientation": batch["orientation"], "mpp": mpp_of(raw, b),
                    "heading": (np.asarray(raw["orientation_from_north"], np.float32)
                                if with_heading else np.zeros(b, np.float32))})
                acc.update(g["heatmap"], g["gt"][..., None], g["ori"], g["orientation"],
                           g["mpp"], orientation_from_north=g["heading"] if with_heading else None)
                pairs += len(g["mpp"])
        summary = acc.summary()
        summary["pairs_per_sec"] = pairs / max(time.time() - t0, 1e-9)
        return summary

    def write_epoch_results(self, epoch: int, summary: dict, prefix: str = ""):
        """Append the epoch's four headline metrics to the reference's
        results files and the whole summary to ``{label}_{prefix}summary.json``;
        rank 0 only."""
        if _process_index() != 0:
            return
        mapping = {
            "mean_distance_m": "mean_distance_error",
            "median_distance_m": "median_distance_error",
            "mean_orientation_deg": "mean_orientation_error",
            "median_orientation_deg": "median_orientation_error",
        }
        for key, stem in mapping.items():
            if key in summary:
                append_result(self.results_dir, f"{self.label}_{prefix}{stem}.txt", epoch,
                              summary[key], f"{self.label}_{prefix}{stem}:")
        with open(os.path.join(self.results_dir, f"{self.label}_{prefix}summary.json"),
                  "a") as f:
            f.write(json.dumps({"epoch": epoch, **summary}) + "\n")
