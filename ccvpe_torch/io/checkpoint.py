"""Full-state checkpoints and resume (counterpart of
``ccvpe_tpu/io/checkpoint.py``).

The reference saves model weights once per epoch and cannot resume its
optimizer (``train_VIGOR.py:159-163``).  Here the whole train state -- the
model's parameters and BatchNorm buffers, Adam's state and the step --
goes through ``torch.save`` into one file per step, ``ckpt_<step>.pt``,
so training can checkpoint every N steps and resume after preemption.
With bfloat16-resident parameters (``--bf16_params``) the file holds them
in bfloat16 beside the BN statistics in float32, and the optimizer's state
holds the float32 master next to both Adam moments; a restore is bit for
bit in either case, and refuses a file whose parameter dtypes are not the
live model's.  ``load_weights`` reads the model of the newest file for
inference (``api.load_model`` of a checkpoint directory).

Every file is written to a temporary name and renamed into place, so a
save cut short never shows as a step.  A sidecar ``latest_meta.json``
holds the newest save's position (epoch, completed); it is replaced only
after its step's state file has landed, and is trusted only for that step.
Saves are synchronous.  Under ``torch.distributed`` every rank gathers
the whole state (a ZeRO-1 optimizer's slices, ``parallel.zero``; an FSDP2
model's and its Adam's shards, ``parallel.distribute``) and rank 0 writes
it, then the sidecar: a checkpoint of any layout is the file a one-device
run writes, and restores into any layout (each rank reads the whole file
and keeps its own shards).

The JAX package's orbax checkpoints are not readable here: the format
the two packages share is the reference ``.pt`` of the weights
(``io.from_jax.load_state_dict``/``save_state_dict``).
"""

from __future__ import annotations

import json
import os
import re

import torch

from ..data.pipeline import _process_index
from ..parallel.distribute import (full_state, is_sharded, load_full_optimizer_state,
                                   load_full_state)
from ..parallel.mesh import is_distributed

META = "latest_meta.json"
_STEP_FILE = re.compile(r"^ckpt_(\d+)\.pt$")


def _atomic_write(path: str, write) -> None:
    """``write(tmp_path)``, then rename onto ``path`` (same directory)."""
    tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.{os.getpid()}.tmp")
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointManager:
    """Checkpoints of a ``train.loop.TrainState`` in ``directory``.

    ``max_to_keep``: the newest steps retained; ``None`` or 0 keeps every
    step (the reference keeps every epoch's file).  Only the process of
    rank 0 (``torch.distributed``; 0 without a process group) writes;
    under a process group every rank calls ``save``."""

    def __init__(self, directory: str, max_to_keep: int | None = 3):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep or None

    def path(self, step: int) -> str:
        return os.path.join(self._dir, f"ckpt_{int(step)}.pt")

    def save(self, step: int, state, wait: bool = True, meta: dict | None = None) -> None:
        """Write ``state``'s model, optimizer and step as ``step``, then the
        sidecar ``meta`` (when given), then drop steps past
        ``max_to_keep``.  Synchronous: ``wait`` is accepted for the JAX
        signature and has nothing to wait for."""
        # a collective under a process group: every rank gathers, rank 0
        # writes, and every rank returns once the file is there
        payload = {"step": int(state.step), "model": full_state(state.model.state_dict()),
                   "optimizer": full_state(state.optimizer.state_dict())}
        if _process_index() == 0:
            os.makedirs(self._dir, exist_ok=True)
            _atomic_write(self.path(step), lambda tmp: torch.save(payload, tmp))
            if meta is not None:
                self.save_meta(step, meta)
            if self.max_to_keep:
                for old in self.all_steps()[:-self.max_to_keep]:
                    os.remove(self.path(old))
        if is_distributed():
            torch.distributed.barrier()

    def save_meta(self, step: int, meta: dict) -> None:
        """(Re)write the sidecar for ``step``, whose state file must have
        landed -- e.g. to mark a mid-epoch save as the epoch's end."""
        if _process_index() != 0:
            return
        if not os.path.exists(self.path(step)):
            raise FileNotFoundError(f"no checkpoint of step {step} in {self._dir}: "
                                    "the sidecar follows its state file")

        def write(tmp):
            with open(tmp, "w") as f:
                json.dump({"step": int(step), **meta}, f)

        _atomic_write(os.path.join(self._dir, META), write)

    def meta(self, step: int) -> dict:
        """The sidecar written with ``step``'s save; ``{}`` when absent or
        written for another step."""
        try:
            with open(os.path.join(self._dir, META)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return {}
        return rec if rec.get("step") == int(step) else {}

    def all_steps(self) -> list[int]:
        """The steps on disk, ascending."""
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return []
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, names) if m)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state, step: int | None = None):
        """Load ``step`` (default: the latest) into ``state``'s live model
        and optimizer, on their device and in their memory format, bit for
        bit, and set ``state.step``; returns ``state``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        # onto the host: the model copies into its tensors in place and
        # Adam moves each moment to its parameter's device (keeping the
        # saved strides) and keeps ``step`` on the host, where it lives
        saved = torch.load(self.path(step), map_location="cpu", weights_only=True)
        live = state.model.state_dict()
        differ = sorted(k for k, v in saved["model"].items()
                        if k in live and v.dtype != live[k].dtype)
        if differ:
            raise ValueError(
                f"checkpoint {self.path(step)} holds {differ[0]} in "
                f"{saved['model'][differ[0]].dtype}, the model in {live[differ[0]].dtype} "
                f"({len(differ)} tensors differ): resume with the parameter dtype it "
                "was trained with (--bf16_params)")
        if is_sharded(state.model):
            load_full_state(state.model, saved["model"])
            load_full_optimizer_state(state.model, state.optimizer, saved["optimizer"])
        else:
            state.model.load_state_dict(saved["model"], strict=True)
            state.optimizer.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
        return state

    def load_weights(self, step: int | None = None) -> dict:
        """The model's state_dict saved at ``step`` (default: the latest), on
        the host, in the dtypes it was saved in."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)["model"]

    def close(self) -> None:
        """Nothing is in flight: saves are synchronous."""
