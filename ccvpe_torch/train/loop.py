"""Train and eval steps (counterpart of ``ccvpe_tpu/train/loop.py``).

One train step: the CVM forward in train mode (BatchNorm on batch
statistics, running statistics updated; drop-connect when a generator is
given), the factored-GT objective in float32, backward (through the
matching kernels' ``autograd.Function`` on a CUDA device), and one Adam
update with the reference's hyperparameters.

    state = create_train_state(cvm.VIGOR, seed=0)            # on cuda
    step = make_train_step(cvm.VIGOR)
    parts = step(state, batch, generator)

The eval steps run the forward in eval mode without autograd:
``make_eval_step`` returns the model's outputs, ``make_eval_readout_step``
the per-sample pose scalars of ``ops.readout.pose_readout_from_outputs``.

``batch`` is the JAX step's dict, NHWC: ``grd`` and ``sat`` (ImageNet-
normalised floats), ``gt`` [B, H, W], ``bin_weights`` [B, bins],
``orientation`` [B, H, W, 2] (``ops.gt.synthesize_batch_factored``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
from torch.profiler import record_function

from .. import resolve_device
from ..models import cvm
from . import losses


# profiler ranges of a train step: forward and loss; the gradient norm and
# Adam.  The backward runs on autograd's device threads, outside both.
FORWARD_RANGE = "train_step.forward"
OPTIMIZER_RANGE = "train_step.optimizer"


@dataclass
class TrainState:
    model: cvm.CVM
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params, learning_rate: float = 1e-4) -> torch.optim.Adam:
    """Adam with the reference's betas (0.9, 0.999); eps 1e-8 as optax's
    ``adam`` (whose ``eps_root`` is 0)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def _state_for(model: cvm.CVM, device: torch.device, learning_rate: float) -> TrainState:
    model = model.to(device=device, memory_format=torch.channels_last).train()
    return TrainState(model, make_optimizer(model.parameters(), learning_rate))


def create_train_state(cfg: cvm.CVMConfig, seed: int = 0,
                       device: str | torch.device | None = None,
                       learning_rate: float = 1e-4) -> TrainState:
    """A seeded model in train mode, channels_last on ``device`` (default
    ``cuda``; raises when CUDA is absent and no device was asked for), and
    its optimizer."""
    device = resolve_device(device)
    model = cvm.CVM(cfg).init_weights_(torch.Generator().manual_seed(seed))
    return _state_for(model, device, learning_rate)


def train_state_from_torch(state_dict: dict, cfg: cvm.CVMConfig, *,
                           device: str | torch.device | None = None,
                           learning_rate: float = 1e-4) -> TrainState:
    """A train state from a reference-format state_dict
    (``io.from_jax.load_state_dict``): its weights and BN statistics, a
    fresh Adam and step 0 (JAX ``train/loop.py::train_state_from_torch``)."""
    device = resolve_device(device)
    model = cvm.CVM(cfg)
    model.load_state_dict(state_dict, strict=True)
    return _state_for(model, device, learning_rate)


@contextlib.contextmanager
def _mode(model: torch.nn.Module, training: bool):
    """Run in train or eval mode and give the model back in the mode it had."""
    was = model.training
    model.train(training)
    try:
        yield
    finally:
        model.train(was)


def _check_model(model: cvm.CVM, cfg: cvm.CVMConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"a step built for {cfg.name} got a {model.cfg.name} model")


def make_train_step(cfg: cvm.CVMConfig, *, weight_info_nce: float = 1e4,
                    weight_ori: float = 1e1, grad_accum: int = 1,
                    matching_impl: str = "kernel"):
    """The train step for ``cfg``: ``step(state, batch, generator=None)``
    updates ``state`` in place and returns the loss parts
    (``loss``, ``ce``, ``info_nce``, ``ori``) and ``grad_norm``, the global
    norm of the gradients before the update over the parameters that have
    one, as 0-d float32 tensors on the model's device.

    ``grad_accum=N`` splits the batch into N strided microbatches (sample i
    goes to microbatch i % N): BatchNorm normalises each microbatch and its
    running statistics chain through all N; gradients and loss parts are
    the microbatches' means; Adam steps once.  ``generator`` draws
    drop-connect (None: off).  ``matching_impl``: 'kernel' or 'plain', as
    ``CVM.forward`` takes it."""

    def train_step(state: TrainState, batch: dict, generator: torch.Generator | None = None
                   ) -> dict[str, torch.Tensor]:
        model = state.model
        _check_model(model, cfg)
        b = batch["gt"].shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} must be divisible by grad_accum={grad_accum}")
        state.optimizer.zero_grad(set_to_none=True)
        sums: dict[str, torch.Tensor] = {}
        with _mode(model, True):
            for j in range(grad_accum):
                mb = {k: v[j::grad_accum] for k, v in batch.items()}
                with record_function(FORWARD_RANGE):
                    out = model(mb["grd"], mb["sat"], matching_impl=matching_impl,
                                generator=generator)
                    loss, parts = losses.total_loss(
                        out, mb["gt"], mb["bin_weights"], mb["orientation"],
                        weight_info_nce=weight_info_nce, weight_ori=weight_ori)
                (loss / grad_accum).backward()
                for k, v in parts.items():
                    sums[k] = sums.get(k, 0) + v.detach()
        with record_function(OPTIMIZER_RANGE):
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            parts = {k: v / grad_accum for k, v in sums.items()}
            parts["grad_norm"] = torch.nn.utils.get_total_norm(grads)
            state.optimizer.step()
        state.step += 1
        return parts

    return train_step


def make_eval_step(cfg: cvm.CVMConfig, loc_offsets=None, matching_impl: str = "kernel"):
    """The eval forward for ``cfg``: ``step(model, grd, sat) -> CVMOutputs``,
    BatchNorm on its running statistics, no autograd; ``loc_offsets`` and
    ``matching_impl`` as ``CVM.forward`` takes them (None: all bins).  The
    model keeps its mode."""

    def eval_step(model: cvm.CVM, grd: torch.Tensor, sat: torch.Tensor) -> cvm.CVMOutputs:
        _check_model(model, cfg)
        with _mode(model, False), torch.no_grad():
            return model(grd, sat, loc_offsets=loc_offsets, matching_impl=matching_impl)

    return eval_step


def make_eval_readout_step(cfg: cvm.CVMConfig, loc_offsets=None, matching_impl: str = "kernel"):
    """The eval forward fused with the pose readout (JAX
    ``train/loop.py::make_eval_readout_step``):
    ``step(model, grd, sat, gt, gt_orientation) -> dict`` of [B] tensors
    on the model's device (``ops.readout.pose_readout_from_outputs``: the
    peak from the logits, so no heatmap is read)."""
    from ..ops.readout import pose_readout_from_outputs

    forward = make_eval_step(cfg, loc_offsets, matching_impl)

    def eval_step(model: cvm.CVM, grd: torch.Tensor, sat: torch.Tensor, gt: torch.Tensor,
                  gt_orientation: torch.Tensor) -> dict[str, torch.Tensor]:
        out = forward(model, grd, sat)
        return pose_readout_from_outputs(out, gt, gt_orientation)

    return eval_step
