"""Train and eval steps (counterpart of ``ccvpe_tpu/train/loop.py``).

One train step: the CVM forward in train mode (BatchNorm on batch
statistics, running statistics updated; drop-connect when a generator is
given), the factored-GT objective in float32, backward (through the
matching kernels' ``autograd.Function`` on a CUDA device), and one Adam
update with the reference's hyperparameters.

    state = create_train_state(cvm.VIGOR, seed=0)            # on cuda
    step = make_train_step(cvm.VIGOR)
    parts = step(state, batch, generator)

Training options, as the JAX step takes them: ``remat`` (what the
backward recomputes: ``models.cvm.remat_scopes``), ``compute_dtype``
(bfloat16: the inputs, and so the forward and backward, in bfloat16; the
loss in float32), and bfloat16-resident parameters with a float32 master
in the optimizer (``create_train_state(param_dtype=torch.bfloat16)``,
``F32MasterAdam``).  ``pretrained_b0`` starts both encoders from a raw
EfficientNet-B0 state_dict.

Under a process group of more than one rank (``parallel.mesh``) the step
is one rank's share of a data-parallel step: the model runs under DDP
(or is an FSDP2 module, ``parallel.distribute``), BatchNorm's statistics
and the loss normalizers are the global batch's, and the loss parts and
``grad_norm`` it returns are the global ones -- the numbers of one device
at the global batch.  Without one, nothing here issues a collective.

The eval steps run the forward in eval mode without autograd:
``make_eval_step`` returns the model's outputs, ``make_eval_readout_step``
the per-sample pose scalars of ``ops.readout.pose_readout_from_outputs``.

``batch`` is the JAX step's dict, NHWC: ``grd`` and ``sat`` (ImageNet-
normalised floats), ``gt`` [B, H, W], ``bin_weights`` [B, bins],
``orientation`` [B, H, W, 2] (``ops.gt.synthesize_batch_factored``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

from .. import resolve_device
from ..models import cvm
from ..parallel import mesh
from ..parallel.zero import Zero1Adam
from ..utils.profiling import annotate
from . import losses


# profiler ranges of a train step (``utils.profiling.annotate``): the
# gradients' reset; forward and loss; the backward call, which returns once
# autograd's device threads have launched the whole backward (their ops lie
# outside every range of this thread); the gradient norm and Adam
ZERO_GRAD_RANGE = "train_step.zero_grad"
FORWARD_RANGE = "train_step.forward"
BACKWARD_RANGE = "train_step.backward"
OPTIMIZER_RANGE = "train_step.optimizer"


@dataclass
class TrainState:
    model: cvm.CVM
    optimizer: torch.optim.Optimizer
    step: int = 0
    # the DDP wrapper of ``model`` that the step runs under a process group
    ddp: object = field(default=None, repr=False, compare=False)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_dtype(dtype: str | torch.dtype | None) -> torch.dtype | None:
    """A torch dtype from its name ('float32', 'bfloat16'), or as given."""
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


def make_optimizer(params, learning_rate: float = 1e-4, f32_master: bool = False,
                   zero1_axes=None):
    """Adam with the reference's betas (0.9, 0.999); eps 1e-8 as optax's
    ``adam`` (whose ``eps_root`` is 0).  ``f32_master=True``: an
    ``F32MasterAdam`` over float32 copies of ``params`` as they are now,
    for parameters that are then cast to bfloat16.  ``zero1_axes`` (one
    entry per parameter, ``parallel.mesh.zero1_axes``): ZeRO-1, the state
    sharded over the process group (``parallel.zero.Zero1Adam``)."""
    params = list(params)
    if zero1_axes is not None:
        return Zero1Adam(params, learning_rate, zero1_axes, master=f32_master)
    if f32_master:
        return F32MasterAdam(params, learning_rate)
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


class F32MasterAdam(Zero1Adam):
    """Adam on float32 master copies of bfloat16-resident parameters (JAX
    ``train/loop.py::with_f32_master``): ``parallel.zero.Zero1Adam`` with
    every master whole.

    ``step`` casts each gradient to float32, steps Adam on the master, and
    sets the resident parameter as ``optax.apply_updates`` leaves it:
    ``bf16(p + (m - p))`` in float32, which is ``bf16(m)`` up to the
    rounding of the two float32 operations.  The masters are taken when the
    optimizer is made, so make it on the unrounded parameters, or pass
    them (``masters``: FSDP2 shards the parameters cast,
    ``parallel.distribute``).  Parameters without a gradient (the unused
    ``_fc`` heads) are left alone, as Adam leaves them.  ``state_dict`` is
    Adam's plus ``master``, the float32 copies in parameter order."""

    def __init__(self, params, learning_rate: float = 1e-4, masters=None):
        super().__init__(params, learning_rate, master=True, masters=masters)


def _state_for(model: cvm.CVM, device: torch.device, learning_rate: float,
               param_dtype: torch.dtype | None = None, zero1: bool = False,
               n_model: int = 1) -> TrainState:
    """The optimizer is made on the float32 parameters, then they are cast,
    not the buffers: the BN running statistics stay float32 (JAX
    ``create_train_state``: the master captures the unrounded copy).
    ``zero1``/``n_model``: the layouts of ``parallel.distribute``."""
    model = model.to(device=device, memory_format=torch.channels_last).train()
    param_dtype = as_dtype(param_dtype)
    master = param_dtype not in (None, torch.float32)
    if n_model > 1:
        from ..parallel.distribute import fsdp_state

        return fsdp_state(model, learning_rate, n_model=n_model, zero1=zero1, master=master)
    axes = None
    if zero1 and mesh.is_distributed():
        names = [k for k, _ in model.named_parameters()]
        rule = mesh.zero1_axes(model, mesh.world_size())
        axes = [rule[k] for k in names]
    optimizer = make_optimizer(model.parameters(), learning_rate, f32_master=master,
                               zero1_axes=axes)
    if master:
        for p in model.parameters():
            p.data = p.data.to(param_dtype)
    return TrainState(model, optimizer)


def create_train_state(cfg: cvm.CVMConfig, seed: int = 0,
                       device: str | torch.device | None = None,
                       learning_rate: float = 1e-4,
                       param_dtype: str | torch.dtype | None = None,
                       pretrained_b0: str | None = None, zero1: bool = False,
                       n_model: int = 1) -> TrainState:
    """A seeded model in train mode, channels_last on ``device`` (default
    ``cuda``; raises when CUDA is absent and no device was asked for), and
    its optimizer.

    ``param_dtype`` (bfloat16): resident parameters in that dtype, with a
    float32 master in the optimizer.  ``pretrained_b0``: a raw
    EfficientNet-B0 state_dict -- a local path, or ``auto`` /
    ``efficientnet-bN`` through the verified download cache
    (``io.pretrained.resolve``) -- into both encoders; a file that does not
    fit the preset raises ``ValueError`` naming its first mismatched keys.

    Under a process group, ``zero1`` shards the optimizer's state
    (``parallel.zero``) and ``n_model > 1`` shards the model with FSDP2
    (``parallel.distribute``); every rank makes the same seeded model."""
    device = resolve_device(device)
    model = cvm.CVM(cfg).init_weights_(torch.Generator().manual_seed(seed))
    if pretrained_b0 is not None:
        from ..io.from_jax import import_b0, load_state_dict
        from ..io.pretrained import resolve

        import_b0(model, load_state_dict(resolve(pretrained_b0)), pretrained_b0)
    return _state_for(model, device, learning_rate, param_dtype, zero1, n_model)


def train_state_from_torch(state_dict: dict, cfg: cvm.CVMConfig, *,
                           device: str | torch.device | None = None,
                           learning_rate: float = 1e-4,
                           param_dtype: str | torch.dtype | None = None,
                           spec: str = "state_dict", zero1: bool = False,
                           n_model: int = 1) -> TrainState:
    """A train state from a reference-format state_dict
    (``io.from_jax.load_state_dict``): its weights and BN statistics, a
    fresh Adam and step 0 (JAX ``train/loop.py::train_state_from_torch``).
    A state_dict that does not fit ``cfg`` raises ``ValueError`` naming
    its first mismatched keys (``spec`` names the file).  ``zero1``,
    ``n_model``: as ``create_train_state``."""
    from ..io.from_jax import check_shapes

    device = resolve_device(device)
    model = cvm.CVM(cfg)
    check_shapes(model.state_dict(), state_dict, spec, cfg.name)
    model.load_state_dict(state_dict, strict=True)
    return _state_for(model, device, learning_rate, param_dtype, zero1, n_model)


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


def _grad_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """The global norm, in float32 also over bfloat16 gradients (over an
    FSDP2 model's sharded gradients, ``parallel.distribute.grad_norm``)."""
    from ..parallel.distribute import grad_norm, is_dtensor

    if grads and is_dtensor(grads[0]):
        return grad_norm(grads)
    if any(g.dtype != torch.float32 for g in grads):
        grads = [g.float() for g in grads]
    return torch.nn.utils.get_total_norm(grads)


def _runner(state: TrainState):
    """What the step calls: the model, or under a process group its DDP
    wrapper (made once, then kept on the state); an FSDP2 model does its
    own reductions.  The unused ``_fc`` heads of both encoders (zeros that
    ``io/from_jax`` emits, never run) are kept out of DDP's reduction with
    its ignore list, so DDP neither waits for their gradients nor needs
    ``find_unused_parameters``'s graph walk each step.  The running
    statistics are already global (``nn.layers.BatchNorm2d``), so no
    buffer is broadcast."""
    from torch.distributed.fsdp import FSDPModule
    from torch.nn.parallel import DistributedDataParallel as DDP

    model = state.model
    if not mesh.is_distributed() or isinstance(model, FSDPModule):
        return model
    if state.ddp is None or state.ddp.module is not model:
        unused = [k for k, _ in model.named_parameters() if "._fc." in k]
        DDP._set_params_and_buffers_to_ignore_for_model(model, unused)
        device = next(model.parameters()).device
        ids = None
        if device.type == "cuda":
            ids = [device.index if device.index is not None else torch.cuda.current_device()]
        state.ddp = DDP(model, device_ids=ids, broadcast_buffers=False)
    return state.ddp


def _no_sync(runner, last: bool):
    """Skip the gradient reduction of every microbatch but the last."""
    if isinstance(runner, torch.nn.parallel.DistributedDataParallel) and not last:
        return runner.no_sync()
    if hasattr(runner, "set_requires_gradient_sync"):   # FSDP2
        runner.set_requires_gradient_sync(last)
    return contextlib.nullcontext()


def make_train_step(cfg: cvm.CVMConfig, *, weight_info_nce: float = 1e4,
                    weight_ori: float = 1e1, grad_accum: int = 1,
                    matching_impl: str = "kernel", remat: bool | str = False,
                    compute_dtype: str | torch.dtype = torch.float32):
    """The train step for ``cfg``: ``step(state, batch, generator=None)``
    updates ``state`` in place and returns the loss parts
    (``loss``, ``ce``, ``info_nce``, ``ori``) and ``grad_norm``, the global
    norm of the gradients before the update over the parameters that have
    one, as 0-d float32 tensors on the model's device.

    ``grad_accum=N`` splits the batch into N strided microbatches (sample i
    goes to microbatch i % N): BatchNorm normalises each microbatch and its
    running statistics chain through all N; gradients and loss parts are
    the microbatches' means; Adam steps once.  Under a process group each
    rank's batch is its slice of the global batch, its microbatches the
    strided slices of that, each microbatch normalised over every rank's
    (JAX ``loop.py:197-267``); the gradient reduction runs after the last.
    ``generator`` draws drop-connect (None: off; seed it alike on every
    rank).  ``matching_impl``: 'kernel' or 'plain', as
    ``CVM.forward`` takes it.  ``remat``: False, True/'all', 'encoder' or
    'decoder' (``models.cvm.remat_scopes``).  ``compute_dtype``: the dtype
    the images are cast to, and so the forward's and backward's; the loss
    parts stay float32."""
    cvm.remat_scopes(remat)
    compute_dtype = as_dtype(compute_dtype)

    def train_step(state: TrainState, batch: dict, generator: torch.Generator | None = None
                   ) -> dict[str, torch.Tensor]:
        model = state.model
        _check_model(model, cfg)
        b = batch["gt"].shape[0]
        world = mesh.world_size()
        if (b * world) % grad_accum:
            raise ValueError(f"batch {b * world} must be divisible by grad_accum={grad_accum}")
        if b % grad_accum:
            # JAX's check: a microbatch must divide the mesh
            raise ValueError(
                f"microbatch {b * world // grad_accum} (batch {b * world} / grad_accum="
                f"{grad_accum}) does not divide the {world}-device mesh; grouped-conv "
                f"gradients would mis-reduce — use a batch with batch % (mesh * "
                f"grad_accum) == 0")
        with annotate(ZERO_GRAD_RANGE):
            state.optimizer.zero_grad(set_to_none=True)
        runner = _runner(state)
        distributed = mesh.is_distributed()
        sums: dict[str, torch.Tensor] = {}
        with _mode(model, True):
            for j in range(grad_accum):
                mb = {k: v[j::grad_accum] for k, v in batch.items()}
                with _no_sync(runner, j == grad_accum - 1):
                    with annotate(FORWARD_RANGE):
                        out = runner(mb["grd"].to(compute_dtype), mb["sat"].to(compute_dtype),
                                     matching_impl=matching_impl, generator=generator,
                                     remat=remat)
                        loss, parts = losses.total_loss(
                            out, mb["gt"], mb["bin_weights"], mb["orientation"],
                            weight_info_nce=weight_info_nce, weight_ori=weight_ori,
                            global_mean=mesh.all_reduce_mean if distributed else None)
                    with annotate(BACKWARD_RANGE):
                        (loss / grad_accum).backward()
                for k, v in parts.items():
                    sums[k] = sums.get(k, 0) + v.detach()
        with annotate(OPTIMIZER_RANGE):
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            parts = {k: v / grad_accum for k, v in sums.items()}
            if distributed:
                # each rank's parts are its share of the global batch's
                keys = sorted(parts)
                mean = mesh.all_reduce_mean(torch.stack([parts[k] for k in keys]))
                parts = dict(zip(keys, mean.unbind()))
            parts["grad_norm"] = _grad_norm(grads)
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
