"""``--n_model``: the model sharded with FSDP2 (counterpart of the JAX
trainer's ``tree_shardings`` placement, ``ccvpe_tpu/train/harness.py:51-101``),
and the full state of a sharded model or optimizer for checkpoints.

``n_model > 1`` lays the ranks out as a ``(data, model)`` mesh
(``parallel.mesh.create_mesh``) and shards the model with
``fully_shard``: replicated over ``data``, sharded over ``model``.  The
leaves that JAX's rule shards (``mesh.model_axes``) are sharded along the
same axis (in the port's layout); FSDP2 shards every other parameter too,
along its first axis -- where a tensor lives, not what it computes.  The
batch is split over all ranks, as JAX's ``data_sharded`` splits it over
both axes, and BatchNorm's statistics are global over all of them.  With
``zero1`` as well the mesh is one axis over the whole world: parameters,
gradients and Adam's state are all sharded over every rank (JAX shards the
optimizer's state over both axes).  bfloat16-resident parameters are
sharded in bfloat16, their float32 masters (``train.loop.F32MasterAdam``)
alike.  The numbers are those of one device.

``full_state`` turns the sharded tensors of a state_dict into whole ones
(a collective: every rank calls it), so a checkpoint of an FSDP2 run is
the file a one-device run writes; ``load_full_state`` and
``load_full_optimizer_state`` take such a file back into the sharded
layout, each rank keeping its own shard.
"""

from __future__ import annotations

import torch
from torch import nn

from . import mesh


def is_dtensor(x) -> bool:
    """True for a tensor FSDP2 has sharded (a ``DTensor``)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _sharded_dims(t) -> list[int]:
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(t.placements) if isinstance(p, Shard)]


def grad_norm(grads) -> torch.Tensor:
    """The global norm of FSDP2's sharded gradients, in float32: each rank's
    sum of squares of its shards, all-reduced over the sharded mesh
    dimensions (the shards of a replicated dimension are equal copies).
    The c10d all-reduce, not DTensor's functional one (see
    ``full_tensor``)."""
    import torch.distributed as dist

    sq = torch.stack([g.to_local().float().square().sum() for g in grads]).sum()
    for dim in _sharded_dims(grads[0]):
        dist.all_reduce(sq, group=grads[0].device_mesh.get_group(dim))
    return sq.sqrt()


def fsdp_state(model: nn.Module, learning_rate: float, *, n_model: int, zero1: bool,
               master: bool):
    """A ``train.loop.TrainState`` whose model is sharded with FSDP2 over
    the process group (``n_model`` ranks per model replica; with ``zero1``
    over every rank) and whose Adam steps the sharded parameters."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    from ..train import loop

    world = mesh.world_size()
    if zero1:
        device_mesh = init_device_mesh(_device_type(model), (world,),
                                       mesh_dim_names=(mesh.MODEL_AXIS,))
        axes = mesh.model_axes(model, world)
    else:
        device_mesh = mesh.create_mesh(n_model=n_model, device_type=_device_type(model))
        axes = mesh.model_axes(model, n_model)
    by_id = {id(p): axes[k] for k, p in model.named_parameters()}

    def placement(p):
        ax = by_id.get(id(p))
        return None if ax is None else Shard(ax)

    # the float32 values, before a bfloat16 cast, are the masters' start
    unrounded = [p.detach().clone() for p in model.parameters()] if master else None
    # FSDP2 shards contiguous tensors only: the convs' weights leave
    # channels_last (their gathered copies are contiguous in any case)
    for p in model.parameters():
        p.data = p.data.to(torch.bfloat16 if master else p.dtype).contiguous()
    fully_shard(model, mesh=device_mesh, reshard_after_forward=True,
                shard_placement_fn=placement)
    if not master:
        return loop.TrainState(model, loop.make_optimizer(model.parameters(), learning_rate))
    # bfloat16 parameters sharded; their float32 masters sharded alike
    masters = [_like(f, p, torch.float32) for f, p in zip(unrounded, model.parameters())]
    return loop.TrainState(model, loop.F32MasterAdam(model.parameters(), learning_rate,
                                                     masters=masters))


def _device_type(model: nn.Module) -> str:
    return next(model.parameters()).device.type


@torch.no_grad()
def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of ``t``: a DTensor sharded as FSDP2 shards
    (``Shard`` or ``Replicate`` on each mesh dimension; uneven shards as
    ``torch.chunk`` cuts them) is gathered with ``all_gather_into_tensor``
    over each sharded dimension's group -- a collective of every rank.
    ``DTensor.full_tensor`` is not used: its functional collectives crash
    over gloo on CUDA tensors (torch 2.11, H100).  Any other tensor is
    returned as it is."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(t):
        return t
    if any(not isinstance(p, (Shard, Replicate)) for p in t.placements):
        raise ValueError(f"full_tensor takes Shard/Replicate placements, not {t.placements}")
    out = t.to_local().detach()
    for mesh_dim, placement in enumerate(t.placements):
        if not isinstance(placement, Shard):
            continue
        group = t.device_mesh.get_group(mesh_dim)
        n, d = t.shape[placement.dim], placement.dim
        world = dist.get_world_size(group)
        chunk = -(-n // world)
        local = out.movedim(d, 0)
        padded = local.new_zeros((chunk, *local.shape[1:]))
        padded[:local.shape[0]] = local
        gathered = padded.new_empty((chunk * world, *local.shape[1:]))
        dist.all_gather_into_tensor(gathered, padded.contiguous(), group=group)
        out = gathered[:n].movedim(0, d)
    return out.contiguous()


def full_state(tree):
    """``tree`` (a state_dict, an optimizer's state) with every DTensor
    replaced by the whole tensor (``full_tensor``); a collective when
    there is one."""
    if isinstance(tree, dict):
        return {k: full_state(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_state(v) for v in tree)
    return full_tensor(tree)


def _like(full: torch.Tensor, like, dtype: torch.dtype | None = None):
    """``full`` laid out as the DTensor ``like`` (in ``dtype``, default
    ``like``'s): each rank keeps its shard of its own copy, nothing is
    sent."""
    from torch.distributed.tensor import distribute_tensor

    full = full.to(device=like.device, dtype=dtype or like.dtype)
    return distribute_tensor(full, like.device_mesh, like.placements, src_data_rank=None)


def is_sharded(model: nn.Module) -> bool:
    return any(is_dtensor(p) for p in model.parameters())


@torch.no_grad()
def load_full_state(model: nn.Module, state_dict: dict) -> None:
    """Load a whole-tensor state_dict into an FSDP2 model (strict)."""
    live = model.state_dict()
    if set(live) != set(state_dict):
        missing, extra = set(live) - set(state_dict), set(state_dict) - set(live)
        raise KeyError(f"state_dict keys differ: missing {sorted(missing)[:3]}, "
                       f"unexpected {sorted(extra)[:3]}")
    for k, v in live.items():
        if is_dtensor(v):
            v.to_local().copy_(_like(state_dict[k], v).to_local())
        else:
            v.copy_(state_dict[k])


def load_full_optimizer_state(model: nn.Module, optimizer, state: dict) -> None:
    """Load a whole-tensor Adam state (with ``master``: ``F32MasterAdam``'s)
    into the optimizer of an FSDP2 model: each moment and master laid out
    as its parameter, in float32."""
    params = list(model.parameters())
    state = {**state, "state": {
        i: {k: (_like(v, params[int(i)], torch.float32)
                if k != "step" and torch.is_tensor(v) and v.dim() else v)
            for k, v in st.items()}
        for i, st in state["state"].items()}}
    if "master" in state:
        state["master"] = [_like(v, p, torch.float32) for v, p in zip(state["master"], params)]
    optimizer.load_state_dict(state)
