"""Process groups, meshes and the layout rules of the port (counterpart of
``ccvpe_tpu/parallel/mesh.py``).

The JAX package runs one program over a device mesh and lets GSPMD insert
the collectives.  The port runs PyTorch's own way: one process per GPU
(``torchrun --nproc_per_node N``), a ``torch.distributed`` process group,
DDP for data parallelism, a ZeRO-1 optimizer (``parallel.zero``) and FSDP2
over a ``(data, model)`` ``DeviceMesh`` for ``--n_model``.  What the JAX
mesh guarantees holds here too: per-device batch b on N devices reproduces
one device at batch bN -- BatchNorm statistics are global
(``nn.layers.BatchNorm2d``), the loss normalizers are global
(``train.losses.total_loss(global_mean=...)``), ``grad_accum``
microbatches are strided over the whole world, and ``n_model``/``zero1``
change where state lives, not the numbers.

Without a process group (or with one of a single rank) nothing here
issues a collective, and every caller takes its one-device path.

The layout rules are JAX's, applied in JAX's axis order: ``tree_shardings``
shards a tensor of at least ``min_size`` elements over the ``model`` axis
along its largest axis that the axis size divides; ``zero1_state_shardings``
does the same for the optimizer's tensors over the ``data`` axis, skipping
an axis already model-sharded.  ``jax_axis_order`` maps the port's tensor
layouts (OIHW convs, [I, O, kh, kw] transposed convs, [out, in] linears)
onto JAX's (HWIO, [I, kh, kw, O], [in, out]), so ``model_axes`` and
``zero1_axes`` name, in the port's layout, the axis JAX shards.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..utils.platform import env_platform

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the layout rules' threshold: tensors of fewer elements stay replicated
MIN_SIZE = 100_000

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def world_size() -> int:
    """The process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_distributed() -> bool:
    """True under a process group of more than one rank: the case in which
    the port issues collectives."""
    return world_size() > 1


# bytes this process has all-reduced through ``all_reduce_sum`` and
# ``all_reduce_mean`` (BatchNorm statistics, loss normalizers and parts);
# DDP's and FSDP2's gradient reductions are their own
_all_reduced_bytes = 0


def all_reduced_bytes() -> int:
    return _all_reduced_bytes


def reset_all_reduced_bytes() -> None:
    global _all_reduced_bytes
    _all_reduced_bytes = 0


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    global _all_reduced_bytes
    _all_reduced_bytes += t.numel() * t.element_size()
    dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The sum over the process group.  The objective of a data-parallel
    step is the sum of every rank's loss, so the gradient of a rank's input
    is the sum over ranks of the gradients of the output: the backward
    all-reduces the incoming gradient too."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the process group, differentiably (a collective in
    the backward as well); ``x`` itself without one."""
    return _AllReduceSum.apply(x) if is_distributed() else x


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the process group's ranks, without gradient;
    ``x`` itself without one."""
    if not is_distributed():
        return x
    return _all_reduce(x.detach().clone()) / world_size()


def maybe_init_distributed(backend: str | None = None) -> bool:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, ``LOCAL_RANK``); a
    no-op returning False when those are not set or a group exists.

    The backend is NCCL on CUDA and gloo on the CPU (``CCVPE_PLATFORM=cpu``
    or no CUDA); ``backend`` overrides it (gloo also carries CUDA tensors,
    which lets two ranks share one card).  On CUDA the rank's card,
    ``LOCAL_RANK``, becomes the current device before anything touches it,
    so ``resolve_device(None)`` means this rank's card.  The group's
    timeout is ``CCVPE_INIT_TIMEOUT`` seconds (default 300)."""
    if dist.is_initialized() or not all(os.environ.get(k) for k in _TORCHRUN_ENV):
        return False
    on_cuda = env_platform() != "cpu" and torch.cuda.is_available()
    if on_cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    backend = backend or ("nccl" if on_cuda else "gloo")
    timeout = datetime.timedelta(seconds=int(os.environ.get("CCVPE_INIT_TIMEOUT", "300")))
    dist.init_process_group(backend, timeout=timeout)
    return True


# Monotone count of finalize_run calls in this process.  The barrier names
# embed it, so runs made one after another in one process (the eval runner
# calls several CLI mains) each meet at a distinct barrier: a rank that
# skipped one raises naming both, instead of pairing run k with run k+1.
_finalize_count = 0


def finalize_count() -> int:
    """How many times ``finalize_run`` has been called in this process."""
    return _finalize_count


def finalize_run(tag: str = "run-complete") -> None:
    """The end-of-run barrier of every CLI, after its last visible effect
    (the final checkpoint, the results files); a no-op with fewer than two
    ranks.  Every rank hands in its barrier's name; names that differ
    raise.  The wait is bounded by ``CCVPE_SHUTDOWN_TIMEOUT`` seconds
    (default 900) on gloo (``monitored_barrier`` names a rank that never
    came), by the group's timeout otherwise."""
    global _finalize_count
    _finalize_count += 1
    name = f"ccvpe:{tag}:{_finalize_count}"
    if not is_distributed():
        return
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=datetime.timedelta(
            seconds=int(os.environ.get("CCVPE_SHUTDOWN_TIMEOUT", "900"))))
    names = [None] * world_size()
    dist.all_gather_object(names, name)
    if len(set(names)) != 1:
        raise RuntimeError(f"finalize_run out of step across ranks: {names}")


def create_mesh(n_data: int | None = None, n_model: int = 1, device_type: str | None = None):
    """A ``(data, model)`` ``DeviceMesh`` over the process group's ranks,
    rank r at ``(r // n_model, r % n_model)``; ``n_data`` defaults to
    ``world / n_model``.  ``device_type``: 'cuda' or 'cpu' (default: the
    current CUDA device when there is one and ``CCVPE_PLATFORM`` is not
    'cpu')."""
    from torch.distributed.device_mesh import init_device_mesh

    world = world_size()
    if n_model < 1 or world % n_model:
        raise ValueError(f"n_model={n_model} must be a positive divisor of the "
                         f"device count ({world})")
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"a {n_data}x{n_model} mesh needs {n_data * n_model} ranks, "
                         f"the process group has {world}")
    if device_type is None:
        device_type = "cuda" if env_platform() != "cpu" and torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def shard_batch(batch, index: int | None = None, count: int | None = None):
    """This rank's contiguous slice of a global batch: leading-axis rows
    ``[i*b/n, (i+1)*b/n)`` of every leaf (tensors, arrays; dicts, tuples and
    lists of them), as JAX's ``data_sharded`` splits it over the mesh.
    Returns the batch itself with one rank.  The loaders already hand each
    process its slice (``data.pipeline.Loader(multihost=True)``); this is
    for a batch that every rank holds whole."""
    index = rank() if index is None else index
    count = world_size() if count is None else count
    if count == 1:
        return batch

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(take(v) for v in x)
        b = x.shape[0]
        if b % count:
            raise ValueError(f"global batch {b} must be divisible by the {count}-device mesh")
        n = b // count
        return x[index * n:(index + 1) * n]

    return take(batch)


def _to_host(x):
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _concat(parts):
    first = parts[0]
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_concat([p[i] for p in parts]) for i in range(len(first)))
    return np.concatenate(parts, axis=0)


def fetch_global(tree):
    """Every rank's rows of a tree of small per-sample results, joined on
    the host in rank order (numpy), on every rank: the global value, as
    JAX's ``fetch_global`` materialises it.  The values go through the
    host as pickled objects, so this works over gloo with CUDA tensors.
    One process: the tree on the host."""
    local = _to_host(tree)
    if not is_distributed():
        return local
    parts = [None] * world_size()
    dist.all_gather_object(parts, local)
    return _concat(parts)


def replicate(module: nn.Module, devices) -> list[nn.Module]:
    """One copy of ``module`` per entry of ``devices`` (the first copy is
    ``module`` itself, moved there), channels_last as the model runs; the
    copies of one device are distinct modules."""
    import copy

    devices = [torch.device(d) for d in devices]
    copies = [module.to(device=devices[0], memory_format=torch.channels_last)]
    for d in devices[1:]:
        copies.append(copy.deepcopy(module).to(device=d, memory_format=torch.channels_last))
    return copies


# -- the layout rules ---------------------------------------------------------

def largest_divisible_axis(shape, n: int, skip: int | None = None) -> int | None:
    """The largest axis of ``shape`` that ``n`` divides, ties to the lower
    axis (JAX's ``sorted(range(len(shape)), key=lambda a: -shape[a])``);
    ``skip``: an axis already taken."""
    for ax in sorted(range(len(shape)), key=lambda a: -shape[a]):
        if ax != skip and shape[ax] % n == 0:
            return ax
    return None


def jax_axis_order(model: nn.Module) -> dict[str, tuple[int, ...]]:
    """For each parameter, the JAX axis that each of its axes holds
    (``io/from_jax``'s layout rules): convs OIHW <- HWIO, transposed convs
    [I, O, kh, kw] <- [I, kh, kw, O], linears [out, in] <- [in, out] (the
    satellite descriptor's input axis is JAX's, reordered within), 1-D
    tensors as they are."""
    order = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if p.dim() == 4 and isinstance(mod, nn.ConvTranspose2d):
                order[name] = (0, 3, 1, 2)
            elif p.dim() == 4:
                order[name] = (3, 2, 0, 1)
            elif p.dim() == 2:
                order[name] = (1, 0)
            else:
                order[name] = tuple(range(p.dim()))
    return order


def _port_axis(shape, perm, n: int, min_size: int | None,
               skip: int | None = None) -> int | None:
    min_size = MIN_SIZE if min_size is None else min_size
    if n <= 1 or not shape or int(np.prod(shape)) < min_size:
        return None
    jax_shape = [shape[perm.index(j)] for j in range(len(shape))]
    jax_skip = None if skip is None else perm[skip]
    ax = largest_divisible_axis(jax_shape, n, jax_skip)
    return None if ax is None else perm.index(ax)


def model_axes(model: nn.Module, n_model: int,
               min_size: int | None = None) -> dict[str, int | None]:
    """``tree_shardings`` on the parameters: for each parameter, the axis
    (in the port's layout) sharded over ``n_model`` devices, or None where
    JAX replicates it.  ``min_size`` defaults to ``MIN_SIZE``, JAX's."""
    order = jax_axis_order(model)
    return {k: _port_axis(tuple(p.shape), order[k], n_model, min_size)
            for k, p in model.named_parameters()}


def zero1_axes(model: nn.Module, n_data: int, min_size: int | None = None,
               taken: dict[str, int | None] | None = None) -> dict[str, int | None]:
    """``zero1_state_shardings`` on the optimizer's tensors (each
    parameter's Adam moments and float32 master have its shape): the axis
    sharded over ``n_data`` devices, or None where JAX replicates them.
    ``taken``: axes already model-sharded (``model_axes``), left alone."""
    order = jax_axis_order(model)
    taken = taken or {}
    return {k: _port_axis(tuple(p.shape), order[k], n_data, min_size, taken.get(k))
            for k, p in model.named_parameters()}
