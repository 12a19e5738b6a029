"""ZeRO-1: Adam with its state sharded over the data-parallel ranks
(counterpart of ``ccvpe_tpu/parallel/mesh.py::zero1_state_shardings``).

The parameters stay replicated and the gradients are DDP's all-reduced
ones, so the compute of a data-parallel step is unchanged.  Each tensor
that JAX's rule shards (``parallel.mesh.zero1_axes``: at least
``min_size`` elements, the largest axis the world size divides) keeps its
Adam moments -- and, for bfloat16-resident parameters, its float32 master
-- only for this rank's slice along that axis.  A step updates the slice,
writes it into the parameter and broadcasts each rank's slices from it
(one flat buffer per rank: broadcast is the collective that gloo carries
for CUDA tensors as well as NCCL).  Every other tensor is stepped whole on
every rank, as JAX replicates it.  Adam is elementwise, so the numbers are
the replicated optimizer's.

``state_dict`` gathers the moments (and masters) into the state of the
unsharded optimizer -- ``torch.optim.Adam``'s, or ``train.loop.F32MasterAdam``'s
with its ``master`` list -- on every rank, so a checkpoint is the one a
one-device run writes; ``load_state_dict`` takes that state and keeps this
rank's slices.  Both are collectives: every rank calls them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import rank, world_size


def _broadcast_slices(fulls: list[torch.Tensor], axes: list[int]) -> None:
    """Fill every rank's slice (``chunk(world, axis)[r]``) of each tensor of
    ``fulls`` from rank r, in place: one flat broadcast per rank."""
    world, me = world_size(), rank()
    if world == 1 or not fulls:
        return
    for dtype in sorted({t.dtype for t in fulls}, key=str):
        group = [(t, ax) for t, ax in zip(fulls, axes) if t.dtype == dtype]
        for src in range(world):
            views = [t.chunk(world, ax)[src] for t, ax in group]
            flat = torch.cat([v.reshape(-1) for v in views])
            dist.broadcast(flat, src=src)
            if src != me:
                for v, part in zip(views, flat.split([v.numel() for v in views])):
                    v.copy_(part.view(v.shape))


class Zero1Adam:
    """Adam (the reference's betas, optax's eps) over ``params`` with the
    state of each parameter whose ``axes`` entry is not None sharded along
    that axis over the process group's ranks (no ``axes``: nothing
    sharded).  ``master=True``: the parameters are bfloat16-resident and
    Adam steps float32 masters (``train.loop.F32MasterAdam``), taken from
    the parameters when the optimizer is made -- so make it on the float32
    parameters, before they are cast -- or given as ``masters``.
    Parameters without a gradient are left alone, as Adam leaves them."""

    def __init__(self, params, learning_rate: float = 1e-4, axes=None, master: bool = False,
                 masters=None):
        self.params = list(params)
        self.world, self.rank = world_size(), rank()
        self.axes = list(axes) if axes is not None else [None] * len(self.params)
        if len(self.axes) != len(self.params):
            raise ValueError(f"{len(self.axes)} axes for {len(self.params)} parameters")
        self.keeps_master = master
        # what Adam steps for each parameter: the parameter itself, or a
        # float32 copy of it or of this rank's slice of it (the master)
        if masters is not None:
            self.slots = list(masters)
        else:
            self.slots = [p if ax is None and not master else self._local(p.detach(), ax)
                          .float().clone() for p, ax in zip(self.params, self.axes)]
        self.inner = torch.optim.Adam(self.slots, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    @property
    def master(self) -> list[torch.Tensor]:
        """The float32 masters (this rank's slices of the sharded ones)."""
        return self.slots

    def _local(self, t: torch.Tensor, ax: int | None) -> torch.Tensor:
        return t if ax is None else t.chunk(self.world, ax)[self.rank]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        for p, s, ax in zip(self.params, self.slots, self.axes):
            if s is not p:
                s.grad = None if p.grad is None else self._local(p.grad, ax).float()
        self.inner.step()
        gathered = []
        for p, s, ax in zip(self.params, self.slots, self.axes):
            if s is p or s.grad is None:
                continue
            mine = self._local(p, ax)
            if p.dtype == torch.float32:
                mine.copy_(s)
            else:   # bf16(p + (m - p)), as optax.apply_updates leaves it
                pf = mine.float()
                mine.copy_(pf + (s - pf))
            if ax is not None:
                gathered.append((p, ax))
        _broadcast_slices([p.data for p, _ in gathered], [ax for _, ax in gathered])
        for p, s in zip(self.params, self.slots):
            if s is not p:
                s.grad = None

    def _full(self, locals_: list[torch.Tensor | None]) -> list[torch.Tensor | None]:
        """Whole tensors from this rank's slices (None stays None)."""
        fulls, sharded = [], []
        for t, p, ax in zip(locals_, self.params, self.axes):
            if t is None or ax is None:
                fulls.append(t)
                continue
            full = torch.zeros(p.shape, dtype=t.dtype, device=t.device)
            full.chunk(self.world, ax)[self.rank].copy_(t)
            fulls.append(full)
            sharded.append((full, ax))
        _broadcast_slices([f for f, _ in sharded], [ax for _, ax in sharded])
        return fulls

    def state_dict(self) -> dict:
        """The unsharded optimizer's state (Adam's; plus ``master``, the
        float32 masters in parameter order), on every rank; a collective
        when anything is sharded."""
        sd = self.inner.state_dict()
        state = sd["state"]
        for key in ("exp_avg", "exp_avg_sq"):
            full = self._full([state[i][key] if i in state else None
                               for i in range(len(self.params))])
            for i, t in enumerate(full):
                if t is not None:
                    state[i] = {**state[i], key: t}
        if self.keeps_master:
            sd["master"] = self._full(self.slots)
        return sd

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Take the unsharded optimizer's state (from any layout's
        checkpoint) and keep this rank's slices; the parameters must already
        hold the checkpoint's values."""
        state = dict(state)
        masters = state.pop("master", None)
        if self.keeps_master and masters is None:
            raise ValueError("the optimizer keeps a float32 master and the state has none")
        if self.keeps_master and len(masters) != len(self.params):
            raise ValueError(f"{len(masters)} masters for {len(self.params)} parameters")
        inner = {"param_groups": state["param_groups"],
                 "state": {i: {k: (self._local(v, ax) if k in ("exp_avg", "exp_avg_sq") else v)
                               for k, v in st.items()}
                           for i, st in state["state"].items()
                           for ax in [self.axes[int(i)]]}}
        for i, (p, s, ax) in enumerate(zip(self.params, self.slots, self.axes)):
            if s is not p:
                src = masters[i] if self.keeps_master else p
                s.copy_(self._local(src.to(s.device), ax))
        self.inner.load_state_dict(inner)
