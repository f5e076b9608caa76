"""Device mesh and sharding (counterpart of ``cmdgen_tpu/parallel/mesh.py``).

A ``(dp, tp)`` ``DeviceMesh`` over the processes of the default group (one
per GPU under ``torchrun``, ``parallel.launch``): the batch is split over
``dp``; ``tp_shard`` splits every eligible ``nn.Linear`` Megatron-style by
columns over ``tp``; ``fsdp_shard`` applies FSDP2's ``fully_shard`` over
``dp`` (ZeRO-3: weights, gradients and optimizer state each held once
across ``dp``), after ``tp_shard`` for the combined layout.

The JAX package states the same layouts as shardings and lets GSPMD place
the collectives. Here they are written out:

- A column-split weight is a DTensor ``Shard(0)`` on the ``tp`` mesh (a
  torch ``Linear`` weight is ``[out, in]``, so flax's split of the last
  axis of ``[in, out]`` is dim 0). ``column_parallel`` computes a rank's
  own output columns from the replicated input and all-gathers them; in
  the backward pass the input's gradient, which each rank holds a part
  of, is summed over ``tp``. The model's ``linear`` helper
  (``models/egnn.py``) takes this path for a sharded weight, so modules
  that read ``lin.weight`` through it need no hooks.
- FSDP2 shards dim 0 of each weight (uneven shards padded), where the JAX
  package shards the largest divisible axis: a layout difference, not a
  semantic one.
- Replicated weights (plain tensors, or the ``tp``-only DTensors) have
  their gradients averaged over ``dp`` by ``MeshPlan.average_grads``;
  FSDP's own reduce-scatter averages the weights it manages.

Optimizer state and the EMA are kept as each rank's local part of a weight
(``local``), so the multi-tensor updates never gather; ``full`` gathers a
part laid out as its weight, for evaluation and checkpoints, and
``shard_like`` cuts a whole tensor back into a part, for a resume.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple, Type

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Shard, distribute_tensor


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``(dp, tp)`` mesh over the default group's processes; ``dp``
    defaults to world size // tp (the JAX package's "all devices").
    Raises ValueError unless dp * tp is the world size."""
    world = dist.get_world_size()
    if dp is None:
        dp = world // tp
    if tp < 1 or dp < 1 or dp * tp != world:
        raise ValueError(f"dp*tp={dp * tp} must equal the world size {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))


def tp_eligible(shape: Sequence[int], tp: int) -> bool:
    """The JAX package's Megatron column-split test (``_tp_eligible``) on a
    flax-layout shape: its last axis divides by ``tp`` and is at least
    2 * tp wide."""
    return bool(tp > 1 and len(shape) and shape[-1] % tp == 0 and shape[-1] >= 2 * tp)


def linear_tp_eligible(lin: nn.Linear, tp: int) -> bool:
    """Whether ``lin``'s weight (flax kernel ``[in, out]``) and bias
    (``[out]``) are column-split: both by the width of the output."""
    return tp_eligible((lin.in_features, lin.out_features), tp)


def tp_shard(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Column-split every eligible ``nn.Linear`` of ``module`` over the
    mesh's ``tp`` axis, in place: its weight and bias become DTensors
    ``Shard(0)`` on ``mesh["tp"]``. A no-op at tp = 1."""
    tp_mesh = mesh["tp"]
    for lin in module.modules():
        if isinstance(lin, nn.Linear) and linear_tp_eligible(lin, tp_mesh.size()):
            for name in ("weight", "bias"):
                p = getattr(lin, name)
                if p is not None:
                    setattr(lin, name, nn.Parameter(
                        distribute_tensor(p.detach(), tp_mesh, [Shard(0)]),
                        requires_grad=p.requires_grad))
    return module


def fsdp_shard(module: nn.Module, mesh: DeviceMesh,
               blocks: Tuple[Type[nn.Module], ...]) -> nn.Module:
    """FSDP2 over the mesh's ``dp`` axis, in place: each submodule of a
    type in ``blocks`` is its own unit (gathered for its own forward and
    backward, activation checkpointing included), the rest of ``module``
    one more. Call it after :func:`tp_shard`."""
    from torch.distributed.fsdp import fully_shard

    dp_mesh = mesh["dp"]
    for m in list(module.modules()):
        if m is not module and isinstance(m, blocks):
            fully_shard(m, mesh=dp_mesh)
    fully_shard(module, mesh=dp_mesh)
    return module


# ----------------------------------------------------- tensor parallelism

def _tp_group(w: DTensor):
    names = w.device_mesh.mesh_dim_names
    if names != ("tp",):
        raise RuntimeError(f"a weight read outside its module's forward pass, on the mesh {names}")
    return w.device_mesh.get_group("tp")


class _SumGradOverTP(torch.autograd.Function):
    """Identity; the gradient, of which each tp rank computed a part, is
    summed over the group (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherOverTP(torch.autograd.Function):
    """The tp ranks' parts concatenated along ``dim``; the gradient's own
    part back (every rank holds the whole, equal, gradient)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.n, ctx.rank, ctx.dim = dist.get_world_size(group), dist.get_rank(group), dim
        parts = [torch.empty_like(x) for _ in range(ctx.n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.rank].contiguous(), None, None


def column_parallel(lin: nn.Linear, *xs: torch.Tensor):
    """``(xs, weight, bias, gather)`` for a Dense over inputs ``xs``.

    A plain weight comes back as it is with ``gather`` the identity. A
    column-split one (:func:`tp_shard`) comes back as this rank's rows of
    the weight and bias, the inputs marked so that their gradient sums
    over ``tp``, and ``gather`` all-gathering the output columns: the
    caller computes ``gather(f(xs, weight, bias))`` once for both."""
    w, b = lin.weight, lin.bias
    if not isinstance(w, DTensor):
        return xs, w, b, lambda y: y
    group = _tp_group(w)
    xs = tuple(_SumGradOverTP.apply(x, group) for x in xs)
    b = None if b is None else b.to_local()
    return xs, w.to_local(), b, lambda y: _GatherOverTP.apply(y, group, y.dim() - 1)


def full_weight(w: torch.Tensor) -> torch.Tensor:
    """The whole of a weight at its point of use: a column-split one
    gathered over ``tp`` (its gradient cut back to this rank's rows)."""
    if not isinstance(w, DTensor):
        return w
    return _GatherOverTP.apply(w.to_local(), _tp_group(w), 0)


# ------------------------------------------------------ local and whole

def local(t: torch.Tensor) -> torch.Tensor:
    """The part of ``t`` this rank holds, sharing its storage (``t``
    itself unless it is a DTensor)."""
    if isinstance(t, DTensor):
        with torch.no_grad():
            return t.to_local()
    return t


def full(t: torch.Tensor, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole tensor: a DTensor gathered; a plain ``t`` with ``like`` a
    DTensor is this rank's part of a tensor laid out as ``like`` and is
    gathered as one. Plain tensors come back as they are. Every rank of the mesh
    must call it."""
    with torch.no_grad():
        if isinstance(like, DTensor) and not isinstance(t, DTensor):
            t = DTensor.from_local(t, like.device_mesh, like.placements, run_check=False,
                                   shape=like.shape, stride=like.stride())
        return t.full_tensor() if isinstance(t, DTensor) else t


def shard_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's part of the whole tensor ``t`` laid out as ``like`` (a
    DTensor); ``t`` itself when ``like`` is plain."""
    if not isinstance(like, DTensor):
        return t
    return distribute_tensor(t.to(like.device), like.device_mesh, like.placements).to_local()


def holders(t: torch.Tensor, world: int) -> int:
    """How many ranks hold each element of ``t``: the world for a plain
    tensor, fewer by the size of every mesh axis a DTensor is split on."""
    if not isinstance(t, DTensor):
        return world
    shards = 1
    for i, pl in enumerate(t.placements):
        if not pl.is_replicate():
            shards *= t.device_mesh.size(i)
    return world // shards


def fsdp_managed(p: torch.Tensor) -> bool:
    """Whether FSDP holds ``p`` (a DTensor on a mesh with a ``dp`` axis)."""
    return isinstance(p, DTensor) and "dp" in (p.device_mesh.mesh_dim_names or ())


# -------------------------------------------------------------- the plan

@dataclasses.dataclass
class MeshPlan:
    """What a train step needs of the mesh: its rows of the batch, the
    gradient average over ``dp``, the full gradient norm and the metrics'
    mean over ``dp``. Each collective runs at every size, one rank
    included, so a world of one takes the same path as a larger one."""

    mesh: DeviceMesh

    @property
    def dp(self) -> int:
        return self.mesh["dp"].size()

    @property
    def dp_group(self):
        return self.mesh.get_group("dp")

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch; raises ValueError unless the
        batch divides by dp (as ``jax.device_put`` refuses it)."""
        if batch % self.dp:
            raise ValueError(f"batch {batch} does not divide by dp={self.dp}")
        n = batch // self.dp
        r = self.mesh.get_local_rank("dp")
        return slice(r * n, (r + 1) * n)

    def average_grads(self, params: Iterable[nn.Parameter]) -> None:
        """Average over ``dp``, in place and in one all-reduce, the
        gradients of the weights FSDP does not hold."""
        grads = [local(p.grad) for p in params if not fsdp_managed(p)]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.dp_group)
        flat /= self.dp
        torch._foreach_copy_(grads, [v.view_as(g) for v, g in
                                     zip(flat.split([g.numel() for g in grads]), grads)])

    def total_squares(self, squares: torch.Tensor, params: Sequence[torch.Tensor]) -> torch.Tensor:
        """Each weight's whole sum of squares [P] from this rank's parts'
        ``squares`` [P]: each part weighted by one over its number of
        holders and summed over the world, so every rank gets the same."""
        world = dist.get_world_size()
        share = torch.tensor([1.0 / holders(p, world) for p in params], device=squares.device)
        out = squares * share
        dist.all_reduce(out)
        return out

    def mean_over_dp(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """Scalars (each rank's batch means) averaged over ``dp``."""
        v = torch.stack([x.float() for x in values])
        dist.all_reduce(v, group=self.dp_group)
        return list(v / self.dp)
