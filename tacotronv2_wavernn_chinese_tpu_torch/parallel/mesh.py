"""The mesh of ranks, batch sharding, and the reductions a data-parallel
step makes explicit.

The JAX package puts its batches on a GSPMD mesh with dim 0 sharded over
the ``data`` axis and its parameters replicated; XLA then inserts every
collective the global program needs.  The port's params are plain dicts of
tensors and its steps are functions, so ``nn.parallel.DistributedDataParallel``
does not fit; the same global program is written out here instead.  A
data-parallel step over N ranks equals the one-process step on the global
batch because:

* every rank draws the step's random masks for the global batch from the
  same generator and keeps its own rows (``models.tacotron.shard_train_rand``);
* losses divide by global denominators (``batch_sum`` of the local counts),
  so a rank with fewer valid frames weighs what its frames weigh; a
  rank's loss is its share of the global loss, and the shares sum to it;
* train-mode BatchNorm takes its mean and variance over the global batch
  from all-reduced sums (``batch_sum_grad``: the backward all-reduces the
  cotangents, as SyncBatchNorm does), so every rank holds the same moving
  averages;
* the gradients are summed once, as one flat buffer (``batch_sum_tree``),
  before the clip, which then sees the global norm; the metrics are the
  summed shares, equal on every rank.

The task modules' ``compute_grads(..., mesh)`` enter ``data_parallel(mesh)``
and the model code reads the active data axis through ``batch_shards``,
``batch_sum``...: outside it, or where the axis holds no process group,
each helper is the identity and the step is the one-process step.  An
axis holds a group whenever a process group is up, a world of one
included (``make_mesh``): such a world runs the data-parallel step's code
and every collective of it over its one rank, which is how one card
checks that path against the one-process step.

The collectives that carry a gradient are three small autograd Functions
below rather than ``torch.distributed.nn.functional``'s: its
``all_gather`` backward sums the cotangents over the ranks, which double
counts where they are replicated (the model axis of ``parallel/tp.py``),
and its ``all_reduce`` is deprecated in current torch.

``Mesh`` is the small counterpart of ``jax.sharding.Mesh``: its axes, their
sizes, this rank's coordinate on each and the process group of each (None
where the axis runs no collective).  ``batch_sharding`` and ``replicated`` are
PartitionSpec-like descriptors.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..utils import tree_leaves, tree_map
from .distributed import host_shard, initialized


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    shape: dict  # axis -> number of ranks along it
    coords: dict  # axis -> this rank's index along it
    groups: dict  # axis -> process group, None where the axis runs no collective

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def make_mesh(axis: str = "data") -> Mesh:
    """Every rank of the process group on one axis; one rank and no group
    without a process group.  A world of one keeps its group, so a step
    on this mesh runs its collectives over that one rank."""
    rank, world = host_shard()
    group = dist.group.WORLD if initialized() else None
    return Mesh((axis,), {axis: world}, {axis: rank}, {axis: group})


def mesh_or_refuse(use_mesh: bool = True) -> Mesh | None:
    """The trainers' mesh: ``make_mesh()`` over several ranks, None for one
    process (the one-process step).  The JAX loops' ``use_mesh=False``
    asks for the one-device step; here one process takes it anyway, and
    under several ranks it is refused (ValueError): each rank would train
    the whole batch alone and every rank would write one log directory."""
    mesh = make_mesh()
    if mesh.size == 1:
        return None
    if not use_mesh:
        raise ValueError(f"use_mesh=False under a process group of {mesh.size} ranks: the one-process step "
                         "runs only in one process (start the trainer without a launcher)")
    return mesh


def batch_sharding(mesh: Mesh, axis: str = "data") -> tuple:
    """Dim 0 (batch or folds) sharded over ``axis``."""
    return (axis,)


def replicated(mesh: Mesh) -> tuple:
    return ()


# ---------------------------------------------------------------------------
# sharding and replication of trees
# ---------------------------------------------------------------------------


def shard_rows(x, n: int, i: int, dim: int = 0):
    """Block ``i`` of ``n`` equal blocks of ``x`` (tensor or ndarray) along
    ``dim``; ValueError when the size does not divide (as ``device_put``
    refuses an uneven split)."""
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not divide over {n} ranks")
    k = size // n
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, i * k, k)
    return np.take(x, np.arange(i * k, (i + 1) * k), axis=dim)


def _shard(mesh: Mesh, tree: Any, axis: str, dim: int) -> Any:
    n, i = mesh.shape[axis], mesh.coords[axis]

    def put(x):
        if getattr(x, "ndim", 0) > dim:
            return shard_rows(x, n, i, dim)
        return x

    return tree_map(put, tree)


def shard_batch(mesh: Mesh, tree: Any, axis: str = "data") -> Any:
    """This rank's rows (dim 0) of every array leaf of ``tree``."""
    return _shard(mesh, tree, axis, 0)


def shard_stacked_batch(mesh: Mesh, tree: Any, axis: str = "data") -> Any:
    """[K, B, ...] step-stacked batches: the step dim stays whole, this
    rank keeps its rows of the batch dim (1)."""
    return _shard(mesh, tree, axis, 1)


def _flat(tensors: list) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like: list) -> list:
    return [c.view_as(t) for c, t in zip(flat.split([t.numel() for t in like]), like)]


def replicate_tree(mesh: Mesh, tree: Any) -> Any:
    """Every tensor leaf broadcast from rank 0 (one flat buffer per dtype),
    so an init or a restored checkpoint agrees on every rank."""
    if mesh.size == 1:
        return tree
    leaves = [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    out = {}
    for dtype in {t.dtype for t in leaves}:
        group = [t for t in leaves if t.dtype == dtype]
        flat = _flat(group)
        dist.broadcast(flat, src=0)
        out.update({id(t): c.clone() for t, c in zip(group, _unflat(flat, group))})
    return tree_map(lambda t: out.get(id(t), t), tree)


# ---------------------------------------------------------------------------
# collectives over one axis
# ---------------------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the cotangents over it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumCotangents(torch.autograd.Function):
    """The identity whose backward sums the cotangents over the group: the
    input of a product split by output columns, whose cotangent each rank
    holds only its columns' part of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherColumns(torch.autograd.Function):
    """All-gather of column blocks along the last dim.  The backward keeps
    this rank's block of the cotangent: valid where everything after the
    gather is computed alike on every rank of the group (the model axis of
    ``parallel.tp``), so each rank holds the whole cotangent already."""

    @staticmethod
    def forward(ctx, x, group, n, i):
        ctx.n, ctx.i = n, i
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=-1)[ctx.i].contiguous(), None, None, None


def axis_sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum over ``axis`` of a tensor that carries no gradient."""
    if mesh.groups[axis] is None:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=mesh.groups[axis])
    return y


def axis_sum_grad(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum over ``axis`` whose backward sums the cotangents over it."""
    if mesh.groups[axis] is None:
        return x
    return _AllReduceSum.apply(x, mesh.groups[axis])


def sum_cotangents(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` unchanged; its cotangent summed over ``axis`` (see
    ``_SumCotangents``)."""
    if mesh.groups[axis] is None:
        return x
    return _SumCotangents.apply(x, mesh.groups[axis])


def gather_columns(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The blocks of ``axis`` concatenated along the last dim (see
    ``_GatherColumns`` for the backward's rule)."""
    n = mesh.shape[axis]
    if mesh.groups[axis] is None:
        return x
    return _GatherColumns.apply(x, mesh.groups[axis], n, mesh.coords[axis])


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The blocks of ``axis`` concatenated along dim 0 (no gradient)."""
    n = mesh.shape[axis]
    if mesh.groups[axis] is None:
        return x
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=mesh.groups[axis])
    return torch.cat(parts, dim=0)


def sum_tree(tree: Any, mesh: Mesh, axis: str) -> Any:
    """Every tensor leaf summed over ``axis`` as one flat all-reduce."""
    if mesh.groups[axis] is None:
        return tree
    leaves = tree_leaves(tree)
    flat = _flat(leaves)
    dist.all_reduce(flat, group=mesh.groups[axis])
    it = iter(_unflat(flat, leaves))
    return tree_map(lambda _: next(it), tree)


# ---------------------------------------------------------------------------
# the active data axis of a step
# ---------------------------------------------------------------------------

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("data_parallel_axis", default=None)


@contextlib.contextmanager
def data_parallel(mesh: Mesh | None, axis: str = "data"):
    """Run the enclosed step with its batch sharded over ``axis`` of
    ``mesh`` (None, or an axis without a group: the one-process step).
    Entered by the task modules' ``compute_grads``."""
    on = mesh is not None and mesh.groups.get(axis) is not None
    token = _ACTIVE.set((mesh, axis) if on else None)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def batch_sharded() -> bool:
    """True inside a data-parallel step."""
    return _ACTIVE.get() is not None


def batch_shards() -> int:
    """Ranks the active batch is sharded over (1 outside ``data_parallel``)."""
    active = _ACTIVE.get()
    return 1 if active is None else active[0].shape[active[1]]


def batch_index() -> int:
    """This rank's block of the active batch."""
    active = _ACTIVE.get()
    return 0 if active is None else active[0].coords[active[1]]


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active batch axis, without a gradient (counts,
    denominators, metrics)."""
    active = _ACTIVE.get()
    return x if active is None else axis_sum(x, *active)


def batch_sum_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the active batch axis, differentiably (the global
    BatchNorm moments)."""
    active = _ACTIVE.get()
    return x if active is None else axis_sum_grad(x, *active)


def batch_sum_tree(tree: Any) -> Any:
    """A gradient tree summed over the active batch axis in one flat
    all-reduce."""
    active = _ACTIVE.get()
    return tree if active is None else sum_tree(tree, *active)
