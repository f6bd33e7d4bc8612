"""Tensor parallelism (DP x TP) for WaveRNN training.

The mesh has a ``data`` axis (batch rows, as in ``parallel/mesh.py``) and
a ``model`` axis.  Every rank keeps the column block (last axis) of each
weight of ndim >= 2 under ``TP_MODULES`` (the I projection, the two GRUs'
gate kernels, fc1-fc3), and Adam's moments of those leaves alike; biases,
the conditioning network and the step counters stay whole on every rank.
The JAX package gets this from GSPMD by placement alone; here
``wavernn_task.train_step`` runs the same step with the layers of
``layers(mesh)``:

* I and fc1-fc3 are column-parallel: a rank multiplies the (whole) input
  by its weight columns and the output blocks are all-gathered along the
  feature axis (``mesh.gather_columns``, whose backward keeps the rank's
  block of the cotangent), with the bias added after; the input's
  cotangent, of which a rank holds only its columns' part, is summed over
  ``model`` (``mesh.sum_cotangents``).  Everything between the gathers
  runs alike on every rank of ``model``.
* The GRUs all-gather their weight blocks and run cuDNN's GRU at full
  width.  GSPMD instead gathers the activations inside JAX's scan, once a
  timestep; over a 1,375-sample window that would be thousands of
  collectives a step, against two gathers per GRU here.
* The gradients are summed over ``data`` (one flat all-reduce); each rank
  keeps its columns.  The clip's global norm counts a sharded leaf's
  blocks once each (a sum over ``model``) and a whole leaf once, not once
  per rank (``global_norm``).

The GRU gate axis [3H] splits into blocks that straddle the (r, z, n)
gates unless tp divides into them; the gather restores the full kernel,
so any tp that divides the widths (``tp_divisible``) gives the unsharded
step's values.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from ..models import layers as L
from . import mesh as PM
from .distributed import host_shard

# param-tree keys whose ndim >= 2 leaves shard their last axis over "model"
TP_MODULES = ("gru1", "gru2", "fc1", "fc2", "fc3", "I")


def make_mesh_2d(dp: int | None = None, tp: int = 2) -> PM.Mesh:
    """Ranks laid out dp x tp, row-major (rank = d * tp + m), with a process
    group for each ``data`` column and each ``model`` row.  Every rank
    creates every group, in the same order."""
    rank, world = host_shard()
    if dp is None:
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"dp {dp} x tp {tp} != world size {world}")
    d, m = divmod(rank, tp)
    groups = {"data": None, "model": None}
    for axis, n_groups, size, ranks_of, mine in (
        ("data", tp, dp, lambda j: [i * tp + j for i in range(dp)], m),
        ("model", dp, tp, lambda i: [i * tp + j for j in range(tp)], d),
    ):
        if size == 1:
            continue
        for j in range(n_groups):
            g = dist.group.WORLD if size == world else dist.new_group(ranks_of(j))
            if j == mine:
                groups[axis] = g
    return PM.Mesh(("data", "model"), {"data": dp, "model": tp}, {"data": d, "model": m}, groups)


def model_parallel(mesh: PM.Mesh | None) -> bool:
    return mesh is not None and mesh.shape.get("model", 1) > 1


def tp_divisible(cfg, tp: int) -> bool:
    """Every column-sharded output axis divides by ``tp``."""
    wc = cfg.wavernn
    n_classes = 2 ** cfg.audio.bits if wc.mode == "RAW" else 30
    return wc.rnn_dims % tp == 0 and wc.fc_dims % tp == 0 and n_classes % tp == 0


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _sharded(path, leaf) -> bool:
    return any(k in TP_MODULES for k in path) and getattr(leaf, "ndim", 0) >= 2


def _spec(mesh: PM.Mesh, path, leaf) -> tuple:
    """The leaf's PartitionSpec-like descriptor; ValueError when its
    sharded axis does not divide."""
    if not _sharded(path, leaf):
        return ()
    tp = mesh.shape["model"]
    if leaf.shape[-1] % tp:
        name = "/".join(map(str, path))
        raise ValueError(f"TP axis size {tp} does not divide the sharded output axis {leaf.shape[-1]} of "
                         f"{name}; pick tp with tp_divisible(cfg, tp)")
    return (None,) * (leaf.ndim - 1) + ("model",)


def wavernn_state_shardings(mesh: PM.Mesh, state) -> Any:
    """The descriptor tree of a WaveRNN ``TrainState``: params and Adam's
    moments shard alike, the counters replicate."""
    spec = lambda tree, prefix: _map_with_path(lambda p, x: _spec(mesh, prefix + p, x), tree)
    opt = state.opt_state
    return type(state)((), spec(state.params, ()),
                       {"count": (), "mu": spec(opt["mu"], ("mu",)), "nu": spec(opt["nu"], ("nu",))})


def _place(mesh: PM.Mesh, tree, prefix=()):
    """This rank's column block of every sharded leaf of a whole tree."""
    tp, m = mesh.shape["model"], mesh.coords["model"]
    return _map_with_path(
        lambda p, x: x.chunk(tp, dim=-1)[m].contiguous() if _spec(mesh, prefix + p, x) else x, tree)


def place_wavernn_state(mesh: PM.Mesh, state):
    """A whole WaveRNN ``TrainState`` (equal on every rank) -> this rank's
    state: the column block of every sharded leaf of the params and of
    Adam's moments."""
    opt = state.opt_state
    return type(state)(state.step, _place(mesh, state.params),
                       {"count": opt["count"], "mu": _place(mesh, opt["mu"], ("mu",)),
                        "nu": _place(mesh, opt["nu"], ("nu",))})


def gather_params(mesh: PM.Mesh, params) -> Any:
    """The whole params tree from each rank's column blocks (no gradient)."""
    if not model_parallel(mesh):
        return params
    n = mesh.shape["model"]

    def whole(path, x):
        if not _sharded(path, x):
            return x
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
        dist.all_gather(parts, x.detach().contiguous(), group=mesh.groups["model"])
        return torch.cat(parts, dim=-1)

    return _map_with_path(whole, params)


def layers(mesh: PM.Mesh) -> dict:
    """The ``dense`` and ``gru`` of ``models.wavernn.forward`` over the
    ``model`` axis (see the module docstring)."""

    def dense(p, x):
        y = PM.gather_columns(PM.sum_cotangents(x, mesh, "model") @ p["w"], mesh, "model")
        return y + p["b"] if "b" in p else y

    def gru(p, x, h0=None):
        whole = dict(p, wi=PM.gather_columns(p["wi"], mesh, "model"), wh=PM.gather_columns(p["wh"], mesh, "model"))
        return L.gru_scan(whole, x, h0)

    return {"dense": dense, "gru": gru}


def global_norm(grads, mesh: PM.Mesh) -> torch.Tensor:
    """The global norm of a tree whose sharded leaves hold column blocks:
    each block counted once (summed over ``model``), each whole leaf once."""
    parts = {True: [], False: []}
    _map_with_path(lambda p, g: parts[_sharded(p, g)].append(torch.sum(g * g)), grads)
    whole = sum(parts[False]) if parts[False] else 0.0
    blocks = PM.axis_sum(sum(parts[True]), mesh, "model") if parts[True] else 0.0
    return torch.sqrt(torch.as_tensor(whole + blocks))
