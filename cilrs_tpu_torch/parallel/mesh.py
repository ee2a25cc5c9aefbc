"""The data-parallel mesh over ``torch.distributed`` (port of
``cilrs_tpu/parallel/mesh.py``).

One logical axis, ``"data"``, carries both the training batch and the env
fleet: the CILRS model (22 M parameters) needs no tensor parallelism, so the
layout is pure data parallelism. In JAX that axis is a ``Mesh`` of the
devices that one process sees; here it is the process group, one process a
GPU, and a rank's contiguous block of a leading axis is that device's shard
(``P(DATA_AXIS)`` gives contiguous blocks in device order).

The collectives go through one flat buffer a dtype, so a step's reduction of
110 gradient tensors is one call, not 110. Each call adds one to
``Mesh.collectives``. Without a process group (a plain single-process run),
``make_mesh()`` is a world of 1 whose collectives are no-ops; with one, even
a world of 1 calls its backend, so a one-card run exercises NCCL.

No counterpart, in this idiom:
 - ``batch_spec`` / ``replicated_spec``: a rank holds its block
   (``shard_batch``) or a full copy (``replicate``), not an annotated array;
 - ``shard_map_compat``: the code that ``shard_map`` wraps in JAX runs as it
   is on every rank, with the collectives written out.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from cilrs_tpu_torch.core.state import TensorTree

DATA_AXIS = "data"


@dataclasses.dataclass
class Mesh:
    """A rank's view of the data axis: its process group (None without
    one), its rank and the world size, and its device."""

    group: object | None
    rank: int
    world: int
    device: torch.device
    collectives: int = 0  # collective calls made through this mesh


def make_mesh(num_devices: int | None = None, device: str | torch.device | None = None) -> Mesh:
    """The default process group as a mesh, on ``device``: by default this
    rank's GPU (the CPU without one); a CUDA device without an index is this
    rank's. Without a group, a world of 1. ``num_devices`` must be the world
    size when given: the ranks of a torchrun job are its devices."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        world, rank, group = 1, 0, None
    else:
        world, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    if num_devices is not None and num_devices != world:
        raise ValueError(f"make_mesh({num_devices}) in a world of {world}: launch "
                         f"{num_devices} ranks (torchrun --nproc_per_node {num_devices})")
    return Mesh(group, rank, world, device)


def _map(fn, tree):
    """fn over every array leaf of dicts, lists, tuples and TensorTrees."""
    if isinstance(tree, TensorTree):
        return type(tree)(**{f.name: _map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


def block(mesh: Mesh, n: int) -> slice:
    """The rank's contiguous block of a leading axis of ``n``."""
    if n % mesh.world:
        raise ValueError(f"a leading axis of {n} does not split into {mesh.world} equal blocks")
    k = n // mesh.world
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def shard_batch(mesh: Mesh, tree):
    """The rank's block of every leaf's leading axis (tensors or numpy
    arrays; views, not copies). A pure function of (rank, world)."""
    return _map(lambda x: x[block(mesh, x.shape[0])], tree)


@torch.no_grad()
def _flat(mesh: Mesh, tensors, call) -> None:
    """``call(flat)`` on one flat buffer a dtype of ``tensors``, whose
    results are copied back in place."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        call(flat)
        mesh.collectives += 1
        torch._foreach_copy_(ts, [v.view_as(t) for v, t in
                                  zip(flat.split([t.numel() for t in ts]), ts)])


def replicate(mesh: Mesh, tree):
    """Every tensor of ``tree`` broadcast from rank 0, in place (one flat
    buffer a dtype). Returns ``tree``."""
    if mesh.group is not None:
        _flat(mesh, _leaves(tree), lambda f: dist.broadcast(f, 0, group=mesh.group))
    return tree


def all_reduce_sum_(mesh: Mesh, tensors) -> None:
    """Sum ``tensors`` over the ranks, in place, in one flat buffer a dtype."""
    if mesh.group is not None:
        _flat(mesh, tensors, lambda f: dist.all_reduce(f, group=mesh.group))


def all_reduce_mean_(mesh: Mesh, tensors) -> None:
    """``pmean``: the mean of ``tensors`` over the ranks, in place."""
    if mesh.group is not None:
        _flat(mesh, tensors, lambda f: (dist.all_reduce(f, group=mesh.group),
                                        f.div_(mesh.world)))


def all_gather(mesh: Mesh, tree):
    """Every leaf's blocks from all ranks, concatenated along the leading
    axis in rank order: the global view of a sharded tree."""
    if mesh.group is None:
        return tree

    def gather(x):
        parts = [torch.empty_like(x) for _ in range(mesh.world)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        mesh.collectives += 1
        return torch.cat(parts)

    return _map(gather, tree)


class _AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) whose gradient is the all_reduce(SUM) of the
    incoming gradient (every rank's output depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.clone()
        dist.all_reduce(y, group=mesh.group)
        mesh.collectives += 1
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.mesh.group)
        ctx.mesh.collectives += 1
        return g, None


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (SyncBatchNorm's
    statistics)."""
    return x if mesh.group is None else _AllReduceSum.apply(x, mesh)
