"""Collectives over a mesh's named axes, on per-member tensors: the port's
counterpart of the ``jax.lax`` collectives that the reference's
``shard_map`` bodies call (``axis_index``, ``ppermute``, ``psum``,
``pmean``, ``all_gather``, ``all_to_all``). No JAX file corresponds to it.

The port drives a mesh from one process (``parallel/mesh.py``). A value
that a ``shard_map`` body holds once a device is here a list of tensors,
one a member, in ``mesh.members`` order (the flat order of
``mesh.devices``). A collective over axis ``a`` acts within each group of
members that differ only in their ``a`` coordinate, taken in ``a`` order,
and returns one tensor a member, on that member's device.

- They are built from ``.to(member)``, ``torch.cat``/``torch.stack`` and
  out-of-place sums, so autograd runs through them: a tensor that several
  members read gets the sum of their gradients, which is what the
  transpose of a ``psum`` or GSPMD's all-reduce gives.
- Sums run in member order along the axis, so a result does not depend on
  timing.
- Each member's ops run on its device's current stream, where autograd
  runs their backward too; ``run_members``' side streams are for serving.

A mesh built inside a ``torch.distributed`` group
(``multihost.hybrid_mesh``) splits its ``process_axis`` between the
processes. A reduction over that axis sums the local members in order,
then calls ``all_reduce`` across the group; its backward passes the
cotangent on unchanged, since each process seeds its own copy of the
reduced value. ``sharding.ShardedTensor.blocks`` pairs it with
``replicated_read``, whose backward sums a replicated tensor's gradient
across the group: the reduce and copy functions of Megatron-LM. The other
collectives act on local members only, and raise over a process axis that
spans more than one process.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from nornicdb_tpu_torch.parallel.mesh import Mesh


def groups(mesh: Mesh, axis_name: str) -> List[List[int]]:
    """The member positions of each group along ``axis_name``, each group
    in axis order."""
    shape = mesh.devices.shape
    a = mesh.axis_names.index(axis_name)
    pos = np.moveaxis(np.arange(mesh.devices.size).reshape(shape), a, -1)
    return [[int(m) for m in g] for g in pos.reshape(-1, shape[a])]


def axis_index(mesh: Mesh, axis_name: str, m: int) -> int:
    """Member ``m``'s coordinate along ``axis_name`` (``jax.lax.axis_index``);
    global across processes on the process axis."""
    a = mesh.axis_names.index(axis_name)
    local = int(np.unravel_index(m, mesh.devices.shape)[a])
    if axis_name == mesh.process_axis:
        return mesh.process_index * mesh.devices.shape[a] + local
    return local


def _crosses_processes(mesh: Mesh, axis_name: str) -> bool:
    return axis_name == mesh.process_axis and mesh.in_process_group


def _local_only(mesh: Mesh, axis_name: str, what: str) -> None:
    if _crosses_processes(mesh, axis_name) and mesh.process_count > 1:
        raise ValueError(f"{what} over {axis_name!r}, which spans "
                         f"{mesh.process_count} processes, is not supported")


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce`` across the process group; the cotangent passes on."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad


class _GradAllReduce(torch.autograd.Function):
    """The identity, whose backward sums the gradient across the group."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def replicated_read(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x``, a tensor every process of ``mesh``'s group holds a copy of,
    as its local members read it: its gradient is summed across the group
    (``x`` itself outside a group)."""
    return _GradAllReduce.apply(x) if mesh.in_process_group else x


def psum(mesh: Mesh, xs: Sequence[torch.Tensor], axis_name: str) -> List[torch.Tensor]:
    """The sum over each group, in axis order, on every member of it."""
    members = mesh.members
    out: List[torch.Tensor] = [None] * len(xs)
    for g in groups(mesh, axis_name):
        total = xs[g[0]]
        for m in g[1:]:
            total = total + xs[m].to(total.device)
        if _crosses_processes(mesh, axis_name):
            total = _AllReduceSum.apply(total)
        for m in g:
            out[m] = total.to(members[m])
    return out


def pmean(mesh: Mesh, xs: Sequence[torch.Tensor], axis_name: str) -> List[torch.Tensor]:
    n = mesh.shape[axis_name]
    return [x / n for x in psum(mesh, xs, axis_name)]


def ppermute(mesh: Mesh, xs: Sequence[torch.Tensor], axis_name: str,
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Member at coordinate ``src`` sends to ``dst`` for each pair of
    ``perm``; a member that receives nothing holds zeros."""
    _local_only(mesh, axis_name, "ppermute")
    members = mesh.members
    out: List[torch.Tensor] = [None] * len(xs)
    for g in groups(mesh, axis_name):
        for src, dst in perm:
            out[g[dst]] = xs[g[src]].to(members[g[dst]])
        for m in g:
            if out[m] is None:
                out[m] = torch.zeros_like(xs[m])
    return out


def all_gather(mesh: Mesh, xs: Sequence[torch.Tensor], axis_name: str,
               axis: int = 0) -> List[torch.Tensor]:
    """The group's blocks concatenated along ``axis`` in axis order (the
    tiled form), on every member of it."""
    _local_only(mesh, axis_name, "all_gather")
    members = mesh.members
    out: List[torch.Tensor] = [None] * len(xs)
    for g in groups(mesh, axis_name):
        lead = members[g[0]]
        full = torch.cat([xs[m].to(lead) for m in g], dim=axis) if len(g) > 1 else xs[g[0]]
        for m in g:
            out[m] = full.to(members[m])
    return out


def all_to_all(mesh: Mesh, xs: Sequence[torch.Tensor], axis_name: str,
               split_axis: int, concat_axis: int) -> List[torch.Tensor]:
    """The untiled form (``tiled=False``): each block's ``split_axis``
    (of the axis's size) is split, and member ``i`` stacks the ``i``-th
    pieces of every member of its group, in axis order, on a new axis at
    ``concat_axis``."""
    _local_only(mesh, axis_name, "all_to_all")
    members = mesh.members
    out: List[torch.Tensor] = [None] * len(xs)
    for g in groups(mesh, axis_name):
        for m in g:
            if xs[m].shape[split_axis] != len(g):
                raise ValueError(f"all_to_all: axis {split_axis} of a block is "
                                 f"{xs[m].shape[split_axis]}, not {axis_name}={len(g)}")
        for i, m in enumerate(g):
            out[m] = torch.stack([xs[j].select(split_axis, i).to(members[m]) for j in g],
                                 dim=concat_axis)
    return out
