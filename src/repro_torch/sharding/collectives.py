"""Collectives over a DeviceMesh's named axes: the port's counterparts of
``jax.lax.axis_index``, ``all_gather(tiled=True)``, ``psum`` and ``pmean``
inside a ``shard_map`` body. Each runs on this rank's block and on the
process group of one mesh axis; several axes reduce one after another.
Every call is a blocking ``torch.distributed`` collective, bounded by the
group's timeout (``launch/mesh.init_world``)."""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_index(mesh, axis: str) -> int:
    """This rank's index along ``axis``."""
    return mesh.get_local_rank(axis)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The blocks of every rank along ``axis`` concatenated along ``dim`` in
    the axis's order (JAX's tiled ``all_gather``)."""
    group = mesh.get_group(axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def psum(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The sum of ``x`` over every rank of ``axes``, the same on each."""
    x = x.clone(memory_format=torch.contiguous_format)
    for a in _axes(axes):
        dist.all_reduce(x, group=mesh.get_group(a))
    return x


def pmean(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The mean of ``x`` over every rank of ``axes``."""
    axes = _axes(axes)
    n = 1
    for a in axes:
        n *= mesh.get_group(a).size()
    return psum(x, mesh, axes) / n


class _SumReplicated(torch.autograd.Function):
    """All-reduce (sum) of per-rank partial values into a value every rank
    of the group holds; the backward passes the gradient through, since
    each rank's copy of the sum carries the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_replicated(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, differentiable where the result is
    replicated: Megatron's reduce from the model-parallel region."""
    return _SumReplicated.apply(x, mesh.get_group(axis))


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axis`` (no gradient)."""
    x = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return x
