"""Logical-axis rules: map ParamDef logical axes onto mesh axes (the torch
twin of ``repro/sharding/axes.py``).

The production mesh is ('data', 'model') single-pod or ('pod', 'data',
'model') multi-pod; 'pod' extends the data-parallel axis. Modules run with
ctx=None on one device.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` when a process
group is up (``launch/mesh.py``), or an ``AbstractMesh``: axis names and
sizes only, as JAX's ``AbstractMesh``, for the rules and their tests. Both
give ``mesh_dim_names`` and ``shape``. Where JAX places a global array on
the devices, a rank here holds its own block: ``NamedSharding.block``
cuts it from the full tensor by the rank's mesh coordinate, and
``NamedSharding.distribute`` (the port's ``device_put``) wraps it as a
DTensor (``torch.distributed.tensor``) whose placements are the spec's
(``placements``). ``with_sharding_constraint`` redistributes a DTensor to
a spec, as ``jax.lax.with_sharding_constraint`` pins an array's layout.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Tuple

import torch



class PartitionSpec(tuple):
    """A tensor's layout over a mesh, one entry per leading dim: a mesh axis
    name, a tuple of names (sharded over their product, the first
    outermost), or None (replicated). Dims past its length are replicated.
    A tuple of one name is that name, as in JAX."""

    def __new__(cls, *parts):
        return super().__new__(cls, (p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh:
    """A mesh's axis names and sizes, with no devices and no process group."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
        self.shape = tuple(int(n) for n in shape)
        self.mesh_dim_names = tuple(axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or an AbstractMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class MeshCtx:
    mesh: Any                      # DeviceMesh or AbstractMesh
    batch_axes: Tuple[str, ...]    # axes that shard the batch (pod + data)
    tp_axis: str                   # tensor/expert-parallel axis
    fsdp_axis: str                 # optimizer/param fully-sharded axis

    @property
    def shape(self) -> dict:
        return axis_sizes(self.mesh)

    @property
    def tp_size(self) -> int:
        return self.shape[self.tp_axis]

    @property
    def dp_size(self) -> int:
        return math.prod(self.shape[a] for a in self.batch_axes)

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape.values())

    def batch_spec_for(self, batch: int):
        """Axis (or axes) to shard a batch dim of the given size, or None."""
        if batch % self.dp_size == 0:
            return self.batch_axes
        # a prefix of the batch axes (e.g. batch=2 on the pod axis only)
        for i in range(len(self.batch_axes) - 1, 0, -1):
            if batch % math.prod(self.shape[a] for a in self.batch_axes[:i]) == 0:
                return self.batch_axes[:i]
        return None

    def size_of(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.shape[a] for a in axes)

    def data_spec(self, batch: int, ndim: int) -> PartitionSpec:
        """PartitionSpec for a (batch, ...) data array."""
        return P(self.batch_spec_for(batch), *([None] * (ndim - 1)))


def make_ctx(mesh) -> Optional[MeshCtx]:
    if mesh is None:
        return None
    if "pod" in mesh.mesh_dim_names:
        return MeshCtx(mesh, ("pod", "data"), "model", "data")
    return MeshCtx(mesh, ("data",), "model", "data")


def coordinate(mesh) -> dict:
    """{axis name: this rank's index along it} on a DeviceMesh."""
    if isinstance(mesh, AbstractMesh):
        raise TypeError("an AbstractMesh has no rank: pass the coordinate explicitly")
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, coord))


def shard_block(x, spec, sizes: Mapping[str, int], coord: Mapping[str, int]):
    """The block of the full tensor ``x`` that the mesh position ``coord``
    holds under ``spec``: a view (``narrow``) along each sharded dim."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n, i = 1, 0
        for a in axes:
            n, i = n * sizes[a], i * sizes[a] + coord[a]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {axes} ({n})")
        step = x.shape[dim] // n
        x = x.narrow(dim, i * step, step)
    return x


def placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on a mesh: one per mesh dim,
    ``Shard(d)`` on every mesh axis that tensor dim ``d`` is sharded over,
    ``Replicate()`` on the rest. A tuple entry shards one tensor dim over
    several axes, the first outermost, as ``shard_block`` cuts it; DTensor
    cuts such a dim over its mesh dims in mesh order, so the tuple must
    name them in that order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    def block(self, x, coord: Optional[Mapping[str, int]] = None):
        """This rank's block of the full tensor ``x`` (or that of the mesh
        position ``coord``)."""
        return shard_block(x, self.spec, axis_sizes(self.mesh),
                           coordinate(self.mesh) if coord is None else coord)

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)

    def distribute(self, x, shape=None):
        """A DTensor of this sharding (JAX's ``device_put``): from the full
        tensor ``x``, which every rank holds (no communication: the rank
        keeps a copy of its block), or, with ``shape``, from this rank's
        block ``x`` of a tensor of that global shape."""
        from torch.distributed.tensor import DTensor

        if shape is None:
            shape, x = tuple(x.shape), self.block(x).clone(memory_format=torch.contiguous_format)
        return DTensor.from_local(x, self.mesh, self.placements, run_check=False, shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.append(n)
        n *= d
    return tuple(reversed(stride))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def like(block, ref):
    """``block`` (this rank's local tensor) as a DTensor of ``ref``'s mesh,
    placements and global shape."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(block, ref.device_mesh, ref.placements, run_check=False, shape=ref.shape,
                              stride=ref.stride())


def full_value(t):
    """A DTensor's whole value as a plain tensor (gathered, or summed where
    it is partial); a plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def redistribute(x, placements):
    """The DTensor ``x`` in ``placements``: ``x`` itself where it already is,
    with no redistribution in the autograd graph (its backward would take
    a partial gradient to ``x``'s placements, an all-reduce, where the
    gradient should stay partial for the next reduction to scatter it)."""
    placements = tuple(placements)
    return x if tuple(x.placements) == placements else x.redistribute(x.device_mesh, placements)


def with_sharding_constraint(x, sharding: NamedSharding):
    """``x`` laid out as ``sharding`` says: a DTensor redistributed to its
    placements (``redistribute``), a plain tensor distributed from its full
    value."""
    if is_dtensor(x):
        return redistribute(x, sharding.placements)
    return sharding.distribute(x)


class Rules:
    """Resolve ParamDef logical axes to PartitionSpecs on a given ctx."""

    def __init__(self, ctx: Optional[MeshCtx], fsdp_params: bool = False):
        self.ctx = ctx
        self.fsdp_params = fsdp_params

    def spec_for(self, d) -> PartitionSpec:
        """The spec of a ``models.common.ParamDef``."""
        from repro_torch.models.common import EMBED, FSDP, NULL, STACK, TP

        if self.ctx is None:
            return P()
        sizes = self.ctx.shape
        mapping = {TP: self.ctx.tp_axis, FSDP: self.ctx.fsdp_axis, EMBED: None, STACK: None, NULL: None}
        out = []
        for dim, a in zip(d.shape, d.axes):
            ax = mapping.get(a)
            # drop shardings that do not divide the dim evenly
            out.append(None if ax is not None and dim % sizes[ax] else ax)
        # optional ZeRO-3/FSDP: also shard the largest unsharded dim over the
        # fsdp axis (for very large parameter trees)
        if self.fsdp_params and self.ctx.fsdp_axis not in out:
            fs = sizes[self.ctx.fsdp_axis]
            cand = [(dim, i) for i, (dim, ax) in enumerate(zip(d.shape, out))
                    if ax is None and dim % fs == 0 and dim >= 2 * fs]
            if cand:
                out[max(cand)[1]] = self.ctx.fsdp_axis
        return P(*out)

    def spec_tree(self, defs: Any) -> Any:
        from repro_torch.models.common import map_defs

        return map_defs(self.spec_for, defs)

    def sharding_tree(self, defs: Any) -> Any:
        from repro_torch.models.common import map_defs

        if self.ctx is None:
            return map_defs(lambda d: None, defs)
        return map_defs(lambda d: NamedSharding(self.ctx.mesh, self.spec_for(d)), defs)


def unshard(x, axis: str, dim: Optional[int] = None):
    """The DTensor ``x`` with mesh axis ``axis`` no longer sharding it (an
    all-gather over that axis): every dim, or only tensor dim ``dim``. A
    plain tensor, or one ``axis`` does not shard, comes back as it is."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(x):
        return x
    i = x.device_mesh.mesh_dim_names.index(axis)
    pl = list(x.placements)
    if not isinstance(pl[i], Shard) or (dim is not None and pl[i].dim != dim % x.ndim):
        return x
    pl[i] = Replicate()
    return x.redistribute(x.device_mesh, pl)


def gather_fsdp(tree, ctx: MeshCtx):
    """Every DTensor leaf of ``tree`` all-gathered over the fsdp axis (the
    layout it computes in: FSDP's gather at use); the other axes' shards
    stay. The backward of the gather reduce-scatters each gradient back."""
    if isinstance(tree, Mapping):
        return {k: gather_fsdp(v, ctx) for k, v in tree.items()}
    return unshard(tree, ctx.fsdp_axis)
