"""Production and tier meshes on ``torch.distributed`` (the twin of
``repro/launch/mesh.py``). Importing touches no device and no process group:
meshes are built only inside functions, over a process group that the
caller started (``init_world``), where JAX finds its devices itself.

A mesh is a ``DeviceMesh`` whose axis groups carry the collectives of
``sharding/collectives.py``. One rank computes on one device; several ranks
may share a card over the gloo backend. The backend is always the
caller's: NCCL on the card, gloo on the CPU (or on CUDA tensors where the
caller names it); none is picked by probing. Ranks that share one card
and run DTensor code name ``sharding.staged.STAGED``: gloo with CUDA
operands staged through the host.
"""
from __future__ import annotations

import math
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.models.common import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def init_world(backend: str, rank: int, world_size: int, store, timeout_s: float = 60.0,
               device=None) -> torch.device:
    """Start the default process group over ``store`` (a
    ``torch.distributed`` Store: a ``FileStore`` or a ``TCPStore`` on
    localhost) with ``timeout_s`` seconds on every collective, and select
    this rank's device (``None``: the card). Returns the device.
    ``backend`` ``sharding.staged.STAGED`` registers that backend first."""
    from repro_torch.sharding import staged

    if backend == staged.STAGED:
        staged.register()
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    return dev


def _world_size(what: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs a process group; start one with launch.mesh.init_world")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: 256 chips (16, 16) over ('data', 'model'). Multi-pod: 2
    pods = 512 chips (2, 16, 16) over ('pod', 'data', 'model'); 'pod'
    extends data parallelism across the inter-pod links."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = PRODUCTION[multi_pod]
    need = math.prod(shape)
    have = _world_size(f"the production mesh {shape}")
    if have != need:
        raise RuntimeError(f"the {'multi-pod' if multi_pod else 'single-pod'} production mesh {shape} "
                           f"needs a world of {need} ranks; this one has {have}")
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=names)


def make_tier_mesh(n_devices: int, tp: int = 1, device=None):
    """Small serving-tier meshes: the first ``n_devices`` ranks as
    (n_devices // tp, tp) over ('data', 'model')."""
    from torch.distributed.device_mesh import DeviceMesh

    if n_devices % tp:
        raise ValueError(f"{n_devices} devices do not divide into tp {tp}")
    have = _world_size(f"a tier mesh of {n_devices} devices")
    if n_devices > have:
        raise RuntimeError(f"a tier mesh of {n_devices} devices needs as many ranks; the world has {have}")
    return DeviceMesh(resolve_device(device).type, torch.arange(n_devices).reshape(n_devices // tp, tp),
                      mesh_dim_names=("data", "model"))
