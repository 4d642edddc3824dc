"""gloo collectives over host copies of CUDA tensors: a process-group
backend for ranks that share one card.

NCCL needs a card a rank, so several ranks on one H100 talk over gloo.
gloo's all-reduce and list all-gather take CUDA tensors, but the entry
points that DTensor's redistributions call (``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_to_all_single``) end the process with a
segmentation fault on a CUDA tensor (seen with torch 2.11 on an H100).
``StagedGloo`` is the process group a world started with backend
``STAGED`` (``launch/mesh.init_world``) gives every mesh axis: each
collective copies its CUDA operands to the host, runs on a CPU gloo group
over the same store, and copies the results back into the CUDA outputs.
Host operands go straight through. Only the operands move: every
computation stays on the card.

Every group counts what it staged (``staged``: collective name -> [calls,
bytes sent by this rank]); ``staged_log(mesh)`` reads the counts of a
mesh's axis groups.
"""
from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist
from torch._C import _distributed_c10d as c10d

STAGED = "stagedgloo"


def _done(result):
    """A completed ``Work`` holding ``result``."""
    fut = torch.futures.Future()
    fut.set_result(result)
    return torch._C._distributed_c10d._create_work_from_future(fut)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu() if t.is_cuda else t


class StagedGloo(dist.ProcessGroup):
    """A gloo group whose CUDA operands are staged through host memory."""

    def __init__(self, store, rank: int, size: int, timeout: timedelta):
        super().__init__(rank, size)
        self._rank, self._size = rank, size
        self._gloo = dist.ProcessGroupGloo(dist.PrefixStore("staged", store), rank, size, timeout)
        self.staged: dict = {}
        self._name = self._desc = ""

    def _count(self, name: str, tensors) -> None:
        if any(t.is_cuda for t in tensors):
            c = self.staged.setdefault(name, [0, 0])
            c[0] += 1
            c[1] += sum(t.numel() * t.element_size() for t in tensors)

    @staticmethod
    def _back(outs, hosts) -> None:
        for o, h in zip(outs, hosts):
            if o is not h:
                o.copy_(h)

    # -- collectives --------------------------------------------------------
    def allreduce(self, tensors, opts=None):
        self._count("all_reduce", tensors)
        hosts = [_host(t) for t in tensors]
        self._gloo.allreduce(hosts, opts or c10d.AllreduceOptions()).wait()
        self._back(tensors, hosts)
        return _done(tensors)

    def allreduce_coalesced(self, tensors, opts=None):
        for t in tensors:
            o = c10d.AllreduceOptions()
            o.reduceOp = opts.reduceOp if opts is not None else c10d.ReduceOp.SUM
            self.allreduce([t], o)
        return _done(tensors)

    def allgather(self, output_lists, inputs, opts=None):
        self._count("all_gather", inputs)
        host_lists = [[_host(t) if not t.is_cuda else torch.empty(t.shape, dtype=t.dtype) for t in outs]
                      for outs in output_lists]
        self._gloo.allgather(host_lists, [_host(t) for t in inputs], opts or c10d.AllgatherOptions()).wait()
        for outs, hosts in zip(output_lists, host_lists):
            self._back(outs, hosts)
        return _done(output_lists)

    def _allgather_base(self, output, input, opts=None):
        self.allgather([list(output.chunk(self._size))], [input], opts)
        return _done([output])

    def allgather_into_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._allgather_base(o, i, opts)
        return _done(outputs)

    def _reduce_scatter_base(self, output, input, opts=None):
        """The sum (or ``opts.reduceOp``) over ranks of each rank's chunk of
        ``input``: an all-reduce of the host copy, then this rank's chunk."""
        self._count("reduce_scatter", [input])
        h = input.detach().cpu().clone() if input.is_cuda else input.clone()
        o = c10d.AllreduceOptions()
        o.reduceOp = opts.reduceOp if opts is not None else c10d.ReduceOp.SUM
        self._gloo.allreduce([h], o).wait()
        output.copy_(h.chunk(self._size)[self._rank].reshape(output.shape))
        return _done([output])

    def reduce_scatter(self, outputs, input_lists, opts=None):
        for o, parts in zip(outputs, input_lists):
            self._reduce_scatter_base(o, torch.cat([p.reshape(-1) for p in parts]), opts)
        return _done(outputs)

    def reduce_scatter_tensor_coalesced(self, outputs, inputs, opts=None):
        for o, i in zip(outputs, inputs):
            self._reduce_scatter_base(o, i, opts)
        return _done(outputs)

    def alltoall_base(self, output, input, output_split_sizes, input_split_sizes,
                      opts=None):
        self._count("all_to_all", [input])
        h_out = _host(output) if not output.is_cuda else torch.empty(output.shape, dtype=output.dtype)
        self._gloo.alltoall_base(h_out, _host(input), output_split_sizes or [], input_split_sizes or [],
                                 opts or c10d.AllToAllOptions()).wait()
        self._back([output], [h_out])
        return _done([output])

    def broadcast(self, tensors, opts=None):
        self._count("broadcast", tensors)
        hosts = [_host(t) for t in tensors]
        self._gloo.broadcast(hosts, opts or c10d.BroadcastOptions()).wait()
        self._back(tensors, hosts)
        return _done(tensors)

    def barrier(self, opts=None):
        self._gloo.barrier(opts or c10d.BarrierOptions()).wait()
        return _done(None)

    # -- identity -------------------------------------------------------------
    def size(self) -> int:
        return self._size

    def rank(self) -> int:
        return self._rank

    def getBackendName(self) -> str:
        return STAGED

    def getGroupName(self) -> str:
        return self._name

    def setGroupName(self, name: str) -> None:
        self._name = name

    def getGroupDesc(self) -> str:
        return self._desc

    def setGroupDesc(self, desc: str) -> None:
        self._desc = desc


def _create(store, rank: int, size: int, timeout: timedelta) -> StagedGloo:
    return StagedGloo(store, rank, size, timeout)


def register() -> None:
    """Make ``STAGED`` a backend name ``torch.distributed`` knows (once)."""
    if not hasattr(dist.Backend, STAGED.upper()):
        dist.Backend.register_backend(STAGED, _create, devices=["cpu", "cuda"])


def staged_log(mesh) -> dict:
    """{axis: {collective: [calls, bytes]}} of what each of ``mesh``'s axis
    groups staged through the host (empty for groups of other backends)."""
    return {a: dict(getattr(mesh.get_group(a), "staged", {})) for a in mesh.mesh_dim_names}
