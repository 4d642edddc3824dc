"""Gradient compression for cross-pod data parallelism (the torch twin of
``repro/train/compression.py``).

On the multi-pod mesh the gradient all-reduce crosses the slow inter-pod
links. ``compressed_allreduce_local`` is an int8 block-quantized all-reduce:
quantize locally, all-gather the int8 blocks and their f32 scales (about
1/128 more), dequantize and sum locally in rank order. Wire bytes drop
about 4x against f32 (2x against bf16) at the cost of a gather in place of
a reduce; worthwhile when the pod axis is small. Error feedback (carrying
the residual) keeps training unbiased.

Where JAX runs the all-reduce inside ``shard_map`` on a global array, the
port's functions take this rank's block and collect over a process group.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding.axes import MeshCtx
from repro_torch.train.optimizer import QBLOCK
from repro_torch.train.tree import map_tree


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """x flattened in f32, zero-padded to whole QBLOCK blocks: (int8 blocks
    (nb, QBLOCK), f32 scales (nb, 1) = absmax / 127 at least 1e-12, pad)."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % QBLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, QBLOCK)
    amax = blocks.abs().amax(-1, keepdim=True)
    # a tensor divisor: torch on CUDA divides by a Python scalar as a
    # multiply by its reciprocal, which can be 1 ulp off amax / 127
    scale = (amax / amax.new_tensor(127.0)).clamp_min(1e-12)
    q = torch.round(blocks / scale).clamp(-127, 127).to(torch.int8)
    return q, scale, pad


def _dequantize(q: torch.Tensor, scale: torch.Tensor, pad: int, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compressed_allreduce_local(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` with an int8 wire format:
    every rank's int8 blocks and scales all-gathered, then dequantized and
    summed in rank order 0..g-1 in f32, as JAX's loop does; the same bits on
    every rank. Cast back to x's dtype."""
    q, scale, pad = _quantize(x)
    g = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(g)]
    ss = [torch.empty_like(scale) for _ in range(g)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, scale, group=group)
    total = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(g):
        total = total + _dequantize(qs[i], ss[i], pad, x.shape)
    return total.to(x.dtype)


def make_compressed_psum(ctx_or_mesh, axis_name: str, inner_spec):
    """fn(x) = the all-reduce of this rank's block ``x`` over the mesh axis
    ``axis_name`` with the int8 wire format, the other axes untouched.
    ``ctx_or_mesh``: a ``MeshCtx`` or a ``DeviceMesh``; ``inner_spec``: the
    ``PartitionSpec`` the blocks are cut by (x has at least its length in
    dims)."""
    mesh = ctx_or_mesh.mesh if isinstance(ctx_or_mesh, MeshCtx) else ctx_or_mesh
    group = mesh.get_group(axis_name)

    def fn(x: torch.Tensor) -> torch.Tensor:
        if x.ndim < len(inner_spec):
            raise ValueError(f"a block of {x.ndim} dims under {inner_spec}")
        return compressed_allreduce_local(x, group)

    return fn


class ErrorFeedback:
    """Residual error feedback for biased compressors: carry the
    quantization error into the next step (Karimireddy et al., 2019)."""

    @staticmethod
    def init(grads: Any) -> Any:
        return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)

    @staticmethod
    def apply(grads: Any, residual: Any, compress_fn) -> Tuple[Any, Any]:
        """(compress_fn of each corrected gradient's int8 round trip in its
        dtype, the new f32 residuals), corrected = gradient + residual."""
        def one(g, r):
            corrected = g.float() + r
            q, scale, pad = _quantize(corrected)
            sent = _dequantize(q, scale, pad, corrected.shape)
            return compress_fn(sent.to(g.dtype)), corrected - sent

        pairs = map_tree(one, grads, residual)
        return map_tree(lambda pr: pr[0], pairs), map_tree(lambda pr: pr[1], pairs)
