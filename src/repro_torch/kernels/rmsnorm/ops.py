"""Model-facing RMSNorm: arbitrary leading dims, the CUDA kernel on a CUDA
tensor (``csrc/rmsnorm.cu``), the plain version on a CPU tensor, and on a
meta tensor only the output's allocation (the dry run). Where a gradient is
wanted (training), the forward runs inside ``RMSNormFn`` on every device,
whose backward is the plain version's (``kernels/_grad.py``). Under a cost
counter the call reports ``rmsnorm_cost`` (``launch/cost.py``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _grad
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.launch import cost as _cost

_P = ctypes.c_void_p
_RT = _build.Entry("rt_rmsnorm", [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                  ctypes.c_int, _P])


def rmsnorm_cost(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """(FLOPs, bytes): no matrix product; x and w read once, the output
    written once."""
    return 0, 2 * _cost.nbytes(x) + _cost.nbytes(w)


@_cost.reports(rmsnorm_cost)
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); w: (D,). Returns x's shape and dtype."""
    _build.refuse_dtensor("rmsnorm", x, w)
    if (x.requires_grad or w.requires_grad) and torch.is_grad_enabled():
        return RMSNormFn.apply(x, w, eps)
    return _forward(x, w, eps)


def _forward(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain version on the CPU, the output alone on the meta device,
    the kernel on the card."""
    if x.is_cpu:
        return rmsnorm_ref(x, w, eps)
    if x.is_meta:
        return torch.empty_like(x)
    return _launch(x, w, eps)


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Check, allocate the output and launch the kernel on the current stream."""
    D = x.shape[-1]
    code = _build.DTYPE_CODE.get(x.dtype)
    if code is None or w.dtype != x.dtype:
        raise ValueError(f"rmsnorm: x and w must share f32 or bf16, got {x.dtype}, {w.dtype}")
    if w.shape != (D,):
        raise ValueError(f"rmsnorm: w must be ({D},), got {tuple(w.shape)}")
    dev = _build.require_cuda("rmsnorm", x, w)
    out = torch.empty_like(x)
    err = (_RT.fn or _RT.resolve())(x.data_ptr(), w.data_ptr(), out.data_ptr(), x.numel() // max(1, D),
                                    D, eps, code, _build.stream_ptr(dev))
    _build.count_launch(rmsnorm)
    _build.check(err, "rmsnorm")
    return out


class RMSNormFn(torch.autograd.Function):
    """The kernel forward (``_forward``); the backward of ``rmsnorm_ref`` at
    the saved x, w."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return _forward(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return (*_grad.plain_grads(rmsnorm_ref, (x, w), ctx.needs_input_grad[:2], (g,), eps=ctx.eps), None)


rmsnorm.launches = 0
