"""Model-facing RMSNorm: arbitrary leading dims, the CUDA kernel on a CUDA
tensor (``csrc/rmsnorm.cu``), the plain version on a CPU tensor."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_P = ctypes.c_void_p
_RT = _build.Entry("rt_rmsnorm", [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                  ctypes.c_int, _P])


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); w: (D,). Returns x's shape and dtype."""
    if x.is_cpu:
        return rmsnorm_ref(x, w, eps)
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


rmsnorm.launches = 0
