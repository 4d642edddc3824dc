"""Model-facing flash attention: the (B, S, H, hd) layout of the model, the
CUDA kernel of ``csrc/flash_attention.cu`` on a CUDA tensor, the plain
version on a CPU tensor. Standard causal positions only (square q/k); the
kernel masks a ragged S itself, so no padded copy is made."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_RT = _build.Entry("rt_flash_attention",
                   [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P])
_MAX_HD = 128                                   # csrc/flash_attention.cu


def flash_attention_bhsd(q, k, v):
    """q: (B, H, S, hd); k/v: (B, KV, S, hd) -> (B, H, S, hd)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v)
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if k.shape != (B, KV, S, hd) or v.shape != k.shape or H % KV:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q.dtype not in _build.DTYPE_CODE or not (k.dtype == v.dtype == q.dtype):
        raise ValueError("flash_attention: q, k and v must share one f32 or bf16 dtype")
    if hd > _MAX_HD:
        raise ValueError(f"flash_attention: head_dim {hd} > {_MAX_HD}")
    dev = _build.require_cuda("flash_attention", q, k, v)
    out = torch.empty_like(q)
    err = (_RT.fn or _RT.resolve())(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
                                    KV, S, hd, 1.0 / hd ** 0.5, _build.DTYPE_CODE[q.dtype],
                                    _build.stream_ptr(dev))
    _build.count_launch(flash_attention_bhsd)
    _build.check(err, "flash_attention")
    return out


flash_attention_bhsd.launches = 0


def flash_attention(q, k, v):
    """q: (B, S, H, hd); k/v: (B, S, KV, hd) -> (B, S, H, hd), causal."""
    o = flash_attention_bhsd(
        q.transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
    )
    return o.transpose(1, 2)
