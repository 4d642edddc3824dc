"""Model-facing dense decode attention: q (B, 1, H, hd) over a cache stored
as (B, T, KV, hd), the CUDA kernel of ``csrc/decode_attention.cu`` on a CUDA
tensor, the plain version on a CPU tensor.

The kernel reads the cache through its strides, as it is stored: no
transposed or padded copy is made (the JAX wrapper transposes and pads the
whole cache on every call), and a T that is no multiple of the kernel's tile
is masked in place."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, ctypes.c_float, ctypes.c_float,
         _I, _P]
_THREADS, _MAX_PER_THREAD, _TILE = 128, 4, 32      # csrc/decode_tile.cuh, decode_attention.cu
_SMEM_LIMIT = 48 * 1024


def decode_attention(q, k, v, cache_len, softcap: float = 0.0):
    """q: (B, 1, H, hd); k/v: (B, T, KV, hd); cache_len: scalar or (B,)
    valid positions per sequence. Returns (B, 1, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q[:, 0].reshape(B, KV, G, hd)
    lens = torch.as_tensor(cache_len, dtype=torch.int32, device=k.device).reshape(-1).expand(B)
    if k.device.type == "cpu":
        o = decode_attention_ref(qg, k.transpose(1, 2), v.transpose(1, 2), lens, softcap=softcap)
        return o.reshape(B, 1, H, hd)
    if S != 1 or H % KV or k.shape != (B, T, KV, hd) or v.shape != k.shape:
        raise ValueError(f"decode_attention: q (B, 1, H, hd) over k/v (B, T, KV, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    if q.dtype not in _build.DTYPE_CODE or not (k.dtype == v.dtype == q.dtype):
        raise ValueError("decode_attention: q, k and v must share one f32 or bf16 dtype")
    if k.stride() != v.stride() or k.stride(3) != 1:
        raise ValueError("decode_attention: k and v need one layout with unit stride over hd")
    if G * hd > _THREADS * _MAX_PER_THREAD:
        raise ValueError(f"decode_attention: G*hd={G * hd} exceeds the kernel's register budget")
    smem = 4 * (G * hd + _TILE * (hd + 1) + _TILE * hd + G * _TILE + G)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"decode_attention: a tile needs {smem} bytes of shared memory")
    qg, lens = qg.contiguous(), lens.contiguous()
    _build.require_cuda("decode_attention", qg, lens)
    if not (k.is_cuda and v.is_cuda and k.device == v.device == qg.device):
        raise ValueError(f"decode_attention: every tensor must be on {qg.device}")
    out = torch.empty_like(qg)
    fn = _build.function("rt_decode_attention", _ARGS)
    sb, st, sh, _ = k.stride()
    err = fn(qg.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(), B, T, KV,
             G, hd, sb, st, sh, 1.0 / hd ** 0.5, float(softcap), _build.DTYPE_CODE[q.dtype],
             _build.stream_ptr(q))
    _build.count_launch(decode_attention)
    _build.check(err, "decode_attention")
    return out.reshape(B, 1, H, hd)


decode_attention.launches = 0
