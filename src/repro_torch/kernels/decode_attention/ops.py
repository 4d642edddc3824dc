"""Model-facing dense decode attention: q (B, 1, H, hd) over a cache stored
as (B, T, KV, hd), the CUDA kernel of ``csrc/decode_attention.cu`` on a CUDA
tensor, the plain version on a CPU tensor.

The kernel reads the cache through its strides, as it is stored: no
transposed or padded copy is made (the JAX wrapper transposes and pads the
whole cache on every call). When B * KV blocks would leave the card's SMs
idle, the T axis is split across blocks (``plan_splits``) and a second
kernel combines the splits in a fixed order."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_RT = _build.Entry("rt_decode_attention", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L,
                                           ctypes.c_float, ctypes.c_float, _I, _I, _P])
SMS = 132                   # streaming multiprocessors of an H100 SXM
MIN_SPLIT = 64              # tokens: a shorter split costs more in its combine than it saves
_MAX_G = 8                  # csrc/decode_attention.cu: query rows and accumulators in registers


def plan_splits(B: int, KV: int, T: int) -> int:
    """Splits of the cache's T axis, from the shapes alone (the lengths lie
    on the card): at most two blocks per SM, all resident at once, where
    B * KV blocks would leave SMs idle; each split at least MIN_SPLIT
    tokens (T // MIN_SPLIT splits at most); one split for a short cache."""
    return max(1, min(2 * SMS // max(1, B * KV), T // MIN_SPLIT))


def split_bounds(T: int, nsplit: int) -> list:
    """[start, stop) of each split, as the kernel computes them: split s
    covers [s * T // n, (s + 1) * T // n)."""
    return [(s * T // nsplit, (s + 1) * T // nsplit) for s in range(nsplit)]


def decode_attention(q, k, v, cache_len, softcap: float = 0.0):
    """q: (B, 1, H, hd); k/v: (B, T, KV, hd); cache_len: scalar or (B,)
    valid positions per sequence. Returns (B, 1, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q[:, 0].reshape(B, KV, G, hd)
    lens = cache_len
    if not (isinstance(lens, torch.Tensor) and lens.dtype == torch.int32 and lens.shape == (B,)
            and lens.is_contiguous() and lens.get_device() == k.get_device()):
        lens = torch.as_tensor(cache_len, dtype=torch.int32, device=k.device).reshape(-1).expand(B)
        lens = lens.contiguous()
    if k.is_cpu:
        o = decode_attention_ref(qg, k.transpose(1, 2), v.transpose(1, 2), lens, softcap=softcap)
        return o.reshape(B, 1, H, hd)
    if S != 1 or H % KV or k.shape != (B, T, KV, hd) or v.shape != k.shape:
        raise ValueError(f"decode_attention: q (B, 1, H, hd) over k/v (B, T, KV, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    code = _build.DTYPE_CODE.get(q.dtype)
    if code is None or not (k.dtype == v.dtype == q.dtype):
        raise ValueError("decode_attention: q, k and v must share one f32 or bf16 dtype")
    if k.stride() != v.stride() or k.stride(3) != 1:
        raise ValueError("decode_attention: k and v need one layout with unit stride over hd")
    qg = qg.contiguous()
    index = _build.require_cuda("decode_attention", qg, lens)
    if not (k.is_cuda and v.is_cuda and k.get_device() == v.get_device() == index):
        raise ValueError(f"decode_attention: every tensor must be on {qg.device}")
    sb, st, sh, _ = k.stride()
    vec = 16 // q.element_size()                 # elements per 16-byte load
    fast = (hd % vec == 0 and hd <= 32 * vec and sb % vec == 0 and st % vec == 0
            and sh % vec == 0 and (qg.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0)
    if G > _MAX_G or not (fast or hd <= 32):
        raise ValueError(f"decode_attention: the kernel takes G <= {_MAX_G} query heads per KV head "
                         f"and either hd <= 32 or rows of whole 16-byte vectors up to 512 bytes "
                         f"(aligned, as are the strides), got G={G}, hd={hd}")
    nsplit = plan_splits(B, KV, T)
    out = torch.empty_like(qg)
    part = None
    if nsplit > 1:       # per (b, h, split): G maxima, G sums, G x hd accumulators
        part = torch.empty(B * KV * nsplit * G * (hd + 2), dtype=torch.float32, device=q.device)
    err = (_RT.fn or _RT.resolve())(
        qg.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), B, T, KV, G, hd, sb, st, sh, 1.0 / hd ** 0.5,
        float(softcap), nsplit, code, _build.stream_ptr(index))
    _build.count_launch(decode_attention)
    _build.check(err, "decode_attention")
    return out.reshape(B, 1, H, hd)


decode_attention.launches = 0
