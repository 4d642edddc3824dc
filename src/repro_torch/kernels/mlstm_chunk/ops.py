"""Model-facing chunkwise mLSTM: the CUDA kernel of ``csrc/mlstm_chunk.cu``
on a CUDA tensor, the plain version on a CPU tensor. Unlike the TPU
kernel's wrapper, the carry ``(C0, n0, m0)`` goes into the kernel, so a
chunked prefill resumes from it."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mlstm_chunk import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_RT = _build.Entry("rt_mlstm_chunkwise", [_P] * 13 + [_I, _I, _I, _I, _I, _P])
TC = 32                 # columns of C per block (csrc/mlstm_chunk.cu)
MAX_DH = 1024           # the block's shared memory holds DH x TC and 16 x DH floats


def mlstm_chunkwise_bh(q, k, v, i, lf, C0, n0, m0, chunk: int = 64):
    """q, k, v: (BH, S, DH) f32 or bf16; i, lf: (BH, S) f32 (lf =
    log_sigmoid(f)); C0 (BH, DH, DH), n0 (BH, DH), m0 (BH) f32. Returns (h
    (BH, S, DH) in q's dtype, C, n, m) in f32."""
    if q.device.type == "cpu":
        return ref.mlstm_chunkwise_bh_ref(q, k, v, i, lf, C0, n0, m0, chunk=chunk)
    BH, S, DH = q.shape
    if k.shape != q.shape or v.shape != q.shape or i.shape != (BH, S) or lf.shape != (BH, S):
        raise ValueError(f"mlstm_chunkwise: bad shapes q {tuple(q.shape)}, i {tuple(i.shape)}")
    if C0.shape != (BH, DH, DH) or n0.shape != (BH, DH) or m0.shape != (BH,):
        raise ValueError(f"mlstm_chunkwise: bad carry shapes C0 {tuple(C0.shape)}, "
                         f"n0 {tuple(n0.shape)}, m0 {tuple(m0.shape)}")
    if q.dtype not in _build.DTYPE_CODE or not (k.dtype == v.dtype == q.dtype):
        raise ValueError("mlstm_chunkwise: q, k and v must share one f32 or bf16 dtype")
    if any(t.dtype != torch.float32 for t in (i, lf, C0, n0, m0)):
        raise ValueError("mlstm_chunkwise: gates and carry must be f32")
    if DH % TC or DH > MAX_DH or S < 1:
        raise ValueError(f"mlstm_chunkwise: DH must be a multiple of {TC} up to {MAX_DH}, "
                         f"and S >= 1 (DH {DH}, S {S})")
    dev = _build.require_cuda("mlstm_chunkwise", q, k, v, i, lf, C0, n0, m0)
    L = ref.chunk_len(S, chunk)
    h = torch.empty_like(q)
    C = torch.empty_like(C0)
    n = torch.empty_like(n0)
    m = torch.empty_like(m0)
    # per block: the chunk's cumulative log-forget, row stabilisers and
    # carry weights, L floats each
    scratch = torch.empty(BH * (DH // TC) * 3 * L, dtype=torch.float32, device=q.device)
    err = (_RT.fn or _RT.resolve())(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), i.data_ptr(), lf.data_ptr(),
        C0.data_ptr(), n0.data_ptr(), m0.data_ptr(), h.data_ptr(), C.data_ptr(),
        n.data_ptr(), m.data_ptr(), scratch.data_ptr(), BH, S, DH, L, _build.DTYPE_CODE[q.dtype],
        _build.stream_ptr(dev))
    _build.count_launch(mlstm_chunkwise_bh)
    _build.check(err, "mlstm_chunkwise")
    return h, C, n, m


mlstm_chunkwise_bh.launches = 0


def mlstm_chunkwise(q, k, v, i, f, C0, n0, m0, chunk: int = 64):
    """q, k, v: (B, S, NH, DH); i, f: (B, S, NH) raw gates; carry (B, NH,
    ...). Returns (h (B, S, NH, DH), (C, n, m))."""
    return ref.mlstm_chunkwise(q, k, v, i, f, C0, n0, m0, chunk=chunk, bh_fn=mlstm_chunkwise_bh)
