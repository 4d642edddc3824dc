"""Model-facing chunkwise mLSTM: the CUDA kernel of ``csrc/mlstm_chunk.cu``
on a CUDA tensor, the plain version on a CPU tensor. Unlike the TPU
kernel's wrapper, the carry ``(C0, n0, m0)`` goes into the kernel, so a
chunked prefill resumes from it.

bf16 inputs take the tensor-core instance, whose blocks hold ``TC``
columns of C each, ``plan_col_tile`` choosing TC from the shapes; f32
inputs (the parity runs) take the exact-FMA instance, 32 columns a block,
with a global scratch for its gate scalars. Where a gradient is wanted
(training), the forward runs inside ``MLSTMFn`` on every device, whose
backward is the plain version's (``kernels/_grad.py``), the carry outputs
``(C, n, m)`` included. On a meta tensor only the outputs are allocated
(the dry run); under a cost counter a call reports ``mlstm_cost``
(``launch/cost.py``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _grad
from repro_torch.kernels.mlstm_chunk import ref
from repro_torch.launch import cost as _cost

_P = ctypes.c_void_p
_I = ctypes.c_int
_RT = _build.Entry("rt_mlstm_chunkwise", [_P] * 13 + [_I] * 6 + [_P])
TC = 32                 # columns of C per block of the f32 instance
MAX_DH = 1024           # the block's shared memory holds DH x TC floats of C
SMS = 132               # streaming multiprocessors of an H100 SXM


def plan_col_tile(BH: int, DH: int, n_sms: int = SMS) -> int:
    """Columns of C per block of the bf16 instance, from the shapes alone:
    16 where BH * DH / 32 blocks would leave SMs idle (twice the blocks, each
    with half the carry update), 32 otherwise. DH is a multiple of 32, so
    either divides it."""
    return 16 if BH * DH // 32 < n_sms else 32


def mlstm_cost(q, k, v, i, lf, C0, n0, m0, chunk: int = 64):
    """(FLOPs, bytes) of one call: the plain version's products, S / L
    chunks of q k^T and s v (2 * L^2 * DH each), q C and the carry update
    k^T v (2 * L * DH^2 each) and q n (2 * L * DH) per head; every input
    read once and h, C, n, m written once."""
    BH, S, DH = q.shape
    L = ref.chunk_len(S, chunk)
    flops = BH * (S // L) * (4 * L * L * DH + 4 * L * DH * DH + 2 * L * DH)
    return flops, sum(_cost.nbytes(t) for t in (q, k, v, i, lf, C0, n0, m0, q, C0, n0, m0))


def _forward(q, k, v, i, lf, C0, n0, m0, chunk: int):
    """The plain version on the CPU, the outputs alone on the meta device,
    the kernel on the card."""
    if q.device.type == "cpu":
        return ref.mlstm_chunkwise_bh_ref(q, k, v, i, lf, C0, n0, m0, chunk=chunk)
    if q.is_meta:
        return torch.empty_like(q), torch.empty_like(C0), torch.empty_like(n0), torch.empty_like(m0)
    return _launch(q, k, v, i, lf, C0, n0, m0, chunk)


@_cost.reports(mlstm_cost)
def mlstm_chunkwise_bh(q, k, v, i, lf, C0, n0, m0, chunk: int = 64):
    """q, k, v: (BH, S, DH) f32 or bf16; i, lf: (BH, S) f32 (lf =
    log_sigmoid(f)); C0 (BH, DH, DH), n0 (BH, DH), m0 (BH) f32. Returns (h
    (BH, S, DH) in q's dtype, C, n, m) in f32. On the card the bf16 kernel
    takes a chunk length L up to what a block's shared memory holds (5348
    steps at DH 512; ``csrc/mlstm_chunk.cu``); past it the launch raises."""
    _build.refuse_dtensor("mlstm_chunkwise", q, k, v, i, lf, C0, n0, m0)
    if _grad.wants_grad(q, k, v, i, lf, C0, n0, m0):
        return MLSTMFn.apply(q, k, v, i, lf, C0, n0, m0, chunk)
    return _forward(q, k, v, i, lf, C0, n0, m0, chunk)


def _launch(q, k, v, i, lf, C0, n0, m0, chunk: int):
    """Check, allocate the outputs and launch the kernel on the current stream."""
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
    if DH % 32 or DH > MAX_DH or S < 1:
        raise ValueError(f"mlstm_chunkwise: DH must be a multiple of 32 up to {MAX_DH}, "
                         f"and S >= 1 (DH {DH}, S {S})")
    dev = _build.require_cuda("mlstm_chunkwise", q, k, v, i, lf, C0, n0, m0)
    L = ref.chunk_len(S, chunk)
    h = torch.empty_like(q)
    C = torch.empty_like(C0)
    n = torch.empty_like(n0)
    m = torch.empty_like(m0)
    if q.dtype == torch.bfloat16:
        if (q.data_ptr() | k.data_ptr() | v.data_ptr() | C0.data_ptr() | n0.data_ptr()) % 16:
            raise ValueError("mlstm_chunkwise: the bf16 kernel takes q, k, v, C0 and n0 "
                             "16-byte aligned")
        tc, scratch_ptr = plan_col_tile(BH, DH), None
    else:
        # per block: the chunk's cumulative log-forget, row stabilisers and
        # carry weights, L floats each (kept alive by the name until the launch)
        tc = TC
        scratch = torch.empty(BH * (DH // TC) * 3 * L, dtype=torch.float32, device=q.device)
        scratch_ptr = scratch.data_ptr()
    err = (_RT.fn or _RT.resolve())(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), i.data_ptr(), lf.data_ptr(),
        C0.data_ptr(), n0.data_ptr(), m0.data_ptr(), h.data_ptr(), C.data_ptr(),
        n.data_ptr(), m.data_ptr(), scratch_ptr, BH, S, DH, L, tc, _build.DTYPE_CODE[q.dtype],
        _build.stream_ptr(dev))
    _build.count_launch(mlstm_chunkwise_bh)
    _build.check(err, "mlstm_chunkwise")
    return h, C, n, m


class MLSTMFn(torch.autograd.Function):
    """The kernel forward; the backward of ``ref.mlstm_chunkwise_bh_ref`` at
    the saved inputs, for h and for the carry outputs (C, n, m) alike."""

    @staticmethod
    def forward(ctx, q, k, v, i, lf, C0, n0, m0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, i, lf, C0, n0, m0)
        ctx.chunk = chunk
        return _forward(q, k, v, i, lf, C0, n0, m0, chunk)

    @staticmethod
    def backward(ctx, gh, gC, gn, gm):
        return (*_grad.plain_grads(ref.mlstm_chunkwise_bh_ref, ctx.saved_tensors, ctx.needs_input_grad[:8],
                                   (gh, gC, gn, gm), chunk=ctx.chunk), None)


mlstm_chunkwise_bh.launches = 0


def mlstm_chunkwise(q, k, v, i, f, C0, n0, m0, chunk: int = 64):
    """q, k, v: (B, S, NH, DH); i, f: (B, S, NH) raw gates; carry (B, NH,
    ...). Returns (h (B, S, NH, DH), (C, n, m))."""
    return ref.mlstm_chunkwise(q, k, v, i, f, C0, n0, m0, chunk=chunk, bh_fn=mlstm_chunkwise_bh)
