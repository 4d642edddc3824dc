"""Causal GQA flash attention: the CUDA kernel of ``csrc/flash_attention.cu``
on a CUDA tensor, the plain version on a CPU tensor. Standard causal
positions only (square q/k); the kernel masks a ragged S itself, so no
padded copy is made.

The kernel reads q, k and v and writes its output through their strides, so
both entry points hand it their tensors as they lie: ``flash_attention``
the model's (B, S, H, hd) layout, ``flash_attention_bhsd`` the TPU kernel's
(B, H, S, hd). Neither makes a copy. Both count their launches on
``flash_attention_bhsd.launches``. Where a gradient is wanted (training),
the forward runs inside ``FlashFn`` on every device, whose backward is the
plain version's (``kernels/_grad.py``): the TPU kernel is forward only, as
is this one. On a meta tensor only the output is allocated (the dry run);
under a cost counter a call reports ``flash_cost`` (``launch/cost.py``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _grad
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.launch import cost as _cost

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_RT = _build.Entry("rt_flash_attention", [_P, _P, _P, _P, _I, _I, _I, _I, _I, *[_L] * 12,
                                          ctypes.c_float, _I, _P])
_MAX_HD = 128                                   # csrc/flash_attention.cu


def kernel_strides(stride, layout: str):
    """The element strides (batch, position, head) that the kernel takes for
    a 4-d tensor of strides ``stride`` in ``layout`` "bshd" or "bhsd"."""
    sb, s1, s2, _ = stride
    return (sb, s1, s2) if layout == "bshd" else (sb, s2, s1)


def _launch(q, k, v, layout: str):
    """q and the output: (B, S, H, hd) or (B, H, S, hd) as ``layout`` says;
    k/v likewise with KV heads. Checks, allocates the output in q's layout
    and launches on the current stream."""
    B, S, H, hd = q.shape if layout == "bshd" else (q.shape[0], q.shape[2], q.shape[1], q.shape[3])
    KV = k.shape[2] if layout == "bshd" else k.shape[1]
    want = (B, S, KV, hd) if layout == "bshd" else (B, KV, S, hd)
    if k.shape != want or v.shape != want or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    code = _build.DTYPE_CODE.get(q.dtype)
    if code is None or not (k.dtype == v.dtype == q.dtype):
        raise ValueError("flash_attention: q, k and v must share one f32 or bf16 dtype")
    if hd > _MAX_HD:
        raise ValueError(f"flash_attention: head_dim {hd} > {_MAX_HD}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: q, k and v need unit stride over hd")
    index = q.get_device()
    if not (q.is_cuda and k.is_cuda and v.is_cuda and k.get_device() == v.get_device() == index):
        raise ValueError(f"flash_attention: every tensor must be on one CUDA device, got "
                         f"{[str(t.device) for t in (q, k, v)]}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = (_RT.fn or _RT.resolve())(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV, S, hd,
        *kernel_strides(q.stride(), layout), *kernel_strides(k.stride(), layout),
        *kernel_strides(v.stride(), layout), *kernel_strides(out.stride(), layout),
        1.0 / hd ** 0.5, code, _build.stream_ptr(index))
    _build.count_launch(flash_attention_bhsd)
    _build.check(err, "flash_attention")
    return out


def _plain(q, k, v, layout: str):
    """The plain version in ``layout``."""
    if layout == "bhsd":
        return attention_ref(q, k, v)
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)


def _forward(q, k, v, layout: str):
    """The plain version on the CPU, the output alone on the meta device,
    the kernel on the card; contiguous on every device, as the kernel
    writes it."""
    if q.device.type == "cpu":
        return _plain(q, k, v, layout).contiguous()
    if q.is_meta:
        return torch.empty(q.shape, dtype=q.dtype, device=q.device)
    return _launch(q, k, v, layout)


class FlashFn(torch.autograd.Function):
    """The kernel forward; the backward of the plain version at the saved
    q, k, v (its S x S scores recomputed, as the reference's chunked jnp
    path recomputes them under ``jax.checkpoint``)."""

    @staticmethod
    def forward(ctx, q, k, v, layout):
        ctx.save_for_backward(q, k, v)
        ctx.layout = layout
        return _forward(q, k, v, layout)

    @staticmethod
    def backward(ctx, g):
        return (*_grad.plain_grads(_plain, ctx.saved_tensors, ctx.needs_input_grad[:3], (g,),
                                   layout=ctx.layout), None)


def _attend(q, k, v, layout: str):
    _build.refuse_dtensor("flash_attention", q, k, v)
    if _grad.wants_grad(q, k, v):
        return FlashFn.apply(q, k, v, layout)
    return _forward(q, k, v, layout)


def flash_cost(q, k, v, layout: str = "bhsd"):
    """(FLOPs, bytes) of one call: the plain version's two products over
    the whole S x S scores (4 * B * H * S^2 * hd), q, k and v read once and
    the output written once."""
    B, S, H, hd = q.shape if layout == "bshd" else (q.shape[0], q.shape[2], q.shape[1], q.shape[3])
    return 4 * B * H * S * S * hd, 2 * _cost.nbytes(q) + _cost.nbytes(k) + _cost.nbytes(v)


@_cost.reports(flash_cost)
def flash_attention_bhsd(q, k, v):
    """q: (B, H, S, hd); k/v: (B, KV, S, hd) -> (B, H, S, hd)."""
    return _attend(q, k, v, "bhsd")


flash_attention_bhsd.launches = 0


@_cost.reports(lambda q, k, v: flash_cost(q, k, v, "bshd"))
def flash_attention(q, k, v):
    """q: (B, S, H, hd); k/v: (B, S, KV, hd) -> (B, S, H, hd), causal; on a
    CUDA tensor the output is contiguous."""
    return _attend(q, k, v, "bshd")
