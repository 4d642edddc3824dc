"""Model-facing wrappers for the paged KV pool: the decode-time
gather-attention over block tables, and its write-side twin, the prefill
scatter that lands a prompt's (or chunk's) K/V in the pool in place.

For a CPU tensor each wrapper runs its plain version (``ref.py``); for a
CUDA tensor it launches the kernel of ``csrc/paged_attention.cu`` or raises.
``paged_gather_context`` is plain PyTorch on every device, as its JAX twin
is plain jnp."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import (
    gather_kv,
    paged_attention_ref,
    paged_prefill_write_ref,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_WRITE_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_DECODE_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                ctypes.c_float, ctypes.c_float, _I, _P]
_DECODE_THREADS, _DECODE_MAX_PER_THREAD = 128, 4     # csrc/paged_attention.cu
_SMEM_LIMIT = 48 * 1024


def _shift_row(tab: torch.Tensor, offset: int, ps: int) -> torch.Tensor:
    """Shift a block-table row left by ``offset // ps`` pages (chunked
    prefill: chunk token t lands at absolute position offset + t). Entries
    shifted past the row's end map to the reserved null page 0."""
    P = tab.shape[0]
    idx = int(offset) // ps + torch.arange(P, device=tab.device)
    inside = idx < P
    return torch.where(inside, tab[idx.clamp(0, P - 1)], torch.zeros_like(tab))


def paged_prefill_write(pool_k, pool_v, k, v, tab_row, offset=None):
    """Scatter one prefilled prompt's (or prompt chunk's) K/V through its
    block-table row, IN PLACE.

    pool_k/pool_v: (num_pages, KV, ps, hd); k/v: (1, Lp, KV, hd); tab_row:
    (P,) int. Bucket padding past the sequence's pages maps to the null page
    0. ``offset`` (a page multiple) makes this the chunked write: chunk token
    t lands at absolute position offset + t through the row shifted by
    ``offset // ps`` pages. Lp need not be a page multiple: the kernel writes
    the ragged tail itself. Returns (pool_k, pool_v)."""
    num_pages, KV, ps, hd = pool_k.shape
    tab = torch.as_tensor(tab_row, dtype=torch.int32, device=pool_k.device)
    if offset is not None:
        tab = _shift_row(tab, offset, ps)
    if pool_k.device.type == "cpu":
        return paged_prefill_write_ref(pool_k, pool_v, k, v, tab)
    Lp = k.shape[1]
    if k.shape != (1, Lp, KV, hd) or v.shape != k.shape:
        raise ValueError(f"paged_prefill_write: k/v must be (1, Lp, {KV}, {hd}), got {tuple(k.shape)}")
    if pool_k.dtype not in _build.DTYPE_CODE or not (
            pool_v.dtype == k.dtype == v.dtype == pool_k.dtype) or pool_v.shape != pool_k.shape:
        raise ValueError("paged_prefill_write: pools and k/v must share one f32 or bf16 dtype and shape")
    if -(-Lp // ps) > tab.shape[0]:
        raise ValueError(f"paged_prefill_write: {Lp} tokens need more than the row's {tab.shape[0]} pages")
    _build.require_cuda("paged_prefill_write", pool_k, pool_v, k, v, tab)
    fn = _build.function("rt_paged_prefill_write", _WRITE_ARGS)
    err = fn(k.data_ptr(), v.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tab.data_ptr(),
             Lp, KV, ps, hd, pool_k.element_size(), num_pages, _build.stream_ptr(pool_k))
    _build.count_launch(paged_prefill_write)
    _build.check(err, "paged_prefill_write")
    return pool_k, pool_v


paged_prefill_write.launches = 0


def paged_gather_context(pool_k, pool_v, tab_row):
    """One sequence's dense K/V context view from the page pool:
    (num_pages, KV, ps, hd) x (P,) -> two (1, P*ps, KV, hd) tensors where
    index t holds the token at logical position t (null-row entries carry
    page-0 garbage; callers mask them by position)."""
    tab = torch.as_tensor(tab_row, dtype=torch.int32, device=pool_k.device)[None, :]
    k = gather_kv(pool_k, tab)                    # (1, KV, P*ps, hd)
    v = gather_kv(pool_v, tab)
    return k.transpose(1, 2), v.transpose(1, 2)


def paged_attention(q, pool_k, pool_v, block_tab, lengths, softcap: float = 0.0):
    """q: (B, 1, H, hd); pools: (num_pages, KV, ps, hd); block_tab: (B, P)
    physical pages; lengths: (B,) valid tokens per sequence. Returns
    (B, 1, H, hd)."""
    B, S, H, hd = q.shape
    num_pages, KV, ps, _ = pool_k.shape
    G = H // KV
    qg = q[:, 0].reshape(B, KV, G, hd)
    dev = pool_k.device
    tab = torch.as_tensor(block_tab, dtype=torch.int32, device=dev)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    if dev.type == "cpu":
        return paged_attention_ref(qg, pool_k, pool_v, tab, lens, softcap=softcap).reshape(B, 1, H, hd)
    if S != 1 or H % KV:
        raise ValueError(f"paged_attention: q must be (B, 1, H, hd) with H % KV == 0, got {tuple(q.shape)}")
    if q.dtype not in _build.DTYPE_CODE or not (pool_k.dtype == pool_v.dtype == q.dtype):
        raise ValueError("paged_attention: q and the pools must share one f32 or bf16 dtype")
    if tab.shape[0] != B or lens.shape != (B,):
        raise ValueError("paged_attention: block_tab must be (B, P) and lengths (B,)")
    if G * hd > _DECODE_THREADS * _DECODE_MAX_PER_THREAD:
        raise ValueError(f"paged_attention: G*hd={G * hd} exceeds the kernel's register budget")
    smem = 4 * (G * hd + ps * (hd + 1) + ps * hd + G * ps + G)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged_attention: a page needs {smem} bytes of shared memory")
    qg = qg.contiguous()
    _build.require_cuda("paged_attention", qg, pool_k, pool_v, tab, lens)
    out = torch.empty_like(qg)
    fn = _build.function("rt_paged_attention", _DECODE_ARGS)
    err = fn(qg.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tab.data_ptr(), lens.data_ptr(),
             out.data_ptr(), B, KV, G, hd, ps, tab.shape[1], num_pages, 1.0 / hd ** 0.5,
             float(softcap), _build.DTYPE_CODE[q.dtype], _build.stream_ptr(q))
    _build.count_launch(paged_attention)
    _build.check(err, "paged_attention")
    return out.reshape(B, 1, H, hd)


paged_attention.launches = 0
