"""Model-facing wrappers for the paged KV pool: the decode-time
gather-attention over block tables, and its write-side twin, the prefill
scatter that lands a prompt's (or chunk's) K/V in the pool in place. Every
entry point carries an int8 leg (scale pools beside the value pools:
quantize at write, dequantize on gather), and the decode also takes chained
two-level block tables.

For a CPU tensor each wrapper runs its plain version (``ref.py``); for a
CUDA tensor it launches the kernel of ``csrc/paged_attention.cu`` or raises.
When B * KV blocks would leave the card's SMs idle, the decode splits each
row's pages across blocks (``plan_page_splits``) and a second kernel
combines the splits in a fixed order; the call counts one launch. The
prefill writes take a chunk's offset as a page count that the kernel
resolves (``write_page_ids``), so a chunked write is one device operation,
on a grid from ``plan_write_grid``.
``paged_gather_context`` is plain PyTorch on every device, as its JAX twin
is plain jnp."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ops import MIN_SPLIT, SMS
from repro_torch.kernels.paged_attention.ref import (
    gather_kv,
    paged_attention_ref,
    paged_prefill_write_quant_ref,
    paged_prefill_write_ref,
)
from repro_torch.models.quant import dequantize_kv

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_WRITE = _build.Entry("rt_paged_prefill_write",
                      [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P])
_WRITE_QUANT = _build.Entry("rt_paged_prefill_write_quant",
                            [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P])
_DECODE = _build.Entry("rt_paged_attention", [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                              _I, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P])
_MAX_G, _MAX_HD = 8, 128    # csrc/paged_attention.cu: query heads and columns held in registers
_MAX_SPLIT_PAGES = 8192     # one split's page ids, resolved into 32 KB of shared memory
_KV_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_WRITE_TOKENS = 16          # tokens per write block at most: a page's worth at 16-token pages


def plan_page_splits(B: int, KV: int, P: int, ps: int) -> int:
    """Splits of a block-table row's P pages across blocks, from the shapes
    alone (the lengths lie on the card), by ``decode_attention``'s rule: at
    most two blocks per SM, all resident at once, where B * KV blocks would
    leave SMs idle; each split a whole number of pages and at least
    MIN_SPLIT tokens; one split for a short row."""
    min_pages = max(1, -(-MIN_SPLIT // ps))
    return max(1, min(2 * SMS // max(1, B * KV), P // min_pages))


def page_split_bounds(P: int, nsplit: int) -> list:
    """[start, stop) pages of each split, as the kernel computes them: split
    s covers pages [s * P // n, (s + 1) * P // n)."""
    return [(s * P // nsplit, (s + 1) * P // nsplit) for s in range(nsplit)]


def _shift_row(tab: torch.Tensor, offset: int, ps: int) -> torch.Tensor:
    """Shift a block-table row left by ``offset // ps`` pages (chunked
    prefill: chunk token t lands at absolute position offset + t). Entries
    shifted past the row's end map to the reserved null page 0. The plain
    path's form of what the write kernels resolve themselves."""
    P = tab.shape[0]
    idx = int(offset) // ps + torch.arange(P, device=tab.device)
    inside = idx < P
    return torch.where(inside, tab[idx.clamp(0, P - 1)], torch.zeros_like(tab))


def write_page_ids(tab: torch.Tensor, shift_pages: int, Lp: int, ps: int) -> torch.Tensor:
    """The page each of Lp chunk tokens lands in, by the write kernels' rule:
    token t goes to ``tab[shift_pages + t // ps]`` while that index lies in
    the row's P entries, else to the null page 0 (written, not dropped); an
    id outside the pool is dropped later, by the scatter. Equal to
    ``_shift_row(tab, shift_pages * ps, ps)[t // ps]``."""
    P = tab.shape[0]
    i = shift_pages + torch.arange(Lp, device=tab.device) // ps
    return torch.where(i < P, tab[i.clamp(0, P - 1)], torch.zeros((), dtype=tab.dtype, device=tab.device))


def plan_write_grid(Lp: int, KV: int, hd: int, elem_bytes: int, n_sms: int) -> tuple:
    """Launch shape of the prefill writes: (tokens per block, blocks). Block
    (x, h) takes tokens [x * tokens, (x + 1) * tokens) of KV head h, a row of
    16-byte lanes per token (elem_bytes 2 for the quantizing write, whose
    lanes take 8 values each). From 16 tokens a block (a page's worth at
    16-token pages), halved while the grid leaves SMs idle and a block keeps
    a warp's lanes; where even that cannot fill the card, 16 tokens a block,
    the smallest grid."""
    lanes = max(1, -(-hd * elem_bytes // 16))
    tokens = _WRITE_TOKENS
    while tokens > 1 and -(-Lp // tokens) * KV < n_sms and (tokens // 2) * lanes >= 32:
        tokens //= 2
    if -(-Lp // tokens) * KV < n_sms:
        tokens = _WRITE_TOKENS
    return tokens, -(-Lp // tokens) * KV


def _write_args(name: str, pool_k, k, v, tab_row, offset):
    """The int32 row of a prefill write and the chunk's shift in pages,
    after the checks the kernels rely on when the pools lie on the card. On
    the CPU the row comes back shifted (``_shift_row``) with shift 0."""
    num_pages, KV, ps, hd = pool_k.shape
    tab = torch.as_tensor(tab_row, dtype=torch.int32, device=pool_k.device)
    if pool_k.device.type == "cpu":
        return (tab if offset is None else _shift_row(tab, offset, ps)), 0
    Lp = k.shape[1]
    if k.shape != (1, Lp, KV, hd) or v.shape != k.shape:
        raise ValueError(f"{name}: k/v must be (1, Lp, {KV}, {hd}), got {tuple(k.shape)}")
    if tab.dim() != 1:
        raise ValueError(f"{name}: tab_row must be (P,), got {tuple(tab.shape)}")
    P = tab.shape[0]
    if -(-Lp // ps) > P:
        raise ValueError(f"{name}: {Lp} tokens need more than the row's {P} pages")
    if Lp * KV * hd * k.element_size() >= 2 ** 31:
        raise ValueError(f"{name}: the kernel indexes k/v in 32 bits; {Lp} tokens are too many")
    # every shift at or past the row's end (or at or below its negative)
    # gives the same pages, and the clamp keeps the int in 32 bits
    return tab, 0 if offset is None else max(-P, min(P, int(offset) // ps))


def paged_prefill_write(pool_k, pool_v, k, v, tab_row, offset=None):
    """Scatter one prefilled prompt's (or prompt chunk's) K/V through its
    block-table row, IN PLACE.

    pool_k/pool_v: (num_pages, KV, ps, hd); k/v: (1, Lp, KV, hd); tab_row:
    (P,) int. Bucket padding past the sequence's pages maps to the null page
    0. ``offset`` (a page multiple) makes this the chunked write: chunk token
    t lands at absolute position offset + t, in page ``tab_row[offset // ps
    + t // ps]`` (``write_page_ids``). Lp need not be a page multiple: the
    kernel writes the ragged tail itself. Returns (pool_k, pool_v)."""
    tab, shift = _write_args("paged_prefill_write", pool_k, k, v, tab_row, offset)
    if pool_k.device.type == "cpu":
        return paged_prefill_write_ref(pool_k, pool_v, k, v, tab)
    num_pages, KV, ps, hd = pool_k.shape
    if pool_k.dtype not in _build.DTYPE_CODE or not (
            pool_v.dtype == k.dtype == v.dtype == pool_k.dtype) or pool_v.shape != pool_k.shape:
        raise ValueError("paged_prefill_write: pools and k/v must share one f32 or bf16 dtype and shape")
    dev = _build.require_cuda("paged_prefill_write", pool_k, pool_v, k, v, tab)
    Lp = k.shape[1]
    tokens, _ = plan_write_grid(Lp, KV, hd, pool_k.element_size(), SMS)
    err = (_WRITE.fn or _WRITE.resolve())(
        k.data_ptr(), v.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), tab.data_ptr(),
        Lp, KV, ps, hd, pool_k.element_size(), num_pages, tab.shape[0], shift, tokens,
        _build.stream_ptr(dev))
    _build.count_launch(paged_prefill_write)
    _build.check(err, "paged_prefill_write")
    return pool_k, pool_v


paged_prefill_write.launches = 0


def paged_prefill_write_quant(pool_k, pool_v, pool_ks, pool_vs, k, v, tab_row, offset=None):
    """Int8 leg of ``paged_prefill_write``: quantize per (token, head) at
    write time and land the int8 values in pool_k/pool_v (num_pages, KV, ps,
    hd) and the bf16 scales in pool_ks/pool_vs (num_pages, KV, ps, 1), all
    IN PLACE. k/v are f32 or bf16 activations. Returns the four pools."""
    tab, shift = _write_args("paged_prefill_write_quant", pool_k, k, v, tab_row, offset)
    if pool_k.device.type == "cpu":
        return paged_prefill_write_quant_ref(pool_k, pool_v, pool_ks, pool_vs, k, v, tab)
    num_pages, KV, ps, hd = pool_k.shape
    if not (pool_k.dtype == pool_v.dtype == torch.int8 and pool_v.shape == pool_k.shape):
        raise ValueError("paged_prefill_write_quant: pool_k/pool_v must be int8 of one shape")
    if not (pool_ks.dtype == pool_vs.dtype == torch.bfloat16
            and pool_ks.shape == pool_vs.shape == (num_pages, KV, ps, 1)):
        raise ValueError(f"paged_prefill_write_quant: scale pools must be bf16 ({num_pages}, {KV}, {ps}, 1)")
    if k.dtype not in _build.DTYPE_CODE or v.dtype != k.dtype:
        raise ValueError("paged_prefill_write_quant: k/v must share one f32 or bf16 dtype")
    dev = _build.require_cuda("paged_prefill_write_quant", pool_k, pool_v, pool_ks, pool_vs, k, v, tab)
    Lp = k.shape[1]
    tokens, _ = plan_write_grid(Lp, KV, hd, 2, SMS)
    err = (_WRITE_QUANT.fn or _WRITE_QUANT.resolve())(
        k.data_ptr(), v.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), pool_ks.data_ptr(),
        pool_vs.data_ptr(), tab.data_ptr(), Lp, KV, ps, hd, _build.DTYPE_CODE[k.dtype],
        num_pages, tab.shape[0], shift, tokens, _build.stream_ptr(dev))
    _build.count_launch(paged_prefill_write_quant)
    _build.check(err, "paged_prefill_write_quant")
    return pool_k, pool_v, pool_ks, pool_vs


paged_prefill_write_quant.launches = 0


def paged_gather_context(pool_k, pool_v, tab_row, pool_ks=None, pool_vs=None):
    """One sequence's dense K/V context view from the page pool:
    (num_pages, KV, ps, hd) x (P,) -> two (1, P*ps, KV, hd) tensors where
    index t holds the token at logical position t (null-row entries carry
    page-0 garbage; callers mask them by position). With ``pool_ks``/
    ``pool_vs`` the pools are int8 and the view is dequantized (f32)."""
    tab = torch.as_tensor(tab_row, dtype=torch.int32, device=pool_k.device)[None, :]
    k = gather_kv(pool_k, tab)                    # (1, KV, P*ps, hd)
    v = gather_kv(pool_v, tab)
    if pool_ks is not None:
        k = dequantize_kv(k, gather_kv(pool_ks, tab), torch.float32)
        v = dequantize_kv(v, gather_kv(pool_vs, tab), torch.float32)
    return k.transpose(1, 2), v.transpose(1, 2)


def paged_attention(q, pool_k, pool_v, block_tab, lengths, softcap: float = 0.0,
                    pool_ks=None, pool_vs=None, l2_tab=None):
    """q: (B, 1, H, hd); pools: (num_pages, KV, ps, hd); block_tab: (B, P)
    physical pages, or with ``l2_tab`` (n_rows, tpp) the (B, W1) first-level
    rows of a chained table; lengths: (B,) valid tokens per sequence.
    ``pool_ks``/``pool_vs`` (num_pages, KV, ps, 1) bf16 select the int8
    leg. Returns (B, 1, H, hd) in q's dtype."""
    B, S, H, hd = q.shape
    num_pages, KV, ps, _ = pool_k.shape
    G = H // KV
    qg = q[:, 0].reshape(B, KV, G, hd)
    dev = pool_k.device
    tab = torch.as_tensor(block_tab, dtype=torch.int32, device=dev)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    l2 = None if l2_tab is None else torch.as_tensor(l2_tab, dtype=torch.int32, device=dev)
    quant = pool_ks is not None
    if dev.type == "cpu":
        return paged_attention_ref(qg, pool_k, pool_v, tab, lens, softcap=softcap, pool_ks=pool_ks,
                                   pool_vs=pool_vs, l2_tab=l2).reshape(B, 1, H, hd)
    if S != 1 or H % KV:
        raise ValueError(f"paged_attention: q must be (B, 1, H, hd) with H % KV == 0, got {tuple(q.shape)}")
    if q.dtype not in _build.DTYPE_CODE or pool_v.dtype != pool_k.dtype:
        raise ValueError("paged_attention: q must be f32 or bf16 and the pools share one dtype")
    if quant != (pool_k.dtype == torch.int8) or (not quant and pool_k.dtype != q.dtype):
        raise ValueError("paged_attention: int8 pools need scale pools; other pools take q's dtype")
    scales = ()
    if quant:
        if not (pool_ks.dtype == pool_vs.dtype == torch.bfloat16
                and pool_ks.shape == pool_vs.shape == (num_pages, KV, ps, 1)):
            raise ValueError(f"paged_attention: scale pools must be bf16 ({num_pages}, {KV}, {ps}, 1)")
        scales = (pool_ks, pool_vs)
    if lens.shape != (B,) or tab.dim() != 2 or tab.shape[0] != B:
        raise ValueError("paged_attention: block_tab must be (B, P) and lengths (B,)")
    tpp, n_rows, P = 0, 0, tab.shape[1]
    if l2 is not None:
        if l2.dim() != 2:
            raise ValueError("paged_attention: l2_tab must be (n_rows, tpp)")
        n_rows, tpp = l2.shape
        P = tab.shape[1] * tpp
    vec = 8 if quant else 16 // pool_k.element_size()     # elements per vector load
    fast = hd % vec == 0 and (pool_k.data_ptr() | pool_v.data_ptr()) % (vec * pool_k.element_size()) == 0
    if G > _MAX_G or hd > _MAX_HD or not (fast or hd <= 32):
        raise ValueError(f"paged_attention: the kernel takes G <= {_MAX_G} query heads per KV head "
                         f"and hd <= 32, or rows of whole vectors up to hd {_MAX_HD} in pools "
                         f"aligned to a vector, got G={G}, hd={hd}")
    nsplit = plan_page_splits(B, KV, P, ps)
    if -(-P // nsplit) > _MAX_SPLIT_PAGES:
        raise ValueError(f"paged_attention: {-(-P // nsplit)} pages in one split, more than the "
                         f"kernel's {_MAX_SPLIT_PAGES}")
    qg = qg.contiguous()
    index = _build.require_cuda("paged_attention", qg, pool_k, pool_v, tab, lens, *scales,
                                *(() if l2 is None else (l2,)))
    out = torch.empty_like(qg)
    part = None
    if nsplit > 1:       # per (b, h, split): G maxima, G sums, G x hd accumulators
        part = torch.empty(B * KV * nsplit * G * (hd + 2), dtype=torch.float32, device=dev)
    err = (_DECODE.fn or _DECODE.resolve())(
        qg.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        pool_ks.data_ptr() if quant else None, pool_vs.data_ptr() if quant else None,
        tab.data_ptr(), None if l2 is None else l2.data_ptr(), lens.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), B, KV, G, hd, ps, P, num_pages,
        tpp, n_rows, nsplit, 1.0 / hd ** 0.5, float(softcap), _build.DTYPE_CODE[q.dtype],
        _KV_CODE[pool_k.dtype], _build.stream_ptr(index))
    _build.count_launch(paged_attention, _leg(quant, l2 is not None))
    _build.check(err, "paged_attention")
    return out.reshape(B, 1, H, hd)


def _leg(quant: bool, chained: bool) -> str:
    return {(False, False): "flat", (True, False): "int8", (False, True): "chained",
            (True, True): "int8+chained"}[quant, chained]


paged_attention.launches = 0
paged_attention.leg_launches = {leg: 0 for leg in ("flat", "int8", "chained", "int8+chained")}
