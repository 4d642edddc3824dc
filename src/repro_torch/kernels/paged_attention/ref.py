"""Plain PyTorch oracles for the paged KV-pool kernels: the decode
gather-attention (gather, then dense), the prefill write scatter through a
block-table row, the int8-pool legs (quantize at write, dequantize on
gather, with ``models/quant.py``'s KV idiom, so the int8 tensors match the
kernels bit for bit), and the chained-table flattener (two-level block
tables reduce to the flat physical row for every oracle).

Index semantics are explicit here, where JAX's are implicit: a gather
through a table clamps the id into range (JAX clamps gathers), and a
scatter to a page id outside the pool is dropped (JAX drops out-of-range
scatters)."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models.quant import dequantize_kv, quantize_kv


def chain_rows(l1_tab: torch.Tensor, l2_tab: torch.Tensor) -> torch.Tensor:
    """Flatten two-level block tables to the flat physical rows they encode.

    l1_tab: (B, W1) int32 rows of table-page ids; l2_tab: (n_rows, tpp)
    int32 second-level rows of physical page ids. Logical block i of
    sequence b lives in page ``l2_tab[l1_tab[b, i // tpp], i % tpp]``; row 0
    of l2_tab is the all-null table page. Returns (B, W1 * tpp) int32."""
    B, W1 = l1_tab.shape
    n_rows, tpp = l2_tab.shape
    rows = l1_tab.to(device=l2_tab.device, dtype=torch.long).clamp(0, n_rows - 1)
    return l2_tab[rows].reshape(B, W1 * tpp)


def gather_kv(pool: torch.Tensor, block_tab: torch.Tensor) -> torch.Tensor:
    """Materialize the dense (B, KV, P*ps, hd) view of a paged pool.

    pool: (num_pages, KV, ps, hd); block_tab: (B, P) int32."""
    B, P = block_tab.shape
    num_pages, KV, ps, hd = pool.shape
    tab = block_tab.to(device=pool.device, dtype=torch.long).clamp(0, num_pages - 1)
    g = pool[tab]                                  # (B, P, KV, ps, hd)
    return g.permute(0, 2, 1, 3, 4).reshape(B, KV, P * ps, hd)


def paged_attention_ref(q, pool_k, pool_v, block_tab, lengths, softcap: float = 0.0,
                        pool_ks=None, pool_vs=None, l2_tab=None):
    """q: (B, KV, G, hd); pools: (num_pages, KV, ps, hd); block_tab: (B, P);
    lengths: (B,) valid tokens per sequence. With ``pool_ks``/``pool_vs``
    the pools are int8 and the gathered K/V is dequantized (f32) first; with
    ``l2_tab`` block_tab is the first level of a chained table."""
    tab = chain_rows(block_tab, l2_tab) if l2_tab is not None else block_tab
    k = gather_kv(pool_k, tab)
    v = gather_kv(pool_v, tab)
    if pool_ks is not None:
        k = dequantize_kv(k, gather_kv(pool_ks, tab), torch.float32)
        v = dequantize_kv(v, gather_kv(pool_vs, tab), torch.float32)
    return decode_attention_ref(q, k, v, lengths, softcap=softcap)


def paged_prefill_write_ref(pool_k, pool_v, k, v, tab_row):
    """Scatter one prompt's (or chunk's) K/V (1, Lp, KV, hd) through its
    block-table row (P,) into the pools IN PLACE: token t lands in page
    ``tab_row[t // ps]``, slot ``t % ps``. Lp need not be a page multiple
    (the tail page is written partially). Returns (pool_k, pool_v)."""
    num_pages, KV, ps, hd = pool_k.shape
    Lp = k.shape[1]
    P = tab_row.shape[0]
    if -(-Lp // ps) > P:
        raise ValueError(f"{Lp} tokens need {-(-Lp // ps)} pages; the row has {P}")
    dev = pool_k.device
    t = torch.arange(Lp, device=dev)
    pages = tab_row.to(device=dev, dtype=torch.long)[t // ps]
    keep = (pages >= 0) & (pages < num_pages)      # dropped, as JAX drops the scatter
    pages, offs = pages[keep], (t % ps)[keep]
    kvh = torch.arange(KV, device=dev)
    at = (pages[:, None], kvh[None, :], offs[:, None])
    pool_k[at] = k[0][keep].to(pool_k.dtype)
    pool_v[at] = v[0][keep].to(pool_v.dtype)
    return pool_k, pool_v


def paged_prefill_write_quant_ref(pool_k, pool_v, pool_ks, pool_vs, k, v, tab_row):
    """Int8 leg of the prefill scatter: quantize per (token, head), then
    scatter values and scales through the same row, IN PLACE. Returns the
    four pools."""
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    paged_prefill_write_ref(pool_k, pool_v, kq, vq, tab_row)
    paged_prefill_write_ref(pool_ks, pool_vs, ks, vs, tab_row)
    return pool_k, pool_v, pool_ks, pool_vs
