"""Plain PyTorch oracles for the paged KV-pool kernels: the decode
gather-attention (gather, then dense) and the prefill write scatter through
a block-table row. Flat tables and f32/bf16 pools only (the int8 and
chained-table legs are not ported yet).

Index semantics are explicit here, where JAX's are implicit: a gather
through a table clamps the page id into the pool (JAX clamps gathers), and a
scatter to a page id outside the pool is dropped (JAX drops out-of-range
scatters)."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def gather_kv(pool: torch.Tensor, block_tab: torch.Tensor) -> torch.Tensor:
    """Materialize the dense (B, KV, P*ps, hd) view of a paged pool.

    pool: (num_pages, KV, ps, hd); block_tab: (B, P) int32."""
    B, P = block_tab.shape
    num_pages, KV, ps, hd = pool.shape
    tab = block_tab.to(device=pool.device, dtype=torch.long).clamp(0, num_pages - 1)
    g = pool[tab]                                  # (B, P, KV, ps, hd)
    return g.permute(0, 2, 1, 3, 4).reshape(B, KV, P * ps, hd)


def paged_attention_ref(q, pool_k, pool_v, block_tab, lengths, softcap: float = 0.0):
    """q: (B, KV, G, hd); pools: (num_pages, KV, ps, hd); block_tab: (B, P);
    lengths: (B,) valid tokens per sequence."""
    k = gather_kv(pool_k, block_tab)
    v = gather_kv(pool_v, block_tab)
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
